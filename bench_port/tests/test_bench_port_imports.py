"""What the benchmark loads: nothing whose top-level name is jax, jaxlib,
flax or ldpcgputegra_tpu (compared whole: the port's name begins with the
JAX package's), and a reference that loads nothing of the port."""

import ast
import os
import subprocess
import sys

from ._small import ROOT

BENCH = os.path.join(ROOT, "bench_port")
FORBIDDEN = {"jax", "jaxlib", "flax", "ldpcgputegra_tpu"}


def _loaded_after(code: str) -> set:
    """Top-level names in ``sys.modules`` after running ``code`` in a fresh
    interpreter whose path starts at the checkout's root."""
    prog = ("import sys; sys.path.insert(0, %r)\n%s\n"
            "print(' '.join(sorted({m.split('.', 1)[0] "
            "for m in sys.modules})))" % (ROOT, code))
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, check=True, timeout=300,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    return set(out.stdout.split())


def test_benchmark_loads_no_jax():
    code = """
import bench_port.run, bench_port.control
from bench_port import cell
for k in ("decode_loop", "block_latency", "sweep"):
    cell.load_kind(k, %r)
bench = cell.load_benchmark(%r)
for m in bench["per_layer"]:
    cell.load_reader(m["name"], %r)
# what the kinds import from the program at set-up and in the window
import ldpcgputegra_tpu_torch.codes.registry, ldpcgputegra_tpu_torch.decoder
import ldpcgputegra_tpu_torch.sim.sweep, ldpcgputegra_tpu_torch.channel.awgn
import ldpcgputegra_tpu_torch.quant, ldpcgputegra_tpu_torch.kernels
""" % (ROOT, ROOT, ROOT)
    loaded = _loaded_after(code)
    assert "ldpcgputegra_tpu_torch" in loaded and "bench_port" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    loaded = _loaded_after(
        "import bench_port.reference.codes, bench_port.reference.channel, "
        "bench_port.reference.decoder, bench_port.yardstick")
    assert not loaded & (FORBIDDEN | {"ldpcgputegra_tpu_torch"})


def test_reference_sources_import_nothing_of_the_program():
    for d in ("reference", "."):
        folder = os.path.join(BENCH, d)
        for fn in os.listdir(folder):
            if d == "." and fn != "yardstick.py" or not fn.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(folder, fn)).read())
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    names = [node.module]
                for n in names:
                    top = n.split(".", 1)[0]
                    assert top not in FORBIDDEN | {"ldpcgputegra_tpu_torch"}, (
                        fn, n)
