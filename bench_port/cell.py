"""Finding a cell's parts by name: ``BENCHMARK.json`` at the checkout's
root names the cells, their configurations (each entry's ``file``) and
traffic mixes (``bench_port/traffic/<traffic>.json``, whose ``kind`` names
``bench_port/kinds/<kind>.py``), and the metrics (a per-layer metric is
read by ``bench_port/metrics/<name>.py``, or by the file of the name
before its first dot).  Adding a cell, a mix or a metric adds files and
entries; no file here names one."""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def load_benchmark(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def load_config(bench: dict, name: str, root: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            with open(os.path.join(root, c["file"])) as f:
                return json.load(f)
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def load_traffic(name: str, root: str) -> dict:
    with open(os.path.join(root, "bench_port", "traffic", name + ".json")) as f:
        return json.load(f)


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not os.path.exists(path):
        raise KeyError(f"no module at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_kind(kind: str, root: str):
    """The ``Run`` class of a kind of traffic."""
    path = os.path.join(root, "bench_port", "kinds", kind + ".py")
    return _module(path, f"bench_port.kinds.{kind}").Run


def load_reader(metric: str, root: str):
    """The ``read(ctx)`` function of a per-layer metric: from
    ``metrics/<metric>.py``, or where there is none, from the file of the
    name before its first dot (``k2_roofline.block`` is ``k2_roofline``
    read in another cell, moving another end-to-end metric)."""
    folder = os.path.join(root, "bench_port", "metrics")
    name = metric
    if not os.path.exists(os.path.join(folder, name + ".py")):
        name = metric.split(".", 1)[0]
    path = os.path.join(folder, name + ".py")
    return _module(path, "bench_port.metrics." + name.replace(".", "_")).read


def metrics_of(bench: dict, cell: str, trace: bool) -> list:
    """The metric entries a run of ``cell`` reports: with ``trace`` the
    per-layer ones, else the end-to-end ones.  An entry without
    ``workloads`` goes to every cell that reports what it moves (a
    per-layer entry) or to every cell (an end-to-end one)."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in moved else [])]
