"""Start a group of ranks in this machine's processes and collect what
each returns: what ``dryrun_multichip``, the tests and ``chip_smoke.py``
use where torchrun is not the launcher.

Each rank is a process started with the ``spawn`` method; it joins the
group through a ``file://`` store in a fresh directory (no TCP port to
collide with other runs on the machine), calls ``fn(rank, *args)``, and
sends the result back pickled through a file of that directory.  A rank
that raises, dies or outlives ``timeout`` fails the whole group: the
others are killed and ``run_ranks`` raises with the failing rank's
traceback.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import shutil
import tempfile
import time
import traceback
from typing import Callable, Sequence

__all__ = ["run_ranks"]


def _rank_main(fn, rank, world_size, backend, init_method, args, threads,
               out_dir):
    import torch
    import torch.distributed as dist

    from .mesh import initialize_distributed

    def send(result):
        path = os.path.join(out_dir, f"rank{rank}")
        with open(path + ".tmp", "wb") as f:
            pickle.dump(result, f)
        os.replace(path + ".tmp", path)

    try:
        if threads:
            torch.set_num_threads(threads)
        initialize_distributed(backend, init_method, world_size, rank)
        result = fn(rank, *args)
    except BaseException:
        send(("error", traceback.format_exc()))  # the parent raises it
        raise
    send(("ok", result))
    if dist.is_initialized():
        dist.destroy_process_group()


def run_ranks(fn: Callable, world_size: int, args: Sequence = (),
              backend: str = "gloo", threads: int = 1,
              timeout: float = 600.0) -> list:
    """Run ``fn(rank, *args)`` on ``world_size`` ranks of a ``backend``
    group; returns their results in rank order.  ``fn`` and ``args`` must
    pickle (``fn`` a module-level function); ``threads`` sets each rank's
    intra-op threads (0 leaves PyTorch's default)."""
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="ldpc-ranks-")
    try:
        init_method = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, world_size, backend, init_method,
                                   tuple(args), threads, tmp))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        results: dict[int, tuple] = {}
        while len(results) < world_size:
            for r, p in enumerate(procs):
                if r in results:
                    continue
                alive = p.is_alive()  # before the look: a rank writes, then ends
                path = os.path.join(tmp, f"rank{r}")
                if os.path.exists(path):
                    with open(path, "rb") as f:
                        results[r] = pickle.load(f)
                    if results[r][0] == "error":
                        _stop(procs)
                        raise RuntimeError(
                            f"rank {r} of {world_size} failed:\n"
                            f"{results[r][1]}")
                elif not alive:
                    _stop(procs)
                    raise RuntimeError(f"rank {r} of {world_size} died "
                                       f"(exit code {p.exitcode})")
            if time.monotonic() > deadline:
                _stop(procs)
                raise RuntimeError(f"ranks did not finish in {timeout} s")
            time.sleep(0.05)
        for p in procs:
            p.join(timeout=60)
        _stop(procs)
        return [results[r][1] for r in range(world_size)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _stop(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.kill()
    for p in procs:
        p.join(timeout=10)
