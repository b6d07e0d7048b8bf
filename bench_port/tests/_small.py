"""A small configuration for the CPU tests: the 802.16e 576x288 code
(z=24) at the cells' decoder settings, and the cells' traffic mixes cut
to a few frames."""

from __future__ import annotations

import json
import os
import shutil

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def small_config() -> dict:
    from bench_port.reference.codes import schedule_for

    with open(os.path.join(ROOT, "bench_port", "configs",
                           "wimax_2304x1152.json")) as f:
        cfg = json.load(f)
    cfg.update(code="576x288", n=576, k=288, z=24,
               code_file="ldpcgputegra_tpu/codes/data/576x288.json")
    cfg["edge_updates"] = schedule_for(cfg, ROOT).edge_updates
    return cfg


SMALL_TRAFFIC = {
    "decode_b8192": {"batch": 48, "n_inputs": 3, "check_first": 6,
                     "check_calls": 3, "ebn0_db": 1.5},
    "block_b128": {"batch": 16, "n_blocks": 4, "check_first": 6,
                   "check_blocks": 3, "ebn0_db": 1.5},
    "sweep_s16_b512": {"batch": 24, "scan_steps": 3, "ebn0_db": 1.5},
}


def small_run(traffic: str, seed: int = 2**31 + 7):
    from bench_port import cell

    tr = dict(cell.load_traffic(traffic, ROOT), **SMALL_TRAFFIC[traffic])
    return cell.load_kind(tr["kind"], ROOT)(small_config(), tr, seed, "cpu",
                                            ROOT)


def drive(run, seconds: float = 0.3) -> list:
    """Set-up, window and check of ``run`` on the CPU: what a run of the
    harness does after its look for a card."""
    from bench_port.window import Window

    run.setup()
    win = Window(False, run.window_name)
    run.measure(win, seconds)
    run.release()
    return run.check()


def tree(tmp_path):
    """A copy of the checkout's benchmark files under ``tmp_path``."""
    shutil.copytree(os.path.join(ROOT, "bench_port"),
                    tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    return tmp_path
