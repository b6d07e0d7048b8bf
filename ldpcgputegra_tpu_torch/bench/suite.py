"""The benchmark suite on the card: throughput and roofline share of every
suite code (the port's counterpart of ``ldpcgputegra_tpu/bench/suite.py``).

    python -m ldpcgputegra_tpu_torch.bench.suite [--quick] [--fresh]
        [--remeasure] [--repeats R] [--out PATH]

First measures the card's ceilings (``probe_rates``: the best int32 rate
of the two probes, the int32 rate on the decoder's operation mix alone, the
same mix in int8x4, and the device-memory rate, with the probe kernels of
``bench/vpu_probe.py``).  Then times each ``CONFIGS`` row (OMS, ET off,
2.5 dB; coded Mbit/s at 10 and 5 iterations) and each ``LAT_CONFIGS``
latency row (batch 128) through the decoder that ``auto`` picks on the
card, and reports each row's share of its bound (``bench/roofline.py``)
against the probed ceilings, raised to the best rate a row demonstrates
where one beats the probe (``demonstrated_ceiling``), and its share against
the mix's rate.

Writes a Markdown table, headed with the card's name and power limit, to
``--out`` (default ``bench_results/SUITE.md``, git-ignored) and a
checkpoint beside it (``<out>.ckpt.json``) that a later run resumes from
unless ``--fresh``.  Exits non-zero without a CUDA device (writing
nothing), and after the results are written if any row failed.  A probe
failure raises.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import torch

from ..channel.awgn import AwgnChannel
from ..codes.registry import load_code
from ..decoder import backend_for, effective_code, make_decoder
from ..ops.layered import LayeredSpec
from .harness import measure_call, throughput_report
from .roofline import bound, roofline_report, smi_query

__all__ = ["CONFIGS", "LAT_CONFIGS", "KERNEL_BACKENDS", "bench_one",
           "bench_latency", "probe_rates", "demonstrated_ceiling", "main"]

# (code, batch, {iters: published baseline Mbps [best device, 3 streams]}
# [, iteration counts]); the JAX suite's table entry for entry.
# 10-iter: paper/ldpcGpuTegra.tex:337,345,353 (GTX 680); 5-iter: :338,346,354
CONFIGS = [
    ("576x288", 16384, {10: 127.0, 5: 217.0}),
    ("2304x1152", 8192, {10: 132.0, 5: 226.0}),
    ("1944x972", 8192, {}),
    ("2048x384", 8192, {}),
    ("4000x2000", 4096, {10: 131.0, 5: 230.0}),
    ("4896x2448", 4096, {}),
    ("8000x4000", 2048, {10: 33.0}),  # TK1 heterogeneous, tex:318
    ("9972x4986", 2048, {}),
    ("16200x7560", 1024, {}),
    ("20000x10000", 1024, {}),
    ("64800x32400", 512, {}),
    ("64800x21600", 512, {}),
    ("155x93", 16384, {}, (10,)),
    ("200x100", 16384, {}, (10,)),
    ("816x408", 8192, {}, (10,)),
    ("1024x518", 8192, {}, (10,)),
    ("1200x600", 8192, {}, (10,)),
    ("1248x624", 8192, {}, (10,)),
    ("2640x1320", 4096, {}, (10,)),
    ("802_11e_576x288", 16384, {}, (10,)),
    ("802_11e_1920x960", 8192, {}, (10,)),
    ("802_11e_2304x1152", 8192, {}, (10,)),
    ("802_11n-1944x972", 8192, {}, (10,)),
    ("16200x10800", 512, {}, (10,)),
    ("64800x32400-dvbs2", 256, {}, (10,)),
    ("64800x6480-dvbs2", 256, {}, (10,)),
    ("64800x7200-dvbs2", 256, {}, (10,)),
    ("synthqc-256x128x6-z1024", 256, {}, (10,)),
]

LAT_CONFIGS = ["576x288", "1944x972", "4000x2000", "64800x32400"]

KERNEL_BACKENDS = ("cuda", "cuda-gather", "cuda-streamed")
SNR_DB = 2.5
LAT_BATCH = 128
OUT = os.path.join("bench_results", "SUITE.md")


def _time(name: str, batch: int, iters: int, quick: bool, repeats: int,
          seed0: int, dev):
    """(code, spec, backend, seconds per call): the fastest of ``repeats``
    slope measurements of the decoder ``auto`` picks on ``dev``."""
    code = load_code(name)
    spec = LayeredSpec(algo="OMS", iters=iters, early_term=False)
    backend = backend_for(code, spec, dev)
    dec = make_decoder(code, spec, device=dev)
    chan = AwgnChannel(code.N, code.K, device=dev)
    chan.configure(SNR_DB)
    inputs = [chan.generate_zero_int8(chan.generator(seed0 + i), batch)
              for i in range(2 if quick else 6)]
    ks, kl = (2, 6) if quick else (4, 20)
    sec = min(measure_call(dec, inputs, k_small=ks, k_large=kl)
              for _ in range(max(1, repeats)))
    return code, spec, backend, sec


def bench_one(name: str, batch: int, iters: int, quick: bool,
              rates: dict, repeats: int = 1, dev=None) -> dict:
    """One suite row: ms per call, coded throughput and the share of the
    bound against ``rates`` (``probe_rates``): against the best int32 rate
    and, as ``roofline_frac_mix``, against the mix's.  With repeats > 1 the
    time is the fastest of R measurements.  Keys starting with ``_`` feed
    ``demonstrated_ceiling``."""
    dev = torch.device(dev if dev is not None else "cuda")
    code, spec, backend, sec = _time(name, batch, iters, quick, repeats, 0,
                                     dev)
    roof, roof_mix = (
        roofline_report(effective_code(code), spec, batch, sec, alu_rate=alu,
                        hbm_rate=rates["hbm"])
        for alu in (rates["alu"], rates["alu_mix"]))
    return {
        "code": name,
        "backend": backend,
        "iters": iters,
        "batch": batch,
        **throughput_report(sec, batch, code.N),
        "roofline_frac": roof["roofline_frac"],
        "roofline_frac_mix": roof_mix["roofline_frac"],
        "bound": roof["bound"],
        "ceiling": roof["ceiling"],
        "ops_per_edge": roof["ops_per_edge"],
        "_sec": sec,
        "_ops": roof["ops"],
        "_bytes": roof["bytes"],
    }


def bench_latency(name: str, iters: int, quick: bool, repeats: int = 1,
                  dev=None) -> dict:
    """The decode time of one batch of 128 frames, the reference's latency
    axis (``code/ldpc_decoder_arm/main.cpp:612-625``)."""
    dev = torch.device(dev if dev is not None else "cuda")
    code, _, backend, sec = _time(name, LAT_BATCH, iters, quick, repeats,
                                  1000, dev)
    return {
        "code": name,
        "backend": backend,
        "iters": iters,
        "batch": LAT_BATCH,
        "ms_per_call": sec * 1e3,
        "us_per_frame": sec / LAT_BATCH * 1e6,
        "coded_mbps": LAT_BATCH * code.N / sec / 1e6,
    }


class _ClockSampler:
    """``nvidia-smi`` sampling the SM clock and the power draw every
    100 ms while the block runs; ``summary()`` after it."""

    def __enter__(self):
        self._log = tempfile.TemporaryFile(mode="w+")
        self._proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=self._log, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self._proc.terminate()
        self._proc.wait(timeout=10)
        self._log.seek(0)
        self.samples = []
        for line in self._log.read().splitlines():
            try:
                clock, power = (float(v) for v in line.split(","))
            except ValueError:
                continue
            self.samples.append((clock, power))
        self._log.close()
        return False

    def summary(self) -> dict:
        if not self.samples:
            return {}
        clocks = sorted(c for c, _ in self.samples)
        powers = sorted(p for _, p in self.samples)
        return {"samples": len(self.samples),
                "clock_mhz": [clocks[0], clocks[len(clocks) // 2], clocks[-1]],
                "power_w": [powers[0], powers[len(powers) // 2], powers[-1]]}


def probe_rates(dev=None) -> dict:
    """The card's ceilings, measured once per suite run, in algorithmic
    int32 operations/s: ``alu`` (the best of the mix and the peak, whose
    add and max nvcc fuses), ``alu_mix`` (the decoder's own operation mix),
    ``alu_int8x4`` (the packed mix, four operations a lane); the best
    integer-ALU instruction rate either issued (``alu_instructions``);
    ``hbm`` (bytes/s); and the SM clock and power draw that ``nvidia-smi``
    saw meanwhile (min, median, max).  Raises if a probe fails."""
    from .vpu_probe import measure_alu_rate, measure_hbm_bw

    with _ClockSampler() as smp:
        alu = measure_alu_rate(dev)
        alu4 = measure_alu_rate(dev, packed=True)
        rates = {"alu": max(alu["mix"], alu["peak"]), "alu_mix": alu["mix"],
                 "alu_int8x4": alu4["mix"],
                 "alu_instructions": max(alu["instructions"],
                                         alu4["instructions"]),
                 "hbm": measure_hbm_bw(dev)}
    rates["seen"] = smp.summary()
    print(f"(II) probed ceilings: int32 {rates['alu'] / 1e12:.4f} Tops/s "
          f"(the mix {rates['alu_mix'] / 1e12:.4f}), int8x4 "
          f"{rates['alu_int8x4'] / 1e12:.4f} Tops/s, "
          f"{rates['alu_instructions'] / 1e12:.4f} T ALU instructions/s, "
          f"device memory {rates['hbm'] / 1e9:.1f} GB/s; seen "
          f"{rates['seen']}", flush=True)
    return rates


def demonstrated_ceiling(rows: list[dict], rates: dict):
    """The final shares: each row against max(the probed int32 rate, the
    best rate a row demonstrates, ops / seconds) and the probed
    device-memory rate.  A kernel's own sustained rate proves the card can
    issue it, so the best row sits at 1.0 where it sets the ceiling.

    Returns ``(rows, ceiling, best)``: new rows without the ``_`` keys, with
    ``roofline_frac``, ``bound``, ``ceiling`` and, above 1.0,
    ``roofline_suspect``; the operations/s ceiling; and what set it
    ("probe" or "<code>@<iters>it").  Pure: the input rows are not
    changed."""
    ceiling = rates["alu"]
    best = "probe"
    for r in rows:
        demonstrated = r["_ops"] / r["_sec"]
        if demonstrated > ceiling:
            ceiling = demonstrated
            best = f"{r['code']}@{r['iters']}it"
    hbm = rates["hbm"]
    out = []
    for r in rows:
        sec, ops, nbytes = r["_sec"], r["_ops"], r["_bytes"]
        r = {k: v for k, v in r.items() if not k.startswith("_")}
        t_bound, r["bound"] = bound(ops, nbytes, ceiling, hbm)
        r["roofline_frac"] = t_bound / sec
        if r["bound"] == "operations":
            r["ceiling"] = f"measured(max of probe, demonstrated by {best})"
        if r["roofline_frac"] > 1.0:
            r["roofline_suspect"] = True
        out.append(r)
    return out, ceiling, best


def ckpt_path(out: str) -> str:
    return out + ".ckpt.json"


def _ckpt_save(path, rows, lat_rows, rates) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"rows": rows, "lat_rows": lat_rows, "rates": rates}, f)
    os.replace(tmp, path)


def _write(path, rows, lat_rows, rates, ceiling, best, card, failed) -> None:
    stamp = time.strftime("%Y-%m-%d")
    with open(path, "w") as f:
        f.write("# Benchmark suite (one card)\n\n")
        f.write(f"Measured {stamp} on {card} "
                "(`python -m ldpcgputegra_tpu_torch.bench.suite`); OMS, ET "
                f"off, {SNR_DB} dB, coded-bit throughput in the reference's "
                "accounting (`main.cpp:311-315`), CUDA-event slope timing.\n\n")
        seen = rates.get("seen", {})
        f.write(f"Probed ceilings: int32 {rates['alu'] / 1e12:.4f} Tops/s "
                f"(the best probe), {rates['alu_mix'] / 1e12:.4f} Tops/s on "
                f"the decoder's mix, int8x4 {rates['alu_int8x4'] / 1e12:.4f} "
                f"Tops/s, device memory {rates['hbm'] / 1e9:.1f} GB/s; SM "
                f"clock (min, median, max) {seen.get('clock_mhz')} MHz, "
                f"power {seen.get('power_w')} W while probing. Operations "
                f"ceiling {ceiling / 1e12:.4f} Tops/s (set by {best}).\n\n")
        f.write("| code | backend | iters | batch | ms/call | coded Mbit/s "
                "| roofline share | share at the mix's rate "
                "| vs best GPU baseline |\n")
        f.write("|---|---|---|---|---|---|---|---|---|\n")
        for r in rows:
            vs = (f"{r['vs_baseline']:.1f}x (vs {r['baseline_mbps']})"
                  if r.get("vs_baseline") else "—")
            flag = " SUSPECT" if r.get("roofline_suspect") else ""
            f.write(f"| {r['code']} | {r['backend']} | {r['iters']} "
                    f"| {r['batch']} | {r['ms_per_call']:.4f} "
                    f"| {r['coded_mbps']:.1f} | {r['roofline_frac']:.4f} "
                    f"({r['bound']}){flag} | {r['roofline_frac_mix']:.4f} "
                    f"| {vs} |\n")
        f.write(f"\nMinimum-batch latency ({LAT_BATCH} frames, 10 "
                "iterations; the reference's latency axis, "
                "`ldpc_decoder_arm/main.cpp:612-625`):\n\n")
        f.write("| code | backend | ms / call | us/frame | coded Mbit/s |\n")
        f.write("|---|---|---|---|---|\n")
        for r in lat_rows:
            f.write(f"| {r['code']} | {r['backend']} | {r['ms_per_call']:.4f} "
                    f"| {r['us_per_frame']:.2f} | {r['coded_mbps']:.1f} |\n")
        if failed:
            f.write("\nFailed rows: " + ", ".join(failed) + "\n")
        f.write("\nRaw records:\n\n```json\n")
        f.write(json.dumps({"rates": rates, "ceiling": ceiling,
                            "ceiling_set_by": best}) + "\n")
        for r in rows:
            f.write(json.dumps(r) + "\n")
        for r in lat_rows:
            f.write(json.dumps({"latency": True, **r}) + "\n")
        f.write("```\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="2 inputs and call counts 2/6 a row (else 6, 4/20)")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--fresh", action="store_true",
                    help="ignore (and overwrite) the checkpoint")
    ap.add_argument("--remeasure", action="store_true",
                    help="drop the checkpoint's rows but keep its probed "
                    "ceilings")
    ap.add_argument("--repeats", type=int, default=1,
                    help="the fastest of R measurements a row")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("suite: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    name, limit = smi_query("name,power.limit")
    card = f"{name}, {limit} W"
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    ckpt = ckpt_path(args.out)

    rows, lat_rows, rates = [], [], None
    if not args.fresh and os.path.exists(ckpt):
        with open(ckpt) as f:
            ck = json.load(f)
        rows, lat_rows, rates = ck["rows"], ck["lat_rows"], ck.get("rates")
        if args.remeasure:
            print(f"(II) --remeasure: dropping {len(rows)} rows "
                  f"(+{len(lat_rows)} latency), keeping the probed ceilings",
                  flush=True)
            rows, lat_rows = [], []
        else:
            print(f"(II) resuming: {len(rows)} rows + {len(lat_rows)} "
                  f"latency rows from {ckpt}", flush=True)
    if rates is None:
        rates = probe_rates(dev)
        _ckpt_save(ckpt, rows, lat_rows, rates)
    done = {(r["code"], r["iters"], r["batch"]) for r in rows}

    failed = []
    for ent in CONFIGS:
        cname, batch, baselines = ent[:3]
        for iters in (ent[3] if len(ent) > 3 else (10, 5)):
            if (cname, iters, batch) in done:
                continue
            t0 = time.time()
            try:
                r = bench_one(cname, batch, iters, args.quick, rates,
                              args.repeats, dev)
            except Exception:  # noqa: BLE001 -- reported; main exits non-zero
                traceback.print_exc()
                print(f"(EE) {cname}@{iters}it failed", flush=True)
                failed.append(f"{cname}@{iters}it")
                continue
            base = baselines.get(iters)
            r["baseline_mbps"] = base
            if base:
                r["vs_baseline"] = r["coded_mbps"] / base
            rows.append(r)
            _ckpt_save(ckpt, rows, lat_rows, rates)
            print(f"(PERF) {cname} {iters}it [{r['backend']}]: "
                  f"{r['ms_per_call']:.4f} ms, {r['coded_mbps']:.1f} coded "
                  f"Mbit/s, roofline {r['roofline_frac']:.4f} ({r['bound']}, "
                  f"{r['ceiling']} ceiling; {r['roofline_frac_mix']:.4f} at "
                  f"the mix's rate) [{time.time() - t0:.1f} s]",
                  flush=True)

    lat_done = {r["code"] for r in lat_rows}
    for cname in LAT_CONFIGS:
        if cname in lat_done:
            continue
        try:
            r = bench_latency(cname, 10, args.quick, args.repeats, dev)
        except Exception:  # noqa: BLE001 -- reported; main exits non-zero
            traceback.print_exc()
            print(f"(EE) latency {cname} failed", flush=True)
            failed.append(f"latency {cname}")
            continue
        lat_rows.append(r)
        _ckpt_save(ckpt, rows, lat_rows, rates)
        print(f"(PERF) latency {cname} [{r['backend']}]: "
              f"{r['ms_per_call']:.4f} ms a {LAT_BATCH}-frame call, "
              f"{r['us_per_frame']:.2f} us/frame", flush=True)

    final, ceiling, best = demonstrated_ceiling(rows, rates)
    for r in final:
        if r.get("roofline_suspect"):
            print(f"(EE) {r['code']}@{r['iters']}it roofline share "
                  f"{r['roofline_frac']:.4f} > 1 against the ceiling: "
                  "investigate before publishing", flush=True)
    print(f"(II) operations ceiling {ceiling / 1e12:.4f} Tops/s (set by "
          f"{best})", flush=True)
    _write(args.out, final, lat_rows, rates, ceiling, best, card, failed)
    print(f"(II) wrote {args.out}")
    if failed:
        print(f"(EE) {len(failed)} rows failed: {', '.join(failed)}",
              flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
