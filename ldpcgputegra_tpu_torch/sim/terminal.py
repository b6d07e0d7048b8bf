"""Live terminal reporting (reference M2, CTerminal).

Reproduces the reference's observable report shape: a ~1 Hz carriage-return
live line with frames, FE, FER, BE, BER, BE/FE, frames/min, Mbps, elapsed
and ETA (``code/gpu_fixed/terminal/CTerminal.cpp:17-49``), and a one-line
``final_report`` per SNR point (``:53-63``).  Additionally emits structured
JSONL records when given a metrics sink (an aux capability the reference
lacks; SURVEY §5.5).
"""

from __future__ import annotations

import json
import sys
import time
from typing import IO, Optional

from .analyzer import ErrorAnalyzer

__all__ = ["Terminal", "fmt_hms"]


def fmt_hms(seconds: float) -> str:
    s = int(seconds)
    return f"{s // 3600:02d}h{(s // 60) % 60:02d}'{s % 60:02d}"


class Terminal:
    def __init__(
        self,
        analyzer: ErrorAnalyzer,
        snr_db: float,
        metrics: Optional[IO[str]] = None,
        out: IO[str] = sys.stdout,
        interval_s: float = 1.0,
        start_elapsed: float = 0.0,
    ):
        self.analyzer = analyzer
        self.snr_db = snr_db
        self.metrics = metrics
        self.out = out
        self.interval_s = interval_s
        # start_elapsed: wall seconds already spent on this point before a
        # checkpoint resume; keeps rates consistent with the accumulated
        # pre-resume counters in the analyzer.
        self.t0 = time.monotonic() - start_elapsed
        self._last = 0.0

    def elapsed(self) -> float:
        return time.monotonic() - self.t0

    def _rates(self) -> tuple[float, float]:
        """(frames/min, coded Mbps) over elapsed wall time."""
        el = max(self.elapsed(), 1e-9)
        a = self.analyzer
        fpm = 60.0 * a.frames / el
        mbps = a.frames * a.n / el / 1.0e6
        return fpm, mbps

    def temp_report(self, force: bool = False) -> None:
        now = time.monotonic()
        if not force and now - self._last < self.interval_s:
            return
        self._last = now
        a = self.analyzer
        fpm, mbps = self._rates()
        if a.frame_errors:
            eta = (self.elapsed() / a.frame_errors) * a.fe_limit()
            eta_s = fmt_hms(eta)
            ber, fer = a.ber, a.fer
            be_fe = a.bit_errors / a.frame_errors
        else:
            # no errors yet: report the resolvable bound like the reference
            ber = 1.0 / max(a.frames, 1) / a.counted_bits
            fer = 1.0 / max(a.frames, 1)
            be_fe = 0.0
            eta_s = "INF."
        self.out.write(
            f"(RT) FRA: {a.frames:8d} | FE: {a.frame_errors:3d} | "
            f"FER: {fer:2.2e} | BE: {a.bit_errors:5d} | BER: {ber:2.2e} | "
            f"[BE/FE]: {be_fe:4.1f} | FPM: {fpm:5.0f} | MBPS: {mbps:6.2f} | "
            f"ETA: {fmt_hms(self.elapsed())} | ETR: {eta_s}\r"
        )
        self.out.flush()

    def final_report(self) -> dict:
        a = self.analyzer
        _, mbps = self._rates()
        rec = {
            "snr_db": self.snr_db,
            "ber": a.ber,
            "fer": a.fer,
            "mbps": mbps,
            "frames": a.frames,
            "fe": a.frame_errors,
            "be": a.bit_errors,
            "runtime_s": self.elapsed(),
        }
        be_fe = a.bit_errors / a.frame_errors if a.frame_errors else 0.0
        self.out.write(
            f"SNR = {self.snr_db:.2f} | BER = {a.ber:2.3e} | "
            f"FER = {a.fer:2.3e} | MBPS = {mbps:6.2f} | "
            f"MATRICES = {a.frames:10d} | FE = {a.frame_errors} | "
            f"BE = {a.bit_errors} | BE/FE = {be_fe:.1f} | "
            f"RUNTIME = {fmt_hms(self.elapsed())}\n"
        )
        self.out.flush()
        if self.metrics is not None:
            self.metrics.write(json.dumps({"type": "snr_point", **rec}) + "\n")
            self.metrics.flush()
        return rec
