"""Pipelined decode stream — the library-surface form of the reference's
``decode_stream`` (``CGPUDecoder.h:20-37``, per-stream overlap in
``code/gpu_fixed/test.cpp:345-420``); the port's counterpart of
``ldpcgputegra_tpu/decoder/stream.py``.

A stream is a bounded window of in-flight batches on one CUDA stream (the
current one; the JAX package has no multi-stream scheme either).
``submit`` queues a batch's decode and a device-to-host copy of its bits
and ``iters_used`` into pinned memory, records an event after them and
returns; ``get`` returns results in submission order, each waiting only
on its own event, so a result is materialized only when asked for.
``depth`` bounds the batches in flight (the reference's W streams bound
its pinned buffers).  On the CPU the decode runs at ``submit``.
"""

from __future__ import annotations

from collections import deque
from typing import Iterator, Optional

import numpy as np
import torch

from ..codes.code import LdpcCode
from ..ops.layered import LayeredSpec
from . import default_device, make_decoder

__all__ = ["DecodeStream"]


class DecodeStream:
    def __init__(
        self,
        code: LdpcCode,
        spec: LayeredSpec = LayeredSpec(),
        backend: str = "auto",
        depth: int = 4,
        device=None,
    ):
        self.device = (torch.device(device) if device is not None
                       else default_device())
        self._decode = make_decoder(code, spec, backend=backend,
                                    device=self.device)
        self.depth = max(1, depth)
        self._inflight: deque = deque()
        self._ready_cache: list = []

    def submit(self, llr: torch.Tensor) -> None:
        """Queue a batch; waits (for the oldest result, moved to the ready
        queue) only when the window is full."""
        if len(self._inflight) >= self.depth:
            self._ready_cache.append(self._finish(self._inflight.popleft()))
        bits, iters = self._decode(llr)
        if bits.device.type != "cuda":
            self._inflight.append((bits, iters, None))
            return
        h_bits = torch.empty(bits.shape, dtype=bits.dtype, pin_memory=True)
        h_iters = torch.empty((), dtype=iters.dtype, pin_memory=True)
        h_bits.copy_(bits, non_blocking=True)
        h_iters.copy_(iters, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        self._inflight.append((h_bits, h_iters, done))

    @staticmethod
    def _finish(item) -> tuple[np.ndarray, int]:
        bits, iters, done = item
        if done is not None:
            done.synchronize()
        return bits.numpy(), int(iters)

    def get(self) -> Optional[tuple[np.ndarray, int]]:
        """Next result in submission order, (bits [B, N] uint8, iters_used);
        None when nothing is pending."""
        if self._ready_cache:
            return self._ready_cache.pop(0)
        if self._inflight:
            return self._finish(self._inflight.popleft())
        return None

    def drain(self) -> Iterator[tuple[np.ndarray, int]]:
        """Yield all remaining results in order."""
        while True:
            r = self.get()
            if r is None:
                return
            yield r

    @property
    def pending(self) -> int:
        return len(self._inflight) + len(self._ready_cache)
