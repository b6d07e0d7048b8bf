"""Staircase (DVB-S2-family) detection — the part of
``ldpcgputegra_tpu/codes/dvbs2.py`` the port needs so far.

The JAX package decodes a staircase code through its Z=360 QC view
(``to_qc_form``, chosen by ``decoder/__init__.py::effective_code``), which
runs the QC kernels in the view's check order.  Until that view is ported
(ROADMAP queue 1 item 11) the port refuses staircase codes, so that no
backend decodes them in another check order than the JAX package does.
``is_staircase`` tells them apart; ``_check_rows_in_parity_order`` is
copied from ``ldpcgputegra_tpu/channel/encoder.py`` (importing that module
would load jax).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .code import LdpcCode

__all__ = ["is_staircase"]


def _check_rows_in_parity_order(code: LdpcCode) -> Optional[list[np.ndarray]]:
    """Recover original staircase row order from parity-column membership.

    In a dual-diagonal (staircase) code, original check row ``i`` contains
    parity VNs {K+i-1, K+i} (row 0: just {K}).  Degree-class sorting loses
    row order; this maps each check back, returning for each original row
    the index arrays of its *info* VNs, or None if the code isn't staircase.
    """
    K, M = code.K, code.n_checks
    rows_info: list[Optional[np.ndarray]] = [None] * M
    for ci in code.class_idx:
        for c in range(ci.shape[0]):
            vns = ci[c]
            par = np.sort(vns[vns >= K]) - K
            info = vns[vns < K]
            if par.size == 1 and par[0] == 0:
                row = 0
            elif par.size == 2 and par[1] == par[0] + 1:
                row = int(par[1])
            else:
                return None
            if rows_info[row] is not None:
                return None
            rows_info[row] = info
    if any(r is None for r in rows_info):
        return None
    return rows_info  # type: ignore[return-value]


def is_staircase(code: LdpcCode) -> bool:
    return _check_rows_in_parity_order(code) is not None
