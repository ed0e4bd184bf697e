"""HARQ and RBG constants of the FF-MAC schedulers.

Copies of ``tpudes/models/lte/scheduler.py:26-40``.
"""

from __future__ import annotations

HARQ_RTT_TTIS = 8
HARQ_MAX_TX = 4  # 1 first tx + 3 retransmissions


def rbg_size_for(n_rb: int) -> int:
    """TS 36.213 table 7.1.6.1-1 type-0 RBG sizes."""
    if n_rb <= 10:
        return 1
    if n_rb <= 26:
        return 2
    if n_rb <= 63:
        return 3
    return 4
