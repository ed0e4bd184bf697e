"""MRG32k3a streams and the seeded bulk generator.

Counterpart of ``tpudes/core/rng.py`` for what the port's scenario
functions draw: the AS flow endpoints (``RngStream(seed, 0, 0)``'s
``RandInt``, ``tpudes/scenarios.py:272-278``) and the BRITE generator's
bulk arrays (:func:`seeded_bulk_generator`, ``rng.py:184-206``).

:class:`RngStream` is L'Ecuyer's MRG32k3a at stream 0, substream 0 of a
seed (``rng.py:69-127``): stream 0 and substream 0 need no jump
matrices, and no other stream is ported.  The global ``RngSeed`` and
``RngRun`` of the reference (both 1 by default) are explicit arguments
of :func:`seeded_bulk_generator`.
"""

from __future__ import annotations

import numpy as np

# MRG32k3a's moduli and multipliers (L'Ecuyer 1999; ``rng.py:27-33``)
_M1 = 4294967087
_M2 = 4294944443
_A12 = 1403580
_A13N = 810728
_A21 = 527612
_A23N = 1370589
_NORM = 1.0 / (_M1 + 1)


class RngStream:
    """One MRG32k3a stream at ``(seed, 0, 0)`` (``rng.py:69-127``)."""

    __slots__ = ("_s1", "_s2")

    def __init__(self, seed: int, stream: int = 0, substream: int = 0):
        if stream or substream:
            raise NotImplementedError(
                "the port's RngStream holds stream 0, substream 0 only "
                "(the jump matrices are not ported)")
        # the scalar seed expanded into the six-value package seed
        s = int(seed) % _M1 or 12345
        self._s1 = [s, s, s]
        self._s2 = [s % _M2 or 12345] * 3

    def RandU01(self) -> float:  # noqa: N802 — the reference's name
        s1, s2 = self._s1, self._s2
        p1 = (_A12 * s1[1] - _A13N * s1[0]) % _M1
        s1[0], s1[1], s1[2] = s1[1], s1[2], p1
        p2 = (_A21 * s2[2] - _A23N * s2[0]) % _M2
        s2[0], s2[1], s2[2] = s2[1], s2[2], p2
        d = p1 - p2
        if d <= 0:
            d += _M1
        return d * _NORM

    def RandInt(self, low: int, high: int) -> int:  # noqa: N802
        return low + int(self.RandU01() * (high - low + 1))

    def get_state(self) -> tuple:
        return tuple(self._s1) + tuple(self._s2)


def seeded_bulk_generator(stream_id: int = 0, rng_seed: int = 1,
                          rng_run: int = 1) -> np.random.Generator:
    """``numpy.random.default_rng(SeedSequence((rng_seed, rng_run,
    stream_id)))``: the reference's bulk generator (``rng.py:184-206``)
    with its global seed and run (1 and 1 unless a caller sets them)
    passed explicitly."""
    return np.random.default_rng(np.random.SeedSequence(
        entropy=(int(rng_seed), int(rng_run), int(stream_id))))
