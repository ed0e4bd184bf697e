"""Threefry-2x32 counter-based draws, bit-equal to ``jax.random``.

Reproduces the chain the LTE SM engine draws its HARQ decode coins
from, under jax 0.9.0 defaults (``threefry2x32`` keys,
``jax_threefry_partitionable=True``, x64 off):

    replica_keys(PRNGKey(s), R)[r] -> fold_in(., t) -> uniform(., (U,), f32)

(``tpudes/parallel/runtime.py:130``, ``tpudes/parallel/lte_sm.py:678``,
``:423``), and the chain the WiFi BSS engine draws its backoffs and
decode coins from, step first, then replica (``tpudes/parallel/
replicated.py:744-770``):

    fold_in(fold_in(key, step), r) -> split -> uniform(., (N,), f32) x 2

with, in an A-MPDU program, ``uniform(., (N, K), f32)`` from the
second key; the TCP dumbbell's slot draws (``tpudes/parallel/
tcp_dumbbell.py:843-862``), slot first, then replica:

    fold_in(fold_in(key, t), r) -> uniform(., (), f32)

or, under RED, ``split(., 3)`` into a scalar, an ``(F,)`` and a scalar
draw (:func:`tcp_draws`); a traffic program's per-replica keys
``fold_in(fold_in(key, 0x7A), r)`` (:func:`traffic_keys`,
``replicated.py:727-737``); and the AS flow engine's rate jitter
(``tpudes/parallel/as_flows.py:633-644``), a standard normal per flow:

    fold_in(key, r) -> normal(., (F,), f32)

(:func:`normal`, :func:`as_replica_draws`); and the wired engine's CBR
phase jitter (``tpudes/parallel/wired.py:391-426``), one integer per
replica and flow:

    randint(fold_in(fold_in(key, r), f), 0, jitter + 1)

(:func:`randint`, :func:`wired_jitter`).

A key is an int64 tensor ``(..., 2)`` holding the two uint32 words; torch's unsigned arithmetic is thin, so every 32-bit word rides
in int64 and is masked with ``& 0xFFFFFFFF`` after each add and shift.
All functions broadcast over leading key axes, so a chunk of TTIs for
every replica is drawn in one vectorised call.
"""

from __future__ import annotations

import numpy as np
import torch

from tpudes_torch.ops.fused import erf_inv

MASK32 = 0xFFFFFFFF
#: fold tag of the run's traffic key: ``fold_in(key, TRAFFIC_KEY_TAG)``
#: (``tpudes/traffic/device.py:50``, ``lte_sm.py:1016``)
TRAFFIC_KEY_TAG = 0x7A
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA


def threefry2x32(k0, k1, x0, x1):
    """The 20-round Threefry-2x32 hash of counter words ``(x0, x1)``
    under key words ``(k0, k1)`` (all int64 holding uint32, broadcast
    together); returns the two output words.  The rounds work in place
    on the two words' own buffers (the inputs are not written)."""
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (x0 + k0) & MASK32
    x1 = (x1 + k1) & MASK32
    if x0.shape != x1.shape:
        x0, x1 = (x.contiguous() for x in torch.broadcast_tensors(x0, x1))
    low = torch.empty_like(x1)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(MASK32)
            torch.bitwise_right_shift(x1, 32 - r, out=low)
            x1.bitwise_left_shift_(r).bitwise_or_(low).bitwise_and_(MASK32)
            x1.bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(MASK32)
        x1.add_(ks[(i + 2) % 3]).add_(i + 1).bitwise_and_(MASK32)
    return x0, x1


def PRNGKey(seed: int, device=None) -> torch.Tensor:  # noqa: N802 — jax's name
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: words
    ``(0, seed & 0xFFFFFFFF)``."""
    seed = int(seed)
    if not -(2**31) <= seed < 2**32:
        raise ValueError(f"seed {seed} does not fit 32 bits")
    return torch.tensor([0, seed & MASK32], dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: hash of the counter pair
    ``(0, data)`` under ``key``.  ``data`` (int or int tensor)
    broadcasts against the key's leading axes.  An int is filled on the
    key's device (no copy from the host, which would synchronise)."""
    if isinstance(data, (int, np.integer)):
        data = torch.full((), int(data), dtype=torch.int64, device=key.device)
    else:
        data = torch.as_tensor(data, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(
        key[..., 0], key[..., 1], torch.zeros_like(data), data & MASK32
    )
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def split(key: torch.Tensor) -> torch.Tensor:
    """``jax.random.split(key)``: ``(..., 2, 2)``, the two new keys.  In
    partitionable mode key ``i`` hashes the counter pair ``(0, i)``, so
    it is ``fold_in(key, i)``."""
    return fold_in(key[..., None, :], torch.arange(2, device=key.device))


def replica_keys(key: torch.Tensor, n: int) -> torch.Tensor:
    """``(n, 2)`` per-replica keys; row ``i`` is ``fold_in(key, i)``
    (``tpudes/parallel/runtime.py:130``)."""
    return fold_in(key[None, :], torch.arange(n, device=key.device))


def random_bits32(key: torch.Tensor, n: int) -> torch.Tensor:
    """``(..., n)`` 32-bit draws of ``jax.random.bits`` in partitionable
    mode: word pair ``(hi, lo)`` of the flat index hashed, then the two
    output words xor-ed."""
    if n >= 2**32:
        raise ValueError("draws past 2**32 elements need the hi word")
    lo = torch.arange(n, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(
        key[..., 0:1], key[..., 1:2], torch.zeros_like(lo), lo
    )
    return y0 ^ y1


def uniform(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32)`` over ``[0, 1)``:
    ``shape`` an int ``n`` (``(n,)``) or a tuple; the bits are drawn at
    the flat index of each element (partitionable mode), and the top 23
    become the mantissa of a float in ``[1, 2)``, minus 1."""
    if isinstance(shape, int):
        return _unit(random_bits32(key, shape))
    shape = tuple(int(d) for d in shape)
    n = 1
    for d in shape:
        n *= d
    bits = random_bits32(key, n)
    return _unit(bits).reshape(*bits.shape[:-1], *shape)


def _unit(bits: torch.Tensor) -> torch.Tensor:
    """f32 in ``[0, 1)`` from 32 random bits (in int64)."""
    mant = (bits >> 9) | 0x3F800000
    return mant.to(torch.int32).view(torch.float32) - 1.0


def window_keys(key: torch.Tensor, windows) -> torch.Tensor:
    """``(..., W, 2, 2)``: window ``i``'s ``(k_tx, k_phy) = split(fold_in(
    key, i))`` for each ``i`` of ``windows`` (an int ``W``: ``0..W-1``, or
    an int tensor), broadcast over the key's leading axes
    (``tpudes/parallel/kernels.py:132-133``)."""
    if isinstance(windows, int):
        windows = torch.arange(windows, dtype=torch.int64, device=key.device)
    return split(fold_in(key[..., None, :], windows))


def tti_coins(keys: torch.Tensor, t0: int, t1: int, n_ue: int) -> torch.Tensor:
    """``(t1 - t0, R, U)`` decode coins of TTIs ``[t0, t1)`` for the
    ``(R, 2)`` replica keys: ``uniform(fold_in(keys[r], t), (U,))``
    for the whole chunk in one vectorised call."""
    t = torch.arange(t0, t1, dtype=torch.int64, device=keys.device)
    kt = fold_in(keys[None, :, :], t[:, None])              # (T, R, 2)
    return uniform(kt, n_ue)


def bss_draws(key: torch.Tensor, s0: int, s1: int, replicas: int,
              n: int, coin_keys: bool = False):
    """``(u_back, u_coin)``: the BSS step's draws for steps ``[s0, s1)``
    and every replica in one vectorised call.  Step ``s``, replica ``r``
    draws ``k_back, k_coin = split(fold_in(fold_in(key, s), r))``, then
    ``uniform(k_back, (N,))`` and ``uniform(k_coin, (N,))``, each
    ``(s1 - s0, R, N)``.  An A-MPDU program draws ``uniform(k_coin, (N,
    K))`` in place of the second (``replicated.py:748-757``): with
    ``coin_keys`` the second is ``k_coin`` itself, ``(s1 - s0, R, 2)``,
    for :func:`mpdu_coins`."""
    steps = torch.arange(s0, s1, dtype=torch.int64, device=key.device)
    ks = fold_in(key[None, :], steps)                        # (S, 2)
    kr = fold_in(ks[:, None, :], torch.arange(replicas, device=key.device))
    kk = split(kr)                                           # (S, R, 2, 2)
    u_back = uniform(kk[..., 0, :], n)
    if coin_keys:
        return u_back, kk[..., 1, :]
    return u_back, uniform(kk[..., 1, :], n)


def mpdu_coins(k_coin: torch.Tensor, nodes: torch.Tensor,
               mpdus: int) -> torch.Tensor:
    """``(G, K)``: rows of the ``(N, K)`` MPDU coins, hashed only where
    they are needed: row ``g`` is ``uniform(k_coin[g], (N, K))[nodes[g]]``
    (the flat index ``i K + j`` is the threefry counter) for ``G`` coin
    keys (:func:`bss_draws` with ``coin_keys``) and nodes."""
    j = torch.arange(mpdus, dtype=torch.int64, device=k_coin.device)
    lo = nodes.to(torch.int64)[:, None] * mpdus + j[None, :]
    y0, y1 = threefry2x32(k_coin[:, 0:1], k_coin[:, 1:2],
                          torch.zeros_like(lo), lo)
    return _unit(y0 ^ y1)


def traffic_keys(key: torch.Tensor, replicas: int) -> torch.Tensor:
    """``(R, 2)`` per-replica traffic keys ``fold_in(fold_in(key,
    0x7A), r)`` of the WiFi BSS, pure in the run's key
    (``replicated.py:727-737``)."""
    tr_key = fold_in(key, TRAFFIC_KEY_TAG)
    return fold_in(tr_key[None, :], torch.arange(replicas,
                                                 device=key.device))


def tcp_draws(key: torch.Tensor, t0: int, t1: int, replicas: int,
              n_flows: int, red: bool = False):
    """``(u_dep, u_red, u_mark)``: the dumbbell step's draws for slots
    ``[t0, t1)`` and every replica in one vectorised call, each ``(t1 -
    t0, R, ...)``.  Slot ``t``, replica ``r`` keys ``kk = fold_in(
    fold_in(key, t), r)`` (``tcp_dumbbell.py:843``).  Without RED
    ``u_dep = uniform(kk, ())`` and the other two are None; with RED
    ``split(kk, 3)`` (in partitionable mode ``fold_in(kk, i)``) gives the
    scalar ``u_dep``, the ``(F,)`` ``u_red`` and the scalar ``u_mark``
    (``:846-858``)."""
    slots = torch.arange(t0, t1, dtype=torch.int64, device=key.device)
    kt = fold_in(key[None, :], slots)                        # (T, 2)
    kk = fold_in(kt[:, None, :],
                 torch.arange(replicas, device=key.device))  # (T, R, 2)
    if not red:
        return uniform(kk, 1)[..., 0], None, None
    k3 = fold_in(kk[..., None, :], torch.arange(3, device=key.device))
    return (uniform(k3[..., 0, :], 1)[..., 0], uniform(k3[..., 1, :], n_flows),
            uniform(k3[..., 2, :], 1)[..., 0])


#: ``jax.random.normal``'s lower bound, ``nextafter(-1, 0)`` in f32
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
#: ``sqrt(2)`` in f32
_SQRT2 = float(np.float32(np.sqrt(2.0)))


def normal(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)`` as jax 0.9 draws it
    (``jax/_src/random.py::_normal_real``): ``u = uniform(key, shape,
    lo, 1)`` with ``lo = nextafter(-1, 0)`` (the unit float times ``1 -
    lo``, which is 2 in f32, plus ``lo``, clamped below at ``lo``), then
    ``sqrt(2) * erf_inv(u)`` with the compiled ``erf_inv``
    (:func:`tpudes_torch.ops.fused.erf_inv`).  Broadcasts over the key's
    leading axes as :func:`uniform` does."""
    unit = uniform(key, shape)
    lo = torch.full((), _NORMAL_LO, dtype=torch.float32, device=key.device)
    u = torch.maximum(lo, unit * 2.0 + lo)
    return erf_inv(u) * _SQRT2


def as_replica_draws(key: torch.Tensor, replicas: int,
                     n_flows: int) -> torch.Tensor:
    """``(R, F)`` f32 rate-jitter draws of the AS flow engine: row ``r``
    is ``normal(fold_in(key, r), (F,))`` (``tpudes/parallel/as_flows.py:
    633-644``), independent of the other rows."""
    return normal(replica_keys(key, replicas), n_flows)


def randint(key: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """``jax.random.randint(key, (), lo, hi)`` for int32, bit for bit
    (``jax/_src/random.py::_randint``): ``k1, k2 = split(key)``, a 32-bit
    draw from each, ``span = hi - lo`` (1 where ``hi <= lo``), the
    multiplier ``(2^16 % span)^2 % span``, and ``(hi_bits % span *
    multiplier + lo_bits % span) % span + lo``, every product and sum
    wrapped to 32 bits as uint32 wraps (the square too: past a span of
    2^16 it wraps to 0).  Broadcasts over the key's leading
    axes; returns int64 holding the int32 values."""
    lo, hi = int(lo), int(hi)
    if not (-(2**31) <= lo < 2**31 and -(2**31) <= hi < 2**31):
        raise ValueError(f"randint takes int32 bounds; got {lo}, {hi}")
    span = max(hi - lo, 1)
    mult = ((2**16 % span) ** 2 & MASK32) % span
    k = split(key)
    hi_bits = random_bits32(k[..., 0, :], 1)[..., 0]
    lo_bits = random_bits32(k[..., 1, :], 1)[..., 0]
    off = ((hi_bits % span) * mult) & MASK32
    off = ((off + lo_bits % span) & MASK32) % span
    return off + lo


def wired_jitter(key: torch.Tensor, replicas: int, flow_ids,
                 jitter: int, replica_offset: int = 0) -> torch.Tensor:
    """``(R, F)`` int32 CBR phases of the wired engine
    (``tpudes/parallel/wired.py:391`` ``_replica_jitter``): entry ``(r,
    f)`` is ``randint(fold_in(fold_in(key, replica_offset + r),
    flow_ids[f]), 0, jitter + 1)``, a pure function of the global replica
    index and the global flow id, so a rank that carries a subset of the
    flows, or a process that runs a slice of the replicas, draws the same
    phases as one whole run (``flow_ids`` numpy, or an int64 tensor on
    the key's device).  Zeros where ``jitter <= 0``."""
    ids = (flow_ids if isinstance(flow_ids, torch.Tensor) else
           torch.as_tensor(np.asarray(flow_ids, np.int64), device=key.device))
    if jitter <= 0:
        return torch.zeros((int(replicas), ids.shape[0]), dtype=torch.int32,
                           device=key.device)
    rows = torch.arange(int(replicas), device=key.device) + int(
        replica_offset)
    kr = fold_in(key[None, :], rows)                          # (R, 2)
    krf = fold_in(kr[:, None, :], ids[None, :])               # (R, F, 2)
    return randint(krf, 0, int(jitter) + 1).to(torch.int32)
