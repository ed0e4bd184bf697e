"""The fused WiFi PHY window: positions to decoded frames in one step.

Counterpart of ``tpudes/parallel/kernels.py`` (``:1-140``), the
reference's "TPU fast path": per conservative time window the (tx, rx)
PHY math of every replica is one kernel,

    positions -> pairwise distance -> log-distance loss -> rx power
    tx mask   -> SINR (every concurrent tx interferes) -> NIST or table PSR
    key       -> per-frame decode coins -> the rx mask ``ok``

:func:`wifi_phy_window` is one replica's window, :func:`replicated` the
same over a leading replica axis, and :func:`multi_window_scan` runs
``n_windows`` windows with Bernoulli(``tx_prob``) transmitters and counts
the frames decoded, for one key or a stack of replica keys.

On the card each is one launch of the hand-written kernel
``csrc/wifi_window.cu`` (:mod:`tpudes_torch.parallel.window_cuda`); on
the CPU the plain version below (:func:`window_math`, :func:`scan_math`)
runs.  Both compute the reference's arithmetic as its CPU executable does
(the optimised HLO of the jitted window, ``tests/test_torch_phy_window.py``
holds them to it):

- the distance, loss and rx power are the geometry stage's
  (:mod:`tpudes_torch.ops.propagation`): ``rx_dbm = tx - fma(log(max(d,
  1)), 10 n / ln 10, L0)``, ``rx_w = powf(10, ((tx - 30) - loss) 0.1)``,
  zero on the diagonal, times the tx mask;
- ``total_w[rx]`` sums ``rx_w[tx, rx]`` over ``tx`` in the compiled
  order: in blocks of 32 transmitters past 32 (:func:`sum_blocks`);
  ``sinr = rx_w / ((total_w - rx_w) + noise)``;
- the PSR resolves each transmitter's mode per element
  (:func:`tpudes_torch.ops.wifi_error.mode_table`); the compiler turns
  the QAM branch's ``sqrt(sinr / div)`` into ``sqrt(rx_w / (((total_w -
  rx_w) + noise) div))``, one division;
- the coins are ``uniform(key, (N, N))`` and window ``i`` of the scan
  draws ``k_tx, k_phy = split(fold_in(key, i))``
  (:func:`tpudes_torch.random.window_keys`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tpudes_torch.device import resolve_device
from tpudes_torch.ops import fused
from tpudes_torch.ops.interference import thermal_noise_w
from tpudes_torch.ops.propagation import (
    dbm_to_w,
    log_distance,
    log_distance_loss,
    pairwise_distance,
)
from tpudes_torch.ops.wifi_error import (
    ALL_MODES,
    TABLE_REF_SIZE_BYTES,
    log1p_neg_pe_at,
    mode_table,
    table_lg,
)
from tpudes_torch.random import uniform, window_keys

__all__ = ["WindowParams", "multi_window_scan", "replicated", "scan_math",
           "window_math", "wifi_phy_window"]

#: the error models a window takes
ERROR_MODELS = ("nist", "table")


@dataclass(frozen=True)
class WindowParams:
    """The window's static parameters (``kernels.py:35-53``)."""

    tx_power_dbm: float = 16.0206
    noise_figure_db: float = 7.0
    bandwidth_hz: float = 20e6
    path_loss_exponent: float = 3.0
    reference_loss_db: float = 46.6777
    rx_sensitivity_dbm: float = -101.0
    #: PER provider: "nist" (closed form) or "table" (the PER table)
    error_model: str = "nist"

    def __post_init__(self):
        if self.error_model not in ERROR_MODELS:
            raise ValueError(f"error_model must be one of {ERROR_MODELS}; "
                             f"got {self.error_model!r}")

    @property
    def noise_w(self) -> float:
        return float(thermal_noise_w(self.bandwidth_hz, self.noise_figure_db))


def geometry(positions: torch.Tensor, params: WindowParams):
    """``(rx_dbm, rx_w)`` of ``(..., N, 3)`` f32 positions, each ``(...,
    N, N)`` indexed ``[tx, rx]``: the rx power in dBm (finite on the
    diagonal, ``max(d, 1)``) and in W, 0 on the diagonal, before the tx
    mask."""
    d = pairwise_distance(positions)
    rx_dbm = log_distance(params.tx_power_dbm, d,
                          exponent=params.path_loss_exponent,
                          reference_loss_db=params.reference_loss_db)
    loss = log_distance_loss(d, params.path_loss_exponent,
                             reference_loss_db=params.reference_loss_db)
    n = positions.shape[-2]
    eye = torch.eye(n, dtype=torch.bool, device=positions.device)
    rx_w = torch.where(eye, fused.f32(d, 0.0),
                       dbm_to_w(params.tx_power_dbm, loss))
    return rx_dbm, rx_w


#: the compiled reduction's block: past it the CPU backend splits the sum
SUM_BLOCK = 32
#: the most nodes whose column sum takes two levels of blocks (past it the
#: backend adds a third level, not reproduced)
MAX_NODES = SUM_BLOCK * SUM_BLOCK


def sum_blocks(n: int) -> list:
    """The ``[lo, hi)`` row ranges of the compiled column sum over ``n``
    transmitters: one range up to :data:`SUM_BLOCK` rows, else the rows
    padded to a multiple of it (``pad // 2`` zeros in front, the rest
    behind) and cut in blocks of :data:`SUM_BLOCK` (the CPU backend's
    ``reduce-window`` of ``size=32 pad=lo_hi``, then a ``reduce`` of the
    blocks)."""
    if n > MAX_NODES:
        raise ValueError(f"the window's column sum holds N <= {MAX_NODES} "
                         f"nodes; got {n}")
    if n <= SUM_BLOCK:
        return [(0, n)]
    nb = -(-n // SUM_BLOCK)
    low = (nb * SUM_BLOCK - n) // 2
    return [(max(0, j * SUM_BLOCK - low), min(n, (j + 1) * SUM_BLOCK - low))
            for j in range(nb)]


def _column_sum(rx_w: torch.Tensor) -> torch.Tensor:
    """``sum(rx_w, axis=-2)`` in the compiled order: each block of
    :func:`sum_blocks` summed from its first row, then the blocks' sums
    in order, one rounding a term."""
    total = None
    for lo, hi in sum_blocks(rx_w.shape[-2]):
        acc = rx_w[..., lo, :]
        for i in range(lo + 1, hi):
            acc = acc + rx_w[..., i, :]
        total = acc if total is None else total + acc
    return total


def psr_math(rx_w, den, sinr, mode_idx, frame_bytes,
             params: WindowParams) -> torch.Tensor:
    """The ``(..., N, N)`` success rates of the window's frames: the
    transmitter's (row's) mode and size, NIST or table.  ``den`` is
    ``(total_w - rx_w) + noise``, the SINR's denominator."""
    mode = mode_idx.long()[..., :, None].expand_as(sinr)
    fb = frame_bytes[..., :, None]
    if params.error_model == "table":
        lg = table_lg(sinr, mode)
        scale = fb * fused.f32(fb, float(np.float32(8.0) / np.float32(
            8.0 * TABLE_REF_SIZE_BYTES)))
    else:
        div = mode_table(sinr.device)["div"][mode]
        qam_z = fused.sqrt(rx_w / (den * div))
        lg = log1p_neg_pe_at(sinr, mode, qam_z)
        scale = fb * 8.0
    return fused.exp(scale * lg)


def window_math(positions, tx_active, mode_idx, frame_bytes, coin,
                params: WindowParams = WindowParams()):
    """The plain window for a batch: ``positions`` ``(..., N, 3)`` f32,
    ``tx_active``, ``mode_idx`` (int) and ``frame_bytes`` (f32) ``(...,
    N)``, ``coin`` ``(..., N, N)`` f32 (``uniform(key, (N, N))``).
    Returns ``(ok, sinr, rx_dbm)``, each ``(..., N, N)`` indexed ``[tx,
    rx]``."""
    txf = tx_active.to(torch.float32)
    rx_dbm, rx_w = geometry(positions, params)
    rx_w = rx_w * txf[..., :, None]
    total = _column_sum(rx_w)
    den = (total[..., None, :] - rx_w) + fused.f32(rx_w, params.noise_w)
    sinr = rx_w / den
    psr = psr_math(rx_w, den, sinr, mode_idx, frame_bytes, params)
    n = positions.shape[-2]
    eye = torch.eye(n, dtype=torch.bool, device=positions.device)
    ok = ((coin < psr)
          & (rx_dbm >= fused.f32(rx_dbm, params.rx_sensitivity_dbm))
          & ((1.0 - txf) > 0.0)[..., None, :]
          & (txf > 0.0)[..., :, None]
          & ~eye)
    return ok, sinr, rx_dbm


def _tensor(x, dtype, dev) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x))
    return x.to(device=dev, dtype=dtype).contiguous()


def _key_tensor(key, dev) -> torch.Tensor:
    if isinstance(key, torch.Tensor):
        return key.to(device=dev, dtype=torch.int64).contiguous()
    return torch.as_tensor(np.asarray(key, dtype=np.int64), device=dev)


def _check_modes(mode_idx: torch.Tensor) -> None:
    if mode_idx.numel() and not (0 <= int(mode_idx.min())
                                 and int(mode_idx.max()) < len(ALL_MODES)):
        raise ValueError(f"mode indices must lie in 0..{len(ALL_MODES) - 1}")


def _windows(positions, tx_active, mode_idx, frame_bytes, keys,
             params: WindowParams, dev):
    """``R`` windows, ``(R, ...)`` inputs and ``(R, 2)`` keys: the plain
    version on the CPU, one launch of the kernel on the card."""
    pos = _tensor(positions, torch.float32, dev)
    tx = _tensor(tx_active, torch.bool, dev)
    mode = _tensor(mode_idx, torch.int32, dev)
    fb = _tensor(frame_bytes, torch.float32, dev)
    keys = _key_tensor(keys, dev)
    _check_modes(mode)
    if dev.type == "cuda":
        from tpudes_torch.parallel.window_cuda import window_launch

        return window_launch(pos, tx, mode, fb, keys, params)
    coin = uniform(keys, (pos.shape[-2], pos.shape[-2]))
    return window_math(pos, tx, mode, fb, coin, params)


def wifi_phy_window(positions, tx_active, mode_idx, frame_bytes, key,
                    params: WindowParams = WindowParams(), *, device=None):
    """One conservative window of the Yans PHY for one replica
    (``kernels.py:56-104``): ``positions`` ``(N, 3)`` f32, ``tx_active``
    ``(N,)`` bool or 0/1, ``mode_idx`` ``(N,)`` int (the transmitter's
    WifiMode), ``frame_bytes`` ``(N,)`` f32, ``key`` a ``(2,)`` threefry
    key.  Returns ``(ok, sinr, rx_dbm)``, ``(N, N)`` tensors indexed
    ``[tx, rx]``: ``ok[t, r]`` is True where ``r`` decodes ``t``'s frame.
    ``device`` defaults to the card (one launch of the kernel)."""
    dev = resolve_device(device)
    ok, sinr, rx_dbm = _windows(
        _tensor(positions, torch.float32, dev)[None],
        _tensor(tx_active, torch.bool, dev)[None],
        _tensor(mode_idx, torch.int32, dev)[None],
        _tensor(frame_bytes, torch.float32, dev)[None],
        _key_tensor(key, dev)[None], params, dev)
    return ok[0], sinr[0], rx_dbm[0]


def replicated(kernel=wifi_phy_window):
    """A window kernel over a leading replica axis (``kernels.py:107-116``):
    every array argument gains a leading ``R``; ``params`` stays shared.
    :func:`wifi_phy_window` runs all ``R`` replicas as one batch (one
    launch on the card); another kernel runs once a replica."""

    def run(positions, tx_active, mode_idx, frame_bytes, keys,
            params: WindowParams = WindowParams(), *, device=None):
        dev = resolve_device(device)
        if kernel is wifi_phy_window:
            return _windows(positions, tx_active, mode_idx, frame_bytes,
                            keys, params, dev)
        outs = [kernel(positions[r], tx_active[r], mode_idx[r],
                       frame_bytes[r], keys[r], params, device=dev)
                for r in range(len(keys))]
        return tuple(torch.stack(o) for o in zip(*outs))

    return run


def scan_math(positions, tx_prob, mode_idx, frame_bytes, keys,
              n_windows: int) -> torch.Tensor:
    """The plain scan: windows ``0 .. n_windows - 1`` of every replica of
    ``keys`` ``(R, 2)`` over the shared ``positions`` ``(N, 3)``,
    ``mode_idx`` and ``frame_bytes`` ``(N,)`` and ``tx_prob`` (a scalar or
    ``(N,)``, f32), NIST at the default parameters.  Window ``i`` draws
    ``k_tx, k_phy = split(fold_in(key, i))``, its transmitters
    ``uniform(k_tx, (N,)) < tx_prob`` and its coins ``uniform(k_phy, (N,
    N))``.  Returns the ``(R,)`` int32 counts of decoded frames."""
    params = WindowParams()
    n = positions.shape[0]
    rx_dbm, rx_w0 = geometry(positions, params)
    total = torch.zeros(keys.shape[0], dtype=torch.int32,
                        device=positions.device)
    for i in range(n_windows):
        kk = window_keys(keys, torch.tensor([i], device=keys.device))[:, 0]
        tx = uniform(kk[:, 0], n) < tx_prob
        coin = uniform(kk[:, 1], (n, n))
        txf = tx.to(torch.float32)
        rx_w = rx_w0 * txf[:, :, None]
        tot = _column_sum(rx_w)
        den = (tot[:, None, :] - rx_w) + fused.f32(rx_w, params.noise_w)
        sinr = rx_w / den
        psr = psr_math(rx_w, den, sinr, mode_idx[None].expand_as(tx),
                       frame_bytes[None].expand_as(txf), params)
        eye = torch.eye(n, dtype=torch.bool, device=positions.device)
        ok = ((coin < psr)
              & (rx_dbm >= fused.f32(rx_dbm, params.rx_sensitivity_dbm))
              & ((1.0 - txf) > 0.0)[:, None, :]
              & (txf > 0.0)[:, :, None] & ~eye)
        total = total + ok.sum((1, 2), dtype=torch.int32)
    return total


def multi_window_scan(positions, tx_prob, mode_idx, frame_bytes, key,
                      n_windows: int = 16, *, device=None) -> torch.Tensor:
    """``n_windows`` consecutive windows with Bernoulli(``tx_prob``)
    transmitters, the frames decoded summed (``kernels.py:119-140``): a
    ``(2,)`` key gives the 0-dim int32 total, an ``(R, 2)`` stack of keys
    the ``(R,)`` totals of ``jax.vmap(multi_window_scan, in_axes=(None,
    None, None, None, 0))``.  ``positions`` ``(N, 3)``, ``mode_idx`` and
    ``frame_bytes`` ``(N,)`` are shared; ``tx_prob`` is a scalar or
    ``(N,)``.  ``device`` defaults to the card, where the whole scan is
    one launch of the kernel (a CTA per window and replica)."""
    dev = resolve_device(device)
    pos = _tensor(positions, torch.float32, dev)
    mode = _tensor(mode_idx, torch.int32, dev)
    fb = _tensor(frame_bytes, torch.float32, dev)
    prob = torch.broadcast_to(_tensor(tx_prob, torch.float32, dev),
                              (pos.shape[0],)).contiguous()
    keys = _key_tensor(key, dev)
    single = keys.dim() == 1
    keys = keys.reshape(-1, 2).contiguous()
    _check_modes(mode)
    if int(n_windows) < 0:
        raise ValueError(f"n_windows must be >= 0; got {n_windows}")
    if dev.type == "cuda":
        from tpudes_torch.parallel.window_cuda import scan_launch

        total = scan_launch(pos, prob, mode, fb, keys, int(n_windows))
    else:
        total = scan_math(pos, prob, mode, fb, keys, int(n_windows))
    return total[0] if single else total
