"""The fused WiFi PHY window as a CUDA kernel: the wrapper.

``csrc/wifi_window.cu`` replaces the reference's window
(``tpudes/parallel/kernels.py:56-116``, ``wifi_phy_window`` and its vmap
over replicas; XLA code, no ``pallas_call``) and its scan (``:119-140``,
``multi_window_scan``, vmapped over replica keys).  Three wrappers, each
launching one kernel:

- :func:`window_launch`: one CTA a replica; ``ok``, ``sinr`` and
  ``rx_dbm`` of every ``(tx, rx)`` pair, NIST or table;
- :func:`geometry_launch`: the scan's shared geometry, each pair's rx
  power in W and whether it clears the sensitivity;
- :func:`scan_launch`: the geometry, then one CTA a (window, replica),
  each adding its decoded frames to its replica's count with an integer
  atomic.

Each equals its plain version (:func:`tpudes_torch.parallel.kernels.
window_math`, :func:`~tpudes_torch.parallel.kernels.geometry`,
:func:`~tpudes_torch.parallel.kernels.scan_math`) bit for bit.  Every
launch is counted in :data:`tpudes_torch.parallel.kernels_cuda.launches`
under ``wifi_window`` (a scan is two), the geometry's also under
``wifi_window:geometry``, the scan kernel's under ``wifi_window:scan``
and those of the table model under ``wifi_window:table``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tpudes_torch.ops import fused
from tpudes_torch.ops.propagation import _folded
from tpudes_torch.ops.wifi_error import (
    TABLE_REF_SIZE_BYTES,
    _DB_PER_LN,
    mode_table,
    per_table_f32,
)
from tpudes_torch.parallel.kernels import MAX_NODES, WindowParams
from tpudes_torch.parallel.kernels_cuda import _check, _launch

#: a mode's row of the kernel's per-mode table (MODE_COLS in the .cu)
MODE_COLUMNS = ("constellation", "div", "factor", "b", "log_c", "exps")


def mode_args(device) -> tuple:
    """``(modes, keep)``: the per-mode table as the kernel reads it, ``(M,
    24)`` f32 rows of :data:`MODE_COLUMNS` (the ten ``log_c``, then the
    ten ``exps``), and ``(M,)`` int32 masks of the nonzero weights, from
    :func:`~tpudes_torch.ops.wifi_error.mode_table` (the same numbers the
    plain version uses)."""
    t = mode_table(device)
    modes = torch.cat([t["constellation"][:, None], t["div"][:, None],
                       t["factor"][:, None], t["b"][:, None], t["log_c"],
                       t["exps"]], dim=1).contiguous()
    bits = 1 << torch.arange(t["keep"].shape[1], device=t["keep"].device)
    keep = (t["keep"].long() * bits).sum(1).to(torch.int32).contiguous()
    return modes, keep


def link_args(params: WindowParams) -> list:
    """The link's f32 constants: tx dBm, tx - 30, the loss's slope ``10 n /
    ln 10`` and intercept, the sensitivity and the noise
    (:func:`tpudes_torch.parallel.kernels.geometry`'s numbers)."""
    f = ctypes.c_float
    return [f(params.tx_power_dbm),
            f(float(np.float32(params.tx_power_dbm) - np.float32(30.0))),
            f(_folded(10.0 * params.path_loss_exponent)),
            f(params.reference_loss_db), f(params.rx_sensitivity_dbm),
            f(params.noise_w)]


def _nodes(n: int) -> None:
    if not 1 <= n <= MAX_NODES:
        raise ValueError(f"wifi_window holds 1..{MAX_NODES} nodes; got {n}")


def window_launch(pos: torch.Tensor, tx: torch.Tensor, mode: torch.Tensor,
                  fb: torch.Tensor, keys: torch.Tensor,
                  params: WindowParams):
    """Launch the window once for ``R`` replicas: ``pos`` ``(R, N, 3)``
    f32, ``tx`` ``(R, N)`` bool, ``mode`` ``(R, N)`` int32, ``fb`` ``(R,
    N)`` f32, ``keys`` ``(R, 2)`` int64, all on the card.  Returns ``(ok,
    sinr, rx_dbm)``, ``(R, N, N)`` in fresh tensors.  Raises on a bad
    argument or a launch error; never takes the plain version."""
    dev = keys.device
    R, N = tx.shape
    _nodes(N)
    _check("pos", pos, (R, N, 3), torch.float32, dev)
    _check("tx", tx, (R, N), torch.bool, dev)
    _check("mode", mode, (R, N), torch.int32, dev)
    _check("fb", fb, (R, N), torch.float32, dev)
    _check("keys", keys, (R, 2), torch.int64, dev)
    modes, keep = mode_args(dev)
    table = params.error_model == "table"
    per = fused.device_table(per_table_f32(), dev) if table else None
    ok = torch.empty((R, N, N), dtype=torch.bool, device=dev)
    sinr = torch.empty((R, N, N), dtype=torch.float32, device=dev)
    rx_dbm = torch.empty((R, N, N), dtype=torch.float32, device=dev)
    f = ctypes.c_float
    _launch("wifi_window", pos.data_ptr(), tx.data_ptr(), mode.data_ptr(),
            fb.data_ptr(), keys.data_ptr(), modes.data_ptr(),
            keep.data_ptr(), None if per is None else per.data_ptr(),
            ok.data_ptr(), sinr.data_ptr(), rx_dbm.data_ptr(), R, N,
            int(table), *link_args(params), f(_DB_PER_LN),
            f(float(np.float32(8.0) / np.float32(8.0 * TABLE_REF_SIZE_BYTES))),
            torch.cuda.current_stream(dev).cuda_stream,
            argtypes=WINDOW_ARGTYPES, arms=("table",) * table)
    return ok, sinr, rx_dbm


def geometry_launch(pos: torch.Tensor) -> tuple:
    """Launch the scan's geometry once for the shared ``pos`` ``(N, 3)``
    f32 on the card, at the default parameters.  Returns ``(rx_w, det)``,
    ``(N, N)`` f32 and bool: each ``[tx, rx]`` pair's rx power in W (0 on
    the diagonal) and whether its rx power clears the sensitivity.  Raises
    on a bad argument or a launch error."""
    dev = pos.device
    N = pos.shape[0]
    _nodes(N)
    _check("pos", pos, (N, 3), torch.float32, dev)
    rx_w = torch.empty((N, N), dtype=torch.float32, device=dev)
    det = torch.empty((N, N), dtype=torch.bool, device=dev)
    _call("wifi_geometry_launch", GEOMETRY_ARGTYPES, pos.data_ptr(),
          rx_w.data_ptr(), det.data_ptr(), N, *link_args(WindowParams()),
          torch.cuda.current_stream(dev).cuda_stream)
    _count("geometry")
    return rx_w, det


def scan_launch(pos: torch.Tensor, prob: torch.Tensor, mode: torch.Tensor,
                fb: torch.Tensor, keys: torch.Tensor,
                n_windows: int) -> torch.Tensor:
    """Launch the scan: windows ``0 .. n_windows - 1`` of the ``(R, 2)``
    int64 ``keys`` over the shared ``pos`` ``(N, 3)``, ``prob`` and ``fb``
    ``(N,)`` f32 and ``mode`` ``(N,)`` int32, NIST at the default
    parameters, on the card: :func:`geometry_launch`, then the scan kernel
    once (no launch at all for no windows).  Returns the ``(R,)`` int32
    counts of decoded frames.  Raises on a bad argument or a launch
    error."""
    dev = keys.device
    N = pos.shape[0]
    R = keys.shape[0]
    _nodes(N)
    if R < 1 or not 0 <= n_windows * R < 2**31:
        raise ValueError(f"wifi_window scans W >= 0 windows of R >= 1 "
                         f"replicas, W R < 2^31; got R={R}, W={n_windows}")
    _check("pos", pos, (N, 3), torch.float32, dev)
    _check("prob", prob, (N,), torch.float32, dev)
    _check("mode", mode, (N,), torch.int32, dev)
    _check("fb", fb, (N,), torch.float32, dev)
    _check("keys", keys, (R, 2), torch.int64, dev)
    delivered = torch.zeros(R, dtype=torch.int32, device=dev)
    if n_windows == 0:
        return delivered
    rx_w, det = geometry_launch(pos)
    modes, keep = mode_args(dev)
    _call("wifi_scan_launch", SCAN_ARGTYPES, prob.data_ptr(),
          mode.data_ptr(), fb.data_ptr(), keys.data_ptr(), modes.data_ptr(),
          keep.data_ptr(), rx_w.data_ptr(), det.data_ptr(),
          delivered.data_ptr(), R, N, int(n_windows),
          ctypes.c_float(WindowParams().noise_w),
          torch.cuda.current_stream(dev).cuda_stream)
    _count("scan")
    return delivered


def _call(symbol: str, argtypes: list, *args) -> None:
    """Call the library's entry ``symbol``; raise on an error."""
    from tpudes_torch._build import load_library

    fn = getattr(load_library("wifi_window"), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{symbol} failed: CUDA error {err}")


def _count(arm: str) -> None:
    from tpudes_torch.parallel.kernels_cuda import launches

    launches["wifi_window"] += 1
    launches[f"wifi_window:{arm}"] += 1


#: ctypes signature of ``wifi_window_launch`` (csrc/wifi_window.cu): pos,
#: tx, mode, fb, keys, the per-mode table and masks, the PER table (null:
#: NIST), ok, sinr, rx_dbm, three ints (R, N, table), eight floats (tx dBm,
#: tx - 30, the loss's slope and intercept, the sensitivity, the noise, the
#: table's dB factor and size scale), stream
WINDOW_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 3
                   + [ctypes.c_float] * 8 + [ctypes.c_void_p])
#: ``wifi_geometry_launch``: pos, rx_w, det, N, the window's first six
#: floats, stream
GEOMETRY_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int]
                     + [ctypes.c_float] * 6 + [ctypes.c_void_p])
#: ``wifi_scan_launch``: prob, mode, fb, keys, the per-mode table and
#: masks, the geometry's rx_w and det, delivered, three ints (R, N, W), the
#: noise, stream
SCAN_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 3
                 + [ctypes.c_float] + [ctypes.c_void_p])
