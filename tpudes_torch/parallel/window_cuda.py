"""The fused WiFi PHY window as a CUDA kernel: the wrapper.

``csrc/wifi_window.cu`` replaces the reference's window
(``tpudes/parallel/kernels.py:56-116``, ``wifi_phy_window`` and its vmap
over replicas; XLA code, no ``pallas_call``) and its scan (``:119-140``,
``multi_window_scan``, vmapped over replica keys).  Three wrappers, each
launching one kernel:

- :func:`window_launch`: one CTA of eight warps a replica; ``ok``,
  ``sinr`` and ``rx_dbm`` of every ``(tx, rx)`` pair, NIST or table;
- :func:`geometry_launch`: the scan's shared geometry, each pair's rx
  power in W and whether it clears the sensitivity;
- :func:`scan_launch`: the geometry, then the scan kernel, a warp a
  (window, replica) at a time, adding its decoded frames to its
  replica's count with an integer atomic.

Beside them, not counted: the stage probe (:func:`window_profile`,
:func:`scan_profile`, the kernels' ``PROF`` instantiations) and
:func:`fma_check`, the kernel's multiply-add over f64 registers against
``xla_math::fma32``.

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

#: the stage probe's stages (``Stage`` in the .cu): the keys and the
#: transmitters, the column sums, a pair's link and SINR, its BER (erfc, or
#: the table's interpolation), ``log_d``, the union bound's terms, log1p,
#: the last exp, the coin, and the count or the stores
WIN_PROF_STAGES = ("setup", "sums", "link", "ber", "log_d", "terms", "log1p",
                   "exp", "coin", "out")

#: a mode's row of the kernel's per-mode table (MODE_COLS in the .cu)
MODE_COLUMNS = ("constellation", "div", "factor", "b", "log_c", "exps")


_MODE_ARGS: dict = {}


def mode_args(device) -> tuple:
    """``(modes, keep)``: the per-mode table as the kernel reads it, ``(M,
    24)`` f32 rows of :data:`MODE_COLUMNS` (the ten ``log_c``, then the
    ten ``exps``), and ``(M,)`` int32 masks of the nonzero weights, from
    :func:`~tpudes_torch.ops.wifi_error.mode_table` (the same numbers the
    plain version uses); built once per device and kept, so that a launch
    queues no other work.  Raises where a kept term's ``log_c`` exceeds 80
    or its ``exps`` is negative: the kernel's sum of the terms relies on
    each being at most e^80."""
    key = str(torch.device(device))
    out = _MODE_ARGS.get(key)
    if out is not None:
        return out
    t = mode_table(device)
    kept = t["keep"].bool()
    if (t["log_c"][kept] > 80.0).any() or (t["exps"][kept] < 0.0).any():
        raise ValueError("the kernel's union bound sums exps of at most "
                         "e^80: it needs log_c <= 80 and exps >= 0")
    modes = torch.cat([t["constellation"][:, None], t["div"][:, None],
                       t["factor"][:, None], t["b"][:, None], t["log_c"],
                       t["exps"]], dim=1).contiguous()
    bits = 1 << torch.arange(t["keep"].shape[1], device=t["keep"].device)
    keep = (t["keep"].long() * bits).sum(1).to(torch.int32).contiguous()
    out = _MODE_ARGS[key] = (modes, keep)
    return out


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


def _window_args(pos, tx, mode, fb, keys, params: WindowParams) -> tuple:
    """Check a window launch's inputs and allocate its outputs: ``(args,
    (ok, sinr, rx_dbm), table, held)``, ``args`` the C entry's arguments
    before the stream, ``held`` the tables they point into (alive until
    the launch is queued)."""
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
    args = (pos.data_ptr(), tx.data_ptr(), mode.data_ptr(), fb.data_ptr(),
            keys.data_ptr(), modes.data_ptr(), keep.data_ptr(),
            None if per is None else per.data_ptr(), ok.data_ptr(),
            sinr.data_ptr(), rx_dbm.data_ptr(), R, N, int(table),
            *link_args(params), f(_DB_PER_LN),
            f(float(np.float32(8.0) / np.float32(8.0 * TABLE_REF_SIZE_BYTES))))
    return args, (ok, sinr, rx_dbm), table, (modes, keep, per)


def window_launch(pos: torch.Tensor, tx: torch.Tensor, mode: torch.Tensor,
                  fb: torch.Tensor, keys: torch.Tensor,
                  params: WindowParams):
    """Launch the window once for ``R`` replicas: ``pos`` ``(R, N, 3)``
    f32, ``tx`` ``(R, N)`` bool, ``mode`` ``(R, N)`` int32, ``fb`` ``(R,
    N)`` f32, ``keys`` ``(R, 2)`` int64, all on the card.  Returns ``(ok,
    sinr, rx_dbm)``, ``(R, N, N)`` in fresh tensors.  Raises on a bad
    argument or a launch error; never takes the plain version."""
    args, out, table, _held = _window_args(pos, tx, mode, fb, keys, params)
    _launch("wifi_window", *args,
            torch.cuda.current_stream(keys.device).cuda_stream,
            argtypes=WINDOW_ARGTYPES, arms=("table",) * table)
    return out


def window_profile(pos: torch.Tensor, tx: torch.Tensor, mode: torch.Tensor,
                   fb: torch.Tensor, keys: torch.Tensor,
                   params: WindowParams):
    """The window's stage probe: the launch :func:`window_launch` makes,
    by the kernel's profiling instantiation (``wifi_window_profile``: each
    lane reads ``clock64()`` at its stage edges).  Returns ``((ok, sinr,
    rx_dbm), cycles)``: the outputs and the ``(len(WIN_PROF_STAGES),)``
    float64 warp-cycles a window (a replica) in each stage, each warp's
    slowest lane summed over the warps.  Not the main path: not counted in
    ``kernels_cuda.launches``."""
    args, out, _, _held = _window_args(pos, tx, mode, fb, keys, params)
    prof = torch.zeros(len(WIN_PROF_STAGES), dtype=torch.int64,
                       device=keys.device)
    _call("wifi_window_profile", WINDOW_ARGTYPES[:-1] + [ctypes.c_void_p] * 2,
          *args, prof.data_ptr(),
          torch.cuda.current_stream(keys.device).cuda_stream)
    return out, prof.double() / tx.shape[0]


def _geometry(pos: torch.Tensor) -> tuple:
    dev = pos.device
    N = pos.shape[0]
    _nodes(N)
    _check("pos", pos, (N, 3), torch.float32, dev)
    rx_w = torch.empty((N, N), dtype=torch.float32, device=dev)
    det = torch.empty((N, N), dtype=torch.bool, device=dev)
    _call("wifi_geometry_launch", GEOMETRY_ARGTYPES, pos.data_ptr(),
          rx_w.data_ptr(), det.data_ptr(), N, *link_args(WindowParams()),
          torch.cuda.current_stream(dev).cuda_stream)
    return rx_w, det


def geometry_launch(pos: torch.Tensor) -> tuple:
    """Launch the scan's geometry once for the shared ``pos`` ``(N, 3)``
    f32 on the card, at the default parameters.  Returns ``(rx_w, det)``,
    ``(N, N)`` f32 and bool: each ``[tx, rx]`` pair's rx power in W (0 on
    the diagonal) and whether its rx power clears the sensitivity.  Raises
    on a bad argument or a launch error."""
    out = _geometry(pos)
    _count("geometry")
    return out


def _scan_args(pos, prob, mode, fb, keys, n_windows: int):
    """Check a scan's inputs and allocate its counts: ``(R, N, delivered)``."""
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
    return R, N, torch.zeros(R, dtype=torch.int32, device=dev)


def _scan_call(symbol: str, argtypes: list, rx_w, det, prob, mode, fb, keys,
               delivered, n_windows: int, *extra) -> None:
    dev = keys.device
    modes, keep = mode_args(dev)
    _call(symbol, argtypes, prob.data_ptr(), mode.data_ptr(), fb.data_ptr(),
          keys.data_ptr(), modes.data_ptr(), keep.data_ptr(),
          rx_w.data_ptr(), det.data_ptr(), delivered.data_ptr(),
          keys.shape[0], prob.shape[0], int(n_windows),
          ctypes.c_float(WindowParams().noise_w), *extra,
          torch.cuda.current_stream(dev).cuda_stream)


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
    _, _, delivered = _scan_args(pos, prob, mode, fb, keys, n_windows)
    if n_windows == 0:
        return delivered
    rx_w, det = geometry_launch(pos)
    _scan_call("wifi_scan_launch", SCAN_ARGTYPES, rx_w, det, prob, mode, fb,
               keys, delivered, n_windows)
    _count("scan")
    return delivered


def scan_profile(pos: torch.Tensor, prob: torch.Tensor, mode: torch.Tensor,
                 fb: torch.Tensor, keys: torch.Tensor, n_windows: int):
    """The scan's stage probe: the scan kernel's launch as
    :func:`scan_launch` makes it (over the geometry of
    ``wifi_geometry_launch``), by its profiling instantiation
    (``wifi_scan_profile``).  Returns ``(delivered, cycles)``: the ``(R,)``
    counts and the ``(len(WIN_PROF_STAGES),)`` float64 warp-cycles a window
    in each stage, each warp's slowest lane summed over the warps.  Not
    the main path: not counted in ``kernels_cuda.launches``."""
    R, N, delivered = _scan_args(pos, prob, mode, fb, keys, n_windows)
    if n_windows < 1:
        raise ValueError("the scan's probe needs a window")
    rx_w, det = _geometry(pos)
    prof = torch.zeros(len(WIN_PROF_STAGES), dtype=torch.int64,
                       device=keys.device)
    _scan_call("wifi_scan_profile", SCAN_ARGTYPES[:-1] + [ctypes.c_void_p] * 2,
               rx_w, det, prob, mode, fb, keys, delivered, n_windows,
               prof.data_ptr())
    return delivered, prof.double() / (R * n_windows)


def fma_check(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> tuple:
    """The kernel's multiply-add over f64 registers (``fma32d`` in
    csrc/wifi_window.cu) and ``xla_math::fma32`` on the same ``(n,)`` f32
    triples, on their device (``wifi_fma_check``).  Returns ``(got,
    want)``, ``(n,)`` f32.  Not counted in ``kernels_cuda.launches``."""
    dev = a.device
    n = a.shape[0]
    for name, x in (("a", a), ("b", b), ("c", c)):
        _check(name, x, (n,), torch.float32, dev)
    got = torch.empty_like(a)
    want = torch.empty_like(a)
    if n:
        _call("wifi_fma_check", FMA_CHECK_ARGTYPES, a.data_ptr(),
              b.data_ptr(), c.data_ptr(), got.data_ptr(), want.data_ptr(),
              n, torch.cuda.current_stream(dev).cuda_stream)
    return got, want


#: the functions :func:`chain_check` holds, in the order of its ``which``
CHAIN_FUNCTIONS = ("exp", "log", "log1p", "erfc")


def chain_check(x: torch.Tensor, fn: str) -> tuple:
    """The kernel's ``exp_d``, ``log_d``, ``log1p_d`` or ``erfc_d`` (``fn``
    of :data:`CHAIN_FUNCTIONS`) over f64 registers against xla_math.cuh's
    f32 function, on the ``(n,)`` f32 ``x`` on its device
    (``wifi_chain_check``).  Returns ``(got, want, in_range)``: ``(n,)``
    f32, f32 and bool, ``in_range`` whether the f64 chain stayed where its
    rounding is f32's (elsewhere the kernels take the f32 function).  Not
    counted in ``kernels_cuda.launches``."""
    dev = x.device
    n = x.shape[0]
    _check("x", x, (n,), torch.float32, dev)
    got = torch.empty_like(x)
    want = torch.empty_like(x)
    in_range = torch.empty((n,), dtype=torch.bool, device=dev)
    if n:
        _call("wifi_chain_check", CHAIN_CHECK_ARGTYPES, x.data_ptr(),
              got.data_ptr(), want.data_ptr(), in_range.data_ptr(), n,
              CHAIN_FUNCTIONS.index(fn),
              torch.cuda.current_stream(dev).cuda_stream)
    return got, want, in_range


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
#: ``wifi_fma_check``: a, b, c, got, want, n (int64), stream
FMA_CHECK_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_longlong,
                                              ctypes.c_void_p]
#: ``wifi_chain_check``: x, got, want, in_range, n (int64), which, stream
CHAIN_CHECK_ARGTYPES = ([ctypes.c_void_p] * 4
                        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
