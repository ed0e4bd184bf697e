"""The NIST error-rate model (counterpart of ``tpudes/ops/wifi_error.py``).

A frame's success rate is ``(1 - pe)^nbits``: the AWGN bit error rate
of its constellation (erfc closed forms), then the union bound over the
first ten terms of the K = 7 convolutional code's distance spectrum at
its coding rate.  The tables and the mode registry are copies of the
reference's (``wifi_error.py:32-75``, ``:147-220``).

The arithmetic is the reference's as its CPU executable computes it
inside the BSS step (:mod:`tpudes_torch.ops.fused`): the mode is a
constant there, so the compiler folds every per-mode number (the
divisor's reciprocal, the QAM factor, ``log`` of the spectrum weights)
into one f32 constant; ``erfc``, ``exp``, ``log`` and ``log1p`` are its
own; products fuse into the sums that follow them; ``1 - 1e-12`` is 1.0
in f32.  So here a mode, a constellation and a rate class are Python
ints, as they are in the step, and the result is bit-equal to the
reference's jitted ``mode_chunk_success_rate`` with the mode and
``nbits`` constant (``tests/test_torch_wifi_error.py``).

An A-MPDU's subframes decode at ``psr ** (1 / k)`` with ``nbits`` the
whole PPDU's, which depends on ``k``: :func:`ampdu_airtime` and
:func:`mpdu_success_rate` compute both as the compiled A-MPDU step does
(``tests/test_torch_bss_ht.py``).

The fused PHY window (:mod:`tpudes_torch.parallel.kernels`) resolves the
mode per element: :func:`mode_chunk_success_rate` with a mode *tensor*
gathers each element's constellation and rate class, as the reference's
traced path does (``wifi_error.py:223-230``), and its compiled arithmetic
differs from the static one: the per-mode numbers are computed, not
folded (the QAM factor ``2 (1 - rsqrt M) / (log M log2 e)``, the weights'
logs by the compiler's ``log``), all three BER branches are evaluated
and selected (:func:`mode_table`, :func:`uncoded_ber_at`).

The table model (``per_table``, ``table_chunk_success_rate``,
``wifi_error.py:233-306``): a float64 PER grid made once from the
float64 oracle :func:`chunk_success_rate_py`, read in f32 by linear
interpolation over SNR dB and scaled to the frame's size.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from tpudes_torch.ops import fused
from tpudes_torch.ops.propagation import _folded

# --- coding-rate classes (``wifi_error.py:27-32``): 0 rate 1/2, 1 rate 2/3,
# 2 rate 3/4, 3 rate 5/6
B_FACTOR_TABLE = [1.0 / 2.0, 1.0 / 4.0, 1.0 / 6.0, 1.0 / 10.0]

#: union-bound weights a_d of the K=7 code per puncturing, first ten
#: terms (rate 1/2 has nine, padded with zero; ``wifi_error.py:37-51``)
PE_COEFFS_TABLE = [
    [36.0, 211.0, 1404.0, 11633.0, 77433.0, 502690.0, 3322763.0,
     21292910.0, 134365911.0, 0.0],
    [3.0, 70.0, 285.0, 1276.0, 6160.0, 27128.0, 117019.0,
     498860.0, 2103891.0, 8784123.0],
    [42.0, 201.0, 1492.0, 10469.0, 62935.0, 379644.0, 2253373.0,
     13073811.0, 75152755.0, 428005675.0],
    [92.0, 528.0, 8694.0, 79453.0, 792114.0, 7375573.0, 67884974.0,
     610875423.0, 5427275376.0, 47664215639.0],
]
#: the distances d of those terms (``wifi_error.py:52-57``)
PE_EXPONENTS_TABLE = [
    [10.0, 12.0, 14.0, 16.0, 18.0, 20.0, 22.0, 24.0, 26.0, 28.0],
    [6.0, 7.0, 8.0, 9.0, 10.0, 11.0, 12.0, 13.0, 14.0, 15.0],
    [5.0, 6.0, 7.0, 8.0, 9.0, 10.0, 11.0, 12.0, 13.0, 14.0],
    [4.0, 5.0, 6.0, 7.0, 8.0, 9.0, 10.0, 11.0, 12.0, 13.0],
]

RATE_1_2, RATE_2_3, RATE_3_4, RATE_5_6 = 0, 1, 2, 3

#: erfc-argument divisors of upstream's M-QAM closed forms, z =
#: sqrt(snr / div) (``wifi_error.py:75``)
QAM_DIVISORS = {16.0: 10.0, 64.0: 21.0, 256.0: 60.0, 1024.0: 155.0}

#: the clamp of the weights before their log, and the largest pe the
#: success rate takes (``1 - 1e-12``, which is 1.0 in f32)
_COEFF_FLOOR = 1e-35
_PE_MAX = 1.0 - 1e-12


@dataclass(frozen=True)
class WifiMode:
    """One entry of the WifiMode registry (``wifi_error.py:147-167``)."""

    name: str
    index: int
    constellation: int      # 2 BPSK, 4 QPSK, 16/64/256/1024 QAM
    rate_class: int         # RATE_* above
    data_rate_bps: int      # PHY data rate at 20 MHz, 800 ns GI, 1 SS
    bits_per_symbol: float  # data bits per OFDM symbol
    standard: str = "ofdm"


def _ofdm_modes():
    # 802.11a/g 20 MHz OFDM (``wifi_error.py:170-185``)
    table = [
        ("OfdmRate6Mbps", 2, RATE_1_2, 6e6),
        ("OfdmRate9Mbps", 2, RATE_3_4, 9e6),
        ("OfdmRate12Mbps", 4, RATE_1_2, 12e6),
        ("OfdmRate18Mbps", 4, RATE_3_4, 18e6),
        ("OfdmRate24Mbps", 16, RATE_1_2, 24e6),
        ("OfdmRate36Mbps", 16, RATE_3_4, 36e6),
        ("OfdmRate48Mbps", 64, RATE_2_3, 48e6),
        ("OfdmRate54Mbps", 64, RATE_3_4, 54e6),
    ]
    return [
        WifiMode(name, i, m, b, int(rate), rate * 4e-6)
        for i, (name, m, b, rate) in enumerate(table)
    ]


def _ht_he_modes(start_index: int):
    # HT/VHT/HE MCS ladder, 1 SS, 20 MHz, long GI (``wifi_error.py:188-209``)
    ladder = [
        ("HtMcs0", 2, RATE_1_2, 6.5e6),
        ("HtMcs1", 4, RATE_1_2, 13e6),
        ("HtMcs2", 4, RATE_3_4, 19.5e6),
        ("HtMcs3", 16, RATE_1_2, 26e6),
        ("HtMcs4", 16, RATE_3_4, 39e6),
        ("HtMcs5", 64, RATE_2_3, 52e6),
        ("HtMcs6", 64, RATE_3_4, 58.5e6),
        ("HtMcs7", 64, RATE_5_6, 65e6),
        ("VhtMcs8", 256, RATE_3_4, 78e6),
        ("VhtMcs9", 256, RATE_5_6, 86.7e6),
        ("HeMcs10", 1024, RATE_3_4, 97.5e6),
        ("HeMcs11", 1024, RATE_5_6, 108.3e6),
    ]
    return [
        WifiMode(name, start_index + i, m, b, int(rate), rate * 4e-6,
                 standard="ht")
        for i, (name, m, b, rate) in enumerate(ladder)
    ]


OFDM_MODES = _ofdm_modes()
HT_MODES = _ht_he_modes(len(OFDM_MODES))
ALL_MODES = OFDM_MODES + HT_MODES
MODES_BY_NAME = {m.name: m for m in ALL_MODES}

#: per-mode lookup arrays (``wifi_error.py:215-217``)
MODE_CONSTELLATION = np.array([m.constellation for m in ALL_MODES],
                              dtype=np.float32)
MODE_RATE_CLASS = np.array([m.rate_class for m in ALL_MODES], dtype=np.int32)
MODE_DATA_RATE = np.array([m.data_rate_bps for m in ALL_MODES],
                          dtype=np.float32)


def ber_constants(constellation: int) -> tuple[float, float]:
    """``(scale, factor)`` with ``ber = factor * erfc(sqrt(snr * scale))``
    for a constellation, as the reference's compiled step folds them:
    BPSK ``(1, 1/2)``, QPSK ``(1/2, 1/2)``, M-QAM (M >= 16) the f32
    reciprocal of its divisor and ``2 (1 - 1/sqrt M) / log2 M`` rounded
    to f32.  (``snr * 1`` is ``snr``: one form serves all three.)"""
    if constellation <= 2:
        return 1.0, 0.5
    if constellation <= 4:
        return 0.5, 0.5
    m = float(max(constellation, 16))
    scale = np.float32(1.0) / np.float32(QAM_DIVISORS[m])
    factor = np.float32(2.0 * (1.0 - 1.0 / math.sqrt(m)) / math.log2(m))
    return float(scale), float(factor)


def pe_constants(rate_class: int) -> tuple[tuple, tuple, tuple, float]:
    """``(weights, log_weights, distances, b)`` of a coding rate as f32
    values: the union-bound weights (a zero weight's term is dropped),
    their logs (the weight clamped to 1e-35 first, its log rounded
    once to f32, as the compiler folds it), the distances and the
    rate's factor."""
    coeffs = np.asarray(PE_COEFFS_TABLE[rate_class], np.float32)
    log_c = np.log(
        np.maximum(coeffs, np.float32(_COEFF_FLOOR)).astype(np.float64)
    ).astype(np.float32)
    exps = np.asarray(PE_EXPONENTS_TABLE[rate_class], np.float32)
    return (tuple(float(v) for v in coeffs), tuple(float(v) for v in log_c),
            tuple(float(v) for v in exps),
            float(np.float32(B_FACTOR_TABLE[rate_class])))


def _pe_terms(rate_class: int) -> tuple[np.ndarray, np.ndarray]:
    """The nonzero-weight terms of a rate's union bound: ``log a_k`` and
    ``e_k`` as f32 values held in f64 (:func:`~tpudes_torch.ops.fused.
    fma`'s operands)."""
    coeffs, log_c, exps, _ = pe_constants(rate_class)
    keep = [k for k, a in enumerate(coeffs) if a > 0.0]
    return (np.asarray([log_c[k] for k in keep], np.float64),
            np.asarray([exps[k] for k in keep], np.float64))


_PE_TERMS = [_pe_terms(rc) for rc in range(len(B_FACTOR_TABLE))]


def _qam_ber(snr: torch.Tensor, m: int) -> torch.Tensor:
    """Gray-coded square M-QAM AWGN BER (``wifi_error.py:78-96``):
    ``2 (1 - 1/sqrt M) / log2 M * erfc(sqrt(snr / div(M)))``."""
    scale, factor = ber_constants(max(int(m), 16))
    return uncoded_ber_from(snr, scale, factor)


def uncoded_ber_from(snr: torch.Tensor, scale: float,
                     factor: float) -> torch.Tensor:
    """``factor * erfc(sqrt(snr * scale))`` in the compiled f32."""
    z = fused.sqrt(snr * fused.f32(snr, scale))
    return fused.ftz(fused.f32(snr, factor) * fused.erfc(z))


def uncoded_ber(snr: torch.Tensor, constellation: int) -> torch.Tensor:
    """Per-bit AWGN error probability by constellation size
    (``wifi_error.py:99-113``): BPSK ``erfc(sqrt snr) / 2``, QPSK
    ``erfc(sqrt(snr / 2)) / 2``, M-QAM the closed form."""
    return uncoded_ber_from(snr, *ber_constants(int(constellation)))


def coded_pe(ber: torch.Tensor, rate_class: int) -> torch.Tensor:
    """First-event error probability union bound (``wifi_error.py:116-
    135``): with ``D = sqrt(4 p (1 - p))``, ``pe = b * sum a_k D^e_k``,
    each term ``exp(log a_k + e_k log D)``, summed in order, clamped to
    ``[0, 1]``."""
    log_c, exps = _PE_TERMS[int(rate_class)]
    b = float(np.float32(B_FACTOR_TABLE[int(rate_class)]))
    p = torch.clamp(ber, 0.0, 0.5)
    d = fused.sqrt((p * 4.0) * (1.0 - p))
    log_d = fused.log(torch.clamp_min(d, fused.f32(d, _COEFF_FLOOR)))
    terms = fused.exp(torch.addcmul(
        fused.device_table(log_c, d.device), log_d.double()[..., None],
        fused.device_table(exps, d.device),
    ).float())                                            # (..., terms)
    acc = terms[..., 0]
    for k in range(1, terms.shape[-1]):
        acc = acc + terms[..., k]
    return torch.clamp(fused.ftz(acc * fused.f32(d, b)), 0.0, 1.0)


def log1p_neg_pe(snr: torch.Tensor, constellation: int,
                 rate_class: int) -> torch.Tensor:
    """``log1p(-pe)``, ``pe`` clamped below 1: the part of the success
    rate that depends on the SNR alone (``wifi_error.py:138-144``)."""
    pe = coded_pe(uncoded_ber(snr, constellation), rate_class)
    pe = torch.clamp_max(pe, fused.f32(pe, _PE_MAX))
    return fused.log1p(-pe)


def chunk_success_rate(snr: torch.Tensor, nbits, constellation: int,
                       rate_class: int) -> torch.Tensor:
    """``(1 - pe)^nbits`` as ``exp(nbits * log1p(-pe))``
    (``wifi_error.py:138-144``); ``nbits`` a constant or an f32 tensor
    that broadcasts against ``snr`` (the product is one f32 multiply
    either way: the compiled step neither folds nor fuses it)."""
    lg = log1p_neg_pe(snr, constellation, rate_class)
    if not isinstance(nbits, torch.Tensor):
        nbits = fused.f32(lg, nbits)
    return fused.exp(nbits * lg)


def mode_chunk_success_rate(snr: torch.Tensor, nbits,
                            mode_index) -> torch.Tensor:
    """Success rate with the mode resolved from the registry by index
    (``wifi_error.py:223-230``); ``nbits`` a constant or a tensor.  An
    int mode is static (the BSS step's folded arithmetic); a tensor of
    mode indices, broadcast against ``snr``, is resolved per element
    (:func:`mode_table`)."""
    if isinstance(mode_index, torch.Tensor):
        return _mode_chunk_success_rate_at(snr, nbits, mode_index)
    mode = ALL_MODES[int(mode_index)]
    return chunk_success_rate(snr, nbits, mode.constellation,
                              mode.rate_class)


def mpdu_success_rate(snr: torch.Tensor, nbits: torch.Tensor,
                      k: torch.Tensor, mode_index: int) -> torch.Tensor:
    """One subframe's success rate in an A-MPDU of ``k`` equal subframes:
    the PPDU's ``psr ** (1 / k)`` (``replicated.py:935-944``).  The
    compiled step never takes that power: ``psr`` is ``exp(nbits *
    log1p(-pe))``, and XLA's simplifier rewrites ``exp(a) ** b`` as
    ``exp(a * b)``, so the result is ``exp((nbits * log1p(-pe)) * (1 /
    k))``, three f32 roundings then the compiler's ``exp`` (the
    ``multiply_exponential_fusion`` of the step's optimised HLO).  With
    ``k = 1`` it is ``psr`` itself."""
    mode = ALL_MODES[int(mode_index)]
    lg = log1p_neg_pe(snr, mode.constellation, mode.rate_class)
    return fused.exp((nbits * lg) * (1.0 / k.to(torch.float32)))


def ampdu_params(subframe_bytes: int, mode_index: int):
    """The f32 constants of :func:`ampdu_airtime` and the preamble:
    ``(8 sub, 1 / ndbps, rate / 1e6, preamble_us)``, each rounded to f32
    as the compiled step folds it (the reciprocal of the f32 ``ndbps``
    taken in f32)."""
    mode = ALL_MODES[int(mode_index)]
    ndbps = mode.data_rate_bps * 4e-6
    return (float(np.float32(8.0 * subframe_bytes)),
            float(np.float32(1.0) / np.float32(ndbps)),
            float(np.float32(mode.data_rate_bps * 1e-6)),
            36 if mode.standard == "ht" else 20)


def ampdu_airtime(k: torch.Tensor, subframe_bytes: int, mode_index: int):
    """``(dur_us, nbits)`` of an A-MPDU of ``k`` subframes
    (``replicated.py:935-942``): ``nsym = ceil((22 + 8 sub k) / ndbps)``
    in f32, the division by the constant ``ndbps`` done as the compiled
    step does it (times its f32 reciprocal), ``dur = 36 + 4 nsym`` µs
    with the HT preamble (20 for a legacy mode), and ``nbits = f32(rate
    / 1e6) * dur``, the PER integral over the whole PPDU at the payload
    rate.  ``k`` is int32, ``dur_us`` int32, ``nbits`` f32."""
    sub8, inv_ndbps, rate, preamble = ampdu_params(subframe_bytes,
                                                   mode_index)
    x = k.to(torch.float32) * fused.f32(k, sub8) + 22.0
    nsym = torch.ceil(x * fused.f32(k, inv_ndbps))
    dur = (nsym * 4.0).to(torch.int32) + preamble
    return dur, fused.f32(k, rate) * dur.to(torch.float32)


# --- the mode per element (the fused window's path) ------------------------

#: ``log2 e`` as the compiled ``log2`` folds it (``log(x) * log2 e``)
_LOG2E_F32 = 1.44269502
#: the QAM branch's constellation thresholds and erfc-argument divisors
#: as the compiled select holds them (``wifi_error.py:84-92``)
_QAM_STEPS = ((16.0, 10.0), (64.0, 21.0), (256.0, 60.0))
_QAM_LAST_DIV = 155.0

_MODE_TABLES: dict = {}


def mode_table(device=None) -> dict:
    """The per-mode numbers of the traced error model, ``(M,)`` and ``(M,
    10)`` tensors on ``device``, computed as the compiled window computes
    them for each element (its optimised HLO): ``constellation``; the
    QAM branch's ``div`` (selected by ``max(M, 16)``) and ``factor`` ``2
    (1 - rsqrt M') / (log M' * log2 e)`` with ``M' = max(M, 16)`` (the
    root of these squares is exact); the union bound's ``log_c``, the
    compiler's ``log`` of each weight clamped to 1e-35, its ``exps``,
    the ``keep`` mask of nonzero weights and the rate's factor ``b``.
    Kept once per device."""
    dev = torch.device(device or "cpu")
    key = str(dev)
    out = _MODE_TABLES.get(key)
    if out is not None:
        return out
    m = torch.as_tensor(MODE_CONSTELLATION, device=dev)
    rc = torch.as_tensor(MODE_RATE_CLASS, device=dev).long()
    mq = torch.clamp_min(m, 16.0)
    div = torch.full_like(mq, _QAM_LAST_DIV)
    for top, d in reversed(_QAM_STEPS):
        div = torch.where(mq <= top, fused.f32(mq, d), div)
    factor = ((1.0 - 1.0 / fused.sqrt(mq)) * 2.0) / (
        fused.log(mq) * fused.f32(mq, _LOG2E_F32))
    coeffs = torch.as_tensor(np.asarray(PE_COEFFS_TABLE, np.float32),
                             device=dev)[rc]
    out = dict(
        constellation=m, div=div, factor=factor,
        log_c=fused.log(torch.clamp_min(coeffs, fused.f32(coeffs,
                                                          _COEFF_FLOOR))),
        exps=torch.as_tensor(np.asarray(PE_EXPONENTS_TABLE, np.float32),
                             device=dev)[rc],
        keep=coeffs > 0.0,
        b=torch.as_tensor(np.asarray(B_FACTOR_TABLE, np.float32),
                          device=dev)[rc],
    )
    _MODE_TABLES[key] = out
    return out


def uncoded_ber_at(snr: torch.Tensor, mode_index: torch.Tensor,
                   qam_z: torch.Tensor | None = None) -> torch.Tensor:
    """Per-element BER (``wifi_error.py:99-113`` with a traced
    constellation): BPSK ``erfc(sqrt snr) * 0.5``, QPSK ``erfc(sqrt(snr
    * 0.5)) * 0.5`` and M-QAM ``factor * erfc(z)``, each flushed, then
    selected by the element's constellation.  ``z`` is ``sqrt(snr /
    div)`` unless ``qam_z`` gives it (the window's compiler computes it
    from the SINR's own quotient, :mod:`tpudes_torch.parallel.kernels`)."""
    t = mode_table(snr.device)
    c = t["constellation"][mode_index.long()]
    half = fused.f32(snr, 0.5)
    bpsk = fused.ftz(fused.erfc(fused.sqrt(snr)) * half)
    qpsk = fused.ftz(fused.erfc(fused.sqrt(snr * half)) * half)
    if qam_z is None:
        qam_z = fused.sqrt(snr / t["div"][mode_index.long()])
    qam = fused.ftz(t["factor"][mode_index.long()] * fused.erfc(qam_z))
    return torch.where(c <= 2.0, bpsk, torch.where(c <= 4.0, qpsk, qam))


def coded_pe_at(ber: torch.Tensor, mode_index: torch.Tensor) -> torch.Tensor:
    """Per-element union bound (``wifi_error.py:116-135`` with a traced
    rate class): ``D = sqrt(4 p (1 - p))``, each of the mode's ten terms
    ``exp(log a_k + e_k log D)`` (zero where ``a_k = 0``) summed in
    order, times ``b``, clamped to ``[0, 1]``."""
    t = mode_table(ber.device)
    mi = mode_index.long()
    p = torch.clamp(ber, 0.0, 0.5)
    d = fused.sqrt((p * 4.0) * (1.0 - p))
    log_d = fused.log(torch.clamp_min(d, fused.f32(d, _COEFF_FLOOR)))
    log_c, exps = t["log_c"][mi], t["exps"][mi]
    keep = t["keep"][mi]
    acc = None
    for k in range(log_c.shape[-1]):
        term = fused.exp(torch.addcmul(log_c[..., k].double(), log_d.double(),
                                       exps[..., k].double()).float())
        term = torch.where(keep[..., k], term, fused.f32(term, 0.0))
        acc = term if acc is None else acc + term
    return torch.clamp(fused.ftz(acc * t["b"][mi]), 0.0, 1.0)


def log1p_neg_pe_at(snr: torch.Tensor, mode_index: torch.Tensor,
                    qam_z: torch.Tensor | None = None) -> torch.Tensor:
    """``log1p(-min(pe, 1 - 1e-12))`` of each element's own mode."""
    pe = coded_pe_at(uncoded_ber_at(snr, mode_index, qam_z), mode_index)
    return fused.log1p(-torch.clamp_max(pe, fused.f32(pe, _PE_MAX)))


def _mode_chunk_success_rate_at(snr, nbits, mode_index):
    lg = log1p_neg_pe_at(snr, mode_index)
    if not isinstance(nbits, torch.Tensor):
        nbits = fused.f32(lg, nbits)
    return fused.exp(nbits * lg)


# --- the table-based error model (``wifi_error.py:233-306``) ---------------

TABLE_SNR_MIN_DB = -5.0
TABLE_SNR_STEP_DB = 0.5
TABLE_SNR_POINTS = 91            # -5 .. +40 dB
TABLE_REF_SIZE_BYTES = 1458      # upstream's large-payload table size
#: the interpolated PER's cap, ``1 - 1e-7`` in f32
_TABLE_PER_MAX = 1.0 - 1e-7

_PER_TABLE_CACHE: dict = {}


def chunk_success_rate_py(snr: float, nbits: float, constellation: int,
                          rate_class: int) -> float:
    """The float64 oracle (``wifi_error.py:312-331``), the same formulas
    in the same order: the table below is made from it."""
    if constellation <= 2:
        ber = 0.5 * math.erfc(math.sqrt(snr))
    elif constellation <= 4:
        ber = 0.5 * math.erfc(math.sqrt(snr / 2.0))
    else:
        m = float(constellation)
        z = math.sqrt(snr / QAM_DIVISORS[m])
        ber = (2.0 * (1.0 - 1.0 / math.sqrt(m)) / math.log2(m)) * math.erfc(z)
    p = min(max(ber, 0.0), 0.5)
    d = math.sqrt(4.0 * p * (1.0 - p))
    coeffs = PE_COEFFS_TABLE[rate_class]
    exps = PE_EXPONENTS_TABLE[rate_class]
    factor = B_FACTOR_TABLE[rate_class]
    pe = factor * sum(c * d**e for c, e in zip(coeffs, exps) if c > 0)
    pe = min(pe, 1.0 - 1e-12)
    return math.exp(nbits * math.log1p(-pe))


def per_table() -> np.ndarray:
    """``(n_modes, TABLE_SNR_POINTS)`` float64 PER at
    ``TABLE_REF_SIZE_BYTES`` (``wifi_error.py:252-267``), made once from
    :func:`chunk_success_rate_py` on the same SNR grid."""
    tbl = _PER_TABLE_CACHE.get("table")
    if tbl is None:
        snrs_db = TABLE_SNR_MIN_DB + TABLE_SNR_STEP_DB * np.arange(
            TABLE_SNR_POINTS)
        nbits = 8.0 * TABLE_REF_SIZE_BYTES
        tbl = np.empty((len(ALL_MODES), TABLE_SNR_POINTS))
        for m in ALL_MODES:
            for j, snr_db in enumerate(snrs_db):
                ok = chunk_success_rate_py(10.0 ** (snr_db / 10.0), nbits,
                                           m.constellation, m.rate_class)
                tbl[m.index, j] = 1.0 - ok
        _PER_TABLE_CACHE["table"] = tbl
        _PER_TABLE_CACHE["f32"] = tbl.astype(np.float32)
    return tbl


def per_table_f32() -> np.ndarray:
    """:func:`per_table` rounded to f32, as the compiled path reads it."""
    per_table()
    return _PER_TABLE_CACHE["f32"]


def table_lg(snr: torch.Tensor, mode_index: torch.Tensor) -> torch.Tensor:
    """``log1p(-per_ref)`` of the table model (``wifi_error.py:289-306``)
    as its compiled form computes it: ``x = fma(log(max(snr, 1e-30)),
    10 / ln 10, 5) * 2`` (the dB, less the grid's start, over its step),
    clamped to the grid, ``lo = trunc(x)`` clamped to ``[0, 89]``, ``frac
    = x - lo``, ``per_ref = min(fma(per_hi, frac, per_lo (1 - frac)), 1 -
    1e-7)`` (the compiler fuses the second product, not the first), each
    element's row its own mode's."""
    tbl = fused.device_table(per_table_f32(), snr.device)
    lg = fused.log(torch.clamp_min(snr, fused.f32(snr, 1e-30)))
    x = fused.fma(lg, fused.f32(snr, _DB_PER_LN), fused.f32(
        snr, -TABLE_SNR_MIN_DB)) * fused.f32(snr, 1.0 / TABLE_SNR_STEP_DB)
    x = torch.clamp(x, 0.0, TABLE_SNR_POINTS - 1.0)
    lo = torch.clamp(x.to(torch.int32), 0, TABLE_SNR_POINTS - 2)
    frac = x - lo.float()
    row = mode_index.long() * TABLE_SNR_POINTS + lo.long()
    flat = tbl.reshape(-1)
    per_lo, per_hi = flat[row], flat[row + 1]
    per_ref = fused.fma(per_hi, frac, per_lo * (1.0 - frac))
    per_ref = torch.clamp_max(per_ref, fused.f32(per_ref, _TABLE_PER_MAX))
    return fused.log1p(-per_ref)


#: ``10 log10(x)`` compiled: ``log(x)`` times ``f32(10) * f32(1 / ln 10)``
#: (:func:`~tpudes_torch.ops.fused.log10`'s constant folded)
_DB_PER_LN = _folded(10.0)


def table_chunk_success_rate(snr: torch.Tensor, nbits,
                             mode_index: torch.Tensor) -> torch.Tensor:
    """The table model's success rate (``wifi_error.py:289-306``): the
    interpolated PER at the reference size scaled to ``nbits``,
    ``exp((nbits / ref_bits) * log1p(-per_ref))``, the division a product
    with the f32 reciprocal of ``ref_bits``."""
    lg = table_lg(snr, mode_index)
    if not isinstance(nbits, torch.Tensor):
        nbits = fused.f32(lg, nbits)
    inv = fused.f32(lg, float(np.float32(1.0) / np.float32(
        8.0 * TABLE_REF_SIZE_BYTES)))
    return fused.exp((nbits * inv) * lg)
