"""The port's multi-TTI LTE advance (``sm_advance``) on the CPU.

``csrc/lte_sm_advance.cu`` has no CPU mode, so these tests hold what
the card's kernel is built from against the plain core that the JAX
parity tests (tests/test_torch_sm_kernel.py, tests/test_torch_lte_sm.py)
already hold against the reference:

- ``sm_advance_math`` over ``[t0, t1)``, ``t0 > 0``, equals ``t1 - t0``
  steps of ``sm_step_math`` on ``tti_coins``, for every scheduler id;
- the cell grouping (``cell_order``/``cell_start``) and a numpy mirror
  of the kernel's admission scan and winner key agree with
  ``sm_admit_retx`` and ``sm_dispatch``;
- a numpy mirror of the dynamic arm's refresh-row rule picks the
  reference's refresh and the row the plain loop reads; the sweep's
  lanes are its points on shared keys;
- the wrapper's device dispatch, its checks of the table and the sweep,
  and the C launcher's signature.

Tolerance: none — state bit for bit, winners and admissions exactly.
The kernel against ``sm_advance_math`` on the card is
tests/test_torch_cuda.py and ``chip_smoke.py``.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_cpu

from tpudes_torch.parallel import kernels_cuda as kc
from tpudes_torch.parallel.lte_sm import LteSmProgram
from tpudes_torch.random import PRNGKey, replica_keys, tti_coins
from tpudes_torch.scenarios import lena_grid_program, lena_ue_drop

_torch_cpu.one_thread()

R = 3
CSRC = Path(kc.__file__).parents[1] / "csrc"


def _program():
    gen = torch.Generator().manual_seed(11)
    return lena_grid_program(*lena_ue_drop(3, 5, generator=gen), 100)


def _consts(prog):
    """The program's constants with the first-tx MI pulled below the
    code rate for some UEs, so retx, HARQ-IR and drops all run."""
    c = kc.build_sm_consts(prog, device="cpu")
    scale = torch.linspace(0.1, 1.0, prog.n_ue)
    return dict(c, mi0=(c["mi0"] * scale).contiguous())


def _warm_state(c, t, rng):
    """A state with every HARQ field populated, drawn with numpy."""
    E, U, n_rbg = c["E"], c["U"], c["n_rbg"]
    count_c = c["count_c"].numpy()

    def ints(lo, hi, shape=(R, U)):
        return rng.integers(lo, hi, shape).astype(np.int32)

    host = dict(
        avg=rng.uniform(1.0, 1e7, (R, U)).astype(np.float32),
        pend=ints(0, 2),
        p_mi=rng.uniform(0.0, 1.0, (R, U)).astype(np.float32),
        p_tbb=np.floor(rng.uniform(0.0, 2e4, (R, U))).astype(np.float32),
        p_nrbg=ints(1, n_rbg + 1),
        p_txc=ints(1, 4),
        p_due=ints(t - 8, t + 9),
        rr_ptr=(ints(0, 1 << 20, (R, E)) % np.maximum(count_c, 1))
        .astype(np.int32),
        rx_lo=ints(0, 1 << 20),
        rx_hi=ints(0, 4096),
        new_tbs=ints(0, 5000),
        retx=ints(0, 500),
        drops=ints(0, 50),
        ok_cnt=ints(0, 5000),
    )
    return {k: torch.from_numpy(host[k]) for k, _, _ in kc.SM_STATE}


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


@pytest.mark.parametrize("sched", list(kc.SM_SCHED_IDS))
def test_advance_math_equals_stepping_every_scheduler(sched, monkeypatch):
    prog = _program()
    sid = kc.SM_SCHED_IDS[sched]
    c = _consts(prog)
    t0, t1 = 37, 81
    s = _warm_state(c, t0, np.random.default_rng(sid))
    keys = replica_keys(PRNGKey(5), R)
    # coins drawn 3 TTIs at a time: chunk edges fall inside the range
    monkeypatch.setattr(kc, "COIN_CHUNK_ELEMS", 3 * R * prog.n_ue)
    got = kc.sm_advance(c, s, keys, t0, t1, sid)
    want = s
    coins = tti_coins(keys, t0, t1, prog.n_ue)
    for i in range(t1 - t0):
        want = kc.sm_step_math(c, want, coins[i], t0 + i, sid)
    for k, _, _ in kc.SM_STATE:
        assert torch.equal(_bits(got[k]), _bits(want[k])), (sched, k)
    for k in ("new_tbs", "retx", "drops", "ok_cnt"):
        assert int((got[k] - s[k]).sum()) > 0, (sched, k)


def _random_table(c, J, rng):
    """``J`` refreshes of the dynamic rows, drawn with numpy: MCS per
    UE and refresh, the rows it implies, a few UEs out of coverage."""
    from tpudes_torch.ops.lte import _MCS_ECR, _MCS_EFF

    U = c["U"]
    mcs = rng.integers(0, 29, (J, U))
    eff0 = _MCS_EFF[mcs]
    return dict(
        mi0=torch.from_numpy(
            (rng.uniform(0.2, 1.0, (J, U)) ** 3).astype(np.float32)
        ),
        rate0=torch.from_numpy(
            (np.floor(eff0 * c["rbg_size"] * 120.0) * 1000.0).astype(np.float32)
        ),
        eff0=torch.from_numpy(eff0),
        ecr0=torch.from_numpy(_MCS_ECR[mcs]),
        eligible=torch.from_numpy(
            (rng.random((J, U)) > 0.15).astype(np.int32)
        ),
    )


def kernel_row_index(t0: int, t1: int, stride: int) -> np.ndarray:
    """The table row ``csrc/lte_sm_advance.cu``'s dynamic arm holds in
    registers at each TTI of ``[t0, t1)``, mirrored in numpy: row 0 from
    ``t0``; a counter of the next refresh TTI, first ``(t0 // stride +
    1) * stride``, moves on by ``stride`` each time it is reached, and
    the row held moves on by one."""
    row, next_refresh, out = 0, (t0 // stride + 1) * stride, []
    for t in range(t0, t1):
        if t == next_refresh:
            row += 1
            next_refresh += stride
        out.append(row)
    return np.asarray(out)


@pytest.mark.parametrize("t0,t1,stride", [
    (0, 40, 1), (0, 40, 8), (5, 45, 8), (8, 9, 8), (13, 14, 8), (61, 141, 8),
    (1000, 1061, 8), (7, 50, 3), (3, 11, 16),
])
def test_refresh_row_rule_matches_the_reference_refresh(t0, t1, stride):
    """The kernel's row at TTI ``t`` is the refresh at ``stride *
    (t // stride)``, the one the reference's carried rows hold (a range
    that starts mid-stride runs on the refresh before it), and it lies
    inside the table ``table_rows`` sizes."""
    rows = kernel_row_index(t0, t1, stride)
    t = np.arange(t0, t1)
    assert np.array_equal(stride * (t0 // stride + rows),
                          stride * (t // stride))
    assert rows.min() == 0
    assert rows.max() == kc.table_rows(t0, t1, stride) - 1


@pytest.mark.parametrize("t0,t1,stride", [(37, 81, 8), (40, 60, 1),
                                          (5, 30, 3)])
def test_plain_loop_reads_the_rows_the_kernel_holds(t0, t1, stride):
    """``sm_advance_math`` with a table equals stepping ``sm_step_math``
    with the constants' dynamic rows replaced, TTI by TTI, by the row
    :func:`kernel_row_index` says the kernel holds."""
    prog = _program()
    c = _consts(prog)
    rng = np.random.default_rng(stride)
    s = _warm_state(c, t0, rng)
    table = _random_table(c, kc.table_rows(t0, t1, stride), rng)
    keys = replica_keys(PRNGKey(9), R)
    got = kc.sm_advance(c, s, keys, t0, t1, 0, table, stride)
    coins = tti_coins(keys, t0, t1, prog.n_ue)
    want = s
    for i, j in enumerate(kernel_row_index(t0, t1, stride)):
        cj = dict(c, **{k: table[k][j] for k in kc.SM_DYNAMIC_ROWS})
        want = kc.sm_step_math(cj, want, coins[i], t0 + i, 0)
    for k, _, _ in kc.SM_STATE:
        assert torch.equal(_bits(got[k]), _bits(want[k])), k
    static = kc.sm_advance(c, s, keys, t0, t1, 0)
    assert not torch.equal(static["rx_lo"], got["rx_lo"])


def test_sweep_lanes_are_points_on_shared_keys():
    """``sids`` of C points runs lane ``c * R + r`` as replica ``r`` of
    point ``c``, every point on the same replica keys."""
    prog = _program()
    c = _consts(prog)
    s = _warm_state(c, 20, np.random.default_rng(1))
    keys = replica_keys(PRNGKey(4), R)
    sids = torch.tensor([3, 0, 8], dtype=torch.int32)
    swept = kc.sm_advance(
        c, {k: torch.cat([v] * 3) for k, v in s.items()}, keys, 20, 50, sids
    )
    for i, sid in enumerate(sids.tolist()):
        one = kc.sm_advance(c, s, keys, 20, 50, sid)
        for k, _, _ in kc.SM_STATE:
            assert torch.equal(_bits(swept[k][i * R:(i + 1) * R]),
                               _bits(one[k])), (sid, k)


def test_advance_kernel_checks_the_table_and_the_sweep():
    """The CUDA wrapper refuses a table or ``sids`` of the wrong shape or
    type before it launches (these tensors are on the CPU, so a check
    that passed would go on to build the kernel)."""
    prog = _program()
    c = kc.build_sm_consts(prog, device="cpu")
    s = kc.sm_init_state(prog.n_enb, prog.n_ue, 2, device="cpu")
    keys = torch.zeros((2, 2), dtype=torch.int64)
    table = _random_table(c, kc.table_rows(5, 21, 8), np.random.default_rng(0))
    with pytest.raises(ValueError, match=r"rows\[mi0\]"):
        kc.sm_advance_cuda(c, s, keys, 5, 30, 0, table, 8)
    bad = dict(table, eligible=table["eligible"].float())
    with pytest.raises(ValueError, match=r"rows\[eligible\]"):
        kc.sm_advance_cuda(c, s, keys, 5, 21, 0, bad, 8)
    with pytest.raises(ValueError, match="stride"):
        kc.sm_advance_cuda(c, s, keys, 5, 21, 0, table, 0)
    with pytest.raises(ValueError, match="sids"):
        kc.sm_advance_cuda(c, s, keys, 5, 21,
                           torch.tensor([0, 1], dtype=torch.int64))
    with pytest.raises(ValueError, match="avg"):          # C * R lanes
        kc.sm_advance_cuda(c, s, keys, 5, 21,
                           torch.tensor([0, 1], dtype=torch.int32))


def _random_program(seed, E=5, U=40):
    """Random gains, each UE served by its strongest cell: a random
    serving map with most UEs eligible."""
    rng = np.random.default_rng(seed)
    gain = 10.0 ** rng.uniform(-13.0, -9.0, (E, U))
    return LteSmProgram(
        gain=gain, serving=gain.argmax(axis=0).astype(np.int32),
        tx_power_dbm=np.full(E, 30.0), noise_psd=4e-21, n_rb=25,
        n_ttis=10, scheduler="pf",
    )


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_cell_order_groups_serving_stably(seed):
    prog = _random_program(seed)
    c = kc.build_sm_consts(prog, device="cpu")
    order = c["cell_order"].numpy()
    start = c["cell_start"].numpy()
    serving = prog.serving
    assert sorted(order) == list(range(prog.n_ue))
    assert start[0] == 0 and start[-1] == prog.n_ue
    for e in range(prog.n_enb):
        run = order[start[e]:start[e + 1]]
        # the cell's UEs, contiguous and in UE-index order
        assert np.array_equal(run, np.flatnonzero(serving == e)), e


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sorted_scan_admission_equals_the_plain_prefix(seed):
    """The kernel's admission — one inclusive scan over the cell-sorted
    requests, minus the scan just before the cell — admits exactly the
    retx ``sm_admit_retx`` admits."""
    prog = _random_program(seed)
    c = kc.build_sm_consts(prog, device="cpu")
    rng = np.random.default_rng(100 + seed)
    t = 50
    s = _warm_state(c, t, rng)
    _, want_fit, want_rem = kc.sm_admit_retx(c, s, t)

    order = c["cell_order"].numpy()
    start = c["cell_start"].numpy()
    serving = prog.serving
    due = ((s["pend"].numpy() != 0) & (s["p_due"].numpy() <= t)
           & (c["eligible"].numpy() != 0))
    req = np.where(due, s["p_nrbg"].numpy(), 0)
    scan = np.cumsum(req[:, order], axis=1)                 # (R, U) sorted
    rank = np.argsort(order)                                # UE -> position
    before = np.where(
        start[serving] > 0, scan[:, np.maximum(start[serving] - 1, 0)], 0
    )
    fit = due & (scan[:, rank] - before <= c["n_rbg"])
    assert np.array_equal(fit, want_fit.numpy())
    used = np.stack([np.bincount(serving, w, prog.n_enb)
                     for w in np.where(fit, req, 0)])
    assert np.array_equal(c["n_rbg"] - used, want_rem.numpy())
    assert fit.any() and (due & ~fit).any()


@pytest.mark.parametrize("sched", ["fdmt", "tdbet"])
def test_winner_key_picks_the_dispatch_winner(sched):
    """Per cell, the candidate with the largest ``sm_winner_key`` is the
    winner ``sm_dispatch`` picks, on metrics full of ties, ``-0.0`` next
    to ``+0.0``, and ``NEG`` itself."""
    prog = _random_program(7, E=4, U=64)
    c = kc.build_sm_consts(prog, device="cpu")
    sid = kc.SM_SCHED_IDS[sched]
    rng = np.random.default_rng(sid)
    pool = np.array([0.0, -0.0, 1.0, -1.0, 2.5, kc.NEG, 3e5], np.float32)
    vals = rng.choice(pool, (R, prog.n_ue))
    s = kc.sm_init_state(prog.n_enb, prog.n_ue, R, device="cpu")
    if sched == "fdmt":                  # metric = rate0 (one row for all)
        vals[:] = vals[0]
        c = dict(c, rate0=torch.from_numpy(vals[0].copy()))
    else:                                # metric = -avg, sign bits kept
        s["avg"] = torch.from_numpy(-vals)
    metric = vals
    pend = rng.random((R, prog.n_ue)) < 0.3
    s["pend"] = torch.from_numpy(pend.astype(np.int32))
    rem = torch.from_numpy(
        rng.integers(0, 3, (R, prog.n_enb)).astype(np.int32)
    )
    disp = kc.sm_dispatch(c, s, s["pend"] != 0, rem, sid)

    cand = (c["eligible"].numpy() != 0) & ~pend
    key = kc.sm_winner_key(metric, np.arange(prog.n_ue))
    no_win = kc.sm_winner_key(np.float32(kc.NEG), 0)  # NEG, any index
    want = np.zeros((R, prog.n_ue), bool)
    for r in range(R):
        for e in range(prog.n_enb):
            members = np.flatnonzero((prog.serving == e) & cand[r])
            if len(members) == 0:
                continue
            best = members[np.argmax(key[r, members])]
            if key[r, best] > no_win and rem[r, e] > 0:
                want[r, best] = True
    assert np.array_equal(disp["is_winner"].numpy(), want)
    assert want.sum() > 0
    # the draw met both zeros and the fill value among the candidates
    zeros = metric[cand & (metric == 0.0)]
    assert np.signbit(zeros).any() and not np.signbit(zeros).all()
    assert (metric[cand] == np.float32(kc.NEG)).any()


def test_winner_key_orders_like_the_metric():
    m = np.array([-np.inf, kc.NEG, -2.0, -0.0, 0.0, 1e-30, 1.0, np.inf],
                 np.float32)
    key = kc.sm_winner_key(m, np.zeros(len(m), np.int64)) >> np.uint64(32)
    assert np.all(np.diff(key.astype(np.int64)) >= 0)
    assert key[3] == key[4]                          # -0.0 keys as +0.0
    # equal metrics: the lower UE index holds the larger key
    two = kc.sm_winner_key(np.float32([1.0, 1.0]), np.array([3, 9]))
    assert two[0] > two[1]


def test_advance_refuses_other_devices():
    prog = _program()
    consts = kc.build_sm_consts(prog, device="cpu")
    s = kc.sm_init_state(prog.n_enb, prog.n_ue, 1, device="cpu")
    s = {k: v.to("meta") for k, v in s.items()}
    keys = torch.zeros((1, 2), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="no LTE SM advance"):
        kc.sm_advance(consts, s, keys, 0, 4, 0)


def test_advance_kernel_refuses_a_bad_range():
    prog = _program()
    consts = kc.build_sm_consts(prog, device="cpu")
    s = kc.sm_init_state(prog.n_enb, prog.n_ue, 1, device="cpu")
    keys = torch.zeros((1, 2), dtype=torch.int64)
    for t0, t1 in ((5, 4), (-1, 3), (0, kc.ADVANCE_MAX_T + 1)):
        with pytest.raises(ValueError, match="lte_sm_advance runs"):
            kc.sm_advance_cuda(consts, s, keys, t0, t1, 0)


def test_state_and_consts_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the constants and state go to it")
    prog = _program()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        kc.build_sm_consts(prog)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        kc.sm_init_state(prog.n_enb, prog.n_ue, 1)


def test_advance_launcher_signature_matches_cuda_source():
    """The ctypes argtypes count equals the C launcher's parameter count
    (no compiler here, so the binding is checked against the text)."""
    src = (CSRC / "lte_sm_advance.cu").read_text()
    sig = re.search(r'extern "C" int lte_sm_advance_launch\((.*?)\)\s*\{',
                    src, re.S).group(1)
    assert len(sig.split(",")) == len(kc.LAUNCH_ARGTYPES["lte_sm_advance"])
    assert f"#define ADV_MAX_U {kc.KERNEL_MAX_U}" in src
    assert f"#define ADV_MAX_E {kc.KERNEL_MAX_E}" in src
    assert f"#define ADV_MAX_T {kc.ADVANCE_MAX_T}" in src


def test_build_digest_covers_the_shared_header(tmp_path, monkeypatch):
    """An edited header gives a new library path, so a build never loads
    a library compiled against the old header."""
    from tpudes_torch import _build

    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build.library_path("k")
    (tmp_path / "common.cuh").write_text("// two\n")
    assert _build.library_path("k") != before
    assert _build.library_path("k").parent == _build.BUILD
