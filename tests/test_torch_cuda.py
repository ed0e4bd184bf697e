"""tpudes_torch's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and ``nvcc``: the kernels have no CPU
mode, so here they skip.  The file imports neither JAX nor ``tpudes``,
so the card's machine (which has no JAX) runs it without the suite's
conftest:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Tolerance: none — each kernel and its plain version must give
bit-identical state, and the slice's integer outputs must be equal.
"""

import math

import numpy as np
import pytest
import torch

from tpudes_torch.parallel import kernels_cuda as kc
from tpudes_torch.parallel.lte_sm import run_lte_sm
from tpudes_torch.random import PRNGKey, replica_keys
from tpudes_torch.scenarios import lena_grid_program, lena_ue_drop

R = 4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernel has no "
                    "CPU mode); run on the card")
    return torch.device("cuda")


def _program(n_ttis=200):
    gen = torch.Generator().manual_seed(11)
    return lena_grid_program(*lena_ue_drop(3, 5, generator=gen), n_ttis)


def _harq_consts(prog, card):
    """The program's constants with the first-tx MI below the code rate
    for some UEs, so retx and drops run."""
    consts = kc.build_sm_consts(prog, device=card)
    scale = torch.linspace(0.1, 1.0, prog.n_ue, device=card)
    return dict(consts, mi0=(consts["mi0"] * scale).contiguous())


def _counts(step=0, advance=0, dynamic=0, sweep=0):
    return {"lte_sm_step": step, "lte_sm_advance": advance,
            "lte_sm_advance:dynamic": dynamic, "lte_sm_advance:sweep": sweep}


def _bit_equal(a, b):
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("sched", list(kc.SM_SCHED_IDS))
def test_kernel_bit_equal_to_plain_core(card, sched):
    prog = _program()
    sid = kc.SM_SCHED_IDS[sched]
    consts = _harq_consts(prog, card)
    s_k = kc.sm_init_state(prog.n_enb, prog.n_ue, R, device=card)
    s_p = {k: v.clone() for k, v in s_k.items()}
    gen = torch.Generator(device=card).manual_seed(sid)
    for t in range(80):
        coin = torch.rand((R, prog.n_ue), generator=gen, device=card)
        s_k = kc.sm_step(consts, s_k, coin, t, sid)
        s_p = kc.sm_step_math(consts, s_p, coin, t, sid)
        for k, _, _ in kc.SM_STATE:
            assert _bit_equal(s_k[k], s_p[k]), (sched, t, k)
    assert int(s_k["retx"].sum()) > 0 and int(s_k["drops"].sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("sched", list(kc.SM_SCHED_IDS))
def test_advance_kernel_bit_equal_to_plain_loop(card, sched):
    """Two launches of ``lte_sm_advance``, the second from ``t0 > 0``,
    against one plain loop over the same TTIs, from a warmed state in
    which retx and drops occur."""
    prog = _program()
    sid = kc.SM_SCHED_IDS[sched]
    consts = _harq_consts(prog, card)
    keys = replica_keys(PRNGKey(sid), R).to(card)
    s0 = kc.sm_advance_math(
        consts, kc.sm_init_state(prog.n_enb, prog.n_ue, R, device=card),
        keys, 0, 30, sid,
    )
    kc.reset_launches()
    s1 = kc.sm_advance(consts, s0, keys, 30, 75, sid)
    s2 = kc.sm_advance(consts, s1, keys, 75, 130, sid)
    assert kc.launches == _counts(advance=2)
    want = kc.sm_advance_math(consts, s0, keys, 30, 130, sid)
    for k, _, _ in kc.SM_STATE:
        assert _bit_equal(s2[k], want[k]), (sched, k)
    assert int((s2["retx"] - s0["retx"]).sum()) > 0
    assert int((s2["drops"] - s0["drops"]).sum()) > 0


@pytest.mark.cuda
def test_slice_kernel_equals_plain_and_counts_launches(card):
    prog = _program()
    kc.reset_launches()
    kern = run_lte_sm(prog, PRNGKey(3), replicas=R, device=card)
    assert kc.launches == _counts(advance=1)
    chunked = run_lte_sm(prog, PRNGKey(3), replicas=R, device=card,
                         chunk_ttis=64)
    assert kc.launches["lte_sm_advance"] == 1 + math.ceil(prog.n_ttis / 64)
    plain = run_lte_sm(prog, PRNGKey(3), replicas=R, device=card,
                       use_kernel=False)
    cpu = run_lte_sm(prog, PRNGKey(3), replicas=R, device="cpu")
    assert kc.launches == _counts(advance=1 + math.ceil(prog.n_ttis / 64))
    for k in ("rx_bits", "new_tbs", "retx", "drops", "ok", "cqi", "mcs"):
        assert np.array_equal(kern[k], plain[k]), k
        assert np.array_equal(kern[k], cpu[k]), k
        assert np.array_equal(kern[k], chunked[k]), k


def _random_table(consts, J, rng, card):
    """``J`` refreshes of the dynamic rows, drawn with numpy."""
    from tpudes_torch.ops.lte import _MCS_ECR, _MCS_EFF

    U = consts["U"]
    mcs = rng.integers(0, 29, (J, U))
    eff0 = _MCS_EFF[mcs]
    host = dict(
        # cubed: many first-tx MIs far below the code rate
        mi0=(rng.uniform(0.2, 1.0, (J, U)) ** 3).astype(np.float32),
        rate0=(np.floor(eff0 * consts["rbg_size"] * 120.0) * 1000.0).astype(
            np.float32
        ),
        eff0=eff0, ecr0=_MCS_ECR[mcs],
        eligible=(rng.random((J, U)) > 0.15).astype(np.int32),
    )
    return {k: torch.from_numpy(v).to(card) for k, v in host.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("sched", list(kc.SM_SCHED_IDS))
def test_dynamic_arm_bit_equal_to_plain_loop(card, sched):
    """Two launches of the dynamic arm on one stride-3 table, the first
    and the second starting mid-stride, against one plain loop."""
    prog = _program()
    sid = kc.SM_SCHED_IDS[sched]
    consts = _harq_consts(prog, card)
    keys = replica_keys(PRNGKey(sid), R).to(card)
    stride, t0, tm, t1 = 3, 31, 74, 130
    table = _random_table(consts, t1 // stride + 1,
                          np.random.default_rng(sid), card)

    def rows(a, b):
        j0 = a // stride
        return {k: v[j0:j0 + kc.table_rows(a, b, stride)].contiguous()
                for k, v in table.items()}

    s0 = kc.sm_advance_math(
        consts, kc.sm_init_state(prog.n_enb, prog.n_ue, R, device=card),
        keys, 0, t0, sid, rows(0, t0), stride,
    )
    kc.reset_launches()
    s1 = kc.sm_advance(consts, s0, keys, t0, tm, sid, rows(t0, tm), stride)
    s2 = kc.sm_advance(consts, s1, keys, tm, t1, sid, rows(tm, t1), stride)
    assert kc.launches == _counts(advance=2, dynamic=2)
    want = kc.sm_advance_math(consts, s0, keys, t0, t1, sid, rows(t0, t1),
                              stride)
    for k, _, _ in kc.SM_STATE:
        assert _bit_equal(s2[k], want[k]), (sched, k)
    assert int((s2["retx"] - s0["retx"]).sum()) > 0
    assert int((s2["drops"] - s0["drops"]).sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("dynamic", [False, True])
def test_sweep_arm_bit_equal_to_plain_loop(card, dynamic):
    """One launch over all nine scheduler ids against the plain loop,
    bit-equal per point."""
    prog = _program()
    consts = _harq_consts(prog, card)
    keys = replica_keys(PRNGKey(7), R).to(card)
    sids = torch.arange(9, dtype=torch.int32, device=card)
    table = (_random_table(consts, kc.table_rows(10, 90, 8),
                           np.random.default_rng(2), card)
             if dynamic else None)
    s0 = kc.sm_init_state(prog.n_enb, prog.n_ue, 9 * R, device=card)
    kc.reset_launches()
    got = kc.sm_advance(consts, s0, keys, 10, 90, sids, table, 8)
    assert kc.launches == _counts(advance=1, sweep=1, dynamic=int(dynamic))
    want = kc.sm_advance_math(consts, s0, keys, 10, 90, sids, table, 8)
    for k, _, _ in kc.SM_STATE:
        assert _bit_equal(got[k], want[k]), k
    per_point = got["new_tbs"].reshape(9, R, -1).sum((1, 2))
    assert len(set(per_point.tolist())) > 1


@pytest.mark.cuda
def test_mobile_slice_kernel_equals_plain_and_cpu(card):
    """A moving drop through the kernel (whole and in chunks of 7), the
    plain loop on the card and the plain loop on the CPU: equal integers;
    only the dynamic arm launches."""
    from tpudes_torch.scenarios import lena_mobile_program

    prog = lena_mobile_program(3, 5, 200, geom_stride=8,
                               generator=torch.Generator().manual_seed(4))
    kc.reset_launches()
    kern = run_lte_sm(prog, PRNGKey(3), replicas=R, device=card)
    chunked = run_lte_sm(prog, PRNGKey(3), replicas=R, device=card,
                         chunk_ttis=7)
    n = 1 + math.ceil(prog.n_ttis / 7)
    assert kc.launches == _counts(advance=n, dynamic=n)
    plain = run_lte_sm(prog, PRNGKey(3), replicas=R, device=card,
                       use_kernel=False)
    cpu = run_lte_sm(prog, PRNGKey(3), replicas=R, device="cpu")
    assert kc.launches == _counts(advance=n, dynamic=n)
    assert kern["geom_refreshes"] == math.ceil(prog.n_ttis / 8)
    for k in ("rx_bits", "new_tbs", "retx", "drops", "ok", "cqi", "mcs",
              "geom_refreshes"):
        assert np.array_equal(kern[k], plain[k]), k
        assert np.array_equal(kern[k], chunked[k]), k
        assert np.array_equal(kern[k], cpu[k]), k
    swept = run_lte_sm(prog, PRNGKey(3), replicas=R, device=card,
                       schedulers=["rr", prog.scheduler])
    for k in ("rx_bits", "new_tbs", "retx", "drops", "ok"):
        assert np.array_equal(swept[1][k], kern[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["const_velocity", "random_walk"])
def test_geometry_table_card_equals_cpu(card, model):
    """The geometry stage runs the same IEEE f32/f64 operations on the
    card as on the CPU: the integer rows are equal, and so is SINR (the
    walk's f64 ``sin``/``cos`` round alike on both but for an ulp in
    about 2**28 values)."""
    from tpudes_torch.parallel.lte_sm import geom_rows
    from tpudes_torch.scenarios import lena_mobile_program

    prog = lena_mobile_program(3, 5, 4000, model, geom_stride=4,
                               generator=torch.Generator().manual_seed(6))
    t = 4 * torch.arange(1000)
    on_card = geom_rows(prog, kc.build_sm_consts(prog, device=card),
                        t.to(card))
    on_cpu = geom_rows(prog, kc.build_sm_consts(prog, device="cpu"), t)
    for k in ("cqi", "mcs", "eligible", "rate0", "eff0", "ecr0"):
        assert torch.equal(on_card[k].cpu(), on_cpu[k]), k
    for k in ("sinr", "mi0"):
        np.testing.assert_allclose(on_card[k].cpu().numpy(),
                                   on_cpu[k].numpy(), rtol=1e-6, atol=0)
    if model == "const_velocity":
        assert _bit_equal(on_card["sinr"].cpu(), on_cpu["sinr"])
