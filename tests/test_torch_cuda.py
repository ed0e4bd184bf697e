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
    assert kc.launches == {"lte_sm_step": 0, "lte_sm_advance": 2}
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
    assert kc.launches == {"lte_sm_step": 0, "lte_sm_advance": 1}
    chunked = run_lte_sm(prog, PRNGKey(3), replicas=R, device=card,
                         chunk_ttis=64)
    assert kc.launches["lte_sm_advance"] == 1 + math.ceil(prog.n_ttis / 64)
    plain = run_lte_sm(prog, PRNGKey(3), replicas=R, device=card,
                       use_kernel=False)
    cpu = run_lte_sm(prog, PRNGKey(3), replicas=R, device="cpu")
    assert kc.launches == {"lte_sm_step": 0,
                           "lte_sm_advance": 1 + math.ceil(prog.n_ttis / 64)}
    for k in ("rx_bits", "new_tbs", "retx", "drops", "ok", "cqi", "mcs"):
        assert np.array_equal(kern[k], plain[k]), k
        assert np.array_equal(kern[k], cpu[k]), k
        assert np.array_equal(kern[k], chunked[k]), k
