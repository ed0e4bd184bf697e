"""tpudes_torch's CUDA kernel against its plain PyTorch core, on the card.

These tests need an NVIDIA GPU and ``nvcc``: the kernel has no CPU
mode, so here they skip.  The file imports neither JAX nor ``tpudes``,
so the card's machine (which has no JAX) runs it without the suite's
conftest:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Tolerance: none — the kernel and the plain core must give bit-identical
state, and the slice's integer outputs must be equal.
"""

import numpy as np
import pytest
import torch

from tpudes_torch.parallel import kernels_cuda as kc
from tpudes_torch.parallel.lte_sm import run_lte_sm
from tpudes_torch.random import PRNGKey
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


@pytest.mark.cuda
@pytest.mark.parametrize("sched", list(kc.SM_SCHED_IDS))
def test_kernel_bit_equal_to_plain_core(card, sched):
    prog = _program()
    sid = kc.SM_SCHED_IDS[sched]
    consts = kc.build_sm_consts(prog, device=card)
    # first-tx MI below the code rate for some UEs: retx and drops run
    scale = torch.linspace(0.1, 1.0, prog.n_ue, device=card)
    consts = dict(consts, mi0=(consts["mi0"] * scale).contiguous())
    s_k = kc.sm_init_state(prog.n_enb, prog.n_ue, R, device=card)
    s_p = {k: v.clone() for k, v in s_k.items()}
    gen = torch.Generator(device=card).manual_seed(sid)
    for t in range(80):
        coin = torch.rand((R, prog.n_ue), generator=gen, device=card)
        s_k = kc.sm_step(consts, s_k, coin, t, sid)
        s_p = kc.sm_step_math(consts, s_p, coin, t, sid)
        for k, _, _ in kc.SM_STATE:
            a, b = s_k[k], s_p[k]
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            assert torch.equal(a, b), (sched, t, k)
    assert int(s_k["retx"].sum()) > 0 and int(s_k["drops"].sum()) > 0


@pytest.mark.cuda
def test_slice_kernel_equals_plain_and_counts_launches(card):
    prog = _program()
    kc.reset_launches()
    kern = run_lte_sm(prog, PRNGKey(3), replicas=R, device=card)
    assert kc.launches == prog.n_ttis
    plain = run_lte_sm(prog, PRNGKey(3), replicas=R, device=card,
                       use_kernel=False)
    cpu = run_lte_sm(prog, PRNGKey(3), replicas=R, device="cpu")
    assert kc.launches == prog.n_ttis
    for k in ("rx_bits", "new_tbs", "retx", "drops", "ok", "cqi", "mcs"):
        assert np.array_equal(kern[k], plain[k]), k
        assert np.array_equal(kern[k], cpu[k]), k
