"""The port's fused LTE TTI step against the reference Pallas kernel.

The plain PyTorch core (tpudes_torch.parallel.kernels_cuda) is run in
lockstep with ``build_sm_step_fn(consts, True)`` (the Pallas kernel, in
interpret mode on the CPU as the reference's own tests run it) for all
nine scheduler ids, from the same state and the same coins.
Tolerances: integer state exactly equal every TTI; ``avg``, ``p_mi``
and ``p_tbb`` rtol 1e-6 (XLA may contract or fold the f32 EMA and BLER
arithmetic differently).  The CUDA kernel against the plain core on the
card is tests/test_torch_cuda.py and ``chip_smoke.py``.
"""

import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_cpu

from tpudes.parallel import kernels_pallas as ref
from tpudes.parallel.programs import toy_lte_program
from tpudes_torch.convert import (
    PROGRAM_FIELDS,
    program_from_numpy,
    state_from_numpy,
)
from tpudes_torch.parallel import kernels_cuda as kc
from tpudes_torch.parallel.lte_sm import run_lte_sm

_torch_cpu.one_thread()

FLOAT_KEYS = ("avg", "p_mi", "p_tbb")
R = 3


def _program(n_enb=3, n_ue=12, seed=0):
    """A toy grid with seeded gains spread over every CQI (so the
    retx, winner and drop paths all run)."""
    prog = toy_lte_program(n_enb=n_enb, n_ue=n_ue, n_ttis=40)
    rng = np.random.default_rng(seed)
    gain = prog.gain * 10.0 ** rng.uniform(-2.0, 0.5, prog.gain.shape)
    return dataclasses.replace(prog, gain=gain)


def _port_program(prog):
    return program_from_numpy({k: getattr(prog, k) for k in PROGRAM_FIELDS})


def test_consts_agree_with_reference():
    prog = _program()
    want = ref.build_sm_consts(prog)
    got = kc.build_sm_consts(_port_program(prog), device="cpu")
    for k in ("E", "U", "n_rbg", "rbg_size", "n_rb", "pf_alpha"):
        assert got[k] == want[k], k
    for k in ("cqi", "mcs", "eligible", "pos", "count_u", "rate0", "eff0",
              "ecr0", "sinr"):
        assert np.array_equal(got[k].numpy(), want[k][0]), k
    np.testing.assert_allclose(got["mi0"].numpy(), want["mi0"][0],
                               rtol=1e-6, atol=0)
    assert np.array_equal(got["count_c"].numpy(), want["count_c"][:, 0])
    assert np.array_equal(got["serving"].numpy(), prog.serving)
    assert np.array_equal(
        got["cell_onehot"].numpy(), want["cell_onehot"] > 0
    )
    # the port replaces the (U, U) prefix matmul with the serving map:
    # the same-cell UE-order prefix it encodes is the reference operator
    same = prog.serving[:, None] == prog.serving[None, :]
    tri = np.arange(prog.n_ue)[:, None] <= np.arange(prog.n_ue)[None, :]
    assert np.array_equal(want["prefix"] > 0, same & tri)


@pytest.mark.parametrize("sched", list(kc.SM_SCHED_IDS))
def test_plain_core_matches_pallas_kernel_every_scheduler(sched):
    assert kc.SM_SCHED_IDS == ref.SM_SCHED_IDS
    prog = _program(seed=1)
    sid = kc.SM_SCHED_IDS[sched]
    consts_j = ref.build_sm_consts(prog)
    consts_t = kc.build_sm_consts(_port_program(prog), device="cpu")
    E, U = prog.n_enb, prog.n_ue
    # a CQI-matched TB almost always decodes; pull the first-tx MI below
    # the code rate (same values into both steps) so that the retx,
    # HARQ-IR accumulation and drop paths all run
    scale = np.random.default_rng(100).uniform(0.1, 1.0, (1, U))
    mi0 = (consts_j["mi0"] * scale).astype(
        np.float32
    )
    consts_j = dict(consts_j, mi0=mi0)
    consts_t = dict(consts_t, mi0=torch.from_numpy(mi0[0]))
    step_j = jax.jit(
        jax.vmap(ref.build_sm_step_fn(consts_j, True),
                 in_axes=(0, 0, None, None))
    )
    s_j = jax.vmap(lambda _: ref.sm_init_state(E, U))(jnp.arange(R))
    s_t = kc.sm_init_state(E, U, R, device="cpu")
    rng = np.random.default_rng(sid)
    for t in range(80):
        coin = rng.uniform(0.0, 1.0, (R, U)).astype(np.float32)
        s_j = step_j(s_j, jnp.asarray(coin)[:, None, :], jnp.int32(t),
                     jnp.int32(sid))
        s_t = kc.sm_step(consts_t, s_t, torch.from_numpy(coin), t, sid)
        want = state_from_numpy({k: np.asarray(v) for k, v in s_j.items()},
                                device="cpu")
        for k, _, _ in kc.SM_STATE:
            a, b = s_t[k].numpy(), want[k].numpy()
            assert a.dtype == b.dtype, k
            if k in FLOAT_KEYS:
                np.testing.assert_allclose(a, b, rtol=1e-6, atol=0,
                                           err_msg=f"{sched} t={t} {k}")
            else:
                assert np.array_equal(a, b), (sched, t, k)
    # the run exercised the whole HARQ ladder
    for k in ("new_tbs", "retx", "drops", "ok_cnt"):
        assert int(s_t[k].sum()) > 0, k


def test_state_from_numpy_layouts():
    E, U = 2, 5
    lane = {k: np.asarray(v) for k, v in ref.sm_init_state(E, U).items()}
    one = state_from_numpy(lane, device="cpu")
    assert one["avg"].shape == (1, U) and one["rr_ptr"].shape == (1, E)
    batched = {k: np.stack([v] * 4) for k, v in lane.items()}
    four = state_from_numpy(batched, device="cpu")
    assert four["pend"].shape == (4, U) and four["rr_ptr"].shape == (4, E)
    assert four["pend"].dtype == torch.int32
    assert four["avg"].dtype == torch.float32


def test_cuda_request_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA path runs instead")
    prog = _port_program(_program())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_lte_sm(prog, np.zeros(2, np.int64))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_lte_sm(prog, np.zeros(2, np.int64), device="cuda")


def _meta_state(prog, replicas=1):
    """A state on the meta device (sm_init_state takes only the card or
    the CPU)."""
    s = kc.sm_init_state(prog.n_enb, prog.n_ue, replicas, device="cpu")
    return {k: v.to("meta") for k, v in s.items()}


def test_wrapper_refuses_other_devices():
    prog = _port_program(_program())
    consts = kc.build_sm_consts(prog, device="cpu")
    s = _meta_state(prog)
    coin = torch.empty((1, prog.n_ue), device="meta")
    with pytest.raises(ValueError, match="no LTE SM step"):
        kc.sm_step(consts, s, coin, 0, 0)


def test_launcher_signature_matches_cuda_source():
    """The ctypes argtypes count equals the C launcher's parameter count
    (no compiler here, so the binding is checked against the text)."""
    src = (Path(kc.__file__).parents[1] / "csrc" / "lte_sm_step.cu").read_text()
    sig = re.search(r'extern "C" int lte_sm_step_launch\((.*?)\)\s*\{',
                    src, re.S).group(1)
    assert len(sig.split(",")) == len(kc.LAUNCH_ARGTYPES["lte_sm_step"])
    assert f"#define SM_MAX_U {kc.KERNEL_MAX_U}" in src
    assert f"#define SM_MAX_E {kc.KERNEL_MAX_E}" in src
