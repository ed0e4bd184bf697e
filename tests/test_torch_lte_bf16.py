"""The port's bf16 arm (``precision="bf16"``) against the JAX package.

Each bf16 op site is held against the reference function as its CPU
executable computes it, elementwise, over a log sweep of operands, so
that a change in where XLA rounds fails here:

- ``build_sm_consts``' op-by-op CQI and MI (every op its own
  executable): bit-equal;
- the jitted geometry stage's CQI and MI: bit-equal, on a sweep and on
  the rows of a moving bf16 program;
- the jitted step's PF / MT / BET metric: the per-cell winners of the
  reference's ``sm_dispatch`` (bf16 rounding makes ties, which the
  lowest UE index breaks), equal;
- the jitted step's BLER: atol 2.5e-7, the two ``erfc`` implementations'
  own gap (the f32 BLER differs by as much); rounding the quotient, as
  the source reads, would move it by up to 1e-3.

``run_lte_sm`` in bf16 against the JAX engine on the CPU (``build_lena(2,
4)`` lowerings, key ``PRNGKey(3)``, 4 replicas): static, mobile (stride
4) and traffic, with the integer outputs equal per replica and ``sinr``
bit-equal.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpudes.ops.lte as ref
from tpudes.core.world import reset_world
from tpudes.parallel import kernels_pallas as kp
from tpudes.parallel.lte_sm import _build_geom_fn, lower_lte_sm
from tpudes.parallel.lte_sm import run_lte_sm as jax_run_lte_sm
from tpudes.scenarios import build_lena
from tpudes.traffic.program import TrafficProgram as JaxTraffic
from tpudes_torch.convert import (
    MOBILITY_FIELDS,
    PROGRAM_FIELDS,
    TRAFFIC_FIELDS,
    mobility_from_numpy,
    program_from_numpy,
    traffic_from_numpy,
)
from tpudes_torch.ops import lte as port
from tpudes_torch.parallel import kernels_cuda as kc
from tpudes_torch.parallel.lte_sm import SM_DYNAMIC_ROWS, geom_rows, run_lte_sm
from tpudes_torch.random import PRNGKey

INT_KEYS = ("rx_bits", "new_tbs", "retx", "drops", "ok", "cqi", "mcs")
KEY_SEED = 3
REPLICAS = 4
BF16 = jnp.bfloat16


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _sinr_sweep(n=20000, seed=0):
    """bf16-stored SINRs on a log sweep from -25 dB to 45 dB, plus the
    CQI boundaries."""
    db = np.random.default_rng(seed).uniform(-25.0, 45.0, n)
    edges = (2.0 ** np.asarray(ref.CQI_EFFICIENCY[1:]) - 1.0) * ref.SNR_GAP
    x = np.concatenate([10.0 ** (db / 10.0), edges]).astype(np.float32)
    return np.asarray(jnp.asarray(x).astype(BF16).astype(jnp.float32))


def _qm(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.choice([2.0, 4.0, 6.0], n).astype(np.float32)


def test_storage_rounding_bit_equal():
    x = (10.0 ** np.random.default_rng(1).uniform(-4, 5, 50000)).astype(
        np.float32)
    want = np.asarray(jnp.asarray(x).astype(BF16).astype(jnp.float32))
    assert np.array_equal(_bits(port.round_bf16(torch.from_numpy(x))),
                          _bits(want))


@pytest.mark.parametrize("seed", [0, 1])
def test_consts_site_op_by_op_bit_equal(seed):
    """``build_sm_consts`` runs the CQI/MI chain eagerly: every bf16 op
    is its own executable and is rounded."""
    sinr = _sinr_sweep(seed=seed)
    qm = _qm(sinr.size, seed)
    want_cqi = np.asarray(ref.cqi_from_sinr(jnp.asarray(sinr), dtype=BF16))
    want_mi = np.asarray(ref.mi_per_rb(jnp.asarray(sinr), jnp.asarray(qm),
                                       dtype=BF16))
    t = torch.from_numpy(sinr)
    assert np.array_equal(port.cqi_from_sinr(t, bf16=True).numpy(), want_cqi)
    got_mi = port.mi_per_rb(t, torch.from_numpy(qm), bf16=True)
    assert np.array_equal(_bits(got_mi.numpy()), _bits(want_mi))


def test_consts_site_f32_op_by_op_bit_equal():
    """The f32 chain op by op takes the compiler's ``log`` too: MI
    bit-equal."""
    sinr = (10.0 ** np.random.default_rng(2).uniform(-2.5, 4.5, 20000)
            ).astype(np.float32)
    qm = _qm(sinr.size, 2)
    want = np.asarray(ref.mi_per_rb(jnp.asarray(sinr), jnp.asarray(qm)))
    got = port.mi_per_rb(torch.from_numpy(sinr), torch.from_numpy(qm))
    assert np.array_equal(_bits(got.numpy()), _bits(want))


def test_geometry_site_jitted_bit_equal():
    """Under ``jit`` the gap division is a multiplication by the f32
    reciprocal of ``bf16(SNR_GAP)``, rounded, and ``+ 1`` is not
    rounded (the geometry stage's optimised HLO)."""
    sinr = _sinr_sweep(seed=3)
    qm = _qm(sinr.size, 3)

    @jax.jit
    def chain(s, q):
        return (ref.cqi_from_sinr(s, dtype=BF16),
                ref.mi_per_rb(s, q, dtype=BF16))

    want_cqi, want_mi = (np.asarray(a) for a in chain(sinr, qm))
    se = port.gapped_log2(torch.from_numpy(sinr), fused=True, bf16=True)
    assert np.array_equal(port.cqi_from_efficiency(se).numpy(), want_cqi)
    got_mi = port.mi_from_efficiency(se, torch.from_numpy(qm))
    assert np.array_equal(_bits(got_mi.numpy()), _bits(want_mi))


def test_bler_site_jitted():
    rng = np.random.default_rng(4)
    n = 50000
    mi = rng.uniform(0.0, 1.0, n).astype(np.float32)
    ecr = np.asarray(ref.MCS_ECR, np.float32)[rng.integers(0, 29, n)]
    tbb = np.floor(10.0 ** rng.uniform(1.0, 4.3, n)).astype(np.float32)
    want = np.asarray(jax.jit(
        lambda a, b, c: ref.tb_bler_ecr(a, b, c, dtype=BF16))(mi, ecr, tbb))
    t = [torch.from_numpy(a) for a in (mi, ecr, tbb)]
    got = port.tb_bler_ecr(*t, bf16=True).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2.5e-7)
    f32 = port.tb_bler_ecr(*t).numpy()
    assert np.abs(f32 - want).max() > 1e-4    # bf16 really rounds


@pytest.mark.parametrize("sid", [0, 5, 7])
def test_metric_site_winners_equal(sid):
    """Cells of three UEs with rates and averages on a log sweep: the
    reference's jitted ``sm_dispatch`` at bf16 and the port's pick the
    same winner in every cell (PF, MT and BET, sid 0, 5, 7)."""
    rng = np.random.default_rng(sid)
    E, per = 400, 3
    U = E * per
    serving = np.repeat(np.arange(E), per)
    rate0 = (np.floor(rng.uniform(100, 1400, U)) * 1000.0).astype(np.float32)
    avg = (10.0 ** rng.uniform(-1.0, 7.0, U)).astype(np.float32)
    # near-ties: neighbours a few f32 ulps apart
    avg[1::per] = np.nextafter(avg[::per], np.float32(0.0))
    rate0[2::per] = rate0[::per]
    onehot = serving[None, :] == np.arange(E)[:, None]
    pos = np.tile(np.arange(per), E).astype(np.int32)
    cj = dict(E=E, U=U, precision="bf16",
              rate0=jnp.asarray(rate0[None, :]),
              eligible=jnp.ones((1, U), jnp.int32),
              cell_onehot=jnp.asarray(onehot, jnp.float32),
              pos=jnp.asarray(pos[None, :]),
              count_u=jnp.full((1, U), per, jnp.int32),
              count_c=jnp.full((E, 1), per, jnp.int32))
    want = jax.jit(lambda av: kp.sm_dispatch(
        cj, dict(avg=av, rr_ptr=jnp.zeros((E, 1), jnp.int32)),
        jnp.zeros((1, U), bool), jnp.full((E, 1), 7, jnp.int32), sid,
    ))(avg[None, :])
    c = dict(E=E, U=U, bf16=True, rate0=torch.from_numpy(rate0),
             eligible=torch.ones(U, dtype=torch.int32),
             cell_onehot=torch.from_numpy(onehot),
             serving=torch.from_numpy(serving.astype(np.int32)),
             pos=torch.from_numpy(pos),
             count_u=torch.full((U,), per, dtype=torch.int32),
             count_c=torch.full((E,), per, dtype=torch.int32))
    got = kc.sm_dispatch(
        c, dict(avg=torch.from_numpy(avg)[None, :],
                rr_ptr=torch.zeros((1, E), dtype=torch.int32)),
        torch.zeros((1, U), dtype=torch.bool),
        torch.full((1, E), 7, dtype=torch.int32), sid)
    assert np.array_equal(got["is_winner"].numpy()[0],
                          np.asarray(want["is_winner"])[0])
    f32 = kc.sm_dispatch(
        dict(c, bf16=False), dict(avg=torch.from_numpy(avg)[None, :],
                                  rr_ptr=torch.zeros((1, E),
                                                     dtype=torch.int32)),
        torch.zeros((1, U), dtype=torch.bool),
        torch.full((1, E), 7, dtype=torch.int32), sid)
    assert not torch.equal(f32["is_winner"], got["is_winner"])


@pytest.fixture(scope="module")
def lowered():
    """The reference's static and moving (stride 4) lena lowerings."""
    reset_world()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        lte, _ = build_lena(2, 4)
        static = lower_lte_sm(lte, 0.25)
    reset_world()
    lte, _ = build_lena(2, 4, mobility="const_velocity", speed=10.0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        mobile = lower_lte_sm(lte, 0.1, geom_stride=4)
    reset_world()
    return dict(static=static, mobile=mobile)


def _port(prog):
    mob, tr = prog.mobility, prog.traffic
    return program_from_numpy(
        {k: getattr(prog, k) for k in PROGRAM_FIELDS},
        None if mob is None else mobility_from_numpy(
            {k: getattr(mob, k) for k in MOBILITY_FIELDS}),
        None if tr is None else traffic_from_numpy(
            {k: getattr(tr, k) for k in TRAFFIC_FIELDS}),
    )


def test_precision_crosses_over(lowered):
    prog = dataclasses.replace(lowered["static"], precision="bf16")
    assert _port(prog).precision == "bf16"
    # a caller that leaves the field out gets an error, not f32
    with pytest.raises(KeyError, match="precision"):
        program_from_numpy({k: getattr(prog, k) for k in PROGRAM_FIELDS
                            if k != "precision"})
    consts =kc.build_sm_consts(_port(prog), device="cpu")
    want = kp.build_sm_consts(prog)
    for k in ("sinr", "mi0", "cqi", "mcs", "eligible"):
        assert np.array_equal(_bits(consts[k].numpy()), _bits(want[k][0])), k


def test_geometry_rows_bit_equal(lowered):
    prog = dataclasses.replace(lowered["mobile"], precision="bf16")
    pos_at, rows_from_pos, _ = _build_geom_fn(prog, kp.build_sm_consts(prog))
    ops = prog.mobility.operands()
    rows_at = jax.jit(lambda t: rows_from_pos(pos_at(ops, t)))
    t = np.array([0, 1, 7, 8, 40, 63, 99])
    want = {k: np.stack([np.asarray(rows_at(jnp.int32(x))[k])[0] for x in t])
            for k in (*SM_DYNAMIC_ROWS, "sinr", "cqi", "mcs")}
    port_prog = _port(prog)
    got = geom_rows(port_prog, kc.build_sm_consts(port_prog, device="cpu"), t)
    for k, w in want.items():
        assert np.array_equal(_bits(got[k].numpy()), _bits(w)), k


def _traffic(prog):
    tp = JaxTraffic.onoff(prog.n_ue, 200.0, horizon_us=prog.n_ttis * 1000,
                          on=(1.5, 0.01, 0.05), off_mean_s=0.02, tr_seed=2)
    return dataclasses.replace(
        tp, size_pareto=np.asarray([1.4, 800.0, 12000.0], np.float32))


@pytest.mark.parametrize("sched", ["pf", "rr", "tdmt", "tdbet"])
@pytest.mark.parametrize("path", ["static", "mobile", "traffic"])
def test_bf16_run_matches_jax_engine_per_replica(lowered, path, sched):
    base = lowered["mobile" if path == "mobile" else "static"]
    prog = dataclasses.replace(base, precision="bf16", scheduler=sched)
    if path == "traffic":
        prog = dataclasses.replace(prog, traffic=_traffic(prog))
    want = jax_run_lte_sm(prog, jax.random.PRNGKey(KEY_SEED),
                          replicas=REPLICAS)
    got = run_lte_sm(_port(prog), PRNGKey(KEY_SEED), replicas=REPLICAS,
                     device="cpu")
    for k in INT_KEYS + ("goodput_bits",) * (path == "traffic"):
        assert np.array_equal(got[k], np.asarray(want[k])), (path, sched, k)
    assert np.array_equal(_bits(got["sinr"]), _bits(want["sinr"]))
    if path == "traffic":
        assert np.array_equal(_bits(got["backlog_bits"]),
                              _bits(want["backlog_bits"]))
    assert got["rx_bits"].sum() > 0
