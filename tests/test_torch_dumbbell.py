"""The port's TCP dumbbell engine against the JAX engine.

Programs are lowered by the reference (``tpudes.scenarios.
build_dumbbell`` + ``lower_dumbbell``, a RED root qdisc installed where
asked) and carried across with ``convert.dumbbell_from_numpy``; the
port's own lowering, ``scenarios.dumbbell_program``, must give the same
fields.  The JAX engine runs on the CPU as its own tests run it; the
port runs its plain loop on the CPU with the same key.

Tolerances: none.  The variant rules (``cwnd_increase``,
``loss_response``) equal the jitted reference rules bit for bit on
random side states for every variant; the compiled ``cbrt`` and
``power`` equal ``jnp``'s on every point tried; the step's whole state
equals the reference's after each of its first 200 slots, droptail and
RED; and a whole run's ``delivered`` and ``drops`` are equal and its
``cwnd_final``, ``mean_queue`` and ``goodput_mbps`` bit-equal, per
replica, for the bench programs (cut to 8 replicas x 1 s), a RED/ECN
program with DCTCP and non-ECT NewReno flows, a three-point
``variants=[...]`` sweep and a chunked run.  No tie class has separated
the engines here (ROADMAP Queue C).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudes.core.world import reset_world
from tpudes.models.traffic_control import TrafficControlHelper
from tpudes.parallel import tcp_dumbbell as J
from tpudes.scenarios import build_dumbbell
from tpudes_torch.convert import (
    DUMBBELL_FIELDS,
    dumbbell_from_numpy,
    dumbbell_state_from_numpy,
)
from tpudes_torch.ops import fused
from tpudes_torch.parallel import tcp_dumbbell as P
from tpudes_torch.parallel.programs import (
    toy_dumbbell_program,
    toy_traffic_points,
)
from tpudes_torch.random import PRNGKey, tcp_draws
from tpudes_torch.scenarios import dumbbell_program

OUT_KEYS = ("goodput_mbps", "delivered", "drops", "mean_queue",
            "cwnd_final")

#: the RED attributes of the ECN shape (``tests/test_ecn_dctcp.py``'s
#: harness, a shallower queue so that it marks and drops within 2 s)
RED_ECN = dict(MinTh=5.0, MaxTh=15.0, MaxSize=60, UseEcn=True,
               UseHardDrop=False)

#: build_dumbbell / dumbbell_program keywords (and RED attributes)
PROGRAMS = {
    "bench_tcp": dict(n_flows=8, sim_time=20.0, variant="TcpCubic"),
    "variant_sweep": dict(n_flows=17, sim_time=20.0,
                          variants=list(P.VARIANTS),
                          bottleneck_rate="13Mbps"),
    "red_dctcp": dict(n_flows=4, sim_time=2.0,
                      variants=["TcpDctcp", "TcpNewReno"] * 2,
                      bottleneck_rate="5Mbps", red=RED_ECN),
    # three shapes of the fuzz envelope (tcp_dumbbell.py:92-116)
    "fuzz_a": dict(n_flows=2, sim_time=0.9, variants=["TcpVeno", "TcpBic"],
                   bottleneck_rate="3Mbps", bottleneck_delay="20ms",
                   queue="25p", seg_bytes=500),
    "fuzz_b": dict(n_flows=4, sim_time=2.5, variant="TcpHighSpeed",
                   bottleneck_rate="5Mbps", bottleneck_delay="5ms",
                   queue="50p", seg_bytes=1000),
    "fuzz_c": dict(n_flows=3, sim_time=1.7,
                   variants=["TcpLp", "TcpBbr", "TcpDctcp"],
                   bottleneck_rate="10Mbps", bottleneck_delay="10ms",
                   queue="100p", seg_bytes=500),
}


def _reference(spec: dict):
    """The reference's lowering of ``spec``: build_dumbbell, a RED root
    qdisc on the bottleneck if ``red`` is given, lower_dumbbell."""
    spec = dict(spec)
    red = spec.pop("red", None)
    reset_world()
    try:
        db, _ = build_dumbbell(**spec)
        if red is not None:
            tch = TrafficControlHelper()
            tch.SetRootQueueDisc("tpudes::RedQueueDisc", **red)
            tch.Install(db.GetBottleneckDevices().Get(0))
        return J.lower_dumbbell(spec["sim_time"])
    finally:
        reset_world()


def _cut(prog, sim_s: float):
    """``prog`` cut to ``sim_s`` seconds: the horizon and the stops
    lowered again at the shorter simulation time."""
    n = int(np.ceil(sim_s / prog.slot_s))
    return dataclasses.replace(
        prog, n_slots=n,
        stop_slot=np.minimum(prog.stop_slot, int(sim_s / prog.slot_s)))


def _port(prog):
    return dumbbell_from_numpy({k: getattr(prog, k) for k in DUMBBELL_FIELDS})


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and np.array_equal(_bits(a), _bits(b))


@pytest.fixture(scope="module")
def lowered():
    return {name: _reference(spec) for name, spec in PROGRAMS.items()}


# --------------------------------------------------------------------------
# the compiled arithmetic and the rules
# --------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["cbrt", "w_pow_0.8", "keep_pow_n",
                                   "two_pow_rho"])
def test_compiled_power_and_cbrt_equal_jnp(which):
    rng = np.random.default_rng(7)
    if which == "cbrt":
        x = np.concatenate([rng.uniform(0, 500, 20000),
                            10 ** rng.uniform(-6, 6, 20000)])
        got = fused.cbrt(torch.from_numpy(x.astype(np.float32)))
        want = jax.jit(jnp.cbrt)(x.astype(np.float32))
    elif which == "w_pow_0.8":
        x = np.concatenate([rng.uniform(1, 1000, 20000),
                            10 ** rng.uniform(0, 6, 20000)]).astype(np.float32)
        got = fused.powf(torch.from_numpy(x), torch.tensor(np.float32(0.8)))
        want = jax.jit(lambda w: w**0.8)(x)
    elif which == "keep_pow_n":
        n = np.arange(0, 5000, dtype=np.int32)
        keep = np.float32(1.0 - 0.002)
        got = fused.powf(torch.tensor(keep), torch.from_numpy(n).float())
        want = jax.jit(lambda n: jnp.float32(keep) ** n)(n)
    else:
        rho = np.concatenate([[1.0], rng.uniform(1, 40, 20000)]) \
            .astype(np.float32)
        got = fused.powf(torch.tensor(np.float32(2.0)), torch.from_numpy(rho))
        want = jax.jit(lambda r: 2.0**r)(rho)
    assert _same(got.numpy(), want)


def _side_state(rng, R, F, t_s):
    f = lambda lo, hi: rng.uniform(lo, hi, (R, F)).astype(np.float32)  # noqa: E731

    def pick(share, a, b):
        return np.where(rng.random((R, F)) < share, a, b).astype(np.float32)

    ints = lambda hi, dt=np.int32: rng.integers(0, hi, (R, F)).astype(dt)  # noqa: E731
    return dict(
        w_max=pick(0.2, 0.0, f(0, 200)), epoch_t=pick(0.4, -1.0, f(0, t_s)),
        k=f(0, 5), origin=f(1, 200), w_est=f(1, 200),
        base_rtt=np.full((R, F), 0.024832, np.float32),
        last_diff=f(0, 20), min_rtt=pick(0.2, np.inf, f(0.02, 0.1)),
        ww_acc=f(0, 100), bwe=pick(0.3, 0.0, f(10, 5000)),
        ill_max_rtt=pick(0.2, 0.0, f(0.02, 0.3)), ill_alpha=f(0.3, 10),
        ill_beta=f(0.125, 0.5), bbr_acc=f(0, 100),
        bbr_bw=pick(0.2, 0.0, f(100, 5000)), bbr_full_bw=f(0, 5000),
        bbr_full_cnt=ints(5, np.float32), bbr_state=ints(3),
        bbr_cycle=ints(8), cwnd_cnt=f(0, 50), dctcp_alpha=f(0, 1),
        htcp_beta=f(0.5, 0.8), htcp_last_cong=f(0, t_s),
        lp_until=f(0, t_s + 0.1),
    )


@pytest.mark.parametrize("rule", ["cwnd_increase", "loss_response"])
@pytest.mark.parametrize("seed", [1, 2])
def test_rules_equal_the_reference_for_every_variant(rule, seed):
    """Every variant on random side states: cwnd, ssthresh and the whole
    side state bit-equal to the jitted reference rule."""
    rng = np.random.default_rng(seed)
    R, F, t_s = 96, 17, np.float32(3.7)
    var = np.tile(np.arange(F, dtype=np.int32), (R, 1))
    cwnd = np.where(rng.random((R, F)) < 0.05, 0.5,
                    rng.uniform(1, 200, (R, F))).astype(np.float32)
    ssthresh = np.where(rng.random((R, F)) < 0.3, 1e9,
                        rng.uniform(2, 150, (R, F))).astype(np.float32)
    acked_raw = rng.integers(0, 10, (R, F)).astype(np.int32)
    acked = np.where(rng.random((R, F)) < 0.2, 0, acked_raw).astype(np.int32)
    rtt = rng.uniform(0.02, 0.2, (R, 1)).astype(np.float32)
    st = _side_state(rng, R, F, t_s)
    T = torch.from_numpy  # noqa: N806
    pst = {k: T(v) for k, v in st.items()}
    if rule == "cwnd_increase":
        want = jax.jit(J._cwnd_increase)(jnp.asarray(var), cwnd, ssthresh,
                                         acked, t_s, rtt, st, acked_raw)
        got = P.cwnd_increase(T(var), T(cwnd), T(ssthresh), T(acked),
                              torch.tensor(t_s), T(rtt), pst, T(acked_raw))
    else:
        want = jax.jit(J._loss_response)(jnp.asarray(var), cwnd, st, t_s)
        got = P.loss_response(T(var), T(cwnd), pst, torch.tensor(t_s))
    *w_arrays, w_side = want
    *g_arrays, g_side = got
    for w, g in zip(w_arrays, g_arrays):
        assert _same(g.numpy(), w)
    assert set(w_side) == set(g_side)
    for k in w_side:
        assert _same(g_side[k].numpy(), w_side[k]), k


def test_draws_equal_jax_random():
    key = jax.random.PRNGKey(11)
    u_dep, u_red, u_mark = tcp_draws(PRNGKey(11), 5, 9, 4, 6, red=True)
    plain = tcp_draws(PRNGKey(11), 5, 9, 4, 6)[0]
    for t in range(5, 9):
        for r in range(4):
            kk = jax.random.fold_in(jax.random.fold_in(key, t), r)
            a, b, c = jax.random.split(kk, 3)
            assert float(u_dep[t - 5, r]) == float(
                jax.random.uniform(a, (), jnp.float32))
            assert _same(u_red[t - 5, r].numpy(),
                         jax.random.uniform(b, (6,), jnp.float32))
            assert float(u_mark[t - 5, r]) == float(
                jax.random.uniform(c, (), jnp.float32))
            assert float(plain[t - 5, r]) == float(
                jax.random.uniform(kk, (), jnp.float32))


# --------------------------------------------------------------------------
# the step, the lowering and whole runs
# --------------------------------------------------------------------------

#: the step checks' programs: the reference's toy dumbbell (1 ms slots,
#: a 25-packet queue) at 3 and 17 flows, and RED over it, marking its
#: ECN flows and early-dropping the rest, at thresholds low enough to act
#: within 200 slots
STEP_PROGRAMS = {
    "fifo_3": dict(n_flows=3),
    "fifo_17": dict(n_flows=17),
    "red_3": dict(n_flows=3, qdisc="red", queue_cap=60, red_min_th=1.0,
                  red_max_th=3.0, red_max_p=0.2, red_qw=0.2,
                  red_use_ecn=True, red_use_hard_drop=False,
                  ecn=np.asarray([True, False, True])),
    "red_17": dict(n_flows=17, qdisc="red", queue_cap=60, red_min_th=2.0,
                   red_max_th=6.0, red_qw=0.05),
}


@pytest.mark.parametrize("name", list(STEP_PROGRAMS))
def test_step_state_equals_reference_each_slot(name):
    spec = dict(STEP_PROGRAMS[name])
    n_flows = spec.pop("n_flows")
    jprog = dataclasses.replace(_jax_toy(n_flows), **spec)
    prog = _port(jprog)
    R, slots = 4, 200
    init, fn = J.build_dumbbell_advance(jprog, R)
    fn = jax.jit(fn)
    key = jax.random.PRNGKey(3)
    var = jnp.asarray(jprog.variant_idx)
    ecn = jnp.asarray(jprog.ecn if jprog.ecn is not None
                      else np.zeros(n_flows, bool))
    carry = (jnp.int32(0), init())
    consts = P.build_tcp_consts(prog, "cpu")
    state = P.init_state(consts, R)
    tkey = torch.as_tensor(np.asarray(key, np.int64))
    v, e = torch.as_tensor(var)[None], torch.as_tensor(ecn)[None]
    marked = 0
    for t in range(slots):
        carry, _ = fn(carry, key, var, ecn, jnp.int32(t + 1))
        state = P.tcp_advance_math(consts, state, tkey, t, t + 1, v, e)
        want = dumbbell_state_from_numpy(jax.device_get(carry[1]), "cpu")
        for k, _, _ in P.TCP_STATE:
            assert _same(state[k].numpy(), want[k].numpy()), (t, k)
        marked += int(state["mark_buf"].sum() > 0)
    assert int(carry[0]) == slots
    assert int(state["drops"].sum()) > 0
    if spec.get("red_use_ecn"):
        assert marked > 0, "the RED program marked nothing"


def _jax_toy(n_flows):
    from tpudes.parallel.programs import toy_dumbbell_program as jax_toy

    return jax_toy(n_flows=n_flows, n_slots=250)


def test_toy_program_equals_reference():
    for n in (3, 17):
        want, got = _jax_toy(n), toy_dumbbell_program(n, 250)
        for k in DUMBBELL_FIELDS:
            assert _same(getattr(got, k), getattr(want, k)) or (
                getattr(got, k) is None and getattr(want, k) is None), k


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_port_lowering_equals_reference(lowered, name):
    """``dumbbell_program`` gives the reference's lowering field by field
    (the 17-variant bench's ``ack_lag`` lands on 37.5 slots and rounds to
    38)."""
    want = lowered[name]
    got = dumbbell_program(**PROGRAMS[name])
    for f in dataclasses.fields(J.DumbbellProgram):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        else:
            assert a == b and type(a) is type(b), f.name
    carried = _port(want)
    assert all(_same(getattr(carried, k), getattr(got, k))
               for k in DUMBBELL_FIELDS if k != "qdisc")
    if name == "variant_sweep":
        assert got.ack_lag == 38 and got.buf_len == 40


#: whole runs: (program, horizon s, replicas, chunk_slots, sweep points)
RUNS = {
    "bench_tcp": ("bench_tcp", 1.0, 8, None, None),
    "variant_sweep": ("variant_sweep", 1.0, 4, None, None),
    "red_dctcp": ("red_dctcp", 2.0, 8, None, None),
    "sweep_3": ("bench_tcp", 0.6, 4, None,
                [["TcpNewReno"] * 8, list(P.VARIANTS[:8]),
                 ["TcpDctcp", "TcpCubic"] * 4]),
    "chunked": ("fuzz_c", 0.9, 4, 701, None),
}


@pytest.mark.parametrize("name", list(RUNS))
def test_run_equals_reference_per_replica(lowered, name):
    which, sim_s, R, chunk, points = RUNS[name]
    jprog = _cut(lowered[which], sim_s)
    key = jax.random.PRNGKey(5)
    want = J.run_tcp_dumbbell(jprog, key, replicas=R, variants=points,
                              chunk_slots=chunk)
    got = P.run_tcp_dumbbell(_port(jprog), np.asarray(key), R,
                             variants=points, chunk_slots=chunk,
                             device="cpu")
    if points is None:
        want, got = [want], [got]
    assert len(got) == len(want)
    for w, g in zip(want, got):
        assert set(g) == set(OUT_KEYS)
        for k in OUT_KEYS:
            assert _same(g[k], w[k]), (name, k)
        assert g["delivered"].shape == (R, jprog.n_flows)
        assert (g["delivered"].sum(1) > 0).all()
    if name == "red_dctcp":
        assert got[0]["drops"].sum() > 0


def test_sweep_point_equals_its_own_run(lowered):
    """A sweep point is the run of the program with that point's
    variants and the ECN they imply."""
    prog = _port(_cut(lowered["bench_tcp"], 0.3))
    points = [["TcpDctcp", "TcpBbr"] * 4, ["TcpVegas"] * 8]
    key = np.asarray(PRNGKey(9))
    swept = P.run_tcp_dumbbell(prog, key, 3, variants=points, device="cpu")
    for point, res in zip(points, swept):
        ids = P.variant_point(point)
        own = P.run_tcp_dumbbell(
            dataclasses.replace(prog, variant_idx=ids,
                                ecn=P.variant_ecn(ids)), key, 3,
            device="cpu")
        for k in OUT_KEYS:
            assert _same(res[k], own[k]), k


@pytest.mark.parametrize("what", ["traffic", "traffic_sweep", "mesh",
                                  "obs", "checkpoint", "block"])
def test_refusals_name_their_roadmap_item(what):
    """What the port does not run names its ROADMAP item, also beside the
    runtime's ``checkpoint=`` and ``block=False``, which run
    (tests/test_torch_checkpoint.py, test_torch_runtime.py); an
    app-limited workload and a workload sweep run (tests/
    test_torch_dumbbell_traffic.py), and what they refuse is the
    reference's: a workload without one entity a flow, a sweep without
    ``prog.traffic``."""
    prog = toy_dumbbell_program(2, 20)
    workloads = toy_traffic_points(3, 20_000)
    kw = {"traffic_sweep": dict(traffic_sweep=workloads),
          "mesh": dict(mesh=object()), "obs": dict(obs=True),
          "checkpoint": dict(checkpoint="ckpt", mesh=object()),
          "block": dict(block=False, obs=True)}.get(what, {})
    if what == "traffic":
        prog = dataclasses.replace(prog, traffic=workloads[0])
    item = {"mesh": "A12", "obs": "A10", "checkpoint": "A12",
            "block": "A10"}.get(what)
    error, match = ((NotImplementedError, item) if item else
                    (ValueError, {"traffic": "one a flow",
                                  "traffic_sweep": "prog.traffic"}[what]))
    with pytest.raises(error, match=match):
        P.run_tcp_dumbbell(prog, np.asarray(PRNGKey(0)), 2, device="cpu",
                           **kw)


def test_bad_sweep_points_raise():
    prog = toy_dumbbell_program(3, 20)
    key = np.asarray(PRNGKey(0))
    with pytest.raises(ValueError, match="assigns all 3 flows"):
        P.run_tcp_dumbbell(prog, key, 2, variants=[["TcpCubic"] * 2],
                           device="cpu")
    with pytest.raises(ValueError, match="at least one point"):
        P.run_tcp_dumbbell(prog, key, 2, variants=[], device="cpu")


def test_folded_constants_are_the_compiled_steps():
    """The constants the port folds are those the reference's optimised
    HLO holds (printed to round-trip f32): the HighSpeed and RED chains,
    cubic's 1 / C, Hybla's and LEDBAT's reciprocals."""
    f32 = np.float32
    assert f32(P._HS_K) == f32("0.0520223044")
    assert f32(P.folded(1.0 - 0.02, 15.0)) == f32("0.0653333366")
    assert f32(P.folded(0.02, 10.0)) == f32("0.002")
    assert (P._CUBIC_INV_C, P._HYBLA_INV, P._LEDBAT_INV) == (2.5, 40.0, 10.0)
