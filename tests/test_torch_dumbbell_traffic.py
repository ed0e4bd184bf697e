"""The port's app-limited TCP dumbbell against the JAX engine.

An app-limited program (``DumbbellProgram.traffic``) clips each flow's
sending to the segments its workload has offered by the end of the slot
(``tpudes/parallel/tcp_dumbbell.py:955-973``); ``traffic_sweep=[...]``
runs C workloads as one ``(C, R)`` grid.  Programs are the reference's
(``tpudes.parallel.programs.toy_dumbbell_program``, 1 ms slots, and RED
over it) with the reference's ``TrafficProgram``s, carried across with
``convert.dumbbell_from_numpy``; the JAX engine runs on the CPU as its
own tests run it, the port its plain loop on the CPU with the same key.

Tolerance: none.  Every output is equal per replica (floats bit for bit)
for cbr, mmpp, onoff and trace workloads, with RED/ECN, chunked and
over a three-point workload sweep; the whole state equals the
reference's after each of the first 200 slots; the offered-segment
table equals the reference's ``floor(tr_cum((t + 1) slot_us))``.  The
clip binds in every case (the app-limited run differs from the bulk one
and no flow delivers past what was offered).  The kernel's ``TRF`` arm
is held to the plain loop in ``tests/test_torch_tcp_mock.py`` and on the
card in ``tests/test_torch_cuda.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudes.parallel import tcp_dumbbell as J
from tpudes.parallel.programs import toy_dumbbell_program as jax_toy
from tpudes.parallel.programs import toy_traffic_points as jax_points
from tpudes.traffic import TrafficProgram as JaxTraffic
from tpudes.traffic.device import build_cum_fn
from tpudes_torch.convert import (
    DUMBBELL_FIELDS,
    TRAFFIC_FIELDS,
    dumbbell_from_numpy,
    dumbbell_state_from_numpy,
    traffic_from_numpy,
)
from tpudes_torch.parallel import tcp_dumbbell as P
from tpudes_torch.parallel.programs import toy_dumbbell_program
from tpudes_torch.scenarios import dumbbell_program
from tpudes_torch.traffic.device import app_cum_table, stack_traffic_operands

OUT_KEYS = ("goodput_mbps", "delivered", "drops", "mean_queue",
            "cwnd_final")
KEY = jax.random.PRNGKey(4)
FLOWS, SLOTS, REPLICAS = 3, 300, 3


def _port(prog):
    return dumbbell_from_numpy({k: getattr(prog, k) for k in DUMBBELL_FIELDS})


def _traffic(tp):
    return traffic_from_numpy({k: getattr(tp, k) for k in TRAFFIC_FIELDS})


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and np.array_equal(_bits(a), _bits(b))


def _workloads(horizon_us: int) -> dict:
    """One workload of each model for the toy dumbbell's flows, offering
    less than the 1 ms slots carry so that the clip binds."""
    return {
        "cbr": JaxTraffic.cbr(np.zeros(FLOWS, np.int32),
                              np.full(FLOWS, 7000, np.int64)),
        "mmpp": JaxTraffic.mmpp(FLOWS, 200.0, horizon_us=horizon_us,
                                epoch_s=0.05, tr_seed=2),
        "onoff": JaxTraffic.onoff(FLOWS, 300.0, horizon_us=horizon_us,
                                  on=(1.5, 0.02, 0.08), off_mean_s=0.05,
                                  tr_seed=1),
        "trace": jax_points(FLOWS, horizon_us)[-1],
    }


#: the RED/ECN program: the reference's toy dumbbell under RED marking its
#: ECN flows (tests/test_torch_dumbbell.py's red_3 step program)
RED_ECN = dict(qdisc="red", queue_cap=60, red_min_th=1.0, red_max_th=3.0,
               red_max_p=0.2, red_qw=0.2, red_use_ecn=True,
               red_use_hard_drop=False, ecn=np.asarray([True, False, True]))


def _check_run(jprog, chunk=None):
    want = J.run_tcp_dumbbell(jprog, KEY, replicas=REPLICAS,
                              chunk_slots=chunk)
    got = P.run_tcp_dumbbell(_port(jprog), np.asarray(KEY), REPLICAS,
                             chunk_slots=chunk, device="cpu")
    assert set(got) == set(OUT_KEYS)
    for k in OUT_KEYS:
        assert _same(got[k], want[k]), k
    return got


@pytest.mark.parametrize("model", ["cbr", "mmpp", "onoff", "trace"])
def test_app_limited_run_equals_reference(model):
    tp = _workloads(SLOTS * 1000)[model]
    base = jax_toy(n_flows=FLOWS, n_slots=SLOTS)
    got = _check_run(dataclasses.replace(base, traffic=tp))
    bulk = P.run_tcp_dumbbell(_port(base), np.asarray(KEY), REPLICAS,
                              device="cpu")
    assert not np.array_equal(got["delivered"], bulk["delivered"])
    offered = np.floor(np.asarray(build_cum_fn(tp)(tp.operands(),
                                                    SLOTS * 1000)))
    assert (got["delivered"] <= offered[None, :]).all()
    assert got["delivered"].sum() > 0


@pytest.mark.parametrize("model", ["onoff", "trace"])
def test_app_limited_red_ecn_equals_reference(model):
    tp = _workloads(SLOTS * 1000)[model]
    jprog = dataclasses.replace(jax_toy(n_flows=FLOWS, n_slots=SLOTS),
                                traffic=tp, **RED_ECN)
    got = _check_run(jprog)
    assert got["delivered"].sum() > 0


@pytest.mark.parametrize("model", ["mmpp", "onoff"])
def test_app_limited_chunked_equals_reference(model):
    tp = _workloads(SLOTS * 1000)[model]
    jprog = dataclasses.replace(jax_toy(n_flows=FLOWS, n_slots=SLOTS),
                                traffic=tp)
    got = _check_run(jprog, chunk=97)
    whole = P.run_tcp_dumbbell(_port(jprog), np.asarray(KEY), REPLICAS,
                               device="cpu")
    for k in OUT_KEYS:
        assert _same(got[k], whole[k]), k


def test_traffic_sweep_equals_reference():
    """Three workload points (cbr, mmpp, onoff of the reference's eight
    toy points) in one grid: each point equal to the reference's sweep
    and to the port's own run of that workload."""
    pts = [jax_points(FLOWS, SLOTS * 1000)[i] for i in (1, 2, 5)]
    jprog = dataclasses.replace(jax_toy(n_flows=FLOWS, n_slots=SLOTS),
                                traffic=pts[0])
    want = J.run_tcp_dumbbell(jprog, KEY, replicas=REPLICAS,
                              traffic_sweep=pts)
    port = _port(jprog)
    got = P.run_tcp_dumbbell(port, np.asarray(KEY), REPLICAS,
                             traffic_sweep=[_traffic(tp) for tp in pts],
                             device="cpu")
    assert len(got) == len(want) == 3
    for tp, w, g in zip(pts, want, got):
        own = P.run_tcp_dumbbell(dataclasses.replace(port,
                                                     traffic=_traffic(tp)),
                                 np.asarray(KEY), REPLICAS, device="cpu")
        for k in OUT_KEYS:
            assert _same(g[k], w[k]), k
            assert _same(g[k], own[k]), k
    assert not np.array_equal(got[0]["delivered"], got[2]["delivered"])


def test_sweep_refusals_are_the_references():
    prog = toy_dumbbell_program(2, 60)
    pts = [_traffic(tp) for tp in jax_points(2, 60_000)]
    base = dataclasses.replace(prog, traffic=pts[0])
    key = np.asarray(KEY)
    with pytest.raises(ValueError, match="one config axis"):
        P.run_tcp_dumbbell(base, key, 2, traffic_sweep=pts,
                           variants=[[0, 1]] * 8, device="cpu")
    with pytest.raises(ValueError, match="shape key"):
        P.run_tcp_dumbbell(base, key, 2, device="cpu", traffic_sweep=[
            pts[0], dataclasses.replace(pts[1], n_cycle=1)])
    with pytest.raises(ValueError, match="prog.traffic"):
        P.run_tcp_dumbbell(prog, key, 2, traffic_sweep=pts, device="cpu")
    with pytest.raises(ValueError, match="one a flow"):
        P.run_tcp_dumbbell(
            dataclasses.replace(prog, traffic=_traffic(jax_points(3, 60_000)[
                0])), key, 2, device="cpu")


def test_step_state_equals_reference_each_slot():
    """The onoff workload on the toy dumbbell: the whole state after each
    of the first 200 slots equal to the reference's jitted advance."""
    tp = _workloads(SLOTS * 1000)["onoff"]
    jprog = dataclasses.replace(jax_toy(n_flows=FLOWS, n_slots=SLOTS),
                                traffic=tp)
    prog = _port(jprog)
    R, slots = 4, 200
    init, fn = J.build_dumbbell_advance(jprog, R)
    fn = jax.jit(fn)
    var = jnp.asarray(jprog.variant_idx)
    ecn = jnp.zeros(FLOWS, bool)
    tr = tp.operands()
    carry = (jnp.int32(0), init())
    consts = P.build_tcp_consts(prog, "cpu")
    state = P.init_state(consts, R)
    ops = stack_traffic_operands([prog.traffic], "cpu")
    app = app_cum_table(ops, prog.traffic.epoch_us, consts["slot_us"], 0,
                        slots)
    tkey = torch.as_tensor(np.asarray(KEY, np.int64))
    v, e = torch.as_tensor(var)[None], torch.as_tensor(ecn)[None]
    for t in range(slots):
        carry, _ = fn(carry, KEY, var, ecn, jnp.int32(t + 1), tr)
        state = P.tcp_advance_math(consts, state, tkey, t, t + 1, v, e,
                                   app_cum=app[:, t:t + 1])
        want = dumbbell_state_from_numpy(jax.device_get(carry[1]), "cpu")
        for k, _, _ in P.TCP_STATE:
            assert _same(state[k].numpy(), want[k].numpy()), (t, k)
    assert int(state["delivered"].sum()) > 0


@pytest.mark.parametrize("model", ["cbr", "mmpp", "onoff", "trace"])
def test_app_cum_table_equals_reference(model):
    """The launch's offered-segment table: ``floor(tr_cum((t + 1)
    slot_us))`` as int32 for every slot of a chunk, the reference's cum
    function called a slot at a time."""
    tp = _workloads(2_000_000)[model]
    slot_us, t0, t1 = 832, 1500, 1700
    cum = jax.jit(build_cum_fn(tp))
    want = np.stack([np.floor(np.asarray(cum(tp.operands(), jnp.int32(
        (t + 1) * slot_us)))).astype(np.int32) for t in range(t0, t1)])
    ops = stack_traffic_operands([_traffic(tp)], "cpu")
    got = app_cum_table(ops, tp.epoch_us, slot_us, t0, t1)
    assert got.dtype == torch.int32 and got.shape == (1, t1 - t0, FLOWS)
    assert np.array_equal(got[0].numpy(), want)


def test_dumbbell_program_takes_traffic():
    tp = _traffic(_workloads(1_000_000)["onoff"])
    prog = dumbbell_program(FLOWS, 1.0, variant="TcpCubic", traffic=tp)
    assert prog.traffic is tp
    carried = dumbbell_from_numpy({k: getattr(prog, k)
                                   for k in DUMBBELL_FIELDS})
    assert carried.traffic.param_key() == tp.param_key()
    assert P.build_tcp_consts(prog, "cpu")["slot_us"] == 832
