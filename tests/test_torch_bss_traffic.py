"""The port's WiFi BSS under a traffic program against the JAX engine.

A traffic program gives every arrival's next gap from its workload
model (cbr, mmpp, onoff, trace), the mmpp draws keyed
``fold_in(fold_in(fold_in(fold_in(key, 0x7A), r), entity), t)``.  Held
against the reference on the CPU, on the same numpy inputs: the gap per
model at random (entity, t), the table helpers (``with_cbr_rows``,
``unify_shapes``, ``stack_traffic_operands``), the step budget, the
recipes, and per-replica outputs and ``steps`` of whole runs, the
``traffic_sweep=[...]`` axis point for point, mobile + traffic + A-MPDU
composed, and the cbr program against ``traffic=None``.

Tolerances: none.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudes.core.world import reset_world
from tpudes.parallel.programs import toy_bss_program as jax_toy_bss
from tpudes.parallel.programs import toy_traffic_points as jax_toy_points
from tpudes.parallel.replicated import _estimate_max_steps as jax_estimate
from tpudes.parallel.replicated import lower_bss
from tpudes.parallel.replicated import run_replicated_bss as jax_run_bss
from tpudes.scenarios import build_bss
from tpudes.traffic import TrafficProgram as JaxTraffic
from tpudes.traffic import bounded_pareto_mean
from tpudes.traffic.device import TRAFFIC_KEY_TAG as JAX_TAG
from tpudes.traffic.device import build_gap_fn as jax_build_gap_fn
from tpudes.traffic.program import unify_shapes as jax_unify_shapes
from tpudes_torch.convert import (
    BSS_FIELDS,
    MOBILITY_FIELDS,
    TRAFFIC_FIELDS,
    bss_from_numpy,
    mobility_from_numpy,
    traffic_from_numpy,
)
from tpudes_torch.parallel import programs
from tpudes_torch.parallel import replicated as bss
from tpudes_torch.random import PRNGKey, traffic_keys
from tpudes_torch.traffic.device import (
    TRAFFIC_KEY_TAG,
    entry_gaps,
    stack_traffic_operands,
)
from tpudes_torch.traffic.program import unify_shapes

OUT_KEYS = ("srv_rx", "cli_rx", "tx_data", "drops", "steps", "all_done")
SIM_US = 320_000


def _tr(tp):
    return None if tp is None else traffic_from_numpy(
        {k: getattr(tp, k) for k in TRAFFIC_FIELDS})


def _port(prog):
    mob = None if prog.mobility is None else mobility_from_numpy(
        {k: getattr(prog.mobility, k) for k in MOBILITY_FIELDS})
    return bss_from_numpy({k: getattr(prog, k) for k in BSS_FIELDS}, mob,
                          _tr(prog.traffic))


def _same_traffic(a, b):
    for k in TRAFFIC_FIELDS:
        x, y = getattr(a, k), getattr(b, k)
        if isinstance(y, np.ndarray) or isinstance(x, np.ndarray):
            assert x is not None and y is not None, k
            assert x.dtype == y.dtype and np.array_equal(x, y), k
        else:
            assert x == y, k


@pytest.fixture(scope="module")
def toy():
    """The 8-STA toy BSS to 0.32 s and its eight shape-unified workload
    points (cbr x2, mmpp x3, onoff x2, trace), the AP on its beacons."""
    prog = jax_toy_bss(8, SIM_US)
    pts = jax_toy_points(prog.n, prog.sim_end_us, start_us=prog.start_us,
                         beacon=(int(prog.interval_us[0]),
                                 int(prog.start_us[0])))
    return prog, pts


POINT_NAMES = ("cbr20", "cbr9", "mmpp0", "mmpp1", "mmpp2", "onoff0",
               "onoff1", "trace")


@pytest.mark.parametrize("point", range(8), ids=POINT_NAMES)
def test_gap_per_model_equals_reference(toy, point):
    """``entry_gaps`` at every entity over 15 random (t, replica key)
    draws equals the reference's jitted ``build_gap_fn`` bit for bit
    (mmpp's exponential draws included)."""
    prog, pts = toy
    tp = pts[point]
    jgap = jax.jit(jax_build_gap_fn(tp))
    ops = tp.operands()
    port_ops = stack_traffic_operands([_tr(tp)], "cpu")
    every = torch.arange(tp.n)
    rng = np.random.default_rng(point)
    got_all, want_all = [], []
    for _ in range(15):
        r = int(rng.integers(0, 64))
        t = rng.integers(0, SIM_US + 50_000, tp.n).astype(np.int32)
        kr = jax.random.fold_in(jax.random.fold_in(
            jax.random.PRNGKey(11), JAX_TAG), r)
        want_all.append(np.asarray(jgap(ops, kr, jnp.asarray(t))))
        key_r = traffic_keys(PRNGKey(11), 64)[r]
        got_all.append(entry_gaps(
            port_ops, tp.epoch_us, torch.zeros_like(every), every,
            key_r.expand(tp.n, 2), torch.as_tensor(t)).numpy())
    got, want = np.stack(got_all), np.stack(want_all)
    assert got.dtype == np.int32
    assert np.array_equal(got, want), POINT_NAMES[point]
    assert (got[:, 1:] < 2**30).any()


def test_traffic_keys_equal_reference():
    """``traffic_keys`` is ``fold_in(fold_in(key, 0x7A), r)``."""
    assert TRAFFIC_KEY_TAG == JAX_TAG
    key = jax.random.PRNGKey(5)
    tr = jax.random.fold_in(key, JAX_TAG)
    want = np.stack([np.asarray(jax.random.fold_in(tr, r)) for r in range(6)])
    assert np.array_equal(traffic_keys(PRNGKey(5), 6).numpy(), want)


def test_with_cbr_rows_and_unify_shapes_equal_reference():
    """``with_cbr_rows`` and ``unify_shapes`` give the reference's
    fields; the stacked operands are the per-point operands."""
    n, horizon = 6, 500_000
    start = np.full(n, 20_000, np.int32)
    ref = [
        JaxTraffic.mmpp(n, 70.0, horizon_us=horizon, epoch_s=0.04,
                        start_us=start, tr_seed=2),
        JaxTraffic.onoff(n, 120.0, horizon_us=horizon, on=(1.5, 0.05, 0.3),
                         off_mean_s=0.2, start_us=start, tr_seed=3),
        JaxTraffic.trace_replay(np.arange(n * 5).reshape(n, 5) * 997 + 40),
        JaxTraffic.cbr(start, 15_000),
    ]
    ref = [tp.with_cbr_rows(np.arange(n) == 0, 102_400, 0) for tp in ref]
    port = [_tr(tp) for tp in ref]
    for a, b in zip(port, ref):
        _same_traffic(a, b)
    want = jax_unify_shapes(ref)
    got = unify_shapes(port)
    assert len({tp.shape_key() for tp in got}) == 1
    for a, b in zip(got, want):
        _same_traffic(a, b)
    stacked = stack_traffic_operands(got, "cpu")
    for p, tp in enumerate(got):
        for k, v in tp.operands("cpu").items():
            assert torch.equal(stacked[k][p], v), k
    with pytest.raises(ValueError, match="shape key"):
        stack_traffic_operands(port, "cpu")
    with pytest.raises(ValueError, match="entity count"):
        unify_shapes([port[0], _tr(JaxTraffic.cbr(start[:3], 9_000))])


def test_toy_recipes_equal_reference(toy):
    """``programs.toy_bss_program`` / ``toy_traffic_points`` build the
    reference's programs."""
    prog, pts = toy
    got = programs.toy_bss_program(8, SIM_US)
    for f in dataclasses.fields(prog):
        a, b = getattr(got, f.name), getattr(prog, f.name)
        assert (np.array_equal(a, b) if isinstance(b, np.ndarray)
                else a == b), f.name
    mine = programs.toy_traffic_points(
        got.n, got.sim_end_us, start_us=got.start_us,
        beacon=(int(got.interval_us[0]), int(got.start_us[0])))
    for a, b in zip(mine, pts):
        _same_traffic(a, b)


def test_onoff_recipe_equals_the_bench_burst_program():
    """``bss_onoff_traffic`` is ``bench_traffic_burst``'s ON-OFF
    workload at the program's mean echo rate, the AP on its beacons."""
    prog = jax_toy_bss(8, SIM_US)
    on, off_s = (1.5, 0.05, 0.3), 0.1
    duty = bounded_pareto_mean(*on) / (bounded_pareto_mean(*on) + off_s)
    want = JaxTraffic.onoff(
        prog.n, 1e6 / float(prog.interval_us[1]) / duty,
        horizon_us=prog.sim_end_us, on=on, off_mean_s=off_s,
        start_us=prog.start_us, tr_seed=1,
    ).with_cbr_rows(np.arange(prog.n) == 0, int(prog.interval_us[0]),
                    int(prog.start_us[0]))
    _same_traffic(programs.bss_onoff_traffic(_port(prog)), want)


@pytest.mark.parametrize("which", ["mmpp", "onoff", "sparse"])
def test_step_budget_takes_the_workload_total(toy, which):
    """``_estimate_max_steps`` of a traffic program is the reference's:
    the workload's own offered total where it beats the CBR count (the
    bursty models here), else the CBR count (a cbr workload at twice
    the program's interval)."""
    prog, pts = toy
    tp = dict(mmpp=pts[2], onoff=pts[5],
              sparse=JaxTraffic.cbr(prog.start_us, 40_000))[which]
    jp = dataclasses.replace(prog, traffic=tp)
    assert bss._estimate_max_steps(_port(jp)) == jax_estimate(jp)
    assert (jax_estimate(jp) > jax_estimate(prog)) == (which != "sparse")


def _run(jp, R=4, seed=1, **kw):
    want = jax_run_bss(jp, R, jax.random.PRNGKey(seed), **kw)
    port_kw = dict(kw)
    if "traffic_sweep" in kw:
        port_kw["traffic_sweep"] = [_tr(tp) for tp in kw["traffic_sweep"]]
    got = bss.run_replicated_bss(_port(jp), R, PRNGKey(seed), device="cpu",
                                 **port_kw)
    return want, got


def _equal(got, want):
    for k in OUT_KEYS:
        assert np.array_equal(got[k], np.asarray(want[k])), k


@pytest.mark.parametrize("point", [0, 2, 5, 7],
                         ids=["cbr", "mmpp", "onoff", "trace"])
def test_run_equals_jax_per_replica(toy, point):
    """Whole runs under each model: per-replica outputs and ``steps``
    equal the JAX engine's."""
    prog, pts = toy
    want, got = _run(dataclasses.replace(prog, traffic=pts[point]))
    _equal(got, want)
    assert got["all_done"] and got["tx_data"].sum() > 0


def test_traffic_sweep_equals_jax_sweep_point_for_point(toy):
    """The eight points as one ``traffic_sweep``: each equals the JAX
    sweep's point, its own ``steps``, and the port's own run of that
    workload with the same budget."""
    prog, pts = toy
    jp = dataclasses.replace(prog, traffic=pts[0])
    want, got = _run(jp, R=2, traffic_sweep=pts)
    assert isinstance(got, list) and len(got) == len(pts)
    budget = max(jax_estimate(dataclasses.replace(prog, traffic=tp))
                 for tp in pts)
    for c in range(len(pts)):
        _equal(got[c], want[c])
    assert len({p["steps"] for p in got}) > 4
    one = bss.run_replicated_bss(
        _port(dataclasses.replace(prog, traffic=pts[4])), 2, PRNGKey(1),
        device="cpu", max_steps=budget)
    _equal(got[4], one)


def test_traffic_sweep_of_an_ampdu_program_equals_jax_sweep():
    """A workload sweep of four points (cbr, mmpp, onoff, trace) on an
    802.11n A-MPDU program: each point equals the JAX sweep's."""
    reset_world()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sta, ap, clients, _ = build_bss(
            4, 1.1, interval_s=0.02, data_mode="HtMcs7", standard="80211n",
            radii=(12.0, 20.0))
        jp = lower_bss([sta.Get(i) for i in range(4)], ap, clients, 1.1)
    reset_world()
    pts = jax_toy_points(jp.n, jp.sim_end_us, start_us=jp.start_us,
                         beacon=(int(jp.interval_us[0]),
                                 int(jp.start_us[0])))
    pts = [pts[i] for i in (0, 2, 5, 7)]
    assert jp.max_mpdus > 1
    want, got = _run(dataclasses.replace(jp, traffic=pts[0]), R=2,
                     traffic_sweep=pts)
    for c in range(len(pts)):
        _equal(got[c], want[c])


def test_traffic_sweep_refusals(toy):
    """One config axis per run, a traffic program to name the shape, and
    points of one shape key; the same errors as the reference."""
    prog, pts = toy
    port = _port(dataclasses.replace(prog, traffic=pts[0]))
    sweep = [_tr(tp) for tp in pts]
    with pytest.raises(ValueError, match="one config axis"):
        bss.run_replicated_bss(port, 2, PRNGKey(0), device="cpu",
                               sim_end_us=[SIM_US], traffic_sweep=sweep)
    with pytest.raises(ValueError, match="shape key"):
        bss.run_replicated_bss(dataclasses.replace(port, traffic=None), 2,
                               PRNGKey(0), device="cpu", traffic_sweep=sweep)
    odd = _tr(JaxTraffic.cbr(prog.start_us, 20_000))
    with pytest.raises(ValueError, match="shape key"):
        bss.run_replicated_bss(port, 2, PRNGKey(0), device="cpu",
                               traffic_sweep=sweep[:2] + [odd])


def test_cbr_program_equals_traffic_none(toy):
    """The ``traffic_off`` pair: the cbr workload of the program's own
    intervals gives ``traffic=None``'s outputs bit for bit."""
    prog, pts = toy
    port = _port(prog)
    plain = bss.run_replicated_bss(port, 4, PRNGKey(3), device="cpu")
    cbr = bss.run_replicated_bss(dataclasses.replace(port, traffic=_tr(
        pts[0])), 4, PRNGKey(3), device="cpu")
    _equal(cbr, plain)


def test_traffic_under_a_horizon_sweep_equals_jax(toy):
    """A traffic program under ``sim_end_us=[...]``: each horizon equals
    the JAX sweep's point."""
    prog, pts = toy
    ends = [220_000, 320_000, 270_000]
    want, got = _run(dataclasses.replace(prog, traffic=pts[6]),
                     sim_end_us=ends)
    for c in range(len(ends)):
        _equal(got[c], want[c])


def test_mobile_traffic_ampdu_composed_equals_jax():
    """802.11n A-MPDUs, const-velocity drift at stride 4 and the ON-OFF
    workload in one program: per replica equal to the JAX engine,
    unchunked and chunked."""
    reset_world()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sta, ap, clients, _ = build_bss(
            4, 1.15, interval_s=0.02, data_mode="HtMcs7", standard="80211n",
            radii=(12.0, 20.0, 28.0), mobility="const_velocity", speed=2.0)
        jp = lower_bss([sta.Get(i) for i in range(4)], ap, clients, 1.15,
                       geom_stride=4)
    reset_world()
    tp = JaxTraffic.onoff(
        jp.n, 200.0, horizon_us=jp.sim_end_us, on=(1.5, 0.05, 0.3),
        off_mean_s=0.1, start_us=jp.start_us, tr_seed=1,
    ).with_cbr_rows(np.arange(jp.n) == 0, int(jp.interval_us[0]),
                    int(jp.start_us[0]))
    jp = dataclasses.replace(jp, traffic=tp)
    assert jp.max_mpdus > 1
    want, got = _run(jp, R=2, seed=2)
    _equal(got, want)
    assert got["geom_refreshes"] == want["geom_refreshes"]
    chunked = bss.run_replicated_bss(_port(jp), 2, PRNGKey(2), device="cpu",
                                     chunk_steps=333)
    _equal(chunked, want)
