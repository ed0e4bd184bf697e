"""Optimisation on the port's diff engines against tpudes.diff.

The contracts of ``tests/test_diff_opt.py``, each run through the JAX
package and the port on the CPU with the same numpy inputs and keys, at
that file's toy sizes: calibration recovers planted parameters (Adam and
L-BFGS-lite, the AS engine's flow rates and the LTE chain's exponent),
the descent is one launch and one runner, a cached descent refits new
observations, multi-start over ``init=`` reuses one runner, ES improves
the BSS design objective one launch a generation, ES and central
differences on an analytic bowl, and ``GradTelemetry`` with its schema
gate and CLI.

Tolerances: each calibration reaches the reference test's acceptance
(the planted exponent within 2 % under Adam, within 1e-3 under L-BFGS,
the planted flow rates within 10 %), and its final parameters are within
1e-3 relative of the JAX package's descent (the AS calibration, the
quadratic and the refits agree to 1e-6 and better); ``es_search``'s and
``bss_interval_design``'s ``theta`` and ``fitness`` equal the JAX
package's exactly (the populations are the same threefry draws).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_cpu

from tpudes import diff as jdiff
from tpudes.diff.lte_grad import build_lte_diff as jax_lte_diff
from tpudes.diff.lte_grad import lte_default_params as jax_lte_params
from tpudes.parallel import as_flows as jas
from tpudes.parallel.lte_sm import LteSmProgram as JaxLteProgram
from tpudes.parallel.programs import toy_as_program as jax_toy_as
from tpudes.parallel.programs import toy_bss_program as jax_toy_bss
from tpudes.traffic import TrafficProgram as JaxTraffic
from tpudes_torch import diff as tdiff
from tpudes_torch.convert import (
    AS_FIELDS,
    BSS_FIELDS,
    PROGRAM_FIELDS,
    TRAFFIC_FIELDS,
    as_from_numpy,
    bss_from_numpy,
    program_from_numpy,
    traffic_from_numpy,
)
from tpudes_torch.diff.calibrate import value_and_grad
from tpudes_torch.obs.device import CompileTelemetry
from tpudes_torch.parallel.runtime import RUNTIME

_torch_cpu.one_thread()

KEY = jax.random.PRNGKey(17)
TKEY = np.array([0, 17], np.int64)
CPU = dict(device="cpu")


@pytest.fixture(autouse=True)
def _reset_grad_telemetry():
    from tpudes_torch.obs.grad import GradTelemetry

    yield
    GradTelemetry.reset()


def _lte_scene(n_ue=6, pos_seed=0):
    """``tests/test_diff_opt.py:40``: two cells, log-distance n = 3."""
    E = 2
    serving = (np.arange(n_ue) % E).astype(np.int32)
    rng = np.random.default_rng(pos_seed)
    enb_pos = np.array([[0.0, 0.0, 30.0], [600.0, 0.0, 30.0]], np.float32)
    ue_pos = (enb_pos[serving]
              + np.c_[rng.uniform(-200, 200, n_ue),
                      rng.uniform(-200, 200, n_ue),
                      np.full(n_ue, -28.5)]).astype(np.float32)
    jprog = JaxLteProgram(
        gain=np.full((E, n_ue), 1e-12), serving=serving,
        tx_power_dbm=np.full((E,), 43.0),
        noise_psd=10.0**0.9 * 1.380649e-23 * 290.0, n_rb=25, n_ttis=400,
        scheduler="pf", enb_pos=enb_pos,
        pathloss=("log_distance", 3.0, 1.0, 46.67))
    port = program_from_numpy({k: getattr(jprog, k, None)
                               for k in PROGRAM_FIELDS})
    return jprog, port, ue_pos


_KPI = {}


def _observe(jprog, ue_pos, exponent) -> np.ndarray:
    """Per-UE soft CQIs at a planted exponent, through the JAX package's
    chain (the observations both descents fit), jitted once a scene."""
    key = ue_pos.tobytes()
    if key not in _KPI:
        _KPI[key] = jax.jit(jax_lte_diff(jprog, jdiff.Surrogacy()))
    kpi = _KPI[key]
    p = jax_lte_params(jprog, {"ue_pos": ue_pos})
    p["ploss"] = jnp.asarray([exponent, 1.0, 46.67], jnp.float32)
    return np.asarray(kpi(p)["cqi"])


def _close(got, want, rtol=1e-3):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol)


def _calibrate_both(jprog, prog, observed, **kw):
    want = jdiff.calibrate_lte(jprog, KEY, observed, **kw)
    got = tdiff.calibrate_lte(prog, TKEY, observed, **kw, **CPU)
    _close(got.params["ploss"], want.params["ploss"])
    assert got.loss.shape == want.loss.shape
    return got


class TestCalibration:
    def test_as_recovers_planted_flow_rates(self):
        """Plant per-flow rates, observe replica-mean goodput through the
        diff runner (six minibatches), descend 220 Adam steps from the
        nominal rates: within 10 % of the plant, the loss down twenty
        times, and the JAX package's fit to 1e-3."""
        jprog = dataclasses.replace(jax_toy_as(n_nodes=24, n_flows=3),
                                    surrogate=jdiff.Surrogacy(ste=False),
                                    rate_jitter=0.1)
        prog = as_from_numpy({k: getattr(jprog, k) for k in AS_FIELDS})
        planted = np.array([2.2e5, 0.9e5, 1.5e5], np.float32)
        diff_run = jax.jit(jas.build_as_diff(jprog, 8))
        gp = np.mean([np.asarray(diff_run(
            jas._as_replica_draws(jprog, jax.random.fold_in(KEY, i), 8),
            jnp.float32(1.0), jnp.asarray(planted),
            jnp.asarray(jprog.rate_bps, jnp.float32))["goodput_bps"]).mean(0)
            for i in range(6)], axis=0)
        kw = dict(wrt=("flow_bps",), steps=220, lr=0.06, replicas=8)
        res = tdiff.calibrate_as_flows(prog, TKEY, gp, **kw, **CPU)
        rel = np.abs(res.params["flow_bps"] - planted) / planted
        assert (rel < 0.10).all(), (res.params["flow_bps"], planted)
        assert res.loss[-1] < res.loss[0] / 20
        assert res.loss.shape == (220,)
        assert np.isfinite(res.grad_norm).all()
        want = jdiff.calibrate_as_flows(jprog, KEY, gp, **kw)
        _close(res.params["flow_bps"], want.params["flow_bps"])

    def test_lte_recovers_planted_exponent_adam_and_lbfgs(self):
        """Adam within 2 % of the planted exponent, L-BFGS-lite within
        1e-3 and its loss under 1e-8; both within 1e-3 of the JAX
        package's fits."""
        jprog, prog, ue_pos = _lte_scene()
        observed = _observe(jprog, ue_pos, 3.45)
        common = dict(wrt=("ploss",), at={"ue_pos": ue_pos}, loss="cqi_mse")
        adam = _calibrate_both(jprog, prog, observed, steps=250, lr=0.02,
                               opt="adam", **common)
        assert abs(adam.params["ploss"][0] - 3.45) < 0.07
        lbfgs = _calibrate_both(jprog, prog, observed, steps=80, lr=0.5,
                                opt="lbfgs", **common)
        assert abs(lbfgs.params["ploss"][0] - 3.45) < 1e-3
        assert lbfgs.loss[-1] < 1e-8

    def test_descent_loop_is_one_launch_one_compile(self):
        """The descent is one launch, and a repeat of the same study
        family reuses the cached runner."""
        jprog, prog, ue_pos = _lte_scene()
        observed = _observe(jprog, ue_pos, 3.0)
        kw = dict(wrt=("ploss",), at={"ue_pos": ue_pos}, steps=40,
                  loss="cqi_mse")
        first = _calibrate_both(jprog, prog, observed, **kw)
        l0 = RUNTIME.launches("diff_lte")
        c0 = CompileTelemetry.compiles("diff_lte")
        again = tdiff.calibrate_lte(prog, TKEY, observed, **kw, **CPU)
        assert RUNTIME.launches("diff_lte") - l0 == 1
        assert CompileTelemetry.compiles("diff_lte") - c0 == 0
        assert np.array_equal(first.loss, again.loss)

    @pytest.mark.parametrize("opt, steps, lr", [("adam", 300, 0.05),
                                                ("lbfgs", 30, 1.0)])
    def test_descend_optimizers_on_a_quadratic(self, opt, steps, lr):
        """Both optimizers minimise a plain quadratic, to the JAX
        package's iterate."""
        target = np.asarray([1.5, -2.0, 0.25], np.float32)
        tt = torch.from_numpy(target)

        def jvg(params, kt, ops):
            del kt, ops
            return jax.value_and_grad(
                lambda p: jnp.sum((p["x"] - target) ** 2))(params)

        res = tdiff.descend(value_and_grad(
            lambda p, kt, ops: ((p["x"] - tt) ** 2).sum()),
            {"x": np.zeros(3)}, steps=steps, lr=lr, key=TKEY, opt=opt,
            **CPU)
        np.testing.assert_allclose(res.params["x"], target, atol=5e-2)
        assert res.loss[-1] < 1e-3
        want = jdiff.descend(jvg, {"x": jnp.zeros(3)}, steps=steps, lr=lr,
                             key=KEY, opt=opt)
        np.testing.assert_allclose(res.params["x"], want.params["x"],
                                   rtol=1e-3, atol=1e-6)

    def test_unknown_optimizer_rejected(self):
        for descend, zeros in ((tdiff.descend, np.zeros(2)),
                               (jdiff.descend, jnp.zeros(2))):
            with pytest.raises(ValueError, match="adam"):
                descend(lambda p, k, o: (0.0, p), {"x": zeros}, steps=1,
                        lr=0.1, key=KEY, opt="sgd")

    def test_multi_start_recovers_a_wide_exponent_gap(self):
        """A 0.6 exponent gap: multi-start over ``init=`` reuses the first
        start's runner, no start produces a non-finite iterate, the best
        start recovers the plant; each start's fit is the JAX package's."""
        jprog, prog, ue_pos = _lte_scene(pos_seed=4)
        observed = _observe(jprog, ue_pos, 3.6)
        kw = dict(wrt=("ploss",), at={"ue_pos": ue_pos}, steps=120, lr=0.5,
                  loss="cqi_mse", opt="lbfgs")
        best = None
        first = None
        both = 0
        for e0 in (2.5, 3.0, 3.5, 4.0):
            init = {"ploss": np.array([e0, 1.0, 46.67])}
            res = tdiff.calibrate_lte(prog, TKEY, observed, init=init, **kw,
                                      **CPU)
            assert np.isfinite(res.loss).all(), e0
            if first is None:
                first = CompileTelemetry.compiles("diff_lte")
            if best is None or res.final_loss < best.final_loss:
                best = res
            # a start that reaches the plant in both packages fits alike
            # (one that stalls in a flat basin of the quantised landscape
            # wanders chaotically, in either package)
            ref = jdiff.calibrate_lte(jprog, KEY, observed, init=init, **kw)
            if max(res.final_loss, ref.final_loss) < 1e-8:
                _close(res.params["ploss"], ref.params["ploss"])
                both += 1
        assert CompileTelemetry.compiles("diff_lte") == first
        assert abs(best.params["ploss"][0] - 3.6) < 1e-3
        assert best.final_loss < 1e-8
        assert both >= 1

    def test_cached_descent_refits_new_observations(self):
        """The cached descent fits this call's observations (they ride as
        operands), in the port as in the JAX package."""
        jprog, prog, ue_pos = _lte_scene()
        for exp in (3.45, 2.75):
            fit = _calibrate_both(
                jprog, prog, _observe(jprog, ue_pos, exp), wrt=("ploss",),
                at={"ue_pos": ue_pos}, steps=80, lr=0.5, loss="cqi_mse",
                opt="lbfgs")
            assert abs(fit.params["ploss"][0] - exp) < 1e-3


class TestDesignSearch:
    def test_es_improves_bss_objective_one_launch_per_generation(self):
        """Each generation's population is one ``traffic_sweep`` run, the
        decoded-echo objective improves, and ``theta`` and ``fitness`` are
        the JAX package's exactly."""
        jprog = jax_toy_bss(n_sta=3, sim_end_us=40_000)
        tp = JaxTraffic.cbr(np.asarray(jprog.start_us),
                            np.asarray(jprog.interval_us))
        jprog = dataclasses.replace(jprog, traffic=tp)
        prog = bss_from_numpy({k: getattr(jprog, k) for k in BSS_FIELDS},
                              None, traffic_from_numpy(
                                  {k: getattr(tp, k) for k in TRAFFIC_FIELDS}))
        l0 = RUNTIME.launches("bss")
        res = tdiff.bss_interval_design(prog, TKEY, replicas=2,
                                        generations=3, pop=2, **CPU)
        assert RUNTIME.launches("bss") - l0 == res.launches == 3
        assert res.mean_fitness[-1] > res.mean_fitness[0]
        assert res.theta.shape == (3,)
        want = jdiff.bss_interval_design(jprog, KEY, replicas=2,
                                         generations=3, pop=2)
        assert np.array_equal(res.theta, want.theta)
        assert np.array_equal(res.fitness, want.fitness)
        assert np.array_equal(res.mean_fitness, want.mean_fitness)

    def test_es_and_fd_on_an_analytic_bowl(self):
        """``es_search`` climbs and ``fd_gradient`` matches the analytic
        gradient; both equal the JAX package's exactly."""
        opt = np.array([0.7, -0.3])

        def evaluate(thetas):
            d = thetas - opt[None, :]
            return -np.sum(d * d, axis=1)

        kw = dict(generations=40, pop=8, sigma=0.1, lr=0.5)
        res = tdiff.es_search(evaluate, np.zeros(2), key=TKEY, **kw)
        assert np.abs(res.theta - opt).max() < 0.15
        want = jdiff.es_search(evaluate, np.zeros(2), key=KEY, **kw)
        assert np.array_equal(res.theta, want.theta)
        assert np.array_equal(res.fitness, want.fitness)
        g = tdiff.fd_gradient(evaluate, np.zeros(2), eps=1e-4)
        np.testing.assert_allclose(g, 2 * opt, rtol=1e-3, atol=1e-4)
        assert np.array_equal(
            g, jdiff.fd_gradient(evaluate, np.zeros(2), eps=1e-4))

    def test_bss_design_requires_traffic_shape_class(self):
        jprog = jax_toy_bss(n_sta=2)
        prog = bss_from_numpy({k: getattr(jprog, k) for k in BSS_FIELDS})
        for design, p, key in ((tdiff.bss_interval_design, prog, TKEY),
                               (jdiff.bss_interval_design, jprog, KEY)):
            with pytest.raises(ValueError, match="traffic"):
                design(p, key, replicas=1)


class TestGradTelemetry:
    def test_records_and_schema_gate(self, tmp_path):
        """Two grad launches (one a two-point sweep) recorded, the snapshot
        valid for both packages' schema gates and the port's CLI, the
        losses the JAX package's."""
        from tpudes.obs.grad import validate_grad_metrics as jax_validate
        from tpudes_torch.obs.__main__ import main
        from tpudes_torch.obs.grad import GradTelemetry, validate_grad_metrics

        GradTelemetry.reset()
        jprog = dataclasses.replace(jax_toy_as(n_nodes=16, n_flows=2),
                                    surrogate=jdiff.Surrogacy())
        prog = as_from_numpy({k: getattr(jprog, k) for k in AS_FIELDS})
        solo = tdiff.grad_as_flows(prog, TKEY, 2, loss="neg_goodput", **CPU)
        tdiff.grad_as_flows(prog, TKEY, 2, loss="neg_goodput",
                            rate_scale=[0.5, 1.0], **CPU)
        snap = GradTelemetry.snapshot()
        assert validate_grad_metrics(snap) == [] == jax_validate(snap)
        e = snap["engines"]["as_flows"]
        assert e["launches"] == 2
        assert e["batched_points"] == 3
        assert len(e["loss_ring"]) == 2
        assert e["nonfinite"] == 0
        want = jdiff.grad_as_flows(jprog, KEY, 2, loss="neg_goodput")
        assert np.float32(solo["loss"]) == np.float32(want["loss"])
        path = tmp_path / "grad.json"
        path.write_text(json.dumps(snap))
        assert main(["--grad", str(path)]) == 0

    def test_descent_history_joins_the_rings(self):
        from tpudes_torch.obs.grad import GradTelemetry

        GradTelemetry.reset()
        GradTelemetry.record_descent("diff_lte", [1.0, 0.5, 0.25],
                                     [3.0, 2.0, 1.0])
        e = GradTelemetry.engine("diff_lte")
        assert e["steps"] == 3 and e["launches"] == 1
        assert e["loss_ring"] == [1.0, 0.5, 0.25]

    def test_schema_rejects_malformed(self):
        from tpudes.obs.grad import validate_grad_metrics as jax_validate
        from tpudes_torch.obs.grad import validate_grad_metrics

        assert validate_grad_metrics([]) != []
        assert validate_grad_metrics({"version": 1}) != []
        bad = {"version": 1, "engines": {"x": {
            "launches": -1, "steps": 0, "batched_points": 0, "nonfinite": 0,
            "last_loss": None, "loss_ring": [], "grad_norm_ring": ["a"]}}}
        problems = validate_grad_metrics(bad)
        assert any("negative" in p for p in problems)
        assert any("non-number" in p for p in problems)
        assert problems == jax_validate(bad)

    def test_nonfinite_canary(self):
        from tpudes_torch.obs.grad import GradTelemetry

        GradTelemetry.reset()
        GradTelemetry.record("diff_as", loss=float("nan"), grad_norm=1.0)
        assert GradTelemetry.engine("diff_as")["nonfinite"] == 1
