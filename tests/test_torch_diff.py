"""Differentiable simulation in the port (tpudes_torch.diff) against tpudes.diff.

The contracts of ``tests/test_diff.py``, each run through the JAX package
and the port on the CPU with the same numpy inputs and keys, at that
file's toy sizes (``toy_as_program(24, 3)``; a two-cell positional LTE
program of six UEs): surrogate exactness, central finite differences of
every exposed operand, batched grads against solo ones, the
one-launch grad sweep, the requested-replica average, value flips that
never rebuild, the expected-KPI chain against the Monte-Carlo engine; and
the autograd rules of ``ops/fused_grad.py`` against ``jax.grad``, ties
included.

Tolerances: ``surrogate=None`` and ``ste=True`` engine runs bit-equal to
the legacy run and to the JAX package's; ``build_as_diff`` bit-equal to
the JAX package's, and against ``run_as_flows`` goodput and delivered
fraction bit-equal, utilisation and delay within 1 ulp; the soft
forwards and ``build_lte_diff``'s outputs within 4 ulp elementwise (they
are bit-equal at these sizes); losses within 4 ulp; each gradient within
1e-4 of that operand's largest ``|g|`` under ``jax.value_and_grad``; the
port's own central differences at the reference's tolerances; batched
against solo and a call against its repeat, bit for bit.  The JAX
package's runners are compiled once a module (module-scoped fixtures).
"""

import dataclasses

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
from tpudes.parallel.programs import toy_lte_program as jax_toy_lte
from tpudes_torch import diff as tdiff
from tpudes_torch.convert import (
    AS_FIELDS,
    PROGRAM_FIELDS,
    as_from_numpy,
    program_from_numpy,
)
from tpudes_torch.diff.lte_grad import build_lte_diff, lte_default_params
from tpudes_torch.obs.device import CompileTelemetry
from tpudes_torch.parallel import as_flows as tas
from tpudes_torch.parallel.runtime import RUNTIME
from tpudes_torch.random import as_replica_draws

_torch_cpu.one_thread()

KEY = jax.random.PRNGKey(42)
TKEY = np.array([0, 42], np.int64)
CPU = dict(device="cpu")


# --- programs and comparisons ----------------------------------------------


def _port_as(jprog):
    return as_from_numpy({k: getattr(jprog, k) for k in AS_FIELDS})


def _jsur(sur):
    return None if sur is None else jdiff.Surrogacy(
        temp=sur.temp, gate_temp=sur.gate_temp, ste=sur.ste)


def _as_pair(surrogate=None, congested=False):
    """``toy_as_program(24, 3)`` (``tests/test_diff.py:30``), or pushed
    near saturation (``:35``), for both packages."""
    jprog = jax_toy_as(n_nodes=24, n_flows=3)
    if congested:
        jprog = dataclasses.replace(jprog, flow_bps=np.full(3, 4e7))
    jprog = dataclasses.replace(jprog, surrogate=_jsur(surrogate))
    return jprog, _port_as(jprog)


def _lte_pair(n_ue=6, pathloss=("log_distance", 3.2, 1.0, 46.67)):
    """The positional two-cell program of ``tests/test_diff.py:49``."""
    E = 2
    serving = (np.arange(n_ue) % E).astype(np.int32)
    rng = np.random.default_rng(7)
    enb_pos = np.array([[0.0, 0.0, 30.0], [600.0, 0.0, 30.0]], np.float32)
    ue_pos = (enb_pos[serving]
              + np.c_[rng.uniform(-200, 200, n_ue),
                      rng.uniform(-200, 200, n_ue),
                      np.full(n_ue, -28.5)]).astype(np.float32)
    kw = dict(gain=np.full((E, n_ue), 1e-12), serving=serving,
              tx_power_dbm=np.full((E,), 43.0),
              noise_psd=10.0**0.9 * 1.380649e-23 * 290.0, n_rb=25,
              n_ttis=400, scheduler="pf", enb_pos=enb_pos, pathloss=pathloss)
    jprog = JaxLteProgram(**kw)
    port = program_from_numpy({k: getattr(jprog, k, None)
                               for k in PROGRAM_FIELDS})
    return jprog, port, ue_pos


def _ulps(a, b) -> int:
    """The largest distance in f32 ulps between ``a`` and ``b``."""
    def key(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)

    return int(np.abs(key(a) - key(b)).max())


def _grads_close(got: dict, want: dict) -> None:
    """Each port gradient within 1e-4 of that operand's largest |g| under
    ``jax.value_and_grad``."""
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w, np.float64)
        g = np.asarray(got[k], np.float64)
        assert g.shape == w.shape, k
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max(), (k, g, w)


def _same_result(want: dict, got: dict) -> None:
    assert set(want) == set(got)
    for k in want:
        w, g = np.asarray(want[k]), np.asarray(got[k])
        assert w.dtype == g.dtype and np.array_equal(w, g), k


@pytest.fixture(autouse=True)
def _reset_grad_telemetry():
    from tpudes_torch.obs.grad import GradTelemetry

    yield
    GradTelemetry.reset()


# --- the JAX package's results, once a module -------------------------------


@pytest.fixture(scope="module")
def jax_as_grads():
    """``grad_as_flows`` of the JAX package per (program, loss)."""
    tgt = np.full(3, 5e4, np.float32)
    out = {}
    for name, sur, cong in (("sparse", tdiff.Surrogacy(ste=False), False),
                            ("congested", tdiff.Surrogacy(ste=False), True)):
        jprog, _ = _as_pair(sur, cong)
        out[name, "neg_goodput"] = jdiff.grad_as_flows(
            jprog, KEY, 4, loss="neg_goodput")
    jprog, _ = _as_pair(tdiff.Surrogacy(ste=False))
    out["sparse", "kpi_mse"] = jdiff.grad_as_flows(
        jprog, KEY, 4, loss="kpi_mse", target=tgt)
    out["sparse", "delay"] = jdiff.grad_as_flows(jprog, KEY, 4, loss="delay")
    return out


@pytest.fixture(scope="module")
def jax_lte_grads():
    jprog, _, ue_pos = _lte_pair()
    at = {"ue_pos": ue_pos}
    tgt = np.linspace(4.0, 14.0, 6).astype(np.float32)
    soft = jdiff.Surrogacy(ste=False)
    return {
        "neg_goodput": jdiff.grad_lte_sm(jprog, loss="neg_goodput", at=at,
                                         surrogate=soft),
        "cqi_mse": jdiff.grad_lte_sm(jprog, loss="cqi_mse", target=tgt,
                                     at=at, surrogate=soft),
    }


# --- surrogate exactness ----------------------------------------------------


class TestSurrogateExactness:
    def test_surrogate_none_is_same_runner_and_bit_equal(self):
        """The default program is the legacy program: a rerun hits the
        cached runner, an explicit ``surrogate=None`` changes nothing,
        and the run equals the JAX package's."""
        jprog, prog = _as_pair()
        base = tas.run_as_flows(prog, TKEY, 4, **CPU)
        c0 = CompileTelemetry.compiles("as_flows")
        again = tas.run_as_flows(dataclasses.replace(prog, surrogate=None),
                                 TKEY, 4, **CPU)
        assert CompileTelemetry.compiles("as_flows") - c0 == 0
        _same_result(base, again)
        _same_result(jas.run_as_flows(jprog, KEY, replicas=4), base)

    def test_ste_forward_bit_equal_to_legacy(self):
        """Straight-through: the forward equals the legacy run bit for bit,
        in the port and in the JAX package."""
        jprog, prog = _as_pair(tdiff.Surrogacy(ste=True), congested=True)
        base = tas.run_as_flows(dataclasses.replace(prog, surrogate=None),
                                TKEY, 4, **CPU)
        ste = tas.run_as_flows(prog, TKEY, 4, **CPU)
        _same_result(base, ste)
        _same_result(jas.run_as_flows(jprog, KEY, replicas=4), ste)

    def test_soft_surrogate_changes_the_forward(self):
        """``ste=False`` swaps the delivery gate: near saturation the soft
        run's delivered fractions differ from the hard run's, and equal
        the JAX package's soft run."""
        jprog, prog = _as_pair(tdiff.Surrogacy(ste=False), congested=True)
        base = tas.run_as_flows(dataclasses.replace(prog, surrogate=None),
                                TKEY, 4, **CPU)
        soft = tas.run_as_flows(prog, TKEY, 4, **CPU)
        assert not np.array_equal(base["delivered_frac"],
                                  soft["delivered_frac"])
        _same_result(jas.run_as_flows(jprog, KEY, replicas=4), soft)

    @pytest.mark.parametrize("congested", [False, True])
    def test_diff_runner_forward_bit_equal_to_engine(self, congested):
        """``build_as_diff`` against ``run_as_flows`` in the sparse regime
        (``tests/test_diff.py:107``): goodput and delivered fraction
        bit-equal, utilisation and delay within 1 ulp (the capacities are
        operands, so the divides are true divisions; past a link's
        capacity that ulp moves the gate, so the congested program is
        held to the JAX package's runner only); every output bit-equal to
        the JAX package's runner."""
        sur = tdiff.Surrogacy(ste=False) if congested else None
        jprog, prog = _as_pair(sur, congested)
        run = tas.build_as_diff(prog, 8, "cpu")
        d = run(as_replica_draws(torch.as_tensor(TKEY), 8, 3),
                torch.tensor(1.0), torch.tensor(np.float32(prog.flow_bps)),
                torch.tensor(np.float32(prog.rate_bps)))
        d = {k: v.detach().numpy() for k, v in d.items()}
        if not congested:
            out = tas.run_as_flows(prog, TKEY, 5, **CPU)
            for k in ("goodput_bps", "delivered_frac"):
                assert np.array_equal(d[k][:5], out[k]), k
            assert _ulps(d["max_util"][:5], out["max_util"]) <= 1
            reach = ~out["unreachable"]
            assert _ulps(d["delay_s"][:5][:, reach],
                         out["delay_s"][:, reach]) <= 1
        want = jax.jit(jas.build_as_diff(jprog, 8))(
            jas._as_replica_draws(jprog, KEY, 8), jnp.float32(1.0),
            jnp.asarray(jprog.flow_bps, jnp.float32),
            jnp.asarray(jprog.rate_bps, jnp.float32))
        for k, w in want.items():
            assert np.array_equal(np.asarray(w), d[k]), k

    def test_ops_level_hard_paths_unchanged(self):
        """The surrogate seams of ``ops/lte.py``: ``surrogate=None`` is the
        legacy CQI, the hard efficiency staircase is the CQI table's
        gather, Qm is 2 / 4 / 6, ``decode_ok`` the comparison, ``ste`` a
        bit-exact forward with the soft backward; the soft staircases
        equal the JAX package's jitted ones."""
        from tpudes.ops import lte as jlte
        from tpudes_torch.diff.surrogate import ste
        from tpudes_torch.ops import lte as tlte

        sinr_np = np.logspace(-2, 4, 41, dtype=np.float32)
        sinr = torch.from_numpy(sinr_np)
        legacy = tlte.cqi_from_sinr(sinr)
        assert torch.equal(legacy, tlte.cqi_from_sinr(sinr, surrogate=None))
        eff_hard = tlte.eff_from_sinr(sinr).numpy()
        assert np.allclose(eff_hard, tlte._CQI_EFF[legacy.numpy()],
                           atol=1e-6)
        assert set(np.unique(tlte.qm_from_eff(torch.from_numpy(
            eff_hard)).numpy())) <= {2.0, 4.0, 6.0}
        coin = torch.tensor([0.05, 0.5, 0.95])
        bler = torch.tensor([0.1, 0.5, 0.9])
        assert torch.equal(tlte.decode_ok(coin, bler), coin >= bler)
        assert float(ste(torch.tensor(3.0), torch.tensor(2.5))) == 3.0
        x = torch.tensor(1.4, requires_grad=True)
        (g,) = torch.autograd.grad(ste(torch.round(x), x * x), x)
        assert float(g) == pytest.approx(2.8)
        sur, jsur = tdiff.Surrogacy(), jdiff.Surrogacy()
        want = jax.jit(lambda s: (
            jlte.eff_from_sinr(s, jsur),
            jlte.qm_from_eff(jlte.eff_from_sinr(s, jsur), jsur),
            jlte.cqi_from_sinr(s, surrogate=jsur),
            jlte.decode_ok(s / 1e4, jnp.full_like(s, 0.5), jsur)))(sinr_np)
        eff = tlte.eff_from_sinr(sinr, sur)
        got = (eff, tlte.qm_from_eff(eff, sur),
               tlte.cqi_from_sinr(sinr, surrogate=sur),
               tlte.decode_ok(sinr / 1e4, torch.full_like(sinr, 0.5), sur))
        for w, g in zip(want, got):
            assert _ulps(np.asarray(w), g.numpy()) <= 4

    def test_surrogate_flips_compile_separate_runners(self):
        """The surrogate is a runner-cache key component: a temperature flip
        builds a new runner."""
        _, prog = _as_pair(tdiff.Surrogacy(gate_temp=0.25))
        tas.run_as_flows(prog, TKEY, 2, **CPU)
        c0 = CompileTelemetry.compiles("as_flows")
        tas.run_as_flows(dataclasses.replace(
            prog, surrogate=tdiff.Surrogacy(gate_temp=0.5)), TKEY, 2, **CPU)
        assert CompileTelemetry.compiles("as_flows") - c0 == 1


# --- finite differences ------------------------------------------------------


def _fd_check(loss_at, v0, h, ad, rtol, atol=0.0):
    """Central differences against the port's AD gradient ``ad``."""
    fd = np.zeros_like(np.asarray(v0, np.float64))
    flat0 = np.asarray(v0, np.float64).ravel()
    for i in range(flat0.size):
        p, m = flat0.copy(), flat0.copy()
        p[i] += h
        m[i] -= h
        fd.ravel()[i] = (loss_at(p.reshape(np.shape(v0)))
                         - loss_at(m.reshape(np.shape(v0)))) / (2 * h)
    np.testing.assert_allclose(np.asarray(ad), fd, rtol=rtol, atol=atol)
    return fd


class TestFiniteDifference:
    @pytest.mark.parametrize("case, name, h, rtol", [
        ("sparse", "flow_bps", 200.0, 5e-3),
        ("congested", "cap_bps", 20000.0, 2e-2),
        ("sparse", "rate_scale", 1e-3, 5e-3)])
    def test_as_every_exposed_operand(self, jax_as_grads, case, name, h,
                                      rtol):
        """FD against AD on ``flow_bps`` / ``cap_bps`` / ``rate_scale`` at
        the reference's steps and tolerances, the soft surrogate; the AD
        loss and grads against the JAX package's."""
        _, prog = _as_pair(tdiff.Surrogacy(ste=False), case == "congested")
        base = tdiff.grad_as_flows(prog, TKEY, 4, loss="neg_goodput", **CPU)
        want = jax_as_grads[case, "neg_goodput"]
        assert _ulps(want["loss"], base["loss"]) <= 4
        _grads_close(base["grads"], want["grads"])
        v0 = np.asarray({"flow_bps": prog.flow_bps, "cap_bps": prog.rate_bps,
                         "rate_scale": 1.0}[name], np.float64)

        def loss_at(v):
            return tdiff.grad_as_flows(prog, TKEY, 4, loss="neg_goodput",
                                       at={name: v}, **CPU)["loss"]

        fd = _fd_check(loss_at, v0, h, base["grads"][name], rtol=rtol,
                       atol=1e-10)
        assert np.abs(fd).max() > 0, f"{name}: degenerate FD probe"

    @pytest.mark.parametrize("loss", ["kpi_mse", "delay"])
    def test_as_delay_and_kpi_losses_differentiate(self, jax_as_grads, loss):
        _, prog = _as_pair(tdiff.Surrogacy(ste=False))
        kw = dict(target=np.full(3, 5e4, np.float32)) if loss == "kpi_mse" \
            else {}
        r = tdiff.grad_as_flows(prog, TKEY, 4, loss=loss, **kw, **CPU)
        g = r["grads"]["flow_bps"]
        assert np.isfinite(g).all() and np.abs(g).max() > 0
        want = jax_as_grads["sparse", loss]
        assert _ulps(want["loss"], r["loss"]) <= 4
        _grads_close(r["grads"], want["grads"])

    @pytest.mark.parametrize("name, h, rtol", [
        ("tx_power_dbm", 0.02, 0.02), ("ue_pos", 0.5, 0.06),
        ("enb_pos", 0.5, 0.06), ("ploss", 0.002, 0.02),
        ("sched_w", 0.01, 0.02)])
    def test_lte_every_exposed_operand(self, jax_lte_grads, name, h, rtol):
        """FD against AD on every LTE operand at the reference's steps and
        tolerances (atol 3e-4); the AD loss and grads against the JAX
        package's."""
        _, prog, ue_pos = _lte_pair()
        at = {"ue_pos": ue_pos}
        soft = tdiff.Surrogacy(ste=False)
        base = tdiff.grad_lte_sm(prog, loss="neg_goodput", at=at,
                                 surrogate=soft, **CPU)
        want = jax_lte_grads["neg_goodput"]
        assert _ulps(want["loss"], base["loss"]) <= 4
        _grads_close(base["grads"], want["grads"])
        v0 = {"tx_power_dbm": np.full(2, 43.0),
              "ue_pos": ue_pos.astype(np.float64),
              "enb_pos": np.asarray(prog.enb_pos, np.float64),
              "ploss": np.array([3.2, 1.0, 46.67]),
              "sched_w": np.ones(6)}[name]

        def loss_at(v):
            return tdiff.grad_lte_sm(prog, loss="neg_goodput",
                                     at={**at, name: v}, surrogate=soft,
                                     **CPU)["loss"]

        fd = _fd_check(loss_at, v0, h, base["grads"][name], rtol=rtol,
                       atol=3e-4)
        assert np.abs(fd).max() > 0, f"{name}: degenerate FD probe"

    def test_lte_cqi_loss_differentiates_propagation(self, jax_lte_grads):
        _, prog, ue_pos = _lte_pair()
        tgt = np.linspace(4.0, 14.0, 6).astype(np.float32)
        r = tdiff.grad_lte_sm(prog, loss="cqi_mse", target=tgt,
                              at={"ue_pos": ue_pos},
                              surrogate=tdiff.Surrogacy(ste=False), **CPU)
        assert np.isfinite(r["grads"]["ploss"]).all()
        assert np.abs(r["grads"]["ploss"][0]) > 0
        want = jax_lte_grads["cqi_mse"]
        assert _ulps(want["loss"], r["loss"]) <= 4
        _grads_close(r["grads"], want["grads"])


# --- batching ------------------------------------------------------------------


class TestGradBatching:
    def test_as_vmap_of_grad_equals_stacked_solo(self):
        """A batch of three designs: each point's loss and grads equal its
        solo call bit for bit, and the JAX package's batch within the
        tolerances."""
        jprog, prog = _as_pair(tdiff.Surrogacy())
        cands = np.array([[1e5, 1e5, 1e5], [2e5, 5e4, 1e5],
                          [8e4, 3e5, 6e4]], np.float32)
        batched = tdiff.grad_as_flows(prog, TKEY, 4, loss="neg_goodput",
                                      batch={"flow_bps": cands}, **CPU)
        for i in range(3):
            solo = tdiff.grad_as_flows(prog, TKEY, 4, loss="neg_goodput",
                                       at={"flow_bps": cands[i]}, **CPU)
            assert np.float32(solo["loss"]) == np.float32(batched["loss"][i])
            for k in solo["grads"]:
                assert np.array_equal(solo["grads"][k],
                                      batched["grads"][k][i]), k
        want = jdiff.grad_as_flows(jprog, KEY, 4, loss="neg_goodput",
                                   batch={"flow_bps": cands})
        assert _ulps(want["loss"], batched["loss"]) <= 4
        for i in range(3):
            _grads_close({k: v[i] for k, v in batched["grads"].items()},
                         {k: v[i] for k, v in want["grads"].items()})

    def test_lte_vmap_of_grad_equals_stacked_solo(self):
        jprog, prog, ue_pos = _lte_pair()
        at = {"ue_pos": ue_pos}
        cands = np.stack([np.full(2, 40.0), np.full(2, 43.0),
                          np.array([46.0, 38.0])]).astype(np.float32)
        batched = tdiff.grad_lte_sm(prog, loss="neg_goodput", at=at,
                                    batch={"tx_power_dbm": cands}, **CPU)
        for i in range(3):
            solo = tdiff.grad_lte_sm(prog, loss="neg_goodput",
                                     at={**at, "tx_power_dbm": cands[i]},
                                     **CPU)
            assert np.float32(solo["loss"]) == np.float32(batched["loss"][i])
            for k in solo["grads"]:
                assert np.array_equal(solo["grads"][k],
                                      batched["grads"][k][i]), k
        want = jdiff.grad_lte_sm(jprog, loss="neg_goodput", at=at,
                                 batch={"tx_power_dbm": cands})
        assert _ulps(want["loss"], batched["loss"]) <= 4
        for i in range(3):
            _grads_close({k: v[i] for k, v in batched["grads"].items()},
                         {k: v[i] for k, v in want["grads"].items()})

    def test_grad_sweep_is_one_launch_one_executable(self):
        """A grad-of-sweep: one launch and no new runner once warm; the
        points' losses and grads against the JAX package's sweep."""
        jprog, prog = _as_pair(tdiff.Surrogacy())
        scales = [0.5, 1.0, 2.0, 4.0]
        tdiff.grad_as_flows(prog, TKEY, 4, loss="neg_goodput",
                            rate_scale=scales, **CPU)
        l0 = RUNTIME.launches("diff_as")
        c0 = CompileTelemetry.compiles("diff_as")
        r = tdiff.grad_as_flows(prog, TKEY, 4, loss="neg_goodput",
                                rate_scale=scales, **CPU)
        assert RUNTIME.launches("diff_as") - l0 == 1
        assert CompileTelemetry.compiles("diff_as") - c0 == 0
        assert np.shape(r["loss"]) == (4,)
        assert r["grads"]["rate_scale"].shape == (4,)
        want = jdiff.grad_as_flows(jprog, KEY, 4, loss="neg_goodput",
                                   rate_scale=scales)
        assert _ulps(want["loss"], r["loss"]) <= 4
        for i in range(4):
            _grads_close({k: v[i] for k, v in r["grads"].items()},
                         {k: v[i] for k, v in want["grads"].items()})

    def test_loss_averages_requested_replicas_not_the_bucket(self):
        """A 5-replica loss is the engine's 5-replica mean KPI, not the
        8-row bucket's, and the JAX package's loss."""
        jprog, prog = _as_pair(tdiff.Surrogacy(ste=True))
        out5 = tas.run_as_flows(prog, TKEY, 5, **CPU)
        want = -float(np.asarray(out5["goodput_bps"], np.float64)
                      .mean(axis=0).sum() * 1e-6)
        got5 = tdiff.grad_as_flows(prog, TKEY, 5, loss="neg_goodput", **CPU)
        got8 = tdiff.grad_as_flows(prog, TKEY, 8, loss="neg_goodput", **CPU)
        assert got5["loss"] == pytest.approx(want, rel=1e-5)
        assert got5["loss"] != got8["loss"]
        ref5 = jdiff.grad_as_flows(jprog, KEY, 5, loss="neg_goodput")
        assert _ulps(ref5["loss"], got5["loss"]) <= 4
        _grads_close(got5["grads"], ref5["grads"])

    def test_operand_value_flips_never_recompile(self):
        _, prog = _as_pair(tdiff.Surrogacy())
        tdiff.grad_as_flows(prog, TKEY, 4, loss="neg_goodput", **CPU)
        c0 = CompileTelemetry.compiles("diff_as")
        for scale in (0.7, 1.3, 2.9):
            tdiff.grad_as_flows(
                prog, TKEY, 4, loss="neg_goodput",
                at={"flow_bps": np.asarray(prog.flow_bps) * scale}, **CPU)
        assert CompileTelemetry.compiles("diff_as") - c0 == 0

    def test_a_call_repeats_bit_for_bit(self):
        """Two calls of one congested grad give the same bits (the gathers'
        cotangents sum in a fixed order)."""
        _, prog = _as_pair(tdiff.Surrogacy(ste=False), congested=True)
        a, b = (tdiff.grad_as_flows(prog, TKEY, 4, loss="neg_goodput",
                                    **CPU) for _ in range(2))
        assert a["loss"] == b["loss"]
        for k in a["grads"]:
            assert np.array_equal(a["grads"][k], b["grads"][k]), k


# --- the expected-KPI chain ----------------------------------------------------


class TestLteForwardParity:
    def test_expected_goodput_tracks_the_engine(self):
        """The chain's expected per-UE goodput within +-30 % of the port's
        Monte-Carlo engine on the dominant-gain toy grid, and its outputs
        within 4 ulp of the JAX package's jitted chain."""
        from tpudes_torch.parallel.lte_sm import run_lte_sm

        jprog = jax_toy_lte(n_enb=2, n_ue=4, n_ttis=1000)
        prog = program_from_numpy({k: getattr(jprog, k, None)
                                   for k in PROGRAM_FIELDS})
        eng = run_lte_sm(prog, TKEY, **CPU)
        eng_bps = np.asarray(eng["rx_bits"], np.float64) / (prog.n_ttis * 1e-3)
        kpi = build_lte_diff(prog, tdiff.Surrogacy(ste=True), "cpu")(
            lte_default_params(prog, device="cpu"))
        exp_bps = kpi["tput_bps"].numpy().astype(np.float64)
        assert eng_bps.shape == exp_bps.shape
        ratio = exp_bps / np.maximum(eng_bps, 1.0)
        assert (0.7 < ratio).all() and (ratio < 1.3).all(), ratio
        want = jax.jit(jax_lte_diff(jprog, jdiff.Surrogacy(ste=True)))(
            jax_lte_params(jprog))
        for k, w in want.items():
            assert _ulps(np.asarray(w), kpi[k].numpy()) <= 4, k

    @pytest.mark.parametrize("pathloss", [("log_distance", 3.2, 1.0, 46.67),
                                          ("friis", 2.12e9, 1.0, 0.0)])
    @pytest.mark.parametrize("soft", [None, False, True])
    def test_positional_chain_equals_reference(self, pathloss, soft):
        """``build_lte_diff`` on a positional program, Friis or
        log-distance, exact / soft / straight-through: every output within
        4 ulp of the JAX package's jitted chain."""
        jprog, prog, ue_pos = _lte_pair(pathloss=pathloss)
        sur = None if soft is None else tdiff.Surrogacy(ste=soft)
        kpi = build_lte_diff(prog, sur, "cpu")(
            lte_default_params(prog, {"ue_pos": ue_pos}, "cpu"))
        want = jax.jit(jax_lte_diff(jprog, _jsur(sur)))(
            jax_lte_params(jprog, {"ue_pos": ue_pos}))
        for k, w in want.items():
            assert _ulps(np.asarray(w), kpi[k].numpy()) <= 4, k

    def test_gain_based_program_rejects_positional_wrt(self):
        jprog = jax_toy_lte(n_enb=2, n_ue=4)
        prog = program_from_numpy({k: getattr(jprog, k, None)
                                   for k in PROGRAM_FIELDS})
        with pytest.raises(ValueError, match="positional"):
            tdiff.grad_lte_sm(prog, wrt=("ue_pos",), **CPU)
        r = tdiff.grad_lte_sm(prog, loss="neg_goodput", **CPU)
        assert np.isfinite(r["grads"]["tx_power_dbm"]).all()
        want = jdiff.grad_lte_sm(jprog, loss="neg_goodput")
        assert _ulps(want["loss"], r["loss"]) <= 4
        _grads_close({"tx_power_dbm": r["grads"]["tx_power_dbm"]},
                     {"tx_power_dbm": want["grads"]["tx_power_dbm"]})
        # full buffers at equal weights: each cell's shares sum to 1, so
        # the weights' gradient is rounding noise at the loss's ulp (the
        # JAX package's is -2^-20, the port's 0)
        for g in (r["grads"]["sched_w"], want["grads"]["sched_w"]):
            assert np.abs(g).max() <= 2.0**-19


# --- the autograd rules ----------------------------------------------------------


RULES = {
    "exp": (jnp.exp, -30.0, 30.0),
    "log": (jnp.log, 1e-6, 1e6),
    "log1p": (jnp.log1p, -0.9, 10.0),
    "erfc": (jax.scipy.special.erfc, -4.0, 6.0),
    "exp10": (lambda x: 10.0 ** x, -20.0, 5.0),
    "sqrt": (jnp.sqrt, 1e-3, 1e4),
    "rsqrt": (jax.lax.rsqrt, 24.0, 1e4),
    "logistic": (jax.nn.sigmoid, -20.0, 20.0),
    "softplus": (jax.nn.softplus, -30.0, 30.0),
}


class TestAutogradRules:
    @pytest.mark.parametrize("name", sorted(RULES))
    def test_rule_equals_jax(self, name):
        """Each wrapped function's forward within 4 ulp of the jitted
        ``jnp`` one (bit-equal but for the reciprocal root's estimate),
        its gradient within 1e-6 relative of ``jax.grad``'s."""
        from tpudes_torch.ops import fused_grad

        fn, lo, hi = RULES[name]
        x = np.random.default_rng(3).uniform(lo, hi, 257).astype(np.float32)
        want = np.asarray(jax.jit(fn)(x))
        wgrad = np.asarray(jax.jit(jax.grad(lambda v: fn(v).sum()))(x))
        t = torch.from_numpy(x).requires_grad_()
        y = getattr(fused_grad, name)(t)
        (g,) = torch.autograd.grad(y.sum(), t)
        assert _ulps(want, y.detach().numpy()) <= 4
        np.testing.assert_allclose(g.numpy(), wgrad, rtol=1e-6, atol=1e-30)

    def test_ties_split_the_gradient_like_jax(self):
        """At a tie ``jnp.maximum`` / ``jnp.clip`` pass half the gradient;
        so do the port's clamps: the BLER at ``tb_bits = 24`` exactly, the
        rx power on the clip's bound, the soft gate at ``util = 1e-9``."""
        from tpudes.ops.lte import tb_bler_ecr as jax_bler
        from tpudes_torch.ops import fused_grad
        from tpudes_torch.ops.lte import tb_bler_ecr

        mi, ecr = np.float32(0.5), np.float32(0.45)
        want = float(jax.grad(lambda tb: jax_bler(mi, ecr, tb))(
            jnp.float32(24.0)))
        tb = torch.tensor(24.0, requires_grad=True)
        (got,) = torch.autograd.grad(
            tb_bler_ecr(torch.tensor(mi), torch.tensor(ecr), tb, fused=True),
            tb)
        assert got != 0 and abs(float(got) - want) <= 1e-6 * abs(want)
        for lo, hi, v in ((-250.0, 50.0, 50.0), (-250.0, 50.0, -250.0)):
            want = float(jax.grad(lambda x: jnp.clip(x, lo, hi))(
                jnp.float32(v)))
            x = torch.tensor(v, requires_grad=True)
            (got,) = torch.autograd.grad(fused_grad.clip(x, lo, hi), x)
            assert float(got) == want == 0.5
        t = 0.25
        want = float(jax.grad(lambda u: -jax.nn.softplus(
            jnp.log(jnp.maximum(u, jnp.float32(1e-9))) / t) * t)(
                jnp.float32(1e-9)))
        u = torch.tensor(np.float32(1e-9), requires_grad=True)
        (got,) = torch.autograd.grad(tas.soft_lfrac(u, t), u)
        assert abs(float(got) - want) <= 1e-6 * abs(want)
