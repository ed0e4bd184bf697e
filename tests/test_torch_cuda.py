"""tpudes_torch's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and ``nvcc``: the kernels have no CPU
mode, so here they skip.  The file imports neither JAX nor ``tpudes``,
so the card's machine (which has no JAX) runs it without the suite's
conftest:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Tolerance: none — each kernel and its plain version must give
bit-identical state, and the slice's integer outputs must be equal;
the BSS engine's outputs on the card equal the CPU's.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from tpudes_torch.parallel import kernels_cuda as kc
from tpudes_torch.parallel import replicated as bss
from tpudes_torch.ops.mobility import MobilityProgram
from tpudes_torch.parallel.bss_cuda import BSS_STATE
from tpudes_torch.parallel import tcp_dumbbell as tcp
from tpudes_torch.parallel.lte_sm import run_lte_sm
from tpudes_torch.parallel.programs import (
    bss_onoff_traffic,
    toy_traffic_points,
)
from tpudes_torch.random import PRNGKey, replica_keys
from tpudes_torch.scenarios import (
    ONOFF_OFF_MEAN_S,
    ONOFF_ON,
    ONOFF_TR_SEED,
    bss_program,
    dumbbell_program,
    lena_grid_program,
    lena_traffic_program,
    lena_ue_drop,
)
from tpudes_torch.traffic.device import offered_table
from tpudes_torch.traffic.program import TrafficProgram

R = 4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernel has no "
                    "CPU mode); run on the card")
    return torch.device("cuda")


def _program(n_ttis=200, precision="f32"):
    gen = torch.Generator().manual_seed(11)
    prog = lena_grid_program(*lena_ue_drop(3, 5, generator=gen), n_ttis)
    return dataclasses.replace(prog, precision=precision)


def _traffic_program(n_ttis=200, precision="f32"):
    """The 3 x 5 drop under the ON-OFF workload at a peak of 120 pps,
    near what the cells deliver, so backlogs empty and the gate bites."""
    prog = lena_traffic_program(3, 5, n_ttis, precision=precision,
                                generator=torch.Generator().manual_seed(11))
    near = TrafficProgram.onoff(
        prog.n_ue, 120.0, horizon_us=n_ttis * 1000, on=ONOFF_ON,
        off_mean_s=ONOFF_OFF_MEAN_S, tr_seed=ONOFF_TR_SEED,
    )
    return dataclasses.replace(prog, traffic=dataclasses.replace(
        near, size_pareto=prog.traffic.size_pareto))


def _offered(prog, card, t0, t1, seed=5):
    ops = prog.traffic.operands(card)
    return offered_table(ops, prog.traffic.epoch_us,
                         PRNGKey(seed).to(card), t0, t1)


def _harq_consts(prog, card):
    """The program's constants with the first-tx MI below the code rate
    for some UEs, so retx and drops run."""
    consts = kc.build_sm_consts(prog, device=card)
    scale = torch.linspace(0.1, 1.0, prog.n_ue, device=card)
    return dict(consts, mi0=(consts["mi0"] * scale).contiguous())


def _counts(step=0, advance=0, dynamic=0, sweep=0, traffic=0, bf16=0,
            step_bf16=0, bss=0, bss_agg=0, bss_sweep=0, bss_mob=0,
            bss_trf=0, bss_trf_sweep=0, tcp=0, tcp_red=0, tcp_sweep=0,
            tcp_trf=0, tcp_trf_sweep=0, win=0, win_geometry=0, win_scan=0,
            win_table=0, as_spf=0, as_fluid=0, as_fluid_sweep=0, wired=0,
            wired_owned=0, wired_lanes=0, lte_obs=0, bss_obs=0, tcp_obs=0,
            wired_obs=0, wired_obs_union=0):
    return {"lte_sm_step": step, "lte_sm_step:bf16": step_bf16,
            "lte_sm_advance": advance, "lte_sm_advance:dynamic": dynamic,
            "lte_sm_advance:sweep": sweep, "lte_sm_advance:traffic": traffic,
            "lte_sm_advance:bf16": bf16, "bss_advance": bss,
            "bss_advance:agg": bss_agg, "bss_advance:sweep": bss_sweep,
            "bss_advance:mobile": bss_mob, "bss_advance:traffic": bss_trf,
            "bss_advance:traffic_sweep": bss_trf_sweep, "tcp_advance": tcp,
            "tcp_advance:red": tcp_red, "tcp_advance:sweep": tcp_sweep,
            "tcp_advance:trf": tcp_trf, "tcp_advance:trf_sweep": tcp_trf_sweep,
            "wifi_window": win, "wifi_window:geometry": win_geometry,
            "wifi_window:scan": win_scan, "wifi_window:table": win_table,
            "as_spf": as_spf, "as_fluid": as_fluid,
            "as_fluid:sweep": as_fluid_sweep, "wired_advance": wired,
            "wired_advance:owned": wired_owned,
            "wired_advance:lanes": wired_lanes,
            "lte_sm_advance:obs": lte_obs, "bss_advance:obs": bss_obs,
            "tcp_advance:obs": tcp_obs, "wired_advance:obs": wired_obs,
            "wired_advance:obs_union": wired_obs_union}


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


def _assert_states_equal(got, want, layout, msg):
    for k, _, _ in layout:
        assert _bit_equal(got[k], want[k]), (msg, k)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("sched", list(kc.SM_SCHED_IDS))
def test_traffic_arm_bit_equal_to_plain_loop(card, sched, precision):
    """Two launches of the traffic arm, the second from where the first
    ended, against one plain loop: the 14 arrays and the backlog state
    bit-equal; the gate fired and some backlog is left."""
    prog = _traffic_program(precision=precision)
    sid = kc.SM_SCHED_IDS[sched]
    consts = _harq_consts(prog, card)
    keys = replica_keys(PRNGKey(sid), R).to(card)
    s0 = kc.sm_init_state(prog.n_enb, prog.n_ue, R, card, traffic=True)
    table = _offered(prog, card, 20, 150)
    kc.reset_launches()
    s1 = kc.sm_advance(consts, s0, keys, 20, 90, sid,
                       offered=table[:70].contiguous())
    s2 = kc.sm_advance(consts, s1, keys, 90, 150, sid,
                       offered=table[70:].contiguous())
    bf = 2 * (precision == "bf16")
    assert kc.launches == _counts(advance=2, traffic=2, bf16=bf)
    want = kc.sm_advance_math(consts, s0, keys, 20, 150, sid, offered=table)
    _assert_states_equal(s2, want, kc.SM_STATE + kc.TR_STATE, sched)
    full = kc.sm_advance_math(consts, s0, keys, 20, 150, sid)
    assert int(s2["new_tbs"].sum()) < int(full["new_tbs"].sum())
    assert bool((s2["tr_backlog"] > 0).any())
    assert int(s2["retx"].sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("arm", ["static", "dynamic", "sweep", "traffic"])
def test_bf16_arms_bit_equal_to_plain_loop(card, arm):
    """The bf16 flag on each arm of ``lte_sm_advance``, one launch of
    every scheduler id (the sweep grid) against the plain loop."""
    prog = (_traffic_program if arm == "traffic" else _program)(
        precision="bf16")
    consts = _harq_consts(prog, card)
    keys = replica_keys(PRNGKey(3), R).to(card)
    sids = torch.arange(9, dtype=torch.int32, device=card)
    lanes, sid = (9 * R, sids) if arm in ("sweep", "traffic") else (R, 0)
    rows = (_random_table(consts, kc.table_rows(10, 90, 4),
                          np.random.default_rng(2), card)
            if arm == "dynamic" else None)
    offered = _offered(prog, card, 10, 90) if arm == "traffic" else None
    s0 = kc.sm_init_state(prog.n_enb, prog.n_ue, lanes, card,
                          traffic=offered is not None)
    kc.reset_launches()
    got = kc.sm_advance(consts, s0, keys, 10, 90, sid, rows, 4, offered)
    assert kc.launches == _counts(
        advance=1, bf16=1, dynamic=int(arm == "dynamic"),
        sweep=int(lanes > R), traffic=int(arm == "traffic"))
    want = kc.sm_advance_math(consts, s0, keys, 10, 90, sid, rows, 4,
                              offered)
    _assert_states_equal(got, want, kc.SM_STATE + kc.TR_STATE * (
        offered is not None), arm)
    assert int(got["retx"].sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("sched", list(kc.SM_SCHED_IDS))
def test_step_kernel_bf16_bit_equal_to_plain_core(card, sched):
    prog = _program(precision="bf16")
    sid = kc.SM_SCHED_IDS[sched]
    consts = _harq_consts(prog, card)
    s_k = kc.sm_init_state(prog.n_enb, prog.n_ue, R, device=card)
    s_p = {k: v.clone() for k, v in s_k.items()}
    gen = torch.Generator(device=card).manual_seed(sid)
    kc.reset_launches()
    for t in range(60):
        coin = torch.rand((R, prog.n_ue), generator=gen, device=card)
        s_k = kc.sm_step(consts, s_k, coin, t, sid)
        s_p = kc.sm_step_math(consts, s_p, coin, t, sid)
    assert kc.launches == _counts(step=60, step_bf16=60)
    _assert_states_equal(s_k, s_p, kc.SM_STATE, sched)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_traffic_slice_kernel_equals_plain_and_cpu(card, precision):
    """A traffic program through the kernel (whole and in chunks of 37),
    the plain loop on the card and the plain loop on the CPU: equal
    integers and bit-equal backlogs; the sweep's points equal their
    single runs."""
    prog = _traffic_program(300, precision)
    kc.reset_launches()
    kern = run_lte_sm(prog, PRNGKey(3), replicas=R, device=card)
    chunked = run_lte_sm(prog, PRNGKey(3), replicas=R, device=card,
                         chunk_ttis=37)
    n = 1 + math.ceil(prog.n_ttis / 37)
    assert kc.launches == _counts(advance=n, traffic=n,
                                  bf16=n * (precision == "bf16"))
    plain = run_lte_sm(prog, PRNGKey(3), replicas=R, device=card,
                       use_kernel=False)
    cpu = run_lte_sm(prog, PRNGKey(3), replicas=R, device="cpu")
    for k in ("rx_bits", "new_tbs", "retx", "drops", "ok", "goodput_bits",
              "backlog_bits"):
        for other in (plain, chunked, cpu):
            assert np.array_equal(kern[k], other[k]), k
    swept = run_lte_sm(prog, PRNGKey(3), replicas=R, device=card,
                       schedulers=["rr", prog.scheduler])
    for k in ("rx_bits", "goodput_bits", "backlog_bits"):
        assert np.array_equal(swept[1][k], kern[k]), k


@pytest.mark.cuda
def test_offered_table_card_equals_cpu(card):
    """The offered-bits table runs the same IEEE operations on the card
    as on the CPU: bit-equal at full width over 2,000 TTIs."""
    prog = lena_traffic_program(7, 30, 2000,
                                generator=torch.Generator().manual_seed(1))
    on_card = _offered(prog, card, 0, 2000)
    on_cpu = _offered(prog, "cpu", 0, 2000)
    assert _bit_equal(on_card.cpu(), on_cpu)
    assert float(on_cpu.sum()) > 0


#: the BSS programs of the card's checks: the bench's (64 STAs on the
#: 10/22/34 m rings) and a collision-heavy one (32 STAs sending every
#: 5 ms, the medium near saturation, with same-µs ties of three and more)
BSS_PROGRAMS = {
    "bench": lambda: bss_program(64, 2.0),
    "collisions": lambda: bss_program(32, 1.3, radii=(8.0, 14.0, 20.0),
                                      interval_s=0.005),
    # bench.py::bench_wifi_ht: 802.11n A-MPDUs of up to 64 at 65 Mbit/s
    "bench_ht": lambda: bss_program(64, 2.0, interval_s=0.01,
                                    data_mode="HtMcs7", standard="80211n"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("which", list(BSS_PROGRAMS))
def test_bss_kernel_bit_equal_to_plain_loop(card, which):
    """64 replicas: one launch of ``bss_advance`` and two launches split
    at a step boundary, each against the plain loop on the card, the
    whole state bit-equal, with the step count and pending flags."""
    prog = BSS_PROGRAMS[which]()
    consts, init, _ = bss.build_bss_advance(prog, 64, card)
    key = PRNGKey(4).to(card)
    bound = bss._estimate_max_steps(prog)
    want, w_steps, w_pend = bss.bss_advance_math(consts, init(), key, [0],
                                                 bound)
    kc.reset_launches()
    got, steps, pend = bss.bss_advance(consts, init(), key, [0], bound)
    mid = w_steps[0] // 2
    half, h_steps, _ = bss.bss_advance(consts, init(), key, [0], mid)
    two, t_steps, t_pend = bss.bss_advance(consts, half, key, h_steps, bound)
    assert kc.launches == _counts(bss=3, bss_agg=3 * (consts["K"] > 1))
    assert (steps, h_steps, t_steps) == (w_steps, [mid], w_steps)
    assert torch.equal(pend, w_pend) and torch.equal(t_pend, w_pend)
    for k, _, _ in BSS_STATE:
        assert torch.equal(got[k], want[k]), (which, k)
        assert torch.equal(two[k], want[k]), (which, "two launches", k)
    assert int(want["tx_data"].sum()) > 0 and int(want["drops"].sum()) > 0


@pytest.mark.cuda
def test_bss_card_equals_cpu(card):
    """The engine's outputs on the card (the kernel) equal the CPU's (the
    plain loop), per replica, unchunked and chunked."""
    prog = bss_program(8, 1.5, radii=(12.0, 20.0, 28.0))
    cpu = bss.run_replicated_bss(prog, 8, PRNGKey(6), device="cpu")
    kc.reset_launches()
    gpu = bss.run_replicated_bss(prog, 8, PRNGKey(6), device=card)
    chunked = bss.run_replicated_bss(prog, 8, PRNGKey(6), device=card,
                                     chunk_steps=40)
    assert kc.launches["bss_advance"] == 1 + math.ceil(
        bss._estimate_max_steps(prog) / 40)
    for k in ("srv_rx", "cli_rx", "tx_data", "drops", "steps", "all_done"):
        assert np.array_equal(gpu[k], cpu[k]), k
        assert np.array_equal(chunked[k], cpu[k]), k
    assert gpu["all_done"]


def _ht(n_stas, sim_s, **kw):
    return bss_program(n_stas, sim_s, data_mode="HtMcs7", standard="80211n",
                       **kw)


@pytest.mark.cuda
def test_bss_ht_card_equals_cpu(card):
    """An A-MPDU program's outputs on the card (the ``AGG`` arm) equal the
    CPU's plain loop, per replica, unchunked and chunked."""
    prog = _ht(8, 1.5, radii=(12.0, 20.0, 28.0), interval_s=0.01)
    cpu = bss.run_replicated_bss(prog, 8, PRNGKey(6), device="cpu")
    kc.reset_launches()
    gpu = bss.run_replicated_bss(prog, 8, PRNGKey(6), device=card)
    chunked = bss.run_replicated_bss(prog, 8, PRNGKey(6), device=card,
                                     chunk_steps=300)
    n = 1 + math.ceil(bss._estimate_max_steps(prog) / 300)
    assert kc.launches == _counts(bss=n, bss_agg=n)
    for k in ("srv_rx", "cli_rx", "tx_data", "drops", "steps", "all_done"):
        assert np.array_equal(gpu[k], cpu[k]), k
        assert np.array_equal(chunked[k], cpu[k]), k
    assert gpu["all_done"] and gpu["drops"].sum() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("ht", [False, True])
def test_bss_sweep_grid_equals_plain_and_single_launches(card, ht):
    """Three horizons as one ``(C, R)`` launch: the whole state bit-equal
    to the plain grid loop on the card, each point's step count and
    pending flags too, and each point's outputs equal to its own
    single-point launch."""
    prog = (_ht(16, 1.2, interval_s=0.01) if ht else bss_program(16, 1.2))
    ends = [1_050_000, 1_200_000, 1_120_000]
    consts, init, _ = bss.build_bss_advance(prog, 32, card)
    key = PRNGKey(3).to(card)
    s0 = init(3)
    bound = max(bss._estimate_max_steps(dataclasses.replace(
        prog, sim_end_us=v)) for v in ends)
    want, w_steps, w_pend = bss.bss_advance_math(consts, s0, key, [0] * 3,
                                                 bound, ends)
    kc.reset_launches()
    got, steps, pend = bss.bss_advance(consts, s0, key, [0] * 3, bound, ends)
    assert kc.launches == _counts(bss=1, bss_agg=int(ht), bss_sweep=1)
    assert steps == w_steps and len(set(steps)) == 3
    assert torch.equal(pend, w_pend)
    for k, _, _ in BSS_STATE:
        assert torch.equal(got[k], want[k]), k
    sweep = bss.run_replicated_bss(prog, 32, PRNGKey(3), device=card,
                                   sim_end_us=ends, max_steps=bound)
    for c, end in enumerate(ends):
        one = bss.run_replicated_bss(
            dataclasses.replace(prog, sim_end_us=end), 32, PRNGKey(3),
            device=card, max_steps=bound)
        for k in ("srv_rx", "cli_rx", "tx_data", "drops", "steps",
                  "all_done"):
            assert np.array_equal(sweep[c][k], one[k]), (c, k)


def _waypoint_program():
    """8 STAs on 12/20/28 m rings walking three legs of waypoints."""
    prog = bss_program(8, 1.3, radii=(12.0, 20.0, 28.0))
    wt = np.tile(np.array([0, 1_100_000, 1_200_000, 10**9]), (9, 1))
    wt[0] = [0, 1, 2, 3]
    wp = np.repeat(prog.positions[:, None, :], 4, 1).copy()
    wp[1:, 1, 0] += 6.0
    wp[1:, 2, 1] -= 5.0
    return dataclasses.replace(prog, geom_stride=4,
                               mobility=MobilityProgram.waypoints(wt, wp))


def _onoff(prog):
    return dataclasses.replace(prog, traffic=bss_onoff_traffic(prog))


#: the programs of the MOB and TRF arms' checks (16 STAs, 1.3 s): each
#: mobility model, the ON-OFF workload, and all three composed under
#: 802.11n
ARM_PROGRAMS = {
    "const_velocity": lambda: bss_program(
        16, 1.3, mobility="const_velocity", speed=5.0, geom_stride=3),
    "random_walk": lambda: bss_program(
        16, 1.3, mobility="random_walk", speed=2.0, geom_stride=2),
    "waypoint": _waypoint_program,
    "onoff": lambda: _onoff(bss_program(16, 1.3)),
    "composed": lambda: _onoff(bss_program(
        16, 1.3, interval_s=0.01, data_mode="HtMcs7", standard="80211n",
        mobility="const_velocity", speed=3.0, geom_stride=4)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("which", list(ARM_PROGRAMS))
def test_bss_mob_trf_kernel_bit_equal_to_plain_loop(card, which):
    """64 replicas: the ``MOB`` / ``TRF`` arms in one launch and in two
    split mid-stride, the whole state (``geom_t`` included), the step
    count and the pending flags bit-equal to the plain loop on the
    card."""
    prog = ARM_PROGRAMS[which]()
    consts, init, _ = bss.build_bss_advance(prog, 64, card)
    key = PRNGKey(4).to(card)
    bound = bss._estimate_max_steps(prog)
    want, w_steps, w_pend = bss.bss_advance_math(consts, init(), key, [0],
                                                 bound)
    kc.reset_launches()
    got, steps, pend = bss.bss_advance(consts, init(), key, [0], bound)
    mid = w_steps[0] // 2 | 1
    half, h_steps, _ = bss.bss_advance(consts, init(), key, [0], mid)
    two, t_steps, t_pend = bss.bss_advance(consts, half, key, h_steps, bound)
    mob, trf = prog.mobility is not None, prog.traffic is not None
    assert kc.launches == _counts(bss=3, bss_agg=3 * (consts["K"] > 1),
                                  bss_mob=3 * mob, bss_trf=3 * trf)
    assert (steps, h_steps, t_steps) == (w_steps, [mid], w_steps)
    assert torch.equal(pend, w_pend) and torch.equal(t_pend, w_pend)
    for k, _, _ in BSS_STATE:
        assert torch.equal(got[k], want[k]), (which, k)
        assert torch.equal(two[k], want[k]), (which, "two launches", k)
    assert int(want["tx_data"].sum()) > 0


@pytest.mark.cuda
def test_bss_traffic_grid_equals_plain_and_single_launches(card):
    """The eight workload points as one ``(C, R)`` launch: the whole state
    bit-equal to the plain grid loop on the card, each point's step
    count and pending flags too, and each point's outputs equal to its
    own run."""
    prog = bss_program(16, 1.3)
    pts = toy_traffic_points(prog.n, prog.sim_end_us, start_us=prog.start_us,
                             beacon=(int(prog.interval_us[0]),
                                     int(prog.start_us[0])))
    prog = dataclasses.replace(prog, traffic=pts[0])
    consts, init, _ = bss.build_bss_advance(prog, 32, card, pts)
    key = PRNGKey(3).to(card)
    C = len(pts)
    bound = max(bss._estimate_max_steps(dataclasses.replace(prog, traffic=tp))
                for tp in pts)
    ends = [prog.sim_end_us] * C
    want, w_steps, w_pend = bss.bss_advance_math(consts, init(C), key,
                                                 [0] * C, bound, ends)
    kc.reset_launches()
    got, steps, pend = bss.bss_advance(consts, init(C), key, [0] * C, bound,
                                       ends)
    assert kc.launches == _counts(bss=1, bss_trf=1, bss_trf_sweep=1)
    assert steps == w_steps and len(set(steps)) > 4
    assert torch.equal(pend, w_pend)
    for k, _, _ in BSS_STATE:
        assert torch.equal(got[k], want[k]), k
    sweep = bss.run_replicated_bss(prog, 32, PRNGKey(3), device=card,
                                   traffic_sweep=pts, max_steps=bound)
    for c, tp in enumerate(pts):
        one = bss.run_replicated_bss(dataclasses.replace(prog, traffic=tp),
                                     32, PRNGKey(3), device=card,
                                     max_steps=bound)
        for k in ("srv_rx", "cli_rx", "tx_data", "drops", "steps",
                  "all_done"):
            assert np.array_equal(sweep[c][k], one[k]), (c, k)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["random_walk", "composed"])
def test_bss_mob_trf_card_equals_cpu(card, which):
    """A mobile / traffic program's outputs on the card equal the CPU's
    plain loop, per replica, unchunked and chunked mid-stride."""
    prog = ARM_PROGRAMS[which]()
    cpu = bss.run_replicated_bss(prog, 8, PRNGKey(6), device="cpu")
    gpu = bss.run_replicated_bss(prog, 8, PRNGKey(6), device=card)
    chunked = bss.run_replicated_bss(prog, 8, PRNGKey(6), device=card,
                                     chunk_steps=101)
    keys = ("srv_rx", "cli_rx", "tx_data", "drops", "steps", "all_done",
            "geom_refreshes")
    for k in keys:
        assert np.array_equal(gpu[k], cpu[k]), k
        assert np.array_equal(chunked[k], cpu[k]), k
    assert gpu["all_done"]


#: node counts at the lane and slot edges of the kernel's layout (node i
#: on lane i % 32, slot i // 32; up to 4 slots in registers, past it in
#: local memory; 1024 the most a row holds)
EDGE_NS = (2, 32, 33, 64, 65, 97, 128, 129, 1024)


def _edge_program(n, **kw):
    """n nodes (an AP and n - 1 STAs on 8/14/20 m rings), echoes every 4
    ms, 1.08 s: the STAs that start before the horizon collide often."""
    return bss_program(n - 1, 1.08, radii=(8.0, 14.0, 20.0),
                       interval_s=0.004, **kw)


def _kernel_vs_plain(prog, R, card, ends=None, cuts=()):
    """One launch of the kernel and, with ``cuts``, launches split at
    those steps, each against the plain loop on the card: every state
    array, the step counts and the pending flags bit-equal."""
    consts, init, _ = bss.build_bss_advance(prog, R, card)
    C = len(ends) if ends else 1
    ends = ends or [prog.sim_end_us]
    key = PRNGKey(4).to(card)
    bound = max(bss._estimate_max_steps(dataclasses.replace(
        prog, sim_end_us=e)) for e in ends)
    want, w_steps, w_pend = bss.bss_advance_math(consts, init(C), key,
                                                 [0] * C, bound, ends)
    got, steps, pend = bss.bss_advance(consts, init(C), key, [0] * C,
                                       bound, ends)
    assert steps == w_steps and torch.equal(pend, w_pend)
    for k, _, _ in BSS_STATE:
        assert torch.equal(got[k], want[k]), k
    if cuts:
        state, at = init(C), [0] * C
        for cut in (*cuts, bound):
            state, at, pend = bss.bss_advance(consts, state, key, at, cut,
                                              ends)
        assert at == w_steps and torch.equal(pend, w_pend)
        for k, _, _ in BSS_STATE:
            assert torch.equal(state[k], want[k]), ("split", k)
    return want, w_steps


@pytest.mark.cuda
@pytest.mark.parametrize("n", EDGE_NS)
def test_bss_layout_edges_bit_equal_to_plain_loop(card, n):
    """The legacy arm at the lane and slot edges: 2 replicas, one launch
    against the plain loop, bit for bit."""
    want, _ = _kernel_vs_plain(_edge_program(n), 2, card)
    assert int(want["tx_data"].sum()) > 0


#: each arm at two of the edge node counts (802.11n A-MPDUs, motion, an
#: ON-OFF workload, all three composed)
ARM_EDGES = {
    ("ht", 33): lambda n: _edge_program(
        n, data_mode="HtMcs7", standard="80211n"),
    ("ht", 129): lambda n: _edge_program(
        n, data_mode="HtMcs7", standard="80211n"),
    ("mobile", 64): lambda n: _edge_program(
        n, mobility="const_velocity", speed=5.0, geom_stride=3),
    ("mobile", 1024): lambda n: _edge_program(
        n, mobility="random_walk", speed=2.0, geom_stride=2),
    ("onoff", 32): lambda n: _onoff(_edge_program(n)),
    ("onoff", 97): lambda n: _onoff(_edge_program(n)),
    ("composed", 65): lambda n: _onoff(_edge_program(
        n, data_mode="HtMcs7", standard="80211n",
        mobility="const_velocity", speed=3.0, geom_stride=4)),
    ("composed", 128): lambda n: _onoff(_edge_program(
        n, data_mode="HtMcs7", standard="80211n",
        mobility="const_velocity", speed=3.0, geom_stride=4)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("arm_n", list(ARM_EDGES), ids=str)
def test_bss_arms_at_layout_edges_bit_equal_to_plain_loop(card, arm_n):
    """Each arm at two node counts: 2 replicas, one launch against the
    plain loop, bit for bit (N = 1024 under MOB takes the shared-memory
    opt-in)."""
    arm, n = arm_n
    _kernel_vs_plain(ARM_EDGES[arm_n](n), 2, card)


@pytest.mark.cuda
def test_bss_ragged_grid_bit_equal_to_plain_loop(card):
    """Three horizons x 5 replicas: 15 rows, so the last block of 4 rows
    has an idle warp; the grid bit-equal to the plain grid loop."""
    _kernel_vs_plain(_edge_program(33), 5, card,
                     ends=[1_030_000, 1_080_000, 1_055_000])


@pytest.mark.cuda
def test_bss_mobile_chunks_split_mid_stride(card):
    """A mobile program (stride 3) at N = 97 run in four launches cut
    mid-stride equals one launch and the plain loop, ``geom_t`` too."""
    prog = _edge_program(97, mobility="const_velocity", speed=5.0,
                         geom_stride=3)
    _, steps = _kernel_vs_plain(prog, 3, card, cuts=(7, 50, 101))
    assert steps[0] > 101


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["legacy", "ht", "mobile", "onoff"])
def test_bss_probe_equals_main_launch(card, which):
    """The profiling instantiation at the bench's slot count (N = 65)
    computes what the main launch does, and counts cycles in every stage
    a step runs (the refresh only under MOB)."""
    from tpudes_torch.parallel.bss_cuda import (
        BSS_PROF_STAGES,
        bss_launch,
        bss_profile,
    )

    kw = {"ht": dict(data_mode="HtMcs7", standard="80211n"),
          "mobile": dict(mobility="const_velocity", speed=5.0,
                         geom_stride=3)}.get(which, {})
    prog = _edge_program(65, **kw)
    if which == "onoff":
        prog = _onoff(prog)
    consts, init, _ = bss.build_bss_advance(prog, 8, card)
    key = PRNGKey(4).to(card)
    bound = bss._estimate_max_steps(prog)
    kc.reset_launches()
    want = bss_launch(consts, init(), key, [0], bound)
    got, cyc = bss_profile(consts, init(), key, [0], bound)
    assert kc.launches["bss_advance"] == 1          # the probe is not counted
    for k, _, _ in BSS_STATE:
        assert torch.equal(got[0][k], want[0][k]), k
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a, b)
    total = cyc.sum(0)
    assert cyc.shape == (8, len(BSS_PROF_STAGES))
    for k, name in enumerate(BSS_PROF_STAGES):
        assert (int(total[k]) > 0) == (name != "refresh" or which == "mobile"
                                       ), name



# --------------------------------------------------------------------------
# tcp_advance, the TCP dumbbell's slot loop
# --------------------------------------------------------------------------


def _dumbbell(n_flows, sim_s=0.3, red=None, queue="30p", **kw):
    """A dumbbell of ``n_flows`` over all 17 variants in turn (DCTCP's
    flows ECN-capable), droptail or RED."""
    return dumbbell_program(
        n_flows, sim_s, variants=[tcp.VARIANTS[i % 17]
                                  for i in range(n_flows)],
        queue=queue, red=red, **kw)


def _tcp_kernel_vs_plain(prog, replicas, card, cuts=(), variants=None):
    """The kernel over launches cut at ``cuts`` against the plain loop on
    the card: every state array bit-equal.  Returns the kernel's state."""
    from tpudes_torch.parallel.tcp_cuda import tcp_launch

    consts = tcp.build_tcp_consts(prog, card)
    var, ecn = tcp.sweep_operands(prog, variants)
    var = torch.as_tensor(var, device=card)
    ecn = torch.as_tensor(ecn, device=card)
    s0 = tcp.init_state(consts, replicas, var.shape[0])
    key = PRNGKey(6).to(card)
    want = tcp.tcp_advance_math(consts, s0, key, 0, prog.n_slots, var, ecn)
    got, t = s0, 0
    for bound in (*cuts, prog.n_slots):
        got = tcp_launch(consts, got, key, t, bound, var, ecn)
        t = bound
    torch.cuda.synchronize()
    for k, _, _ in tcp.TCP_STATE:
        assert torch.equal(got[k], want[k]), k
    assert int(got["delivered"].sum()) > 0
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("n_flows", [1, 2, 8, 17, 32])
def test_tcp_advance_bit_equal_to_plain_loop(card, n_flows):
    got = _tcp_kernel_vs_plain(_dumbbell(n_flows), 3, card)
    assert int(got["drops"].sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("hard_drop", [False, True])
def test_tcp_advance_red_bit_equal_to_plain_loop(card, hard_drop):
    """RED with ECN: DCTCP and NewReno flows, marks and early drops."""
    prog = dumbbell_program(
        6, 0.6, variants=["TcpDctcp", "TcpNewReno", "TcpCubic"] * 2,
        bottleneck_rate="5Mbps",
        red=dict(MinTh=3, MaxTh=8, MaxSize=60, UseEcn=True,
                 UseHardDrop=hard_drop))
    got = _tcp_kernel_vs_plain(prog, 4, card, cuts=(333,))
    assert float(got["dctcp_alpha"][..., 0].min()) < 1.0   # marks arrived


@pytest.mark.cuda
def test_tcp_advance_ragged_grid_and_split(card):
    """Three variant points x 3 replicas: 9 rows, so the last block of 4
    has idle warps; three launches split mid-horizon."""
    points = [["TcpNewReno"] * 5, list(tcp.VARIANTS[4:9]),
              ["TcpBbr", "TcpLp", "TcpHtcp", "TcpYeah", "TcpLedbat"]]
    _tcp_kernel_vs_plain(_dumbbell(5), 3, card, cuts=(101, 257),
                         variants=points)


@pytest.mark.cuda
def test_tcp_advance_global_rings_bit_equal(card):
    """An ack lag long enough that four rows' rings pass the shared
    memory a block may hold: the rings stay in global memory."""
    from tpudes_torch.parallel.tcp_cuda import launch_geometry

    prog = _dumbbell(32, sim_s=0.5, bottleneck_delay="200ms")
    assert launch_geometry(32, prog.buf_len, 1, 2)["rings"] == "global"
    _tcp_kernel_vs_plain(prog, 2, card)


@pytest.mark.cuda
def test_tcp_advance_refuses_too_many_flows(card):
    prog = _dumbbell(33, sim_s=0.01)
    with pytest.raises(ValueError, match="1..32 flows"):
        tcp.run_tcp_dumbbell(prog, PRNGKey(0), 2, device=card)


@pytest.mark.cuda
def test_tcp_run_on_card_equals_cpu(card):
    """run_tcp_dumbbell on the card (one launch a chunk) equals the CPU's
    plain loop, a sweep included."""
    prog = _dumbbell(8, sim_s=0.4)
    points = [list(tcp.VARIANTS[:8]), ["TcpDctcp"] * 8]
    kc.reset_launches()
    got = tcp.run_tcp_dumbbell(prog, PRNGKey(2), 4, variants=points,
                               chunk_slots=200)
    n = -(-prog.n_slots // 200)
    assert kc.launches == _counts(tcp=n, tcp_sweep=n)
    want = tcp.run_tcp_dumbbell(prog, PRNGKey(2), 4, variants=points,
                                device="cpu")
    for g, w in zip(got, want):
        for k in ("delivered", "drops", "mean_queue", "cwnd_final"):
            assert np.array_equal(g[k], w[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("red", [False, True])
def test_tcp_probe_equals_main_launch(card, red):
    """The stage probe (the PROF instantiation) gives the main launch's
    state, is not counted, and counts cycles in every stage (RED's only
    under RED)."""
    from tpudes_torch.parallel.tcp_cuda import (
        TCP_PROF_STAGES,
        tcp_launch,
        tcp_profile,
    )

    prog = _dumbbell(6, sim_s=0.2, red=dict(MinTh=3, MaxTh=8, MaxSize=60,
                                            UseEcn=True) if red else None)
    consts = tcp.build_tcp_consts(prog, card)
    var, ecn = (torch.as_tensor(x, device=card)
                for x in tcp.sweep_operands(prog))
    s0 = tcp.init_state(consts, 5)
    key = PRNGKey(6).to(card)
    kc.reset_launches()
    want = tcp_launch(consts, s0, key, 3, prog.n_slots, var, ecn)
    got, cyc = tcp_profile(consts, s0, key, 3, prog.n_slots, var, ecn)
    torch.cuda.synchronize()
    assert kc.launches["tcp_advance"] == 1          # the probe is not counted
    for k, _, _ in tcp.TCP_STATE:
        assert torch.equal(got[k], want[k]), k
    assert cyc.shape == (5, len(TCP_PROF_STAGES))
    total = cyc.sum(0)
    for k, name in enumerate(TCP_PROF_STAGES):
        assert (int(total[k]) > 0) == (name != "red" or red), name


@pytest.mark.cuda
@pytest.mark.parametrize("replicas, sim_s", [(9, 0.3), (256, 0.1)])
def test_tcp_advance_rows_bit_equal(card, replicas, sim_s):
    """9 rows (a ragged last block) and the bench's 256: the plain loop's
    state."""
    from tpudes_torch.parallel.tcp_cuda import tcp_launch

    prog = _dumbbell(8, sim_s=sim_s)
    consts = tcp.build_tcp_consts(prog, card)
    var, ecn = (torch.as_tensor(x, device=card)
                for x in tcp.sweep_operands(prog))
    s0 = tcp.init_state(consts, replicas)
    key = PRNGKey(6).to(card)
    want = tcp.tcp_advance_math(consts, s0, key, 0, prog.n_slots, var, ecn)
    got = tcp_launch(consts, s0, key, 0, prog.n_slots, var, ecn)
    torch.cuda.synchronize()
    for k, _, _ in tcp.TCP_STATE:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("red", [False, True])
def test_tcp_advance_draw_batch_edges(card, red):
    """Launches that start at t0 % 32 != 0 and run odd lengths (the edges
    of the kernel's batch of 32 slots' draws) equal one launch."""
    from tpudes_torch.parallel.tcp_cuda import tcp_launch

    prog = _dumbbell(7, sim_s=0.3, red=dict(MinTh=3, MaxTh=8, MaxSize=60,
                                            UseEcn=True) if red else None)
    consts = tcp.build_tcp_consts(prog, card)
    var, ecn = (torch.as_tensor(x, device=card)
                for x in tcp.sweep_operands(prog))
    s0 = tcp.init_state(consts, 6)
    key = PRNGKey(9).to(card)
    n = prog.n_slots
    one = tcp_launch(consts, s0, key, 0, n, var, ecn)
    for cuts in ((1, 2, 35, 67, 99), (31, 33, 64, 97, 161, n - 1),
                 (13, 50, 111)):
        got, t = s0, 0
        for bound in (*cuts, n):
            got = tcp_launch(consts, got, key, t, bound, var, ecn)
            t = bound
        torch.cuda.synchronize()
        for k, _, _ in tcp.TCP_STATE:
            assert torch.equal(got[k], one[k]), (cuts, k)


@pytest.mark.cuda
def test_tcp_advance_17_variants_at_bench_rows(card):
    """bench_tcp_variant_sweep's program (17 flows, one per variant, 13
    Mbit/s) at the bench's 256 rows, cut to 0.3 s: the plain loop's
    state."""
    prog = dumbbell_program(17, 0.3, variants=list(tcp.VARIANTS),
                            bottleneck_rate="13Mbps")
    _tcp_kernel_vs_plain(prog, 256, card, cuts=(77,))


@pytest.mark.cuda
def test_tcp_division_fast_path_equals_ieee(card):
    """The kernel's branch-free division (the card's IEEE division's fast
    path, taken for operands within 2^-60..2^60) gives __fdiv_rn's bits on
    2^26 hashed pairs."""
    from tpudes_torch.parallel.tcp_cuda import division_check

    assert division_check(1 << 26, seed=1, device=card) == (0, 1 << 26)


@pytest.mark.cuda
@pytest.mark.parametrize("lag, delay, access", [(1, "0.1ms", "0.1ms"),
                                                (3, "0.25ms", "0.5ms")])
def test_tcp_advance_short_ack_lag(card, lag, delay, access):
    """Ack lags of one and three slots, where the kernel's two warps take
    their steps in turn (one slot a step at one)."""
    prog = _dumbbell(5, sim_s=0.3, bottleneck_delay=delay,
                     access_delay=access)
    assert prog.ack_lag == lag
    _tcp_kernel_vs_plain(prog, 3, card, cuts=(37,))


# --------------------------------------------------------------------------
# tcp_advance's TRF arm: app-limited flows
# --------------------------------------------------------------------------


def _tcp_trf_vs_plain(prog, workloads, replicas, card, cuts=()):
    """The TRF arm over launches cut at ``cuts`` against the plain loop on
    the card, a grid of ``workloads``' points (one: ``prog.traffic``'s):
    every state array bit-equal.  Returns the kernel's state."""
    from tpudes_torch.parallel.tcp_cuda import tcp_launch
    from tpudes_torch.traffic.device import app_cum_table

    consts = tcp.build_tcp_consts(prog, card)
    ops = tcp.workload_operands(prog, workloads if len(workloads) > 1
                                else None, card)
    C = ops["tr_id"].shape[0]
    var, ecn = (torch.as_tensor(x, device=card).repeat(C, 1)
                for x in tcp.sweep_operands(prog))
    s0 = tcp.init_state(consts, replicas, C)
    key = PRNGKey(6).to(card)

    def app(t0, t1):
        return app_cum_table(ops, prog.traffic.epoch_us, consts["slot_us"],
                             t0, t1)

    want = tcp.tcp_advance_math(consts, s0, key, 0, prog.n_slots, var, ecn,
                                app_cum=app(0, prog.n_slots))
    got, t = s0, 0
    for bound in (*cuts, prog.n_slots):
        got = tcp_launch(consts, got, key, t, bound, var, ecn, app(t, bound))
        t = bound
    torch.cuda.synchronize()
    for k, _, _ in tcp.TCP_STATE:
        assert torch.equal(got[k], want[k]), k
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("point", [2, 5, 7])
def test_tcp_advance_trf_bit_equal_to_plain_loop(card, point):
    """An mmpp, onoff or trace workload of the toy points on 8 flows,
    three launches."""
    tp = toy_traffic_points(8, 300_000)[point]
    prog = dataclasses.replace(_dumbbell(8), traffic=tp)
    got = _tcp_trf_vs_plain(prog, [tp], 9, card, cuts=(101, 257))
    assert int(got["delivered"].sum()) > 0


@pytest.mark.cuda
def test_tcp_advance_trf_workload_grid(card):
    """The eight toy workload points as one 8 x 16 grid."""
    pts = toy_traffic_points(8, 300_000)
    prog = dataclasses.replace(_dumbbell(8), traffic=pts[0])
    _tcp_trf_vs_plain(prog, pts, 16, card, cuts=(77,))


@pytest.mark.cuda
def test_tcp_trf_run_on_card_equals_cpu(card):
    """run_tcp_dumbbell on the card with an app-limited program and with a
    workload sweep, counted, equals the CPU's plain loop."""
    pts = toy_traffic_points(8, 400_000)
    prog = dataclasses.replace(_dumbbell(8, sim_s=0.4), traffic=pts[5])
    n = -(-prog.n_slots // 150)
    for kw, counts in ((dict(), _counts(tcp=n, tcp_trf=n)),
                       (dict(traffic_sweep=pts),
                        _counts(tcp=n, tcp_trf=n, tcp_trf_sweep=n))):
        kc.reset_launches()
        got = tcp.run_tcp_dumbbell(prog, PRNGKey(2), 4, chunk_slots=150,
                                   **kw)
        assert kc.launches == counts
        want = tcp.run_tcp_dumbbell(prog, PRNGKey(2), 4, device="cpu", **kw)
        for g, w in zip(got if kw else [got], want if kw else [want]):
            for k in ("delivered", "drops", "mean_queue", "cwnd_final"):
                assert np.array_equal(g[k], w[k]), k


# --------------------------------------------------------------------------
# wifi_window, the fused PHY window and its scan
# --------------------------------------------------------------------------


def _window_inputs(n, replicas, seed=3):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, 50.0, (replicas, n, 3)).astype(np.float32)
    pos[..., 2] = 0.0
    return (torch.from_numpy(pos),
            torch.from_numpy(rng.random((replicas, n)) < 0.25),
            torch.from_numpy((np.arange(n) % 20).astype(np.int32)
                             ).expand(replicas, n).contiguous(),
            torch.full((replicas, n), 1000.0))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8, 65, 129])
@pytest.mark.parametrize("model", ["nist", "table"])
def test_wifi_window_bit_equal_to_plain(card, model, n):
    from tpudes_torch.parallel import kernels as win
    from tpudes_torch.parallel.window_cuda import window_launch

    pos, tx, mode, fb = (x.to(card) for x in _window_inputs(n, 64))
    keys = replica_keys(PRNGKey(4).to(card), 64)
    params = win.WindowParams(error_model=model)
    kc.reset_launches()
    got = window_launch(pos, tx, mode, fb, keys, params)
    want = win.window_math(pos, tx, mode, fb, win.uniform(keys, (n, n)),
                           params)
    torch.cuda.synchronize()
    assert kc.launches == _counts(win=1, win_table=int(model == "table"))
    for name, g, w in zip(("ok", "sinr", "rx_dbm"), got, want):
        assert _bit_equal(g, w), name
    assert int(got[0].sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("n", [32, 65])
def test_wifi_scan_equals_plain(card, n):
    from tpudes_torch.parallel import kernels as win

    pos, _, mode, fb = _window_inputs(n, 1)
    keys = replica_keys(PRNGKey(8).to(card), 32)
    kc.reset_launches()
    got = win.multi_window_scan(pos[0], 0.25, mode[0], fb[0], keys, 16)
    assert kc.launches == _counts(win=2, win_geometry=1, win_scan=1)
    want = win.scan_math(pos[0].to(card), torch.full((n,), 0.25,
                                                     device=card),
                         mode[0].to(card), fb[0].to(card), keys, 16)
    assert torch.equal(got, want) and int(want.sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8, 65, 1024])
def test_wifi_geometry_bit_equal_to_plain(card, n):
    from tpudes_torch.parallel import kernels as win
    from tpudes_torch.parallel.window_cuda import geometry_launch

    pos = _window_inputs(n, 1)[0][0].to(card)
    kc.reset_launches()
    rx_w, det = geometry_launch(pos)
    params = win.WindowParams()
    rx_dbm, want = win.geometry(pos, params)
    torch.cuda.synchronize()
    assert kc.launches == _counts(win=1, win_geometry=1)
    assert _bit_equal(rx_w, want)
    assert torch.equal(det, rx_dbm >= params.rx_sensitivity_dbm)


@pytest.mark.cuda
def test_wifi_window_on_card_equals_cpu(card):
    from tpudes_torch.parallel import kernels as win

    pos, tx, mode, fb = _window_inputs(32, 1)
    key = PRNGKey(0)
    got = win.wifi_phy_window(pos[0], tx[0], mode[0], fb[0], key)
    want = win.wifi_phy_window(pos[0], tx[0], mode[0], fb[0], key,
                               device="cpu")
    for g, w in zip(got, want):
        assert _bit_equal(g.cpu(), w)
    total = win.multi_window_scan(pos[0], 0.25, mode[0], fb[0], key, 8)
    assert int(total) == int(win.multi_window_scan(
        pos[0], 0.25, mode[0], fb[0], key, 8, device="cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [200, 1024])
@pytest.mark.parametrize("model", ["nist", "table"])
def test_wifi_window_large_n_bit_equal_to_plain(card, model, n):
    """Past the N whose geometry fits in shared memory the window keeps it
    in its own sinr and rx_dbm slabs: still the plain version's bits."""
    from tpudes_torch.parallel import kernels as win
    from tpudes_torch.parallel.window_cuda import window_launch

    pos, tx, mode, fb = (x.to(card) for x in _window_inputs(n, 1, seed=n))
    keys = replica_keys(PRNGKey(n).to(card), 1)
    params = win.WindowParams(error_model=model)
    kc.reset_launches()
    got = window_launch(pos, tx, mode, fb, keys, params)
    want = win.window_math(pos, tx, mode, fb, win.uniform(keys, (n, n)),
                           params)
    torch.cuda.synchronize()
    assert kc.launches == _counts(win=1, win_table=int(model == "table"))
    for name, g, w in zip(("ok", "sinr", "rx_dbm"), got, want):
        assert _bit_equal(g, w), name
    assert int(got[0].sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("n", [200, 1024])
def test_wifi_scan_large_n_equals_plain(card, n):
    from tpudes_torch.parallel import kernels as win

    pos, _, mode, fb = _window_inputs(n, 1, seed=n)
    keys = replica_keys(PRNGKey(n).to(card), 1)
    kc.reset_launches()
    got = win.multi_window_scan(pos[0], 0.25, mode[0], fb[0], keys, 4)
    assert kc.launches == _counts(win=2, win_geometry=1, win_scan=1)
    want = win.scan_math(pos[0].to(card), torch.full((n,), 0.25,
                                                     device=card),
                         mode[0].to(card), fb[0].to(card), keys, 4)
    assert torch.equal(got, want) and int(want.sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("what", ["window", "table", "scan"])
def test_wifi_probes_return_finite_cycles(card, what):
    from tpudes_torch.parallel import kernels as win
    from tpudes_torch.parallel import window_cuda

    pos, tx, mode, fb = (x.to(card) for x in _window_inputs(65, 16))
    keys = replica_keys(PRNGKey(5).to(card), 16)
    kc.reset_launches()
    if what == "scan":
        args = (pos[0], torch.full((65,), 0.25, device=card), mode[0],
                fb[0], keys, 8)
        got, cyc = window_cuda.scan_profile(*args)
        assert torch.equal(got, window_cuda.scan_launch(*args))
    else:
        params = win.WindowParams(error_model="table" if what == "table"
                                  else "nist")
        got, cyc = window_cuda.window_profile(pos, tx, mode, fb, keys,
                                              params)
        want = window_cuda.window_launch(pos, tx, mode, fb, keys, params)
        assert all(_bit_equal(g, w) for g, w in zip(got, want))
    torch.cuda.synchronize()
    assert cyc.shape == (len(window_cuda.WIN_PROF_STAGES),)
    assert torch.isfinite(cyc).all() and (cyc >= 0).all() and cyc.sum() > 0


@pytest.mark.cuda
def test_wifi_fma_routine_equals_fma32(card):
    """The window's multiply-add over f64 registers against
    ``xla_math::fma32`` on 2^24 triples of random bits (every class of
    f32, NaN bits compared as one pattern) and 2^20 constructed ties."""
    from tpudes_torch.parallel.window_cuda import fma_check

    gen = torch.Generator(device=card).manual_seed(12)
    n = 1 << 24
    a, b, c = (torch.randint(-2**31, 2**31, (n,), device=card,
                             generator=gen, dtype=torch.int64)
               .to(torch.int32).view(torch.float32) for _ in range(3))
    got, want = fma_check(a, b, c)
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan].view(torch.int32),
                       want[~nan].view(torch.int32))
    m = 1 << 20
    j = torch.randint(1, 300, (m,), device=card, generator=gen).double()
    u = j * 2.0 ** -23
    k = torch.randint(-100, 100, (m,), device=card, generator=gen).double()
    cm = torch.randint(1, 1 << 23, (m,), device=card, generator=gen).double()
    ta = (2.0 ** -24 * (1 + u) * 2.0 ** k).float()
    tb = (1 - u).float()
    tc = ((1 + cm * 2.0 ** -23) * 2.0 ** k).float()
    got, want = fma_check(ta, tb, tc)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("fn", ["exp", "log", "log1p", "erfc"])
def test_wifi_chain_over_f64_equals_f32(card, fn):
    """The window's exp, log, log1p and erfc over f64 registers against
    xla_math.cuh's f32 functions on 2^22 random-bit inputs and 2^22 draws
    of the error model's domain: equal wherever the f64 chain stays in
    range, which it does on nearly all the domain draw (erfc's is cut at
    9: from 9.2 to its flush at 9.42 exp(-x^2) / x leaves f32's normals
    and the kernels take the f32 path)."""
    from tpudes_torch.parallel.window_cuda import chain_check

    gen = torch.Generator(device=card).manual_seed(3)
    n = 1 << 22
    raw = torch.randint(-2**31, 2**31, (n,), device=card, generator=gen,
                        dtype=torch.int64).to(torch.int32)
    lo, hi = {"exp": (-95.0, 95.0), "log": (1e-38, 4.0),
              "log1p": (-1.0, 1.0), "erfc": (-1.0, 9.0)}[fn]
    x = torch.cat([raw.view(torch.float32),
                   torch.rand(n, device=card, generator=gen) * (hi - lo)
                   + lo])
    got, want, in_range = chain_check(x, fn)
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got)[in_range], nan[in_range])
    keep = in_range & ~nan
    assert torch.equal(got[keep].view(torch.int32),
                       want[keep].view(torch.int32))
    assert in_range[n:].double().mean().item() > 0.99


def _as_bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["hops", "delay"])
@pytest.mark.parametrize("rounds, shared", [(48, None), (3, None),
                                            (48, False)])
def test_as_spf_bit_equal_to_plain(card, metric, rounds, shared):
    """as_spf against spf_math and walk_math on the card: a 3,000-node BA
    graph, full and truncated rounds, its rows in shared and in device
    memory; the routing tables and the walk's path, hops and reached."""
    from tpudes_torch.parallel import as_cuda
    from tpudes_torch.parallel import as_flows as asf
    from tpudes_torch.scenarios import as_program

    prog = dataclasses.replace(as_program(3000, 64, 1.0, seed=4),
                               spf_metric=metric, spf_rounds=rounds)
    g = asf.spf_graph(prog, card)
    dist, nh_edge, nh_node = asf.spf_math(g, prog.n, rounds)
    want = (dist, nh_edge, nh_node,
            *asf.walk_math(g, dist, nh_edge, nh_node))
    kc.reset_launches()
    got = as_cuda.spf_cuda(g, prog.n, rounds, shared)
    torch.cuda.synchronize()
    assert kc.launches["as_spf"] == 1
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and torch.equal(_as_bits(a), _as_bits(b))
    if rounds < 10:
        assert (want[0] == asf.INF).any() and not want[5].all()


@pytest.mark.cuda
@pytest.mark.parametrize("scales, split", [([1.0], (4,)),
                                           ([0.5, 1.0, 4.0, 16.0], (4,)),
                                           ([1.0, 8.0], (1, 3))])
def test_as_fluid_bit_equal_to_plain(card, scales, split):
    """as_fluid against as_replica_draws and fluid_math on the card over a
    (C, 64) grid whose upper points overload links, one launch and a run
    split in two; the draws it writes out equal as_replica_draws'."""
    from tpudes_torch.parallel import as_cuda
    from tpudes_torch.parallel import as_flows as asf
    from tpudes_torch.scenarios import as_program

    prog = dataclasses.replace(as_program(3000, 64, 1.0, seed=4),
                               flow_bps=np.full(64, 2e7))
    args, _ = asf.fluid_inputs(prog, np.array([0, 9]), 64, scales, card)
    want, _, z = asf.fluid_draws_math(*args, asf.FP_ROUNDS)
    lf = None
    for rounds in split:
        got, lf = as_cuda.fluid_cuda(*args, rounds, lf, carry=True,
                                     z_out=True)
    torch.cuda.synchronize()
    for k in want:
        assert torch.equal(_as_bits(want[k]), _as_bits(got[k])), k
    assert torch.equal(_as_bits(z), _as_bits(got["z"]))
    if len(scales) > 2:
        assert (want["delivered_frac"][-1] < 1.0).any()


@pytest.mark.cuda
def test_as_erf_inv_bit_equal_to_plain(card):
    """The draw's erf_inv (as_fluid's, xla_math::xla_erf_inv) against
    fused.erf_inv on the card: 2^20 draws' inputs, both branches, +-1."""
    from tpudes_torch.ops.fused import erf_inv
    from tpudes_torch.parallel import as_cuda

    gen = torch.Generator(device=card).manual_seed(5)
    x = torch.cat([torch.rand(1 << 20, device=card, generator=gen) * 2 - 1,
                   1 - torch.rand(1 << 12, device=card, generator=gen) * 1e-3,
                   torch.tensor([1.0, -1.0, 0.0, -0.0], device=card)])
    assert torch.equal(_as_bits(as_cuda.erf_inv_check(x)),
                       _as_bits(erf_inv(x)))


@pytest.mark.cuda
def test_as_flows_on_card_equals_cpu(card, monkeypatch):
    """run_as_flows on the card (one as_spf and one as_fluid launch, and
    no call of the plain walk or draws) against the plain path on the
    CPU."""
    from tpudes_torch.parallel import as_flows as asf
    from tpudes_torch.scenarios import as_program

    prog = as_program(2000, 32, 1.0, seed=6)
    key = np.array([0, 5])
    want = asf.run_as_flows(prog, key, 16, rate_scale=[1.0, 40.0],
                            device="cpu")

    def plain(*a, **k):
        raise AssertionError("the card's run called a plain stage")

    for name in ("walk_paths", "_walk", "as_replica_draws",
                 "fluid_draws_math", "spf_math", "fluid_math"):
        monkeypatch.setattr(asf, name, plain)
    kc.reset_launches()
    got = asf.run_as_flows(prog, key, 16, rate_scale=[1.0, 40.0])
    assert kc.launches == _counts(as_spf=1, as_fluid=1, as_fluid_sweep=1)
    for w, g in zip(want, got):
        for k in w:
            a, b = np.asarray(w[k]), np.asarray(g[k])
            if a.dtype == np.float32:
                a, b = a.view(np.uint32), b.view(np.uint32)
            assert np.array_equal(a, b), k


def _wired_clone(carry):
    return {k: (v.clone() if torch.is_tensor(v) else v)
            for k, v in carry.items()}


def _wired_equal(want, wm, got, gm):
    from tpudes_torch.parallel import wired as wd

    for k, _ in wd.WIRED_STATE:
        assert torch.equal(want[k], got[k]), k
    assert want["t"] == got["t"]
    assert torch.equal(wm["next_event"], gm["next_event"])
    assert int(wm["n_steps"]) == int(gm["n_steps"])


@pytest.mark.cuda
@pytest.mark.parametrize("span", [1, 128, 4096])
def test_wired_advance_bit_equal_to_plain(card, span):
    """wired_advance against advance_math on the card: the bench chain
    (64 links, 64 flows, jitter 5) at 64 replicas over a zero-step window
    and two windows, every state array, t, next_event and n_steps."""
    from tpudes_torch.parallel import wired as wd
    from tpudes_torch.parallel import wired_cuda

    prog = wd.wired_chain(64, 64, period=200, n_slots=3000, jitter_slots=5)
    tab = wd.wired_tables(prog, [(prog, None, None)], card)
    init, _ = wd.build_wired_advance(prog, 64, device=card)
    carry = init(np.array([0, 3]))
    kc.reset_launches()
    for g in (0, 1200, 3000):
        want, wm = wd.advance_math(tab, _wired_clone(carry), g)
        got, gm = wired_cuda.wired_cuda(tab, _wired_clone(carry), g, span)
        torch.cuda.synchronize()
        _wired_equal(want, wm, got, gm)
        carry = want
    assert kc.launches == _counts(wired=3)
    assert (carry["deliver"] >= 0).sum() > 10_000


@pytest.mark.cuda
@pytest.mark.parametrize("transport, ranks", [("local", 4), ("batched", 4)])
def test_wired_hybrid_on_card_equals_cpu(card, monkeypatch, transport,
                                         ranks):
    """run_hybrid on the card, every window one wired_advance launch (a
    rank's owned links, or four lanes), each launch held against
    advance_math on a copy of its carry; the merged result equal to the
    CPU's run_wired."""
    from tpudes_torch.parallel import hybrid as hy
    from tpudes_torch.parallel import wired as wd
    from tpudes_torch.parallel import wired_cuda

    prog = (wd.wired_chain(16, 12, period=20, n_slots=2000, ranks=ranks,
                           boundary_delay=40, jitter_slots=3)
            if transport == "local" else
            wd.wired_weak_chain(ranks, links_per_rank=4, period=9,
                                cross_period=31, n_slots=2000,
                                boundary_delay=40, jitter_slots=3))
    want = wd.run_wired(prog, np.array([0, 5]), 32, device="cpu")
    real = wired_cuda.wired_cuda
    launches = []

    def held(tab, carry, t_grant):
        want, wm = wd.advance_math(tab, _wired_clone(carry), t_grant)
        got, gm = real(tab, carry, t_grant)
        _wired_equal(want, wm, got, gm)
        launches.append(tab["paths"].shape[0])
        return got, gm

    monkeypatch.setattr(wired_cuda, "advance_launch", held)
    kc.reset_launches()
    got = hy.run_hybrid(prog, np.array([0, 5]), 32, transport=transport)
    n = len(launches)
    assert n > ranks * 3
    if transport == "local":
        assert kc.launches == _counts(wired=n, wired_owned=n)
    else:
        assert kc.launches == _counts(wired=n, wired_lanes=n)
    for k in ("deliver_slot", "delivered", "served"):
        assert np.array_equal(want[k], got[k]), k


@pytest.mark.cuda
def test_run_wired_on_card_equals_cpu(card, monkeypatch):
    """run_wired on the card (one wired_advance launch a window, no call of
    the plain loop) against the plain run on the CPU."""
    from tpudes_torch.parallel import wired as wd
    from tpudes_torch.parallel import wired_cuda

    prog = wd.wired_chain(24, 16, period=40, n_slots=4000, jitter_slots=5)
    want = wd.run_wired(prog, np.array([0, 9]), 48, window_slots=1500,
                        device="cpu")

    def plain(*a, **k):
        raise AssertionError("the card's run called the plain loop")

    monkeypatch.setattr(wd, "advance_math", plain)
    monkeypatch.setattr(wd, "wired_step_math", plain)
    monkeypatch.setattr(wired_cuda, "advance_math", plain)
    kc.reset_launches()
    got = wd.run_wired(prog, np.array([0, 9]), 48, window_slots=1500)
    assert kc.launches == _counts(wired=3)
    for k in ("deliver_slot", "delivered", "served"):
        assert np.array_equal(want[k], got[k]), k


@pytest.mark.cuda
def test_wired_list_overflow_raises_on_card(card):
    """Six packets reach one link at one slot: a list of four entries
    raises ListOverflowError naming the capacity and the row (no
    fallback), a list of six runs bit-equal to advance_math."""
    from tpudes_torch.parallel import wired as wd
    from tpudes_torch.parallel import wired_cuda

    prog = wd.WiredProgram(
        n_links=2, service_slots=np.array([1, 1], np.int32),
        delay_slots=np.array([2, 2], np.int32),
        paths=np.array([[0, 1]] * 6, np.int32),
        start_slot=np.full(6, 3, np.int32),
        period_slots=np.full(6, 50, np.int32),
        n_pkts=np.full(6, 2, np.int32), n_slots=120)
    tab = wd.wired_tables(prog, [(prog, None, None)], card)
    init, _ = wd.build_wired_advance(prog, 2, device=card)
    carry = init(np.array([0, 3]))
    with pytest.raises(wired_cuda.ListOverflowError,
                       match=r"cap=4 .* row 0"):
        wired_cuda.wired_cuda(tab, _wired_clone(carry), 120, 8, 4)
    want, wm = wd.advance_math(tab, _wired_clone(carry), 120)
    got, gm = wired_cuda.wired_cuda(tab, _wired_clone(carry), 120, 8, 6)
    torch.cuda.synchronize()
    _wired_equal(want, wm, got, gm)


@pytest.mark.cuda
def test_wired_profile_stage_sums(card):
    """wired_profile (the PROF instantiation) on the bench chain at 64
    replicas over 3,000 slots: its state equal to advance_math's, not
    counted as a launch; every row's stage cycles >= 0 and their sum
    within the row's total; refreshes, windows and list lengths
    positive."""
    from tpudes_torch.parallel import wired as wd
    from tpudes_torch.parallel import wired_cuda

    prog = wd.wired_chain(64, 64, period=200, n_slots=3000, jitter_slots=5)
    tab = wd.wired_tables(prog, [(prog, None, None)], card)
    init, _ = wd.build_wired_advance(prog, 64, device=card)
    carry = init(np.array([0, 3]))
    prof = torch.zeros((64, wired_cuda.PROF_WORDS), dtype=torch.int64,
                       device=card)
    kc.reset_launches()
    want, wm = wd.advance_math(tab, _wired_clone(carry), 3000)
    got, gm = wired_cuda.wired_profile(tab, _wired_clone(carry), 3000, prof)
    torch.cuda.synchronize()
    _wired_equal(want, wm, got, gm)
    assert kc.launches == _counts()
    n = len(wired_cuda.PROF_STAGES)
    stages = prof[:, :n]
    assert (stages >= 0).all()
    assert (stages.sum(1) <= prof[:, n]).all()
    assert (prof[:, n + 1:] > 0).all()
    per = wired_cuda.wired_stages(prof.cpu())
    assert 0 < per["list_mean"] <= per["list_max"] <= wired_cuda.LIST_CAP


# --- the engine runtime on the card ------------------------------------------


def _same_result(a, b) -> bool:
    a = a if isinstance(a, list) else [a]
    b = b if isinstance(b, list) else [b]
    return len(a) == len(b) and all(
        set(x) == set(y) and all(np.array_equal(np.asarray(x[k]),
                                                np.asarray(y[k]))
                                 for k in x)
        for x, y in zip(a, b))


def _runtime_entries(card):
    from tpudes_torch.parallel.as_flows import run_as_flows
    from tpudes_torch.parallel.hybrid import run_hybrid
    from tpudes_torch.parallel.programs import (
        toy_as_program,
        toy_bss_program,
        toy_dumbbell_program,
    )
    from tpudes_torch.parallel.wired import run_wired, wired_weak_chain

    key = np.array([0, 3])
    wired = wired_weak_chain(2, links_per_rank=3, flows_per_rank=2,
                             period=40, n_slots=600, jitter_slots=3)
    return {
        "lte_sm": lambda **kw: run_lte_sm(_program(), key, replicas=3,
                                          device=card, **kw),
        "bss": lambda **kw: bss.run_replicated_bss(
            toy_bss_program(4, 60_000), 3, key, device=card, **kw),
        "dumbbell": lambda **kw: tcp.run_tcp_dumbbell(
            toy_dumbbell_program(3, 200), key, 3, device=card, **kw),
        "as_flows": lambda **kw: run_as_flows(
            toy_as_program(64, 3), key, 3, rate_scale=[1.0, 8.0],
            device=card, **kw),
        "wired": lambda **kw: run_wired(wired, key, 3, window_slots=200,
                                        device=card, **kw),
        "hybrid": lambda **kw: run_hybrid(wired, key, 3, transport="local",
                                          device=card, **kw),
    }


@pytest.mark.parametrize("name", ["lte_sm", "bss", "dumbbell", "as_flows",
                                  "wired", "hybrid"])
def test_runner_cache_hit_bit_equal_to_miss_on_card(card, name):
    """Miss, hit, hit through each entry on the card: all three equal, and
    equal to the CPU's run (a cached table a launch wrote into would make
    the hits differ)."""
    from tpudes_torch.parallel.runtime import RUNTIME

    run = _runtime_entries(card)[name]
    RUNTIME.clear()
    hits = RUNTIME.hits
    miss, hit1, hit2 = run(), run(), run()
    assert _same_result(miss, hit1) and _same_result(miss, hit2)
    assert RUNTIME.hits - hits >= 2
    cpu = _runtime_entries(torch.device("cpu"))[name]()
    assert _same_result(miss, cpu)


def test_submitted_run_behind_a_sleep_kernel_is_not_done(card):
    """A run submitted behind a 0.2 s sleep kernel on the same stream is
    not done when it returns; its result equals the blocking run's."""
    want = run_lte_sm(_program(), PRNGKey(4), replicas=R, device=card)
    torch.cuda.synchronize()
    torch.cuda._sleep(int(0.2 * 2.0e9))
    fut = run_lte_sm(_program(), PRNGKey(4), replicas=R, device=card,
                     block=False)
    assert not fut.done()
    got = fut.result()
    assert fut.done() and _same_result(got, want)


def test_checkpoint_resumes_on_card(card, tmp_path):
    """The dumbbell in four chunks with a checkpoint, killed after the
    second chunk's save, resumes with two launches, bit-equal to the
    uninterrupted run."""
    import tpudes_torch.chaos as chaos
    from tpudes_torch.parallel.programs import toy_dumbbell_program

    prog = toy_dumbbell_program(3, 400)
    key = np.array([0, 8])
    want = tcp.run_tcp_dumbbell(prog, key, 5, device=card)
    path = tmp_path / "tcp.ckpt"
    chaos.arm(chaos.ChaosSchedule([chaos.ChaosEvent(
        "checkpoint_kill", "checkpoint_save", nth=2)]))
    try:
        with pytest.raises(chaos.ChaosInjected):
            tcp.run_tcp_dumbbell(prog, key, 5, device=card, chunk_slots=100,
                                 checkpoint=path)
    finally:
        chaos.disarm()
    kc.reset_launches()
    got = tcp.run_tcp_dumbbell(prog, key, 5, device=card, chunk_slots=100,
                               checkpoint=path)
    assert kc.launches["tcp_advance"] == 2
    assert _same_result(got, want)


# --------------------------------------------------------------------------
# the OBS arms (obs=True): the FlowMonitor columns against the plain loops


def _same_tree(want: dict, got: dict) -> bool:
    for k, v in want.items():
        if torch.is_tensor(v):
            a, b = v, got[k]
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            if not torch.equal(a, b.to(a.device)):
                return False
        elif v != got[k]:
            return False
    return True


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_lte_obs_arm_bit_equal_to_plain_loop(card, precision):
    """``lte_sm_advance``'s OBS arm against ``sm_advance_math`` with the
    columns: one point and the nine-point scheduler grid, two launches."""
    from tpudes_torch.obs.flowmon import flow_carry

    prog = _program(n_ttis=150, precision=precision)
    consts = kc.build_sm_consts(prog, device=card)
    keys = replica_keys(PRNGKey(5, device=card), R)
    for sids in (3, torch.arange(9, dtype=torch.int32, device=card)):
        lanes = R * (1 if isinstance(sids, int) else 9)
        s0 = kc.sm_init_state(prog.n_enb, prog.n_ue, lanes, card)
        fm0 = flow_carry(prog.n_ue, (lanes,), card)
        want = kc.sm_advance_math(consts, s0, keys, 0, 150, sids, fm=fm0)
        half = kc.sm_advance_cuda(consts, s0, keys, 0, 71, sids, fm=fm0)
        got = kc.sm_advance_cuda(consts, half[0], keys, 71, 150, sids,
                                 fm=half[1])
        assert _same_tree(want[0], got[0]) and _same_tree(want[1], got[1])
        assert int(got[1]["fm_rx"].sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("red", [False, True])
def test_tcp_obs_arm_bit_equal_to_plain_loop(card, red):
    """``tcp_advance``'s OBS arm against the plain loop's obs_slot, two
    launches; droptail and RED/ECN."""
    prog = dumbbell_program(
        6, 0.5, variants=["TcpDctcp", "TcpNewReno", "TcpCubic"] * 2,
        bottleneck_rate="5Mbps",
        red=dict(MinTh=3, MaxTh=8, MaxSize=60, UseEcn=True) if red else None)
    consts = tcp.build_tcp_consts(prog, card)
    var, ecn = (torch.as_tensor(x, device=card)
                for x in tcp.sweep_operands(prog, None))
    key = PRNGKey(2, device=card)
    s0 = tcp.init_state(consts, 5, 1, obs=True)
    from tpudes_torch.parallel.tcp_cuda import tcp_launch

    want = tcp.tcp_advance_math(consts, s0, key, 0, prog.n_slots, var, ecn)
    got = tcp_launch(consts, tcp_launch(consts, s0, key, 0, 97, var, ecn),
                     key, 97, prog.n_slots, var, ecn)
    assert _same_tree(want, got) and int(got["fm_rx"].sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("ht", [False, True])
def test_bss_obs_arm_bit_equal_to_plain_loop(card, ht):
    """``bss_advance``'s OBS arm (legacy and A-MPDU) against the plain
    loop, two launches, the finished replicas' idle ring rows included."""
    from tpudes_torch.parallel.bss_cuda import bss_advance_cuda

    kw = dict(interval_s=0.01, data_mode="HtMcs7", standard="80211n") \
        if ht else {}
    prog = bss_program(8, 1.3, radii=(12.0, 20.0, 28.0), **kw)
    consts, init, _ = bss.build_bss_advance(prog, 5, card)
    key = PRNGKey(3, device=card)
    ends = [prog.sim_end_us]
    s0 = init(1, True)
    want, w_steps, w_pend = bss.bss_advance_math(consts, s0, key, [0],
                                                 100_000, ends)
    half, steps, _ = bss_advance_cuda(consts, s0, key, [0], 333, ends)
    got, steps, pend = bss_advance_cuda(consts, half, key, steps, 100_000,
                                        ends)
    assert steps == w_steps and torch.equal(pend.cpu(), w_pend.cpu())
    assert _same_tree(want, got) and int(got["fm_rx"].sum()) > 0


@pytest.mark.cuda
def test_wired_obs_arm_bit_equal_to_plain_version(card):
    """``wired_advance``'s OBS arm and the union pass against
    ``advance_math`` with the columns (every row on the union clock) over
    windows of 37, 1 and 162 slots and the rest, each window one launch of
    each."""
    from tpudes_torch.parallel import wired as W
    from tpudes_torch.parallel import wired_cuda

    prog = W.wired_chain(12, 8, jitter_slots=5, n_slots=600)
    tab = W.wired_tables(prog, [(prog, None, None)], card)
    init, _ = W.build_wired_advance(prog, 6, device=card, obs=True, tab=tab)
    want = init(np.array([0, 9]))
    got = {k: (v.clone() if torch.is_tensor(v) else v)
           for k, v in want.items()}
    kc.reset_launches()
    for b in (37, 38, 200, 600):
        want, wm = W.advance_math(tab, want, b)
        got, gm = wired_cuda.wired_obs_cuda(tab, got, b)
        assert _same_tree(want, got) and _same_tree(wm, gm), b
    assert kc.launches == _counts(wired=4, wired_obs=4, wired_obs_union=4)
    assert int(got["fm_rx"].sum()) > 0


@pytest.mark.cuda
def test_obs_main_paths_launch_the_obs_arms(card):
    """``obs=True`` through each entry launches its kernel's OBS arm, once
    a chunk, and gives the CPU run's columns."""
    from tpudes_torch.parallel.wired import run_wired, wired_chain

    runs = {
        "lte_sm_advance": lambda dev: run_lte_sm(
            _program(80), PRNGKey(4), replicas=R, device=dev, obs=True,
            chunk_ttis=40),
        "tcp_advance": lambda dev: tcp.run_tcp_dumbbell(
            dumbbell_program(4, 0.3), PRNGKey(4), 3, device=dev, obs=True,
            chunk_slots=128),
        "bss_advance": lambda dev: bss.run_replicated_bss(
            bss_program(8, 1.2), 3, PRNGKey(4), device=dev, obs=True),
        "wired_advance": lambda dev: run_wired(
            wired_chain(6, 3, n_slots=300), np.array([0, 4]), 3,
            device=dev, obs=True, window_slots=100),
    }
    for name, run in runs.items():
        kc.reset_launches()
        got = run(card)
        assert kc.launches[f"{name}:obs"] == kc.launches[name] > 0, name
        if name == "wired_advance":
            assert kc.launches["wired_advance:obs_union"] == kc.launches[
                name]
        want = run(torch.device("cpu"))
        for k, v in want["flow"].items():
            assert np.array_equal(np.asarray(v).view(np.uint8),
                                  np.asarray(got["flow"][k]).view(np.uint8)
                                  ), (name, k)
