"""The port's wired engine against the JAX engine and the host DES.

``tpudes_torch.parallel.wired.run_wired`` on the CPU (the plain
``advance_math``) against the reference ``tpudes.parallel.wired.run_wired``
per replica on ``deliver_slot``, ``delivered`` and ``served``, and each
row against the reference's sequential host DES ``run_wired_host`` with
that row's phase jitter, on: ``wired_chain()`` at its defaults; a chain of
12 links and 8 flows with ``jitter_slots=5`` at R = 4;
``wired_weak_chain(2)`` over 3,000 slots; and a program whose flows use
every column of ``paths``.  Also: windows of 37 slots equal the single
shot; ``replica_offset`` slices equal one run's rows; ``randint`` and
``wired_jitter`` equal ``jax.random`` over 64 keys; the reference's whole
carry, held window by window with ingress for one rank of a two-rank
chain, equals the port's after every window; the program constructors,
partitions and lookaheads equal the reference's, and so do the
``UnliftableWiredError`` cases and their messages.  Tolerance: none (all
integers).
"""

import jax
import numpy as np
import pytest
import torch

from tpudes.parallel import hybrid as ref_hybrid
from tpudes.parallel import wired as ref
from tpudes_torch import random as tr
from tpudes_torch.convert import (
    WIRED_FIELDS,
    wired_from_numpy,
    wired_state_from_numpy,
)
from tpudes_torch.parallel import wired as W

KEY = 7
FIELDS = ("deliver_slot", "delivered", "served")


def _port(prog):
    return wired_from_numpy({k: getattr(prog, k) for k in WIRED_FIELDS})


def _key(seed=KEY):
    return np.array([0, seed])


def _full_column_program():
    """Flows over all three columns of ``paths`` (``nhops == H``), one of
    them backwards, so the last hop reads the last column."""
    return ref.WiredProgram(
        n_links=3, service_slots=np.array([1, 2, 1], np.int32),
        delay_slots=np.array([2, 3, 2], np.int32),
        paths=np.array([[0, 1, 2], [2, 1, 0], [1, 2, -1]], np.int32),
        start_slot=np.array([1, 2, 3], np.int32),
        period_slots=np.array([3, 4, 5], np.int32),
        n_pkts=np.array([40, 30, 20], np.int32), n_slots=200,
        jitter_slots=2)


PROGRAMS = {
    "chain_defaults": (lambda: ref.wired_chain(), 2),
    "chain_12x8_jitter5": (lambda: ref.wired_chain(
        12, 8, jitter_slots=5, n_slots=800), 4),
    "weak_chain_2": (lambda: ref.wired_weak_chain(2, n_slots=3000), 2),
    "full_columns": (_full_column_program, 3),
}


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_run_wired_equals_reference_and_host_des(name):
    build, R = PROGRAMS[name]
    prog = build()
    want = ref.run_wired(prog, jax.random.key(KEY), replicas=R)
    got = W.run_wired(_port(prog), _key(), R, device="cpu")
    for k in FIELDS:
        assert got[k].dtype == np.int32 and np.array_equal(want[k], got[k]), k
    assert got["delivered"].sum() > 0
    jit = np.asarray(ref._replica_jitter(prog, jax.random.key(KEY), R))
    for r in range(R):
        host = ref.run_wired_host(prog, jitter=jit[r])
        assert np.array_equal(got["deliver_slot"][r], host["deliver_slot"])
        assert np.array_equal(got["served"][r], host["served"])


@pytest.mark.parametrize("name", ["chain_12x8_jitter5", "full_columns"])
def test_windows_equal_single_shot(name):
    prog = _port(PROGRAMS[name][0]())
    one = W.run_wired(prog, _key(), 3, device="cpu")
    win = W.run_wired(prog, _key(), 3, window_slots=37, device="cpu")
    for k in FIELDS:
        assert np.array_equal(one[k], win[k]), k


def test_replica_offset_slices_bit_equal():
    prog = _port(ref.wired_chain(5, 3, n_slots=300, jitter_slots=4))
    full = W.run_wired(prog, _key(), 5, device="cpu")
    lo = W.run_wired(prog, _key(), 3, replica_offset=0, device="cpu")
    hi = W.run_wired(prog, _key(), 2, replica_offset=3, device="cpu")
    for k in FIELDS:
        assert np.array_equal(np.concatenate([lo[k], hi[k]]), full[k]), k


@pytest.mark.parametrize("jitter", [1, 2, 5, 7])
def test_wired_jitter_equals_jax(jitter):
    """64 keys: the (R, F) phases of ``_replica_jitter`` with global flow
    ids and a replica offset, and ``randint`` itself."""
    prog = ref.wired_chain(5, 4, jitter_slots=jitter)
    ids = np.array([0, 3, 6, 11])
    for seed in range(64):
        key = jax.random.key(seed)
        want = np.asarray(ref._replica_jitter(prog, key, 3, 5,
                                              flow_ids=ids))
        got = tr.wired_jitter(torch.tensor([0, seed]), 3, ids, jitter, 5)
        assert got.dtype == torch.int32
        assert np.array_equal(want, got.numpy()), seed
        raw = jax.random.PRNGKey(seed)
        assert int(jax.random.randint(raw, (), 0, jitter + 1)) == int(
            tr.randint(torch.tensor([0, seed]), 0, jitter + 1)), seed


@pytest.mark.parametrize("lo, hi", [(0, 1), (-5, 9), (3, 3), (9, -2),
                                    (0, 70_000), (-2**31, 2**31 - 1)])
def test_randint_bounds_equal_jax(lo, hi):
    for seed in (0, 1, 99):
        want = int(jax.random.randint(jax.random.PRNGKey(seed), (), lo, hi))
        assert int(tr.randint(torch.tensor([0, seed]), lo, hi)) == want


def _same_state(want_carry, got: dict, what: str) -> None:
    want = wired_state_from_numpy(jax.device_get(want_carry), "cpu")
    assert got["t"] == want["t"], what
    for k, _ in W.WIRED_STATE:
        assert torch.equal(got[k], want[k]), (what, k)


@pytest.mark.parametrize("jitter", [0, 3])
def test_carried_state_equals_reference_every_window(jitter):
    """One rank of a two-rank chain (its owned links and resident flows),
    its ingress the reference protocol's: the reference carry and the
    port's are equal after the priming advance and after every window, and
    so are the next events."""
    prog = ref.wired_chain(8, 5, ranks=2, n_slots=400, jitter_slots=jitter)
    R = 4
    engines = [ref_hybrid.HybridRank(prog, jax.random.key(KEY), R, r, 2)
               for r in range(2)]
    ports = []
    for e in engines:
        init, adv = W.build_wired_advance(
            _port(e.sub), R, owned=e.owned, flow_ids=e.flow_ids,
            device="cpu")
        carry, m = adv(init(_key()), None, None, 0)
        _same_state(e.carry, carry, f"rank {e.rank} primed")
        assert int(m["next_event"]) == int(e._metrics["next_event"])
        ports.append([adv, carry])
    windows = 0
    while engines[0].t_now < prog.n_slots:
        polled = [e.poll() for e in engines]
        inboxes = [[], []]
        for outbox, _ in polled:
            for dst, payload in outbox.items():
                inboxes[dst].append(payload)
        grant = min(e.candidate(nx, inboxes[e.rank])
                    for e, (_, nx) in zip(engines, polled))
        g = min(grant, prog.n_slots)
        for e, port in zip(engines, ports):
            ing_hop = np.full(tuple(port[1]["hop"].shape), -1, np.int32)
            ing_ready = ing_hop.copy()
            ref_hybrid._inject_inbox(ing_hop, ing_ready, inboxes[e.rank],
                                     e._g2l, "rank")
            port[1], m = port[0](port[1], torch.from_numpy(ing_hop),
                                 torch.from_numpy(ing_ready), g)
            e.window(inboxes[e.rank], g)
            _same_state(e.carry, port[1], f"rank {e.rank} window {windows}")
            assert int(m["next_event"]) == int(e._metrics["next_event"])
        windows += 1
    assert windows > 5
    assert any((p[1]["deliver"] >= 0).any() for p in ports)


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_tables_partitions_and_lookaheads_equal_reference(name):
    prog = PROGRAMS[name][0]()
    port = _port(prog)
    for a, b in zip(ref.packet_table(prog), W.packet_table(port)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    split = ref.wired_chain(9, 5, ranks=3, boundary_delay=11, n_slots=300)
    for r in range(3):
        for a, b in zip(ref.partition_flows(split, r),
                        W.partition_flows(_port(split), r)):
            if isinstance(a, np.ndarray):
                assert np.array_equal(a, b)
            else:
                for k in WIRED_FIELDS:
                    assert np.array_equal(np.asarray(getattr(a, k)),
                                          np.asarray(getattr(b, k))), k
        assert (ref.partition_lookahead(split, r)
                == W.partition_lookahead(_port(split), r))


def _lanes(prog, how):
    """The lanes a launch takes: the whole program, each rank of its
    partitions as ``HybridLanes`` builds them, or its uniform space
    lanes."""
    if how == "whole":
        return [[(prog, None, None)]]
    owner = np.asarray(prog.link_owner)
    lanes = [(sub, owner == r, fids) for r, (sub, fids, _) in enumerate(
        W.partition_flows(prog, r) for r in range(prog.n_ranks))]
    return [lanes] if how == "space" else [[lane] for lane in lanes]


@pytest.mark.parametrize("prog, how", [
    (W.wired_chain(64, 64, period=200, n_slots=20_000, jitter_slots=5),
     "whole"),
    (W.wired_chain(64, 64, period=200, n_slots=20_000, jitter_slots=5,
                   ranks=4, boundary_delay=240), "ranks"),
    (W.wired_weak_chain(4, links_per_rank=2, period=3573, n_slots=108_000,
                        boundary_delay=600, cross_period=8793), "space"),
], ids=["bench_chain", "four_way_split", "weak_chain"])
def test_lo_at_equals_paths_nhops_g2l(prog, how):
    """``wired_tables``' derived ``lo_at`` (the kernel's one-load link
    table) against ``paths``, ``nhops`` and ``g2l`` hop by hop: the local
    link of each flow's hop, -2 where a peer serves it, -1 from the hop
    count on (column H included)."""
    for lanes in _lanes(prog, how):
        tab = W.wired_tables(prog, lanes, "cpu")
        K, F, H = tab["paths"].shape
        assert tab["lo_at"].shape == (K, F, H + 1)
        assert tab["lo_at"].dtype == torch.int16
        paths, nhops = tab["paths"].numpy(), tab["nhops"].numpy()
        g2l, lo_at = tab["g2l"].numpy(), tab["lo_at"].numpy()
        seen = set()
        for k in range(K):
            for f in range(F):
                for h in range(H + 1):
                    if h >= nhops[k, f]:
                        want = W.LO_DELIVERED
                    elif g2l[k, paths[k, f, h]] < 0:
                        want = W.LO_PEER
                    else:
                        want = g2l[k, paths[k, f, h]]
                    assert lo_at[k, f, h] == want, (k, f, h)
                    seen.add(min(int(want), 0))
        assert seen == ({-1, 0} if how == "whole" else {-2, -1, 0})


@pytest.mark.parametrize("kw", [
    dict(n_links=6, n_flows=4, period=7, n_pkts=5, n_slots=90, ranks=2,
         boundary_delay=12, jitter_slots=3),
    dict(service=[2, 1, 3], delay=[1, 4, 2], n_links=3, n_flows=2),
])
def test_chain_programs_equal_reference(kw):
    for a, b in ((ref.wired_chain(**kw), W.wired_chain(**kw)),
                 (ref.wired_weak_chain(3, 3, 2, n_slots=900),
                  W.wired_weak_chain(3, 3, 2, n_slots=900))):
        for k in WIRED_FIELDS:
            assert np.array_equal(np.asarray(getattr(a, k)),
                                  np.asarray(getattr(b, k))), k


def _raises_alike(fn_ref, fn_port, exc=ref.UnliftableWiredError):
    with pytest.raises(exc) as want:
        fn_ref()
    with pytest.raises(W.UnliftableWiredError if exc is
                       ref.UnliftableWiredError else exc) as got:
        fn_port()
    assert str(got.value) == str(want.value)


def _bad_fields(**over):
    base = dict(n_links=4, service_slots=np.array([1, 1, 1, 1], np.int32),
                delay_slots=np.array([2, 2, 2, 2], np.int32),
                paths=np.array([[0, 1, -1, -1]], np.int32),
                start_slot=np.array([1], np.int32),
                period_slots=np.array([5], np.int32),
                n_pkts=np.array([3], np.int32), n_slots=100)
    return dict(base, **over)


@pytest.mark.parametrize("over", [
    dict(service_slots=np.array([1, 0, 1, 1], np.int32)),
    dict(service_slots=np.array([1, 1, 1], np.int32)),
    dict(delay_slots=np.array([2, 0, 2, 2], np.int32)),
    dict(paths=np.array([[0, 9, -1, -1]], np.int32)),
    dict(period_slots=np.array([0], np.int32)),
])
def test_unliftable_programs_raise_as_reference(over):
    fields = _bad_fields(**over)
    _raises_alike(lambda: ref.WiredProgram(**fields),
                  lambda: W.WiredProgram(**fields))


def test_idle_rank_and_ragged_lanes_raise_as_reference():
    prog = ref.wired_chain(n_links=4, n_flows=2, n_slots=200)
    _raises_alike(lambda: ref.partition_flows(prog, 3),
                  lambda: W.partition_flows(_port(prog), 3))
    ragged = ref.wired_chain(n_links=6, n_flows=4, n_slots=300, ranks=2)
    _raises_alike(lambda: ref.build_wired_space_advance(ragged, 1),
                  lambda: W.build_wired_space_advance(_port(ragged), 1,
                                                      device="cpu"))


def test_space_lanes_equal_reference_state():
    """The four-lane space kernel's carry (rank axis leading) and per-lane
    next events equal the reference's after the priming advance and two
    windows."""
    prog = ref.wired_weak_chain(4, links_per_rank=2, n_slots=600,
                                jitter_slots=3)
    init_r, adv_r, _ = ref.build_wired_space_advance(prog, 2)
    init_p, adv_p, parts = W.build_wired_space_advance(_port(prog), 2,
                                                       device="cpu")
    assert len(parts) == 4
    carry_r = init_r(jax.random.key(KEY))
    carry_p = init_p(_key())
    no = np.full(np.asarray(carry_r["hop"]).shape, -1, np.int32)
    for g in (0, 150, 400):
        carry_r, m_r = adv_r(carry_r, no, no, np.int32(g))
        carry_p, m_p = adv_p(carry_p, None, None, g)
        _same_state(carry_r, carry_p, f"grant {g}")
        assert np.array_equal(np.asarray(m_r["next_event"]),
                              m_p["next_event"].numpy())


@pytest.mark.parametrize("kw, item", [
    (dict(mesh=object()), "A12"), (dict(block=False, mesh=object()), "A12"),
])
def test_unported_options_raise(kw, item):
    with pytest.raises(NotImplementedError, match=item):
        W.run_wired(W.wired_chain(), _key(), 1, device="cpu", **kw)


@pytest.mark.parametrize("kw", [dict(obs=True), dict(obs=True, block=False)])
def test_obs_runs_beside_block_false(kw):
    """``obs=True`` (once refused, ROADMAP A10) runs, also beside
    ``block=False``: the outputs are the obs=False run's, and each flow's
    deliveries are its received packets (tests/test_torch_obs_wired.py
    holds the columns against the reference)."""
    prog = W.wired_chain()
    got = W.run_wired(prog, _key(), 2, device="cpu", **kw)
    if not isinstance(got, dict):
        got = got.result()
    plain = W.run_wired(prog, _key(), 2, device="cpu")
    for k in FIELDS:
        assert np.array_equal(got[k], plain[k]), k
    assert np.array_equal(got["flow"]["fm_rx"], got["delivered"])
    assert (got["flow"]["fm_txb"] == 1000 * got["flow"]["fm_tx"]).all()


def test_obs_delay_sums_are_the_deliveries_delays():
    """``fm_dsum`` (in seconds) is each flow's delivered packets' delays,
    ``deliver - birth``, times ``slot_s``: one exact integer a delivery."""
    prog = W.wired_chain(6, 3, jitter_slots=0)
    got = W.run_wired(prog, _key(), 1, device="cpu", obs=True)
    flow, birth, _ = W.packet_table(prog)
    d = got["deliver_slot"][0]
    sums = np.zeros(prog.n_flows)
    np.add.at(sums, flow[d >= 0], (d - birth)[d >= 0])
    assert np.allclose(got["flow"]["fm_dsum"][0], sums * prog.slot_s,
                       rtol=0, atol=1e-9)
