"""The port's hybrid PDES against the JAX package's.

``tpudes_torch.parallel.hybrid.run_hybrid`` on the CPU, transports
``"local"`` (every rank a ``HybridRank``, lockstep rounds) and
``"batched"`` (all ranks as lanes of one launch), at 1, 2 and 4 ranks,
with free and bounded grants, with and without phase jitter: the merged
``deliver_slot``, ``delivered`` and ``served`` equal the reference
``tpudes.parallel.hybrid.run_hybrid``'s and the port's own ``run_wired``,
and ``windows`` and ``ranks`` equal the reference's (its replica
bucketing off: its padded replicas would join the grant, so where R is
not a power of two its window schedule can differ, ROADMAP C5).  Window
by window, a two-rank run's egress payloads and next events equal the reference
``HybridRank``'s (payload entries compared as sets: the protocol does not
depend on their order).  Ragged partitions under ``"batched"``, a rank
count that disagrees with the program, a program that names more ranks
than are launched, a payload outside a rank's resident set, and the
transports and options not ported raise as the reference does or name
their ROADMAP item.  Tolerance: none.
"""

import jax
import numpy as np
import pytest

from tpudes.parallel import hybrid as ref_hybrid
from tpudes.parallel import wired as ref
from tpudes_torch.convert import WIRED_FIELDS, wired_from_numpy
from tpudes_torch.parallel import hybrid as H
from tpudes_torch.parallel import wired as W

KEY = 7
FIELDS = ("deliver_slot", "delivered", "served")


@pytest.fixture(autouse=True)
def unbucketed(monkeypatch):
    monkeypatch.setenv("TPUDES_BUCKETING", "0")


def _port(prog):
    return wired_from_numpy({k: getattr(prog, k) for k in WIRED_FIELDS})


def _key():
    return np.array([0, KEY])


CASES = {
    "one_rank": (lambda j: ref.wired_chain(6, 3, n_slots=400, ranks=1,
                                           jitter_slots=j), 1),
    "two_ranks": (lambda j: ref.wired_chain(6, 3, n_slots=400, ranks=2,
                                            jitter_slots=j), 2),
    "four_ranks_weak": (lambda j: ref.wired_weak_chain(
        4, links_per_rank=2, n_slots=1500, jitter_slots=j), 4),
}


@pytest.mark.parametrize("transport", ["local", "batched"])
@pytest.mark.parametrize("window_slots", [None, 11])
@pytest.mark.parametrize("jitter", [0, 5])
@pytest.mark.parametrize("case", sorted(CASES))
def test_run_hybrid_equals_reference_and_run_wired(case, jitter,
                                                   window_slots, transport):
    build, ranks = CASES[case]
    prog = build(jitter)
    want = ref_hybrid.run_hybrid(prog, jax.random.key(KEY), replicas=3,
                                 ranks=ranks, transport=transport,
                                 window_slots=window_slots)
    got = H.run_hybrid(_port(prog), _key(), 3, ranks=ranks,
                       transport=transport, window_slots=window_slots,
                       device="cpu")
    plain = W.run_wired(_port(prog), _key(), 3, device="cpu")
    for k in FIELDS:
        assert np.array_equal(want[k], got[k]), k
        assert np.array_equal(plain[k], got[k]), k
    assert (got["windows"], got["ranks"]) == (want["windows"], ranks)
    assert got["delivered"].sum() > 0


def test_ragged_partitions_run_local_and_equal_run_wired():
    """A chain whose ranks hold different flow sets: the local transport
    runs it (four ranks), equal to the reference and to run_wired."""
    prog = ref.wired_chain(12, 7, ranks=4, n_slots=500, boundary_delay=9,
                           jitter_slots=2)
    want = ref_hybrid.run_hybrid(prog, jax.random.key(KEY), replicas=2)
    got = H.run_hybrid(_port(prog), _key(), 2, device="cpu")
    plain = W.run_wired(_port(prog), _key(), 2, device="cpu")
    for k in FIELDS:
        assert np.array_equal(want[k], got[k]), k
        assert np.array_equal(plain[k], got[k]), k
    assert got["windows"] == want["windows"]


def _payloads(outbox):
    return {dst: sorted(zip(*(p[k].tolist() for k in ("r", "p", "hop",
                                                      "ready"))))
            for dst, p in outbox.items()}


@pytest.mark.parametrize("jitter", [0, 4])
def test_two_rank_windows_equal_reference(jitter):
    prog = ref.wired_chain(8, 5, ranks=2, n_slots=400, jitter_slots=jitter)
    refs = [ref_hybrid.HybridRank(prog, jax.random.key(KEY), 4, r, 2)
            for r in range(2)]
    ports = [H.HybridRank(_port(prog), _key(), 4, r, 2, device="cpu")
             for r in range(2)]
    windows = crossed = 0
    while refs[0].t_now < prog.n_slots:
        polled_r = [e.poll() for e in refs]
        polled_p = [e.poll()[0] for e in ports]
        for (ob_r, nx_r), (ob_p, nx_p) in zip(polled_r, polled_p):
            assert nx_r == nx_p, windows
            assert _payloads(ob_r) == _payloads(ob_p), windows
            crossed += sum(p["p"].size for p in ob_p.values())
        inboxes = [[], []]
        for outbox, _ in polled_r:
            for dst, payload in outbox.items():
                inboxes[dst].append(payload)
        grants = [min(e.candidate(nx, inboxes[e.rank]) for e, (_, nx)
                      in zip(refs, polled_r)),
                  min(H._candidate(nx, inboxes[e.ranks[0]], e.lookaheads[0])
                      for e, (_, nx) in zip(ports, polled_p))]
        assert grants[0] == grants[1]
        g = min(grants[0], prog.n_slots)
        for e_r, e_p in zip(refs, ports):
            e_r.window(inboxes[e_r.rank], g)
            e_p.window([inboxes[e_p.ranks[0]]], g)
        windows += 1
    assert windows > 5 and crossed > 0
    for e_r, e_p in zip(refs, ports):
        want, got = e_r.results(), e_p.results()[0]
        for k in ("deliver", "served"):
            assert np.array_equal(want[k], got[k]), k


def _raises_alike(fn_ref, fn_port, exc, port_exc=None):
    with pytest.raises(exc) as want:
        fn_ref()
    with pytest.raises(port_exc or exc) as got:
        fn_port()
    assert str(got.value) == str(want.value)


def test_batched_rejects_ragged_partitions_as_reference():
    prog = ref.wired_chain(n_links=6, n_flows=4, n_slots=300, ranks=2)
    _raises_alike(
        lambda: ref_hybrid.run_hybrid(prog, jax.random.key(KEY),
                                      transport="batched"),
        lambda: H.run_hybrid(_port(prog), _key(), transport="batched",
                             device="cpu"),
        ref.UnliftableWiredError, W.UnliftableWiredError)


def test_wrong_rank_counts_raise_as_reference():
    prog = ref.wired_chain(6, 3, n_slots=400, ranks=2)
    _raises_alike(
        lambda: ref_hybrid.run_hybrid(prog, jax.random.key(KEY), ranks=3,
                                      transport="batched"),
        lambda: H.run_hybrid(_port(prog), _key(), ranks=3,
                             transport="batched", device="cpu"),
        ValueError)
    four = ref.wired_chain(8, 3, n_slots=400, ranks=4)
    _raises_alike(
        lambda: ref_hybrid.run_hybrid(four, jax.random.key(KEY), ranks=2),
        lambda: H.run_hybrid(_port(four), _key(), ranks=2, device="cpu"),
        ValueError)


@pytest.mark.parametrize("kw, item", [
    (dict(transport="mpi"), "A12"),
    (dict(transport="mpi", telemetry=True), "A12"),
])
def test_unported_transport_and_telemetry_raise(kw, item):
    prog = W.wired_chain(6, 3, n_slots=100, ranks=2)
    with pytest.raises(NotImplementedError, match=item):
        H.run_hybrid(prog, _key(), 1, device="cpu", **kw)


@pytest.mark.parametrize("transport", ["local", "batched"])
def test_telemetry_records_every_window(transport):
    """``telemetry=True`` (once refused, ROADMAP A10) records one window a
    rank a round, the grants summing to the horizon, the results the
    run without it (tests/test_torch_obs_engines.py holds the counts
    against the reference's drivers)."""
    from tpudes_torch.obs.distributed import (
        DistributedTelemetry,
        validate_distributed_metrics,
    )

    prog = W.wired_chain(6, 3, n_slots=100, ranks=2)
    DistributedTelemetry.reset()
    got = H.run_hybrid(prog, _key(), 1, device="cpu", telemetry=True,
                       transport=transport)
    plain = H.run_hybrid(prog, _key(), 1, device="cpu", transport=transport)
    for k in ("deliver_slot", "delivered", "served", "windows"):
        assert np.array_equal(got[k], plain[k]), k
    snap = DistributedTelemetry.snapshot()
    assert validate_distributed_metrics(snap) == []
    assert snap["counters"]["windows"] == 2 * got["windows"]
    for rank in ("0", "1"):
        assert snap["ranks"][rank]["grant_slots_sum"] == prog.n_slots
    DistributedTelemetry.reset()


def test_packet_outside_the_resident_set_raises():
    """Injection maps global packet ids to resident rows; a payload naming
    a packet the rank does not carry raises, as the reference's does."""
    import torch

    prog = W.wired_chain(12, 7, ranks=4, n_slots=300, boundary_delay=9)
    rank = H.HybridRank(prog, _key(), 2, 0, 4, device="cpu")
    foreign = np.setdiff1d(np.arange(rank.n_total_pkts),
                           rank.pkt_ids[0])[:1]
    payload = dict(r=np.array([0], np.int32), p=foreign.astype(np.int32),
                   hop=np.array([1], np.int32),
                   ready=np.array([50], np.int32))
    before = {k: rank.carry[k].clone() for k in ("hop", "ready")}
    with pytest.raises(RuntimeError, match="partition maps disagree"):
        H._inject_inbox(rank.carry, 0, [payload], rank._g2l[0], "rank 0")
    for k, v in before.items():
        assert torch.equal(rank.carry[k], v), k


def test_unknown_transport_raises():
    with pytest.raises(ValueError, match="unknown transport"):
        H.run_hybrid(W.wired_chain(), _key(), transport="pigeon",
                     device="cpu")
