"""StudyServer: continuous batching of independently arriving studies.

Counterpart of ``tpudes/serving/server.py`` (``StudyServer`` at ``:177``),
in full for the in-process server (the reference's ``router=`` that fans
batches out to member processes waits for A12).  Clients call
:meth:`StudyServer.submit_study` and get a :class:`StudyHandle` back at
once; a coalescing scheduler drains the request queue and merges
compatible studies — same engine, same coalesce key, differing only in
the engine's sweep operand (scheduler id, TCP variant assignment, BSS
horizon, AS load scale) — into one config-axis launch through
:data:`tpudes_torch.parallel.runtime.RUNTIME`, demultiplexing each
study's result back through its handle.  The engines' sweeps equal their
per-point runs, and only studies whose coalesce keys match are merged,
so a coalesced result is the solo result.

Operating behaviour, as the reference's:

- **Batching deadline** (``max_wait_s``): the head study waits at most
  this long for batchmates; a lone study goes alone at the deadline.
- **SLO classes** (``slo=``, :data:`SLO_CLASSES`): the due head is picked
  by (priority, arrival), and ``gold`` preempts coalesce-pending work: a
  gold head goes at once with whatever batchmates are queued.
  ``slo_targets`` feed the attainment telemetry.
- **Admission**: a per-tenant cap on queued and in-flight studies
  (:class:`AdmissionError`), in front of the runtime's in-flight window
  (``TPUDES_INFLIGHT``).
- **Fault tolerance**: a batch that hits a transient fault
  (:class:`~tpudes_torch.chaos.ChaosInjected`, the launch-shaped error
  the chaos schedule plants) is requeued under
  a per-study ``retry_budget`` with exponential ``retry_backoff_s``; past
  the budget the handle raises
  :class:`~tpudes_torch.serving.errors.RetryBudgetError`.  Any other
  error poisons only that batch's handles; the scheduler never dies.
- **pow2 batch buckets**: a coalesced batch pads its config axis to the
  next power of two by duplicating the tail point (results dropped).
- **Warm pool** (:meth:`warm`): short runs of the hot engines and batch
  sizes at start, which build the kernels and fill the runner cache.
- **Metrics**: :class:`tpudes_torch.obs.serving.ServingTelemetry`.

Threading: all device work (launch, copy back, unpack) happens on the
scheduler thread, or on the caller's through :meth:`pump` with
``start=False`` (the deterministic mode the tests use).  Launches go to
the scheduler thread's current CUDA stream, on the device each study's
descriptor names (studies carry their device explicitly, as the thread
is not the caller's).
"""

from __future__ import annotations

import importlib
import itertools
import threading
import time
from dataclasses import dataclass, field
from collections import deque

from tpudes_torch.obs.serving import ServingTelemetry
from tpudes_torch.serving.descriptor import StudyDescriptor
from tpudes_torch.serving.errors import RetryBudgetError

__all__ = [
    "SLO_CLASSES",
    "AdmissionError",
    "StudyHandle",
    "StudyServer",
]


class AdmissionError(RuntimeError):
    """The tenant's queued+in-flight study cap is exhausted; retry
    after some of its studies complete."""


#: SLO class -> scheduling priority (lower dispatches first).  ``gold``
#: additionally preempts coalesce-pending work (see module docstring).
SLO_CLASSES = {"gold": 0, "standard": 1, "batch": 2}

#: classes whose head never waits out the batching deadline
_PREEMPT = frozenset({"gold"})

#: default per-class latency targets (seconds) for SLO attainment —
#: deliberately loose; operators pass ``slo_targets=`` for real fleets
DEFAULT_SLO_TARGETS = {
    "gold": 2.0, "standard": 30.0, "batch": float("inf"),
}

#: engine name -> (module, study-descriptor extraction function); the
#: lazy import keeps tpudes_torch.serving importable without pulling
#: every engine in at module import
_ENGINE_STUDY = {
    "bss": ("tpudes_torch.parallel.replicated", "bss_study"),
    "lte_sm": ("tpudes_torch.parallel.lte_sm", "lte_sm_study"),
    "dumbbell": ("tpudes_torch.parallel.tcp_dumbbell", "tcp_study"),
    "as_flows": ("tpudes_torch.parallel.as_flows", "as_study"),
}


class StudyHandle:
    """Client-side future for one submitted study."""

    def __init__(self, engine: str, tenant: str, slo: str = "standard"):
        self.engine = engine
        self.tenant = tenant
        self.slo = slo
        #: how many real studies shared this study's launch (set at
        #: completion; 1 means it was dispatched alone)
        self.batch_size: int | None = None
        self._ev = threading.Event()
        self._result = None
        self._error: BaseException | None = None

    def done(self) -> bool:
        return self._ev.is_set()

    def result(self, timeout: float | None = None):
        """Block until the study completes; raises the launch error if
        its batch failed, TimeoutError past ``timeout``."""
        if not self._ev.wait(timeout):
            raise TimeoutError(
                f"study ({self.engine}, tenant={self.tenant!r}) not "
                f"complete within {timeout} s"
            )
        if self._error is not None:
            raise self._error
        return self._result

    def _complete(self, result=None, error=None, batch_size=None) -> None:
        self._result = result
        self._error = error
        self.batch_size = batch_size
        self._ev.set()


@dataclass
class _Request:
    desc: StudyDescriptor
    tenant: str
    handle: StudyHandle
    t_submit: float
    slo: str = "standard"
    priority: int = 1
    preempt: bool = False
    seq: int = 0
    #: requeue state: attempts so far + earliest redispatch
    retries: int = 0
    t_ready: float = field(default=0.0)


def _pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


class StudyServer:
    """The coalescing scheduler + its request queue (module docstring
    has the big picture)."""

    def __init__(
        self,
        *,
        max_wait_s: float = 0.01,
        max_batch: int = 8,
        tenant_cap: int = 64,
        warm: list | None = None,
        start: bool = True,
        retry_budget: int = 3,
        retry_backoff_s: float = 0.05,
        slo_targets: dict | None = None,
    ):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.max_wait_s = float(max_wait_s)
        self.max_batch = int(max_batch)
        self.tenant_cap = int(tenant_cap)
        #: bounded retries per study for transient faults (chaos-injected
        #: launch errors); exceeded -> RetryBudgetError
        self.retry_budget = int(retry_budget)
        #: base backoff before a requeued batch redispatches (doubles
        #: per retry); force-pump/close ignore it so drains terminate
        self.retry_backoff_s = float(retry_backoff_s)
        self.slo_targets = dict(DEFAULT_SLO_TARGETS)
        if slo_targets:
            self.slo_targets.update(slo_targets)
        self._cond = threading.Condition()
        self._queue: deque[_Request] = deque()
        #: dispatched launches not yet demuxed: (future, batch, t0)
        self._pending: deque[tuple] = deque()
        self._tenant_load: dict[str, int] = {}
        self._seq = itertools.count()
        self._running = False
        self._closed = False
        self._thread: threading.Thread | None = None
        if warm:
            self.warm(warm)
        if start:
            self.start()

    # --- client surface ---------------------------------------------------

    def submit_study(
        self,
        engine: str,
        prog,
        key,
        replicas=None,
        *,
        mesh=None,
        tenant: str = "default",
        slo: str = "standard",
        **engine_kwargs,
    ) -> StudyHandle:
        """Queue one study; returns immediately with its handle.

        ``engine`` is one of ``bss`` / ``lte_sm`` / ``dumbbell`` /
        ``as_flows``; ``prog`` the engine's lowered Program dataclass;
        ``key``/``replicas``/``mesh`` exactly what the engine's
        ``run_*`` entry takes.  ``slo`` picks the scheduling class
        (:data:`SLO_CLASSES`).  Extra ``engine_kwargs`` flow to the
        engine's study extractor (e.g. ``rate_scale=`` for the AS
        engine).  Raises :class:`AdmissionError` when ``tenant``
        already has ``tenant_cap`` studies queued or in flight."""
        mod_name, fn_name = _ENGINE_STUDY[engine]
        extract = getattr(importlib.import_module(mod_name), fn_name)
        desc = extract(prog, key, replicas, mesh=mesh, **engine_kwargs)
        return self.submit(desc, tenant=tenant, slo=slo)

    def submit(self, desc: StudyDescriptor, tenant: str = "default",
               slo: str = "standard") -> StudyHandle:
        """Queue a pre-extracted :class:`StudyDescriptor`."""
        if slo not in SLO_CLASSES:
            raise ValueError(
                f"unknown SLO class {slo!r} (have {sorted(SLO_CLASSES)})"
            )
        handle = StudyHandle(desc.engine, tenant, slo)
        with self._cond:
            if self._closed:
                # a closed server never strands a handle — including
                # one a racing submit would otherwise enqueue after
                # the drain
                raise RuntimeError("StudyServer is closed")
            if self._tenant_load.get(tenant, 0) >= self.tenant_cap:
                ServingTelemetry.record_reject(tenant)
                raise AdmissionError(
                    f"tenant {tenant!r} has {self.tenant_cap} studies "
                    "queued/in flight (tenant_cap)"
                )
            self._tenant_load[tenant] = self._tenant_load.get(tenant, 0) + 1
            self._queue.append(_Request(
                desc, tenant, handle, time.monotonic(), slo=slo,
                priority=SLO_CLASSES[slo], preempt=slo in _PREEMPT,
                seq=next(self._seq),
            ))
            ServingTelemetry.record_submit(desc.engine, len(self._queue))
            self._cond.notify_all()
        return handle

    def metrics(self) -> dict:
        """Snapshot of the process-global serving telemetry (see
        :func:`tpudes_torch.obs.serving.validate_serving_metrics`)."""
        return ServingTelemetry.snapshot()

    # --- warm pool --------------------------------------------------------

    def warm(self, studies: list, buckets: tuple | None = None) -> int:
        """Pre-compile the executables the given example studies will
        need: for each distinct coalesce key, the plain single-study
        program plus each pow2 config-axis bucket up to the one
        ``max_batch`` pads into (the default ``buckets``) — so no batch
        size the server can ever dispatch pays a fresh compile on the
        serving path.  ``studies`` holds :class:`StudyDescriptor`
        objects or dicts of :meth:`submit_study` keyword arguments.
        Returns the number of warm launches performed (each a
        minimal-horizon run, which builds the kernels and fills the
        runner cache)."""
        top = _pow2(max(1, self.max_batch))
        if buckets is None:
            buckets = tuple(1 << i for i in range(top.bit_length()))
        n = 0
        seen: set = set()
        t0 = time.monotonic()
        for study in studies:
            desc = study
            if isinstance(study, dict):
                kw = dict(study)
                mod_name, fn_name = _ENGINE_STUDY[kw.pop("engine")]
                extract = getattr(
                    importlib.import_module(mod_name), fn_name
                )
                desc = extract(
                    kw.pop("prog"), kw.pop("key"),
                    kw.pop("replicas", None), **kw,
                )
            if desc.warm is None or desc.coalesce_key in seen:
                continue
            seen.add(desc.coalesce_key)
            for b in buckets if not desc.solo else (1,):
                if b > top:
                    continue
                desc.warm(int(b))
                n += 1
        if n:
            ServingTelemetry.record_warm(
                "all", n, time.monotonic() - t0
            )
        return n

    # --- scheduler --------------------------------------------------------

    def start(self) -> None:
        """Start the background scheduler thread (idempotent)."""
        with self._cond:
            if self._running:
                return
            self._running = True
        self._thread = threading.Thread(
            target=self._loop, name="tpudes-study-server", daemon=True
        )
        self._thread.start()

    def close(self) -> None:
        """Stop the scheduler, force-dispatching and completing every
        queued/in-flight study first (a closed server never strands a
        handle — a study mid-retry either completes or surfaces its
        RetryBudgetError)."""
        thread = self._thread
        with self._cond:
            self._running = False
            self._closed = True
            self._cond.notify_all()
        if thread is not None:
            thread.join()
            self._thread = None
        else:
            self.pump(force=True)  # start=False server: drain inline

    def pump(self, force: bool = True) -> int:
        """Synchronously dispatch what is due (everything queued when
        ``force`` — including batches still backing off) and demux
        every completed launch, following requeues until the queue
        drains — the deterministic single-thread mode (``start=False``);
        returns the number of studies completed.  Must not be called
        while the background thread runs."""
        done = 0
        while True:
            with self._cond:
                batch = self._take_batch(force=force)
            if batch is not None:
                self._dispatch(batch)
                continue
            if self._pending:
                done += self._demux_oldest()
                continue
            with self._cond:
                if not (force and self._queue):
                    break
            # a racing client submit landed between the lock drops
            # (force mode always takes a batch from a settled queue) —
            # yield briefly and re-take
            time.sleep(0.001)
        return done

    def _loop(self) -> None:
        from tpudes_torch.parallel.runtime import RUNTIME

        while True:
            batch = None
            with self._cond:
                if (
                    not self._running
                    and not self._queue
                    and not self._pending
                ):
                    return
                batch = self._take_batch(force=not self._running)
                if batch is None and self._queue and self._running:
                    # head not due: sleep until its deadline, a retry
                    # backoff expiring, or a new arrival — bounded so
                    # the loop keeps sweeping pending work
                    self._cond.wait(timeout=self._nap_s())
                    batch = self._take_batch(force=not self._running)
                elif batch is None and not self._pending and self._running:
                    self._cond.wait(timeout=0.05)
            if batch is not None:
                try:
                    self._dispatch(batch)
                except Exception as e:  # noqa: BLE001 - hardening: an
                    # escaped dispatch error fails THIS batch's handles,
                    # never the scheduler thread
                    self._finish_batch(batch, error=e, n_real=len(batch))
                try:
                    RUNTIME.poll()  # sweep the window, never blocks
                except Exception:  # noqa: BLE001 - a poisoned window
                    # future resurfaces via its own demux
                    ServingTelemetry.record_backstop()
            # demux finished launches; a blocking result() on live work
            # would serialize the scheduler, so while running we only
            # retire what is ready
            try:
                while self._pending and self._pending[0][0].done():
                    self._demux_oldest()
            except Exception:  # noqa: BLE001 - _demux_oldest poisons
                # per-batch; this is the loop's counted backstop
                ServingTelemetry.record_backstop()
            if batch is None and self._pending and not self._queue:
                if self._running:
                    with self._cond:
                        if self._running and not self._queue:
                            self._cond.wait(timeout=0.002)
                else:
                    try:
                        self._demux_oldest()  # shutdown drain: block
                    except Exception:  # noqa: BLE001 - see above
                        ServingTelemetry.record_backstop()

    def _nap_s(self) -> float:
        """Scheduler nap (caller holds the lock): until the oldest
        head's batching deadline, capped so retry backoffs and pending
        sweeps stay responsive."""
        now = time.monotonic()
        ages = [now - r.t_submit for r in self._queue]
        rem = self.max_wait_s - (max(ages) if ages else 0.0)
        return min(0.05, max(0.001, rem))

    def _take_batch(self, force: bool) -> list | None:
        """Pop the due batch (caller holds the lock).  The head is the
        highest-priority (then oldest) request whose retry backoff has
        expired; due = solo study, batch full, deadline reached,
        preempting SLO class, or ``force`` (which also overrides
        backoff so drains terminate).  Batchmates are every eligible
        queued request sharing the head's coalesce key, in arrival
        order, up to ``max_batch``."""
        if not self._queue:
            return None
        now = time.monotonic()
        ready = (
            list(self._queue) if force
            else [r for r in self._queue if r.t_ready <= now]
        )
        if not ready:
            return None
        head = min(ready, key=lambda r: (r.priority, r.seq))
        if head.desc.solo:
            mates = [head]
        else:
            # the head rides FIRST: with more compatible requests than
            # max_batch queued, a plain arrival-order slice could cut
            # the priority-selected head out of the very batch its
            # preempt flag made due (gold would force-dispatch other
            # tenants' work while itself staying queued)
            mates = [head] + [
                r for r in ready
                if r is not head and r.desc.compatible(head.desc)
            ][: self.max_batch - 1]
        due = (
            force
            or head.desc.solo
            or head.preempt
            or len(mates) >= self.max_batch
            or (now - head.t_submit) >= self.max_wait_s
        )
        if not due:
            return None
        for r in mates:
            self._queue.remove(r)
        ServingTelemetry.record_queue_depth(len(self._queue))
        return mates

    def _dispatch(self, batch: list) -> None:
        """Launch one (possibly coalesced) batch through the runtime's
        bounded in-flight window.  Never raises: a transient fault (a
        chaos-injected launch error) requeues the batch under its retry
        budget; anything else poisons the batch's
        handles instead of killing the scheduler."""
        from tpudes_torch.chaos import ChaosInjected, maybe_fail
        from tpudes_torch.parallel.runtime import RUNTIME

        points = [r.desc.sweep_point for r in batch]
        n_real = len(points)
        if n_real > 1:
            # pad the config axis to the pow2 bucket by duplicating the
            # tail point: one executable per bucket, not per batch size
            points = points + [points[-1]] * (_pow2(n_real) - n_real)
        t0 = time.monotonic()
        try:
            maybe_fail(
                "local_launch", what=f"{batch[0].desc.engine} launch"
            )
            fut = RUNTIME.submit(batch[0].desc.launch, points)
        except ChaosInjected as e:
            self._requeue(batch, e)
            return
        except Exception as e:  # noqa: BLE001 - poison, don't crash
            self._finish_batch(batch, error=e, n_real=n_real)
            return
        with self._cond:
            queue_depth = len(self._queue)
        ServingTelemetry.record_dispatch(
            batch[0].desc.engine, n_real, len(points), queue_depth
        )
        self._pending.append((fut, batch, t0))

    def _demux_oldest(self) -> int:
        """Retire the oldest pending launch and complete its handles;
        a recoverable failure requeues the batch instead.  Returns the
        number of handles COMPLETED (0 on requeue)."""
        from tpudes_torch.chaos import ChaosInjected

        fut, batch, t0 = self._pending.popleft()
        engine = batch[0].desc.engine
        try:
            res = fut.result()
        except ChaosInjected as e:
            self._requeue(batch, e)
            return 0
        except Exception as e:  # noqa: BLE001 - poison, don't crash
            self._finish_batch(batch, error=e, n_real=len(batch))
            return len(batch)
        try:
            ServingTelemetry.record_launch_done(
                engine, time.monotonic() - t0
            )
            results = res if isinstance(res, list) else [res]
            now = time.monotonic()
            for r, out in zip(batch, results):  # pad tail dropped by zip
                latency = now - r.t_submit
                r.handle._complete(result=out, batch_size=len(batch))
                target = self.slo_targets.get(r.slo)
                ServingTelemetry.record_study_done(
                    engine, latency, slo=r.slo,
                    attained=target is None or latency <= target,
                )
                self._release(r.tenant)
            return len(batch)
        except Exception as e:  # noqa: BLE001 - hardening: anything
            # after a successful launch (telemetry, demux bookkeeping)
            # fails only THIS batch's still-open handles
            for r in batch:
                if not r.handle.done():
                    r.handle._complete(error=e, batch_size=len(batch))
                    self._release(r.tenant)
            return len(batch)

    def _requeue(self, batch: list, err: BaseException) -> None:
        """Put a transiently failed batch back at the queue head with
        exponential backoff; studies past their retry budget surface
        :class:`RetryBudgetError` through their handles instead."""
        now = time.monotonic()
        kept: list[_Request] = []
        dead: list[_Request] = []
        for r in batch:
            r.retries += 1
            if r.retries > self.retry_budget:
                dead.append(r)
            else:
                r.t_ready = now + self.retry_backoff_s * (
                    2 ** (r.retries - 1)
                )
                kept.append(r)
        with self._cond:
            for r in reversed(kept):
                self._queue.appendleft(r)
            self._cond.notify_all()
        if kept:
            ServingTelemetry.record_requeue(
                batch[0].desc.engine, len(kept)
            )
        for r in dead:
            ServingTelemetry.record_retry_exhausted()
            r.handle._complete(
                error=RetryBudgetError(r.retries - 1, err),
                batch_size=len(batch),
            )
            self._release(r.tenant)

    def _finish_batch(self, batch, error, n_real) -> None:
        del n_real
        for r in batch:
            r.handle._complete(error=error, batch_size=len(batch))
            self._release(r.tenant)

    def _release(self, tenant: str) -> None:
        with self._cond:
            # decrement-only (never popped): the map is bounded by the
            # distinct-tenant count, and a zero entry is a valid gauge
            self._tenant_load[tenant] = self._tenant_load.get(tenant, 1) - 1
            self._cond.notify_all()

    # --- context manager ---------------------------------------------------

    def __enter__(self) -> "StudyServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
