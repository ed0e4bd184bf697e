"""The engine runtime: runner cache, replica buckets, submitted runs and
the chunk drive, shared by every device engine of the port.

Counterpart of ``tpudes/parallel/runtime.py``:

- :class:`EngineRuntime` / :data:`RUNTIME` (``runtime.py:379``): one
  process-wide runner registry with true LRU eviction (a hit moves the
  entry to the back of the eviction order).  A runner holds what is a
  pure function of its key — host tables, constants, the kernels' packed
  table blobs and their device copies — and a launch never writes into
  it, so a hit changes only the host's work, never what the card does.
- **Replica buckets** (:func:`bucket_replicas`, ``:115``): the replica
  axis is padded to the next power of two and the results are sliced
  back.  Padding is exact: every engine draws replica ``r``'s numbers
  from ``fold_in(key, r)`` (or a pure function of ``(key, t, r)``), so a
  real replica's outcome cannot move.  ``TPUDES_BUCKETING=0`` turns it
  off.  The mesh rounding waits for A12.
- **Submitted runs** (:class:`EngineFuture`, ``:319``): every ``run_*``
  takes ``block=False`` and returns a future holding the run's device
  outputs and a ``torch.cuda.Event`` recorded on the stream that
  launched the run; the copy back and the unpack happen in
  :meth:`EngineFuture.result`.  :meth:`EngineRuntime.submit` bounds the
  runs in flight (``TPUDES_INFLIGHT``, default 4).
- **The chunk drive** (:func:`drive_chunks`, ``:166``): one launch per
  chunk bound, the carry handed from chunk to chunk, with a
  :mod:`~tpudes_torch.parallel.checkpoint` saved after every chunk when
  one is given.

Not ported: ``donate_argnums`` and ``configure_persistent_cache`` are
XLA's (the kernel build directory ``tpudes_torch/build`` that
``_build.py`` keeps is the persistent cache's counterpart), and
``shard_replica_axis`` waits for A12.
"""

from __future__ import annotations

import os
from collections import OrderedDict

__all__ = [
    "RUNTIME",
    "EngineFuture",
    "EngineRuntime",
    "bucket_replicas",
    "bucketing_enabled",
    "chunk_bounds",
    "drive_chunks",
    "finalize_with_flush",
    "inflight_window",
    "pow2_bucket",
    "to_host",
    "tree_map",
    "unstack_points",
]


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to tpudes_torch yet (ROADMAP {item})"
    )


def bucketing_enabled() -> bool:
    """Replica buckets are on unless ``TPUDES_BUCKETING`` says otherwise
    (read per call, ``runtime.py:98``)."""
    raw = os.environ.get("TPUDES_BUCKETING")
    if raw is None:
        return True
    return raw.strip().lower() not in {"0", "false", "no", "off"}


def pow2_bucket(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    n = int(n)
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


def bucket_replicas(replicas: int | None) -> int | None:
    """The padded replica-axis size: the next power of two under
    bucketing, else ``replicas``; ``None`` (no replica axis) passes
    through (``runtime.py:115``, without the mesh rounding)."""
    if replicas is None:
        return None
    r = int(replicas)
    return pow2_bucket(r) if bucketing_enabled() else r


def inflight_window() -> int:
    """Bound on submitted runs in flight (``TPUDES_INFLIGHT``, default 4,
    floor 1; read per call, ``runtime.py:142``)."""
    raw = os.environ.get("TPUDES_INFLIGHT")
    if not raw:
        return 4
    try:
        return max(1, int(raw))
    except ValueError:
        return 4


def chunk_bounds(total: int, chunk: int) -> list[int]:
    """Segment end-bounds covering ``[0, total)`` in ``chunk``-sized
    pieces: ``chunk_bounds(10, 4) == [4, 8, 10]``; a non-positive or
    oversized chunk is one segment (``runtime.py:155``)."""
    total, chunk = int(total), int(chunk)
    if chunk <= 0 or chunk >= total:
        return [total]
    return list(range(chunk, total, chunk)) + [total]


def drive_chunks(engine: str, bounds, carry, launch, obs: bool = False,
                 checkpoint=None):
    """The chunk protocol every engine runs (``runtime.py:166``): one
    ``launch(carry, bound) -> carry`` per bound, each counted by
    :meth:`EngineRuntime.record_launch`.  Returns ``(carry, flush)``;
    ``flush`` is the deferred last-chunk metrics record of the
    reference's ``obs`` arm, which is not ported (A10), so always None.

    ``checkpoint`` (a :func:`~tpudes_torch.parallel.checkpoint.
    checkpoint_ctx` result) saves the carry after every completed chunk
    and, when a matching checkpoint exists, skips the completed chunks
    and resumes from the restored carry: bit-equal to an uninterrupted
    run, since every engine's draws are pure in their step and replica.
    Each save copies the carry back, a synchronise a chunk."""
    if obs:
        raise _not_ported("the TpudesObs chunk stream", "A10")
    bounds = list(bounds)
    start = 0
    if checkpoint is not None:
        restored = checkpoint.ckpt.restore(checkpoint, bounds)
        if restored is not None:
            done_bound, carry = restored
            start = bounds.index(done_bound) + 1
    for bound in bounds[start:]:
        carry = launch(carry, bound)
        RUNTIME.record_launch(engine)
        if checkpoint is not None:
            checkpoint.ckpt.save(checkpoint, bound, bounds, carry)
    return carry, None


def finalize_with_flush(flush, finalize):
    """Chain the deferred last-chunk flush in front of an
    :class:`EngineFuture` finalize (identity when there is nothing to
    flush; ``runtime.py:223``)."""
    if flush is None:
        return finalize

    def wrapped(host):
        flush()
        return finalize(host)

    return wrapped


def unstack_points(n_cfg: int | None, unpack_one, shared=()):
    """The :class:`EngineFuture` ``finalize`` of a run with a leading
    config axis (``runtime.py:236``): without one (``n_cfg`` None) the
    host tree unpacks directly; with one, each point's slice of the
    leading axis unpacks on its own (``shared`` names keys without it)."""

    def finalize(host):
        if n_cfg is None:
            return unpack_one(host)
        return [
            unpack_one({k: (v if k in shared else v[i])
                        for k, v in host.items()})
            for i in range(n_cfg)
        ]

    return finalize


def _tree_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tree_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tree_leaves(v)
    else:
        yield tree


def tree_map(fn, tree):
    """``fn`` over the leaves of a dict/list/tuple tree (None passes)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def to_host(tree):
    """The tree with every tensor copied back as numpy (other leaves as
    they are)."""
    import torch

    return tree_map(
        lambda v: v.cpu().numpy() if isinstance(v, torch.Tensor) else v,
        tree)


def _cuda_device(tree):
    import torch

    for leaf in _tree_leaves(tree):
        if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda":
            return leaf.device
    return None


class EngineFuture:
    """Handle to one launched engine run (``run_*(..., block=False)``,
    ``runtime.py:319``).

    Holds the run's device outputs, the engine's ``finalize`` (slice the
    padded replicas, unstack the config points, rebuild wide counters)
    and, for a run on the card, a ``torch.cuda.Event`` recorded on the
    current stream when the future is made, after the run's launches.
    :meth:`done` queries the event (True on the CPU); :meth:`result`
    waits on it, copies the outputs back and finalizes, once."""

    __slots__ = ("engine", "_device_out", "_finalize", "_result", "_done",
                 "_runtime", "_event")

    def __init__(self, engine: str, device_out, finalize):
        import torch

        self.engine = engine
        self._device_out = device_out
        self._finalize = finalize
        self._result = None
        self._done = False
        self._runtime: "EngineRuntime | None" = None
        self._event = None
        dev = _cuda_device(device_out)
        if dev is not None:
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(dev))

    def done(self) -> bool:
        """True once the device work has finished (never blocks)."""
        if self._done or self._event is None:
            return True
        return bool(self._event.query())

    def block(self) -> "EngineFuture":
        """Wait for the device work without copying back."""
        if not self._done and self._event is not None:
            self._event.synchronize()
        return self

    def result(self):
        """Copy back and finalize; memoised.  Retires from the runtime's
        in-flight window even when the finalize raises, so a poisoned
        future cannot jam later submits."""
        if not self._done:
            try:
                self.block()
                self._result = self._finalize(to_host(self._device_out))
            finally:
                if self._runtime is not None:
                    self._runtime._retire(self)
            self._device_out = None  # release the device buffers
            self._done = True
        return self._result


class EngineRuntime:
    """Process-wide runner registry shared by every engine
    (``runtime.py:379``): entries keyed ``(engine, *key)``, evicted true
    LRU; the bounded in-flight window of submitted runs; launch counts
    per engine."""

    def __init__(self, capacity: int = 64):
        self.capacity = int(capacity)
        self._runners: OrderedDict[tuple, object] = OrderedDict()
        self.hits = 0
        self.misses = 0
        self._inflight: list[EngineFuture] = []
        self.submitted = 0
        self.retired = 0
        self.max_in_flight = 0
        self._launches: dict[str, int] = {}

    def runner(self, engine: str, key: tuple, build):
        """``(value, built_new)``: the cached runner for ``(engine,
        *key)``, built (a miss) when absent."""
        full = (engine, *key)
        hit = self._runners.get(full)
        if hit is not None:
            self._runners.move_to_end(full)
            self.hits += 1
            return hit, False
        self.misses += 1
        value = build()
        self._runners[full] = value
        while len(self._runners) > self.capacity:
            self._runners.popitem(last=False)
        return value, True

    def size(self, engine: str | None = None) -> int:
        """Resident runners, all or one engine's."""
        if engine is None:
            return len(self._runners)
        return sum(1 for k in self._runners if k[0] == engine)

    def clear(self, engine: str | None = None) -> None:
        """Drop cached runners (all, or one engine's).  A full clear also
        zeroes the submit and launch counts, not the hits and misses, as
        the reference's does (in-flight futures stay valid: they hold
        their own buffers)."""
        if engine is None:
            self._runners.clear()
            self.submitted = self.retired = self.max_in_flight = 0
            self._inflight = []
            self._launches = {}
            return
        for k in [k for k in self._runners if k[0] == engine]:
            del self._runners[k]

    # --- submitted runs --------------------------------------------------

    def submit(self, run_fn, *args, **kwargs) -> EngineFuture:
        """``run_fn(*args, block=False, **kwargs)`` tracked in the bounded
        in-flight window: at the window, the oldest future is retired
        first (copy back and unpack), before anything new is launched."""
        window = inflight_window()
        while len(self._inflight) >= window:
            self._inflight[0].result()  # retires itself
        fut = run_fn(*args, block=False, **kwargs)
        if not isinstance(fut, EngineFuture):
            raise TypeError(
                f"{getattr(run_fn, '__name__', run_fn)!r} did not return "
                "an EngineFuture under block=False — only the engines' "
                "run_* entry points are submittable"
            )
        fut._runtime = self
        self._inflight.append(fut)
        self.submitted += 1
        self.max_in_flight = max(self.max_in_flight, len(self._inflight))
        return fut

    def _retire(self, fut: EngineFuture) -> None:
        try:
            self._inflight.remove(fut)
        except ValueError:
            return  # already retired (result() is memoised)
        self.retired += 1

    def drain(self) -> None:
        """Retire every outstanding future, in submission order."""
        while self._inflight:
            self._inflight[0].result()

    def poll(self) -> int:
        """Retire every in-flight future whose device work has finished,
        without blocking; the number retired."""
        n = 0
        for fut in list(self._inflight):
            if fut.done():
                fut.result()
                n += 1
        return n

    def record_launch(self, engine: str, n: int = 1) -> None:
        """Count one launch of ``engine``'s chunk (or window)."""
        self._launches[engine] = self._launches.get(engine, 0) + int(n)

    def launches(self, engine: str) -> int:
        return self._launches.get(engine, 0)

    def stats(self) -> dict:
        """Hit and miss counts, residency per engine, the window's
        counts and the launches (the reference's keys)."""
        per_engine: dict[str, int] = {}
        for k in self._runners:
            per_engine[k[0]] = per_engine.get(k[0], 0) + 1
        return {
            "hits": self.hits,
            "misses": self.misses,
            "resident": len(self._runners),
            "per_engine": per_engine,
            "submitted": self.submitted,
            "retired": self.retired,
            "in_flight": len(self._inflight),
            "max_in_flight": self.max_in_flight,
            "launches": dict(self._launches),
        }


#: the one registry every engine routes through
RUNTIME = EngineRuntime()
