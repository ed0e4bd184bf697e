"""Checkpoint and resume of chunked engine runs.

Counterpart of ``tpudes/parallel/checkpoint.py``.  Every engine's carry
is its whole simulation state, so saving it after each completed chunk
makes a long run resumable: a run killed between chunks restarts from
its last completed chunk, and because every draw is a pure function of
its step and replica, the resumed run is bit-equal to an uninterrupted
one.

    run_lte_sm(prog, key, replicas=64, chunk_ttis=1000,
               checkpoint="study.ckpt")
    # ... killed between chunks ...
    run_lte_sm(prog, key, replicas=64, chunk_ttis=1000,
               checkpoint="study.ckpt")   # resumes, finishes bit-equal

Format: one pickle file (written to a temporary name, then renamed)
holding the carry copied back as numpy, a per-leaf marker of the leaves
that carry the padded replica axis at the engine's replica position
(axis 1: the port's carries are ``(C, R, ...)``), the bucket size at the
save, and a fingerprint of what the carry's meaning depends on (engine,
key bytes, replica count, config axis, obs mode, the engine's static
program key).  A resume restores it onto the run's device: verbatim when
the bucket is unchanged, and across a ``TPUDES_BUCKETING`` flip with the
marked leaves resized (the real rows kept, the pad rows copies of the
last real one: pad rows are independent replicas whose results are
sliced off).  A changed chunk schedule, another study's file and a
corrupt file are refused with :class:`CheckpointError`.

Chaos hook: after each save the ``checkpoint_save`` site fires (tag: the
engine's name), so a seed-keyed :class:`~tpudes_torch.chaos.
ChaosSchedule` can kill the run between chunks.
"""

from __future__ import annotations

import hashlib
import os
import pickle
from dataclasses import dataclass

import numpy as np

from tpudes_torch.parallel.runtime import to_host, tree_map

__all__ = ["CarryCheckpoint", "CheckpointError", "checkpoint_ctx"]

_VERSION = 1


class CheckpointError(RuntimeError):
    """A checkpoint file cannot serve this run: fingerprint mismatch
    (another program, key, replica count or sweep), a changed chunk
    schedule, or a corrupt or foreign file (``checkpoint.py:61``).
    Delete the file, or pass a fresh path, to start over."""


def _key_bytes(key) -> bytes:
    import torch

    if isinstance(key, torch.Tensor):
        key = key.cpu()
    return np.asarray(key, np.int64).tobytes()


def _tree_map2(fn, tree, other):
    """``fn(leaf, other_leaf)`` over two trees of one structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_map2(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map2(fn, v, o) for v, o in zip(tree, other))
    return fn(tree, other)


class CarryCheckpoint:
    """One resumable run's carry slot, one file (``checkpoint.py:110``)."""

    def __init__(self, path):
        self.path = str(path)

    def exists(self) -> bool:
        return os.path.exists(self.path)

    def remove(self) -> None:
        if self.exists():
            os.remove(self.path)

    # --- the engine side (driven by runtime.drive_chunks) ---------------

    def save(self, ctx: "_CkptCtx", bound: int, bounds, carry) -> None:
        """Save the carry after the chunk ending at ``bound`` (copies it
        back, a synchronise; atomic on the filesystem).  The chaos
        ``checkpoint_save`` site fires after the file is in place, so an
        injected kill always leaves a resumable state."""
        host = to_host(carry)
        markers = None
        if ctx.r_pad is not None:
            markers = tree_map(
                lambda v: bool(isinstance(v, np.ndarray)
                               and v.ndim > ctx.axis
                               and v.shape[ctx.axis] == ctx.r_pad),
                host)
        doc = {
            "version": _VERSION,
            "fingerprint": ctx.fingerprint,
            "engine": ctx.engine,
            "bound": int(bound),
            "bounds": [int(b) for b in bounds],
            "replicas": ctx.replicas,
            "r_pad": ctx.r_pad,
            "replica_leaf": markers,
            "carry": host,
        }
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(doc, f)
        os.replace(tmp, self.path)
        from tpudes_torch.obs.serving import ServingTelemetry

        ServingTelemetry.record_checkpoint("save")
        from tpudes_torch.chaos import maybe_fail

        maybe_fail("checkpoint_save", what="checkpoint", tag=ctx.engine)

    def restore(self, ctx: "_CkptCtx", bounds):
        """The saved carry on the run's device, resized to the run's
        bucket: ``(done_bound, carry)``, or None where no file exists.
        Refuses (:class:`CheckpointError`) a file whose fingerprint or
        chunk schedule is not this run's, or that cannot be read."""
        if not self.exists():
            return None
        try:
            with open(self.path, "rb") as f:
                doc = pickle.load(f)
        except Exception as e:  # noqa: BLE001 - a corrupt file: loud stop
            raise CheckpointError(
                f"{self.path}: unreadable checkpoint ({e})"
            ) from e
        if not isinstance(doc, dict) or doc.get("version") != _VERSION:
            raise CheckpointError(
                f"{self.path}: checkpoint version "
                f"{doc.get('version') if isinstance(doc, dict) else None} "
                f"!= {_VERSION}"
            )
        if doc.get("fingerprint") != ctx.fingerprint:
            raise CheckpointError(
                f"{self.path}: fingerprint mismatch — this checkpoint "
                "belongs to a different study (program, key, replicas, "
                "sweep points, or obs mode changed)"
            )
        if doc.get("bounds") != [int(b) for b in bounds]:
            raise CheckpointError(
                f"{self.path}: chunk schedule changed "
                f"({doc.get('bounds')} != {[int(b) for b in bounds]}); "
                "resume with the same chunk size or start fresh"
            )
        import torch

        carry = tree_map(
            lambda v: (torch.from_numpy(np.ascontiguousarray(v)).to(
                ctx.device) if isinstance(v, np.ndarray) else v),
            self._rebucket(doc, ctx))
        from tpudes_torch.obs.serving import ServingTelemetry

        ServingTelemetry.record_checkpoint("restore")
        return int(doc["bound"]), carry

    def _rebucket(self, doc: dict, ctx: "_CkptCtx"):
        """The saved carry resized to the run's bucket: verbatim where
        the bucket is unchanged; else only the leaves marked at the save
        as replica-bearing are resized, the real rows kept and the pad
        rows copies of the last real row (``checkpoint.py:211``)."""
        host = doc["carry"]
        saved_r_pad = doc.get("r_pad")
        if ctx.r_pad == saved_r_pad:
            return host
        if ctx.r_pad is None or saved_r_pad is None:
            raise CheckpointError(
                f"{self.path}: replica-axis presence changed between "
                "save and resume"
            )
        idx = np.minimum(np.arange(ctx.r_pad), ctx.replicas - 1)

        def resize(v, is_replica):
            if not is_replica:
                return v
            return np.take(np.asarray(v), idx, axis=ctx.axis)

        return _tree_map2(resize, host, doc["replica_leaf"])


@dataclass
class _CkptCtx:
    """What :func:`~tpudes_torch.parallel.runtime.drive_chunks` needs to
    save and restore one run."""

    ckpt: CarryCheckpoint
    engine: str
    fingerprint: str
    replicas: int | None
    r_pad: int | None
    axis: int
    device: object = None


def checkpoint_ctx(checkpoint, *, engine: str, key, replicas: int | None,
                   r_pad: int | None, n_cfg: int | None, obs: bool,
                   axis: int, device=None, extra: tuple = ()):
    """The :func:`~tpudes_torch.parallel.runtime.drive_chunks` checkpoint
    context of a run (None passes through; ``checkpoint.py:256``).
    ``checkpoint`` is a path or a :class:`CarryCheckpoint`; ``extra`` the
    engine's static identity (its program key and sweep points): what,
    changed, would make the saved carry another study's."""
    if checkpoint is None:
        return None
    ckpt = (checkpoint if isinstance(checkpoint, CarryCheckpoint)
            else CarryCheckpoint(checkpoint))
    ident = repr((
        engine,
        _key_bytes(key).hex(),
        None if replicas is None else int(replicas),
        None if n_cfg is None else int(n_cfg),
        bool(obs),
        extra,
    ))
    fp = hashlib.sha256(ident.encode()).hexdigest()
    return _CkptCtx(
        ckpt, engine, fp,
        None if replicas is None else int(replicas),
        None if r_pad is None else int(r_pad),
        int(axis), device,
    )
