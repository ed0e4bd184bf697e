"""Study descriptors: what the coalescing scheduler needs to know.

A copy of ``tpudes/serving/descriptor.py`` (``StudyDescriptor`` at
``:66``, ``mesh_fingerprint`` at ``:54``) for the port.  A *study* is one
client-requested simulation: a program plus its key, replica count and
device.  Two studies whose programs differ only in the engine's sweep
operand (scheduler id, TCP variant assignment, BSS horizon, AS load
scale) ride one config-axis launch, the results demultiplexed per study,
each equal to its solo run.  Each engine owns a ``*_study`` function
returning a :class:`StudyDescriptor`:

- ``coalesce_key`` — everything that must match for two studies to share
  a launch: the program's static fields, the shared launch bound where
  the engine has one, the key's bytes, the replica count, the mesh and
  the device;
- ``sweep_point`` — this study's value of the sweep operand;
- ``launch(points, block=False)`` — one point through the engine's plain
  entry, several through its config-axis sweep, as one launch;
- ``warm(n_points)`` — a short run of the batch size, which fills the
  runner cache and builds the kernels;
- ``solo`` — True marks a study the sweep cannot serve equal to its solo
  run (a dumbbell program whose ``ecn`` disagrees with its variants'
  ``REQUIRES_ECN`` flags); it is never batched;
- ``spec`` — the picklable description a routed member would rebuild the
  study from; None until A12 ports the router.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

__all__ = ["StudyDescriptor", "mesh_fingerprint"]


def mesh_fingerprint(mesh) -> tuple | None:
    """Hashable identity of a mesh for the coalesce key (two studies
    must target the same device set to share a launch)."""
    if mesh is None:
        return None
    return (
        tuple(mesh.axis_names),
        tuple(d.id for d in mesh.devices.flat),
    )


@dataclass(frozen=True)
class StudyDescriptor:
    """One submitted study, as the coalescing scheduler sees it."""

    engine: str
    coalesce_key: tuple
    sweep_point: Any
    launch: Callable  # (points, block=False) -> result | EngineFuture
    warm: Callable = None  # (n_points) -> None, blocking mini-compile
    solo: bool = field(default=False)
    #: picklable launch spec for cross-process routing (None = local)
    spec: dict | None = field(default=None, compare=False)

    def compatible(self, other: "StudyDescriptor") -> bool:
        """True when ``self`` and ``other`` may share one launch."""
        return (
            not self.solo
            and not other.solo
            and self.engine == other.engine
            and self.coalesce_key == other.coalesce_key
        )
