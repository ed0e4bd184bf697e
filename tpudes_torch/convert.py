"""Carry the reference's programs and kernel states into the port.

The JAX package's ``LteSmProgram``, its ``MobilityProgram`` and its
kernel state are numpy-able; the port takes their numpy values (it
never imports the JAX package).  This is how the tests and a user move
a scenario lowered by the reference (``tpudes.scenarios.build_lena`` +
``lower_lte_sm``) onto the card.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from tpudes_torch.device import resolve_device
from tpudes_torch.ops.mobility import MobilityProgram
from tpudes_torch.parallel.kernels_cuda import SM_STATE
from tpudes_torch.parallel.lte_sm import LteSmProgram

#: the reference program's fields the port reads
PROGRAM_FIELDS = (
    "gain", "serving", "tx_power_dbm", "noise_psd", "n_rb", "n_ttis",
    "scheduler", "pf_alpha", "geom_stride", "enb_pos", "pathloss",
)

#: the reference ``MobilityProgram``'s fields
MOBILITY_FIELDS = (
    "model", "base_pos", "velocity", "speed", "bounds", "wp_t", "wp_p",
    "seg_us", "n_seg", "mob_seed",
)


def mobility_from_numpy(fields: Mapping) -> MobilityProgram:
    """Port motion from the reference ``MobilityProgram``'s numpy
    fields (:data:`MOBILITY_FIELDS`)."""
    return MobilityProgram(
        model=str(fields["model"]),
        base_pos=np.asarray(fields["base_pos"], np.float32),
        velocity=np.asarray(fields["velocity"], np.float32),
        speed=np.asarray(fields["speed"], np.float32),
        bounds=np.asarray(fields["bounds"], np.float32),
        wp_t=np.asarray(fields["wp_t"], np.int32),
        wp_p=np.asarray(fields["wp_p"], np.float32),
        seg_us=int(fields["seg_us"]),
        n_seg=int(fields["n_seg"]),
        mob_seed=int(fields["mob_seed"]),
    )


def program_from_numpy(fields: Mapping,
                       mobility: MobilityProgram | None = None
                       ) -> LteSmProgram:
    """Port program from the reference ``LteSmProgram``'s numpy fields
    (:data:`PROGRAM_FIELDS`; the mobile ones may be missing or None for
    a static program), moving as ``mobility`` says
    (:func:`mobility_from_numpy`)."""
    enb_pos = fields.get("enb_pos")
    pathloss = fields.get("pathloss")
    return LteSmProgram(
        gain=np.asarray(fields["gain"], dtype=np.float64),
        serving=np.asarray(fields["serving"], dtype=np.int32),
        tx_power_dbm=np.asarray(fields["tx_power_dbm"], dtype=np.float64),
        noise_psd=float(fields["noise_psd"]),
        n_rb=int(fields["n_rb"]),
        n_ttis=int(fields["n_ttis"]),
        scheduler=str(fields["scheduler"]),
        pf_alpha=float(fields["pf_alpha"]),
        mobility=mobility,
        geom_stride=int(fields.get("geom_stride") or 1),
        enb_pos=None if enb_pos is None else np.asarray(enb_pos, np.float32),
        pathloss=None if pathloss is None else (
            str(pathloss[0]), *(float(v) for v in pathloss[1:])
        ),
    )


def state_from_numpy(state: Mapping, device=None) -> dict:
    """Port kernel state from a reference state dict: per-lane rows
    ``(..., 1, U)`` and columns ``(..., E, 1)`` become ``(R, U)`` and
    ``(R, E)`` (an unbatched reference state becomes ``R = 1``), on
    ``device`` (the card by default)."""
    device = resolve_device(device)
    out = {}
    for k, ax, _ in SM_STATE:
        a = np.asarray(state[k])
        a = a.reshape(-1, a.shape[-1]) if ax == "u" else a.reshape(
            -1, a.shape[-2]
        )
        out[k] = torch.tensor(a, device=device)
    return out
