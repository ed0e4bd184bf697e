"""Carry the reference's programs and kernel states into the port.

The JAX package's ``LteSmProgram`` and kernel state are numpy-able; the
port takes their numpy values (it never imports the JAX package).  This
is how the tests and a user move a scenario lowered by the reference
(``tpudes.scenarios.build_lena`` + ``lower_lte_sm``) onto the card.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from tpudes_torch.device import resolve_device
from tpudes_torch.parallel.kernels_cuda import SM_STATE
from tpudes_torch.parallel.lte_sm import LteSmProgram

#: the reference program's fields the static port reads
PROGRAM_FIELDS = (
    "gain", "serving", "tx_power_dbm", "noise_psd", "n_rb", "n_ttis",
    "scheduler", "pf_alpha",
)


def program_from_numpy(fields: Mapping) -> LteSmProgram:
    """Port program from the reference ``LteSmProgram``'s numpy fields
    (:data:`PROGRAM_FIELDS`)."""
    return LteSmProgram(
        gain=np.asarray(fields["gain"], dtype=np.float64),
        serving=np.asarray(fields["serving"], dtype=np.int32),
        tx_power_dbm=np.asarray(fields["tx_power_dbm"], dtype=np.float64),
        noise_psd=float(fields["noise_psd"]),
        n_rb=int(fields["n_rb"]),
        n_ttis=int(fields["n_ttis"]),
        scheduler=str(fields["scheduler"]),
        pf_alpha=float(fields["pf_alpha"]),
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

