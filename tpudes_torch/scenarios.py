"""The lena macro-cell grid (BASELINE config #4) as a port program.

Counterpart of ``tpudes/scenarios.py``'s ``hex_grid`` and ``build_lena``
followed by ``lower_lte_sm``, for a static or a mobile full-buffer drop,
without the host simulator: sites and UEs are plain arrays and the
lowering is the array math the reference controller runs
(``tpudes/models/lte/controller.py:266-287``).

Defaults are copies of the reference's: eNB TxPower 30 dBm
(``models/lte/phy.py:75``), UE NoiseFigure 9 dB (``phy.py:101``), 25 RBs
and Friis at 2.12 GHz (``models/lte/helper.py:33-36``), PF alpha 0.05.
The upstream drop draws from MRG32k3a; this one draws from a seeded
``torch.Generator``, so the two drops differ (the tests feed the
reference's own positions to :func:`lena_grid_program`).
:func:`lena_traffic_program` gives the static drop finite backlogs under
the ON-OFF workload of the reference's LTE traffic test.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from tpudes_torch.ops.lte import noise_psd_w
from tpudes_torch.ops.mobility import MobilityProgram, warn_geom_stride
from tpudes_torch.ops.propagation import friis
from tpudes_torch.parallel.lte_sm import LteSmProgram
from tpudes_torch.traffic.program import TrafficProgram

ENB_HEIGHT_M = 30.0
UE_HEIGHT_M = 1.5

#: the ON-OFF workload of the reference's LTE traffic test
#: (``tests/test_traffic_engines.py:148-155``): arrivals per second while
#: ON, bounded-Pareto ON periods (shape, shortest s, longest s), the mean
#: of the exponential OFF periods, bounded-Pareto packet sizes (shape,
#: smallest B, largest B) and the seed of the cycle tables
ONOFF_PEAK_PPS = 50.0
ONOFF_ON = (1.5, 0.01, 0.05)
ONOFF_OFF_MEAN_S = 0.02
ONOFF_SIZE_PARETO = (1.4, 800.0, 12000.0)
ONOFF_TR_SEED = 2


def hex_grid(n: int, spacing: float) -> list[tuple[float, float]]:
    """First n positions of a hexagonal ring layout (cell 0 centred)."""
    pos = [(0.0, 0.0)]
    ring = 1
    while len(pos) < n:
        for k in range(6 * ring):
            a = 2 * math.pi * k / (6 * ring)
            pos.append(
                (ring * spacing * math.cos(a), ring * spacing * math.sin(a))
            )
            if len(pos) >= n:
                break
        ring += 1
    return pos[:n]


def lena_ue_drop(
    n_enbs: int,
    ues_per_cell: int,
    inter_site: float = 500.0,
    radius_factor: float = 0.45,
    generator: torch.Generator | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """``(enb_pos (E, 3), ue_pos (E * ues_per_cell, 3))`` float64: hex
    sites at 30 m, UEs uniform in a disc of ``inter_site *
    radius_factor`` around their site at 1.5 m, cell by cell."""
    sites = np.asarray(hex_grid(n_enbs, inter_site), dtype=np.float64)
    enb_pos = np.column_stack([sites, np.full(n_enbs, ENB_HEIGHT_M)])
    u = torch.rand(
        (n_enbs, ues_per_cell, 2), generator=generator, dtype=torch.float64
    ).numpy()
    r = inter_site * radius_factor * np.sqrt(u[..., 0])
    a = 2 * math.pi * u[..., 1]
    ue_xy = sites[:, None, :] + np.stack(
        [r * np.cos(a), r * np.sin(a)], axis=-1
    )
    ue_pos = np.column_stack(
        [ue_xy.reshape(-1, 2), np.full(n_enbs * ues_per_cell, UE_HEIGHT_M)]
    )
    return enb_pos, ue_pos


def lena_grid_program(
    enb_pos,
    ue_pos,
    n_ttis: int,
    scheduler: str = "pf",
    *,
    n_rb: int = 25,
    tx_power_dbm: float = 30.0,
    noise_figure_db: float = 9.0,
    frequency_hz: float = 2.12e9,
    pf_alpha: float = 0.05,
) -> LteSmProgram:
    """Lower a static full-buffer drop to an :class:`LteSmProgram`.

    Attach is to the closest eNB, lowest index on ties
    (``helper.py:124-135``).  The gain follows the controller: float64
    distances, the Friis loss in f32, then ``10 ** (-loss / 10)`` in
    float64."""
    enb_pos = np.asarray(enb_pos, dtype=np.float64)
    ue_pos = np.asarray(ue_pos, dtype=np.float64)
    d2 = ((ue_pos[:, None, :] - enb_pos[None, :, :]) ** 2).sum(-1)  # (U, E)
    serving = np.argmin(d2, axis=1).astype(np.int32)
    d = np.sqrt(((enb_pos[:, None, :] - ue_pos[None, :, :]) ** 2).sum(-1))
    rx_dbm = friis(
        torch.zeros((), dtype=torch.float32),
        torch.from_numpy(d).to(torch.float32),
        frequency_hz,
    )
    loss_db = -rx_dbm.numpy().astype(np.float64)
    return LteSmProgram(
        gain=10.0 ** (-loss_db / 10.0),
        serving=serving,
        tx_power_dbm=np.full(len(enb_pos), float(tx_power_dbm)),
        noise_psd=noise_psd_w(noise_figure_db),
        n_rb=int(n_rb),
        n_ttis=int(n_ttis),
        scheduler=scheduler,
        pf_alpha=float(pf_alpha),
    )


def lena_mobile_program(
    n_enbs: int,
    ues_per_cell: int,
    n_ttis: int,
    mobility: str = "const_velocity",
    speed: float = 10.0,
    geom_stride: int = 8,
    scheduler: str = "pf",
    *,
    inter_site: float = 500.0,
    radius_factor: float = 0.45,
    frequency_hz: float = 2.12e9,
    generator: torch.Generator | None = None,
) -> LteSmProgram:
    """A moving lena drop (``build_lena(..., mobility=, speed=)`` +
    ``lower_lte_sm(..., geom_stride=)``): :func:`lena_ue_drop`, the t = 0
    lowering of :func:`lena_grid_program` (attach and cell structure),
    Friis at ``frequency_hz`` for the geometry stage, and the UEs moving
    as ``mobility`` says:

    - ``"const_velocity"``: ``speed`` m/s along a heading ``h`` drawn
      per UE from the same generator after the drop,
      ``v = speed (cos h, sin h, 0)``;
    - ``"random_walk"``: speed band ``[speed / 2, speed]``, 1 s segments,
      inside the sites' bounding box padded by the drop radius + 50 m
      (``tpudes/scenarios.py:390-402``)."""
    enb_pos, ue_pos = lena_ue_drop(
        n_enbs, ues_per_cell, inter_site, radius_factor, generator
    )
    prog = lena_grid_program(enb_pos, ue_pos, n_ttis, scheduler,
                             frequency_hz=frequency_hz)
    base = ue_pos.astype(np.float32)
    if mobility == "const_velocity":
        h = 2.0 * math.pi * torch.rand(
            len(ue_pos), generator=generator, dtype=torch.float64
        ).numpy()
        vel = np.stack([speed * np.cos(h), speed * np.sin(h),
                        np.zeros_like(h)], axis=-1)
        mob = MobilityProgram.constant_velocity(base, vel)
    elif mobility == "random_walk":
        pad = inter_site * radius_factor + 50.0
        xs, ys = enb_pos[:, 0], enb_pos[:, 1]
        mob = MobilityProgram.random_walk(
            base, (xs.min() - pad, xs.max() + pad, ys.min() - pad,
                   ys.max() + pad),
            np.tile([speed / 2.0, speed], (len(base), 1)),
            horizon_us=n_ttis * 1000,
        )
    else:
        raise ValueError(f"unknown mobility {mobility!r}")
    warn_geom_stride("lena_mobile_program", mob, geom_stride, 1e-3)
    return dataclasses.replace(
        prog, mobility=mob, geom_stride=int(geom_stride),
        enb_pos=enb_pos.astype(np.float32),
        pathloss=("friis", float(frequency_hz), 1.0, 0.0),
    )


def lena_traffic_program(
    n_enbs: int,
    ues_per_cell: int,
    n_ttis: int,
    scheduler: str = "pf",
    *,
    precision: str = "f32",
    generator: torch.Generator | None = None,
) -> LteSmProgram:
    """The static drop of :func:`lena_ue_drop` + :func:`lena_grid_program`
    with one ON-OFF source per UE, the workload of the reference's LTE
    traffic test over the whole horizon: :data:`ONOFF_PEAK_PPS` arrivals
    per second while ON, bounded-Pareto ON periods ``(1.5, 10 ms, 50
    ms)``, exponential OFF periods of mean 20 ms, packet sizes
    bounded-Pareto ``(1.4, 800 B, 12000 B)``.  A UE offers about 24
    packets of about 1.9 kB a second, 10.8 Mbit/s per cell of 30 UEs: on
    the seven-cell reuse-1 drop several times what the cells deliver, so
    the eligibility gate bites while backlogs are young and most hold
    bits by the end of a 10-second run."""
    prog = lena_grid_program(
        *lena_ue_drop(n_enbs, ues_per_cell, generator=generator), n_ttis,
        scheduler,
    )
    tp = TrafficProgram.onoff(
        prog.n_ue, ONOFF_PEAK_PPS, horizon_us=n_ttis * 1000, on=ONOFF_ON,
        off_mean_s=ONOFF_OFF_MEAN_S, tr_seed=ONOFF_TR_SEED,
    )
    tp = dataclasses.replace(
        tp, size_pareto=np.asarray(ONOFF_SIZE_PARETO, np.float32)
    )
    return dataclasses.replace(prog, traffic=tp, precision=precision)
