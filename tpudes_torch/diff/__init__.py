"""tpudes_torch.diff: differentiable simulation on the port's engines.

Counterpart of ``tpudes/diff`` (ROADMAP A14), with ``torch.autograd`` in
place of ``jax.grad``:

- :class:`Surrogacy`: temperature-controlled smooth surrogates for the
  engines' hard points (the CQI staircase, the modulation-order ladder,
  the eligibility threshold, the AS delivery min-gate), straight-through
  where the forward must stay exact; ``surrogate=None`` is the exact
  program;
- :func:`grad_as_flows` / :func:`grad_lte_sm`: the gradient of a scalar
  KPI loss w.r.t. the engines' operands (propagation parameters, tx
  powers, eNB / UE positions, flow rates, link capacities, scheduler
  weights), a batch of designs in one launch;
- :func:`calibrate_as_flows` / :func:`calibrate_lte` / :func:`descend`:
  Adam or L-BFGS-lite, a whole descent as one launch, ``fold_in``-keyed
  replica minibatches;
- :func:`es_search` / :func:`fd_gradient` / :func:`bss_interval_design`:
  megabatched evolution strategies for the engines that stay
  event-stepped (one launch a generation).

On the card a grad call and a descent are each one CUDA-graph replay
(:mod:`tpudes_torch.diff.graphs`).  Entry points run on the card unless
given ``device="cpu"``.
"""

from tpudes_torch.diff.as_grad import AS_LOSSES, grad_as_flows
from tpudes_torch.diff.calibrate import (
    CalibResult,
    calibrate_as_flows,
    calibrate_lte,
    descend,
)
from tpudes_torch.diff.lte_grad import LTE_LOSSES, grad_lte_sm
from tpudes_torch.diff.search import (
    ESResult,
    bss_interval_design,
    descend_design,
    es_search,
    fd_gradient,
)
from tpudes_torch.diff.surrogate import Surrogacy, soft_staircase, ste

__all__ = [
    "AS_LOSSES",
    "CalibResult",
    "ESResult",
    "LTE_LOSSES",
    "Surrogacy",
    "bss_interval_design",
    "calibrate_as_flows",
    "calibrate_lte",
    "descend",
    "descend_design",
    "es_search",
    "fd_gradient",
    "grad_as_flows",
    "grad_lte_sm",
    "soft_staircase",
    "ste",
]
