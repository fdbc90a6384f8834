"""Progressive-filling max-min fair solver over a flow/link incidence.

The flow model reduces every traffic pattern to a *rate allocation
problem*: flows (CSR lists of directed-link ids) with demands, links
with capacities, and the engine-calibrated question "what rate does each
flow sustain?".  The canonical answer for a work-conserving fabric with
per-flow queues is the **max-min fair** allocation, computed here by
progressive filling (Bertsekas & Gallager §6.5.2):

1. raise every active flow's rate at a common speed;
2. the first constraint to bind is either a link running out of residual
   capacity (its flows are *bottlenecked* — frozen at the current level)
   or a flow reaching its demand (frozen *satisfied*);
3. repeat with the survivors until no flow is active.

Each iteration freezes at least one flow, and symmetric patterns freeze
whole equivalence classes at once, so the loop runs for the number of
distinct bottleneck levels — single digits on every in-repo pattern —
with O(nnz) vectorized work per iteration.

Two cores: the numpy reference (:func:`maxmin_rates_numpy`, the oracle)
and a float64 torch twin of the reference's jitted core
(:func:`maxmin_rates_torch`) that runs each iteration's O(nnz) work on
``device`` — the card by default.  The torch core takes every step in
the numpy core's order and rounding (``resid - inc * n_act`` as a product
then a difference; the per-link active counts are integers, so their
scatter-add is exact in any order), so the two agree to the last bit on
the in-repo problems.  ``solver="auto"`` is the torch core on the
caller's device; the numpy core runs only when asked for.
"""
from __future__ import annotations

import numpy as np
import torch

from ..sim.xengine import _resolve_device

__all__ = ["maxmin_rates", "maxmin_rates_numpy", "maxmin_rates_torch"]

#: Residual-capacity slack below which a link counts as saturated.  The
#: filling step subtracts ``inc * n_active`` from the binding link's
#: residual, which lands on 0 up to one rounding error of the division
#: that produced ``inc``; 1e-9 is orders above that for unit capacities.
TOL = 1e-9

#: ``maxmin_rates(solver=...)`` choices.
SOLVERS = ("numpy", "torch", "auto")


def _entry_flow(flow_ptr: np.ndarray) -> np.ndarray:
    """Flow index of every CSR entry."""
    counts = np.diff(flow_ptr)
    return np.repeat(np.arange(counts.size), counts)


def maxmin_rates_numpy(demand: np.ndarray, link_idx: np.ndarray,
                       flow_ptr: np.ndarray, capacity: np.ndarray, *,
                       max_iters: int = 256) -> np.ndarray:
    """Max-min fair rates (numpy reference core).

    ``demand``: (F,) offered rate per flow; ``link_idx``/(``flow_ptr``):
    CSR of each flow's *compacted* link indices (a flow crossing a link
    twice lists it twice and consumes capacity twice); ``capacity``:
    (L,) per-link capacity.  Returns (F,) rates with ``0 <= rate <=
    demand``.
    """
    demand = np.asarray(demand, dtype=np.float64)
    capacity = np.asarray(capacity, dtype=np.float64)
    F, L = demand.size, capacity.size
    entry_flow = _entry_flow(np.asarray(flow_ptr))
    link_idx = np.asarray(link_idx)
    rates = np.zeros(F)
    active = demand > TOL
    resid = capacity.copy()
    for _ in range(max_iters):
        if not active.any():
            break
        ea = active[entry_flow]
        n_act = np.bincount(link_idx[ea], minlength=L).astype(np.float64)
        used = n_act > 0
        alpha = np.min(resid[used] / n_act[used]) if used.any() else np.inf
        beta = np.min(demand[active] - rates[active])
        inc = min(alpha, beta)
        if np.isfinite(inc) and inc > 0:
            rates[active] += inc
            resid -= inc * n_act
            np.maximum(resid, 0.0, out=resid)
        tight = used & (resid <= TOL)
        flow_tight = np.zeros(F, dtype=bool)
        if tight.any():
            hit = ea & tight[link_idx]
            flow_tight[entry_flow[hit]] = True
        met = rates >= demand - TOL
        newly = active & (flow_tight | met)
        if not newly.any():
            # Numerical stall (should not happen: inc==alpha saturates a
            # link, inc==beta satisfies a flow).  Freeze the survivors at
            # their current — already fair — rates rather than spin.
            break
        active &= ~newly
    return rates


def _torch_core(demand: torch.Tensor, entry_flow: torch.Tensor,
                link_idx: torch.Tensor, capacity: torch.Tensor,
                max_iters: int) -> tuple[torch.Tensor, int]:
    """Progressive filling on the tensors' device (float64 demand and
    capacity, int64 CSR entries); returns ``(rates, iterations)``.  The
    reference's ``_jax_core`` update, step for step as
    :func:`maxmin_rates_numpy` rounds it; the loop condition
    ``active.any()`` is the one host read per iteration."""
    F, L = demand.shape[0], capacity.shape[0]
    inf = torch.tensor(float("inf"), dtype=torch.float64,
                       device=demand.device)
    rates = torch.zeros_like(demand)
    active = demand > TOL
    resid = capacity.clone()
    iters = 0
    while iters < max_iters and bool(active.any()):
        iters += 1
        ea = active[entry_flow]
        n_act = torch.zeros(L, dtype=torch.float64, device=demand.device
                            ).index_add_(0, link_idx, ea.to(torch.float64))
        used = n_act > 0
        alpha = torch.where(used, resid / torch.clamp(n_act, min=1.0),
                            inf).amin()
        beta = torch.where(active, demand - rates, inf).amin()
        inc = torch.minimum(alpha, beta)
        inc = torch.where(torch.isfinite(inc) & (inc > 0), inc, 0.0)
        rates = torch.where(active, rates + inc, rates)
        used_cap = inc * n_act
        resid = torch.clamp(resid - used_cap, min=0.0)
        tight = used & (resid <= TOL)
        hit = (ea & tight[link_idx]).to(torch.int8)
        flow_tight = torch.zeros(F, dtype=torch.int8, device=demand.device
                                 ).scatter_reduce_(0, entry_flow, hit,
                                                   "amax") > 0
        met = rates >= demand - TOL
        newly = active & (flow_tight | met)
        # Same stall safeguard as the numpy core: no progress deactivates
        # everything (rates already hold the fair allocation so far).
        active = torch.where(newly.any(), active & ~newly,
                             torch.zeros_like(active))
    return rates, iters


def upload_problem(demand, link_idx, flow_ptr, capacity, device
                   ) -> tuple[torch.Tensor, ...]:
    """The solver's inputs on ``device``: ``(demand, entry_flow, link_idx,
    capacity)`` as float64 / int64 tensors."""
    device = _resolve_device(device)
    entry_flow = _entry_flow(np.asarray(flow_ptr))
    as_t = lambda a, dt: torch.as_tensor(  # noqa: E731
        np.asarray(a), dtype=dt, device=device)
    return (as_t(demand, torch.float64), as_t(entry_flow, torch.int64),
            as_t(link_idx, torch.int64), as_t(capacity, torch.float64))


def maxmin_rates_torch(demand: np.ndarray, link_idx: np.ndarray,
                       flow_ptr: np.ndarray, capacity: np.ndarray, *,
                       max_iters: int = 256, device="cuda") -> np.ndarray:
    """Max-min fair rates from the torch core on ``device`` (default
    ``"cuda"``, which raises where CUDA is absent); the same arguments and
    result as :func:`maxmin_rates_numpy`."""
    rates, _ = _torch_core(*upload_problem(demand, link_idx, flow_ptr,
                                           capacity, device), max_iters)
    return rates.cpu().numpy()


def maxmin_rates(demand, link_idx, flow_ptr, capacity, *,
                 max_iters: int = 256, solver: str = "auto",
                 device="cuda") -> np.ndarray:
    """Dispatch: ``"torch"`` and ``"auto"`` run the torch core on
    ``device``; ``"numpy"`` runs the numpy core.  Nothing falls back from
    one to the other."""
    if solver == "numpy":
        return maxmin_rates_numpy(demand, link_idx, flow_ptr, capacity,
                                  max_iters=max_iters)
    if solver in ("torch", "auto"):
        return maxmin_rates_torch(demand, link_idx, flow_ptr, capacity,
                                  max_iters=max_iters, device=device)
    raise ValueError(f"unknown flow solver {solver!r}; expected one of "
                     f"{SOLVERS}")
