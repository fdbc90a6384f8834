"""The comparison that decides ``correct`` for a training cell.

Four relative gaps between the program's reading and the plain
reference's, from the same weights and batches, and a share the program's
run reads alone:

- ``loss_gap``: the largest over the first steps of |loss - reference's|
  over the reference's loss;
- ``grad_norm_gap``: the first step's gradient, as the optimizer got it
  (its first moment over 1 - beta1, the clip's scale divided out), by its
  norm a leaf: the largest over leaves of the gap between the program's
  norm and the reference's, over the larger of the reference's norm of
  that leaf and of the median leaf;
- ``grad_norm_gap_median``: the median over leaves of the same gaps, a
  number steady from seed to seed where one small leaf's gap swings (a
  MoE router's, whose top-k flips between a bf16 and a float32 logit);
- ``update_gap``: the same of the norm a leaf of the parameters' change
  over those steps, over the leaves that the reference's gradient moves
  (its first gradient's norm at least a thousandth of the median leaf's:
  a leaf whose gradient is nought to rounding, as a key's bias is under
  softmax, moves under AdamW by rounding alone);
- ``dropped_share``: in a MoE, the share of the program's expert
  assignments over those steps that its capacity dispatch dropped (the
  published model drops none), read where the port's dispatch can be
  counted (``traffic/train.py`` ``counted_drops``).

A cell compares the numbers its ``limits`` name; a number the run could
not read is left out.
"""
from __future__ import annotations

import math
import statistics

NUMBERS = ("loss_gap", "grad_norm_gap", "grad_norm_gap_median",
           "update_gap", "dropped_share")
MOVED_SHARE = 1e-3


def _gap(a, b, base):
    if not (math.isfinite(a) and math.isfinite(b)):
        return math.inf
    return abs(a - b) / base if base > 0 else (0.0 if a == b else math.inf)


def leaf_gaps(got: dict, want: dict, keys) -> dict:
    """{leaf: gap} over ``keys``, each over the larger of the reference's
    norm of the leaf and of the median leaf."""
    keys = list(keys)
    med = statistics.median(want[k] for k in keys)
    return {k: _gap(got.get(k, math.nan), want[k], max(want[k], med))
            for k in keys}


def leaf_gap(got: dict, want: dict, keys) -> tuple[float, str]:
    """(worst gap, its leaf) over ``keys``."""
    gaps = leaf_gaps(got, want, keys)
    leaf = max(gaps, key=gaps.get)
    return gaps[leaf], leaf


def gaps(got: dict, want: dict) -> dict:
    """The numbers and the leaves that set them, from two readings
    ``{"losses", "grad_norms", "changes"}``."""
    losses = [_gap(a, b, abs(b)) for a, b in zip(got["losses"],
                                                  want["losses"])]
    if len(got["losses"]) != len(want["losses"]):
        losses.append(math.inf)
    grads = want["grad_norms"]
    per_leaf = leaf_gaps(got["grad_norms"], grads, grads)
    g_leaf = max(per_leaf, key=per_leaf.get)
    g = per_leaf[g_leaf]
    med = statistics.median(grads.values())
    moved = [k for k, n in grads.items() if n >= MOVED_SHARE * med]
    u, u_leaf = leaf_gap(got["changes"], want["changes"], moved)
    return {"loss_gap": max(losses), "grad_norm_gap": g,
            "grad_norm_gap_median": statistics.median(per_leaf.values()),
            "update_gap": u, "dropped_share": got.get("dropped_share"),
            "grad_norm_leaf": g_leaf, "update_leaf": u_leaf,
            "leaves_moved": len(moved), "leaves": len(grads)}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) for each number the limits
    name."""
    check = {k: {"value": numbers[k], "limit": limits[k]} for k in NUMBERS
             if k in limits and numbers.get(k) is not None}
    ok = all(math.isfinite(v["value"]) and v["value"] <= v["limit"]
             for v in check.values())
    return ok, check
