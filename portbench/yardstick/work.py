"""Work and bytes of a train step and of one attention call, from a
configuration's sizes alone.

Copied from the program at commit 6086916 so that a later change to the
program cannot move them:

- :func:`train_step_work` and :func:`visible_pairs` from
  ``chip_smoke.py`` (``train_step_work``, ``visible_pairs``), extended
  here with the routed experts and the router of a MoE layer (the
  original counted one dense MLP of width ``d_ff``);
- :func:`attention_call_work` from
  ``src/repro_torch/kernels/flash_attention.py`` ``work()`` and
  ``_aligned_counts()``, for aligned positions 0 .. T-1 (the training
  forward's), taking shapes in place of tensors.

:func:`model_flops` is the count a model FLOPs utilisation divides:
what the step needs, with no recomputation counted.

A configuration here is the dict ``configs/<name>.json`` holds, with the
port's field names under ``"port"`` (see ``harness.model_sizes``).
"""
from __future__ import annotations

ADAMW_BYTES_PER_PARAM = 28   # p, g, m, v read and p, m, v written, fp32


def visible_pairs(seq: int, window: int) -> int:
    """(query, key) pairs a causal layer of ``seq`` aligned positions sees,
    with a sliding ``window`` (0: none): each query t sees min(t + 1,
    window) keys."""
    if window <= 0 or window >= seq:
        return seq * (seq + 1) // 2
    return window * (window + 1) // 2 + (seq - window) * window


def _gated(sizes) -> int:
    return 3 if sizes["mlp"] in ("swiglu", "geglu") else 2


def layer_weights(sizes) -> tuple[int, int]:
    """(weights a token meets in one layer, weights stored in one layer),
    the matrices only: attention's four projections and the MLP, or for a
    MoE layer the router and ``top_k`` of the experts (stored: all of
    the store's experts)."""
    d, h, kv, dh, f = (sizes["d_model"], sizes["num_heads"],
                       sizes["num_kv_heads"], sizes["head_dim"],
                       sizes["d_ff"])
    attn = d * (h + 2 * kv) * dh + h * dh * d
    expert = _gated(sizes) * d * f
    if sizes.get("num_experts"):
        router = d * sizes["num_experts"]
        return (attn + router + sizes["top_k"] * expert,
                attn + router + sizes["experts_stored"] * expert)
    return attn + expert, attn + expert


def train_step_work(sizes, batch: int, seq: int, n_params: int,
                    remat: str = "full") -> tuple[int, int]:
    """(operations, optimizer bytes) of the least work of one train step:
    the products of the weights a token meets forward, recomputed (remat
    "full") and backward (2 + 2 + 4 FLOP a weight and token), of the
    unembedding forward and backward (6), causal attention's products over
    each layer's visible pairs forward twice and 2.5x in the backward, and
    AdamW's 28 bytes a stored parameter."""
    d = sizes["d_model"]
    tokens = batch * seq
    recompute = 2 if remat == "full" else 0
    weights = (6 + recompute) * sizes["num_layers"] * layer_weights(sizes)[0] \
        * tokens
    head = 6 * sizes["vocab_padded"] * d * tokens
    pairs = sum(visible_pairs(seq, w) for w in sizes["windows"])
    attn = 4 * batch * sizes["num_heads"] * sizes["head_dim"] * pairs * (
        1 + recompute / 2 + 2.5)
    return int(weights + head + attn), ADAMW_BYTES_PER_PARAM * n_params


def model_flops(sizes, batch: int, seq: int) -> int:
    """Model FLOPs of one train step, recomputation not counted: 6 a weight
    and token for the weights a token meets and for the unembedding over
    the model's vocabulary, and 12 a visible (query, key) pair, head and
    head dim for attention (4 forward, 8 backward)."""
    tokens = batch * seq
    weights = 6 * sizes["num_layers"] * layer_weights(sizes)[0] * tokens
    head = 6 * sizes["vocab_size"] * sizes["d_model"] * tokens
    pairs = sum(visible_pairs(seq, w) for w in sizes["windows"])
    attn = 12 * batch * sizes["num_heads"] * sizes["head_dim"] * pairs
    return int(weights + head + attn)


def aligned_counts(t: int, s: int, causal: bool, window: int):
    """(keys some query sees, visible pairs) for queries at s - t .. s - 1
    against keys at 0 .. s - 1."""
    rows, pairs, lo_seen, hi_seen = 0, 0, s, -1
    for q in range(s - t, s):
        hi = min(q, s - 1) if causal else s - 1
        lo = max(q - window + 1, 0) if window > 0 else 0
        if hi >= lo:
            pairs += hi - lo + 1
            lo_seen, hi_seen = min(lo_seen, lo), max(hi_seen, hi)
    # every window's keys are contiguous and the windows overlap: the keys
    # seen are one range
    rows = max(hi_seen - lo_seen + 1, 0)
    return rows, pairs


def attention_call_work(b: int, t: int, h: int, d: int, s: int, kvh: int,
                        elem_bytes: int, *, causal: bool = True,
                        window: int = 0) -> tuple[int, int]:
    """(bytes, operations) of one attention call: q read and the output
    written once, the K/V rows some query sees read once, the int32
    positions, and the four operations of each visible (query, key) pair
    for each query head and head dim."""
    rows, pairs = aligned_counts(t, s, causal, window)
    nbytes = (2 * b * t * h * d * elem_bytes + 2 * b * rows * kvh * d
              * elem_bytes + 4 * (t + s))
    return nbytes, 4 * b * h * d * pairs
