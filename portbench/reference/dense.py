"""The plain reference of a dense decoder's training step: the loss of a
batch, its gradients by autograd and AdamW, in float32 with TF32 off.

It computes what the configuration file states, in the port's parameter
layout (``weights.py``): token embedding; per layer a pre-norm (LayerNorm
or RMSNorm with eps from the file, each scale stored as an offset from 1),
grouped-query attention with rotary embeddings (rotate-half, inverse
frequencies theta^(-i/half)) and projection biases where the file says
so, causal softmax at 1/sqrt(head_dim), the output projection, a residual
add, a second pre-norm and the MLP (gelu's tanh form, or silu-gated), a
residual add; the final norm, the head (the embedding's transpose where
tied), the padded vocabulary's columns masked, and the mean cross entropy
over every labelled position.  Each layer runs under a checkpoint, so that
the activations of one layer at a time are held in float32.

AdamW: the gradients clipped to a global norm, m and v, bias correction,
decoupled weight decay on every leaf of two or more dimensions, the
layers' axis counted (the layout of the JAX package's stacked layers),
but norms' scales and biases, and a learning rate warmed up linearly and
decayed on a cosine, all as the traffic file's optimizer sets them.

``precision="fp8"`` is the control: every matrix product's two operands
rounded to float8 e4m3 with a scale a tensor (its largest magnitude to
448), the product and everything else in float32; the rounding is seen
by the forward and its gradients flow straight through it.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

FP8_MAX = 448.0

#: Leaf names that never decay (the JAX package's optimizer's list).
NO_DECAY = ("scale", "bias", "b_i", "b_f", "b_gates", "dt_bias", "A_log",
            "D", "norm_scale", "hnorm_scale", "ffn_norm_scale", "q_scale",
            "k_scale", "attn_out_scale", "ssm_out_scale")


def exact_float32():
    """Matrix products in full float32 (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8_round(x):
    """x rounded to float8 e4m3 with one scale for the tensor; the
    gradient passes straight through."""
    amax = x.detach().abs().amax().clamp_min(1e-30)
    scale = FP8_MAX / amax
    q = (x.detach() * scale).to(torch.float8_e4m3fn).float() / scale
    return x + (q - x).detach()


class Ops:
    """The products of a precision: ``mm`` and ``ein`` round their operands
    where the precision is fp8."""

    def __init__(self, precision: str = "float32"):
        if precision not in ("float32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.round = fp8_round if precision == "fp8" else (lambda x: x)

    def mm(self, a, b):
        return self.round(a) @ self.round(b)

    def ein(self, eq, a, b):
        return torch.einsum(eq, self.round(a), self.round(b))


def norm(p, x, sizes):
    eps = sizes["norm_eps"]
    if sizes["norm"] == "layernorm":
        mu = x.mean(-1, keepdim=True)
        var = (x - mu).square().mean(-1, keepdim=True)
        return (x - mu) / torch.sqrt(var + eps) * (1 + p["scale"]) + p["bias"]
    ms = x.square().mean(-1, keepdim=True)
    return x / torch.sqrt(ms + eps) * (1 + p["scale"])


def rope(x, pos, theta):
    """x (B, T, H, D) rotated by positions ``pos`` (T,), rotate-half."""
    half = x.shape[-1] // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float32,
                                  device=x.device) / half)
    ang = pos.float()[:, None] * inv[None, :]
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attend(q, k, v, ops: Ops):
    """Causal grouped-query attention, one batch row at a time: q (B, T,
    H, D), k and v (B, T, KV, D) -> (B, T, H, D)."""
    b, t, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    mask = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    rows = []
    for i in range(b):
        qi = q[i].reshape(t, kvh, g, d)
        s = ops.ein("tkgd,skd->kgts", qi, k[i]) / math.sqrt(d)
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        rows.append(ops.ein("kgts,skd->tkgd", p, v[i]).reshape(t, h, d))
    return torch.stack(rows)


def project(x, w, ops: Ops):
    """x (B, T, d) @ w (d, heads, dh) -> (B, T, heads, dh)."""
    d, n, k = w.shape
    return ops.mm(x, w.reshape(d, n * k)).unflatten(-1, (n, k))


def gelu_tanh(x):
    return 0.5 * x * (1 + torch.tanh(math.sqrt(2 / math.pi)
                                     * (x + 0.044715 * x ** 3)))


def mlp(p, x, sizes, ops: Ops):
    h = ops.mm(x, p["wi"])
    if "bi" in p:
        h = h + p["bi"]
    if sizes["mlp"] == "swiglu":
        h = F.silu(ops.mm(x, p["wg"])) * h
    else:
        h = gelu_tanh(h)
    y = ops.mm(h, p["wo"])
    return y + p["bo"] if "bo" in p else y


def attention_block(p, x, pos, sizes, ops: Ops):
    a = p["attn"]
    y = norm(p["ln1"], x, sizes)
    q, k, v = (project(y, a[w], ops) for w in ("wq", "wk", "wv"))
    if "bq" in a:
        q, k, v = q + a["bq"], k + a["bk"], v + a["bv"]
    theta = sizes["rope_theta"]
    o = attend(rope(q, pos, theta), rope(k, pos, theta), v, ops)
    h, dh, d = a["wo"].shape
    out = ops.mm(o.flatten(-2), a["wo"].reshape(h * dh, d))
    return x + (out + a["bo"] if "bo" in a else out)


def dense_layer(p, x, pos, sizes, ops: Ops):
    x = attention_block(p, x, pos, sizes, ops)
    return x + mlp(p["mlp"], norm(p["ln2"], x, sizes), sizes, ops), \
        x.new_zeros(2)


def loss(params, batch, sizes, ops: Ops, layer=dense_layer):
    """(loss, aux (2,)) of a batch: mean cross entropy over the labelled
    positions plus the configuration's weights on ``layer``'s summed aux
    terms (none for a dense layer)."""
    tokens = torch.as_tensor(batch["tokens"], device=params["embed"][
        "table"].device).long()
    labels = torch.as_tensor(batch["labels"], device=tokens.device).long()
    x = params["embed"]["table"][tokens]
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    aux = x.new_zeros(2)
    for p in params["layers"]:
        x, a = checkpoint(layer, p, x, pos, sizes, ops, use_reentrant=False)
        aux = aux + a
    x = norm(params["final_norm"], x, sizes)
    w = (params["embed"]["table"].T if sizes["tie"]
         else params["lm_head"]["w"])
    logits = ops.mm(x, w)
    v = sizes["vocab_size"]
    logits = torch.cat([logits[..., :v], torch.full_like(
        logits[..., v:], float("-inf"))], dim=-1)
    mask = labels >= 0
    ce = torch.logsumexp(logits, -1) - logits.gather(
        -1, labels.clamp_min(0)[..., None])[..., 0]
    ce = (ce * mask).sum() / mask.sum().clamp_min(1)
    wa, wz = sizes["aux_weights"]
    return ce + wa * aux[0] + wz * aux[1], aux


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _leaves(v, prefix + (k,))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree)
                for x in _leaves(v, prefix + (i,))]
    return [(prefix, tree)]


def learning_rate(opt: dict, step: int) -> float:
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    prog = min(max((step - opt["warmup_steps"])
                   / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0),
               1.0)
    cos = 0.5 * (1 + math.cos(math.pi * prog))
    return opt["lr"] * warm * (opt["min_lr_ratio"]
                               + (1 - opt["min_lr_ratio"]) * cos)


def decays(path, p) -> bool:
    name = path[-1] if isinstance(path[-1], str) else ""
    stored_ndim = p.dim() + (1 if path[0] == "layers" else 0)
    return name not in NO_DECAY and stored_ndim >= 2


def train(params, batches, sizes, opt: dict, *, precision="float32",
          layer=dense_layer) -> dict:
    """Steps of AdamW from ``params`` (updated in place), one a batch.
    Returns each step's loss, the first step's gradient norm a leaf
    (before clipping) and its global norm."""
    ops = Ops(precision)
    named = _leaves(params)
    m = [torch.zeros_like(p) for _, p in named]
    v = [torch.zeros_like(p) for _, p in named]
    b1, b2 = opt["beta1"], opt["beta2"]
    out = {"losses": [], "grad_norms": None, "grad_norm": None}
    for step, batch in enumerate(batches, start=1):
        for _, p in named:
            p.requires_grad_(True)
        value, _ = loss(params, batch, sizes, ops, layer)
        grads = torch.autograd.grad(value, [p for _, p in named])
        for _, p in named:
            p.requires_grad_(False)
        norms = torch.stack([g.double().norm() for g in grads])
        gnorm = float(norms.square().sum().sqrt())
        if step == 1:
            out["grad_norms"] = {".".join(map(str, path)): float(n)
                                 for (path, _), n in zip(named, norms)}
            out["grad_norm"] = gnorm
        out["losses"].append(float(value.detach()))
        scale = min(1.0, opt["clip_norm"] / max(gnorm, 1e-9))
        lr = learning_rate(opt, step)
        c1, c2 = 1 - b1 ** step, 1 - b2 ** step
        with torch.no_grad():
            for (path, p), g, mi, vi in zip(named, grads, m, v):
                g = g * scale
                mi.mul_(b1).add_(g, alpha=1 - b1)
                vi.mul_(b2).add_(g.square(), alpha=1 - b2)
                delta = (mi / c1) / ((vi / c2).sqrt() + opt["eps"])
                if decays(path, p):
                    delta = delta + opt["weight_decay"] * p
                p.sub_(lr * delta)
        del grads, value
    return out
