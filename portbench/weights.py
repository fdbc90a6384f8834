"""The weights of a cell, made on the device from the seed, in the port's
parameter layout (``repro_torch.models.transformer`` ``init_params``'
tree), in the type the train state holds them (float32).

Each kind of leaf is one group: all layers' copies of it are drawn in one
``torch.randn`` of shape (layers, *leaf) from a ``torch.Generator`` on the
device, scaled in place, and each layer's leaf is a view of its row.  The
same seed gives the same weights; :func:`initial_groups` draws them again,
group by group, so that the parameters' change after some steps can be
read without a second copy of the model.

The distributions: a matrix N(0, 1) / sqrt(fan-in), the embedding (and an
untied head's columns) N(0, 0.02^2), and every norm's scale offset, norm
bias and projection bias N(0, 0.05^2), so that the output check sees each
of them act.

A configuration's multipliers that the port has no field for (granite's
embedding, residual, attention and logits multipliers: ``model_sizes``
``gains``) are folded into these draws, so that the port computes the
published forward: the embedding's draw times the embedding multiplier,
every block's output projection and its bias times the residual
multiplier, the query projection times the attention multiplier over the
port's 1 / sqrt(head_dim), and the final norm's scale (stored as an offset
from 1) times 1 / logits scaling, over the embedding multiplier too where
the head is tied to the embedding.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

SMALL = 0.05      # norm scale offsets and biases
EMBED = 0.02


@dataclass(frozen=True)
class Group:
    path: tuple       # the leaf's path below a layer, or from the root
    shape: tuple
    scale: float
    layered: bool     # one copy a layer
    shift: float = 0.0  # added after the scale


def groups(sizes) -> list:
    """Every leaf kind of the model, in the order they are drawn."""
    d, h, kv, dh, f = (sizes["d_model"], sizes["num_heads"],
                       sizes["num_kv_heads"], sizes["head_dim"],
                       sizes["d_ff"])
    gain = sizes["gains"]
    res = gain["residual"]
    out = [Group(("embed", "table"), (sizes["vocab_padded"], d),
                 EMBED * gain["embed"], False)]

    def norm(name):
        out.append(Group((name, "scale"), (d,), SMALL, True))
        if sizes["norm"] == "layernorm":
            out.append(Group((name, "bias"), (d,), SMALL, True))

    def dense(path, shape, fan_in, times=1.0):
        out.append(Group(path, shape, times / math.sqrt(fan_in), True))

    norm("ln1")
    dense(("attn", "wq"), (d, h, dh), d, gain["query"])
    dense(("attn", "wk"), (d, kv, dh), d)
    dense(("attn", "wv"), (d, kv, dh), d)
    dense(("attn", "wo"), (h, dh, d), h * dh, res)
    if sizes["bias"]:
        for name, shape, times in (("bq", (h, dh), gain["query"]),
                                   ("bk", (kv, dh), 1.0),
                                   ("bv", (kv, dh), 1.0), ("bo", (d,), res)):
            out.append(Group(("attn", name), shape, SMALL * times, True))
    norm("ln2")
    gated = sizes["mlp"] in ("swiglu", "geglu")
    if sizes["num_experts"]:
        e = sizes["experts_stored"]
        dense(("moe", "router"), (d, sizes["num_experts"]), d)
        dense(("moe", "wi"), (e, d, f), d)
        dense(("moe", "wo"), (e, f, d), f, res)
        if gated:
            dense(("moe", "wg"), (e, d, f), d)
    else:
        dense(("mlp", "wi"), (d, f), d)
        dense(("mlp", "wo"), (f, d), f, res)
        if gated:
            dense(("mlp", "wg"), (d, f), d)
        if sizes["bias"]:
            out.append(Group(("mlp", "bi"), (f,), SMALL, True))
            out.append(Group(("mlp", "bo"), (d,), SMALL * res, True))
    final = gain["final"]
    out.append(Group(("final_norm", "scale"), (d,), SMALL * final, False,
                     final - 1.0))
    if sizes["norm"] == "layernorm":
        out.append(Group(("final_norm", "bias"), (d,), SMALL * final, False))
    if not sizes["tie"]:
        out.append(Group(("lm_head", "w"), (d, sizes["vocab_padded"]),
                         EMBED, False))
    return out


def initial_groups(sizes, seed: int, device):
    """(group, tensor) in drawing order; a layered group's tensor has the
    layers first."""
    gen = torch.Generator(device=device).manual_seed(seed)
    for g in groups(sizes):
        shape = ((sizes["num_layers"],) + g.shape) if g.layered else g.shape
        t = torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32).mul_(g.scale)
        yield g, (t.add_(g.shift) if g.shift else t)


def _set(tree, path, value):
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


#: The port's key order of a block (init_block), of attention and the MLP.
_BLOCK_ORDER = ("ln1", "attn", "ln2", "mlp", "moe")
_LEAF_ORDER = ("scale", "bias", "wq", "wk", "wv", "wo", "bq", "bk", "bv",
               "bo", "router", "wi", "wg", "bi")
_PORT_ORDER = {"mlp": ("wi", "wo", "wg", "bi", "bo"),
               "moe": ("router", "wi", "wo", "wg")}


def _ordered(d: dict, order) -> dict:
    return {k: d[k] for k in order if k in d}


def make(sizes, seed: int, device) -> dict:
    """The parameter tree of the port's layout, drawn from ``seed``."""
    tree = {"embed": {}, "layers": [{} for _ in range(sizes["num_layers"])]}
    top = {}
    for g, t in initial_groups(sizes, seed, device):
        if g.layered:
            for i, layer in enumerate(tree["layers"]):
                _set(layer, g.path, t[i])
        elif g.path[0] == "embed":
            tree["embed"][g.path[1]] = t
        else:
            _set(top, g.path, t)
    layers = []
    for layer in tree["layers"]:
        block = {}
        for name in _BLOCK_ORDER:
            if name in layer:
                order = _PORT_ORDER.get(name, _LEAF_ORDER)
                block[name] = _ordered(layer[name], order)
        layers.append(block)
    out = {"embed": tree["embed"], "layers": layers,
           "final_norm": _ordered(top["final_norm"], _LEAF_ORDER)}
    if "lm_head" in top:
        out["lm_head"] = top["lm_head"]
    return out


def leaves(tree, prefix=()):
    """[(path, tensor)] in the tree's order."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in leaves(v, prefix + (k,))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree)
                for x in leaves(v, prefix + (i,))]
    return [(prefix, tree)]


def path_name(path) -> str:
    return ".".join(str(p) for p in path)


def n_params(sizes) -> int:
    total = 0
    for g in groups(sizes):
        n = math.prod(g.shape)
        total += n * (sizes["num_layers"] if g.layered else 1)
    return total


def change_norms(sizes, seed: int, params) -> dict:
    """{leaf name: ||leaf - its initial value||} (float64), the initial
    values drawn again from ``seed`` group by group."""
    device = params["embed"]["table"].device
    out = {}
    for g, t0 in initial_groups(sizes, seed, device):
        if g.layered:
            for i, layer in enumerate(params["layers"]):
                leaf = layer
                for key in g.path:
                    leaf = leaf[key]
                out[path_name(("layers", i) + g.path)] = (
                    leaf - t0[i]).double().norm()
        else:
            leaf = params
            for key in g.path:
                leaf = leaf[key]
            out[path_name(g.path)] = (leaf - t0).double().norm()
        del t0
    return {k: float(v) for k, v in out.items()}
