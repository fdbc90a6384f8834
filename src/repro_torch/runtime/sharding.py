"""Parameter / state / batch / cache partition specs for a mesh, and the
placement of a tree on a ``DeviceMesh`` as DTensors.

Port of ``repro.runtime.sharding``.  Name-pattern based: every parameter
leaf gets a :class:`Spec` from its path.  The reference computes specs on
its *stacked* layout, each run's layers along a leading axis that is never
sharded, and both the ZeRO threshold (:data:`FSDP_MIN_ELEMS`) and
:func:`zero_extend_spec`'s choice of dim read that stacked shape.  So the
port computes every spec on ``models.convert.shapes_from_params``' stacked
:class:`~repro_torch.models.convert.ShapeDtype` tree and maps it to its own
per-layer leaves (``convert.per_layer``), dropping the layer axis's
``None``; a spec that shards the layer axis raises there.  Shapes come from
any tensors, ``meta`` ones included (``models.transformer.param_shapes``,
the counterpart of ``jax.eval_shape``), and the mesh from any object with
``mesh_dim_names`` and ``size(i)``, so specs for a (16, 16) mesh need no
process group.

:func:`placements` turns a spec into ``torch.distributed.tensor``
placements and :func:`shard_tree` places a tree of whole tensors or numpy
arrays (every rank holding the same values) as DTensors, each rank slicing
out its own shard: the port's ``jax.device_put(x, NamedSharding)``, with no
collective.  :func:`working_copy` turns a placed tree into the local
tensors the layers compute on: each leaf gathered whole, but a leaf that a
tensor-parallel layer reads on its ``tp`` slice
(``models.transformer.tp_slice_dim``), or an expert leaf of the
expert-parallel MoE, keeps that slice, gathered over the other axes only.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import (as_dtensor, per_layer,
                                        shapes_from_params, stacked)
from repro_torch.models.layers import AxisRules
from repro_torch.models.transformer import (build_runs, init_caches,
                                            tp_slice_dim)
from repro_torch.optim.adamw import tree_map


class Spec(tuple):
    """A partition spec, the reference's ``PartitionSpec``: one entry a
    tensor dim, each ``None``, a mesh axis name, or a tuple of names
    (sharded over their product, the first outermost).  A one-name tuple
    reads as the name, as ``PartitionSpec`` normalises it."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, (tuple, list)) and len(e) == 1
            else tuple(e) if isinstance(e, list) else e for e in entries))

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self):
        return "Spec" + tuple.__repr__(self)


def _names(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _axis_size(mesh, name: str) -> int:
    return int(mesh.size(list(mesh.mesh_dim_names).index(name)))


def spec_map(fn, *trees, path=()):
    """``fn(path, *leaves)`` over nested dicts and lists, in the first
    tree's order (``optim.adamw.tree_map``'s); anything else (a
    :class:`Spec`, a ``ShapeDtype``, a tensor) is a leaf.  ``path`` holds the dict
    keys only, as the reference's ``p.key`` of each ``DictKey``."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: spec_map(fn, *(t[k] for t in trees), path=path + (k,))
                for k in first}
    if isinstance(first, list):
        return [spec_map(fn, *(t[i] for t in trees), path=path)
                for i in range(len(first))]
    return fn(path, *trees)


def _has_layer_axis(names) -> bool:
    return bool(names) and names[0] == "stack" or "encoder" in names


def _leaf_spec(names, shape, cfg: ModelConfig, rules: AxisRules) -> Spec:
    tp = rules.tp
    name = names[-1] if names else ""
    in_moe = "moe" in names
    nd = len(shape)
    stacked_axis = int(_has_layer_axis(names))

    def spec(*tail):
        return Spec(*([None] * stacked_axis + list(tail)))

    heads_shardable = cfg.num_heads % max(rules.tp_size, 1) == 0
    kv_shardable = cfg.num_kv_heads % max(rules.tp_size, 1) == 0
    ff_shardable = cfg.d_ff % max(rules.tp_size, 1) == 0 if cfg.d_ff else False

    if name == "table":                       # embedding (V, d)
        return Spec(tp, None)
    if name == "w" and "lm_head" in names:    # (d, V)
        return Spec(None, tp)
    if name == "router":
        return spec(None, None)
    if in_moe and name in ("wi", "wg"):       # (E, d, f)
        return spec(tp, None, None)
    if in_moe and name == "wo":               # (E, f, d)
        return spec(tp, None, None)
    if name == "wq" and nd - stacked_axis == 3:    # attn (d, h, dh)
        return spec(None, tp, None) if heads_shardable else spec(tp, None, None)
    if name in ("wk", "wv") and nd - stacked_axis == 3:  # attn (d, kv, dh)
        return spec(None, tp, None) if kv_shardable else spec(None, None, None)
    if name in ("wq", "wk", "wv") and nd - stacked_axis == 2:  # mLSTM
        return spec(None, tp)
    if name == "wo" and nd - stacked_axis == 3:    # attn out (h, dh, d)
        return spec(tp, None, None) if heads_shardable else spec(None, None, tp)
    if name in ("bq",):                       # (h, dh)
        return spec(tp, None) if heads_shardable else spec(None, None)
    if name in ("bk", "bv"):
        return spec(tp, None) if kv_shardable else spec(None, None)
    if name == "wi" or name == "wg":          # mlp (d, f)
        return spec(None, tp) if ff_shardable else spec(None, None)
    if name == "wo":                          # mlp (f, d)
        return spec(tp, None) if ff_shardable else spec(None, None)
    if name == "bi":                          # (f,)
        return spec(tp) if ff_shardable else spec(None)
    # --- xLSTM / SSM inner-dim sharded leaves -----------------------------
    if name == "up":                          # (d, 2*inner)
        return spec(None, tp)
    if name == "down" or name == "out_proj":  # (inner, d)
        return spec(tp, None)
    if name in ("in_proj", "w_gates", "ffn_wi", "ffn_wg", "dt_proj"):
        return spec(None, tp)
    if name in ("ffn_wo", "x_proj"):          # (inner/ff, ...)
        return spec(tp, None)
    if name in ("A_log",):                    # (inner, S)
        return spec(tp, None)
    if name in ("D", "dt_bias"):              # (inner,)
        return spec(tp)
    if name == "conv_w":                      # (K, inner)
        return spec(None, tp)
    if name in ("wq_m", "wk_m", "wv_m"):
        return spec(None, tp)
    # everything else (norm scales, small biases, meta tokens, gates)
    return Spec(*([None] * nd))


def _fit_spec(spec: Spec, shape: tuple, mesh) -> Spec:
    """Drop sharded axes whose mesh extent does not divide the dim size
    (e.g. whisper's 51865 vocab), as the reference does for jit."""
    out = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if ax is None:
            out.append(None)
            continue
        extent = 1
        for a in _names(ax):
            extent *= _axis_size(mesh, a)
        out.append(ax if dim % extent == 0 else None)
    return Spec(*out)


#: Leaves at least this many elements get ZeRO-extended (fsdp-style 2-D)
#: sharding on the master store: tp on the model dim, dp on the largest
#: remaining dim.  The sharded train step gathers each leaf once a step
#: (ZeRO-3, as the reference's GSPMD gathers the working copy), so fp32
#: master, moments and gradients stay 2-D-sharded.
FSDP_MIN_ELEMS = 1 << 22    # 4M elements (16 MB fp32)


def zero_extend_spec(spec: Spec, shape: tuple, rules: AxisRules, *,
                     layer_axis: bool = False) -> Spec:
    """ZeRO-style extension: additionally shard the largest unsharded dim
    over the dp axes (if it divides).  Used for optimizer moments and the
    gradient accumulator.  ``layer_axis``: dim 0 is a stacked layer axis,
    which is never picked; the reference picks it where it is the largest
    (hymba-1.5b's SSM leaves: ROADMAP C23), and the port's per-layer leaves
    cannot hold such a shard."""
    if not rules.dp or rules.mesh is None:
        return spec
    used = {a for ax in spec for a in _names(ax)}
    if used & set(rules.dp):
        return spec    # dp axes already placed (idempotent)
    extent = rules.dp_size
    tail = tuple(spec) + (None,) * (len(shape) - len(spec))
    cands = [(d, i) for i, (d, ax) in enumerate(zip(shape, tail))
             if ax is None and d % extent == 0 and d >= extent
             and not (layer_axis and i == 0)]
    if not cands:
        return spec
    _, idx = max(cands)
    out = list(tail)
    out[idx] = rules.dp if len(rules.dp) > 1 else rules.dp[0]
    return Spec(*out)


def _layer_spec(spec: Spec, _i: int) -> Spec:
    if spec and spec[0] is not None:
        raise ValueError(f"{spec} shards the stacked layer axis, which the "
                         "port's per-layer leaves cannot take")
    return Spec(*spec[1:])


def per_layer_specs(specs, cfg: ModelConfig):
    """Specs of the reference's stacked layout as specs of the port's
    per-layer leaves."""
    return per_layer(specs, cfg, lambda s: s, _layer_spec)


def stacked_specs(specs, cfg: ModelConfig):
    """The inverse of :func:`per_layer_specs`: the port's per-layer specs
    (equal across a run's layers) with the layer axis in front."""
    def stack(group):
        if any(s != group[0] for s in group):
            raise ValueError(f"layers of one run differ: {group}")
        return Spec(None, *group[0])
    return stacked(specs, cfg, lambda s: s, stack)


def _stacked_param_specs(shapes, cfg: ModelConfig, rules: AxisRules):
    def go(names, leaf):
        spec = _leaf_spec(names, leaf.shape, cfg, rules)
        if rules.mesh is None:
            return spec
        if int(np.prod(leaf.shape)) >= FSDP_MIN_ELEMS:
            spec = zero_extend_spec(spec, leaf.shape, rules,
                                    layer_axis=_has_layer_axis(names))
        return _fit_spec(spec, leaf.shape, rules.mesh)
    return spec_map(go, shapes)


def _zero_extended(params, pspecs, cfg: ModelConfig, rules: AxisRules):
    shapes = shapes_from_params(params, cfg)
    return per_layer_specs(spec_map(
        lambda names, leaf, spec: zero_extend_spec(
            spec, leaf.shape, rules, layer_axis=_has_layer_axis(names)),
        shapes, stacked_specs(pspecs, cfg)), cfg)


def param_specs(params, cfg: ModelConfig, rules: AxisRules):
    """:class:`Spec` tree matching ``params`` (the port's per-layer tree;
    any tensors, ``meta`` ones too), computed on the stacked layout."""
    return per_layer_specs(
        _stacked_param_specs(shapes_from_params(params, cfg), cfg, rules), cfg)


def opt_state_specs(params, pspecs, cfg: ModelConfig, rules: AxisRules):
    """AdamW's m and v: each parameter spec ZeRO-extended (on the stacked
    shape); the step replicated."""
    mom = _zero_extended(params, pspecs, cfg, rules)
    return {"m": mom, "v": mom, "step": Spec()}


def grad_accum_specs(params, cfg: ModelConfig, rules: AxisRules):
    """Sharding for the microbatch gradient accumulator (ZeRO-2-ish)."""
    return _zero_extended(params, param_specs(params, cfg, rules), cfg, rules)


def state_specs(params, cfg: ModelConfig, rules: AxisRules):
    ps = param_specs(params, cfg, rules)
    return {"params": ps, "opt": opt_state_specs(params, ps, cfg, rules),
            "step": Spec()}


def train_batch_specs(cfg: ModelConfig, rules: AxisRules) -> dict:
    dp = rules.dp if rules.dp else None
    out = {"tokens": Spec(dp, None), "labels": Spec(dp, None)}
    if cfg.num_patch_tokens:
        out["patch_embeds"] = Spec(dp, None, None)
    if cfg.is_encdec:
        out["frames"] = Spec(dp, None, None)
    return out


def cache_specs(cfg: ModelConfig, rules: AxisRules, batch: int,
                seq_len: int = 8):
    """Decode-cache specs, one dict a layer as ``init_caches`` gives them.
    Batch over dp when it divides; otherwise sequence-parallel over every
    axis (long_500k, batch 1).  Computed on each run's stacked caches, as
    the reference's."""
    dp = rules.dp if rules.dp else ()
    tp = rules.tp
    big_batch = batch >= max(rules.dp_size, 1) and rules.dp_size > 1
    bspec = dp if big_batch else None
    # sequence axis: tp normally; everything when batch is unshardable
    sspec = tp if big_batch else (tuple(dp) + (tp,) if tp else dp) or None

    def leaf(name, shape):
        nd = len(shape)
        if name in ("k", "v"):          # (L, B, S, kv, dh)
            return Spec(None, bspec, sspec, None, None)
        if name in ("ck", "cv"):        # (L, B, S_enc, kv, dh)
            return Spec(None, bspec, None, None, None)
        if name == "conv":              # (L, B, K-1, inner)
            return Spec(None, bspec, None, tp)
        if name == "state":             # (L, B, inner, S)
            return Spec(None, bspec, tp, None)
        if name == "C":                 # mLSTM (L, B, H, dh, dh)
            return Spec(None, bspec, None, tp, None)
        if name == "n":                 # mLSTM (L,B,H,dh) / sLSTM (L,B,d)
            return Spec(None, bspec, None, tp) if nd == 4 \
                else Spec(None, bspec, tp)
        if name == "m":                 # mLSTM (L,B,H) / sLSTM (L,B,d)
            if nd == 3 and shape[-1] != cfg.num_heads:
                return Spec(None, bspec, tp)
            return Spec(None, bspec, None)
        if name in ("h", "c"):          # sLSTM (L, B, d)
            return Spec(None, bspec, tp)
        return Spec(*([None] * nd))

    caches = init_caches(cfg, batch, seq_len, device="meta")
    out, i = [], 0
    for run in build_runs(cfg):
        group = caches[i:i + run.count]
        i += run.count
        specs = {}
        for name in group[0]:
            shape = (run.count,) + tuple(group[0][name].shape)
            spec = leaf(name, shape)
            if rules.mesh is not None:
                spec = _fit_spec(spec, shape, rules.mesh)
            specs[name] = spec
        out += [{name: _layer_spec(s, 0) for name, s in specs.items()}
                for _ in range(run.count)]
    return out


# ---------------------------------------------------------------------------
# Placement on a DeviceMesh.
# ---------------------------------------------------------------------------

def placements(spec: Spec, mesh) -> list:
    """``torch.distributed.tensor`` placements of ``spec`` on ``mesh``:
    ``Shard(dim)`` on each mesh dim that the spec names, ``Replicate()``
    elsewhere.  A tensor dim sharded over several mesh dims takes them in
    the mesh's order (the nesting DTensor gives them)."""
    mesh_names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in mesh_names]
    for dim, entry in enumerate(spec):
        axes = _names(entry)
        where = [mesh_names.index(a) for a in axes]
        if where != sorted(where):
            raise ValueError(f"{spec}: {axes} are not in the mesh's order "
                             f"{tuple(mesh_names)}")
        for i in where:
            out[i] = Shard(dim)
    return out


def _placements_of(sharding, mesh):
    """``(mesh, spec)`` or ``(mesh, placements)`` as placements."""
    if isinstance(sharding, Spec):
        return placements(sharding, mesh)
    return list(sharding)


def local_region(shape, places, mesh) -> tuple:
    """This rank's slice of a tensor of ``shape`` placed by ``places``: a
    tuple of slices, ``torch.chunk``'s split (DTensor's) on each sharded
    mesh dim, the mesh dims in order."""
    coord = mesh.get_coordinate()
    start, length = [0] * len(shape), list(shape)
    for i, p in enumerate(places):
        if isinstance(p, Shard):
            n = int(mesh.size(i))
            chunk = -(-length[p.dim] // n)
            lo = min(coord[i] * chunk, length[p.dim])
            start[p.dim] += lo
            length[p.dim] = min(chunk, length[p.dim] - lo)
        elif not isinstance(p, Replicate):
            raise ValueError(f"cannot place a whole tensor as {p}")
    return tuple(slice(s, s + n) for s, n in zip(start, length))


def narrow(local, frm, to, mesh):
    """The part of ``local`` (a shard placed by ``frm``) that placement
    ``to`` gives this rank, where ``to`` adds shards over mesh dims that
    ``frm`` replicates: a view."""
    coord = mesh.get_coordinate()
    for i, (a, b) in enumerate(zip(frm, to)):
        if a == b:
            continue
        if not (isinstance(a, Replicate) and isinstance(b, Shard)):
            raise ValueError(f"{list(to)} does not refine {list(frm)}")
        n, size = int(mesh.size(i)), local.shape[b.dim]
        chunk = -(-size // n)
        lo = min(coord[i] * chunk, size)
        local = local.narrow(b.dim, lo, min(chunk, size - lo))
    return local


def place(x, sharding, mesh) -> DTensor:
    """``x`` (a tensor or numpy array, the same values on every rank) as a
    DTensor on ``mesh``, placed by ``sharding`` (a :class:`Spec` or
    placements): each rank keeps its own slice, no collective."""
    places = _placements_of(sharding, mesh)
    region = local_region(tuple(x.shape), places, mesh)
    local = (x.detach()[region] if isinstance(x, torch.Tensor)
             else torch.from_numpy(np.asarray(np.asarray(x)[region])))
    if isinstance(x, torch.Tensor) and local.numel() < x.numel():
        # a slice of its own: a view would hold all of x's memory
        local = local.clone(memory_format=torch.contiguous_format)
    if local.device.type != mesh.device_type:
        local = local.to(mesh.device_type)
    return as_dtensor(local.contiguous(), mesh, places, tuple(x.shape))


def shard_tree(tree, specs, mesh):
    """``tree`` (dicts and lists of tensors or numpy arrays) placed on
    ``mesh`` by ``specs`` (a matching tree of :class:`Spec`): the port's
    ``jax.device_put(x, NamedSharding(mesh, spec))``."""
    return spec_map(lambda _, x, spec: place(x, spec, mesh), tree, specs)


def checkpoint_shardings(specs, cfg: ModelConfig, mesh) -> dict:
    """:func:`state_specs` in the checkpoint's (the reference's stacked)
    layout as ``(mesh, spec)`` pairs: ``CheckpointManager.restore``'s
    ``shardings`` for a train state."""
    opt = specs["opt"]
    tree = {"params": stacked_specs(specs["params"], cfg),
            "opt": {"m": stacked_specs(opt["m"], cfg),
                    "v": stacked_specs(opt["v"], cfg), "step": opt["step"]},
            "step": specs["step"]}
    return spec_map(lambda _, spec: (mesh, spec), tree)


# ---------------------------------------------------------------------------
# The working copy: what the layers compute on.
# ---------------------------------------------------------------------------

def is_expert_leaf(path, cfg: ModelConfig, rules: AxisRules) -> bool:
    """An expert store leaf of the expert-parallel MoE (``models/moe.py``),
    which computes on its ``tp`` slice of the experts."""
    return (cfg.is_moe and cfg.moe_impl != "dense" and rules.tp_size > 1
            and len(path) >= 2 and path[-2] == "moe"
            and path[-1] in ("wi", "wo", "wg"))


def working_dim(path, leaf: DTensor, cfg: ModelConfig,
                rules: AxisRules) -> int | None:
    """The dim of ``leaf`` (a DTensor at ``path``) on which the layers
    compute its ``tp`` slice: ``tp_slice_dim``'s where the leaf is placed
    ``Shard`` on it over ``tp`` (a leaf placed otherwise, on another dim or
    replicated, is computed whole), 0 for an expert leaf; None where the
    layers take it whole."""
    if rules.tp_size == 1:
        return None
    placed = leaf.placements[list(rules.mesh.mesh_dim_names).index(rules.tp)]
    if is_expert_leaf(path, cfg, rules):
        if placed != Shard(0):
            raise ValueError(f"expert leaf {'/'.join(map(str, path))} is "
                             f"placed {leaf.placements}, not sharded over "
                             f"{rules.tp} on its expert dim")
        return 0
    dim = tp_slice_dim(path, cfg, rules)
    return dim if dim is not None and placed == Shard(dim) else None


def gathered(leaf: DTensor, target) -> torch.Tensor:
    """This rank's part of ``leaf`` redistributed to the placements
    ``target`` (each either ``leaf``'s or ``Replicate()``), as a local
    tensor.  Over a gloo group each shard is written into zeros and the
    zeros summed over the mesh dims gathered (all-reduces, exact: one term
    an entry): gloo all-reduces CUDA tensors but cannot all-gather them,
    and two ranks sharing one card run over gloo (ROADMAP C9).  Elsewhere
    ``DTensor.redistribute``."""
    mesh, places = leaf.device_mesh, list(leaf.placements)
    dims = [i for i, (a, b) in enumerate(zip(places, target)) if a != b]
    if not dims or any(
            dist.get_backend(mesh.get_group(i)) != "gloo" for i in dims):
        return leaf.redistribute(mesh, target).to_local()
    mine = local_region(tuple(leaf.shape), places, mesh)
    want = local_region(tuple(leaf.shape), target, mesh)
    local = leaf.to_local()
    out = local.new_zeros([w.stop - w.start for w in want])
    out[tuple(slice(m.start - w.start, m.stop - w.start)
              for m, w in zip(mine, want))] = local
    for i in dims:
        dist.all_reduce(out, group=mesh.get_group(i))
    return out


def working_leaf(leaf: DTensor, dim: int | None, rules: AxisRules):
    """``leaf`` as a local tensor: whole where ``dim`` is None, else this
    rank's ``tp`` slice, gathered over every other mesh axis
    (:func:`gathered`)."""
    if dim is None:
        return gathered(leaf, [Replicate()] * leaf.device_mesh.ndim)
    tp = list(rules.mesh.mesh_dim_names).index(rules.tp)
    return gathered(leaf, [pl if i == tp else Replicate()
                           for i, pl in enumerate(leaf.placements)])


def working_copy(params, cfg: ModelConfig, rules: AxisRules):
    """``params`` as the layers compute on them under ``rules``: each
    DTensor leaf through :func:`working_dim` and :func:`working_leaf`;
    other tensors (already local) as they are."""
    def local(path, leaf):
        if not isinstance(leaf, DTensor):
            return leaf
        return working_leaf(leaf, working_dim(path, leaf, cfg, rules), rules)
    return tree_map(local, params)
