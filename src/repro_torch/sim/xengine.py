"""The cycle engine of the port: the reference's compiled pipeline as one
fixed-shape torch step, replayed as a CUDA graph.

The reference (``repro.sim.xengine``) compiles the simulator's cycle —
eject -> route -> inject -> credit-checked link arbitration -> move — into
one JAX program over a flat state holding B fabric copies (one per
(load, seed) grid point) and loops it with ``lax.fori_loop`` /
``lax.while_loop``.  This module runs the same step on the same flat
state in torch, op for op, so that its results are *bit-identical* to the
reference's on every :class:`RunStats` field:

* **Same random bits.**  Each copy and cycle draws threefry words exactly
  as the reference does (:mod:`.threefry`): cycle key
  ``fold_in(base, c)``, copy ``b`` folded over its global copy id (copy 0
  keeps the cycle key), one word per queue lane and per terminal lane,
  and each mechanism reads the same bit range of its word.
* **Same arithmetic.**  The reference's dtypes (int16 ring-buffer
  heads/occupancies and small packed keys, int32 elsewhere); the two
  float expressions XLA:CPU contracts into one fused multiply-add (the
  adaptive policy's pressure EWMA and its detour threshold) are computed
  in float64 and rounded once to float32, which gives the same bits on
  the CPU and on the card.
* **The loop as a CUDA graph.**  One graph holds ``_BLOCK`` cycles (the
  counterpart of ``fori_loop(..., unroll=8)``) and is replayed from
  static state buffers.  The reference's loop condition becomes a
  device-side gate inside the step: a gated-off cycle changes no state,
  ``cycle`` included, so running whole blocks is bit-identical to
  stopping exactly.  A drain run reads its predicate on the host once per
  block; nothing inside the step synchronises.  The threefry keys and
  words of a whole block are drawn at its start (gating is monotone, so
  block step ``k`` that runs is cycle ``c0 + k``).  On the CPU the same
  gated blocks run eagerly.
* **Graphs kept across calls.**  A captured graph, with the buffers it
  replays onto, stays in an in-process LRU
  (:func:`repro_torch.obs.telemetry.timed_graph`, 64 entries) keyed by the
  step's static spec, the shapes of its tables and packets, and the
  device; a later sweep of the same key copies its tables, packets, base
  key and bounds into those buffers in place, resets the state in place
  and replays (``compile_cached="memory"``).  Shape bucketing (the
  reference's ``bucket=True``, the default) rounds the copies, the packet
  axis and the static horizon and cutoff up to :func:`_bucket_count`
  boundaries, so nearby sweep sizes share one graph.  Padded copies carry
  no packets, padded packet slots are never eligible, and the host loop
  stops at the runtime bounds, so a bucketed run is bit-identical to the
  exact one and runs no extra cycle.

The host side stays numpy, as in the reference: the dense next-hop table
(:meth:`SimTopology.minimal_port_table`), the index tables
(:func:`_build_tables`), traffic packing and the reconstruction of
per-packet delivery cycles from the ejection log.

Collective replays (traffic carrying a :class:`~.workloads.Workload`) run
the step's phase barrier: a phase's closing cycle is recorded by the step
in the cycle it happens, and a gated-off cycle writes none.  Degraded
fabrics (:func:`repro_torch.faults.degrade`) run the same step: their
fallback next-hop table is the port table, dead wires are unwired slots,
and Valiant mids outside the source's component collapse to the
destination.  ``trace=`` adds the reference's statically shaped ring
buffers to the state: each sampled cycle writes one row of each at the
end of the cycle, read-modify-write under the gate, so an untraced step
captures exactly the kernels it did before.

Serving traffic (a :class:`Traffic` carrying request ids) gets the
reference's per-request latency percentiles and SLO attainment, computed
on the host after the run; the request array never reaches the device.

``devices=`` splits the copies over several devices, the counterpart of
the reference's ``shard_map`` over a ``copies`` axis: each device runs
the step on its contiguous block of copies, with the packet descriptors
whole (so packet ids and copy ids stay global, and so do the threefry
streams), and the blocks' outputs are put back together on the host as
the reference's are.  The copies are disjoint fabrics, so the split is
bit-identical to one program.  :func:`_block_sweep` runs the same blocks
on any list of devices, one device as often as wanted.
"""
from __future__ import annotations

import inspect
import time
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from ..obs.telemetry import timed_graph
from ..obs.trace import Trace, TraceConfig, derive_backlog
from .engine import _DRAIN_SLACK
from .link import LinkLoadCounter, LinkTable
from .metrics import (RunStats, attach_replay, attach_serving, build_stats,
                      replay_timeline)
from .policies import RoutingPolicy, make_policy
from .threefry import fold_in, prng_key, random_bits
from .topology import SimTopology
from .traffic import Traffic, resolve_terminals

_I16, _I32, _I64 = torch.int16, torch.int32, torch.int64
_INT32_MAX = np.iinfo(np.int32).max
#: Sentinel generation cycle for padded packet slots: larger than any
#: simulated cycle, so a padded slot never becomes an injection candidate.
_PAD_GEN = _INT32_MAX
#: Hop counts saturate at this value inside the packed attribute word
#: (mid << 8 | phase << 7 | hops); hops only feed the VC-class clamp
#: ``min(hops, num_vcs - 1)``, so saturation is lossless for V <= 128.
_MAX_HOPS = 127
#: Above this many (horizon x queue-lane) entries the per-cycle ejection
#: log falls back to a per-packet scatter to bound memory.
_LOG_ENTRY_BUDGET = 48_000_000
#: Cycles per captured CUDA graph (and per eager block on the CPU).
_BLOCK = 16
#: Device types whose runs keep their graph (and its buffers) in the
#: cache across calls.  The CPU has no graph and runs uncached; tests add
#: "cpu" to run the same refill path eagerly.
_CACHE_DEVICES = ("cuda",)
#: Blocks run (graph replays on CUDA, eager blocks on the CPU) since the
#: module was imported: the host loop's trip count, read across a call.
block_runs = 0

def _bucket_count(x: int) -> int:
    """The shape-bucketing boundary at or above ``x`` (the reference's
    ``_bucket_count``): exact powers of two up to 8, multiples of 8 up to
    64, then the {2^k, 1.5 * 2^k} ladder."""
    x = max(int(x), 1)
    if x <= 8:
        return 1 << (x - 1).bit_length()
    if x <= 64:
        return (x + 7) // 8 * 8
    p = 1 << (x - 1).bit_length()          # next pow2 >= x
    if 3 * p // 4 >= x:
        return 3 * p // 4                  # the 1.5 * 2^(k-1) rung
    return p


class XSpec(NamedTuple):
    """Static engine configuration: what the step's shapes and branches
    depend on (the reference's jit cache key, and with the table and
    packet shapes the graph cache's).  ``horizon`` and ``cutoff`` are the
    bucketed static bounds; the runtime ones ride in ``pkt["lim"]``."""
    n: int
    ports: int
    vcs: int
    cap: int
    terminals: int
    eject_bw: int
    policy: str
    threshold: float
    weight: float
    alpha: float
    drain: bool
    horizon: int
    cutoff: int
    log_deliveries: bool
    #: Collective-replay mode: > 0 enables the phase barrier (packet
    #: ``gen`` is a phase ordinal, injection gates on completed phases).
    #: 0 = open-loop traffic.
    num_phases: int = 0
    #: Time-series tracing (repro_torch.obs): sample the trace ring
    #: buffers every ``trace_stride`` cycles into ``trace_samples`` rows.
    #: 0 = off, and the step then carries no trace op at all.
    trace_stride: int = 0
    trace_samples: int = 0


class _Tables(NamedTuple):
    """Constants of one run, as numpy arrays: the reference's topology
    tables plus precomputed index vectors.  Topology tables use *local*
    (per-copy) ids; index vectors span the flat replicated state
    (Q = B*N*P*V lanes, L = B*N*P links, NT = B*N*T terminal lanes)."""
    port_table: np.ndarray        # (N, N) next-hop output port
    comp_of_switch: np.ndarray    # (N,) component label (all 0 pristine)
    feeder_local: np.ndarray      # (N*P,) local link feeding port (s,i); -1
    sw_local: np.ndarray          # (Q,) local switch of each queue lane
    x_of_lane: np.ndarray         # (Q,) contender slot within the block
    vc_of_lane: np.ndarray        # (Q,) VC of each queue lane
    linkbase_of_lane: np.ndarray  # (Q,) flat link id of the block's port 0
    feeder_flat: np.ndarray       # (Q,) flat link feeding the lane's port
    feeder_xbase: np.ndarray      # (Q,) feeder's block * x (contender base)
    wired_q: np.ndarray           # (Q,) lane's input port is wired
    blk_idx: np.ndarray           # (NT,) flat (copy, switch) index
    slot_of_term: np.ndarray      # (NT,) terminal slot within the switch
    linkbase_of_term: np.ndarray  # (NT,) flat link id of the switch's port 0
    copybase_of_term: np.ndarray  # (NT,) copy * N*P (adaptive congestion)
    copybase_of_block: np.ndarray  # (B*N,) copy * N*P per switch block
    copy_of_link: np.ndarray      # (L,) copy owning each flat link


class _State(NamedTuple):
    """Flat state of all B fabric copies (see the reference's ``_State``).
    ``deliver`` keeps one dump slot past the packets and ``ej_log`` one
    dump row past the horizon, for writes a lane or cycle must not make."""
    buf: torch.Tensor              # (Q, cap, 2) ring buffers: pid, attr
    head: torch.Tensor             # (Q,) int16
    occ: torch.Tensor              # (Q,) int16
    deliver: torch.Tensor          # (M + 1,) delivery cycle, -1
    ej_log: torch.Tensor           # (horizon + 1, Q) ejected pid, -1
    term_next: torch.Tensor        # (NT,) injected count per terminal lane
    pressure: torch.Tensor         # (L,) float32 EWMA of link demand
    load_total: torch.Tensor       # (L,)
    load_window: torch.Tensor      # (L,)
    delivered_total: torch.Tensor  # (B,)
    delivered_win: torch.Tensor    # (B,)
    phase_done: torch.Tensor       # (B, num_phases) completion cycle, -1
    cycle: torch.Tensor            # () int32, shared by every copy
    # Trace ring buffers, S = spec.trace_samples rows written in place;
    # (1,)/(1, 1) dummies, never touched, when tracing is off.
    tr_cycle: torch.Tensor         # (S,) sampled cycle, -1 = unwritten
    tr_link: torch.Tensor          # (S, L) cumulative link traversals
    tr_occ: torch.Tensor           # (S, B*N) per-switch queue occupancy
    tr_inj: torch.Tensor           # (S, B*N) cumulative injections
    tr_del: torch.Tensor           # (S, B) cumulative deliveries per copy


def _key_layout(x: int) -> tuple:
    """Packed arbitration key ``[cls | rand | contender index]``: the
    index bits cover ``x`` strictly, small blocks fit the key in int16.
    Returns ``(x_bits, x_mask, key_dtype, sentinel, rand_bits)``."""
    x_bits = int(x).bit_length()
    if x_bits <= 6:
        return x_bits, (1 << x_bits) - 1, _I16, 32767, 14 - x_bits
    return (x_bits, (1 << x_bits) - 1, _I32, _INT32_MAX,
            min(30 - x_bits, 16))


def _pack_attr(mid, phase, hops):
    return (mid << 8) | (phase << 7) | torch.clamp(hops, max=_MAX_HOPS)


def _fma32(a: float, b: torch.Tensor, c) -> torch.Tensor:
    """``float32(a) * b + c`` rounded once to float32, as XLA:CPU's fused
    multiply-add does (``c`` a float32 tensor or a Python float, taken as
    float32): the float32 product is exact in float64, and the float64
    sum rounded to float32 is the fused result on any device."""
    a64 = float(np.float32(a))
    c64 = c.double() if isinstance(c, torch.Tensor) else float(np.float32(c))
    return (b.double() * a64 + c64).float()


def _resolve_policy(policy) -> RoutingPolicy:
    if isinstance(policy, RoutingPolicy):
        return policy
    if isinstance(policy, str):
        return make_policy(policy)
    if callable(policy):
        return policy()
    raise TypeError(f"cannot resolve a routing policy from {policy!r}")


def _accepts_seed(traffic_factory: Callable) -> bool:
    """True when the factory takes ``(load, seed)`` rather than ``(load)``."""
    try:
        pos = [q for q in
               inspect.signature(traffic_factory).parameters.values()
               if q.kind in (q.POSITIONAL_ONLY, q.POSITIONAL_OR_KEYWORD,
                             q.VAR_POSITIONAL)]
        return len(pos) >= 2
    except (TypeError, ValueError):
        return False


def _resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises for CUDA when there is none."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    return device


def _pack_traffic(traffic: Traffic, n: int, pid_base: int
                  ) -> dict[str, np.ndarray]:
    """The oracle Engine's packet layout — sorted by (src, gen), with
    per-switch source-FIFO block bounds — offset into the flat packet-id
    space at ``pid_base`` (reference ``_pack_traffic``)."""
    src = traffic.src.astype(np.int64)
    gen = traffic.gen.astype(np.int64)
    # All in-repo generators emit (src, gen)-sorted packets already; the
    # stable lexsort is then the identity, so skip it.
    key = src * (gen.max(initial=0) + 1) + gen
    if np.all(key[1:] >= key[:-1]):
        dst = traffic.dst
    else:
        order = np.lexsort((traffic.gen, traffic.src))
        src = src[order]
        gen = gen[order]
        dst = traffic.dst[order]
    m = src.size
    counts = np.bincount(src, minlength=n) if m else np.zeros(n, np.int64)
    blk_start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    blk_end = blk_start + counts
    return {
        "src": src.astype(np.int32),
        "dst": np.asarray(dst, dtype=np.int32),
        "gen": np.clip(gen, 0, _PAD_GEN).astype(np.int32),
        "blk_start": (blk_start + pid_base).astype(np.int32),
        "blk_end": (blk_end + pid_base).astype(np.int32),
        "m_real": np.int32(m),
    }


# ---------------------------------------------------------------------------
# The cycle step (all B fabric copies at once).
# ---------------------------------------------------------------------------

def _step(spec: XSpec, tb: dict, pkt: dict, bits: torch.Tensor,
          st: _State) -> _State:
    """One cycle of every copy: the reference's ``_step`` with its loop
    condition as the gate ``g``.  ``bits`` is this cycle's ``(B, words)``
    threefry draw.  ``ej_log``/``deliver`` and the trace buffers are
    written in place; every other field comes back new."""
    n, p, v = spec.n, spec.ports, spec.vcs
    cap, t = spec.cap, spec.terminals
    pv = p * v
    blocks = st.head.shape[0] // pv
    b = blocks // n
    q_flat = blocks * pv
    nt_flat = b * n * t
    n_links = blocks * p
    m_flat = pkt["src"].shape[0]
    x = pv + t
    x_bits, x_mask, key_dtype, sent, rand_bits = _key_layout(x)
    src, dst, gen = pkt["src"], pkt["dst"], pkt["gen"]
    c = st.cycle
    g = _gate(spec, pkt, st)
    if spec.num_phases:
        in_window = c >= pkt["warmup"]
    else:
        in_window = (c >= pkt["warmup"]) & (c < pkt["lim"][0])
    lane_bits = bits[:, :n * pv].reshape(q_flat)
    #                                  ^ high 16: ejection; low 16: arb
    term_bits = bits[:, n * pv:].reshape(nt_flat)
    #                                  ^ high bits: arb; low: Valiant mid

    # -- queue heads (a gated-off cycle sees every queue empty) -------------
    valid = (st.occ > 0) & g
    h_pair = st.buf.view(q_flat * cap, 2)[tb["lane_cap"] + st.head]
    pid = torch.where(valid, h_pair[:, 0], 0)
    h_attr = h_pair[:, 1]
    h_mid = h_attr >> 8
    h_phase = (h_attr >> 7) & 1
    h_hops = h_attr & _MAX_HOPS
    done = valid & (tb["sw_local"] == dst[pid]) & (h_phase == 1)

    # 1. ejection: up to eject_bw random winners per switch ----------------
    done2 = done.view(blocks, pv)
    if spec.eject_bw <= 0:
        ej_win = torch.zeros_like(done)
    elif pv <= 32:
        r2 = (lane_bits >> 16).to(_I32).view(blocks, pv)
        before = (r2[:, None, :] < r2[:, :, None]) | (
            (r2[:, None, :] == r2[:, :, None]) & tb["idx_before"])
        rank = (before & done2[:, None, :]).sum(dim=2)
        ej_win = (done2 & (rank < spec.eject_bw)).view(q_flat)
    else:
        e_bits = int(pv).bit_length()
        ekey = (((lane_bits >> 16) << e_bits) | tb["x_of_lane"]).to(_I32)
        ekey = torch.where(done, ekey, _INT32_MAX).view(blocks, pv)
        kth = torch.sort(ekey, dim=1).values[:, min(spec.eject_bw, pv) - 1]
        ej_win = (done2 & (ekey <= kth[:, None])).view(q_flat)

    ej_cnt = ej_win.view(b, n * pv).sum(dim=1, dtype=_I32)
    if spec.log_deliveries:
        row = torch.clamp(c, max=spec.horizon).to(_I64).view(1)
        st.ej_log.index_copy_(0, row, torch.where(ej_win, pid, -1)[None])
    else:
        st.deliver.scatter_(0, torch.where(ej_win, pid, m_flat).to(_I64),
                            c.expand(q_flat))
    occ = st.occ - ej_win.to(_I16)
    head = st.head + ej_win.to(_I16)
    delivered_total = st.delivered_total + ej_cnt
    delivered_win = st.delivered_win + torch.where(in_window, ej_cnt, 0)

    # -- phase barrier (collective replay) ---------------------------------
    if spec.num_phases:
        done_p = delivered_total[:, None] >= pkt["phase_cum"]
        phase_done = torch.where((st.phase_done < 0) & done_p & g, c,
                                 st.phase_done)
        cur_phase = done_p.sum(dim=1, dtype=_I32)
    else:
        phase_done = st.phase_done

    # 2. transit requests --------------------------------------------------
    transit = valid & ~done
    sw_q = tb["sw_local"]
    tgt = torch.where(h_phase == 1, dst[pid], h_mid)
    safe_tgt = torch.where(transit & (tgt != sw_q), tgt, tb["next_sw"])
    t_port = tb["port_flat"][tb["sw_row"] + safe_tgt]

    # 3. injection candidates + policy itinerary ---------------------------
    cand = pkt["term_start"] + st.term_next * t
    inj_valid = (cand < pkt["term_end"]) & g
    ip = torch.where(inj_valid, cand, 0)
    if spec.num_phases:
        inj_valid = inj_valid & (gen[ip] <= cur_phase[tb["copy_of_term"]])
    else:
        inj_valid = inj_valid & (gen[ip] <= c)

    i_mid = dst[ip]
    i_phase = torch.ones(nt_flat, dtype=_I32, device=c.device)
    pressure = st.pressure
    if spec.policy != "minimal" and n >= 3:
        # Uniform intermediate avoiding {src, dst} (shift-remap).
        s_i, d_i = src[ip], dst[ip]
        lo = torch.minimum(s_i, d_i)
        hi = torch.maximum(s_i, d_i)
        r = ((term_bits & 0x3FFF) % (n - 2)).to(_I32)
        r = r + (r >= lo).to(_I32)
        r = r + (r >= hi).to(_I32)
        ok = tb["comp_of_switch"][r] == tb["comp_of_switch"][s_i]
        if spec.policy == "valiant":
            i_mid = torch.where(ok, r, d_i)
            i_phase = torch.where(ok, 0, 1).to(_I32)
        else:  # adaptive: congestion-threshold detour (UGAL-style)
            per_port_occ = occ.view(n_links, v).sum(dim=1, dtype=_I32)
            base = tb["copybase_of_term"]

            def congestion(port_local):
                link_local = s_i * p + port_local
                backlog = per_port_occ[
                    base + tb["feeder_local"][link_local]]
                return st.pressure[base + link_local] + backlog

            safe_d = torch.where(d_i != s_i, d_i, (s_i + 1) % n)
            c_min = congestion(tb["port_flat"][s_i * n + safe_d])
            c_val = congestion(tb["port_flat"][s_i * n + r])
            detour = (c_min > _fma32(spec.weight, c_val, spec.threshold)
                      ) & ok
            i_mid = torch.where(detour, r, d_i)
            i_phase = torch.where(detour, 0, 1).to(_I32)

    i_tgt = torch.where(i_phase == 1, dst[ip], i_mid)
    i_src = src[ip]
    i_tgt = torch.where(i_tgt != i_src, i_tgt, (i_src + 1) % n)
    i_port = tb["port_flat"][i_src * n + i_tgt]

    # 4. link arbitration with credit check --------------------------------
    # Contender block per switch: its pv queue heads then its t terminals.
    act = torch.cat([transit.view(blocks, pv),
                     inj_valid.view(blocks, t)], dim=1)
    port_x = torch.cat([t_port.view(blocks, pv),
                        i_port.view(blocks, t)], dim=1)
    pid_x = torch.cat([pid.view(blocks, pv), ip.view(blocks, t)], dim=1)
    attr_x = torch.cat([
        _pack_attr(h_mid, h_phase, h_hops + 1).view(blocks, pv),
        _pack_attr(i_mid, i_phase, i_phase.new_ones(())).view(blocks, t)],
        dim=1)
    vc_x = torch.clamp((attr_x & _MAX_HOPS) - 1, max=v - 1)

    # Credit check against the downstream (port, VC) queue of each
    # contender's requested link; unwired slots are credit-starved.
    link_local_x = torch.cat([(sw_q * p + t_port).view(blocks, pv),
                              (i_src * p + i_port).view(blocks, t)], dim=1)
    fl = tb["feeder_local"][link_local_x]
    dq = (tb["copybase_of_block"][:, None] + fl) * v + vc_x
    feas = act & (fl >= 0) & (occ[dq] < cap)

    # Arbitration randomness: transit lanes use the low half of their
    # lane word, terminal lanes the top of theirs.
    rand = torch.cat([
        ((lane_bits & 0xFFFF) >> (16 - rand_bits)).view(blocks, pv),
        (term_bits >> (32 - rand_bits)).view(blocks, t)], dim=1)
    packed = ((((tb["cls_x"] << rand_bits) | rand) << x_bits)
              | tb["arange_x"]).to(key_dtype)
    # (blocks, x, p) one-hot expansion; one min-reduction per port gives
    # the winning key and the winner's contender index in its low bits.
    on_port = port_x[:, :, None] == tb["arange_p"]
    key_m = torch.where(feas[:, :, None] & on_port, packed[:, :, None],
                        sent)
    minval_flat = key_m.amin(dim=1).reshape(n_links).to(_I32)

    if spec.policy == "adaptive":
        # EWMA of requested (pre-credit) demand — only adaptive reads it.
        demand = (act[:, :, None] & on_port).sum(dim=1,
                                                 dtype=_I32).view(n_links)
        new_p = _fma32(spec.alpha, demand.float() - st.pressure, st.pressure)
        pressure = torch.where(g, new_p, st.pressure)

    # 5. movement ----------------------------------------------------------
    win_t = transit & ((minval_flat[tb["linkbase_of_lane"] + t_port]
                        & x_mask) == tb["x_of_lane"])
    occ = occ - win_t.to(_I16)
    head = head + win_t.to(_I16)

    i_win = inj_valid & ((minval_flat[tb["linkbase_of_term"] + i_port]
                          & x_mask) == pv + tb["slot_of_term"])
    term_next = st.term_next + i_win.to(_I32)

    # Push as a gather: queue (sw', p', vc') receives the winner of its
    # feeder link when the VC matches.  A sentinel's index field points
    # past its block, so the gather index is clamped (its row is masked).
    mv = minval_flat[tb["feeder_flat"]]
    recv_x = torch.clamp(tb["feeder_xbase"] + (mv & x_mask),
                         max=blocks * x - 1)
    pair_x = torch.stack([pid_x.to(_I32), attr_x.to(_I32)],
                         dim=-1).view(blocks * x, 2)
    pair_w = pair_x[recv_x]
    pid_w, attr_w = pair_w[:, 0], pair_w[:, 1]
    vc_w = torch.clamp((attr_w & _MAX_HOPS) - 1, max=v - 1)
    recv = tb["wired_q"] & (mv != sent) & (vc_w == tb["vc_of_lane"])
    # Phase flips on arrival at the Valiant intermediate.
    attr_w = torch.where(((attr_w & (1 << 7)) == 0)
                         & ((attr_w >> 8) == tb["sw_local"]),
                         attr_w | (1 << 7), attr_w)

    slot = (head + occ) % cap
    onehot = (tb["arange_cap"] == slot[:, None]) & recv[:, None]
    buf = torch.where(onehot[:, :, None],
                      torch.stack([pid_w, attr_w], dim=-1)[:, None, :],
                      st.buf)
    occ = occ + recv.to(_I16)
    head = head % cap

    has_w = minval_flat != sent
    load_total = st.load_total + has_w.to(_I32)
    load_window = st.load_window + (
        has_w & in_window[tb["copy_of_link"]]).to(_I32)

    # -- trace sampling (end of cycle c, after movement) -------------------
    # The row index is clamped, so a row is read first and replaced only
    # when this cycle really runs (g) and samples: a gated-off tail cycle
    # of the last block must not overwrite the last row.
    if spec.trace_stride:
        stride = spec.trace_stride
        row = torch.clamp(c // stride, max=spec.trace_samples - 1
                          ).to(_I64).view(1)
        write = g & ((c % stride) == 0) & (c // stride < spec.trace_samples)
        for buf_t, vec in (
                (st.tr_cycle, c.view(1)),
                (st.tr_link, load_total),
                (st.tr_occ, occ.view(blocks, pv).sum(dim=1, dtype=_I32)),
                (st.tr_inj, term_next.view(blocks, t).sum(dim=1, dtype=_I32)),
                (st.tr_del, delivered_total)):
            cur = buf_t.index_select(0, row)
            buf_t.index_copy_(0, row, torch.where(
                write, vec.view(cur.shape).to(buf_t.dtype), cur))

    return _State(buf=buf, head=head, occ=occ, deliver=st.deliver,
                  ej_log=st.ej_log, term_next=term_next, pressure=pressure,
                  load_total=load_total, load_window=load_window,
                  delivered_total=delivered_total,
                  delivered_win=delivered_win, phase_done=phase_done,
                  cycle=c + g.to(_I32), tr_cycle=st.tr_cycle,
                  tr_link=st.tr_link, tr_occ=st.tr_occ, tr_inj=st.tr_inj,
                  tr_del=st.tr_del)


def _gate(spec: XSpec, pkt: dict, st: _State) -> torch.Tensor:
    """The reference's loop condition on the device: ``cycle < h_eff``,
    and in a drain run also while packets are undelivered before the
    cutoff.  ``pkt["lim"]`` holds ``(h_eff, cutoff)``."""
    g = st.cycle < pkt["lim"][0]
    if spec.drain:
        g = g | ((st.delivered_total.sum() < pkt["total_m"])
                 & (st.cycle < pkt["lim"][1]))
    return g


def _block_bits(spec: XSpec, tb: dict, pkt: dict, cycle: torch.Tensor,
                k: int) -> torch.Tensor:
    """The threefry words of cycles ``cycle .. cycle + k - 1``, shape
    ``(k, B, n*P*V + n*T)``: cycle key ``fold_in(base, c)``, copy ``b``
    folded over its copy id except copy 0 (reference ``_step``)."""
    n, pv, t = spec.n, spec.ports * spec.vcs, spec.terminals
    cyc = cycle + torch.arange(k, dtype=_I64, device=cycle.device)
    ck = fold_in(tb["base_key"], cyc)                        # (k, 2)
    copy_id = pkt["copy_id"]
    folded = fold_in(ck[:, None, :], copy_id[None, :])       # (k, B, 2)
    keys = torch.where((copy_id == 0)[None, :, None], ck[:, None, :], folded)
    return random_bits(keys, n * pv + n * t, tb["counter"])


def _block(spec: XSpec, tb: dict, pkt: dict, state: _State,
           pred: torch.Tensor, k: int) -> None:
    """``k`` gated cycles on the static ``state``, updated in place, and
    the loop predicate after them into ``pred``.  The threefry words of
    all ``k`` cycles are drawn first: cycle ``c0 + j`` is what block step
    ``j`` runs, whenever it runs at all (gating is monotone)."""
    bits = _block_bits(spec, tb, pkt, state.cycle, k)
    st = state
    for j in range(k):
        st = _step(spec, tb, pkt, bits[j], st)
    for old, new in zip(state, st):
        if new is not old:
            old.copy_(new)
    pred.copy_(_gate(spec, pkt, state))


#: The value every element of a state field holds at cycle 0: -1 marks
#: an empty ring slot, an undelivered packet, an unwritten ejection-log
#: or trace row and an open phase; every other field starts at 0.
_STATE_FILL = {"buf": -1, "deliver": -1, "ej_log": -1, "phase_done": -1,
               "tr_cycle": -1}


def _reset_state(state: _State) -> None:
    """Every field of ``state`` back to its cycle-0 value, in place: the
    ring buffers, heads and occupancies, the delivery record and ejection
    log, the injection counts, the adaptive pressure, the link-load and
    delivery counters, the phase record, the cycle and the trace rings.
    A graph replays onto these very tensors, so none may be rebound."""
    for name, t in zip(_State._fields, state):
        t.fill_(_STATE_FILL.get(name, 0))


def _init_state(spec: XSpec, tb: dict, pkt: dict) -> _State:
    """The state at cycle 0, on the tables' device."""
    n, p, v = spec.n, spec.ports, spec.vcs
    dev = tb["port_flat"].device
    b = pkt["copy_id"].shape[0]
    bq = b * n * p * v
    m_flat = pkt["src"].shape[0]
    empty = lambda *shape, dt=_I32: torch.empty(  # noqa: E731
        shape, dtype=dt, device=dev)
    s = spec.trace_samples if spec.trace_stride else 0
    rows = lambda width: (s, width) if s else (1, 1)  # noqa: E731
    state = _State(
        buf=empty(bq, spec.cap, 2),
        head=empty(bq, dt=_I16),
        occ=empty(bq, dt=_I16),
        deliver=empty(m_flat + 1 if not spec.log_deliveries else 1),
        ej_log=empty(spec.horizon + 1 if spec.log_deliveries else 1, bq),
        term_next=empty(b * n * spec.terminals),
        pressure=empty(b * n * p, dt=torch.float32),
        load_total=empty(b * n * p),
        load_window=empty(b * n * p),
        delivered_total=empty(b),
        delivered_win=empty(b),
        phase_done=empty(b, spec.num_phases),
        cycle=empty(),
        tr_cycle=empty(max(s, 1)),
        tr_link=empty(*rows(b * n * p)),
        tr_occ=empty(*rows(b * n)),
        tr_inj=empty(*rows(b * n)),
        tr_del=empty(*rows(b)))
    _reset_state(state)
    return state


def _capture(spec: XSpec, tb: dict, pkt: dict, state: _State,
             pred: torch.Tensor, block: int,
             keep_graph: bool = False) -> "torch.cuda.CUDAGraph":
    """One ``block``-cycle :func:`_block` captured as a CUDA graph over the
    static ``state``, on its device.  It is warmed up first on a side
    stream with the gate shut (``lim`` = 0: no cycle runs, no state
    changes).  ``keep_graph`` keeps the graph's node list readable
    (``raw_cuda_graph``) after the capture."""
    dev = state.cycle.device
    lim = pkt["lim"].clone()
    pkt["lim"].zero_()
    with torch.cuda.device(dev):
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            _block(spec, tb, pkt, state, pred, block)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph(keep_graph=keep_graph)
        with torch.cuda.graph(graph):
            _block(spec, tb, pkt, state, pred, block)
    pkt["lim"].copy_(lim)
    return graph


class _Graph(NamedTuple):
    """A captured block and the buffers it replays onto: the tables, the
    packets, the state and the loop predicate.  ``run`` is the graph's
    replay on CUDA, the same block run eagerly on the CPU."""
    tb: dict
    pkt: dict
    state: _State
    pred: torch.Tensor
    run: Callable[[], None]


def _shapes(d: dict) -> tuple:
    return tuple((k, tuple(t.shape), str(t.dtype)) for k, t in d.items())


def _run_loop(spec: XSpec, tb: dict, pkt: dict, *, block: int = _BLOCK,
              grid_points: int = 1) -> tuple[dict, dict]:
    """One run on one block of copies: :func:`_run_blocks` of
    ``[(tb, pkt)]``."""
    return _run_blocks(spec, [(tb, pkt)], block=block,
                       grid_points=grid_points)


def _run_blocks(spec: XSpec, blocks: list, *, block: int = _BLOCK,
                grid_points: int = 1) -> tuple[dict, dict]:
    """One run: the gated cycle loop on each block ``(tb, pkt)`` of
    copies, on the block's device, and the output dict (numpy) with the
    timing record.  On CUDA the ``block``-cycle step is captured as a CUDA
    graph and replayed, and the graph is kept for the next call of the
    same key (:func:`repro_torch.obs.telemetry.timed_graph`); on the CPU
    the block runs eagerly.  Each round replays every block once before
    the host reads any drain predicate, so blocks on several cards
    overlap.  A block stops at the runtime bounds in ``pkt["lim"]``, or
    when its own copies have drained, never at the bucketed static
    horizon.  Several blocks' outputs are put back together as the
    reference's ``sweep`` does after its ``shard_map``."""

    def entry(i: int, tb: dict, pkt: dict):
        dev = tb["port_flat"].device

        def capture() -> _Graph:
            state = _init_state(spec, tb, pkt)
            pred = torch.ones((), dtype=torch.bool, device=dev)
            if dev.type == "cuda":
                run = _capture(spec, tb, pkt, state, pred, block).replay
            else:
                def run():
                    _block(spec, tb, pkt, state, pred, block)
            return _Graph(tb, pkt, state, pred, run)

        def refill(g: _Graph) -> None:
            # The graph reads only these tensors, at fixed addresses, so
            # every one is overwritten in place.  g.tb: the topology and
            # index tables and the threefry base key; g.pkt: src/dst/gen,
            # the terminal block bounds, copy ids, warm-ups, lim (h_eff,
            # cutoff), total_m and phase_cum; then g.state (every field,
            # see _reset_state).  g.pred is written by every block before
            # the host reads it.
            for new, old in ((tb, g.tb), (pkt, g.pkt)):
                for k, t in new.items():
                    old[k].copy_(t)
            _reset_state(g.state)

        # the block count and index key the graph too: two blocks on one
        # device never share one
        key = ((spec, str(dev), block, len(blocks), i, _shapes(tb),
                _shapes(pkt)) if dev.type in _CACHE_DEVICES else None)
        return key, capture, refill

    def execute(graphs: list) -> dict:
        global block_runs
        h_eff, cutoff = (int(a) for a in graphs[0].pkt["lim"].tolist())
        if spec.drain:
            trips = -(-max(h_eff, cutoff) // block) + 1
        else:
            trips = -(-h_eff // block)
        live = list(graphs)
        for _ in range(trips):
            for g in live:
                g.run()
                block_runs += 1
            if spec.drain:
                live = [g for g in live if bool(g.pred.item())]
                if not live:
                    break
        outs = [_outputs(spec, g) for g in graphs]
        return outs[0] if len(outs) == 1 else _reassemble(outs)

    return timed_graph([entry(i, tb, pkt) for i, (tb, pkt) in
                        enumerate(blocks)], execute,
                       devices=[tb["port_flat"].device for tb, _ in blocks],
                       grid_points=grid_points)


def _outputs(spec: XSpec, g: _Graph) -> dict:
    """A finished block's outputs, copied to the host (the next call of
    its key overwrites the buffers)."""
    st = g.state
    b = g.pkt["copy_id"].shape[0]
    out = {
        "deliver": st.deliver[:g.pkt["src"].shape[0]],
        "ej_log": st.ej_log[:spec.horizon],
        "load_total": st.load_total,
        "load_window": st.load_window,
        "delivered_total": st.delivered_total,
        "delivered_in_window": st.delivered_win,
        "phase_done": st.phase_done,
        "cycle": st.cycle,
        "in_flight": st.occ.view(b, -1).sum(dim=1, dtype=_I32),
    }
    if spec.trace_stride:
        out.update(tr_cycle=st.tr_cycle, tr_link=st.tr_link,
                   tr_occ=st.tr_occ, tr_inj=st.tr_inj, tr_del=st.tr_del)
    return {k: a.to("cpu", copy=True).numpy() for k, a in out.items()}


def _reassemble(outs: list) -> dict:
    """The blocks' outputs as one program's (the reference's host
    reassembly): delivery records hold global packet ids, disjoint across
    blocks and -1 elsewhere, so their max merges them; ejection-log rows
    join along the lane axis; per-copy and per-link vectors and the phase
    record join in copy order; the cycle is the last block's to stop.  A
    traced run is one block, so no trace ring is joined."""
    out = {"deliver": np.max([o["deliver"] for o in outs], axis=0),
           "ej_log": np.concatenate([o["ej_log"] for o in outs], axis=1),
           "cycle": np.max([o["cycle"] for o in outs])}
    for k in ("load_total", "load_window", "delivered_total",
              "delivered_in_window", "in_flight", "phase_done"):
        out[k] = np.concatenate([o[k] for o in outs])
    return out


# ---------------------------------------------------------------------------
# Host-side API.
# ---------------------------------------------------------------------------

def _default_num_vcs(topo: SimTopology, policy: RoutingPolicy) -> int:
    return topo.diameter * (2 if policy.vc_required > 1 else 1)


def _build_tables(topo: SimTopology, links: LinkTable, b: int,
                  terminals: int, num_vcs: int) -> _Tables:
    """Topology tables + flat index vectors for ``b`` fabric copies
    (reference ``_build_tables``, as numpy)."""
    n, p, v, t = topo.num_switches, topo.num_ports, num_vcs, terminals
    pv, x = p * v, p * v + terminals
    nbr = links.neighbor_flat.astype(np.int64)
    rev = links.rev_flat.astype(np.int64)
    feeder_local = np.where(nbr >= 0, nbr * p + rev, -1)

    lanes = np.arange(b * n * pv, dtype=np.int64)
    copy_of_lane = lanes // (n * pv)
    block_of_lane = lanes // pv
    qport_local = (lanes % (n * pv)) // v
    f_local = feeder_local[qport_local]
    feeder_flat = np.clip(copy_of_lane * (n * p) + f_local, 0,
                          b * n * p - 1)
    ti = np.arange(b * n * t, dtype=np.int64)
    term_block = ti // t
    link_ids = np.arange(b * n * p, dtype=np.int64)
    faults = (topo.meta or {}).get("faults")
    comp = (faults["comp"] if faults is not None
            else np.zeros(n, dtype=np.int64))
    as_i32 = lambda a: np.asarray(a, np.int32)  # noqa: E731
    return _Tables(
        port_table=as_i32(topo.minimal_port_table()),
        comp_of_switch=as_i32(comp),
        feeder_local=as_i32(feeder_local),
        sw_local=as_i32((lanes % (n * pv)) // pv),
        x_of_lane=as_i32(lanes % pv),
        vc_of_lane=as_i32(lanes % v),
        linkbase_of_lane=as_i32(block_of_lane * p),
        feeder_flat=as_i32(feeder_flat),
        feeder_xbase=as_i32((feeder_flat // p) * x),
        wired_q=np.asarray(f_local >= 0),
        blk_idx=as_i32(term_block),
        slot_of_term=as_i32(ti % t),
        linkbase_of_term=as_i32(term_block * p),
        copybase_of_term=as_i32((ti // (n * t)) * (n * p)),
        copybase_of_block=as_i32((np.arange(b * n) // n) * (n * p)),
        copy_of_link=as_i32(link_ids // (n * p)))


def _device_tables(spec: XSpec, tables: _Tables, seed_key: int,
                   device: torch.device) -> dict:
    """The tables on ``device``, plus the constants the step would
    otherwise rebuild every cycle (iotas, the flat next-hop table, row
    offsets) and the run's base threefry key."""
    n, p, v, t = spec.n, spec.ports, spec.vcs, spec.terminals
    pv = p * v
    tb = {k: torch.as_tensor(a, device=device)
          for k, a in tables._asdict().items()}
    sw = tables.sw_local.astype(np.int64)
    idx = np.arange(pv)
    words = n * pv + n * t
    tb.update(
        port_flat=tb.pop("port_table").reshape(-1),
        sw_row=torch.as_tensor(sw * n, dtype=_I32, device=device),
        next_sw=torch.as_tensor((sw + 1) % n, dtype=_I32, device=device),
        lane_cap=torch.arange(sw.size, dtype=_I64,
                              device=device) * spec.cap,
        copy_of_term=torch.as_tensor(
            tables.copybase_of_term.astype(np.int64) // (n * p),
            dtype=_I64, device=device),
        idx_before=torch.as_tensor(idx[None, :] < idx[:, None],
                                   device=device),
        cls_x=torch.as_tensor((np.arange(pv + t) >= pv)[None, :],
                              dtype=_I64, device=device),
        arange_x=torch.arange(pv + t, dtype=_I64, device=device)[None, :],
        arange_p=torch.arange(p, dtype=_I32, device=device),
        arange_cap=torch.arange(spec.cap, dtype=_I16,
                                device=device)[None, :],
        counter=torch.arange(words, dtype=_I64, device=device),
        base_key=prng_key(seed_key, device=device))
    return tb


class _Prepared(NamedTuple):
    """A sweep ready to run: the step's spec, each block's tables and
    packets ``(tb, pkt)`` on its device, and what the host needs to turn
    the output into RunStats.  ``tb`` and ``pkt`` are the first block's
    (a sweep on one device has one block)."""
    spec: XSpec
    blocks: list
    topo: SimTopology
    policy: RoutingPolicy
    grid: list
    packed: list
    workloads: list
    bases: np.ndarray
    links: LinkTable
    horizon: int
    warmups: list
    terminals: int
    n_seeds: int
    trace: TraceConfig | None
    host_s: float

    @property
    def tb(self) -> dict:
        return self.blocks[0][0]

    @property
    def pkt(self) -> dict:
        return self.blocks[0][1]


def _resolve_devices(devices, device: torch.device) -> int:
    """How many blocks of copies a sweep on ``device`` runs (the
    reference's ``_resolve_devices``): ``None`` or 1 one; ``"auto"`` every
    visible device of ``device``'s type (``torch.cuda.device_count()`` for
    CUDA, 1 for the CPU, the reference's one host device); an int is
    checked against that count."""
    if devices is None:
        return 1
    avail = torch.cuda.device_count() if device.type == "cuda" else 1
    if devices == "auto":
        return max(avail, 1)
    ndev = int(devices)
    if ndev < 1:
        raise ValueError(f"devices={devices!r} must be >= 1")
    if ndev > avail:
        raise ValueError(f"devices={ndev} but only {avail} {device.type} "
                         f"device(s) are visible")
    return ndev


def _prepare(topo: SimTopology, policy, traffic_factory: Callable,
             loads: Sequence[float], *, seeds: Sequence[int] = (0,),
             terminals: int | None = None, eject_bw: int | None = None,
             num_vcs: int | None = None, queue_capacity: int = 4,
             cycles: int | None = None, warmup: int | None = None,
             drain: bool | None = None, max_cycles: int | None = None,
             trace=None, bucket: bool | None = None, devices=None,
             device="cuda", block_devices=None) -> _Prepared | None:
    """The host side of :func:`sweep` up to the run (None for an empty
    grid): option checks, traffic packing, bucketing, tables, device
    upload.  The copies go in one block a device: ``devices`` of
    ``device``'s type (:func:`_resolve_devices`), or one a device of
    ``block_devices`` where given (:func:`_block_sweep`).  A traced run
    keeps one block, as the reference's does."""
    t_host = time.perf_counter()
    trace_cfg = TraceConfig.coerce(trace)
    if block_devices is None:
        device = _resolve_device(device)
        ndev = 1 if trace_cfg is not None else _resolve_devices(devices,
                                                                device)
        block_devices = ([device] if ndev == 1 else
                         [torch.device(device.type, i) for i in range(ndev)])
    else:
        block_devices = [_resolve_device(d) for d in block_devices]
        if trace_cfg is not None:
            block_devices = block_devices[:1]
    ndev = len(block_devices)
    policy = _resolve_policy(policy)
    seeded_factory = _accepts_seed(traffic_factory)
    n = topo.num_switches
    grid: list[tuple[float, int, Traffic]] = []
    for load in loads:
        for seed in seeds:
            tr = (traffic_factory(load, seed) if seeded_factory
                  else traffic_factory(load))
            grid.append((load, seed, tr))
    if not grid:
        return None

    resolved_t = {resolve_terminals(tr, terminals) for _, _, tr in grid}
    if len(resolved_t) > 1:
        raise ValueError(
            f"a batched sweep shares one injector count across the grid "
            f"but the traffic objects record terminals="
            f"{sorted(resolved_t)}; use one terminals value per sweep")
    terminals = resolved_t.pop()

    # Collective replays (traffic.workload set) run the phase barrier:
    # all-or-none across the grid (the barrier changes the injection
    # gate's meaning), one static phase-window count.
    wls = [tr.workload for _, _, tr in grid]
    replaying = any(w is not None for w in wls)
    if replaying and not all(w is not None for w in wls):
        raise ValueError("a batched sweep cannot mix collective-replay "
                         "workloads with open-loop traffic")
    num_phases = (max(w.num_phases for w in wls) if replaying else 0)
    replaying = num_phases > 0

    if drain is None:
        drain = all(tr.offered == 0 for _, _, tr in grid)
    if num_vcs is None:
        num_vcs = _default_num_vcs(topo, policy)
    if num_vcs > _MAX_HOPS + 1:
        raise ValueError(f"the cycle engine packs hop counts into 7 bits; "
                         f"num_vcs={num_vcs} is out of range")

    sizes = [tr.num_packets for _, _, tr in grid]
    bases = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    packed = [_pack_traffic(tr, n, int(bases[i]))
              for i, (_, _, tr) in enumerate(grid)]
    if cycles is not None:
        horizon = int(cycles)
    else:
        windows = {max(tr.horizon, 1) for _, _, tr in grid}
        horizon = int(max(windows))
        if len(windows) > 1:
            import warnings
            warnings.warn(
                f"batched sweep derived a shared horizon of {horizon} "
                f"cycles from traffic windows {sorted(windows)}; points "
                f"with shorter generation windows are still measured over "
                f"the shared horizon, which dilutes their accepted "
                f"throughput — pass cycles= to pin one window",
                stacklevel=2)
    default_warmup = 0 if replaying else horizon // 4
    warmups = [default_warmup if warmup is None else warmup] * len(grid)
    cutoff = int(max_cycles if max_cycles is not None
                 else horizon + _DRAIN_SLACK)
    bucket = True if bucket is None else bool(bucket)
    b_real = len(grid)
    b = _bucket_count(b_real) if bucket else b_real
    b = -(-b // ndev) * ndev            # whole blocks of copies a device
    bb = b // ndev
    h_static = _bucket_count(horizon) if bucket else horizon
    c_static = max(_bucket_count(cutoff) if bucket else cutoff, h_static)
    q_flat = b * n * topo.num_ports * num_vcs
    log_deliveries = (not drain
                      and h_static * q_flat <= _LOG_ENTRY_BUDGET)
    if trace_cfg is not None:
        # A drain run can stop anywhere below the cutoff, so rows are
        # allocated for the worst case (capped by max_samples); unwritten
        # rows keep the -1 cycle and are dropped on the host.  Budgets
        # derive from the exact span: padded cycles never run.
        span = cutoff if drain else horizon
        trace_samples = min(trace_cfg.max_samples,
                            (max(span, 1) - 1) // trace_cfg.stride + 1)
    spec = XSpec(
        n=n, ports=topo.num_ports, vcs=num_vcs, cap=queue_capacity,
        terminals=terminals,
        eject_bw=terminals if eject_bw is None else eject_bw,
        policy=policy.name,
        threshold=float(getattr(policy, "threshold", 0.0)),
        weight=float(getattr(policy, "weight", 0.0)),
        alpha=0.05, drain=bool(drain), horizon=h_static, cutoff=c_static,
        log_deliveries=log_deliveries, num_phases=num_phases,
        trace_stride=0 if trace_cfg is None else trace_cfg.stride,
        trace_samples=0 if trace_cfg is None else trace_samples)

    links = LinkTable.for_topology(topo, num_vcs)
    tables = _build_tables(topo, links, bb, terminals, num_vcs)
    flat_np = {k: (np.concatenate([pk[k] for pk in packed])
                   if packed[0][k].ndim else
                   np.asarray([pk[k] for pk in packed]))
               for k in packed[0]}
    # Bucket the flat packet axis with inert slots, at least one (the
    # all-empty grid's gathers need one in range): a padded slot's
    # generation time is past any horizon.  Padded copies carry empty
    # source blocks, no real packets, warm-up 0 and empty phases.
    m_total = int(flat_np["src"].size)
    m_pad = _bucket_count(max(m_total, 1)) if bucket else max(m_total, 1)
    pad_m, pad_b = m_pad - m_total, b - b_real
    flat_np["src"] = np.concatenate([flat_np["src"],
                                     np.zeros(pad_m, np.int32)])
    flat_np["dst"] = np.concatenate([flat_np["dst"],
                                     np.full(pad_m, min(1, n - 1), np.int32)])
    flat_np["gen"] = np.concatenate([flat_np["gen"],
                                     np.full(pad_m, _PAD_GEN, np.int32)])
    for k in ("blk_start", "blk_end"):
        flat_np[k] = np.concatenate([flat_np[k],
                                     np.zeros(pad_b * n, np.int32)])
    flat_np["m_real"] = np.concatenate([flat_np["m_real"],
                                        np.zeros(pad_b, np.int32)])
    flat_np["warmup"] = np.asarray(warmups + [0] * pad_b)
    if replaying:
        # Per-copy cumulative phase sizes, padded to the shared static
        # phase count (padding phases are empty and complete at once).
        flat_np["phase_cum"] = np.concatenate(
            [np.stack([w.phase_cum(num_phases) for w in wls]),
             np.zeros((pad_b, num_phases))])
    seed_key = hash(tuple(s for _, s, _ in grid)) & 0x7FFFFFFF
    blk = tables.blk_idx
    blocks = []
    for j, dev in enumerate(block_devices):
        # Block j: copies j*bb .. (j+1)*bb - 1; the packets whole, so
        # packet ids and copy ids (the threefry fold keys) stay global.
        lo, hi = j * bb, (j + 1) * bb
        as_dev = lambda a, dt=_I32: torch.as_tensor(  # noqa: E731
            np.asarray(a), dtype=dt, device=dev)
        pkt = {
            "src": as_dev(flat_np["src"]),
            "dst": as_dev(flat_np["dst"]),
            "gen": as_dev(flat_np["gen"]),
            "term_start": as_dev(flat_np["blk_start"][lo * n:hi * n][blk]
                                 + tables.slot_of_term),
            "term_end": as_dev(flat_np["blk_end"][lo * n:hi * n][blk]),
            "copy_id": as_dev(np.arange(lo, hi), _I64),
            "warmup": as_dev(flat_np["warmup"][lo:hi]),
            "lim": as_dev([horizon, cutoff]),
            "total_m": as_dev(int(flat_np["m_real"][lo:hi].sum())),
        }
        if replaying:
            pkt["phase_cum"] = as_dev(flat_np["phase_cum"][lo:hi])
        blocks.append((_device_tables(spec, tables, seed_key, dev), pkt))
    host_s = time.perf_counter() - t_host
    return _Prepared(spec=spec, blocks=blocks, topo=topo, policy=policy,
                     grid=grid, packed=packed,
                     workloads=wls if replaying else [None] * len(grid),
                     bases=bases, links=links,
                     horizon=horizon, warmups=warmups, terminals=terminals,
                     n_seeds=len(seeds), trace=trace_cfg, host_s=host_s)


def _collect(run: _Prepared, out: dict, timing: dict
             ) -> list[list[RunStats]]:
    """The ``[load][seed]`` grid of RunStats from a run's output (the
    reference's host-side tail of ``sweep``)."""
    spec, topo, policy, grid = run.spec, run.topo, run.policy, run.grid
    packed, bases, horizon = run.packed, run.bases, run.horizon
    n, drain, terminals = spec.n, spec.drain, run.terminals
    sizes = [int(pk["m_real"]) for pk in packed]

    total_m = max(1, int(sum(sizes)))
    if spec.log_deliveries:
        # Reconstruct per-packet delivery cycles from the per-cycle
        # ejection log: row c holds the pids ejected at cycle c.
        log = out["ej_log"].ravel()
        q_per_cycle = out["ej_log"].shape[1]
        deliver_all = np.full(total_m, -1, np.int64)
        hit = np.flatnonzero(log >= 0)
        deliver_all[log[hit]] = hit // q_per_cycle
    else:
        deliver_all = out["deliver"].astype(np.int64)

    n_links = n * topo.num_ports
    if run.trace is not None:
        tr_valid = np.flatnonzero(out["tr_cycle"] >= 0)
        tr_cycles = out["tr_cycle"][tr_valid].astype(np.int64)
    results: list[RunStats] = []
    for i, (load, seed, tr) in enumerate(grid):
        m = int(packed[i]["m_real"])
        delivered_total = int(out["delivered_total"][i])
        if drain and delivered_total < m:
            raise RuntimeError(
                f"{topo.name}/{policy.name}: {m - delivered_total} packets "
                f"undelivered after {int(out['cycle'])} cycles "
                f"(deadlock or cutoff too small)")
        counter = LinkLoadCounter(run.links)
        counter.total = out["load_total"][
            i * n_links:(i + 1) * n_links].astype(np.int64)
        counter.window = out["load_window"][
            i * n_links:(i + 1) * n_links].astype(np.int64)
        deliver = deliver_all[int(bases[i]):int(bases[i]) + m]
        gen_arg = packed[i]["gen"][:m].astype(np.int64)
        cycles_arg = max(horizon, 1)
        wl = run.workloads[i]
        if wl is not None:
            # Measure over the replay's own timeline (see
            # metrics.replay_timeline): horizon = completion cycle,
            # generation = the cycle each packet's phase released.
            phase_done = out["phase_done"][i, :wl.num_phases]
            cycles_arg, gen_arg = replay_timeline(phase_done, gen_arg)
        stats = build_stats(
            topology=topo, policy=policy, traffic=tr,
            cycles=cycles_arg, warmup=int(run.warmups[i]),
            terminals=terminals, gen=gen_arg,
            deliver=deliver, link_counter=counter,
            delivered_in_window=int(out["delivered_in_window"][i]),
            in_flight=int(out["in_flight"][i]))
        if wl is not None:
            attach_replay(stats, wl, phase_done)
        if tr.request is not None:
            # Request ids in the engine's packet order: _pack_traffic's
            # permutation, recomputed (a stable lexsort over the same
            # inputs, so the same order); the step never sees requests.
            req = np.asarray(tr.request, dtype=np.int64)
            src64 = tr.src.astype(np.int64)
            gen64 = tr.gen.astype(np.int64)
            sort_key = src64 * (gen64.max(initial=0) + 1) + gen64
            if not np.all(sort_key[1:] >= sort_key[:-1]):
                req = req[np.lexsort((tr.gen, tr.src))]
            attach_serving(stats, req, packed[i]["gen"][:m].astype(np.int64),
                           deliver, slo=tr.slo)
        stats.timing = timing
        if run.trace is not None:
            # Copy i's columns of the flat ring buffers; block bounds come
            # back to local pid space by removing the copy's pid base.
            base = int(bases[i])
            injected = out["tr_inj"][tr_valid][:, i * n:(i + 1) * n
                                               ].astype(np.int64)
            stats.trace = Trace(
                stride=run.trace.stride, cycles=tr_cycles,
                link_load=out["tr_link"][tr_valid][
                    :, i * n_links:(i + 1) * n_links],
                queue_occ=out["tr_occ"][tr_valid][:, i * n:(i + 1) * n],
                injected=injected,
                delivered=out["tr_del"][tr_valid][:, i],
                backlog=derive_backlog(
                    tr_cycles, injected, packed[i]["gen"][:m].astype(np.int64),
                    packed[i]["blk_start"].astype(np.int64) - base,
                    packed[i]["blk_end"].astype(np.int64) - base,
                    phase_done=phase_done if wl is not None else None),
                meta={"topology": topo.name, "policy": policy.name,
                      "backend": "torch", "num_switches": n,
                      "num_ports": topo.num_ports, "terminals": terminals,
                      "load": load, "seed": seed})
        results.append(stats)
    k = run.n_seeds
    return [results[i:i + k] for i in range(0, len(results), k)]


def sweep(topo: SimTopology, policy, traffic_factory: Callable,
          loads: Sequence[float], *, seeds: Sequence[int] = (0,),
          terminals: int | None = None, eject_bw: int | None = None,
          num_vcs: int | None = None, queue_capacity: int = 4,
          cycles: int | None = None, warmup: int | None = None,
          drain: bool | None = None, max_cycles: int | None = None,
          trace=None, bucket: bool | None = None, devices=None,
          device="cuda") -> list[list[RunStats]]:
    """An entire saturation sweep as one run of the cycle engine on
    ``device`` (default ``"cuda"``, which raises where CUDA is absent;
    ``"cpu"`` runs the same step eagerly).

    The reference's ``repro.sim.xengine.sweep``, bit for bit: every
    (offered load, seed) point becomes one fabric copy of a flat state,
    and the ``[load][seed]`` grid of :class:`RunStats` comes out of the
    same metrics pipeline.  ``traffic_factory`` is called as
    ``factory(load, seed)`` when it accepts two positional arguments,
    else ``factory(load)``.  ``cycles=`` pins the shared horizon,
    otherwise it is the longest generation window of the grid.

    Every point's stats carry a shared ``timing`` record: ``compile_s``
    is the CUDA graph's warm-up and capture (0.0 on the CPU, and on a
    graph kept from an earlier call, which reports
    ``compile_cached="memory"``; else ``False``), ``execute_s`` the
    buffers' refill and the replay to completion, and ``host_s`` the
    host-side tables and traffic packing before the run.

    ``bucket`` (default on) rounds the step's static shapes (copies,
    packet count, horizon, drain cutoff) up to :func:`_bucket_count`
    boundaries, so nearby sweep sizes replay one kept graph; the padding
    is inert and the result bit-identical to ``bucket=False``, which runs
    exact shapes.

    Serving traffic (``traffic.request`` set, :mod:`repro_torch.workload`)
    adds per-request latency percentiles and SLO attainment to each
    point's stats.  Traffic that carries a collective-replay workload
    runs the phase
    barrier (all points of a grid replay, or none: a mixed grid raises
    ``ValueError``); its warm-up defaults to 0, and each point's stats
    carry ``phase_cycles`` / ``completion_cycles`` / ``ideal_cycles``.

    ``trace`` (anything :meth:`repro_torch.obs.TraceConfig.coerce`
    accepts) adds statically shaped time-series ring buffers to the step;
    per-point :class:`~repro_torch.obs.Trace` objects land on
    ``stats.trace`` (packet spans, ``TraceConfig.packets``, are a
    numpy-engine feature and are ignored here).  Degraded topologies
    (``topo.meta["faults"]``) run their fallback tables.

    ``devices`` splits the copies over devices of ``device``'s type, one
    contiguous block each (``None`` one device, ``"auto"`` every visible
    one, or an int; more than are visible raises ``ValueError``), bit for
    bit the single-device run; a traced run keeps one block.
    """
    return _execute(_prepare(
        topo, policy, traffic_factory, loads, seeds=seeds,
        terminals=terminals, eject_bw=eject_bw, num_vcs=num_vcs,
        queue_capacity=queue_capacity, cycles=cycles, warmup=warmup,
        drain=drain, max_cycles=max_cycles, trace=trace, bucket=bucket,
        devices=devices, device=device))


def _block_sweep(block_devices: Sequence, topo: SimTopology, policy,
                 traffic_factory: Callable, loads: Sequence[float],
                 **kw) -> list[list[RunStats]]:
    """:func:`sweep` with the copies in one block for each entry of
    ``block_devices`` (torch devices; one device may come several times),
    in place of ``devices=`` and ``device=``: the split of ``devices=N``
    run on any devices, so that one card or the CPU holds it to one
    program bit for bit."""
    return _execute(_prepare(topo, policy, traffic_factory, loads,
                             block_devices=list(block_devices), **kw))


def _execute(run: _Prepared | None) -> list[list[RunStats]]:
    if run is None:
        return []
    out, timing = _run_blocks(run.spec, run.blocks,
                              grid_points=len(run.grid))
    timing["host_s"] = round(run.host_s, 6)
    return _collect(run, out, timing)


def simulate_torch(topo: SimTopology, policy, traffic: Traffic, *,
                   terminals: int | None = None, eject_bw: int | None = None,
                   num_vcs: int | None = None, queue_capacity: int = 4,
                   cycles: int | None = None, warmup: int | None = None,
                   drain: bool | None = None, max_cycles: int | None = None,
                   seed: int = 0, trace=None, bucket: bool | None = None,
                   devices=None, device="cuda") -> RunStats:
    """One run (a single-copy :func:`sweep`); the reference's
    ``simulate_jax``."""
    if drain is None:
        drain = traffic.offered == 0
    return sweep(topo, policy, lambda _load: traffic, [traffic.offered],
                 seeds=(seed,), terminals=terminals, eject_bw=eject_bw,
                 num_vcs=num_vcs, queue_capacity=queue_capacity,
                 cycles=cycles, warmup=0 if warmup is None else warmup,
                 drain=drain, max_cycles=max_cycles, trace=trace,
                 bucket=bucket, devices=devices, device=device)[0][0]
