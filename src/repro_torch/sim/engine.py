"""Cycle-driven engine: batched arbitration over the whole fabric per cycle.

Per-cycle pipeline (all stages are numpy operations over every switch at
once; there are no per-packet Python objects):

1. **Ejection** — queue heads that reached their final destination compete
   for the switch's ``eject_bw`` ejection slots.
2. **Routing** — remaining heads compute their output port with the
   topology's vectorized table-free minimal route (towards ``mid`` in
   phase 0, ``dst`` in phase 1).
3. **Injection candidates** — each terminal exposes the head of its source
   FIFO (open-loop: generation timestamps come from the traffic object);
   the policy picks minimal/Valiant itineraries for them, re-evaluating
   congestion every cycle until they win.
4. **Link arbitration + credits** — one packet per directed link per
   cycle; a request is feasible only if the downstream (port, VC) queue
   has a free slot (occupancy *is* the credit counter).  Transit beats
   injection; ties break by a per-cycle random key.
5. **Movement** — winners pop from their queue (or terminal), push into
   the far-end queue, flip to phase 1 on reaching ``mid``, and bump the
   link-load counters.

Packets advance at most one hop per cycle (unit link latency + bandwidth).
"""
from __future__ import annotations

import time

import numpy as np

from ..obs.telemetry import timing_dict
from ..obs.trace import Trace, TraceConfig, derive_backlog
from .link import LinkLoadCounter, LinkTable
from .metrics import (RunStats, attach_replay, attach_serving, build_stats,
                      replay_timeline)
from .policies import RoutingPolicy
from .switch import QueueFabric, arbitrate
from .topology import SimTopology
from .traffic import Traffic, resolve_terminals

_DRAIN_SLACK = 100_000   # safety cap on drain cycles for closed workloads


class Engine:
    """One simulation run; construct fresh per run."""

    def __init__(self, topo: SimTopology, policy: RoutingPolicy,
                 traffic: Traffic, *, terminals: int | None = None,
                 eject_bw: int | None = None, num_vcs: int | None = None,
                 queue_capacity: int = 4, seed: int = 0, trace=None):
        self.topo = topo
        self.policy = policy
        self.traffic = traffic
        # None defaults to the traffic object's record; an explicit value
        # must agree with it (the offered load is scaled by the traffic's
        # terminals, so a disagreement silently mis-normalizes accepted
        # throughput).
        terminals = resolve_terminals(traffic, terminals)
        self.terminals = terminals
        self.eject_bw = terminals if eject_bw is None else eject_bw
        if num_vcs is None:
            # Distance-class VC ladder: one class per hop of the longest
            # route (doubled when the policy may take a Valiant detour).
            # A packet in the top class is then on its final hop, whose
            # next buffer is the always-draining ejection port, so no
            # buffer-dependency cycle can close.  On a CIN this yields the
            # paper's §3 numbers exactly: 1 VC minimal, 2 VCs non-minimal.
            num_vcs = topo.diameter * (2 if policy.vc_required > 1 else 1)
        self.num_vcs = num_vcs
        self.queue_capacity = queue_capacity
        self.rng = np.random.default_rng(seed)

        n, p, v = topo.num_switches, topo.num_ports, self.num_vcs
        self.links = LinkTable.for_topology(topo, v)
        self.load = LinkLoadCounter(self.links)
        self.fabric = QueueFabric(n * p * v, queue_capacity)

        # -- packet state (structure-of-arrays), sorted by (src, gen) -------
        order = np.lexsort((traffic.gen, traffic.src))
        self.src = traffic.src[order].astype(np.int64)
        self.dst = traffic.dst[order].astype(np.int64)
        self.gen = traffic.gen[order].astype(np.int64)
        self.request = (traffic.request[order].astype(np.int64)
                        if traffic.request is not None else None)
        m = self.src.size
        self.mid = self.dst.copy()
        self.phase = np.ones(m, dtype=np.int64)
        self.hops = np.zeros(m, dtype=np.int64)
        self.loc = self.src.copy()
        self.deliver = np.full(m, -1, dtype=np.int64)

        # -- terminal source FIFOs: switch block + stride-t subsequences ----
        counts = np.bincount(self.src, minlength=n) if m else np.zeros(n, np.int64)
        self.blk_start = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
        self.blk_end = (self.blk_start + counts).astype(np.int64)
        t = terminals
        self.term_switch = np.repeat(np.arange(n), t)
        self.term_lane = np.tile(np.arange(t), n)
        self.term_next = np.zeros(n * t, dtype=np.int64)   # injected count

        # EWMA of per-link requested demand (packets/cycle wanting the link,
        # whether or not they won) — the local congestion signal adaptive
        # policies read.  Downstream credit occupancy alone cannot see
        # source-side contention: a saturated link's far-end queue drains
        # freely while its requesters pile up on this side.
        self.pressure = np.zeros(self.links.num_link_slots)
        self.pressure_alpha = 0.05

        self.delivered_total = 0
        self.delivered_in_window = 0
        self.cycle = 0
        self.warmup = 0

        # -- collective-replay phase barrier --------------------------------
        # For workload replays (traffic.workload set) gen holds each
        # packet's phase ordinal; a phase's packets become injection
        # candidates only once every earlier phase has fully delivered.
        # phase_done[k] records the cycle phase k's last packet ejected.
        if traffic.workload is not None:
            num_phases = traffic.workload.num_phases
            self.phase_cum = traffic.workload.phase_cum(num_phases)
            self.phase_done = np.full(num_phases, -1, dtype=np.int64)
            self.cur_phase = 0
            self._advance_barrier(0)         # release empty leading phases
        else:
            self.phase_cum = None
        # Measurement window is [warmup, meas_end): drain cycles past the
        # open-loop horizon deliver backlog without fresh offered load, so
        # counting them would inflate accepted throughput past offered.
        self.meas_end = float("inf")

        # -- time-series trace (repro_torch.obs) ----------------------------------
        # Sampling happens at end-of-cycle, after movement, so every channel
        # reflects the state the next cycle starts from — the same point the
        # compiled engine's ring buffers capture.
        self.trace_cfg = TraceConfig.coerce(trace)
        self._span_mask = None
        if self.trace_cfg is not None:
            self._tr_cycles: list = []
            self._tr_link: list = []
            self._tr_occ: list = []
            self._tr_inj: list = []
            self._tr_del: list = []
            self._tr_events: list = []
            k = self.trace_cfg.packets
            if k > 0 and m > 0:
                # K packets spread evenly over the (src, gen)-sorted ids, so
                # the sample covers sources and phases rather than one block.
                ids = np.unique(np.linspace(0, m - 1, min(k, m)).astype(np.int64))
                self._span_mask = np.zeros(m, dtype=bool)
                self._span_mask[ids] = True

    def _advance_barrier(self, c: int) -> None:
        """Open the next phase barrier(s) whose packets are all delivered,
        recording the completion cycle (empty phases complete in place)."""
        while (self.cur_phase < self.phase_cum.size
               and self.delivered_total >= self.phase_cum[self.cur_phase]):
            self.phase_done[self.cur_phase] = c
            self.cur_phase += 1

    # -- congestion view for adaptive policies ------------------------------
    def port_backlog(self, switch: np.ndarray, port: np.ndarray) -> np.ndarray:
        """Occupancy (all VCs) of the downstream queue behind an output
        port — the credit-visible congestion signal."""
        link = self.links.link_ids(switch, port)
        base = self.links.dest_queue(link, np.zeros_like(link))
        per_port = self.fabric.occ.reshape(-1, self.num_vcs).sum(axis=1)
        return per_port[base // self.num_vcs]

    def link_pressure(self, switch: np.ndarray, port: np.ndarray) -> np.ndarray:
        """Smoothed requested demand (packets/cycle) on an output link."""
        return self.pressure[self.links.link_ids(switch, port)]

    # -- one simulated cycle -------------------------------------------------
    def step(self) -> None:
        self._step_core()
        cfg = self.trace_cfg
        if cfg is not None:
            c = self.cycle - 1
            if c % cfg.stride == 0 and c // cfg.stride < cfg.max_samples:
                self._sample(c)

    def _sample(self, c: int) -> None:
        n = self.topo.num_switches
        self._tr_cycles.append(c)
        self._tr_link.append(self.load.total.copy())
        self._tr_occ.append(self.fabric.occ.reshape(n, -1).sum(axis=1))
        self._tr_inj.append(self.term_next.reshape(n, -1).sum(axis=1))
        self._tr_del.append(self.delivered_total)

    def _finalize_trace(self) -> Trace:
        n = self.topo.num_switches
        s = len(self._tr_cycles)
        cycles = np.asarray(self._tr_cycles, dtype=np.int64)
        injected = np.asarray(self._tr_inj, dtype=np.int64).reshape(s, n)
        backlog = derive_backlog(
            cycles, injected, self.gen, self.blk_start, self.blk_end,
            phase_done=self.phase_done if self.phase_cum is not None else None)
        return Trace(
            stride=self.trace_cfg.stride, cycles=cycles,
            link_load=np.asarray(self._tr_link, np.int64).reshape(
                s, self.links.num_link_slots),
            queue_occ=np.asarray(self._tr_occ, np.int64).reshape(s, n),
            injected=injected,
            delivered=np.asarray(self._tr_del, np.int64),
            backlog=backlog,
            meta={"topology": self.topo.name, "policy": self.policy.name,
                  "backend": "numpy", "num_switches": n,
                  "num_ports": self.topo.num_ports,
                  "terminals": self.terminals},
            events=self._tr_events)

    def _step_core(self) -> None:
        topo, fab, links = self.topo, self.fabric, self.links
        p, v, cap = topo.num_ports, self.num_vcs, self.queue_capacity
        c = self.cycle

        # 1. ejection ------------------------------------------------------
        aq = fab.active()
        heads = fab.heads(aq)
        done = (self.loc[heads] == self.dst[heads]) & (self.phase[heads] == 1)
        if done.any():
            eq = aq[done]
            ep = heads[done]
            sw = eq // (p * v)
            win = arbitrate(sw, self.rng.random(eq.size), k=self.eject_bw)
            fab.pop(eq[win])
            pids = ep[win]
            if self._span_mask is not None:
                for pd in pids[self._span_mask[pids]]:
                    self._tr_events.append(
                        (int(pd), c, int(self.loc[pd]), -1))
            self.deliver[pids] = c
            self.delivered_total += win.size
            if self.warmup <= c < self.meas_end:
                self.delivered_in_window += win.size
            if self.phase_cum is not None:
                # Barrier opens in the same cycle the closing delivery
                # lands, so the next phase's injection (stage 3 below)
                # never loses a cycle to the bookkeeping.
                self._advance_barrier(c)

        # 2. transit requests ---------------------------------------------
        tq = aq[~done]
        tp = heads[~done]
        tgt = np.where(self.phase[tp] == 1, self.dst[tp], self.mid[tp])
        if tp.size:
            t_port = topo.minimal_port(self.loc[tp], tgt)
        else:
            t_port = np.empty(0, dtype=np.int64)
        t_vc = np.minimum(self.hops[tp], v - 1)

        # 3. injection candidates -----------------------------------------
        idx = (self.blk_start[self.term_switch] + self.term_lane
               + self.term_next * self.terminals)
        valid = idx < self.blk_end[self.term_switch]
        if self.gen.size:
            safe = np.where(valid, idx, 0)
            # Replays gate on the released phase (gen = phase ordinal);
            # open-loop traffic gates on simulated time (gen = cycle).
            limit = c if self.phase_cum is None else self.cur_phase
            valid &= self.gen[safe] <= limit
        cand_term = np.nonzero(valid)[0]
        ip = idx[cand_term]
        if ip.size:
            self.policy.on_inject(self, ip)
            i_tgt = np.where(self.phase[ip] == 1, self.dst[ip], self.mid[ip])
            i_port = topo.minimal_port(self.src[ip], i_tgt)
        else:
            i_port = np.empty(0, dtype=np.int64)
        i_vc = np.zeros(ip.size, dtype=np.int64)     # first hop = class 0

        # 4. link arbitration with credit check ---------------------------
        # The EWMA pressure update happens exactly once per cycle, on every
        # path out of this stage (an empty request set is demand == 0, a
        # fully-blocked cycle still counts its requesters), so adaptive
        # policies never read a stale congestion signal.
        nt = tp.size
        r_pid = np.concatenate([tp, ip])
        r_loc = np.concatenate([self.loc[tp], self.src[ip]])
        r_port = np.concatenate([t_port, i_port])
        r_link = links.link_ids(r_loc, r_port)
        demand = np.bincount(r_link, minlength=links.num_link_slots)
        self.pressure += self.pressure_alpha * (demand - self.pressure)
        if r_pid.size == 0:
            self.cycle += 1
            return
        r_vc = np.concatenate([t_vc, i_vc])
        r_cls = np.concatenate([np.zeros(nt, np.int64),
                                np.ones(ip.size, np.int64)])
        r_dq = links.dest_queue(r_link, r_vc)
        # Unwired slots (including links a FailureSpec killed) have no
        # downstream queue — they are permanently credit-starved.
        # Degraded fallback routing never requests them, so this guard
        # never fires on well-formed traffic; it keeps stray requests
        # from indexing a garbage queue.
        feasible = np.nonzero((fab.occ[r_dq] < cap)
                              & links.wired[r_link])[0]
        if feasible.size == 0:
            self.cycle += 1
            return
        win = feasible[arbitrate(r_link[feasible], r_cls[feasible],
                                 self.rng.random(feasible.size), k=1)]

        # 5. movement ------------------------------------------------------
        w_transit = win[win < nt]
        fab.pop(tq[w_transit])
        w_inject = win[win >= nt] - nt
        self.term_next[cand_term[w_inject]] += 1

        pid = r_pid[win]
        dq = r_dq[win]
        nbr = links.neighbor_flat[r_link[win]]
        if self._span_mask is not None:
            traced = self._span_mask[pid]
            if traced.any():
                frm = r_loc[win][traced]
                for a, b, d in zip(pid[traced], frm, nbr[traced]):
                    self._tr_events.append((int(a), c, int(b), int(d)))
        fab.push(dq, pid)
        self.loc[pid] = nbr
        self.hops[pid] += 1
        arrived_mid = (self.phase[pid] == 0) & (nbr == self.mid[pid])
        if arrived_mid.any():
            self.phase[pid[arrived_mid]] = 1
        if self.warmup <= c < self.meas_end:
            self.load.record(r_link[win])
        else:
            self.load.total[r_link[win]] += 1
        self.cycle += 1

    # -- full run -------------------------------------------------------------
    def run(self, *, cycles: int | None = None, warmup: int = 0,
            drain: bool | None = None, max_cycles: int | None = None
            ) -> RunStats:
        m = self.src.size
        horizon = cycles if cycles is not None else max(self.traffic.horizon, 1)
        if drain is None:
            drain = self.traffic.offered == 0
        cutoff = max_cycles if max_cycles is not None else horizon + _DRAIN_SLACK
        self.warmup = warmup
        # Replays measure the whole run: the "horizon" is only the phase
        # count, and every delivery belongs to the workload being timed.
        self.meas_end = horizon if self.phase_cum is None else float("inf")

        t0 = time.perf_counter()
        while self.cycle < horizon:
            if self.cycle == warmup:
                self.load.reset_window()
            self.step()
        while drain and self.delivered_total < m and self.cycle < cutoff:
            self.step()
        wall_s = time.perf_counter() - t0
        if drain and self.delivered_total < m:
            raise RuntimeError(
                f"{self.topo.name}/{self.policy.name}: "
                f"{m - self.delivered_total} packets undelivered after "
                f"{self.cycle} cycles (deadlock or cutoff too small)")
        if self.phase_cum is not None:
            # Summary stats over the *replay's* timeline: the run spans
            # [0, completion], and a packet's reference time is the cycle
            # its phase barrier opened (gen holds the phase ordinal), so
            # latency measures in-phase queueing + flight, and accepted /
            # utilization normalize by the measured completion.
            cycles_arg, gen_arg = replay_timeline(self.phase_done, self.gen)
            stats = build_stats(
                topology=self.topo, policy=self.policy, traffic=self.traffic,
                cycles=cycles_arg, warmup=warmup, terminals=self.terminals,
                gen=gen_arg, deliver=self.deliver, link_counter=self.load,
                delivered_in_window=self.delivered_in_window,
                in_flight=self.fabric.total_occupancy)
            stats = attach_replay(stats, self.traffic.workload,
                                  self.phase_done)
            return self._attach_obs(stats, wall_s)
        stats = build_stats(
            topology=self.topo, policy=self.policy, traffic=self.traffic,
            cycles=max(horizon, 1), warmup=warmup, terminals=self.terminals,
            gen=self.gen, deliver=self.deliver, link_counter=self.load,
            delivered_in_window=self.delivered_in_window,
            in_flight=self.fabric.total_occupancy)
        if self.request is not None:
            stats = attach_serving(stats, self.request, self.gen,
                                   self.deliver, slo=self.traffic.slo)
        return self._attach_obs(stats, wall_s)

    def _attach_obs(self, stats: RunStats, wall_s: float) -> RunStats:
        stats.timing = timing_dict("numpy", execute_s=wall_s)
        if self.trace_cfg is not None:
            stats.trace = self._finalize_trace()
        return stats


def simulate(topo: SimTopology, policy: RoutingPolicy, traffic: Traffic, *,
             terminals: int | None = None, eject_bw: int | None = None,
             num_vcs: int | None = None, queue_capacity: int = 4,
             cycles: int | None = None,
             warmup: int = 0, drain: bool | None = None,
             max_cycles: int | None = None, seed: int = 0,
             backend: str = "torch", trace=None, failures=None,
             bucket: bool | None = None, devices=None,
             device="cuda") -> RunStats:
    """Run one simulation; ``backend`` picks the engine.  The default is
    the torch cycle engine on the card, which raises where CUDA is absent:
    the oracle runs only when asked for.

    ``terminals`` defaults to what the traffic object was generated with
    (:func:`repro_torch.sim.traffic.resolve_terminals`); passing a
    disagreeing explicit value raises.

    * ``"torch"`` (default) — the cycle engine
      (:mod:`repro_torch.sim.xengine`): the same pipeline as one
      fixed-shape step replayed as a CUDA graph on ``device`` (default
      ``"cuda"``; ``"cpu"`` runs the step eagerly).
      Bit-identical to the reference's compiled ``"jax"`` engine, which
      draws the same threefry stream.  Prefer
      :func:`repro_torch.sim.xengine.sweep` for many (load, seed) points.
    * ``"numpy"`` — the interpreted oracle :class:`Engine` (one Python
      iteration per cycle; reference semantics).
    * ``"flow"``  — the analytical fair-share model
      (:mod:`repro_torch.flow`): a different *fidelity tier*, not another
      cycle engine.  Rates and replay completion are cross-validated
      estimates; latency fields are hop-count lower bounds, and
      queue-level knobs (``queue_capacity``, ``num_vcs``, ``eject_bw``,
      ``seed``, ``trace``) are accepted but ignored.  Its max-min solver
      runs on ``device`` (default ``"cuda"``, which raises where CUDA is
      absent).

    ``failures`` (a :class:`repro_torch.faults.FailureSpec`, or its dict
    form) runs the simulation on the degraded fabric: the topology is
    masked and re-routed via :func:`repro_torch.faults.degrade` and
    packets whose endpoints died or were disconnected are dropped from
    ``traffic`` before the engine ever sees them — uniformly for all three
    backends.  ``None`` (or a null spec) is exactly the pristine run.

    ``trace`` turns on time-series recording (anything
    :meth:`repro_torch.obs.TraceConfig.coerce` accepts: ``True``, a
    config, or a kwargs dict); the sampled :class:`~repro_torch.obs.Trace`
    lands on ``stats.trace``.  ``bucket`` / ``devices`` are torch-engine
    knobs (see :func:`repro_torch.sim.xengine.sweep`), ignored by the
    other backends.
    """
    if failures is not None:
        from repro_torch.faults import degrade, mask_traffic
        topo = degrade(topo, failures)
        traffic = mask_traffic(traffic, topo)
    if backend == "torch":
        from . import xengine
        return xengine.simulate_torch(
            topo, policy, traffic, terminals=terminals, eject_bw=eject_bw,
            num_vcs=num_vcs, queue_capacity=queue_capacity, cycles=cycles,
            warmup=warmup, drain=drain, max_cycles=max_cycles, seed=seed,
            trace=trace, bucket=bucket, devices=devices, device=device)
    if backend == "flow":
        from repro_torch.flow import simulate_flow
        return simulate_flow(topo, policy, traffic, terminals=terminals,
                             cycles=cycles, warmup=warmup, device=device)
    if backend != "numpy":
        raise ValueError(f"unknown simulator backend {backend!r}; "
                         f"expected 'numpy', 'torch' or 'flow'")
    eng = Engine(topo, policy, traffic, terminals=terminals,
                 eject_bw=eject_bw, num_vcs=num_vcs,
                 queue_capacity=queue_capacity, seed=seed, trace=trace)
    return eng.run(cycles=cycles, warmup=warmup, drain=drain,
                   max_cycles=max_cycles)
