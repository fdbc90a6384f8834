"""Chrome trace-event builders: spans and counter tracks for Perfetto.

Emits the JSON-object list of the Trace Event Format (the ``traceEvents``
array ``ui.perfetto.dev`` and ``chrome://tracing`` load): complete spans
(``"ph": "X"`` with ``ts``/``dur``), counter samples (``"ph": "C"``),
and the ``"M"`` metadata records that name process/thread lanes.
Timestamps are microseconds in the format; we map **1 simulated cycle =
1 us**, so a span's ``dur`` reads directly as cycles.

Three builders, composable by concatenation (see
:func:`repro_torch.obs.export.replay_trace_events` for the one-call form):

* :func:`phase_events` — one span per collective-replay phase,
  barrier-to-barrier, on a dedicated "replay" process lane;
* :func:`packet_events` — the numpy engine's K sampled packets as
  hop-by-hop residence spans, one thread lane per switch;
* :func:`counter_events` — any derived time-series (link utilization,
  in-flight count, backlog) as a counter track.

:func:`validate_trace_events` checks the invariants the viewers rely on
and is run by the export CLI before anything is written.
"""
from __future__ import annotations

import json

import numpy as np

__all__ = ["phase_events", "packet_events", "counter_events",
           "request_events", "export_perfetto", "validate_trace_events",
           "PID_REPLAY", "PID_SWITCHES", "PID_COUNTERS", "PID_REQUESTS"]

#: Process ids of the lanes an exported replay / serving run shows.
PID_REPLAY, PID_SWITCHES, PID_COUNTERS, PID_REQUESTS = 1, 2, 3, 4

_VALID_PH = {"X", "C", "M", "B", "E", "I", "i"}


def _meta(pid: int, name: str, *, tid: int | None = None) -> dict:
    ev = {"ph": "M", "pid": pid, "ts": 0,
          "name": "process_name" if tid is None else "thread_name",
          "args": {"name": name}}
    if tid is not None:
        ev["tid"] = tid
    return ev


def phase_events(stats, *, pid: int = PID_REPLAY) -> list[dict]:
    """One ``"X"`` span per replay phase (barrier-to-barrier) from the
    ``phase_cycles`` record of a collective-replay
    :class:`~repro_torch.sim.metrics.RunStats`; empty for open-loop runs."""
    if getattr(stats, "phase_cycles", None) is None:
        return []
    events = [_meta(pid, "replay"), _meta(pid, "phases", tid=0)]
    start = 0
    for k, dur in enumerate(stats.phase_cycles):
        events.append({
            "name": f"phase {k}", "cat": "phase", "ph": "X",
            "ts": start, "dur": max(int(dur), 0), "pid": pid, "tid": 0,
            "args": {"phase": k, "cycles": int(dur)},
        })
        start += int(dur)
    return events


def packet_events(trace, *, pid: int = PID_SWITCHES,
                  num_switches: int | None = None) -> list[dict]:
    """Residence spans of the traced packets: one thread lane per switch,
    one ``"X"`` span per hop covering the cycles the packet sat in that
    switch's queues (arrival cycle + 1 through its next departure).

    ``trace.events`` rows are ``(pid, cycle, from_switch, to_switch)``
    movement records (``to_switch == -1`` = ejected at ``from_switch``),
    as the numpy engine captures them; the torch cycle engine records none.
    """
    if not trace.events:
        return []
    n = num_switches if num_switches is not None \
        else int(trace.meta.get("num_switches", 0))
    by_pid: dict[int, list] = {}
    for ev in trace.events:
        by_pid.setdefault(int(ev[0]), []).append(ev)
    events = [_meta(pid, "switches")]
    lanes_used: set[int] = set()
    for pkt, evs in sorted(by_pid.items()):
        evs.sort(key=lambda e: e[1])
        for here, nxt in zip(evs, evs[1:] + [None]):
            _, cycle, frm, to = here
            if to < 0:          # ejection record: the span ended earlier
                continue
            depart = nxt[1] if nxt is not None else cycle + 1
            events.append({
                "name": f"pkt {pkt}", "cat": "packet", "ph": "X",
                "ts": int(cycle) + 1,
                "dur": max(int(depart) - int(cycle), 1),
                "pid": pid, "tid": int(to),
                "args": {"packet": pkt, "from": int(frm), "to": int(to)},
            })
            lanes_used.add(int(to))
    for sw in sorted(lanes_used):
        label = f"switch {sw}" if not n else f"switch {sw}/{n}"
        events.append(_meta(pid, label, tid=sw))
    return events


def request_events(request, gen, deliver, *, slo: float | None = None,
                   pid: int = PID_REQUESTS) -> list[dict]:
    """One ``"X"`` span per *completed* serving request — arrival cycle
    to last-packet delivery — and an ``"I"`` instant for each request
    still open when the run stopped.

    Inputs are the per-packet arrays a serving
    :class:`~repro_torch.sim.traffic.Traffic` run produces (``request`` ids,
    ``gen`` cycles, ``deliver`` cycles, −1 = undelivered), the same
    triple :func:`repro_torch.sim.metrics.attach_serving` summarizes.  When
    ``slo`` is given each span's args carry ``slo_met`` so Perfetto
    queries can split the lane by attainment.
    """
    from repro_torch.sim.metrics import request_latency_summary
    rs = request_latency_summary(request, gen, deliver)
    if not rs["count"]:
        return []
    events = [_meta(pid, "requests"), _meta(pid, "serving", tid=0)]
    for k, (arr, lat) in enumerate(zip(rs["arrival"].tolist(),
                                       rs["latency"].tolist())):
        if lat < 0:
            events.append({
                "name": f"req {k} (open)", "cat": "request", "ph": "I",
                "ts": int(arr), "pid": pid, "tid": 0, "s": "t",
                "args": {"request": k},
            })
            continue
        args = {"request": k, "latency": int(lat)}
        if slo is not None:
            args["slo_met"] = bool(lat <= float(slo))
        events.append({
            "name": f"req {k}", "cat": "request", "ph": "X",
            "ts": int(arr), "dur": int(lat), "pid": pid, "tid": 0,
            "args": args,
        })
    return events


def counter_events(name: str, cycles, values, *,
                   pid: int = PID_COUNTERS) -> list[dict]:
    """A counter track (``"ph": "C"``): one sample per entry of
    ``cycles``/``values``.  Perfetto renders it as a stepped area chart
    — the shape link-utilization plateaus show up in."""
    cycles = np.asarray(cycles)
    values = np.asarray(values)
    events = [_meta(pid, "counters")]
    for c, v in zip(cycles.tolist(), values.tolist()):
        events.append({
            "name": name, "ph": "C", "ts": int(c), "pid": pid,
            "args": {name: round(float(v), 6)},
        })
    return events


def validate_trace_events(events: list[dict]) -> list[dict]:
    """Check the trace-event schema invariants the viewers rely on;
    returns ``events`` unchanged (so it chains) or raises ``ValueError``
    naming the first offending event."""
    if not isinstance(events, list):
        raise ValueError(f"traceEvents must be a list, got {type(events)}")
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"event {i}: not an object: {ev!r}")
        ph = ev.get("ph")
        if ph not in _VALID_PH:
            raise ValueError(f"event {i}: unknown phase {ph!r}")
        if "name" not in ev:
            raise ValueError(f"event {i}: missing name")
        if ph != "M" and not isinstance(ev.get("ts"), int):
            raise ValueError(f"event {i}: ts must be an integer, "
                             f"got {ev.get('ts')!r}")
        if ph == "X":
            if not isinstance(ev.get("dur"), int) or ev["dur"] < 0:
                raise ValueError(f"event {i}: X span needs dur >= 0, "
                                 f"got {ev.get('dur')!r}")
        if ph == "C" and not isinstance(ev.get("args"), dict):
            raise ValueError(f"event {i}: counter needs an args object")
        try:
            json.dumps(ev)
        except TypeError as e:
            raise ValueError(f"event {i}: not JSON-serializable: {e}") from e
    return events


def export_perfetto(path: str, events: list[dict], *,
                    validate: bool = True) -> dict:
    """Write ``events`` as a Perfetto/Chrome-loadable JSON object
    (``{"traceEvents": [...]}``); returns the payload."""
    if validate:
        validate_trace_events(events)
    payload = {"traceEvents": events, "displayTimeUnit": "ms"}
    with open(path, "w") as f:
        json.dump(payload, f, indent=1, sort_keys=True)
        f.write("\n")
    return payload
