"""Exporters for FlightRecorder traces: JSONL and Chrome/Perfetto JSON
(counterpart of the JAX package's ``obs/export.py``; the files are
byte-identical to the reference's for the same spans).

Both formats are **byte-deterministic**: spans are written in open order
(a stable total order assigned at record time), every JSON object is
serialized with sorted keys, and no wall-clock field exists anywhere in
the span model — so two runs of the same traffic trace produce identical
files, and exported artifacts diff cleanly across commits.

The Perfetto export maps the virtual step clock onto a microsecond
timeline at :data:`US_PER_STEP` µs per step (Chrome's ``trace_event``
format requires real time units; the scale is arbitrary and chosen so a
few hundred steps render comfortably). Open ``chrome://tracing`` or
https://ui.perfetto.dev and load the file: one named track ("thread")
per request plus a session track carrying wave spans and counter series.

A recorder in wall mode has a second export, to a file of its own
(:func:`write_wall_perfetto`): its wall records and, once
:meth:`~repro_torch.obs.FlightRecorder.resolve` has placed them, the
device intervals, in real microseconds from the first record, on two
tracks, host and device (each request's queue wait as an async slice
beside them). It is not deterministic: it is a measurement.
"""

from __future__ import annotations

import json
import pathlib
from typing import Any, Iterable, Mapping

#: virtual-step -> microsecond scale for the Perfetto timeline
US_PER_STEP = 1000

#: trace-export schema rev (bumped with the span/export model)
TRACE_SCHEMA_VERSION = 1

#: counter fields lifted from wave spans into Perfetto counter tracks
COUNTER_FIELDS = ("occupancy", "pool_pages_held", "energy_j",
                  "sector_coverage", "dram_ns")


def _track_key(track) -> tuple:
    # request tracks (int rids) first in rid order, named tracks after
    return (0, track, "") if isinstance(track, int) else (1, 0, str(track))


def write_jsonl(spans: Iterable[Mapping[str, Any]], path,
                extra: Mapping[str, Any] | None = None) -> pathlib.Path:
    """One span per line, open order, sorted keys; ``extra`` metadata
    fields are merged into every line (run provenance)."""
    path = pathlib.Path(path)
    base = dict(extra or {})
    with path.open("w") as fh:
        for span in spans:
            fh.write(json.dumps({**base, **span}, sort_keys=True) + "\n")
    return path


def to_trace_events(spans: Iterable[Mapping[str, Any]],
                    us_per_step: int = US_PER_STEP) -> list[dict]:
    """Chrome ``trace_event`` list: complete (``ph:"X"``) spans, instant
    (``ph:"i"``) events, counter (``ph:"C"``) series from wave spans, and
    thread-name metadata rows. Still-open spans (``end`` None) are
    rendered as zero-duration opens at their start step."""
    spans = list(spans)
    events: list[dict] = []
    tracks = sorted({s["track"] for s in spans}, key=_track_key)
    for track in tracks:
        tid = tracks.index(track)
        name = (f"request {track}" if isinstance(track, int)
                else str(track))
        events.append({"ph": "M", "name": "thread_name", "pid": 0,
                       "tid": tid, "args": {"name": name}})
    tid_of = {track: i for i, track in enumerate(tracks)}
    for span in spans:
        tid = tid_of[span["track"]]
        ts = span["start"] * us_per_step
        args = dict(span.get("attrs") or {})
        end = span.get("end")
        if end is None:
            args["open"] = True
            end = span["start"]
        if end > span["start"]:
            events.append({"ph": "X", "name": span["name"], "pid": 0,
                           "tid": tid, "ts": ts,
                           "dur": (end - span["start"]) * us_per_step,
                           "args": args})
        else:
            events.append({"ph": "i", "name": span["name"], "pid": 0,
                           "tid": tid, "ts": ts, "s": "t", "args": args})
        if span["name"] == "wave":
            for field in COUNTER_FIELDS:
                value = args.get(field)
                if value is not None:
                    events.append({"ph": "C", "name": field, "pid": 0,
                                   "tid": tid_of[span["track"]], "ts": ts,
                                   "args": {field: value}})
    return events


#: the DRAM command track renders modeled *nanoseconds* at 1 µs per ns,
#: anchored at each wave's step window — makespans are hundreds of ns,
#: step windows are US_PER_STEP µs wide, so command phases nest visibly
#: inside their wave's slice without a second clock domain
COMMAND_TRACK_PID = 1


def command_trace_events(records: Iterable[Mapping[str, Any]],
                         us_per_step: int = US_PER_STEP) -> list[dict]:
    """Perfetto events for the flight recorder's DRAM command records.

    One dedicated process ("dram commands"): per wave, a ``dram`` slice
    spanning the modeled makespan with nested ``act issue`` (tFAW
    token-bucket / tRRD-limited) and ``data bus`` (RD/WR burst
    occupancy, offset by the tRCD+tCL fill) phase slices, plus
    ``dram_ns`` / ``faw_tokens`` counter series. Slice ``args`` carry
    per-kind command counts and the replay breakdown; determinism
    matches the span exporter (open order, no wall-clock).
    """
    records = list(records)
    events: list[dict] = []
    if not records:
        return events
    pid = COMMAND_TRACK_PID
    events.append({"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                   "args": {"name": "dram commands"}})
    events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": 0,
                   "args": {"name": "dram"}})
    for rec in records:
        ts0 = rec["step"] * us_per_step
        counts: dict[str, float] = {}
        for cmd in rec.get("commands", ()):
            counts[cmd["kind"]] = counts.get(cmd["kind"], 0.0) + cmd["count"]
        events.append({"ph": "C", "name": "dram_ns", "pid": pid, "tid": 0,
                       "ts": ts0, "args": {"dram_ns": rec["dram_ns"]}})
        events.append({"ph": "C", "name": "faw_tokens", "pid": pid,
                       "tid": 0, "ts": ts0,
                       "args": {"faw_tokens": rec["faw_tokens"]}})
        if rec["dram_ns"] <= 0:
            continue
        events.append({"ph": "X", "name": "dram", "pid": pid, "tid": 0,
                       "ts": ts0, "dur": rec["dram_ns"],
                       "args": {"dram_ns": rec["dram_ns"],
                                "act_ns": rec["act_ns"],
                                "bus_ns": rec["bus_ns"],
                                "n_acts": rec["n_acts"],
                                "faw_tokens": rec["faw_tokens"],
                                "commands": counts}})
        if rec["act_ns"] > 0:
            events.append({"ph": "X", "name": "act issue", "pid": pid,
                           "tid": 0, "ts": ts0, "dur": rec["act_ns"],
                           "args": {"n_acts": rec["n_acts"],
                                    "faw_tokens": rec["faw_tokens"]}})
        if rec["bus_ns"] > 0:
            events.append({"ph": "X", "name": "data bus", "pid": pid,
                           "tid": 0, "ts": ts0 + rec["lead_ns"],
                           "dur": rec["bus_ns"],
                           "args": {"bus_ns": rec["bus_ns"]}})
    return events


def write_perfetto(spans: Iterable[Mapping[str, Any]], path,
                   extra: Mapping[str, Any] | None = None,
                   us_per_step: int = US_PER_STEP,
                   commands: Iterable[Mapping[str, Any]] | None = None
                   ) -> pathlib.Path:
    """Write a Perfetto/chrome://tracing JSON object trace; returns path.

    ``commands`` optionally merges the DRAM command track
    (:func:`command_trace_events`) beside the span tracks."""
    path = pathlib.Path(path)
    events = to_trace_events(spans, us_per_step)
    if commands is not None:
        events.extend(command_trace_events(commands, us_per_step))
    payload = {"displayTimeUnit": "ms",
               "metadata": dict(extra or {}),
               "traceEvents": events}
    path.write_text(json.dumps(payload, sort_keys=True) + "\n")
    return path


#: the wall-clock export's tracks: one process, a host and a device thread
WALL_TRACKS = ("host", "device")


def wall_trace_events(wall_spans: Iterable[Mapping[str, Any]],
                      device_intervals: Iterable[Mapping[str, Any]] = ()
                      ) -> list[dict]:
    """Chrome ``trace_event`` list of a wall-mode recorder, in µs from
    the first record: every closed wall span but ``queued`` as a
    complete slice on the host track, each ``queued`` as an async slice
    (id: the request), every device interval on the device track; a
    slice's ``args`` carry its request and attributes."""
    spans = [s for s in wall_spans if s.get("end") is not None]
    device = list(device_intervals)
    starts = [s["start"] for s in spans] + [d["start"] for d in device]
    if not starts:
        return []
    t0 = min(starts)

    def us(t):
        return (t - t0) / 1e3

    events: list[dict] = [
        {"ph": "M", "name": "thread_name", "pid": 0, "tid": tid,
         "args": {"name": name}} for tid, name in enumerate(WALL_TRACKS)]
    for s in spans:
        args = dict(s.get("attrs") or {})
        if s.get("rid") is not None:
            args["rid"] = s["rid"]
        if s["name"] == "queued":
            for ph, t in (("b", s["start"]), ("e", s["end"])):
                events.append({"ph": ph, "cat": "queue", "name": "queued",
                               "id": s["rid"], "pid": 0, "tid": 0,
                               "ts": us(t), "args": args})
            continue
        events.append({"ph": "X", "name": s["name"], "pid": 0, "tid": 0,
                       "ts": us(s["start"]),
                       "dur": us(s["end"]) - us(s["start"]), "args": args})
    for d in device:
        args = {} if d.get("rid") is None else {"rid": d["rid"]}
        events.append({"ph": "X", "name": d["name"], "pid": 0, "tid": 1,
                       "ts": us(d["start"]),
                       "dur": us(d["end"]) - us(d["start"]), "args": args})
    return events


def write_wall_perfetto(wall_spans: Iterable[Mapping[str, Any]], path,
                        device_intervals: Iterable[Mapping[str, Any]] = ()
                        ) -> pathlib.Path:
    """Write :func:`wall_trace_events` as a Perfetto/chrome://tracing JSON
    object trace; returns path."""
    path = pathlib.Path(path)
    payload = {"displayTimeUnit": "ms",
               "traceEvents": wall_trace_events(wall_spans,
                                                device_intervals)}
    path.write_text(json.dumps(payload, sort_keys=True) + "\n")
    return path
