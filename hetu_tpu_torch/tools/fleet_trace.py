"""Fleet trace collector/merger: one Perfetto timeline for N processes (a
copy of ``hetu_tpu/tools/fleet_trace.py``).

Each fleet process (the router front door,
every remote engine replica) carries its own span tracer and flight
recorder, each anchored to its OWN clocks: the tracer's ``ts`` values
are microseconds since a per-process ``perf_counter`` epoch, pinned to
wall time by ``otherData.epoch_unix``; flight events carry raw
``ts_unix``. Opened separately those traces are N disconnected
pictures; a P/D-split request — router dispatch on the front door,
prefill chunks on the prefill replica, the KV stream back through the
router, decode on the decode replica — is unreadable.

This tool merges them into ONE Chrome-trace document:

- every process becomes its own Perfetto process group (re-pid'd,
  ``process_name`` = replica name), with its events shifted onto the
  MASTER clock (the first entry — by convention the router) using the
  per-replica clock offsets the router measures on every status poll
  (``RemoteEngineProxy.clock_offset_s``: replica wall clock minus
  router wall clock, NTP-style from the ESTATUS round trip);
- every ``req <trace_id>`` request track — the per-request synthetic
  timelines the engine and router emit — is re-homed onto one shared
  REQUESTS process group, with ONE track per ``trace_id``: the
  dispatch span (router), prefill chunks (prefill replica), KV handoff
  (router), and decode (decode replica) land on the same line;
- flight events become Perfetto instant events on a per-process
  ``flight`` track, and any flight event stamped with a trace context
  (``trace=<trace_id or traceparent>`` — weight pushes, chaos kills,
  dispatches) is mirrored onto the matching request track, so "the
  latency spike at t=3.2s" and "the chaos kill at t=3.19s" sit one
  pixel apart.

Inputs come from ``DUMPOBS`` bundles (live fleet: one verb fetches the
tracer + flight ring + clock anchors of a process), exported chrome
JSON files, or flight ``*.jsonl`` dumps. Stdlib only.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional

#: synthetic pid for the unified per-request track group — far above
#: anything an OS hands out, below Chrome-trace consumers' int limits
REQ_PID = 9_999_999

#: master-entry name used when the caller gives none
DEFAULT_MASTER = "router"


def _req_tid(trace_id: str) -> int:
    """Stable per-trace_id track id: the same request gets the same
    unified tid no matter which processes contributed fragments.
    trace_ids are 12 lowercase hex chars (``uuid4().hex[:12]``); fall
    back to a stable string hash for foreign ids."""
    try:
        return int(trace_id[:12], 16)
    except ValueError:
        import zlib
        return zlib.crc32(trace_id.encode())


def _trace_id_of(value: str) -> str:
    """A flight event's ``trace`` field may be a bare trace_id or a
    full ``<trace_id>-<span_id>`` traceparent — normalize to trace_id."""
    from hetu_tpu_torch.telemetry.tracecontext import parse_traceparent
    tid, _span = parse_traceparent(value)
    return tid if tid else value


def bundle_to_entry(bundle: dict, *, name: Optional[str] = None,
                    offset_s: Optional[float] = None) -> dict:
    """Normalize one DUMPOBS bundle into a merge entry:
    ``{name, chrome, flight, epoch_unix, offset_s, role}``."""
    return {
        "name": name or bundle.get("replica")
        or f"pid{bundle.get('pid', '?')}",
        "chrome": bundle.get("chrome") or {"traceEvents": []},
        "flight": list(bundle.get("flight") or ()),
        "epoch_unix": float(bundle.get("epoch_unix") or 0.0),
        "offset_s": float(bundle.get("clock_offset_s", 0.0)
                          if offset_s is None else offset_s),
        "role": bundle.get("role"),
    }


def merge_chrome(entries: list[dict]) -> dict:
    """Merge per-process chrome docs + flight rings into one document.

    ``entries`` — :func:`bundle_to_entry` dicts. The FIRST entry is the
    clock master (its events shift by its own offset, normally 0); an
    entry's events move onto the master timeline by

    ``shift_us = ((epoch_unix - offset_s) - master_epoch) * 1e6``

    i.e. its wall-clock anchor corrected by its measured skew, re-based
    to the master's epoch. Events that would land before the master's
    epoch clamp to 0 (Perfetto dislikes negative ts).
    """
    if not entries:
        return {"traceEvents": [], "displayTimeUnit": "ms",
                "otherData": {"processes": []}}
    master_epoch = float(entries[0]["epoch_unix"]) \
        - float(entries[0].get("offset_s", 0.0))
    out: list[dict] = []
    req_tracks: dict[str, int] = {}          # trace_id -> unified tid
    processes: list[dict] = []
    for idx, ent in enumerate(entries):
        name = ent["name"]
        pid = idx + 1                        # stable, collision-free
        offset = float(ent.get("offset_s", 0.0))
        epoch = float(ent["epoch_unix"])
        shift_us = ((epoch - offset) - master_epoch) * 1e6
        processes.append({"name": name, "pid": pid,
                          "offset_s": offset, "role": ent.get("role")})
        # which local tids are request tracks, and for which trace_id
        req_tids: dict[int, str] = {}
        for ev in ent["chrome"].get("traceEvents", ()):
            if ev.get("ph") == "M" and ev.get("name") == "thread_name":
                tname = (ev.get("args") or {}).get("name", "")
                if tname.startswith("req "):
                    req_tids[int(ev["tid"])] = tname[4:]
        for ev in ent["chrome"].get("traceEvents", ()):
            ev = dict(ev)
            if ev.get("ph") == "M":
                if ev.get("name") == "process_name":
                    ev["pid"] = pid
                    ev["args"] = {"name": name}
                    out.append(ev)
                elif ev.get("name") == "thread_name" \
                        and int(ev.get("tid", -1)) not in req_tids:
                    ev["pid"] = pid
                    out.append(ev)
                # request-track thread_name rows are re-emitted once,
                # below, on the unified REQ_PID group
                continue
            tid = int(ev.get("tid", 0))
            if tid in req_tids:
                trace_id = req_tids[tid]
                req_tracks[trace_id] = _req_tid(trace_id)
                ev["pid"] = REQ_PID
                ev["tid"] = req_tracks[trace_id]
                args = dict(ev.get("args") or {})
                args.setdefault("replica", name)
                ev["args"] = args
            else:
                ev["pid"] = pid
            ev["ts"] = round(max(0.0, float(ev.get("ts", 0.0))
                                 + shift_us), 3)
            out.append(ev)
        # flight ring -> instant events on a per-process flight track
        flight_tid = 999_999
        if ent["flight"]:
            out.append({"name": "thread_name", "ph": "M", "pid": pid,
                        "tid": flight_tid, "args": {"name": "flight"}})
        for fev in ent["flight"]:
            ts_unix = float(fev.get("ts_unix", 0.0))
            ts_us = max(0.0, (ts_unix - offset - master_epoch) * 1e6)
            args = {k: v for k, v in fev.items()
                    if k not in ("kind", "ts_unix", "seq", "tid")}
            inst = {"name": str(fev.get("event", "flight")), "ph": "i",
                    "s": "t", "cat": "flight", "pid": pid,
                    "tid": flight_tid, "ts": round(ts_us, 3),
                    "args": args}
            out.append(inst)
            trace = fev.get("trace")
            if trace:
                trace_id = _trace_id_of(str(trace))
                utid = req_tracks.setdefault(trace_id,
                                             _req_tid(trace_id))
                mirror = dict(inst)
                mirror["pid"] = REQ_PID
                mirror["tid"] = utid
                mirror["args"] = dict(args, replica=name)
                out.append(mirror)
    # the unified request group: one process_name row + one
    # thread_name row per trace_id
    if req_tracks:
        out.append({"name": "process_name", "ph": "M", "pid": REQ_PID,
                    "tid": 0, "args": {"name": "REQUESTS"}})
        for trace_id, utid in sorted(req_tracks.items()):
            out.append({"name": "thread_name", "ph": "M",
                        "pid": REQ_PID, "tid": utid,
                        "args": {"name": f"req {trace_id}"}})
    return {"traceEvents": out, "displayTimeUnit": "ms",
            "otherData": {"master_epoch_unix": master_epoch,
                          "processes": processes}}


def merge_bundles(bundles: list[dict], *,
                  offsets: Optional[dict[str, float]] = None,
                  master: Optional[str] = None) -> dict:
    """Merge raw DUMPOBS bundles. ``offsets`` maps replica name →
    measured clock offset seconds (replica wall minus master wall; the
    router's ``fleet_status`` carries these per replica). ``master``
    names the clock-master bundle — defaults to the one with offset 0
    (the router itself), else the first."""
    offsets = dict(offsets or {})
    entries = [bundle_to_entry(
        b, offset_s=offsets.get(
            b.get("replica") or f"pid{b.get('pid', '?')}"))
        for b in bundles]
    if master is not None:
        entries.sort(key=lambda e: 0 if e["name"] == master else 1)
    else:
        entries.sort(key=lambda e: (abs(e["offset_s"]) > 1e-12,))
    return merge_chrome(entries)


def request_track(merged: dict, trace_id: str) -> list[dict]:
    """Every event on ``trace_id``'s unified request track, sorted by
    start time — what the merged-trace tests assert ordering on."""
    utid = _req_tid(trace_id)
    evs = [ev for ev in merged.get("traceEvents", ())
           if ev.get("pid") == REQ_PID and ev.get("tid") == utid
           and ev.get("ph") != "M"]
    return sorted(evs, key=lambda ev: float(ev.get("ts", 0.0)))


def span_order(merged: dict, trace_id: str) -> list[str]:
    """Just the ``ph: "X"`` span names on the request track, in start
    order — ``["dispatch", "queued", "prefill_chunk", ...]``."""
    return [ev["name"] for ev in request_track(merged, trace_id)
            if ev.get("ph") == "X"]


# -- collection ---------------------------------------------------------------

def collect_dump(port: int, *, host: str = "127.0.0.1",
                 token: str = "", timeout: float = 10.0) -> dict:
    """Fetch one process's DUMPOBS bundle over the line protocol."""
    from hetu_tpu_torch.rpc.client import CoordinatorClient
    cli = CoordinatorClient(port, host=host, timeout=timeout,
                            token=token)
    try:
        return cli.dump_obs()
    finally:
        cli.close()


def _load_path(path: str) -> dict:
    """A ``.json`` file is a chrome doc (or a DUMPOBS bundle); a
    ``.jsonl`` file is a flight dump. Either becomes a bundle."""
    if path.endswith(".jsonl"):
        events, header = [], {}
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                if rec.get("kind") == "flight_header":
                    header = rec
                elif rec.get("kind") == "flight_event":
                    events.append(rec)
        return {"replica": header.get("replica")
                or f"rank{header.get('rank', '?')}",
                "role": header.get("role"), "pid": header.get("pid"),
                "epoch_unix": header.get("epoch_unix", 0.0),
                "chrome": {"traceEvents": []}, "flight": events}
    with open(path) as f:
        doc = json.load(f)
    if "chrome" in doc or "flight" in doc:   # already a DUMPOBS bundle
        return doc
    return {"replica": os.path.splitext(os.path.basename(path))[0],
            "epoch_unix": (doc.get("otherData") or {}).get(
                "epoch_unix", 0.0),
            "chrome": doc, "flight": []}


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="fleet_trace",
        description="merge per-process traces into one fleet Perfetto "
                    "timeline")
    ap.add_argument("paths", nargs="*",
                    help="chrome .json docs / DUMPOBS bundle .json / "
                         "flight .jsonl dumps")
    ap.add_argument("--dump", action="append", default=[],
                    metavar="NAME=PORT",
                    help="fetch a live process's DUMPOBS bundle")
    ap.add_argument("--offset", action="append", default=[],
                    metavar="NAME=SECONDS",
                    help="clock offset (replica wall minus master "
                         "wall) for NAME; overrides the bundle's own")
    ap.add_argument("--master", default=None,
                    help="entry name to use as the clock master")
    ap.add_argument("--token", default="",
                    help="line-protocol auth token for --dump")
    ap.add_argument("--out", default="fleet_trace.json")
    args = ap.parse_args(argv)

    bundles: list[dict] = []
    for spec in args.dump:
        name, _, port = spec.partition("=")
        b = collect_dump(int(port), token=args.token)
        if name and not b.get("replica"):
            b["replica"] = name
        bundles.append(b)
    for path in args.paths:
        bundles.append(_load_path(path))
    if not bundles:
        ap.error("nothing to merge: give paths and/or --dump")
    offsets = {}
    for spec in args.offset:
        name, _, sec = spec.partition("=")
        offsets[name] = float(sec)
    merged = merge_bundles(bundles, offsets=offsets,
                           master=args.master)
    with open(args.out, "w") as f:
        json.dump(merged, f)
    n_ev = sum(1 for ev in merged["traceEvents"]
               if ev.get("ph") != "M")
    n_req = sum(1 for ev in merged["traceEvents"]
                if ev.get("ph") == "M"
                and ev.get("pid") == REQ_PID
                and ev.get("name") == "thread_name")
    print(f"fleet_trace: merged {len(bundles)} processes, "
          f"{n_ev} events, {n_req} request tracks -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
