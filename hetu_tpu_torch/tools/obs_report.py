"""obs_report: render flight records + SLO verdicts for an operator (a
copy of ``hetu_tpu/tools/obs_report.py``).

Usage::

    python -m hetu_tpu_torch.tools.obs_report runs/exp1/flight_0.jsonl
    python -m hetu_tpu_torch.tools.obs_report runs/exp1          # a directory
    python -m hetu_tpu_torch.tools.obs_report runs/exp1 --tail 50

Reads the artifacts the production-observability layer leaves behind
(``telemetry/flight.py`` dumps, ``telemetry.jsonl`` with ``slo_alert``
records) and prints the postmortem: why the dump happened, what the
system was doing (event timeline tail + per-kind counts), which threads
were where, and which SLO rules fired. ``trace_summary`` stays the
goodput/plane view; this is the forensics view.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time
from typing import Optional


def load_jsonl(path: str) -> list[dict]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def _is_flight_file(path: str) -> bool:
    """Content check (first record is a ``flight_header``) — dumps are
    not always named ``flight_<rank>.jsonl`` (e.g. BENCH_flight.jsonl)."""
    try:
        with open(path) as f:
            first = f.readline()
        return json.loads(first).get("kind") == "flight_header"
    except (OSError, json.JSONDecodeError, AttributeError):
        return False


def find_artifacts(path: str) -> tuple[list[str], Optional[str]]:
    """(flight dumps, telemetry.jsonl) under a file or directory path."""
    if os.path.isdir(path):
        flights = sorted(
            p for p in glob.glob(os.path.join(path, "*flight*.jsonl"))
            if _is_flight_file(p))
        tj = os.path.join(path, "telemetry.jsonl")
        return flights, tj if os.path.exists(tj) else None
    if _is_flight_file(path):
        tj = os.path.join(os.path.dirname(path), "telemetry.jsonl")
        return [path], tj if os.path.exists(tj) else None
    return [], path


def _fmt_ts(ts_unix: float, epoch: Optional[float]) -> str:
    if epoch:
        return f"+{ts_unix - epoch:9.3f}s"
    return time.strftime("%H:%M:%S", time.localtime(ts_unix))


def flight_report(path: str, *, tail: int = 30) -> list[str]:
    records = load_jsonl(path)
    header = next((r for r in records
                   if r.get("kind") == "flight_header"), {})
    events = [r for r in records if r.get("kind") == "flight_event"]
    stacks = next((r for r in records
                   if r.get("kind") == "thread_stacks"), None)
    lines = [f"== flight record ({path}) =="]
    if header:
        who = ""
        if header.get("replica"):
            who = f"   replica {header['replica']}"
            if header.get("role"):
                who += f" ({header['role']})"
        lines.append(
            f"reason {header.get('reason', '?')}   rank "
            f"{header.get('rank', '?')}   pid {header.get('pid', '?')}"
            f"{who}   "
            f"events {header.get('events_total', len(events))} "
            f"({header.get('events_dropped', 0)} dropped)")
        if header.get("watchdog"):
            lines.append(f"watchdog [{header['watchdog']}] tripped after "
                         f"{header.get('stalled_s', '?')}s without "
                         f"progress")
    by_kind: dict[str, int] = {}
    for ev in events:
        by_kind[ev.get("event", "?")] = by_kind.get(
            ev.get("event", "?"), 0) + 1
    if by_kind:
        lines.append("event counts     "
                     + "  ".join(f"{k}={v}" for k, v in
                                 sorted(by_kind.items(),
                                        key=lambda kv: -kv[1])))
    if events:
        lines.append(f"-- last {min(tail, len(events))} events --")
        epoch = header.get("epoch_unix")
        for ev in events[-tail:]:
            extra = {k: v for k, v in ev.items()
                     if k not in ("kind", "seq", "ts_unix", "tid",
                                  "event")}
            lines.append(
                f"  {_fmt_ts(ev.get('ts_unix', 0.0), epoch)} "
                f"{ev.get('event', '?'):<22} "
                + " ".join(f"{k}={v}" for k, v in extra.items()))
    if stacks is not None:
        lines.append(f"-- thread stacks ({len(stacks['stacks'])} "
                     f"threads) --")
        for name, frames in stacks["stacks"].items():
            lines.append(f"  [{name}]")
            # innermost frames are what the operator needs
            for fr in frames[-3:]:
                for ln in fr.splitlines():
                    lines.append(f"    {ln}")
    return lines


def slo_report(path: str) -> Optional[list[str]]:
    """SLO verdicts from a telemetry.jsonl: fired alerts + the final
    alerting/trip counters from the last registry snapshot."""
    try:
        records = load_jsonl(path)
    except (OSError, json.JSONDecodeError):
        return None
    from hetu_tpu_torch.telemetry.slo import health_from_snapshot
    alerts = [r for r in records if r.get("kind") == "slo_alert"]
    snap: dict = {}
    for rec in records:
        cand = rec.get("metrics") if rec.get("kind") == "metrics_snapshot" \
            else rec.get("telemetry")
        if isinstance(cand, dict):
            snap = cand
    lines: list[str] = []
    if alerts:
        lines.append(f"-- fired alerts ({len(alerts)}) --")
        for a in alerts:
            lines.append(f"  [{a.get('alert_kind', '?'):>10}] "
                         f"{a.get('rule', '?')}: {a.get('message', '')}")
    hs = health_from_snapshot(snap)
    trips = hs["watchdog_trips"]
    fired = hs["alerts_by_rule"]
    alerting = hs["alerting_rules"]
    if trips or fired or alerting:
        lines.append("-- verdicts --")
        if trips:
            lines.append(f"  watchdog trips   {trips}")
        for rule, n in sorted(fired.items()):
            state = "STILL ALERTING" if rule in alerting else "cleared"
            lines.append(f"  {rule:<24} fired {int(n)}x ({state})")
    if not lines:
        return None
    return lines


def fleet_overview(flights: list[str]) -> list[str]:
    """One line per process when a directory holds dumps from SEVERAL
    processes (a multi-process fleet run: pid-suffixed names stop the
    dumps clobbering each other; the headers carry replica/role
    identity). Single-process directories render nothing extra."""
    rows = []
    for fp in flights:
        try:
            with open(fp) as f:
                header = json.loads(f.readline())
        except (OSError, json.JSONDecodeError):
            continue
        if header.get("kind") != "flight_header":
            continue
        rows.append((
            header.get("replica") or f"rank{header.get('rank', '?')}",
            header.get("role") or "-", header.get("pid", "?"),
            header.get("reason", "?"), header.get("events_total", 0),
            os.path.basename(fp)))
    if len(rows) < 2:
        return []
    lines = [f"== fleet overview ({len(rows)} processes) =="]
    for name, role, pid, reason, n, base in sorted(rows):
        lines.append(f"  {name:<12} role {role:<8} pid {pid!s:<8} "
                     f"reason {reason:<12} events {n}  [{base}]")
    lines.append("")
    return lines


def report(path: str, *, tail: int = 30) -> str:
    flights, tj = find_artifacts(path)
    parts: list[str] = list(fleet_overview(flights))
    for fp in flights:
        parts.extend(flight_report(fp, tail=tail))
        parts.append("")
    if tj is not None:
        sl = slo_report(tj)
        if sl:
            parts.append(f"== SLO verdicts ({tj}) ==")
            parts.extend(sl)
    if not parts:
        return (f"obs_report: no flight_*.jsonl or telemetry.jsonl "
                f"found under {path}")
    return "\n".join(parts).rstrip()


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="obs_report",
        description="Postmortem view of hetu_tpu_torch flight records and "
                    "SLO verdicts")
    ap.add_argument("path",
                    help="flight_<rank>.jsonl, telemetry.jsonl, or a "
                         "directory holding them")
    ap.add_argument("--tail", type=int, default=30,
                    help="how many trailing flight events to print")
    args = ap.parse_args(argv)
    if not os.path.exists(args.path):
        print(f"obs_report: no such file: {args.path}", file=sys.stderr)
        return 2
    try:
        print(report(args.path, tail=args.tail))
    except FileNotFoundError:
        print(f"obs_report: no such file: {args.path}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
