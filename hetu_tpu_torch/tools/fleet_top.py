"""fleet_top: live terminal status view over a fleet front door (a copy of
``hetu_tpu/tools/fleet_top.py``).

``top`` for a serving fleet: one screen that
answers "is the fleet healthy, who is loaded, who is skewed, what is
the wire doing" — rendered purely from the federated Prometheus page
the router serves on ``FLEETMETRICS`` (plus the ``HEALTHZ`` fleet
rollup when reachable). Per-replica rows show status, dispatch load,
queue depth, slot occupancy, heartbeat age and measured clock skew;
below them the hottest line-protocol verbs by client-side p50/count.

Everything degrades: a missing series renders as ``-`` (a replica that
just registered has no gauges yet; an in-process fleet has no beat
ages). Stdlib only.

Usage::

    python -m hetu_tpu_torch.tools.fleet_top --port 9123          # live loop
    python -m hetu_tpu_torch.tools.fleet_top --port 9123 --once
    python -m hetu_tpu_torch.tools.fleet_top --snapshot fleet.prom --once
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Optional

from hetu_tpu_torch.telemetry.federation import FLEET_REPLICA, parse_prometheus

#: the router's own registry rides the federated page under this label
LOCAL_REPLICA = "_local"

#: verbs shown in the hot-verb line, at most
MAX_HOT_VERBS = 6


def _fmt(v: Optional[float], spec: str = ".2f") -> str:
    return "-" if v is None else format(v, spec)


def _replica_of(labels: dict) -> Optional[str]:
    """The replica a sample describes. Router-registry series about a
    replica (load, beat age, skew) carry the name in ``orig_replica``
    after federation re-labels; a replica's own series carry it in
    ``replica``."""
    name = labels.get("orig_replica") or labels.get("replica")
    if name in (FLEET_REPLICA, LOCAL_REPLICA):
        return None
    return name


def render(metrics_text: str, health: Optional[dict] = None) -> str:
    """One status screen from a FLEETMETRICS page (+ optional fleet
    HEALTHZ rollup). Pure function — the smoke test feeds it a canned
    snapshot."""
    _meta, samples = parse_prometheus(metrics_text)
    per: dict[str, dict] = {}            # replica -> column values

    def cell(labels, col, value):
        name = _replica_of(labels)
        if name is not None:
            per.setdefault(name, {})[col] = value

    verbs: dict[str, dict] = {}
    for name, labels, value in samples:
        if name == "router_replica_load":
            cell(labels, "load", value)
        elif name == "fleet_replica_beat_age_seconds":
            cell(labels, "beat", value)
        elif name == "fleet_clock_skew_seconds":
            cell(labels, "skew", value)
        elif name == "serving_queue_depth":
            cell(labels, "queue", value)
        elif name == "serving_slot_occupancy":
            cell(labels, "occ", value)
        elif name == "rpc_client_verb_ms" \
                and labels.get("quantile") == "0.5" \
                and labels.get("replica") in (LOCAL_REPLICA, None):
            verbs.setdefault(labels.get("verb", "?"), {})["p50"] = value
        elif name == "rpc_client_verb_ms_count" \
                and labels.get("replica") in (LOCAL_REPLICA, None):
            verbs.setdefault(labels.get("verb", "?"), {})["count"] = value

    health = health or {}
    rollup = health.get("fleet", health) if health else {}
    statuses = {n: (d or {}).get("status", "?")
                for n, d in (rollup.get("replicas") or {}).items()}
    for name, st in statuses.items():
        per.setdefault(name, {})["status"] = st

    lines = []
    n_ok = sum(1 for s in statuses.values() if s == "ok")
    head = f"fleet: {len(per)} replicas"
    if statuses:
        head += (f", {n_ok} ok — "
                 f"{rollup.get('status', '?')}")
        degraded = rollup.get("degraded") or []
        if degraded:
            head += f" (degraded: {', '.join(degraded)})"
    lines.append(head)
    lines.append(f"{'replica':<12} {'status':<9} {'load':>5} "
                 f"{'queue':>6} {'occ':>5} {'beat_s':>7} {'skew_ms':>8}")
    for name in sorted(per):
        row = per[name]
        skew = row.get("skew")
        lines.append(
            f"{name:<12} {row.get('status', '?'):<9} "
            f"{_fmt(row.get('load'), '.0f'):>5} "
            f"{_fmt(row.get('queue'), '.0f'):>6} "
            f"{_fmt(row.get('occ'), '.2f'):>5} "
            f"{_fmt(row.get('beat'), '.1f'):>7} "
            f"{_fmt(None if skew is None else skew * 1e3, '+.1f'):>8}")
    if verbs:
        hot = sorted(verbs.items(),
                     key=lambda kv: -(kv[1].get("count") or 0))
        parts = [f"{v} {_fmt(d.get('p50'))}ms/"
                 f"{_fmt(d.get('count'), '.0f')}"
                 for v, d in hot[:MAX_HOT_VERBS]]
        lines.append("hot verbs (client p50/calls): " + "  ".join(parts))
    return "\n".join(lines) + "\n"


def _fetch(port: int, host: str, token: str,
           timeout: float) -> tuple[str, Optional[dict]]:
    from hetu_tpu_torch.rpc.client import CoordinatorClient
    cli = CoordinatorClient(port, host=host, timeout=timeout,
                            token=token)
    try:
        text = cli.fleet_metrics_text()
        try:
            health = cli.healthz()
        except Exception:                    # noqa: BLE001
            health = None
        return text, health
    finally:
        cli.close()


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="fleet_top",
        description="live fleet status from a router front door")
    ap.add_argument("--port", type=int, default=None,
                    help="front-door line-protocol port (FLEETMETRICS)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--token", default="")
    ap.add_argument("--snapshot", default=None,
                    help="render a saved FLEETMETRICS text file "
                         "instead of scraping")
    ap.add_argument("--interval", type=float, default=2.0)
    ap.add_argument("--once", action="store_true",
                    help="render one frame and exit")
    ap.add_argument("--timeout", type=float, default=5.0)
    args = ap.parse_args(argv)
    if args.snapshot is None and args.port is None:
        ap.error("need --port or --snapshot")
    while True:
        if args.snapshot is not None:
            with open(args.snapshot) as f:
                text = f.read()
            health = None
        else:
            try:
                text, health = _fetch(args.port, args.host,
                                      args.token, args.timeout)
            except Exception as e:           # noqa: BLE001
                print(f"fleet_top: scrape failed: {e}",
                      file=sys.stderr)
                if args.once:
                    return 1
                time.sleep(args.interval)
                continue
        frame = render(text, health)
        if not args.once:
            print("\x1b[2J\x1b[H", end="")   # clear screen, home
        print(frame, end="")
        if args.once:
            return 0
        time.sleep(args.interval)


if __name__ == "__main__":
    raise SystemExit(main())
