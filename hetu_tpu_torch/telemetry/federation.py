"""Fleet metrics/health federation (a copy of
``hetu_tpu/telemetry/federation.py``).

The Router scrapes each replica's METRICS/HEALTHZ exposition and this
module merges the per-process Prometheus texts into one fleet-scoped
page: every series gains a ``replica="<name>"`` label, HELP/TYPE lines
are emitted once per metric, and counters/gauges are additionally
pre-aggregated across replicas into ``replica="_fleet"`` totals (for
summaries only the ``_count``/``_sum`` series aggregate — quantiles do
not add). A matching health rollup names the degraded replicas instead
of collapsing them into a boolean.

Pure host-side text processing — stdlib only, importable from
the router process, the lint, and the ``fleet_top`` terminal view.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

__all__ = [
    "parse_prometheus",
    "merge_prometheus",
    "health_rollup",
    "FLEET_REPLICA",
]

#: Synthetic replica-label value for the pre-aggregated fleet totals.
FLEET_REPLICA = "_fleet"

#: When a scraped series already carries a ``replica`` label (e.g. the
#: router's own ``router_replica_load{replica=...}`` gauges), the
#: original label is preserved under this name so federation never
#: silently drops a dimension.
_ORIG_LABEL = "orig_replica"


def _escape_label_value(v: str) -> str:
    return (v.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _unescape_label_value(v: str) -> str:
    out: List[str] = []
    i = 0
    while i < len(v):
        c = v[i]
        if c == "\\" and i + 1 < len(v):
            nxt = v[i + 1]
            if nxt == "n":
                out.append("\n")
            elif nxt in ("\\", '"'):
                out.append(nxt)
            else:            # unknown escape: keep verbatim
                out.append(c)
                out.append(nxt)
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _parse_labels(s: str) -> Optional[Dict[str, str]]:
    """Parse ``k="v",k2="v2"`` (the inside of ``{...}``); ``None`` on
    malformed input. Handles escaped quotes inside values."""
    labels: Dict[str, str] = {}
    i, n = 0, len(s)
    while i < n:
        j = s.find("=", i)
        if j < 0:
            return None
        key = s[i:j].strip()
        if not key:
            return None
        i = j + 1
        if i >= n or s[i] != '"':
            return None
        i += 1
        buf: List[str] = []
        while i < n:
            c = s[i]
            if c == "\\" and i + 1 < n:
                buf.append(c)
                buf.append(s[i + 1])
                i += 2
                continue
            if c == '"':
                break
            buf.append(c)
            i += 1
        if i >= n:           # unterminated value
            return None
        labels[key] = _unescape_label_value("".join(buf))
        i += 1               # past closing quote
        if i < n and s[i] == ",":
            i += 1
    return labels


def parse_prometheus(text: str):
    """``(meta, samples)`` from an exposition page.

    ``meta``: ``{metric_name: {"help": str, "type": str}}`` (either key
    may be absent). ``samples``: list of ``(name, labels, value)``
    where labels values are unescaped. Unparseable lines are skipped —
    federation must degrade, not crash, on a weird replica.
    """
    meta: Dict[str, Dict[str, str]] = {}
    samples: List[Tuple[str, Dict[str, str], float]] = []
    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 4 and parts[1] in ("HELP", "TYPE"):
                meta.setdefault(parts[2], {})[parts[1].lower()] = parts[3]
            continue
        if "{" in line:
            brace = line.index("{")
            name = line[:brace]
            close = line.rfind("}")
            if close < brace:
                continue
            labels = _parse_labels(line[brace + 1:close])
            if labels is None:
                continue
            val_s = line[close + 1:].strip()
        else:
            bits = line.split()
            if len(bits) != 2:
                continue
            name, val_s = bits
            labels = {}
        try:
            value = float(val_s)
        except ValueError:
            continue
        samples.append((name, labels, value))
    return meta, samples


def _base_name(name: str, meta: Dict[str, Dict[str, str]]) -> str:
    """Map ``x_count``/``x_sum`` back to their summary family ``x``."""
    for suffix in ("_count", "_sum"):
        if name.endswith(suffix):
            base = name[:-len(suffix)]
            if meta.get(base, {}).get("type") == "summary":
                return base
    return name


def _aggregatable(name: str, labels: Dict[str, str],
                  meta: Dict[str, Dict[str, str]]) -> bool:
    base = _base_name(name, meta)
    mtype = meta.get(base, {}).get("type")
    if mtype in ("counter", "gauge"):
        return True
    if mtype == "summary":
        # _count/_sum add across replicas; quantiles do not.
        return name != base
    # untyped: trust the _total convention, refuse the rest
    return name.endswith("_total")


def _fmt_sample(name: str, labels: Dict[str, str], value: float) -> str:
    if labels:
        body = ",".join(
            f'{k}="{_escape_label_value(v)}"'
            for k, v in sorted(labels.items()))
        return f"{name}{{{body}}} {value}"
    return f"{name} {value}"


def merge_prometheus(texts: Dict[str, str], *,
                     replica_label: str = "replica",
                     fleet_totals: bool = True) -> str:
    """Merge ``{replica_name: exposition_text}`` into one fleet page.

    Every sample gains ``replica_label="<name>"``; a pre-existing label
    of that name is renamed to ``orig_replica``. With ``fleet_totals``,
    counters/gauges (and summary ``_count``/``_sum``) are also summed
    across replicas into ``replica="_fleet"`` series grouped by their
    original label sets.
    """
    meta: Dict[str, Dict[str, str]] = {}
    # name -> list of (labels_with_replica, value); insertion-ordered
    series: Dict[str, List[Tuple[Dict[str, str], float]]] = {}
    # (name, sorted original-label items) -> summed value
    totals: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float] = {}

    for rep in sorted(texts):
        rmeta, samples = parse_prometheus(texts[rep])
        for mname, m in rmeta.items():
            dst = meta.setdefault(mname, {})
            for k, v in m.items():
                dst.setdefault(k, v)
        for name, labels, value in samples:
            labels = dict(labels)
            if replica_label in labels:
                labels[_ORIG_LABEL] = labels.pop(replica_label)
            key_labels = tuple(sorted(labels.items()))
            out_labels = dict(labels)
            out_labels[replica_label] = rep
            series.setdefault(name, []).append((out_labels, value))
            if fleet_totals and _aggregatable(name, labels, meta):
                tkey = (name, key_labels)
                totals[tkey] = totals.get(tkey, 0.0) + value

    lines: List[str] = [
        f"# fleet federation of {len(texts)} replica(s) "
        f"at {time.time():.3f}"]
    for name in sorted(series):
        base = _base_name(name, meta)
        if name == base or base not in series:
            m = meta.get(base, {})
            if "help" in m:
                lines.append(f"# HELP {base} {m['help']}")
            if "type" in m:
                lines.append(f"# TYPE {base} {m['type']}")
        for labels, value in series[name]:
            lines.append(_fmt_sample(name, labels, value))
        if fleet_totals:
            for (tname, tlabels), tvalue in totals.items():
                if tname != name:
                    continue
                out = dict(tlabels)
                out[replica_label] = FLEET_REPLICA
                lines.append(_fmt_sample(tname, out, tvalue))
    return "\n".join(lines) + "\n"


def health_rollup(replicas: Dict[str, Dict]) -> Dict:
    """Fleet HEALTHZ from per-replica health docs.

    ``replicas``: ``{name: {"status": "ok"|"degraded"|..., ...}}``.
    The rollup is ``ok`` only when every replica is; otherwise it is
    ``degraded`` and ``degraded`` lists the offending replica names —
    the first question an operator asks.
    """
    degraded = sorted(
        name for name, doc in replicas.items()
        if (doc or {}).get("status") != "ok")
    return {
        "status": "ok" if (replicas and not degraded) else "degraded",
        "ts_unix": time.time(),
        "replicas_total": len(replicas),
        "replicas_ok": len(replicas) - len(degraded),
        "degraded": degraded,
        "replicas": replicas,
    }
