"""trace_summary: read telemetry artifacts, print the goodput breakdown
(a copy of ``hetu_tpu/tools/trace_summary.py``, reading the port's
artifacts, which share ``hetu_tpu``'s schemas).

Usage::

    python -m hetu_tpu_torch.tools.trace_summary runs/exp1/telemetry.jsonl
    python -m hetu_tpu_torch.tools.trace_summary runs/exp1/trace.json --wall 42.0

Accepts either artifact the telemetry subsystem writes
(:func:`hetu_tpu_torch.telemetry.export_dir` / ``Trainer`` with
``trace_dir``): the unified JSONL (``kind: span|metrics|goodput|...``
records) or a Chrome-trace JSON (``traceEvents``). Prints the goodput
table (compute/compile/switch/checkpoint/stall vs wall), the heaviest
spans, and the last logged training metrics.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from typing import Optional

from hetu_tpu_torch.telemetry.goodput import (
    format_goodput_table, report_from_records,
)


def load_records(path: str) -> list[dict]:
    """JSONL → record list; Chrome trace → synthesized span records."""
    with open(path) as f:
        text = f.read()
    try:
        obj = json.loads(text)               # whole file = one document?
    except json.JSONDecodeError:
        return [json.loads(line) for line in text.splitlines()
                if line.strip()]             # JSONL
    if isinstance(obj, dict) and "traceEvents" in obj:
        records = []
        for ev in obj["traceEvents"]:
            if ev.get("ph") != "X":
                continue
            records.append({
                "kind": "span", "name": ev.get("name", ""),
                "cat": ev.get("cat", "span"),
                "ts_s": ev.get("ts", 0.0) / 1e6,
                "dur_s": ev.get("dur", 0.0) / 1e6,
                "tid": ev.get("tid", 0),
                "depth": 0, "attrs": ev.get("args", {}),
            })
        return records
    # a one-record JSONL parses as a single dict; a JSON array passes
    # through as-is
    return [obj] if isinstance(obj, dict) else list(obj)


def span_rollup(records: list[dict], top: int = 10) -> list[tuple]:
    """(name, count, total_s, max_s) rows for the heaviest span names."""
    agg: dict[str, list[float]] = {}
    for rec in records:
        if rec.get("kind") != "span":
            continue
        agg.setdefault(rec.get("name", "?"), []).append(
            rec.get("dur_s", 0.0))
    rows = [(name, len(durs), sum(durs), max(durs))
            for name, durs in agg.items()]
    rows.sort(key=lambda r: -r[2])
    return rows[:top]


def last_metrics(records: list[dict]) -> Optional[dict]:
    out = None
    for rec in records:
        if rec.get("kind") == "metrics":
            out = rec
    return out


#: control-plane counters surfaced as their own section: the direct
#: evidence the StepCache / AOT precompiler / prefetch overlap are (or
#: are not) killing the compile+stall tax (docs/PERFORMANCE.md).
_CONTROL_PLANE_COUNTERS = (
    "step_cache_hits_total", "step_cache_misses_total",
    "precompiled_strategies_total",
    "prefetch_batches_total", "prefetch_ready_total",
    "prefetch_restaged_total",
    "switch_fastpath_leaves_total", "switch_reassembled_leaves_total",
    "switches_total", "data_stall_seconds",
    # streaming control plane: push-vs-poll split — direct
    # evidence the subscription lane carries the tokens (pushes high,
    # empty polls / fallbacks / drops ~0) or has degraded to polling
    "serving_stream_events_total", "serving_stream_tokens_total",
    "serving_stream_fallbacks_total",
    "serving_stream_subscriber_drops_total",
    "router_result_poll_empty_total",
)


def control_plane_summary(records: list[dict]) -> Optional[list[str]]:
    """Lines for the step-cache / prefetch counter section, or None when
    no telemetry snapshot carries them. Reads the LAST snapshot seen
    (counters are cumulative)."""
    snap: Optional[dict] = None
    for rec in records:
        cand = rec.get("metrics") if rec.get("kind") == "metrics_snapshot" \
            else rec.get("telemetry")
        if isinstance(cand, dict) and any(
                k.split("{")[0] in _CONTROL_PLANE_COUNTERS for k in cand):
            snap = cand
    if snap is None:
        return None
    vals = {}
    for series, v in snap.items():
        base = series.split("{")[0]
        if base in _CONTROL_PLANE_COUNTERS and isinstance(v, (int, float)):
            vals[base] = vals.get(base, 0.0) + v
    if not vals:
        return None
    lines = []
    hits = vals.get("step_cache_hits_total", 0.0)
    misses = vals.get("step_cache_misses_total", 0.0)
    if hits or misses:
        rate = hits / (hits + misses) if (hits + misses) else 0.0
        lines.append(f"step cache       {int(hits)} hits / "
                     f"{int(misses)} misses ({100.0 * rate:.0f}% hit)")
    if vals.get("precompiled_strategies_total"):
        lines.append(f"precompiled      "
                     f"{int(vals['precompiled_strategies_total'])} "
                     f"strategies (background AOT)")
    served = vals.get("prefetch_batches_total", 0.0)
    if served:
        ready = vals.get("prefetch_ready_total", 0.0)
        lines.append(f"prefetch         {int(ready)}/{int(served)} "
                     f"batches pre-staged "
                     f"({100.0 * ready / served:.0f}% overlapped)")
    if vals.get("prefetch_restaged_total"):
        lines.append(f"restaged         "
                     f"{int(vals['prefetch_restaged_total'])} batches "
                     f"(post-switch re-place)")
    fast = vals.get("switch_fastpath_leaves_total", 0.0)
    slow = vals.get("switch_reassembled_leaves_total", 0.0)
    if fast or slow:
        lines.append(f"switch leaves    {int(fast)} device_put fast path"
                     f" / {int(slow)} host-reassembled")
    evs = vals.get("serving_stream_events_total", 0.0)
    if evs:
        lines.append(f"stream push      {int(evs)} events / "
                     f"{int(vals.get('serving_stream_tokens_total', 0.0))}"
                     f" tokens pushed")
    falls = vals.get("serving_stream_fallbacks_total", 0.0)
    drops = vals.get("serving_stream_subscriber_drops_total", 0.0)
    empty = vals.get("router_result_poll_empty_total", 0.0)
    if evs or falls or drops or empty:
        lines.append(f"push vs poll     {int(empty)} empty RESULT polls"
                     f" / {int(falls)} fallbacks / "
                     f"{int(drops)} subscriber drops")
    return lines


#: data-plane counters (comm bytes, overlap share, DP sync rate): the
#: direct evidence the ring matmuls / delayed grad sync / double-buffered
#: pipeline are (or are not) killing the collective tax
#: (docs/PERFORMANCE.md "Data plane").
_DATA_PLANE_COUNTERS = (
    "comm_bytes_total", "comm_overlapped_bytes_total",
    "dp_grad_syncs_total", "optimizer_updates_total",
)


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(n) < 1024.0 or unit == "TB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024.0
    return f"{n:.1f}TB"


def data_plane_summary(records: list[dict]) -> Optional[list[str]]:
    """Lines for the comm-bytes / overlap / DP-sync section, or None
    when no snapshot carries data-plane counters. Reads the LAST
    snapshot (counters are cumulative)."""
    snap: Optional[dict] = None
    for rec in records:
        cand = rec.get("metrics") if rec.get("kind") == "metrics_snapshot" \
            else rec.get("telemetry")
        if isinstance(cand, dict) and any(
                k.split("{")[0] in _DATA_PLANE_COUNTERS for k in cand):
            snap = cand
    if snap is None:
        return None
    by_kind: dict[str, float] = {}
    overlapped = 0.0
    syncs = updates = 0.0
    for series, v in snap.items():
        if not isinstance(v, (int, float)):
            continue
        base = series.split("{")[0]
        if base == "comm_bytes_total":
            kind = "?"
            if "{" in series and 'kind="' in series:
                kind = series.split('kind="', 1)[1].split('"', 1)[0]
            by_kind[kind] = by_kind.get(kind, 0.0) + v
        elif base == "comm_overlapped_bytes_total":
            overlapped += v
        elif base == "dp_grad_syncs_total":
            syncs += v
        elif base == "optimizer_updates_total":
            updates += v
    lines = []
    total = sum(by_kind.values())
    width = max([len(f"comm[{k}]") for k in by_kind] + [16]) + 2
    # cumulative, not per-step: ring/pipeline bytes accrue per TRACE,
    # dp_grad_sync bytes per host call (see parallel/overlap.py)
    for kind in sorted(by_kind, key=lambda k: -by_kind[k]):
        lines.append(f"comm[{kind}]".ljust(width)
                     + f"{_fmt_bytes(by_kind[kind])} cumulative")
    if total:
        lines.append("overlap ratio".ljust(width)
                     + f"{100.0 * overlapped / total:.0f}% "
                     f"of data-plane bytes on overlapping paths")
    if updates:
        lines.append("dp syncs/update".ljust(width)
                     + f"{syncs / updates:.2f} "
                     f"({int(syncs)} syncs / {int(updates)} updates — "
                     f"1.00 = fully delayed grad sync)")
    return lines or None


#: memory-plane gauges (engine.memory ledger): peak bytes by class, the
#: recompute tax the remat policy pays, and the fsdp gather accounting —
#: the direct evidence the per-layer gather ring / remat policy engine
#: are (or are not) killing the memory tax (docs/PERFORMANCE.md
#: "Memory plane").
_MEMORY_PLANE_GAUGES = (
    "mem_params_bytes", "mem_grads_bytes", "mem_opt_bytes",
    "mem_act_bytes", "mem_peak_bytes", "mem_remat_recompute_flops",
)


#: shape-plane series (data/bucket.ShapeBucketer + the serving CP-prefill
#: lane): the padding-tax view — how many dispatched tokens were real vs
#: pad, which buckets absorbed the traffic, how many step programs the
#: ragged epoch actually compiled, and what share of serving prompts
#: took the CP lane (docs/PERFORMANCE.md "Shape plane").
_SHAPE_PLANE_SERIES = (
    "data_real_tokens_total", "data_padding_tokens_total",
    "data_raw_tokens_total", "data_bucket_hits_total",
    "data_bucket_compiles_total", "serving_cp_prefill_requests_total",
    "serving_cp_prefill_tokens_total",
)


def shape_plane_summary(records: list[dict]) -> Optional[list[str]]:
    """Lines for the shape-plane section, or None when no snapshot
    carries the bucketing/CP-prefill series. Reads the LAST snapshot
    (counters are cumulative)."""
    snap: Optional[dict] = None
    for rec in records:
        cand = rec.get("metrics") if rec.get("kind") == "metrics_snapshot" \
            else rec.get("telemetry")
        if isinstance(cand, dict) and any(
                k.split("{")[0] in _SHAPE_PLANE_SERIES for k in cand):
            snap = cand
    if snap is None:
        return None
    vals: dict[str, float] = {}
    buckets: dict[str, float] = {}
    compiles: dict[str, float] = {}
    traces = 0.0
    for series, v in snap.items():
        if not isinstance(v, (int, float)):
            continue
        base = series.split("{")[0]
        if base == "data_bucket_hits_total":
            m = re.search(r'bucket="([^"]+)"', series)
            buckets[m.group(1) if m else "?"] = v
        elif base == "data_bucket_compiles_total":
            m = re.search(r'bucket="([^"]+)"', series)
            compiles[m.group(1) if m else "?"] = v
        elif base == "step_traces_total" \
                and 'what="train_step"' in series:
            traces += v
        elif base in _SHAPE_PLANE_SERIES:
            vals[base] = v
    if not vals and not buckets:
        return None
    lines = []
    width = 18
    real = vals.get("data_real_tokens_total", 0.0)
    pad = vals.get("data_padding_tokens_total", 0.0)
    raw = vals.get("data_raw_tokens_total", 0.0)
    if real or pad:
        lines.append("pad fraction".ljust(width)
                     + f"{100.0 * pad / max(real + pad, 1):.1f}% after "
                     f"bucketing"
                     + (f" (vs {100.0 * (1 - real / raw):.1f}% as the "
                        f"loader padded)" if raw else ""))
        lines.append("real tokens".ljust(width) + f"{real:,.0f}")
    if buckets:
        total = sum(buckets.values())
        for b in sorted(buckets, key=lambda x: int(x)
                        if x.isdigit() else 0):
            note = ""
            if b in compiles:
                note = f", {compiles[b]:.0f} compile(s)"
            lines.append(f"  bucket {b}".ljust(width)
                         + f"{buckets[b]:.0f} batches "
                         f"({100.0 * buckets[b] / total:.0f}%{note})")
    if traces:
        lines.append("train-step traces".ljust(width)
                     + f"{traces:.0f} total (the <= n_buckets audit)")
    cp_req = vals.get("serving_cp_prefill_requests_total", 0.0)
    if cp_req:
        cp_tok = vals.get("serving_cp_prefill_tokens_total", 0.0)
        served = snap.get('serving_requests_total{outcome="completed"}',
                          0.0)
        share = f" ({100.0 * cp_req / served:.0f}% of completed)" \
            if served else ""
        lines.append("cp-prefill lane".ljust(width)
                     + f"{cp_req:.0f} long prompts{share}, "
                     f"{cp_tok:,.0f} tokens prefilled cp-sharded")
    return lines


def memory_plane_summary(records: list[dict]) -> Optional[list[str]]:
    """Lines for the memory-ledger section, or None when no snapshot
    carries ``mem_*`` gauges. Reads the LAST snapshot (gauges are
    last-write-wins); the fsdp gather split comes from the data-plane
    byte counters in the same snapshot."""
    snap: Optional[dict] = None
    for rec in records:
        cand = rec.get("metrics") if rec.get("kind") == "metrics_snapshot" \
            else rec.get("telemetry")
        if isinstance(cand, dict) and any(
                k.split("{")[0] in _MEMORY_PLANE_GAUGES for k in cand):
            snap = cand
    if snap is None:
        return None
    vals: dict[str, float] = {}
    fsdp_bytes = fsdp_overlapped = 0.0
    for series, v in snap.items():
        if not isinstance(v, (int, float)):
            continue
        base = series.split("{")[0]
        if base in _MEMORY_PLANE_GAUGES:
            vals[base] = v
        elif base == "comm_bytes_total" and 'kind="fsdp_gather"' in series:
            fsdp_bytes += v
        elif base == "comm_overlapped_bytes_total" \
                and 'kind="fsdp_gather"' in series:
            fsdp_overlapped += v
    if not vals:
        return None
    lines = []
    width = 18
    if vals.get("mem_peak_bytes"):
        lines.append("peak (ledger)".ljust(width)
                     + f"{_fmt_bytes(vals['mem_peak_bytes'])} per device")
    for label, key in (("params", "mem_params_bytes"),
                       ("grads", "mem_grads_bytes"),
                       ("optimizer", "mem_opt_bytes"),
                       ("activations", "mem_act_bytes")):
        if key in vals:
            lines.append(f"  {label}".ljust(width)
                         + _fmt_bytes(vals[key]))
    rf = vals.get("mem_remat_recompute_flops", 0.0)
    if rf:
        lines.append("remat recompute".ljust(width)
                     + f"{rf / 1e12:.2f} TFLOP/step replayed in bwd")
    if fsdp_bytes:
        lines.append("fsdp gathers".ljust(width)
                     + f"{_fmt_bytes(fsdp_bytes)} cumulative "
                     f"({100.0 * fsdp_overlapped / fsdp_bytes:.0f}% on "
                     f"the per-block overlap ring)")
    return lines


#: serving-plane series (hetu_tpu_torch/serving): request/token flow, latency
#: histograms (TTFT/TPOT), queue depth and slot occupancy — the direct
#: evidence the continuous-batching engine is (or is not) keeping the
#: pool busy without queueing collapse (docs/SERVING.md).
_SERVING_PLANE_SERIES = (
    "serving_requests_total", "serving_tokens_total",
    "serving_queue_depth", "serving_slot_occupancy",
    "serving_ttft_seconds", "serving_tpot_seconds",
    "serving_step_seconds",
    "serving_draft_tokens_total", "serving_accepted_tokens_total",
    "serving_sampled_accepted_tokens_total",
    "serving_resample_tokens_total",
    "serving_decode_slot_steps_total", "serving_preemptions_total",
    "serving_kv_spilled_blocks_total", "serving_kv_resumed_blocks_total",
)


def serving_plane_summary(records: list[dict]) -> Optional[list[str]]:
    """Lines for the serving-engine section, or None when no snapshot
    carries ``serving_*`` series. Reads the LAST snapshot (counters are
    cumulative, gauges last-write-wins, histograms carry their own
    percentile summaries)."""
    snap: Optional[dict] = None
    for rec in records:
        cand = rec.get("metrics") if rec.get("kind") == "metrics_snapshot" \
            else rec.get("telemetry")
        if isinstance(cand, dict) and any(
                k.split("{")[0] in _SERVING_PLANE_SERIES for k in cand):
            snap = cand
    if snap is None:
        return None
    by_label: dict[str, dict[str, float]] = {}
    hists: dict[str, dict] = {}
    gauges: dict[str, float] = {}
    for series, v in snap.items():
        base = series.split("{")[0]
        if base not in _SERVING_PLANE_SERIES:
            continue
        label = series.split('="', 1)[1].split('"', 1)[0] \
            if "{" in series else ""
        if isinstance(v, dict):                    # histogram summary
            hists[base] = v
        elif base in ("serving_queue_depth", "serving_slot_occupancy"):
            gauges[base] = float(v)
        else:
            by_label.setdefault(base, {})[label] = float(v)
    lines = []
    width = 18
    toks = by_label.get("serving_tokens_total", {})
    if toks:
        parts = " / ".join(f"{int(v)} {k}" for k, v in sorted(toks.items()))
        lines.append("tokens".ljust(width) + parts)
    reqs = by_label.get("serving_requests_total", {})
    if reqs:
        parts = " / ".join(f"{int(v)} {k}" for k, v in sorted(reqs.items()))
        lines.append("requests".ljust(width) + parts)
    for label, key in (("ttft", "serving_ttft_seconds"),
                       ("tpot", "serving_tpot_seconds"),
                       ("engine step", "serving_step_seconds")):
        h = hists.get(key)
        if h and h.get("count"):
            lines.append(label.ljust(width)
                         + f"p50 {h['p50'] * 1e3:.1f}ms  "
                         f"p99 {h['p99'] * 1e3:.1f}ms  "
                         f"(n={int(h['count'])})")
    dr = sum(by_label.get("serving_draft_tokens_total", {}).values())
    if dr:
        ac = sum(by_label.get(
            "serving_accepted_tokens_total", {}).values())
        steps = sum(by_label.get(
            "serving_decode_slot_steps_total", {}).values())
        line = (f"{int(ac)}/{int(dr)} accepted "
                f"({100.0 * ac / dr:.0f}%)")
        if steps:
            line += f"  {1.0 + ac / steps:.2f} tok/slot-step"
        # sampled/greedy split: accepted tokens that went through the
        # rejection-sampling verify lane vs the greedy-match rule
        sac = sum(by_label.get(
            "serving_sampled_accepted_tokens_total", {}).values())
        if sac:
            res = sum(by_label.get(
                "serving_resample_tokens_total", {}).values())
            line += (f"  [sampled {int(sac)} / greedy "
                     f"{int(ac - sac)}; {int(res)} resampled]")
        lines.append("speculation".ljust(width) + line)
    pre = by_label.get("serving_preemptions_total", {})
    if pre:
        spilled = sum(by_label.get(
            "serving_kv_spilled_blocks_total", {}).values())
        resumed = sum(by_label.get(
            "serving_kv_resumed_blocks_total", {}).values())
        per = " ".join(f"p{k}:{int(v)}" for k, v in sorted(pre.items()))
        lines.append("preemptions".ljust(width)
                     + f"{int(sum(pre.values()))} ({per})  "
                     f"spilled {int(spilled)} / resumed "
                     f"{int(resumed)} blocks")
    if "serving_slot_occupancy" in gauges:
        lines.append("slot occupancy".ljust(width)
                     + f"{100.0 * gauges['serving_slot_occupancy']:.0f}%"
                     f" (last sample)")
    if "serving_queue_depth" in gauges:
        lines.append("queue depth".ljust(width)
                     + f"{gauges['serving_queue_depth']:.0f} waiting "
                     f"(last sample)")
    return lines or None


#: expert-plane series (nn/moe.py): per-expert load balance, the
#: capacity-overflow drop rate, aux-loss drift, and the ep all_to_all
#: byte accounting — the direct evidence expert parallelism is (or is
#: not) balanced and its exchanges overlapped (docs/PERFORMANCE.md
#: "Expert plane").
_EXPERT_PLANE_SERIES = (
    "moe_expert_tokens", "moe_dropped_tokens_total",
    "moe_overflow_fraction", "moe_aux_loss",
)


def expert_plane_summary(records: list[dict]) -> Optional[list[str]]:
    """Lines for the MoE expert-plane section, or None when no snapshot
    carries ``moe_*`` series. Reads the LAST snapshot; the ep_a2a byte
    split comes from the data-plane counters in the same snapshot."""
    snap: Optional[dict] = None
    for rec in records:
        cand = rec.get("metrics") if rec.get("kind") == "metrics_snapshot" \
            else rec.get("telemetry")
        if isinstance(cand, dict) and any(
                k.split("{")[0] in _EXPERT_PLANE_SERIES for k in cand):
            snap = cand
    if snap is None:
        return None
    loads: dict[int, float] = {}
    dropped = 0.0
    hists: dict[str, dict] = {}
    a2a_bytes = a2a_overlapped = 0.0
    for series, v in snap.items():
        base = series.split("{")[0]
        if base == "moe_expert_tokens" and isinstance(v, (int, float)):
            try:
                e = int(series.split('expert="', 1)[1].split('"', 1)[0])
            except (IndexError, ValueError):
                continue
            loads[e] = float(v)
        elif base == "moe_dropped_tokens_total" \
                and isinstance(v, (int, float)):
            dropped += v
        elif base in ("moe_overflow_fraction", "moe_aux_loss") \
                and isinstance(v, dict):
            hists[base] = v
        elif base == "comm_bytes_total" and 'kind="ep_a2a"' in series \
                and isinstance(v, (int, float)):
            a2a_bytes += v
        elif base == "comm_overlapped_bytes_total" \
                and 'kind="ep_a2a"' in series and isinstance(v, (int, float)):
            a2a_overlapped += v
    lines = []
    width = 18
    if loads:
        vals = [loads[e] for e in sorted(loads)]
        mean = sum(vals) / len(vals)
        imbalance = max(vals) / mean if mean else 0.0
        lines.append("expert load".ljust(width)
                     + " ".join(f"{int(v)}" for v in vals)
                     + f"  (max/mean {imbalance:.2f})")
    lines.append("dropped tokens".ljust(width)
                 + (f"{int(dropped)} (token, choice) slots past capacity"
                    if dropped else "0"))
    h = hists.get("moe_overflow_fraction")
    if h and h.get("count"):
        lines.append("overflow frac".ljust(width)
                     + f"p50 {h['p50']:.4f}  p99 {h['p99']:.4f}  "
                     f"(n={int(h['count'])})")
    h = hists.get("moe_aux_loss")
    if h and h.get("count"):
        lines.append("aux loss".ljust(width)
                     + f"p50 {h['p50']:.4f}  p99 {h['p99']:.4f}")
    if a2a_bytes:
        lines.append("ep a2a".ljust(width)
                     + f"{_fmt_bytes(a2a_bytes)} cumulative "
                     f"({100.0 * a2a_overlapped / a2a_bytes:.0f}% on the "
                     f"chunked-overlap path)")
    return lines


#: health series (telemetry/flight.py watchdog, telemetry/slo.py): the
#: run's production-health verdict — did anything hang, which SLO rules
#: fired, and is anything still breached (docs/OBSERVABILITY.md).
_HEALTH_SERIES = (
    "watchdog_trips_total", "slo_alerts_total", "slo_alerting",
)


#: fleet-plane series (serving/router.py + serving/fleet.py): dispatch
#: spread, requeues (and their remote/multi-process slice), P/D
#: handoffs with the KV blocks they streamed, weight pushes by
#: transport, and remote-replica heartbeat ages — the direct evidence
#: a disaggregated fleet is balanced, resuming instead of re-prefilling
#: and detecting dead processes (docs/SERVING.md "Disaggregated fleet").
_FLEET_PLANE_SERIES = (
    "router_requests_total", "router_requeues_total",
    "router_resumed_requeues_total", "fleet_remote_requeues_total",
    "fleet_pd_handoffs_total", "fleet_kv_stream_blocks_total",
    "weight_pushes_total", "weight_push_bytes_total",
    "router_replicas_live", "fleet_replica_beat_age_seconds",
    "serving_idem_dedup_total",
    # fleet-global KV plane: directory hit ratio, pull
    # volume, buddy replication and recoveries, spill-tier occupancy
    "fleet_prefix_hit_tokens_total", "fleet_prefix_miss_tokens_total",
    "fleet_kv_pull_blocks_total", "fleet_kv_pull_bytes_total",
    "fleet_kv_replicated_blocks_total", "fleet_kv_recoveries_total",
    "spill_tier_blocks",
)


def fleet_plane_summary(records: list[dict]) -> Optional[list[str]]:
    """Lines for the fleet-plane section, or None when no snapshot
    carries router/fleet series. Reads the LAST snapshot (counters are
    cumulative, gauges last-write-wins)."""
    snap: Optional[dict] = None
    for rec in records:
        cand = rec.get("metrics") if rec.get("kind") == "metrics_snapshot" \
            else rec.get("telemetry")
        if isinstance(cand, dict) and any(
                k.split("{")[0] in _FLEET_PLANE_SERIES for k in cand):
            snap = cand
    if snap is None:
        return None
    by_label: dict[str, dict[str, float]] = {}
    for series, v in snap.items():
        base = series.split("{")[0]
        if base not in _FLEET_PLANE_SERIES \
                or not isinstance(v, (int, float)):
            continue
        label = series.split('="', 1)[1].split('"', 1)[0] \
            if "{" in series else ""
        by_label.setdefault(base, {})[label] = float(v)
    lines = []
    width = 18
    disp = by_label.get("router_requests_total", {})
    if disp:
        total = sum(disp.values())
        parts = " / ".join(f"{r or '?'}:{int(v)}"
                           for r, v in sorted(disp.items()))
        lines.append("dispatch".ljust(width)
                     + f"{int(total)} ({parts})")
    rq = sum(by_label.get("router_requeues_total", {}).values())
    if rq:
        remote = sum(by_label.get(
            "fleet_remote_requeues_total", {}).values())
        resumed = sum(by_label.get(
            "router_resumed_requeues_total", {}).values())
        lines.append("requeues".ljust(width)
                     + f"{int(rq)} ({int(remote)} remote, "
                     f"{int(resumed)} KV-resumed)")
    pd = sum(by_label.get("fleet_pd_handoffs_total", {}).values())
    if pd:
        blocks = sum(by_label.get(
            "fleet_kv_stream_blocks_total", {}).values())
        lines.append("P/D handoffs".ljust(width)
                     + f"{int(pd)} requests, {int(blocks)} KV blocks "
                     f"streamed")
    pushes = sum(by_label.get("weight_pushes_total", {}).values())
    if pushes:
        bt = by_label.get("weight_push_bytes_total", {})
        parts = " / ".join(f"{t}:{v / 1e6:.1f}MB"
                           for t, v in sorted(bt.items()))
        lines.append("weight pushes".ljust(width)
                     + f"{int(pushes)}" + (f"  ({parts})" if bt else ""))
    dedup = sum(by_label.get("serving_idem_dedup_total", {}).values())
    if dedup:
        lines.append("idem dedups".ljust(width)
                     + f"{int(dedup)} duplicate deliveries suppressed")
    live = by_label.get("router_replicas_live", {})
    if live:
        line = f"{int(sum(live.values()))} live"
        beats = by_label.get("fleet_replica_beat_age_seconds", {})
        if beats:
            worst = max(beats.items(), key=lambda kv: kv[1])
            line += (f"  (stalest remote beat: {worst[0]} "
                     f"{worst[1] * 1e3:.0f}ms)")
        lines.append("replicas".ljust(width) + line)
    # fleet KV: directory effectiveness + buddy replication
    hit = sum(by_label.get("fleet_prefix_hit_tokens_total",
                           {}).values())
    miss = sum(by_label.get("fleet_prefix_miss_tokens_total",
                            {}).values())
    if hit or miss:
        pulls = sum(by_label.get("fleet_kv_pull_blocks_total",
                                 {}).values())
        pull_mb = sum(by_label.get("fleet_kv_pull_bytes_total",
                                   {}).values()) / 1e6
        lines.append(
            "fleet KV prefix".ljust(width)
            + f"{int(hit)}/{int(hit + miss)} prompt tokens warm "
            f"({hit / max(1.0, hit + miss):.0%}), "
            f"{int(pulls)} blocks pulled ({pull_mb:.1f}MB)")
    repl = sum(by_label.get("fleet_kv_replicated_blocks_total",
                            {}).values())
    if repl:
        rec = sum(by_label.get("fleet_kv_recoveries_total",
                               {}).values())
        lines.append("fleet KV buddies".ljust(width)
                     + f"{int(repl)} blocks replicated, "
                     f"{int(rec)} mid-decode recoveries")
    tiers = by_label.get("spill_tier_blocks", {})
    if any(tiers.values()):
        parts = " / ".join(f"{t}:{int(v)}"
                           for t, v in sorted(tiers.items()))
        lines.append("spill tiers".ljust(width) + parts)
    return lines or None


#: tenant-plane series (serving/tenancy.py + the engine's adapter
#: arena): per-tenant request/throttle flow, adapter page pressure and
#: load/evict churn — the direct evidence the multi-tenant QoS gate and
#: the LRU arena are (or are not) isolating tenants (docs/SERVING.md
#: "Multi-tenant adapters").
_TENANT_PLANE_SERIES = (
    "tenant_requests_total", "tenant_throttled_total",
    "adapter_loads_total", "adapter_evictions_total",
    "adapter_pages_in_use", "adapter_pushes_total",
)


def tenant_plane_summary(records: list[dict]) -> Optional[list[str]]:
    """Lines for the multi-tenant adapter section, or None when no
    snapshot carries tenant/adapter series. Reads the LAST snapshot
    (counters are cumulative, gauges last-write-wins)."""
    snap: Optional[dict] = None
    for rec in records:
        cand = rec.get("metrics") if rec.get("kind") == "metrics_snapshot" \
            else rec.get("telemetry")
        if isinstance(cand, dict) and any(
                k.split("{")[0] in _TENANT_PLANE_SERIES for k in cand):
            snap = cand
    if snap is None:
        return None
    reqs: dict[str, float] = {}
    throttled: dict[str, float] = {}
    vals: dict[str, float] = {}
    for series, v in snap.items():
        base = series.split("{")[0]
        if base not in _TENANT_PLANE_SERIES \
                or not isinstance(v, (int, float)):
            continue
        if base == "tenant_requests_total":
            m = re.search(r'tenant="([^"]*)"', series)
            t = m.group(1) if m else "?"
            reqs[t] = reqs.get(t, 0.0) + v
        elif base == "tenant_throttled_total":
            m = re.search(r'tenant="([^"]*)"', series)
            t = m.group(1) if m else "?"
            throttled[t] = throttled.get(t, 0.0) + v
        else:
            vals[base] = vals.get(base, 0.0) + v
    lines = []
    width = 18
    if reqs:
        total = sum(reqs.values())
        parts = " / ".join(f"{t}:{int(v)}"
                           for t, v in sorted(reqs.items()))
        lines.append("tenant requests".ljust(width)
                     + f"{int(total)} ({parts})")
    if throttled:
        parts = " / ".join(f"{t}:{int(v)}"
                           for t, v in sorted(throttled.items()))
        lines.append("throttled".ljust(width)
                     + f"{int(sum(throttled.values()))} ({parts})")
    loads = vals.get("adapter_loads_total", 0.0)
    evs = vals.get("adapter_evictions_total", 0.0)
    if loads or evs:
        lines.append("adapter churn".ljust(width)
                     + f"{int(loads)} page loads / {int(evs)} "
                     f"evictions")
    if "adapter_pages_in_use" in vals:
        lines.append("arena pages".ljust(width)
                     + f"{int(vals['adapter_pages_in_use'])} in use "
                     f"(last sample)")
    if vals.get("adapter_pushes_total"):
        lines.append("adapter pushes".ljust(width)
                     + f"{int(vals['adapter_pushes_total'])} fleet-wide"
                     f" (no drain)")
    return lines or None


#: recovery-plane series (chaos harness + elastic supervisor +
#: incremental checkpointing): the direct evidence the preemption plane
#: detects kills, recovers fast, and that checkpoint cadence is no
#: longer priced into step time (docs/ELASTICITY.md).
_RECOVERY_SERIES = (
    "chaos_kills_total", "elastic_recoveries_total",
    "elastic_recovery_seconds", "elastic_detect_seconds",
    "heartbeat_send_failures_total", "checkpoint_snapshot_seconds",
    "checkpoint_write_seconds", "checkpoint_delta_bytes_total",
)


def recovery_plane_summary(records: list[dict]) -> Optional[list[str]]:
    """Lines for the recovery-plane section (kills, detection latency,
    recovery seconds by mode, checkpoint cadence vs step-time overhead),
    or None when no snapshot carries recovery series."""
    snap: Optional[dict] = None
    goodput_rec: Optional[dict] = None
    for rec in records:
        if rec.get("kind") == "goodput":
            goodput_rec = rec
        cand = rec.get("metrics") if rec.get("kind") == "metrics_snapshot" \
            else rec.get("telemetry")
        if isinstance(cand, dict) and any(
                k.split("{")[0] in _RECOVERY_SERIES for k in cand):
            snap = cand
    if snap is None:
        return None

    def by_label(base: str) -> dict[str, object]:
        out = {}
        for series, v in snap.items():
            if series.split("{")[0] != base:
                continue
            label = series[len(base):].strip("{}")
            out[label or "*"] = v
        return out

    width = 18
    lines: list[str] = []
    kills = by_label("chaos_kills_total")
    if kills:
        total = int(sum(kills.values()))
        detail = ", ".join(
            f"{k.split('=')[-1].strip(chr(34))}: {int(v)}"
            for k, v in sorted(kills.items()))
        lines.append("kills".ljust(width) + f"{total} injected ({detail})")
    recs = by_label("elastic_recoveries_total")
    if recs:
        total = int(sum(recs.values()))
        detail = ", ".join(
            f"{k.split('=')[-1].strip(chr(34))}: {int(v)}"
            for k, v in sorted(recs.items()))
        lines.append("recoveries".ljust(width) + f"{total} ({detail})")
    det = by_label("elastic_detect_seconds").get("*")
    if isinstance(det, dict) and det.get("count"):
        lines.append("detection".ljust(width)
                     + f"p50 {det['p50']:.2f}s  max {det['max']:.2f}s "
                     f"(kill → membership)")
    rsec = by_label("elastic_recovery_seconds")
    for label, h in sorted(rsec.items()):
        if isinstance(h, dict) and h.get("count"):
            mode = label.split("=")[-1].strip('"')
            lines.append(f"recovery ({mode})".ljust(width)
                         + f"p50 {h['p50']:.2f}s  max {h['max']:.2f}s "
                         f"({h['count']}x)")
    hb = by_label("heartbeat_send_failures_total")
    if hb:
        lines.append("heartbeat".ljust(width)
                     + f"{int(sum(hb.values()))} sends failed "
                     f"(retried with backoff)")
    snaps = by_label("checkpoint_snapshot_seconds").get("*")
    if isinstance(snaps, dict) and snaps.get("count"):
        line = ("ckpt snapshot".ljust(width)
                + f"p50 {1e3 * snaps['p50']:.0f}ms step-blocking")
        wr = by_label("checkpoint_write_seconds")
        wasync = next((h for k, h in wr.items() if "async" in k), None)
        if isinstance(wasync, dict) and wasync.get("count"):
            line += f" / write p50 {1e3 * wasync['p50']:.0f}ms async"
        lines.append(line)
    delta = by_label("checkpoint_delta_bytes_total")
    written = sum(v for k, v in delta.items() if "written" in k)
    reused = sum(v for k, v in delta.items() if "reused" in k)
    if written or reused:
        saved = 100.0 * reused / (written + reused) \
            if (written + reused) else 0.0
        lines.append("ckpt delta".ljust(width)
                     + f"{_fmt_bytes(written)} written / "
                     f"{_fmt_bytes(reused)} reused ({saved:.0f}% saved)")
    if goodput_rec:
        comps = goodput_rec.get("components", {})
        wall = goodput_rec.get("wall_s", 0.0)
        ck = comps.get("checkpoint", 0.0)
        rc = comps.get("recovery", 0.0)
        if wall and (ck or rc):
            lines.append("cadence cost".ljust(width)
                         + f"checkpoint {ck:.2f}s + recovery {rc:.2f}s "
                         f"of {wall:.2f}s wall "
                         f"({100.0 * (ck + rc) / wall:.1f}%)")
    return lines or None


def health_summary(records: list[dict]) -> Optional[list[str]]:
    """Lines for the watchdog/SLO health section, or None when neither
    a health series nor an ``slo_alert`` record is present. Counters
    from the LAST snapshot; alert records counted over the stream."""
    snap: Optional[dict] = None
    for rec in records:
        cand = rec.get("metrics") if rec.get("kind") == "metrics_snapshot" \
            else rec.get("telemetry")
        if isinstance(cand, dict) and any(
                k.split("{")[0] in _HEALTH_SERIES for k in cand):
            snap = cand
    alerts = [r for r in records if r.get("kind") == "slo_alert"]
    if snap is None and not alerts:
        return None
    from hetu_tpu_torch.telemetry.slo import health_from_snapshot
    hs = health_from_snapshot(snap or {})
    trips = hs["watchdog_trips"]
    fired = sum(hs["alerts_by_rule"].values())
    alerting = hs["alerting_rules"]
    lines = []
    width = 18
    lines.append("watchdog trips".ljust(width)
                 + (f"{int(trips)} — the run HUNG; see the "
                    f"flight_<rank>.jsonl dump (obs_report)"
                    if trips else "0"))
    if fired or alerts:
        lines.append("slo alerts".ljust(width)
                     + f"{int(max(fired, len(alerts)))} fired")
    for a in alerts[-5:]:
        lines.append(f"  [{a.get('rule', '?')}]".ljust(width)
                     + a.get("message", "")[:100])
    if alerting:
        lines.append("still breached".ljust(width)
                     + ", ".join(sorted(alerting)))
    return lines


def summarize(path: str, *, wall_s: Optional[float] = None,
              top: int = 10) -> str:
    records = load_records(path)
    report = report_from_records(records, wall_s=wall_s)
    parts = [f"== goodput breakdown ({path}) ==",
             format_goodput_table(report)]

    cp = control_plane_summary(records)
    if cp:
        parts.append("")
        parts.append("== control plane ==")
        parts.extend(cp)

    dp = data_plane_summary(records)
    if dp:
        parts.append("")
        parts.append("== data plane ==")
        parts.extend(dp)

    shp = shape_plane_summary(records)
    if shp:
        parts.append("")
        parts.append("== shape plane ==")
        parts.extend(shp)

    mp = memory_plane_summary(records)
    if mp:
        parts.append("")
        parts.append("== memory plane ==")
        parts.extend(mp)

    sv = serving_plane_summary(records)
    if sv:
        parts.append("")
        parts.append("== serving plane ==")
        parts.extend(sv)

    xp = expert_plane_summary(records)
    if xp:
        parts.append("")
        parts.append("== expert plane ==")
        parts.extend(xp)

    fl = fleet_plane_summary(records)
    if fl:
        parts.append("")
        parts.append("== fleet plane ==")
        parts.extend(fl)

    tn = tenant_plane_summary(records)
    if tn:
        parts.append("")
        parts.append("== tenant plane ==")
        parts.extend(tn)

    rp = recovery_plane_summary(records)
    if rp:
        parts.append("")
        parts.append("== recovery plane ==")
        parts.extend(rp)

    hl = health_summary(records)
    if hl:
        parts.append("")
        parts.append("== health ==")
        parts.extend(hl)

    rows = span_rollup(records, top=top)
    if rows:
        parts.append("")
        parts.append(f"== heaviest spans ==")
        parts.append(f"{'span':<24} {'n':>6} {'total s':>10} {'max s':>9}")
        for name, n, total, mx in rows:
            parts.append(f"{name:<24} {n:>6} {total:>10.3f} {mx:>9.3f}")

    m = last_metrics(records)
    if m is not None:
        parts.append("")
        keep = {k: v for k, v in m.items()
                if k not in ("kind", "telemetry") and not isinstance(
                    v, (dict, list))}
        parts.append(f"== last metrics record ==")
        parts.append(json.dumps(keep))
    return "\n".join(parts)


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="trace_summary",
        description="Goodput breakdown from hetu_tpu_torch telemetry artifacts")
    ap.add_argument("path", help="telemetry.jsonl or trace.json")
    ap.add_argument("--wall", type=float, default=None,
                    help="override wall-clock seconds (else taken from "
                         "the goodput record / latest span end)")
    ap.add_argument("--top", type=int, default=10,
                    help="how many span names to roll up")
    args = ap.parse_args(argv)
    try:
        print(summarize(args.path, wall_s=args.wall, top=args.top))
    except FileNotFoundError:
        print(f"trace_summary: no such file: {args.path}",
              file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
