"""Cross-rank metric aggregation over the coordinator KV store (a copy
of ``hetu_tpu/telemetry/aggregate.py``).

Per-host registries are local; the operator wants ONE cluster view.
Rather than invent a side channel, snapshots fan through the rendezvous
fabric that already exists — the coordinator KV (``csrc/coordinator.cpp``
native server / ``rpc/py_server.py`` fallback, spoken by
``rpc/client.py``): every rank publishes its snapshot under a run-scoped
key, a barrier aligns the round, and rank 0 reduces to per-metric
min/max/mean/sum and republishes the cluster aggregate for everyone.

This mirrors the reference's use of its KV store for cross-worker
coordination (``rpc/kv_store/client.py``; straggler ratios travel the
same way in ``python/hetu/engine/straggler.py``).
"""

from __future__ import annotations

import time
from typing import Optional

_PREFIX = "telemetry"


def _rank_key(run: str, rank: int) -> str:
    return f"{_PREFIX}/{run}/rank{rank}"


def _agg_key(run: str) -> str:
    return f"{_PREFIX}/{run}/aggregate"


def publish_snapshot(client, rank: int, snapshot: dict, *,
                     run: str = "run0") -> None:
    """Publish one rank's ``MetricRegistry.snapshot()`` to the KV."""
    client.put(_rank_key(run, rank), snapshot)


def collect_snapshots(client, num_ranks: int, *, run: str = "run0",
                      timeout_s: float = 30.0,
                      poll_s: float = 0.05) -> list[dict]:
    """Poll until every rank's snapshot is present; returns them by rank."""
    deadline = time.monotonic() + timeout_s
    out: list[Optional[dict]] = [None] * num_ranks
    while True:
        missing = [r for r in range(num_ranks) if out[r] is None]
        for r in missing:
            out[r] = client.get(_rank_key(run, r))
        if all(s is not None for s in out):
            return out  # type: ignore[return-value]
        if time.monotonic() > deadline:
            still = [r for r in range(num_ranks) if out[r] is None]
            raise TimeoutError(
                f"telemetry aggregation: ranks {still} never published "
                f"for run {run!r} within {timeout_s}s")
        time.sleep(poll_s)


def aggregate_snapshots(snapshots: list[dict]) -> dict:
    """Reduce per-rank snapshots to ``{series: {min,max,mean,sum,ranks}}``.

    Scalar series (counters/gauges) reduce directly. Histogram summaries
    reduce exactly on count/sum/min/max; per-rank percentiles cannot be
    combined exactly, so the aggregate reports their min/max spread
    (``p50_min``/``p50_max`` etc.) — honest bounds, not a fake quantile.
    """
    names: dict[str, list] = {}
    for snap in snapshots:
        for name, val in (snap or {}).items():
            names.setdefault(name, []).append(val)

    out: dict = {}
    for name, vals in names.items():
        if all(isinstance(v, dict) for v in vals):
            agg = {
                "count": sum(v.get("count", 0) for v in vals),
                "sum": sum(v.get("sum", 0.0) for v in vals),
                "min": min(v.get("min", 0.0) for v in vals),
                "max": max(v.get("max", 0.0) for v in vals),
                "ranks": len(vals),
            }
            for p in ("p50", "p90", "p99"):
                ps = [v.get(p, 0.0) for v in vals]
                agg[f"{p}_min"] = min(ps)
                agg[f"{p}_max"] = max(ps)
            if agg["count"]:
                agg["mean"] = agg["sum"] / agg["count"]
            out[name] = agg
        else:
            nums = [float(v) for v in vals
                    if isinstance(v, (int, float))]
            if not nums:
                continue
            out[name] = {"min": min(nums), "max": max(nums),
                         "mean": sum(nums) / len(nums),
                         "sum": sum(nums), "ranks": len(nums)}
    return out


def cluster_aggregate(client, rank: int, num_ranks: int, snapshot: dict, *,
                      run: str = "run0", timeout_s: float = 30.0) -> dict:
    """Full round: publish, barrier, rank 0 reduces + republishes, a
    second barrier, every rank returns the same cluster aggregate.

    The second barrier makes the round REUSABLE with the same ``run``
    id (e.g. a periodic cadence): non-zero ranks only read the aggregate
    key after rank 0 has overwritten it for THIS round, so a previous
    round's value can never be returned stale.

    ``client``: a connected
    :class:`~hetu_tpu_torch.rpc.client.CoordinatorClient`.
    """
    publish_snapshot(client, rank, snapshot, run=run)
    client.barrier(f"{_PREFIX}-{run}", num_ranks, f"rank{rank}")
    if rank == 0:
        agg = aggregate_snapshots(
            collect_snapshots(client, num_ranks, run=run,
                              timeout_s=timeout_s))
        client.put(_agg_key(run), agg)
        client.barrier(f"{_PREFIX}-{run}-agg", num_ranks, f"rank{rank}")
        return agg
    client.barrier(f"{_PREFIX}-{run}-agg", num_ranks, f"rank{rank}")
    agg = client.get(_agg_key(run))
    if agg is None:           # unreachable under the barrier protocol
        raise RuntimeError(
            f"rank {rank}: aggregate missing for run {run!r} after "
            f"the publish barrier")
    return agg
