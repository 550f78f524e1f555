"""Goodput / MFU accounting: where did the wall-clock go? (a copy of
``hetu_tpu/telemetry/goodput.py``).

Every large-run report leads with two numbers the raw step log cannot
produce: **goodput** (fraction of wall time spent on productive training
compute — the complement of compile, hot-switch, checkpoint and data-stall
overheads; HotSPa's switch-cost accounting is a special case) and **MFU**
(model FLOPs utilization, Megatron/PaLM appendix-B accounting — the same
formula ``bench.py`` uses for its headline).

The accountant is a category → seconds ledger the Trainer feeds from its
loop, plus a token counter; ``report()`` folds in model FLOPs (derived
from the Galvatron cost model's :class:`ModelDims` shapes) and the chip's
peak to emit the per-run breakdown table.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

#: canonical categories, in table order; "compute" is productive time,
#: everything after it is overhead, "other" is the unaccounted remainder.
CATEGORIES = ("compute", "compile", "switch", "checkpoint", "stall",
              "eval", "recovery")

#: span-name → category mapping used when a report is rebuilt from trace
#: records (``report_from_records`` / tools/trace_summary.py).
SPAN_CATEGORIES = {
    "compute": "compute", "step": "compute", "hetero_step": "compute",
    "compile": "compile", "make_plan": None, "build_step": None,
    "build_plan_and_step": None,
    # background AOT compilation (engine/precompile.py) runs OFF the
    # training thread — it is not foreground overhead and must not be
    # summed into the wall breakdown (it still shows in the span rollup)
    "precompile": None,
    "switch": "switch", "cross_topology_switch": None,
    "checkpoint": "checkpoint", "checkpoint_write": None,
    "checkpoint_gather": None, "checkpoint_snapshot": None,
    "stall": "stall", "eval": "eval",
}


def model_flops_per_token(dims) -> float:
    """Matmul-FLOPs per trained token for a transformer LM described by a
    :class:`~hetu_tpu.tools.galvatron.cost_model.ModelDims` (PaLM
    appendix-B accounting, identical to ``bench.py``): ``6·N`` for the
    parameter matmuls plus the causal-attention ``6·L·H·s/2·2`` term."""
    return (6.0 * dims.total_params()
            + 6.0 * dims.num_layers * dims.hidden * dims.seq_len)


@dataclasses.dataclass
class GoodputReport:
    """One run's time breakdown + derived goodput/MFU."""

    wall_s: float
    components: dict            # category -> seconds
    tokens: int = 0
    flops_per_token: Optional[float] = None
    peak_flops: Optional[float] = None
    steps: int = 0

    @property
    def accounted_s(self) -> float:
        return sum(self.components.values())

    @property
    def other_s(self) -> float:
        return max(0.0, self.wall_s - self.accounted_s)

    @property
    def compute_s(self) -> float:
        return self.components.get("compute", 0.0)

    @property
    def goodput(self) -> float:
        """Fraction of wall time spent on productive training compute."""
        return self.compute_s / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def tokens_per_sec(self) -> float:
        return self.tokens / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def mfu(self) -> Optional[float]:
        """Model FLOPs utilization over the WHOLE wall clock (overheads
        included — that is the point of goodput accounting)."""
        if not self.flops_per_token or not self.peak_flops \
                or self.wall_s <= 0:
            return None
        return (self.tokens * self.flops_per_token
                / self.wall_s / self.peak_flops)

    def to_record(self) -> dict:
        rec = {"kind": "goodput", "wall_s": round(self.wall_s, 6),
               "components": {k: round(v, 6)
                              for k, v in self.components.items()},
               "tokens": int(self.tokens), "steps": int(self.steps),
               "goodput": round(self.goodput, 6),
               "tokens_per_sec": round(self.tokens_per_sec, 3)}
        if self.flops_per_token:
            rec["flops_per_token"] = self.flops_per_token
        mfu = self.mfu
        if mfu is not None:
            rec["mfu"] = round(mfu, 6)
        return rec

    @classmethod
    def from_record(cls, rec: dict) -> "GoodputReport":
        flops = rec.get("flops_per_token")
        peak = None
        if rec.get("mfu") and flops and rec.get("tokens") \
                and rec.get("wall_s"):
            peak = (rec["tokens"] * flops / rec["wall_s"] / rec["mfu"])
        return cls(wall_s=rec["wall_s"],
                   components=dict(rec.get("components", {})),
                   tokens=rec.get("tokens", 0),
                   flops_per_token=flops, peak_flops=peak,
                   steps=rec.get("steps", 0))


class GoodputAccountant:
    """Category → seconds ledger for one training run.

    Feed with ``record(category, seconds)`` and ``add_tokens(n)``;
    ``report()`` closes the wall clock (or takes an explicit one).
    ``clock`` is injectable so goodput math is testable on a synthetic
    timeline."""

    def __init__(self, *, flops_per_token: Optional[float] = None,
                 peak_flops: Optional[float] = None,
                 clock: Callable[[], float] = time.perf_counter):
        self._clock = clock
        self._t0 = clock()
        self._frozen_wall: Optional[float] = None
        self.flops_per_token = flops_per_token
        self.peak_flops = peak_flops
        self.tokens = 0
        self.steps = 0
        self._seconds: dict[str, float] = {}

    def record(self, category: str, seconds: float) -> None:
        if seconds > 0:
            self._seconds[category] = \
                self._seconds.get(category, 0.0) + seconds

    def add_tokens(self, n: int) -> None:
        self.tokens += int(n)

    def add_step(self, n: int = 1) -> None:
        self.steps += n

    def seconds(self, category: str) -> float:
        return self._seconds.get(category, 0.0)

    def wall(self) -> float:
        if self._frozen_wall is not None:
            return self._frozen_wall
        return self._clock() - self._t0

    def freeze(self) -> None:
        """Pin the wall clock at 'now': the run is over. Later reports
        (e.g. a manual ``export_telemetry()`` minutes after ``train()``
        returned) must not dilute goodput with idle time."""
        if self._frozen_wall is None:
            self._frozen_wall = self._clock() - self._t0

    def report(self, wall_s: Optional[float] = None) -> GoodputReport:
        return GoodputReport(
            wall_s=self.wall() if wall_s is None else wall_s,
            components=dict(self._seconds), tokens=self.tokens,
            flops_per_token=self.flops_per_token,
            peak_flops=self.peak_flops, steps=self.steps)


def report_from_records(records, *, wall_s: Optional[float] = None
                        ) -> GoodputReport:
    """Rebuild a report from unified-JSONL records (``trace_summary``).

    Prefers a ``kind: goodput`` record (the Trainer's own ledger — exact);
    otherwise sums span durations by :data:`SPAN_CATEGORIES` (names
    mapped to ``None`` are nested detail under an already-counted parent
    and are skipped to avoid double counting)."""
    goodput_rec = None
    components: dict[str, float] = {}
    max_end = 0.0
    tokens = 0
    for rec in records:
        kind = rec.get("kind")
        if kind == "goodput":
            goodput_rec = rec              # last one wins (latest run)
        elif kind == "span":
            name = rec.get("name", "")
            cat = SPAN_CATEGORIES.get(name, "other" if name else None)
            end = rec.get("ts_s", 0.0) + rec.get("dur_s", 0.0)
            max_end = max(max_end, end)
            if cat is not None:
                components[cat] = components.get(cat, 0.0) \
                    + rec.get("dur_s", 0.0)
        elif kind == "metrics":
            tokens = rec.get("tokens_total", tokens)
    if goodput_rec is not None:
        rep = GoodputReport.from_record(goodput_rec)
        if wall_s is not None:
            rep.wall_s = wall_s
        return rep
    return GoodputReport(wall_s=wall_s if wall_s is not None else max_end,
                         components=components, tokens=tokens)


def format_goodput_table(report: GoodputReport) -> str:
    """The operator-facing breakdown table (``tools/trace_summary.py``)."""
    lines = [f"{'category':<12} {'seconds':>10} {'% wall':>8}"]

    def row(name, secs):
        pct = 100.0 * secs / report.wall_s if report.wall_s > 0 else 0.0
        lines.append(f"{name:<12} {secs:>10.3f} {pct:>7.1f}%")

    ordered = [c for c in CATEGORIES if c in report.components]
    ordered += [c for c in sorted(report.components) if c not in CATEGORIES]
    for cat in ordered:
        row(cat, report.components[cat])
    row("(unaccounted)", report.other_s)
    lines.append(f"{'WALL':<12} {report.wall_s:>10.3f} {100.0:>7.1f}%")
    lines.append("")
    lines.append(f"goodput          {100.0 * report.goodput:.1f}%  "
                 f"(compute / wall)")
    if report.tokens:
        lines.append(f"tokens           {report.tokens} "
                     f"({report.tokens_per_sec:.1f} tok/s)")
    mfu = report.mfu
    if mfu is not None:
        lines.append(f"MFU              {100.0 * mfu:.2f}%")
    return "\n".join(lines)
