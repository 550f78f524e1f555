"""SLO & anomaly engine: rolling-window baselines over the registry (a
copy of ``hetu_tpu/telemetry/slo.py``).

The metric registry records what happened; nothing watches it. This
module is the watcher: rules bind to a metric series (step_time,
serving_ttft/tpot, goodput, loss/grad-norm), keep bounded rolling
windows of observations, and evaluate two families of detectors on the
Trainer's log cadence / the serving background loop:

- **multi-window burn-rate SLOs** (the Google-SRE alerting shape): each
  observation is classified good/bad against an objective; the alert
  fires only when the error-budget burn rate exceeds its threshold in
  EVERY configured window — the short window gives fast detection, the
  long window suppresses blips;
- **regression / spike detectors**: the recent window's median against
  the trailing baseline window's median — a ratio breach is a loss
  spike, a step-time regression, or a TTFT/TPOT degradation, with no
  absolute threshold to mis-set.

Alerts increment ``slo_alerts_total{rule=...}``, pin the per-rule
``slo_alerting{rule=...}`` gauge (1 while breached — what ``HEALTHZ``
reads), land in the flight recorder, and are returned to the caller for
logging. Everything takes an injectable ``clock`` so tests drive
synthetic timelines.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Optional, Sequence

from hetu_tpu_torch.telemetry.flight import get_flight_recorder
from hetu_tpu_torch.telemetry.metrics import MetricRegistry, percentile


@dataclasses.dataclass
class Alert:
    """One fired detector: ``to_record()`` is the JSONL form."""

    rule: str
    kind: str                    # "burn_rate" | "regression"
    series: str
    value: float                 # the offending observation/statistic
    threshold: float
    message: str
    ts_unix: float
    windows: dict = dataclasses.field(default_factory=dict)

    def to_record(self) -> dict:
        return {"kind": "slo_alert", "rule": self.rule,
                "alert_kind": self.kind, "series": self.series,
                "value": round(self.value, 6),
                "threshold": round(self.threshold, 6),
                "message": self.message,
                "ts_unix": round(self.ts_unix, 3),
                "windows": self.windows}


class _Window:
    """(t, value) points trimmed by age — median / bad-fraction views."""

    __slots__ = ("_pts",)

    def __init__(self):
        self._pts: collections.deque = collections.deque()

    def add(self, t: float, v: float) -> None:
        self._pts.append((t, float(v)))

    def trim(self, now: float, max_age_s: float) -> None:
        while self._pts and now - self._pts[0][0] > max_age_s:
            self._pts.popleft()

    def values(self, now: float, age_s: float) -> list[float]:
        return [v for t, v in self._pts if now - t <= age_s]

    def __len__(self) -> int:
        return len(self._pts)


@dataclasses.dataclass
class _BurnRateRule:
    name: str
    series: str
    field: str
    objective: float
    budget: float                      # allowed bad fraction (1 - target)
    windows: tuple                     # ((age_s, burn_threshold), ...)
    direction: str                     # "above": value > objective is bad
    min_samples: int
    window: _Window = dataclasses.field(default_factory=_Window)
    alerting: bool = False

    def is_bad(self, v: float) -> bool:
        return v > self.objective if self.direction == "above" \
            else v < self.objective

    def evaluate(self, now: float) -> Optional[Alert]:
        self.window.trim(now, max(a for a, _ in self.windows))
        burns = {}
        for age_s, threshold in self.windows:
            vals = self.window.values(now, age_s)
            if len(vals) < self.min_samples:
                self.alerting = False
                return None
            bad = sum(1 for v in vals if self.is_bad(v))
            burn = (bad / len(vals)) / self.budget
            burns[f"{age_s:g}s"] = round(burn, 3)
            if burn < threshold:
                self.alerting = False
                return None
        if self.alerting:        # edge-triggered: one alert per breach;
            return None          # the slo_alerting gauge carries state
        self.alerting = True
        last = self.window.values(now, self.windows[0][0])[-1]
        return Alert(
            rule=self.name, kind="burn_rate", series=self.series,
            value=last, threshold=self.objective,
            message=(f"{self.series}[{self.field}] burning error budget "
                     f"in every window (objective "
                     f"{'<' if self.direction == 'above' else '>'} "
                     f"{self.objective:g}): burn rates {burns}"),
            ts_unix=time.time(), windows=burns)


@dataclasses.dataclass
class _RegressionRule:
    name: str
    series: str
    field: str
    factor: float                      # recent median > factor * baseline
    baseline_s: float
    recent_s: float
    min_baseline: int
    min_recent: int
    window: _Window = dataclasses.field(default_factory=_Window)
    alerting: bool = False

    def evaluate(self, now: float) -> Optional[Alert]:
        self.window.trim(now, self.baseline_s + self.recent_s)
        recent = self.window.values(now, self.recent_s)
        older = [v for t, v in self.window._pts
                 if now - t > self.recent_s]
        if len(recent) < self.min_recent or len(older) < self.min_baseline:
            self.alerting = False
            return None
        base = percentile(sorted(older), 0.5)
        cur = percentile(sorted(recent), 0.5)
        if base <= 0 or cur <= self.factor * base:
            self.alerting = False
            return None
        if self.alerting:        # edge-triggered (see _BurnRateRule)
            return None
        self.alerting = True
        return Alert(
            rule=self.name, kind="regression", series=self.series,
            value=cur, threshold=self.factor * base,
            message=(f"{self.series}[{self.field}] recent median "
                     f"{cur:.4g} is {cur / base:.2f}x the trailing "
                     f"baseline {base:.4g} (threshold {self.factor}x)"),
            ts_unix=time.time(),
            windows={"baseline_median": round(base, 6),
                     "recent_median": round(cur, 6)})


class SLOEngine:
    """Rules over rolling windows; evaluated on the caller's cadence.

    Observations arrive two ways:

    - **push** — instrumented call sites (Trainer log cadence, serving
      token path) call :meth:`observe` with fresh values;
    - **pull** — rules bound to a registry series with no pushes sample
      the current series value (histograms: the named summary field) on
      every :meth:`evaluate` — "rolling-window baselines over existing
      histograms/gauges".
    """

    def __init__(self, registry: Optional[MetricRegistry] = None, *,
                 clock: Callable[[], float] = time.monotonic):
        self._registry = registry
        self._clock = clock
        self._rules: list = []
        self._pushed: set[str] = set()      # series with push traffic
        self.alerts_total = 0

    # -- rule construction --------------------------------------------------
    def add_burn_rate(self, name: str, series: str, *,
                      objective: float, field: str = "p99",
                      budget: float = 0.01,
                      windows: Sequence[tuple] = ((60.0, 14.4),
                                                  (300.0, 6.0)),
                      direction: str = "above",
                      min_samples: int = 3) -> "SLOEngine":
        """SLO: at most ``budget`` of observations may violate
        ``objective``; alert when the burn rate exceeds its threshold in
        EVERY window (multi-window multi-burn-rate)."""
        self._rules.append(_BurnRateRule(
            name=name, series=series, field=field,
            objective=float(objective), budget=float(budget),
            windows=tuple((float(a), float(b)) for a, b in windows),
            direction=direction, min_samples=int(min_samples)))
        return self

    def add_regression(self, name: str, series: str, *,
                       field: str = "p50", factor: float = 2.0,
                       baseline_s: float = 300.0, recent_s: float = 30.0,
                       min_baseline: int = 8,
                       min_recent: int = 2) -> "SLOEngine":
        """Anomaly: recent-window median > ``factor`` x trailing-baseline
        median (loss spikes, step-time/TTFT regressions)."""
        self._rules.append(_RegressionRule(
            name=name, series=series, field=field, factor=float(factor),
            baseline_s=float(baseline_s), recent_s=float(recent_s),
            min_baseline=int(min_baseline), min_recent=int(min_recent)))
        return self

    # -- observations -------------------------------------------------------
    def observe(self, series: str, value: float) -> None:
        """Push one fresh observation to every rule bound to ``series``."""
        now = self._clock()
        self._pushed.add(series)
        for r in self._rules:
            if r.series == series:
                r.window.add(now, float(value))

    def _pull(self, now: float) -> None:
        if self._registry is None:
            return
        for r in self._rules:
            if r.series in self._pushed:
                continue
            m = self._registry.get(r.series)
            if m is None:
                continue
            if m.kind == "histogram":
                s = m.summary()
                if not s["count"]:
                    continue
                r.window.add(now, float(s.get(r.field, 0.0)))
            else:
                r.window.add(now, float(m.value()))

    # -- evaluation ---------------------------------------------------------
    def evaluate(self) -> list[Alert]:
        """Pull registry-bound rules, run every detector, record fired
        alerts (metrics + flight record) and return them."""
        now = self._clock()
        self._pull(now)
        alerts = []
        for r in self._rules:
            a = r.evaluate(now)
            if a is not None:
                alerts.append(a)
        if self._registry is not None:
            for r in self._rules:
                self._registry.gauge(
                    "slo_alerting",
                    "1 while the rule's condition is breached").set(
                    1.0 if r.alerting else 0.0, rule=r.name)
        for a in alerts:
            self.alerts_total += 1
            if self._registry is not None:
                self._registry.counter(
                    "slo_alerts_total", "fired SLO/anomaly alerts").inc(
                    rule=a.rule)
            get_flight_recorder().record(
                "slo_alert", rule=a.rule, series=a.series,
                value=round(a.value, 6), threshold=round(a.threshold, 6))
        return alerts

    def status(self) -> dict:
        """Live JSON for HEALTHZ / obs_report: per-rule state + totals."""
        rules = []
        for r in self._rules:
            rules.append({
                "name": r.name, "series": r.series,
                "kind": "burn_rate" if isinstance(r, _BurnRateRule)
                else "regression",
                "alerting": r.alerting, "samples": len(r.window),
            })
        return {"rules": rules, "alerts_total": self.alerts_total,
                "alerting": any(r.alerting for r in self._rules)}


# -- canned rule sets --------------------------------------------------------

def default_training_rules(engine: SLOEngine, *,
                           step_time_factor: float = 2.0,
                           loss_factor: float = 2.0,
                           baseline_s: float = 600.0,
                           recent_s: float = 60.0) -> SLOEngine:
    """Trainer log-cadence watchers: step-time regression, loss spike,
    grad-norm spike (all baseline-relative — no absolute knobs)."""
    engine.add_regression("step_time_regression", "step_time_s",
                          factor=step_time_factor,
                          baseline_s=baseline_s, recent_s=recent_s)
    engine.add_regression("loss_spike", "loss", factor=loss_factor,
                          baseline_s=baseline_s, recent_s=recent_s,
                          min_recent=1)
    engine.add_regression("grad_norm_spike", "grad_norm", factor=4.0,
                          baseline_s=baseline_s, recent_s=recent_s,
                          min_recent=1)
    return engine


def default_serving_rules(engine: SLOEngine, *,
                          ttft_objective_s: float = 1.0,
                          tpot_objective_s: float = 0.2,
                          budget: float = 0.05,
                          windows: Sequence[tuple] = ((60.0, 10.0),
                                                      (300.0, 2.0)),
                          ) -> SLOEngine:
    """Serving-loop watchers: TTFT/TPOT burn-rate SLOs on the pushed
    per-request latencies + an engine-step-time regression detector."""
    engine.add_burn_rate("ttft_slo", "serving_ttft_seconds",
                         objective=ttft_objective_s, budget=budget,
                         windows=windows)
    engine.add_burn_rate("tpot_slo", "serving_tpot_seconds",
                         objective=tpot_objective_s, budget=budget,
                         windows=windows)
    engine.add_regression("serving_step_regression",
                          "serving_step_seconds", factor=3.0,
                          baseline_s=300.0, recent_s=30.0)
    return engine


# -- health payload (HEALTHZ verb / obs_report) ------------------------------

def _rule_label(series: str) -> str:
    """``slo_alerting{rule="x"}`` → ``x`` (series name when unlabeled)."""
    if 'rule="' in series:
        return series.split('rule="', 1)[1].split('"', 1)[0]
    return series


def health_from_snapshot(snap: dict) -> dict:
    """The health view of a registry snapshot — the ONE parser for the
    watchdog/SLO series, shared by :func:`health_status`,
    ``tools/trace_summary.health_summary`` and
    ``tools/obs_report.slo_report``:
    ``{"watchdog_trips", "alerts_by_rule", "alerting_rules"}``."""
    trips = 0.0
    alerts_by_rule: dict[str, float] = {}
    alerting: list[str] = []
    for series, v in snap.items():
        if not isinstance(v, (int, float)):
            continue
        base = series.split("{")[0]
        if base == "watchdog_trips_total":
            trips += v
        elif base == "slo_alerts_total":
            rule = _rule_label(series)
            alerts_by_rule[rule] = alerts_by_rule.get(rule, 0.0) + v
        elif base == "slo_alerting" and v:
            alerting.append(_rule_label(series))
    return {"watchdog_trips": int(trips),
            "alerts_by_rule": alerts_by_rule,
            "alerting_rules": sorted(alerting)}


def health_status(registry: Optional[MetricRegistry] = None, *,
                  serving=None, slo: Optional[SLOEngine] = None) -> dict:
    """One JSON health document: overall status (``ok`` | ``degraded``),
    watchdog trips, SLO state, serving liveness, flight-recorder depth.
    Built from the global registry PLUS the always-on sources (the
    flight module's trip ledger, a live :class:`SLOEngine` when given)
    so a hang still degrades health when the telemetry master switch —
    and therefore every registry write — was left off."""
    from hetu_tpu_torch.telemetry.flight import watchdog_trip_totals
    if registry is None:
        from hetu_tpu_torch import telemetry
        registry = telemetry.get_registry()
    hs = health_from_snapshot(registry.snapshot())
    # the registry no-ops writes while disabled; the trip ledger and the
    # engine's own rule state do not
    trips = max(hs["watchdog_trips"],
                sum(watchdog_trip_totals().values()))
    alerting_rules = set(hs["alerting_rules"])
    alerts_total = sum(hs["alerts_by_rule"].values())
    if slo is not None:
        st = slo.status()
        alerting_rules |= {r["name"] for r in st["rules"]
                           if r["alerting"]}
        alerts_total = max(alerts_total, st["alerts_total"])
    alerting_rules = sorted(alerting_rules)
    rec = get_flight_recorder()
    out = {
        "status": "degraded" if (trips or alerting_rules) else "ok",
        "ts_unix": round(time.time(), 3),
        "watchdog_trips": int(trips),
        "slo": {"alerting_rules": alerting_rules,
                "alerts_total": int(alerts_total)},
        "flight_events": len(rec),
    }
    if slo is not None:
        out["slo"]["rules"] = slo.status()["rules"]
    if serving is not None:
        try:
            if hasattr(serving, "fleet_status"):
                # a fleet Router: per-replica states + fleet counters;
                # a fleet with ZERO live replicas is degraded outright
                fleet = serving.fleet_status()
                out["serving"] = fleet
                if fleet.get("live", 0) == 0 and fleet["replicas"]:
                    out["status"] = "degraded"
            else:
                out["serving"] = {
                    "queue_depth": serving.scheduler.depth,
                    "slot_occupancy": round(
                        serving.scheduler.occupancy, 4),
                    "iterations": serving._iter,
                    # is_alive(): a loop thread that died from an
                    # unhandled exception must read as down, not merely
                    # "was started"
                    "loop_running": serving._thread is not None
                    and serving._thread.is_alive(),
                }
        except Exception:
            out["serving"] = {"error": "unavailable"}
    return out
