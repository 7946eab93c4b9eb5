"""Pure SLO math (counterpart of hyperspace_tpu/telemetry/slo.py, copied):
multi-window multi-burn-rate evaluation over metric samples, plus the
alert-state transition function.

Everything here is a pure function over plain data, a list of
``(ts, counters, histograms)`` samples in, burn rates and state
transitions out, so the clock-skew and flap-damping cases are
unit-testable with no IO.  The alert engine that owns threads, conf and
the store is telemetry/alerts.py.

The model is the Google-SRE multi-window multi-burn-rate recipe:

  - An **objective** declares a target ratio of GOOD events (availability:
    ``serve.ok`` over ok+errors+shed; latency: observations under the SLO
    bound over all observations).  The **error budget** is ``1 - target``.
  - The **burn rate** over a window is ``(bad/total in window) /
    budget`` — 1.0 means the budget is being spent exactly at the rate
    that exhausts it at the window's end; 14.4 over 5m+1h means ~2% of a
    30-day budget gone in an hour (the classic fast-burn page).
  - A **rule** breaches only when BOTH its short and long windows exceed
    the factor: the long window is the signal, the short window is the
    "is it still happening" guard that ends the page quickly after
    recovery.

Sampling model: the engine appends one cumulative sample per evaluation
tick.  A window's delta is computed against the NEWEST sample at least
``window_s`` old (clamped to the oldest available) — with samples riding
the heartbeat cadence this is exact for monotonic counters.  Skew and
restarts are tolerated, not assumed away: samples are sorted by ts, a
negative counter delta (process restart, registry reset) reads as an
EMPTY window (no data beats wrong data), and a window that spans less
than ``min_fraction`` of its nominal width is marked incomplete so young
processes do not page off seconds of data.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

# Alert states (what an alert engine persists).
PENDING = "pending"
FIRING = "firing"
RESOLVED = "resolved"

# Fraction of the nominal window that must be covered by samples before
# a rule is allowed to breach (young process / sparse ring guard).
MIN_WINDOW_FRACTION = 0.5


@dataclasses.dataclass(frozen=True)
class BurnRule:
    """One multi-window burn-rate rule: breach when BOTH windows burn
    faster than ``factor`` budgets-per-window."""

    name: str          # "fast_burn" | "slow_burn"
    short_s: float
    long_s: float
    factor: float
    severity: str      # "page" | "warn"


@dataclasses.dataclass(frozen=True)
class Sample:
    """One cumulative observation of the metrics registry."""

    ts: float
    good: float
    bad: float

    @property
    def total(self) -> float:
        return self.good + self.bad


def hist_split(hist: Optional[Dict[str, Any]],
               slo_ms: float) -> Tuple[float, float]:
    """``(good, bad)`` cumulative observation counts from a histogram
    snapshot's fixed buckets: good = observations in buckets bounded
    ``<= slo_ms`` (the conservative split telemetry/doctor.py uses),
    bad = the rest.  ``(0, 0)`` for missing/malformed input."""
    if not isinstance(hist, dict) or slo_ms <= 0:
        return 0.0, 0.0
    try:
        count = float(hist.get("count", 0) or 0)
        buckets = hist.get("buckets")
        if count <= 0 or not isinstance(buckets, dict):
            return 0.0, 0.0
        under = 0.0
        for bound, n in buckets.items():
            b = float("inf") if str(bound) == "+Inf" else float(bound)
            if b <= slo_ms:
                under += float(n or 0)
        under = min(under, count)
        return under, count - under
    except (TypeError, ValueError):
        return 0.0, 0.0


def window_delta(samples: Sequence[Sample], now: float,
                 window_s: float) -> Tuple[float, float, float]:
    """``(good_delta, bad_delta, covered_s)`` between the latest sample
    and the newest sample at least ``window_s`` old (clamped to the
    oldest).  Pure and skew-tolerant: samples are sorted by ts (an NTP
    step reordering the ring cannot invert a delta), and a NEGATIVE
    delta on either counter — a restart or registry reset inside the
    window — reads as an empty window rather than a huge phantom burn."""
    if not samples or window_s <= 0:
        return 0.0, 0.0, 0.0
    ordered = sorted(samples, key=lambda s: s.ts)
    head = ordered[-1]
    target = now - window_s
    base = ordered[0]
    for s in ordered:
        if s.ts <= target:
            base = s
        else:
            break
    covered = max(0.0, head.ts - base.ts)
    good = head.good - base.good
    bad = head.bad - base.bad
    if good < 0 or bad < 0 or covered <= 0:
        return 0.0, 0.0, 0.0
    return good, bad, covered


def burn_rate(good: float, bad: float, budget: float) -> float:
    """Budget-consumption rate of one window: observed bad ratio over
    the error budget.  0.0 for an empty window or a degenerate budget
    (target >= 1 would page on any single error — treat as unburnable)."""
    total = good + bad
    if total <= 0 or budget <= 0:
        return 0.0
    return (bad / total) / budget


def evaluate_rule(samples: Sequence[Sample], now: float, rule: BurnRule,
                  budget: float) -> Dict[str, Any]:
    """One rule over one objective's sample ring: both window burns, the
    breach verdict, and window-coverage diagnostics.  A window covering
    less than ``MIN_WINDOW_FRACTION`` of its nominal width cannot breach
    (but CAN clear — recovery is never suppressed)."""
    g_s, b_s, cov_s = window_delta(samples, now, rule.short_s)
    g_l, b_l, cov_l = window_delta(samples, now, rule.long_s)
    burn_short = burn_rate(g_s, b_s, budget)
    burn_long = burn_rate(g_l, b_l, budget)
    complete = (cov_s >= rule.short_s * MIN_WINDOW_FRACTION
                and cov_l >= rule.long_s * MIN_WINDOW_FRACTION)
    breached = (complete and burn_short >= rule.factor
                and burn_long >= rule.factor)
    return {"rule": rule.name, "severity": rule.severity,
            "factor": rule.factor,
            "burn_short": round(burn_short, 4),
            "burn_long": round(burn_long, 4),
            "covered_short_s": round(cov_s, 3),
            "covered_long_s": round(cov_l, 3),
            "complete": complete, "breached": breached}


def evaluate_objective(samples: Sequence[Sample], now: float,
                       rules: Sequence[BurnRule],
                       target: float) -> Dict[str, Any]:
    """Every rule over one objective; the worst breached rule (page
    beats warn) decides ``breached``/``severity``."""
    budget = 1.0 - float(target)
    evaluations = [evaluate_rule(samples, now, r, budget) for r in rules]
    breached = [e for e in evaluations if e["breached"]]
    worst = None
    for e in breached:
        if worst is None or (e["severity"] == "page"
                             and worst["severity"] != "page"):
            worst = e
    return {"target": target, "breached": bool(breached),
            "severity": worst["severity"] if worst else "",
            "worst_rule": worst["rule"] if worst else "",
            "rules": evaluations}


def threshold_objective(value: Optional[float], threshold: float,
                        severity: str) -> Dict[str, Any]:
    """Gauge-style objective (staleness seconds, dead-holder build
    claims): breached while ``value >= threshold``.  A None value (probe
    failed) never breaches — a blind probe is the doctor's finding, not
    a page."""
    breached = (value is not None and threshold > 0
                and float(value) >= threshold)
    return {"value": value, "threshold": threshold,
            "breached": bool(breached),
            "severity": severity if breached else "", "rules": []}


# ---------------------------------------------------------------------------
# The alert state machine (flap damping)
# ---------------------------------------------------------------------------
def step_state(prev: Optional[Dict[str, Any]], breached: bool,
               severity: str, now: float, pending_evals: int = 2,
               resolve_evals: int = 2) -> Tuple[Dict[str, Any],
                                                Optional[str]]:
    """One evaluation tick of one alert's state machine.  Returns
    ``(new_state, transition)`` where ``transition`` is ``"firing"`` /
    ``"resolved"`` / None.

    Flap damping: a breach must persist ``pending_evals`` consecutive
    evaluations before pending promotes to firing (a single bad tick
    never pages), and a firing alert must see ``resolve_evals``
    consecutive clear evaluations before it resolves (a single good
    tick mid-incident never closes the page).  ``pending_evals <= 1``
    fires immediately on the first breach."""
    state = str(prev.get("state", RESOLVED)) if prev else RESOLVED
    streak = int(prev.get("streak", 0) or 0) if prev else 0
    since = float(prev.get("since", now) or now) if prev else now
    pending_evals = max(1, int(pending_evals))
    resolve_evals = max(1, int(resolve_evals))

    if breached:
        if state == FIRING:
            return ({"state": FIRING, "streak": 0, "since": since,
                     "severity": severity or str(
                         prev.get("severity", "") if prev else "")},
                    None)
        streak = streak + 1 if state == PENDING else 1
        if streak >= pending_evals:
            return ({"state": FIRING, "streak": 0, "since": now,
                     "severity": severity}, "firing")
        return ({"state": PENDING, "streak": streak, "since": since
                 if state == PENDING else now,
                 "severity": severity}, None)
    if state == FIRING:
        streak += 1
        if streak >= resolve_evals:
            return ({"state": RESOLVED, "streak": 0, "since": now,
                     "severity": ""}, "resolved")
        return ({"state": FIRING, "streak": streak, "since": since,
                 "severity": str(prev.get("severity", "")
                                 if prev else "")}, None)
    if state == PENDING:
        # A pending alert that stops breaching goes straight back: it
        # never fired, so there is nothing to damp.
        return ({"state": RESOLVED, "streak": 0, "since": now,
                 "severity": ""}, None)
    return ({"state": RESOLVED, "streak": 0, "since": since,
             "severity": ""}, None)


def default_rules(fast_short_s: float = 300.0, fast_long_s: float = 3600.0,
                  fast_factor: float = 14.4,
                  slow_short_s: float = 21600.0,
                  slow_long_s: float = 259200.0,
                  slow_factor: float = 1.0) -> List[BurnRule]:
    """The classic two-rule ladder: 5m+1h fast burn pages, 6h+3d slow
    burn warns (windows/factors conf-tunable — tests shrink them to
    sub-second so a drill fires within two evaluation intervals)."""
    return [
        BurnRule("fast_burn", fast_short_s, fast_long_s, fast_factor,
                 "page"),
        BurnRule("slow_burn", slow_short_s, slow_long_s, slow_factor,
                 "warn"),
    ]
