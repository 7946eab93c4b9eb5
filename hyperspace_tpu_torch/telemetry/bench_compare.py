"""Bench regression watchdog: diff one bench run against a baseline
(counterpart of hyperspace_tpu/telemetry/bench_compare.py, copied: it is
pure host logic).

The inputs are the current run's per-section checkpoint JSONL and a
baseline, which may be a prior checkpoint JSONL, a headline-shaped JSON,
or ``auto`` (the previous run's rotated results file).  Both shapes
flatten to the same dotted metric paths, so any two of them compare.

What counts as comparable (everything else is ignored, so new metrics
never false-positive):

  - ``*_s`` scalar seconds and ``*_s.median`` timing stats: lower is
    better;
  - ``*speedup*`` ratios: higher is better;
  - ``*_mrows_per_s`` / ``*_mb_s`` throughput rates: higher is better.

A metric regresses when it moves past ``threshold_pct`` in the bad
direction and by more than ``min_abs_s``, the absolute floor that keeps
toy-scale timer noise from tripping the watchdog.  For seconds metrics
the floor applies to the delta; a ratio or rate metric carries no
seconds of its own, so the floor applies to its *reference seconds*, the
sibling timing metric of the same workload (``X_speedup`` ->
``X_scan_s.median``; ``geomean_speedup`` -> the largest contributing scan
median); ratios with no sibling fall back to the threshold alone.  For a
regressed metric whose section carries per-index build-phase records
(``build_phases`` / ``index_build_phases``), the report renders which
phase of which index's build took the delta.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Tuple

DEFAULT_THRESHOLD_PCT = 25.0
DEFAULT_MIN_ABS_S = 0.5

# Headline-detail bookkeeping keys that are not metrics.
_SKIP_KEYS = frozenset({
    "section", "status", "elapsed_s", "reason", "platform", "sections_run",
    "results_file", "trace_file", "bench_elapsed_s", "note", "scale",
    "skipped", "budget_s", "bench",
})
_PHASE_KEYS = ("build_phases", "index_build_phases")


class BaselineError(Exception):
    """The named baseline cannot be read/parsed (exit code 2 in bench)."""


@dataclasses.dataclass
class RunMetrics:
    """One run, flattened: metric path → value, plus attribution data."""

    path: str
    metrics: Dict[str, float]
    key_section: Dict[str, str]          # top metric path → section name
    phases: Dict[str, List[dict]]        # section → per-index phase dicts


@dataclasses.dataclass
class CompareResult:
    regressions: List[dict]
    improvements: List[dict]
    compared: int
    baseline_path: str

    @property
    def ok(self) -> bool:
        return not self.regressions


# ---------------------------------------------------------------------------
# Loading
# ---------------------------------------------------------------------------
def _flatten(prefix: str, value: Any, out: Dict[str, float]) -> None:
    if isinstance(value, bool):
        return
    if isinstance(value, (int, float)):
        out[prefix] = float(value)
        return
    if isinstance(value, dict):
        for k, v in value.items():
            if k in _SKIP_KEYS:
                continue
            _flatten(f"{prefix}.{k}" if prefix else str(k), v, out)


def _merge_detail(detail: Dict[str, Any], section_of_key: Dict[str, str],
                  phases: Dict[str, List[dict]], section: str) -> dict:
    clean: Dict[str, Any] = {}
    for k, v in detail.items():
        if k in _PHASE_KEYS:
            if isinstance(v, list):
                phases.setdefault(section, []).extend(
                    p for p in v if isinstance(p, dict))
            continue
        if k in _SKIP_KEYS:
            continue
        clean[k] = v
        section_of_key[k] = section
        # One level of nesting also carries phase lists (sf10/sf100 put
        # theirs inside their own sub-dict).
        if isinstance(v, dict):
            for pk in _PHASE_KEYS:
                pv = v.get(pk)
                if isinstance(pv, list):
                    phases.setdefault(k, []).extend(
                        p for p in pv if isinstance(p, dict))
    return clean


def load_run(path: str) -> RunMetrics:
    """Load a results artifact: per-section checkpoint JSONL (preferred)
    or headline-shaped JSON.  Raises :class:`BaselineError` when the file
    is missing or holds neither shape."""
    try:
        with open(path, encoding="utf-8") as f:
            lines = [ln for ln in f if ln.strip()]
    except OSError as e:
        raise BaselineError(f"cannot read {path!r}: {e}") from e
    records = []
    for ln in lines:
        try:
            records.append(json.loads(ln))
        except ValueError:
            continue  # a torn checkpoint line is survivable
    if not records:
        raise BaselineError(f"{path!r} holds no parseable JSON")

    key_section: Dict[str, str] = {}
    phases: Dict[str, List[dict]] = {}
    merged: Dict[str, Any] = {}
    section_records = [r for r in records
                       if isinstance(r, dict) and r.get("status") == "ok"
                       and "section" in r]
    if section_records:
        for r in section_records:
            detail = {k: v for k, v in r.items()}
            merged.update(_merge_detail(detail, key_section, phases,
                                        str(r["section"])))
    else:
        headline = None
        for r in records:
            if isinstance(r, dict) and isinstance(r.get("headline"), dict):
                headline = r["headline"]
            elif isinstance(r, dict) and "detail" in r \
                    and isinstance(r["detail"], dict):
                headline = r
        if headline is None:
            raise BaselineError(
                f"{path!r} holds neither section checkpoints nor a "
                f"headline record")
        merged = _merge_detail(dict(headline.get("detail", {})),
                               key_section, phases, "headline")
        if isinstance(headline.get("value"), (int, float)):
            merged.setdefault("geomean_speedup", headline["value"])
            key_section.setdefault("geomean_speedup", "headline")

    flat: Dict[str, float] = {}
    _flatten("", merged, flat)
    return RunMetrics(path=path, metrics=flat, key_section=key_section,
                      phases=phases)


# ---------------------------------------------------------------------------
# Classification + diff
# ---------------------------------------------------------------------------
def _direction(path: str) -> Optional[str]:
    """"lower" / "higher" is better, or None (not comparable)."""
    parts = path.split(".")
    last = parts[-1]
    if last.endswith("_mrows_per_s") or last.endswith("_mb_s"):
        return "higher"
    if "speedup" in last or last == "geomean_speedup":
        return "higher"
    if last == "firing" or last.endswith("_ratio"):
        # Alert gauges and overhead ratios: fewer firing alerts and a
        # smaller ratio are better.  Unitless — the seconds floor does
        # not apply (and ``*_rate`` stays out: hedge_win_rate is
        # neither better high nor low).
        return "lower"
    if last.endswith("_s"):
        return "lower"
    if last == "median" and len(parts) >= 2 and parts[-2].endswith("_s") \
            and not parts[-2].endswith("_per_s"):
        return "lower"
    return None


def _seconds_metric(path: str) -> bool:
    """True when the metric is in seconds — the only unit the
    ``min_abs_s`` absolute floor is meaningful for."""
    last = path.split(".")[-1]
    return last.endswith("_s") or last == "median"


def _section_of(run: RunMetrics, path: str) -> str:
    return run.key_section.get(path.split(".")[0], "")


def _ratio_reference_seconds(path: str, current: RunMetrics,
                             baseline: RunMetrics) -> Optional[float]:
    """The seconds a ratio/rate metric is ABOUT — the sibling timing of
    the same workload, max over both runs (either run being slow enough
    makes the ratio meaningful).  None when no sibling resolves."""
    parts = path.split(".")
    last = parts[-1]
    prefix = parts[:-1]

    def key(name: str) -> str:
        return ".".join(prefix + [name]) if prefix else name

    candidates: List[str] = []
    if last == "geomean_speedup":
        # The geomean's reference is the slowest contributing workload:
        # every *_scan_s.median under the same prefix.
        scope = ".".join(prefix) + "." if prefix else ""
        for run in (current, baseline):
            for k in run.metrics:
                if k.startswith(scope) and k.endswith("_scan_s.median") \
                        and k.count(".") == len(prefix) + 1:
                    candidates.append(k)
    elif last.endswith("_speedup"):
        stem = last[: -len("_speedup")]
        candidates += [key(f"{stem}_scan_s.median"),
                       key(f"{stem}_indexed_s.median")]
    elif last.endswith("speedup_vs_host"):
        candidates += [key("host_s.median"), key("warm_s.median"),
                       key("warm_resident_s.median")]
    elif last.endswith("_mrows_per_s"):
        stem = last[: -len("_mrows_per_s")]
        candidates.append(key(f"{stem}_s.median"))
    elif last.endswith("_mb_s"):
        stem = last[: -len("_mb_s")]
        candidates.append(key(f"{stem}_full_s.median"))
    vals = [run.metrics[c] for run in (current, baseline)
            for c in candidates if c in run.metrics]
    return max(vals) if vals else None


def compare_runs(current: RunMetrics, baseline: RunMetrics,
                 threshold_pct: float = DEFAULT_THRESHOLD_PCT,
                 min_abs_s: float = DEFAULT_MIN_ABS_S) -> CompareResult:
    regressions: List[dict] = []
    improvements: List[dict] = []
    compared = 0
    for path, cur in sorted(current.metrics.items()):
        direction = _direction(path)
        if direction is None or path not in baseline.metrics:
            continue
        base = baseline.metrics[path]
        if base <= 0:
            continue
        compared += 1
        delta_pct = (cur - base) / base * 100.0
        finding = {"metric": path,
                   "section": _section_of(current, path)
                   or _section_of(baseline, path),
                   "baseline": round(base, 4), "current": round(cur, 4),
                   "delta_pct": round(delta_pct, 1),
                   "direction": direction}
        if direction == "lower":
            floor = min_abs_s if _seconds_metric(path) else 0.0
            if delta_pct > threshold_pct and (cur - base) > floor:
                regressions.append(finding)
            elif delta_pct < -threshold_pct and (base - cur) > floor:
                improvements.append(finding)
        else:
            # Higher is better (ratios/rates): the abs floor applies to
            # the workload's reference seconds — a halved speedup on a
            # 2 ms workload is timer noise, on a 20 s one a regression.
            ref = _ratio_reference_seconds(path, current, baseline)
            if ref is not None and ref <= min_abs_s:
                continue
            if delta_pct < -threshold_pct:
                regressions.append(finding)
            elif delta_pct > threshold_pct:
                improvements.append(finding)
    regressions.sort(key=lambda r: -abs(r["delta_pct"]))
    improvements.sort(key=lambda r: -abs(r["delta_pct"]))
    return CompareResult(regressions=regressions, improvements=improvements,
                         compared=compared, baseline_path=baseline.path)


# ---------------------------------------------------------------------------
# Rendering
# ---------------------------------------------------------------------------
def _phase_rows(recs: List[dict]) -> Dict[Tuple[str, str], float]:
    out: Dict[Tuple[str, str], float] = {}
    for i, rec in enumerate(recs):
        index = str(rec.get("index", f"#{i}"))
        for k, v in rec.items():
            if k == "index" or not isinstance(v, (int, float)):
                continue
            key = (index, k[:-2] if k.endswith("_s") else k)
            out[key] = out.get(key, 0.0) + float(v)
    return out


def phase_attribution(current: RunMetrics, baseline: RunMetrics,
                      section: str) -> str:
    """Per-phase build attribution table for ``section`` — empty string
    when either run lacks phase records for it."""
    cur = current.phases.get(section)
    base = baseline.phases.get(section)
    if not cur or not base:
        return ""
    c_rows, b_rows = _phase_rows(cur), _phase_rows(base)
    keys = sorted(set(c_rows) | set(b_rows))
    lines = [f"  per-phase attribution for section {section!r}:",
             f"    {'index':<14}{'phase':<14}{'baseline_s':>12}"
             f"{'current_s':>12}{'delta_s':>10}"]
    for index, phase in keys:
        b = b_rows.get((index, phase), 0.0)
        c = c_rows.get((index, phase), 0.0)
        lines.append(f"    {index:<14}{phase:<14}{b:>12.3f}{c:>12.3f}"
                     f"{c - b:>+10.3f}")
    return "\n".join(lines)


def render_report(result: CompareResult, current: RunMetrics,
                  baseline: RunMetrics,
                  threshold_pct: float = DEFAULT_THRESHOLD_PCT,
                  min_abs_s: float = DEFAULT_MIN_ABS_S) -> str:
    lines = [f"bench compare: {os.path.basename(current.path)} vs "
             f"{os.path.basename(baseline.path)} "
             f"({result.compared} comparable metrics, "
             f"threshold {threshold_pct:g}% / {min_abs_s:g}s)"]
    if not result.regressions:
        lines.append("no regression")
    else:
        lines.append(f"REGRESSED: {len(result.regressions)} metric(s)")
        for r in result.regressions:
            word = "slower" if r["direction"] == "lower" else "worse"
            lines.append(
                f"  [{r['section'] or '?'}] {r['metric']}: "
                f"{r['baseline']} -> {r['current']} "
                f"({r['delta_pct']:+.1f}% {word})")
        for section in sorted({r["section"] for r in result.regressions
                               if r["section"]}):
            table = phase_attribution(current, baseline, section)
            if table:
                lines.append(table)
    if result.improvements:
        lines.append(f"improved: {len(result.improvements)} metric(s)")
        for r in result.improvements[:10]:
            lines.append(
                f"  [{r['section'] or '?'}] {r['metric']}: "
                f"{r['baseline']} -> {r['current']} "
                f"({r['delta_pct']:+.1f}%)")
    return "\n".join(lines)


def compare_files(current_path: str, baseline_path: str,
                  threshold_pct: float = DEFAULT_THRESHOLD_PCT,
                  min_abs_s: float = DEFAULT_MIN_ABS_S
                  ) -> Tuple[CompareResult, str]:
    """Convenience: load both artifacts, diff, render.  Raises
    :class:`BaselineError` for an unreadable baseline OR current."""
    current = load_run(current_path)
    baseline = load_run(baseline_path)
    result = compare_runs(current, baseline, threshold_pct, min_abs_s)
    return result, render_report(result, current, baseline,
                                 threshold_pct, min_abs_s)
