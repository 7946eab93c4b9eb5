"""The optimize-result cache (counterpart of
hyperspace_tpu/execution/plan_cache.py): pay the optimizer once per
query, serve repeats straight to the executor.

A repeat query pays the whole optimizer pass (the subquery rewrite,
pushdown, pruning, the rules over every ACTIVE index) before it runs.
``Dataset.collect(plan_cache=...)`` keeps the OPTIMIZED plan under a key
of three parts:

  - the advisor's structural fingerprint (``advisor/workload.fingerprint``:
    per relation its filter, join and group columns, never a literal);
  - a digest of the whole plan tree with its literals
    (``plan.tree_string()``), since two values of one shape prune other
    buckets and so optimize to other plans;
  - whether hyperspace is enabled on the session.

An entry goes stale three ways:

  - **generation**: every committed action (create, refresh, optimize,
    delete, restore, vacuum, repair; actions/base.py) bumps a
    process-wide generation, and an entry made under an older one is a
    miss (``serve.plan_cache.stale``), so the next query plans against
    the new index state;
  - **TTL**: a source can change with no action (files appended under a
    scanned root); entries expire after ``ttl_s``;
  - **explicit**: ``collect`` drops the entry of a plan that failed at
    execution before containment runs, so a cached plan over damaged
    files cannot fail twice.

Eviction is the byte-budget LRU the device column cache uses
(``execution/device_cache.ByteBudgetLRU``), an entry costed at its
rendered tree plus the file lists of its scans; the counters and the
bytes gauge go under ``serve.plan_cache.*``.
"""

from __future__ import annotations

import hashlib
import threading
import time
from typing import Optional, Tuple

from hyperspace_tpu_torch.execution.device_cache import ByteBudgetLRU
from hyperspace_tpu_torch.plan.nodes import LogicalPlan, Scan

# Process-wide, not per session: sessions share the indexes on disk, so
# an action through any session makes every cache's plans suspect.
_generation = 0
_generation_lock = threading.Lock()


def bump_generation() -> None:
    global _generation
    with _generation_lock:
        _generation += 1


def current_generation() -> int:
    with _generation_lock:
        return _generation


def _plan_bytes_estimate(rendered: str, plan: LogicalPlan) -> int:
    """The retained size of a cached plan: its rendered tree plus each
    scan's file list (an index scan holds every file path)."""
    total = len(rendered)
    for scan in plan.leaf_relations():
        if isinstance(scan, Scan) and scan.relation.file_paths:
            total += sum(len(p) for p in scan.relation.file_paths)
    return total + 256  # a floor for the node objects


class PlanCache:
    """A thread-safe optimize-result cache."""

    def __init__(self, budget_bytes: int = 64 << 20,
                 ttl_s: float = 300.0) -> None:
        self.budget_bytes = int(budget_bytes)
        self.ttl_s = float(ttl_s)
        self._lru = ByteBudgetLRU(metric_prefix="serve.plan_cache")

    def key_for(self, session, plan: LogicalPlan) -> Optional[str]:
        """The key of the user's ``plan``, or None when it cannot be
        cached (no source relation to fingerprint, or the fingerprint
        failed: a cache never fails a query)."""
        try:
            from hyperspace_tpu_torch.advisor import workload

            fp = workload.fingerprint(session, plan)
            if fp is None:
                return None
            structural = workload.fingerprint_key(fp)
            literal = hashlib.sha1(
                plan.tree_string().encode("utf-8")).hexdigest()[:16]
            enabled = "1" if session.is_hyperspace_enabled() else "0"
            return f"{structural}:{literal}:{enabled}"
        except Exception:  # noqa: BLE001 - uncacheable, never fatal
            return None

    def get(self, key: str) -> Optional[LogicalPlan]:
        entry: Optional[Tuple[LogicalPlan, int, float]] = self._lru.peek(key)
        if entry is not None:
            plan, generation, stored_at = entry
            if generation == current_generation() \
                    and time.monotonic() - stored_at <= self.ttl_s:
                self._lru.get(key)  # the hit and the recency bump
                return plan
            # Stale: dropped before the counting lookup, so a hit means
            # "served from the cache" and nothing else.
            self._lru.pop(key)
            from hyperspace_tpu_torch.telemetry import metrics

            metrics.inc("serve.plan_cache.stale")
        self._lru.get(key)  # the miss
        return None

    def put(self, key: str, plan: LogicalPlan) -> None:
        try:
            rendered = plan.tree_string()
        except Exception:  # noqa: BLE001 - unrenderable: uncacheable
            return
        self._lru.put(key, (plan, current_generation(), time.monotonic()),
                      _plan_bytes_estimate(rendered, plan),
                      self.budget_bytes)

    def invalidate(self, key: str) -> None:
        self._lru.pop(key)

    def clear(self) -> None:
        self._lru.clear()

    def stats(self):
        return self._lru.stats()
