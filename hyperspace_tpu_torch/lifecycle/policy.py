"""The maintenance policy (counterpart of hyperspace_tpu/lifecycle/policy.py):
a change summary and the index's state in, one decision out.

Pure functions over plain values (no session, no IO, no clock).  The
refresh ladder, most urgent first:

  - ``repair``       quarantine records exist: rebuild the damaged
                     buckets from the recorded snapshot
  - ``full``         churn at or past the full-churn ratio, or deletes
                     or rewrites without lineage
  - ``incremental``  deletes or rewrites with lineage (without the CDC
                     rung, or past its merge-debt budget), or appends
                     past the quick budget
  - ``quick``        small appends with hybrid scan on, and with CDC
                     merge-on-read also deletes and rewrites while the
                     merge debt stays within its ratio
  - ``none``         nothing changed (journaled all the same)

``decide_advisor`` ranks the advisor's create and delete decisions under
the byte budget.  The reason strings are the JAX package's, character for
character: the journal keeps them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Set

from hyperspace_tpu_torch.lifecycle.change_detector import ChangeSummary

# Decision kinds the daemon knows how to execute.
KIND_NONE = "none"
KIND_REFRESH = "refresh"
KIND_REPAIR = "repair"
KIND_CREATE = "create"
KIND_DELETE = "delete"
KIND_OPTIMIZE = "optimize"


@dataclasses.dataclass(frozen=True)
class MaintenanceDecision:
    """One policy outcome; ``kind=none`` decisions are journaled too."""

    kind: str
    index: str = ""
    mode: str = ""    # refresh mode for kind=refresh/repair
    reason: str = ""

    def to_dict(self) -> dict:
        return {"kind": self.kind, "index": self.index,
                "mode": self.mode, "reason": self.reason}


def decide_refresh(change: ChangeSummary, *, quarantined: int,
                   lineage: bool, hybrid_scan: bool,
                   quick_append_ratio: float,
                   full_churn_ratio: float,
                   cdc_merge_on_read: bool = False,
                   merge_debt_ratio: float = 0.2) -> MaintenanceDecision:
    """The per-index decision for one detection pass.

    With ``cdc_merge_on_read`` (``conf.lifecycle_cdc_enabled``),
    row-level deletes/mutations with lineage + hybrid scan take the
    metadata-only quick refresh too — the hybrid rule applies the
    delete overlay at scan time, bit-equal to a rebuild — until the
    accumulated merge debt outgrows ``merge_debt_ratio`` of the
    recorded source bytes, when the real incremental refresh runs.
    """
    name = change.index
    if quarantined > 0:
        return MaintenanceDecision(
            KIND_REPAIR, name, mode="repair",
            reason=f"{quarantined} quarantined index file(s); rebuilding "
                   f"damaged buckets from the recorded snapshot")
    over_debt = change.append_ratio > quick_append_ratio
    cdc_over_debt = cdc_merge_on_read \
        and change.merge_debt_ratio > merge_debt_ratio
    if not change.changed and not over_debt and not cdc_over_debt:
        if change.hybrid_debt_bytes + change.merge_debt_bytes > 0:
            return MaintenanceDecision(
                KIND_NONE, name,
                reason=f"no new source changes; "
                       f"{change.hybrid_debt_bytes + change.merge_debt_bytes}"
                       f" pending bytes within "
                       f"the hybrid-scan debt budget")
        return MaintenanceDecision(KIND_NONE, name,
                                   reason="source unchanged")
    if change.churn_ratio >= full_churn_ratio:
        return MaintenanceDecision(
            KIND_REFRESH, name, mode="full",
            reason=f"churn ratio {change.churn_ratio:.2f} >= "
                   f"{full_churn_ratio:.2f}: full rebuild is cheaper "
                   f"than an incremental pass over most of the index")
    if change.deleted or change.mutated:
        if not lineage:
            return MaintenanceDecision(
                KIND_REFRESH, name, mode="full",
                reason=f"{change.deleted} deleted / {change.mutated} "
                       f"mutated file(s) without lineage: incremental "
                       f"refresh cannot exclude their rows")
        if cdc_merge_on_read and hybrid_scan and not cdc_over_debt:
            # CDC merge-on-read: record the overlay metadata-only; the
            # hybrid rule merges it at scan time (bit-equal).
            return MaintenanceDecision(
                KIND_REFRESH, name, mode="quick",
                reason=f"CDC merge-on-read: {change.appended} appended / "
                       f"{change.deleted} deleted / {change.mutated} "
                       f"mutated file(s) recorded as merge debt (ratio "
                       f"{change.merge_debt_ratio:.3f} <= "
                       f"{merge_debt_ratio:.3f}); hybrid scan applies "
                       f"the overlay at query time")
        return MaintenanceDecision(
            KIND_REFRESH, name, mode="incremental",
            reason=f"{change.appended} appended / {change.deleted} "
                   f"deleted / {change.mutated} mutated file(s)"
                   + (f"; merge debt ratio {change.merge_debt_ratio:.3f}"
                      f" > {merge_debt_ratio:.3f}" if cdc_over_debt
                      else ""))
    # Appends only from here.
    if hybrid_scan and not over_debt and not cdc_over_debt:
        return MaintenanceDecision(
            KIND_REFRESH, name, mode="quick",
            reason=f"{change.appended} small appended file(s) "
                   f"(append ratio {change.append_ratio:.3f} <= "
                   f"{quick_append_ratio:.3f}): metadata-only, hybrid "
                   f"scan serves them from source")
    if cdc_over_debt and not change.changed:
        # Nothing new, but the CARRIED overlay outgrew the budget: the
        # incremental refresh exists to clear it.
        return MaintenanceDecision(
            KIND_REFRESH, name, mode="incremental",
            reason=f"no new source changes, but accumulated merge debt "
                   f"ratio {change.merge_debt_ratio:.3f} > "
                   f"{merge_debt_ratio:.3f}: incremental refresh clears "
                   f"the scan-time overlay")
    return MaintenanceDecision(
        KIND_REFRESH, name, mode="incremental",
        reason=(f"{change.appended} appended file(s) "
                f"({change.appended_bytes + change.hybrid_debt_bytes} "
                f"bytes beyond the quick budget)"
                if over_debt or not hybrid_scan else "appended files")
        + (f"; merge debt ratio {change.merge_debt_ratio:.3f} > "
           f"{merge_debt_ratio:.3f}" if cdc_over_debt else ""))


@dataclasses.dataclass(frozen=True)
class AdvisorInputs:
    """The impure-world snapshot :func:`decide_advisor` ranks over —
    the daemon gathers it, tests fabricate it."""

    byte_budget: int
    index_bytes: Dict[str, int]          # ACTIVE index -> on-disk bytes
    cold_indexes: Sequence[str]          # no captured-workload support
    # (name, est_build_cost_bytes) of advisor candidates, best first,
    # already filtered for "not covered by an existing index".
    candidates: Sequence[tuple] = ()


def decide_advisor(inputs: AdvisorInputs) -> List[MaintenanceDecision]:
    """Create/delete decisions under the byte budget.  Deterministic:
    drop the LARGEST cold index first (fastest route back under
    budget), then admit candidates best-score-first while their
    estimated build size fits."""
    if inputs.byte_budget <= 0:
        return []
    out: List[MaintenanceDecision] = []
    total = sum(inputs.index_bytes.values())
    cold: Set[str] = set(inputs.cold_indexes)
    for name in sorted(cold & set(inputs.index_bytes),
                       key=lambda n: -inputs.index_bytes[n]):
        if total <= inputs.byte_budget:
            break
        size = inputs.index_bytes[name]
        total -= size
        out.append(MaintenanceDecision(
            KIND_DELETE, name,
            reason=f"cold index ({size} bytes) over the "
                   f"{inputs.byte_budget}-byte budget; no captured "
                   f"workload supports it"))
    for name, est_bytes in inputs.candidates:
        est = max(0, int(est_bytes))
        if total + est > inputs.byte_budget:
            continue
        total += est
        out.append(MaintenanceDecision(
            KIND_CREATE, name,
            reason=f"advisor-recommended; est {est} bytes fits the "
                   f"remaining budget"))
    return out
