"""Hypothetical indexes and what-if planning: plan as if an index existed
(counterpart of hyperspace_tpu/advisor/hypothetical.py).

A hypothetical entry is an ACTIVE-looking ``IndexLogEntry`` with no data
file and the ``hypothetical`` property set.  Its source snapshot and
signature are the live relation's, so the rewrite rules match it exactly
as they would a built index: the what-if answer is the real optimizer's.
Three guards keep what-if entries out of real execution: the log refuses
to persist one (index/log_manager.py), ``session.optimize`` considers
them only when passed through its ``hypothetical=`` channel, and the
executor refuses any plan with a hypothetical scan.

What-if never executes a plan and never writes a file: it optimizes the
query without and with the entries, and estimates the bytes each plan
would scan from recorded file sizes (a real index's files; a
hypothetical one's source bytes times its share of the columns).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

from hyperspace_tpu_torch.exceptions import HyperspaceError
from hyperspace_tpu_torch.index.index_config import IndexConfig
from hyperspace_tpu_torch.index.log_entry import (
    HYPOTHETICAL_PROPERTY,
    Content,
    CoveringIndex,
    Directory,
    FileIdTracker,
    IndexLogEntry,
    LogicalPlanFingerprint,
    Signature,
    Source,
    States,
)
from hyperspace_tpu_torch.plan.nodes import LogicalPlan, Scan
from hyperspace_tpu_torch.telemetry import metrics
from hyperspace_tpu_torch.telemetry.trace import span
from hyperspace_tpu_torch.utils.resolver import resolve_or_raise


def hypothetical_entry(session, dataset_or_plan,
                       config: IndexConfig) -> IndexLogEntry:
    """The what-if entry of ``config`` over the relation of
    ``dataset_or_plan`` (of a join plan, the one relation whose schema
    holds every column of the config)."""
    from hyperspace_tpu_torch.index.signatures import get_provider

    plan = getattr(dataset_or_plan, "plan", dataset_or_plan)
    leaves = [s for s in plan.leaf_relations()
              if s.relation.index_scan_of is None]
    if not leaves:
        raise HyperspaceError("The plan has no source relation to index")
    if len(leaves) > 1:
        wanted = {c.lower() for c in config.indexed_columns
                  + list(config.included_columns)}
        matches = []
        for leaf in leaves:
            try:
                schema = {c.lower() for c in session.schema_of(leaf)}
            except Exception:  # noqa: BLE001 - an unreadable leaf matches
                continue       # no config
            if wanted <= schema:
                matches.append(leaf)
        if len(matches) != 1:
            raise HyperspaceError(
                f"Hypothetical index {config.index_name!r} matches "
                f"{len(matches)} of the plan's {len(leaves)} relations; "
                f"build it from a single-relation dataset instead")
        leaves = matches
    relation = session.source_provider_manager.get_relation(leaves[0])
    schema = relation.schema()
    indexed = resolve_or_raise(config.indexed_columns, schema,
                               "indexed column")
    included = resolve_or_raise(config.included_columns, schema,
                                "included column")
    provider_name = session.conf.signature_provider
    # Sign the bare leaf scan, as create_index over this relation does:
    # candidate selection signs each leaf scan alone.
    value = get_provider(provider_name).signature(
        leaves[0],
        lambda scan: session.source_provider_manager
        .get_relation(scan).all_files())
    if value is None:
        raise HyperspaceError("Could not compute plan signature")
    rel_meta = relation.create_relation_metadata(FileIdTracker())
    return IndexLogEntry(
        name=config.index_name,
        derived_dataset=CoveringIndex(
            indexed_columns=indexed,
            included_columns=included,
            num_buckets=session.conf.num_buckets,
            schema={c: schema[c] for c in indexed + included},
            properties={"layout": getattr(config, "layout",
                                          "lexicographic")},
        ),
        content=Content(Directory("/")),  # no file, by construction
        source=Source(relations=[rel_meta],
                      fingerprint=LogicalPlanFingerprint(
                          [Signature(provider_name, value)])),
        properties={HYPOTHETICAL_PROPERTY: "true", "lineage": "false"},
        state=States.ACTIVE,
    )


def _scan_estimate(session, scan: Scan,
                   hypo_by_name: Dict[str, IndexLogEntry]
                   ) -> Tuple[str, str, float]:
    """(label, kind, estimated bytes) of one leaf scan."""
    from hyperspace_tpu_torch.io.parquet import bucket_id_of_file

    rel = scan.relation
    name = rel.index_scan_of
    if name is not None and rel.hypothetical:
        entry = hypo_by_name.get(name)
        if entry is None:
            return name, "hypothetical-index", 0.0
        src_bytes = sum(f.size for f in entry.source_file_infos())
        width = len(entry.relations[0].schema) or 1
        frac = len(entry.derived_dataset.all_columns) / width
        est = src_bytes * frac
        if rel.prune_to_buckets is not None and entry.num_buckets:
            est *= len(rel.prune_to_buckets) / entry.num_buckets
        return name, "hypothetical-index", est
    if name is not None:
        entry = session.index_collection_manager.get_index(name)
        size_of = {} if entry is None else \
            {f.name: f.size for f in entry.content.file_infos()}
        paths = list(rel.file_paths or size_of)
        if rel.prune_to_buckets is not None:
            wanted = set(rel.prune_to_buckets)
            paths = [p for p in paths
                     if (b := bucket_id_of_file(p)) is None or b in wanted]
        est = 0.0
        for p in paths:
            sz = size_of.get(p)
            if sz is None:
                try:
                    sz = os.path.getsize(p)
                except OSError:
                    sz = 0
            est += sz
        return name, "index", est
    # A source scan, possibly a file subset a sketch kept.
    label = ",".join(rel.root_paths)
    if rel.file_paths is not None:
        est = 0.0
        for p in rel.file_paths:
            try:
                est += os.path.getsize(p)
            except OSError:
                pass
        return label, "source", est
    try:
        files = session.source_provider_manager.get_relation(scan).all_files()
        return label, "source", float(sum(f.size for f in files))
    except Exception:  # noqa: BLE001 - an estimate is advisory
        return label, "source", 0.0


def estimate_plan_bytes(session, plan: LogicalPlan,
                        hypo_by_name: Optional[Dict[str, IndexLogEntry]]
                        = None) -> Tuple[float, List[Dict[str, Any]]]:
    """(estimated bytes scanned in all, one detail row per scan) of a
    plan: the advisor's cost model, shared by what-if and the
    recommender."""
    hypo_by_name = hypo_by_name or {}
    total = 0.0
    detail: List[Dict[str, Any]] = []
    for scan in plan.leaf_relations():
        label, kind, est = _scan_estimate(session, scan, hypo_by_name)
        total += est
        detail.append({"relation": label, "kind": kind,
                       "est_bytes": round(est, 1)})
    return total, detail


@dataclasses.dataclass
class WhatIfReport:
    """What one what-if pass found: the two plans and the estimated
    bytes each scans."""

    hypothetical: List[str]
    hypothetical_used: List[str]
    plan_before: str
    plan_after: str
    est_bytes_before: float
    est_bytes_after: float
    detail_before: List[Dict[str, Any]]
    detail_after: List[Dict[str, Any]]

    @property
    def est_bytes_delta(self) -> float:
        """Positive: the hypothetical indexes would read fewer bytes."""
        return self.est_bytes_before - self.est_bytes_after

    def to_dict(self) -> Dict[str, Any]:
        return {
            "hypothetical": list(self.hypothetical),
            "hypothetical_used": list(self.hypothetical_used),
            "est_bytes_before": round(self.est_bytes_before, 1),
            "est_bytes_after": round(self.est_bytes_after, 1),
            "est_bytes_delta": round(self.est_bytes_delta, 1),
            "detail_before": list(self.detail_before),
            "detail_after": list(self.detail_after),
            "plan_before": self.plan_before,
            "plan_after": self.plan_after,
        }

    def render(self) -> str:
        bar = "=" * 64
        lines = [bar, "What-if: hypothetical indexes "
                 + (", ".join(self.hypothetical) or "(none)"), bar]
        lines.append("Plan with hypothetical indexes:")
        lines.extend("  " + ln for ln in self.plan_after.splitlines())
        lines.append("")
        lines.append("Plan without:")
        lines.extend("  " + ln for ln in self.plan_before.splitlines())
        lines.append("")
        lines.append(f"Hypothetical indexes used: "
                     f"{', '.join(self.hypothetical_used) or '(none)'}")
        lines.append(f"Estimated bytes scanned: "
                     f"{self.est_bytes_before:,.0f} -> "
                     f"{self.est_bytes_after:,.0f} "
                     f"(delta {self.est_bytes_delta:,.0f})")
        for row in self.detail_after:
            lines.append(f"  scan [{row['kind']}] {row['relation']}: "
                         f"~{row['est_bytes']:,.0f} bytes")
        return "\n".join(lines)


def whatif(session, dataset_or_plan, candidates: Sequence) -> WhatIfReport:
    """Plan ``dataset_or_plan`` as if ``candidates`` (``IndexConfig``s or
    hypothetical entries) were built.  Nothing executes and no file is
    written."""
    plan = getattr(dataset_or_plan, "plan", dataset_or_plan)
    entries: List[IndexLogEntry] = []
    for c in candidates:
        if isinstance(c, IndexLogEntry):
            if not c.is_hypothetical:
                raise HyperspaceError(
                    f"whatif() takes hypothetical entries only; "
                    f"{c.name!r} is not tagged")
            entries.append(c)
        elif isinstance(c, IndexConfig):
            entries.append(hypothetical_entry(session, plan, c))
        else:
            raise HyperspaceError(
                f"whatif() candidates are IndexConfig or hypothetical "
                f"IndexLogEntry, got {type(c).__name__}")
    hypo_by_name = {e.name: e for e in entries}
    with span("advisor.whatif", candidates=len(entries)):
        metrics.inc("advisor.whatif.runs")
        was_enabled = session.is_hyperspace_enabled()
        try:
            session.enable_hyperspace()
            plan_before = session.optimize(plan)
            plan_after = session.optimize(plan, hypothetical=entries)
        finally:
            if not was_enabled:
                session.disable_hyperspace()
        before_total, before_detail = estimate_plan_bytes(session,
                                                          plan_before)
        after_total, after_detail = estimate_plan_bytes(
            session, plan_after, hypo_by_name)
        used = sorted({s.relation.index_scan_of
                       for s in plan_after.leaf_relations()
                       if s.relation.hypothetical
                       and s.relation.index_scan_of})
        return WhatIfReport(
            hypothetical=sorted(hypo_by_name),
            hypothetical_used=used,
            plan_before=plan_before.tree_string(),
            plan_after=plan_after.tree_string(),
            est_bytes_before=before_total,
            est_bytes_after=after_total,
            detail_before=before_detail,
            detail_after=after_detail,
        )
