"""Explain: the plans with and without indexes, side by side, the
differing subtrees highlighted (counterpart of
hyperspace_tpu/plananalysis/explain.py).

The plan is optimized twice, with the index rules on and off; the two
trees are compared top down, and once two nodes differ their whole
subtrees are highlighted.  Then the indexes used, with their locations,
and in verbose mode the physical-operator counts of both plans
(plananalysis/physical.py), each scan's files and bytes, the optimizer's
decisions from a run report around the with-indexes pass, and the
session's last run report.  Output goes through the display modes
(plananalysis/display.py).
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

from hyperspace_tpu_torch.plan.nodes import LogicalPlan
from hyperspace_tpu_torch.plananalysis.display import (
    BufferStream,
    get_display_mode,
)
from hyperspace_tpu_torch.plananalysis.physical import physical_operators
from hyperspace_tpu_torch.telemetry import report as run_report

# (text, highlighted) per rendered plan line.
_Line = Tuple[str, bool]


def _used_indexes(plan: LogicalPlan) -> List[str]:
    used = {s.relation.index_scan_of for s in plan.leaf_relations()
            if s.relation.index_scan_of}
    used |= {s.relation.data_skipping_of for s in plan.leaf_relations()
             if s.relation.data_skipping_of}
    return sorted(used)


def _subtree_lines(node: LogicalPlan, indent: int,
                   highlighted: bool) -> List[_Line]:
    lines = [("  " * indent + node.simple_string(), highlighted)]
    for c in node.children:
        lines.extend(_subtree_lines(c, indent + 1, highlighted))
    return lines


def _diff_lines(a: Optional[LogicalPlan], b: Optional[LogicalPlan],
                indent: int = 0) -> Tuple[List[_Line], List[_Line]]:
    """Render both trees, highlighting differing subtrees: once two nodes
    differ, their whole subtrees are highlighted."""
    if a is None and b is None:
        return [], []
    if a is None or b is None or a.simple_string() != b.simple_string() \
            or len(a.children) != len(b.children):
        return (_subtree_lines(a, indent, True) if a else [],
                _subtree_lines(b, indent, True) if b else [])
    out_a = [("  " * indent + a.simple_string(), False)]
    out_b = [("  " * indent + b.simple_string(), False)]
    for ca, cb in zip(a.children, b.children):
        la, lb = _diff_lines(ca, cb, indent + 1)
        out_a.extend(la)
        out_b.extend(lb)
    return out_a, out_b


def _write_plan(stream: BufferStream, lines: List[_Line]) -> None:
    for text, highlighted in lines:
        if highlighted:
            stream.highlight(text)
            stream.write_line()
        else:
            stream.write_line(text)


def _build_header(stream: BufferStream, title: str) -> None:
    bar = "=" * 64
    stream.write_line(bar).write_line(title).write_line(bar)


def explain_string(dataset, session, verbose: bool = False) -> str:
    """The explain text of ``dataset``; the session's enabled state is
    restored afterwards."""
    was_enabled = session.is_hyperspace_enabled()
    try:
        session.enable_hyperspace()
        token = run_report.start()
        try:
            plan_with = session.optimize(dataset.plan)
        finally:
            optimize_report = run_report.finish(token)
        session.disable_hyperspace()
        # Column pruning and pushdown still run without the index rules.
        plan_without = session.optimize(dataset.plan)
    finally:
        if was_enabled:
            session.enable_hyperspace()
        else:
            session.disable_hyperspace()

    mode = get_display_mode(session.conf)
    stream = BufferStream(mode)
    lines_with, lines_without = _diff_lines(plan_with, plan_without)

    _build_header(stream, "Plan with indexes:")
    _write_plan(stream, lines_with)
    stream.write_line()

    _build_header(stream, "Plan without indexes:")
    _write_plan(stream, lines_without)
    stream.write_line()

    _build_header(stream, "Indexes used:")
    used = _used_indexes(plan_with)
    if used:
        mgr = session.index_collection_manager
        for name in used:
            entry = mgr.get_index(name)
            location = ""
            if entry is not None:
                files = entry.content.file_infos()
                if files:
                    location = os.path.dirname(files[0].name)
            stream.write_line(f"{name}:{location}")
    else:
        stream.write_line("(none)")
    stream.write_line()

    if verbose:
        _build_header(stream, "Physical operator stats:")
        with_counts, with_details = physical_operators(session, plan_with)
        without_counts, without_details = physical_operators(
            session, plan_without)
        ops = sorted(set(with_counts) | set(without_counts))
        stream.write_line(
            f"{'Physical Operator':<24}{'Hyperspace Disabled':>22}"
            f"{'Enabled':>10}{'Diff':>8}")
        for op in ops:
            a, b = without_counts.get(op, 0), with_counts.get(op, 0)
            stream.write_line(f"{op:<24}{a:>22}{b:>10}{b - a:>+8}")
        stream.write_line()
        _build_header(stream, "Scan IO (with indexes):")
        for line in with_details:
            stream.write_line(line)
        _build_header(stream, "Scan IO (without indexes):")
        for line in without_details:
            stream.write_line(line)
        stream.write_line()
        _build_header(stream, "Optimizer decisions:")
        stream.write_line(
            "indexes considered: "
            + (", ".join(optimize_report.indexes_considered) or "(none)"))
        stream.write_line(
            "indexes used:       "
            + (", ".join(optimize_report.indexes_used) or "(none)"))
        skipped = optimize_report.skipped_indexes()
        if skipped:
            stream.write_line("indexes skipped:    " + ", ".join(skipped))
        for d in optimize_report.rules():
            state = "applied" if d.get("applied") else "no match"
            stream.write_line(f"rule {d.get('rule')}: {state}")
        stream.write_line()
        last = session.last_run_report_value
        if last is not None:
            _build_header(stream, "Last run report:")
            for line in last.render().splitlines():
                stream.write_line(line)
            stream.write_line()
    return stream.with_tag()
