"""Execution-time containment of damaged index files (counterpart of the
probe in hyperspace_tpu/dataset.py): what ``Dataset.collect`` does when
reading an index file failed.

  - ``is_read_error``: the failures containment takes, ``OSError`` and
    pyarrow's ``ArrowException``; ``is_index_side_error`` the wider set
    the planning-stage degraded fallback takes.  The executor notes such a failure
    only where it reads index files (``Executor.index_read_failures``),
    so a device or kernel error, or any other ``RuntimeError``, never
    counts as one.
  - ``quarantine_damaged_index_files``: a stat, a Parquet footer read
    and, for a file that passes both, a digest check against its entry
    (io/integrity.py) over every index file the failed plan reads; each
    file that fails is quarantined (index/quarantine.py), so the re-plan
    reads its bucket from the source.

pyarrow is imported inside the functions.
"""

from __future__ import annotations

import os
from typing import List

from hyperspace_tpu_torch.io import integrity
from hyperspace_tpu_torch.plan.nodes import LogicalPlan, Scan


def is_read_error(e: BaseException) -> bool:
    import pyarrow as pa

    return isinstance(e, (OSError, pa.ArrowException))


def always_propagates(e: BaseException) -> bool:
    """A passed deadline or a sync-guard violation: errors no cache
    invalidation, containment, fallback or backoff may act on, since
    each would spend more time past the deadline or repeat the
    unattributed read-back."""
    from hyperspace_tpu_torch.exceptions import (
        DeadlineExceededError,
        DeviceSyncError,
    )

    return isinstance(e, (DeadlineExceededError, DeviceSyncError))


def is_index_side_error(e: BaseException) -> bool:
    """The failures the planning-stage degraded fallback takes (a rule
    that raised, an index listing that failed): a read error, a log
    entry's JSON or key decode error, or a ``HyperspaceError``.  A CUDA
    or other torch error, and the kernel loader's ``KernelError``, are
    none of these: no fallback may hide the card.  Nor is an error that
    ``always_propagates``, though both such are ``HyperspaceError``s."""
    import json

    from hyperspace_tpu_torch.exceptions import HyperspaceError

    if always_propagates(e):
        return False
    return is_read_error(e) or isinstance(
        e, (json.JSONDecodeError, UnicodeDecodeError, KeyError,
            HyperspaceError))


def index_scans_of(plan: LogicalPlan) -> List[str]:
    """The names of the indexes ``plan`` reads."""
    return sorted({name for name, _ in _index_scan_files(plan)})


def _index_scan_files(plan: LogicalPlan) -> List:
    """(index name, file paths) per index scan of ``plan``."""
    out: List = []
    if isinstance(plan, Scan) and plan.relation.index_scan_of is not None:
        out.append((plan.relation.index_scan_of,
                    list(plan.relation.file_paths or ())))
    for child in plan.children:
        out.extend(_index_scan_files(child))
    return out


def quarantine_damaged_index_files(session, plan: LogicalPlan) -> List[str]:
    """Probe every index file ``plan`` reads and quarantine the damaged
    ones; returns the files quarantined now (empty: the failure is not
    the index data's)."""
    import pyarrow.parquet as pq

    mgr = session.index_collection_manager
    newly: List[str] = []
    for name, paths in _index_scan_files(plan):
        quarantine = mgr.quarantine_manager(name)
        entry = mgr.get_index(name)
        digest_of = {} if entry is None else \
            {f.name: f.digest for f in entry.content.file_infos()}
        for path in paths:
            reason = None
            try:
                os.stat(path)
            except OSError as err:
                reason = f"stat failed: {err}"
            else:
                try:
                    pq.read_metadata(path)
                except Exception as err:  # noqa: BLE001 - any footer
                    # that does not parse leaves the file unreadable
                    reason = f"unreadable: {err}"
                else:
                    digest = digest_of.get(path)
                    if digest is not None and \
                            integrity.verify_file(path, digest) is False:
                        reason = f"content digest mismatch ({digest})"
            if reason is not None and \
                    quarantine.add(path, f"execution-failure probe: {reason}"):
                newly.append(path)
    return newly
