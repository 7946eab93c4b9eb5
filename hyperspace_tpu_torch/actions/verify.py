"""VerifyIndexAction: scrub an index's data files against its log entry
(counterpart of hyperspace_tpu/actions/verify.py).

  - ``quick``: every file the latest stable entry references must exist
    with its recorded size and mtime; stat calls only, no data read.
  - ``full``: quick, then each file read again and hashed against the
    content digest recorded when it was written (io/integrity.py),
    which catches bit rot that keeps size and mtime.  A file without a
    digest reports "unknown", never a mismatch.

A scrub writes no log entry, so it runs against a live index from any
process.  Its one mutation is the quarantine (index/quarantine.py): a
damaged file is quarantined (idempotently); a full pass releases a
quarantined file that verifies clean and drops the records of files no
current entry references.  The per-file report comes back as an arrow
table (file, status, detail, quarantined), and each pass emits an
``IndexScrubEvent`` (files checked and flagged; the ``scrub.*``
counters).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

from hyperspace_tpu_torch.exceptions import HyperspaceError
from hyperspace_tpu_torch.index.data_manager import IndexDataManager
from hyperspace_tpu_torch.index.log_entry import IndexLogEntry
from hyperspace_tpu_torch.index.log_manager import IndexLogManager
from hyperspace_tpu_torch.index.quarantine import QuarantineManager
from hyperspace_tpu_torch.io import integrity
from hyperspace_tpu_torch.telemetry.events import IndexScrubEvent, emit_event

STATUS_OK = "ok"
STATUS_UNKNOWN = "unknown"          # no digest to check (full mode)
STATUS_MISSING = "missing"
STATUS_SIZE_MISMATCH = "size-mismatch"
# Reported, not quarantined: copies and restores touch mtimes, and the
# digest is what full mode checks.
STATUS_MTIME_DRIFT = "mtime-drift"
STATUS_DIGEST_MISMATCH = "digest-mismatch"
STATUS_UNREADABLE = "unreadable"

# The statuses that quarantine a file.
_FLAGGED = frozenset({STATUS_MISSING, STATUS_SIZE_MISMATCH,
                      STATUS_DIGEST_MISMATCH, STATUS_UNREADABLE})


class VerifyIndexAction:
    def __init__(self, log_manager: IndexLogManager,
                 data_manager: IndexDataManager,
                 quarantine: QuarantineManager,
                 mode: str = "quick") -> None:
        if mode not in ("quick", "full"):
            raise HyperspaceError(f"Unknown verify mode {mode!r}")
        self.log_manager = log_manager
        self.data_manager = data_manager
        self.quarantine = quarantine
        self.mode = mode

    def _check_file(self, f) -> Dict[str, str]:
        try:
            st = os.stat(f.name)
        except FileNotFoundError:
            return {"status": STATUS_MISSING, "detail": "file not found"}
        except OSError as e:
            return {"status": STATUS_UNREADABLE, "detail": str(e)}
        if st.st_size != f.size:
            return {"status": STATUS_SIZE_MISMATCH,
                    "detail": f"size {st.st_size} != recorded {f.size}"}
        drift = int(st.st_mtime_ns) != f.mtime
        if self.mode == "quick":
            if drift:
                return {"status": STATUS_MTIME_DRIFT,
                        "detail": f"mtime {st.st_mtime_ns} != recorded "
                                  f"{f.mtime}"}
            return {"status": STATUS_OK, "detail": ""}
        if f.digest is None:
            return {"status": STATUS_UNKNOWN,
                    "detail": "no digest recorded (pre-integrity entry or "
                              "digestOnWrite off)"}
        try:
            verdict = integrity.verify_file(f.name, f.digest)
        except OSError as e:
            return {"status": STATUS_UNREADABLE, "detail": str(e)}
        if verdict is None:
            return {"status": STATUS_UNKNOWN,
                    "detail": f"digest algorithm unavailable: {f.digest}"}
        if not verdict:
            return {"status": STATUS_DIGEST_MISMATCH,
                    "detail": f"content does not match {f.digest}"
                              + (" (mtime drifted too)" if drift else "")}
        if drift:
            return {"status": STATUS_MTIME_DRIFT,
                    "detail": "content verified; only mtime drifted"}
        return {"status": STATUS_OK, "detail": ""}

    def run(self):
        import pyarrow as pa

        entry: Optional[IndexLogEntry] = \
            self.log_manager.get_latest_stable_log()
        if entry is None:
            raise HyperspaceError(
                "verify_index: index does not exist (no stable log entry)")
        infos = entry.content.file_infos()
        already = self.quarantine.paths([f.name for f in infos])
        rows: List[Dict] = []
        referenced = set()
        flagged = 0
        for f in infos:
            referenced.add(f.name)
            res = self._check_file(f)
            status = res["status"]
            quarantined = f.name in already
            if status in _FLAGGED:
                flagged += 1
                if not quarantined:
                    self.quarantine.add(f.name, f"scrub[{self.mode}]: "
                                                f"{status}", size=f.size)
                quarantined = True
            elif quarantined and self.mode == "full" \
                    and status in (STATUS_OK, STATUS_MTIME_DRIFT):
                # Its bytes verified end to end (restored from a copy,
                # say): release it.  Quick mode never releases, as it
                # read no byte.
                self.quarantine.remove(f.name)
                quarantined = False
            rows.append({"file": f.name, "status": status,
                         "detail": res["detail"],
                         "quarantined": quarantined})
        if self.mode == "full":
            # Records of files no current entry references (a repair or
            # an optimize replaced them): harmless to the rules, which
            # intersect with the entry's content, but noise in reports.
            for stale in already - referenced:
                self.quarantine.remove(stale)
        emit_event(IndexScrubEvent(
            index_name=entry.name, mode=self.mode,
            files_checked=len(infos), files_flagged=flagged,
            message=f"scrub[{self.mode}] {entry.name}: "
                    f"{flagged}/{len(infos)} flagged"))
        return pa.table({
            "file": pa.array([r["file"] for r in rows], type=pa.string()),
            "status": pa.array([r["status"] for r in rows],
                               type=pa.string()),
            "detail": pa.array([r["detail"] for r in rows],
                               type=pa.string()),
            "quarantined": pa.array([r["quarantined"] for r in rows],
                                    type=pa.bool_()),
        })
