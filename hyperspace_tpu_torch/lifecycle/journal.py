"""The lifecycle decision journal (counterpart of
hyperspace_tpu/lifecycle/journal.py): every maintenance decision, "did
nothing, here's why" included, durable across restarts and readable from
any process.

Records go through the LogStore seam (io/log_store.py, the class
``conf.log_store_class`` names) under ``<systemPath>/_hyperspace_lifecycle``, one key
``d-<ms>-<pid>-<seq>`` each, at most
``conf.lifecycle_journal_max_entries`` (the oldest pruned), and come back
through ``Hyperspace.lifecycle_history()``.  A record is one flat JSON
object: ``v``, ``ts``, ``cycle``, ``decision``, ``index``, ``mode``,
``reason``, ``outcome`` (``done``, ``noop``, ``skipped``, ``error``),
``wall_s``, the detection counts ``appended``/``deleted``/``mutated`` and
``error`` when one was raised.

``append`` runs inside ``faults.quiet()`` (journal IO never consumes a
fault armed at the system under test) and never raises: a journal
failure must not cost an action its commit.

Appends count in ``lifecycle.journal.appends`` and failures in
``lifecycle.journal.errors``.  Under an object store's listing window
(``conf.object_store_stale_list_ms``) ``records`` shows a record once
the window has passed, and the cap prunes only listed records: nothing
reads the journal to decide, so the lag delays the history only.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

JOURNAL_DIR = "_hyperspace_lifecycle"
RECORD_VERSION = 1

_seq_lock = threading.Lock()
_seq = 0


def journal_root(conf) -> str:
    from hyperspace_tpu_torch.index.manager import system_path_of

    return os.path.join(system_path_of(conf), JOURNAL_DIR)


def _store(conf):
    from hyperspace_tpu_torch.telemetry.perf_ledger import store_for

    return store_for(conf, journal_root(conf))


def _next_key() -> str:
    global _seq
    with _seq_lock:
        _seq += 1
        seq = _seq
    return f"d-{int(time.time() * 1000):013d}-{os.getpid()}-{seq:05d}"


def append(conf, record: Dict[str, Any]) -> Optional[str]:
    """Append one decision record; returns its key, or None on failure.
    Never raises; runs fault-quiet."""
    from hyperspace_tpu_torch.io import faults
    from hyperspace_tpu_torch.telemetry import metrics

    try:
        with faults.quiet():
            store = _store(conf)
            rec = {"v": RECORD_VERSION, "ts": time.time(), **record}
            payload = json.dumps(rec, default=str).encode("utf-8")
            for _ in range(4):
                key = _next_key()
                if store.put_if_absent(key, payload):
                    break
            else:
                metrics.inc("lifecycle.journal.errors")
                return None
            cap = int(conf.lifecycle_journal_max_entries)
            if cap > 0:
                keys = store.list_keys()
                if len(keys) > cap:
                    for old in sorted(keys)[:len(keys) - cap]:
                        store.delete(old)
            metrics.inc("lifecycle.journal.appends")
            return key
    except Exception:  # noqa: BLE001 - journal IO never fails the daemon
        metrics.inc("lifecycle.journal.errors")
        return None


def records(conf) -> List[Dict[str, Any]]:
    """Every parseable record, oldest first, each with its ``key``; torn
    ones are skipped (the journal is advisory data)."""
    from hyperspace_tpu_torch.io import faults

    out: List[Dict[str, Any]] = []
    try:
        with faults.quiet():
            store = _store(conf)
            for key in sorted(store.list_keys()):
                try:
                    rec = json.loads(store.read(key).decode("utf-8"))
                except (FileNotFoundError, ValueError, UnicodeDecodeError):
                    continue
                if not isinstance(rec, dict):
                    continue
                rec["key"] = key
                out.append(rec)
    except Exception:  # noqa: BLE001 - an unreadable journal reads empty
        pass
    return out


def history_table(conf):
    """The journal as a pyarrow table, oldest first
    (``Hyperspace.lifecycle_history``); the whole record rides in
    ``recordJson``."""
    import pyarrow as pa

    recs = records(conf)

    def column(name: str, kind, default, typ):
        return pa.array([kind(r.get(name, default)) for r in recs], type=typ)

    def count(v) -> int:
        return int(v or 0)

    def seconds(v) -> float:
        return float(v or 0.0)

    return pa.table({
        "key": column("key", str, "", pa.string()),
        "ts": column("ts", float, 0.0, pa.float64()),
        "index": column("index", str, "", pa.string()),
        "decision": column("decision", str, "", pa.string()),
        "mode": column("mode", str, "", pa.string()),
        "reason": column("reason", str, "", pa.string()),
        "outcome": column("outcome", str, "", pa.string()),
        "appended": column("appended", count, 0, pa.int64()),
        "deleted": column("deleted", count, 0, pa.int64()),
        "mutated": column("mutated", count, 0, pa.int64()),
        "wallSeconds": column("wall_s", seconds, 0.0, pa.float64()),
        "error": column("error", str, "", pa.string()),
        "recordJson": pa.array([json.dumps(r, default=str) for r in recs],
                               type=pa.string()),
    })


def clear(conf) -> None:
    """Remove every record."""
    from hyperspace_tpu_torch.io import faults

    with faults.quiet():
        store = _store(conf)
        for key in store.list_keys():
            store.delete(key)
