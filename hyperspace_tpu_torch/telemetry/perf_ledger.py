"""The persistent perf ledger: a durable record of every action run
(counterpart of hyperspace_tpu/telemetry/perf_ledger.py).

Every action appends one compact JSON record through the store of
``conf.log_store_class`` (io/log_store.py) under
``<systemPath>/_hyperspace_perf``, which survives restarts and is read by
``Hyperspace.perf_history()``.  The record layout and ``RECORD_VERSION``
are the JAX package's, so either package reads the other's ledger when
both name the same store class:

  - ``kind``: ``"action"`` or ``"bench"``
  - ``name``: action class and index, or bench section name
  - ``ts`` / ``wall_s`` / ``outcome``
  - ``phases_s`` and the byte counters (the BuildReport serialization)
  - ``fingerprint``: host, Python, torch and CUDA versions, the device
    name and pyarrow's version, and the build-relevant conf fields, so a
    diff across records can tell a regression from a changed
    environment.

Keys are ``r-<epoch_ms>-<pid>-<seq>``: they sort chronologically and
``put_if_absent`` arbitrates collisions.  The ledger is bounded
(``conf.perf_ledger_max_entries``): appends past the cap delete the
oldest records.  Appends run inside ``faults.quiet()`` (diagnostic IO
never spends an injected fault aimed at the system under test) and never
raise: a ledger failure must not cost an action its commit.
``conf.perf_ledger_enabled`` (on by default) turns it off.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

PERF_DIR = "_hyperspace_perf"
RECORD_VERSION = 1

_seq_lock = threading.Lock()
_seq = 0


def perf_root(conf) -> str:
    from hyperspace_tpu_torch.index.manager import system_path_of

    return os.path.join(system_path_of(conf), PERF_DIR)


def store_for(conf, root: Optional[str] = None):
    """A store of the class ``conf.log_store_class``, with its window,
    rooted at ``root`` or else the perf directory.  The journal, the
    lease, the watch bus and the diagnostics bundles reach their stores
    through here."""
    from hyperspace_tpu_torch.io.log_store import store_from_conf

    return store_from_conf(conf, root if root is not None
                           else perf_root(conf))


def enabled(conf) -> bool:
    return bool(getattr(conf, "perf_ledger_enabled", True))


def fingerprint(conf) -> Dict[str, Any]:
    """Environment and build-relevant conf, for diffing runs like with
    like.  Never raises; missing pieces are left out."""
    fp: Dict[str, Any] = {}
    try:
        import platform

        import torch

        fp["host"] = platform.node()
        fp["python"] = platform.python_version()
        fp["torch"] = torch.__version__
        fp["cuda"] = torch.version.cuda
        if torch.cuda.is_available():
            fp["platform"] = "gpu"
            fp["device_name"] = torch.cuda.get_device_name(0)
        else:
            fp["platform"] = "cpu"
        import pyarrow

        fp["pyarrow"] = pyarrow.__version__
    except Exception:  # noqa: BLE001
        pass
    for knob in ("num_buckets", "device_batch_rows",
                 "index_file_compression", "index_max_rows_per_file"):
        try:
            fp[knob] = getattr(conf, knob)
        except Exception:  # noqa: BLE001
            pass
    return fp


def _next_key() -> str:
    global _seq
    with _seq_lock:
        _seq += 1
        seq = _seq
    return f"r-{int(time.time() * 1000):013d}-{os.getpid()}-{seq:05d}"


def append(conf, record: Dict[str, Any]) -> Optional[str]:
    """Append one record; returns its key, or None when disabled/failed.
    Never raises (see module docstring); InjectedCrash cannot originate
    here — the whole append runs fault-quiet."""
    from hyperspace_tpu_torch.io import faults
    from hyperspace_tpu_torch.telemetry import metrics

    if not enabled(conf):
        return None
    try:
        with faults.quiet():
            store = store_for(conf)
            rec = {"v": RECORD_VERSION, "ts": time.time(), **record}
            payload = json.dumps(rec, default=str).encode("utf-8")
            key = None
            for _ in range(4):
                key = _next_key()
                if store.put_if_absent(key, payload):
                    break
            else:
                metrics.inc("perf.ledger.errors")
                return None
            cap = int(getattr(conf, "perf_ledger_max_entries", 2048))
            if cap > 0:
                keys = store.list_keys()
                if len(keys) > cap:
                    for old in sorted(keys)[:len(keys) - cap]:
                        store.delete(old)
            metrics.inc("perf.ledger.appends")
            return key
    except Exception:  # noqa: BLE001 — diagnostic IO never fails callers
        metrics.inc("perf.ledger.errors")
        return None


def records(conf, root: Optional[str] = None) -> List[Dict[str, Any]]:
    """Every parseable ledger record, oldest first.  Torn/unparseable
    records are skipped — the ledger is advisory data."""
    from hyperspace_tpu_torch.io import faults

    out: List[Dict[str, Any]] = []
    try:
        with faults.quiet():
            store = store_for(conf, root)
            for key in sorted(store.list_keys()):
                try:
                    rec = json.loads(store.read(key).decode("utf-8"))
                except (FileNotFoundError, ValueError, UnicodeDecodeError):
                    continue
                if not isinstance(rec, dict):
                    continue
                rec["key"] = key
                out.append(rec)
    except Exception:  # noqa: BLE001 — an unreadable ledger reads empty
        pass
    return out


def filtered_records(conf, root: Optional[str] = None,
                     index: Optional[str] = None,
                     section: Optional[str] = None,
                     limit: Optional[int] = None) -> List[Dict[str, Any]]:
    """Ledger records with the ``perf_history`` ergonomics filters
    applied: ``index`` keeps action records for that index (the
    ``Action(index)`` naming or the serialized ``index`` field),
    ``section`` keeps bench records for that section name, ``limit``
    keeps the most recent N after filtering."""
    out = records(conf, root)
    if index:
        out = [r for r in out
               if r.get("index") == index
               or str(r.get("name", "")).endswith(f"({index})")]
    if section:
        out = [r for r in out
               if r.get("kind") == "bench"
               and r.get("name") == section]
    if limit is not None and limit >= 0:
        out = out[-int(limit):] if limit else []
    return out


def history_table(conf, root: Optional[str] = None,
                  index: Optional[str] = None,
                  section: Optional[str] = None,
                  limit: Optional[int] = None):
    """The ledger as an arrow table, one row per record (what
    ``Hyperspace.perf_history()`` returns, with the ``index``, ``section``
    and ``limit`` filters passed through).  Structured sub-objects ride
    as JSON strings, so the schema stays flat."""
    import pyarrow as pa

    rows = {"key": [], "kind": [], "name": [], "ts": [], "wallSeconds": [],
            "outcome": [], "phasesJson": [], "bytesWritten": [],
            "spillBytes": [], "recordJson": []}
    for rec in filtered_records(conf, root, index=index, section=section,
                                limit=limit):
        rows["key"].append(rec.get("key", ""))
        rows["kind"].append(str(rec.get("kind", "")))
        rows["name"].append(str(rec.get("name", "")))
        rows["ts"].append(float(rec.get("ts", 0.0)))
        rows["wallSeconds"].append(float(rec.get("wall_s", 0.0) or 0.0))
        rows["outcome"].append(str(rec.get("outcome", "")))
        rows["phasesJson"].append(json.dumps(rec.get("phases_s", {})))
        rows["bytesWritten"].append(int(rec.get("bytes_written", 0) or 0))
        rows["spillBytes"].append(int(rec.get("spill_bytes", 0) or 0))
        rows["recordJson"].append(json.dumps(rec, default=str))
    return pa.table({
        "key": pa.array(rows["key"], type=pa.string()),
        "kind": pa.array(rows["kind"], type=pa.string()),
        "name": pa.array(rows["name"], type=pa.string()),
        "ts": pa.array(rows["ts"], type=pa.float64()),
        "wallSeconds": pa.array(rows["wallSeconds"], type=pa.float64()),
        "outcome": pa.array(rows["outcome"], type=pa.string()),
        "phasesJson": pa.array(rows["phasesJson"], type=pa.string()),
        "bytesWritten": pa.array(rows["bytesWritten"], type=pa.int64()),
        "spillBytes": pa.array(rows["spillBytes"], type=pa.int64()),
        "recordJson": pa.array(rows["recordJson"], type=pa.string()),
    })


def clear(conf) -> None:
    """Wipe the ledger (tests)."""
    from hyperspace_tpu_torch.io import faults

    with faults.quiet():
        store = store_for(conf)
        for key in store.list_keys():
            store.delete(key)
