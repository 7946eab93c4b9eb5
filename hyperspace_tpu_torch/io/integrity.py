"""Content digests of index data files: the detection layer of the
integrity loop (detect, quarantine, serve degraded, repair).
Counterpart of hyperspace_tpu/io/integrity.py.

  - every index data file the writers land (``io/parquet.write_bucketed``
    and ``write_bucket_run``: create, refresh, optimize and repair) and
    every data-skipping sketch is hashed as it lands, and the digest is
    recorded here;
  - ``index/log_entry.Directory._scan`` picks the recorded digest up when
    an action builds its content tree, so the committed ``FileInfo``
    carries ``digest`` beside (size, mtime);
  - ``actions/verify.VerifyIndexAction`` hashes the files again on demand
    and quarantines a mismatch (``index/quarantine.py``).

A digest reads ``"<algo>:<hex>"``: ``xxh64`` where the ``xxhash`` module
imports, ``blake2b16`` (8-byte blake2b, stdlib) otherwise.  A scrub
hashes with the algorithm the writer used, so digests written by either
package, on any machine, verify in the other; one whose algorithm this
machine cannot run scrubs as "unknown", never as a mismatch.

The recorder is a process-wide map (absolute path -> digest), bounded to
``_MAX_RECORDED`` entries (LRU): the writer threads and the content-tree
builder are separated by the action layer and a thread pool.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Optional

try:
    import xxhash as _xxhash
except ImportError:  # the stdlib algorithm below serves instead
    _xxhash = None

_CHUNK = 1 << 20  # bytes hashed per read
_MAX_RECORDED = 8192


def _xxh64_hasher():
    return _xxhash.xxh64()


def _blake2b16_hasher():
    import hashlib

    return hashlib.blake2b(digest_size=8)


# algo name -> hasher factory (objects with update / hexdigest).
_ALGOS = {}
if _xxhash is not None:
    _ALGOS["xxh64"] = _xxh64_hasher
_ALGOS["blake2b16"] = _blake2b16_hasher

DEFAULT_ALGO = "xxh64" if _xxhash is not None else "blake2b16"


def digest_bytes(data: bytes, algo: Optional[str] = None) -> str:
    algo = algo or DEFAULT_ALGO
    h = _ALGOS[algo]()
    h.update(data)
    return f"{algo}:{h.hexdigest()}"


def digest_file(path: str, algo: Optional[str] = None) -> str:
    """The digest of ``path``, read in ``_CHUNK`` pieces."""
    algo = algo or DEFAULT_ALGO
    h = _ALGOS[algo]()
    with open(path, "rb") as f:
        while True:
            chunk = f.read(_CHUNK)
            if not chunk:
                break
            h.update(chunk)
    return f"{algo}:{h.hexdigest()}"


def verify_file(path: str, expected: str) -> Optional[bool]:
    """Whether ``path`` still has the digest ``expected``; None when
    ``expected`` names an algorithm this machine cannot run."""
    algo = expected.split(":", 1)[0] if ":" in expected else ""
    if algo not in _ALGOS:
        return None
    return digest_file(path, algo) == expected


# ---------------------------------------------------------------------------
# the write-site recorder
# ---------------------------------------------------------------------------
_enabled = True
_recorded: "OrderedDict[str, str]" = OrderedDict()
_lock = threading.Lock()


def configure_from_conf(conf) -> None:
    """Apply ``conf.integrity_digest_on_write``; the actions call this
    before they write, so the conf of the session that writes wins."""
    set_enabled(bool(getattr(conf, "integrity_digest_on_write", True)))


def set_enabled(enabled: bool) -> None:
    global _enabled
    _enabled = bool(enabled)


def record_file(path: str) -> Optional[str]:
    """Hash the file just written at ``path`` and remember its digest for
    the content-tree builder; None, and nothing read, when digest on
    write is off."""
    if not _enabled:
        return None
    digest = digest_file(path)
    key = os.path.abspath(path)
    with _lock:
        _recorded[key] = digest
        _recorded.move_to_end(key)
        while len(_recorded) > _MAX_RECORDED:
            _recorded.popitem(last=False)
    return digest


def recorded_digest(path: str) -> Optional[str]:
    """The digest recorded for ``path`` when it was written, if any
    (source files are never recorded)."""
    with _lock:
        return _recorded.get(os.path.abspath(path))


def clear_recorded() -> None:
    with _lock:
        _recorded.clear()
