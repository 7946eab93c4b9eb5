"""A flat key -> bytes store with per-key generations and conditional
puts (counterpart of hyperspace_tpu/io/log_store.py).  The operation log
of ``ObjectStoreLogManager`` (index/object_log_manager.py), the
quarantine records of an index (index/quarantine.py), the captured
workload, the lifecycle journal, the maintenance lease, the watch bus,
the perf ledger and the diagnostics bundles each live in one, of the
class ``conf.log_store_class`` names.

  - ``PosixLogStore`` keeps each key as a file in ``root``, its
    generation in a ``<key>.g`` sidecar (``{"g": N, "t": commit time}``),
    and serialises every put and delete with ``flock`` on
    ``root/.lock`` plus an in-process mutex, so a conditional put is
    atomic across processes.  Its listing is strongly consistent.
  - ``EmulatedObjectStore`` (the default) gives object-store semantics
    over the same directory: keys are flat and percent-encoded into file
    names (``/`` is data, not structure), and a listing hides the keys
    committed within the last ``stale_list_s`` seconds while point
    reads and conditional puts stay strong: the eventual listing of an
    object store, which the log protocol must survive.  No rename
    appears in its API; the ``os.replace`` inside ``_commit`` plays the
    store server's atomic commit.

The layout on disk (file names, sidecars, generations) is the JAX
package's, so either package reads what the other wrote with the same
store class.

Every call goes through a fault site (io/faults.py): ``store.put``
(where ``torn`` commits half the payload with a real generation, then
dies, so readers must skip the burned key), ``store.read``,
``store.list`` and ``store.delete``.  The advisor's captured workload
(advisor/workload.py) lives in one too.

Each conditional put is a ``store.put`` span and counts in
``log.store.puts``; a lost compare-and-swap counts in
``log.cas.conflicts`` (telemetry/).
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
import urllib.parse
from typing import List, Optional, Tuple

from hyperspace_tpu_torch.io import faults

try:  # flock arbitrates between processes; without it, within one only
    import fcntl as _fcntl
except ImportError:
    _fcntl = None

_LOCK_NAME = ".lock"
_GEN_SUFFIX = ".g"


class LogStore:
    """Keys with generations: ``generation(key)`` is 0 for an absent key
    and grows with every put to it; the conditional puts are atomic with
    respect to every other mutation of the key; point reads are strongly
    consistent; a listing may lag the puts."""

    def list_keys(self, prefix: str = "") -> List[str]:
        """The keys starting with ``prefix``, sorted; may lag recent
        puts (the stale-list window)."""
        raise NotImplementedError

    def read(self, key: str) -> bytes:
        """The bytes at ``key``; FileNotFoundError when absent."""
        raise NotImplementedError

    def read_with_generation(self, key: str) -> Tuple[Optional[bytes], int]:
        """(bytes or None, generation); generation 0 means absent."""
        raise NotImplementedError

    def generation(self, key: str) -> int:
        raise NotImplementedError

    def exists(self, key: str) -> bool:
        return self.generation(key) > 0

    def put_if_absent(self, key: str, data: bytes) -> bool:
        """Commit ``data`` iff ``key`` does not exist; False otherwise."""
        return self.put_if_generation_match(key, data, 0)

    def put_if_generation_match(self, key: str, data: bytes,
                                expected_generation: int) -> bool:
        """Commit ``data`` iff the key's generation is
        ``expected_generation`` (0: absent); False otherwise."""
        raise NotImplementedError

    def delete(self, key: str) -> None:
        """Remove ``key``; an absent key is a no-op."""
        raise NotImplementedError


class PosixLogStore(LogStore):
    """Keys are files in ``root``; puts and deletes run under ``flock``
    on ``root/.lock``; generations live in ``<key>.g`` sidecars."""

    def __init__(self, root: str, stale_list_s: float = 0.0) -> None:
        self.root = root
        # A posix listing is strongly consistent: the parameter is there
        # so that every store class takes the same constructor.
        self.stale_list_s = 0.0
        self._mutex = threading.Lock()

    def _encode(self, key: str) -> str:
        return key

    def _decode(self, name: str) -> str:
        return name

    def _data_path(self, key: str) -> str:
        return os.path.join(self.root, self._encode(key))

    def _gen_path(self, key: str) -> str:
        return self._data_path(key) + _GEN_SUFFIX

    @contextlib.contextmanager
    def _locked(self):
        """The cross-process critical section: ``flock`` on
        ``root/.lock`` (closing the descriptor releases it)."""
        with self._mutex:
            os.makedirs(self.root, exist_ok=True)
            fd = os.open(os.path.join(self.root, _LOCK_NAME),
                         os.O_CREAT | os.O_RDWR)
            try:
                if _fcntl is not None:
                    _fcntl.flock(fd, _fcntl.LOCK_EX)
                yield
            finally:
                os.close(fd)

    def _meta(self, key: str) -> Tuple[int, float]:
        """(generation, commit time) from the sidecar, (0, 0) when
        absent; a data file without one (a layout from before
        generations) has generation 1, so it stays visible."""
        try:
            with open(self._gen_path(key), "r", encoding="utf-8") as f:
                meta = json.load(f)
            return int(meta["g"]), float(meta.get("t", 0.0))
        except (FileNotFoundError, ValueError, KeyError):
            return (1, 0.0) if os.path.isfile(self._data_path(key)) \
                else (0, 0.0)

    def generation(self, key: str) -> int:
        faults.check("store.read")
        return self._meta(key)[0]

    def read(self, key: str) -> bytes:
        faults.check("store.read")
        with open(self._data_path(key), "rb") as f:
            return f.read()

    def read_with_generation(self, key: str) -> Tuple[Optional[bytes], int]:
        faults.check("store.read")
        gen = self._meta(key)[0]
        if gen == 0:
            return None, 0
        try:
            with open(self._data_path(key), "rb") as f:
                return f.read(), gen
        except FileNotFoundError:
            return None, gen

    def list_keys(self, prefix: str = "") -> List[str]:
        faults.check("store.list")
        if not os.path.isdir(self.root):
            return []
        now = time.time()
        out: List[str] = []
        for name in os.listdir(self.root):
            if name == _LOCK_NAME or name.endswith(_GEN_SUFFIX) \
                    or ".tmp-" in name:
                continue
            key = self._decode(name)
            if prefix and not key.startswith(prefix):
                continue
            if self.stale_list_s > 0.0:
                # The window: a key committed within it is not listed
                # yet; point reads see it.
                t = self._meta(key)[1]
                if t and now - t < self.stale_list_s:
                    continue
            out.append(key)
        return sorted(out)

    def _commit(self, key: str, data: bytes, gen: int) -> None:
        """Install the data, then the generation, each by an atomic
        replace of a temporary file."""
        data_path = self._data_path(key)
        tmp = f"{data_path}.tmp-{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, data_path)
        gen_tmp = f"{self._gen_path(key)}.tmp-{os.getpid()}"
        with open(gen_tmp, "w", encoding="utf-8") as f:
            json.dump({"g": gen, "t": time.time()}, f)
        os.replace(gen_tmp, self._gen_path(key))

    def put_if_generation_match(self, key: str, data: bytes,
                                expected_generation: int) -> bool:
        from hyperspace_tpu_torch.telemetry import metrics
        from hyperspace_tpu_torch.telemetry.trace import span

        kind = faults.fire("store.put")  # enospc, eio, crash raise here
        with span("store.put", key=key) as sp, self._locked():
            metrics.inc("log.store.puts")
            cur = self._meta(key)[0]
            if cur != int(expected_generation):
                # Another writer moved the key's generation first.
                metrics.inc("log.cas.conflicts")
                sp.set(outcome="conflict")
                return False
            sp.set(outcome="committed", bytes=len(data))
            if kind == "torn":
                # The store accepted a partial upload: half the payload
                # commits with a real generation, then the writer dies.
                self._commit(key, data[:max(1, len(data) // 2)], cur + 1)
                raise faults.InjectedCrash(f"injected torn put of {key!r}")
            self._commit(key, data, cur + 1)
            return True

    def delete(self, key: str) -> None:
        faults.check("store.delete")
        with self._locked():
            for path in (self._data_path(key), self._gen_path(key)):
                try:
                    os.unlink(path)
                except FileNotFoundError:
                    pass


def store_from_conf(conf, root: str) -> LogStore:
    """A store of the class ``conf.log_store_class`` rooted at ``root``,
    with the window ``conf.object_store_stale_list_ms``.  A class that
    does not load raises ``HyperspaceError``."""
    from hyperspace_tpu_torch.exceptions import HyperspaceError
    from hyperspace_tpu_torch.utils.reflection import load_class

    cls = load_class(conf.log_store_class, LogStore, HyperspaceError)
    return cls(root, stale_list_s=float(
        conf.object_store_stale_list_ms) / 1000.0)


class EmulatedObjectStore(PosixLogStore):
    """Object-store semantics over a local directory: flat
    percent-encoded keys, per-key generations, conditional puts, and a
    listing that hides the keys committed within ``stale_list_s``
    (``conf.object_store_stale_list_ms``; 0 lists every key)."""

    def __init__(self, root: str, stale_list_s: float = 0.0) -> None:
        super().__init__(root)
        self.stale_list_s = float(stale_list_s)

    def _encode(self, key: str) -> str:
        return urllib.parse.quote(key, safe="")

    def _decode(self, name: str) -> str:
        return urllib.parse.unquote(name)
