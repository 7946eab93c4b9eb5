"""Push-based source change detection (counterpart of
hyperspace_tpu/io/watch.py): source mutations become wake events, so the
maintenance daemon runs its next cycle when something changed and
staleness is bounded by event latency, not by
``conf.lifecycle_interval_s``.

Three backends behind one ``SourceWatcher`` (``conf.watch_mode``):

  - ``inotify``: Linux file notification through ctypes on libc (no
    dependency), on each source root's change directory (``_delta_log``
    or ``metadata`` when present, else the root itself);
  - ``store``: object-store notification, emulated over the LogStore
    seam: writers call ``publish`` after a commit, which puts a marker
    under ``<systemPath>/_hyperspace_watch`` (at most ``_MARKER_CAP``,
    the oldest pruned); the watcher lists that small store and emits an
    event per unseen marker;
  - ``poll``: a stat-level fingerprint of each change directory.

``auto`` takes inotify when the kernel offers it, else store.  Events
are debounced (``conf.watch_debounce_ms``): a burst of commits is one
wake.  A backend that cannot start degrades (a forced inotify to poll);
no backend raises out of the watcher.

The bus is a store of the class ``conf.log_store_class`` names.  Under
an object store's listing window (``conf.object_store_stale_list_ms``) a
marker is listed, and so wakes the watcher, once the window has passed:
the watcher keeps the keys it has seen, so a late marker still wakes it
once, and the delay is bounded by the window plus one tick.

Publishes, events, wakes and errors count in ``lifecycle.watch.*``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Dict, List, Optional, Sequence

from hyperspace_tpu_torch.telemetry import metrics

WATCH_DIR = "_hyperspace_watch"
_MARKER_CAP = 256  # notification-bus bound: oldest markers pruned

# inotify constants (linux/inotify.h; stable ABI across architectures).
_IN_MODIFY = 0x00000002
_IN_CLOSE_WRITE = 0x00000008
_IN_MOVED_FROM = 0x00000040
_IN_MOVED_TO = 0x00000080
_IN_CREATE = 0x00000100
_IN_DELETE = 0x00000200
_IN_MASK = (_IN_MODIFY | _IN_CLOSE_WRITE | _IN_MOVED_FROM
            | _IN_MOVED_TO | _IN_CREATE | _IN_DELETE)
_IN_NONBLOCK = 0o4000  # == O_NONBLOCK on Linux


@dataclasses.dataclass(frozen=True)
class WatchEvent:
    """One observed source mutation: which root, what the backend saw."""

    root: str
    detail: str = ""
    ts: float = 0.0


def change_dir(root: str) -> str:
    """The directory a source's mutations funnel through: a lake
    table's commit log when present, the root itself otherwise."""
    for sub in ("_delta_log", "metadata"):
        p = os.path.join(root, sub)
        if os.path.isdir(p):
            return p
    return root


# ---------------------------------------------------------------------------
# The store notification bus (object-store notification, emulated)
# ---------------------------------------------------------------------------
def watch_store_root(conf) -> str:
    from hyperspace_tpu_torch.index.manager import system_path_of

    return os.path.join(system_path_of(conf), WATCH_DIR)


def _store(conf):
    from hyperspace_tpu_torch.telemetry.perf_ledger import store_for

    return store_for(conf, watch_store_root(conf))


_seq_lock = threading.Lock()
_seq = 0


def _next_key() -> str:
    global _seq
    with _seq_lock:
        _seq += 1
        seq = _seq
    return f"w-{int(time.time() * 1000):013d}-{os.getpid()}-{seq:05d}"


def publish(conf, root: str, detail: str = "") -> Optional[str]:
    """Publish one change marker for ``root`` on the notification bus;
    returns its key, or None on failure.  Never raises and runs
    fault-quiet (same contract as the lifecycle journal: losing a
    notification costs one poll interval, not a commit)."""
    from hyperspace_tpu_torch.io import faults

    try:
        with faults.quiet():
            store = _store(conf)
            payload = json.dumps({
                "root": os.path.abspath(root), "detail": detail,
                "ts": time.time()}).encode("utf-8")
            key = None
            for _ in range(4):
                key = _next_key()
                if store.put_if_absent(key, payload):
                    break
            else:
                return None
            keys = store.list_keys()
            if len(keys) > _MARKER_CAP:
                for old in sorted(keys)[:len(keys) - _MARKER_CAP]:
                    store.delete(old)
            metrics.inc("lifecycle.watch.publishes")
            return key
    except Exception:  # noqa: BLE001 — the bus is advisory
        return None


# ---------------------------------------------------------------------------
# Backends
# ---------------------------------------------------------------------------
class _PollBackend:
    """Stat-level fingerprints of each change directory."""

    name = "poll"

    def __init__(self, roots: Sequence[str]) -> None:
        self._roots = list(roots)
        self._prints: Dict[str, tuple] = {
            r: self._fingerprint(r) for r in self._roots}

    @staticmethod
    def _fingerprint(root: str) -> tuple:
        d = change_dir(root)
        try:
            with os.scandir(d) as it:
                entries = tuple(sorted(
                    (e.name, e.stat(follow_symlinks=False).st_size,
                     e.stat(follow_symlinks=False).st_mtime_ns)
                    for e in it))
        except OSError:
            entries = ()
        return entries

    def collect(self) -> List[WatchEvent]:
        out: List[WatchEvent] = []
        for root in self._roots:
            fp = self._fingerprint(root)
            if fp != self._prints[root]:
                self._prints[root] = fp
                out.append(WatchEvent(root, "poll: listing changed",
                                      time.time()))
        return out

    def close(self) -> None:
        pass


class _StoreBackend:
    """Unseen markers on the notification bus → events."""

    name = "store"

    def __init__(self, conf, roots: Sequence[str]) -> None:
        self._conf = conf
        self._roots = {os.path.abspath(r) for r in roots}
        self._seen = set(self._list())

    def _list(self) -> List[str]:
        from hyperspace_tpu_torch.io import faults

        try:
            with faults.quiet():
                return _store(self._conf).list_keys()
        except Exception:  # noqa: BLE001 — an unreadable bus reads empty
            return []

    def collect(self) -> List[WatchEvent]:
        from hyperspace_tpu_torch.io import faults

        out: List[WatchEvent] = []
        for key in sorted(self._list()):
            if key in self._seen:
                continue
            self._seen.add(key)
            root, detail, ts = "", "", time.time()
            try:
                with faults.quiet():
                    rec = json.loads(
                        _store(self._conf).read(key).decode("utf-8"))
                root = str(rec.get("root", ""))
                detail = str(rec.get("detail", ""))
                ts = float(rec.get("ts", ts))
            except Exception:  # noqa: BLE001 — a torn marker still wakes
                pass
            # No roots configured = wake on any marker; otherwise only
            # markers for a watched root count.
            if not self._roots or not root or root in self._roots:
                out.append(WatchEvent(root, detail or f"marker {key}", ts))
        return out

    def close(self) -> None:
        pass


class _InotifyBackend:
    """Linux inotify via ctypes; raises OSError when unavailable so
    the watcher can fall back."""

    name = "inotify"

    def __init__(self, roots: Sequence[str]) -> None:
        import ctypes
        import ctypes.util

        libc_name = ctypes.util.find_library("c") or "libc.so.6"
        libc = ctypes.CDLL(libc_name, use_errno=True)
        for fn in ("inotify_init1", "inotify_add_watch"):
            if not hasattr(libc, fn):
                raise OSError(f"libc lacks {fn}")
        self._libc = libc
        fd = libc.inotify_init1(_IN_NONBLOCK)
        if fd < 0:
            raise OSError(ctypes.get_errno(), "inotify_init1 failed")
        self._fd = fd
        self._wd_to_root: Dict[int, str] = {}
        try:
            for root in roots:
                d = change_dir(root)
                wd = libc.inotify_add_watch(
                    fd, os.fsencode(d), _IN_MASK)
                if wd < 0:
                    raise OSError(ctypes.get_errno(),
                                  f"inotify_add_watch({d}) failed")
                self._wd_to_root[wd] = root
        except OSError:
            os.close(fd)
            raise

    def collect(self) -> List[WatchEvent]:
        import select
        import struct

        try:
            readable, _, _ = select.select([self._fd], [], [], 0)
        except OSError:
            return []
        if not readable:
            return []
        try:
            buf = os.read(self._fd, 65536)
        except (BlockingIOError, OSError):
            return []
        out: List[WatchEvent] = []
        off, now = 0, time.time()
        while off + 16 <= len(buf):
            wd, mask, _cookie, name_len = struct.unpack_from("iIII", buf,
                                                             off)
            name = buf[off + 16: off + 16 + name_len].split(b"\0", 1)[0]
            off += 16 + name_len
            root = self._wd_to_root.get(wd)
            if root is not None:
                out.append(WatchEvent(
                    root, f"inotify {mask:#x} {os.fsdecode(name)}", now))
        return out

    def close(self) -> None:
        try:
            os.close(self._fd)
        except OSError:
            pass


# ---------------------------------------------------------------------------
# The watcher
# ---------------------------------------------------------------------------
class SourceWatcher:
    """One background thread multiplexing a watch backend into a wake
    :class:`threading.Event` the daemon sleeps on.

    ``collect → debounce → record + wake`` every
    ``conf.watch_poll_interval_s`` (inotify pays only the
    zero-timeout select per tick; poll/store pay their small stat/list).
    Construction never raises: a backend that cannot initialize
    downgrades (inotify → poll) and the resolved mode is readable via
    :attr:`mode`.
    """

    def __init__(self, conf, roots: Sequence[str],
                 wake: Optional[threading.Event] = None,
                 mode: Optional[str] = None) -> None:
        self.conf = conf
        self.roots = [os.path.abspath(r) for r in roots]
        self.wake = wake if wake is not None else threading.Event()
        self._events: List[WatchEvent] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        requested = (mode or str(conf.watch_mode) or "auto").lower()
        self._backend = self._make_backend(requested)

    def _make_backend(self, requested: str):
        if requested in ("inotify", "auto"):
            try:
                return _InotifyBackend(self.roots)
            except OSError:
                if requested == "inotify":
                    # Forced but unavailable: degrade to poll, never raise.
                    return _PollBackend(self.roots)
        if requested == "store" or requested == "auto":
            return _StoreBackend(self.conf, self.roots)
        return _PollBackend(self.roots)

    @property
    def mode(self) -> str:
        """The backend actually running (after auto/downgrade)."""
        return self._backend.name

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "SourceWatcher":
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="hs-source-watcher", daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout_s: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout_s)
            self._thread = None
        self._backend.close()

    def drain(self) -> List[WatchEvent]:
        """Events observed since the last drain (consumes them)."""
        with self._lock:
            out, self._events = self._events, []
        return out

    # -- the watch loop ------------------------------------------------------
    def _run(self) -> None:
        interval = max(0.01, float(self.conf.watch_poll_interval_s))
        debounce_s = max(0.0, float(self.conf.watch_debounce_ms) / 1000.0)
        while not self._stop.is_set():
            try:
                events = self._backend.collect()
                if events:
                    # Debounce: let the burst finish, sweep once more, then
                    # wake the daemon exactly once.
                    if debounce_s > 0:
                        self._stop.wait(debounce_s)
                        events.extend(self._backend.collect())
                    with self._lock:
                        self._events.extend(events)
                        del self._events[:-_MARKER_CAP]
                    metrics.inc("lifecycle.watch.events", len(events))
                    metrics.inc("lifecycle.watch.wakes")
                    self.wake.set()
            except Exception:  # noqa: BLE001 - a tick never kills the
                # thread; the daemon's interval still runs
                metrics.inc("lifecycle.watch.errors")
            self._stop.wait(interval)
