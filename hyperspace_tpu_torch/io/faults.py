"""Deterministic fault injection for the IO, op-log and action layers
and the query server's wire (counterpart of hyperspace_tpu/io/faults.py).

IO primitives call :func:`check` / :func:`write_payload` /
:func:`atomic_replace` / :func:`corrupt_file` at named *sites*, and an
installed :class:`FaultPlan` decides whether the Nth call at that site
fails, and how.  Disarmed (the default) a site costs one ``is None``
check per file operation, never per row.

Sites:

========================  ====================================================
``log.write``             payload write of a numbered log entry
                          (``IndexLogManager.write_log``)
``log.rename``            the latestStable tmp -> pointer rename
                          (``IndexLogManager.create_latest_stable_log``)
``data.write``            an index data (Parquet) file write
                          (``io/parquet.write_bucketed``, ``write_bucket_run``)
``action.commit``         between an action's ``op()`` and ``end()``: the
                          work done, the final entry not yet committed
``io.list``               a directory listing (``io/files.list_dir``,
                          ``list_data_files``)
``io.delete``             a delete of index data (``io/files.remove_tree``,
                          ``remove_file``: vacuumed versions, spill runs)
``data.read``             one source or index file read
                          (``io/parquet.read_file``, ``read_table``,
                          ``read_schema``)
``store.put``             a LogStore conditional put (``torn`` COMMITS half
                          the payload, then dies)
``store.read``            a LogStore point read or generation probe
``store.list``            a LogStore key listing
``store.delete``          a LogStore delete
``net.connect``           a client socket dial (``interop/netfaults.connect``)
``net.send``              a framed wire send: the client's request line, or
                          the server's status line and Arrow stream while a
                          wire plan is armed (``interop/netfaults.send_all``)
``net.recv``              a client's read of the status line and stream
                          (``interop/netfaults.before_recv``)
``net.accept``            the server's accept, in both IO modes
                          (``interop/netfaults.on_accept``)
========================  ====================================================

Kinds:

========================  ====================================================
``enospc`` / ``eio``      raise ``OSError`` with that errno (transient for
                          the retry layer, utils/retry.py)
``torn``                  write half the payload, then die
                          (:class:`InjectedCrash`); the partial file stays
``crash``                 die at the site before doing anything
``crash-before-rename``   die with the tmp file written, the rename not done
``crash-after-rename``    do the rename, then die
``bitrot``                flip 8 bytes mid-file in place, keeping size and
                          mtime (only a content digest sees it); fires only
                          through :func:`corrupt_file`
``truncate``              cut the file to half its size; fires only through
                          :func:`corrupt_file`
``refused``               the peer answers the dial with an RST
                          (``ConnectionRefusedError``)
``reset``                 the connection dies mid-operation
                          (``ConnectionResetError``)
``black-hole``            the peer goes silent: the call hangs ``hang_s``
                          seconds, then times out
``slow``                  the call succeeds ``latency_ms`` late
``torn-frame``            half the frame lands, then the connection resets:
                          the reader sees a truncated Arrow stream
========================  ====================================================

The corruption kinds never raise: the write or read itself succeeds and
the damage sits on disk for the integrity loop to find.  :func:`check`
and the other checkpoints skip them without counting, so ``at=N`` counts
only the calls that can fire the armed kind.  The wire kinds pair only
with the ``net.*`` sites (a plan pairing a wire kind with a file site, or
a file kind with a wire site, is refused: it could never fire) and fire
only through :func:`net`, which never raises: ``interop/netfaults.py``
decides how each one shows on the socket.

A crash is :class:`InjectedCrash`, a ``BaseException``: ``except
Exception`` cleanup, which a real ``kill -9`` would never run, does not
catch it, so the state on disk is the honest post-crash state.

A plan is process-global and belongs to this package alone: a plan of
the JAX package arms none of these sites, and one installed here arms
none of its.  Arm one with ``faults.install(FaultPlan(...))`` or through
the conf (``fault_injection_enabled`` and the ``fault_injection_*``
fields, read when a ``HyperspaceSession`` is made); always ``clear()``
it afterwards.
"""

from __future__ import annotations

import dataclasses
import errno
import os
import threading
from typing import Optional

_KNOWN_KINDS = ("enospc", "eio", "torn", "crash", "crash-before-rename",
                "crash-after-rename", "bitrot", "truncate",
                "refused", "reset", "black-hole", "slow", "torn-frame")
# Kinds that damage a file's content instead of failing the call; they
# fire only through corrupt_file().
_CORRUPT_KINDS = ("bitrot", "truncate")
# Wire kinds: they fire only through net(), at net.* sites, and
# interop/netfaults.py interprets them.
_NET_KINDS = ("refused", "reset", "black-hole", "slow", "torn-frame")

# Every checkpoint and every FaultPlan names one of these: a misspelt
# site would silently never fire.
SITES = (
    "log.write",
    "log.rename",
    "data.write",
    "data.read",
    "action.commit",
    "io.list",
    "io.delete",
    "store.put",
    "store.read",
    "store.list",
    "store.delete",
    "net.connect",
    "net.send",
    "net.recv",
    "net.accept",
)


class InjectedCrash(BaseException):
    """Simulated process death at a fault site.  Not an ``Exception``: a
    crashed process runs no cleanup, so ``except Exception`` blocks must
    not swallow it."""


@dataclasses.dataclass
class FaultPlan:
    """One armed fault: fire ``count`` times (-1: every matching call)
    from the ``at``-th call of ``site`` on (1-based), with ``kind``."""

    site: str
    kind: str
    at: int = 1
    count: int = 1
    # What a wire kind does, read by interop/netfaults.py: the delay of
    # ``slow`` and the hang of ``black-hole`` before its timeout.
    latency_ms: float = 25.0
    hang_s: float = 0.25

    def __post_init__(self) -> None:
        if self.kind not in _KNOWN_KINDS:
            raise ValueError(
                f"Unknown fault kind {self.kind!r}; expected one of "
                f"{_KNOWN_KINDS}")
        if self.site not in SITES:
            raise ValueError(
                f"Unknown fault site {self.site!r}; expected one of "
                f"{SITES} (a misspelt site would silently never fire)")
        if (self.kind in _NET_KINDS) != self.site.startswith("net."):
            raise ValueError(
                f"Fault kind {self.kind!r} cannot fire at site "
                f"{self.site!r}: wire kinds {_NET_KINDS} pair only with "
                f"net.* sites (a mismatched plan would silently never "
                f"fire)")
        self._calls = 0
        self._fired = 0
        # The spill build reaches data.write and io.delete from its route
        # and finalize threads at once: the count must be exact.
        self._lock = threading.Lock()

    def _should_fire(self, site: str, corrupting: bool = False,
                     net: bool = False) -> bool:
        if site != self.site:
            return False
        if (self.kind in _CORRUPT_KINDS) != corrupting \
                or (self.kind in _NET_KINDS) != net:
            # A call that cannot fire this kind does not count either.
            return False
        with self._lock:
            self._calls += 1
            if self._calls < self.at:
                return False
            if self.count >= 0 and self._fired >= self.count:
                return False
            self._fired += 1
            return True

    def _raise(self) -> None:
        if self.kind == "enospc":
            raise OSError(errno.ENOSPC, "injected: no space left on device")
        if self.kind == "eio":
            raise OSError(errno.EIO, "injected: input/output error")
        raise InjectedCrash(f"injected crash at {self.site}")


_PLAN: Optional[FaultPlan] = None

# Per-thread quiet depth: bookkeeping IO inside a quiet() section
# neither fires an armed fault nor moves its call counter.
_quiet_tls = threading.local()


class _QuietSection:
    def __enter__(self) -> "_QuietSection":
        self._prev = getattr(_quiet_tls, "depth", 0)
        _quiet_tls.depth = self._prev + 1
        return self

    def __exit__(self, *exc: object) -> bool:
        _quiet_tls.depth = self._prev
        return False


def quiet() -> _QuietSection:
    """Context manager: the fault sites on this thread pass through (no
    fire, no counting) while it is open."""
    return _QuietSection()


def _armed(site: str, corrupting: bool = False,
           net: bool = False) -> Optional[FaultPlan]:
    plan = _PLAN
    if plan is None or getattr(_quiet_tls, "depth", 0) > 0 \
            or not plan._should_fire(site, corrupting, net):
        return None
    return plan


def install(plan: Optional[FaultPlan]) -> None:
    """Arm ``plan`` process-wide (None disarms)."""
    global _PLAN
    _PLAN = plan


def clear() -> None:
    install(None)


def active() -> Optional[FaultPlan]:
    return _PLAN


def install_from_conf(conf) -> None:
    """Arm the injector from the conf's ``fault_injection_*`` fields; a
    no-op unless ``fault_injection_enabled``."""
    if not getattr(conf, "fault_injection_enabled", False):
        return
    install(FaultPlan(site=conf.fault_injection_site,
                      kind=conf.fault_injection_kind,
                      at=int(conf.fault_injection_at),
                      count=int(conf.fault_injection_count),
                      latency_ms=float(conf.fault_injection_latency_ms),
                      hang_s=float(conf.fault_injection_hang_s)))


def check(site: str) -> None:
    """Fault checkpoint: raise the armed fault when ``site`` matches and
    the call count lines up."""
    plan = _armed(site)
    if plan is not None:
        plan._raise()


def net(site: str) -> Optional[FaultPlan]:
    """Wire checkpoint: the armed plan when a wire kind fires at ``site``,
    else None.  Never raises: the socket seam (interop/netfaults.py)
    decides how the fault shows, this only whether the Nth call fires."""
    return _armed(site, net=True)


def fire(site: str) -> Optional[str]:
    """Like :func:`check`, but a ``torn`` fault returns ``"torn"`` instead
    of raising, so a store whose commit is atomic decides what a torn
    upload leaves behind; every other kind raises here."""
    plan = _armed(site)
    if plan is None:
        return None
    if plan.kind == "torn":
        return "torn"
    plan._raise()
    return None


def write_payload(f, data: bytes, site: str) -> None:
    """Write ``data`` to the open binary file ``f`` under ``site``'s
    faults: ``enospc``/``eio`` fail before a byte lands, ``torn`` writes
    half and dies, ``crash`` dies before writing."""
    plan = _armed(site)
    if plan is None:
        f.write(data)
        return
    if plan.kind == "torn":
        f.write(data[:max(1, len(data) // 2)])
        f.flush()
        raise InjectedCrash(f"injected torn write at {site}")
    plan._raise()


def corrupt_file(site: str, path: str) -> None:
    """Corruption checkpoint: ``bitrot`` flips 8 bytes in the middle of
    ``path`` in place and restores its mtime; ``truncate`` cuts it to
    half its size.  The IO at the site itself still succeeds."""
    plan = _armed(site, corrupting=True)
    if plan is None:
        return
    st = os.stat(path)
    if plan.kind == "truncate":
        with open(path, "r+b") as f:
            f.truncate(max(1, st.st_size // 2))
        return
    with open(path, "r+b") as f:
        off = max(0, st.st_size // 2 - 4)
        f.seek(off)
        chunk = f.read(8)
        f.seek(off)
        f.write(bytes(b ^ 0xFF for b in chunk))
        f.flush()
        os.fsync(f.fileno())
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns))


def atomic_replace(tmp: str, dst: str, site: str) -> None:
    """``os.replace`` under ``site``'s faults: ``crash-before-rename``
    (and ``crash``, ``torn``) dies leaving ``tmp`` and ``dst`` as they
    were; ``crash-after-rename`` dies with the rename done;
    ``enospc``/``eio`` fail the rename."""
    plan = _armed(site)
    if plan is None:
        os.replace(tmp, dst)
        return
    if plan.kind == "crash-after-rename":
        os.replace(tmp, dst)
        raise InjectedCrash(f"injected crash after rename at {site}")
    if plan.kind in ("crash", "crash-before-rename", "torn"):
        raise InjectedCrash(f"injected crash before rename at {site}")
    plan._raise()
