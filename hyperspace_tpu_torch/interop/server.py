"""Arrow-IPC query server (counterpart of hyperspace_tpu/interop/server.py):
one JSON request line in, one Arrow IPC stream out.

Wire protocol (minimal on purpose: any language with a socket and an
Arrow library can speak it):

  client -> server   one JSON object (the interop/query.py spec, or
                     ``{"sql": ..., "tables": {...}}``, or
                     ``{"verb": ...}``), UTF-8, newline-terminated; it
                     may carry a client-minted trace context
                     (``trace_id`` / ``request_id``, 16 hex chars each)
                     that the server adopts; a malformed id is replaced
                     by a minted one, never refused
  server -> client   the status line ``OK trace=<trace_id>\\n`` and an
                     Arrow IPC STREAM of the result, or
                     ``ERR <CODE> <message> trace=<trace_id>\\n`` and the
                     connection closes.  Every response echoes the trace
                     id, which the ``slow_queries`` and ``trace`` verbs
                     answer for afterwards.

Error codes split what a client may retry from what it may not:

  ``BUSY``      retryable: the server shed the request (admission queue
                full, connection cap, a watermark, draining); the line
                carries ``retry-after-ms=<n>``, the server's backoff hint
  ``DEADLINE``  retryable: the request's deadline passed first
  ``BADREQ``    permanent: the request itself is malformed
  ``FAILED``    permanent: the engine failed on a valid request (a CUDA
                error or ``torch.OutOfMemoryError`` included: a query on
                a ``cuda`` session never reruns on the host)

:func:`parse_wire_error` (used by :class:`QueryClient`) also reads the
bare pre-taxonomy form ``ERR <message>`` as ``FAILED``.

Connections are PIPELINED: after an ``OK`` response the client may send
the next request on the same connection; an error closes it.  Query
execution runs on a fixed pool of ``conf.serving_workers`` threads fed
by a bounded admission queue (``conf.serving_queue_depth``).  Socket IO
takes one of two modes (``conf.serving_io_mode``, read when the server
is made): ``"threaded"``, one thread per connection, or ``"async"``, one
selector thread that accepts and reads every connection and hands each
complete request line to one of ``workers + 4`` dispatcher threads.
Both run the same request engine (:class:`_Responder`), so they answer
the same bytes.  Past ``conf.serving_max_connections`` open connections
the accept path answers ``ERR BUSY`` without a thread or a selector
registration.  One writer per connection, one complete response per
request, so frames never interleave.  A request's deadline
(``deadline_ms``, else ``conf.serving_default_deadline_ms``) reaches
``Dataset.collect`` through utils/deadline.py.  A spec's ``"tenant"``
(a string) is its admission key: with ``conf.serving_tenant_max_queued``
above 0 a tenant with that many requests queued or running sheds ``ERR
BUSY`` while other tenants are admitted.  Repeat queries skip the
optimizer through the server's plan cache (execution/plan_cache.py).
``drain()`` (or SIGTERM with ``handle_sigterm=True``) stops accepting,
lets in-flight requests finish within ``conf.serving_drain_grace_s``,
then closes.

The wire seams (the client's dial, sends and reads, the server's accept
and, while a wire plan is armed, its response) go through
interop/netfaults.py, so the ``net.*`` fault sites can tear, reset,
delay or silence them.

The server executes against ONE session, on that session's device
(``cuda`` unless the caller built a ``cpu`` session), so its indexes and
conf govern rewrites exactly as for local use; the dispatchers and the
selector thread only parse, admit and write.

The client side: :class:`FleetQueryClient` is a front door over N
servers (least-loaded routing over pooled pipelined connections,
failover of retryable codes and transport faults under ONE deadline
budget, per-endpoint circuit breakers, hedged requests), and
``QueryServer(..., proxy_endpoints=[...])`` forwards queries through
one, so a client in any language gets the same fault tolerance.
:class:`MetricsScrapeServer` serves the metrics registry to a Prometheus
scraper, or with ``fleet=True`` every published heartbeat's series.

The fleet plane (telemetry/fleet.py): a started server publishes the
role ``server`` and its address in its heartbeat, and ``drain`` flags
the heartbeat draining at once and deletes it at the end; the front door
routes on the servers' published load and skips draining rows.  The SLO
alert engine (telemetry/alerts.py) is not in this package yet: the
``alerts`` verb answers ``ERR FAILED`` naming it.  pyarrow and
http.server are imported inside functions.
"""

from __future__ import annotations

import json
import queue
import random
import re
import socket
import socketserver
import threading
import time
from typing import (TYPE_CHECKING, Any, Callable, Dict, List, Optional,
                    Sequence, Tuple, Union)

from hyperspace_tpu_torch.interop import netfaults

if TYPE_CHECKING:
    import pyarrow as pa

MAX_REQUEST_BYTES = 1 << 20  # a query spec, not a data upload

REQUEST_TIMEOUT_S = 30.0  # an idle connection must not pin a thread + fd

# -- wire error taxonomy ------------------------------------------------------
ERR_BUSY = "BUSY"
ERR_DEADLINE = "DEADLINE"
ERR_BADREQ = "BADREQ"
ERR_FAILED = "FAILED"
KNOWN_WIRE_CODES = (ERR_BUSY, ERR_DEADLINE, ERR_BADREQ, ERR_FAILED)
RETRYABLE_WIRE_CODES = frozenset({ERR_BUSY, ERR_DEADLINE})


class WireError(Exception):
    """Server side: an error with an explicit wire code (everything else
    goes through :func:`_classify_error`).  ``retry_after_ms`` rides a
    BUSY shed as the ``retry-after-ms=<n>`` token."""

    def __init__(self, code: str, message: str,
                 retry_after_ms: Optional[int] = None) -> None:
        super().__init__(message)
        self.code = code
        self.message = message
        self.retry_after_ms = retry_after_ms


class QueryFailedError(RuntimeError):
    """Client side: the server answered ``ERR ...``.  ``code`` is one of
    ``BUSY``/``DEADLINE``/``BADREQ``/``FAILED``; ``retryable`` is True
    for the first two: back off and retry on a NEW connection (an error
    closes the one it came on).  ``trace_id`` is the echoed trace id,
    what ``slow_queries`` and the ``trace`` verb answer for;
    ``retry_after_ms`` the server's backoff hint (None without one)."""

    def __init__(self, code: str, message: str, payload: str,
                 trace_id: Optional[str] = None,
                 retry_after_ms: Optional[int] = None) -> None:
        super().__init__(f"Query failed: {payload}")
        self.code = code
        self.message = message
        self.trace_id = trace_id
        self.retry_after_ms = retry_after_ms

    @property
    def retryable(self) -> bool:
        return self.code in RETRYABLE_WIRE_CODES


class ServerBusyError(QueryFailedError):
    """The server shed this request (``ERR BUSY``): overload, not a bug.
    Retry after ``retry_after_ms`` on a new connection."""


_TRACE_ECHO_RE = re.compile(r"^(.*?)\s*\btrace=([0-9a-f]{16})\s*$")
_RETRY_AFTER_RE = re.compile(r"^(.*?)\s*\bretry-after-ms=(\d+)\s*$")


def _split_trace_echo(text: str) -> Tuple[str, Optional[str]]:
    """Strip a trailing ``trace=<16 hex>`` token (the server's trace-id
    echo) off a status line: ``(rest, trace_id or None)``."""
    m = _TRACE_ECHO_RE.match(text)
    if m is None:
        return text, None
    return m.group(1), m.group(2)


def _split_retry_after(text: str) -> Tuple[str, Optional[int]]:
    """Strip a trailing ``retry-after-ms=<n>`` token (the BUSY backoff
    hint) off a status line: ``(rest, ms or None)``."""
    m = _RETRY_AFTER_RE.match(text)
    if m is None:
        return text, None
    return m.group(1), int(m.group(2))


def parse_wire_error(line: str) -> QueryFailedError:
    """An ``ERR ...`` status line as the typed client error.  Reads the
    coded form (``ERR BUSY queue full``) and the bare pre-taxonomy form
    (``ERR something broke``, code FAILED); a trailing ``trace=<id>``
    and a ``retry-after-ms=<n>`` land in ``.trace_id`` and
    ``.retry_after_ms`` either way."""
    payload = line[4:] if line.startswith("ERR ") else line
    stripped, trace_id = _split_trace_echo(payload)
    stripped, retry_after_ms = _split_retry_after(stripped)
    code, _, rest = stripped.partition(" ")
    if code in KNOWN_WIRE_CODES and rest:
        cls = ServerBusyError if code == ERR_BUSY else QueryFailedError
        return cls(code, rest, payload, trace_id, retry_after_ms)
    return QueryFailedError(ERR_FAILED, stripped, payload, trace_id,
                            retry_after_ms)


def _classify_error(exc: BaseException) -> Tuple[str, str]:
    """(wire code, message) of an exception crossing the wire."""
    from hyperspace_tpu_torch.exceptions import DeadlineExceededError

    if isinstance(exc, WireError):
        return exc.code, exc.message
    if isinstance(exc, QueryFailedError):
        # A proxied upstream error keeps its code across this hop: BUSY
        # stays retryable, with its retry-after hint, instead of turning
        # into a permanent FAILED at the front door.
        return exc.code, exc.message
    if isinstance(exc, DeadlineExceededError):
        return ERR_DEADLINE, str(exc)
    if isinstance(exc, ValueError):
        # The spec decoders (interop/query.py, the SQL front end) raise
        # ValueError for a malformed request: the client's fault.
        return ERR_BADREQ, str(exc)
    return ERR_FAILED, f"{type(exc).__name__}: {exc}"


# -- the bounded worker pool --------------------------------------------------
class _Job:
    """One admitted request: the execute closure and its rendezvous.
    Workers compute; the connection's thread does ALL socket IO."""

    __slots__ = ("fn", "kind", "deadline_at", "enqueued_t", "done",
                 "result", "error", "report", "abandoned",
                 "trace_id", "request_id", "root_span", "queue_wait_ms",
                 "tenant")

    def __init__(self, fn: Callable[[], "pa.Table"], kind: str,
                 deadline_at: Optional[float], trace_id: str = "",
                 request_id: str = "", tenant: str = "") -> None:
        self.fn = fn
        self.kind = kind
        self.tenant = tenant  # the wire tenant id ("": none)
        self.deadline_at = deadline_at  # absolute time.monotonic(), or None
        self.enqueued_t = time.monotonic()
        self.done = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        self.report = None  # the query's run report, for the verbs
        self.abandoned = False  # the handler answered DEADLINE already
        self.trace_id = trace_id
        self.request_id = request_id
        self.root_span = None  # the serve.request Span with tracing on
        self.queue_wait_ms: Optional[float] = None


class _WorkerPool:
    """Fixed worker threads over a bounded admission queue: the cap on
    concurrent execution, and the seam every shed goes through."""

    _EWMA_ALPHA = 0.2

    def __init__(self, session, workers: int, queue_depth: int) -> None:
        self._session = session
        self._queue: "queue.Queue" = queue.Queue(maxsize=max(1, queue_depth))
        self._threads: list = []
        self._stop_sentinel = object()
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        self._active = 0  # jobs executing right now
        self._queued_or_active = 0  # admitted and not yet finished
        # Requests whose RESPONSE is not fully written yet: drain() waits
        # for the write too, or a SIGTERM between "worker done" and
        # "stream flushed" would tear the frame.
        self._open_requests = 0
        self._queue_wait_ewma_ms = 0.0
        self._rss_at = 0.0
        self._rss_mb = 0.0
        # tenant id -> its requests queued or running, which the quota
        # (conf.serving_tenant_max_queued) grades: a hot tenant sheds
        # against its own count while the others are admitted.
        self._tenant_queued: Dict[str, int] = {}
        self.draining = False
        self.workers = max(1, int(workers))

    def start(self) -> None:
        for i in range(self.workers):
            t = threading.Thread(target=self._run,
                                 name=f"hs-serve-worker-{i}", daemon=True)
            t.start()
            self._threads.append(t)

    # -- admission ---------------------------------------------------------
    def retry_after_hint_ms(self) -> int:
        """The backoff a shed client should take: about one recent queue
        wait (twice the EWMA the latency watermark reads), floored at
        100 ms so an idle-queue shed still suggests a real pause, capped
        at 30 s."""
        with self._lock:
            ewma = self._queue_wait_ewma_ms
        return int(max(100.0, min(30_000.0, ewma * 2.0)))

    def _shed(self, reason: str, message: str) -> None:
        from hyperspace_tpu_torch.telemetry import metrics

        metrics.inc("serve.shed")
        metrics.inc(f"serve.shed.{reason}")
        raise WireError(ERR_BUSY, message,
                        retry_after_ms=self.retry_after_hint_ms())

    def submit(self, job: _Job, conf) -> None:
        """Admit ``job`` or shed it with a retryable ``ERR BUSY``."""
        from hyperspace_tpu_torch.lifecycle.daemon import _current_rss_mb
        from hyperspace_tpu_torch.telemetry import metrics

        if self.draining:
            self._shed("draining", "server is draining; retry elsewhere")
        rss_mark = float(getattr(conf, "serving_shed_rss_watermark_mb", 0.0))
        if rss_mark > 0:
            now = time.monotonic()
            if now - self._rss_at > 0.2:  # a stat per ~5 admits at most
                self._rss_mb = _current_rss_mb()
                self._rss_at = now
            if self._rss_mb > rss_mark:
                self._shed("memory",
                           f"memory watermark: rss {self._rss_mb:.0f} MB > "
                           f"{rss_mark:.0f} MB; retry later")
        wait_mark = float(getattr(conf,
                                  "serving_shed_queue_wait_watermark_ms",
                                  0.0))
        if wait_mark > 0 and self._queue_wait_ewma_ms > wait_mark \
                and self._queue.qsize() > 0:
            self._shed("latency",
                       f"queue-wait watermark: recent wait "
                       f"{self._queue_wait_ewma_ms:.0f} ms > "
                       f"{wait_mark:.0f} ms; retry later")
        # Counted BEFORE the put: a worker can finish the job before this
        # thread resumes, and wait_idle must never see a transient zero
        # while work is in flight.  The tenant's count moves in the same
        # critical section, so it never disagrees with the pool's.
        quota = int(conf.serving_tenant_max_queued)
        with self._lock:
            tenant_over = quota > 0 and bool(job.tenant) and \
                self._tenant_queued.get(job.tenant, 0) >= quota
            if not tenant_over:
                self._queued_or_active += 1
                if job.tenant:
                    self._tenant_queued[job.tenant] = \
                        self._tenant_queued.get(job.tenant, 0) + 1
            tenant_left = self._tenant_queued.get(job.tenant, 0)
        if tenant_over:
            metrics.inc(f"serve.tenant.{job.tenant}.shed")
            self._shed("tenant",
                       f"tenant {job.tenant!r} is at its queued quota "
                       f"({quota}); retry later")
        if job.tenant:
            metrics.set_gauge(f"serve.tenant.{job.tenant}.queued",
                              tenant_left)
        try:
            self._queue.put_nowait(job)
        except queue.Full:
            with self._idle:
                self._queued_or_active -= 1
                self._release_tenant(job)
                self._idle.notify_all()
            self._shed("queue_full",
                       f"admission queue full "
                       f"(depth {self._queue.maxsize}); retry later")
        metrics.inc("serve.admitted")
        metrics.set_gauge("serve.queue_depth", self._queue.qsize())

    def _release_tenant(self, job: _Job) -> None:
        """One off the job's tenant count; the caller holds the lock."""
        if not job.tenant:
            return
        n = self._tenant_queued.get(job.tenant, 1) - 1
        if n <= 0:
            self._tenant_queued.pop(job.tenant, None)
        else:
            self._tenant_queued[job.tenant] = n

    def tenant_snapshot(self) -> Dict[str, int]:
        """tenant id -> its requests queued or running now (the
        ``tenants`` verb's ``queued`` column)."""
        with self._lock:
            return dict(self._tenant_queued)

    # -- workers -----------------------------------------------------------
    def _run(self) -> None:
        from hyperspace_tpu_torch.exceptions import DeadlineExceededError
        from hyperspace_tpu_torch.telemetry import metrics, trace
        from hyperspace_tpu_torch.utils import deadline as _deadline

        while True:
            item = self._queue.get()
            if item is self._stop_sentinel:
                return
            job: _Job = item
            now = time.monotonic()
            wait_ms = (now - job.enqueued_t) * 1000.0
            job.queue_wait_ms = wait_ms
            metrics.observe("serve.queue_wait_ms", wait_ms)
            metrics.set_gauge("serve.queue_depth", self._queue.qsize())
            with self._lock:
                # A read-modify-write shared by the workers: unlocked,
                # two of them lose updates.
                self._queue_wait_ewma_ms += self._EWMA_ALPHA * (
                    wait_ms - self._queue_wait_ewma_ms)
                self._active += 1
                metrics.set_gauge("serve.inflight", self._active)
            try:
                if job.abandoned:
                    pass  # the handler answered already: spend nothing
                elif job.deadline_at is not None and now > job.deadline_at:
                    # Expired while QUEUED: no execution spent on it.
                    job.error = DeadlineExceededError(
                        f"deadline expired after {wait_ms:.0f} ms in the "
                        f"admission queue")
                else:
                    budget = None if job.deadline_at is None \
                        else job.deadline_at - time.monotonic()
                    # The report is thread-local: clear this worker's
                    # previous one, so a query that dies before collect()
                    # is not recorded with a stale report.
                    self._session.last_run_report_value = None
                    try:
                        # The wire trace context rides the worker's
                        # context: collect() sees a served request, and
                        # the root span carries the ids to the sinks.
                        with trace.request_scope(job.trace_id,
                                                 job.request_id):
                            with trace.span(
                                    "serve.request", kind=job.kind,
                                    trace_id=job.trace_id,
                                    request_id=job.request_id) as sp:
                                if isinstance(sp, trace.Span):
                                    job.root_span = sp
                                with _deadline.scope(budget):
                                    job.result = job.fn()
                                sp.set(queue_wait_ms=round(wait_ms, 1))
                    finally:
                        # This worker's run report (of a failed query
                        # too) goes to the connection, for the
                        # last_run_report verb on the same connection.
                        job.report = self._session.last_run_report_value
            except BaseException as e:  # noqa: BLE001 - a worker survives
                # anything a query throws (a CUDA error included); the
                # error crosses the wire instead.
                job.error = e
            finally:
                # Recorded BEFORE done.set(): the span tree and report are
                # final here, and a record exists by the time the handler
                # answers.  The worker records every ADMITTED job (an
                # abandoned one too); the handler only what never reached
                # a worker (sheds, BADREQ).
                self._record_flight(job)
                job.done.set()
                with self._idle:
                    self._active -= 1
                    self._queued_or_active -= 1
                    self._release_tenant(job)
                    tenant_left = self._tenant_queued.get(job.tenant, 0)
                    metrics.set_gauge("serve.inflight", self._active)
                    self._idle.notify_all()
                if job.tenant:
                    metrics.set_gauge(f"serve.tenant.{job.tenant}.queued",
                                      tenant_left)

    def _record_flight(self, job: _Job) -> None:
        """One finished job: one flight-recorder offer, and for an OK the
        latency histogram with the trace id as its exemplar when the
        record was retained."""
        from hyperspace_tpu_torch.telemetry import flight_recorder, metrics

        if job.abandoned:
            # The client saw ERR DEADLINE whatever the aborted run made
            # of it afterwards: record what was answered.
            outcome = ERR_DEADLINE
            error = ("abandoned: deadline passed before the result was "
                     "ready")
        elif job.error is not None:
            outcome, raw = _classify_error(job.error)
            error = str(raw).replace("\n", " ")[:500]
        else:
            outcome, error = "OK", ""
        latency_ms = (time.monotonic() - job.enqueued_t) * 1000.0
        retained = flight_recorder.record(
            self._session.conf, kind=job.kind, outcome=outcome,
            latency_ms=latency_ms, trace_id=job.trace_id,
            request_id=job.request_id, queue_wait_ms=job.queue_wait_ms,
            error=error, span=job.root_span, report=job.report)
        if not job.abandoned and job.error is None:
            metrics.observe("serve.latency_ms", latency_ms,
                            exemplar=job.trace_id if retained else None)

    # -- request accounting (connection threads) ---------------------------
    def request_started(self) -> None:
        with self._idle:
            self._open_requests += 1

    def request_finished(self) -> None:
        with self._idle:
            self._open_requests -= 1
            self._idle.notify_all()

    # -- lifecycle ---------------------------------------------------------
    def wait_idle(self, grace_s: float) -> bool:
        """Block until every admitted job finished AND every response is
        fully written, or ``grace_s`` passed.  True when it drained."""
        deadline_at = time.monotonic() + max(0.0, grace_s)
        with self._idle:
            while self._queued_or_active > 0 or self._open_requests > 0:
                left = deadline_at - time.monotonic()
                if left <= 0:
                    return False
                self._idle.wait(left)
        return True

    def stop(self, timeout_s: float = 5.0) -> None:
        for _ in self._threads:
            self._queue.put(self._stop_sentinel)
        for t in self._threads:
            t.join(timeout=timeout_s)
        self._threads.clear()


# -- the connection handler ---------------------------------------------------
class _Responder:
    """The request→response engine of both IO modes: parse, answer a
    verb or admit a query, stream the answer, classify errors.  It holds
    no socket logic of its own beyond ``connection`` (the socket) and
    ``wfile`` (a binary writer on it); :class:`_Handler` is the threaded
    mode's shell, :class:`_AsyncResponder` the async mode's."""

    server: Any = None
    connection: Any = None
    wfile: Any = None

    def _init_responder(self) -> None:
        # The run report of the latest query served on THIS connection
        # (queries run on pool workers, so the session's thread-local
        # cannot answer the last_run_report verb here).
        self._last_report = None
        # The admitted job of the current request (None before
        # admission): the error path records only unadmitted requests.
        self._cur_job = None

    def _respond_one(self, line: bytes, conf) -> bool:
        from hyperspace_tpu_torch.interop.query import (
            mint_trace_id,
            pop_trace_context,
        )
        from hyperspace_tpu_torch.telemetry import flight_recorder, metrics

        t0 = time.monotonic()
        trace_id: Optional[str] = None
        request_id: Optional[str] = None
        kind = "unknown"
        is_verb = False
        self._cur_job = None
        try:
            spec = self._parse(line)
            # Adopt the client's trace context, or mint one for a missing
            # or malformed id (a bad id never refuses the request).
            trace_id, request_id, adopted = pop_trace_context(spec)
            if adopted:
                metrics.inc("serve.trace.adopted")
            else:
                metrics.inc("serve.trace.minted")
            # The tenant id is popped here, so neither verbs nor the
            # decoders see it; admission grades it against its quota.
            tenant = spec.pop("tenant", "")
            if tenant is None:
                tenant = ""
            if not isinstance(tenant, str):
                raise WireError(ERR_BADREQ, '"tenant" must be a string')
            is_verb = "verb" in spec
            if is_verb:
                # Verbs answer INLINE on the connection thread: they read
                # process state, never the executor, and keep working
                # while the admission queue is full.
                table = _serve_verb(self.server.session, spec,
                                    self._last_report,
                                    pool=self.server.pool)
            else:
                kind = "sql" if "sql" in spec else "spec"
                table = self._execute_admitted(spec, conf, trace_id,
                                               request_id, tenant)
        except Exception as exc:  # -> coded wire error, connection closes
            if trace_id is None:
                trace_id, request_id = mint_trace_id(), mint_trace_id()
                metrics.inc("serve.trace.minted")
            code, raw = _classify_error(exc)
            msg = str(raw).replace("\n", " ")[:500]
            metrics.inc("serve.errors")
            metrics.inc(f"serve.err.{code.lower()}")
            if code == ERR_DEADLINE:
                metrics.inc("serve.deadline.expired")
            if not is_verb and self._cur_job is None:
                # Sheds and malformed requests never reach a worker, so
                # the record is made here.
                flight_recorder.record(
                    conf, kind=kind, outcome=code,
                    latency_ms=(time.monotonic() - t0) * 1000.0,
                    trace_id=trace_id, request_id=request_id, error=msg)
            retry_ms = getattr(exc, "retry_after_ms", None)
            hint = f" retry-after-ms={int(retry_ms)}" \
                if retry_ms is not None else ""
            try:
                self.connection.settimeout(
                    float(conf.serving_send_timeout_s))
                self.wfile.write(
                    f"ERR {code} {msg}{hint} trace={trace_id}\n"
                    .encode("utf-8"))
            except OSError:
                pass
            return False
        # The send side has its OWN timeout: a dead client that stopped
        # reading mid-stream must not pin this thread on a full buffer.
        import pyarrow as pa

        try:
            self.connection.settimeout(float(conf.serving_send_timeout_s))
            if netfaults.armed():
                # The wire-fault detour: the whole frame in one buffer, so
                # the net.send seam can tear it at an exact byte.  Only
                # with a wire plan armed: otherwise no frame is copied.
                import io

                buf = io.BytesIO()
                buf.write(f"OK trace={trace_id}\n".encode("utf-8"))
                with pa.ipc.new_stream(buf, table.schema) as writer:
                    writer.write_table(table)
                netfaults.send_all(self.connection, buf.getvalue())
            else:
                self.wfile.write(f"OK trace={trace_id}\n".encode("utf-8"))
                with pa.ipc.new_stream(self.wfile, table.schema) as writer:
                    writer.write_table(table)
                self.wfile.flush()
            metrics.inc("serve.ok")
            return True
        except TimeoutError:
            metrics.inc("serve.send_timeouts")
            return False  # dead reader: free the thread, drop the socket
        except OSError:
            return False  # the client hung up mid-response

    def _parse(self, line: bytes) -> Dict[str, Any]:
        if len(line) > MAX_REQUEST_BYTES or not line.endswith(b"\n"):
            raise WireError(
                ERR_BADREQ,
                f"request exceeds {MAX_REQUEST_BYTES} bytes or is not "
                f"newline-terminated")
        try:
            spec = json.loads(line.decode("utf-8"))
        except (ValueError, UnicodeDecodeError) as e:
            raise WireError(ERR_BADREQ, f"request is not JSON: {e}")
        if not isinstance(spec, dict):
            # A bare JSON string is valid JSON, and `"sql" in spec` on a
            # string would match a substring.
            raise WireError(ERR_BADREQ, "request must be a JSON object")
        return spec

    def _execute_admitted(self, spec: Dict[str, Any], conf,
                          trace_id: str, request_id: str,
                          tenant: str = "") -> "pa.Table":
        from hyperspace_tpu_torch.exceptions import DeadlineExceededError

        deadline_ms = spec.pop("deadline_ms", None)
        if deadline_ms is None:
            default_ms = float(conf.serving_default_deadline_ms or 0.0)
            deadline_ms = default_ms if default_ms > 0 else None
        elif not isinstance(deadline_ms, (int, float)) or \
                isinstance(deadline_ms, bool) or deadline_ms <= 0:
            raise WireError(ERR_BADREQ,
                            f'"deadline_ms" must be a positive number, '
                            f'got {deadline_ms!r}')
        deadline_at = None if deadline_ms is None \
            else time.monotonic() + float(deadline_ms) / 1000.0
        fn, kind = self._make_query_fn(spec)
        job = _Job(fn, kind, deadline_at, trace_id=trace_id,
                   request_id=request_id, tenant=tenant)
        self.server.pool.submit(job, conf)  # raises WireError(BUSY): shed
        self._cur_job = job  # admitted: its worker records it
        if deadline_at is None:
            job.done.wait()
        else:
            left = max(0.0, deadline_at - time.monotonic())
            if not job.done.wait(left):
                # The deadline is a RESPONSE contract: answer DEADLINE the
                # moment it passes.  The deadline scope aborts the work
                # at its next phase boundary, and the abandoned flag
                # discards the result (or skips a still-queued job).
                job.abandoned = True
                raise DeadlineExceededError(
                    "deadline exceeded before the result was ready (the "
                    "query aborts at its next phase boundary)")
        if job.error is not None:
            raise job.error
        if job.report is not None:
            self._last_report = job.report
        return job.result

    def _make_query_fn(self, spec: Dict[str, Any]):
        """Check the request's SHAPE on the connection thread (BADREQ
        without taking a queue slot); return the closure a worker runs
        and the request's kind."""
        session = self.server.session
        plan_cache = self.server.plan_cache
        proxy = self.server.proxy_client
        if proxy is not None:
            # Proxy mode: queries go on through the fleet client (routing,
            # failover, retry-after backoff) while verbs answer here.
            # Checking the shape is the backend's job; its coded errors
            # come back as they are (_classify_error keeps the code).
            forward = dict(spec)

            def run_proxy() -> "pa.Table":
                return proxy.query(forward)

            return run_proxy, ("sql" if "sql" in spec else "spec")
        if "sql" in spec:
            # {"sql": "SELECT ...", "tables": {name: parquet_dir}}
            if not isinstance(spec["sql"], str):
                raise WireError(ERR_BADREQ, '"sql" must be a string')
            tables = spec.get("tables", {})
            if not isinstance(tables, dict) or not all(
                    isinstance(v, str) for v in tables.values()):
                raise WireError(
                    ERR_BADREQ,
                    '"tables" must map names to parquet directory paths '
                    'over the wire')

            def run() -> "pa.Table":
                from hyperspace_tpu_torch.sql import sql as run_sql

                ds = run_sql(session, spec["sql"], tables=tables)
                return ds.collect(plan_cache=plan_cache)

            return run, "sql"

        def run_spec() -> "pa.Table":
            from hyperspace_tpu_torch.interop.query import dataset_from_spec

            return dataset_from_spec(session, spec).collect(
                plan_cache=plan_cache)

        return run_spec, "spec"


class _Handler(_Responder, socketserver.StreamRequestHandler):
    """The threaded accept path's per-connection shell: blocking reads
    under the idle timeout, one thread per connection."""

    timeout = REQUEST_TIMEOUT_S  # the first read's; set per phase below

    def setup(self) -> None:
        super().setup()
        # A response is several sends (the status line, then each Arrow
        # message).  Under Nagle's algorithm each small send after the
        # first waits for the client's delayed ACK: about 40 ms a
        # response, whatever the query cost.
        self.connection.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._init_responder()

    def handle(self) -> None:
        # Pipelined: serve requests until EOF, the idle timeout, or an
        # error response (which closes the connection, so framing stays
        # unambiguous for simple clients).
        while self._serve_one():
            pass

    def _serve_one(self) -> bool:
        from hyperspace_tpu_torch.telemetry import metrics

        conf = self.server.session.conf
        try:
            self.connection.settimeout(
                float(conf.serving_request_timeout_s))
            line = self.rfile.readline(MAX_REQUEST_BYTES + 1)
        except (TimeoutError, OSError):
            return False
        if not line:
            return False  # clean EOF between requests
        metrics.inc("serve.requests")
        # In flight from here until the response is fully written:
        # drain()'s wait_idle blocks on this accounting.
        pool = self.server.pool
        pool.request_started()
        try:
            return self._respond_one(line, conf)
        finally:
            pool.request_finished()


def _reject_connection(server, request: socket.socket) -> None:
    """Answer ``ERR BUSY`` to a connection past the cap; shared by both
    IO modes and bounded by a 1 s send timeout."""
    from hyperspace_tpu_torch.interop.query import mint_trace_id
    from hyperspace_tpu_torch.telemetry import flight_recorder, metrics

    metrics.inc("serve.shed")
    metrics.inc("serve.shed.connections")
    # No request line was read, so no client trace context exists: the
    # shed is recorded under minted ids.
    flight_recorder.record(
        server.session.conf, kind="unknown", outcome=ERR_BUSY,
        latency_ms=0.0, trace_id=mint_trace_id(),
        request_id=mint_trace_id(), error="connection capacity reached")
    hint = server.pool.retry_after_hint_ms()
    try:
        request.settimeout(1.0)
        request.sendall(
            f"ERR {ERR_BUSY} connection capacity reached; "
            f"retry later retry-after-ms={hint}\n".encode("utf-8"))
    except OSError:
        pass


class _AsyncResponder(_Responder):
    """One async connection's engine: the same responder over a writer
    on the socket, kept across the connection's pipelined requests (the
    ``last_run_report`` verb answers per connection)."""

    def __init__(self, server, sock: socket.socket) -> None:
        self.server = server
        self.connection = sock
        # As the threaded shell does: no Nagle wait on a response's last
        # small send.
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.wfile = sock.makefile("wb")
        self._init_responder()


class _AsyncConn:
    """The selector's state of one async connection: the socket, the
    bytes read past the last complete request line, the responder."""

    __slots__ = ("sock", "buf", "responder")

    def __init__(self, server, sock: socket.socket) -> None:
        self.sock = sock
        self.buf = b""
        self.responder = _AsyncResponder(server, sock)


class _AsyncIOLoop:
    """The async IO mode (``conf.serving_io_mode = "async"``): ONE
    event-loop thread accepts and reads for every connection, so idle
    connections cost no thread each.  A complete request line goes to a
    pool of ``workers + 4`` dispatcher threads that run the same
    :class:`_Responder` as the threaded mode: admission, verbs,
    deadlines and the error taxonomy are one code path.  The queries
    themselves run on the worker pool, as in the threaded mode.

    While a response is in flight its socket is unregistered from the
    selector: the dispatcher is the connection's only writer, and the
    loop never reads ahead of an unfinished response, so pipelined
    answers keep their order.  A finished connection comes back to the
    loop through the requeue queue and a wakeup socketpair (the loop's
    thread owns every selector registration).  The loop never blocks:
    it only accepts, reads what is ready and hands off."""

    def __init__(self, outer: "QueryServer", server) -> None:
        import selectors

        self._outer = outer
        self._server = server
        self._sel = selectors.DefaultSelector()
        self._listener: socket.socket = server.socket
        self._ready: "queue.Queue" = queue.Queue()
        self._requeue: "queue.Queue" = queue.Queue()
        self._wake_r, self._wake_w = socket.socketpair()
        self._stop = threading.Event()
        self._loop_thread: Optional[threading.Thread] = None
        self._dispatchers: list = []
        self._conns: set = set()  # owned by the loop's thread

    def start(self) -> None:
        self._listener.setblocking(False)
        self._wake_r.setblocking(False)
        self._sel.register(self._listener, _read_event(), "accept")
        self._sel.register(self._wake_r, _read_event(), "wakeup")
        self._loop_thread = threading.Thread(
            target=self._event_loop, name="hs-serve-io", daemon=True)
        self._loop_thread.start()
        # Concurrent responses are bounded by the dispatchers: the
        # workers plus headroom, so inline verbs answer while every
        # worker is busy.
        for i in range(self._server.pool.workers + 4):
            t = threading.Thread(target=self._dispatch,
                                 name=f"hs-serve-dispatch-{i}", daemon=True)
            t.start()
            self._dispatchers.append(t)

    # -- the event loop (never blocks) ----------------------------------------
    def _event_loop(self) -> None:
        while not self._stop.is_set():
            try:
                events = self._sel.select(timeout=0.2)
            except OSError:
                continue
            for key, _mask in events:
                tag = key.data
                if tag == "accept":
                    self._on_accept()
                elif tag == "wakeup":
                    self._on_wakeup()
                else:
                    self._on_readable(tag)

    def _on_accept(self) -> None:
        try:
            sock, _addr = self._listener.accept()
        except OSError:
            return
        if not netfaults.on_accept(sock):
            return  # an armed net.accept fault consumed it
        if not self._outer._acquire_conn():
            # Refused IN the loop, never registered: the threaded accept
            # path's ERR BUSY, with its bounded send.
            _reject_connection(self._server, sock)
            try:
                sock.close()
            except OSError:
                pass
            return
        sock.setblocking(False)
        conn = _AsyncConn(self._server, sock)
        self._conns.add(conn)
        self._sel.register(sock, _read_event(), conn)

    def _on_readable(self, conn: _AsyncConn) -> None:
        try:
            data = conn.sock.recv(65536)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._drop(conn, registered=True)
            return
        if not data:
            self._drop(conn, registered=True)  # a clean EOF
            return
        conn.buf += data
        if b"\n" in conn.buf or len(conn.buf) > MAX_REQUEST_BYTES:
            self._sel.unregister(conn.sock)
            self._hand_off(conn)

    def _on_wakeup(self) -> None:
        try:
            while self._wake_r.recv(4096):
                pass
        except (BlockingIOError, InterruptedError):
            pass
        except OSError:
            return
        while True:
            try:
                conn, keep = self._requeue.get_nowait()
            except queue.Empty:
                break
            if not keep or self._stop.is_set():
                self._drop(conn, registered=False)
            elif b"\n" in conn.buf:
                # The client pipelined ahead: its next request is read
                # already, and no readiness event will come for it.
                self._hand_off(conn)
            else:
                try:
                    conn.sock.setblocking(False)
                    self._sel.register(conn.sock, _read_event(), conn)
                except (OSError, ValueError):
                    self._drop(conn, registered=False)

    def _hand_off(self, conn: _AsyncConn) -> None:
        line, sep, rest = conn.buf.partition(b"\n")
        conn.buf = rest
        self._ready.put_nowait((conn, line + sep))

    def _drop(self, conn: _AsyncConn, registered: bool) -> None:
        if conn not in self._conns:
            return
        self._conns.discard(conn)
        if registered:
            try:
                self._sel.unregister(conn.sock)
            except (KeyError, ValueError):
                pass
        try:
            conn.responder.wfile.close()  # flushes an ERR line
        except OSError:
            pass
        try:
            conn.sock.close()
        except OSError:
            pass
        self._outer._release_conn()

    # -- the dispatchers (one response at a time per connection) -------------
    def _dispatch(self) -> None:
        from hyperspace_tpu_torch.telemetry import metrics

        while True:
            item = self._ready.get()
            if item is None:
                return
            conn, line = item
            pool = self._server.pool
            metrics.inc("serve.requests")
            pool.request_started()
            keep = False
            try:
                keep = conn.responder._respond_one(
                    line, self._server.session.conf)
            except Exception:  # noqa: BLE001 - a dispatcher survives
                keep = False   # anything the response path throws
            finally:
                pool.request_finished()
            self._requeue.put((conn, keep))
            try:
                self._wake_w.send(b"x")
            except OSError:
                pass

    # -- lifecycle -------------------------------------------------------------
    def stop_accepting(self) -> None:
        """Step one of a drain or a stop: end the event loop (no new
        accept, no new request read).  Responses in flight go on, and
        ``wait_idle`` waits for them."""
        self._stop.set()
        try:
            self._wake_w.send(b"x")
        except OSError:
            pass
        if self._loop_thread is not None:
            self._loop_thread.join(timeout=5)
            self._loop_thread = None

    def close(self) -> None:
        """Step two: stop the dispatchers and close every connection."""
        self.stop_accepting()
        for _ in self._dispatchers:
            self._ready.put(None)
        for t in self._dispatchers:
            t.join(timeout=5)
        self._dispatchers.clear()
        for conn in list(self._conns):
            self._drop(conn, registered=True)
        try:
            self._sel.close()
        except OSError:
            pass
        for s in (self._wake_r, self._wake_w):
            try:
                s.close()
            except OSError:
                pass


def _read_event() -> int:
    import selectors

    return selectors.EVENT_READ


def _not_here(verb: str, what: str) -> None:
    """A verb of the JAX package's server whose module this package does
    not have yet: it answers ``ERR FAILED`` naming the module, never an
    empty table."""
    from hyperspace_tpu_torch.exceptions import HyperspaceError

    raise HyperspaceError(
        f"the {verb} verb reads {what}, which this package does not have "
        f"yet")


def _serve_verb(session, spec: Dict[str, Any],
                last_report=None, pool=None) -> "pa.Table":
    """The non-query verbs of the wire protocol:

      {"verb": "metrics"}          -> (name, value) rows: counters and
                                      gauges flat, histograms as
                                      name.count/.sum/.mean/.min/.max
      {"verb": "last_run_report"}  -> one row, ``report_json``: the
                                      latest query report of THIS
                                      connection (null before any)
      {"verb": "workload"}         -> the advisor's captured workload
      {"verb": "perf_history",
       "index"?, "section"?,
       "limit"?}                   -> the perf ledger, one row per
                                      record, filtered
      {"verb": "build_report"}     -> one row, ``report_json``: the
                                      session's latest BuildReport
      {"verb": "slow_queries"}     -> the flight recorder's ring, oldest
                                      first
      {"verb": "trace",
       "id": "<trace_id>"}         -> one row, ``record_json``: the
                                      retained record of that trace id
      {"verb": "doctor"}           -> the health report (one row per
                                      check and ``overall``)
      {"verb": "lifecycle"}        -> the lifecycle decision journal,
                                      oldest first
      {"verb": "tenants"}          -> one row per tenant id seen, sorted:
                                      ``queued`` (its requests queued or
                                      running now, what the quota
                                      grades) and ``shed`` (its quota
                                      sheds so far)

    ``doctor`` with ``"fleet": true`` adds the cluster checks over the
    published heartbeats, and ``fleet_status`` serves every heartbeat
    (telemetry/fleet.py).  ``alerts`` (telemetry/alerts.py) answers
    ``ERR FAILED`` naming what this package lacks.
    """
    import pyarrow as pa

    verb = spec["verb"]
    if not isinstance(verb, str):
        raise ValueError('"verb" must be a string')
    if verb == "metrics":
        from hyperspace_tpu_torch.telemetry import metrics as m

        names: list = []
        values: list = []

        def emit(name: str, value) -> None:
            if isinstance(value, (int, float)):
                names.append(name)
                values.append(float(value))

        for name, value in sorted(m.snapshot().items()):
            if isinstance(value, dict):  # a histogram's snapshot
                for part in ("count", "sum", "mean", "min", "max"):
                    if value.get(part) is not None:
                        emit(f"{name}.{part}", value[part])
            else:
                emit(name, value)
        return pa.table({"name": pa.array(names, type=pa.string()),
                         "value": pa.array(values, type=pa.float64())})
    if verb in ("last_run_report", "build_report"):
        if verb == "build_report":
            report = session.last_build_report_value
        else:
            report = last_report if last_report is not None \
                else session.last_run_report_value
        payload = json.dumps(report.to_dict() if report is not None
                             else None)
        return pa.table({"report_json": pa.array([payload],
                                                 type=pa.string())})
    if verb == "workload":
        from hyperspace_tpu_torch.advisor.workload import workload_table

        return workload_table(session.conf)
    if verb == "perf_history":
        from hyperspace_tpu_torch.telemetry.perf_ledger import history_table

        index = spec.get("index")
        section = spec.get("section")
        limit = spec.get("limit")
        if index is not None and not isinstance(index, str):
            raise ValueError('"index" must be a string')
        if section is not None and not isinstance(section, str):
            raise ValueError('"section" must be a string')
        if limit is not None and (not isinstance(limit, int)
                                  or isinstance(limit, bool) or limit < 0):
            raise ValueError('"limit" must be a non-negative integer')
        return history_table(session.conf, index=index, section=section,
                             limit=limit)
    if verb == "slow_queries":
        from hyperspace_tpu_torch.telemetry.flight_recorder import (
            slow_queries_table,
        )

        return slow_queries_table(session.conf)
    if verb == "trace":
        from hyperspace_tpu_torch.telemetry import flight_recorder

        trace_id = spec.get("id")
        if not isinstance(trace_id, str) or not trace_id:
            raise ValueError(
                'the trace verb needs {"id": "<trace_id>"} — the id a '
                'response echoed as trace=... or an error carried')
        rec = flight_recorder.recorder().find(trace_id.lower())
        if rec is None:
            raise ValueError(
                f"no retained flight record for trace id {trace_id!r} "
                f"(healthy requests are sampled; slow/error/shed ones "
                f"are always kept while they fit the ring)")
        return pa.table({"record_json": pa.array(
            [json.dumps(rec, default=str)], type=pa.string())})
    if verb in ("doctor", "alerts"):
        fleet = spec.get("fleet", False)
        if not isinstance(fleet, bool):
            raise ValueError('"fleet" must be a boolean')
        if verb == "alerts":
            _not_here("alerts", "the SLO alert engine (telemetry/alerts.py)")
        from hyperspace_tpu_torch.telemetry.doctor import doctor

        return doctor(session, fleet=fleet).table()
    if verb == "fleet_status":
        from hyperspace_tpu_torch.telemetry.fleet import fleet_status_table

        return fleet_status_table(session.conf)
    if verb == "lifecycle":
        from hyperspace_tpu_torch.lifecycle.journal import history_table

        return history_table(session.conf)
    if verb == "tenants":
        from hyperspace_tpu_torch.telemetry import metrics as m

        queued = pool.tenant_snapshot() if pool is not None else {}
        shed: Dict[str, float] = {}
        prefix, suffix = "serve.tenant.", ".shed"
        for name, value in m.snapshot().items():
            if name.startswith(prefix) and name.endswith(suffix) \
                    and not isinstance(value, dict):
                shed[name[len(prefix):-len(suffix)]] = float(value)
        tenants = sorted(set(queued) | set(shed))
        return pa.table({
            "tenant": pa.array(tenants, type=pa.string()),
            "queued": pa.array([int(queued.get(t, 0)) for t in tenants],
                               type=pa.int64()),
            "shed": pa.array([int(shed.get(t, 0)) for t in tenants],
                             type=pa.int64()),
        })
    raise ValueError(f"Unknown verb {verb!r}; expected metrics, "
                     f"last_run_report, workload, perf_history, "
                     f"build_report, slow_queries, trace, doctor, "
                     f"fleet_status, alerts, lifecycle, or tenants")


def _is_loopback(host: str) -> bool:
    if host == "localhost":
        return True
    if host == "":
        return False  # "" binds INADDR_ANY: every interface
    import ipaddress

    try:
        return ipaddress.ip_address(host).is_loopback
    except ValueError:
        return False  # a hostname that cannot be classified: remote


class QueryServer:
    """Admission-controlled threaded TCP server bound to ``session``.
    ``port=0`` picks an ephemeral port (read it back from ``.address``).

    Sizing comes from the session's conf when the server is made
    (``serving_workers``, ``serving_queue_depth``,
    ``serving_max_connections``, ``serving_plan_cache_*``,
    ``serving_io_mode``); timeouts, deadlines, watermarks and the tenant
    quota are read per request, so a conf field set on a running server
    applies at once.  ``serving_io_mode = "async"`` swaps the thread per
    connection for the selector loop (:class:`_AsyncIOLoop`): the same
    bytes on the wire, one IO thread for every connection.

    ``handle_sigterm=True`` installs a SIGTERM handler (main thread only)
    that runs :meth:`drain` in the background; ``drained`` is set when
    the shutdown completes, so a serving script can simply
    ``server.drained.wait()``.

    ``proxy_endpoints=[...]`` makes this server a thin FRONT DOOR: its
    queries go on through a :class:`FleetQueryClient` over those
    backends (least-loaded routing, failover, retry-after backoff), so a
    client in another language gets the fleet's fault tolerance without
    writing it; the verbs still answer from THIS process."""

    def __init__(self, session, host: str = "127.0.0.1",
                 port: int = 0, allow_remote: bool = False,
                 handle_sigterm: bool = False,
                 proxy_endpoints: Optional[list] = None) -> None:
        # The server is UNAUTHENTICATED and reads any path the process
        # can: binding a non-loopback interface must be asked for.
        if not _is_loopback(host) and not allow_remote:
            raise ValueError(
                f"QueryServer binds {host!r}, a non-loopback interface, but "
                f"the protocol has no authentication: any peer that can "
                f"reach the port can read any file this process can.  Pass "
                f"allow_remote=True only behind a trusted network boundary.")

        outer = self

        class _Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

            def process_request(self, request, client_address):
                if not netfaults.on_accept(request):
                    return  # an armed net.accept fault consumed it
                if not outer._acquire_conn():
                    # Refused IN the accept loop: no thread is spawned, so
                    # a connection storm cannot grow the thread count past
                    # max_connections + workers.
                    _reject_connection(self, request)
                    self.shutdown_request(request)
                    return
                super().process_request(request, client_address)

            def process_request_thread(self, request, client_address):
                try:
                    super().process_request_thread(request, client_address)
                finally:
                    outer._release_conn()

        self._server = _Server((host, port), _Handler)
        self._server.session = session
        conf = session.conf
        # Telemetry fields set after the session was made must apply
        # before the first request's serve.request span opens.
        from hyperspace_tpu_torch.telemetry import trace as _trace

        _trace.configure_from_conf(conf)
        self._server.pool = _WorkerPool(
            session, workers=int(conf.serving_workers),
            queue_depth=int(conf.serving_queue_depth))
        if conf.serving_plan_cache_enabled:
            from hyperspace_tpu_torch.execution.plan_cache import PlanCache

            self._server.plan_cache = PlanCache(
                budget_bytes=int(conf.serving_plan_cache_bytes),
                ttl_s=float(conf.cache_expiry_seconds))
        else:
            self._server.plan_cache = None
        self._server.proxy_client = (
            FleetQueryClient(proxy_endpoints, conf=conf)
            if proxy_endpoints else None)
        self._io_mode = str(conf.serving_io_mode).strip().lower()
        if self._io_mode not in ("threaded", "async"):
            self._server.server_close()
            raise ValueError(
                f"the server's ioMode (conf.serving_io_mode) must be "
                f"'threaded' or 'async', got {self._io_mode!r}")
        self._async: Optional[_AsyncIOLoop] = None
        self._max_connections = int(conf.serving_max_connections)
        self._conn_lock = threading.Lock()
        self._conn_count = 0
        self._thread: Optional[threading.Thread] = None
        self._draining = False
        self.drained = threading.Event()
        if handle_sigterm:
            self._install_sigterm()

    # -- connection accounting ---------------------------------------------
    def _acquire_conn(self) -> bool:
        from hyperspace_tpu_torch.telemetry import metrics

        if self._draining:
            return False
        with self._conn_lock:
            if self._max_connections > 0 and \
                    self._conn_count >= self._max_connections:
                return False
            self._conn_count += 1
            count = self._conn_count
        metrics.set_gauge("serve.connections", count)
        return True

    def _release_conn(self) -> None:
        from hyperspace_tpu_torch.telemetry import metrics

        with self._conn_lock:
            self._conn_count = max(0, self._conn_count - 1)
            count = self._conn_count
        metrics.set_gauge("serve.connections", count)

    # -- surface -------------------------------------------------------------
    @property
    def session(self):
        return self._server.session

    @property
    def pool(self) -> _WorkerPool:
        return self._server.pool

    @property
    def plan_cache(self):
        return self._server.plan_cache

    @property
    def address(self) -> Tuple[str, int]:
        return self._server.server_address

    def start(self) -> "QueryServer":
        # A serving process publishes the role "server" and its address
        # in its fleet heartbeat (telemetry/fleet.py; off unless the conf
        # turns it on, and never raises), so the front door matches rows
        # to endpoints; a start clears a draining flag an earlier server
        # of this process left behind.
        from hyperspace_tpu_torch.telemetry import fleet

        fleet.set_process_role("server")
        fleet.set_serving_address(f"{self.address[0]}:{self.address[1]}")
        fleet.set_serving_draining(False)
        fleet.maybe_start(self.session)
        self._server.pool.start()
        if self._io_mode == "async":
            self._async = _AsyncIOLoop(self, self._server)
            self._async.start()
        else:
            self._thread = threading.Thread(
                target=self._server.serve_forever,
                name="hs-query-server", daemon=True)
            self._thread.start()
        return self

    def drain(self, grace_s: Optional[float] = None) -> bool:
        """Graceful shutdown: stop accepting new connections AND new
        requests (both shed ``ERR BUSY``), let in-flight requests finish
        within ``grace_s`` (default ``conf.serving_drain_grace_s``),
        dump the flight recorder's bundle, deregister the fleet
        heartbeat, then stop the workers and close the listener.  True
        when everything in flight completed inside the grace window.
        Idempotent."""
        from hyperspace_tpu_torch.lifecycle import daemon as _lifecycle
        from hyperspace_tpu_torch.telemetry import (
            fleet,
            flight_recorder,
            metrics,
        )

        if self.drained.is_set():
            return True
        if grace_s is None:
            grace_s = float(self.session.conf.serving_drain_grace_s)
        self._draining = True
        self._server.pool.draining = True
        metrics.inc("serve.drains")
        # Park the maintenance daemon too: a refresh racing this drain
        # would keep the process alive past its grace window (the latch
        # is process-wide).
        _lifecycle.notify_drain()
        # Flag the heartbeat draining and publish at once: the front door
        # skips draining rows, so new requests go elsewhere during the
        # grace window instead of shedding here (conf-gated, fault-quiet).
        fleet.set_serving_draining(True)
        fleet.publish_once(self.session.conf)
        if self._async is not None:
            self._async.stop_accepting()
        elif self._thread is not None:
            self._server.shutdown()  # stop the accept loop
        clean = self._server.pool.wait_idle(grace_s)
        # After the in-flight requests: a SIGTERM'd server leaves "what
        # happened" readable after a restart.  Never raises.
        flight_recorder.dump_diagnostics(self.session.conf)
        # A drained server is a planned exit, not a dead process: delete
        # its heartbeat, or the fleet doctor would page on every rolling
        # restart.  A SIGKILL skips this, which is how a dead one shows.
        fleet.publisher_for(self.session).stop()
        self._server.pool.stop()
        if self._async is not None:
            self._async.close()
        if self._server.proxy_client is not None:
            self._server.proxy_client.close()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self.drained.set()
        return clean

    def _install_sigterm(self) -> None:
        import signal

        def _on_term(signum, frame) -> None:
            threading.Thread(target=self.drain, name="hs-serve-drain",
                             daemon=True).start()

        try:
            signal.signal(signal.SIGTERM, _on_term)
        except ValueError:
            raise ValueError(
                "handle_sigterm=True requires constructing the "
                "QueryServer on the main thread (signal handlers are "
                "main-thread-only); call drain() from your own handler "
                "instead")

    def stop(self) -> None:
        # shutdown() waits on serve_forever's exit: on a server never
        # started it would wait forever, so only a started one does it;
        # server_close() releases the socket either way.
        if self.drained.is_set():
            return
        if self._thread is not None:
            self._server.shutdown()
        self._server.pool.stop()
        if self._async is not None:
            self._async.close()
        if self._server.proxy_client is not None:
            self._server.proxy_client.close()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def __enter__(self) -> "QueryServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


class MetricsScrapeServer:
    """A long-lived Prometheus scrape endpoint: ``GET /metrics`` (and
    ``/``) serves this process's metrics registry as text exposition
    (``telemetry/metrics.registry().render_prometheus()``: the
    ``build.*``, ``exec.*``, ``io.*``, ``serve.*`` and ``client.*``
    series of docs/16-observability.md); any other path is a 404.

    The pull-based twin of the ``metrics`` verb: the verb answers an
    Arrow client once, this endpoint stays up for a scraper's own
    schedule.  It binds loopback only unless ``allow_remote=True``, as
    :class:`QueryServer` does (series values leak index names and the
    workload's shape).

    ``fleet=True`` (it needs ``session``) serves the fleet's exposition
    instead (telemetry/fleet.py): every fresh heartbeat's series under
    ``session``'s system path and this process's live registry, each
    labelled ``process="<id>"``, so one scrape target answers for the
    fleet and the label says which server is slow.

    >>> with MetricsScrapeServer(port=9109) as ms:
    ...     ...  # curl http://127.0.0.1:9109/metrics
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 allow_remote: bool = False, session=None,
                 fleet: bool = False) -> None:
        if not _is_loopback(host) and not allow_remote:
            raise ValueError(
                f"MetricsScrapeServer binds {host!r}, a non-loopback "
                f"interface, without authentication.  Pass "
                f"allow_remote=True only behind a trusted boundary.")
        if fleet and session is None:
            raise ValueError(
                "MetricsScrapeServer(fleet=True) needs session=...: the "
                "merged exposition reads the fleet heartbeats under that "
                "session's system path")
        scrape_conf = session.conf if session is not None else None
        import http.server

        class _MetricsHandler(http.server.BaseHTTPRequestHandler):
            def do_GET(self) -> None:  # noqa: N802 - the stdlib's name
                if self.path.split("?")[0] not in ("/metrics", "/"):
                    self.send_error(404)
                    return
                from hyperspace_tpu_torch.telemetry import metrics

                if fleet:
                    from hyperspace_tpu_torch.telemetry.fleet import (
                        render_fleet_prometheus,
                    )

                    body = render_fleet_prometheus(scrape_conf).encode(
                        "utf-8")
                else:
                    body = metrics.registry().render_prometheus().encode(
                        "utf-8")
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args: object) -> None:
                pass  # a scrape a second must not flood stderr

        class _Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = _Server((host, port), _MetricsHandler)
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> Tuple[str, int]:
        return self._server.server_address

    def start(self) -> "MetricsScrapeServer":
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name="hs-metrics-server", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is not None:
            self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def __enter__(self) -> "MetricsScrapeServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def request_query(address: Tuple[str, int],
                  spec: Dict[str, Any]) -> "pa.Table":
    """One request on a new connection: send ``spec``, return the result
    table.  A client in another language does the same with its own
    socket and Arrow library."""
    with QueryClient(address) as client:
        return client.query(spec)


class QueryClient:
    """A persistent pipelined connection: successful ``query()`` calls
    ride one socket.  After an error response, a transport failure or
    the server's idle timeout the server closes the connection; the
    client marks itself broken, and later calls raise ``ConnectionError``
    asking for a new client.

    A wire error raises :class:`QueryFailedError` (a ``RuntimeError``)
    with ``.code`` and ``.retryable``.  Every request carries a
    client-minted trace context that the server adopts and echoes:
    ``.last_trace_id`` after a call (and ``QueryFailedError.trace_id``)
    is the id ``slow_queries`` and the ``trace`` verb answer for.

    ``tenant`` stamps every spec sent on this connection with a tenant
    id, the admission key of ``conf.serving_tenant_max_queued``; a spec's
    own ``"tenant"`` wins.  The dial, the sends and the reads pass the
    ``net.*`` fault seams (interop/netfaults.py); a torn or reset stream
    raises ``ConnectionError``."""

    def __init__(self, address: Tuple[str, int],
                 tenant: Optional[str] = None,
                 timeout_s: Optional[float] = None) -> None:
        self._sock = netfaults.connect(address, timeout=timeout_s)
        self._f = self._sock.makefile("rb")
        self._broken = False
        self.tenant = tenant
        #: The trace id of the latest query(): the server's echo, else
        #: the one minted here.
        self.last_trace_id: Optional[str] = None

    def is_stale(self) -> bool:
        """True when the socket is no longer usable: the server hung up
        (a nonblocking peek sees EOF or an error), or bytes are pending
        between requests, which a pipelined connection never has."""
        if self._broken:
            return True
        try:
            self._sock.setblocking(False)
            try:
                self._sock.recv(1, socket.MSG_PEEK)
            finally:
                self._sock.setblocking(True)
        except (BlockingIOError, InterruptedError):
            return False  # nothing pending: the healthy idle state
        except OSError:
            return True
        return True  # EOF or unexpected bytes

    def query(self, spec: Dict[str, Any],
              deadline_ms: Optional[float] = None,
              timeout_s: Optional[float] = None) -> "pa.Table":
        import pyarrow as pa

        from hyperspace_tpu_torch.interop.query import mint_trace_id

        if self._broken:
            raise ConnectionError(
                "connection closed by an earlier error or timeout; open a "
                "new QueryClient")
        if deadline_ms is not None:
            spec = {**spec, "deadline_ms": deadline_ms}
        if isinstance(spec, dict):
            if self.tenant is not None and "tenant" not in spec:
                spec = {**spec, "tenant": self.tenant}
            if "trace_id" not in spec:
                spec = {**spec, "trace_id": mint_trace_id()}
            if "request_id" not in spec:
                spec = {**spec, "request_id": mint_trace_id()}
            self.last_trace_id = spec["trace_id"]
        else:
            # A non-object spec still goes out: the server's BADREQ, not
            # a client-side crash, is the answer to it.
            self.last_trace_id = None
        try:
            if timeout_s is not None:
                # One socket timeout bounds the whole exchange.
                self._sock.settimeout(timeout_s)
            netfaults.send_all(
                self._sock, json.dumps(spec).encode("utf-8") + b"\n")
            netfaults.before_recv()
            status = self._f.readline().decode("utf-8").rstrip("\n")
        except OSError as exc:
            self._broken = True
            raise ConnectionError(f"connection lost: {exc}") from exc
        if not status.startswith("OK"):
            # ERR (the server closes) or EOF (idle timeout, server gone).
            self._broken = True
            if not status:
                raise ConnectionError(
                    "server closed the connection (idle timeout or "
                    "shutdown); open a new QueryClient")
            err = parse_wire_error(status)
            if err.trace_id is None:
                err.trace_id = self.last_trace_id
            else:
                self.last_trace_id = err.trace_id
            raise err
        _, echoed = _split_trace_echo(status[2:].strip())
        if echoed is not None:
            self.last_trace_id = echoed
        try:
            with pa.ipc.open_stream(self._f) as reader:
                return reader.read_all()
        except OSError as exc:
            self._broken = True
            raise ConnectionError(f"connection lost: {exc}") from exc
        except pa.ArrowInvalid as exc:
            # A garbled stream after a clean OK line: the connection died
            # mid-frame, a transport fault rather than a query failure.
            self._broken = True
            raise ConnectionError(
                f"response stream torn mid-frame: {exc}") from exc

    def close(self) -> None:
        self._f.close()
        self._sock.close()

    def __enter__(self) -> "QueryClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# -- the front door -----------------------------------------------------------
def _as_address(endpoint) -> Tuple[str, int]:
    """``"host:port"`` or ``(host, port)`` → ``(host, port)``."""
    if isinstance(endpoint, str):
        host, _, port = endpoint.rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(f"endpoint {endpoint!r} is not 'host:port'")
        return host, int(port)
    host, port = endpoint
    return str(host), int(port)


class _Endpoint:
    """One server behind the front door: its address, a pool of idle
    pipelined connections, the router's view of it (in-flight count,
    penalty clock) and its circuit breaker (closed → open on consecutive
    failures → half-open probe after the cooldown).  ``load`` (the
    server's published ``serve.inflight + serve.queue_depth``) and
    ``draining`` come from its fresh fleet heartbeat; without one the
    endpoint stays routable on local counts."""

    __slots__ = ("address", "label", "idle", "inflight", "penalized_until",
                 "load", "draining", "lock",
                 "breaker_state", "breaker_fails", "breaker_until")

    MAX_IDLE = 4  # idle pipelined connections kept per endpoint

    def __init__(self, endpoint) -> None:
        self.address = _as_address(endpoint)
        self.label = f"{self.address[0]}:{self.address[1]}"
        self.idle: List[QueryClient] = []
        self.inflight = 0
        self.penalized_until = 0.0   # monotonic; routing skips until then
        self.load: Optional[float] = None  # the fleet-reported load
        self.draining = False
        self.lock = threading.Lock()
        self.breaker_state = "closed"   # closed | open | half-open
        self.breaker_fails = 0          # consecutive failures while closed
        self.breaker_until = 0.0        # monotonic; open until then

    def acquire(self, tenant: Optional[str],
                timeout_s: Optional[float] = None) -> QueryClient:
        """An idle connection that passes a peek, or a new one.  A server
        that restarted leaves half-open TCP in the pool; handing that out
        would turn a routine bounce into a reset charged to the retries,
        so it is evicted here (``client.pool.evicted``).  The dial runs
        outside the lock, and a failed dial rolls the in-flight count
        back, so a dead endpoint does not look busy forever."""
        from hyperspace_tpu_torch.telemetry import metrics

        with self.lock:
            self.inflight += 1
        while True:
            with self.lock:
                client = self.idle.pop() if self.idle else None
            if client is None:
                break
            if client.is_stale():
                metrics.inc("client.pool.evicted")
                try:
                    client.close()
                except OSError:
                    pass
                continue
            client.tenant = tenant
            return client
        try:
            return QueryClient(self.address, tenant=tenant,
                               timeout_s=timeout_s)
        except OSError:
            with self.lock:
                self.inflight -= 1
            raise

    # -- circuit breaker -----------------------------------------------------
    def breaker_blocked(self, now: float) -> bool:
        """True when routing should avoid this endpoint: its breaker open
        inside the cooldown, or a half-open probe already in flight."""
        with self.lock:
            if self.breaker_state == "open":
                return now < self.breaker_until
            return self.breaker_state == "half-open"

    def breaker_on_pick(self, now: float) -> bool:
        """Open → half-open when the cooldown is over and this endpoint
        was PICKED (the probe).  True on that transition."""
        with self.lock:
            if self.breaker_state == "open" and now >= self.breaker_until:
                self.breaker_state = "half-open"
                return True
        return False

    def breaker_failure(self, threshold: int, cooldown_s: float) -> bool:
        """A retryable or transport failure.  True when it OPENED the
        breaker (the threshold reached, or the half-open probe failed)."""
        now = time.monotonic()
        with self.lock:
            if self.breaker_state == "half-open":
                self.breaker_state = "open"
                self.breaker_until = now + cooldown_s
                return True
            self.breaker_fails += 1
            if self.breaker_state == "closed" \
                    and self.breaker_fails >= max(1, threshold):
                self.breaker_state = "open"
                self.breaker_until = now + cooldown_s
                return True
        return False

    def breaker_success(self) -> bool:
        """A served request.  True when it CLOSED a breaker that was not
        closed (the half-open probe came back)."""
        with self.lock:
            was = self.breaker_state
            self.breaker_state = "closed"
            self.breaker_fails = 0
            return was != "closed"

    def release(self, client: QueryClient) -> None:
        with self.lock:
            self.inflight -= 1
            if len(self.idle) < self.MAX_IDLE:
                self.idle.append(client)
                return
        client.close()

    def discard(self, client: QueryClient) -> None:
        with self.lock:
            self.inflight -= 1
        try:
            client.close()
        except OSError:
            pass

    def close_idle(self) -> None:
        with self.lock:
            idle, self.idle = self.idle, []
        for client in idle:
            try:
                client.close()
            except OSError:
                pass


class FleetQueryClient:
    """A fault-tolerant front door over N :class:`QueryServer` endpoints.

    Routing is LEAST-LOADED.  Given a ``conf`` with the servers' system
    path, the client reads their fresh fleet heartbeats (at most once per
    ``status_refresh_s``): each carries the server's address, its
    ``serve.inflight`` and ``serve.queue_depth`` gauges and a
    ``draining`` flag.  Rows are matched to endpoints by address,
    draining endpoints are skipped, and each request goes to the least
    loaded of the rest (published load plus this client's in-flight
    count; round-robin among ties).  An endpoint without a fresh row
    stays routable on the local count alone.

    Failures:

      - RETRYABLE: ``BUSY``/``DEADLINE`` wire errors and transport faults
        (refused, reset, EOF, a torn stream, a socket timeout) retry on
        ANOTHER endpoint when there is one, after a jittered exponential
        backoff; a ``retry-after-ms`` hint replaces the backoff's step
        and penalises that endpoint for the hinted window, so the next
        pick avoids it.
      - PERMANENT: ``BADREQ``/``FAILED`` raise at once.  A CUDA error or
        ``torch.OutOfMemoryError`` in a backend arrives as ``FAILED``
        and is not retried.

    Retries count ``client.retry`` and ``client.retry.<kind>``; a retry
    that lands on another endpoint than the failed one counts
    ``client.failover``.  ``tenant`` stamps every spec with the servers'
    admission key.

    DEADLINE BUDGET: ``deadline_ms`` is ONE budget for the whole call:
    dials, socket reads, backoff sleeps, the hedge's delay and the
    server-side deadline all spend from it, so every failover attempt
    together stays inside the caller's bound.

    CIRCUIT BREAKERS (``conf.client_breaker_*``, off by default):
    ``failures`` consecutive retryable or transport errors open an
    endpoint's breaker; routing avoids it for ``cooldown_ms``, then ONE
    half-open probe decides (a success closes it, a failure re-opens it).
    Transitions count ``client.breaker.open``/``.half_open``/``.close``;
    the ``client.breaker.open_now`` gauge is what the doctor's ``client``
    check grades.

    HEDGED REQUESTS (``conf.client_hedge_*``, off by default): when the
    first attempt is slower than the hedge delay (``hedge_delay_ms``, or
    twice the latency EWMA when 0), one more attempt goes to another
    endpoint; the first answer wins and the loser's late answer is
    dropped by its request_id (each attempt reads its own connection, so
    a late frame never lands on the winner's).  ``client.hedge.sent`` and
    ``client.hedge.wins`` count them.  Every request here is a read, so
    sending it twice is safe.

    The backoff's jitter comes from this client's own ``random.Random``,
    uniform in [0.5, 1.5) × the step.

    >>> with FleetQueryClient(["127.0.0.1:9001", "127.0.0.1:9002"],
    ...                       conf=session.conf) as fleet:
    ...     fleet.query({"index": "idx", "point": {"id": 7}})
    """

    def __init__(self, endpoints: Sequence[Union[str, Tuple[str, int]]],
                 conf=None, tenant: Optional[str] = None,
                 max_attempts: Optional[int] = None,
                 backoff_cap_ms: float = 2000.0,
                 status_refresh_s: float = 1.0,
                 hedge_enabled: Optional[bool] = None,
                 hedge_delay_ms: Optional[float] = None,
                 breaker_enabled: Optional[bool] = None,
                 breaker_failures: Optional[int] = None,
                 breaker_cooldown_ms: Optional[float] = None) -> None:
        if not endpoints:
            raise ValueError("FleetQueryClient needs at least one endpoint")
        self._endpoints = [_Endpoint(e) for e in endpoints]
        self._conf = conf
        self._tenant = tenant
        self._max_attempts = int(max_attempts if max_attempts is not None
                                 else max(3, len(self._endpoints)))
        self._backoff_cap_ms = float(backoff_cap_ms)
        self._status_refresh_s = float(status_refresh_s)
        self._status_stamp = 0.0  # monotonic; 0 forces a first refresh
        self._rng = random.Random()
        self._rr = 0
        # Guards _rr, _status_stamp and _lat_ewma_ms only; never held
        # across a dial, a send or a sleep.
        self._lock = threading.Lock()

        def _opt(value, field, default):
            if value is not None:
                return value
            return getattr(conf, field) if conf is not None else default

        self._hedge_enabled = bool(
            _opt(hedge_enabled, "client_hedge_enabled", False))
        self._hedge_delay_ms = float(
            _opt(hedge_delay_ms, "client_hedge_delay_ms", 0.0))
        self._breaker_enabled = bool(
            _opt(breaker_enabled, "client_breaker_enabled", False))
        self._breaker_failures = int(
            _opt(breaker_failures, "client_breaker_failures", 5))
        self._breaker_cooldown_ms = float(
            _opt(breaker_cooldown_ms, "client_breaker_cooldown_ms", 2000.0))
        self._lat_ewma_ms = 0.0  # the successful requests' latency EWMA
        #: The trace id of the latest query(), as on QueryClient.
        self.last_trace_id: Optional[str] = None

    # -- routing --------------------------------------------------------------
    def _refresh_status(self) -> None:
        """Fold the fresh fleet heartbeats into the endpoint table, by
        their ``address``.  At most once per ``status_refresh_s``; on any
        failure routing keeps the local in-flight counts."""
        if self._conf is None:
            return
        now = time.monotonic()
        with self._lock:
            if now - self._status_stamp < self._status_refresh_s:
                return
            self._status_stamp = now
        try:
            from hyperspace_tpu_torch.telemetry import fleet

            rows = {}
            for snap in fleet.fresh_snapshots(self._conf):
                addr = str(snap.get("address", "") or "")
                if addr:
                    rows[addr] = snap
        except Exception:  # noqa: BLE001 - telemetry never breaks routing
            return
        for ep in self._endpoints:
            snap = rows.get(ep.label)
            if snap is None:
                # No fresh row (the server may publish none): routable on
                # local counts.
                ep.load = None
                ep.draining = False
                continue
            gauges = snap.get("metrics", {}).get("gauges", {})
            ep.load = (float(gauges.get("serve.inflight", 0.0)) +
                       float(gauges.get("serve.queue_depth", 0.0)))
            ep.draining = bool(snap.get("draining", False))

    def _pick(self, tried: set,
              exclude: Optional[set] = None) -> _Endpoint:
        """The least-loaded routable endpoint not yet tried for this
        request, relaxing step by step (breaker-blocked and penalised
        allowed, then draining, then tried) rather than failing a pick
        while any endpoint exists.  ``exclude`` labels (the hedge's other
        attempt) are avoided at every tier but the last."""
        from hyperspace_tpu_torch.telemetry import metrics

        self._refresh_status()
        now = time.monotonic()
        exclude = exclude or set()

        def _tier(skip_tried: bool = True, skip_draining: bool = True,
                  skip_penalized: bool = False,
                  skip_broken: bool = False) -> List[_Endpoint]:
            return [ep for ep in self._endpoints
                    if ep.label not in exclude
                    and (not skip_tried or ep.label not in tried)
                    and (not skip_draining or not ep.draining)
                    and (not skip_penalized or now >= ep.penalized_until)
                    and (not skip_broken
                         or not ep.breaker_blocked(now))]

        pool = (_tier(skip_penalized=True,
                      skip_broken=self._breaker_enabled)
                or _tier()
                or _tier(skip_draining=False)
                or [ep for ep in self._endpoints if ep.label not in exclude]
                or self._endpoints)

        def _load(ep: _Endpoint) -> float:
            base = ep.load if ep.load is not None else 0.0
            return base + ep.inflight

        low = min(_load(ep) for ep in pool)
        ties = [ep for ep in pool if _load(ep) <= low]
        with self._lock:
            self._rr += 1
            ep = ties[self._rr % len(ties)]
        if self._breaker_enabled and ep.breaker_on_pick(now):
            metrics.inc("client.breaker.half_open")
            self._breaker_gauge()
        return ep

    def _breaker_gauge(self) -> None:
        from hyperspace_tpu_torch.telemetry import metrics

        metrics.set_gauge(
            "client.breaker.open_now",
            sum(1 for ep in self._endpoints
                if ep.breaker_state != "closed"))

    # -- the request path -----------------------------------------------------
    def query(self, spec: Dict[str, Any],
              deadline_ms: Optional[float] = None) -> "pa.Table":
        deadline_at = (time.monotonic() + float(deadline_ms) / 1000.0
                       if deadline_ms is not None else None)
        if self._hedge_enabled and isinstance(spec, dict):
            return self._query_hedged(spec, deadline_ms, deadline_at)
        return self._query_attempts(spec, deadline_ms, deadline_at)

    @staticmethod
    def _remaining_ms(deadline_at: Optional[float]) -> Optional[float]:
        if deadline_at is None:
            return None
        return (deadline_at - time.monotonic()) * 1000.0

    def _observe_latency(self, elapsed_ms: float) -> None:
        with self._lock:
            self._lat_ewma_ms = elapsed_ms if self._lat_ewma_ms <= 0.0 \
                else 0.8 * self._lat_ewma_ms + 0.2 * elapsed_ms

    def _query_attempts(self, spec: Dict[str, Any],
                        deadline_ms: Optional[float],
                        deadline_at: Optional[float],
                        exclude: Optional[set] = None,
                        note: Optional[Dict[str, Any]] = None,
                        max_attempts: Optional[int] = None) -> "pa.Table":
        """The retry and failover loop under ONE deadline budget: each
        attempt's socket timeout, server-side deadline and backoff sleep
        are bounded by what remains of ``deadline_ms``."""
        from hyperspace_tpu_torch.telemetry import metrics

        attempts_cap = int(max_attempts) if max_attempts is not None \
            else self._max_attempts
        last_exc: Optional[Exception] = None
        last_label: Optional[str] = None
        tried: set = set()
        for attempt in range(1, attempts_cap + 1):
            remaining = self._remaining_ms(deadline_at)
            if remaining is not None and remaining <= 1.0:
                break  # the budget is spent: raise the last failure
            if len(tried) >= len(self._endpoints):
                tried.clear()  # every endpoint failed once: start over
            ep = self._pick(tried, exclude=exclude)
            tried.add(ep.label)
            if note is not None:
                note.setdefault("labels", set()).add(ep.label)
            if last_label is not None and last_label != ep.label:
                # A retry routed AWAY from the endpoint that failed.
                metrics.inc("client.failover")
            # Spread what remains over the attempts left (at most one per
            # endpoint): a GRAY server, alive and answering nothing, would
            # otherwise eat the whole budget in one socket timeout.
            if remaining is not None:
                spread = max(1, min(attempts_cap - attempt + 1,
                                    len(self._endpoints)))
                timeout_s = remaining / 1000.0 / spread + 0.05
            else:
                timeout_s = None
            retry_after_ms: Optional[float] = None
            kind = "connection"
            t0 = time.monotonic()
            try:
                client = ep.acquire(self._tenant, timeout_s=timeout_s)
            except OSError as exc:
                last_exc = ConnectionError(
                    f"connect to {ep.label} failed: {exc}")
            else:
                try:
                    table = client.query(
                        spec,
                        deadline_ms=self._remaining_ms(deadline_at)
                        if deadline_at is not None else deadline_ms,
                        timeout_s=timeout_s)
                except QueryFailedError as exc:
                    # The server closed the connection after its ERR.
                    ep.discard(client)
                    self.last_trace_id = exc.trace_id
                    if not exc.retryable:
                        raise  # BADREQ/FAILED: the same answer anywhere
                    kind = exc.code.lower()
                    retry_after_ms = exc.retry_after_ms
                    last_exc = exc
                except OSError as exc:  # ConnectionError, TimeoutError
                    ep.discard(client)
                    last_exc = exc
                else:
                    ep.release(client)
                    self.last_trace_id = client.last_trace_id
                    self._observe_latency(
                        (time.monotonic() - t0) * 1000.0)
                    if self._breaker_enabled and ep.breaker_success():
                        metrics.inc("client.breaker.close")
                        self._breaker_gauge()
                    return table
            metrics.inc("client.retry")
            metrics.inc(f"client.retry.{kind}")
            last_label = ep.label
            if self._breaker_enabled and ep.breaker_failure(
                    self._breaker_failures,
                    self._breaker_cooldown_ms / 1000.0):
                metrics.inc("client.breaker.open")
                self._breaker_gauge()
            # Penalise the endpoint for the server's hinted window (or a
            # nominal beat) so the next pick avoids it.
            ep.penalized_until = time.monotonic() + \
                (retry_after_ms or 100.0) / 1000.0
            if attempt < attempts_cap:
                if not self._backoff(attempt, retry_after_ms, deadline_at):
                    break  # no budget left to sleep AND try again
        if last_exc is None:
            last_exc = TimeoutError(
                f"deadline budget ({deadline_ms} ms) exhausted before "
                f"any attempt completed")
        raise last_exc

    def _query_hedged(self, spec: Dict[str, Any],
                      deadline_ms: Optional[float],
                      deadline_at: Optional[float]) -> "pa.Table":
        """The attempts loop on a thread; when it is slower than the
        hedge delay, ONE more single attempt on another endpoint.  The
        first answer wins; the loser reads its own connection to the end
        on its thread and its answer is dropped by request_id."""
        from hyperspace_tpu_torch.interop.query import mint_trace_id
        from hyperspace_tpu_torch.telemetry import metrics

        lock = threading.Lock()
        done = threading.Event()
        state: Dict[str, Any] = {"winner": None, "table": None,
                                 "trace": None, "outstanding": 1}
        errs: Dict[str, Exception] = {}
        primary_note: Dict[str, Any] = {}

        def _runner(tag: str, req_spec: Dict[str, Any],
                    exclude: Optional[set], note: Optional[dict],
                    max_attempts: Optional[int] = None) -> None:
            try:
                # The hedge runs ONE attempt: it is there to beat a slow
                # primary, not to run the retry ladder a second time.
                table = self._query_attempts(
                    req_spec, deadline_ms, deadline_at,
                    exclude=exclude, note=note, max_attempts=max_attempts)
            except Exception as exc:  # noqa: BLE001 - raised by query()
                with lock:
                    errs[tag] = exc
                    state["outstanding"] -= 1
                    if state["outstanding"] <= 0 \
                            and state["winner"] is None:
                        done.set()
            else:
                with lock:
                    state["outstanding"] -= 1
                    if state["winner"] is None:
                        state["winner"] = tag
                        state["table"] = table
                        state["trace"] = self.last_trace_id
                        done.set()
                    # else: the loser; its request_id lost the race and
                    # its whole answer is dropped here.

        primary_spec = {**spec, "request_id": mint_trace_id()}
        threading.Thread(
            target=_runner, args=("primary", primary_spec, None,
                                  primary_note),
            name="hs-client-primary", daemon=True).start()

        delay_s = self._hedge_delay_s()
        remaining = self._remaining_ms(deadline_at)
        if remaining is not None:
            delay_s = min(delay_s, max(0.0, remaining / 1000.0))
        fired = False
        if not done.wait(delay_s) and len(self._endpoints) > 1:
            with lock:
                slow_primary = state["winner"] is None \
                    and state["outstanding"] > 0
                if slow_primary:
                    state["outstanding"] += 1
            if slow_primary:
                remaining = self._remaining_ms(deadline_at)
                if remaining is None or remaining > 5.0:
                    metrics.inc("client.hedge.sent")
                    fired = True
                    hedge_spec = {**spec, "request_id": mint_trace_id()}
                    threading.Thread(
                        target=_runner,
                        args=("hedge", hedge_spec,
                              set(primary_note.get("labels", set())),
                              None, 1),
                        name="hs-client-hedge", daemon=True).start()
                else:
                    with lock:
                        state["outstanding"] -= 1
        remaining = self._remaining_ms(deadline_at)
        # The attempts' socket timeouts spend the budget, so a short
        # grace past the deadline lets both threads settle.
        done.wait(remaining / 1000.0 + 0.5 if remaining is not None
                  else None)
        with lock:
            if state["winner"] is not None:
                if fired and state["winner"] == "hedge":
                    metrics.inc("client.hedge.wins")
                self.last_trace_id = state["trace"]
                return state["table"]
            exc = errs.get("primary") or errs.get("hedge")
        if exc is not None:
            raise exc
        raise TimeoutError(
            f"deadline budget ({deadline_ms} ms) exhausted before any "
            f"attempt completed")

    def _hedge_delay_s(self) -> float:
        """The wait before a hedge: the configured delay, or, when 0,
        twice the latency EWMA within [10 ms, 500 ms] (50 ms with no
        history yet)."""
        if self._hedge_delay_ms > 0.0:
            return self._hedge_delay_ms / 1000.0
        with self._lock:
            ewma = self._lat_ewma_ms
        if ewma <= 0.0:
            return 0.050
        return min(0.500, max(0.010, 2.0 * ewma / 1000.0))

    def _backoff(self, attempt: int, retry_after_ms: Optional[float],
                 deadline_at: Optional[float] = None) -> bool:
        """Jittered exponential backoff; the server's ``retry-after-ms``
        hint is the step when there is one, and what remains of the
        deadline budget caps it.  False when the budget cannot pay for
        the sleep (the caller stops retrying)."""
        step = retry_after_ms if retry_after_ms is not None \
            else 50.0 * (2.0 ** (attempt - 1))
        delay_ms = min(self._backoff_cap_ms, step) * \
            (0.5 + self._rng.random())
        remaining = self._remaining_ms(deadline_at)
        if remaining is not None:
            if remaining <= 2.0:
                return False
            delay_ms = min(delay_ms, remaining - 1.0)
        time.sleep(delay_ms / 1000.0)
        return True

    def close(self) -> None:
        for ep in self._endpoints:
            ep.close_idle()
        if self._breaker_enabled:
            # The gauge describes THIS client's routing table: with the
            # client gone nothing is open, and a stale nonzero would keep
            # the doctor's client check warning.
            from hyperspace_tpu_torch.telemetry import metrics

            metrics.set_gauge("client.breaker.open_now", 0.0)

    def __enter__(self) -> "FleetQueryClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
