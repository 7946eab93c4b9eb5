"""Session configuration (counterpart of hyperspace_tpu/config.py,
holding the fields the build, the refresh and optimize verbs, the query
path, the device column cache, the build reports and the integrity loop
read, the explain display mode, the failure envelope, the advisor, the
index lifecycle, the source watch, the transaction loop, telemetry, the
sync guard, the doctor, deadlines, the mesh, the plan cache, the flight
recorder, the pluggable log and store classes, the source providers,
and the source formats and globbing pattern of the default provider;
defaults are the JAX package's, with the class paths under the port's
own modules).

The routing thresholds default to None: ``device_min_rows(kind, device)``
and ``resident_min_rows(kind, device)`` then take the value calibration
derives for the session's device (``utils/calibrate.py``), or its static
constants (2**26 cold and 2**20-2**24 resident rows, 2**22 for the
build) when calibration is off, its probe failed or the device is the
CPU.  A value set explicitly always wins.  Below a threshold a batch
takes the host route (arrow predicate, numpy join, arrow group-by, the
build's numpy mirror), as in the JAX package; once an operation's
columns are resident in the device column cache, the resident threshold
governs instead, so a forced host route needs both raised."""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

from hyperspace_tpu_torch.io.parquet import INDEX_COMPRESSION_DEFAULT


@dataclasses.dataclass
class HyperspaceConf:
    system_path: Optional[str] = None
    num_buckets: int = 200
    # Stamp each index row with its source file's id (``_data_file_id``):
    # what incremental refresh with deletes and hybrid scan over deleted
    # files need.
    lineage_enabled: bool = False
    # Hybrid scan: a stale index answers with its deleted files' rows
    # filtered out and the appended files read beside it, while the
    # appended (deleted) bytes stay within these shares of the current
    # (indexed) bytes.
    hybrid_scan_enabled: bool = False
    hybrid_scan_max_appended_ratio: float = 0.3
    hybrid_scan_max_deleted_ratio: float = 0.2
    # Quick optimize compacts only index files smaller than this.
    optimize_file_size_threshold: int = 256 * 1024 * 1024
    # Split each bucket's sorted run into files of at most this many rows
    # (0 = one file per bucket).
    index_max_rows_per_file: int = 0
    signature_provider: str = "IndexSignatureProvider"
    # The operation log's backend, a dotted class path of an
    # IndexLogManager subclass: the default creates entries with O_EXCL
    # and moves the pointer by an atomic rename; ObjectStoreLogManager
    # (index/object_log_manager.py) needs neither, only the conditional
    # puts of a LogStore.
    log_manager_class: str = (
        "hyperspace_tpu_torch.index.log_manager.IndexLogManager")
    # The LogStore class (io/log_store.py) of ObjectStoreLogManager's log
    # and of every store of records (quarantine, workload, journal,
    # lease, watch bus, perf ledger, diagnostics bundles).
    log_store_class: str = (
        "hyperspace_tpu_torch.io.log_store.EmulatedObjectStore")
    # EmulatedObjectStore's listing window (ms): keys committed within it
    # are not listed yet, while point reads see them.
    object_store_stale_list_ms: float = 0.0
    # The source providers (sources/manager.py), comma-separated names
    # of its registry; a name not registered raises.
    source_providers: str = "default,delta,iceberg"
    # The source formats the default provider reads, comma-separated.
    supported_file_formats: str = "avro,csv,json,orc,parquet,text"
    # Comma-separated glob patterns; when set, create_index records the
    # patterns as the relation's root paths (each root must match one),
    # so a refresh picks up directories that appeared since.
    globbing_pattern: str = ""
    # The most rows one build holds on the device at once; env
    # HS_DEVICE_BATCH_ROWS overrides the default.
    device_batch_rows: int = dataclasses.field(
        default_factory=lambda: int(
            os.environ.get("HS_DEVICE_BATCH_ROWS", 1 << 20)))
    # The spill build's pipeline: off runs the forced-serial reference
    # (inline reads, inline routing, sequential finalize), the same bytes.
    build_pipeline_enabled: bool = True
    # Source files decoded ahead of the route (the prefetch backpressure).
    build_prefetch_depth: int = 2
    # Threads that merge and write the closed bucket groups.
    build_finalize_workers: int = 4
    # Parquet codec for index data files ("none" = uncompressed).
    index_file_compression: str = INDEX_COMPRESSION_DEFAULT
    # Filter rule: carry the bucket spec on index scans even when the
    # predicate prunes no bucket.
    filter_rule_use_bucket_spec: bool = False
    # Rows from which a filter / a join / a grouped aggregate / the
    # build's hash and sort run on the session's device; None derives the
    # threshold from calibration.
    device_filter_min_rows: Optional[int] = None
    device_join_min_rows: Optional[int] = None
    device_agg_min_rows: Optional[int] = None
    device_build_min_rows: Optional[int] = None
    # The device column cache (execution/device_cache.py): byte budget
    # for the post-decode columns kept on the device across queries,
    # keyed by file identity; 0 disables it.
    device_cache_bytes: int = 1 << 30
    # "auto": cache when the device path runs anyway; "eager": take the
    # device on first use for scans whose columns can be cached (pay the
    # upload once, serve repeats from card memory); "off": never cache.
    device_cache_policy: str = "auto"
    # Rows from which an operation whose inputs are already resident (or
    # will be, under "eager") runs on the device; a value set applies to
    # every kind, None calibrates one per kind.
    device_resident_min_rows: Optional[int] = None
    # The mesh of logical shards (parallel/mesh.py): "auto" takes the
    # sharded paths (the spill route, the mesh filter, join and
    # aggregates) when at least 2 local devices are seen, "on" too (still
    # nothing below 2), "off" never (the same bytes and answers either
    # way); mesh_max_devices caps the devices it spans (0 = all).
    mesh_enabled: str = "auto"
    mesh_max_devices: int = 0
    # Rows from which, with a mesh, a device filter, a join (and the
    # bucketed join's buckets, and the fused join->aggregate) and a
    # grouped aggregate run over the mesh.
    mesh_filter_min_rows: int = 1 << 24
    mesh_join_min_rows: int = 1 << 24
    mesh_agg_min_rows: int = 1 << 24
    # The monolithic build over the mesh (parallel/build.py): "auto" when
    # more than one local device is seen, "on" always, which also keeps
    # a source beyond one batch in one monolithic build, "off" never.
    parallel_build: str = "auto"
    # The multi-host build (parallel/multihost_build.py): hosts >= 1 runs
    # create_index as that many host subprocesses under work claims (0:
    # the build of this process); a claim expires claim_ttl_s after its
    # last renew, and a survivor reclaims it; hosts and the coordinator
    # poll the claim table every poll_s; the coordinator fails the build
    # past deadline_s.
    multihost_build_hosts: int = 0
    multihost_build_claim_ttl_s: float = 10.0
    multihost_build_poll_s: float = 0.05
    multihost_build_deadline_s: float = 600.0
    # Build reports (telemetry/build_report.py): off keeps the phase
    # seconds and bytes but skips the memory sampling, the metric and
    # span export and the perf-ledger append.
    build_profiling_enabled: bool = True
    # The optimistic transaction loop (actions/base.py): on a write
    # conflict a manager-dispatched action rebases on the winner's log
    # entry and retries after a jittered backoff (the io_retry_* delays),
    # up to this many extra attempts (0: the first conflict raises).
    concurrency_max_retries: int = 3
    # Telemetry (telemetry/; docs/16-observability.md):
    #   - event_logger: a registered logger name or a dotted class path
    #     (telemetry/events.py); "" keeps the no-op logger;
    #   - tracing: per-query and per-action span trees, and a JSONL file
    #     every finished root span is appended to, rotated past max bytes
    #     (0: unbounded);
    #   - timeline: build phases, executor operators and the device
    #     programs' CUDA-event seams as intervals in a bounded ring, and a
    #     memory sampler during actions at the cadence (0: no sampler);
    #     off, each seam costs one bool check and no torch.cuda call;
    #   - perf ledger: one record per action under
    #     <systemPath>/_hyperspace_perf, the oldest pruned past the cap.
    event_logger: str = ""
    telemetry_tracing_enabled: bool = False
    telemetry_trace_sink: str = ""
    telemetry_trace_max_bytes: int = 256 << 20
    timeline_enabled: bool = False
    timeline_max_intervals: int = 8192
    timeline_memory_sample_ms: float = 25.0
    perf_ledger_enabled: bool = True
    perf_ledger_max_entries: int = 2048
    # The integrity loop (io/integrity.py, actions/verify.py,
    # index/quarantine.py, actions/repair.py):
    #   - digest on write: hash every index data file as it lands and
    #     record the digest in its FileInfo; off, files commit without
    #     one and a full scrub reports them "unknown";
    #   - quarantine on failure: when reading an index file fails at
    #     execution, probe the files the plan read, quarantine the
    #     damaged ones and re-plan with their buckets read from source;
    #   - auto repair: after such a re-plan answered, rebuild the
    #     quarantined buckets (refresh mode "repair") in the same call;
    #   - degraded fallback: when containment cannot answer, re-run the
    #     query against the source without the indexes; a rewrite rule
    #     or an index listing that fails on index metadata leaves the
    #     index out of the plan (off: DegradedIndexError, or the rule's
    #     own error).
    integrity_digest_on_write: bool = True
    integrity_quarantine_on_failure: bool = True
    auto_repair_enabled: bool = False
    degraded_fallback_to_source: bool = True
    # The failure envelope (io/faults.py, utils/retry.py):
    #   - transient IO errors (EIO, ENOSPC, ...) of the op log, listings
    #     and data files retry this many times in all, with exponential
    #     backoff from the initial delay up to the cap, jittered;
    #   - auto recovery: before each lifecycle verb, a transient latest
    #     log entry (an action that died mid-flight) is rolled back, an
    #     implicit cancel();
    #   - the listing of ACTIVE entries the optimizer reads is cached for
    #     this many seconds, and cleared by every lifecycle verb;
    #   - fault injection armed through the conf (the session installs
    #     it): site, kind, the first call to fail and how many fail;
    #     a wire kind's shaping (io/faults.py net.* sites): the delay a
    #     ``slow`` adds and how long a ``black-hole`` hangs.
    io_retry_max_attempts: int = 3
    io_retry_initial_backoff_ms: float = 10.0
    io_retry_max_backoff_ms: float = 1000.0
    auto_recovery_enabled: bool = False
    cache_expiry_seconds: int = 300
    fault_injection_enabled: bool = False
    fault_injection_site: str = ""
    fault_injection_kind: str = ""
    fault_injection_at: int = 1
    fault_injection_count: int = 1
    fault_injection_latency_ms: float = 25.0
    fault_injection_hang_s: float = 0.25
    # The index advisor (advisor/): capture a fingerprint of each collect
    # (at most this many distinct shapes), and enumerate at most this
    # many candidate indexes.
    advisor_capture_enabled: bool = False
    advisor_capture_max_entries: int = 512
    advisor_max_candidates: int = 20
    # The autonomous index lifecycle (lifecycle/):
    #   - enabled: the opt-in maintenance daemon thread
    #     (``Hyperspace.start_maintenance``), one cycle every interval;
    #     ``Hyperspace.maintenance_cycle()`` runs one cycle regardless;
    #   - byte budget: the on-disk index bytes the advisor pass may grow
    #     the indexes to (0: no autonomous create or delete);
    #   - quick append ratio: appended plus pending bytes over recorded
    #     bytes below which an append takes the quick refresh (with
    #     hybrid scan on); full churn ratio: the changed share of the
    #     recorded files from which a full rebuild is chosen;
    #   - the journal keeps at most this many decisions;
    #   - a failed action backs its index off from the initial delay,
    #     doubling per failure up to the cap;
    #   - lease: one daemon per system path holds the maintenance lease
    #     (lifecycle/lease.py), renewed each cycle, expiring after ttl;
    #   - CDC merge-on-read: deletes and rewrites with lineage and
    #     hybrid scan take the quick refresh while the merge debt stays
    #     within its ratio of the recorded bytes;
    #   - compaction: an otherwise idle index with at least this many
    #     mergeable small files gets an optimize in ``mode``.
    lifecycle_enabled: bool = False
    lifecycle_interval_s: float = 30.0
    lifecycle_byte_budget: int = 0
    lifecycle_quick_append_ratio: float = 0.1
    lifecycle_full_churn_ratio: float = 0.5
    lifecycle_journal_max_entries: int = 1024
    lifecycle_backoff_initial_s: float = 1.0
    lifecycle_backoff_max_s: float = 300.0
    lifecycle_lease_enabled: bool = False
    lifecycle_lease_ttl_s: float = 30.0
    lifecycle_cdc_enabled: bool = False
    lifecycle_cdc_merge_debt_ratio: float = 0.2
    lifecycle_compaction_enabled: bool = False
    lifecycle_compaction_min_small_files: int = 8
    lifecycle_compaction_mode: str = "quick"
    # The query server (interop/server.py):
    #   - workers: query-executing threads per QueryServer, the bound on
    #     concurrent execution; queue_depth: admitted requests waiting
    #     for a worker (a full queue sheds ERR BUSY); max_connections:
    #     open connections (past it the accept loop answers ERR BUSY
    #     without spawning a thread).  Read when the server is made.
    #   - default_deadline_ms: the deadline of a request that names none
    #     (0: none); request_timeout_s / send_timeout_s: the socket's
    #     read and write timeouts; drain_grace_s: how long drain() lets
    #     in-flight requests finish.
    #   - shed_rss_watermark_mb (a maintenance cycle reads it too) and
    #     shed_queue_wait_watermark_ms: past either (0: off) new
    #     requests shed ERR BUSY, and a maintenance cycle journals a skip.
    #   - plan_cache_*: the server's optimize-result cache
    #     (execution/plan_cache.py) and its byte budget.
    #   - io_mode: "threaded" (one thread per connection) or "async" (one
    #     selector thread reads every connection, workers + 4 dispatcher
    #     threads answer); read when the server is made.
    #   - tenant_max_queued: admitted requests of one tenant (a spec's
    #     "tenant") queued or running at once; past it that tenant sheds
    #     ERR BUSY (0: no quota).
    serving_workers: int = 4
    serving_queue_depth: int = 16
    serving_max_connections: int = 64
    serving_default_deadline_ms: float = 0.0
    serving_request_timeout_s: float = 30.0
    serving_send_timeout_s: float = 30.0
    serving_drain_grace_s: float = 10.0
    serving_shed_rss_watermark_mb: float = 0.0
    serving_shed_queue_wait_watermark_ms: float = 0.0
    serving_plan_cache_enabled: bool = True
    serving_plan_cache_bytes: int = 64 << 20
    serving_io_mode: str = "threaded"
    serving_tenant_max_queued: int = 0
    # The front door (interop/server.FleetQueryClient); both features
    # off by default, so the plain request path adds only a bool check.
    #   - hedge_enabled / hedge_delay_ms: when the first attempt is slower
    #     than the delay (0: twice the client's latency EWMA), a second
    #     goes to another endpoint; the first answer wins and the loser's
    #     is dropped by request_id.
    #   - breaker_enabled / breaker_failures / breaker_cooldown_ms: a
    #     circuit breaker per endpoint; that many consecutive failures
    #     open it (routing avoids it), after the cooldown one half-open
    #     probe closes it again or re-opens it.
    client_hedge_enabled: bool = False
    client_hedge_delay_ms: float = 0.0
    client_breaker_enabled: bool = False
    client_breaker_failures: int = 5
    client_breaker_cooldown_ms: float = 2000.0
    # The source watch (io/watch.py): the daemon wakes on source events
    # instead of sleeping the whole interval.  mode "auto" takes inotify,
    # else the store notification bus; "inotify", "store" and "poll"
    # force a backend.  The poll interval paces the watcher; the debounce
    # folds a burst of events into one wake.
    watch_enabled: bool = False
    watch_mode: str = "auto"
    watch_poll_interval_s: float = 0.5
    watch_debounce_ms: float = 50.0
    # The strict-mode sync guard (execution/sync_guard.py): armed by each
    # collect for the session's device; a device→host read-back outside
    # the attributed sync_guard.pull/scalar seams raises DeviceSyncError
    # and counts guard.sync.violations.  Off leaves torch untouched.
    device_guard_enabled: bool = False
    # The doctor (telemetry/doctor.py): the serving check warns past
    # shed/requests >= the ratio (crit at 5x) and grades the latency-SLO
    # burn against the bound; the device-skew check warns when the
    # max/median of the per-device kernel ms reaches its value (0: never).
    doctor_latency_slo_ms: float = 1000.0
    doctor_shed_warn_ratio: float = 0.05
    doctor_device_skew_warn: float = 4.0
    # The flight recorder (telemetry/flight_recorder.py): a bounded ring
    # of completed queries; slow (>= slow_ms), error and deadline ones
    # always kept, healthy ones sampled 1-in-N (0: none); bundles dumped
    # under <systemPath>/_hyperspace_diagnostics, at most max_bundles.
    flight_recorder_enabled: bool = True
    flight_recorder_max_records: int = 256
    flight_recorder_slow_ms: float = 1000.0
    flight_recorder_healthy_sample_n: int = 16
    flight_recorder_max_bundles: int = 8
    # Explain output rendering (plananalysis/display.py): "plaintext",
    # "html" or "console"; custom highlight tags, both set, override the
    # mode's own.
    display_mode: str = "plaintext"
    highlight_begin_tag: str = ""
    highlight_end_tag: str = ""

    def device_min_rows(self, kind: str, device) -> int:
        """The host-versus-device threshold of ``kind`` ("filter",
        "join", "agg", "join_agg" or "build") on ``device``: the field set
        explicitly, else the calibrated value.  The fused join→aggregate
        has no field of its own: an explicit join threshold governs it,
        since it is the join's device decision with the aggregation
        behind it; otherwise it calibrates as a kind of its own."""
        field = "join" if kind == "join_agg" else kind
        explicit = getattr(self, f"device_{field}_min_rows")
        if explicit is not None:
            return int(explicit)
        from hyperspace_tpu_torch.utils.calibrate import calibrated_min_rows

        return calibrated_min_rows(kind, device)

    def resident_min_rows(self, kind: str, device) -> int:
        """The threshold of ``kind`` on ``device`` when its inputs are
        already there (only the round trip is left to repay)."""
        if self.device_resident_min_rows is not None:
            return int(self.device_resident_min_rows)
        from hyperspace_tpu_torch.utils.calibrate import (
            calibrated_resident_min_rows,
        )

        return calibrated_resident_min_rows(kind, device)
