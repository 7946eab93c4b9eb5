#!/usr/bin/env python3
"""Drive hyperspace_tpu_torch on one CUDA card and check it.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one
CUDA device and exits non-zero without one, or when the package is not
beside it.  ``python3 chip_smoke.py --phases T,U`` runs some phases only:
the kernel builds and phase A always, the data generation, the selected
phases in the script's order with what they read from other phases
(PHASE_READS: phase C's ``li_idx`` build, phase D's ``ord_idx`` build
without its queries, phase L for M, phase T for U; C and D for T, V, Z
and MH; C for W, X and Y),
then the kernels' timing, with the same last line.  A phase is named by
its letter, or by its name of more than one letter (MH); an unknown name
is an error.
``--u-turns N`` adds N rounds of phase U's 8 clients on a threaded and an
async server in turns (threaded, async, async, threaded).

  build    compile both CUDA kernels from ``hyperspace_tpu_torch/csrc``
           (one nvcc per source, started together).
  phase A  each kernel against its plain PyTorch version on the card,
           bit for bit: the hash at n in {1, 2, 3, 5, 32769, 1_500_000,
           6_000_000} (the last two: the ord_idx and li_idx builds),
           k in {1, 3, HASH_MAX_COLS + 1} (a chunk boundary), num_buckets
           in {0, 16, 200, 4096}, on aligned columns, on 8- but not
           16-byte-aligned views (``big[1:]``) and on a mix of both; the
           histogram at the same n and num_buckets in {16, 200, 1024,
           1025, 8193, 60000} (per-warp copies, one block histogram, and
           tiles over gridDim.y), twice back to back (each launch leaves its
           accumulator and ticket zero for the next), on views 1-3 ids
           past a 16-byte boundary and at n = 0; on two streams at once
           (one accumulator per stream); a capture on a stream with no
           accumulator, which must be refused; twice in one CUDA graph
           replayed twice, with an eager launch between; then one call
           of each wrapper under ``torch.cuda.set_sync_debug_mode
           ("error")``, which raises if a wrapper synchronises.
  phase B  the build's data plane at full size without pyarrow: the
           6,000,000-row SF1 ``l_orderkey`` through
           ``bucket_sort_permutation`` on the card against the numpy
           mirror ``route_partition_np``, and ``bucket_counts`` against
           ``np.bincount``.
  phase C  ``Hyperspace.create_index`` end to end through the port's
           session on the SF1 lineitem (64 Parquet files, 16 buckets),
           with the launch counts set to 0 just before and read just
           after; then the index files are checked: bucket membership,
           order within each file, row total, and a point lookup of five
           seeded keys through the pruned bucket's file.
  phase D  queries through the indexes: ``create_index`` of ``ord_idx``
           on the SF1 orders (1,500,000 rows, 64 files, 16 buckets)
           beside ``li_idx``, with the launch counts set to 0 just before
           and read after the queries, and its files checked as phase C
           checks ``li_idx``'s; then, with hyperspace enabled and
           disabled, the four QUERIES (``point``: bench.py's
           ``l_orderkey == 123_457``, pruned to one bucket; ``range``: 20%
           of the keys over every bucket; ``join``: orders with lineitem,
           bucket by bucket; ``filtered_join``: the same under
           ``o_totalprice < 2000``), each answer held to numpy's answer
           from the generated arrays, each indexed plan required to scan
           the indexes and to record the "device" route of its filters
           and join kernels and a "bucketed" join.  Each indexed query
           runs a second time with ``device_filter_min_rows`` and
           ``device_join_min_rows`` above its row counts, so its filters
           and join kernels take the host route (arrow predicate,
           ``sorted_equi_join_np``), with ``device_resident_min_rows``
           raised too, since resident columns would otherwise keep the
           device; that answer too is held to numpy.
           Then the aggregates, each held to numpy (floats within
           AGG_RTOL relative, keys and counts exactly): ``q3``, bench.py's
           ``q_q3`` (orders under ``o_totalprice < 2000`` joined with
           lineitem, the revenue summed per ``o_custkey``, the top 10),
           ``q10``, bench.py's ``q_q10`` with its ``l_shipdate`` window
           scaled to SF1 (Q10_WINDOW: 1,500,000 rows; the top 20), both
           on the fused join→aggregate ("device-fused-agg" /
           "device-join-agg" with ``topn``), and ``agg_by_priority``
           (half the orders through ``ord_idx``, sum, min, max, mean and
           count per ``o_shippriority``, "device-segment"); the k-th and
           (k+1)-th revenues must differ by more than AGG_RTOL, so the
           top-k check decides.  Their host route is bucketed joins and
           arrow's group-by, with nothing on the device.
           The phase starts on an empty device column cache.  Each
           query is timed cold and warm: ``indexed_cold_ms`` is the
           median host wall of D_TIMED_RUNS collects, the cache
           emptied before each (outside the clock), after a checking one
           on an empty cache; ``indexed_warm_ms`` the median of as many
           collects after one more checked one, which must have read
           every column from the cache (hits, no miss, every device
           filter, join kernel, fused join and aggregate ``resident``);
           ``scan_cold_ms`` and ``scan_warm_ms`` the same with hyperspace
           off; ``host_route_ms`` the host route.  Beside them the two
           speedups, the two ``host_over_device`` and the cache's hits
           and misses of the checked cold and warm collects.  One
           profiled cold run gives ``device_ms`` (the sum of its device
           activities), ``busy_share`` (``device_ms`` over that run's
           wall) and the torch ops with the most device time (the warm
           profiled run left the time limit to phase MH); for the aggregates
           also ``programs`` (calls and device ms of AGG_PROGRAMS, each
           under a ``record_function`` of its name).  ``stages`` splits
           one cold and one warm run by stage (``stage_breakdown``:
           reads, fingerprints, arrow, uploads, predicates, device calls,
           the pool's wait).  Then q3 runs twice with the cache's budget
           at EVICTION_BUDGET, under its working set: both answers held
           to numpy, and the cache must have evicted or rejected columns.
           The resident MiB at the phase's end are printed.

  phase E  the spill build at SF1 with the conf's default batch
           (``device_batch_rows = 1 << 20``: 6 chunks) and 200 buckets:
           ``li_idx`` over phase C's lineitem three ways, pipelined spill,
           serial spill (``build_pipeline_enabled=False``) and monolithic
           (``1 << 23`` rows), each with the launch counts set to 0 just
           before and read just after (6 and 6 for each spill, 1 and 1 for
           the monolithic build), every bucket's sha256 equal across the
           three, and the spilled index's files checked as phase C checks
           them; a fourth, pipelined, build runs under ``torch.profiler``
           for its device time and busy share (and is bit-equal too).
           Then, over a copy of the source with one file appended:
           a full ``refresh_index`` (6 chunks, files checked), a refresh
           of the unchanged source (outcome "noop"), and delete, restore,
           delete, vacuum, with each state checked.
  phase F  the spill build at SF10: bench.py's SF10 lineitem generator
           (``default_rng(17)``), copied here, 60,000,000 rows x 15
           columns in 64 files; ``sf10_li`` on ``l_orderkey`` with phase
           C's included columns, 200 buckets and the default batch (58
           chunks, one launch of each kernel per chunk), its files checked,
           with its wall, phases, the process's peak RSS and the card's
           peak allocation.
  phase G  an index over a changing source, at SF1 with 200 buckets and
           the default batch: over a copy of phase C's lineitem (hard
           links), ``ord200`` on the orders and ``li_lin`` with the
           lineage column (6 spill chunks), both indexes' files checked
           and every row's ``_data_file_id`` held to its file's id (the
           file is known from the row's ``l_shipdate``).  Then 8 files of
           93,750 rows are appended (``gen_lineitem``, ``default_rng(29)``)
           and 4 original files deleted; ``refresh_index("quick")``
           (outcome "ok", 8 appended, 4 deleted, no launch); with hybrid
           scan off no plan scans ``li_lin``; with it on, phase D's four
           queries over the changed source, each held to numpy, with the
           hybrid plans (``Union`` or ``BucketUnion`` and the lineage
           filter), the "bucketed" join marked hybrid, one hash launch
           per join to route the appended rows, and each timed cold and
           warm over G_TIMED_RUNS collects, the checking collects the
           first (the buckets that gained
           rows are unions, which have no file identity: their columns
           are uploaded every time).  Then ``refresh_index("incremental")``
           (6,375,000 rows, one launch of each kernel), 2 more files
           appended and a second incremental refresh (6,562,500 rows,
           buckets with files in two versions), ``optimize_index("quick")``
           (one file per compacted bucket) and again (outcome "noop"),
           the files, the lineage and the four answers checked after
           each; after the first incremental refresh the four queries
           through the clean ``li_lin`` are timed cold and warm (every
           warm device entry resident).  Phase D profiles and splits
           the query shapes by stage; phase G no longer does (its
           splits and profiled runs left the time limit to phase MH).
           Phases E, F and G start on an
           empty cache, every timed build empties it first (so the
           card's peak is the build's own), and each phase prints the
           MiB resident at its end.
  phase H  calibration, build reports and data skipping, run after
           phase D over its data and indexes.  Phases A-G pin every
           routing threshold (0: the device routes, ``set_min_rows``),
           so the calibration probe first runs here: its profile
           (latency, h2d and d2h MB/s, host Mrows/s per kind, the cold
           and resident threshold per kind, ``calibrated`` required
           true) and its own seconds.  Then phase D's seven queries in a
           session with every threshold left at None, each run cold in
           turns with phase D's device route (thresholds 0) and host
           route (above every row count), then warm, each route after a
           checked run of its own (the host route reads no cached
           column, so its warm time is its cold one); each route's first
           cold answer and its warm-up answer held to numpy; per query
           the route calibration chose ("device",
           "host" or "mixed" over its filters, join kernels and
           aggregates), its ms, and the faster of the other two.  Then one
           SF1 ``create_index`` at the calibrated defaults, its route
           and launches printed and every bucket's sha256 held to phase
           C's.  Then a data-skipping index ``li_ds`` on ``l_shipdate``
           (timed) and bench.py's ``ds_range`` (``l_shipdate`` in
           [300,000, 390,000)) cold with hyperspace on and off: files
           kept of all (2 of 64), ms, the answer held to numpy; and
           q10's plan with ``li_ds`` present.  After phase G it prints
           the build reports of phase C's create, phase E's pipelined
           spill build and phase G's first incremental refresh and
           quick optimize; every timed build's report (phases C, E, G,
           F) has its ``bytes_written`` and ``files_written`` held to
           the data files of the version it wrote.
  phase I  the integrity loop, after phase G, over phase C's lineitem:
           ``li_int`` (``l_orderkey`` with quantity, price and discount,
           200 buckets, lineage, the default batch) and ``ord_int`` on
           the orders; every FileInfo has a content digest and each
           bucket's sha256 is kept.  ``verify_index`` quick and full
           (timed; every file "ok", nothing quarantined; the MB full
           read).  ``point`` and ``range`` of phase D timed cold clean
           and as scans.  Bit rot: one byte flipped in the middle of the
           file of ``POINT_KEY``'s bucket, size and mtime kept; quick
           reads "ok", full "digest-mismatch" for that file alone, the
           only one quarantined.  Containment: both queries' plans hold
           one ``BucketIn`` branch of that bucket, their answers equal
           numpy's (phase D's order), each BucketIn takes the device
           route with one hash launch, and both are timed cold; the
           join leaves ``li_int`` unused.  Another bucket's file is then
           truncated to half: ``range``'s collect quarantines it, answers
           right from the containment re-plan (no source fallback).  A
           device fault (``ops.filter.compile_predicate`` made to raise,
           then restored) propagates out of ``collect`` and changes no
           quarantine.  ``refresh_index(mode="repair")``: one launch of
           each kernel, its report's phases and wall; the two repaired
           buckets' rows equal numpy's in the index order (lineage ids
           included) and every bucket's sha256 equals the build's; a
           full verify is clean, the quarantine empty, the plans hold no
           ``BucketIn``.  Last, phase C's build four times, digest on
           write off and on in turns (DIGEST_BUILDS), and the written MB
           hashed again serially.
  phase J  the Z-order layout, after phase I, over phase C's lineitem:
           bench.py's ``li_z`` (``l_shipdate``, ``l_extendedprice`` with
           ``l_quantity``, ``layout="zorder"``, one bucket, N_LINEITEM // 64
           rows per file).  The codes first: the numpy mirror
           (``ops.zorder.zorder_order_words_np`` and a stable argsort) on
           the host, timed, and ``ops.zorder.zorder_sort`` on the card,
           timed between CUDA events, bit for bit equal; the mirror's
           codes give the layout (``zorder_split_chunks``: each cut on a
           cell boundary or at the row cap) and the files whose price
           range meets bench.py's ``q_zorder_second_dim`` ([2500, 3000)).
           ``li_z`` built monolithic (``1 << 23`` rows a batch: hash 0,
           histogram 1 launches) and two-pass (the default batch: 0 and
           0), each held to that layout file for file and row for row
           (a row is known by its ``l_shipdate``), each file in Morton
           order.  ``q_zorder_second_dim`` through the monolithic index
           pinned to the card: its files kept equal to the layout's, the
           answer to numpy's, cold and warm beside the scan and the plan
           ms; once more at the calibrated defaults; and a lexicographic
           index on the same columns must not apply to the price-only
           predicate.  Then over a hard-linked copy: ``li_z`` built, 2
           files appended (``default_rng(31)``), an incremental refresh
           (0 and 1 launches, layout kept, two versions), ``optimize_index
           ("quick")`` (0 and 0; files in Morton order and cell-aligned by
           the card's codes of the 6,187,500 rows), one flipped byte that
           a full verify flags, ``refresh_index(mode="repair")`` (1 and 1;
           the files equal to the monolithic layout of the snapshot row
           for row, verify clean after), the answer held to numpy's after
           each step.  Its SF10 part runs in phase F before phase F's
           source goes: ``sf10_z`` (bench.py:512-526) built two-pass over
           the 60,000,000 rows (0 and 0 launches; wall, phases, peak RSS,
           card peak); on the card the ranks of pass A checked to be the
           stable order (a permutation, keys non-decreasing along it, ties
           in row order) and the scaled, interleaved codes equal to numpy's
           on a seeded 1-in-ZORDER_SAMPLE sample of the rows; the files
           held to the card codes' layout as at SF1; the query's files
           kept and answer checked, cold beside the scan.  Prints the
           ``{"zorder": ...}`` line.

  phase K  the analytic operators, after phase J, over phase C's
           lineitem and ``li_idx``; every answer held to a numpy oracle
           written here (``k_expected``: a stable ``np.lexsort`` per
           ``l_status`` partition, plain cumulative sums), float running
           sums within K_PREFIX_RTOL of the column's absolute sum.
           bench.py's ``_sec_window`` shapes (bench.py:1672-1760) on the
           host route (agg threshold raised, cache off): ``running_sum``,
           ``rank``, ``trailing7_frame``, ``whole_partition_sum``, each
           timed over K_RUNS collects.  The device route: the
           whole-partition sum with a chained count window at the
           calibrated thresholds and the "eager" policy, cold once on an
           emptied cache, then warm (both windows "device-segment" over
           4 groups, resident), answers within AGG_RTOL of the host
           route's.  Seven tie-heavy windows ordered by ``l_quantity``
           (49 values: ties about 30,000 rows deep): the RANGE running
           sum, ``dense_rank``, ``ntile(4)``, ``lag`` and ``lead`` of
           ``l_orderkey``, ``min`` over ROWS (-2, 2), ``first_value``.
           Through ``li_idx``: a 5% key range, ``rank`` by price within
           ``l_quantity``, a computed revenue.  ``distinct`` over
           (``l_status``, ``l_quantity``) (196 rows, sorted),
           ``intersect`` and ``subtract`` of two overlapping key ranges
           through ``li_idx`` (in order), ``union`` by name.  No kernel
           launches on this path (checked).  Then ``ops.window``'s
           ``frame_sum``, ``frame_min_max`` (prefix scan and sparse
           table) and ``rank_from_ties`` on the card against the same
           functions on CPU tensors over the sorted layouts (ints and
           rows bit for bit, sums within the prefix bound), both timed:
           a measurement, no route.  Prints ``{"window": ...}``.
  phase L  the plan language, after phase K, at SF1: TPC-H-shaped
           ``orders`` (1,500,000 rows) and ``lineitem`` (6,000,000) in
           64 files each from ``default_rng(31)`` (``l_gen``), with
           TPC-H's names and value domains (dates as date32 rising with
           file order, the five priorities, the seven ship modes,
           comments from a small vocabulary with 1% nulls); ``li_q`` on
           ``l_orderkey`` and ``ord_q`` on ``o_orderkey`` (16 buckets,
           covering what the queries read) and ``li_q_ds`` on
           ``l_shipdate``, with the launch counts set to 0 before the
           builds and read after them (both kernels must have
           launched: ``L builds``), then set to 0 again before the
           queries and read after them (neither may have launched:
           ``L plan language``).  Every threshold pinned to 0.
           Fifteen queries, each held to numpy's answer (``l_expected``;
           ints, strings and dates exactly, float sums within AGG_RTOL)
           on a checked collect from an emptied cache and on
           L_TIMED_RUNS timed ones: ``year_1995`` (no ``year(`` left in
           the plan, the filter on the card, files kept equal to numpy's
           count of the files whose dates meet 1995), ``year_isin`` (the
           covering interval's files), ``month_3`` (a host ``Extract``,
           no file pruned), TPC-H ``q12`` (CASE sums over ``li_q`` ⋈
           ``ord_q``, both indexes in the plan), Q13's orders side
           (``NOT LIKE``; there is no customer table, so its outer join
           is left out), the string functions and matches, ``q4`` (a
           semi join), Q17's shape (a correlated scalar: an aggregate
           and an inner join), Q22's scalar (a literal in the plan, the
           filter on the card), ``in``, ``not_in`` and ``not_in_null``
           (a CASE without ELSE makes the null: no row), and Q21's shape
           over one month's orders (a semi and an anti join, each with a
           residual).  Prints ``{"plan_language": ...}``: per query its
           ms, rows, routes, files kept and plan facts.
  phase M  SQL and explain, right after phase L in its session, over its
           tables and indexes, with the launch counts set to 0 before
           it and read after it (neither kernel may have launched:
           ``M sql``).  Each of phase L's queries as SQL text
           (``m_texts``) through ``hyperspace_tpu_torch.sql.sql``: the
           parse and lower and the optimize timed, the optimized plan
           equal to its DSL twin's (but for M_PLAN_EXCEPTIONS, where the
           text cannot spell the DSL's node), numpy's answer on a
           checked collect from an emptied cache and on four timed
           collects in turns with the DSL twin (SQL, DSL, DSL, SQL), the
           routes phase L took.  Then
           ``Hyperspace.explain(ds, verbose=True)`` of the SQL ``q12``,
           ``q21_shape`` and ``year_1995``, timed: q12 uses ``li_q``
           and ``ord_q`` through ``PerBucketMergeJoinExec``, year_1995's
           scan IO keeps numpy's count of files, and the optimizer's
           decisions list the four rules.  Then ``hs.index("li_q")``
           (16 buckets, ACTIVE) and ``hs.indexes()``.  Prints
           ``{"sql": ...}``: per query its ms, the DSL twin's in turns
           and its phase L median, and its routes; each explain's ms;
           the statistics.
  phase N  the failure envelope at SF1, after phase M, over a
           hard-linked copy of phase C's lineitem (N_SOURCE) in a system
           path of its own: the spill build with the default batch, 200
           buckets and lineage.  Each step runs with the launch counts
           set to 0 just before and read just after and prints its wall,
           outcome and launches; each fault is armed in the port's
           injector (io/faults.py) and cleared in a finally.  The clean
           build ``n_clean`` (its files' sha256 per bucket kept) and
           ``n_ord`` on the orders; ``data.read eio`` at the third
           source read (retried; the bytes ``n_clean``'s); ``data.write
           eio`` (no IO retry, as in the JAX package: the build raises
           OSError, no spill directory of this process is left, the log
           is CREATING) and its rebuild under auto recovery (the clean
           bytes); ``data.write torn`` (InjectedCrash, no spill
           directory, CREATING with no stable entry) and its rebuild
           (ACTIVE, the clean bytes).  Then N_APPENDED files appended:
           an uninterrupted incremental refresh of ``n_read`` (a copy of
           the clean bytes), the same refresh of ``n_clean`` crashed at
           ``action.commit`` (the stable entry unchanged, point and q3
           answering numpy's over the changed source), and its refresh
           under auto recovery (the uninterrupted refresh's bytes).
           ``log.rename`` ``crash-before-rename`` of a delete (no
           pointer, its tmp file left, the DELETED entry resolved) and
           ``crash-after-rename`` of the restore (the pointer durable at
           ACTIVE).  ``data.read eio`` at query time: point and q3
           through the indexes, numpy's answers, one ``io.retry``
           decision in the run report, the extra ms against a clean cold
           run.  Degraded: a system path holding a copy of ``n_clean``'s
           log with every entry torn; the point query answers numpy's
           from the source, the report "degraded" naming the copy, and
           with the fallback off ``DegradedIndexError``; a real
           allocation error of the card (``torch.empty(1 << 50)``)
           raised inside FilterIndexRule propagates and degrades
           nothing.  Prints ``{"envelope": ...}``.
  phase O  the advisor at SF1, after phase N, over phase C's lineitem
           and phase D's orders in a fresh system path, 16 buckets,
           thresholds pinned to 0, capture on: phase D's point, range,
           join and q3 twice each from an emptied cache (numpy's
           answers; four shapes of two hits in ``captured_workload()``);
           O_CAPTURE_CALLS capture calls of the point query timed;
           ``recommend_indexes(top_k=5)`` twice, equal, each row
           printed; ``explain(whatif=...)`` of the top two candidates
           over each query's relations (the text printed, the estimated
           bytes falling), the system path's listing unchanged, and the
           executor refusing q3's what-if plan; ``apply_recommendations
           (top_k=2)`` with the launch counts set to 0 just before and
           read just after (``O apply``: both kernels), its build report
           checked; the four queries again from an emptied cache through
           the built indexes alone, numpy's answers, fewer bytes read,
           the ms before and after (``O rerun``).  Prints
           ``{"advisor": ...}``.
  phase P  the autonomous index lifecycle at SF1, after phase O, over a
           hard-linked copy of phase C's lineitem (P_SOURCE): ``p_li``
           (200 buckets, lineage, hybrid scan and CDC merge-on-read on),
           and a twin of it in a second system path, driven by hand with
           ``refresh_index``/``optimize_index`` in the mode the daemon
           journaled.  Each cycle is ``Hyperspace.maintenance_cycle()``
           with the launch counts set to 0 just before and read just
           after (P_CYCLES: the decision, mode, outcome and reason each
           must journal; incremental, repair, full and the advisor's
           create must launch both kernels, a quick refresh neither):
           1 unchanged (the detection ms); 2 one file appended (quick);
           3 eight more (incremental, every bucket then holds two files);
           4 compaction turned on, idle (optimize quick); 5 four files
           deleted and one rewritten in place with fewer rows (CDC
           quick, the queries through the delete overlay); 6 twelve more
           deleted (incremental on merge debt); 7 one byte flipped in an
           index file and a full verify (repair, the digests equal to
           those before the damage); 8 half the files deleted (full);
           9a phase D's point, range and q3 captured and a byte budget
           (the advisor's create); 9b a cold index built and a budget
           under the total (its delete).  After each, point, range and
           q3 held to numpy (``p_expected``), and after each
           incremental, full and optimize every bucket's sha256 equal to
           the twin's.  Files are written beside the source and renamed
           in (``p_write``): a linked file is never rewritten in place.
           Then the lease (a second session over the system path stands
           by until the first releases: the handoff ms), the staleness
           (``start_maintenance`` at a 30 s interval with the watch on,
           hybrid scan off: one file renamed in, the seconds to the
           journal's done record, under P_STALENESS_LIMIT_S, both
           kernels launched by the daemon thread) and a real allocation
           error of the card inside the daemon's refresh, journaled and
           raised out of the cycle, then the refresh under auto
           recovery.  Prints ``{"lifecycle": ...}``.
  phase Q  telemetry on the card (after phase P): with the timeline and
           tracing on, one SF1 spill build of ``li_tel`` and phase D's
           seven queries.  The build's ``exec.kernel.route_partition``
           seam must count one sample per launch of its chunks, its
           summed CUDA-event ms lie between the launches times the
           kernels line's chunk ``kernel_ms`` (hash plus histogram,
           checked after the timing) and the report's ``spill_route``
           seconds; ``export_timeline`` must write Perfetto JSON with a
           ``device:0`` lane and a memory counter track,
           ``perf_history()`` must hold the build's row and
           ``metrics_text()`` must parse as Prometheus text.  With the
           timeline off, ``torch.profiler`` over the queries must see no
           ``cudaEventRecord`` or ``cudaEventSynchronize`` (and, on, see
           them).  Then Q_PAIRS interleaved off/on pairs of the build and
           of the queries give the overhead, printed, not gated.  Prints
           ``{"telemetry": ...}`` with the card's name and power limit.
  phase R  the query-path guards and diagnostics (after phase Q): an SF1
           spill build of ``r_li`` over a hard-linked copy of phase C's
           lineitem with the guard off, then the first collect with
           ``device_guard_enabled`` arms the strict sync guard and the
           same build runs again (timeline on): every bucket's sha256
           equal, its launches (chunks of each kernel) counted under
           ``R diagnostics``, ``exec.transfer.d2h.bytes`` at least the
           chunks' permutations and counts.  Phase D's seven queries
           cold and warm under the guard: numpy's answers, 0
           ``guard.sync.violations``, attributed read-backs above 0, no
           launch; an ``.item()`` injected through
           ``ops/filter.compile_predicate`` raises ``DeviceSyncError``
           with nothing contained; R_PAIRS off/armed pairs of the warm
           queries give the guard's overhead, and R_PAIRS passes before
           the first arming the cost of the installed patch against
           unpatched torch (both printed, not gated).  The
           plan cache: two passes, 7 hits, the optimizer ms a hit skips,
           a committed action (delete) and the stale miss.  Deadlines:
           q3 under 1 ms raises ``DeadlineExceededError`` uncontained,
           under 60 s answers.  The flight recorder (slow at R_SLOW_MS):
           q3's record by trace id, ``export_timeline(trace_id=)``, the
           two error records, one bundle dumped and read back.  The
           doctor over ``r_li``: integrity and staleness ``ok``; a
           flipped byte and a full verify, ``crit``; the repair (one
           launch of each kernel, under ``R diagnostics``), ``ok``; an
           appended file, staleness ``warn``; one maintenance cycle (a
           quick refresh, no launch) and its ``maintenance`` flight
           record.  The guard is disarmed at the end.  Prints
           ``{"diagnostics": ...}`` with the card's name and power limit.
  phase S  the object store (after phase R): an SF1 spill build of
           ``s_li`` over a hard-linked copy of phase C's lineitem through
           ``ObjectStoreLogManager`` over ``EmulatedObjectStore`` under a
           S_STALE_MS listing window, and a twin on the posix log: every
           bucket's sha256 equal, nothing listed yet ids 1 and 2 found by
           the forward probe.  Phase D's seven queries: numpy's answers
           and the twin's, no launch.  A flipped byte in the point key's
           bucket: a full verify quarantines it through the emulated
           store (listed nothing, found by point reads), the point query
           answers that bucket from the source (one hash launch), the
           repair restores the twin's bytes.  One appended file and an
           incremental refresh on each log, bucket for bucket equal.  A
           quick refresh with an eio at its third ``store.put`` (the
           pointer's swap) commits through the retry; one with a torn
           first put dies, its id stays burned and the refresh run again
           commits at the next ids; two sessions' incremental refreshes
           race (both past validation before either claims an id): one
           "ok" (one launch of each kernel), one "noop" after a conflict
           retry, the files the twin's after its own refresh.  The
           pointer only moves forward.  The ms per log commit (S_COMMITS commits of the
           index's entry, ``write_log`` and the pointer) on each store
           class and on the posix log.  Its launches (the build, the
           contained query, the repair, the refresh and the race's
           winner) are ``S object store``; prints ``{"object_store": ...}`` with the card's name
           and power limit.
  phase T  the query server (after phase S): ``QueryServer`` on one
           ``cuda`` session over phase C's ``li_idx`` and phase D's
           ``ord_idx`` (rebuilt if a phase before left them otherwise),
           T_WORKERS workers, ``QueryClient`` over loopback.  (1) Phase
           D's seven queries as wire specs (``t_specs``), each served
           once and collected directly, both held to numpy and to each
           other, then T_TIMED_RUNS served and direct runs in turns;
           none launches a kernel.  (2) The seven from T_CLIENTS
           concurrent clients, T_ROUNDS rounds each: every answer
           numpy's, none lost or torn.  (3) Each query served with the
           plan cache emptied first and again from it: the ms a hit
           saves.  (4) One file appended to the lineitem source, hybrid
           scan on: the served filtered_join is numpy's and the direct
           collect's, its plan has a ``BucketUnion``, and it launches
           ``hash_buckets`` for its appended rows (``T server``); the
           file is removed after.  (5) A second server with one worker
           and a queue of one: with the running q3 held, one queued and
           T_BURST more requests shed ``BUSY``, as many as the
           ``serve.shed.queue_full`` counter; a 1 ms ``deadline_ms`` on
           q3 answers ``DEADLINE`` and the next q3 answers right; a
           drain with a join in flight (held until the drain begins)
           completes it and sheds the next request on an open
           connection.  (6) Each of the nine verbs once.  Prints
           ``{"server": ...}`` with the card's name and power limit.
  phase U  tenants, the async IO mode and the wire faults (after phase
           T), over phase T's indexes and wire specs, T_BOUND_S bounding
           every wait and socket.  (1) An async ``QueryServer``
           (U_WORKERS workers, one selector thread, workers + 4
           dispatchers): the seven served once, each equal to phase T's
           threaded answer (``pa.Table.equals``; phase T held it to
           numpy), then T_CLIENTS clients x T_ROUNDS rounds as in T's
           step 2, every answer T's or numpy's, with qps, client p50/p99,
           the ``serve.latency_ms`` and ``serve.queue_wait_ms`` means
           and the caching allocator's device allocations and frees
           beside T's step 2.  (2) One worker and
           ``serving_tenant_max_queued = 1``: tenant ``hot``'s join held
           on the worker (``tenant_snapshot()`` polled until it counts
           it), ``hot``'s point shed ``BUSY`` "quota" with a retry-after,
           the ``tenants`` verb showing ``hot`` queued at least 1 and
           shed 1, ``cold``'s point admitted behind the join; both
           answers right, ``serve.shed.tenant`` and
           ``serve.tenant.hot.shed`` up by 1.  (3) Wire faults on the
           async server: ``net.send`` ``torn-frame`` at 2 on the join's
           response a ``ConnectionError``, then a new client's join
           right; ``net.accept`` ``reset`` a ``ConnectionError``;
           ``net.accept`` ``black-hole`` under a U_BLACK_HOLE_S client
           timeout a ``ConnectionError`` from its ``TimeoutError``;
           ``net.recv`` ``slow`` (U_SLOW_RECV_MS) on point at least that
           long and right; the join U_DETOUR_RUNS times each with a wire
           plan armed that never fires (the buffered detour) and
           without, in turns.  Every plan is cleared in a ``finally``.
           No kernel launches (``U server``).  Prints ``{"server_u":
           ...}`` with the card's name and power limit.
  phase V  the front door (after phase U), over phase C's and D's
           indexes (``serve_indexes``), phase T's wire specs, two
           backend ``QueryServer``s a and b (V_WORKERS workers each) and
           ``FleetQueryClient``s with V_DEADLINE_MS budgets.  (1) The
           seven through one client over a and b, each held to numpy,
           with its ms and the picks of each endpoint.  (2) Failover,
           each fault once and answered right after a retry and a
           failover: a ``net.connect`` ``refused`` at a new client's
           first dial (the point query); a ``net.send`` ``torn-frame``
           at 2 on the join's response; a fake endpoint
           (``VBusyEndpoint``) answering ``ERR BUSY retry-after-ms=``
           V_PARK_HINT_MS beside a, hit once in V_PARK_QUERIES point
           queries and never picked again.  (3) A breaker
           (V_BREAKER_FAILURES, V_BREAKER_COOLDOWN_MS) over a dead port
           and a: it opens, ``client.breaker.open_now`` reads 1 and the
           doctor's ``client`` check ``warn``; a server comes up on that
           port, and after the cooldown one half-open probe closes it
           (open, half_open and close +1 each, the doctor ``ok``); after
           ``close()`` the gauge reads 0.  (4) V_HEDGES point queries
           hedged after V_HEDGE_DELAY_MS, a one-shot ``net.recv``
           ``slow`` of V_SLOW_RECV_MS armed before each:
           ``client.hedge.sent`` V_HEDGES, wins at least 1, each ms
           against a clean point's.  (5) A third server with
           ``proxy_endpoints=[a, b]``: a plain ``QueryClient`` gets the
           seven right; the join direct and proxied, V_JOIN_RUNS each in
           turns (its 192 MB cross loopback twice through the proxy); a
           proxy over a fake BUSY endpoint answers ``ServerBusyError``
           with the hint V_PROXY_HINT_MS.  (6) One ``GET /metrics`` of a
           ``MetricsScrapeServer`` carrying the ``serve.*`` and
           ``client.*`` series (V_SCRAPED), its ms and bytes.  No kernel
           launches (``V fleet``).  Prints ``{"fleet": ...}`` with the
           card's name and power limit.
  phase W  the source formats, hive partitions and globs (after phase
           V), beside phase C's lineitem and ``li_idx``: six sources
           written under ``root`` (``w_write``): ``w_hive``, the 6 M
           rows by l_status in ``l_status=K/`` directories (N_FILES //
           W_STATUSES files each, l_status only in the paths);
           ``w_csv`` (with a header) and ``w_orc``, phase C's N_FILES
           slices; ``w_json``, the orders as newline-delimited JSON;
           ``w_avro``, the orders' first W_AVRO_ROWS rows (cut: the
           codec is pure Python); ``w_text``, ``order-<o_orderkey>``
           per order.  (1) ``w_csv_idx`` (li_idx's columns, 16 buckets)
           as a spill build with DEFAULT_BATCH_ROWS, and (2)
           ``w_orc_idx`` monolithic: each bucket's rows equal to
           ``li_idx``'s in order, value for value (CSV reads the whole
           doubles of l_quantity as int64; ``type_changes`` lists it).
           (3) ``w_hive_idx`` (l_orderkey; l_status, l_extendedprice):
           every row equal to numpy's in the index's layout, the
           partition column included.  (4) Cold, then warm: a point and
           a range on ``w_csv``, ``l_status == W_STATUS`` on ``w_hive``
           (through ``w_ds``), the join of ``w_csv_idx`` with
           ``w_json_idx``, a point on ``w_avro`` and on ``w_text``, each
           equal to numpy and through its indexes.  (5) The glob
           ``w_hive/l_status=*`` reads every row; ``w_glob_idx`` is
           created over the four directories under that globbing
           pattern (recorded as its root); a partition ``l_status=4/``
           of ROWS_PER_FILE rows (``gen_lineitem(default_rng(211))``)
           appears; the range through hybrid scan, then an incremental
           refresh that indexes its rows alone, then the range through
           the index, each equal to numpy.  (6) ``w_ds``
           (DataSkippingIndexConfig on l_status) keeps N_FILES //
           W_STATUSES of N_FILES files for (4)'s hive query.  Per build
           its wall, read seconds (beside phase C's Parquet ``read_s``),
           MB on disk, decoded and written; launches ``W formats`` over
           the whole phase, both nonzero on the card.  Prints
           ``{"formats": ...}`` with the card's name and power limit.
  phase X  the Delta Lake source (after phase W), over phase C's
           lineitem and ``li_idx``: ``x_delta``, phase C's rows written
           with the port's ``write_delta`` in X_COMMITS appends
           (versions 0-9).  (1) ``x_delta_idx`` (li_idx's columns, 16
           buckets, lineage on) as a spill build with
           DEFAULT_BATCH_ROWS: each bucket's keys equal to ``li_idx``'s
           in order and its rows to ``li_idx``'s as a multiset per key
           (a snapshot's files follow their random names, so rows of
           one key may come in another order); the entry is ``delta``
           with ``versionAsOf`` 9 and one ``deltaVersions`` pair ending
           in ``:9``.  (2) A point and a 5% range (X_RANGE), cold then
           warm, through the index, equal to numpy.  (3) v10: an append
           of ROWS_PER_FILE rows (``gen_lineitem(default_rng(223))``)
           writes the first checkpoint and ``_last_checkpoint``; the
           snapshot through it equals the JSON replay (both timed); the
           range through hybrid scan equals numpy over the 6,093,750
           rows; the incremental refresh indexes the appended rows
           alone (one hash and one histogram launch on the card) and
           ``deltaVersions`` gains a pair ending in ``:10``.  (4) After
           it, ``versionAsOf="9"`` and ``timestampAsOf`` of v9's commit
           are served by the v9 log entry (every file of the plan's
           index scan is that entry's) and equal numpy over the first
           6,000,000 rows; ``versionAsOf="5"`` equals numpy over the
           first 3,600,000, whatever route it takes.  (5) v11
           upserts X_UPSERTED keys and v12 deletes one, keys found in
           the appended rows alone; ``maintenance_cycle()`` with
           ``lifecycle_cdc_enabled`` journals a quick refresh for "CDC
           merge-on-read", and a filter over the three keys returns the
           upserted rows alone.  (6) ``x_delta_ow``: X_OW_COMMITS
           commits of X_OW_ROWS rows, then an overwrite of X_OW_ROWS
           more; a scan returns those rows alone.  Prints the write's
           seconds and MB, the build's wall, read seconds (beside phase
           C's Parquet ``read_s``), MB decoded and written, each query's
           ms, the snapshot's replay ms, the refresh's and the cycle's
           walls; launches ``X delta`` (the build, the refresh and the
           cycle), both nonzero on the card.  Prints ``{"delta": ...}``
           with the card's name and power limit.
  phase Y  the Iceberg source (after phase X), over phase C's lineitem
           and ``li_idx``: ``y_iceberg``, phase C's rows written with
           the port's ``write_iceberg`` in Y_COMMITS appends (snapshots
           1-10).  (1) ``y_iceberg_idx`` (li_idx's columns, 16 buckets,
           lineage on) as a spill build with DEFAULT_BATCH_ROWS, one
           hash and one histogram launch per chunk on the card, held to
           ``li_idx`` per key as phase X's index is; the entry is
           ``iceberg`` with the 10th snapshot's ``snapshot-id`` and one
           ``icebergSnapshots`` pair.  (2) A point and a 5% range
           (Y_RANGE), cold then warm, through the index, equal to numpy.
           (3) The 11th snapshot appends ROWS_PER_FILE rows
           (``gen_lineitem(default_rng(233))``); ``plan_files`` is timed
           over the 10th and the 11th snapshots (metadata, manifest list
           and manifest read); the range through hybrid scan, then the
           incremental refresh (the appended rows alone, one launch of
           each kernel on the card), then the range through the
           refreshed index, each equal to numpy.  (4) ``snapshot_id``
           and ``as_of_timestamp`` (its ``timestamp-ms``) of the 10th
           snapshot are served by the build's log entry through
           ``closest_index`` (every file of the plan's index scan is
           that entry's) and equal numpy over the first 6,000,000 rows;
           ``snapshot_id`` of the 6th snapshot takes the source route
           and equals numpy over the first 3,600,000.  (5) An
           ``upsert_iceberg`` of Y_UPSERTED keys and a
           ``delete_rows_iceberg`` of one, keys found in the appended
           rows alone; ``maintenance_cycle()`` journals a quick refresh
           for "CDC merge-on-read", and a filter over the three keys
           returns the upserted rows alone.  (6) ``y_iceberg_ow``:
           Y_OW_COMMITS snapshots of Y_OW_ROWS rows, then an overwrite
           of Y_OW_ROWS more that drops ``l_shipdate`` and adds
           ``l_discount``: the surviving columns keep their field ids,
           the new one takes 4, and a scan returns those rows alone.
           (7) A truncated copy of the newest metadata JSON raises
           ``CorruptMetadataError`` naming the file.  Prints the
           write's seconds and MB, the build's wall, read seconds, MB
           decoded and written, each query's ms, ``plan_files``'s ms,
           the refresh's and the cycle's walls; launches ``Y iceberg``
           (the build, the refresh and the cycle: 7 and 7 on the card).
           Prints ``{"iceberg": ...}`` with the card's name and power
           limit.
  phase Z  the mesh of Z_SHARDS logical shards on the one card (after
           phase Y), over phase C's lineitem and phase D's orders:
           ``parallel/mesh.local_devices`` gives Z_SHARDS copies of the
           card (``logical_shards``, the seam of the port's mesh
           tests).  (1) ``li_idx`` as a spill build with
           DEFAULT_BATCH_ROWS (6 chunks), each chunk routed over the
           mesh: the build report's ``mesh_devices`` is 8, one hash and
           one histogram launch per shard and chunk (48 and 48), and
           every bucket file's sha256 equals phase C's ``li_idx``'s;
           then the same build with the mesh off (6 and 6, the same
           files), for the detour's cost.  (2) ``ord_idx`` with
           ``parallel_build="on"``: the bucket shuffle over the mesh (8
           hash launches, the writer's one histogram), its files equal
           to phase D's.  (3) With every ``mesh_*_min_rows`` at 0: the
           point and the range (strategy device-mesh), the join through
           the indexes (bucketed-mesh) and over the sources (the flat
           join, join kernel mesh), q3's groups whole
           (mesh-fused-agg and mesh-join-agg; its top Q3_TOP are phase
           D's q3) and agg_by_priority (mesh-segment), each collected
           once unchecked, then cold once over the mesh and once on the
           single device with the mesh off, each answer equal to numpy
           (floats within AGG_RTOL).
           (4) One chunk's spill route (DEFAULT_BATCH_ROWS rows, 16
           buckets) by ``route_partition`` and by
           ``route_partition_mesh``, the same (perm, counts), Z_ROUTE_RUNS
           host-clock calls of each in turns.  Logical shards on one card
           run one after another, so this measures the detour, not
           scaling.  Launches ``Z sharded spill`` and ``Z distributed
           build``.  Prints ``{"mesh": ...}`` with the card's name and
           power limit.
  phase MH the multi-host layer on the one card (after phase Z), over
           phase C's lineitem and phase D's orders.  (1) ``li_idx``'s
           config as ``li_mh`` by MH_HOSTS host subprocesses on
           ``cuda:0`` (``multihost_build_hosts``), DEFAULT_BATCH_ROWS (6
           chunk claims, 8 group claims): every bucket's sha256 equal to
           ``li_idx``'s, the hosts' launches from the chunk claims
           (``multihost_launches``: 6 and 6), none in the parent, one
           ``claim``/``commit`` journal record, no claim left, and the
           route and finalize walls from the claim spans.  (2) The same
           as ``li_mh_kill`` with a MH_KILL_TTL_S claim TTL and the first
           host SIGKILLed after its first done chunk: the survivor
           reclaims its claims and lands the same bytes, with one commit
           and no item completed twice.  (3) Phase D's orders (1,500,000
           rows) through ``hierarchical_bucket_shuffle`` over
           ``build_mesh_2d(2, 4)`` of 8 logical shards and through the
           flat ``bucket_shuffle`` on the same shards, in turns (flat,
           two-stage, two-stage, flat; 8 hash launches each): the same
           perm, buckets, counts and payload.  (4) MH_PROCESSES processes
           on ``cuda:0`` joined by ``initialize_distributed`` over Gloo
           (``mh_worker``), 2 shards each, stage 1 by
           ``all_to_all_single`` through host memory: each process's
           shards equal the flat shuffle's over the same 4 shards.
           Launches ``MH multihost build`` and ``MH hierarchical
           shuffle``.  Prints ``{"multihost": ...}`` with the card's name
           and power limit.

The data is bench.py's generators, copied here.  Then each kernel is
timed at the shapes of HASH_SHAPES and HIST_SHAPES (the first of each is
phase C's, the last the spill build's chunk), in three ways:

  kernel_ms    device time per launch: GRAPH_LAUNCHES wrapper calls
               captured into one CUDA graph (on the stream that warmed
               them up) and replayed between two events, each launch on
               the next of enough input copies to exceed twice the L2
               cache, so each starts cold.  ``ms`` is this time.
  profiler_ms  the same launches' device time by ``torch.profiler``
               (activities named after the kernel), as a cross-check.
  call_ms      one wrapper call between two events after an L2 flush,
               median of TIMED_RUNS: the kernel plus the host around it.

beside the bound (bytes read once and written once over HBM_BYTES_PER_S,
or integer operations over ALU_OPS_PER_S), the plain version's call time
and, for the histogram, ``torch.bincount``'s device time by the profiler
(it synchronises, so no graph holds it).  Each kernel row carries its
launches on every path the script drives (``launches_by_path``); the
chunk-shape rows carry ``launches_per_sf1_build``.  The last lines are
the builds JSON (phases E, G, J and F, each with its build ``report``),
the queries JSON (phase D's with its ``eviction`` run, phase G's as
``hybrid_queries`` and phase
H's under ``calibration``), the kernels JSON (``launches_by_path`` with
phase I's ``I repair`` and ``I containment``, phase J's steps and phase
K's ``K analytic``, phase L's ``L builds`` and ``L plan language``,
phase M's ``M sql``, phase N's ``N envelope``, phase O's ``O apply`` and
``O rerun``, phase P's ``P lifecycle``, phase Q's ``Q telemetry``, phase
R's ``R diagnostics``, phase S's ``S object store``, phase T's ``T
server``, phase U's ``U server``, phase V's ``V fleet``, phase W's ``W
formats``, phase X's ``X delta``, phase Y's ``Y iceberg``, phase Z's
``Z sharded spill`` and ``Z distributed build``, phase MH's ``MH
multihost build`` and ``MH hierarchical shuffle``), the
integrity JSON (phase I), the Z-order JSON (phase J), the window JSON
(phase K), the plan-language JSON (phase L), the SQL JSON (phase M), the
envelope JSON (phase N), the advisor JSON (phase O), the lifecycle JSON
(phase P), the telemetry JSON (phase Q), the diagnostics JSON (phase
R), the object-store JSON (phase S), the server JSON (phase T), the
async, tenant and wire-fault JSON (phase U), the front-door JSON
(phase V), the formats JSON (phase W), the Delta JSON (phase X) and the
Iceberg JSON (phase Y), the mesh JSON (phase Z) and the multi-host JSON
(phase MH), each of the last fifteen with
the card's name and power limit, the card's name and power limit, and
``{"ok": true, "device": ...}``.  A selection prints the lines of the
phases it ran.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

N_ORDERS = 1_500_000
N_LINEITEM = 6_000_000
N_FILES = 64
NUM_BUCKETS = 16
INDEX_NAME = "li_idx"
INDEXED = ["l_orderkey"]
INCLUDED = ["l_quantity", "l_extendedprice", "l_discount", "l_shipdate"]
ORDERS_INDEX = "ord_idx"
# Phase D's queries: bench.py sf1's point key and join, a range over 20%
# of the keys, and the join under a filter on the orders' price.
POINT_KEY = 123_457
RANGE = (100_000, 400_000)
PRICE_BELOW = 2_000.0
# Phase D's aggregates: bench.py's q_q3 (top 10) and q_q10 (top 20) with
# its l_shipdate window scaled to SF1 (bench.py's [10 M, 25 M) is empty
# at SF1's 6 M rows; this is the same 25% of the rows), and a grouped
# aggregate over half the orders.
Q3_TOP = 10
Q10_TOP = 20
Q10_WINDOW = (1_000_000, 2_500_000)
AGG_ORDERKEY_BELOW = 750_000
AGG_RTOL = 1e-9
# The slice's device programs, timed by name in the profiled run.
AGG_PROGRAMS = ("match_pairs", "_group_sort", "_segment_reduce",
                "_topk_groups")
# One timed run per variant of phases H, I and J, of phase D's variants,
# of phase G's hybrid and clean queries and scans (its checking collects,
# since phase MH) and of phase K's shapes: with phases Q to Y added, what
# keeps the whole script inside its time limit on the slower card hosts
# (A-Y took 1,078 s on one H100 80GB HBM3 machine).
TIMED_QUERY_RUNS = 1
D_TIMED_RUNS = 1
G_TIMED_RUNS = 1
# The cold and the resident thresholds of the host route: more rows than
# any query has, so every filter, join kernel and aggregate runs on the
# host, resident columns or not.
HOST_ROUTE_MIN_ROWS = 1 << 62
# The device column cache's budget of phase D's eviction run: under q3's
# working set (li_idx's three referenced columns, 48 MB each).
EVICTION_BUDGET = 64 << 20

# Phases E and F: the spill build with the conf's default batch.
SPILL_BUCKETS = 200
DEFAULT_BATCH_ROWS = 1 << 20
MONOLITHIC_BATCH_ROWS = 1 << 23
COPY_INDEX = "li_copy"
APPENDED_ROWS = 1_000
SF10_INDEX = "sf10_li"
N_ORDERS_SF10 = 15_000_000
N_LINEITEM_SF10 = 60_000_000
SF10_FILES = 64
# Phase G: an index over a changing source, at SF1 with 200 buckets.
LINEAGE_INDEX = "li_lin"
ORDERS_INDEX_200 = "ord200"
ROWS_PER_FILE = N_LINEITEM // N_FILES  # 93,750: write_files's cut
G_APPENDED = 8                  # files appended before the quick refresh
G_DELETED = (3, 17, 31, 45)     # original files deleted with them
G_APPENDED_AGAIN = 2            # files appended before the last refresh
G_QUERY_COLUMNS = ("l_orderkey", "l_quantity", "l_extendedprice",
                   "l_discount")

# Phase H: bench.py's ds_range window over SF1 (l_shipdate is the row
# number, ROWS_PER_FILE rows a file, so it spans files 3 and 4).
DS_INDEX = "li_ds"
DS_RANGE = (N_LINEITEM // 20, N_LINEITEM * 13 // 200)
DS_WANT_FILES = (2, N_FILES)
CALIBRATED_INDEX = "li_cal"
# Phase I: the integrity loop at SF1, 200 buckets with lineage.
INTEGRITY_INDEX = "li_int"
INTEGRITY_ORDERS = "ord_int"
INTEGRITY_INCLUDED = ["l_quantity", "l_extendedprice", "l_discount"]
INTEGRITY_COLUMNS = ["l_orderkey"] + INTEGRITY_INCLUDED
# Phase C's build with digest on write off and on, in turns.
DIGEST_BUILDS = (False, True, False, True)
ZORDER_INDEX = "li_z"           # bench.py's li_z (bench.py:1165-1176)
ZORDER_LEX_INDEX = "li_zlex"    # the same columns, lexicographic
ZORDER_INDEXED = ["l_shipdate", "l_extendedprice"]
ZORDER_INCLUDED = ["l_quantity"]
ZORDER_COLUMNS = ZORDER_INDEXED + ZORDER_INCLUDED
ZORDER_BITS = 16 * len(ZORDER_INDEXED)
ZORDER_RANGE = (2500.0, 3000.0)  # bench.py's q_zorder_second_dim
J_APPENDED = 2                  # files appended before the refresh
J_LAUNCHES = {                  # hash, histogram per Z-order step
    "monolithic": {"hash_buckets": 0, "bucket_histogram": 1},
    "two-pass": {"hash_buckets": 0, "bucket_histogram": 0},
    "refresh": {"hash_buckets": 0, "bucket_histogram": 1},
    "optimize": {"hash_buckets": 0, "bucket_histogram": 0},
    "repair": {"hash_buckets": 1, "bucket_histogram": 1},
}
SF10_Z_INDEX = "sf10_z"         # bench.py's sf10_z (bench.py:512-526)
ZORDER_SAMPLE = 64              # SF10: codes checked on 1 row in 64
# Phase K: the analytic operators over phase C's lineitem and li_idx.
K_RUNS = 1                      # timed runs of each step-1 shape
# A float running sum is a difference of prefix sums over the whole
# sorted table (up to sum |x|, about 3e10 at SF1), so it is held to
# K_PREFIX_RTOL * sum |x| absolute: the prefixes' rounding (about
# sqrt(n) * 2**-53 * sum |x| in any summation order, 1e-13 of it at
# 6 M rows) and not the frame's own sum sets the error.
K_PREFIX_RTOL = 1e-11
K_NTILE = 4
K_RANGE = (600_000, 675_000)    # step 4: 5% of the order keys
K_SET_A = (100_000, 160_000)    # step 5: two overlapping key ranges
K_SET_B = (140_000, 200_000)
K_UNION_KEYS = (POINT_KEY, POINT_KEY + 1)
K_DISTINCT_ROWS = 4 * 49        # (l_status, l_quantity) pairs
# Phase L: the plan language over TPC-H-shaped orders and lineitem.
L_SEED = 31
L_ORDERS = N_ORDERS
L_LINEITEM = N_LINEITEM
L_CUSTOMERS = 150_000           # TPC-H SF1's customer count
L_SUPPLIERS = 10_000            # TPC-H SF1's supplier count
L_FIRST_DAY = 8035              # 1992-01-01, days since 1970-01-01
L_LAST_DAY = 10440              # 1998-08-02, TPC-H's last order date
L_PRIORITIES = ("1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW")
L_SHIPMODES = ("REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB")
L_WORDS = ("special", "requests", "pending", "deposits", "furiously",
           "carefully", "quickly", "final", "accounts", "packages",
           "ironic", "regular")
L_PHRASES = 256                 # distinct comments, 2-6 words each
L_COMMENT_NULLS = 0.01
L_LI_INDEX = "li_q"
L_ORD_INDEX = "ord_q"
L_DS_INDEX = "li_q_ds"
L_LI_INCLUDED = ["l_suppkey", "l_quantity", "l_extendedprice", "l_shipdate",
                 "l_commitdate", "l_receiptdate", "l_shipmode"]
L_ORD_INCLUDED = ["o_custkey", "o_totalprice", "o_orderpriority"]
L_TIMED_RUNS = 1                # timed collects after the checked one
L_STRING_KEYS = (600_000, 615_000)  # 1% of the order keys
L_Q21_MONTH = (9190, 9221)      # 1995-03-01 .. 1995-04-01: ~1/80 of orders
L_Q4_QUARTER = (8582, 8674)     # 1993-07-01 .. 1993-10-01
L_NULL_KEYS = (0, 20_000)       # NOT IN with a null: the keys scanned
# Phase M: phase L's queries as SQL text.  Their optimized plans equal
# the DSL twins' but where the text cannot spell the DSL's node: LIKE for
# startswith/endswith/contains, and count(*) for a count_all of a named
# column (which keeps that column through pruning).  The CPU test
# (tests/test_torch_sql.py) holds this set to the reference package's.
M_PLAN_EXCEPTIONS = frozenset({"strings_matches", "not_in_null"})
M_EXPLAINED = ("q12", "q21_shape", "year_1995")
M_RULES = ("JoinIndexRule", "FilterIndexRule", "BucketPruneRule",
           "DataSkippingFilterRule")
Q_INDEX = "li_tel"               # phase Q's SF1 spill build
Q_PAIRS = 1                     # interleaved timeline off/on pairs
Q_EVENT_CALLS = ("cudaEventRecord", "cudaEventSynchronize")
R_SOURCE = "r_lineitem"         # a hard-linked copy of phase C's lineitem
R_INDEX = "r_li"                # phase R's strict SF1 spill build
R_PAIRS = 1                     # interleaved guard off/armed pairs
R_SLOW_MS = 1.0                 # flight_recorder_slow_ms: q3 is kept
R_APPENDED_ROWS = 10_000        # one appended file: a quick refresh
R_PLAN_RUNS = 3                 # timed optimizer passes per query
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
# 67 TFLOP/s of float32 outside the tensor cores counts an FMA as two
# operations; the kernels' integer ops issue one each, so 33.5e12 op/s.
ALU_OPS_PER_S = 33.5e12
L2_BYTES = 50 * 1024 * 1024
TIMED_RUNS = 25
GRAPH_LAUNCHES = 30
GRAPH_REPLAYS = 5
PROFILED_CALLS = 30
# (rows, key columns, buckets) of the hash and (rows, buckets) of the
# histogram; the first of each is phase C's, the last the spill build's
# chunk at the default batch.
HASH_SHAPES = ((N_LINEITEM, 1, NUM_BUCKETS), (N_LINEITEM, 1, 200),
               (N_LINEITEM, 3, NUM_BUCKETS),
               (DEFAULT_BATCH_ROWS, 1, SPILL_BUCKETS))
HIST_SHAPES = ((N_LINEITEM, NUM_BUCKETS), (N_LINEITEM, 200),
               (DEFAULT_BATCH_ROWS, SPILL_BUCKETS))


def gen_lineitem(rng, n: int) -> dict:
    """bench.py's ``_gen_lineitem``: 16 TPC-H-like lineitem columns."""
    li = {
        "l_orderkey": rng.integers(0, N_ORDERS, n),
        "l_status": rng.integers(0, 4, n),
        "l_quantity": rng.integers(1, 50, n).astype(np.float64),
        "l_extendedprice": rng.random(n) * 1e4,
        "l_discount": rng.random(n) * 0.1,
        "l_shipdate": np.arange(n, dtype=np.int64),
    }
    for i in range(10):
        li[f"l_pad{i}"] = rng.random(n)
    return li


def gen_data():
    """bench.py's ``_gen_data``: (orders, lineitem), the orders drawn
    first from the same random stream."""
    rng = np.random.default_rng(7)
    o_key = np.arange(N_ORDERS, dtype=np.int64)
    rng.shuffle(o_key)
    orders = {
        "o_orderkey": o_key,
        "o_custkey": rng.integers(0, 20_000, N_ORDERS),
        "o_totalprice": rng.random(N_ORDERS) * 1e5,
        "o_shippriority": rng.integers(0, 5, N_ORDERS),
    }
    return orders, gen_lineitem(rng, N_LINEITEM)


def write_files(table: dict, path: str) -> None:
    """``table`` as N_FILES Parquet files under ``path``, as bench.py
    writes them."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    os.makedirs(path)
    table = pa.table(table)
    step = -(-table.num_rows // N_FILES)
    for f in range(N_FILES):
        pq.write_table(table.slice(f * step, step),
                       os.path.join(path, f"part-{f:05d}.parquet"))


def int64_words(values: np.ndarray):
    """(hash words, order words) of an int64 key column, as
    ``io.columnar`` makes them, without pyarrow."""
    from hyperspace_tpu_torch.io.columnar import _monotone_uint64, split_words64

    values = np.ascontiguousarray(values, dtype=np.int64)
    return split_words64(values.view(np.uint64)), \
        split_words64(_monotone_uint64(values))


def require_equal(name: str, got, want) -> None:
    import torch

    if not torch.equal(got, want):
        diff = int((got != want).sum())
        raise AssertionError(f"{name}: {diff} of {got.numel()} values differ")


def _random_words(dev, n: int, k: int, gen) -> list:
    """k random (n, 2) uint32 word columns, drawn on the card."""
    import torch

    return [torch.randint(-2**31, 2**31, (n, 2), dtype=torch.int32,
                          device=dev, generator=gen).view(torch.uint32)
            for _ in range(k)]


def _misaligned(t):
    """A contiguous copy of ``t`` that starts one element past a 16-byte
    boundary: ``big[1:]`` of a tensor one row longer."""
    import torch

    big = torch.empty((t.shape[0] + 1,) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    view = big[1:]
    view.copy_(t)
    if view.data_ptr() % 16 == 0:
        raise AssertionError("misaligned view came out 16-byte aligned")
    return view


def phase_a(dev) -> None:
    import torch

    from hyperspace_tpu_torch.ops import kernels

    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    chunk = kernels.HASH_MAX_COLS
    # N_ORDERS and N_LINEITEM: the ord_idx and li_idx builds' shapes.
    for n in (1, 2, 3, 5, 32769, N_ORDERS, N_LINEITEM):
        for k in (1, 3, chunk + 1):
            cols = _random_words(dev, n, k, gen)
            for nb in (0, 16, 200, 4096):
                require_equal(f"hash_buckets n={n} k={k} nb={nb}",
                              kernels.hash_buckets(cols, nb),
                              kernels.hash_buckets_plain(cols, nb))
            # Every column 8- but not 16-byte aligned, then one of each.
            odd = [_misaligned(c) for c in cols]
            for name, view in (("misaligned", odd),
                               ("mixed", [cols[0]] + odd[1:] if k > 1
                                else [odd[0]])):
                require_equal(f"hash_buckets n={n} k={k} {name}",
                              kernels.hash_buckets(view, 200),
                              kernels.hash_buckets_plain(view, 200))
        for nb in (16, 200, 1024, 1025, 8193, 60000):
            ids = torch.randint(-1, nb, (n,), dtype=torch.int32, device=dev,
                                generator=gen)
            want = kernels.bucket_histogram_plain(ids, nb)
            require_equal(f"bucket_histogram n={n} nb={nb}",
                          kernels.bucket_histogram(ids, nb), want)
            # Back to back: the first launch left the accumulator zero.
            require_equal(f"bucket_histogram n={n} nb={nb} again",
                          kernels.bucket_histogram(ids, nb), want)
            for shift in (1, 2, 3):
                big = torch.full((n + shift,), -1, dtype=torch.int32,
                                 device=dev)
                big[shift:] = ids
                require_equal(f"bucket_histogram n={n} nb={nb} view+{shift}",
                              kernels.bucket_histogram(big[shift:], nb), want)
    empty = torch.empty(0, dtype=torch.int32, device=dev)
    require_equal("bucket_histogram n=0", kernels.bucket_histogram(empty, 64),
                  torch.zeros(64, dtype=torch.int32, device=dev))

    # Histograms on two streams at once: each stream has its own
    # accumulator, so launches that overlap do not add into each other.
    cur = torch.cuda.current_stream()
    ids = torch.randint(-1, 200, (N_LINEITEM,), dtype=torch.int32, device=dev,
                        generator=gen)
    ids2 = torch.randint(-1, 200, (N_LINEITEM,), dtype=torch.int32,
                         device=dev, generator=gen)
    want = kernels.bucket_histogram_plain(ids, 200)
    want2 = kernels.bucket_histogram_plain(ids2, 200)
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    outs = ([], [])
    # A few ms of matmul holds both streams back while the host queues
    # every launch, so the two streams' launches run together.
    hold = torch.randn(4096, 4096, device=dev, generator=gen)
    hold = hold @ hold
    for s in streams:
        s.wait_stream(cur)
    for _ in range(4):
        for s, x, got in zip(streams, (ids, ids2), outs):
            with torch.cuda.stream(s):
                got.append(kernels.bucket_histogram(x, 200))
    for s in streams:
        cur.wait_stream(s)
    for i in range(4):
        require_equal(f"bucket_histogram stream 0 launch {i}", outs[0][i], want)
        require_equal(f"bucket_histogram stream 1 launch {i}", outs[1][i],
                      want2)
    torch.cuda.synchronize()

    # Capture on a stream with no accumulator yet is refused (the zero
    # fill would only be recorded).  High priority: a pool no launch here
    # has drawn from.
    fresh = torch.cuda.Stream(priority=-1)
    fresh.wait_stream(cur)
    try:
        with torch.cuda.graph(torch.cuda.CUDAGraph(), stream=fresh):
            kernels.bucket_histogram(ids, 200)
    except RuntimeError as e:
        if "capture stream" not in str(e):
            raise
    else:
        raise AssertionError("bucket_histogram: capture with no accumulator "
                             "on the capture stream was not refused")

    # Two histograms inside one CUDA graph, captured on the stream that
    # made the accumulator, replayed twice with an eager launch between.
    side = streams[0]
    side.wait_stream(cur)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        outs = [kernels.bucket_histogram(ids, 200) for _ in range(2)]
    for replay in range(2):
        graph.replay()
        require_equal(f"bucket_histogram eager after replay {replay}",
                      kernels.bucket_histogram(ids2, 200), want2)
        for i, got in enumerate(outs):
            require_equal(f"bucket_histogram in a graph, replay {replay} "
                          f"launch {i}", got, want)
    del graph, outs

    # The wrappers neither copy to the card nor synchronise per call.
    cols = _random_words(dev, 4096, chunk + 1, gen)
    ids = torch.randint(-1, 16, (4096,), dtype=torch.int32, device=dev,
                        generator=gen)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [kernels.hash_buckets(cols[:1], 16),
               kernels.hash_buckets(cols, 16),
               kernels.bucket_histogram(ids, 16)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    require_equal("hash_buckets k=1 under sync debug", got[0],
                  kernels.hash_buckets_plain(cols[:1], 16))
    require_equal("hash_buckets chunked under sync debug", got[1],
                  kernels.hash_buckets_plain(cols, 16))
    require_equal("bucket_histogram under sync debug", got[2],
                  kernels.bucket_histogram_plain(ids, 16))
    torch.cuda.synchronize()


def phase_b(dev, keys: np.ndarray) -> None:
    import torch

    from hyperspace_tpu_torch.ops.hash import route_partition_np
    from hyperspace_tpu_torch.ops.sort import bucket_counts, bucket_sort_permutation

    hw, ow = int64_words(keys)
    buckets, perm = bucket_sort_permutation(
        [torch.from_numpy(hw).to(dev)], [torch.from_numpy(ow).to(dev)],
        NUM_BUCKETS)
    want_b, want_p = route_partition_np([hw], [ow], NUM_BUCKETS)
    if not np.array_equal(buckets.cpu().numpy(), want_b):
        raise AssertionError("phase B: bucket ids differ from route_partition_np")
    if not np.array_equal(perm.cpu().numpy(), want_p):
        raise AssertionError("phase B: permutation differs from route_partition_np")
    counts = bucket_counts(buckets, NUM_BUCKETS).cpu().numpy()
    if not np.array_equal(counts, np.bincount(want_b, minlength=NUM_BUCKETS)):
        raise AssertionError("phase B: bucket_counts differ from np.bincount")


def check_index_files(phase: str, hs, name: str, key: str, rows: int,
                      num_buckets: int = NUM_BUCKETS,
                      lineage: bool = False) -> dict:
    """The index ``name`` is ACTIVE, each of its files holds only rows of
    its own bucket (by ``bucket_ids_np``) sorted by ``key``, and the
    files hold ``rows`` rows in all.  With ``lineage`` (phase G's
    lineitem), every row also carries its source file's id in
    ``_data_file_id`` (the file is known from the row's ``l_shipdate``
    block), and every file the entry records gives all its rows.
    Returns bucket -> file paths."""
    import pyarrow.parquet as pq

    from hyperspace_tpu_torch.io.parquet import bucket_id_of_file
    from hyperspace_tpu_torch.ops.hash import bucket_ids_np

    listed = [r for r in hs.indexes().to_pylist() if r["name"] == name]
    if len(listed) != 1 or listed[0]["state"] != "ACTIVE":
        raise AssertionError(f"{phase}: {name} is not ACTIVE: {listed}")
    entry = hs.session.index_collection_manager.get_index(name)
    columns = [key]
    if lineage:
        columns += ["l_shipdate", "_data_file_id"]
        ids = {os.path.basename(f.name): f.id for f in entry.source_file_infos()}
        blocks = N_FILES + G_APPENDED + G_APPENDED_AGAIN
        want = np.array([ids.get(g_file_name(b), -1) for b in range(blocks)],
                        dtype=np.int64)
        per_block = np.zeros(blocks, dtype=np.int64)
    files_by_bucket: dict = {}
    total = 0
    for info in entry.content.file_infos():
        b = bucket_id_of_file(info.name)
        files_by_bucket.setdefault(b, []).append(info.name)
        t = pq.read_table(info.name, columns=columns)
        keys = t.column(key).to_numpy()
        total += len(keys)
        hw, _ = int64_words(keys)
        if not np.all(bucket_ids_np([hw], num_buckets) == b):
            raise AssertionError(f"{phase}: rows of {info.name} outside bucket {b}")
        if np.any(np.diff(keys) < 0):
            raise AssertionError(f"{phase}: {info.name} is not sorted by {key}")
        if lineage:
            block = t.column("l_shipdate").to_numpy() // ROWS_PER_FILE
            if not np.array_equal(t.column("_data_file_id").to_numpy(),
                                  want[block]):
                raise AssertionError(f"{phase}: {info.name} holds rows whose "
                                     f"_data_file_id is not their file's")
            per_block += np.bincount(block, minlength=blocks)
    if total != rows:
        raise AssertionError(f"{phase}: {name}'s files hold {total} rows, "
                             f"expected {rows}")
    if lineage and not np.array_equal(
            per_block, np.where(want >= 0, ROWS_PER_FILE, 0)):
        raise AssertionError(f"{phase}: {name} does not hold exactly the rows "
                             f"of its recorded files")
    return files_by_bucket


def checked_report(label: str, hs) -> dict:
    """The last build report of ``hs`` as a dict, its ``bytes_written``
    and ``files_written`` held to the data files of the version
    directory the action wrote (the newest of its index's content); an
    action that wrote no index file is not checked."""
    report = hs.last_build_report()
    if report is None or report.outcome != "ok":
        raise AssertionError(f"{label}: build report {report}")
    if report.files_written:
        entry = hs.session.index_collection_manager.get_index(report.index)
        dirs = {os.path.dirname(f.name) for f in entry.content.file_infos()}
        newest = max(dirs, key=lambda d: int(d.rsplit("v__=", 1)[1]))
        files = [f.name for f in entry.content.file_infos()
                 if os.path.dirname(f.name) == newest]
        want = (sum(os.path.getsize(f) for f in files), len(files))
        if (report.bytes_written, report.files_written) != want:
            raise AssertionError(
                f"{label}: report wrote {report.bytes_written} bytes in "
                f"{report.files_written} files, {newest} holds {want}")
    return report.to_dict()


def phase_c(li: dict, root: str, dev) -> dict:
    import pyarrow as pa
    import pyarrow.compute as pc
    import pyarrow.parquet as pq

    from hyperspace_tpu_torch import Hyperspace, HyperspaceSession, IndexConfig
    from hyperspace_tpu_torch.ops import kernels
    from hyperspace_tpu_torch.ops.hash import bucket_ids_np

    src = os.path.join(root, "lineitem")
    write_files(li, src)

    session = HyperspaceSession(system_path=os.path.join(root, "indexes"),
                                device=dev)
    session.conf.num_buckets = NUM_BUCKETS
    session.conf.device_batch_rows = 1 << 23
    set_min_rows(session, 0)
    hs = Hyperspace(session)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    hs.create_index(session.read.parquet(src),
                    IndexConfig(INDEX_NAME, INDEXED, INCLUDED))
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    phases = session.build_stats_log[-1]
    report = checked_report("phase C", hs)

    files_by_bucket = check_index_files("phase C", hs, INDEX_NAME,
                                        "l_orderkey", N_LINEITEM)
    rng = np.random.default_rng(5)
    for key in rng.choice(li["l_orderkey"], size=5, replace=False):
        hw, _ = int64_words(np.array([key]))
        b = int(bucket_ids_np([hw], NUM_BUCKETS)[0])
        got = pa.concat_tables([pq.read_table(p, partitioning=None)
                                for p in sorted(files_by_bucket[b])])
        got = got.filter(pc.equal(got.column("l_orderkey"), key))
        mask = li["l_orderkey"] == key
        for c in INDEXED + INCLUDED:
            if not np.array_equal(got.column(c).to_numpy(), li[c][mask]):
                raise AssertionError(f"phase C: lookup of {key} differs in {c}")
    return {"wall_s": wall, "phases": phases, "launches": launches,
            "files": sum(len(v) for v in files_by_bucket.values()),
            "report": report}


def sorted_rows(columns: dict, keys) -> dict:
    """The columns' rows ordered by ``keys`` (lexicographic)."""
    order = np.lexsort([columns[k] for k in reversed(keys)])
    return {c: v[order] for c, v in columns.items()}


def in_key_order(columns: dict, keys) -> bool:
    """Whether the rows are already ordered by ``keys`` (lexicographic;
    NaN keys never count as ordered), so that ``sorted_rows``, a stable
    sort, would leave them as they are."""
    undecided = None
    for k in keys:
        v = columns[k]
        if v.dtype.kind == "f" and np.isnan(v).any():
            return False
        lt, gt = v[:-1] < v[1:], v[:-1] > v[1:]
        if undecided is None:
            undecided = np.ones(len(lt), dtype=bool)
        if (undecided & gt).any():
            return False
        undecided &= ~lt
    return True


def require_rows(name: str, table, want: dict, keys=None,
                 rtol: float = 0.0) -> None:
    """``table`` holds exactly the rows of ``want`` (column name ->
    numpy array): in the same order when ``keys`` is None, else as the
    same multiset of rows, compared after sorting both by ``keys``.  With
    ``rtol``, float columns (sums in another order) agree within it and
    the rest exactly."""
    if table.column_names != list(want):
        raise AssertionError(f"{name}: columns {table.column_names}, "
                             f"expected {list(want)}")
    got = {c: table.column(c).to_numpy() for c in want}
    if keys is not None:
        got = sorted_rows(got, keys)
        if not in_key_order(want, keys):
            want = sorted_rows(want, keys)
    for c, values in want.items():
        if rtol and np.issubdtype(values.dtype, np.floating) \
                and got[c].shape == values.shape:
            same = np.allclose(got[c], values, rtol=rtol, atol=0.0)
        else:
            same = np.array_equal(got[c], values)
        if not same or got[c].dtype != values.dtype:
            raise AssertionError(f"{name}: column {c} differs from numpy "
                                 f"({len(got[c])} rows of {got[c].dtype}, "
                                 f"expected {len(values)} of {values.dtype})")


def top_groups(groups: np.ndarray, weights: np.ndarray, k: int, label: str):
    """(group keys, sums) of the k groups with the largest sum of
    ``weights`` (groups with rows only; ties to the smaller key, as the
    device ranks them).  Raises unless the k-th and (k+1)-th sums differ
    by more than AGG_RTOL relative, so that the check decides."""
    sums = np.bincount(groups, weights=weights)
    present = np.flatnonzero(np.bincount(groups) > 0)
    order = present[np.argsort(-sums[present], kind="stable")]
    kth, after = sums[order[k - 1]], sums[order[k]]
    if abs(kth - after) <= AGG_RTOL * abs(kth):
        raise AssertionError(f"{label}: the {k}th and {k + 1}th sums tie "
                             f"({kth!r}, {after!r}): the check decides nothing")
    return order[:k], sums[order[:k]]


def expected_aggregates(orders: dict, li: dict) -> dict:
    """The aggregate queries answered by numpy from the generated arrays,
    in the queries' own row order (keys None): each lineitem row's order
    is a gather, as in ``expected_answers``."""
    lk = li["l_orderkey"]
    position = np.empty(N_ORDERS, dtype=np.int64)
    position[orders["o_orderkey"]] = np.arange(N_ORDERS)
    row = position[lk]
    cust = orders["o_custkey"][row]
    revenue = li["l_extendedprice"] * (1 - li["l_discount"])
    cheap = orders["o_totalprice"][row] < PRICE_BELOW
    q3_cust, q3_rev = top_groups(cust[cheap], revenue[cheap], Q3_TOP, "q3")
    ship = li["l_shipdate"]
    window = (ship >= Q10_WINDOW[0]) & (ship < Q10_WINDOW[1])
    q10_cust, q10_rev = top_groups(cust[window], revenue[window], Q10_TOP,
                                   "q10")
    sel = orders["o_orderkey"] < AGG_ORDERKEY_BELOW
    prio, price = orders["o_shippriority"][sel], orders["o_totalprice"][sel]
    keys = np.unique(prio)
    n = np.bincount(prio)[keys]
    total = np.bincount(prio, weights=price)[keys]
    low = np.array([price[prio == k].min() for k in keys])
    high = np.array([price[prio == k].max() for k in keys])
    return {
        "q3": ({"o_custkey": q3_cust, "revenue": q3_rev}, None),
        "q10": ({"o_custkey": q10_cust, "revenue": q10_rev}, None),
        "agg_by_priority": ({"o_shippriority": keys, "total": total,
                             "low": low, "high": high, "avg": total / n,
                             "n": n.astype(np.int64)}, None),
    }


def expected_answers(orders: dict, li: dict) -> dict:
    """Each query of QUERIES answered by numpy from the generated arrays:
    (expected columns, sort keys or None for "in source order"), the
    columns of a keyed answer already in key order (``require_rows`` then
    sorts only the rows it checks).
    ``o_orderkey`` is a permutation of ``arange``, so the join is a
    gather of the order row of each lineitem row."""
    lk = li["l_orderkey"]
    point = lk == POINT_KEY
    in_range = (lk >= RANGE[0]) & (lk < RANGE[1])
    position = np.empty(N_ORDERS, dtype=np.int64)
    position[orders["o_orderkey"]] = np.arange(N_ORDERS)
    price = orders["o_totalprice"][position[lk]]
    joined = {"o_orderkey": lk, "o_totalprice": price,
              "l_quantity": li["l_quantity"],
              "l_extendedprice": li["l_extendedprice"]}
    cheap = price < PRICE_BELOW
    join_keys = ["o_orderkey", "l_extendedprice"]
    range_keys = ["l_orderkey", "l_extendedprice"]
    return {
        "point": ({c: li[c][point] for c in ("l_orderkey", "l_quantity")},
                  None),
        "range": (sorted_rows({c: li[c][in_range] for c in (
            "l_orderkey", "l_extendedprice", "l_discount")}, range_keys),
            range_keys),
        "join": (sorted_rows(joined, join_keys), join_keys),
        "filtered_join": (sorted_rows({c: v[cheap] for c, v in joined.items()},
                                      join_keys), join_keys),
    }


def build_queries(session, root: str, lineitem: str = "lineitem",
                  aggregates: bool = False) -> dict:
    """The four queries of phase D as Datasets of ``session``, over the
    lineitem files in ``root/lineitem``; with ``aggregates`` then also
    ``q3``, ``q10`` and ``agg_by_priority``."""
    from hyperspace_tpu_torch import col

    li = session.read.parquet(os.path.join(root, lineitem))
    orders = session.read.parquet(os.path.join(root, "orders"))
    join_cols = ("o_orderkey", "o_totalprice", "l_quantity", "l_extendedprice")
    queries = {
        "point": li.filter(col("l_orderkey") == POINT_KEY)
        .select("l_orderkey", "l_quantity"),
        "range": li.filter((col("l_orderkey") >= RANGE[0])
                           & (col("l_orderkey") < RANGE[1]))
        .select("l_orderkey", "l_extendedprice", "l_discount"),
        "join": orders.join(li, col("o_orderkey") == col("l_orderkey"))
        .select(*join_cols),
        "filtered_join": orders.filter(col("o_totalprice") < PRICE_BELOW)
        .join(li, col("o_orderkey") == col("l_orderkey")).select(*join_cols),
    }
    if not aggregates:
        return queries
    revenue = col("l_extendedprice") * (1 - col("l_discount"))
    queries["q3"] = (
        orders.filter(col("o_totalprice") < PRICE_BELOW)
        .join(li, col("o_orderkey") == col("l_orderkey"))
        .group_by("o_custkey").agg(revenue=(revenue, "sum"))
        .sort(("revenue", False)).limit(Q3_TOP))
    queries["q10"] = (
        li.filter((col("l_shipdate") >= Q10_WINDOW[0])
                  & (col("l_shipdate") < Q10_WINDOW[1]))
        .join(orders, col("l_orderkey") == col("o_orderkey"))
        .group_by("o_custkey").agg(revenue=(revenue, "sum"))
        .sort(("revenue", False)).limit(Q10_TOP))
    queries["agg_by_priority"] = (
        orders.filter(col("o_orderkey") < AGG_ORDERKEY_BELOW)
        .group_by("o_shippriority")
        .agg(total=("o_totalprice", "sum"), low=("o_totalprice", "min"),
             high=("o_totalprice", "max"), avg=("o_totalprice", "mean"),
             n=("o_totalprice", "count_all"))
        .sort("o_shippriority"))
    return queries


def index_scans(plan) -> list:
    """(index name, pruned buckets) of every index scan in ``plan``."""
    rel = getattr(plan, "relation", None)
    out = [] if rel is None or not rel.index_scan_of \
        else [(rel.index_scan_of, rel.prune_to_buckets)]
    for child in plan.children:
        out.extend(index_scans(child))
    return out


def wall_ms(fn) -> float:
    """Host milliseconds of ``fn()``, which ends in host data (a collect
    pulls every result to the host, so the device work is done)."""
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def short_kernel_name(name: str) -> str:
    """``void at::native::elementwise_kernel<128, 4, ...>(...)`` ->
    ``elementwise_kernel`` (kernels in an anonymous namespace too);
    copies and memsets keep their names."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    head = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    head = head.split("<", 1)[0].split("(", 1)[0]
    return head.rsplit("::", 1)[-1]


@contextlib.contextmanager
def annotated_programs():
    """While the context lasts, each of the slice's device programs
    (AGG_PROGRAMS, in ``ops.aggregate`` and ``ops.join_agg``) runs inside
    a ``torch.profiler.record_function`` of its name."""
    import torch

    from hyperspace_tpu_torch.ops import aggregate, join_agg

    saved = []
    for module in (aggregate, join_agg):
        for name in AGG_PROGRAMS:
            fn = getattr(module, name, None)
            if fn is None:
                continue

            def wrapped(*args, _fn=fn, _name=name, **kwargs):
                with torch.profiler.record_function(_name):
                    return _fn(*args, **kwargs)

            saved.append((module, name, fn))
            setattr(module, name, wrapped)
    try:
        yield
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)


# (owner, attribute, stage) of stage_breakdown: the owner is the class
# or module whose attribute the executor looks up at call time.
STAGES = (
    ("Executor", "_scan", "scan_ms"),
    ("executor", "files_fingerprint", "fingerprint_ms"),
    ("Executor", "_filter", "arrow_ms"),
    ("Executor", "_host_join_tables", "arrow_ms"),
    ("pyarrow", "concat_tables", "arrow_ms"),
    ("Executor", "_device_column", "upload_ms"),
    ("Executor", "_eval_predicate", "predicate_ms"),
    ("Executor", "_eval_device", "predicate_ms"),
    ("executor", "_eval_arrow", "predicate_ms"),
    ("join", "sorted_equi_join", "device_call_ms"),
    ("join_agg", "join_group_aggregate", "device_call_ms"),
    ("aggregate", "grouped_aggregate", "device_call_ms"),
    ("join", "sorted_equi_join_np", "host_match_ms"),
    ("Executor", "_route_to_buckets", "route_ms"),
    ("Executor", "_join", "join_other_ms"),
)


def stage_breakdown(fn) -> dict:
    """One run of ``fn`` (a query) with its time split by stage, in
    thread-ms summed over every thread that ran a stage (the bucketed
    join runs its buckets on 8 pool threads): each stage counts its own
    time, not the time of the stages it calls (per thread, a stack of
    open stages in a ``threading.local``).

      scan_ms         Parquet reads (``Executor._scan``)
      fingerprint_ms  the file identities (``files_fingerprint``)
      arrow_ms        arrow's filter, take and concat (``_filter``,
                      ``_host_join_tables``, ``pa.concat_tables``)
      upload_ms       the columns to the card (``_device_column``:
                      conversion and copy; a cache hit costs ~0)
      predicate_ms    a predicate beside its uploads (compare on the
                      card and the mask back, or arrow's predicate)
      device_call_ms  the join, aggregate and fused calls with their read
                      backs, a numpy upload inside them included
      host_match_ms   the host route's ``sorted_equi_join_np``
      route_ms        the hybrid route of appended rows (hash on the card)
      join_other_ms   the rest of ``_join``; on the calling thread of a
                      bucketed join the wait on the pool

    Beside them: ``threads`` that ran a stage; per pool thread its busy
    ms (the time under its outermost stage, a bucket's ``_join``), the
    busiest, and ``pool_wait_ms``, the wall minus the busiest worker;
    ``mean_busy_workers``, the pool threads' busy ms over the wall (the
    shared pool rotates a call's at most 8 tasks over all its threads, so
    8 means the call kept its workers saturated); ``other_ms``, the wall
    minus the calling thread's outermost stages (planning, the
    result)."""
    import threading

    import pyarrow

    from hyperspace_tpu_torch.execution import executor
    from hyperspace_tpu_torch.ops import aggregate, join, join_agg

    owners = {"Executor": executor.Executor, "executor": executor,
              "pyarrow": pyarrow, "join": join, "join_agg": join_agg,
              "aggregate": aggregate}
    totals: dict = {}
    outer: dict = {}
    lock = threading.Lock()
    local = threading.local()

    def add(book: dict, key, ms: float) -> None:
        with lock:
            book[key] = book.get(key, 0.0) + ms

    def wrap(fn0, stage):
        def timed(*args, **kwargs):
            stack = local.__dict__.setdefault("stack", [])
            entered = time.perf_counter()
            if stack:
                add(totals, stack[-1][0], (entered - stack[-1][1]) * 1e3)
            stack.append([stage, entered])
            try:
                return fn0(*args, **kwargs)
            finally:
                left = time.perf_counter()
                add(totals, stage, (left - stack.pop()[1]) * 1e3)
                if stack:
                    stack[-1][1] = left
                else:
                    add(outer, threading.get_ident(), (left - entered) * 1e3)
        return timed

    saved = []
    for owner_name, name, stage in STAGES:
        owner = owners[owner_name]
        fn0 = getattr(owner, name)
        saved.append((owner, name, fn0))
        setattr(owner, name, wrap(fn0, stage))
    main = threading.get_ident()
    try:
        wall = wall_ms(fn)
    finally:
        for owner, name, fn0 in reversed(saved):
            setattr(owner, name, fn0)
    workers = sorted((ms for t, ms in outer.items() if t != main), reverse=True)
    busiest = workers[0] if workers else 0.0
    return {"wall_ms": wall,
            **{stage: totals.get(stage, 0.0)
               for stage in dict.fromkeys(st for _o, _n, st in STAGES)},
            "threads": len(outer), "worker_busy_ms": workers,
            "busiest_worker_ms": busiest,
            "pool_wait_ms": wall - busiest if workers else 0.0,
            "mean_busy_workers": sum(workers) / wall,
            "other_ms": wall - outer.get(main, 0.0)}


def profile_query(dev, fn, programs: bool = False) -> dict:
    """One run of ``fn`` (a query, or a build) under ``torch.profiler``:
    its wall time, the sum of its device activities (kernels and copies;
    one stream, so they do not overlap), and the activities grouped by
    kernel name with their launches and milliseconds, largest first.
    With ``programs``, also per device program of AGG_PROGRAMS its calls
    and the device time of the kernels it launched."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        if programs:
            with annotated_programs():
                wall = wall_ms(fn)
        else:
            wall = wall_ms(fn)
    by_name: dict = {}
    by_program: dict = {}
    for e in prof.events():
        if e.name in AGG_PROGRAMS:
            # The annotation itself: on the CPU its calls and the device
            # time of its kernels; on the device a span, not counted.
            if e.device_type == DeviceType.CPU:
                t = getattr(e, "device_time_total", None)
                entry = by_program.setdefault(e.name, [0, 0.0])
                entry[0] += 1
                entry[1] += (t if t is not None else e.cuda_time_total) / 1e3
        elif e.device_type == DeviceType.CUDA:
            entry = by_name.setdefault(short_kernel_name(e.name), [0, 0.0])
            entry[0] += 1
            entry[1] += e.time_range.elapsed_us() / 1e3
    device_ms = sum(ms for _, ms in by_name.values())
    out = {"profiled_wall_ms": wall, "device_ms": device_ms,
           "busy_share": device_ms / wall if wall else None,
           "device_ops": [{"op": k, "launches": n, "ms": ms} for k, (n, ms)
                          in sorted(by_name.items(), key=lambda kv: -kv[1][1])]}
    if programs:
        out["programs"] = [{"program": k, "calls": n, "device_ms": ms}
                           for k, (n, ms) in sorted(by_program.items())]
    return out


def routes(stats: dict) -> dict:
    """The strategies a collect recorded, per kind, sorted."""
    return {k: sorted({d["strategy"] for d in stats.get(k, [])})
            for k in ("filters", "joins", "join_kernels")}


AGG_QUERIES = ("q3", "q10", "agg_by_priority")


def expected_routes(name: str, route: str) -> dict:
    """The strategies query ``name`` must record on ``route`` ("device"
    or "host"): its filters and join kernels on that route, and every
    join bucketed, except the fused join→aggregate of q3 and q10 on the
    device route, which records no join kernel."""
    join = name.endswith("join") or name in ("q3", "q10")
    if name in ("q3", "q10") and route == "device":
        return {"filters": [route], "joins": ["device-fused-agg"],
                "join_kernels": []}
    return {"filters": [route] if name != "join" else [],
            "joins": ["bucketed"] if join else [],
            "join_kernels": [route] if join else []}


def expected_aggregates_route(name: str, route: str) -> list:
    """(strategy, topn) of each device aggregate query ``name`` records."""
    if route == "host" or name not in AGG_QUERIES:
        return []
    if name == "agg_by_priority":
        return [("device-segment", None)]
    return [("device-join-agg", Q3_TOP if name == "q3" else Q10_TOP)]


def aggregate_routes(stats: dict) -> list:
    return [(d["strategy"], d.get("topn")) for d in stats.get("aggregates", [])]


def query_indexes(name: str) -> list:
    """The indexes query ``name``'s indexed plan must scan."""
    if name == "agg_by_priority":
        return [ORDERS_INDEX]
    if name.endswith("join") or name in ("q3", "q10"):
        return sorted([INDEX_NAME, ORDERS_INDEX])
    return [INDEX_NAME]


def set_min_rows(session, rows: int) -> None:
    """Every routing threshold, the cold and the resident ones and the
    build's: with only the cold ones raised, a query whose columns are
    resident still takes the card.  Phases A-G pin them (0: the device
    routes) instead of taking the calibrated defaults; phase H leaves
    them at None."""
    session.conf.device_filter_min_rows = rows
    session.conf.device_join_min_rows = rows
    session.conf.device_agg_min_rows = rows
    session.conf.device_build_min_rows = rows
    session.conf.device_resident_min_rows = rows


def device_cache():
    from hyperspace_tpu_torch.execution.device_cache import global_cache

    return global_cache()


def resident_mib() -> float:
    return device_cache().bytes_cached / 2**20


def timed_collect(ds) -> tuple:
    """(``ds.collect()``, its host milliseconds), as ``wall_ms`` times."""
    t0 = time.perf_counter()
    table = ds.collect()
    return table, (time.perf_counter() - t0) * 1e3


def cold_ms(fn) -> float:
    """``wall_ms(fn)`` on an empty device column cache (emptied before
    the clock starts)."""
    device_cache().clear()
    return wall_ms(fn)


def require_warm(label: str, stats: dict) -> None:
    """A warm collect: the cache answered every column (hits, no miss)
    and every device filter, join kernel, fused join and aggregate read
    resident inputs."""
    cache = stats.get("device_cache") or {}
    entries = [d for k in ("filters", "join_kernels", "joins", "aggregates")
               for d in stats.get(k, [])
               if d["strategy"] not in ("host", "bucketed", "plain")]
    if not cache.get("hits") or cache.get("misses") \
            or not all(d.get("resident") is True for d in entries):
        raise AssertionError(f"{label}: warm run with cache {cache}, "
                             f"entries {entries}")


def check_routes(label: str, name: str, route: str, stats: dict) -> None:
    got = (routes(stats), aggregate_routes(stats))
    want = (expected_routes(name, route), expected_aggregates_route(name, route))
    if got != want:
        raise AssertionError(f"phase D {name}: {label} strategies {got}, "
                             f"expected {want}")


def d_build(orders: dict, root: str, dev) -> tuple:
    """Phase D's ``ord_idx`` build beside phase C's ``li_idx``, its files
    checked, with the launch counts set to 0 just before it: the session,
    its ``Hyperspace`` and the build's seconds."""
    from hyperspace_tpu_torch import Hyperspace, HyperspaceSession, IndexConfig
    from hyperspace_tpu_torch.ops import kernels

    device_cache().clear()
    write_files(orders, os.path.join(root, "orders"))
    session = HyperspaceSession(system_path=os.path.join(root, "indexes"),
                                device=dev)
    session.conf.num_buckets = NUM_BUCKETS
    session.conf.device_batch_rows = 1 << 23
    set_min_rows(session, 0)
    hs = Hyperspace(session)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    hs.create_index(
        session.read.parquet(os.path.join(root, "orders")),
        IndexConfig(ORDERS_INDEX, ["o_orderkey"],
                    ["o_totalprice", "o_custkey", "o_shippriority"]))
    build_s = time.perf_counter() - t0
    check_index_files("phase D", hs, ORDERS_INDEX, "o_orderkey", N_ORDERS)
    return session, hs, build_s


def phase_d(orders: dict, li: dict, root: str, dev) -> dict:
    """Queries through the indexes: build ``ord_idx`` beside phase C's
    ``li_idx`` and check its files (``d_build``), then run QUERIES with
    hyperspace enabled (device route cold and warm, then the host route)
    and disabled (cold and warm), each answer held to numpy; time each,
    and profile and split one cold and one warm indexed run.  Then q3
    once more under a device column cache budget below its working
    set."""
    from hyperspace_tpu_torch.ops import kernels

    session, _, build_s = d_build(orders, root, dev)
    queries = build_queries(session, root, aggregates=True)
    expected = {**expected_answers(orders, li),
                **expected_aggregates(orders, li)}
    rows = []
    for name, ds in queries.items():
        want, keys = expected[name]
        rtol = AGG_RTOL if name in AGG_QUERIES else 0.0

        def checked(label: str, route: str, warm: bool = False) -> dict:
            require_rows(f"phase D {name} {label}", ds.collect(), want, keys,
                         rtol)
            stats = session.last_execution_stats
            if route is not None:
                check_routes(label, name, route, stats)
            if warm:
                require_warm(f"phase D {name} {label}", stats)
            return stats

        session.enable_hyperspace()
        scans = index_scans(ds.optimized_plan())
        names = sorted(n for n, _ in scans)
        if names != query_indexes(name):
            raise AssertionError(f"phase D {name}: plan scans {names}, "
                                 f"expected {query_indexes(name)}")
        device_cache().clear()
        stats = checked("indexed", "device")
        cache_cold = stats.get("device_cache")
        indexed_cold = [cold_ms(ds.collect) for _ in range(D_TIMED_RUNS)]
        cache_warm = checked("indexed warm", "device", warm=True)["device_cache"]
        indexed_warm = [wall_ms(ds.collect) for _ in range(D_TIMED_RUNS)]
        device_cache().clear()
        profiled = profile_query(dev, ds.collect, programs=name in AGG_QUERIES)
        device_cache().clear()
        profiled["stages"] = {"cold": stage_breakdown(ds.collect),
                              "warm": stage_breakdown(ds.collect)}
        # Resident columns lower no threshold here: the route is the host.
        set_min_rows(session, HOST_ROUTE_MIN_ROWS)
        checked("host route", "host")
        host_route = [wall_ms(ds.collect) for _ in range(D_TIMED_RUNS)]
        set_min_rows(session, 0)
        session.disable_hyperspace()
        if index_scans(ds.optimized_plan()):
            raise AssertionError(f"phase D {name}: disabled plan scans an index")
        device_cache().clear()
        checked("source", None)
        scan_cold = [cold_ms(ds.collect) for _ in range(D_TIMED_RUNS)]
        checked("source warm", None, warm=True)
        scan_warm = [wall_ms(ds.collect) for _ in range(D_TIMED_RUNS)]
        med = {k: statistics.median(v) for k, v in (
            ("indexed_cold_ms", indexed_cold), ("indexed_warm_ms", indexed_warm),
            ("scan_cold_ms", scan_cold), ("scan_warm_ms", scan_warm),
            ("host_route_ms", host_route))}
        rows.append({
            "name": name, "rows": len(next(iter(want.values()))), **med,
            "speedup_cold": med["scan_cold_ms"] / med["indexed_cold_ms"],
            "speedup_warm": med["scan_warm_ms"] / med["indexed_warm_ms"],
            "host_over_device_cold": med["host_route_ms"] / med["indexed_cold_ms"],
            "host_over_device_warm": med["host_route_ms"] / med["indexed_warm_ms"],
            "device_cache_cold": cache_cold, "device_cache_warm": cache_warm,
            **profiled,
            "pruned_buckets": [len(b) if b is not None else None
                               for _, b in scans],
            "files_read": sum(s["files_read"] for s in stats["scans"]),
            "filters": len(stats.get("filters", [])),
            "join_kernels": len(stats.get("join_kernels", [])),
            "aggregates": stats.get("aggregates", []),
            "indexed_cold_runs_ms": indexed_cold,
            "indexed_warm_runs_ms": indexed_warm,
            "scan_cold_runs_ms": scan_cold, "scan_warm_runs_ms": scan_warm,
            "host_route_runs_ms": host_route})
    resident_end = resident_mib()
    eviction = eviction_run(session, queries["q3"], expected["q3"])
    device_cache().clear()
    return {"queries": rows, "build_s": build_s, "eviction": eviction,
            "resident_mib_end": resident_end,
            "launches": kernels.launch_counts()}


def eviction_run(session, ds, expected: tuple) -> dict:
    """q3 twice through the indexes with the cache's budget at
    EVICTION_BUDGET, under its working set: both answers right, the
    cache's evictions and rejections over the two counted."""
    want, keys = expected
    session.enable_hyperspace()
    cache = device_cache()
    cache.clear()
    before = cache.stats()
    budget = session.conf.device_cache_bytes
    session.conf.device_cache_bytes = EVICTION_BUDGET
    try:
        runs = []
        for i in range(2):
            ms = wall_ms(lambda: require_rows(f"phase D q3 eviction run {i}",
                                              ds.collect(), want, keys,
                                              AGG_RTOL))
            runs.append({"ms": ms, "device_cache":
                         session.last_execution_stats.get("device_cache"),
                         "resident": [d.get("resident") for d in
                                      session.last_execution_stats.get(
                                          "aggregates", [])]})
    finally:
        session.conf.device_cache_bytes = budget
    after = cache.stats()
    out = {"budget_mib": EVICTION_BUDGET / 2**20, "runs": runs,
           "evictions": after["evictions"] - before["evictions"],
           "rejected": after["rejected"], "resident_mib": resident_mib()}
    if not out["evictions"] and not out["rejected"]:
        raise AssertionError(f"phase D q3 eviction: nothing evicted or "
                             f"rejected: {out}")
    return out


def bucket_digests(hs, name: str) -> dict:
    """bucket -> sorted sha256 of the index ``name``'s files (hashed on
    8 threads: hashlib releases the GIL)."""
    import hashlib
    from concurrent.futures import ThreadPoolExecutor

    from hyperspace_tpu_torch.io.parquet import bucket_id_of_file

    def digest(path: str) -> str:
        with open(path, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()

    entry = hs.session.index_collection_manager.get_index(name)
    paths = [info.name for info in entry.content.file_infos()]
    with ThreadPoolExecutor(8) as pool:
        digests = list(pool.map(digest, paths))
    out: dict = {}
    for path, d in zip(paths, digests):
        out.setdefault(bucket_id_of_file(path), []).append(d)
    return {b: sorted(v) for b, v in out.items()}


def spill_session(dev, system_path: str, **conf):
    """A session with the conf's defaults but SPILL_BUCKETS buckets and
    the routing thresholds pinned to 0; the default batch must be
    DEFAULT_BATCH_ROWS."""
    from hyperspace_tpu_torch import Hyperspace, HyperspaceSession

    session = HyperspaceSession(system_path=system_path, device=dev)
    if session.conf.device_batch_rows != DEFAULT_BATCH_ROWS:
        raise AssertionError(f"the conf's default batch is "
                             f"{session.conf.device_batch_rows} rows, not "
                             f"{DEFAULT_BATCH_ROWS} (HS_DEVICE_BATCH_ROWS set?)")
    session.conf.num_buckets = SPILL_BUCKETS
    set_min_rows(session, 0)
    for k, v in conf.items():
        setattr(session.conf, k, v)
    return Hyperspace(session)


def require_launches(label: str, launches: dict, want: dict) -> None:
    if launches != want:
        raise AssertionError(f"{label}: launches {launches}, expected {want}")


def timed_build(dev, label: str, hs, run, want_launches) -> dict:
    """``run()`` (a build, a refresh or an optimize) with the launch
    counts set to 0 just before and read just after: each kernel must
    have launched ``want_launches`` times (or, a dict, as many times as
    it names).  Returns its wall, phases (of a run that built index
    data), launches, the card's peak allocation and its checked build
    report."""
    import torch

    from hyperspace_tpu_torch.ops import kernels

    log = hs.session.build_stats_log
    logged = len(log)
    # A build reads no cached column: what queries left resident would
    # only raise its peak.
    device_cache().clear()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    outcome = run()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    require_launches(label, launches, want_launches
                     if isinstance(want_launches, dict)
                     else {k: want_launches for k in launches})
    return {"build": label, "wall_s": wall, "launches": launches,
            "phases": {k: v for k, v in log[-1].items() if k != "index"}
            if len(log) > logged else {},
            "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
            "report": checked_report(label, hs),
            "outcome": outcome}


def index_state(hs, name: str) -> str:
    rows = [r for r in hs.indexes().to_pylist() if r["name"] == name]
    return rows[0]["state"] if rows else "missing"


def version_dirs(system_path: str, name: str) -> list:
    return sorted(d for d in os.listdir(os.path.join(system_path, name))
                  if d.startswith("v__="))


def phase_e(li: dict, root: str, dev) -> list:
    """The spill build at SF1 with the default batch (see the module
    docstring); returns one record per build."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from hyperspace_tpu_torch import IndexConfig

    device_cache().clear()
    src = os.path.join(root, "lineitem")
    chunks = -(-N_LINEITEM // DEFAULT_BATCH_ROWS)
    config = IndexConfig(INDEX_NAME, INDEXED, INCLUDED)
    builds, digests = [], {}
    for label, conf, want in (
            ("E spill pipelined", {}, chunks),
            ("E spill serial", {"build_pipeline_enabled": False}, chunks),
            ("E monolithic", {"device_batch_rows": MONOLITHIC_BATCH_ROWS}, 1)):
        path = os.path.join(root, "e_" + label.split()[-1])
        hs = spill_session(dev, path, **conf)
        rec = timed_build(dev, label, hs, lambda: hs.create_index(
            hs.session.read.parquet(src), config), want)
        spilled = "spill_route_s" in rec["phases"]
        if spilled != (want > 1):
            raise AssertionError(f"phase {label}: spilled={spilled}")
        if want > 1:
            check_index_files(f"phase {label}", hs, INDEX_NAME, "l_orderkey",
                              N_LINEITEM, SPILL_BUCKETS)
        digests[label] = bucket_digests(hs, INDEX_NAME)
        builds.append(rec)
        shutil.rmtree(path, ignore_errors=True)
    # Once more under torch.profiler, for the build's device time and the
    # card's busy share (the profiler's own cost inflates this wall).
    path = os.path.join(root, "e_profiled")
    hs = spill_session(dev, path)
    profiled: dict = {}
    rec = timed_build(dev, "E spill profiled", hs, lambda: profiled.update(
        profile_query(dev, lambda: hs.create_index(
            hs.session.read.parquet(src), config))), chunks)
    rec.update(device_ms=profiled["device_ms"],
               busy_share=profiled["busy_share"],
               device_ops=profiled["device_ops"][:10])
    digests[rec["build"]] = bucket_digests(hs, INDEX_NAME)
    builds.append(rec)
    shutil.rmtree(path, ignore_errors=True)
    first = digests["E monolithic"]
    if len(first) != SPILL_BUCKETS or \
            any(d != first for d in digests.values()):
        raise AssertionError("phase E: per-bucket sha256 differ between the "
                             "spilled and monolithic builds")

    # The lifecycle over a copy of the source (hard links: the files are
    # never written) with one file appended after the build.
    copy = os.path.join(root, "lineitem_copy")
    shutil.copytree(src, copy, copy_function=os.link)
    path = os.path.join(root, "e_life")
    hs = spill_session(dev, path)
    builds.append(timed_build(dev, "E create copy", hs, lambda: hs.create_index(
        hs.session.read.parquet(copy),
        IndexConfig(COPY_INDEX, INDEXED, INCLUDED)), chunks))
    pq.write_table(pa.table({c: v[:APPENDED_ROWS] for c, v in li.items()}),
                   os.path.join(copy, "part-99999.parquet"))
    rows = N_LINEITEM + APPENDED_ROWS
    rec = timed_build(dev, "E refresh full", hs,
                      lambda: hs.refresh_index(COPY_INDEX, "full"),
                      -(-rows // DEFAULT_BATCH_ROWS))
    summary = rec.pop("outcome")
    if (summary.outcome, summary.appended, summary.deleted) != ("ok", 1, 0):
        raise AssertionError(f"phase E: refresh summary {summary}")
    check_index_files("phase E refresh", hs, COPY_INDEX, "l_orderkey", rows,
                      SPILL_BUCKETS)
    builds.append(rec)
    if version_dirs(path, COPY_INDEX) != ["v__=0", "v__=1"]:
        raise AssertionError(f"phase E: versions {version_dirs(path, COPY_INDEX)}")
    noop = hs.refresh_index(COPY_INDEX, "full")
    if noop.outcome != "noop" or noop.version is not None:
        raise AssertionError(f"phase E: refresh of an unchanged source: {noop}")
    for verb, want in (("delete_index", "DELETED"), ("restore_index", "ACTIVE"),
                       ("delete_index", "DELETED"),
                       ("vacuum_index", "DOESNOTEXIST")):
        getattr(hs, verb)(COPY_INDEX)
        if index_state(hs, COPY_INDEX) != want:
            raise AssertionError(f"phase E: {verb} left "
                                 f"{index_state(hs, COPY_INDEX)}, not {want}")
    if version_dirs(path, COPY_INDEX):
        raise AssertionError(f"phase E: vacuum left {version_dirs(path, COPY_INDEX)}")
    for rec in builds:
        rec.pop("outcome", None)
    shutil.rmtree(path, ignore_errors=True)
    shutil.rmtree(copy, ignore_errors=True)
    return builds


def write_sf10_lineitem(path: str) -> None:
    """bench.py's SF10 generator (``default_rng(17)``): lineitem, 15
    columns, in SF10_FILES files.  Its orders columns are drawn from the
    same stream, and not written, so lineitem's values are bench.py's."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    from concurrent.futures import ThreadPoolExecutor

    os.makedirs(path)
    rng = np.random.default_rng(17)
    per_li = -(-N_LINEITEM_SF10 // SF10_FILES)
    per_ord = -(-N_ORDERS_SF10 // SF10_FILES)
    pending = []
    with ThreadPoolExecutor(4) as pool:
        for f in range(SF10_FILES):
            n = min(per_li, N_LINEITEM_SF10 - f * per_li)
            base = f * per_li
            cols = {
                "l_orderkey": rng.integers(0, N_ORDERS_SF10, n),
                "l_quantity": rng.integers(1, 50, n).astype(np.float64),
                "l_extendedprice": rng.random(n) * 1e4,
                "l_discount": rng.random(n) * 0.1,
                "l_shipdate": np.arange(base, base + n, dtype=np.int64),
                "l_status": rng.integers(0, 4, n),
            }
            for i in range(9):
                cols[f"l_pad{i}"] = rng.random(n)
            n_o = min(per_ord, N_ORDERS_SF10 - f * per_ord)
            rng.integers(0, 200_000, n_o)  # o_custkey
            rng.random(n_o)                # o_totalprice
            while len(pending) >= 4:
                pending.pop(0).result()
            pending.append(pool.submit(
                pq.write_table, pa.table(cols),
                os.path.join(path, f"part-{f:05d}.parquet")))
        for fut in pending:
            fut.result()


def phase_f(root: str, dev) -> dict:
    """The SF10 spill build (see the module docstring)."""
    import resource

    from hyperspace_tpu_torch import IndexConfig

    device_cache().clear()
    src = os.path.join(root, "sf10_lineitem")
    t0 = time.perf_counter()
    write_sf10_lineitem(src)
    datagen_s = time.perf_counter() - t0
    free_gb = shutil.disk_usage(root).free / 1e9
    path = os.path.join(root, "f_indexes")
    hs = spill_session(dev, path)
    chunks = -(-N_LINEITEM_SF10 // DEFAULT_BATCH_ROWS)
    rss_before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
    rec = timed_build(dev, "F sf10 spill", hs, lambda: hs.create_index(
        hs.session.read.parquet(src),
        IndexConfig(SF10_INDEX, INDEXED, INCLUDED)), chunks)
    rec.pop("outcome")
    rec["peak_rss_mb"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
    rec["peak_rss_mb_before"] = rss_before
    t0 = time.perf_counter()
    check_index_files("phase F", hs, SF10_INDEX, "l_orderkey", N_LINEITEM_SF10,
                      SPILL_BUCKETS)
    rec.update(rows=N_LINEITEM_SF10, files=SF10_FILES, chunks=chunks,
               datagen_s=datagen_s, check_s=time.perf_counter() - t0,
               disk_free_gb_before=free_gb)
    shutil.rmtree(path, ignore_errors=True)
    # Phase J's SF10 part, on this source before it goes.
    rec["zorder"] = zorder_sf10(root, src, dev)
    shutil.rmtree(src, ignore_errors=True)
    return rec


def g_append(path: str, first: int, count: int, seed: int) -> dict:
    """``count`` lineitem files of ROWS_PER_FILE rows from
    ``gen_lineitem(default_rng(seed))``, written as ``part-9NNNN`` (after
    the original files in listing order).  File ``first + j`` holds the
    ``l_shipdate`` values of block ``64 + first + j``, so every row's
    shipdate names its file, as the original files' do."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    cols = gen_lineitem(np.random.default_rng(seed), count * ROWS_PER_FILE)
    cols["l_shipdate"] = (N_FILES + first) * ROWS_PER_FILE \
        + np.arange(count * ROWS_PER_FILE, dtype=np.int64)
    table = pa.table(cols)
    for j in range(count):
        pq.write_table(table.slice(j * ROWS_PER_FILE, ROWS_PER_FILE),
                       os.path.join(path, f"part-{90000 + first + j:05d}.parquet"))
    return cols


def g_file_name(block: int) -> str:
    """The source file of ``l_shipdate`` block ``block``."""
    return f"part-{block:05d}.parquet" if block < N_FILES \
        else f"part-{90000 + block - N_FILES:05d}.parquet"


def g_rows(li: dict, appended: list) -> dict:
    """The query columns of the changed source in listing order: the
    original rows of the files not deleted, then the appended files'."""
    keep = np.ones(N_LINEITEM, dtype=bool)
    for f in G_DELETED:
        keep[f * ROWS_PER_FILE:(f + 1) * ROWS_PER_FILE] = False
    return {c: np.concatenate([li[c][keep]] + [a[c] for a in appended])
            for c in G_QUERY_COLUMNS}


def plan_nodes(plan) -> list:
    """The class names of ``plan``'s nodes."""
    return [type(plan).__name__] + [n for c in plan.children
                                    for n in plan_nodes(c)]


def g_queries(phase: str, session, root: str, expected: dict, hybrid: bool,
              timed: int = 0) -> dict:
    """Each query over the changed source through ``li_lin``, checked
    against numpy on an empty device column cache, with the launch counts
    set to 0 just before the checking collect and read just after.
    Without ``hybrid`` the plan must hold no union.  Returns per query
    its Dataset, launches and stats, and with ``timed`` the median wall
    of ``timed`` cold collects (the cache emptied before each) and of
    ``timed`` warm ones, with the stats of the last: the checking collect
    is the first cold one and a checked warm collect the first warm
    one."""
    from hyperspace_tpu_torch.ops import kernels

    session.conf.hybrid_scan_enabled = hybrid
    session.enable_hyperspace()
    out = {}
    for name, ds in build_queries(session, root, "lineitem_mut").items():
        plan = ds.optimized_plan()
        if LINEAGE_INDEX not in [n for n, _ in index_scans(plan)]:
            raise AssertionError(f"{phase} {name}: plan does not scan "
                                 f"{LINEAGE_INDEX}: {index_scans(plan)}")
        if not hybrid and {"Union", "BucketUnion"} & set(plan_nodes(plan)):
            raise AssertionError(f"{phase} {name}: a union without hybrid scan")
        want, keys = expected[name]
        device_cache().clear()
        kernels.reset_launch_counts()
        table, first_ms = timed_collect(ds)
        launches = kernels.launch_counts()
        require_rows(f"{phase} {name}", table, want, keys)
        stats = session.last_execution_stats
        cold, warm = [], []
        if timed:
            cold = [first_ms] + [cold_ms(ds.collect)
                                 for _ in range(timed - 1)]
            table, warm_first = timed_collect(ds)
            require_rows(f"{phase} {name} warm", table, want, keys)
            warm = [warm_first] + [wall_ms(ds.collect)
                                   for _ in range(timed - 1)]
        out[name] = {
            "ds": ds, "launches": launches, "stats": stats,
            "cold_ms": statistics.median(cold) if cold else None,
            "warm_ms": statistics.median(warm) if warm else None,
            "cold_runs_ms": cold, "warm_runs_ms": warm,
            "device_cache_cold": stats.get("device_cache"),
            "warm_stats": session.last_execution_stats if warm else None}
    return out


def phase_g(orders: dict, li: dict, root: str, dev) -> dict:
    """An index over a changing source (see the module docstring)."""
    from hyperspace_tpu_torch import IndexConfig

    t_phase = time.perf_counter()
    steps = {}

    def step(label: str) -> None:
        nonlocal t_phase
        now = time.perf_counter()
        steps[label] = now - t_phase
        t_phase = now

    device_cache().clear()
    mut = os.path.join(root, "lineitem_mut")
    shutil.copytree(os.path.join(root, "lineitem"), mut, copy_function=os.link)
    path = os.path.join(root, "g_indexes")
    hs = spill_session(dev, path)
    session = hs.session
    builds, by_path = [], {}
    rec = timed_build(dev, "G create ord200", hs, lambda: hs.create_index(
        session.read.parquet(os.path.join(root, "orders")),
        IndexConfig(ORDERS_INDEX_200, ["o_orderkey"],
                    ["o_totalprice", "o_custkey", "o_shippriority"])),
        -(-N_ORDERS // DEFAULT_BATCH_ROWS))
    builds.append(rec)
    session.conf.lineage_enabled = True
    rec = timed_build(dev, "G create li_lin (lineage)", hs, lambda: hs.create_index(
        session.read.parquet(mut), IndexConfig(LINEAGE_INDEX, INDEXED, INCLUDED)),
        -(-N_LINEITEM // DEFAULT_BATCH_ROWS))
    builds.append(rec)
    by_path["lineage_create"] = rec["launches"]
    step("create")
    check_index_files("phase G create", hs, LINEAGE_INDEX, "l_orderkey",
                      N_LINEITEM, SPILL_BUCKETS, lineage=True)
    check_index_files("phase G create", hs, ORDERS_INDEX_200, "o_orderkey",
                      N_ORDERS, SPILL_BUCKETS)
    step("check create")

    appended = [g_append(mut, 0, G_APPENDED, 29)]
    for f in G_DELETED:
        os.remove(os.path.join(mut, g_file_name(f)))
    rows = N_LINEITEM + (G_APPENDED - len(G_DELETED)) * ROWS_PER_FILE
    expected = expected_answers(orders, g_rows(li, appended))
    step("mutate")

    rec = timed_build(dev, "G refresh quick", hs,
                      lambda: hs.refresh_index(LINEAGE_INDEX, "quick"), 0)
    summary = rec.pop("outcome")
    if (summary.outcome, summary.appended, summary.deleted) != \
            ("ok", G_APPENDED, len(G_DELETED)):
        raise AssertionError(f"phase G: quick refresh summary {summary}")
    builds.append(rec)
    session.conf.hybrid_scan_enabled = False
    session.enable_hyperspace()
    for name, ds in build_queries(session, root, "lineitem_mut").items():
        if LINEAGE_INDEX in [n for n, _ in index_scans(ds.optimized_plan())]:
            raise AssertionError(f"phase G {name}: a quick-refreshed index is "
                                 f"used without hybrid scan")
    step("quick refresh")

    rows_out = []
    for name, q in g_queries("phase G hybrid", session, root, expected, True,
                             timed=G_TIMED_RUNS).items():
        ds, launches, stats = q["ds"], q["launches"], q["stats"]
        join = name.endswith("join")
        plan = ds.optimized_plan()
        if ("BucketUnion" if join else "Union") not in plan_nodes(plan) \
                or "_data_file_id" not in plan.tree_string():
            raise AssertionError(f"phase G {name}: hybrid plan\n"
                                 f"{plan.tree_string()}")
        want_routes = {"filters": ["device"],
                       "joins": ["bucketed"] if join else [],
                       "join_kernels": ["device"] if join else []}
        if routes(stats) != want_routes or \
                any(not j["hybrid"] for j in stats["joins"]):
            raise AssertionError(f"phase G {name}: strategies {routes(stats)}, "
                                 f"joins {stats['joins']}")
        # One route of the appended rows per hybrid join side.
        require_launches(f"phase G {name} hybrid route", launches,
                         {"hash_buckets": int(join), "bucket_histogram": 0})
        if join:
            by_path["hybrid_route"] = launches
        session.disable_hyperspace()
        want, keys = expected[name]
        # The checking scan is the first timed one (phase D splits and
        # profiles the query shapes; phase G's splits and profiled runs
        # left the time limit to phase MH).
        device_cache().clear()
        table, first_ms = timed_collect(ds)
        require_rows(f"phase G {name} source", table, want, keys)
        scan = [first_ms] + [cold_ms(ds.collect)
                             for _ in range(G_TIMED_RUNS - 1)]
        session.enable_hyperspace()
        scan_ms = statistics.median(scan)
        rows_out.append({
            "name": f"hybrid {name}", "rows": len(next(iter(want.values()))),
            "indexed_cold_ms": q["cold_ms"], "indexed_warm_ms": q["warm_ms"],
            "scan_cold_ms": scan_ms,
            "speedup_cold": scan_ms / q["cold_ms"],
            "speedup_warm": scan_ms / q["warm_ms"],
            "pruned_buckets": [len(b) if b is not None else None
                               for _, b in index_scans(plan)],
            "files_read": sum(s["files_read"] for s in stats["scans"]),
            "hybrid_route_launches": launches,
            "device_cache_cold": q["device_cache_cold"],
            "device_cache_warm": q["warm_stats"].get("device_cache"),
            "indexed_cold_runs_ms": q["cold_runs_ms"],
            "indexed_warm_runs_ms": q["warm_runs_ms"], "scan_cold_runs_ms": scan})
    resident_hybrid = resident_mib()
    step("hybrid queries")

    rec = timed_build(dev, "G refresh incremental", hs,
                      lambda: hs.refresh_index(LINEAGE_INDEX, "incremental"), 1)
    summary = rec.pop("outcome")
    if (summary.outcome, summary.appended, summary.deleted) != \
            ("ok", G_APPENDED, len(G_DELETED)):
        raise AssertionError(f"phase G: incremental refresh summary {summary}")
    builds.append(rec)
    by_path["incremental_refresh"] = rec["launches"]
    check_index_files("phase G incremental", hs, LINEAGE_INDEX, "l_orderkey",
                      rows, SPILL_BUCKETS, lineage=True)
    # The same source through the clean index: what the hybrid merge
    # costs on top of the 200-bucket plan.
    clean = g_queries("phase G incremental", session, root, expected, False,
                      timed=G_TIMED_RUNS)
    for row in rows_out:
        q = clean[row["name"].split()[-1]]
        # The clean index's columns are cached per bucket file set.
        require_warm(f"phase G clean {row['name']}", q["warm_stats"])
        row.update(clean_cold_ms=q["cold_ms"], clean_warm_ms=q["warm_ms"],
                   hybrid_over_clean=row["indexed_cold_ms"] / q["cold_ms"],
                   clean_device_cache_warm=q["warm_stats"]["device_cache"])
    step("incremental")

    appended.append(g_append(mut, G_APPENDED, G_APPENDED_AGAIN, 31))
    rows += G_APPENDED_AGAIN * ROWS_PER_FILE
    expected = expected_answers(orders, g_rows(li, appended))
    rec = timed_build(dev, "G refresh incremental (appended only)", hs,
                      lambda: hs.refresh_index(LINEAGE_INDEX, "incremental"), 1)
    summary = rec.pop("outcome")
    if (summary.outcome, summary.appended, summary.deleted) != \
            ("ok", G_APPENDED_AGAIN, 0):
        raise AssertionError(f"phase G: second incremental summary {summary}")
    builds.append(rec)
    files_by_bucket = check_index_files("phase G appended", hs, LINEAGE_INDEX,
                                        "l_orderkey", rows, SPILL_BUCKETS,
                                        lineage=True)
    two_versions = [b for b, fs in files_by_bucket.items()
                    if len({os.path.dirname(f) for f in fs}) == 2]
    if not two_versions:
        raise AssertionError("phase G: no bucket has files in two versions")
    g_queries("phase G appended", session, root, expected, False)
    step("incremental appended")

    rec = timed_build(dev, "G optimize quick", hs,
                      lambda: hs.optimize_index(LINEAGE_INDEX, "quick"), 0)
    summary = rec.pop("outcome")
    merged = [b for b, fs in files_by_bucket.items() if len(fs) > 1]
    if (summary.outcome, summary.compacted_buckets, summary.written_files) != \
            ("ok", len(merged), len(merged)):
        raise AssertionError(f"phase G: optimize summary {summary}")
    builds.append(rec)
    files_by_bucket = check_index_files("phase G optimize", hs, LINEAGE_INDEX,
                                        "l_orderkey", rows, SPILL_BUCKETS,
                                        lineage=True)
    if any(len(fs) != 1 for fs in files_by_bucket.values()):
        raise AssertionError("phase G: a bucket kept more than one file")
    g_queries("phase G optimize", session, root, expected, False)
    noop = hs.optimize_index(LINEAGE_INDEX, "quick")
    if noop.outcome != "noop" or noop.version is not None:
        raise AssertionError(f"phase G: optimize again: {noop}")
    step("optimize")
    for rec in builds:
        rec.pop("outcome", None)
    shutil.rmtree(path, ignore_errors=True)
    shutil.rmtree(mut, ignore_errors=True)
    resident_end = resident_mib()
    device_cache().clear()
    return {"builds": builds, "queries": rows_out, "launches_by_path": by_path,
            "two_version_buckets": len(two_versions), "rows": rows,
            "steps_s": steps,
            "resident_mib_hybrid": resident_hybrid,
            "resident_mib_end": resident_end}


def bucket_of(keys: np.ndarray, num_buckets: int) -> np.ndarray:
    """The build's bucket of each int64 key (the host mirror)."""
    from hyperspace_tpu_torch.ops.hash import bucket_ids_np

    hw, _ = int64_words(keys)
    return bucket_ids_np([hw], num_buckets)


def flip_byte(path: str) -> None:
    """Flip one byte in the middle of ``path``, keeping its size and
    putting its mtime back: bit rot that only a digest sees."""
    st = os.stat(path)
    with open(path, "r+b") as f:
        f.seek(st.st_size // 2)
        byte = f.read(1)
        f.seek(st.st_size // 2)
        f.write(bytes([byte[0] ^ 0xFF]))
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns))


def bucket_in_branches(plan) -> list:
    """The ``BucketIn`` filters of ``plan`` (quarantine containment)."""
    from hyperspace_tpu_torch.plan.expr import BucketIn

    own = [plan] if type(plan).__name__ == "Filter" \
        and isinstance(plan.condition, BucketIn) else []
    return own + [n for c in plan.children for n in bucket_in_branches(c)]


def verify_statuses(hs, mode: str) -> tuple:
    """(seconds, {file: status}, quarantined files) of one scrub."""
    t0 = time.perf_counter()
    report = hs.verify_index(INTEGRITY_INDEX, mode)
    seconds = time.perf_counter() - t0
    statuses = dict(zip(report.column("file").to_pylist(),
                        report.column("status").to_pylist()))
    quarantined = {f for f, q in zip(report.column("file").to_pylist(),
                                     report.column("quarantined").to_pylist())
                   if q}
    return seconds, statuses, quarantined


def require_flagged(label: str, statuses: dict, want: dict) -> dict:
    """Every file "ok" but those of ``want`` (file -> status)."""
    flagged = {f: s for f, s in statuses.items() if s != "ok"}
    if flagged != want:
        raise AssertionError(f"phase I {label}: flagged {flagged}, "
                             f"expected {want}")
    return {os.path.basename(f): s for f, s in flagged.items()}


def phase_i(orders: dict, li: dict, root: str, dev) -> dict:
    """The integrity loop at SF1 (see the module docstring)."""
    import pyarrow.parquet as pq

    from hyperspace_tpu_torch import (
        Hyperspace,
        HyperspaceSession,
        IndexConfig,
        col,
    )
    from hyperspace_tpu_torch.io import integrity
    from hyperspace_tpu_torch.io.parquet import bucket_id_of_file
    from hyperspace_tpu_torch.ops import filter as device_filter
    from hyperspace_tpu_torch.ops import kernels

    # 1. The indexes: a digest on every file, each bucket's sha256 kept.
    device_cache().clear()
    path = os.path.join(root, "i_indexes")
    hs = spill_session(dev, path, lineage_enabled=True)
    session = hs.session
    mgr = session.index_collection_manager
    source = os.path.join(root, "lineitem")
    t0 = time.perf_counter()
    hs.create_index(session.read.parquet(source),
                    IndexConfig(INTEGRITY_INDEX, INDEXED, INTEGRITY_INCLUDED))
    create_s = time.perf_counter() - t0
    hs.create_index(session.read.parquet(os.path.join(root, "orders")),
                    IndexConfig(INTEGRITY_ORDERS, ["o_orderkey"],
                                ["o_totalprice"]))
    entry = mgr.get_index(INTEGRITY_INDEX)
    infos = entry.content.file_infos()
    if not infos or not all(f.digest for f in infos):
        raise AssertionError("phase I: an index file of the entry has no digest")
    pristine = bucket_digests(hs, INTEGRITY_INDEX)
    file_of = {bucket_id_of_file(f.name): f.name for f in infos}
    if len(file_of) != len(infos):
        raise AssertionError("phase I: a bucket with more than one file")
    lk = li["l_orderkey"]
    key_buckets = bucket_of(lk, SPILL_BUCKETS)
    b = int(bucket_of(np.array([POINT_KEY]), SPILL_BUCKETS)[0])
    c = next(x for x in ((b + 100 + i) % SPILL_BUCKETS
                         for i in range(SPILL_BUCKETS))
             if x in file_of and file_of[x] != infos[0].name)
    flagged = {}

    # 2. Scrubs of the clean index.
    quick_s, statuses, quarantined = verify_statuses(hs, "quick")
    flagged["clean_quick"] = require_flagged("clean quick", statuses, {})
    full_s, statuses, quarantined = verify_statuses(hs, "full")
    flagged["clean_full"] = require_flagged("clean full", statuses, {})
    if quarantined or mgr.quarantine_manager(INTEGRITY_INDEX).paths():
        raise AssertionError(f"phase I: clean scrub quarantined {quarantined}")
    full_mb = sum(f.size for f in infos) / 1e6

    point = (session.read.parquet(source).filter(col("l_orderkey") == POINT_KEY)
             .select("l_orderkey", "l_quantity"))
    rng_q = (session.read.parquet(source)
             .filter((col("l_orderkey") >= RANGE[0])
                     & (col("l_orderkey") < RANGE[1]))
             .select("l_orderkey", "l_extendedprice", "l_discount"))
    join = (session.read.parquet(os.path.join(root, "orders"))
            .join(session.read.parquet(source),
                  col("o_orderkey") == col("l_orderkey"))
            .select("o_orderkey", "o_totalprice", "l_quantity"))
    want_point = ({c_: li[c_][lk == POINT_KEY]
                   for c_ in ("l_orderkey", "l_quantity")}, None)
    in_range = (lk >= RANGE[0]) & (lk < RANGE[1])
    want_range = ({c_: li[c_][in_range] for c_ in
                   ("l_orderkey", "l_extendedprice", "l_discount")},
                  ["l_orderkey", "l_extendedprice"])
    queries = {"point": (point, want_point), "range": (rng_q, want_range)}
    session.enable_hyperspace()
    if sorted(n for n, _ in index_scans(join.optimized_plan())) != \
            sorted([INTEGRITY_INDEX, INTEGRITY_ORDERS]):
        raise AssertionError("phase I: the clean join does not read both "
                             "indexes")
    times = {}
    for name, (ds, (want, keys)) in queries.items():
        require_rows(f"phase I clean {name}", ds.collect(), want, keys)
        clean = [cold_ms(ds.collect) for _ in range(TIMED_QUERY_RUNS)]
        session.disable_hyperspace()
        require_rows(f"phase I scan {name}", ds.collect(), want, keys)
        scan = [cold_ms(ds.collect) for _ in range(TIMED_QUERY_RUNS)]
        session.enable_hyperspace()
        times[name] = {"clean_ms": statistics.median(clean),
                       "scan_ms": statistics.median(scan),
                       "clean_runs_ms": clean, "scan_runs_ms": scan}

    # 3. Bit rot in bucket b's file: only a full scrub sees it.
    flip_byte(file_of[b])
    _, statuses, _ = verify_statuses(hs, "quick")
    flagged["bitrot_quick"] = require_flagged("bit rot quick", statuses, {})
    _, statuses, quarantined = verify_statuses(hs, "full")
    flagged["bitrot_full"] = require_flagged(
        "bit rot full", statuses, {file_of[b]: "digest-mismatch"})
    qm = mgr.quarantine_manager(INTEGRITY_INDEX)
    if quarantined != {file_of[b]} or qm.paths() != {file_of[b]}:
        raise AssertionError(f"phase I: quarantined {qm.paths()}")

    # 4. Containment: bucket b's rows come from the source.
    contained_launches = {}
    for name, (ds, (want, keys)) in queries.items():
        plan = ds.optimized_plan()
        branches = bucket_in_branches(plan)
        if len(branches) != 1 or branches[0].condition.buckets != (b,):
            raise AssertionError(f"phase I {name}: {len(branches)} BucketIn "
                                 f"branches:\n{plan.tree_string()}")
        device_cache().clear()
        kernels.reset_launch_counts()
        require_rows(f"phase I contained {name}", ds.collect(), want, keys)
        contained_launches[name] = kernels.launch_counts()
        stats = session.last_execution_stats
        if [r["strategy"] for r in stats.get("bucket_in", [])] != ["device"] \
                or contained_launches[name]["hash_buckets"] != 1:
            raise AssertionError(
                f"phase I {name}: BucketIn routes {stats.get('bucket_in')}, "
                f"launches {contained_launches[name]}")
        runs = [cold_ms(ds.collect) for _ in range(TIMED_QUERY_RUNS)]
        times[name].update(contained_ms=statistics.median(runs),
                           contained_runs_ms=runs)
    if INTEGRITY_INDEX in [n for n, _ in index_scans(join.optimized_plan())]:
        raise AssertionError("phase I: the join reads the quarantined index")

    # 5. A truncated file found by the query itself.
    with open(file_of[c], "r+b") as f:
        f.truncate(os.path.getsize(file_of[c]) // 2)
    ds, (want, keys) = queries["range"]
    device_cache().clear()
    require_rows("phase I truncated range", ds.collect(), want, keys)
    stats = session.last_execution_stats
    record = stats.get("containment") or {}
    if record.get("replan") != "containment" \
            or record.get("quarantined") != [file_of[c]] \
            or not any(s["is_index"] for s in stats["scans"]) \
            or qm.paths() != {file_of[b], file_of[c]}:
        raise AssertionError(f"phase I: execution containment {record}, "
                             f"quarantine {qm.paths()}")
    flagged["execution"] = {os.path.basename(p): "quarantined"
                            for p in record["quarantined"]}

    # 6. A device fault is not contained.
    def fault(*args, **kwargs):
        raise RuntimeError("phase I injected device fault")

    real = device_filter.compile_predicate
    device_filter.compile_predicate = fault
    try:
        ds.collect()
    except RuntimeError as e:
        if "injected device fault" not in str(e):
            raise
    else:
        raise AssertionError("phase I: the device fault did not propagate")
    finally:
        device_filter.compile_predicate = real
    if qm.paths() != {file_of[b], file_of[c]}:
        raise AssertionError(f"phase I: the device fault changed the "
                             f"quarantine: {qm.paths()}")

    # 7. Repair: buckets b and c from the recorded snapshot.
    device_cache().clear()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    summary = hs.refresh_index(INTEGRITY_INDEX, mode="repair")
    repair_s = time.perf_counter() - t0
    repair_launches = kernels.launch_counts()
    require_launches("phase I repair", repair_launches,
                     {"hash_buckets": 1, "bucket_histogram": 1})
    report = checked_report("phase I repair", hs)
    if summary.outcome != "ok":
        raise AssertionError(f"phase I: repair summary {summary}")
    entry = mgr.get_index(INTEGRITY_INDEX)
    ids = {os.path.basename(f.name): f.id for f in entry.source_file_infos()}
    file_id = np.array([ids[f"part-{i:05d}.parquet"] for i in range(N_FILES)],
                       dtype=np.int64)
    for bucket in (b, c):
        files = sorted(f.name for f in entry.content.file_infos()
                       if bucket_id_of_file(f.name) == bucket)
        got = pq.read_table(files[0], partitioning=None) \
            if len(files) == 1 else None
        if got is None:
            raise AssertionError(f"phase I: bucket {bucket} has {files}")
        rows = np.flatnonzero(key_buckets == bucket)
        rows = rows[np.argsort(lk[rows], kind="stable")]
        want = {c_: li[c_][rows] for c_ in INTEGRITY_COLUMNS}
        want["_data_file_id"] = file_id[rows // ROWS_PER_FILE]
        require_rows(f"phase I repaired bucket {bucket}", got, want)
    repaired = bucket_digests(hs, INTEGRITY_INDEX)
    if repaired != pristine:
        raise AssertionError("phase I: a repaired bucket's sha256 differs "
                             "from the build's")
    _, statuses, quarantined = verify_statuses(hs, "full")
    flagged["repaired_full"] = require_flagged("repaired full", statuses, {})
    if quarantined or qm.paths():
        raise AssertionError(f"phase I: quarantine after repair {qm.paths()}")
    for name, (ds, (want, keys)) in queries.items():
        if bucket_in_branches(ds.optimized_plan()):
            raise AssertionError(f"phase I {name}: BucketIn after repair")
        require_rows(f"phase I repaired {name}", ds.collect(), want, keys)

    # 8. What digest on write costs a build (phase C's shape): builds
    # with it off and on in turns, so neither is always the first.
    walls = {"on": [], "off": []}
    for i, on in enumerate(DIGEST_BUILDS):
        label = "on" if on else "off"
        system_path = os.path.join(root, f"i_digest_{i}")
        s2 = HyperspaceSession(system_path=system_path, device=dev)
        s2.conf.num_buckets = NUM_BUCKETS
        s2.conf.device_batch_rows = 1 << 23
        s2.conf.integrity_digest_on_write = on
        set_min_rows(s2, 0)
        device_cache().clear()
        t0 = time.perf_counter()
        Hyperspace(s2).create_index(s2.read.parquet(source),
                                    IndexConfig(INDEX_NAME, INDEXED, INCLUDED))
        walls[label].append(time.perf_counter() - t0)
        written = s2.index_collection_manager.get_index(INDEX_NAME) \
            .content.file_infos()
        if all(f.digest for f in written) != on or \
                any(f.digest for f in written) != on:
            raise AssertionError(f"phase I: digest on write {label}: "
                                 f"{[f.digest for f in written][:3]}")
        if on:
            t0 = time.perf_counter()
            for f in written:
                if integrity.digest_file(f.name) != f.digest:
                    raise AssertionError(f"phase I: digest of {f.name}")
            serial_digest_s = time.perf_counter() - t0
            written_mb = sum(f.size for f in written) / 1e6
        shutil.rmtree(system_path, ignore_errors=True)
    shutil.rmtree(path, ignore_errors=True)
    session.disable_hyperspace()
    device_cache().clear()
    return {
        "digest_algo": integrity.DEFAULT_ALGO, "create_s": create_s,
        "buckets": {"bitrot": b, "truncated": c},
        "verify_quick_s": quick_s, "verify_full_s": full_s,
        "verify_full_mb": full_mb, "flagged": flagged, "queries": times,
        "contained_launches": contained_launches,
        "repair_wall_s": repair_s, "repair_phases": report["phases_s"],
        "repair_launches": repair_launches, "repair_report": report,
        "digest_on_write_s": {
            "on": walls["on"], "off": walls["off"],
            "difference": statistics.median(walls["on"])
            - statistics.median(walls["off"]),
            "serial_digest_s": serial_digest_s, "mb": written_mb}}


def zorder_words(columns: dict) -> list:
    """The order words of the Z-order index's columns (``io.columnar``)."""
    import pyarrow as pa

    from hyperspace_tpu_torch.io.columnar import to_order_words

    return [to_order_words(pa.array(columns[c])) for c in ZORDER_INDEXED]


def zorder_layout(codes: np.ndarray, order: np.ndarray, price: np.ndarray,
                  max_rows: int) -> dict:
    """The layout that ``codes`` (uint64 per row) and their stable
    ``order`` give: the files' cuts (``zorder_split_chunks``), each cut on
    a cell boundary or at the row cap, and the files whose price range
    meets ZORDER_RANGE (what the sketch keeps)."""
    from hyperspace_tpu_torch.io.parquet import zorder_split_chunks

    sorted_codes = codes[order]
    if np.any(sorted_codes[1:] < sorted_codes[:-1]):
        raise AssertionError("Z-order: the codes' order is not sorted")
    chunks = zorder_split_chunks(sorted_codes, ZORDER_BITS, max_rows)
    level = max(1, min(ZORDER_BITS, int(np.ceil(np.log2(
        -(-len(codes) // max_rows))))))
    cells = sorted_codes >> np.uint64(ZORDER_BITS - level)
    for (off, rows), (nxt, _) in zip(chunks, chunks[1:]):
        if rows != max_rows and cells[off + rows - 1] == cells[nxt]:
            raise AssertionError(f"Z-order: a cut at row {nxt} inside a cell")
    starts = np.array([off for off, _ in chunks])
    p = price[order]
    lo, hi = ZORDER_RANGE
    kept = (np.maximum.reduceat(p, starts) >= lo) \
        & (np.minimum.reduceat(p, starts) < hi)
    return {"chunks": chunks, "files": len(chunks), "kept": int(kept.sum())}


def zorder_index_files(hs, name: str) -> dict:
    """first row id -> (row ids in file order, file path) of the index
    ``name``: one bucket, layout "zorder", every file bucket 0.  A row's
    id is its ``l_shipdate`` (the generators' row number)."""
    import pyarrow.parquet as pq

    from hyperspace_tpu_torch.io.parquet import bucket_id_of_file

    entry = hs.session.index_collection_manager.get_index(name)
    if entry.num_buckets != 1 or \
            entry.derived_dataset.properties.get("layout") != "zorder":
        raise AssertionError(f"{name}: {entry.num_buckets} buckets, layout "
                             f"{entry.derived_dataset.properties}")
    files = {}
    for info in entry.content.file_infos():
        if bucket_id_of_file(info.name) != 0:
            raise AssertionError(f"{name}: {info.name} is not bucket 0")
        ids = pq.read_table(info.name, columns=["l_shipdate"],
                            partitioning=None).column("l_shipdate").to_numpy()
        files[int(ids[0])] = (ids, info.name)
    return files


def check_zorder_files(label: str, hs, name: str, codes: np.ndarray,
                       layout: dict, order, columns: dict) -> int:
    """The index ``name``'s files are the layout's, file for file and row
    for row: each file's rows are one of its cuts of ``order``, with the
    codes non-decreasing, and each row's values are ``columns``' (the
    source's, by row id).  Returns the file count."""
    import pyarrow.parquet as pq

    files = zorder_index_files(hs, name)
    for off, rows in layout["chunks"]:
        want = order[off:off + rows]
        got = files.pop(int(want[0]), (None, None))[0]
        if got is None or not np.array_equal(got, want):
            raise AssertionError(f"{label}: the file of rows {off}.. is not "
                                 f"the layout's")
    if files:
        raise AssertionError(f"{label}: {len(files)} files outside the layout")
    entry = hs.session.index_collection_manager.get_index(name)
    for info in entry.content.file_infos():
        t = pq.read_table(info.name, partitioning=None,
                          columns=[c for c in ZORDER_COLUMNS if c in columns])
        ids = t.column("l_shipdate").to_numpy()
        z = codes[ids]
        if np.any(z[1:] < z[:-1]):
            raise AssertionError(f"{label}: {info.name} is not in Morton order")
        for c in t.column_names:
            if not np.array_equal(t.column(c).to_numpy(), columns[c][ids]):
                raise AssertionError(f"{label}: {info.name} differs in {c}")
    return len(layout["chunks"])


def check_zorder_order(label: str, hs, name: str, codes: np.ndarray,
                       max_rows: int, rows: int) -> int:
    """The index ``name``'s files in Morton order and cell-aligned, by
    ``codes`` of each row id (a layout whose tie order is not the
    source's, as optimize's): within each file the codes are
    non-decreasing, the files do not overlap along the curve, every cut
    is on a cell boundary or at the row cap, and the files hold ``rows``
    rows.  Returns the file count."""
    files = zorder_index_files(hs, name)
    spans = sorted((codes[ids[0]], codes[ids[-1]], len(ids))
                   for ids, _ in files.values())
    for ids, path in files.values():
        z = codes[ids]
        if np.any(z[1:] < z[:-1]):
            raise AssertionError(f"{label}: {path} is not in Morton order")
    level = max(1, min(ZORDER_BITS,
                       int(np.ceil(np.log2(-(-rows // max_rows))))))
    shift = np.uint64(ZORDER_BITS - level)
    for (_, last, n), (first, _, _) in zip(spans, spans[1:]):
        if first < last or (n != max_rows and last >> shift == first >> shift):
            raise AssertionError(f"{label}: files overlap or cut inside a cell")
    if sum(n for _, _, n in spans) != rows:
        raise AssertionError(f"{label}: the files hold "
                             f"{sum(n for _, _, n in spans)} rows, not {rows}")
    return len(spans)


def card_codes(dev, words: list, runs: int = 3) -> tuple:
    """The Z-order pass on the card (``ops.zorder.zorder_sort``) over
    ``words``: ((n,) uint64 codes, (n,) int64 order), both on the host,
    the device ms of the pass on words already there (the median of
    ``runs`` between two CUDA events), and the host ms of one pass with
    the words' upload and the results' download."""
    import torch

    from hyperspace_tpu_torch.ops.zorder import key64_to_codes, zorder_sort

    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    up = [torch.from_numpy(w).to(dev) for w in words]
    key, perm = zorder_sort(up)
    codes, order = key64_to_codes(key), perm.cpu().numpy()
    with_copies_ms = (time.perf_counter() - t0) * 1e3
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        zorder_sort(up)
        end.record()
        torch.cuda.synchronize(dev)
        times.append(start.elapsed_time(end))
    del up, key, perm
    return codes, order, statistics.median(times), with_copies_ms


def zorder_query(session, src: str):
    from hyperspace_tpu_torch import col

    lo, hi = ZORDER_RANGE
    return (session.read.parquet(src)
            .filter((col("l_extendedprice") >= lo)
                    & (col("l_extendedprice") < hi))
            .select(*ZORDER_COLUMNS))


def zorder_want(columns: dict) -> dict:
    lo, hi = ZORDER_RANGE
    price = columns["l_extendedprice"]
    mask = (price >= lo) & (price < hi)
    return {c: columns[c][mask] for c in ZORDER_COLUMNS}


def kept_of(ds, name: str) -> tuple:
    """(files kept, files in all) of the plan's scan of index ``name``."""
    plan = ds.optimized_plan()
    scans = [sc.relation for sc in plan.leaf_relations()
             if sc.relation.index_scan_of == name]
    if len(scans) != 1 or scans[0].data_skipping_stats is None:
        raise AssertionError(f"{name}: plan\n{plan.tree_string()}")
    return tuple(scans[0].data_skipping_stats)


def timed_collects(label: str, ds, want: dict, cold: bool) -> list:
    """TIMED_QUERY_RUNS collects of ``ds`` (cold: the device column cache
    emptied before each, outside the clock), each answer held to
    ``want`` after its clock stopped; their ms."""
    times = []
    for _ in range(TIMED_QUERY_RUNS):
        if cold:
            device_cache().clear()
        t0 = time.perf_counter()
        got = ds.collect()
        times.append((time.perf_counter() - t0) * 1e3)
        require_rows(label, got, want, ["l_shipdate"])
    return times


def timed_zorder_query(label: str, session, src: str, want: dict,
                       layout: dict, name: str = ZORDER_INDEX) -> dict:
    """The second-dimension query with hyperspace on, cold and warm, and
    the scan cold: each answer held to ``want``, the files kept to the
    layout's; with the plan's ms."""
    ds = zorder_query(session, src)
    session.enable_hyperspace()
    t0 = time.perf_counter()
    kept = kept_of(ds, name)
    plan_ms = (time.perf_counter() - t0) * 1e3
    if kept != (layout["kept"], layout["files"]):
        raise AssertionError(f"{label}: kept {kept}, the layout keeps "
                             f"{layout['kept']} of {layout['files']}")
    cold = timed_collects(label, ds, want, cold=True)
    warm = timed_collects(label + " warm", ds, want, cold=False)
    route = route_of(session.last_execution_stats)
    session.disable_hyperspace()
    scan = timed_collects(label + " scan", ds, want, cold=True)
    session.enable_hyperspace()
    device_cache().clear()
    return {"kept": kept[0], "files": kept[1], "rows": len(want["l_shipdate"]),
            "plan_ms": plan_ms, "cold_ms": statistics.median(cold),
            "warm_ms": statistics.median(warm),
            "scan_ms": statistics.median(scan), "route": route,
            "cold_runs_ms": cold,
            "warm_runs_ms": warm, "scan_runs_ms": scan}


def j_append(path: str, count: int) -> dict:
    """``count`` files of ROWS_PER_FILE new rows (``gen_lineitem``,
    ``default_rng(31)``) whose row ids (``l_shipdate``) follow the SF1
    lineitem's; returns their columns."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    rows = ROWS_PER_FILE * count
    new = gen_lineitem(np.random.default_rng(31), rows)
    new["l_shipdate"] = np.arange(N_LINEITEM, N_LINEITEM + rows, dtype=np.int64)
    for i in range(count):
        pq.write_table(pa.table({c: v[i * ROWS_PER_FILE:(i + 1) * ROWS_PER_FILE]
                                 for c, v in new.items()}),
                       os.path.join(path, f"part-{99000 + i:05d}.parquet"))
    return new


def zorder_step(dev, label: str, hs, run, want) -> dict:
    rec = timed_build(dev, label, hs, run, want)
    outcome = rec.pop("outcome")
    if outcome is not None and getattr(outcome, "outcome", "ok") != "ok":
        raise AssertionError(f"{label}: {outcome}")
    return rec


def phase_j(li: dict, root: str, dev) -> dict:
    """The Z-order layout at SF1 (see the module docstring)."""
    from hyperspace_tpu_torch import HyperspaceSession, IndexConfig
    from hyperspace_tpu_torch.ops.zorder import (
        words_to_codes64,
        zorder_order_words_np,
    )

    device_cache().clear()
    src = os.path.join(root, "lineitem")
    max_rows = N_LINEITEM // 64
    columns = {c: li[c] for c in ZORDER_COLUMNS}
    if not np.array_equal(li["l_shipdate"], np.arange(N_LINEITEM)):
        raise AssertionError("phase J: l_shipdate is not the row number")
    if len(np.unique(li["l_extendedprice"])) != N_LINEITEM:
        raise AssertionError("phase J: l_extendedprice has ties; the checks "
                             "of optimize's order need distinct keys")
    out: dict = {"builds": [], "launches_by_path": {}}

    # (a) the codes: the numpy mirror on the host, the card's pass.
    t0 = time.perf_counter()
    words = zorder_words(columns)
    words_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    codes = words_to_codes64(zorder_order_words_np(words))
    order = np.argsort(codes, kind="stable")
    mirror_s = time.perf_counter() - t0
    got_codes, got_order, card_ms, card_copies_ms = card_codes(dev, words)
    if not (np.array_equal(got_codes, codes)
            and np.array_equal(got_order, order)):
        raise AssertionError("phase J: the card's codes or order differ from "
                             "the numpy mirror's")
    del got_codes, got_order
    layout = zorder_layout(codes, order, columns["l_extendedprice"], max_rows)
    out["codes"] = {"rows": N_LINEITEM, "words_s": words_s,
                    "mirror_s": mirror_s, "card_ms": card_ms,
                    "card_with_copies_ms": card_copies_ms,
                    "files": layout["files"], "kept": layout["kept"]}

    # (b) the two builds, each held to the mirror's layout.
    config = IndexConfig(ZORDER_INDEX, ZORDER_INDEXED, ZORDER_INCLUDED,
                         layout="zorder")
    for kind, conf in (("monolithic",
                        {"device_batch_rows": MONOLITHIC_BATCH_ROWS}),
                       ("two-pass", {})):
        label = f"J create {ZORDER_INDEX} {kind}"
        path = os.path.join(root, "j_" + kind)
        hs = spill_session(dev, path, index_max_rows_per_file=max_rows, **conf)
        rec = zorder_step(dev, label, hs, lambda: hs.create_index(
            hs.session.read.parquet(src), config), J_LAUNCHES[kind])
        if ("spill_route_s" in rec["phases"]) != (kind == "two-pass"):
            raise AssertionError(f"{label}: phases {rec['phases']}")
        t0 = time.perf_counter()
        rec["files"] = check_zorder_files(label, hs, ZORDER_INDEX, codes,
                                          layout, order, columns)
        rec["check_s"] = time.perf_counter() - t0
        out["builds"].append(rec)
        out["launches_by_path"][label] = rec["launches"]
        if kind == "monolithic":
            mono_hs = hs
        else:
            shutil.rmtree(path, ignore_errors=True)

    # (c) the second-dimension query through the monolithic build's
    # index: pinned to the card, then at the calibrated defaults; a
    # lexicographic index on the same columns does not apply.
    want = zorder_want(columns)
    hs, session = mono_hs, mono_hs.session
    out["query"] = timed_zorder_query("phase J q_zorder_second_dim", session,
                                      src, want, layout)
    calibrated = HyperspaceSession(system_path=session.conf.system_path,
                                   device=dev)
    calibrated.enable_hyperspace()
    ds = zorder_query(calibrated, src)
    device_cache().clear()
    t0 = time.perf_counter()
    require_rows("phase J calibrated", ds.collect(), want, ["l_shipdate"])
    out["query"]["calibrated_cold_ms"] = (time.perf_counter() - t0) * 1e3
    out["query"]["calibrated_route"] = route_of(calibrated.last_execution_stats)
    if kept_of(ds, ZORDER_INDEX) != (layout["kept"], layout["files"]):
        raise AssertionError("phase J: the calibrated plan keeps other files")
    hs.create_index(session.read.parquet(src),
                    IndexConfig(ZORDER_LEX_INDEX, ZORDER_INDEXED,
                                ZORDER_INCLUDED))
    hs.delete_index(ZORDER_INDEX)
    plan = zorder_query(session, src).optimized_plan()
    if index_scans(plan):
        raise AssertionError(f"phase J: a lexicographic index applied to the "
                             f"price-only predicate:\n{plan.tree_string()}")
    shutil.rmtree(os.path.join(root, "j_monolithic"), ignore_errors=True)

    # (d) maintenance over a copy of the source (hard links).
    copy = os.path.join(root, "lineitem_z")
    shutil.copytree(src, copy, copy_function=os.link)
    path = os.path.join(root, "j_life")
    hs = spill_session(dev, path, index_max_rows_per_file=max_rows,
                       device_batch_rows=MONOLITHIC_BATCH_ROWS)
    session = hs.session
    steps = {}
    rec = zorder_step(dev, "J create copy", hs, lambda: hs.create_index(
        session.read.parquet(copy), config), J_LAUNCHES["monolithic"])
    out["builds"].append(rec)
    new = j_append(copy, J_APPENDED)
    rows = N_LINEITEM + len(new["l_shipdate"])
    union = {c: np.concatenate([columns[c], new[c]]) for c in ZORDER_COLUMNS}
    if len(np.unique(union["l_extendedprice"])) != rows:
        raise AssertionError("phase J: the appended prices add ties")
    union_codes, union_order, _, _ = card_codes(dev, zorder_words(union), 1)
    union_layout = zorder_layout(union_codes, union_order,
                                 union["l_extendedprice"], max_rows)
    union_want = zorder_want(union)
    for step, run, kind in (
            ("J refresh incremental",
             lambda: hs.refresh_index(ZORDER_INDEX, "incremental"), "refresh"),
            ("J optimize quick",
             lambda: hs.optimize_index(ZORDER_INDEX, "quick"), "optimize")):
        rec = zorder_step(dev, step, hs, run, J_LAUNCHES[kind])
        entry = session.index_collection_manager.get_index(ZORDER_INDEX)
        if entry.derived_dataset.properties.get("layout") != "zorder":
            raise AssertionError(
                f"{step}: layout {entry.derived_dataset.properties}")
        if kind == "refresh":
            versions = {os.path.dirname(f.name)
                        for f in entry.content.file_infos()}
            if len(versions) != 2:
                raise AssertionError(f"{step}: versions {sorted(versions)}")
        else:
            rec["files"] = check_zorder_order(step, hs, ZORDER_INDEX,
                                              union_codes, max_rows, rows)
        session.enable_hyperspace()
        device_cache().clear()
        t0 = time.perf_counter()
        require_rows(step, zorder_query(session, copy).collect(), union_want,
                     ["l_shipdate"])
        rec["query_cold_ms"] = (time.perf_counter() - t0) * 1e3
        out["builds"].append(rec)
        out["launches_by_path"][step] = rec["launches"]
    entry = session.index_collection_manager.get_index(ZORDER_INDEX)
    infos = entry.content.file_infos()
    flip_byte(infos[len(infos) // 2].name)
    report = hs.verify_index(ZORDER_INDEX, "full")
    flagged = [s for s in report.column("status").to_pylist() if s != "ok"]
    if flagged != ["digest-mismatch"]:
        raise AssertionError(f"phase J verify: flagged {flagged}")
    rec = zorder_step(dev, "J repair", hs,
                      lambda: hs.refresh_index(ZORDER_INDEX, "repair"),
                      J_LAUNCHES["repair"])
    rec["files"] = check_zorder_files("J repair", hs, ZORDER_INDEX,
                                      union_codes, union_layout, union_order,
                                      union)
    report = hs.verify_index(ZORDER_INDEX, "full")
    if set(report.column("status").to_pylist()) != {"ok"}:
        raise AssertionError("phase J: verify after repair is not clean")
    device_cache().clear()
    require_rows("J repair", zorder_query(session, copy).collect(), union_want,
                 ["l_shipdate"])
    out["builds"].append(rec)
    out["launches_by_path"]["J repair"] = rec["launches"]
    out["union"] = {"rows": rows, "files": union_layout["files"],
                    "kept": union_layout["kept"]}
    shutil.rmtree(path, ignore_errors=True)
    shutil.rmtree(copy, ignore_errors=True)
    device_cache().clear()
    return out


def zorder_sf10(root: str, src: str, dev) -> dict:
    """The SF10 two-pass Z-order build over phase F's source (see the
    module docstring)."""
    import resource

    import torch

    from hyperspace_tpu_torch import IndexConfig, col
    from hyperspace_tpu_torch.io.parquet import read_table
    from hyperspace_tpu_torch.ops.hash import order_key64
    from hyperspace_tpu_torch.ops.zorder import (
        interleave16_np,
        rank_scale,
        stable_ranks,
        zorder_order_words,
    )

    device_cache().clear()
    n = N_LINEITEM_SF10
    max_rows = n // 64
    path = os.path.join(root, "f_zorder")
    hs = spill_session(dev, path, index_max_rows_per_file=max_rows)
    rec = zorder_step(dev, f"F {SF10_Z_INDEX} two-pass", hs,
                      lambda: hs.create_index(
                          hs.session.read.parquet(src),
                          IndexConfig(SF10_Z_INDEX, ZORDER_INDEXED,
                                      ZORDER_INCLUDED, layout="zorder")),
                      J_LAUNCHES["two-pass"])
    rec["peak_rss_mb"] = \
        resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
    if "spill_route_s" not in rec["phases"]:
        raise AssertionError(f"F {SF10_Z_INDEX}: phases {rec['phases']}")

    t0 = time.perf_counter()
    files = sorted(os.path.join(src, f) for f in os.listdir(src))
    table = read_table(files, columns=["l_shipdate", "l_extendedprice"])
    columns = {c: table.column(c).to_numpy() for c in table.column_names}
    del table
    if not np.array_equal(columns["l_shipdate"], np.arange(n)):
        raise AssertionError("phase F: l_shipdate is not the row number")
    words = zorder_words(columns)
    # Pass A's ranks: a permutation, the keys non-decreasing along it and
    # ties in row order.
    up = [torch.from_numpy(w).to(dev) for w in words]
    ranks = []
    for c, w in zip(ZORDER_INDEXED, up):
        rank = stable_ranks(w)
        by_rank = torch.empty_like(rank)
        by_rank[rank] = torch.arange(n, dtype=torch.int64, device=dev)
        if not torch.equal(torch.sort(rank).values,
                           torch.arange(n, dtype=torch.int64, device=dev)):
            raise AssertionError(
                f"phase F: the ranks of {c} are no permutation")
        key = order_key64(w)[by_rank]
        tie = key[1:] == key[:-1]
        if bool((key[1:] < key[:-1]).any()) or \
                bool((tie & (by_rank[1:] < by_rank[:-1])).any()):
            raise AssertionError(f"phase F: the ranks of {c} are not the "
                                 f"stable order")
        ranks.append(rank)
    # The scale and interleave on a seeded sample, against numpy.
    sample = np.sort(np.random.default_rng(41).choice(
        n, n // ZORDER_SAMPLE, replace=False))
    idx = torch.from_numpy(sample).to(dev)
    scaled = [np.clip(r[idx].cpu().numpy().astype(np.float32) * rank_scale(n),
                      0, 65535).astype(np.uint32) for r in ranks]
    hi, lo = interleave16_np(scaled)
    got = zorder_order_words(up)[idx].cpu().numpy()
    if not (np.array_equal(got[:, 0], hi) and np.array_equal(got[:, 1], lo)):
        raise AssertionError("phase F: the card's codes differ from numpy's "
                             "scale and interleave of its ranks")
    del up, ranks, idx
    codes, order, card_ms, card_copies_ms = card_codes(dev, words, 1)
    del words
    layout = zorder_layout(codes, order, columns["l_extendedprice"], max_rows)
    rec["files"] = check_zorder_files(f"F {SF10_Z_INDEX}", hs, SF10_Z_INDEX,
                                      codes, layout, order, columns)
    rec["check_s"] = time.perf_counter() - t0
    rec.update(rows=n, codes_card_ms=card_ms,
               codes_card_with_copies_ms=card_copies_ms,
               sample_rows=len(sample))
    del codes, order
    want = {c: columns[c] for c in columns}
    lo_p, hi_p = ZORDER_RANGE
    mask = (want["l_extendedprice"] >= lo_p) & (want["l_extendedprice"] < hi_p)
    session = hs.session
    session.enable_hyperspace()
    ds = (session.read.parquet(src)
          .filter((col("l_extendedprice") >= lo_p)
                  & (col("l_extendedprice") < hi_p))
          .select("l_shipdate", "l_extendedprice"))
    kept = kept_of(ds, SF10_Z_INDEX)
    if kept != (layout["kept"], layout["files"]):
        raise AssertionError(f"phase F {SF10_Z_INDEX}: kept {kept}, the "
                             f"layout keeps {layout['kept']} of "
                             f"{layout['files']}")
    device_cache().clear()
    t0 = time.perf_counter()
    got = ds.collect()
    rec["query_cold_ms"] = (time.perf_counter() - t0) * 1e3
    require_rows(f"phase F {SF10_Z_INDEX} query", got,
                 {c: v[mask] for c, v in want.items()}, ["l_shipdate"])
    session.disable_hyperspace()
    device_cache().clear()
    t0 = time.perf_counter()
    ds.collect()
    rec["scan_cold_ms"] = (time.perf_counter() - t0) * 1e3
    rec.update(kept=kept[0], query_rows=int(mask.sum()))
    shutil.rmtree(path, ignore_errors=True)
    device_cache().clear()
    return rec


def k_partitions(li: dict, order_key: str, ascending: bool = True) -> list:
    """Per ``l_status`` value (ascending), its rows in the window's order:
    a stable sort by ``order_key`` (ties keep the rows' order)."""
    status = li["l_status"]
    out = []
    for p in np.unique(status):
        rows = np.flatnonzero(status == p)
        key = li[order_key][rows]
        out.append(rows[np.lexsort((key if ascending else -key,))])
    return out


def k_expected(li: dict) -> dict:
    """Phase K's windows answered by numpy, one loop over the four
    partitions each, in the source's row order: (values, valid or None)
    per output column."""
    n = len(li["l_status"])
    price, qty, key = li["l_extendedprice"], li["l_quantity"], li["l_orderkey"]
    out = {c: np.zeros(n, dtype=d) for c, d in (
        ("rs", np.float64), ("trailing7", np.float64), ("whole", np.float64),
        ("rk", np.int32), ("tie_rs", np.float64), ("dr", np.int32),
        ("nt", np.int32), ("lg", np.int64), ("ld", np.int64),
        ("mn", np.float64), ("fv", np.float64), ("cnt", np.int64))}
    lag_valid = np.ones(n, dtype=bool)
    lead_valid = np.ones(n, dtype=bool)
    for rows in k_partitions(li, "l_shipdate"):
        out["rs"][rows] = np.cumsum(price[rows])
        c = np.concatenate([[0.0], np.cumsum(qty[rows])])
        i = np.arange(len(rows))
        out["trailing7"][rows] = c[i + 1] - c[np.maximum(i - 6, 0)]
        out["whole"][rows] = price[rows].sum()
        out["cnt"][rows] = len(rows)
    for rows in k_partitions(li, "l_extendedprice", ascending=False):
        v = price[rows]
        out["rk"][rows] = len(v) - np.searchsorted(np.sort(v), v,
                                                   side="right") + 1
    for rows in k_partitions(li, "l_quantity"):
        q, v, m = qty[rows], price[rows], len(rows)
        change = np.concatenate([[True], q[1:] != q[:-1]])
        group = np.cumsum(change) - 1
        ends = np.concatenate([np.flatnonzero(change)[1:] - 1, [m - 1]])
        out["tie_rs"][rows] = np.cumsum(v)[ends[group]]
        out["dr"][rows] = group + 1
        base, rem = divmod(m, K_NTILE)
        out["nt"][rows] = np.repeat(np.arange(1, K_NTILE + 1),
                                    [base + 1] * rem + [base] * (K_NTILE - rem))
        out["lg"][rows[1:]] = key[rows[:-1]]
        out["ld"][rows[:-1]] = key[rows[1:]]
        lag_valid[rows[0]] = False
        lead_valid[rows[-1]] = False
        padded = np.concatenate([[np.inf] * 2, v, [np.inf] * 2])
        out["mn"][rows] = np.lib.stride_tricks.sliding_window_view(
            padded, 5).min(axis=1)
        out["fv"][rows] = v[0]
    want = {c: (v, None) for c, v in out.items()}
    want["lg"] = (out["lg"], lag_valid)
    want["ld"] = (out["ld"], lead_valid)
    return want


def k_require(label: str, column, want, valid=None, atol: float = 0.0,
              rtol: float = 0.0) -> float:
    """``column`` (arrow) equals ``want`` (numpy) in order: exactly, or
    within ``atol`` absolute or ``rtol`` relative; nulls exactly where
    ``valid`` is False.  Returns the largest absolute difference."""
    import pyarrow as pa

    column = column.combine_chunks() if hasattr(column, "combine_chunks") \
        else column
    got_valid = np.asarray(column.is_valid().to_numpy(zero_copy_only=False))
    if not np.array_equal(got_valid, np.ones(len(want), dtype=bool)
                          if valid is None else valid):
        raise AssertionError(f"phase K {label}: nulls differ from numpy")
    filled = column.fill_null(pa.scalar(0, type=column.type))
    got = np.asarray(filled.to_numpy(zero_copy_only=False))
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"phase K {label}: {got.shape} {got.dtype}, "
                             f"expected {want.shape} {want.dtype}")
    keep = got_valid
    diff = np.abs(got[keep].astype(np.float64) - want[keep].astype(np.float64))
    err = float(diff.max()) if diff.size else 0.0
    if atol or rtol:
        bound = atol + rtol * np.abs(want[keep].astype(np.float64))
        ok = bool(np.all(diff <= bound))
    else:
        ok = np.array_equal(got[keep], want[keep])
    if not ok:
        raise AssertionError(f"phase K {label}: differs from numpy (max "
                             f"abs diff {err!r}, atol {atol!r}, rtol {rtol!r})")
    return err


def k_timed(fn, runs: int = K_RUNS) -> tuple:
    """(first result, ms of each run) of ``runs`` calls of ``fn``."""
    first, times = None, []
    for _ in range(runs):
        t0 = time.perf_counter()
        got = fn()
        times.append((time.perf_counter() - t0) * 1e3)
        first = got if first is None else first
    return first, times


def k_sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def k_segment_functions(li: dict, dev, prefix_atol: float) -> dict:
    """ops.window's frame_sum, frame_min_max (prefix scan and sparse
    table) and rank_from_ties on the card against the same functions on
    CPU tensors, over step 1's and step 3's sorted layouts; both timed
    (the card's second call, inputs already there, synchronised)."""
    import torch

    from hyperspace_tpu_torch.ops import window as W

    status, price = li["l_status"], li["l_extendedprice"]
    layouts = {}
    for name, key in (("shipdate", "l_shipdate"), ("quantity", "l_quantity")):
        order = np.lexsort((li[key], status))
        s, k = status[order], li[key][order]
        new_part = np.concatenate([[True], s[1:] != s[:-1]])
        new_tie = new_part | np.concatenate([[True], k[1:] != k[:-1]])
        layouts[name] = (torch.from_numpy(new_part), torch.from_numpy(new_tie),
                         torch.from_numpy(price[order].copy()))

    def calls(where):
        out = {}
        (p1, t1, v1), (p3, t3, v3) = [
            tuple(x.to(where) for x in layouts[k])
            for k in ("shipdate", "quantity")]
        valid = torch.ones(v1.shape[0], dtype=torch.bool, device=where)

        def run_sum():
            ps, _ = W.segment_bounds(p1)
            _, te = W.segment_bounds(t1)
            return W.frame_sum(v1, valid, ps, te)[0]

        def run_min(frame):
            def f():
                ps, pe = W.segment_bounds(p3)
                _, te = W.segment_bounds(t3)
                lo, hi = W.frame_bounds(ps, pe, te, frame, True)
                return W.frame_min_max(v3, valid, lo, hi, ps, pe, frame,
                                       is_min=True)[0]
            return f

        def rank():
            ps, _ = W.segment_bounds(p3)
            return W.rank_from_ties(ps, t3)

        for label, fn in (("frame_sum", run_sum),
                          ("frame_min_max_scan", run_min((None, 0))),
                          ("frame_min_max_sparse", run_min((-2, 2))),
                          ("rank_from_ties", rank)):
            ms = []
            # The card's first call warms it up; the CPU's needs none.
            for _ in range(2 if where.type == "cuda" else 1):
                k_sync(dev)
                t0 = time.perf_counter()
                got = fn()
                k_sync(dev)
                ms.append((time.perf_counter() - t0) * 1e3)
            out[label] = (got.cpu(), ms[-1])
        return out

    host = calls(torch.device("cpu"))
    card = calls(dev)
    result = {}
    for label, (want, host_ms) in host.items():
        got, card_ms = card[label]
        if want.is_floating_point():
            err = float((got - want).abs().max())
            ok = err <= prefix_atol
        else:
            err = float((got - want).abs().max()) if got.numel() else 0.0
            ok = torch.equal(got, want)
        if not ok:
            raise AssertionError(f"phase K {label}: the card differs from the "
                                 f"CPU ({err!r}, bound {prefix_atol!r})")
        result[label] = {"cpu_ms": host_ms, "card_ms": card_ms,
                         "max_abs_err": err}
    return result


def phase_k(li: dict, root: str, dev) -> dict:
    """The analytic operators at SF1 (see the module docstring)."""
    from hyperspace_tpu_torch import HyperspaceSession, col
    from hyperspace_tpu_torch.ops import kernels

    t_phase = time.perf_counter()
    device_cache().clear()
    kernels.reset_launch_counts()
    src = os.path.join(root, "lineitem")
    n = len(li["l_status"])
    want = k_expected(li)
    prefix_atol = K_PREFIX_RTOL * float(np.abs(li["l_extendedprice"]).sum())
    out: dict = {"rows": n, "prefix_atol": prefix_atol}

    # (1) bench.py's _sec_window shapes on the host route.
    session = HyperspaceSession(system_path=os.path.join(root, "indexes"),
                                device=dev)
    session.conf.device_cache_policy = "off"
    session.conf.device_agg_min_rows = HOST_ROUTE_MIN_ROWS
    li_ds = session.read.parquet(src)
    shapes = {
        "running_sum": (li_ds.select("l_status", "l_shipdate",
                                     "l_extendedprice")
                        .with_window("rs", "sum", partition_by=["l_status"],
                                     order_by=["l_shipdate"],
                                     value="l_extendedprice"),
                        "rs", prefix_atol),
        "rank": (li_ds.select("l_status", "l_extendedprice")
                 .with_window("rk", "rank", partition_by=["l_status"],
                              order_by=[("l_extendedprice", False)]),
                 "rk", 0.0),
        "trailing7_frame": (li_ds.select("l_status", "l_shipdate",
                                         "l_quantity")
                            .with_window("trailing7", "sum",
                                         partition_by=["l_status"],
                                         order_by=["l_shipdate"],
                                         value="l_quantity", frame=(-6, 0)),
                            "trailing7", 0.0),
        "whole_partition_sum": (li_ds.with_window(
            "whole", "sum", partition_by=["l_status"],
            value="l_extendedprice").select("l_status", "whole"),
            "whole", prefix_atol),
    }
    out["shapes"] = {}
    for name, (ds, column, atol) in shapes.items():
        got, times = k_timed(ds.collect)
        if session.last_execution_stats.get("windows"):
            raise AssertionError(f"phase K {name}: left the host route")
        err = k_require(name, got.column(column), want[column][0], atol=atol)
        med = statistics.median(times)
        out["shapes"][name] = {"median_ms": med, "runs_ms": times,
                               "mrows_per_s": n / med / 1e3,
                               "max_abs_err": err}

    # (2) the device route: calibrated thresholds, the eager policy.
    cal = HyperspaceSession(system_path=os.path.join(root, "indexes"),
                            device=dev)
    cal.conf.device_cache_policy = "eager"
    for field in ("filter", "join", "agg", "build", "resident"):
        if getattr(cal.conf, f"device_{field}_min_rows") is not None:
            raise AssertionError(f"phase K: device_{field}_min_rows is set")
    def chained(ds):
        return (ds.with_window("whole", "sum", partition_by=["l_status"],
                               value="l_extendedprice")
                .with_window("cnt", "count", partition_by=["l_status"])
                .select("l_status", "whole", "cnt"))

    whole = chained(cal.read.parquet(src))

    def windows_of(label, stats, resident):
        entries = stats.get("windows") or []
        if len(entries) != 2 or any(
                w["strategy"] != "device-segment" or w["groups"] != 4
                or (resident is not None and w["resident"] is not resident)
                for w in entries):
            raise AssertionError(f"phase K {label}: windows {entries}")
        return entries

    device_cache().clear()
    t0 = time.perf_counter()
    cold = whole.collect()
    cold_ms = (time.perf_counter() - t0) * 1e3
    windows_of("cold", cal.last_execution_stats, None)
    warm = whole.collect()
    entries = windows_of("warm", cal.last_execution_stats, True)
    _, warm_times = k_timed(whole.collect)
    windows_of("timed warm", cal.last_execution_stats, True)
    host, host_times = k_timed(chained(li_ds).collect)
    if session.last_execution_stats.get("windows"):
        raise AssertionError("phase K: the chained host route left the host")
    k_require("host chained count", host.column("cnt"), want["cnt"][0])
    for label, got in (("cold", cold), ("warm", warm)):
        k_require(f"device {label} whole", got.column("whole"),
                  host.column("whole").to_numpy(), rtol=AGG_RTOL)
        k_require(f"device {label} whole (numpy)", got.column("whole"),
                  want["whole"][0], rtol=AGG_RTOL)
        k_require(f"device {label} count", got.column("cnt"), want["cnt"][0])
    host_ms = statistics.median(host_times)
    warm_ms = statistics.median(warm_times)
    out["device_route"] = {
        "cold_ms": cold_ms, "warm_ms": warm_ms, "warm_runs_ms": warm_times,
        "host_ms": host_ms, "host_runs_ms": host_times,
        "host_over_device": host_ms / warm_ms,
        "windows": entries,
        "agg_threshold": cal.conf.device_min_rows("agg", dev),
        "resident_threshold": cal.conf.resident_min_rows("agg", dev)}
    device_cache().clear()

    # (3) tie-heavy windows: ordered by l_quantity, 49 distinct values.
    over = dict(partition_by=["l_status"], order_by=["l_quantity"])
    ties = (li_ds.select("l_status", "l_quantity", "l_extendedprice",
                         "l_orderkey")
            .with_window("tie_rs", "sum", value="l_extendedprice", **over)
            .with_window("dr", "dense_rank", **over)
            .with_window("nt", "ntile", offset=K_NTILE, **over)
            .with_window("lg", "lag", value="l_orderkey", **over)
            .with_window("ld", "lead", value="l_orderkey", **over)
            .with_window("mn", "min", value="l_extendedprice", frame=(-2, 2),
                         **over)
            .with_window("fv", "first_value", value="l_extendedprice",
                         **over))
    t0 = time.perf_counter()
    got = ties.collect()
    ties_ms = (time.perf_counter() - t0) * 1e3
    errs = {}
    for c in ("tie_rs", "dr", "nt", "lg", "ld", "mn", "fv"):
        values, valid = want[c]
        errs[c] = k_require(f"ties {c}", got.column(c), values, valid,
                            atol=prefix_atol if c == "tie_rs" else 0.0)
    out["ties"] = {"wall_ms": ties_ms, "windows": 7, "max_abs_err": errs}

    # (4) through the index: a key range, a rank, a computed select.
    session.enable_hyperspace()
    set_min_rows(session, 0)
    lo, hi = K_RANGE
    indexed = (li_ds.filter((col("l_orderkey") >= lo) & (col("l_orderkey") < hi))
               .with_window("rk", "rank", partition_by=["l_quantity"],
                            order_by=[("l_extendedprice", False)])
               .select("l_shipdate", "l_orderkey", "rk",
                       revenue=col("l_extendedprice") * (1 - col("l_discount"))))
    names = sorted(name for name, _ in index_scans(indexed.optimized_plan()))
    if names != [INDEX_NAME]:
        raise AssertionError(f"phase K indexed: the plan scans {names}")
    got, times = k_timed(indexed.collect)
    sel = np.flatnonzero((li["l_orderkey"] >= lo) & (li["l_orderkey"] < hi))
    rank = np.zeros(len(sel), dtype=np.int32)
    q, p = li["l_quantity"][sel], li["l_extendedprice"][sel]
    for value in np.unique(q):
        part = np.flatnonzero(q == value)
        rank[part] = len(part) - np.searchsorted(np.sort(p[part]), p[part],
                                                 side="right") + 1
    require_rows("phase K indexed", got, {
        "l_shipdate": li["l_shipdate"][sel], "l_orderkey": li["l_orderkey"][sel],
        "rk": rank,
        "revenue": p * (1 - li["l_discount"][sel])}, ["l_shipdate"])
    out["indexed"] = {"rows": int(len(sel)), "runs_ms": times,
                      "median_ms": statistics.median(times), "plan": names}

    # (5) DISTINCT and the set operations.
    t0 = time.perf_counter()
    got = li_ds.select("l_status", "l_quantity").distinct().collect()
    distinct_ms = (time.perf_counter() - t0) * 1e3
    # l_quantity holds the integers 1..49: one int64 code per pair.
    pairs = np.unique(li["l_status"] * 64 + li["l_quantity"].astype(np.int64))
    if len(pairs) != K_DISTINCT_ROWS:
        raise AssertionError(f"phase K: {len(pairs)} distinct pairs")
    require_rows("phase K distinct", got,
                 {"l_status": pairs // 64,
                  "l_quantity": (pairs % 64).astype(np.float64)},
                 ["l_status", "l_quantity"])

    def key_range(bounds):
        return li_ds.filter((col("l_orderkey") >= bounds[0])
                            & (col("l_orderkey") < bounds[1])) \
            .select("l_orderkey")

    left = key_range(K_SET_A).collect().column("l_orderkey").to_numpy()
    mask_b = (li["l_orderkey"] >= K_SET_B[0]) & (li["l_orderkey"] < K_SET_B[1])
    in_b = np.isin(left, li["l_orderkey"][mask_b])
    _, first = np.unique(left, return_index=True)
    setops = {"distinct_rows": int(got.num_rows), "distinct_ms": distinct_ms}
    for kind, keep in (("intersect", in_b[first]), ("subtract", ~in_b[first])):
        ds = getattr(key_range(K_SET_A), kind)(key_range(K_SET_B))
        names = sorted(name for name, _ in index_scans(ds.optimized_plan()))
        if names != [INDEX_NAME, INDEX_NAME]:
            raise AssertionError(f"phase K {kind}: the plan scans {names}")
        t0 = time.perf_counter()
        got = ds.collect()
        setops[f"{kind}_ms"] = (time.perf_counter() - t0) * 1e3
        setops[f"{kind}_rows"] = int(got.num_rows)
        require_rows(f"phase K {kind}", got,
                     {"l_orderkey": left[np.sort(first[keep])]})
    k1, k2 = K_UNION_KEYS
    part1 = li_ds.filter(col("l_orderkey") == k1).select("l_orderkey",
                                                         "l_quantity")
    part2 = li_ds.filter(col("l_orderkey") == k2).select("l_orderkey")
    got = part1.union(part2).collect()
    a, b = part1.collect(), part2.collect()
    na, nb = int((li["l_orderkey"] == k1).sum()), int((li["l_orderkey"] == k2).sum())
    if (a.num_rows, b.num_rows) != (na, nb) or got.num_rows != na + nb \
            or got.column_names != ["l_orderkey", "l_quantity"] \
            or got.column("l_orderkey").to_pylist() \
            != a.column("l_orderkey").to_pylist() + b.column("l_orderkey").to_pylist() \
            or got.column("l_quantity").to_pylist() \
            != a.column("l_quantity").to_pylist() + [None] * nb:
        raise AssertionError("phase K union: not the two selects by name")
    setops["union_rows"] = int(got.num_rows)
    out["setops"] = setops

    out["launches"] = kernels.launch_counts()
    if any(out["launches"].values()):
        raise AssertionError(f"phase K launched {out['launches']}: no kernel "
                             f"is on the analytic operators' path")
    # (6) the segment functions on the card, measured only.
    out["segment_functions"] = k_segment_functions(li, dev, prefix_atol)
    out["wall_s"] = time.perf_counter() - t_phase
    return out


def l_gen() -> tuple:
    """TPC-H-shaped orders and lineitem at L_ORDERS and L_LINEITEM rows
    from ``default_rng(L_SEED)``, TPC-H's names and value domains: keys
    ascend with the order date, so the dates rise with file order as an
    appending lake writes them.  Strings are dictionary codes here (the
    numpy oracle reads the codes); ``l_arrow`` decodes them."""
    rng = np.random.default_rng(L_SEED)
    span = L_LAST_DAY - L_FIRST_DAY + 1
    o_date = L_FIRST_DAY + np.arange(L_ORDERS, dtype=np.int64) * span // L_ORDERS
    phrases = []
    for _ in range(L_PHRASES):
        words = rng.choice(L_WORDS, size=int(rng.integers(2, 7)))
        phrases.append(" ".join(words))
    orders = {
        "o_orderkey": np.arange(L_ORDERS, dtype=np.int64),
        "o_custkey": rng.integers(0, L_CUSTOMERS, L_ORDERS),
        "o_totalprice": rng.random(L_ORDERS) * 1e5,
        "o_orderdate": o_date,
        "o_orderpriority": rng.integers(0, len(L_PRIORITIES), L_ORDERS),
        "o_comment": rng.integers(0, L_PHRASES, L_ORDERS),
        "o_comment_valid": rng.random(L_ORDERS) >= L_COMMENT_NULLS,
    }
    key = np.sort(rng.integers(0, L_ORDERS, L_LINEITEM))
    ship = o_date[key] + rng.integers(1, 122, L_LINEITEM)
    li = {
        "l_orderkey": key,
        "l_suppkey": rng.integers(0, L_SUPPLIERS, L_LINEITEM),
        "l_quantity": rng.integers(1, 51, L_LINEITEM).astype(np.float64),
        "l_extendedprice": rng.random(L_LINEITEM) * 1e4,
        "l_discount": rng.integers(0, 11, L_LINEITEM) / 100.0,
        "l_shipdate": ship,
        "l_commitdate": o_date[key] + rng.integers(30, 91, L_LINEITEM),
        "l_receiptdate": ship + rng.integers(1, 31, L_LINEITEM),
        "l_shipmode": rng.integers(0, len(L_SHIPMODES), L_LINEITEM),
    }
    return orders, li, phrases


def l_arrow(orders: dict, li: dict, phrases: list) -> tuple:
    """The two tables as arrow columns: dates as date32, the string
    codes decoded (a null comment where ``o_comment_valid`` is false)."""
    import pyarrow as pa

    def strings(codes, values, valid=None):
        mask = None if valid is None else ~valid
        return pa.DictionaryArray.from_arrays(
            pa.array(codes.astype(np.int32), mask=mask),
            pa.array(list(values))).dictionary_decode()

    def dates(days):
        return pa.array(days.astype("datetime64[D]"))

    o = {"o_orderkey": orders["o_orderkey"], "o_custkey": orders["o_custkey"],
         "o_totalprice": orders["o_totalprice"],
         "o_orderdate": dates(orders["o_orderdate"]),
         "o_orderpriority": strings(orders["o_orderpriority"], L_PRIORITIES),
         "o_comment": strings(orders["o_comment"], phrases,
                              orders["o_comment_valid"])}
    line = {c: (dates(v) if c.endswith("date") else v)
            for c, v in li.items() if c != "l_shipmode"}
    line["l_shipmode"] = strings(li["l_shipmode"], L_SHIPMODES)
    return o, line


def l_year_days(year: int) -> tuple:
    import datetime

    epoch = datetime.date(1970, 1, 1)
    return ((datetime.date(year, 1, 1) - epoch).days,
            (datetime.date(year + 1, 1, 1) - epoch).days)


def l_files_meeting(days: np.ndarray, ranges) -> int:
    """How many of write_files' N_FILES files hold a date range that
    meets one of ``ranges`` ([lo, hi) in days)."""
    step = -(-len(days) // N_FILES)
    kept = 0
    for f in range(N_FILES):
        part = days[f * step:(f + 1) * step]
        if len(part) and any(part.max() >= lo and part.min() < hi
                             for lo, hi in ranges):
            kept += 1
    return kept


def l_expected(orders: dict, li: dict, phrases: list) -> dict:
    """Each query's answer (column -> numpy array) from the generated
    arrays, and the files a year range keeps."""
    import re

    out = {}
    ship = li["l_shipdate"]
    price = li["l_extendedprice"]

    def total(mask, name="revenue"):
        return {"n": np.array([int(mask.sum())], dtype=np.int64),
                name: np.array([price[mask].sum()])}

    y95 = l_year_days(1995)
    out["year_1995"] = total((ship >= y95[0]) & (ship < y95[1]))
    out["year_1995_files"] = l_files_meeting(ship, [y95])
    both = [l_year_days(1994), l_year_days(1996)]
    out["year_isin"] = total(((ship >= both[0][0]) & (ship < both[0][1]))
                             | ((ship >= both[1][0]) & (ship < both[1][1])))
    # The sketches prune an OR of ranges by its covering interval.
    out["year_isin_files"] = l_files_meeting(ship, [(both[0][0], both[1][1])])
    months = ship.astype("datetime64[D]").astype("datetime64[M]").astype(np.int64) % 12
    out["month_3"] = total(months == 2)

    # q12: MAIL and SHIP, received in 1994, high and low priority lines.
    y94 = l_year_days(1994)
    modes = [L_SHIPMODES.index("MAIL"), L_SHIPMODES.index("SHIP")]
    mask = (np.isin(li["l_shipmode"], modes)
            & (li["l_commitdate"] < li["l_receiptdate"])
            & (li["l_shipdate"] < li["l_commitdate"])
            & (li["l_receiptdate"] >= y94[0]) & (li["l_receiptdate"] < y94[1]))
    pri = orders["o_orderpriority"][li["l_orderkey"][mask]]
    mode = li["l_shipmode"][mask]
    order = sorted(modes, key=lambda m: L_SHIPMODES[m])
    out["q12"] = {
        "l_shipmode": np.array([L_SHIPMODES[m] for m in order], dtype=object),
        "high_line_count": np.array([int(((mode == m) & (pri <= 1)).sum())
                                     for m in order], dtype=np.int64),
        "low_line_count": np.array([int(((mode == m) & (pri > 1)).sum())
                                    for m in order], dtype=np.int64)}

    # q13's orders side: NOT LIKE '%special%requests%' (a null drops).
    like = np.array([re.search("special.*requests", p) is not None
                     for p in phrases])
    keep = orders["o_comment_valid"] & ~like[orders["o_comment"]]
    per_cust = np.bincount(orders["o_custkey"][keep], minlength=L_CUSTOMERS)
    counts = per_cust[per_cust > 0]
    dist = np.bincount(counts)
    c_count = np.flatnonzero(dist)
    order = np.lexsort((-c_count, -dist[c_count]))
    out["q13_orders"] = {"c_count": c_count[order].astype(np.int64),
                         "custdist": dist[c_count][order].astype(np.int64)}

    # strings.
    pri_all = orders["o_orderpriority"]
    names = sorted(range(len(L_PRIORITIES)), key=lambda i: L_PRIORITIES[i])
    out["strings_digit_sum"] = {
        "o_orderpriority": np.array([L_PRIORITIES[i] for i in names],
                                    dtype=object),
        "digit": np.array([int((pri_all == i).sum()) * int(L_PRIORITIES[i][0])
                           for i in names], dtype=np.int64)}
    lo, hi = L_STRING_KEYS
    sel = np.arange(lo, hi)
    text = [L_PRIORITIES[i] for i in pri_all[sel]]
    out["strings_functions"] = {
        "o_orderkey": orders["o_orderkey"][sel],
        "u": np.array([t.upper() for t in text], dtype=object),
        "lo": np.array([t.lower() for t in text], dtype=object),
        "n": np.array([len(t) for t in text], dtype=np.int32),
        "t": np.array([t.strip() for t in text], dtype=object),
        "c": np.array([f"{t}-{c}" for t, c in
                       zip(text, orders["o_custkey"][sel])], dtype=object)}
    codes = np.bincount(li["l_shipmode"], minlength=len(L_SHIPMODES))
    out["strings_matches"] = {
        label: np.array([sum(int(codes[i]) for i, m in enumerate(L_SHIPMODES)
                             if test(m))], dtype=np.int64)
        for label, test in (("startswith", lambda m: m.startswith("R")),
                            ("endswith", lambda m: m.endswith("AIR")),
                            ("contains", lambda m: "AI" in m))}

    # q4: orders of 1993 Q3 with a late line, per priority.
    late = li["l_commitdate"] < li["l_receiptdate"]
    q_lo, q_hi = L_Q4_QUARTER
    in_q = (orders["o_orderdate"] >= q_lo) & (orders["o_orderdate"] < q_hi)
    has = in_q & np.isin(orders["o_orderkey"], li["l_orderkey"][late])
    out["q4"] = {
        "o_orderpriority": np.array([L_PRIORITIES[i] for i in names],
                                    dtype=object),
        "order_count": np.array([int((has & (pri_all == i)).sum())
                                 for i in names], dtype=np.int64)}
    out["q4"] = {c: v[out["q4"]["order_count"] > 0]
                 for c, v in out["q4"].items()}

    # q17's shape: quantity under 0.2 of its supplier's mean.
    supp = li["l_suppkey"]
    sums = np.bincount(supp, weights=li["l_quantity"], minlength=L_SUPPLIERS)
    cnt = np.bincount(supp, minlength=L_SUPPLIERS)
    mean = sums / np.maximum(cnt, 1)
    mask = li["l_quantity"] < 0.2 * mean[supp]
    out["q17_shape"] = {"avg_yearly": np.array([price[mask].sum() / 7.0])}

    # q22's scalar: orders above the mean price.
    tp = orders["o_totalprice"]
    m = tp > tp.mean()
    out["q22_scalar"] = {"n": np.array([int(m.sum())], dtype=np.int64),
                         "total": np.array([tp[m].sum()])}

    # IN and NOT IN over the orders under PRICE_BELOW.
    cheap = orders["o_orderkey"][tp < PRICE_BELOW]
    hit = np.isin(li["l_orderkey"], cheap)
    out["in"] = total(hit)
    out["not_in"] = total(~hit)
    out["not_in_null"] = {"n": np.array([0], dtype=np.int64)}
    lo, hi = L_NULL_KEYS
    if not (tp[lo:hi] >= PRICE_BELOW).any():
        raise AssertionError("phase L: the NOT IN key range makes no null")

    # q21's shape: late lines of one month's orders whose order has
    # another supplier, none of them late.
    m_lo, m_hi = L_Q21_MONTH
    k0, k1 = np.searchsorted(orders["o_orderdate"], [m_lo, m_hi])
    rows = np.flatnonzero((li["l_orderkey"] >= k0) & (li["l_orderkey"] < k1))
    ok, sk, lt = li["l_orderkey"][rows], supp[rows], late[rows]
    # late here is l_receiptdate > l_commitdate, as the query writes it.
    pair = ok * (L_SUPPLIERS + 1) + sk
    _, pair_ix, pair_n = np.unique(pair, return_inverse=True, return_counts=True)
    _, ord_ix, ord_n = np.unique(ok, return_inverse=True, return_counts=True)
    late_pair = np.bincount(pair_ix, weights=lt, minlength=len(pair_n))
    late_ord = np.bincount(ord_ix, weights=lt, minlength=len(ord_n))
    other = ord_n[ord_ix] - pair_n[pair_ix] > 0
    other_late = late_ord[ord_ix] - late_pair[pair_ix] > 0
    hit = lt & other & ~other_late
    per = np.bincount(sk[hit], minlength=L_SUPPLIERS)
    present = np.flatnonzero(per)
    order = present[np.lexsort((present, -per[present]))][:100]
    out["q21_shape"] = {"l_suppkey": order.astype(np.int64),
                        "numwait": per[order].astype(np.int64)}
    out["q21_keys"] = (int(k0), int(k1))
    return out


def l_queries(session, root: str, keys21: tuple, pkg=None) -> dict:
    """Phase L's queries as Datasets of ``session``: name -> (Dataset,
    the sort keys to compare its rows by, or None for its own order).
    ``pkg`` is the package whose DSL builds them (the port's by default;
    a CPU test passes the reference package to compare plans there)."""
    import datetime

    if pkg is None:
        import hyperspace_tpu_torch as pkg
    col, concat, exists, in_subquery = pkg.col, pkg.concat, pkg.exists, \
        pkg.in_subquery
    length, lit, lower, month, outer_ref = pkg.length, pkg.lit, pkg.lower, \
        pkg.month, pkg.outer_ref
    scalar, substring, trim, upper, when, year = pkg.scalar, pkg.substring, \
        pkg.trim, pkg.upper, pkg.when, pkg.year

    li = lambda: session.read.parquet(os.path.join(root, "l_lineitem"))  # noqa: E731
    orders = lambda: session.read.parquet(os.path.join(root, "l_orders"))  # noqa: E731
    epoch = datetime.date(1970, 1, 1)

    def day(n):
        return epoch + datetime.timedelta(days=n)

    def totals(ds, name="revenue"):
        return ds.agg(n=("l_extendedprice", "count_all"),
                      **{name: ("l_extendedprice", "sum")})

    urgent = col("o_orderpriority").isin(["1-URGENT", "2-HIGH"])
    cheap = orders().filter(col("o_totalprice") < PRICE_BELOW).select("o_orderkey")
    lo, hi = L_NULL_KEYS
    with_null = orders().filter((col("o_orderkey") >= lo) & (col("o_orderkey") < hi)) \
        .select(k=when(col("o_totalprice") < PRICE_BELOW, col("o_orderkey")).end())
    k0, k1 = keys21
    late = col("l_receiptdate") > col("l_commitdate")
    same_order = col("l_orderkey") == outer_ref("l_orderkey")
    other_supp = col("l_suppkey") != outer_ref("l_suppkey")
    s_lo, s_hi = L_STRING_KEYS
    q_lo, q_hi = L_Q4_QUARTER
    return {
        "year_1995": (totals(li().filter(year("l_shipdate") == 1995)), None),
        "year_isin": (totals(li().filter(year("l_shipdate").isin([1994, 1996]))),
                      None),
        "month_3": (totals(li().filter(month("l_shipdate") == 3)), None),
        "q12": (li().filter(col("l_shipmode").isin(["MAIL", "SHIP"])
                            & (col("l_commitdate") < col("l_receiptdate"))
                            & (col("l_shipdate") < col("l_commitdate"))
                            & (year("l_receiptdate") == 1994))
                .join(orders(), col("l_orderkey") == col("o_orderkey"))
                .group_by("l_shipmode")
                .agg(high_line_count=(when(urgent, 1).otherwise(0), "sum"),
                     low_line_count=(when(~urgent, 1).otherwise(0), "sum"))
                .sort("l_shipmode"), None),
        "q13_orders": (orders().filter(~col("o_comment").like("%special%requests%"))
                       .group_by("o_custkey").agg(c_count=("o_orderkey", "count"))
                       .group_by("c_count").agg(custdist=("o_custkey", "count_all"))
                       .sort(("custdist", False), ("c_count", False)), None),
        "strings_digit_sum": (orders().group_by("o_orderpriority").agg(
            digit=(substring("o_orderpriority", 1, 1).cast("int"), "sum"))
            .sort("o_orderpriority"), None),
        "strings_functions": (orders().filter((col("o_orderkey") >= s_lo)
                                              & (col("o_orderkey") < s_hi))
                              .select("o_orderkey", u=upper("o_orderpriority"),
                                      lo=lower("o_orderpriority"),
                                      n=length("o_orderpriority"),
                                      t=trim("o_orderpriority"),
                                      c=concat("o_orderpriority", lit("-"),
                                               "o_custkey")),
                              ["o_orderkey"]),
        # One scan of l_shipmode counts all three matches.
        "strings_matches": (li().agg(**{
            label: (when(match, 1).otherwise(0), "sum") for label, match in (
                ("startswith", col("l_shipmode").startswith("R")),
                ("endswith", col("l_shipmode").endswith("AIR")),
                ("contains", col("l_shipmode").contains("AI")))}), None),
        "q4": (orders().filter((col("o_orderdate") >= day(q_lo))
                               & (col("o_orderdate") < day(q_hi))
                               & exists(li().filter(
                                   (col("l_orderkey") == outer_ref("o_orderkey"))
                                   & (col("l_commitdate") < col("l_receiptdate")))))
               .group_by("o_orderpriority")
               .agg(order_count=("o_orderkey", "count_all"))
               .sort("o_orderpriority"), None),
        "q17_shape": (li().filter(col("l_quantity") < 0.2 * scalar(
            li().filter(col("l_suppkey") == outer_ref("l_suppkey"))
            .agg(m=("l_quantity", "mean"))))
            .agg(total=("l_extendedprice", "sum"))
            .select(avg_yearly=col("total") / 7.0), None),
        "q22_scalar": (orders().filter(col("o_totalprice") > scalar(
            orders().agg(m=("o_totalprice", "mean"))))
            .agg(n=("o_totalprice", "count_all"), total=("o_totalprice", "sum")),
            None),
        "in": (totals(li().filter(in_subquery("l_orderkey", cheap))), None),
        "not_in": (totals(li().filter(~in_subquery("l_orderkey", cheap))), None),
        "not_in_null": (li().filter(~in_subquery("l_orderkey", with_null))
                        .agg(n=("l_extendedprice", "count_all")), None),
        "q21_shape": (li().filter((col("l_orderkey") >= k0)
                                  & (col("l_orderkey") < k1) & late)
                      .filter(exists(li().filter(same_order & other_supp))
                              & ~exists(li().filter(same_order & other_supp
                                                    & late)))
                      .group_by("l_suppkey").agg(numwait=("l_orderkey", "count_all"))
                      .sort(("numwait", False), "l_suppkey").limit(100), None),
    }


def l_plan_facts(name: str, plan, ds_index: str) -> dict:
    """What query ``name``'s optimized plan must show, checked: the
    canonicalized year (no ``year(``), the host ``month(``, the folded
    literal, the semi join, the residual, the two indexes of q12."""
    text = plan.tree_string()
    facts = {"extract": "year(" in text or "month(" in text,
             "scalar_subquery": "scalar_subquery" in text,
             "semi": "Join semi" in text, "anti": "Join anti" in text,
             "residual": " residual " in text,
             "indexes": sorted(name_ for name_, _ in index_scans(plan))}
    kept = [sc.relation.data_skipping_stats for sc in plan.leaf_relations()
            if sc.relation.data_skipping_of == ds_index]
    facts["files"] = list(kept[0]) if kept and kept[0] is not None else None
    want = {
        "year_1995": not facts["extract"], "year_isin": not facts["extract"],
        "month_3": "month(" in text,
        "q12": facts["indexes"] == sorted([L_LI_INDEX, L_ORD_INDEX]),
        "q4": facts["semi"] and not facts["scalar_subquery"],
        "q17_shape": not facts["scalar_subquery"] and "Join inner" in text,
        "q22_scalar": not facts["scalar_subquery"]
        and re.search(r"Filter \(col\('o_totalprice'\) > lit\(", text) is not None,
        "in": facts["semi"], "not_in": facts["anti"],
        "not_in_null": "lit(False)" in text,
        "q21_shape": facts["semi"] and facts["anti"] and facts["residual"],
    }.get(name, True)
    if not want:
        raise AssertionError(f"phase L {name}: plan\n{text}")
    return facts


def phase_l(root: str, dev) -> tuple:
    """The plan language at SF1 (see the module docstring).  Returns its
    record and what phase M reuses: the session, its Hyperspace, the
    numpy oracle and the DSL queries."""
    from hyperspace_tpu_torch import (
        DataSkippingIndexConfig,
        Hyperspace,
        HyperspaceSession,
        IndexConfig,
    )
    from hyperspace_tpu_torch.ops import kernels

    t_phase = time.perf_counter()
    device_cache().clear()
    t0 = time.perf_counter()
    orders, li, phrases = l_gen()
    o_cols, li_cols = l_arrow(orders, li, phrases)
    write_files(o_cols, os.path.join(root, "l_orders"))
    write_files(li_cols, os.path.join(root, "l_lineitem"))
    del o_cols, li_cols
    want = l_expected(orders, li, phrases)
    out: dict = {"datagen_s": time.perf_counter() - t0,
                 "rows": {"orders": L_ORDERS, "lineitem": L_LINEITEM}}

    session = HyperspaceSession(system_path=os.path.join(root, "l_indexes"),
                                device=dev)
    session.conf.num_buckets = NUM_BUCKETS
    set_min_rows(session, 0)
    hs = Hyperspace(session)
    kernels.reset_launch_counts()
    builds = {}
    for name, src, config in (
            (L_LI_INDEX, "l_lineitem",
             IndexConfig(L_LI_INDEX, ["l_orderkey"], L_LI_INCLUDED)),
            (L_ORD_INDEX, "l_orders",
             IndexConfig(L_ORD_INDEX, ["o_orderkey"], L_ORD_INCLUDED)),
            (L_DS_INDEX, "l_lineitem",
             DataSkippingIndexConfig(L_DS_INDEX, ["l_shipdate"]))):
        t0 = time.perf_counter()
        hs.create_index(session.read.parquet(os.path.join(root, src)), config)
        builds[name] = time.perf_counter() - t0
    out["build_s"] = builds
    out["launches_builds"] = kernels.launch_counts()
    # On CPU tensors (a rehearsal) the plain versions count no launch.
    missing = [k for k, v in out["launches_builds"].items() if v <= 0]
    if dev.type == "cuda" and missing:
        raise AssertionError(f"phase L: kernels not launched by the builds: "
                             f"{missing}")
    session.enable_hyperspace()

    queries = l_queries(session, root, want["q21_keys"])
    out["queries"] = {}
    kernels.reset_launch_counts()
    for name, (ds, keys) in queries.items():
        t0 = time.perf_counter()
        plan = ds.optimized_plan()
        plan_ms = (time.perf_counter() - t0) * 1e3
        facts = l_plan_facts(name, plan, L_DS_INDEX)
        device_cache().clear()
        t0 = time.perf_counter()
        got = ds.collect()
        checked_ms = (time.perf_counter() - t0) * 1e3
        stats = session.last_execution_stats
        require_rows(f"phase L {name}", got, want[name], keys, rtol=AGG_RTOL)
        times = []
        for _ in range(L_TIMED_RUNS):
            t0 = time.perf_counter()
            again = ds.collect()
            times.append((time.perf_counter() - t0) * 1e3)
            require_rows(f"phase L {name} (timed)", again, want[name], keys,
                         rtol=AGG_RTOL)
        record = {"checked_ms": checked_ms, "timed_ms": times,
                  "median_ms": statistics.median(times), "plan_ms": plan_ms,
                  "rows": int(got.num_rows), **routes(stats),
                  "aggregates": sorted({d["strategy"]
                                        for d in stats.get("aggregates", [])}),
                  "plan": facts}
        out["queries"][name] = record

    y = out["queries"]["year_1995"]
    if y["filters"] != ["device"] or y["plan"]["files"] != [
            want["year_1995_files"], N_FILES]:
        raise AssertionError(f"phase L year_1995: {y}, numpy keeps "
                             f"{want['year_1995_files']} files")
    yi = out["queries"]["year_isin"]
    if yi["plan"]["files"] != [want["year_isin_files"], N_FILES]:
        raise AssertionError(f"phase L year_isin: {yi}, numpy keeps "
                             f"{want['year_isin_files']} files")
    m3 = out["queries"]["month_3"]
    if m3["filters"] != ["host"] or m3["plan"]["files"] not in (
            None, [N_FILES, N_FILES]):
        raise AssertionError(f"phase L month_3: {m3}")
    q22 = out["queries"]["q22_scalar"]
    if q22["filters"] != ["device"]:
        raise AssertionError(f"phase L q22_scalar: {q22}")
    out["launches"] = kernels.launch_counts()
    if any(out["launches"].values()):
        raise AssertionError(f"phase L's queries launched {out['launches']}: "
                             f"no kernel is on their path")
    out["wall_s"] = time.perf_counter() - t_phase
    return out, {"session": session, "hs": hs, "want": want,
                 "queries": queries}


def m_texts(keys21: tuple) -> dict:
    """Phase L's queries as SQL text over the tables ``lineitem`` and
    ``orders``: name -> the text of ``l_queries``' Dataset of that name."""
    import datetime

    epoch = datetime.date(1970, 1, 1)

    def day(n):
        return f"DATE '{(epoch + datetime.timedelta(days=n)).isoformat()}'"

    totals = ("SELECT count(*) AS n, sum(l_extendedprice) AS revenue "
              "FROM lineitem WHERE ")
    cheap = f"SELECT o_orderkey FROM orders WHERE o_totalprice < {PRICE_BELOW!r}"
    urgent = "o_orderpriority IN ('1-URGENT', '2-HIGH')"
    k0, k1 = keys21
    s_lo, s_hi = L_STRING_KEYS
    q_lo, q_hi = L_Q4_QUARTER
    n_lo, n_hi = L_NULL_KEYS
    other = ("{t}.l_orderkey = l1.l_orderkey AND {t}.l_suppkey <> l1.l_suppkey")
    count_match = "sum(CASE WHEN l_shipmode LIKE '{p}' THEN 1 ELSE 0 END) AS {a}"
    return {
        "year_1995": totals + "year(l_shipdate) = 1995",
        "year_isin": totals + "year(l_shipdate) IN (1994, 1996)",
        "month_3": totals + "month(l_shipdate) = 3",
        "q12": f"""
            SELECT l_shipmode,
                   sum(CASE WHEN {urgent} THEN 1 ELSE 0 END) AS high_line_count,
                   sum(CASE WHEN NOT {urgent} THEN 1 ELSE 0 END)
                       AS low_line_count
            FROM lineitem JOIN orders ON l_orderkey = o_orderkey
            WHERE l_shipmode IN ('MAIL', 'SHIP')
              AND l_commitdate < l_receiptdate AND l_shipdate < l_commitdate
              AND year(l_receiptdate) = 1994
            GROUP BY l_shipmode ORDER BY l_shipmode""",
        "q13_orders": """
            SELECT c_count, count(*) AS custdist
            FROM (SELECT o_custkey, count(o_orderkey) AS c_count FROM orders
                  WHERE o_comment NOT LIKE '%special%requests%'
                  GROUP BY o_custkey) c
            GROUP BY c_count ORDER BY custdist DESC, c_count DESC""",
        "strings_digit_sum": """
            SELECT o_orderpriority,
                   sum(CAST(substring(o_orderpriority, 1, 1) AS int)) AS digit
            FROM orders GROUP BY o_orderpriority ORDER BY o_orderpriority""",
        "strings_functions": f"""
            SELECT o_orderkey, upper(o_orderpriority) AS u,
                   lower(o_orderpriority) AS lo, length(o_orderpriority) AS n,
                   trim(o_orderpriority) AS t,
                   concat(o_orderpriority, '-', o_custkey) AS c
            FROM orders WHERE o_orderkey >= {s_lo} AND o_orderkey < {s_hi}""",
        "strings_matches": "SELECT " + ", ".join(
            count_match.format(p=p, a=a) for p, a in (
                ("R%", "startswith"), ("%AIR", "endswith"),
                ("%AI%", "contains"))) + " FROM lineitem",
        "q4": f"""
            SELECT o_orderpriority, count(*) AS order_count FROM orders
            WHERE o_orderdate >= {day(q_lo)} AND o_orderdate < {day(q_hi)}
              AND EXISTS (SELECT 1 FROM lineitem l
                          WHERE l.l_orderkey = orders.o_orderkey
                            AND l.l_commitdate < l.l_receiptdate)
            GROUP BY o_orderpriority ORDER BY o_orderpriority""",
        "q17_shape": """
            SELECT total / 7.0 AS avg_yearly
            FROM (SELECT sum(l_extendedprice) AS total FROM lineitem l1
                  WHERE l1.l_quantity < 0.2 * (
                      SELECT avg(l2.l_quantity) AS m FROM lineitem l2
                      WHERE l2.l_suppkey = l1.l_suppkey)) t""",
        "q22_scalar": """
            SELECT count(*) AS n, sum(o_totalprice) AS total FROM orders
            WHERE o_totalprice > (SELECT avg(o_totalprice) AS m FROM orders)""",
        "in": totals + f"l_orderkey IN ({cheap})",
        "not_in": totals + f"l_orderkey NOT IN ({cheap})",
        "not_in_null": f"""
            SELECT count(*) AS n FROM lineitem
            WHERE l_orderkey NOT IN (
                SELECT CASE WHEN o_totalprice < {PRICE_BELOW!r}
                            THEN o_orderkey END AS k
                FROM orders WHERE o_orderkey >= {n_lo} AND o_orderkey < {n_hi})""",
        "q21_shape": f"""
            SELECT l_suppkey, count(*) AS numwait FROM lineitem l1
            WHERE l1.l_orderkey >= {k0} AND l1.l_orderkey < {k1}
              AND l1.l_receiptdate > l1.l_commitdate
              AND EXISTS (SELECT 1 FROM lineitem l2
                          WHERE {other.format(t="l2")})
              AND NOT EXISTS (SELECT 1 FROM lineitem l3
                              WHERE {other.format(t="l3")}
                                AND l3.l_receiptdate > l3.l_commitdate)
            GROUP BY l_suppkey ORDER BY numwait DESC, l_suppkey LIMIT 100""",
    }


def m_tables(root: str) -> dict:
    return {"lineitem": os.path.join(root, "l_lineitem"),
            "orders": os.path.join(root, "l_orders")}


def m_section(text: str, title: str) -> list:
    """The lines of explain's section ``title`` (between its header and
    the next one)."""
    lines = text.splitlines()
    start = lines.index(title) + 2
    end = next((i for i in range(start, len(lines))
                if lines[i].startswith("=" * 64)), len(lines))
    return [ln for ln in lines[start:end] if ln]


def m_explain(name: str, text: str, files: tuple) -> None:
    """Raise unless explain's ``text`` for query ``name`` holds what phase
    L measured: q12's two indexes and its bucket-aligned join, the files
    year_1995's sketch keeps, and the four rules' decisions."""
    used = [ln.split(":")[0] for ln in m_section(text, "Indexes used:")]
    ops = m_section(text, "Physical operator stats:")
    scans = m_section(text, "Scan IO (with indexes):")
    rules = [ln.split(":")[0] for ln in m_section(text, "Optimizer decisions:")
             if ln.startswith("rule ")]
    want_rules = [f"rule {r}" for r in M_RULES]
    bad = []
    if rules[:4] != want_rules:
        bad.append(f"rules {rules}")
    if name == "q12":
        if used != sorted([L_LI_INDEX, L_ORD_INDEX]):
            bad.append(f"indexes used {used}")
        if not any(ln.split()[0] == "PerBucketMergeJoinExec"
                   and ln.split()[2] == "1" for ln in ops):
            bad.append(f"operators {ops}")
    if name == "year_1995":
        kept = f"files {files[0]}/{files[1]},"
        if used != [L_DS_INDEX] or not any(kept in ln for ln in scans):
            bad.append(f"indexes used {used}, scans {scans}, want {kept}")
    if bad:
        raise AssertionError(f"phase M explain {name}: {bad}\n{text}")


def phase_m(root: str, dev, pl: dict, ctx: dict) -> dict:
    """SQL and explain on the card, over phase L's session, tables and
    indexes (see the module docstring)."""
    from hyperspace_tpu_torch.ops import kernels
    from hyperspace_tpu_torch.sql import sql

    t_phase = time.perf_counter()
    session, hs, want = ctx["session"], ctx["hs"], ctx["want"]
    texts = m_texts(want["q21_keys"])
    tables = m_tables(root)
    out: dict = {"queries": {}, "explain": {}}
    kernels.reset_launch_counts()
    sql_ds = {}
    for name, (dsl, keys) in ctx["queries"].items():
        t0 = time.perf_counter()
        ds = sql(session, texts[name], tables)
        parse_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        plan = ds.optimized_plan()
        optimize_ms = (time.perf_counter() - t0) * 1e3
        same = plan.tree_string() == dsl.optimized_plan().tree_string()
        if same == (name in M_PLAN_EXCEPTIONS):
            raise AssertionError(
                f"phase M {name}: SQL plan {'equals' if same else 'differs from'}"
                f" the DSL twin's\n{plan.tree_string()}")
        device_cache().clear()
        t0 = time.perf_counter()
        got = ds.collect()
        checked_ms = (time.perf_counter() - t0) * 1e3
        stats = session.last_execution_stats
        require_rows(f"phase M {name}", got, want[name], keys, rtol=AGG_RTOL)
        # Timed in turns with the DSL twin, so the two compare within
        # one stretch of the run.
        turns = {"sql": [], "dsl": []}
        for label in ("sql", "dsl", "dsl", "sql"):
            t0 = time.perf_counter()
            again = (ds if label == "sql" else dsl).collect()
            turns[label].append((time.perf_counter() - t0) * 1e3)
            require_rows(f"phase M {name} ({label}, timed)", again,
                         want[name], keys, rtol=AGG_RTOL)
        twin = pl["queries"][name]
        record = {"parse_ms": parse_ms, "optimize_ms": optimize_ms,
                  "checked_ms": checked_ms, "timed_ms": turns["sql"],
                  "median_ms": statistics.median(turns["sql"]),
                  "dsl_turns_ms": turns["dsl"],
                  "dsl_turns_median_ms": statistics.median(turns["dsl"]),
                  "dsl_median_ms": twin["median_ms"], "plan_equal": same,
                  **routes(stats),
                  "aggregates": sorted({d["strategy"]
                                        for d in stats.get("aggregates", [])})}
        for k in ("filters", "joins", "join_kernels", "aggregates"):
            if record[k] != twin[k]:
                raise AssertionError(f"phase M {name}: {k} {record[k]}, phase "
                                     f"L took {twin[k]}")
        out["queries"][name] = record
        sql_ds[name] = ds
    files = (want["year_1995_files"], N_FILES)
    for name in M_EXPLAINED:
        t0 = time.perf_counter()
        text = hs.explain(sql_ds[name], verbose=True)
        out["explain"][name] = {"ms": (time.perf_counter() - t0) * 1e3,
                                "lines": len(text.splitlines())}
        m_explain(name, text, files)
        if name == "q12":
            print(f"phase M explain q12 (verbose):\n{text}", flush=True)
    t0 = time.perf_counter()
    row = hs.index(L_LI_INDEX).to_pylist()
    listed = hs.indexes().to_pylist()
    out["statistics_ms"] = (time.perf_counter() - t0) * 1e3
    if len(row) != 1 or row[0]["numBuckets"] != NUM_BUCKETS \
            or row[0]["state"] != "ACTIVE" or sorted(
                r["name"] for r in listed) != sorted(
                    [L_LI_INDEX, L_ORD_INDEX, L_DS_INDEX]):
        raise AssertionError(f"phase M statistics: {row}, {listed}")
    out["index"] = {k: v for k, v in row[0].items() if k != "schema"}
    out["indexes"] = [{k: r[k] for k in ("name", "numBuckets", "state",
                                          "numIndexFiles", "sizeIndexFiles")}
                      for r in listed]
    out["launches"] = kernels.launch_counts()
    if any(out["launches"].values()):
        raise AssertionError(f"phase M's queries launched {out['launches']}: "
                             f"no kernel is on their path")
    out["wall_s"] = time.perf_counter() - t_phase
    return out


# ---------------------------------------------------------------------------
# Phase N: the failure envelope at SF1
# ---------------------------------------------------------------------------

N_SOURCE = "n_lineitem"         # a hard-linked copy of phase C's lineitem
N_CLEAN = "n_clean"             # the fault-free build every fault holds to
N_ORDERS_INDEX = "n_ord"        # so point and q3 run through indexes
N_APPENDED = 2                  # files appended before the refresh
N_READ_AT = 3                   # data.read eio: the third source read
N_WRITE_AT = 2                  # data.write eio: the second file written
N_QUERIES = ("point", "q3")


def n_spill_dirs() -> set:
    """This process's spill directories in the temporary directory."""
    prefix = f"hs_build_spill_{os.getpid()}_"
    return {n for n in os.listdir(tempfile.gettempdir())
            if n.startswith(prefix)}


def n_log(hs, name: str) -> dict:
    """The ids, states and resolved stable entry of ``name``'s log."""
    mgr = hs.session.index_collection_manager._log_manager(name)
    ids = mgr.log_ids()
    stable = mgr.get_latest_stable_log()
    return {"ids": ids,
            "states": [(e.state if e is not None else None)
                       for e in (mgr.get_log(i) for i in ids)],
            "stable": None if stable is None else [stable.id, stable.state],
            "pointer": os.path.isfile(os.path.join(mgr.log_dir,
                                                   "latestStable")),
            "pointer_tmp": os.path.isfile(os.path.join(
                mgr.log_dir, "latestStable.tmp"))}


def n_step(out: dict, label: str, run, plan=None, error=None) -> dict:
    """``run()`` under the fault ``plan`` (a FaultPlan's fields, cleared
    in a finally), the launch counts set to 0 just before and read just
    after; ``error``, the exception class the run must raise.  Records
    and prints its wall, outcome and launches."""
    from hyperspace_tpu_torch.io import faults
    from hyperspace_tpu_torch.ops import kernels

    device_cache().clear()
    kernels.reset_launch_counts()
    raised = None
    t0 = time.perf_counter()
    try:
        if plan is not None:
            faults.install(faults.FaultPlan(**plan))
        result = run()
    except BaseException as e:  # noqa: BLE001 - the injected crash too
        if error is None or not isinstance(e, error):
            raise
        raised, result = e, None
    finally:
        faults.clear()
    wall = time.perf_counter() - t0
    if error is not None and raised is None:
        raise AssertionError(f"phase N {label}: the run did not raise "
                             f"{error.__name__}")
    outcome = type(raised).__name__ if raised is not None \
        else getattr(result, "outcome", "ok")
    rec = {"step": label, "wall_s": wall, "outcome": outcome,
           "launches": kernels.launch_counts(), "fault": plan}
    out["steps"].append(rec)
    print(f"phase N {label}: wall {wall:.3f} s, outcome {outcome}, "
          f"launches {json.dumps(rec['launches'])}", flush=True)
    return rec


def n_require(label: str, got, want) -> None:
    if got != want:
        raise AssertionError(f"phase N {label}: {got!r}, expected {want!r}")


def n_want(want: dict, name: str) -> tuple:
    """(columns, sort keys) of ``name``'s answer: the point query's rows
    compared as a multiset, since after an incremental refresh its key's
    rows may lie in two versions of a bucket."""
    rows, keys = want[name]
    return rows, (["l_orderkey", "l_quantity"] if name == "point" else keys)


def n_check_queries(label: str, session, root: str, want: dict,
                    indexed: bool) -> dict:
    """Point and q3 over the phase's source, each held to numpy; with
    ``indexed`` every scan of their plans must read an index.  Returns
    each query's cold ms."""
    queries = build_queries(session, root, lineitem=N_SOURCE, aggregates=True)
    ms = {}
    for name in N_QUERIES:
        ds = queries[name]
        plan = ds.optimized_plan()
        scans = index_scans(plan)
        if indexed and len(scans) != len(plan.leaf_relations()):
            raise AssertionError(f"phase N {label} {name}: plan scans "
                                 f"{scans} of {len(plan.leaf_relations())} "
                                 f"relations")
        device_cache().clear()
        t0 = time.perf_counter()
        got = ds.collect()
        ms[name] = (time.perf_counter() - t0) * 1e3
        rows, keys = n_want(want, name)
        require_rows(f"phase N {label} {name}", got, rows, keys,
                     rtol=AGG_RTOL if name == "q3" else 0.0)
    return ms


def phase_n(orders: dict, li: dict, root: str, dev) -> dict:
    """The failure envelope at SF1 (see the module docstring)."""
    from hyperspace_tpu_torch import HyperspaceSession, IndexConfig
    from hyperspace_tpu_torch.exceptions import DegradedIndexError
    from hyperspace_tpu_torch.io.faults import InjectedCrash
    from hyperspace_tpu_torch.rules import filter_rule

    t_phase = time.perf_counter()
    src = os.path.join(root, N_SOURCE)
    shutil.copytree(os.path.join(root, "lineitem"), src,
                    copy_function=os.link)
    sys_path = os.path.join(root, "n_indexes")
    hs = spill_session(dev, sys_path, lineage_enabled=True)
    session = hs.session
    out: dict = {"steps": []}

    def create(name: str):
        return lambda: hs.create_index(
            session.read.parquet(src), IndexConfig(name, INDEXED, INCLUDED))

    # 1. The clean build, and the orders index q3 joins through.
    n_step(out, "clean build", create(N_CLEAN))
    clean = bucket_digests(hs, N_CLEAN)
    out["clean_files"] = sum(len(v) for v in clean.values())
    n_step(out, "orders build", lambda: hs.create_index(
        session.read.parquet(os.path.join(root, "orders")),
        IndexConfig(N_ORDERS_INDEX, ["o_orderkey"],
                    ["o_totalprice", "o_custkey"])))
    if dev.type == "cuda":
        for rec in out["steps"]:
            missing = [k for k, v in rec["launches"].items() if v <= 0]
            if missing:
                raise AssertionError(f"phase N {rec['step']}: kernels not "
                                     f"launched: {missing}")

    # 2. A transient read error past the first chunk: the read is retried
    #    and the build commits the clean bytes.  A write error has no IO
    #    retry (as in the JAX package): the build fails, leaves no spill
    #    directory, and the rebuild under auto recovery commits them.
    n_step(out, "data.read eio", create("n_read"),
           plan={"site": "data.read", "kind": "eio", "at": N_READ_AT})
    n_require("data.read eio bytes", bucket_digests(hs, "n_read"), clean)
    before = n_spill_dirs()
    n_step(out, "data.write eio", create("n_write"), error=OSError,
           plan={"site": "data.write", "kind": "eio", "at": N_WRITE_AT})
    n_require("data.write eio spill dirs", n_spill_dirs() - before, set())
    n_require("data.write eio log", n_log(hs, "n_write")["states"],
              ["CREATING"])
    session.conf.auto_recovery_enabled = True
    n_step(out, "data.write eio rebuild", create("n_write"))
    n_require("data.write eio rebuild bytes", bucket_digests(hs, "n_write"),
              clean)

    # 3. A torn data write: the build dies, no spill directory is left,
    #    the log is CREATING with no stable entry; the rebuild recovers.
    session.conf.auto_recovery_enabled = False
    before = n_spill_dirs()
    n_step(out, "data.write torn", create("n_torn"), error=InjectedCrash,
           plan={"site": "data.write", "kind": "torn"})
    n_require("data.write torn spill dirs", n_spill_dirs() - before, set())
    log = n_log(hs, "n_torn")
    n_require("data.write torn log", (log["states"], log["stable"]),
              (["CREATING"], None))
    session.conf.auto_recovery_enabled = True
    n_step(out, "data.write torn rebuild", create("n_torn"))
    n_require("data.write torn rebuild state", index_state(hs, "n_torn"),
              "ACTIVE")
    n_require("data.write torn rebuild bytes", bucket_digests(hs, "n_torn"),
              clean)
    out["torn_log"] = n_log(hs, "n_torn")

    # 4. A crash at commit of an incremental refresh after appends: the
    #    stable entry stays the previous version and the queries answer
    #    from the changed source; the refresh under auto recovery commits
    #    the bytes an uninterrupted refresh of the same change commits.
    appended = g_append(src, 0, N_APPENDED, seed=141)
    li2 = {c: np.concatenate([li[c], appended[c]]) for c in li}
    want = {**expected_answers(orders, li2),
            **expected_aggregates(orders, li2)}
    n_step(out, "uninterrupted refresh", lambda: hs.refresh_index(
        "n_read", "incremental"))
    reference = bucket_digests(hs, "n_read")
    stable_before = n_log(hs, N_CLEAN)["stable"]
    session.conf.auto_recovery_enabled = False
    n_step(out, "action.commit crash", lambda: hs.refresh_index(
        N_CLEAN, "incremental"), error=InjectedCrash,
        plan={"site": "action.commit", "kind": "crash"})
    log = n_log(hs, N_CLEAN)
    n_require("action.commit crash stable", log["stable"], stable_before)
    n_require("action.commit crash latest", log["states"][-1], "REFRESHING")
    session.enable_hyperspace()
    out["crashed_ms"] = n_check_queries("after the crash", session, root,
                                        want, indexed=False)
    session.conf.auto_recovery_enabled = True
    n_step(out, "recovered refresh", lambda: hs.refresh_index(
        N_CLEAN, "incremental"))
    n_require("recovered refresh bytes", bucket_digests(hs, N_CLEAN),
              reference)
    out["refresh_log"] = n_log(hs, N_CLEAN)

    # 5. Crashes on either side of the pointer's rename resolve.
    n_step(out, "log.rename crash-before-rename",
           lambda: hs.delete_index("n_torn"), error=InjectedCrash,
           plan={"site": "log.rename", "kind": "crash-before-rename"})
    log = n_log(hs, "n_torn")
    n_require("crash-before-rename", (log["pointer"], log["pointer_tmp"],
                                      log["stable"]),
              (False, True, [log["ids"][-1], "DELETED"]))
    n_step(out, "log.rename crash-after-rename",
           lambda: hs.restore_index("n_torn"), error=InjectedCrash,
           plan={"site": "log.rename", "kind": "crash-after-rename"})
    log = n_log(hs, "n_torn")
    n_require("crash-after-rename", (log["pointer"], log["stable"]),
              (True, [log["ids"][-1], "ACTIVE"]))
    out["rename_log"] = log

    # 6. A transient read error at query time: retried, recorded.
    clean_ms = n_check_queries("clean", session, root, want, indexed=True)
    out["queries"] = {}
    for name in N_QUERIES:
        ds = build_queries(session, root, lineitem=N_SOURCE,
                           aggregates=True)[name]
        rows, keys = n_want(want, name)
        holder = {}

        def faulted():
            holder["table"] = ds.collect()

        device_cache().clear()
        rec = n_step(out, f"data.read eio {name}", faulted,
                     plan={"site": "data.read", "kind": "eio"})
        require_rows(f"phase N data.read eio {name}", holder["table"], rows,
                     keys, rtol=AGG_RTOL if name == "q3" else 0.0)
        retries = [d for d in ds.last_run_report().decisions
                   if d["kind"] == "io.retry"]
        if len(retries) != 1:
            raise AssertionError(f"phase N data.read eio {name}: retries "
                                 f"{retries}")
        out["queries"][name] = {
            "clean_ms": clean_ms[name], "faulted_ms": rec["wall_s"] * 1e3,
            "extra_ms": rec["wall_s"] * 1e3 - clean_ms[name],
            "crashed_ms": out["crashed_ms"][name],
            "indexes": sorted(n for n, _ in index_scans(ds.optimized_plan())),
            "retry": retries[0]}
        print(f"phase N data.read eio {name}: {rec['wall_s'] * 1e3:.1f} ms "
              f"against {clean_ms[name]:.1f} ms clean (extra "
              f"{out['queries'][name]['extra_ms']:+.1f} ms), "
              f"{json.dumps(retries[0])}", flush=True)

    # 7. Degraded: every log entry of a copied index torn.
    deg_path = os.path.join(root, "n_degraded")
    deg_log = os.path.join(deg_path, "n_deg", "_hyperspace_log")
    shutil.copytree(os.path.join(sys_path, N_CLEAN, "_hyperspace_log"),
                    deg_log)
    for name in os.listdir(deg_log):
        with open(os.path.join(deg_log, name), "w", encoding="utf-8") as f:
            f.write('{"torn')
    deg = HyperspaceSession(system_path=deg_path, device=dev)
    set_min_rows(deg, 0)
    deg.enable_hyperspace()
    point = build_queries(deg, root, lineitem=N_SOURCE)["point"]
    t0 = time.perf_counter()
    got = point.collect()
    deg_ms = (time.perf_counter() - t0) * 1e3
    require_rows("phase N degraded point", got, *n_want(want, "point"))
    rep = point.last_run_report()
    if rep.outcome != "degraded" or rep.skipped_indexes() != ["n_deg"] \
            or index_scans(point.optimized_plan()):
        raise AssertionError(f"phase N degraded: {rep.render()}")
    deg.conf.degraded_fallback_to_source = False
    strict = None
    try:
        point.collect()
    except DegradedIndexError as e:
        strict = str(e)
    if strict is None or "n_deg" not in strict:
        raise AssertionError(f"phase N strict: {strict!r}")
    out["degraded"] = {"ms": deg_ms, "outcome": rep.outcome,
                       "skipped": rep.skipped_indexes(),
                       "reasons": rep.degraded_reasons(), "strict": strict}
    print(f"phase N degraded: point from the source in {deg_ms:.1f} ms, "
          f"{json.dumps(out['degraded'])}", flush=True)

    # A real allocation error of the card inside a rule propagates.
    import torch

    original = filter_rule.FilterIndexRule.apply

    def card_error(self, plan):
        torch.empty(1 << 50, dtype=torch.uint8, device=dev)
        return original(self, plan)

    point = build_queries(session, root, lineitem=N_SOURCE)["point"]
    filter_rule.FilterIndexRule.apply = card_error
    try:
        point.collect()
    except RuntimeError as e:
        device_error = e
    else:
        raise AssertionError("phase N: the card's error inside a rule was "
                             "degraded")
    finally:
        filter_rule.FilterIndexRule.apply = original
    rep = point.last_run_report()
    if rep.outcome != "error" or rep.degraded:
        raise AssertionError(f"phase N device error: {rep.render()}")
    require_rows("phase N after the device error", point.collect(),
                 *n_want(want, "point"))
    out["device_error"] = f"{type(device_error).__name__}: " \
        f"{str(device_error).splitlines()[0][:160]}"
    print(f"phase N device error inside a rule propagated: "
          f"{out['device_error']}", flush=True)
    out["launches"] = {k: sum(s["launches"][k] for s in out["steps"])
                       for k in out["steps"][0]["launches"]}
    out["wall_s"] = time.perf_counter() - t_phase
    device_cache().clear()
    return out


# ---------------------------------------------------------------------------
# Phase O: the advisor at SF1
# ---------------------------------------------------------------------------

O_QUERIES = ("point", "range", "join", "q3")
O_TOP_K = 5
O_APPLY = 2
O_CAPTURE_CALLS = 30            # timed capture calls of the point query


def o_listing(path: str) -> list:
    """Every file under ``path``, relative, sorted."""
    out = []
    for dirpath, _, names in os.walk(path):
        out.extend(os.path.relpath(os.path.join(dirpath, n), path)
                   for n in names)
    return sorted(out)


def phase_o(orders: dict, li: dict, root: str, dev) -> dict:
    """The advisor at SF1 (see the module docstring)."""
    from hyperspace_tpu_torch import Hyperspace, HyperspaceSession, IndexConfig
    from hyperspace_tpu_torch.advisor import workload
    from hyperspace_tpu_torch.advisor.hypothetical import hypothetical_entry
    from hyperspace_tpu_torch.exceptions import HyperspaceError
    from hyperspace_tpu_torch.execution.executor import Executor
    from hyperspace_tpu_torch.ops import kernels

    t_phase = time.perf_counter()
    sys_path = os.path.join(root, "o_indexes")
    session = HyperspaceSession(system_path=sys_path, device=dev)
    session.conf.num_buckets = NUM_BUCKETS
    set_min_rows(session, 0)
    session.conf.advisor_capture_enabled = True
    session.enable_hyperspace()
    hs = Hyperspace(session)
    workload.reset_cache()
    queries = build_queries(session, root, aggregates=True)
    want = {**expected_answers(orders, li), **expected_aggregates(orders, li)}
    out: dict = {"queries": {}}
    reports = {}

    def run(name: str, label: str) -> dict:
        ds = queries[name]
        rows, keys = want[name]
        device_cache().clear()
        t0 = time.perf_counter()
        got = ds.collect()
        ms = (time.perf_counter() - t0) * 1e3
        require_rows(f"phase O {name} {label}", got, rows, keys,
                     rtol=AGG_RTOL if name in AGG_QUERIES else 0.0)
        rep = reports[name] = ds.last_run_report()
        return {"ms": ms, "bytes_read": rep.bytes_read(),
                "indexes": sorted(n for n, _ in index_scans(
                    ds.optimized_plan()))}

    # 1. Capture: each query twice, cold, on no index.
    for name in O_QUERIES:
        run(name, "capture")
        out["queries"][name] = {"before": run(name, "capture")}
        if out["queries"][name]["before"]["indexes"]:
            raise AssertionError(f"phase O {name}: an index before apply")
    captured = hs.captured_workload().to_pylist()
    if sorted(r["hits"] for r in captured) != [2] * len(O_QUERIES):
        raise AssertionError(f"phase O workload: {captured}")
    out["workload"] = [{k: r[k] for k in (
        "hits", "eqColumns", "rangeColumns", "joinColumns", "groupColumns",
        "projectedColumns", "lastBytesScanned")} for r in captured]
    # What capture adds to a collect: the point query's, with its own
    # report, O_CAPTURE_CALLS times (each a hit more of its shape).
    point_rows = len(next(iter(want["point"][0].values())))
    capture_us = []
    for _ in range(O_CAPTURE_CALLS):
        t0 = time.perf_counter()
        workload.capture(session, queries["point"].plan, reports["point"],
                         result_rows=point_rows)
        capture_us.append((time.perf_counter() - t0) * 1e6)
    out["capture_us"] = {"median": statistics.median(capture_us),
                         "max": max(capture_us)}

    # 2. Recommend twice: the same table.
    t0 = time.perf_counter()
    rec = hs.recommend_indexes(top_k=O_TOP_K).to_pylist()
    out["recommend_ms"] = (time.perf_counter() - t0) * 1e3
    again = hs.recommend_indexes(top_k=O_TOP_K).to_pylist()
    if again != rec or len(rec) < O_APPLY:
        raise AssertionError(f"phase O recommendations: {rec} then {again}")
    out["recommendations"] = rec
    for r in rec:
        print(f"phase O recommend: {json.dumps(r)}", flush=True)

    # 3. What-if of the top candidates, per query over its relations:
    #    nothing written, a what-if plan refused by the executor.
    top = rec[:O_APPLY]
    listing = o_listing(sys_path)
    out["whatif"] = {}
    for name in O_QUERIES:
        ds = queries[name]
        roots = {",".join(s.relation.root_paths)
                 for s in ds.plan.leaf_relations()}
        configs = [IndexConfig(r["candidate"], r["indexedColumns"],
                               r["includedColumns"])
                   for r in top if r["relation"] in roots]
        t0 = time.perf_counter()
        text = ds.explain(whatif=configs)
        whatif_ms = (time.perf_counter() - t0) * 1e3
        report = hs.whatif(ds, configs).to_dict()
        if not report["hypothetical_used"] \
                or report["est_bytes_delta"] <= 0:
            raise AssertionError(f"phase O what-if {name}: {report}")
        out["whatif"][name] = {
            "ms": whatif_ms, "used": report["hypothetical_used"],
            "est_bytes_before": report["est_bytes_before"],
            "est_bytes_after": report["est_bytes_after"]}
        print(f"phase O what-if {name} ({whatif_ms:.1f} ms):\n{text}",
              flush=True)
    q3 = queries["q3"]
    entries = [hypothetical_entry(session, q3, IndexConfig(
        r["candidate"], r["indexedColumns"], r["includedColumns"]))
        for r in top]
    refused = None
    try:
        Executor(session).execute(session.optimize(q3.plan,
                                                   hypothetical=entries))
    except HyperspaceError as e:
        refused = str(e)
    if refused is None or "hypothetical" not in refused:
        raise AssertionError(f"phase O: a what-if plan ran ({refused!r})")
    if o_listing(sys_path) != listing:
        raise AssertionError("phase O: what-if wrote files")
    out["whatif_refused"] = refused

    # 4. Apply the top candidates: built on the card.
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    built = hs.apply_recommendations(top_k=O_APPLY)
    out["apply_s"] = time.perf_counter() - t0
    out["launches"] = kernels.launch_counts()
    if built != [r["candidate"] for r in top]:
        raise AssertionError(f"phase O apply built {built}, expected {top}")
    if dev.type == "cuda" and not all(out["launches"].values()):
        raise AssertionError(f"phase O apply launches {out['launches']}")
    out["built"] = built
    out["apply_report"] = checked_report("phase O apply", hs)
    print(f"phase O apply: {built} in {out['apply_s']:.3f} s, launches "
          f"{json.dumps(out['launches'])}, last build report "
          f"{json.dumps(out['apply_report'])}", flush=True)

    # 5. The queries again, cold: through the built indexes, numpy's
    #    answers, fewer bytes read.
    kernels.reset_launch_counts()
    for name in O_QUERIES:
        after = run(name, "after apply")
        before = out["queries"][name]["before"]
        n_leaves = len(queries[name].plan.leaf_relations())
        if not set(after["indexes"]) <= set(built) \
                or len(after["indexes"]) != n_leaves \
                or after["bytes_read"] >= before["bytes_read"]:
            raise AssertionError(f"phase O {name}: {after} after, "
                                 f"{before} before")
        out["queries"][name]["after"] = after
        print(f"phase O {name}: {before['ms']:.1f} -> {after['ms']:.1f} ms, "
              f"bytes {before['bytes_read']} -> {after['bytes_read']} "
              f"through {after['indexes']}", flush=True)
    out["launches_rerun"] = kernels.launch_counts()
    out["wall_s"] = time.perf_counter() - t_phase
    workload.reset_cache()
    device_cache().clear()
    return out


# ---------------------------------------------------------------------------
# Phase P: the autonomous index lifecycle at SF1
# ---------------------------------------------------------------------------

P_SOURCE = "p_lineitem"         # a hard-linked copy of phase C's lineitem
P_INDEX = "p_li"
P_COLD = "p_cold"               # an index no captured query touches
P_SEED = 161                    # the appended files' rows
P_QUERIES = ("point", "range", "q3")
P_DELETED = (5, 19, 33, 47)     # cycle 5: original files deleted
P_REWRITTEN = 60                # cycle 5: rewritten in place, rows dropped
P_REWRITE_DROP = 1_000
P_DELETED_AGAIN = tuple(range(6, 18))   # cycle 6: 12 more
P_STALENESS_LIMIT_S = 5.0
P_INTERVAL_S = 30.0
# Per cycle: its label, the decision, mode and outcome it must journal
# for P_INDEX (the advisor's for 9a and 9b), a phrase its reason must
# hold, and whether both kernels must launch in it.
P_CYCLES = (
    ("1 unchanged", "none", "", "noop", "source unchanged", False),
    ("2 append 1", "refresh", "quick", "done", "small appended", False),
    ("3 append 8", "refresh", "incremental", "done", "beyond the quick",
     True),
    ("4 compaction", "optimize", "quick", "done", "small index file", False),
    ("5 delete 4, rewrite 1", "refresh", "quick", "done",
     "CDC merge-on-read", False),
    ("6 delete 12", "refresh", "incremental", "done", "merge debt ratio",
     True),
    ("7 bit rot", "repair", "repair", "done", "quarantined index file",
     True),
    ("8 churn", "refresh", "full", "done", "churn ratio", True),
    ("9a advisor create", "create", "", "done", "advisor-recommended", True),
    ("9b advisor delete", "delete", "", "done", "cold index", False),
)


def p_columns(li: dict, f: int, rows=None) -> dict:
    """The query columns of original file ``f`` (its first ``rows``)."""
    lo = f * ROWS_PER_FILE
    hi = lo + (ROWS_PER_FILE if rows is None else rows)
    return {c: li[c][lo:hi] for c in G_QUERY_COLUMNS}


def p_expected(orders: dict, files: dict) -> dict:
    """Point, range and q3 answered by numpy over ``files`` (name ->
    query columns), as phase D answers them; the point query's rows as
    a multiset (after a refresh its key's rows may lie in two versions
    of a bucket)."""
    li = {c: np.concatenate([files[n][c] for n in sorted(files)])
          for c in G_QUERY_COLUMNS}
    lk = li["l_orderkey"]
    point = lk == POINT_KEY
    in_range = (lk >= RANGE[0]) & (lk < RANGE[1])
    position = np.empty(N_ORDERS, dtype=np.int64)
    position[orders["o_orderkey"]] = np.arange(N_ORDERS)
    row = position[lk]
    cheap = orders["o_totalprice"][row] < PRICE_BELOW
    revenue = li["l_extendedprice"] * (1 - li["l_discount"])
    q3_cust, q3_rev = top_groups(orders["o_custkey"][row][cheap],
                                 revenue[cheap], Q3_TOP, "phase P q3")
    return {
        "point": ({c: li[c][point] for c in ("l_orderkey", "l_quantity")},
                  ["l_orderkey", "l_quantity"]),
        "range": ({c: li[c][in_range] for c in
                   ("l_orderkey", "l_extendedprice", "l_discount")},
                  ["l_orderkey", "l_extendedprice"]),
        "q3": ({"o_custkey": q3_cust, "revenue": q3_rev}, None),
    }


def p_check(label: str, session, root: str, want: dict,
            through_index: bool = False, names=P_QUERIES) -> dict:
    """The queries ``names`` (of point, range and q3) over phase P's
    source held to ``want`` (``p_expected``); with ``through_index``
    point and range must read P_INDEX.  Returns each query's ms."""
    queries = build_queries(session, root, lineitem=P_SOURCE, aggregates=True)
    ms = {}
    for name in names:
        ds = queries[name]
        if through_index and name != "q3":
            used = [n for n, _ in index_scans(ds.optimized_plan())]
            if P_INDEX not in used:
                raise AssertionError(f"phase P {label} {name}: the plan "
                                     f"reads {used}, not {P_INDEX}")
        t0 = time.perf_counter()
        got = ds.collect()
        ms[name] = (time.perf_counter() - t0) * 1e3
        rows, keys = want[name]
        require_rows(f"phase P {label} {name}", got, rows, keys,
                     rtol=AGG_RTOL if name == "q3" else 0.0)
    return ms


def p_write(src: str, staging: str, name: str, table) -> float:
    """Write ``table`` as ``src/name`` through a file in ``staging`` and
    ``os.replace``: a linked file is never rewritten in place, and the
    file appears whole.  Returns the wall clock of the rename."""
    import pyarrow.parquet as pq

    tmp = os.path.join(staging, name)
    pq.write_table(table, tmp)
    t = time.time()
    os.replace(tmp, os.path.join(src, name))
    return t


def p_append(src: str, staging: str, files: dict, first: int, count: int,
             seed: int) -> float:
    """``count`` new lineitem files (``gen_lineitem`` from ``seed``) named
    after the original ones; returns the last rename's wall clock."""
    import pyarrow as pa

    cols = gen_lineitem(np.random.default_rng(seed), count * ROWS_PER_FILE)
    cols["l_shipdate"] = (N_FILES + first) * ROWS_PER_FILE \
        + np.arange(count * ROWS_PER_FILE, dtype=np.int64)
    table = pa.table(cols)
    t = 0.0
    for j in range(count):
        name = f"part-{90000 + first + j:05d}.parquet"
        lo = j * ROWS_PER_FILE
        t = p_write(src, staging, name,
                    table.slice(lo, ROWS_PER_FILE))
        files[name] = {c: cols[c][lo:lo + ROWS_PER_FILE]
                       for c in G_QUERY_COLUMNS}
    return t


def p_delete(src: str, files: dict, numbers) -> None:
    for f in numbers:
        name = f"part-{f:05d}.parquet"
        os.remove(os.path.join(src, name))
        del files[name]


def p_record(recs: list, decision: str, mode: str) -> dict:
    """The one record of ``decision`` in ``mode`` among ``recs``; of the
    advisor's creates, the first (each must agree with it)."""
    hits = [r for r in recs if r["decision"] == decision
            and r["mode"] == mode]
    if len(hits) != 1 and not (decision == "create" and hits):
        raise AssertionError(f"phase P: one {decision} {mode} record "
                             f"expected, the cycle journaled {recs}")
    if any(r["outcome"] != hits[0]["outcome"] for r in hits):
        raise AssertionError(f"phase P: {hits}")
    return hits[0]


def p_bucket_rows(hs, bucket: int) -> dict:
    """Column name -> numpy array of ``bucket``'s rows of P_INDEX, its
    files in name order (read as files: no column from the version
    directory's name)."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from hyperspace_tpu_torch.io.parquet import bucket_id_of_file

    entry = hs.session.index_collection_manager.get_index(P_INDEX)
    names = sorted(f.name for f in entry.content.file_infos()
                   if bucket_id_of_file(f.name) == bucket)
    table = pa.concat_tables([pq.ParquetFile(n).read() for n in names])
    return {c: table.column(c).to_numpy() for c in table.column_names}


def p_sorted(rows: dict) -> list:
    """``rows`` as a sorted list of row tuples (a multiset)."""
    return sorted(zip(*(rows[c].tolist() for c in sorted(rows))))


def phase_p(orders: dict, li: dict, root: str, dev) -> dict:
    """The autonomous index lifecycle at SF1 (see the module docstring)."""
    import torch

    from hyperspace_tpu_torch import HyperspaceSession, IndexConfig
    from hyperspace_tpu_torch.io.parquet import bucket_id_of_file
    from hyperspace_tpu_torch.lifecycle import journal
    from hyperspace_tpu_torch.lifecycle.change_detector import detect_changes
    from hyperspace_tpu_torch.ops import hash as ops_hash
    from hyperspace_tpu_torch.ops import kernels

    t_phase = time.perf_counter()
    src = os.path.join(root, P_SOURCE)
    shutil.copytree(os.path.join(root, "lineitem"), src,
                    copy_function=os.link)
    staging = os.path.join(root, "p_staging")
    os.makedirs(staging)
    files = {f"part-{f:05d}.parquet": p_columns(li, f)
             for f in range(N_FILES)}
    conf = {"lineage_enabled": True, "hybrid_scan_enabled": True}
    hs = spill_session(dev, os.path.join(root, "p_indexes"),
                       lifecycle_cdc_enabled=True, **conf)
    twin = spill_session(dev, os.path.join(root, "p_twin"), **conf)
    session = hs.session
    device_cache().clear()
    out: dict = {"cycles": []}
    config = IndexConfig(P_INDEX, INDEXED, INCLUDED)
    t0 = time.perf_counter()
    hs.create_index(session.read.parquet(src), config)
    out["create_s"] = time.perf_counter() - t0
    twin.create_index(twin.session.read.parquet(src), config)
    session.enable_hyperspace()
    cuda = dev.type == "cuda"

    split = out["split_s"] = {k: 0.0 for k in (
        "cycles", "twin", "digests", "oracle", "queries")}

    def digests() -> dict:
        t0 = time.perf_counter()
        got = bucket_digests(hs, P_INDEX)
        split["digests"] += time.perf_counter() - t0
        return got

    def cycle(i: int, twin_step=None) -> dict:
        label, decision, mode, outcome, phrase, kernels_run = P_CYCLES[i]
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        recs = hs.maintenance_cycle()
        wall = time.perf_counter() - t0
        split["cycles"] += wall
        launches = kernels.launch_counts()
        rec = p_record(recs, decision, mode)
        if rec["outcome"] != outcome or phrase not in rec["reason"]:
            raise AssertionError(f"phase P cycle {label}: {rec}")
        if cuda and kernels_run and not all(launches.values()):
            raise AssertionError(f"phase P cycle {label}: launches "
                                 f"{launches}")
        if cuda and mode == "quick" and decision == "refresh" \
                and any(launches.values()):
            raise AssertionError(f"phase P cycle {label}: a quick refresh "
                                 f"launched {launches}")
        step = {"cycle": label, "decision": rec["decision"],
                "index": rec["index"], "mode": rec["mode"],
                "outcome": rec["outcome"], "reason": rec["reason"],
                "wall_s": wall, "launches": launches,
                "records": len(recs)}
        if twin_step is not None:
            t0 = time.perf_counter()
            twin_step(rec["mode"])
            step["twin_wall_s"] = time.perf_counter() - t0
            split["twin"] += step["twin_wall_s"]
            mine = step["digests"] = digests()
            t0 = time.perf_counter()
            theirs = bucket_digests(twin, P_INDEX)
            split["digests"] += time.perf_counter() - t0
            if mine != theirs:
                raise AssertionError(f"phase P cycle {label}: the digests "
                                     f"differ from the twin's")
        out["cycles"].append(step)
        print(f"phase P cycle {label}: {rec['decision']} {rec['index']} "
              f"{rec['mode'] or '-'} {rec['outcome']}, wall {wall:.3f} s, "
              f"launches {json.dumps(launches)}"
              + (f", twin {step['twin_wall_s']:.3f} s" if twin_step else "")
              + f"; {rec['reason']}", flush=True)
        return step

    def refresh_twin(mode: str) -> None:
        twin.refresh_index(P_INDEX, mode)

    def optimize_twin(mode: str) -> None:
        twin.optimize_index(P_INDEX, mode)

    oracle: dict = {}

    def check(label: str, through_index: bool = False,
              names=P_QUERIES) -> None:
        state = sorted((n, len(c["l_orderkey"])) for n, c in files.items())
        t0 = time.perf_counter()
        if oracle.get("state") != state:
            oracle.update(state=state, want=p_expected(orders, files))
        split["oracle"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        out["cycles"][-1].setdefault("query_ms", {})[label] = p_check(
            label, session, root, oracle["want"], through_index, names)
        split["queries"] += time.perf_counter() - t0

    # 1. Unchanged: detection alone.
    entry = session.index_collection_manager.get_index(P_INDEX)
    t0 = time.perf_counter()
    detect_changes(session, entry)
    out["detect_ms"] = (time.perf_counter() - t0) * 1e3
    cycle(0)
    check("unchanged", through_index=True)
    # 2. One file appended: metadata only, hybrid scan serves it.
    p_append(src, staging, files, 0, 1, P_SEED)
    cycle(1, refresh_twin)
    check("quick", through_index=True)
    # 3. Eight more: past the quick budget; every bucket gains a file.
    p_append(src, staging, files, 1, 8, P_SEED + 1)
    step = cycle(2, refresh_twin)
    per_bucket = {len(v) for v in step["digests"].values()}
    if per_bucket != {2}:
        raise AssertionError(f"phase P: files per bucket {per_bucket}")
    check("incremental", through_index=True)
    # 4. Compaction on, nothing changed: the optimize rung.
    session.conf.lifecycle_compaction_enabled = True
    cycle(3, optimize_twin)
    check("optimize", through_index=True)
    # 5. Deletes and a rewrite in place: merge debt, the delete overlay.
    import pyarrow.parquet as pq

    p_delete(src, files, P_DELETED)
    name = f"part-{P_REWRITTEN:05d}.parquet"
    kept = ROWS_PER_FILE - P_REWRITE_DROP
    p_write(src, staging, name,
            pq.read_table(os.path.join(src, name)).slice(0, kept))
    files[name] = p_columns(li, P_REWRITTEN, kept)
    cycle(4, refresh_twin)
    check("cdc quick", through_index=True)
    # 6. Twelve more deleted: the merge debt outgrows its budget.
    p_delete(src, files, P_DELETED_AGAIN)
    before = cycle(5, refresh_twin)["digests"]
    check("merge debt", through_index=True)
    # 7. Bit rot in one index file, found by a full verify: repair.  The
    #    repair rebuilds the bucket from the recorded snapshot in source
    #    order, where the damaged file held the refreshes' merge order:
    #    rows with equal keys may swap, so the bucket is held to its rows
    #    and its key order, and every other bucket to its sha256.
    victim = sorted(f.name for f in session.index_collection_manager
                    .get_index(P_INDEX).content.file_infos())[0]
    bucket = bucket_id_of_file(victim)
    rows_before = p_bucket_rows(hs, bucket)
    flip_byte(victim)
    t0 = time.perf_counter()
    flagged = [r for r in hs.verify_index(P_INDEX, "full").to_pylist()
               if r["quarantined"]]
    out["verify_full_s"] = time.perf_counter() - t0
    if [r["file"] for r in flagged] != [victim]:
        raise AssertionError(f"phase P verify: {flagged}")
    cycle(6)
    after = digests()
    changed = sorted(b for b in set(before) | set(after)
                     if before.get(b) != after.get(b))
    rows_after = p_bucket_rows(hs, bucket)
    keys = rows_after["l_orderkey"]
    if changed not in ([], [bucket]) or np.any(keys[1:] < keys[:-1]) \
            or p_sorted(rows_after) != p_sorted(rows_before):
        a, b = p_sorted(rows_before), p_sorted(rows_after)
        raise AssertionError(
            f"phase P repair: buckets {changed} changed; bucket {bucket}: "
            f"{len(a)} rows before, {len(b)} after, columns "
            f"{[(c, str(v.dtype)) for c, v in sorted(rows_before.items())]} "
            f"-> {[(c, str(v.dtype)) for c, v in sorted(rows_after.items())]}"
            f", key order {not np.any(keys[1:] < keys[:-1])}, "
            f"{len(set(a) - set(b))} rows only before (e.g. "
            f"{sorted(set(a) - set(b))[:3]}), {len(set(b) - set(a))} only "
            f"after (e.g. {sorted(set(b) - set(a))[:3]})")
    out["repair"] = {"bucket": bucket, "rows": len(keys),
                     "bytes_equal": changed == [],
                     "verify_full_s": out["verify_full_s"]}
    check("repair", through_index=True)
    # 8. Churn past half the recorded files: a full rebuild.
    survivors = sorted(n for n in files if n.startswith("part-0"))
    churn = [int(n[5:10]) for n in survivors[:-(-len(files) // 2)]]
    p_delete(src, files, churn)
    cycle(7, refresh_twin)
    check("full", through_index=True)
    # 9. The advisor: phase D's shapes captured (q3 four times, as often
    #    as phase O's workload joins orders), a budget, then a cold index
    #    and a budget under the total.
    session.conf.advisor_capture_enabled = True
    check("capture")
    for _ in range(3):
        check("capture q3", names=("q3",))
    out["recommendations"] = hs.recommend_indexes(top_k=5).to_pylist()
    for r in out["recommendations"]:
        print(f"phase P recommend: {json.dumps(r)}", flush=True)
    session.conf.lifecycle_byte_budget = 1 << 40
    created = cycle(8)
    check("advisor create")
    hs.create_index(session.read.parquet(src),
                    IndexConfig(P_COLD, ["l_shipdate"], ["l_quantity"]))
    total = sum(sum(f.size for f in e.content.file_infos())
                for e in session.index_collection_manager.get_indexes(
                    ["ACTIVE"]))
    session.conf.lifecycle_byte_budget = total - 1
    deleted = cycle(9)
    if deleted["index"] != P_COLD:
        raise AssertionError(f"phase P: the advisor dropped {deleted}")
    session.conf.advisor_capture_enabled = False
    session.conf.lifecycle_byte_budget = 0
    out["advisor"] = {"created": created["index"], "deleted": P_COLD,
                      "budget": total - 1}

    # The lease: a second session over the same system path stands by
    # until the first releases.
    session.conf.lifecycle_lease_enabled = True
    hs.maintenance_cycle()
    other = HyperspaceSession(system_path=session.conf.system_path,
                              device=dev)
    set_min_rows(other, 0)
    other.conf.lifecycle_lease_enabled = True
    from hyperspace_tpu_torch import Hyperspace

    hs2 = Hyperspace(other)
    standby = hs2.maintenance_cycle()
    if [r["outcome"] for r in standby] != ["skipped"] \
            or "lease standby" not in standby[0]["reason"]:
        raise AssertionError(f"phase P lease: {standby}")
    t0 = time.perf_counter()
    hs.stop_maintenance()
    taken = hs2.maintenance_cycle()
    out["lease_handoff_ms"] = (time.perf_counter() - t0) * 1e3
    if any(r["outcome"] == "skipped" for r in taken):
        raise AssertionError(f"phase P lease handoff: {taken}")
    hs2.stop_maintenance()
    out["lease_standby"] = standby[0]["reason"]
    print(f"phase P lease: {standby[0]['reason']}; handoff "
          f"{out['lease_handoff_ms']:.1f} ms", flush=True)

    # Staleness: the daemon thread with a long interval and the watch on;
    # hybrid scan off, so the append is an incremental refresh run by the
    # thread on the card.
    session.conf.hybrid_scan_enabled = False
    session.conf.lifecycle_enabled = True
    session.conf.lifecycle_interval_s = P_INTERVAL_S
    session.conf.watch_enabled = True
    session.conf.watch_mode = "auto"
    n_before = len(journal.records(session.conf))
    kernels.reset_launch_counts()
    daemon = hs.start_maintenance()
    deadline = time.monotonic() + 60.0
    while len(journal.records(session.conf)) <= n_before + 1:
        if time.monotonic() > deadline:
            raise AssertionError("phase P: the daemon's first cycle never "
                                 "journaled")
        time.sleep(0.01)
    watcher = daemon.watcher()
    out["watch_mode"] = watcher.mode if watcher is not None else "none"
    n_before = len(journal.records(session.conf))
    t_rename = p_append(src, staging, files, 9, 1, P_SEED + 2)
    if out["watch_mode"] == "store":
        from hyperspace_tpu_torch.io import watch

        watch.publish(session.conf, src, detail="p append")
    done = None
    while done is None:
        if time.monotonic() > deadline + P_INTERVAL_S:
            raise AssertionError("phase P: the append was never refreshed")
        done = next((r for r in journal.records(session.conf)[n_before:]
                     if r["decision"] == "refresh"
                     and r["outcome"] == "done"), None)
        time.sleep(0.005)
    hs.stop_maintenance()
    out["staleness_s"] = done["ts"] - t_rename
    out["staleness_mode"] = done["mode"]
    out["staleness_launches"] = kernels.launch_counts()
    if out["staleness_s"] >= P_STALENESS_LIMIT_S:
        raise AssertionError(f"phase P staleness {out['staleness_s']:.3f} s")
    if cuda and not all(out["staleness_launches"].values()):
        raise AssertionError(f"phase P: the daemon thread's refresh "
                             f"launched {out['staleness_launches']}")
    session.conf.lifecycle_enabled = False
    session.conf.watch_enabled = False
    check("after the daemon thread")
    print(f"phase P staleness: {out['staleness_s']:.3f} s from the rename "
          f"to the journal's {done['mode']} done (watch "
          f"{out['watch_mode']}, interval {P_INTERVAL_S:.0f} s), launches "
          f"{json.dumps(out['staleness_launches'])}", flush=True)

    # A real allocation error of the card inside the daemon's refresh:
    # journaled, then raised out of the cycle.
    original = ops_hash.hash_buckets

    def card_error(*a, **kw):
        torch.empty(1 << 50, dtype=torch.uint8, device=dev)
        return original(*a, **kw)

    p_append(src, staging, files, 10, 1, P_SEED + 3)
    n_before = len(journal.records(session.conf))
    ops_hash.hash_buckets = card_error
    try:
        hs.maintenance_cycle()
    except RuntimeError as e:
        device_error = e
    else:
        raise AssertionError("phase P: the card's error was swallowed")
    finally:
        ops_hash.hash_buckets = original
    rec = p_record(journal.records(session.conf)[n_before:], "refresh",
                   "incremental")
    if rec["outcome"] != "error" or rec["error"] != str(device_error)[:500]:
        raise AssertionError(f"phase P device error journaled as {rec}")
    out["device_error"] = f"{type(device_error).__name__}: " \
        f"{str(device_error).splitlines()[0][:160]}"
    session.conf.auto_recovery_enabled = True
    recovered = p_record(hs.maintenance_cycle(), "refresh", "incremental")
    if recovered["outcome"] != "done":
        raise AssertionError(f"phase P after the device error: {recovered}")
    check("after the device error")
    print(f"phase P device error inside the daemon's refresh journaled and "
          f"propagated: {out['device_error']}", flush=True)
    out["launches"] = {k: sum(c["launches"][k] for c in out["cycles"])
                       for k in out["cycles"][0]["launches"]}
    for c in out["cycles"]:
        c.pop("digests", None)
    out["journal_records"] = len(journal.records(session.conf))
    out["wall_s"] = time.perf_counter() - t_phase
    device_cache().clear()
    return out


_PROM_SAMPLE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[a-zA-Z_][a-zA-Z0-9_]*="[^"]*"\})? '
    r'(-?[0-9.]+(?:[eE][-+]?[0-9]+)?|[-+]?Inf|NaN)( # .*)?$')


def prometheus_families(text: str) -> dict:
    """family -> type of a Prometheus text exposition, raising on a line
    that is neither a well-formed HELP/TYPE comment nor a sample of a
    family whose TYPE came before it."""
    kinds: dict = {}
    for line in text.splitlines():
        if line.startswith("# HELP "):
            if len(line.split(" ", 3)) < 4:
                raise AssertionError(f"phase Q: bad HELP line {line!r}")
            continue
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(" ")
            if kind not in ("counter", "gauge", "histogram"):
                raise AssertionError(f"phase Q: bad TYPE line {line!r}")
            kinds[name] = kind
            continue
        m = _PROM_SAMPLE.match(line)
        if m is None:
            raise AssertionError(f"phase Q: bad sample line {line!r}")
        name = m.group(1)
        family = re.sub(r"_(bucket|sum|count)$", "", name) \
            if name not in kinds else name
        if family not in kinds:
            raise AssertionError(f"phase Q: sample {name} before its TYPE")
    return kinds


def q_event_calls(dev, queries: dict) -> dict:
    """Each query once under ``torch.profiler``: the host calls of
    Q_EVENT_CALLS it made (by prefix: CUDA 12's runtime records through
    ``cudaEventRecordWithFlags``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for ds in queries.values():
            ds.collect()
    counts = {name: 0 for name in Q_EVENT_CALLS}
    for e in prof.events():
        for name in Q_EVENT_CALLS:
            if e.name.startswith(name):
                counts[name] += 1
    return counts


def phase_q(orders: dict, li: dict, root: str, dev) -> dict:
    """Telemetry on the card (see the module docstring): a traced SF1
    spill build and phase D's queries with the timeline on, their seams,
    export, ledger and exposition checked; the profiler's view of the
    seams off and on; then Q_PAIRS interleaved off/on pairs of the build
    and of the queries."""
    from hyperspace_tpu_torch import HyperspaceSession, IndexConfig
    from hyperspace_tpu_torch.ops import kernels
    from hyperspace_tpu_torch.telemetry import metrics, timeline, trace

    t_phase = time.perf_counter()
    src = os.path.join(root, "lineitem")
    session = HyperspaceSession(system_path=os.path.join(root, "indexes"),
                                device=dev)
    session.conf.num_buckets = NUM_BUCKETS
    set_min_rows(session, 0)
    session.enable_hyperspace()
    queries = build_queries(session, root, aggregates=True)
    for name, ds in queries.items():
        scans = sorted(n for n, _ in index_scans(ds.optimized_plan()))
        if scans != query_indexes(name):
            raise AssertionError(f"phase Q {name}: plan scans {scans}, "
                                 f"expected {query_indexes(name)}")
    expected = {**expected_answers(orders, li),
                **expected_aggregates(orders, li)}
    sink = trace.add_sink(trace.CollectingTraceSink())
    n_build = [0]

    def build(on: bool):
        """One SF1 spill build of Q_INDEX into a fresh system path."""
        n_build[0] += 1
        hs = spill_session(dev, os.path.join(root, f"q_tel_{n_build[0]}"))
        (timeline.enable_timeline if on else timeline.disable_timeline)()
        (trace.enable_tracing if on else trace.disable_tracing)()
        try:
            return hs, timed_build(dev, f"Q build {'on' if on else 'off'}",
                                   hs, lambda: hs.create_index(
                                       hs.session.read.parquet(src),
                                       IndexConfig(Q_INDEX, INDEXED,
                                                   INCLUDED)),
                                   -(-N_LINEITEM // DEFAULT_BATCH_ROWS))
        finally:
            timeline.disable_timeline()
            trace.disable_tracing()

    try:
        # 1. The checked run: one build and every query, timeline on.
        device_cache().clear()
        timeline.reset()
        metrics.reset()
        kernels.reset_launch_counts()
        hs, checked = build(True)
        sink.reset()
        timeline.enable_timeline()
        trace.enable_tracing()
        try:
            for name, ds in queries.items():
                want, keys = expected[name]
                require_rows(f"phase Q {name}", ds.collect(), want, keys,
                             AGG_RTOL if name in AGG_QUERIES else 0.0)
                check_routes("timeline on", name, "device",
                             session.last_execution_stats)
        finally:
            timeline.disable_timeline()
            trace.disable_tracing()
        launches = kernels.launch_counts()
        snap = metrics.snapshot()
        route = snap.get("exec.kernel.route_partition.device_ms")
        # One seam per chunk; on the card timed_build held each kernel to
        # one launch per chunk.
        chunks = -(-N_LINEITEM // DEFAULT_BATCH_ROWS)
        if not isinstance(route, dict) or route["count"] != chunks:
            raise AssertionError(f"phase Q: route_partition seam samples "
                                 f"{route}, chunks {chunks}")
        spill_route_ms = checked["report"]["phases_s"]["spill_route"] * 1e3
        if not 0 < route["sum"] <= spill_route_ms:
            raise AssertionError(f"phase Q: route seams {route['sum']} ms "
                                 f"against spill_route {spill_route_ms} ms")
        seams = {k[len("exec.kernel."):-len(".device_ms")]:
                 {"count": v["count"], "sum_ms": v["sum"],
                  "max_ms": v["max"]}
                 for k, v in snap.items() if k.startswith("exec.kernel.")}
        for seam in ("filter", "join", "join_agg", "aggregate"):
            if seam not in seams:
                raise AssertionError(f"phase Q: no {seam} seam in {seams}")
        path = os.path.join(root, "q_timeline.json")
        hs.export_timeline(path)
        with open(path, encoding="utf-8") as f:
            events = json.load(f)["traceEvents"]
        lanes = sorted({e["args"]["name"] for e in events if e["ph"] == "M"})
        memory = [e for e in events
                  if e["ph"] == "C" and e["name"] == "memory"]
        lane = f"device:{dev.index or 0}" if dev.type == "cuda" \
            else "device:-1"
        if lane not in lanes or not memory:
            raise AssertionError(f"phase Q: exported lanes {lanes}, "
                                 f"{len(memory)} memory samples")
        if dev.type == "cuda" \
                and max(e["args"]["device_live_mb"] for e in memory) <= 0:
            raise AssertionError("phase Q: no card memory sampled")
        history = hs.perf_history(index=Q_INDEX)
        if history.column("name").to_pylist() != [f"CreateAction({Q_INDEX})"]:
            raise AssertionError(f"phase Q: perf_history "
                                 f"{history.column('name').to_pylist()}")
        ledger = json.loads(history.column("recordJson")[0].as_py())
        families = prometheus_families(hs.metrics_text())
        if families.get("hyperspace_exec_kernel_route_partition_device_ms") \
                != "histogram":
            raise AssertionError("phase Q: no route_partition histogram in "
                                 "the exposition")
        # One query.collect root per query (the bucketed join's worker
        # threads deliver their own roots beside them).
        traced = [r for r in sink.spans if r.name == "query.collect"]
        if len(traced) != len(queries):
            raise AssertionError(f"phase Q: {len(traced)} traced queries")
        # 2. The seams' events under the profiler, off then on.
        events_off = q_event_calls(dev, queries)
        timeline.enable_timeline()
        try:
            events_on = q_event_calls(dev, queries)
        finally:
            timeline.disable_timeline()
        if any(events_off.values()) or not all(events_on.values()):
            raise AssertionError(f"phase Q: event calls off {events_off}, "
                                 f"on {events_on}")
        # 3. The overhead: interleaved off/on pairs, queries warm.
        walls: dict = {"build_off_s": [], "build_on_s": [],
                       "queries_off_ms": [], "queries_on_ms": []}
        for _ in range(Q_PAIRS):
            for on in (False, True):
                _hs, b = build(on)
                walls["build_on_s" if on else "build_off_s"].append(
                    b["wall_s"])
                shutil.rmtree(_hs.session.conf.system_path,
                              ignore_errors=True)
        for ds in queries.values():
            ds.collect()  # warm: every pair reads resident columns
        for _ in range(Q_PAIRS):
            for on in (False, True):
                (timeline.enable_timeline if on
                 else timeline.disable_timeline)()
                (trace.enable_tracing if on else trace.disable_tracing)()
                try:
                    ms = sum(wall_ms(ds.collect) for ds in queries.values())
                finally:
                    timeline.disable_timeline()
                    trace.disable_tracing()
                walls["queries_on_ms" if on else "queries_off_ms"].append(ms)
                sink.reset()
    finally:
        trace.remove_sink(sink)
        timeline.disable_timeline()
        trace.disable_tracing()
        timeline.reset()
        device_cache().clear()
    med = {k: statistics.median(v) for k, v in walls.items()}
    return {"launches": launches, "build_launches": checked["launches"],
            "build": {k: v for k, v in checked.items() if k != "report"},
            "build_report": checked["report"],
            "route_partition_seam_ms": route["sum"],
            "route_partition_seams": route["count"],
            "spill_route_ms": spill_route_ms, "seams": seams,
            "exported_events": len(events), "exported_lanes": lanes,
            "memory_samples": len(memory),
            "ledger_keys": sorted(ledger), "families": len(families),
            "event_calls_off": events_off, "event_calls_on": events_on,
            "walls": walls, "medians": med,
            "build_on_over_off": med["build_on_s"] / med["build_off_s"],
            "queries_on_over_off":
                med["queries_on_ms"] / med["queries_off_ms"],
            "phase_s": time.perf_counter() - t_phase}


def r_sneaky_filter():
    """Patch ``ops.filter.compile_predicate`` so every predicate program
    first reads one value back with an unattributed ``.item()``; returns
    the original, to put back."""
    from hyperspace_tpu_torch.ops import filter as ops_filter

    orig = ops_filter.compile_predicate

    def sneaky(expr, order):
        fn, lits = orig(expr, order)

        def bad_fn(cols, literals):
            cols[0][0].item()  # the unattributed sync
            return fn(cols, literals)

        return bad_fn, lits

    ops_filter.compile_predicate = sneaky
    return orig


def r_decisions(session) -> list:
    return [d.get("kind") for d in session.last_run_report_value.decisions]


def r_grades(hs) -> dict:
    return {c.name: c.status for c in hs.doctor().checks}


def r_require_grade(label: str, grades: dict, check: str, want: str) -> None:
    if grades.get(check) != want:
        raise AssertionError(f"phase R {label}: doctor {check} "
                             f"{grades.get(check)}, expected {want} "
                             f"({grades})")


def phase_r(orders: dict, li: dict, root: str, dev) -> dict:
    """The query-path guards and diagnostics at SF1 (see the module
    docstring)."""
    import pyarrow as pa

    from hyperspace_tpu_torch import Hyperspace, HyperspaceSession
    from hyperspace_tpu_torch import IndexConfig
    from hyperspace_tpu_torch.config import HyperspaceConf
    from hyperspace_tpu_torch.exceptions import (
        DeadlineExceededError,
        DeviceSyncError,
    )
    from hyperspace_tpu_torch.execution import plan_cache as pc
    from hyperspace_tpu_torch.execution import sync_guard
    from hyperspace_tpu_torch.ops import filter as ops_filter
    from hyperspace_tpu_torch.ops import kernels
    from hyperspace_tpu_torch.telemetry import (
        flight_recorder,
        metrics,
        timeline,
        trace,
    )
    from hyperspace_tpu_torch.utils import deadline

    t_phase = time.perf_counter()
    cuda = dev.type == "cuda"
    src = os.path.join(root, R_SOURCE)
    shutil.copytree(os.path.join(root, "lineitem"), src,
                    copy_function=os.link)
    session = HyperspaceSession(system_path=os.path.join(root, "indexes"),
                                device=dev)
    session.conf.num_buckets = NUM_BUCKETS
    set_min_rows(session, 0)
    session.conf.flight_recorder_slow_ms = R_SLOW_MS
    session.enable_hyperspace()
    hs = Hyperspace(session)
    queries = build_queries(session, root, aggregates=True)
    expected = {**expected_answers(orders, li),
                **expected_aggregates(orders, li)}
    chunks = -(-N_LINEITEM // DEFAULT_BATCH_ROWS)
    config = IndexConfig(R_INDEX, INDEXED, INCLUDED)
    out: dict = {}
    steps: dict = {}
    mark = [time.perf_counter()]

    def step(label: str) -> None:
        """Close the step running since the last mark."""
        now = time.perf_counter()
        steps[label] = now - mark[0]
        mark[0] = now

    answers: dict = {}

    def check(label: str, name: str, table) -> None:
        """``table`` equal to numpy's answer: to the first checked one's
        table when equal to it (a cheap equality instead of sorting
        millions of rows again), else against numpy itself."""
        if name in answers and table.equals(answers[name]):
            return
        want, keys = expected[name]
        require_rows(f"phase R {label} {name}", table, want, keys,
                     AGG_RTOL if name in AGG_QUERIES else 0.0)
        answers.setdefault(name, table)

    def snap(name: str) -> float:
        return float(metrics.snapshot().get(name, 0.0) or 0.0)

    try:
        metrics.reset()
        flight_recorder.reset()
        sync_guard.arm(HyperspaceConf(), dev)  # off: the reference build
        ref = spill_session(dev, os.path.join(root, "r_ref"))
        timed_build(dev, "R reference build", ref, lambda: ref.create_index(
            ref.session.read.parquet(src), config), chunks)
        want_digests = bucket_digests(ref, R_INDEX)
        shutil.rmtree(ref.session.conf.system_path, ignore_errors=True)
        step("setup_and_reference_build")

        # The unpatched baseline: the seven warm queries before the first
        # arming patches torch.Tensor (the off/armed pairs below both run
        # patched).  Taken only where nothing installed the patch yet.
        unpatched_ms = None
        if not sync_guard._patched:
            for ds in queries.values():
                ds.collect()  # warm
            unpatched_ms = [sum(wall_ms(ds.collect)
                                for ds in queries.values())
                            for _ in range(R_PAIRS)]
        step("unpatched_baseline")

        # 1. Strict mode: the first collect arms the guard.
        session.conf.device_guard_enabled = True
        check("arming", "point", queries["point"].collect())
        if not sync_guard.armed():
            raise AssertionError("phase R: the first collect did not arm "
                                 "the guard")
        hs_r = spill_session(dev, os.path.join(root, "r_indexes"),
                             device_guard_enabled=True)
        timeline.enable_timeline()
        try:
            strict = timed_build(
                dev, "R strict build", hs_r, lambda: hs_r.create_index(
                    hs_r.session.read.parquet(src), config), chunks)
        finally:
            timeline.disable_timeline()
        d2h = snap("exec.transfer.d2h.bytes")
        d2h_floor = N_LINEITEM * 8 + chunks * SPILL_BUCKETS * 4
        if d2h < d2h_floor:
            raise AssertionError(f"phase R: d2h bytes {d2h} under the "
                                 f"chunks' permutations and counts "
                                 f"{d2h_floor}")
        if bucket_digests(hs_r, R_INDEX) != want_digests:
            raise AssertionError("phase R: the strict build's buckets "
                                 "differ from the unguarded build's")
        launches = dict(strict["launches"])
        step("strict_build")
        v0 = snap("guard.sync.violations")
        a0 = snap("guard.sync.attributed")
        kernels.reset_launch_counts()
        q_ms: dict = {}
        for name, ds in queries.items():
            device_cache().clear()
            t0 = time.perf_counter()
            table = ds.collect()
            cold = (time.perf_counter() - t0) * 1e3
            check("strict cold", name, table)
            check_routes("strict", name, "device",
                         session.last_execution_stats)
            t0 = time.perf_counter()
            table = ds.collect()
            q_ms[name] = {"cold_ms": cold,
                          "warm_ms": (time.perf_counter() - t0) * 1e3}
            check("strict warm", name, table)
        query_launches = kernels.launch_counts()
        if any(query_launches.values()):
            raise AssertionError(f"phase R: the queries launched "
                                 f"{query_launches}")
        step("strict_queries")
        violations = snap("guard.sync.violations") - v0
        attributed = snap("guard.sync.attributed") - a0
        if violations != 0 or attributed <= 0:
            raise AssertionError(f"phase R: strict queries counted "
                                 f"{violations} violations, {attributed} "
                                 f"attributed read-backs")
        orig = r_sneaky_filter()
        try:
            try:
                queries["point"].collect()
            except DeviceSyncError as e:
                injected = str(e)
            else:
                raise AssertionError("phase R: the injected .item() was "
                                     "not caught")
        finally:
            ops_filter.compile_predicate = orig
        kinds = r_decisions(session)
        if {"replan", "degraded", "quarantine"} & set(kinds) \
                or "containment" in (session.last_execution_stats or {}):
            raise AssertionError(f"phase R: the violation was contained: "
                                 f"{kinds}")
        if snap("guard.sync.violations") - v0 != 1:
            raise AssertionError("phase R: the injected .item() counted "
                                 "no violation")
        step("injected")
        pairs: dict = {"off_ms": [], "armed_ms": []}
        for _ in range(R_PAIRS):
            for armed in (False, True):
                session.conf.device_guard_enabled = armed
                ms = sum(wall_ms(ds.collect) for ds in queries.values())
                pairs["armed_ms" if armed else "off_ms"].append(ms)
        session.conf.device_guard_enabled = True
        step("overhead_pairs")
        out["strict"] = {
            "build_wall_s": strict["wall_s"], "build_launches": launches,
            "d2h_bytes": d2h, "d2h_floor": d2h_floor,
            "attributed": attributed, "violations": violations,
            "queries": q_ms, "injected": injected[:80],
            "pairs": pairs, "unpatched_ms": unpatched_ms,
            "armed_over_off": statistics.median(pairs["armed_ms"])
            / statistics.median(pairs["off_ms"]),
            "off_over_unpatched": statistics.median(pairs["off_ms"])
            / statistics.median(unpatched_ms) if unpatched_ms else None}

        # 2. The plan cache.
        cache = pc.PlanCache()
        passes = []
        for _ in range(2):
            ms = 0.0
            for name, ds in queries.items():
                t0 = time.perf_counter()
                table = ds.collect(plan_cache=cache)
                ms += (time.perf_counter() - t0) * 1e3
                check("plan cache", name, table)
            passes.append(ms)
        stats = cache.stats()
        if stats["hits"] != len(queries) or stats["misses"] != len(queries):
            raise AssertionError(f"phase R: plan cache {stats}")
        optimize_ms = {}
        for name, ds in queries.items():
            runs = []
            for _ in range(R_PLAN_RUNS):
                t0 = time.perf_counter()
                ds.optimized_plan()
                runs.append((time.perf_counter() - t0) * 1e3)
            optimize_ms[name] = statistics.median(runs)
        g0, stale0 = pc.current_generation(), snap("serve.plan_cache.stale")
        hs_r.delete_index(R_INDEX)  # one committed action
        if pc.current_generation() != g0 + 1:
            raise AssertionError("phase R: the action bumped no generation")
        check("stale", "q3", queries["q3"].collect(plan_cache=cache))
        hit = [d["hit"] for d in session.last_run_report_value.decisions
               if d.get("kind") == "plan_cache"]
        if hit != [False] or snap("serve.plan_cache.stale") != stale0 + 1:
            raise AssertionError(f"phase R: after the action the lookup "
                                 f"was {hit}, stale "
                                 f"{snap('serve.plan_cache.stale') - stale0}")
        hs_r.restore_index(R_INDEX)
        step("plan_cache")
        out["plan_cache"] = {"miss_pass_ms": passes[0],
                             "hit_pass_ms": passes[1], "stats": stats,
                             "optimize_ms": optimize_ms,
                             "saved_ms": sum(optimize_ms.values())}

        # 3. Deadlines.
        q3 = queries["q3"]
        t0 = time.perf_counter()
        try:
            with deadline.scope(0.001):
                q3.collect()
        except DeadlineExceededError as e:
            expired = str(e)
        else:
            raise AssertionError("phase R: q3 beat a 1 ms deadline")
        expired_ms = (time.perf_counter() - t0) * 1e3
        kinds = r_decisions(session)
        if {"replan", "degraded", "quarantine"} & set(kinds):
            raise AssertionError(f"phase R: the deadline was contained: "
                                 f"{kinds}")
        trace.enable_tracing()
        try:
            t0 = time.perf_counter()
            with deadline.scope(60.0):
                table = q3.collect()
            within_ms = (time.perf_counter() - t0) * 1e3
        finally:
            trace.disable_tracing()
        check("deadline 60 s", "q3", table)
        step("deadline")
        out["deadline"] = {"expired": expired, "expired_ms": expired_ms,
                           "within_ms": within_ms}

        # 4. The flight recorder.
        rec = flight_recorder.recorder().records()[-1]
        tid = rec["trace_id"]
        if rec["kind"] != "local" or rec["outcome"] != "ok" \
                or rec["reason"] != "slow" or not rec["spans"]:
            raise AssertionError(f"phase R: q3's record {rec['kind']} "
                                 f"{rec['outcome']} {rec['reason']}")
        slow = hs.slow_queries()
        if tid not in slow.column("traceId").to_pylist() \
                or hs.trace(tid)["trace_id"] != tid:
            raise AssertionError("phase R: q3 not found by trace id")
        path = os.path.join(root, "r_trace.json")
        hs.export_timeline(path, trace_id=tid)
        with open(path, encoding="utf-8") as f:
            names = {e["name"] for e in json.load(f)["traceEvents"]}
        if "query.collect" not in names:
            raise AssertionError(f"phase R: exported {sorted(names)[:8]}")
        # Kept as errors: the injected .item()'s query and the expired q3.
        errors = [r for r in flight_recorder.recorder().records()
                  if r["outcome"] == "error"]
        if len(errors) != 2 or any(r["reason"] != "error" for r in errors):
            raise AssertionError(f"phase R: {len(errors)} error records")
        flight_recorder.clear_bundles(session.conf)
        key = hs.dump_diagnostics()
        bundles = hs.diagnostics_bundles()
        if [b["key"] for b in bundles] != [key] \
                or not bundles[0]["records"] or not bundles[0]["metrics"]:
            raise AssertionError(f"phase R: bundles "
                                 f"{[b.get('key') for b in bundles]}")
        step("flight_recorder")
        out["flight"] = {"records": slow.num_rows, "errors": len(errors),
                         "trace_id": tid, "exported_events": len(names),
                         "bundle_records": len(bundles[0]["records"]),
                         "bundle_metrics": len(bundles[0]["metrics"])}

        # 5. The doctor.
        grades = {"clean": r_grades(hs_r)}
        for c in ("integrity", "staleness"):
            r_require_grade("clean", grades["clean"], c, "ok")
        entry = hs_r.session.index_collection_manager.get_index(R_INDEX)
        victim = sorted(f.name for f in entry.content.file_infos())[0]
        flip_byte(victim)
        full = hs_r.verify_index(R_INDEX, "full")
        flagged = [f for f, st in zip(full.column("file").to_pylist(),
                                      full.column("status").to_pylist())
                   if st != "ok"]
        if flagged != [victim]:
            raise AssertionError(f"phase R: verify flagged {flagged}")
        grades["damaged"] = r_grades(hs_r)
        r_require_grade("damaged", grades["damaged"], "integrity", "crit")
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        hs_r.refresh_index(R_INDEX, "repair")
        repair_s = time.perf_counter() - t0
        repair = kernels.launch_counts()
        if cuda:
            require_launches("phase R repair", repair,
                             {k: 1 for k in repair})
        launches = {k: launches[k] + repair[k] for k in launches}
        grades["repaired"] = r_grades(hs_r)
        r_require_grade("repaired", grades["repaired"], "integrity", "ok")
        cols = gen_lineitem(np.random.default_rng(171), R_APPENDED_ROWS)
        staging = os.path.join(root, "r_staging")
        os.makedirs(staging)
        p_write(src, staging, "part-95000.parquet", pa.table(cols))
        grades["appended"] = r_grades(hs_r)
        r_require_grade("appended", grades["appended"], "staleness", "warn")
        hs_r.session.conf.hybrid_scan_enabled = True  # a quick refresh
        kernels.reset_launch_counts()
        recs = hs_r.maintenance_cycle()
        cycle_launches = kernels.launch_counts()
        if [(r["decision"], r["mode"], r["outcome"]) for r in recs] \
                != [("refresh", "quick", "done")] \
                or any(cycle_launches.values()):
            raise AssertionError(f"phase R: maintenance cycle {recs}, "
                                 f"launches {cycle_launches}")
        maint = [r for r in flight_recorder.recorder().records()
                 if r["kind"] == "maintenance"]
        if len(maint) != 1 or maint[0]["outcome"] != "OK":
            raise AssertionError(f"phase R: maintenance records {maint}")
        grades["maintained"] = r_grades(hs_r)
        r_require_grade("maintained", grades["maintained"], "staleness",
                        "ok")
        step("doctor")
        out["doctor"] = {"grades": grades, "repair_s": repair_s,
                         "repair_launches": repair,
                         "maintenance_ms": maint[0]["latency_ms"]}
        out["launches"] = launches
    finally:
        sync_guard.arm(HyperspaceConf(), dev)  # later phases run unguarded
        timeline.disable_timeline()
        trace.disable_tracing()
        device_cache().clear()
    out["steps_s"] = steps
    out["phase_s"] = time.perf_counter() - t_phase
    return out


S_SOURCE = "s_lineitem"         # a hard-linked copy of phase C's lineitem
S_INDEX = "s_li"                # phase S's SF1 index on the object-store log
S_STALE_MS = 60_000.0           # the listing window: nothing lists in it
S_SEED = 191                    # the appended files' rows
S_COMMITS = 50                  # timed log commits per store
S_OBJECT_CONF = {
    "log_manager_class":
        "hyperspace_tpu_torch.index.object_log_manager.ObjectStoreLogManager",
    "log_store_class": "hyperspace_tpu_torch.io.log_store.EmulatedObjectStore",
    "object_store_stale_list_ms": S_STALE_MS,
}


def s_pointer(hs) -> tuple:
    """(id, state, generation) of the object-store log's pointer."""
    mgr = hs.session.index_collection_manager._log_manager(S_INDEX)
    data, gen = mgr.store.read_with_generation("latestStable")
    entry = mgr._parse(data)
    return (None if entry is None else entry.id,
            None if entry is None else entry.state, gen)


def s_commit_ms(root: str, entry) -> dict:
    """ms per log commit (``write_log`` and the pointer's update) of
    S_COMMITS commits of ``entry`` through the object-store log on each
    store class, and through the posix log (create-if-absent and a
    rename) beside them."""
    import copy

    from hyperspace_tpu_torch.index.log_manager import IndexLogManager
    from hyperspace_tpu_torch.index.object_log_manager import (
        ObjectStoreLogManager,
    )

    out = {}
    for label, store in (("EmulatedObjectStore", "EmulatedObjectStore"),
                         ("PosixLogStore", "PosixLogStore"),
                         ("posix log (IndexLogManager)", None)):
        path = os.path.join(root, "s_commits", label.split()[0])
        if store is None:
            mgr = IndexLogManager(path)
        else:
            mgr = ObjectStoreLogManager(path)
            mgr.store_class = f"hyperspace_tpu_torch.io.log_store.{store}"
            mgr.stale_list_s = S_STALE_MS / 1000.0
        entries = [copy.deepcopy(entry) for _ in range(S_COMMITS)]
        t0 = time.perf_counter()
        for i, e in enumerate(entries, start=1):
            if not (mgr.write_log(i, e) and mgr.create_latest_stable_log(i)):
                raise AssertionError(f"phase S: commit {i} on {label} lost")
        out[label] = (time.perf_counter() - t0) * 1e3 / S_COMMITS
        if mgr.get_latest_stable_log().id != S_COMMITS:
            raise AssertionError(f"phase S: {label} pointer not at "
                                 f"{S_COMMITS}")
    shutil.rmtree(os.path.join(root, "s_commits"), ignore_errors=True)
    return out


def phase_s(orders: dict, li: dict, root: str, dev) -> dict:
    """The object store and the object-store log at SF1 (see the module
    docstring)."""
    import threading

    from hyperspace_tpu_torch import IndexConfig
    from hyperspace_tpu_torch.index.object_log_manager import (
        ObjectStoreLogManager,
    )
    from hyperspace_tpu_torch.io import faults
    from hyperspace_tpu_torch.io.parquet import bucket_id_of_file
    from hyperspace_tpu_torch.ops import kernels
    from hyperspace_tpu_torch.telemetry import metrics

    t_phase = time.perf_counter()
    cuda = dev.type == "cuda"
    src = os.path.join(root, S_SOURCE)
    shutil.copytree(os.path.join(root, "lineitem"), src,
                    copy_function=os.link)
    chunks = -(-N_LINEITEM // DEFAULT_BATCH_ROWS)
    one = {"hash_buckets": 1, "bucket_histogram": 1}
    none = {"hash_buckets": 0, "bucket_histogram": 0}
    config = IndexConfig(S_INDEX, INDEXED, INCLUDED)
    obj_path = os.path.join(root, "s_object")
    obj = spill_session(dev, obj_path, **S_OBJECT_CONF)
    twin = spill_session(dev, os.path.join(root, "s_posix"))
    launches = dict(none)
    out: dict = {}
    steps: dict = {}
    mark = [time.perf_counter()]
    pointers = []

    def step(label: str) -> None:
        now = time.perf_counter()
        steps[label] = now - mark[0]
        mark[0] = now

    def count(label: str, run, want: dict):
        """``run()`` on the object-store index, its launches required to
        be ``want`` and added to the phase's."""
        device_cache().clear()
        kernels.reset_launch_counts()
        result = run()
        got = kernels.launch_counts()
        require_launches(f"phase S {label}", got, want)
        for k, v in got.items():
            launches[k] += v
        pointers.append((label, s_pointer(obj)))
        return result

    def same_files(label: str) -> None:
        got, want = bucket_digests(obj, S_INDEX), bucket_digests(twin, S_INDEX)
        if got != want:
            bad = sorted(b for b in set(got) | set(want)
                         if got.get(b) != want.get(b))
            raise AssertionError(f"phase S {label}: buckets {bad[:8]} "
                                 f"differ from the posix twin's")

    def log_of(hs) -> tuple:
        mgr = hs.session.index_collection_manager._log_manager(S_INDEX)
        ids = mgr.log_ids()
        return ids, [None if e is None else e.state
                     for e in (mgr.get_log(i) for i in ids)]

    def quick(label: str, hs=None) -> str:
        return count(label, lambda: (hs or obj).refresh_index(
            S_INDEX, "quick").outcome, none)

    try:
        metrics.reset()
        # 1. The build, bit for bit the posix twin's.
        build = count("build", lambda: timed_build(
            dev, "S object-store build", obj, lambda: obj.create_index(
                obj.session.read.parquet(src), config), chunks),
            {k: chunks for k in none})
        twin_build = timed_build(dev, "S posix twin build", twin,
                                 lambda: twin.create_index(
                                     twin.session.read.parquet(src), config),
                                 chunks)
        same_files("build")
        mgr = obj.session.index_collection_manager._log_manager(S_INDEX)
        if not isinstance(mgr, ObjectStoreLogManager) \
                or type(mgr.store).__name__ != "EmulatedObjectStore" \
                or mgr.stale_list_s != S_STALE_MS / 1000.0:
            raise AssertionError(f"phase S: the log is {type(mgr).__name__} "
                                 f"over {type(mgr.store).__name__}")
        listed = mgr.store.list_keys()
        probed = mgr.log_ids()
        if listed != [] or probed != [1, 2]:
            raise AssertionError(f"phase S: listed {listed}, probed {probed}")
        out["build"] = {"wall_s": build["wall_s"],
                        "twin_wall_s": twin_build["wall_s"],
                        "phases": build["phases"],
                        "launches": build["launches"],
                        "listed": listed, "probed": probed}
        step("builds")

        # 2. Phase D's seven queries: the twin's answers, no launch.
        expected = {**expected_answers(orders, li),
                    **expected_aggregates(orders, li)}
        for hs in (obj, twin):
            hs.session.enable_hyperspace()
        mine = build_queries(obj.session, root, lineitem=S_SOURCE,
                             aggregates=True)
        theirs = build_queries(twin.session, root, lineitem=S_SOURCE,
                               aggregates=True)
        query_ms = {}
        for name, ds in mine.items():
            t0 = time.perf_counter()
            table = count(f"query {name}", ds.collect, none)
            query_ms[name] = (time.perf_counter() - t0) * 1e3
            want, keys = expected[name]
            require_rows(f"phase S {name}", table, want, keys,
                         AGG_RTOL if name in AGG_QUERIES else 0.0)
            if not table.equals(theirs[name].collect()):
                raise AssertionError(f"phase S {name}: the answer differs "
                                     f"from the posix twin's")
        for name in ("point", "range"):
            if [n for n, _ in index_scans(mine[name].optimized_plan())] \
                    != [S_INDEX]:
                raise AssertionError(f"phase S {name}: the plan does not "
                                     f"read {S_INDEX}")
        out["queries_ms"] = query_ms
        step("queries")

        # 3. Bit rot in the point key's bucket: quarantined through the
        # emulated store under its window, the bucket answered from the
        # source, then repaired to its former bytes.
        entry = obj.session.index_collection_manager.get_index(S_INDEX)
        infos = entry.content.file_infos()
        b = int(bucket_of(np.array([POINT_KEY]), SPILL_BUCKETS)[0])
        victims = [f.name for f in infos if bucket_id_of_file(f.name) == b]
        if len(victims) != 1:
            raise AssertionError(f"phase S: bucket {b} has {victims}")
        flip_byte(victims[0])
        t0 = time.perf_counter()
        report = obj.verify_index(S_INDEX, "full")
        verify_s = time.perf_counter() - t0
        flagged = {f: s for f, s in zip(report.column("file").to_pylist(),
                                        report.column("status").to_pylist())
                   if s != "ok"}
        qm = obj.session.index_collection_manager.quarantine_manager(S_INDEX)
        candidates = [f.name for f in infos]
        if flagged != {victims[0]: "digest-mismatch"} \
                or type(qm.store).__name__ != "EmulatedObjectStore" \
                or qm.store.list_keys() != [] \
                or qm.paths(candidates) != {victims[0]}:
            raise AssertionError(f"phase S: verify flagged {flagged}, "
                                 f"quarantine {qm.paths(candidates)}")
        point = mine["point"]
        branches = bucket_in_branches(point.optimized_plan())
        if len(branches) != 1 or branches[0].condition.buckets != (b,):
            raise AssertionError(f"phase S: {len(branches)} BucketIn "
                                 f"branches in the contained point query")
        want, keys = expected["point"]
        require_rows("phase S contained point", count(
            "contained point", point.collect,
            {"hash_buckets": 1, "bucket_histogram": 0}), want, keys)
        routes = [r["strategy"] for r in
                  obj.session.last_execution_stats.get("bucket_in", [])]
        if cuda and routes != ["device"]:
            raise AssertionError(f"phase S: BucketIn routes {routes}")
        repair = count("repair", lambda: timed_build(
            dev, "S repair", obj,
            lambda: obj.refresh_index(S_INDEX, "repair"), one), one)
        same_files("repair")
        after = obj.session.index_collection_manager.get_index(S_INDEX)
        if qm.paths([f.name for f in after.content.file_infos()]
                    + candidates) or set(
                obj.verify_index(S_INDEX, "full").column("status")
                .to_pylist()) != {"ok"}:
            raise AssertionError("phase S: the repair left a quarantined "
                                 "or damaged file")
        out["integrity"] = {"verify_full_s": verify_s,
                            "repair_wall_s": repair["wall_s"],
                            "repair_launches": repair["launches"],
                            "bucket": b}
        step("quarantine_and_repair")

        # 4. One appended file, an incremental refresh on each log.
        g_append(src, 0, 1, S_SEED)
        refresh = count("incremental refresh", lambda: timed_build(
            dev, "S incremental refresh", obj,
            lambda: obj.refresh_index(S_INDEX, "incremental"), one), one)
        timed_build(dev, "S posix twin refresh", twin,
                    lambda: twin.refresh_index(S_INDEX, "incremental"), one)
        same_files("incremental refresh")
        out["refresh"] = {"wall_s": refresh["wall_s"],
                          "launches": refresh["launches"],
                          "phases": refresh["phases"]}
        step("incremental_refresh")

        # 5. A transient fault at the pointer's swap, absorbed by the
        # retry; a torn put at a numbered entry, which burns its id, and
        # the same refresh again.  The quick refresh puts its transient
        # entry, its final entry, then the pointer: the third put.
        faulted = {}
        g_append(src, 1, 1, S_SEED + 1)
        retries0 = float(metrics.snapshot().get("io.retry.attempts", 0.0))
        before = s_pointer(obj)
        plan = faults.FaultPlan(site="store.put", kind="eio", at=3, count=1)
        faults.install(plan)
        try:
            outcome = quick("quick refresh, eio at the pointer")
        finally:
            faults.clear()
        ids, states = log_of(obj)
        ptr = s_pointer(obj)
        if outcome != "ok" or plan._fired != 1 or ptr[0] != ids[-1] \
                or ptr[2] != before[2] + 1 or states[-2:] != [
                    "REFRESHING", "ACTIVE"] \
                or float(metrics.snapshot().get("io.retry.attempts", 0.0)) \
                <= retries0:
            raise AssertionError(f"phase S: eio at the pointer: {outcome}, "
                                 f"fired {plan._fired}, ids {ids} {states}, "
                                 f"pointer {before} -> {ptr}")
        faulted["eio_at_pointer"] = {"ids": ids[-2:], "pointer": list(ptr)}
        g_append(src, 2, 1, S_SEED + 2)
        burned = ids[-1] + 1
        plan = faults.FaultPlan(site="store.put", kind="torn", at=1, count=1)
        faults.install(plan)
        try:
            crashed = count("quick refresh, torn entry", lambda: _raised_name(
                lambda: obj.refresh_index(S_INDEX, "quick")), none)
        finally:
            faults.clear()
        if crashed != "InjectedCrash" or mgr.get_log(burned) is not None \
                or mgr.get_latest_id() != burned:
            raise AssertionError(f"phase S: torn put: {crashed}, latest "
                                 f"{mgr.get_latest_id()}")
        outcome = quick("quick refresh after the torn entry")
        ids, states = log_of(obj)
        ptr = s_pointer(obj)
        if outcome != "ok" or ids[-3:] != [burned, burned + 1, burned + 2] \
                or states[-3:] != [None, "REFRESHING", "ACTIVE"] \
                or ptr[0] != burned + 2:
            raise AssertionError(f"phase S: after the torn entry {outcome}, "
                                 f"ids {ids} {states}, pointer {ptr}")
        faulted["torn_entry"] = {"burned": burned, "ids": ids[-3:],
                                 "pointer": list(ptr)}
        out["faults"] = faulted
        step("faults")

        # 6. Two sessions' incremental refreshes race after one more
        # append: both validate, both claim the next id, one wins it; the
        # loser, held until the winner has committed, rebases on its
        # entry and finds nothing left to do.  (Two quick refreshes would
        # both commit: a quick refresh records the appended files without
        # indexing them, so the rebased one still finds them, in both
        # packages.)
        g_append(src, 3, 1, S_SEED + 3)
        racers = [spill_session(dev, obj_path, **S_OBJECT_CONF)
                  for _ in range(2)]
        gate = threading.Barrier(2, timeout=60)
        first = threading.local()
        committed = threading.Event()
        write_log = ObjectStoreLogManager.write_log

        def gated(self, log_id, entry):
            if getattr(first, "seen", False):
                return write_log(self, log_id, entry)
            first.seen = True
            gate.wait()
            won = write_log(self, log_id, entry)
            if not won:
                committed.wait(60)
            return won

        results: dict = {}

        def racer(i: int) -> None:
            try:
                results[i] = racers[i].refresh_index(
                    S_INDEX, "incremental").outcome
            except BaseException as e:  # noqa: BLE001 - reported below
                results[i] = repr(e)
            finally:
                committed.set()

        conflicts0 = float(metrics.snapshot().get(
            "action.conflict.retries", 0.0))
        ObjectStoreLogManager.write_log = gated
        try:
            def race():
                threads = [threading.Thread(target=racer, args=(i,))
                           for i in range(2)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(120)
            count("race", race, one)
        finally:
            ObjectStoreLogManager.write_log = write_log
        timed_build(dev, "S posix twin refresh after the race", twin,
                    lambda: twin.refresh_index(S_INDEX, "incremental"), one)
        same_files("race")
        conflicts = float(metrics.snapshot().get(
            "action.conflict.retries", 0.0)) - conflicts0
        ids, states = log_of(obj)
        ptr = s_pointer(obj)
        if sorted(results.values()) != ["noop", "ok"] or conflicts < 1 \
                or ptr[0] != ids[-1] or states[-1] != "ACTIVE":
            raise AssertionError(f"phase S: race {results}, conflict "
                                 f"retries {conflicts}, ids {ids} "
                                 f"{states}, pointer {ptr}")
        out["race"] = {"outcomes": [results[0], results[1]],
                       "conflict_retries": conflicts, "ids": ids[-2:]}
        step("race")

        # The pointer only moved forward, one stable id after another.
        ids_seen = [p[1][0] for p in pointers]
        if any(b_ < a for a, b_ in zip(ids_seen, ids_seen[1:])):
            raise AssertionError(f"phase S: the pointer moved back: "
                                 f"{pointers}")
        out["pointer_ids"] = ids_seen
        final = mgr.get_latest_stable_log()
        out["log"] = {"ids": ids, "states": states,
                      "entry_bytes": len(mgr.store.read(str(final.id)))}
        out["commit_ms"] = s_commit_ms(root, final)
        step("commits")
        out["launches"] = launches
    finally:
        faults.clear()
        for hs in (obj, twin):
            hs.session.disable_hyperspace()
        device_cache().clear()
        shutil.rmtree(src, ignore_errors=True)
    out["steps_s"] = steps
    out["phase_s"] = time.perf_counter() - t_phase
    return out


T_WORKERS = 4                   # the server's workers (the conf default)
T_TIMED_RUNS = 1                # timed served and direct runs per query
T_CLIENTS = 8                   # step 2: concurrent clients
T_ROUNDS = 2                    # step 2: rounds of the seven per client
T_CACHE_PAIRS = 1               # step 3: miss/hit pairs per query
T_APPENDED_ROWS = 10_000        # step 4: one file appended to lineitem
T_SEED = 201                    # its rows
T_BURST = 6                     # step 5: requests past 1 running + 1 queued
T_BOUND_S = 120.0               # every wait, join and socket of phase T
T_VERBS = ("metrics", "last_run_report", "workload", "perf_history",
           "build_report", "slow_queries", "trace", "doctor", "lifecycle")


def t_specs(root: str) -> dict:
    """Phase D's seven queries as wire specs (interop/query.py): the
    twins of ``build_queries``'s Datasets."""
    li = {"format": "parquet", "path": os.path.join(root, "lineitem")}
    orders = {"format": "parquet", "path": os.path.join(root, "orders")}

    def between(c: str, lo, hi) -> dict:
        return {"op": "and", "left": {"op": ">=", "col": c, "value": lo},
                "right": {"op": "<", "col": c, "value": hi}}

    on = {"op": "==", "col": "o_orderkey", "right_col": "l_orderkey"}
    join_cols = ["o_orderkey", "o_totalprice", "l_quantity",
                 "l_extendedprice"]
    cheap = {"op": "<", "col": "o_totalprice", "value": PRICE_BELOW}
    revenue = [{"op": "*", "left": {"col": "l_extendedprice"},
                "right": {"op": "-", "left": 1,
                          "right": {"col": "l_discount"}}}, "sum"]
    return {
        "point": {"source": li, "filter": {"op": "==", "col": "l_orderkey",
                                           "value": POINT_KEY},
                  "select": ["l_orderkey", "l_quantity"]},
        "range": {"source": li, "filter": between("l_orderkey", *RANGE),
                  "select": ["l_orderkey", "l_extendedprice", "l_discount"]},
        "join": {"source": orders, "join": {"source": li, "on": on},
                 "select": join_cols},
        "filtered_join": {"source": orders, "filter": cheap,
                          "join": {"source": li, "on": on},
                          "select": join_cols},
        "q3": {"source": orders, "filter": cheap,
               "join": {"source": li, "on": on},
               "group_by": ["o_custkey"], "aggs": {"revenue": revenue},
               "sort": [["revenue", False]], "limit": Q3_TOP},
        "q10": {"source": li, "filter": between("l_shipdate", *Q10_WINDOW),
                "join": {"source": orders,
                         "on": {"op": "==", "col": "l_orderkey",
                                "right_col": "o_orderkey"}},
                "group_by": ["o_custkey"], "aggs": {"revenue": revenue},
                "sort": [["revenue", False]], "limit": Q10_TOP},
        "agg_by_priority": {
            "source": orders,
            "filter": {"op": "<", "col": "o_orderkey",
                       "value": AGG_ORDERKEY_BELOW},
            "group_by": ["o_shippriority"],
            "aggs": {"total": ["o_totalprice", "sum"],
                     "low": ["o_totalprice", "min"],
                     "high": ["o_totalprice", "max"],
                     "avg": ["o_totalprice", "mean"],
                     "n": ["o_totalprice", "count_all"]},
            "sort": ["o_shippriority"]},
    }


def t_until(cond, what: str, phase: str = "T") -> None:
    """Wait, bounded by T_BOUND_S, for what another thread makes true."""
    end = time.monotonic() + T_BOUND_S
    while not cond():
        if time.monotonic() > end:
            raise AssertionError(f"phase {phase}: timed out waiting for "
                                 f"{what}")
        time.sleep(0.002)


def t_join(threads: list, what: str, phase: str = "T") -> None:
    for t in threads:
        t.join(timeout=T_BOUND_S)
    if any(t.is_alive() for t in threads):
        raise AssertionError(f"phase {phase}: {what} hung")


def t_table_rows(table) -> dict:
    return {c: table.column(c).to_numpy() for c in table.column_names}


def t_concurrent(phase: str, address, specs: dict, check) -> dict:
    """T_CLIENTS concurrent clients over ``address``, T_ROUNDS rounds of
    ``specs`` each, each client starting at another query; every answer
    goes through ``check(label, name, table)``.  The wall, qps and client
    p50/p99, the server's queue-wait and latency means, and on the card
    the caching allocator's device allocations and frees (``cudaMalloc``
    and ``cudaFree``), over this step alone."""
    import threading

    import torch

    from hyperspace_tpu_torch.interop import QueryClient
    from hyperspace_tpu_torch.telemetry import metrics

    def allocator() -> dict:
        if not torch.cuda.is_available():
            return {}
        stats = torch.cuda.memory_stats()
        return {k: stats.get(f"num_device_{k}", 0) for k in ("alloc", "free")}

    names = list(specs)
    done, failures = [], []
    done_lock = threading.Lock()

    def concurrent_client(i: int) -> None:
        try:
            with QueryClient(address, timeout_s=T_BOUND_S) as c:
                for r in range(T_ROUNDS):
                    for j in range(len(names)):
                        name = names[(i + j) % len(names)]
                        t0 = time.perf_counter()
                        table = c.query(specs[name])
                        ms = (time.perf_counter() - t0) * 1e3
                        check(f"client {i} round {r}", name, table)
                        with done_lock:
                            done.append((name, ms))
        except Exception as e:  # noqa: BLE001 - reported below
            with done_lock:
                failures.append(f"client {i}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=concurrent_client, args=(i,),
                                daemon=True) for i in range(T_CLIENTS)]
    before, alloc0 = metrics.snapshot(), allocator()
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    t_join(threads, "a concurrent client", phase)
    wall = time.perf_counter() - t0
    allocs = {k: v - alloc0[k] for k, v in allocator().items()}
    want_n = T_CLIENTS * T_ROUNDS * len(names)
    if failures or len(done) != want_n:
        raise AssertionError(f"phase {phase}: {len(done)} of {want_n} "
                             f"answers, failures {failures[:3]}")
    lat = sorted(ms for _, ms in done)
    after = metrics.snapshot()

    def step_mean(name: str) -> float:
        """The mean of a histogram over this step alone."""
        b, a = before.get(name) or {}, after[name]
        return (a["sum"] - b.get("sum", 0.0)) \
            / (a["count"] - b.get("count", 0))

    return {
        "clients": T_CLIENTS, "requests": len(done), "wall_s": wall,
        "qps": len(done) / wall,
        "p50_ms": lat[len(lat) // 2],
        "p99_ms": lat[min(len(lat) - 1, int(0.99 * len(lat)))],
        # Server side: enqueue to a worker, and enqueue to the answer's
        # table (the wire write not included).
        "queue_wait_ms_mean": step_mean("serve.queue_wait_ms"),
        "server_latency_ms_mean": step_mean("serve.latency_ms"),
        "device_allocs": allocs}


def serve_indexes(session, root: str, phase: str) -> dict:
    """Phase C's ``li_idx`` and phase D's ``ord_idx`` ACTIVE under
    ``session``'s system path, each built here when missing (a rehearsal
    without phases C and D): ``{"indexes": each one's state as found,
    "rebuilt": the names built}``."""
    from hyperspace_tpu_torch import Hyperspace, IndexConfig

    hs = Hyperspace(session)
    configs = {INDEX_NAME: ("lineitem", IndexConfig(INDEX_NAME, INDEXED,
                                                    INCLUDED)),
               ORDERS_INDEX: ("orders", IndexConfig(
                   ORDERS_INDEX, ["o_orderkey"],
                   ["o_totalprice", "o_custkey", "o_shippriority"]))}
    out: dict = {"indexes": {}, "rebuilt": []}
    for name, (source, config) in configs.items():
        entry = hs.index_manager.get_index(name)
        out["indexes"][name] = entry.state if entry else None
        if entry is None or entry.state != "ACTIVE":
            if entry is not None:
                raise AssertionError(f"phase {phase}: {name} is "
                                     f"{entry.state}")
            hs.create_index(session.read.parquet(os.path.join(root, source)),
                            config)
            out["rebuilt"].append(name)
    return out


def phase_t(orders: dict, li: dict, root: str, dev) -> dict:
    """The query server at SF1 (see the module docstring)."""
    import threading

    import pyarrow as pa

    from hyperspace_tpu_torch import HyperspaceSession
    from hyperspace_tpu_torch.interop import (
        QueryClient,
        QueryFailedError,
        QueryServer,
        ServerBusyError,
        dataset_from_spec,
    )
    from hyperspace_tpu_torch.interop import server as server_mod
    from hyperspace_tpu_torch.lifecycle import daemon as lifecycle_daemon
    from hyperspace_tpu_torch.ops import kernels
    from hyperspace_tpu_torch.telemetry import flight_recorder, metrics

    t_phase = time.perf_counter()
    cuda = dev.type == "cuda"
    session = HyperspaceSession(system_path=os.path.join(root, "indexes"),
                                device=dev)
    session.conf.num_buckets = NUM_BUCKETS
    session.conf.device_batch_rows = 1 << 23
    session.conf.serving_workers = T_WORKERS
    set_min_rows(session, 0)
    out = serve_indexes(session, root, "T")
    session.enable_hyperspace()
    specs = t_specs(root)
    direct = {name: dataset_from_spec(session, spec)
              for name, spec in specs.items()}
    for name, ds in direct.items():
        scans = sorted(n for n, _ in index_scans(ds.optimized_plan()))
        if scans != query_indexes(name):
            raise AssertionError(f"phase T {name}: plan scans {scans}, "
                                 f"expected {query_indexes(name)}")
    expected = {**expected_answers(orders, li),
                **expected_aggregates(orders, li)}
    answers: dict = {}
    answers_lock = threading.Lock()
    numpy_checks: dict = {}

    def check(label: str, name: str, table) -> None:
        """``table`` equal to numpy's answer: to the first checked table
        when equal to it, else held to numpy itself (floats of the
        aggregates within AGG_RTOL: summation order may differ)."""
        with answers_lock:
            first = answers.get(name)
        if first is not None and table.equals(first):
            return
        want, keys = expected[name]
        require_rows(f"phase T {label} {name}", table, want, keys,
                     AGG_RTOL if name in AGG_QUERIES else 0.0)
        with answers_lock:
            answers.setdefault(name, table)
            numpy_checks[name] = numpy_checks.get(name, 0) + 1

    def snap(name: str) -> float:
        return float(metrics.snapshot().get(name, 0.0) or 0.0)

    steps: dict = {}
    mark = [time.perf_counter()]

    def step(label: str) -> None:
        now = time.perf_counter()
        steps[label] = now - mark[0]
        mark[0] = now
        print(f"phase T step {label}: {steps[label]:.3f} s", flush=True)

    real_make = server_mod._Responder._make_query_fn
    appended = os.path.join(root, "lineitem", "part-96000.parquet")
    staging = os.path.join(root, "t_staging")
    metrics.reset()
    flight_recorder.reset()
    server = QueryServer(session).start()
    small = client = None
    try:
        client = QueryClient(server.address, timeout_s=T_BOUND_S)
        # 1. Each query served and collected directly, then timed in
        # turns.  The first served run plans (a plan-cache miss); the
        # timed ones are hits.
        kernels.reset_launch_counts()
        queries: dict = {}
        for name, spec in specs.items():
            served = client.query(spec)
            check("served", name, served)
            local = direct[name].collect()
            check_routes("direct", name, "device",
                         session.last_execution_stats)
            check("direct", name, local)
            if not served.equals(local):
                require_rows(f"phase T served against direct {name}",
                             served, t_table_rows(local), expected[name][1],
                             AGG_RTOL if name in AGG_QUERIES else 0.0)
            runs = {"served": [], "direct": []}
            for _ in range(T_TIMED_RUNS):
                runs["served"].append(wall_ms(lambda: client.query(spec)))
                runs["direct"].append(wall_ms(direct[name].collect))
            queries[name] = {
                "rows": served.num_rows,
                "served_ms": statistics.median(runs["served"]),
                "direct_ms": statistics.median(runs["direct"]),
                "served_runs_ms": runs["served"],
                "direct_runs_ms": runs["direct"]}
            queries[name]["served_over_direct"] = \
                queries[name]["served_ms"] / queries[name]["direct_ms"]
        step("1_sequential")

        # 2. T_CLIENTS concurrent clients, T_ROUNDS rounds of the seven,
        # each client starting at another query.
        concurrent = t_concurrent("T", server.address, specs, check)
        # The first client sat idle through step 2, and the server closes
        # a connection idle past serving_request_timeout_s: a new one.
        client.close()
        client = QueryClient(server.address, timeout_s=T_BOUND_S)
        want_n = concurrent["requests"]
        # One round of the seven served in turn (step 1's medians): what
        # 4 workers would divide if they overlapped.
        concurrent["sequential_round_ms"] = sum(q["served_ms"]
                                                for q in queries.values())
        step("2_concurrent")
        query_launches = kernels.launch_counts()
        if any(query_launches.values()):
            raise AssertionError(f"phase T: the served queries launched "
                                 f"{query_launches}")

        # 3. The plan cache: each query served with the cache emptied
        # first (it plans), then from the cache.
        hits0, misses0 = snap("serve.plan_cache.hits"), \
            snap("serve.plan_cache.misses")
        for name, spec in specs.items():
            miss, hit = [], []
            for _ in range(T_CACHE_PAIRS):
                server.plan_cache.clear()
                miss.append(wall_ms(lambda: client.query(spec)))
                hit.append(wall_ms(lambda: client.query(spec)))
            queries[name].update(
                miss_ms=statistics.median(miss), hit_ms=statistics.median(hit),
                cache_saved_ms=statistics.median(miss)
                - statistics.median(hit))
        n = T_CACHE_PAIRS * len(specs)
        cache = {"hits": snap("serve.plan_cache.hits") - hits0,
                 "misses": snap("serve.plan_cache.misses") - misses0}
        if cache != {"hits": n, "misses": n}:
            raise AssertionError(f"phase T: plan cache {cache}, expected "
                                 f"{n} of each")
        step("3_plan_cache")

        # 4. One appended file, hybrid scan on: the served filtered join
        # goes through the hybrid route.  No action committed, so the
        # plan cache cannot see the new file: it is emptied.
        cols = gen_lineitem(np.random.default_rng(T_SEED), T_APPENDED_ROWS)
        os.makedirs(staging)
        p_write(os.path.dirname(appended), staging,
                os.path.basename(appended), pa.table(cols))
        session.conf.hybrid_scan_enabled = True
        server.plan_cache.clear()
        grown = {c: np.concatenate([li[c], cols[c]]) for c in
                 ("l_orderkey", "l_quantity", "l_extendedprice",
                  "l_discount")}
        want, keys = expected_answers(orders, grown)["filtered_join"]
        spec = specs["filtered_join"]
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        served = client.query(spec)
        served_ms = (time.perf_counter() - t0) * 1e3
        launches = kernels.launch_counts()
        if cuda:
            require_launches("phase T served hybrid join", launches,
                             {"hash_buckets": 1, "bucket_histogram": 0})
        hybrid_ds = dataset_from_spec(session, spec)
        if "BucketUnion" not in plan_nodes(hybrid_ds.optimized_plan()):
            raise AssertionError("phase T: the hybrid join's plan has no "
                                 "BucketUnion")
        require_rows("phase T served hybrid join", served, want, keys)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        local = hybrid_ds.collect()
        direct_ms = (time.perf_counter() - t0) * 1e3
        direct_launches = kernels.launch_counts()
        if direct_launches != launches:
            raise AssertionError(f"phase T: the direct hybrid join launched "
                                 f"{direct_launches}, served {launches}")
        if not any(j.get("hybrid") for j in
                   session.last_execution_stats.get("joins", [])):
            raise AssertionError("phase T: the direct join was not hybrid")
        if not served.equals(local):
            require_rows("phase T hybrid served against direct", served,
                         t_table_rows(local), keys)
        hybrid = {"rows": served.num_rows, "served_ms": served_ms,
                  "direct_ms": direct_ms, "launches": launches}
        os.remove(appended)
        session.conf.hybrid_scan_enabled = False
        server.plan_cache.clear()
        step("4_hybrid")

        # 6 (run here, on the four-worker server). Each verb once.
        verbs: dict = {}
        slow = client.query({"verb": "slow_queries"})
        trace_ids = [t for t, k in zip(slow.column("traceId").to_pylist(),
                                       slow.column("kind").to_pylist())
                     if k == "spec"]  # the direct collects' are "local"
        if not trace_ids:
            raise AssertionError("phase T: no served flight record kept")
        for verb in T_VERBS:
            extra = {"id": trace_ids[-1]} if verb == "trace" else {}
            t0 = time.perf_counter()
            table = client.query({"verb": verb, **extra})
            verbs[verb] = {"rows": table.num_rows,
                           "ms": (time.perf_counter() - t0) * 1e3}
        series = dict(zip(*(client.query({"verb": "metrics"}).column(c)
                            .to_pylist() for c in ("name", "value"))))
        if series.get("serve.ok", 0) < want_n or \
                series.get("serve.errors", 0) != 0:
            raise AssertionError(f"phase T: serve.ok "
                                 f"{series.get('serve.ok')}, errors "
                                 f"{series.get('serve.errors')}")
        report = json.loads(client.query({"verb": "last_run_report"})
                            .column("report_json").to_pylist()[0])
        if report is None or sorted(report["indexes_used"]) != \
                query_indexes("filtered_join"):  # step 4's hybrid join
            raise AssertionError(f"phase T: last_run_report {report}")
        rec = json.loads(client.query({"verb": "trace",
                                       "id": trace_ids[-1]})
                         .column("record_json").to_pylist()[0])
        if rec["kind"] != "spec" or rec["outcome"] != "OK":
            raise AssertionError(f"phase T: trace record {rec['kind']} "
                                 f"{rec['outcome']}")
        step("6_verbs")

        # 5. One worker, a queue of one.  A hold keeps the next query
        # admitted and running until released, so the burst's outcome
        # does not hang on timing.
        hold = {"armed": 0, "until": None}
        hold_lock = threading.Lock()
        held = threading.Event()

        def make(self, spec):
            fn, kind = real_make(self, spec)
            with hold_lock:
                take = hold["armed"] > 0
                hold["armed"] -= take
                until = hold["until"]
            if not take:
                return fn, kind

            def held_fn():
                held.set()
                t_until(until, "the hold's release")
                return fn()
            return held_fn, kind

        server_mod._Responder._make_query_fn = make
        sizing = (session.conf.serving_workers,
                  session.conf.serving_queue_depth)
        session.conf.serving_workers = session.conf.serving_queue_depth = 1
        small = QueryServer(session).start()  # sized when made
        session.conf.serving_workers, session.conf.serving_queue_depth = \
            sizing
        release = threading.Event()
        results: dict = {}

        def serve(label: str, name: str) -> None:
            try:
                with QueryClient(small.address, timeout_s=T_BOUND_S) as c:
                    results[label] = c.query(specs[name])
            except Exception as e:  # noqa: BLE001 - checked below
                results[label] = e

        shed0 = {k: snap(k) for k in ("serve.shed", "serve.shed.queue_full")}
        hold.update(armed=1, until=release.is_set)
        first = threading.Thread(target=serve, args=("running", "q3"),
                                 daemon=True)
        first.start()
        if not held.wait(T_BOUND_S):
            raise AssertionError("phase T: the held q3 never ran")
        second = threading.Thread(target=serve, args=("queued", "q3"),
                                  daemon=True)
        second.start()
        t_until(lambda: snap("serve.queue_depth") == 1, "q3 to queue")
        barrier = threading.Barrier(T_BURST)

        def burst(i: int) -> None:
            barrier.wait(T_BOUND_S)
            serve(f"burst {i}", "q3")

        bursts = [threading.Thread(target=burst, args=(i,), daemon=True)
                  for i in range(T_BURST)]
        for t in bursts:
            t.start()
        t_join(bursts, "the burst")
        release.set()
        t_join([first, second], "the admitted q3s")
        busy = [r for k, r in results.items() if k.startswith("burst")
                and isinstance(r, ServerBusyError)]
        shed = {k: snap(k) - v for k, v in shed0.items()}
        if len(busy) != T_BURST or shed["serve.shed.queue_full"] != T_BURST \
                or shed["serve.shed"] != T_BURST:
            raise AssertionError(f"phase T: burst {len(busy)} BUSY of "
                                 f"{T_BURST}, counters {shed}")
        for label in ("running", "queued"):
            check(f"small server {label}", "q3", results[label])
        burst_out = {"busy": len(busy), "counters": shed,
                     "retry_after_ms": [e.retry_after_ms for e in busy]}

        with QueryClient(small.address, timeout_s=T_BOUND_S) as c:
            t0 = time.perf_counter()
            try:
                c.query(specs["q3"], deadline_ms=1)
            except QueryFailedError as e:
                late = e
            else:
                raise AssertionError("phase T: q3 beat a 1 ms deadline")
            deadline_ms = (time.perf_counter() - t0) * 1e3
        if late.code != "DEADLINE" or not late.retryable:
            raise AssertionError(f"phase T: 1 ms deadline answered "
                                 f"{late.code} {late.message}")
        # The abandoned q3 may still sit in the queue of one (a slow
        # worker has not taken it yet): the next q3 waits for it to go.
        if not small.pool.wait_idle(T_BOUND_S):
            raise AssertionError("phase T: the abandoned q3 never finished")
        with QueryClient(small.address, timeout_s=T_BOUND_S) as c:
            t0 = time.perf_counter()
            check("after the deadline", "q3", c.query(specs["q3"]))
            after_ms = (time.perf_counter() - t0) * 1e3
        deadline_out = {"answered_ms": deadline_ms, "message": late.message,
                        "next_q3_ms": after_ms}

        open_client = QueryClient(small.address, timeout_s=T_BOUND_S)
        try:
            check("before the drain", "point",
                  open_client.query(specs["point"]))
            held.clear()
            hold.update(armed=1, until=lambda: small.pool.draining)
            inflight = threading.Thread(target=serve,
                                        args=("in flight", "join"),
                                        daemon=True)
            inflight.start()
            if not held.wait(T_BOUND_S):
                raise AssertionError("phase T: the in-flight join never ran")
            drained: dict = {}
            t0 = time.perf_counter()
            drainer = threading.Thread(
                target=lambda: drained.update(clean=small.drain(
                    grace_s=T_BOUND_S)), daemon=True)
            drainer.start()
            t_until(lambda: small.pool.draining, "the drain to begin")
            try:
                open_client.query(specs["point"])
            except ServerBusyError as e:
                refused = e.message
            else:
                raise AssertionError("phase T: a request during the drain "
                                     "was served")
            t_join([inflight, drainer], "the drain")
            drain_s = time.perf_counter() - t0
        finally:
            open_client.close()
        if drained.get("clean") is not True or "draining" not in refused:
            raise AssertionError(f"phase T: drain {drained}, refusal "
                                 f"{refused!r}")
        check("in flight through the drain", "join", results["in flight"])
        drain_out = {"clean": True, "drain_s": drain_s, "refused": refused}
        step("5_small_server")
    finally:
        server_mod._Responder._make_query_fn = real_make
        if client is not None:
            client.close()
        if small is not None:
            small.stop()
        server.stop()
        lifecycle_daemon.clear_drain()
        session.conf.hybrid_scan_enabled = False
        if os.path.exists(appended):
            os.remove(appended)
        shutil.rmtree(staging, ignore_errors=True)
        session.disable_hyperspace()
        device_cache().clear()
    out.update(queries=queries, concurrent=concurrent, plan_cache=cache,
               numpy_checks=numpy_checks,
               hybrid=hybrid, burst=burst_out, deadline=deadline_out,
               drain=drain_out, verbs=verbs, launches=launches,
               steps_s=steps)
    out["phase_s"] = time.perf_counter() - t_phase
    # For phase U, never printed: the served answers of step 1 (each held
    # to numpy) and numpy's answers.
    out["answers"], out["expected"] = answers, expected
    return out


U_WORKERS = 4                   # the async server's workers, as phase T's
U_BLACK_HOLE_S = 0.5            # the client's timeout under an accept black-hole
U_SLOW_RECV_MS = 100.0          # the net.recv "slow" plan's delay
U_DETOUR_RUNS = 1               # join runs with a silent wire plan and without


def phase_u(orders: dict, li: dict, root: str, dev, t: dict,
            turns: int = 0) -> dict:
    """Tenants, the async IO mode and the wire faults, after phase T, over
    its indexes and specs, with ``t["answers"]`` (phase T's threaded
    answers) and ``t["expected"]`` (numpy's) (see the module docstring).
    ``turns`` (``--u-turns``) adds that many rounds of the 8 clients on
    a threaded and the async server in turns after step 1."""
    import threading

    from hyperspace_tpu_torch import HyperspaceSession
    from hyperspace_tpu_torch.interop import (
        QueryClient,
        QueryServer,
        ServerBusyError,
        dataset_from_spec,
        netfaults,
    )
    from hyperspace_tpu_torch.interop import server as server_mod
    from hyperspace_tpu_torch.io import faults
    from hyperspace_tpu_torch.ops import kernels
    from hyperspace_tpu_torch.telemetry import metrics

    t_phase = time.perf_counter()
    cuda = dev.type == "cuda"
    session = HyperspaceSession(system_path=os.path.join(root, "indexes"),
                                device=dev)
    session.conf.num_buckets = NUM_BUCKETS
    session.conf.device_batch_rows = 1 << 23
    set_min_rows(session, 0)
    session.enable_hyperspace()
    specs = t_specs(root)
    for name, spec in specs.items():
        scans = sorted(n for n, _ in index_scans(
            dataset_from_spec(session, spec).optimized_plan()))
        if scans != query_indexes(name):
            raise AssertionError(f"phase U {name}: plan scans {scans}, "
                                 f"expected {query_indexes(name)}")
    threaded, expected = t["answers"], t["expected"]
    numpy_checks: dict = {}
    checks_lock = threading.Lock()

    def check(label: str, name: str, table, strict: bool = False) -> None:
        """``table`` equal to phase T's threaded answer; unless
        ``strict``, else held to numpy as phase T holds its later
        answers (floats of the aggregates within AGG_RTOL)."""
        if table.equals(threaded[name]):
            return
        if strict:
            raise AssertionError(f"phase U {label} {name}: differs from "
                                 f"phase T's threaded answer")
        want, keys = expected[name]
        require_rows(f"phase U {label} {name}", table, want, keys,
                     AGG_RTOL if name in AGG_QUERIES else 0.0)
        with checks_lock:
            numpy_checks[name] = numpy_checks.get(name, 0) + 1

    def snap(name: str) -> float:
        return float(metrics.snapshot().get(name, 0.0) or 0.0)

    steps: dict = {}
    mark = [time.perf_counter()]

    def step(label: str) -> None:
        now = time.perf_counter()
        steps[label] = now - mark[0]
        mark[0] = now
        print(f"phase U step {label}: {steps[label]:.3f} s", flush=True)

    real_make = server_mod._Responder._make_query_fn
    sizing = (session.conf.serving_workers, session.conf.serving_io_mode)
    session.conf.serving_workers = U_WORKERS
    session.conf.serving_io_mode = "async"
    server = QueryServer(session).start()  # sized and moded when made
    session.conf.serving_workers, session.conf.serving_io_mode = sizing
    quota_server = None
    out: dict = {}
    try:
        # 1. Async against threaded: each of the seven once, equal to
        # phase T's threaded answer (which phase T held to numpy), then
        # phase T's 8 clients x 3 rounds.  None launches a kernel.
        kernels.reset_launch_counts()
        with QueryClient(server.address, timeout_s=T_BOUND_S) as c:
            for name, spec in specs.items():
                check("async", name, c.query(spec), strict=True)
        step("1_async_seven")
        concurrent = t_concurrent("U", server.address, specs, check)
        concurrent["threaded"] = {
            k: t["concurrent"][k] for k in (
                "wall_s", "qps", "p50_ms", "p99_ms", "queue_wait_ms_mean",
                "server_latency_ms_mean", "device_allocs")}
        concurrent["qps_over_threaded"] = \
            concurrent["qps"] / t["concurrent"]["qps"]
        out["async"] = concurrent
        step("1_async_concurrent")
        if turns:
            # Threaded and async in turns on one warm process: what the
            # order of phases T and U adds to their comparison.
            session.conf.serving_workers = U_WORKERS
            threaded_server = QueryServer(session).start()
            session.conf.serving_workers = sizing[0]
            try:
                out["turns"] = [
                    {"mode": mode, **t_concurrent(
                        "U", (server if mode == "async"
                              else threaded_server).address, specs, check)}
                    for _ in range(turns)
                    for mode in ("threaded", "async", "async", "threaded")]
            finally:
                threaded_server.stop()
            for r in out["turns"]:
                print(f"phase U turn {r['mode']}: {r['qps']:.2f} qps, p50 "
                      f"{r['p50_ms']:.1f} p99 {r['p99_ms']:.1f} ms, server "
                      f"latency {r['server_latency_ms_mean']:.1f} queue "
                      f"wait {r['queue_wait_ms_mean']:.1f} ms, allocs "
                      f"{json.dumps(r['device_allocs'])}", flush=True)
            step("1_turns")

        # 2. The tenant quota on one worker: hot's join held on the
        # worker until its second request was shed, the verb read and
        # cold's point admitted behind it.
        session.conf.serving_workers = 1
        quota_server = QueryServer(session).start()
        session.conf.serving_workers = sizing[0]
        session.conf.serving_tenant_max_queued = 1
        hold = {"armed": 1}
        hold_lock = threading.Lock()
        held, release = threading.Event(), threading.Event()

        def make(self, spec):
            fn, kind = real_make(self, spec)
            with hold_lock:
                take = hold["armed"] > 0
                hold["armed"] -= take
            if not take:
                return fn, kind

            def held_fn():
                held.set()
                t_until(release.is_set, "the hold's release", "U")
                return fn()
            return held_fn, kind

        server_mod._Responder._make_query_fn = make
        results: dict = {}

        def serve(tenant: str, name: str) -> None:
            try:
                with QueryClient(quota_server.address, tenant=tenant,
                                 timeout_s=T_BOUND_S) as c:
                    results[tenant] = c.query(specs[name])
            except Exception as e:  # noqa: BLE001 - checked below
                results[tenant] = e

        shed0 = {k: snap(k) for k in ("serve.shed.tenant",
                                      "serve.tenant.hot.shed")}
        hot = threading.Thread(target=serve, args=("hot", "join"),
                               daemon=True)
        hot.start()
        pool = quota_server.pool
        t_until(lambda: pool.tenant_snapshot().get("hot", 0) >= 1,
                "hot's join to be admitted", "U")
        if not held.wait(T_BOUND_S):
            raise AssertionError("phase U: hot's join never reached the "
                                 "worker")
        try:
            with QueryClient(quota_server.address, tenant="hot",
                             timeout_s=T_BOUND_S) as c:
                c.query(specs["point"])
        except ServerBusyError as e:
            shed = e
        else:
            raise AssertionError("phase U: hot's second request was served")
        if "quota" not in shed.message or shed.retry_after_ms is None:
            raise AssertionError(f"phase U: the shed {shed.message!r}, "
                                 f"retry-after {shed.retry_after_ms}")
        with QueryClient(quota_server.address, timeout_s=T_BOUND_S) as c:
            verb = c.query({"verb": "tenants"}).to_pylist()
        rows = {r["tenant"]: r for r in verb}
        if rows.get("hot", {}).get("queued", 0) < 1 \
                or rows["hot"]["shed"] != 1:
            raise AssertionError(f"phase U: the tenants verb {verb}")
        cold = threading.Thread(target=serve, args=("cold", "point"),
                                daemon=True)
        cold.start()
        t_until(lambda: pool.tenant_snapshot().get("cold", 0) >= 1,
                "cold's point to be admitted", "U")
        release.set()
        t_join([hot, cold], "the tenants' requests", "U")
        for tenant, name in (("hot", "join"), ("cold", "point")):
            if isinstance(results[tenant], Exception):
                raise AssertionError(f"phase U: {tenant}'s {name} raised "
                                     f"{results[tenant]!r}")
            check(f"tenant {tenant}", name, results[tenant])
        sheds = {k: snap(k) - v for k, v in shed0.items()}
        if sheds != {"serve.shed.tenant": 1.0, "serve.tenant.hot.shed": 1.0}:
            raise AssertionError(f"phase U: tenant shed counters {sheds}")
        out["tenants"] = {"shed_message": shed.message,
                          "retry_after_ms": shed.retry_after_ms,
                          "verb": verb, "counters": sheds}
        server_mod._Responder._make_query_fn = real_make
        session.conf.serving_tenant_max_queued = 0
        quota_server.stop()
        quota_server = None
        step("2_tenants")

        # 3. Wire faults against the async server; each plan cleared in
        # a finally.
        wire: dict = {}

        def raised(fn) -> BaseException:
            try:
                fn()
            except Exception as e:  # noqa: BLE001 - the outcome checked
                return e
            raise AssertionError("phase U: a wire fault was not raised")

        def query(spec, timeout_s=T_BOUND_S):
            with QueryClient(server.address, timeout_s=timeout_s) as c:
                return c.query(spec)

        try:
            # The client's request send is call 1, the response call 2.
            faults.install(faults.FaultPlan("net.send", "torn-frame", at=2))
            e = raised(lambda: query(specs["join"]))
            faults.clear()
            if not isinstance(e, ConnectionError):
                raise AssertionError(f"phase U: the torn join raised {e!r}")
            wire["torn_frame"] = f"{type(e).__name__}: {e}"[:200]
            check("after the torn frame", "join", query(specs["join"]),
                  strict=True)

            faults.install(faults.FaultPlan("net.accept", "reset"))
            e = raised(lambda: query(specs["point"]))
            faults.clear()
            if not isinstance(e, ConnectionError):
                raise AssertionError(f"phase U: accept reset raised {e!r}")
            wire["accept_reset"] = f"{type(e).__name__}: {e}"[:200]

            faults.install(faults.FaultPlan("net.accept", "black-hole"))
            t0 = time.perf_counter()
            e = raised(lambda: query(specs["point"], U_BLACK_HOLE_S))
            waited = time.perf_counter() - t0
            faults.clear()
            netfaults.clear_parked()
            if not isinstance(e, ConnectionError) \
                    or not isinstance(e.__cause__, TimeoutError) \
                    or waited < U_BLACK_HOLE_S:
                raise AssertionError(f"phase U: accept black-hole raised "
                                     f"{e!r} after {waited:.3f} s")
            wire["black_hole_s"] = waited

            with QueryClient(server.address, timeout_s=T_BOUND_S) as c:
                check("before the slow read", "point", c.query(specs["point"]))
                t0 = time.perf_counter()
                check("plain read", "point", c.query(specs["point"]))
                plain_ms = (time.perf_counter() - t0) * 1e3
                faults.install(faults.FaultPlan(
                    "net.recv", "slow", latency_ms=U_SLOW_RECV_MS))
                t0 = time.perf_counter()
                slow_table = c.query(specs["point"])
                slow_ms = (time.perf_counter() - t0) * 1e3
                faults.clear()
            check("slow read", "point", slow_table, strict=True)
            if slow_ms < U_SLOW_RECV_MS:
                raise AssertionError(f"phase U: the slow read took "
                                     f"{slow_ms:.1f} ms")
            wire["slow_recv_ms"] = {"plain": plain_ms, "slow": slow_ms}

            # The detour's cost: the join served with a wire plan armed
            # that never fires (its whole frame buffered), and without,
            # in turns.
            silent = faults.FaultPlan("net.connect", "refused", at=1 << 40)
            runs: dict = {"direct": [], "buffered": []}
            with QueryClient(server.address, timeout_s=T_BOUND_S) as c:
                for label in ("direct", "buffered") * U_DETOUR_RUNS:
                    faults.install(silent if label == "buffered" else None)
                    t0 = time.perf_counter()
                    table = c.query(specs["join"])
                    runs[label].append((time.perf_counter() - t0) * 1e3)
                    faults.clear()
                    check(f"join {label}", "join", table, strict=True)
            wire["join_ms"] = runs
        finally:
            faults.clear()
            netfaults.clear_parked()
        out["wire"] = wire
        step("3_wire_faults")
        launches = kernels.launch_counts()
        if cuda:
            require_launches("phase U", launches,
                             {"hash_buckets": 0, "bucket_histogram": 0})
    finally:
        server_mod._Responder._make_query_fn = real_make
        session.conf.serving_tenant_max_queued = 0
        faults.clear()
        if quota_server is not None:
            quota_server.stop()
        server.stop()
        session.disable_hyperspace()
        device_cache().clear()
    out.update(numpy_checks=numpy_checks, launches=launches, steps_s=steps,
               phase_s=time.perf_counter() - t_phase)
    return out


def print_server_u(u: dict) -> None:
    a, th, w = u["async"], u["async"]["threaded"], u["wire"]
    print(f"phase U: async {a['requests']} answers right in "
          f"{a['wall_s']:.3f} s ({a['qps']:.1f} qps, p50 {a['p50_ms']:.1f} "
          f"p99 {a['p99_ms']:.1f} ms; server latency "
          f"{a['server_latency_ms_mean']:.1f} ms mean, queue wait "
          f"{a['queue_wait_ms_mean']:.1f}) against threaded "
          f"{th['wall_s']:.3f} s ({th['qps']:.1f} qps, p50 "
          f"{th['p50_ms']:.1f} p99 {th['p99_ms']:.1f} ms; server latency "
          f"{th['server_latency_ms_mean']:.1f}, queue wait "
          f"{th['queue_wait_ms_mean']:.1f}); device allocs/frees async "
          f"{json.dumps(a['device_allocs'])} threaded "
          f"{json.dumps(th['device_allocs'])}; numpy checks "
          f"{json.dumps(u['numpy_checks'])}; tenants "
          f"{json.dumps(u['tenants']['verb'])}, shed "
          f"{u['tenants']['shed_message']!r}; torn frame "
          f"{w['torn_frame'][:60]!r}; black-hole {w['black_hole_s']:.3f} s; "
          f"slow read {w['slow_recv_ms']['slow']:.1f} ms (plain "
          f"{w['slow_recv_ms']['plain']:.1f}); join direct "
          f"{json.dumps([round(x, 1) for x in w['join_ms']['direct']])} "
          f"buffered "
          f"{json.dumps([round(x, 1) for x in w['join_ms']['buffered']])} "
          f"ms; launches {json.dumps(u['launches'])} "
          f"({u['phase_s']:.3f} s; by step {json.dumps(u['steps_s'])})",
          flush=True)


V_WORKERS = 2                   # each backend server's workers
V_DEADLINE_MS = 60_000.0        # each fleet query's budget: its sockets time
                                # out within T_BOUND_S
V_PARK_HINT_MS = 30_000         # step 2: the fake BUSY endpoint's hint
V_PARK_QUERIES = 6              # step 2: point queries through it and a
V_BREAKER_FAILURES = 2          # step 3
V_BREAKER_COOLDOWN_MS = 500.0   # step 3
V_BREAKER_TRIES = 20            # step 3: point queries to open, then close
V_HEDGES = 3                    # step 4: hedged point queries
V_HEDGE_DELAY_MS = 40.0         # step 4
V_SLOW_RECV_MS = 400.0          # step 4: the primary's read held this long
V_JOIN_RUNS = 1                 # step 5: the join direct and proxied, each
V_PROXY_HINT_MS = 50            # step 5: the upstream BUSY's hint
V_SCRAPED = ("hyperspace_serve_ok", "hyperspace_client_retry",
             "hyperspace_client_failover", "hyperspace_client_hedge_sent",
             "hyperspace_client_breaker_open_now")


class VBusyEndpoint:
    """A fake server on loopback: each request line is answered ``ERR BUSY
    ... retry-after-ms=<hint>`` and its connection closed; ``hits``
    counts the lines."""

    def __init__(self, retry_after_ms: int) -> None:
        import socket
        import threading

        self._listener = socket.create_server(("127.0.0.1", 0))
        self.address = self._listener.getsockname()
        self._hint = retry_after_ms
        self.hits = 0
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while True:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return  # closed
            try:
                conn.settimeout(T_BOUND_S)
                if conn.makefile("rb").readline():
                    self.hits += 1
                    conn.sendall(f"ERR BUSY admission queue full; retry "
                                 f"later retry-after-ms={self._hint}\n"
                                 .encode())
            except OSError:
                pass
            finally:
                conn.close()

    def close(self) -> None:
        import socket

        try:
            # Wakes the accept: a close alone leaves it blocked on Linux.
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._listener.close()
        t_join([self._thread], "the busy endpoint's accept loop", "V")


def v_free_port() -> tuple:
    """A loopback address that nothing listens on (yet)."""
    import socket

    probe = socket.create_server(("127.0.0.1", 0))
    address = probe.getsockname()
    probe.close()
    return address


def phase_v(orders: dict, li: dict, root: str, dev) -> dict:
    """The front door over phase C's and D's indexes (see the module
    docstring)."""
    import urllib.request

    from hyperspace_tpu_torch import Hyperspace, HyperspaceSession
    from hyperspace_tpu_torch.interop import (
        FleetQueryClient,
        QueryClient,
        QueryServer,
        ServerBusyError,
    )
    from hyperspace_tpu_torch.interop.server import MetricsScrapeServer
    from hyperspace_tpu_torch.io import faults
    from hyperspace_tpu_torch.ops import kernels
    from hyperspace_tpu_torch.telemetry import metrics

    t_phase = time.perf_counter()
    cuda = dev.type == "cuda"
    session = HyperspaceSession(system_path=os.path.join(root, "indexes"),
                                device=dev)
    session.conf.num_buckets = NUM_BUCKETS
    session.conf.device_batch_rows = 1 << 23
    set_min_rows(session, 0)
    out = serve_indexes(session, root, "V")
    session.enable_hyperspace()
    hs = Hyperspace(session)
    specs = t_specs(root)
    expected = {**expected_answers(orders, li),
                **expected_aggregates(orders, li)}
    answers: dict = {}

    def check(label: str, name: str, table) -> None:
        """``table`` equal to this phase's first answer to ``name``, which
        was held to numpy (floats of the aggregates within AGG_RTOL)."""
        first = answers.get(name)
        if first is not None and table.equals(first):
            return
        want, keys = expected[name]
        require_rows(f"phase V {label} {name}", table, want, keys,
                     AGG_RTOL if name in AGG_QUERIES else 0.0)
        answers.setdefault(name, table)

    def snap(name: str) -> float:
        return float(metrics.snapshot().get(name, 0.0) or 0.0)

    counted = ("client.retry", "client.retry.connection",
               "client.retry.busy", "client.failover")

    def moved(before: dict) -> dict:
        return {k: snap(k) - v for k, v in before.items()}

    def timed(fc, name: str) -> tuple:
        t0 = time.perf_counter()
        table = fc.query(specs[name], deadline_ms=V_DEADLINE_MS)
        return table, (time.perf_counter() - t0) * 1e3

    steps: dict = {}
    mark = [time.perf_counter()]

    def step(label: str) -> None:
        now = time.perf_counter()
        steps[label] = now - mark[0]
        mark[0] = now
        print(f"phase V step {label}: {steps[label]:.3f} s", flush=True)

    workers = session.conf.serving_workers
    session.conf.serving_workers = V_WORKERS
    servers = [QueryServer(session).start(), QueryServer(session).start()]
    session.conf.serving_workers = workers
    a, b = (s.address for s in servers)
    clients: list = []
    busy: list = []

    def fleet(endpoints, **kw) -> "FleetQueryClient":
        fc = FleetQueryClient(endpoints, conf=session.conf, **kw)
        clients.append(fc)
        return fc

    try:
        # 1. The seven through one fleet client over a and b, each held
        # to numpy; the picks each endpoint got.  None launches a kernel.
        kernels.reset_launch_counts()
        fc = fleet([a, b])
        picks = {ep.label: 0 for ep in fc._endpoints}
        real_pick = fc._pick

        def pick(*args, **kw):
            ep = real_pick(*args, **kw)
            picks[ep.label] += 1
            return ep

        fc._pick = pick
        fleet_ms = {}
        for name in specs:
            table, fleet_ms[name] = timed(fc, name)
            check("fleet", name, table)
        out["fleet"] = {"ms": fleet_ms, "picks": dict(picks)}
        step("1_fleet_seven")

        # 2. Failover: each fault once, answered right after a retry.
        failover: dict = {}
        before = {k: snap(k) for k in counted}
        faults.install(faults.FaultPlan("net.connect", "refused", at=1,
                                        count=1))
        try:
            # A new client: its first attempt dials (a pooled one would
            # not pass the dial's seam).
            table, ms = timed(fleet([a, b]), "point")
        finally:
            faults.clear()
        check("refused dial", "point", table)
        failover["refused_dial"] = {"ms": ms, "counters": moved(before)}
        before = {k: snap(k) for k in counted}
        # The client's request send is call 1, the response's call 2.
        faults.install(faults.FaultPlan("net.send", "torn-frame", at=2,
                                        count=1))
        try:
            table, ms = timed(fc, "join")
        finally:
            faults.clear()
        check("torn join", "join", table)
        failover["torn_join"] = {"ms": ms, "counters": moved(before)}
        busy.append(VBusyEndpoint(V_PARK_HINT_MS))
        before = {k: snap(k) for k in counted}
        parked = fleet([busy[-1].address, a])
        park_ms = []
        for _ in range(V_PARK_QUERIES):
            table, ms = timed(parked, "point")
            check("past the busy endpoint", "point", table)
            park_ms.append(ms)
        failover["busy_parked"] = {"ms": park_ms, "hits": busy[-1].hits,
                                   "counters": moved(before)}
        for label, f in failover.items():
            c = f["counters"]
            if c["client.retry"] < 1 or c["client.failover"] < 1:
                raise AssertionError(f"phase V {label}: counters {c}")
            print(f"phase V failover {label}: {json.dumps(f)}", flush=True)
        if busy[-1].hits != 1:
            raise AssertionError(f"phase V: the busy endpoint was hit "
                                 f"{busy[-1].hits} times, not once")
        out["failover"] = failover
        step("2_failover")

        # 3. A breaker: a dead port beside a opens it, the doctor warns;
        # a server comes up on that port, and after the cooldown one
        # half-open probe closes it.
        dead = v_free_port()
        breaker = fleet([dead, a], breaker_enabled=True,
                        breaker_failures=V_BREAKER_FAILURES,
                        breaker_cooldown_ms=V_BREAKER_COOLDOWN_MS)
        ep = breaker._endpoints[0]
        before = {k: snap(k) for k in ("client.breaker.open",
                                       "client.breaker.half_open",
                                       "client.breaker.close")}
        to_open = 0
        while ep.breaker_state != "open":
            if to_open == V_BREAKER_TRIES:
                raise AssertionError("phase V: the breaker never opened")
            table, _ = timed(breaker, "point")
            check("breaker", "point", table)
            to_open += 1
            time.sleep(0.12)  # past the failed endpoint's 100 ms penalty
        open_now = snap("client.breaker.open_now")
        warned = hs.doctor().check("client")
        session.conf.serving_workers = V_WORKERS
        servers.append(QueryServer(session, port=dead[1]).start())
        session.conf.serving_workers = workers
        time.sleep(V_BREAKER_COOLDOWN_MS / 1000.0)
        probe_ms, to_close = [], 0
        while ep.breaker_state != "closed":
            if to_close == V_BREAKER_TRIES:
                raise AssertionError("phase V: the breaker never closed")
            table, ms = timed(breaker, "point")
            check("half-open", "point", table)
            probe_ms.append(ms)
            to_close += 1
        closed_now = snap("client.breaker.open_now")
        cleared = hs.doctor().check("client")
        breaker.close()
        transitions = moved(before)
        out["breaker"] = {
            "queries_to_open": to_open, "open_now": open_now,
            "doctor_open": [warned.status, warned.summary],
            "queries_to_close": to_close, "probe_ms": probe_ms,
            "open_now_closed": closed_now,
            "doctor_closed": cleared.status, "transitions": transitions,
            "open_now_after_close": snap("client.breaker.open_now")}
        if open_now != 1.0 or warned.status != "warn" \
                or closed_now != 0.0 or cleared.status != "ok" \
                or transitions != {"client.breaker.open": 1.0,
                                   "client.breaker.half_open": 1.0,
                                   "client.breaker.close": 1.0} \
                or out["breaker"]["open_now_after_close"] != 0.0:
            raise AssertionError(f"phase V: breaker {out['breaker']}")
        step("3_breaker")

        # 4. Hedging: the primary's read held V_SLOW_RECV_MS each time;
        # the hedge goes to the other endpoint after V_HEDGE_DELAY_MS.
        hedged = fleet([a, b], hedge_enabled=True,
                       hedge_delay_ms=V_HEDGE_DELAY_MS, max_attempts=2)
        for _ in range(4):  # both endpoints pooled
            check("hedge warm", "point", timed(hedged, "point")[0])
        clean_ms = [timed(hedged, "point")[1] for _ in range(3)]
        sent0, wins0 = snap("client.hedge.sent"), snap("client.hedge.wins")
        hedge_ms = []
        for _ in range(V_HEDGES):
            faults.install(faults.FaultPlan("net.recv", "slow", at=1,
                                            count=1,
                                            latency_ms=V_SLOW_RECV_MS))
            try:
                table, ms = timed(hedged, "point")
            finally:
                faults.clear()
            check("hedged", "point", table)
            hedge_ms.append(ms)
        sent = snap("client.hedge.sent") - sent0
        wins = snap("client.hedge.wins") - wins0
        # The losers read their late answers to the end on their threads.
        time.sleep(V_SLOW_RECV_MS / 1000.0 + 0.1)
        out["hedge"] = {"sent": sent, "wins": wins, "ms": hedge_ms,
                        "clean_ms": clean_ms}
        if sent != V_HEDGES or not 1 <= wins <= sent:
            raise AssertionError(f"phase V: hedges {out['hedge']}")
        step("4_hedge")

        # 5. The proxy: a plain client of a third server that forwards
        # to a and b; the join through it against a direct, in turns;
        # an upstream BUSY arrives as BUSY with its hint.
        servers.append(QueryServer(session, proxy_endpoints=[a, b]).start())
        proxy = servers[-1].address
        proxy_ms = {}
        with QueryClient(proxy, timeout_s=T_BOUND_S) as c:
            for name, spec in specs.items():
                t0 = time.perf_counter()
                table = c.query(spec)
                proxy_ms[name] = (time.perf_counter() - t0) * 1e3
                check("proxy", name, table)
        join_ms: dict = {"direct": [], "proxy": []}
        with QueryClient(a, timeout_s=T_BOUND_S) as direct, \
                QueryClient(proxy, timeout_s=T_BOUND_S) as proxied:
            for label in ("direct", "proxy", "proxy", "direct")[
                    :2 * V_JOIN_RUNS]:
                c = direct if label == "direct" else proxied
                t0 = time.perf_counter()
                table = c.query(specs["join"])
                join_ms[label].append((time.perf_counter() - t0) * 1e3)
                check(f"join {label}", "join", table)
        busy.append(VBusyEndpoint(V_PROXY_HINT_MS))
        servers.append(QueryServer(
            session, proxy_endpoints=[busy[-1].address]).start())
        with QueryClient(servers[-1].address, timeout_s=T_BOUND_S) as c:
            try:
                c.query(specs["point"])
            except ServerBusyError as e:
                shed = e
            else:
                raise AssertionError("phase V: a BUSY upstream answered")
        if not shed.retryable or shed.retry_after_ms != V_PROXY_HINT_MS:
            raise AssertionError(f"phase V: the proxied BUSY {shed!r}, "
                                 f"retry-after {shed.retry_after_ms}")
        out["proxy"] = {"ms": proxy_ms, "join_ms": join_ms,
                        "busy": {"message": shed.message,
                                 "retry_after_ms": shed.retry_after_ms,
                                 "upstream_hits": busy[-1].hits}}
        step("5_proxy")

        # 6. One scrape of the process's registry.
        with MetricsScrapeServer() as scraper:
            host, port = scraper.address
            t0 = time.perf_counter()
            with urllib.request.urlopen(f"http://{host}:{port}/metrics",
                                        timeout=T_BOUND_S) as resp:
                body = resp.read()
            scrape_ms = (time.perf_counter() - t0) * 1e3
        text = body.decode("utf-8")
        missing = [s for s in V_SCRAPED if f"\n{s} " not in text]
        if missing:
            raise AssertionError(f"phase V: the scrape lacks {missing}")
        out["scrape"] = {"ms": scrape_ms, "bytes": len(body),
                         "client_series": sum(
                             1 for line in text.splitlines()
                             if line.startswith("hyperspace_client_"))}
        step("6_scrape")
        launches = kernels.launch_counts()
        if cuda:
            require_launches("phase V", launches,
                             {"hash_buckets": 0, "bucket_histogram": 0})
    finally:
        faults.clear()
        for fc in clients:
            fc.close()
        for s in servers:
            s.stop()
        for e in busy:
            e.close()
        session.disable_hyperspace()
        device_cache().clear()
    out.update(launches=launches, steps_s=steps,
               phase_s=time.perf_counter() - t_phase)
    return out


W_SOURCES = ("w_hive", "w_csv", "w_orc", "w_json", "w_avro", "w_text")
W_INDEXES = "w_indexes"         # phase W's system path
W_STATUSES = 4                  # l_status in 0..3: one directory each
W_SMALL_FILES = 16              # the JSON and text sources' files
W_AVRO_ROWS = 100_000           # cut: the Avro codec is pure Python
W_AVRO_FILES = 4
W_STATUS = 2                    # the hive query's partition
W_KEY_ROW = 12_345              # the orders row of the avro/text points
W_APPENDED_SEED = 211           # the rows of the partition l_status=4/
W_TIMED = 1                     # warm runs after the checked cold one


def w_slices(table: dict, parts: int) -> list:
    """``table`` as ``parts`` consecutive arrow slices, as write_files
    cuts it."""
    import pyarrow as pa

    t = pa.table(table)
    step = -(-t.num_rows // parts)
    return [t.slice(f * step, step) for f in range(parts)]


def w_json_lines(t) -> str:
    """Newline-delimited JSON of an arrow table of numbers, formatted by
    arrow's casts to string (the shortest text that reads back the same
    double)."""
    import pyarrow as pa
    import pyarrow.compute as pc

    parts: list = []
    for i, name in enumerate(t.column_names):
        parts += [("{" if i == 0 else ",") + json.dumps(name) + ":",
                  pc.cast(t.column(name), pa.string())]
    lines = pc.binary_join_element_wise(*parts, "}", "")
    return "\n".join(lines.to_pylist()) + "\n"


def w_write(orders: dict, li: dict, root: str) -> dict:
    """The six sources of phase W under ``root``: name -> {path, files,
    mb (on disk), write_s}."""
    from concurrent.futures import ThreadPoolExecutor

    import pyarrow as pa
    import pyarrow.csv as pacsv
    import pyarrow.orc as paorc
    import pyarrow.parquet as pq

    from hyperspace_tpu_torch.io import avro

    out: dict = {}

    def written(name: str, t0: float) -> None:
        path = os.path.join(root, name)
        files = [os.path.join(d, f) for d, _, fs in os.walk(path) for f in fs]
        out[name] = {"path": path, "files": len(files),
                     "mb": sum(os.path.getsize(f) for f in files) / 1e6,
                     "write_s": time.perf_counter() - t0}

    def in_pool(jobs: list) -> None:
        with ThreadPoolExecutor(8) as pool:
            list(pool.map(lambda job: job[0](*job[1:]), jobs))

    # w_hive: rows by l_status (stable), N_FILES // W_STATUSES files per
    # l_status=K/ directory, l_status itself only in the paths.
    t0 = time.perf_counter()
    status = li["l_status"]
    order = np.argsort(status, kind="stable")
    hive = pa.table({c: v[order] for c, v in li.items() if c != "l_status"})
    per = N_FILES // W_STATUSES
    jobs, start = [], 0
    for k, count in enumerate(np.bincount(status, minlength=W_STATUSES)):
        d = os.path.join(root, "w_hive", f"l_status={k}")
        os.makedirs(d)
        step = -(-int(count) // per)
        for f in range(per):
            jobs.append((pq.write_table, hive.slice(start + f * step,
                                                    min(step, int(count) - f * step)),
                         os.path.join(d, f"part-{f:05d}.parquet")))
        start += int(count)
    in_pool(jobs)
    del hive
    written("w_hive", t0)
    # w_csv and w_orc: phase C's slices.
    for name, ext, write in (("w_csv", "csv", pacsv.write_csv),
                             ("w_orc", "orc", paorc.write_table)):
        t0 = time.perf_counter()
        os.makedirs(os.path.join(root, name))
        in_pool([(write, s, os.path.join(root, name, f"part-{f:05d}.{ext}"))
                 for f, s in enumerate(w_slices(li, N_FILES))])
        written(name, t0)
    # w_json: the orders, newline-delimited.
    t0 = time.perf_counter()
    os.makedirs(os.path.join(root, "w_json"))
    for f, s in enumerate(w_slices(orders, W_SMALL_FILES)):
        with open(os.path.join(root, "w_json", f"part-{f:05d}.json"),
                  "w") as fh:
            fh.write(w_json_lines(s))
    written("w_json", t0)
    # w_avro: the orders' first W_AVRO_ROWS rows.
    t0 = time.perf_counter()
    os.makedirs(os.path.join(root, "w_avro"))
    schema = {"type": "record", "name": "orders", "fields": [
        {"name": c, "type": "double" if c == "o_totalprice" else "long"}
        for c in orders]}
    head = {c: v[:W_AVRO_ROWS].tolist() for c, v in orders.items()}
    step = -(-W_AVRO_ROWS // W_AVRO_FILES)
    for f in range(W_AVRO_FILES):
        lo, hi = f * step, min(W_AVRO_ROWS, (f + 1) * step)
        avro.write_container(
            os.path.join(root, "w_avro", f"part-{f:05d}.avro"), schema,
            [dict(zip(head, row)) for row in zip(*(v[lo:hi]
                                                   for v in head.values()))])
    written("w_avro", t0)
    # w_text: one line "order-<o_orderkey>" per order.
    t0 = time.perf_counter()
    os.makedirs(os.path.join(root, "w_text"))
    keys = orders["o_orderkey"]
    step = -(-len(keys) // W_SMALL_FILES)
    for f in range(W_SMALL_FILES):
        with open(os.path.join(root, "w_text", f"part-{f:05d}.txt"),
                  "w") as fh:
            fh.write("".join(f"order-{k}\n"
                             for k in keys[f * step:(f + 1) * step].tolist()))
    written("w_text", t0)
    return out


def w_as_read(label: str, want: dict, table, changed: dict) -> dict:
    """``want`` with each column in the type the reader gave ``table``'s
    (CSV reads whole doubles as int64), the change noted in ``changed``;
    a change that loses a value fails."""
    out = {}
    for c, values in want.items():
        got = table.column(c).type.to_pandas_dtype()
        if np.dtype(got) != values.dtype and values.dtype != object:
            cast = values.astype(got)
            if not np.array_equal(cast, values):
                raise AssertionError(f"{label}: {c} read as {got} loses "
                                     f"values of {values.dtype}")
            changed[c] = f"{values.dtype}->{np.dtype(got)}"
            values = cast
        out[c] = values
    return out


def w_bucket_tables(session, name: str) -> dict:
    """bucket -> the index ``name``'s rows of that bucket, its files in
    name order (one per bucket here)."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from hyperspace_tpu_torch.io.parquet import bucket_id_of_file

    entry = session.index_collection_manager.get_index(name)
    files: dict = {}
    for f in entry.content.file_infos():
        files.setdefault(bucket_id_of_file(f.name), []).append(f.name)
    return {b: pa.concat_tables([pq.read_table(p, partitioning=None)
                                 for p in sorted(paths)])
            for b, paths in files.items()}


def w_same_buckets(label: str, got: dict, want: dict, changed: dict) -> int:
    """Each bucket of ``got`` holds ``want``'s rows in order, value for
    value (a column read in another type compared in ``want``'s);
    returns the rows compared."""
    if sorted(got) != sorted(want):
        raise AssertionError(f"{label}: buckets {sorted(got)} against "
                             f"{sorted(want)}")
    rows = 0
    for b, t in want.items():
        g = got[b]
        if g.column_names != t.column_names or g.num_rows != t.num_rows:
            raise AssertionError(f"{label}: bucket {b} has {g.column_names} "
                                 f"x {g.num_rows}, expected "
                                 f"{t.column_names} x {t.num_rows}")
        for c in t.column_names:
            w = t.column(c).to_numpy()
            x = g.column(c).to_numpy()
            if x.dtype != w.dtype:
                changed[c] = f"{w.dtype}->{x.dtype}"
                x = x.astype(w.dtype)
            if not np.array_equal(x, w):
                raise AssertionError(f"{label}: bucket {b} column {c} "
                                     f"differs from {INDEX_NAME}'s")
        rows += t.num_rows
    return rows


def phase_w(orders: dict, li: dict, root: str, dev,
            parquet_read_s=None) -> dict:
    """The source formats, hive partitions and globs at SF1 (see the
    module docstring): six sources beside phase C's lineitem, their
    builds held to ``li_idx`` and numpy, the queries cold and warm."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from hyperspace_tpu_torch import (
        DataSkippingIndexConfig,
        Hyperspace,
        HyperspaceSession,
        IndexConfig,
        col,
    )
    from hyperspace_tpu_torch.ops import kernels
    from hyperspace_tpu_torch.ops.hash import bucket_ids_np

    t_phase = time.perf_counter()
    cuda = dev.type == "cuda"
    steps: dict = {}

    def step(label: str) -> None:
        steps[label] = time.perf_counter() - t_phase - sum(steps.values())

    device_cache().clear()
    kernels.reset_launch_counts()
    sources = w_write(orders, li, root)
    step("1_write")
    session = HyperspaceSession(system_path=os.path.join(root, W_INDEXES),
                                device=dev)
    session.conf.num_buckets = NUM_BUCKETS
    session.conf.device_batch_rows = 1 << 23
    set_min_rows(session, 0)
    hs = Hyperspace(session)
    changed: dict = {}
    builds: dict = {}

    def build(label: str, source: str, fmt: str, config,
              batch_rows: int = 1 << 23, paths=None) -> dict:
        """``config``'s index over ``source`` (or ``paths`` of it) read
        as ``fmt``; its wall, read seconds and bytes as ``label``."""
        session.conf.device_batch_rows = batch_rows
        ds = session.read.format(fmt).load(
            *(paths or [sources[source]["path"]]))
        t0 = time.perf_counter()
        hs.create_index(ds, config)
        wall = time.perf_counter() - t0
        phases = session.build_stats_log[-1]
        report = checked_report(f"phase W {config.index_name}", hs)
        rec = {"index": config.index_name, "format": fmt, "wall_s": wall,
               "read_s": phases.get("read_s"),
               "spilled": "spill_route_s" in phases,
               "mb_on_disk": sources[source]["mb"],
               "mb_read": report["bytes_read"] / 1e6,
               "mb_written": report["bytes_written"] / 1e6,
               "files": sources[source]["files"]}
        builds[label] = rec
        session.conf.device_batch_rows = 1 << 23
        return rec

    # (1) w_csv: the spill build with the default batch, held to li_idx
    # bucket by bucket; (2) w_orc monolithic, the same.
    li_session = HyperspaceSession(system_path=os.path.join(root, "indexes"),
                                   device=dev)
    want_buckets = w_bucket_tables(li_session, INDEX_NAME)
    chunks = -(-N_LINEITEM // DEFAULT_BATCH_ROWS)
    rec = build("w_csv", "w_csv", "csv",
                IndexConfig("w_csv_idx", INDEXED, INCLUDED),
                DEFAULT_BATCH_ROWS)
    if rec["spilled"] != (chunks > 1):
        raise AssertionError(f"phase W: the CSV build spilled="
                             f"{rec['spilled']} for {chunks} chunks")
    rec["chunks"] = chunks
    rec["rows_checked"] = w_same_buckets(
        "phase W w_csv_idx", w_bucket_tables(session, "w_csv_idx"),
        want_buckets, changed)
    rec = build("w_orc", "w_orc", "orc",
                IndexConfig("w_orc_idx", INDEXED, INCLUDED))
    if rec["spilled"]:
        raise AssertionError("phase W: the ORC build spilled")
    orc_changed: dict = {}
    rec["rows_checked"] = w_same_buckets(
        "phase W w_orc_idx", w_bucket_tables(session, "w_orc_idx"),
        want_buckets, orc_changed)
    if orc_changed:
        raise AssertionError(f"phase W: ORC changed types {orc_changed}")
    del want_buckets
    step("2_csv_orc")

    # (3) w_hive: the partition column against numpy, row for row in the
    # index's layout (source order is l_status's stable order).
    hive_cols = ["l_orderkey", "l_status", "l_extendedprice"]
    rec = build("w_hive", "w_hive", "parquet", IndexConfig(
        "w_hive_idx", ["l_orderkey"], ["l_status", "l_extendedprice"]))
    order = np.argsort(li["l_status"], kind="stable")
    keys = li["l_orderkey"][order]
    hw, _ = int64_words(keys)
    buckets = bucket_ids_np([hw], NUM_BUCKETS)
    layout = order[np.lexsort((keys, buckets))]
    got = w_bucket_tables(session, "w_hive_idx")
    got = pa.concat_tables([got[b] for b in sorted(got)])
    for c in hive_cols:
        if not np.array_equal(got.column(c).to_numpy(), li[c][layout]):
            raise AssertionError(f"phase W w_hive_idx: {c} differs from "
                                 f"numpy's in the index's layout")
    rec["rows_checked"] = got.num_rows
    del got, order, keys, hw, buckets, layout
    # (6) the data-skipping index on the partition column.
    t0 = time.perf_counter()
    hs.create_index(session.read.parquet(sources["w_hive"]["path"]),
                    DataSkippingIndexConfig("w_ds", ["l_status"]))
    ds_create_s = time.perf_counter() - t0
    step("3_hive")

    # JSON, Avro and text builds for the queries.
    for source, fmt, config in (
            ("w_json", "json", IndexConfig("w_json_idx", ["o_orderkey"],
                                           ["o_totalprice"])),
            ("w_avro", "avro", IndexConfig("w_avro_idx", ["o_orderkey"],
                                           ["o_totalprice"])),
            ("w_text", "text", IndexConfig("w_text_idx", ["value"], []))):
        build(source, source, fmt, config)
    step("4_json_avro_text")

    # (4) the queries, indexed, cold then warm, each held to numpy.
    session.enable_hyperspace()
    queries: dict = {}
    exp = expected_answers(orders, li)
    key = int(orders["o_orderkey"][W_KEY_ROW])
    total = float(orders["o_totalprice"][W_KEY_ROW])
    hive_mask = li["l_status"] == W_STATUS
    csv_src = session.read.csv(sources["w_csv"]["path"])
    json_src = session.read.json(sources["w_json"]["path"])
    cases = {
        "csv_point": (csv_src.filter(col("l_orderkey") == POINT_KEY)
                      .select("l_orderkey", "l_quantity"),
                      exp["point"], ["w_csv_idx"]),
        "csv_range": (csv_src.filter((col("l_orderkey") >= RANGE[0])
                                     & (col("l_orderkey") < RANGE[1]))
                      .select("l_orderkey", "l_extendedprice", "l_discount"),
                      exp["range"], ["w_csv_idx"]),
        "hive_status": (session.read.parquet(sources["w_hive"]["path"])
                        .filter(col("l_status") == W_STATUS)
                        .select(*hive_cols),
                        ({c: li[c][hive_mask] for c in hive_cols},
                         ["l_orderkey", "l_extendedprice"]), []),
        "csv_json_join": (json_src.join(csv_src, col("o_orderkey")
                                        == col("l_orderkey"))
                          .select("o_orderkey", "o_totalprice",
                                  "l_quantity", "l_extendedprice"),
                          exp["join"], ["w_json_idx", "w_csv_idx"]),
        "avro_point": (session.read.avro(sources["w_avro"]["path"])
                       .filter(col("o_orderkey") == key)
                       .select("o_orderkey", "o_totalprice"),
                       ({"o_orderkey": np.array([key]),
                         "o_totalprice": np.array([total])}, None),
                       ["w_avro_idx"]),
        "text_point": (session.read.text(sources["w_text"]["path"])
                       .filter(col("value") == f"order-{key}"),
                       ({"value": np.array([f"order-{key}"],
                                           dtype=object)}, None),
                       ["w_text_idx"]),
    }
    for name, (ds, (want, sort_keys), indexes) in cases.items():
        plan = ds.optimized_plan()
        used = sorted(n for n, _ in index_scans(plan))
        if used != sorted(indexes):
            raise AssertionError(f"phase W {name}: indexes {used}, expected "
                                 f"{sorted(indexes)}:\n{plan.tree_string()}")
        kept = None
        if name == "hive_status":
            scans = [s.relation for s in plan.leaf_relations()
                     if s.relation.data_skipping_of]
            kept = scans[0].data_skipping_stats if scans else None
            if kept != (N_FILES // W_STATUSES, N_FILES):
                raise AssertionError(f"phase W: w_ds kept {kept} files, "
                                     f"expected {N_FILES // W_STATUSES} of "
                                     f"{N_FILES}")
        ms = []
        for run in range(1 + W_TIMED):
            if run == 0:
                device_cache().clear()
            t0 = time.perf_counter()
            table = ds.collect()
            ms.append((time.perf_counter() - t0) * 1e3)
            require_rows(f"phase W {name}", table,
                         w_as_read(f"phase W {name}", want, table, changed),
                         sort_keys)
        queries[name] = {"cold_ms": ms[0], "warm_ms": statistics.median(
            ms[1:]), "rows": table.num_rows, "indexes": used,
            "files_kept": kept}
    step("5_queries")

    # (5) globs and the pattern: the partition directories through a
    # glob, an index recorded under the pattern, a new partition served
    # by hybrid scan, then indexed after an incremental refresh.
    pattern = os.path.join(sources["w_hive"]["path"], "l_status=*")
    rows = session.read.parquet(pattern).count()
    if rows != N_LINEITEM:
        raise AssertionError(f"phase W: the glob read {rows} rows")
    dirs = [os.path.join(sources["w_hive"]["path"], f"l_status={k}")
            for k in range(W_STATUSES)]
    session.conf.globbing_pattern = pattern
    session.disable_hyperspace()
    build("w_glob", "w_hive", "parquet", IndexConfig(
        "w_glob_idx", ["l_orderkey"], ["l_discount"]), paths=dirs)
    entry = session.index_collection_manager.get_index("w_glob_idx")
    if entry.relations[0].root_paths != [pattern]:
        raise AssertionError(f"phase W: w_glob_idx records "
                             f"{entry.relations[0].root_paths}")
    appended = gen_lineitem(np.random.default_rng(W_APPENDED_SEED),
                            ROWS_PER_FILE)
    new_dir = os.path.join(sources["w_hive"]["path"],
                           f"l_status={W_STATUSES}")
    os.makedirs(new_dir)
    pq.write_table(pa.table({c: v for c, v in appended.items()
                             if c != "l_status"}),
                   os.path.join(new_dir, "part-00000.parquet"))
    in_range = (li["l_orderkey"] >= RANGE[0]) & (li["l_orderkey"] < RANGE[1])
    a_range = (appended["l_orderkey"] >= RANGE[0]) \
        & (appended["l_orderkey"] < RANGE[1])
    glob_want = {c: np.concatenate([li[c][in_range], appended[c][a_range]])
                 for c in ("l_orderkey", "l_discount")}
    glob_ds = session.read.parquet(pattern).filter(
        (col("l_orderkey") >= RANGE[0]) & (col("l_orderkey") < RANGE[1])) \
        .select("l_orderkey", "l_discount")
    session.enable_hyperspace()
    session.conf.hybrid_scan_enabled = True
    glob: dict = {"rows_read": rows}
    for label, hybrid in (("hybrid", True), ("refreshed", False)):
        if not hybrid:
            session.conf.hybrid_scan_enabled = False
            kernels_before = kernels.launch_counts()
            t0 = time.perf_counter()
            summary = hs.refresh_index("w_glob_idx", "incremental")
            glob["refresh_s"] = time.perf_counter() - t0
            launched = {k: v - kernels_before[k]
                        for k, v in kernels.launch_counts().items()}
            if (summary.outcome, summary.appended, summary.deleted) != \
                    ("ok", 1, 0):
                raise AssertionError(f"phase W: refresh {summary}")
            entry = session.index_collection_manager.get_index("w_glob_idx")
            newest = max({os.path.dirname(f.name)
                          for f in entry.content.file_infos()},
                         key=lambda d: int(d.rsplit("v__=", 1)[1]))
            indexed = sum(pq.ParquetFile(f.name).metadata.num_rows
                          for f in entry.content.file_infos()
                          if os.path.dirname(f.name) == newest)
            if indexed != ROWS_PER_FILE:
                raise AssertionError(f"phase W: the refresh indexed {indexed} "
                                     f"rows, not {ROWS_PER_FILE}")
            glob.update(refresh_rows=indexed, refresh_launches=launched)
        plan = glob_ds.optimized_plan()
        used = [n for n, _ in index_scans(plan)]
        merged = "Union" in plan.tree_string()
        if used != ["w_glob_idx"] or merged != hybrid:
            raise AssertionError(f"phase W glob {label}: indexes {used}, "
                                 f"union {merged}:\n{plan.tree_string()}")
        ms = []
        for run in range(1 + W_TIMED):
            if run == 0:
                device_cache().clear()
            t0 = time.perf_counter()
            table = glob_ds.collect()
            ms.append((time.perf_counter() - t0) * 1e3)
            require_rows(f"phase W glob {label}", table, glob_want,
                         ["l_orderkey", "l_discount"])
        glob[label] = {"cold_ms": ms[0], "warm_ms": statistics.median(ms[1:]),
                       "rows": table.num_rows}
    session.conf.globbing_pattern = ""
    session.disable_hyperspace()
    step("6_glob")
    launches = kernels.launch_counts()
    if cuda and not all(launches.values()):
        raise AssertionError(f"phase W: kernels not launched: {launches}")
    device_cache().clear()
    for name in W_SOURCES:
        shutil.rmtree(sources[name]["path"], ignore_errors=True)
    shutil.rmtree(os.path.join(root, W_INDEXES), ignore_errors=True)
    return {"sources": {k: {kk: vv for kk, vv in v.items() if kk != "path"}
                        for k, v in sources.items()},
            "builds": builds, "parquet_read_s": parquet_read_s,
            "ds_create_s": ds_create_s, "queries": queries, "glob": glob,
            "type_changes": changed, "launches": launches,
            "steps_s": steps, "phase_s": time.perf_counter() - t_phase}


def print_formats(w: dict) -> None:
    for name, b in w["builds"].items():
        print(f"phase W build {b['index']} ({b['format']}): wall "
              f"{b['wall_s']:.3f} s, read {b['read_s'] or 0.0:.3f} s "
              f"(phase C's Parquet {w['parquet_read_s'] or 0.0:.3f} s), "
              f"{b['mb_on_disk']:.1f} MB on disk, {b['mb_read']:.1f} MB "
              f"decoded, {b['mb_written']:.1f} MB written"
              + (", spilled" if b["spilled"] else ""), flush=True)
    for name, q in w["queries"].items():
        print(f"phase W {name}: cold {q['cold_ms']:.1f} warm "
              f"{q['warm_ms']:.1f} ms, {q['rows']} rows through "
              f"{q['indexes'] or 'w_ds'}"
              + (f", files kept {q['files_kept']}" if q["files_kept"] else ""),
              flush=True)
    g = w["glob"]
    print(f"phase W glob: {g['rows_read']} rows through the glob; hybrid "
          f"cold {g['hybrid']['cold_ms']:.1f} warm "
          f"{g['hybrid']['warm_ms']:.1f} ms; refresh {g['refresh_s']:.3f} s "
          f"indexed {g['refresh_rows']} rows, launches "
          f"{json.dumps(g['refresh_launches'])}; refreshed cold "
          f"{g['refreshed']['cold_ms']:.1f} warm "
          f"{g['refreshed']['warm_ms']:.1f} ms", flush=True)
    print(f"phase W: w_ds created in {w['ds_create_s']:.3f} s; types "
          f"changed by the readers {json.dumps(w['type_changes'])}; launches "
          f"{json.dumps(w['launches'])} ({w['phase_s']:.3f} s; by step "
          f"{json.dumps(w['steps_s'])})", flush=True)


X_SOURCE = "x_delta"            # phase C's lineitem as a Delta table
X_OVERWRITTEN = "x_delta_ow"    # a second table, overwritten
X_INDEXES = "x_indexes"         # phase X's system path
X_INDEX = "x_delta_idx"
X_COMMITS = 10                  # append commits of N_LINEITEM // X_COMMITS
X_APPENDED_SEED = 223           # v10: ROWS_PER_FILE rows
X_UPSERT_SEED = 227             # v11: the upserted rows' payloads
X_UPSERTED = 2                  # v11: keys upserted
X_RANGE = (600_000, 675_000)    # 5% of the order keys
X_OW_ROWS = 100_000             # the overwrite's rows
X_OW_COMMITS = 2                # the commits it overwrites
X_TIMED = 1                     # warm runs after the checked cold one


def x_mb(path: str) -> float:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs) / 1e6


def x_rows(columns: dict, mask) -> dict:
    return {c: v[mask] for c, v in columns.items()}


def x_concat(*parts) -> dict:
    return {c: np.concatenate([p[c] for p in parts]) for c in parts[0]}


def x_bucket_tables(session, name: str, columns: list, entry=None) -> dict:
    """bucket -> the rows of ``columns`` of the index ``name`` (or of
    ``entry``) in that bucket, its files in name order."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from hyperspace_tpu_torch.io.parquet import bucket_id_of_file

    entry = entry or session.index_collection_manager.get_index(name)
    files: dict = {}
    for f in entry.content.file_infos():
        files.setdefault(bucket_id_of_file(f.name), []).append(f.name)
    return {b: pa.concat_tables([pq.read_table(p, columns=columns,
                                               partitioning=None)
                                 for p in sorted(paths)])
            for b, paths in files.items()}


def x_same_buckets(label: str, got: dict, want: dict, key: str,
                   row_id: str) -> int:
    """Each bucket of ``got`` holds ``want``'s keys in order and its rows
    as the same multiset per key (compared in ``(key, row_id)`` order,
    ``row_id`` unique per row): rows of one key follow their source
    files, whose order in a Delta snapshot is by their random names.
    Returns the rows compared."""
    if sorted(got) != sorted(want):
        raise AssertionError(f"{label}: buckets {sorted(got)} against "
                             f"{sorted(want)}")
    rows = 0
    for b, t in want.items():
        g = got[b]
        if g.column_names != t.column_names or g.num_rows != t.num_rows:
            raise AssertionError(f"{label}: bucket {b} has {g.column_names} "
                                 f"x {g.num_rows}, expected "
                                 f"{t.column_names} x {t.num_rows}")
        w = {c: t.column(c).to_numpy() for c in t.column_names}
        x = {c: g.column(c).to_numpy() for c in t.column_names}
        if not np.array_equal(x[key], w[key]):
            raise AssertionError(f"{label}: bucket {b}'s keys differ from "
                                 f"{INDEX_NAME}'s")
        x, w = sorted_rows(x, [key, row_id]), sorted_rows(w, [key, row_id])
        for c in t.column_names:
            if not np.array_equal(x[c], w[c]):
                raise AssertionError(f"{label}: bucket {b} column {c} "
                                     f"differs from {INDEX_NAME}'s per key")
        rows += t.num_rows
    return rows


def x_query(label: str, ds, want: dict, keys, index: str,
            phase: str = "X") -> dict:
    """``ds`` through ``index`` (its plan's index scans), cold then warm,
    each equal to numpy's ``want``."""
    used = sorted({n for n, _ in index_scans(ds.optimized_plan())})
    if used != [index]:
        raise AssertionError(f"phase {phase} {label}: indexes {used}, "
                             f"expected [{index}]:\n"
                             f"{ds.optimized_plan().tree_string()}")
    ms = []
    for run in range(1 + X_TIMED):
        if run == 0:
            device_cache().clear()
        t0 = time.perf_counter()
        table = ds.collect()
        ms.append((time.perf_counter() - t0) * 1e3)
        require_rows(f"phase {phase} {label}", table, want, keys)
    return {"cold_ms": ms[0], "warm_ms": statistics.median(ms[1:]),
            "rows": table.num_rows}


def x_index_files(ds) -> set:
    """The files the plan of ``ds`` reads through its index scans."""
    return {p for s in ds.optimized_plan().leaf_relations()
            if s.relation.index_scan_of for p in s.relation.file_paths}


def phase_x(li: dict, root: str, dev, parquet_read_s=None) -> dict:
    """The Delta Lake source at SF1 (see the module docstring): phase C's
    lineitem as ``x_delta``, its index held to ``li_idx``, queries, an
    append through a checkpoint, time travel, CDC and an overwrite."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from hyperspace_tpu_torch import (
        Hyperspace,
        HyperspaceSession,
        IndexConfig,
        col,
    )
    from hyperspace_tpu_torch.ops import kernels
    from hyperspace_tpu_torch.sources.delta import DeltaLog, write_delta
    from hyperspace_tpu_torch.sources.delta.writer import (
        delete_rows_delta,
        upsert_delta,
    )

    t_phase = time.perf_counter()
    cuda = dev.type == "cuda"
    steps: dict = {}

    def step(label: str) -> None:
        steps[label] = time.perf_counter() - t_phase - sum(steps.values())

    device_cache().clear()
    kernels.reset_launch_counts()
    src = os.path.join(root, X_SOURCE)
    columns = list(li)
    # (0) v0-v9: phase C's rows in X_COMMITS appends.
    t0 = time.perf_counter()
    table = pa.table(li)
    step_rows = -(-N_LINEITEM // X_COMMITS)
    for v in range(X_COMMITS):
        got = write_delta(table.slice(v * step_rows, step_rows), src)
        if got != v:
            raise AssertionError(f"phase X: commit {got}, expected {v}")
    del table
    write = {"s": time.perf_counter() - t0, "mb": x_mb(src),
             "commits": X_COMMITS}
    log = DeltaLog(src)
    step("1_write")

    # (1) the index at v9: a spill build with the default batch, held to
    # li_idx bucket by bucket.
    session = HyperspaceSession(system_path=os.path.join(root, X_INDEXES),
                                device=dev)
    session.conf.num_buckets = NUM_BUCKETS
    session.conf.device_batch_rows = DEFAULT_BATCH_ROWS
    session.conf.lineage_enabled = True
    set_min_rows(session, 0)
    hs = Hyperspace(session)
    t0 = time.perf_counter()
    hs.create_index(session.read.delta(src),
                    IndexConfig(X_INDEX, INDEXED, INCLUDED))
    wall = time.perf_counter() - t0
    build_launches = kernels.launch_counts()
    phases = session.build_stats_log[-1]
    report = checked_report(f"phase X {X_INDEX}", hs)
    chunks = -(-N_LINEITEM // DEFAULT_BATCH_ROWS)
    if ("spill_route_s" in phases) != (chunks > 1):
        raise AssertionError(f"phase X: the build's phases {phases} for "
                             f"{chunks} chunks")
    entry = session.index_collection_manager.get_index(X_INDEX)
    rel = entry.relations[0]
    history = entry.properties.get("deltaVersions", "")
    if (rel.file_format, rel.options.get("versionAsOf")) != ("delta", "9") \
            or len(history.split(",")) != 1 or not history.endswith(":9"):
        raise AssertionError(f"phase X: entry {rel.file_format} "
                             f"{rel.options} deltaVersions {history!r}")
    v9_log_version = int(history.split(":")[0])
    li_session = HyperspaceSession(system_path=os.path.join(root, "indexes"),
                                   device=dev)
    cols = INDEXED + INCLUDED
    rows_checked = x_same_buckets(
        f"phase X {X_INDEX}", x_bucket_tables(session, X_INDEX, cols),
        x_bucket_tables(li_session, INDEX_NAME, cols), INDEXED[0],
        "l_shipdate")
    build = {"wall_s": wall, "read_s": phases.get("read_s"),
             "parquet_read_s": parquet_read_s, "chunks": chunks,
             "mb_read": report["bytes_read"] / 1e6,
             "mb_written": report["bytes_written"] / 1e6,
             "rows_checked": rows_checked, "launches": build_launches,
             "delta_versions": history}
    step("2_build")

    # (2) a point and a 5% range at v9, indexed, cold and warm.
    session.enable_hyperspace()
    key = li["l_orderkey"]
    in_range = (key >= X_RANGE[0]) & (key < X_RANGE[1])
    range_cols = ("l_orderkey", "l_extendedprice", "l_discount")
    range_keys = ["l_orderkey", "l_extendedprice"]
    queries = {
        "point": x_query("point", session.read.delta(src)
                         .filter(col("l_orderkey") == POINT_KEY)
                         .select("l_orderkey", "l_quantity"),
                         {c: li[c][key == POINT_KEY]
                          for c in ("l_orderkey", "l_quantity")},
                         ["l_orderkey", "l_quantity"], X_INDEX),
        "range": x_query("range", session.read.delta(src)
                         .filter((col("l_orderkey") >= X_RANGE[0])
                                 & (col("l_orderkey") < X_RANGE[1]))
                         .select(*range_cols),
                         {c: li[c][in_range] for c in range_cols},
                         range_keys, X_INDEX),
    }
    step("3_queries")

    # (3) v10: an append, which writes the first checkpoint; the snapshot
    # through it equals the JSON replay; the hybrid range; the
    # incremental refresh indexes the appended rows alone.
    appended = gen_lineitem(np.random.default_rng(X_APPENDED_SEED),
                            ROWS_PER_FILE)
    if write_delta(pa.table(appended), src) != X_COMMITS:
        raise AssertionError("phase X: the append is not version 10")
    checkpoint = os.path.join(log.log_path,
                              f"{X_COMMITS:020d}.checkpoint.parquet")
    if not (os.path.isfile(checkpoint) and os.path.isfile(
            os.path.join(log.log_path, "_last_checkpoint"))):
        raise AssertionError("phase X: no checkpoint at version 10")

    class JsonOnly(DeltaLog):
        def checkpoint_versions(self):
            return []

    t0 = time.perf_counter()
    snap9 = log.snapshot(X_COMMITS - 1)
    replay = {"v9_json_ms": (time.perf_counter() - t0) * 1e3}
    t0 = time.perf_counter()
    snap10 = log.snapshot(X_COMMITS)
    replay["v10_checkpoint_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    json10 = JsonOnly(src).snapshot(X_COMMITS)
    replay["v10_json_ms"] = (time.perf_counter() - t0) * 1e3
    if snap10.files != json10.files or len(snap10.files) != X_COMMITS + 1 \
            or len(snap9.files) != X_COMMITS:
        raise AssertionError("phase X: the checkpoint's snapshot differs "
                             "from the JSON replay")
    a_range = (appended["l_orderkey"] >= X_RANGE[0]) \
        & (appended["l_orderkey"] < X_RANGE[1])
    range_ds = session.read.delta(src) \
        .filter((col("l_orderkey") >= X_RANGE[0])
                & (col("l_orderkey") < X_RANGE[1])).select(*range_cols)
    with_appended = x_concat(x_rows({c: li[c] for c in range_cols},
                                    in_range),
                             x_rows({c: appended[c] for c in range_cols},
                                    a_range))
    session.conf.hybrid_scan_enabled = True
    if "Union" not in range_ds.optimized_plan().tree_string():
        raise AssertionError("phase X: the range after the append is not a "
                             "hybrid scan")
    queries["hybrid_range"] = x_query("hybrid_range", range_ds,
                                      with_appended, range_keys, X_INDEX)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    summary = hs.refresh_index(X_INDEX, "incremental")
    refresh_s = time.perf_counter() - t0
    refresh_launches = kernels.launch_counts()
    if (summary.outcome, summary.appended, summary.deleted) != ("ok", 1, 0):
        raise AssertionError(f"phase X: refresh {summary}")
    if cuda and refresh_launches != {"hash_buckets": 1,
                                     "bucket_histogram": 1}:
        raise AssertionError(f"phase X: the refresh launched "
                             f"{refresh_launches}")
    entry = session.index_collection_manager.get_index(X_INDEX)
    history = entry.properties["deltaVersions"]
    newest = max({os.path.dirname(f.name) for f in entry.content.file_infos()},
                 key=lambda d: int(d.rsplit("v__=", 1)[1]))
    new_rows = sum(pq.ParquetFile(f.name).metadata.num_rows
                   for f in entry.content.file_infos()
                   if os.path.dirname(f.name) == newest)
    if new_rows != ROWS_PER_FILE or len(history.split(",")) != 2 \
            or not history.endswith(":10"):
        raise AssertionError(f"phase X: the refresh indexed {new_rows} rows, "
                             f"deltaVersions {history!r}")
    step("4_append_refresh")

    # (4) time travel after the refresh: versionAsOf=9 and timestampAsOf=
    # v9's commit ms served by the index's v9 entry; versionAsOf=5.
    v9_entry = session.index_collection_manager.get_index(X_INDEX,
                                                          v9_log_version)
    v9_files = {f.name for f in v9_entry.content.file_infos()}
    v9_ms = log._commit_timestamp(X_COMMITS - 1)
    travel = {}
    first = {c: li[c][in_range] for c in range_cols}
    for label, options in (("version_9", {"versionAsOf": "9"}),
                           ("timestamp_9", {"timestampAsOf": str(v9_ms)})):
        ds = session.read.delta(src, **options) \
            .filter((col("l_orderkey") >= X_RANGE[0])
                    & (col("l_orderkey") < X_RANGE[1])).select(*range_cols)
        files = x_index_files(ds)
        if not files or not files <= v9_files:
            raise AssertionError(f"phase X {label}: the index scan reads "
                                 f"{len(files - v9_files)} files outside "
                                 f"the v9 entry's")
        travel[label] = x_query(label, ds, first, range_keys, X_INDEX)
    v5 = min(N_LINEITEM, (X_COMMITS // 2 + 1) * step_rows)
    ds = session.read.delta(src, versionAsOf=str(X_COMMITS // 2)) \
        .filter((col("l_orderkey") >= X_RANGE[0])
                & (col("l_orderkey") < X_RANGE[1])).select(*range_cols)
    t0 = time.perf_counter()
    table = ds.collect()
    travel["version_5"] = {"cold_ms": (time.perf_counter() - t0) * 1e3,
                           "rows": table.num_rows, "indexes": sorted(
                               {n for n, _ in index_scans(ds.optimized_plan())})}
    require_rows("phase X version_5", table,
                 x_rows(first, np.flatnonzero(in_range) < v5), range_keys)
    step("5_time_travel")

    # (5) CDC: v11 upserts X_UPSERTED keys, v12 deletes one, each found in
    # the appended rows alone (so the commits rewrite that file only);
    # the maintenance cycle journals a CDC quick refresh.
    only_appended = np.setdiff1d(np.unique(appended["l_orderkey"]),
                                 np.unique(li["l_orderkey"]))
    touched = only_appended[:X_UPSERTED + 1]
    if len(touched) != X_UPSERTED + 1:
        raise AssertionError("phase X: no key found in the appended rows "
                             "alone")
    upsert = gen_lineitem(np.random.default_rng(X_UPSERT_SEED), X_UPSERTED)
    upsert["l_orderkey"] = touched[:X_UPSERTED].astype(np.int64)
    upsert["l_shipdate"] = np.arange(X_UPSERTED, dtype=np.int64) - X_UPSERTED
    session.conf.lifecycle_cdc_enabled = True
    t0 = time.perf_counter()
    v11 = upsert_delta(pa.table(upsert), src, "l_orderkey")
    v12 = delete_rows_delta(src, "l_orderkey", [int(touched[-1])])
    cdc_write_s = time.perf_counter() - t0
    if (v11, v12) != (X_COMMITS + 1, X_COMMITS + 2):
        raise AssertionError(f"phase X: CDC commits {v11}, {v12}")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    recs = hs.maintenance_cycle()
    cycle_s = time.perf_counter() - t0
    cycle_launches = kernels.launch_counts()
    quick = [r for r in recs if r["decision"] == "refresh"
             and r["mode"] == "quick" and r["outcome"] == "done"
             and r["index"] == X_INDEX]
    if not quick or "CDC merge-on-read" not in quick[0]["reason"]:
        raise AssertionError(f"phase X: the cycle journaled {recs}")
    cdc_cols = ("l_orderkey", "l_quantity", "l_extendedprice")
    cdc_ds = session.read.delta(src) \
        .filter(col("l_orderkey").isin([int(k) for k in touched])) \
        .select(*cdc_cols)
    cdc = x_query("cdc", cdc_ds, {c: upsert[c] for c in cdc_cols},
                  ["l_orderkey", "l_quantity"], X_INDEX)
    cdc.update(reason=quick[0]["reason"], write_s=cdc_write_s,
               cycle_s=cycle_s, cycle_launches=cycle_launches,
               touched=[int(k) for k in touched])
    step("6_cdc")

    # (6) an overwrite: x_delta_ow's X_OW_COMMITS commits replaced by
    # X_OW_ROWS rows; the scan reads those rows alone.
    ow = os.path.join(root, X_OVERWRITTEN)
    ow_cols = ["l_orderkey", "l_shipdate", "l_extendedprice"]
    part = pa.table({c: li[c] for c in ow_cols})
    for i in range(X_OW_COMMITS):
        write_delta(part.slice(i * X_OW_ROWS, X_OW_ROWS), ow)
    base = X_OW_COMMITS * X_OW_ROWS
    write_delta(part.slice(base, X_OW_ROWS), ow, mode="overwrite")
    t0 = time.perf_counter()
    table = session.read.delta(ow).collect()
    overwrite = {"scan_ms": (time.perf_counter() - t0) * 1e3,
                 "rows": table.num_rows,
                 "files_on_disk": len([n for n in os.listdir(ow)
                                       if n.endswith(".parquet")])}
    require_rows("phase X overwrite", table,
                 {c: li[c][base:base + X_OW_ROWS] for c in ow_cols},
                 ["l_shipdate"])
    step("7_overwrite")

    session.disable_hyperspace()
    launches = {k: build_launches[k] + refresh_launches[k]
                + cycle_launches[k] for k in build_launches}
    if cuda and not all(launches.values()):
        raise AssertionError(f"phase X: kernels not launched: {launches}")
    device_cache().clear()
    for name in (X_SOURCE, X_OVERWRITTEN, X_INDEXES):
        shutil.rmtree(os.path.join(root, name), ignore_errors=True)
    return {"write": write, "build": build, "queries": queries,
            "replay": replay, "refresh": {"s": refresh_s,
                                          "launches": refresh_launches,
                                          "rows": new_rows,
                                          "delta_versions": history},
            "travel": travel, "cdc": cdc, "overwrite": overwrite,
            "launches": launches, "steps_s": steps,
            "phase_s": time.perf_counter() - t_phase}


def print_delta(x: dict) -> None:
    w, b = x["write"], x["build"]
    print(f"phase X write: {w['commits']} commits, {w['mb']:.1f} MB in "
          f"{w['s']:.3f} s", flush=True)
    print(f"phase X build {X_INDEX}: wall {b['wall_s']:.3f} s, read "
          f"{b['read_s'] or 0.0:.3f} s (phase C's Parquet "
          f"{b['parquet_read_s'] or 0.0:.3f} s), {b['mb_read']:.1f} MB "
          f"decoded, {b['mb_written']:.1f} MB written, {b['chunks']} chunks, "
          f"{b['rows_checked']} rows equal to {INDEX_NAME}'s per key, "
          f"deltaVersions {b['delta_versions']}, launches "
          f"{json.dumps(b['launches'])}", flush=True)
    for name, q in {**x["queries"], **x["travel"]}.items():
        warm = f" warm {q['warm_ms']:.1f}" if "warm_ms" in q else ""
        print(f"phase X {name}: cold {q['cold_ms']:.1f}{warm} ms, "
              f"{q['rows']} rows", flush=True)
    r, f = x["replay"], x["refresh"]
    print(f"phase X snapshot replay: v9 JSON {r['v9_json_ms']:.1f} ms, v10 "
          f"checkpoint {r['v10_checkpoint_ms']:.1f} ms (JSON "
          f"{r['v10_json_ms']:.1f} ms); refresh {f['s']:.3f} s indexed "
          f"{f['rows']} rows, launches {json.dumps(f['launches'])}, "
          f"deltaVersions {f['delta_versions']}", flush=True)
    c, o = x["cdc"], x["overwrite"]
    print(f"phase X cdc: commits {c['write_s']:.3f} s, maintenance cycle "
          f"{c['cycle_s']:.3f} s ({c['reason']}), touched keys cold "
          f"{c['cold_ms']:.1f} warm {c['warm_ms']:.1f} ms; overwrite scan "
          f"{o['scan_ms']:.1f} ms, {o['rows']} rows of {o['files_on_disk']} "
          f"files on disk", flush=True)
    print(f"phase X: launches {json.dumps(x['launches'])} "
          f"({x['phase_s']:.3f} s; by step {json.dumps(x['steps_s'])})",
          flush=True)


Y_SOURCE = "y_iceberg"          # phase C's lineitem as an Iceberg table
Y_OVERWRITTEN = "y_iceberg_ow"  # a second table, overwritten
Y_TORN = "y_torn"               # a copy of a metadata JSON, truncated
Y_INDEXES = "y_indexes"         # phase Y's system path
Y_INDEX = "y_iceberg_idx"
Y_COMMITS = 10                  # append snapshots of N_LINEITEM // Y_COMMITS
Y_APPENDED_SEED = 233           # the 11th snapshot: ROWS_PER_FILE rows
Y_UPSERT_SEED = 239             # the upserted rows' payloads
Y_UPSERTED = 2                  # keys upserted
Y_EARLY = 6                     # the snapshot read by the source route
Y_RANGE = (600_000, 675_000)    # 5% of the order keys
Y_OW_ROWS = 100_000             # the overwrite's rows
Y_OW_COMMITS = 2                # the snapshots it overwrites


def y_plan_ms(src: str, snapshot_id: int) -> tuple:
    """(ms to load the metadata and plan ``snapshot_id``'s files, the
    files)."""
    from hyperspace_tpu_torch.sources.iceberg import IcebergTable

    t0 = time.perf_counter()
    table = IcebergTable(src)
    md = table.load_metadata()
    files = table.plan_files(md.snapshot_by_id(snapshot_id), md)
    return (time.perf_counter() - t0) * 1e3, files


def phase_y(li: dict, root: str, dev, parquet_read_s=None) -> dict:
    """The Iceberg source at SF1 (see the module docstring): phase C's
    lineitem as ``y_iceberg``, its index held to ``li_idx``, queries, an
    append and a refresh, time travel, CDC, an overwrite with a schema
    change and a torn metadata file."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from hyperspace_tpu_torch import (
        Hyperspace,
        HyperspaceSession,
        IndexConfig,
        col,
    )
    from hyperspace_tpu_torch.exceptions import CorruptMetadataError
    from hyperspace_tpu_torch.ops import kernels
    from hyperspace_tpu_torch.sources.iceberg import (
        IcebergTable,
        write_iceberg,
    )
    from hyperspace_tpu_torch.sources.iceberg.writer import (
        delete_rows_iceberg,
        upsert_iceberg,
    )

    t_phase = time.perf_counter()
    cuda = dev.type == "cuda"
    steps: dict = {}

    def step(label: str) -> None:
        steps[label] = time.perf_counter() - t_phase - sum(steps.values())

    device_cache().clear()
    kernels.reset_launch_counts()
    src = os.path.join(root, Y_SOURCE)
    # (0) snapshots 1-10: phase C's rows in Y_COMMITS appends.
    t0 = time.perf_counter()
    table = pa.table(li)
    step_rows = -(-N_LINEITEM // Y_COMMITS)
    snaps = [write_iceberg(table.slice(i * step_rows, step_rows), src)
             for i in range(Y_COMMITS)]
    del table
    write = {"s": time.perf_counter() - t0, "mb": x_mb(src),
             "snapshots": Y_COMMITS}
    md = IcebergTable(src).load_metadata()
    if [s.snapshot_id for s in md.snapshots] != snaps \
            or md.current_snapshot_id != snaps[-1]:
        raise AssertionError("phase Y: the snapshots are not the appends'")
    step("1_write")

    # (1) the index at the 10th snapshot: a spill build with the default
    # batch, held to li_idx bucket by bucket.
    session = HyperspaceSession(system_path=os.path.join(root, Y_INDEXES),
                                device=dev)
    session.conf.num_buckets = NUM_BUCKETS
    session.conf.device_batch_rows = DEFAULT_BATCH_ROWS
    session.conf.lineage_enabled = True
    set_min_rows(session, 0)
    hs = Hyperspace(session)
    t0 = time.perf_counter()
    hs.create_index(session.read.iceberg(src),
                    IndexConfig(Y_INDEX, INDEXED, INCLUDED))
    wall = time.perf_counter() - t0
    build_launches = kernels.launch_counts()
    phases = session.build_stats_log[-1]
    report = checked_report(f"phase Y {Y_INDEX}", hs)
    chunks = -(-N_LINEITEM // DEFAULT_BATCH_ROWS)
    if ("spill_route_s" in phases) != (chunks > 1):
        raise AssertionError(f"phase Y: the build's phases {phases} for "
                             f"{chunks} chunks")
    if cuda and build_launches != {"hash_buckets": chunks,
                                   "bucket_histogram": chunks}:
        raise AssertionError(f"phase Y: the build launched {build_launches}")
    entry = session.index_collection_manager.get_index(Y_INDEX)
    rel = entry.relations[0]
    history = entry.properties.get("icebergSnapshots", "")
    if (rel.file_format, rel.options.get("snapshot-id")) \
            != ("iceberg", str(snaps[-1])) \
            or len(history.split(",")) != 1 \
            or not history.endswith(f":{snaps[-1]}"):
        raise AssertionError(f"phase Y: entry {rel.file_format} "
                             f"{rel.options} icebergSnapshots {history!r}")
    build_log_version = int(history.split(":")[0])
    li_session = HyperspaceSession(system_path=os.path.join(root, "indexes"),
                                   device=dev)
    cols = INDEXED + INCLUDED
    rows_checked = x_same_buckets(
        f"phase Y {Y_INDEX}", x_bucket_tables(session, Y_INDEX, cols),
        x_bucket_tables(li_session, INDEX_NAME, cols), INDEXED[0],
        "l_shipdate")
    build = {"wall_s": wall, "read_s": phases.get("read_s"),
             "parquet_read_s": parquet_read_s, "chunks": chunks,
             "mb_read": report["bytes_read"] / 1e6,
             "mb_written": report["bytes_written"] / 1e6,
             "rows_checked": rows_checked, "launches": build_launches,
             "iceberg_snapshots": history}
    step("2_build")

    # (2) a point and a 5% range at the 10th snapshot, cold and warm.
    session.enable_hyperspace()
    key = li["l_orderkey"]
    in_range = (key >= Y_RANGE[0]) & (key < Y_RANGE[1])
    range_cols = ("l_orderkey", "l_extendedprice", "l_discount")
    range_keys = ["l_orderkey", "l_extendedprice"]

    def range_of(**options):
        return session.read.iceberg(src, **options) \
            .filter((col("l_orderkey") >= Y_RANGE[0])
                    & (col("l_orderkey") < Y_RANGE[1])).select(*range_cols)

    first = {c: li[c][in_range] for c in range_cols}
    queries = {
        "point": x_query("point", session.read.iceberg(src)
                         .filter(col("l_orderkey") == POINT_KEY)
                         .select("l_orderkey", "l_quantity"),
                         {c: li[c][key == POINT_KEY]
                          for c in ("l_orderkey", "l_quantity")},
                         ["l_orderkey", "l_quantity"], Y_INDEX, "Y"),
        "range": x_query("range", range_of(), first, range_keys, Y_INDEX,
                         "Y"),
    }
    step("3_queries")

    # (3) the 11th snapshot: an append; the planned files over 10 and 11
    # snapshots; the hybrid range; the incremental refresh indexes the
    # appended rows alone, and the range after it.
    appended = gen_lineitem(np.random.default_rng(Y_APPENDED_SEED),
                            ROWS_PER_FILE)
    snaps.append(write_iceberg(pa.table(appended), src))
    plan = {}
    for n in (Y_COMMITS, Y_COMMITS + 1):
        ms, files = y_plan_ms(src, snaps[n - 1])
        if len(files) != n:
            raise AssertionError(f"phase Y: {len(files)} files planned at "
                                 f"snapshot {n}")
        plan[f"snapshot_{n}_ms"] = ms
    a_range = (appended["l_orderkey"] >= Y_RANGE[0]) \
        & (appended["l_orderkey"] < Y_RANGE[1])
    with_appended = x_concat(first, x_rows({c: appended[c]
                                            for c in range_cols}, a_range))
    session.conf.hybrid_scan_enabled = True
    if "Union" not in range_of().optimized_plan().tree_string():
        raise AssertionError("phase Y: the range after the append is not a "
                             "hybrid scan")
    queries["hybrid_range"] = x_query("hybrid_range", range_of(),
                                      with_appended, range_keys, Y_INDEX, "Y")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    summary = hs.refresh_index(Y_INDEX, "incremental")
    refresh_s = time.perf_counter() - t0
    refresh_launches = kernels.launch_counts()
    if (summary.outcome, summary.appended, summary.deleted) != ("ok", 1, 0):
        raise AssertionError(f"phase Y: refresh {summary}")
    if cuda and refresh_launches != {"hash_buckets": 1,
                                     "bucket_histogram": 1}:
        raise AssertionError(f"phase Y: the refresh launched "
                             f"{refresh_launches}")
    entry = session.index_collection_manager.get_index(Y_INDEX)
    history = entry.properties["icebergSnapshots"]
    newest = max({os.path.dirname(f.name) for f in entry.content.file_infos()},
                 key=lambda d: int(d.rsplit("v__=", 1)[1]))
    new_rows = sum(pq.ParquetFile(f.name).metadata.num_rows
                   for f in entry.content.file_infos()
                   if os.path.dirname(f.name) == newest)
    if new_rows != ROWS_PER_FILE or len(history.split(",")) != 2 \
            or not history.endswith(f":{snaps[-1]}"):
        raise AssertionError(f"phase Y: the refresh indexed {new_rows} rows, "
                             f"icebergSnapshots {history!r}")
    if "Union" in range_of().optimized_plan().tree_string():
        raise AssertionError("phase Y: the range after the refresh is still "
                             "a hybrid scan")
    queries["refreshed_range"] = x_query("refreshed_range", range_of(),
                                         with_appended, range_keys, Y_INDEX,
                                         "Y")
    step("4_append_refresh")

    # (4) time travel after the refresh: snapshot_id and as_of_timestamp
    # of the 10th snapshot served by the build's entry (closest_index);
    # the 6th snapshot by the source route.
    tenth = IcebergTable(src).load_metadata().snapshot_by_id(snaps[9])
    build_files = {f.name for f in session.index_collection_manager
                   .get_index(Y_INDEX, build_log_version).content.file_infos()}
    travel = {}
    for label, options in (
            ("snapshot_10", {"snapshot_id": str(tenth.snapshot_id)}),
            ("timestamp_10", {"as_of_timestamp": str(tenth.timestamp_ms)})):
        ds = range_of(**options)
        files = x_index_files(ds)
        if not files or not files <= build_files:
            raise AssertionError(f"phase Y {label}: the index scan reads "
                                 f"{len(files - build_files)} files outside "
                                 f"the build's entry")
        travel[label] = x_query(label, ds, first, range_keys, Y_INDEX, "Y")
    early = min(N_LINEITEM, Y_EARLY * step_rows)
    ds = range_of(snapshot_id=str(snaps[Y_EARLY - 1]))
    used = sorted({n for n, _ in index_scans(ds.optimized_plan())})
    if used:
        raise AssertionError(f"phase Y snapshot_{Y_EARLY}: indexes {used}, "
                             f"expected the source route")
    t0 = time.perf_counter()
    table = ds.collect()
    travel[f"snapshot_{Y_EARLY}"] = {
        "cold_ms": (time.perf_counter() - t0) * 1e3, "rows": table.num_rows,
        "indexes": used}
    require_rows(f"phase Y snapshot_{Y_EARLY}", table,
                 x_rows(first, np.flatnonzero(in_range) < early), range_keys)
    step("5_time_travel")

    # (5) CDC: one snapshot upserts Y_UPSERTED keys, the next deletes one,
    # each found in the appended rows alone (so the commits rewrite that
    # file only); the maintenance cycle journals a CDC quick refresh.
    only_appended = np.setdiff1d(np.unique(appended["l_orderkey"]),
                                 np.unique(li["l_orderkey"]))
    touched = only_appended[:Y_UPSERTED + 1]
    if len(touched) != Y_UPSERTED + 1:
        raise AssertionError("phase Y: no key found in the appended rows "
                             "alone")
    upsert = gen_lineitem(np.random.default_rng(Y_UPSERT_SEED), Y_UPSERTED)
    upsert["l_orderkey"] = touched[:Y_UPSERTED].astype(np.int64)
    upsert["l_shipdate"] = np.arange(Y_UPSERTED, dtype=np.int64) - Y_UPSERTED
    session.conf.lifecycle_cdc_enabled = True
    t0 = time.perf_counter()
    snaps.append(upsert_iceberg(pa.table(upsert), src, "l_orderkey"))
    snaps.append(delete_rows_iceberg(src, "l_orderkey", [int(touched[-1])]))
    cdc_write_s = time.perf_counter() - t0
    md = IcebergTable(src).load_metadata()
    if [s.snapshot_id for s in md.snapshots] != snaps \
            or [s.summary["operation"] for s in md.snapshots[-2:]] \
            != ["overwrite", "delete"]:
        raise AssertionError("phase Y: the CDC snapshots are not the upsert "
                             "and the delete")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    recs = hs.maintenance_cycle()
    cycle_s = time.perf_counter() - t0
    cycle_launches = kernels.launch_counts()
    quick = [r for r in recs if r["decision"] == "refresh"
             and r["mode"] == "quick" and r["outcome"] == "done"
             and r["index"] == Y_INDEX]
    if not quick or "CDC merge-on-read" not in quick[0]["reason"]:
        raise AssertionError(f"phase Y: the cycle journaled {recs}")
    cdc_cols = ("l_orderkey", "l_quantity", "l_extendedprice")
    cdc_ds = session.read.iceberg(src) \
        .filter(col("l_orderkey").isin([int(k) for k in touched])) \
        .select(*cdc_cols)
    cdc = x_query("cdc", cdc_ds, {c: upsert[c] for c in cdc_cols},
                  ["l_orderkey", "l_quantity"], Y_INDEX, "Y")
    cdc.update(reason=quick[0]["reason"], write_s=cdc_write_s,
               cycle_s=cycle_s, cycle_launches=cycle_launches,
               touched=[int(k) for k in touched])
    step("6_cdc")

    # (6) an overwrite that changes the schema: y_iceberg_ow's
    # Y_OW_COMMITS snapshots replaced by Y_OW_ROWS rows with l_shipdate
    # dropped and l_discount added; the surviving columns keep their
    # field ids, l_discount takes the next, and a scan reads those rows.
    ow = os.path.join(root, Y_OVERWRITTEN)
    part = pa.table({c: li[c] for c in ("l_orderkey", "l_shipdate",
                                         "l_extendedprice")})
    for i in range(Y_OW_COMMITS):
        write_iceberg(part.slice(i * Y_OW_ROWS, Y_OW_ROWS), ow)
    base = Y_OW_COMMITS * Y_OW_ROWS
    ow_cols = ["l_orderkey", "l_discount", "l_extendedprice"]
    write_iceberg(pa.table({c: li[c][base:base + Y_OW_ROWS]
                            for c in ow_cols}), ow, mode="overwrite")
    ow_md = IcebergTable(ow).load_metadata()
    ids = {f["name"]: f["id"] for f in ow_md.schema["fields"]}
    if ids != {"l_orderkey": 1, "l_discount": 4, "l_extendedprice": 3} \
            or ow_md.last_column_id != 4:
        raise AssertionError(f"phase Y: the overwrite's field ids {ids}, "
                             f"last-column-id {ow_md.last_column_id}")
    t0 = time.perf_counter()
    table = session.read.iceberg(ow).collect()
    overwrite = {"scan_ms": (time.perf_counter() - t0) * 1e3,
                 "rows": table.num_rows, "field_ids": ids,
                 "files_on_disk": len(os.listdir(os.path.join(ow, "data")))}
    require_rows("phase Y overwrite", table,
                 {c: li[c][base:base + Y_OW_ROWS] for c in ow_cols},
                 ["l_orderkey", "l_extendedprice"])
    step("7_overwrite")

    # (7) a truncated copy of the newest metadata JSON raises
    # CorruptMetadataError naming the file.
    torn = os.path.join(root, Y_TORN, "metadata")
    os.makedirs(torn)
    with open(os.path.join(src, "metadata",
                           f"v{md.metadata_version}.metadata.json"),
              "rb") as f:
        body = f.read()
    torn_md = os.path.join(torn, "v1.metadata.json")
    with open(torn_md, "wb") as f:
        f.write(body[:len(body) // 2])
    try:
        IcebergTable(os.path.dirname(torn)).load_metadata()
    except CorruptMetadataError as e:
        if torn_md not in str(e):
            raise AssertionError(f"phase Y: the error {e} does not name "
                                 f"{torn_md}") from e
        torn_error = str(e)
    else:
        raise AssertionError("phase Y: a truncated metadata JSON loaded")
    step("8_torn")

    session.disable_hyperspace()
    launches = {k: build_launches[k] + refresh_launches[k]
                + cycle_launches[k] for k in build_launches}
    if cuda and launches != {"hash_buckets": chunks + 1,
                             "bucket_histogram": chunks + 1}:
        raise AssertionError(f"phase Y: launches {launches}")
    device_cache().clear()
    for name in (Y_SOURCE, Y_OVERWRITTEN, Y_TORN, Y_INDEXES):
        shutil.rmtree(os.path.join(root, name), ignore_errors=True)
    return {"write": write, "build": build, "queries": queries,
            "plan_files": plan,
            "refresh": {"s": refresh_s, "launches": refresh_launches,
                        "rows": new_rows, "iceberg_snapshots": history},
            "travel": travel, "cdc": cdc, "overwrite": overwrite,
            "torn": torn_error, "launches": launches, "steps_s": steps,
            "phase_s": time.perf_counter() - t_phase}


def print_iceberg(y: dict) -> None:
    w, b = y["write"], y["build"]
    print(f"phase Y write: {w['snapshots']} snapshots, {w['mb']:.1f} MB in "
          f"{w['s']:.3f} s", flush=True)
    print(f"phase Y build {Y_INDEX}: wall {b['wall_s']:.3f} s, read "
          f"{b['read_s'] or 0.0:.3f} s (phase C's Parquet "
          f"{b['parquet_read_s'] or 0.0:.3f} s), {b['mb_read']:.1f} MB "
          f"decoded, {b['mb_written']:.1f} MB written, {b['chunks']} chunks, "
          f"{b['rows_checked']} rows equal to {INDEX_NAME}'s per key, "
          f"launches {json.dumps(b['launches'])}", flush=True)
    for name, q in {**y["queries"], **y["travel"]}.items():
        warm = f" warm {q['warm_ms']:.1f}" if "warm_ms" in q else ""
        print(f"phase Y {name}: cold {q['cold_ms']:.1f}{warm} ms, "
              f"{q['rows']} rows", flush=True)
    p, r = y["plan_files"], y["refresh"]
    print(f"phase Y plan_files: {json.dumps(p)}; refresh {r['s']:.3f} s "
          f"indexed {r['rows']} rows, launches {json.dumps(r['launches'])}",
          flush=True)
    c, o = y["cdc"], y["overwrite"]
    print(f"phase Y cdc: snapshots {c['write_s']:.3f} s, maintenance cycle "
          f"{c['cycle_s']:.3f} s ({c['reason']}), touched keys cold "
          f"{c['cold_ms']:.1f} warm {c['warm_ms']:.1f} ms; overwrite scan "
          f"{o['scan_ms']:.1f} ms, {o['rows']} rows, field ids "
          f"{json.dumps(o['field_ids'])}; torn metadata raised", flush=True)
    print(f"phase Y: launches {json.dumps(y['launches'])} "
          f"({y['phase_s']:.3f} s; by step {json.dumps(y['steps_s'])})",
          flush=True)


Z_SHARDS = 8                    # logical shards of the mesh on the one card
Z_INDEXES = "z_indexes"         # phase Z's system path
Z_ROUTE_RUNS = 3                # timed calls of each chunk route
# Phase Z's queries: (over the indexes, the strategies each kind records
# over the mesh, then on the single device with the mesh off).
Z_QUERIES = {
    "point": (True, {"filters": ["device-mesh"]}, {"filters": ["device"]}),
    "range": (True, {"filters": ["device-mesh"]}, {"filters": ["device"]}),
    "bucketed_join": (True, {"joins": ["bucketed-mesh"], "join_kernels": []},
                      {"joins": ["bucketed"], "join_kernels": ["device"]}),
    "flat_join": (False, {"joins": ["plain"], "join_kernels": ["mesh"]},
                  {"joins": ["plain"], "join_kernels": ["device"]}),
    "q3_groups": (True, {"filters": ["device-mesh"],
                         "joins": ["mesh-fused-agg"],
                         "aggregates": ["mesh-join-agg"]},
                  {"filters": ["device"], "joins": ["device-fused-agg"],
                   "aggregates": ["device-join-agg"]}),
    "agg_by_priority": (True, {"filters": ["device-mesh"],
                               "aggregates": ["mesh-segment"]},
                        {"filters": ["device"],
                         "aggregates": ["device-segment"]}),
}


@contextlib.contextmanager
def logical_shards(dev, n: int):
    """``parallel/mesh.local_devices`` replaced by ``n`` copies of the
    session's device, the seam of the port's mesh tests: ``n`` logical
    shards on one card.  Yields that mesh."""
    import torch

    from hyperspace_tpu_torch.parallel import mesh as parallel_mesh

    shard = torch.device("cuda", torch.cuda.current_device()) \
        if dev.type == "cuda" else dev
    real = parallel_mesh.local_devices
    parallel_mesh.local_devices = lambda device=None: [shard] * n
    try:
        yield parallel_mesh.build_mesh()
    finally:
        parallel_mesh.local_devices = real


def z_strategies(stats: dict, kinds) -> dict:
    return {k: sorted({d["strategy"] for d in stats.get(k, [])})
            for k in kinds}


def z_expected(orders: dict, li: dict) -> dict:
    """Phase Z's answers by numpy: phase D's, and q3's groups whole (no
    ORDER BY ... LIMIT: a top-n keeps the fused single-device path), in
    o_custkey order."""
    expected = {**expected_answers(orders, li),
                **expected_aggregates(orders, li)}
    position = np.empty(N_ORDERS, dtype=np.int64)
    position[orders["o_orderkey"]] = np.arange(N_ORDERS)
    row = position[li["l_orderkey"]]
    cheap = orders["o_totalprice"][row] < PRICE_BELOW
    cust = orders["o_custkey"][row][cheap]
    revenue = (li["l_extendedprice"] * (1 - li["l_discount"]))[cheap]
    keys = np.unique(cust)
    expected["q3_groups"] = ({"o_custkey": keys, "revenue": np.bincount(
        cust, weights=revenue)[keys]}, ["o_custkey"])
    for name in ("bucketed_join", "flat_join"):
        expected[name] = expected["join"]
    return expected


def z_route_timing(dev, li: dict, mesh) -> dict:
    """The spill route of one chunk (the first DEFAULT_BATCH_ROWS rows of
    l_orderkey, NUM_BUCKETS buckets) on the single device
    (``route_partition``) and over the mesh (``route_partition_mesh``):
    the same (perm, counts), and Z_ROUTE_RUNS host-clock calls of each,
    uploads and read-backs included, in turns (single, mesh, mesh,
    single, ...)."""
    from hyperspace_tpu_torch.ops.hash import (
        route_partition,
        route_partition_mesh,
    )

    hw, ow = int64_words(li["l_orderkey"][:DEFAULT_BATCH_ROWS])
    single = lambda: route_partition([hw], [ow], NUM_BUCKETS, dev)  # noqa: E731
    meshed = lambda: route_partition_mesh(  # noqa: E731
        [hw], [ow], NUM_BUCKETS, mesh)
    p1, c1 = single()
    p2, c2 = meshed()
    if not (np.array_equal(p1, p2) and np.array_equal(c1, c2)):
        raise AssertionError("phase Z: the mesh route's (perm, counts) "
                             "differ from route_partition's")
    times: dict = {"single": [], "mesh": []}
    for i in range(Z_ROUTE_RUNS):
        for name in (("single", "mesh") if i % 2 == 0 else ("mesh", "single")):
            times[name].append(wall_ms(single if name == "single" else meshed))
    med = {k: statistics.median(v) for k, v in times.items()}
    return {"rows": len(hw), "buckets": NUM_BUCKETS, "shards": mesh.size,
            "single_ms": med["single"], "mesh_ms": med["mesh"],
            "detour_ms": med["mesh"] - med["single"],
            "single_runs_ms": times["single"], "mesh_runs_ms": times["mesh"]}


def phase_z(orders: dict, li: dict, root: str, dev) -> dict:
    """The mesh of Z_SHARDS logical shards on the one card (see the module
    docstring): the sharded spill build held to li_idx, the distributed
    orders build held to ord_idx, the mesh routes of the queries held to
    numpy beside the single device's, and the spill route's detour."""
    from hyperspace_tpu_torch import (
        Hyperspace,
        HyperspaceSession,
        IndexConfig,
        col,
    )
    from hyperspace_tpu_torch.ops import kernels

    t_phase = time.perf_counter()
    cuda = dev.type == "cuda"
    steps: dict = {}

    def step(label: str) -> None:
        steps[label] = time.perf_counter() - t_phase - sum(steps.values())

    reference = Hyperspace(HyperspaceSession(
        system_path=os.path.join(root, "indexes"), device=dev))
    want_li = bucket_digests(reference, INDEX_NAME)
    want_ord = bucket_digests(reference, ORDERS_INDEX)
    session = HyperspaceSession(system_path=os.path.join(root, Z_INDEXES),
                                device=dev)
    session.conf.num_buckets = NUM_BUCKETS
    set_min_rows(session, 0)
    hs = Hyperspace(session)
    chunks = -(-N_LINEITEM // DEFAULT_BATCH_ROWS)
    builds: dict = {}

    def build(label: str, src: str, config, want: dict,
              want_launches: dict, mesh_devices: int) -> None:
        device_cache().clear()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        hs.create_index(session.read.parquet(os.path.join(root, src)),
                        config)
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
        report = checked_report(f"phase Z {label}", hs)
        if report.get("properties", {}).get("mesh_devices", 0) \
                != mesh_devices:
            raise AssertionError(f"phase Z {label}: mesh_devices "
                                 f"{report.get('properties')}")
        if cuda and launches != want_launches:
            raise AssertionError(f"phase Z {label}: launches {launches}, "
                                 f"expected {want_launches}")
        if bucket_digests(hs, config.index_name) != want:
            raise AssertionError(f"phase Z {label}: the files' sha256 differ "
                                 f"from phase C's and D's builds")
        builds[label] = {"wall_s": wall, "launches": launches,
                         "phases": {k: v for k, v in
                                    session.build_stats_log[-1].items()
                                    if k != "index"},
                         "device_kernel_ms": report.get("device_kernel_ms")}

    with logical_shards(dev, Z_SHARDS) as mesh:
        # (1) li_idx as a spill build, each chunk routed over the mesh:
        # one hash and one histogram launch per shard and chunk.
        session.conf.device_batch_rows = DEFAULT_BATCH_ROWS
        per_chunk = {"hash_buckets": chunks * Z_SHARDS,
                     "bucket_histogram": chunks * Z_SHARDS}
        build("sharded spill", "lineitem",
              IndexConfig(INDEX_NAME, INDEXED, INCLUDED), want_li, per_chunk,
              Z_SHARDS)
        # The same build on the single device, for the detour's cost.
        session.conf.mesh_enabled = "off"
        build("single-device spill", "lineitem",
              IndexConfig("z_single", INDEXED, INCLUDED), want_li,
              {"hash_buckets": chunks, "bucket_histogram": chunks}, 0)
        hs.delete_index("z_single")
        hs.vacuum_index("z_single")
        session.conf.mesh_enabled = "auto"
        step("1_spill_builds")
        # (2) ord_idx monolithic, the bucket shuffle over the mesh: one
        # hash launch per shard, the writer's one histogram.
        session.conf.device_batch_rows = 1 << 23
        session.conf.parallel_build = "on"
        ord_config = IndexConfig(ORDERS_INDEX, ["o_orderkey"],
                                 ["o_totalprice", "o_custkey",
                                  "o_shippriority"])
        build("distributed", "orders", ord_config, want_ord,
              {"hash_buckets": Z_SHARDS, "bucket_histogram": 1}, 0)
        session.conf.parallel_build = "off"
        step("2_distributed_build")
        # (3) the queries, over the two indexes just built (their files
        # are li_idx's and ord_idx's).
        for kind in ("filter", "join", "agg"):
            setattr(session.conf, f"mesh_{kind}_min_rows", 0)
        queries = build_queries(session, root, aggregates=True)
        queries["bucketed_join"] = queries["flat_join"] = queries["join"]
        revenue = col("l_extendedprice") * (1 - col("l_discount"))
        queries["q3_groups"] = (
            session.read.parquet(os.path.join(root, "orders"))
            .filter(col("o_totalprice") < PRICE_BELOW)
            .join(session.read.parquet(os.path.join(root, "lineitem")),
                  col("o_orderkey") == col("l_orderkey"))
            .group_by("o_custkey").agg(revenue=(revenue, "sum")))
        expected = z_expected(orders, li)
        kernels.reset_launch_counts()
        rows = {}
        for name, (indexed, on_mesh, single) in Z_QUERIES.items():
            ds = queries[name]
            want, keys = expected[name]
            rtol = AGG_RTOL if name in AGG_QUERIES + ("q3_groups",) else 0.0
            if indexed:
                session.enable_hyperspace()
            # Unchecked and untimed: a query's first collect pays one-time
            # costs (its ops' first use), which would land on the route
            # timed first.
            ds.collect()
            out = {}
            for label, mode, routes_want in (("mesh", "auto", on_mesh),
                                             ("single", "off", single)):
                session.conf.mesh_enabled = mode
                device_cache().clear()
                t0 = time.perf_counter()
                table = ds.collect()
                out[f"{label}_cold_ms"] = (time.perf_counter() - t0) * 1e3
                require_rows(f"phase Z {name} {label}", table, want, keys,
                             rtol)
                got = z_strategies(session.last_execution_stats, routes_want)
                if got != routes_want:
                    raise AssertionError(f"phase Z {name} {label}: routes "
                                         f"{got}, expected {routes_want}")
                if name == "q3_groups":
                    # Its top groups are phase D's q3.
                    top = np.argsort(-table.column("revenue").to_numpy(),
                                     kind="stable")[:Q3_TOP]
                    require_rows(f"phase Z q3 {label}", table.take(top),
                                 expected["q3"][0], None, AGG_RTOL)
            session.conf.mesh_enabled = "auto"
            session.disable_hyperspace()
            out["detour_ms"] = out["mesh_cold_ms"] - out["single_cold_ms"]
            out["rows"] = len(next(iter(want.values())))
            rows[name] = out
        query_launches = kernels.launch_counts()
        step("3_queries")
        # (4) the spill route of one chunk, single device and mesh.
        route = z_route_timing(dev, li, mesh)
        step("4_route_timing")
    device_cache().clear()
    shutil.rmtree(os.path.join(root, Z_INDEXES), ignore_errors=True)
    return {"shards": Z_SHARDS, "builds": builds, "queries": rows,
            "query_launches": query_launches, "route": route,
            "launches": builds["sharded spill"]["launches"],
            "steps_s": steps, "phase_s": time.perf_counter() - t_phase}


def print_mesh(z: dict) -> None:
    for label, b in z["builds"].items():
        print(f"phase Z {label} build: wall {b['wall_s']:.3f} s, launches "
              f"{json.dumps(b['launches'])}, phases {json.dumps(b['phases'])}"
              f", device_kernel_ms {json.dumps(b['device_kernel_ms'])}",
              flush=True)
    for name, q in z["queries"].items():
        print(f"phase Z {name}: mesh cold {q['mesh_cold_ms']:.1f} ms, single "
              f"device cold {q['single_cold_ms']:.1f} ms (detour "
              f"{q['detour_ms']:+.1f} ms), {q['rows']} rows", flush=True)
    r = z["route"]
    print(f"phase Z chunk route ({r['rows']} rows, {r['buckets']} buckets): "
          f"single device {r['single_ms']:.2f} ms, mesh of {r['shards']} "
          f"shards {r['mesh_ms']:.2f} ms (detour {r['detour_ms']:+.2f} ms)",
          flush=True)
    print(f"phase Z: {z['shards']} logical shards, every build equal to "
          f"phases C and D, every answer to numpy; query launches "
          f"{json.dumps(z['query_launches'])} ({z['phase_s']:.3f} s; by step "
          f"{json.dumps(z['steps_s'])})", flush=True)


MH_INDEXES = "mh_indexes"       # phase MH's system path
MH_HOSTS = 2                    # host subprocesses of each multi-host build
MH_KILL_TTL_S = 1.5             # step 2's claim TTL
MH_SHAPE = (2, 4)               # step 3's (dcn, ici) mesh of logical shards
MH_PROCESSES = 2                # step 3's Gloo processes, 2 shards each
MH_WORKER_TIMEOUT_S = 300.0     # each Gloo process's wait


def mh_build(hs, name: str, src: str, want: dict, kill: bool) -> dict:
    """A MH_HOSTS-host build of ``name`` (li_idx's config) over ``src``:
    its bucket files' sha256 held to ``want``, exactly one ``commit``
    record, no item completed twice, no claim left behind, the parent
    launching nothing and, on the card, the hosts' chunk claims one hash
    and one histogram launch per chunk.  With ``kill``, the first host
    that has a done chunk claim and holds a pending one is SIGKILLed; the
    survivor must reclaim that claim and land the same bytes."""
    import signal
    import threading

    from hyperspace_tpu_torch import IndexConfig
    from hyperspace_tpu_torch.lifecycle import journal
    from hyperspace_tpu_torch.lifecycle.lease import WorkClaims
    from hyperspace_tpu_torch.ops import kernels
    from hyperspace_tpu_torch.parallel import multihost_build

    session = hs.session
    killed: dict = {}
    spawn = multihost_build.spawn_hosts

    def holder_pid(rec: dict) -> str:
        # A host's identity is <host>-<pid>-<start_ms>.
        parts = str(rec.get("holder", "")).rsplit("-", 2)
        return parts[1] if len(parts) == 3 else ""

    def spawn_and_kill(conf, build_id, n, device="cuda"):
        procs = spawn(conf, build_id, n, device=device)
        store = multihost_build._store(conf, build_id)
        watch = WorkClaims(store, conf, owner="mh-watcher")

        def watcher() -> None:
            deadline = time.monotonic() + 300
            while time.monotonic() < deadline \
                    and all(p.poll() is None for p in procs):
                recs = [watch.get(key[len(WorkClaims.PREFIX):])[0]
                        for key in store.list_keys(WorkClaims.PREFIX)]
                for p in procs:
                    mine = [r for r in recs
                            if r and holder_pid(r) == str(p.pid)]
                    done = [r["item"] for r in mine if r.get("done")
                            and r["item"].startswith("chunk-")]
                    held = [r["item"] for r in mine if not r.get("done")]
                    if done and held:
                        os.kill(p.pid, signal.SIGKILL)
                        killed.update(after=done[0], holding=held,
                                      at_s=time.perf_counter() - t0)
                        return
                time.sleep(0.02)

        thread = threading.Thread(target=watcher, daemon=True)
        thread.start()
        killed["thread"] = thread
        return procs

    if kill:
        multihost_build.spawn_hosts = spawn_and_kill
    logged = len(journal.records(session.conf))
    device_cache().clear()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        hs.create_index(session.read.parquet(src),
                        IndexConfig(name, INDEXED, INCLUDED))
    finally:
        multihost_build.spawn_hosts = spawn
        if "thread" in killed:
            killed.pop("thread").join(timeout=10)
    wall = time.perf_counter() - t0
    parent = kernels.launch_counts()
    report = checked_report(f"phase MH {name}", hs)
    props = report["properties"]
    if kill and "after" not in killed:
        raise AssertionError(f"phase MH {name}: no host was killed")
    chunks = -(-N_LINEITEM // session.conf.device_batch_rows)
    if props["multihost_hosts"] != MH_HOSTS \
            or props["multihost_chunks"] != chunks:
        raise AssertionError(f"phase MH {name}: report {props}")
    launches = props["multihost_launches"]
    if session.device.type == "cuda":
        require_launches(f"phase MH {name} hosts", launches,
                         {"hash_buckets": chunks, "bucket_histogram": chunks})
    require_launches(f"phase MH {name} parent", parent,
                     {"hash_buckets": 0, "bucket_histogram": 0})
    if bucket_digests(hs, name) != want:
        raise AssertionError(f"phase MH {name}: the files' sha256 differ "
                             f"from li_idx's")
    events = [r for r in journal.records(session.conf)[logged:]
              if r.get("decision") == "claim" and r.get("index") == name]
    commits = [e for e in events if e["mode"] == "commit"]
    completes = [e["item"] for e in events if e["mode"] == "complete"]
    if len(commits) != 1 or len(completes) != len(set(completes)):
        raise AssertionError(f"phase MH {name}: {len(commits)} commits, "
                             f"completes {completes}")
    if multihost_build.scan_build_claims(session.conf):
        raise AssertionError(f"phase MH {name}: claims left behind")
    reclaimed = sorted(e["item"] for e in events if e["mode"] == "reclaim")
    if kill and not set(killed["holding"]) <= set(reclaimed):
        raise AssertionError(f"phase MH {name}: the victim held "
                             f"{killed['holding']}, reclaimed {reclaimed}")
    return {"wall_s": wall, "launches": launches,
            "route_wall_s": props["multihost_route_wall_s"],
            "finalize_wall_s": props["multihost_finalize_wall_s"],
            "hosts_wall_s": props["multihost_total_wall_s"],
            "chunks": chunks, "groups": props["multihost_groups"],
            "phases": {k: v for k, v in session.build_stats_log[-1].items()
                       if k != "index"},
            "killed_after": killed.get("after"),
            "killed_holding": killed.get("holding"),
            "killed_at_s": killed.get("at_s"), "reclaimed": reclaimed}


def mh_worker(address: str, rank: int, path: str,
              device: str = "cuda:0") -> None:
    """One of phase MH's Gloo processes on ``device``: slice ``rank`` of
    MH_PROCESSES, 2 logical shards; its shards' records held to the flat
    shuffle's over MH_PROCESSES * 2 shards (``path``: the keys and that
    shuffle's output, saved by the parent)."""
    import torch
    import torch.distributed as dist

    from hyperspace_tpu_torch.ops import kernels
    from hyperspace_tpu_torch.parallel.multihost import (
        initialize_distributed,
        process_bucket_shuffle,
    )

    data = np.load(path)
    keys = data["keys"]
    dev = torch.device(device)
    backend = initialize_distributed(address, MH_PROCESSES, rank, device=dev)
    if backend != "gloo":
        raise AssertionError(f"backend {backend} for {MH_PROCESSES} "
                             f"processes on one card")
    per = -(-len(keys) // MH_PROCESSES)
    lo = rank * per
    hw, ow = int64_words(keys[lo:lo + per])
    dist.barrier()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    outs = process_bucket_shuffle([hw], [ow], NUM_BUCKETS, lo, 2, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    ms = (time.perf_counter() - t0) * 1e3
    launches = kernels.launch_counts()
    counts = data["counts"]
    starts = np.concatenate([[0], np.cumsum(counts)])
    for p, out in enumerate(outs):
        d = rank * 2 + p
        got = out[:, :2].cpu().numpy()
        want_rows = data["perm"][starts[d]:starts[d + 1]]
        want_buckets = data["buckets"][starts[d]:starts[d + 1]]
        if not (np.array_equal(got[:, 1], want_rows)
                and np.array_equal(got[:, 0], want_buckets)):
            raise AssertionError(f"process {rank} shard {p}: records differ "
                                 f"from the flat shuffle's")
    dist.barrier()
    dist.destroy_process_group()
    print("MH_WORKER " + json.dumps({"rank": rank, "ms": ms,
                                      "rows": int(min(per, len(keys) - lo)),
                                      "launches": launches}), flush=True)


def mh_processes(dev, keys: np.ndarray, root: str) -> dict:
    """MH_PROCESSES processes on ``dev`` joined over Gloo, each a slice
    of 2 logical shards: the cross-process two-stage shuffle of ``keys``
    held to the flat shuffle over the same 4 shards."""
    import socket

    from hyperspace_tpu_torch.parallel import bucket_shuffle

    hw, ow = int64_words(keys)
    with logical_shards(dev, MH_PROCESSES * 2) as mesh:
        flat, _ = bucket_shuffle([hw], [ow], NUM_BUCKETS, mesh)
    path = os.path.join(root, "mh_processes.npz")
    np.savez(path, keys=keys, perm=flat.perm, buckets=flat.buckets_sorted,
             counts=flat.device_row_counts)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        address = f"127.0.0.1:{sock.getsockname()[1]}"
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here)
    device = "cuda:0" if dev.type == "cuda" else str(dev)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", f"import chip_smoke; chip_smoke.mh_worker("
         f"{address!r}, {rank}, {path!r}, {device!r})"], cwd=here, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(MH_PROCESSES)]
    outputs = []
    try:
        for p in procs:
            outputs.append(p.communicate(timeout=MH_WORKER_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    workers = []
    for rank, (p, out) in enumerate(zip(procs, outputs)):
        lines = [ln for ln in out.splitlines() if ln.startswith("MH_WORKER ")]
        if p.returncode != 0 or len(lines) != 1:
            raise AssertionError(f"phase MH process {rank} (rc "
                                 f"{p.returncode}):\n{out[-4000:]}")
        workers.append(json.loads(lines[0].split(" ", 1)[1]))
    return {"processes": MH_PROCESSES, "shards": MH_PROCESSES * 2,
            "rows": len(keys), "wall_s": wall, "workers": workers}


def phase_mh(orders: dict, li: dict, root: str, dev) -> dict:
    """The multi-host layer on the one card (see the module docstring):
    two 2-host builds held to li_idx (the second with a host SIGKILLed),
    the two-stage shuffle held to the flat one, and two Gloo processes
    sharing the card."""
    from hyperspace_tpu_torch import Hyperspace, HyperspaceSession
    from hyperspace_tpu_torch.ops import kernels
    from hyperspace_tpu_torch.parallel import (
        bucket_shuffle,
        build_mesh_2d,
        hierarchical_bucket_shuffle,
    )

    t_phase = time.perf_counter()
    steps: dict = {}

    def step(label: str) -> None:
        steps[label] = time.perf_counter() - t_phase - sum(steps.values())

    reference = Hyperspace(HyperspaceSession(
        system_path=os.path.join(root, "indexes"), device=dev))
    want = bucket_digests(reference, INDEX_NAME)
    session = HyperspaceSession(system_path=os.path.join(root, MH_INDEXES),
                                device=dev)
    session.conf.device_batch_rows = DEFAULT_BATCH_ROWS
    session.conf.num_buckets = NUM_BUCKETS
    set_min_rows(session, 0)
    session.conf.multihost_build_hosts = MH_HOSTS
    hs = Hyperspace(session)
    src = os.path.join(root, "lineitem")
    builds = {"clean": mh_build(hs, "li_mh", src, want, kill=False)}
    step("1_build")
    session.conf.multihost_build_claim_ttl_s = MH_KILL_TTL_S
    builds["sigkill"] = mh_build(hs, "li_mh_kill", src, want, kill=True)
    step("2_sigkill_build")

    hw, ow = int64_words(orders["o_orderkey"])
    payload = int64_words(orders["o_custkey"])[0]
    with logical_shards(dev, MH_SHAPE[0] * MH_SHAPE[1]) as mesh:
        mesh2d = build_mesh_2d(*MH_SHAPE)
        if mesh2d.devices != mesh.devices:
            raise AssertionError("phase MH: the 2-axis mesh's shards are not "
                                 "the flat mesh's")
        times: dict = {"flat": [], "hierarchical": []}
        for name in ("flat", "hierarchical", "hierarchical", "flat"):
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            if name == "flat":
                got = bucket_shuffle([hw], [ow], NUM_BUCKETS, mesh,
                                     payload_words=payload)
            else:
                got = hierarchical_bucket_shuffle([hw], [ow], NUM_BUCKETS,
                                                  mesh2d,
                                                  payload_words=payload)
            times[name].append((time.perf_counter() - t0) * 1e3)
            shuffle_launches = kernels.launch_counts()
            if dev.type == "cuda":
                require_launches(f"phase MH {name} shuffle",
                                 shuffle_launches,
                                 {"hash_buckets": mesh.size,
                                  "bucket_histogram": 0})
            if name == "flat":
                flat, flat_pl = got
            else:
                hier, hier_pl = got
                hier_launches = shuffle_launches
    for field in ("perm", "buckets_sorted", "device_row_counts"):
        if not np.array_equal(getattr(hier, field), getattr(flat, field)):
            raise AssertionError(f"phase MH: the two-stage shuffle's {field} "
                                 f"differs from the flat shuffle's")
    if not (np.array_equal(hier_pl, flat_pl)
            and np.array_equal(hier_pl, payload[hier.perm])
            and np.array_equal(np.sort(hier.perm), np.arange(N_ORDERS))):
        raise AssertionError("phase MH: the two-stage shuffle's payload or "
                             "permutation is wrong")
    shuffle = {"rows": N_ORDERS, "shape": list(MH_SHAPE),
               "flat_ms": statistics.median(times["flat"]),
               "hierarchical_ms": statistics.median(times["hierarchical"]),
               "flat_runs_ms": times["flat"],
               "hierarchical_runs_ms": times["hierarchical"],
               "capacity": hier.capacity, "launches": hier_launches}
    step("3_shuffle")
    processes = mh_processes(dev, orders["o_orderkey"], root)
    step("4_processes")
    device_cache().clear()
    shutil.rmtree(os.path.join(root, MH_INDEXES), ignore_errors=True)
    return {"builds": builds, "shuffle": shuffle, "processes": processes,
            "launches": builds["clean"]["launches"],
            "shuffle_launches": hier_launches,
            "steps_s": steps, "phase_s": time.perf_counter() - t_phase}


def print_multihost(mh: dict) -> None:
    for label, b in mh["builds"].items():
        print(f"phase MH {label} build: wall {b['wall_s']:.3f} s (hosts "
              f"{b['hosts_wall_s']:.3f} s from spawn), route "
              f"{b['route_wall_s']:.3f} s and finalize "
              f"{b['finalize_wall_s']:.3f} s by the claim spans, "
              f"{b['chunks']} chunks, {b['groups']} groups, host launches "
              f"{json.dumps(b['launches'])}, a host killed after "
              f"{b['killed_after']} holding {b['killed_holding']}, "
              f"reclaimed {json.dumps(b['reclaimed'])}", flush=True)
    s = mh["shuffle"]
    print(f"phase MH shuffle ({s['rows']} rows, mesh {s['shape']}): flat "
          f"{s['flat_ms']:.1f} ms, two-stage {s['hierarchical_ms']:.1f} ms, "
          f"equal; launches {json.dumps(s['launches'])}, stage-2 capacity "
          f"{s['capacity']}", flush=True)
    p = mh["processes"]
    print(f"phase MH processes: {p['processes']} Gloo processes x 2 "
          f"shards on one device, {p['rows']} rows equal to the flat "
          f"shuffle, wall {p['wall_s']:.3f} s, shuffle ms "
          f"{json.dumps([w['ms'] for w in p['workers']])}, launches "
          f"{json.dumps([w['launches'] for w in p['workers']])}", flush=True)
    print(f"phase MH: both builds equal to li_idx ({mh['phase_s']:.3f} s; "
          f"by step {json.dumps(mh['steps_s'])})", flush=True)


def print_fleet(v: dict) -> None:
    f, p, h = v["fleet"], v["proxy"], v["hedge"]
    br, sc = v["breaker"], v["scrape"]
    print(f"phase V: seven through the fleet client ms "
          f"{json.dumps({k: round(x, 1) for k, x in f['ms'].items()})}, "
          f"picks {json.dumps(f['picks'])}; through the proxy ms "
          f"{json.dumps({k: round(x, 1) for k, x in p['ms'].items()})}; "
          f"join direct "
          f"{json.dumps([round(x, 1) for x in p['join_ms']['direct']])} "
          f"proxied {json.dumps([round(x, 1) for x in p['join_ms']['proxy']])}"
          f" ms; proxied BUSY {p['busy']['message']!r} retry-after "
          f"{p['busy']['retry_after_ms']}; breaker open after "
          f"{br['queries_to_open']} queries (doctor {br['doctor_open'][0]}), "
          f"closed after {br['queries_to_close']} (probe ms "
          f"{json.dumps([round(x, 1) for x in br['probe_ms']])}); hedges "
          f"sent {h['sent']:g} won {h['wins']:g}, ms "
          f"{json.dumps([round(x, 1) for x in h['ms']])} against clean "
          f"{json.dumps([round(x, 1) for x in h['clean_ms']])}; scrape "
          f"{sc['ms']:.1f} ms, {sc['bytes']} bytes; launches "
          f"{json.dumps(v['launches'])} ({v['phase_s']:.3f} s; by step "
          f"{json.dumps(v['steps_s'])})", flush=True)


def _raised_name(fn) -> str:
    """The class name of what ``fn`` raised (a BaseException: an injected
    crash is one), or "" when it returned."""
    try:
        fn()
    except BaseException as e:  # noqa: BLE001 - InjectedCrash included
        return type(e).__name__
    return ""


def print_server(t: dict) -> None:
    for name, q in t["queries"].items():
        print(f"phase T {name}: served {q['served_ms']:.1f} ms, direct "
              f"{q['direct_ms']:.1f} ms ({q['served_over_direct']:.2f}x), "
              f"plan cache miss {q['miss_ms']:.1f} hit {q['hit_ms']:.1f} ms "
              f"(saved {q['cache_saved_ms']:.1f}), {q['rows']} rows",
              flush=True)
    c, h = t["concurrent"], t["hybrid"]
    print(f"phase T: indexes {json.dumps(t['indexes'])} rebuilt "
          f"{t['rebuilt']}; {c['clients']} clients {c['requests']} answers "
          f"right in {c['wall_s']:.3f} s ({c['qps']:.1f} qps, p50 "
          f"{c['p50_ms']:.1f} p99 {c['p99_ms']:.1f} ms; server latency "
          f"{c['server_latency_ms_mean']:.1f} ms mean, queue wait "
          f"{c['queue_wait_ms_mean']:.1f}; a round of the seven in turn "
          f"{c['sequential_round_ms']:.1f} ms); numpy checks "
          f"{json.dumps(t['numpy_checks'])}; hybrid join "
          f"served {h['served_ms']:.1f} / direct {h['direct_ms']:.1f} ms, "
          f"launches {json.dumps(h['launches'])}; burst "
          f"{json.dumps(t['burst']['counters'])}; deadline answered in "
          f"{t['deadline']['answered_ms']:.1f} ms, next q3 "
          f"{t['deadline']['next_q3_ms']:.1f} ms; drain "
          f"{t['drain']['drain_s']:.3f} s ({t['phase_s']:.3f} s; by step "
          f"{json.dumps(t['steps_s'])})", flush=True)


def print_object_store(s: dict) -> None:
    print(f"phase S: object-store build {s['build']['wall_s']:.3f} s "
          f"(posix twin {s['build']['twin_wall_s']:.3f} s), every bucket's "
          f"sha256 the twin's after the build, the repair and the "
          f"refresh; listed {s['build']['listed']}, probed "
          f"{s['build']['probed']}; queries ms "
          f"{json.dumps({k: round(v, 1) for k, v in s['queries_ms'].items()})}; "
          f"faults {json.dumps(s['faults'])}; race "
          f"{json.dumps(s['race'])}; ms per log commit "
          f"{json.dumps(s['commit_ms'])}; launches "
          f"{json.dumps(s['launches'])} ({s['phase_s']:.3f} s; by step "
          f"{json.dumps(s['steps_s'])})", flush=True)


def print_diagnostics(r: dict) -> None:
    st, cache = r["strict"], r["plan_cache"]
    print(f"phase R: strict build {st['build_wall_s']:.3f} s "
          f"{json.dumps(st['build_launches'])}, d2h {st['d2h_bytes']:.0f} "
          f"bytes, {st['attributed']:.0f} attributed read-backs, "
          f"{st['violations']:.0f} violations; guard armed/off "
          f"{st['armed_over_off']:.3f}x, off (patched)/unpatched "
          f"{st['off_over_unpatched'] or float('nan'):.3f}x; plan cache "
          f"miss/hit pass "
          f"{cache['miss_pass_ms']:.1f}/{cache['hit_pass_ms']:.1f} ms, "
          f"optimize saved {cache['saved_ms']:.2f} ms; deadline "
          f"{r['deadline']['expired_ms']:.1f} ms; doctor "
          f"{json.dumps(r['doctor']['grades']['clean'])} "
          f"({r['phase_s']:.3f} s; by step {json.dumps(r['steps_s'])})",
          flush=True)


def q_check_seams(q: dict, rows: list) -> dict:
    """The route seams' summed ms against the kernels line: at least the
    build's launches times the chunk-shape kernel_ms of the hash and the
    histogram.  Returns the floor and both chunk times."""
    chunk = {}
    for r in rows:
        for shape in r["shapes"]:
            if shape["shape"]["n"] == DEFAULT_BATCH_ROWS:
                chunk[r["name"]] = shape["kernel_ms"]
    floor = sum(q["build_launches"][name] * ms for name, ms in chunk.items())
    if not floor <= q["route_partition_seam_ms"]:
        raise AssertionError(f"phase Q: route seams "
                             f"{q['route_partition_seam_ms']} ms below the "
                             f"kernels' {floor} ms")
    return {"chunk_kernel_ms": chunk, "seam_floor_ms": floor}


def print_telemetry(q: dict) -> None:
    med = q["medians"]
    print(f"phase Q: {q['route_partition_seams']} route_partition seams "
          f"{q['route_partition_seam_ms']:.3f} ms (spill_route "
          f"{q['spill_route_ms']:.1f} ms), seams {json.dumps(q['seams'])}; "
          f"export {q['exported_events']} events, lanes "
          f"{q['exported_lanes']}, {q['memory_samples']} memory samples; "
          f"{q['families']} metric families; event calls off "
          f"{json.dumps(q['event_calls_off'])} on "
          f"{json.dumps(q['event_calls_on'])}; build off/on "
          f"{med['build_off_s']:.3f}/{med['build_on_s']:.3f} s "
          f"({q['build_on_over_off']:.3f}x), queries off/on "
          f"{med['queries_off_ms']:.1f}/{med['queries_on_ms']:.1f} ms "
          f"({q['queries_on_over_off']:.3f}x) ({q['phase_s']:.3f} s)",
          flush=True)


def print_lifecycle(p: dict) -> None:
    print(f"phase P: lifecycle checked, {len(p['cycles'])} cycles, detect "
          f"{p['detect_ms']:.1f} ms, staleness {p['staleness_s']:.3f} s, "
          f"launches {json.dumps(p['launches'])} ({p['wall_s']:.3f} s)",
          flush=True)


def print_envelope(n: dict) -> None:
    print(f"phase N: failure envelope checked, launches "
          f"{json.dumps(n['launches'])} ({n['wall_s']:.3f} s)", flush=True)


def print_advisor(o: dict) -> None:
    print(f"phase O: advisor checked, capture {o['capture_us']['median']:.1f}"
          f" us a collect (max {o['capture_us']['max']:.1f}), recommend "
          f"{o['recommend_ms']:.1f} ms, "
          f"apply {o['apply_s']:.3f} s, launches {json.dumps(o['launches'])}"
          f", rerun launches {json.dumps(o['launches_rerun'])} "
          f"({o['wall_s']:.3f} s)", flush=True)


def route_of(stats: dict) -> str:
    """The route a collect took over its filters, join kernels, fused
    joins and device aggregates: "device", "host", "mixed", or "none"
    when it recorded none."""
    sides = {"host" if d["strategy"] == "host" else "device"
             for k in ("filters", "join_kernels") for d in stats.get(k, [])}
    sides |= {"device" for d in stats.get("joins", [])
              if d["strategy"] == "device-fused-agg"}
    sides |= {"device" for _ in stats.get("aggregates", [])}
    if not sides:
        return "none"
    return sides.pop() if len(sides) == 1 else "mixed"


def faster_route(device_ms: float, host_ms: float) -> str:
    return "device" if device_ms < host_ms else "host"


def phase_h(orders: dict, li: dict, root: str, dev) -> dict:
    """Calibration, the calibrated routes and build, and data skipping
    (see the module docstring) over phase D's data and indexes."""
    from hyperspace_tpu_torch import (
        DataSkippingIndexConfig,
        Hyperspace,
        HyperspaceSession,
        IndexConfig,
        col,
    )
    from hyperspace_tpu_torch.ops import kernels
    from hyperspace_tpu_torch.utils import calibrate

    # (a) the probe: phases A-G pinned every threshold, so none probed.
    if calibrate._PROFILES:
        raise AssertionError(f"phase H: probed before phase H: "
                             f"{list(calibrate._PROFILES)}")
    t0 = time.perf_counter()
    calibrate.device_profile(dev)
    probe_s = time.perf_counter() - t0
    summary = calibrate.profile_summary(dev)
    if summary.get("calibrated") is not True:
        raise AssertionError(f"phase H: the probe failed: {summary}")

    # (b) phase D's queries with every threshold at None, timed in turns
    # with phase D's device route (thresholds 0) and host route (above
    # every row count), each run cold; then warm, each route after a
    # checked run of its own.
    device_cache().clear()
    session = HyperspaceSession(system_path=os.path.join(root, "indexes"),
                                device=dev)
    session.conf.num_buckets = NUM_BUCKETS
    session.conf.device_batch_rows = 1 << 23
    for field in ("filter", "join", "agg", "build", "resident"):
        if getattr(session.conf, f"device_{field}_min_rows") is not None:
            raise AssertionError(f"phase H: device_{field}_min_rows is set")
    hs = Hyperspace(session)
    session.enable_hyperspace()
    queries = build_queries(session, root, aggregates=True)
    expected = {**expected_answers(orders, li),
                **expected_aggregates(orders, li)}
    routes_of = {"calibrated": None, "device": 0, "host": HOST_ROUTE_MIN_ROWS}
    rows = []
    for name, ds in queries.items():
        want, keys = expected[name]
        rtol = AGG_RTOL if name in AGG_QUERIES else 0.0

        def run(route: str, label: str, cold: bool,
                check: bool = False) -> tuple:
            set_min_rows(session, routes_of[route])
            if cold:
                device_cache().clear()
            t0 = time.perf_counter()
            got = ds.collect()
            ms = (time.perf_counter() - t0) * 1e3
            if check:
                require_rows(f"phase H {name} {route} {label}", got, want,
                             keys, rtol)
            return ms, route_of(session.last_execution_stats)

        cold = {r: [] for r in routes_of}
        taken = {}
        for i in range(TIMED_QUERY_RUNS):
            for r in routes_of:
                ms, taken[(r, "cold")] = run(r, "cold", True, check=i == 0)
                cold[r].append(ms)
        warm = {}
        for r in ("calibrated", "device"):
            device_cache().clear()
            run(r, "warm-up", False, check=True)
            runs = [run(r, "warm", False) for _ in range(TIMED_QUERY_RUNS)]
            warm[r] = [ms for ms, _ in runs]
            taken[(r, "warm")] = runs[-1][1]
        if (taken[("device", "cold")], taken[("host", "cold")]) not in (
                ("device", "host"), ("none", "none")):
            raise AssertionError(f"phase H {name}: the pinned routes took "
                                 f"{taken}")
        med = {f"{r}_cold_ms": statistics.median(v) for r, v in cold.items()}
        med.update({f"{r}_warm_ms": statistics.median(v)
                    for r, v in warm.items()})
        # The host route reads no cached column: warm is cold.
        med["host_warm_ms"] = med["host_cold_ms"]
        rows.append({
            "name": name,
            "route_cold": taken[("calibrated", "cold")],
            "route_warm": taken[("calibrated", "warm")], **med,
            "faster_cold": faster_route(med["device_cold_ms"],
                                        med["host_cold_ms"]),
            "faster_warm": faster_route(med["device_warm_ms"],
                                        med["host_warm_ms"]),
            "cold_runs_ms": cold, "warm_runs_ms": warm})
    set_min_rows(session, None)
    device_cache().clear()

    # (c) an SF1 build at the calibrated defaults, bit-equal to phase C's.
    path = os.path.join(root, "h_indexes")
    cal = HyperspaceSession(system_path=path, device=dev)
    cal.conf.num_buckets = NUM_BUCKETS
    cal.conf.device_batch_rows = 1 << 23
    cal_hs = Hyperspace(cal)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    cal_hs.create_index(cal.read.parquet(os.path.join(root, "lineitem")),
                        IndexConfig(CALIBRATED_INDEX, INDEXED, INCLUDED))
    build_wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    threshold = cal.conf.device_min_rows("build", dev)
    route = "device" if N_LINEITEM >= threshold else "host"
    if (route == "device") != all(v > 0 for v in launches.values()) \
            or (route == "host") != all(v == 0 for v in launches.values()):
        raise AssertionError(f"phase H: a {route} build launched {launches}")
    if bucket_digests(cal_hs, CALIBRATED_INDEX) != \
            bucket_digests(hs, INDEX_NAME):
        raise AssertionError("phase H: the calibrated build's buckets differ "
                             "from phase C's")
    build = {"route": route, "threshold": threshold, "launches": launches,
             "wall_s": build_wall,
             "report": checked_report("phase H calibrated build", cal_hs)}
    shutil.rmtree(path, ignore_errors=True)

    # (e) data skipping: li_ds beside li_idx and ord_idx.
    src = os.path.join(root, "lineitem")
    t0 = time.perf_counter()
    hs.create_index(session.read.parquet(src),
                    DataSkippingIndexConfig(DS_INDEX, ["l_shipdate"]))
    ds_create_s = time.perf_counter() - t0
    ds_report = checked_report("phase H li_ds", hs)
    lo, hi = DS_RANGE
    ds_range = (session.read.parquet(src)
                .filter((col("l_shipdate") >= lo) & (col("l_shipdate") < hi))
                .select("l_shipdate", "l_extendedprice", "l_discount"))
    mask = (li["l_shipdate"] >= lo) & (li["l_shipdate"] < hi)
    want = {c: li[c][mask] for c in ("l_shipdate", "l_extendedprice",
                                     "l_discount")}
    t0 = time.perf_counter()
    plan = ds_range.optimized_plan()
    plan_ms = (time.perf_counter() - t0) * 1e3
    pruned = [sc.relation for sc in plan.leaf_relations()
              if sc.relation.data_skipping_of == DS_INDEX]
    if len(pruned) != 1 or pruned[0].data_skipping_stats != DS_WANT_FILES:
        raise AssertionError(f"phase H ds_range: plan\n{plan.tree_string()}")
    on_ms, off_ms = [], []
    for _ in range(TIMED_QUERY_RUNS):
        device_cache().clear()
        t0 = time.perf_counter()
        got = ds_range.collect()
        on_ms.append((time.perf_counter() - t0) * 1e3)
        require_rows("phase H ds_range", got, want)
        files_on = sum(sc["files_read"]
                       for sc in session.last_execution_stats["scans"])
        session.disable_hyperspace()
        device_cache().clear()
        t0 = time.perf_counter()
        got = ds_range.collect()
        off_ms.append((time.perf_counter() - t0) * 1e3)
        require_rows("phase H ds_range off", got, want)
        files_off = sum(sc["files_read"]
                        for sc in session.last_execution_stats["scans"])
        session.enable_hyperspace()
    if (files_on, files_off) != DS_WANT_FILES:
        raise AssertionError(f"phase H ds_range read {files_on} and "
                             f"{files_off} files")
    q10_plan = queries["q10"].optimized_plan().tree_string()
    device_cache().clear()
    return {"calibration": summary, "probe_s": probe_s, "queries": rows,
            "build": build,
            "data_skipping": {
                "create_s": ds_create_s, "report": ds_report,
                "kept": pruned[0].data_skipping_stats[0],
                "total": pruned[0].data_skipping_stats[1],
                "rows": int(mask.sum()), "plan_ms": plan_ms,
                "on_ms": statistics.median(on_ms),
                "off_ms": statistics.median(off_ms),
                "on_runs_ms": on_ms, "off_runs_ms": off_ms,
                "q10_plan": q10_plan}}


def call_ms(fn, flush) -> float:
    """Median milliseconds of one call of ``fn`` between two CUDA events,
    over TIMED_RUNS calls, each after an L2 flush, after three warm-up
    calls: the kernel plus whatever the host does around it."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(TIMED_RUNS):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def input_sets(make, set_bytes: int) -> list:
    """Enough copies of one input that together they exceed twice the L2
    cache, so a launch that reads them in turn always starts cold."""
    return [make() for _ in range(max(2, 2 * L2_BYTES // set_bytes + 1))]


def kernel_ms(fn, sets) -> float:
    """Device milliseconds per launch: GRAPH_LAUNCHES calls of ``fn``, on
    the input sets in turn, captured into one CUDA graph and replayed
    between two events (median of GRAPH_REPLAYS replays).  No host work
    runs between the launches."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for s in sets:
            fn(s)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        # Kept alive, so every launch writes an output of its own.
        outs = [fn(sets[i % len(sets)]) for i in range(GRAPH_LAUNCHES)]
    times = []
    for _ in range(GRAPH_REPLAYS + 1):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / GRAPH_LAUNCHES)
    del outs, graph
    return statistics.median(times[1:])


def profiler_ms(fn, sets, kernel=None):
    """Device milliseconds per call by ``torch.profiler``: PROFILED_CALLS
    calls of ``fn`` on the input sets in turn; the time of the device
    activities whose name holds ``kernel`` (every device activity when it
    is None), over the calls.  None when the profiler saw no device
    activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for s in sets:
        fn(s)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(PROFILED_CALLS):
            fn(sets[i % len(sets)])
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA
             and (kernel is None or kernel in e.name))
    return us / 1e3 / PROFILED_CALLS if us else None


def bound(nbytes: int, ops: int):
    """(least milliseconds, "bytes" or "operations") on the card."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ALU_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def measure(dev, keys: np.ndarray, launches: dict, by_path: dict,
            per_sf1_build: dict) -> list:
    """One row per kernel at phase C's shape, with the other shapes of
    HASH_SHAPES / HIST_SHAPES under ``shapes``.  ``launches``: phase C's
    counts; ``by_path``: path -> counts; ``per_sf1_build``: the launches
    of one SF1 spill build, given to the chunk-shape rows (None when no
    phase E ran)."""
    import torch

    from hyperspace_tpu_torch.ops import kernels

    flush = torch.empty(2 * L2_BYTES, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    hw, _ = int64_words(keys)
    key_col = torch.from_numpy(hw).to(dev)

    def timed(fn, sets, kernel, plain):
        graph = kernel_ms(fn, sets)
        return {"ms": graph, "kernel_ms": graph,
                "profiler_ms": profiler_ms(fn, sets, kernel),
                "call_ms": call_ms(lambda: fn(sets[0]), flush),
                "plain_ms": call_ms(lambda: plain(sets[0]), flush)}

    def chunk_launches(name, n):
        return {"launches_per_sf1_build": per_sf1_build[name]} \
            if n == DEFAULT_BATCH_ROWS and per_sf1_build is not None else {}

    hash_rows = []
    for n, k, nb in HASH_SHAPES:
        cols = [key_col[:n]] + _random_words(dev, n, k - 1, gen)
        got = kernels.hash_buckets(cols, nb)
        err = int((got.to(torch.int64) - kernels.hash_buckets_plain(cols, nb)
                   .to(torch.int64)).abs().max())
        # Per row and key word: fmix32 (3 shifts, 3 xors, 2 multiplies),
        # then h * 31 ^ w and the outer fmix32; one modulo per row.
        b, by = bound(n * (8 * k + 4), n * (k * 2 * (8 + 2 + 8) + 1))
        sets = input_sets(lambda: [c.clone() for c in cols], n * (8 * k + 4))
        hash_rows.append({
            "shape": {"n": n, "k": k, "num_buckets": nb}, "max_abs_err": err,
            **timed(lambda s: kernels.hash_buckets(s, nb), sets,
                    "hash_buckets_kernel",
                    lambda s: kernels.hash_buckets_plain(s, nb)),
            "bound_ms": b, "bound_by": by, "library_ms": None,
            **chunk_launches("hash_buckets", n)})
        del sets

    hist_rows = []
    for n, nb in HIST_SHAPES:
        ids = kernels.hash_buckets([key_col[:n]], nb)
        err = int((kernels.bucket_histogram(ids, nb)
                   - kernels.bucket_histogram_plain(ids, nb)).abs().max())
        b, by = bound(4 * n + 4 * nb, 3 * n)  # two compares and an add a row
        sets = input_sets(ids.clone, 4 * n)
        library = lambda s: torch.bincount(s, minlength=nb)  # noqa: E731
        hist_rows.append({
            "shape": {"n": n, "num_buckets": nb}, "max_abs_err": err,
            **timed(lambda s: kernels.bucket_histogram(s, nb), sets,
                    "bucket_histogram_kernel",
                    lambda s: kernels.bucket_histogram_plain(s, nb)),
            "bound_ms": b, "bound_by": by,
            # torch.bincount synchronises (it reads the largest id back),
            # so no graph can hold it: its device time is the profiler's.
            "library_ms": profiler_ms(library, sets),
            "library_call_ms": call_ms(lambda: library(sets[0]), flush),
            **chunk_launches("bucket_histogram", n)})
        del sets

    def row(name, source, replaces, shapes):
        return {"name": name, "route": "cuda",
                "source": f"hyperspace_tpu_torch/csrc/{source}",
                "replaces": replaces,
                "launches": launches[name],
                "launches_by_path": {p: c[name] for p, c in by_path.items()},
                **shapes[0], "shapes": shapes}

    return [row("hash_buckets", "hash_buckets.cu",
                "hyperspace_tpu/ops/pallas_kernels.py:94", hash_rows),
            row("bucket_histogram", "bucket_histogram.cu",
                "hyperspace_tpu/ops/pallas_kernels.py:145", hist_rows)]


def print_integrity(integ: dict) -> None:
    print(f"phase I: digests {integ['digest_algo']}; li_int created in "
          f"{integ['create_s']:.3f} s; verify quick {integ['verify_quick_s']:.4f} "
          f"s, full {integ['verify_full_s']:.4f} s over "
          f"{integ['verify_full_mb']:.1f} MB; buckets "
          f"{json.dumps(integ['buckets'])}", flush=True)
    print(f"phase I flagged: {json.dumps(integ['flagged'])}", flush=True)
    for name, q in integ["queries"].items():
        print(f"phase I {name}: contained {q['contained_ms']:.1f} ms, clean "
              f"{q['clean_ms']:.1f} ms, scan {q['scan_ms']:.1f} ms (cold); "
              f"launches {json.dumps(integ['contained_launches'][name])}",
              flush=True)
    print(f"phase I repair: wall {integ['repair_wall_s']:.3f} s, launches "
          f"{json.dumps(integ['repair_launches'])}, phases "
          f"{json.dumps(integ['repair_phases'])}; repaired buckets' sha256 "
          f"equal the build's", flush=True)
    dw = integ["digest_on_write_s"]
    print(f"phase I digest on write: builds on {json.dumps(dw['on'])} s, "
          f"off {json.dumps(dw['off'])} s, medians' difference "
          f"{dw['difference']:+.3f} s; the "
          f"{dw['mb']:.1f} MB hashed again serially in "
          f"{dw['serial_digest_s']:.3f} s", flush=True)


def print_window(window: dict) -> None:
    for name, shape in window["shapes"].items():
        print(f"phase K {name}: median {shape['median_ms']:.1f} ms of "
              f"{K_RUNS} on the host route, {shape['mrows_per_s']:.2f} "
              f"Mrows/s, max abs diff from numpy {shape['max_abs_err']!r}",
              flush=True)
    d = window["device_route"]
    print(f"phase K device route: whole_partition_sum with a chained count, "
          f"cold {d['cold_ms']:.1f} warm {d['warm_ms']:.1f} ms "
          f"(device-segment, resident), host route {d['host_ms']:.1f} ms, "
          f"host_over_device {d['host_over_device']:.2f}", flush=True)
    t = window["ties"]
    print(f"phase K ties: {t['windows']} windows ordered by l_quantity in "
          f"{t['wall_ms']:.1f} ms, equal to numpy (max abs diff "
          f"{json.dumps(t['max_abs_err'])})", flush=True)
    i = window["indexed"]
    print(f"phase K indexed: {i['rows']} rows through {i['plan']}, rank and "
          f"revenue equal to numpy, median {i['median_ms']:.1f} ms",
          flush=True)
    print(f"phase K set operations: {json.dumps(window['setops'])}",
          flush=True)
    for name, f in window["segment_functions"].items():
        print(f"phase K {name}: cpu {f['cpu_ms']:.1f} ms, card "
              f"{f['card_ms']:.2f} ms, max abs diff {f['max_abs_err']!r}",
              flush=True)
    print(f"phase K: analytic operators checked, launches "
          f"{json.dumps(window['launches'])} ({window['wall_s']:.3f} s)",
          flush=True)


def print_plan_language(pl: dict) -> None:
    for name, q in pl["queries"].items():
        files = q["plan"]["files"]
        print(f"phase L {name}: checked {q['checked_ms']:.1f} ms, timed "
              f"median {q['median_ms']:.1f} ms, {q['rows']} rows; filters "
              f"{q['filters']} joins {q['joins']} join kernels "
              f"{q['join_kernels']} aggregates {q['aggregates']}"
              + (f"; files {files[0]}/{files[1]}" if files else ""),
              flush=True)
    print(f"phase L: plan language checked (data {pl['datagen_s']:.3f} s, "
          f"builds {json.dumps({k: round(v, 3) for k, v in pl['build_s'].items()})}"
          f"), launches by the builds {json.dumps(pl['launches_builds'])}, "
          f"by the queries {json.dumps(pl['launches'])} "
          f"({pl['wall_s']:.3f} s)", flush=True)


def print_sql(m: dict) -> None:
    for name, q in m["queries"].items():
        print(f"phase M {name}: parse {q['parse_ms']:.2f} ms, optimize "
              f"{q['optimize_ms']:.1f} ms, checked {q['checked_ms']:.1f} ms, "
              f"timed median {q['median_ms']:.1f} ms (the DSL twin in turns "
              f"{q['dsl_turns_median_ms']:.1f} ms, its phase L median "
              f"{q['dsl_median_ms']:.1f} ms); plan equal to the twin's "
              f"{q['plan_equal']}", flush=True)
    for name, e in m["explain"].items():
        print(f"phase M explain {name} (verbose): {e['ms']:.1f} ms, "
              f"{e['lines']} lines", flush=True)
    print(f"phase M index {L_LI_INDEX}: {json.dumps(m['index'])}", flush=True)
    print(f"phase M indexes: {json.dumps(m['indexes'])}", flush=True)
    print(f"phase M: SQL twins, explain and statistics checked, launches "
          f"{json.dumps(m['launches'])} ({m['wall_s']:.3f} s)", flush=True)


def print_split(label: str, split: dict) -> None:
    """One line per temperature of a ``stage_breakdown`` pair."""
    for temp in ("cold", "warm"):
        print(f"{label} split {temp}: "
              + json.dumps({k: round(v, 3) if isinstance(v, float) else v
                            for k, v in split[temp].items()
                            if k != "worker_busy_ms"}), flush=True)


# The phases in the order the script runs their checks: the letters, then
# the names of more than one letter.
PHASES = tuple("ABCDEFGHIJKLMNOPQRSTUVWXYZ") + ("MH",)
# What a phase reads from another phase besides the generated data: C
# (the lineitem files and li_idx), D (the orders files and ord_idx), or a
# whole phase whose results it takes (M: phase L's session and oracle;
# U: phase T's answers and figures).
PHASE_READS = {"D": "C", "E": "C", "G": "CD", "H": "CD", "I": "CD",
               "J": "C", "K": "C", "M": "L", "N": "CD", "O": "CD",
               "P": "CD", "Q": "CD", "R": "CD", "S": "CD", "T": "CD",
               "U": "T", "V": "CD", "W": "C", "X": "C", "Y": "C",
               "Z": "CD", "MH": "CD"}
READ_ONLY_RUN = {"C": "phase C (the li_idx build and its checks)",
                 "D": "phase D's ord_idx build, without its queries",
                 "L": "phase L (phase M runs in its session)",
                 "T": "phase T (phase U compares with its answers)"}


def parse_args(argv: list) -> tuple:
    """The command line: (the selected phases with A, the phases run only
    because a selected one reads them, phase U's extra turns).  Without
    ``--phases``, every phase; without ``--u-turns``, none."""
    import argparse

    parser = argparse.ArgumentParser(
        description="Drive hyperspace_tpu_torch on one CUDA card.")
    parser.add_argument(
        "--phases", metavar="NAMES",
        help=f"comma-separated phase names of {','.join(PHASES)} (A and the "
             f"kernel builds always run; a phase's data and builds run with "
             f"it); default: every phase")
    parser.add_argument(
        "--u-turns", type=int, default=0, metavar="N",
        help="phase U: N more rounds of its 8 clients on a threaded and "
             "an async server in turns (threaded, async, async, "
             "threaded); default 0")
    args = parser.parse_args(argv)
    if args.u_turns < 0:
        parser.error("--u-turns must be 0 or more")
    phases = args.phases
    if phases is None:
        return set(PHASES), set(), args.u_turns
    selected = {p.strip() for p in phases.split(",")}
    unknown = sorted(p for p in selected if p not in PHASES)
    if unknown:
        parser.error(f"unknown phases {unknown}; the phases are "
                     f"{','.join(PHASES)}, comma-separated")
    read: set = set()
    todo = list(selected)
    while todo:
        for need in PHASE_READS.get(todo.pop(), ""):
            if need not in selected and need not in read:
                read.add(need)
                todo.append(need)
    return selected | {"A"}, read, args.u_turns


def main(argv=None) -> int:
    import torch

    selected, read, u_turns = parse_args(sys.argv[1:] if argv is None
                                         else argv)
    runs = selected | read
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from hyperspace_tpu_torch.ops import kernels
    except ImportError as e:
        print(f"chip_smoke: run it from a checkout of the repository ({e})",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    if len(selected) < len(PHASES):
        reads = "; ".join(READ_ONLY_RUN[p] for p in sorted(read))
        print(f"phases: {','.join(p for p in PHASES if p in selected)} "
              f"selected; run for them: {reads or 'nothing else'}",
              flush=True)

    t0 = time.perf_counter()
    logs = kernels.build_kernels() or {}
    print(f"build: {time.perf_counter() - t0:.3f} s", flush=True)
    for source, log in logs.items():
        for line in log.splitlines():
            if "Function properties" in line or "registers" in line \
                    or "Compiling entry" in line or "spill" in line:
                print(f"ptxas {source}: {line.strip()}", flush=True)

    t0 = time.perf_counter()
    phase_a(dev)
    print(f"phase A: kernels bit-equal to their plain versions "
          f"({time.perf_counter() - t0:.3f} s)", flush=True)

    t0 = time.perf_counter()
    orders, li = gen_data()
    print(f"data: {N_LINEITEM} rows x {len(li)} columns and {N_ORDERS} "
          f"rows x {len(orders)} columns generated "
          f"({time.perf_counter() - t0:.3f} s)", flush=True)

    if "B" in runs:
        t0 = time.perf_counter()
        phase_b(dev, li["l_orderkey"])
        print(f"phase B: bucket_sort_permutation and bucket_counts bit-equal "
              f"to the numpy mirror ({time.perf_counter() - t0:.3f} s)",
              flush=True)

    # The results of the phases that ran: their JSON lines and the
    # kernels line's launches by path (phases C and D's, the builds',
    # then the other paths').
    res: dict = {}
    builds: list = []
    head: dict = {}
    by_path: dict = {}
    launches = None
    root = tempfile.mkdtemp(prefix="hs_chip_smoke_")
    try:
        if "C" in runs:
            c = phase_c(li, root, dev)
            print(f"phase C: create_index {INDEX_NAME} ACTIVE, {c['files']} "
                  f"files, wall {c['wall_s']:.3f} s, phases "
                  + json.dumps({k: v for k, v in c["phases"].items()
                                if k != "index"}), flush=True)
            launches = c["launches"]
            missing = [k for k, v in launches.items() if v <= 0]
            if missing:
                raise AssertionError(f"phase C: kernels not launched on the "
                                     f"main path: {missing}")
            head["C create li_idx"] = launches
        if "D" in selected:
            t0 = time.perf_counter()
            d = phase_d(orders, li, root, dev)
            d_launches = d["launches"]
            for q in d["queries"]:
                print(f"phase D {q['name']}: indexed cold "
                      f"{q['indexed_cold_ms']:.1f} warm "
                      f"{q['indexed_warm_ms']:.1f} ms, host route "
                      f"{q['host_route_ms']:.1f} ms, scan cold "
                      f"{q['scan_cold_ms']:.1f} warm {q['scan_warm_ms']:.1f} "
                      f"ms; host/device cold {q['host_over_device_cold']:.2f} "
                      f"warm {q['host_over_device_warm']:.2f}; cache cold "
                      f"{json.dumps(q['device_cache_cold'])} warm "
                      f"{json.dumps(q['device_cache_warm'])}", flush=True)
            for q in d["queries"]:
                if q["name"] in ("join", "q3"):
                    print_split(f"phase D {q['name']}", q["stages"])
            print(f"phase D q3 eviction: {json.dumps(d['eviction'])}",
                  flush=True)
            print(f"phase D: {ORDERS_INDEX} built in {d['build_s']:.3f} s; "
                  f"{len(d['queries'])} queries equal to numpy with indexes "
                  f"on (cold, warm, host route) and off (cold, warm); "
                  f"{d['resident_mib_end']:.1f} MiB resident at the end "
                  f"({time.perf_counter() - t0:.3f} s)", flush=True)
            res["queries"] = {"queries": d["queries"], "launches": d_launches,
                              "eviction": d["eviction"]}
        elif "D" in read:
            _, _, build_s = d_build(orders, root, dev)
            d_launches = kernels.launch_counts()
            print(f"phase D build: {ORDERS_INDEX} built in {build_s:.3f} s, "
                  f"launches {json.dumps(d_launches)}", flush=True)
        if "D" in runs:
            missing = [k for k, v in d_launches.items() if v <= 0]
            if missing:
                raise AssertionError(f"phase D: kernels not launched by the "
                                     f"{ORDERS_INDEX} build: {missing}")
            head["D create ord_idx"] = d_launches
        if "H" in runs:
            t0 = time.perf_counter()
            h = phase_h(orders, li, root, dev)
            cal = h["calibration"]
            print(f"phase H calibration: probe {h['probe_s']:.3f} s, "
                  f"calibrated {json.dumps(cal['calibrated'])}, latency "
                  f"{cal['latency_ms']} ms, h2d {cal['h2d_mb_per_s']} MB/s, "
                  f"d2h {cal['d2h_mb_per_s']} MB/s, host Mrows/s "
                  f"{json.dumps(cal['host_mrows_per_s'])}", flush=True)
            print(f"phase H thresholds: cold {json.dumps(cal['thresholds'])} "
                  f"resident {json.dumps(cal['resident_thresholds'])}",
                  flush=True)
            for q in h["queries"]:
                print(f"phase H {q['name']}: calibrated route cold "
                      f"{q['route_cold']} {q['calibrated_cold_ms']:.1f} ms "
                      f"(device {q['device_cold_ms']:.1f} / host "
                      f"{q['host_cold_ms']:.1f} ms, faster "
                      f"{q['faster_cold']}), warm {q['route_warm']} "
                      f"{q['calibrated_warm_ms']:.1f} ms (device "
                      f"{q['device_warm_ms']:.1f} / host "
                      f"{q['host_warm_ms']:.1f} ms, faster "
                      f"{q['faster_warm']})", flush=True)
            b = h["build"]
            print(f"phase H calibrated build: {CALIBRATED_INDEX} took the "
                  f"{b['route']} route (build threshold {b['threshold']} "
                  f"rows), launches {json.dumps(b['launches'])}, wall "
                  f"{b['wall_s']:.3f} s, every bucket's sha256 equal to "
                  f"phase C's", flush=True)
            ds = h["data_skipping"]
            print(f"phase H data skipping: {DS_INDEX} created in "
                  f"{ds['create_s']:.3f} s; ds_range kept "
                  f"{ds['kept']}/{ds['total']} files, {ds['rows']} rows "
                  f"equal to numpy, cold {ds['on_ms']:.1f} ms with "
                  f"hyperspace (its plan {ds['plan_ms']:.1f} ms), "
                  f"{ds['off_ms']:.1f} ms without", flush=True)
            print("phase H q10 plan with li_ds present:\n" + ds["q10_plan"],
                  flush=True)
            print(f"phase H: ({time.perf_counter() - t0:.3f} s)", flush=True)
        if "E" in runs:
            t0 = time.perf_counter()
            e_builds = phase_e(li, root, dev)
            builds.extend(e_builds)
            for b in e_builds:
                print(f"phase {b['build']}: wall {b['wall_s']:.3f} s, "
                      f"launches {json.dumps(b['launches'])}, phases "
                      f"{json.dumps(b['phases'])}", flush=True)
            print(f"phase E: three SF1 builds bit-equal in every bucket, "
                  f"refresh, noop refresh, delete/restore/vacuum checked; "
                  f"{resident_mib():.1f} MiB resident at the end "
                  f"({time.perf_counter() - t0:.3f} s)", flush=True)
        if "G" in runs:
            t0 = time.perf_counter()
            g = phase_g(orders, li, root, dev)
            builds.extend(g["builds"])
            for b in g["builds"]:
                print(f"phase {b['build']}: wall {b['wall_s']:.3f} s, "
                      f"launches {json.dumps(b['launches'])}, phases "
                      f"{json.dumps(b['phases'])}", flush=True)
            for q in g["queries"]:
                print(f"phase G {q['name']}: cold {q['indexed_cold_ms']:.1f} "
                      f"warm {q['indexed_warm_ms']:.1f} ms, "
                      f"{q['speedup_cold']:.2f}x the scan cold, "
                      f"{q['hybrid_over_clean']:.2f}x the clean index (clean "
                      f"cold {q['clean_cold_ms']:.1f} warm "
                      f"{q['clean_warm_ms']:.1f} ms), cache warm "
                      f"{json.dumps(q['device_cache_warm'])}", flush=True)
            print(f"phase G: lineage create, quick refresh, hybrid queries, "
                  f"incremental refreshes ({g['rows']} rows, "
                  f"{g['two_version_buckets']} buckets in two versions), "
                  f"optimize checked; {g['resident_mib_end']:.1f} MiB "
                  f"resident at the end ({time.perf_counter() - t0:.3f} s; "
                  f"by step {json.dumps(g['steps_s'])})", flush=True)
            res.setdefault("queries", {}).update(
                hybrid_queries=g["queries"])
            by_path.update(g["launches_by_path"])
        if "H" in runs:
            reports = {"C create li_idx": c["report"],
                       **{b["build"]: b["report"] for b in builds
                          if b["build"] in ("E spill pipelined",
                                            "G refresh incremental",
                                            "G optimize quick")}}
            for label, report in reports.items():
                print(f"phase H build report {label}: {json.dumps(report)}",
                      flush=True)
            h["build_reports"] = reports
            res.setdefault("queries", {})["calibration"] = h
        if "I" in runs:
            t0 = time.perf_counter()
            integ = phase_i(orders, li, root, dev)
            print_integrity(integ)
            print(f"phase I: digests on every file, scrubs, bit rot, "
                  f"containment, a truncated file found at execution, a "
                  f"device fault propagated, repair checked "
                  f"({time.perf_counter() - t0:.3f} s)", flush=True)
            res["integrity"] = integ
            by_path["I repair"] = integ["repair_launches"]
            by_path["I containment"] = {
                k: sum(c_[k] for c_ in integ["contained_launches"].values())
                for k in integ["repair_launches"]}
        if "J" in runs:
            t0 = time.perf_counter()
            zorder = phase_j(li, root, dev)
            builds.extend(zorder["builds"])
            codes = zorder["codes"]
            print(f"phase J codes: {codes['rows']} rows, numpy mirror "
                  f"{codes['mirror_s']:.3f} s on the host (order words "
                  f"{codes['words_s']:.3f} s), the card "
                  f"{codes['card_ms']:.3f} ms "
                  f"({codes['card_with_copies_ms']:.1f} ms with the copies), "
                  f"bit for bit; {codes['files']} files, {codes['kept']} "
                  f"kept by the second-dimension range", flush=True)
            for b in zorder["builds"]:
                print(f"phase {b['build']}: wall {b['wall_s']:.3f} s, "
                      f"launches {json.dumps(b['launches'])}, phases "
                      f"{json.dumps(b['phases'])}", flush=True)
            q = zorder["query"]
            print(f"phase J q_zorder_second_dim: kept {q['kept']}/"
                  f"{q['files']} files, {q['rows']} rows equal to numpy, "
                  f"cold {q['cold_ms']:.1f} warm {q['warm_ms']:.1f} ms "
                  f"({q['route']}), scan {q['scan_ms']:.1f} ms, plan "
                  f"{q['plan_ms']:.1f} ms, calibrated cold "
                  f"{q['calibrated_cold_ms']:.1f} ms "
                  f"({q['calibrated_route']})", flush=True)
            print(f"phase J: two builds equal to the mirror's layout file "
                  f"for file, refresh, optimize, repair checked "
                  f"({time.perf_counter() - t0:.3f} s)", flush=True)
            res["zorder"] = {
                "codes": zorder["codes"], "query": zorder["query"],
                "union": zorder["union"],
                "launches_by_path": zorder["launches_by_path"],
                "walls_s": {b["build"]: b["wall_s"]
                            for b in zorder["builds"]}}
        if "K" in runs:
            window = phase_k(li, root, dev)
            print_window(window)
            res["window"] = window
            by_path["K analytic"] = window["launches"]
        if "L" in runs:
            plan_language, l_ctx = phase_l(root, dev)
            print_plan_language(plan_language)
            res["plan_language"] = plan_language
            by_path["L builds"] = plan_language["launches_builds"]
            by_path["L plan language"] = plan_language["launches"]
            if "M" in runs:
                sql_m = phase_m(root, dev, plan_language, l_ctx)
                print_sql(sql_m)
                res["sql"] = sql_m
                by_path["M sql"] = sql_m["launches"]
            del l_ctx
        for letter, key, run, show, paths in (
                ("N", "envelope", phase_n, print_envelope,
                 (("N envelope", "launches"),)),
                ("O", "advisor", phase_o, print_advisor,
                 (("O apply", "launches"), ("O rerun", "launches_rerun"))),
                ("P", "lifecycle", phase_p, print_lifecycle,
                 (("P lifecycle", "launches"),)),
                ("Q", "telemetry", phase_q, print_telemetry,
                 (("Q telemetry", "launches"),)),
                ("R", "diagnostics", phase_r, print_diagnostics,
                 (("R diagnostics", "launches"),)),
                ("S", "object_store", phase_s, print_object_store,
                 (("S object store", "launches"),)),
                ("T", "server", phase_t, print_server,
                 (("T server", "launches"),))):
            if letter in runs:
                out = run(orders, li, root, dev)
                show(out)
                res[key] = out
                for path, field in paths:
                    by_path[path] = out[field]
        if "T" in runs:
            t_results = {k: res["server"].pop(k)
                         for k in ("answers", "expected")}
        if "U" in runs:
            u = phase_u(orders, li, root, dev,
                        {**res["server"], **t_results}, u_turns)
            print_server_u(u)
            res["server_u"] = u
            by_path["U server"] = u["launches"]
        if "V" in runs:
            v = phase_v(orders, li, root, dev)
            print_fleet(v)
            res["fleet"] = v
            by_path["V fleet"] = v["launches"]
        if "W" in runs:
            w = phase_w(orders, li, root, dev,
                        c["phases"].get("read_s") if "C" in runs else None)
            print_formats(w)
            res["formats"] = w
            by_path["W formats"] = w["launches"]
        if "X" in runs:
            x = phase_x(li, root, dev, c["phases"].get("read_s"))
            print_delta(x)
            res["delta"] = x
            by_path["X delta"] = x["launches"]
        if "Y" in runs:
            y = phase_y(li, root, dev, c["phases"].get("read_s"))
            print_iceberg(y)
            res["iceberg"] = y
            by_path["Y iceberg"] = y["launches"]
        if "Z" in runs:
            z = phase_z(orders, li, root, dev)
            print_mesh(z)
            res["mesh"] = z
            by_path["Z sharded spill"] = z["launches"]
            by_path["Z distributed build"] = \
                z["builds"]["distributed"]["launches"]
        if "MH" in runs:
            mh = phase_mh(orders, li, root, dev)
            print_multihost(mh)
            res["multihost"] = mh
            by_path["MH multihost build"] = mh["launches"]
            by_path["MH hierarchical shuffle"] = mh["shuffle_launches"]
        del orders
        if "T" in runs:
            del t_results
        if "F" in runs:
            t0 = time.perf_counter()
            f = phase_f(root, dev)
            sf10_z = f.pop("zorder")
            builds.append(f)
            builds.append(sf10_z)
            print(f"phase F: {SF10_INDEX} over {f['rows']} rows in "
                  f"{f['chunks']} chunks, wall {f['wall_s']:.3f} s, phases "
                  f"{json.dumps(f['phases'])}, peak RSS "
                  f"{f['peak_rss_mb']:.0f} MB, card peak "
                  f"{f['max_memory_allocated'] / 2**20:.0f} MiB, "
                  f"{resident_mib():.1f} MiB resident at the end "
                  f"({time.perf_counter() - t0:.3f} s, datagen "
                  f"{f['datagen_s']:.3f} s)", flush=True)
            print(f"phase J {SF10_Z_INDEX}: {sf10_z['files']} files, wall "
                  f"{sf10_z['wall_s']:.3f} s, phases "
                  f"{json.dumps(sf10_z['phases'])}, peak RSS "
                  f"{sf10_z['peak_rss_mb']:.0f} MB, card peak "
                  f"{sf10_z['max_memory_allocated'] / 2**20:.0f} MiB; codes "
                  f"{sf10_z['codes_card_ms']:.3f} ms on the card; kept "
                  f"{sf10_z['kept']}/{sf10_z['files']}, query cold "
                  f"{sf10_z['query_cold_ms']:.1f} ms, scan "
                  f"{sf10_z['scan_cold_ms']:.1f} ms", flush=True)
            if "zorder" in res:
                res["zorder"]["sf10"] = {k: v for k, v in sf10_z.items()
                                         if k != "report"}
    finally:
        shutil.rmtree(root, ignore_errors=True)

    by_path = {**head, **{b["build"]: b["launches"] for b in builds},
               **by_path}
    if launches is None:
        # No phase C in this selection: the launches of what ran.
        launches = {k: sum(p[k] for p in by_path.values())
                    for k in ("hash_buckets", "bucket_histogram")}
    spill = [b for b in builds if b["build"] == "E spill pipelined"]
    t0 = time.perf_counter()
    rows = measure(dev, li["l_orderkey"], launches, by_path,
                   spill[0]["launches"] if spill else None)
    print(f"timing: {time.perf_counter() - t0:.3f} s", flush=True)
    bad = [r["name"] for r in rows
           for s in r["shapes"] if s["max_abs_err"] != 0]
    if bad:
        raise AssertionError(f"kernels differ from their plain versions: {bad}")
    if "telemetry" in res:
        res["telemetry"].update(q_check_seams(res["telemetry"], rows))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    if builds:
        print(json.dumps({"builds": builds}))
    if "queries" in res:
        print(json.dumps({"queries": res["queries"]}))
    print(json.dumps({"kernels": rows}))
    for key in ("integrity", "zorder", "window", "plan_language", "sql"):
        if key in res:
            print(json.dumps({key: res[key]}))
    for key in ("envelope", "advisor", "lifecycle", "telemetry",
                "diagnostics", "object_store", "server", "server_u",
                "fleet", "formats", "delta", "iceberg", "mesh",
                "multihost"):
        if key in res:
            print(json.dumps({key: {**res[key], "card": smi}}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
