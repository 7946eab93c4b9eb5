"""The crash-tolerant multi-host index build (counterpart of
hyperspace_tpu/parallel/multihost_build.py).

N host subprocesses build one index with no collective between them: a
killed participant poisons a collective.  Rows move between hosts as
spill files, and the hosts coordinate through
:class:`~hyperspace_tpu_torch.lifecycle.lease.WorkClaims`, one claim per
work item over the store every host shares.  The items are the spill
build's two phases (``actions/create._BucketSpill``), so the bytes are
the single-process build's:

  - ``chunk-<n>``: route one slice of the global row stream (the
    ``device_batch_rows`` cuts of ``_stream_build``) through
    ``ops.hash.route_partition`` on the host's device (the hash and the
    histogram kernels on the card, one launch each), and land one Arrow
    IPC run file per (chunk, bucket group) in the shared spill directory
    by temp file and atomic rename.  The done record carries the
    buckets of each run and the host's kernel launches for the chunk.
  - ``group-<g>``: once every chunk is done, merge one bucket group's
    runs in chunk order (ties in global row order), sort each bucket and
    write Parquet into the holder's own staging directory; the done
    record carries the staged files with their sha256.

A killed host's claims expire after ``multihost_build_claim_ttl_s`` and
a survivor redoes exactly those items (a group written again is the same
bytes).  A fenced holder loses the done record's CAS, journals ``fence``
and deletes its staged files.  The coordinator (the CreateAction) checks
the union (every group done, every staged file present and hashing to
its manifest, every row accounted for), moves the files into the next
``v__=N`` directory, and the action's ordinary commit publishes it all
or nothing.  Scratch lives under ``<systemPath>/_hyperspace_build/
build-<pid>-<token>/``; a dead coordinator's directory is reaped at the
next build.

Each host runs on the session's device: the spec names it, a host asked
for ``cuda`` without CUDA raises, and the parent resolves the build
threshold (``conf.device_min_rows("build", device)``) for every host.
Hosts are fresh interpreters (``subprocess.Popen`` of ``sys.executable``;
a process holding a CUDA context is never forked) and load the kernels
the parent built from ``csrc/build/``.  The parent's launch counters do
not see the hosts' launches: the coordinator sums the chunk claims'
``launches`` into the build report's ``multihost_launches``, a key the
JAX package lacks.  Not ported: the fleet heartbeat of the hosts.
pyarrow is imported when a function runs.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

BUILD_DIR = "_hyperspace_build"
PLAN_KEY = "plan"
_BUILD_DIR_PREFIX = "build-"
_MAX_GROUPS = 8  # _BucketSpill._MAX_GROUPS: the same group cuts
# What each host subprocess runs.
HOST_CODE = ("from hyperspace_tpu_torch.parallel.multihost_build import "
             "host_main; host_main()")


def armed(conf) -> bool:
    """Whether create_index runs through the claim pipeline: 0 hosts is
    the build of this process, 1 one host subprocess through the same
    protocol (the 1-host baseline), 2 or more the multi-host build."""
    return int(getattr(conf, "multihost_build_hosts", 0)) >= 1


def build_root(conf) -> str:
    from hyperspace_tpu_torch.index.manager import system_path_of

    return os.path.join(system_path_of(conf), BUILD_DIR)


def _store(conf, build_id: str):
    from hyperspace_tpu_torch.telemetry.perf_ledger import store_for

    return store_for(conf, os.path.join(build_root(conf), build_id))


def reap_orphan_build_dirs(conf) -> int:
    """Remove the build directories whose coordinator pid is provably
    dead (``actions/create.reap_orphan_spill_dirs``' contract: a killed
    coordinator runs no cleanup).  Returns how many were removed."""
    from hyperspace_tpu_torch.actions.create import _pid_alive
    from hyperspace_tpu_torch.io.files import remove_tree

    root = build_root(conf)
    try:
        names = os.listdir(root)
    except OSError:
        return 0
    reaped = 0
    for name in names:
        if not name.startswith(_BUILD_DIR_PREFIX):
            continue
        pid_part = name[len(_BUILD_DIR_PREFIX):].split("-", 1)[0]
        if not pid_part.isdigit():
            continue
        pid = int(pid_part)
        if pid == os.getpid() or _pid_alive(pid):
            continue
        remove_tree(os.path.join(root, name), ignore_errors=True)
        reaped += 1
    return reaped


# -- the plan (written once by the coordinator, read by every host) ----------

def _group_bounds(num_buckets: int, groups: int) -> List[int]:
    from hyperspace_tpu_torch.parallel.sharded_build import (
        bucket_group_bounds,
    )

    return bucket_group_bounds(num_buckets, groups)


def _chunk_ranges(total_rows: int, batch_rows: int) -> List[List[int]]:
    """The global row stream cut at ``batch_rows``: ``_stream_build``'s
    boundaries, so the runs and their tie order are the same."""
    return [[start, min(start + batch_rows, total_rows)]
            for start in range(0, total_rows, batch_rows)]


def _code_column_names(columns, indexed, rel_schema, lineage) -> List[str]:
    """The carried sort-code columns, from the relation's schema
    (``_BucketSpill._plan_code_columns``: none when a key is
    rank-mapped)."""
    from hyperspace_tpu_torch.actions.create import DATA_FILE_ID_COLUMN
    from hyperspace_tpu_torch.io import columnar
    from hyperspace_tpu_torch.io.parquet import _dtype_from_string

    for c in indexed:
        if not columnar.is_numeric_type(
                _dtype_from_string(rel_schema.get(c, "string"))):
            return []
    taken = set(columns)
    if lineage:
        taken.add(DATA_FILE_ID_COLUMN)
    names = []
    for i in range(len(indexed)):
        name = f"__hs_sort{i}"
        while name in taken:
            name += "_"
        taken.add(name)
        names.append(name)
    return names


def make_plan(conf, build_id: str, index_name: str, relation, resolved,
              files, columns, lineage: bool, batch_rows: int) -> Dict:
    """The build plan every host runs.  Needs Parquet data files (their
    footers' row counts cut the chunks without a decode) and the
    lexicographic layout."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from hyperspace_tpu_torch.exceptions import HyperspaceError

    if getattr(resolved, "layout", "lexicographic") == "zorder":
        raise HyperspaceError(
            "multihost build does not support the zorder layout (the "
            "global curve is a single two-pass build); set "
            "multihost_build_hosts to 0 for this index")
    if relation.read_format != "parquet":
        raise HyperspaceError(
            f"multihost build requires parquet sources (footer row "
            f"counts plan the chunk claims); got "
            f"{relation.read_format!r}")
    file_rows = []
    for f in files:
        try:
            file_rows.append(pq.read_metadata(f.name).num_rows)
        except (OSError, pa.ArrowException) as e:
            raise HyperspaceError(
                f"multihost build could not read the parquet footer of "
                f"{f.name}: {e}") from e
    total = sum(file_rows)
    num_buckets = int(conf.num_buckets)
    groups = min(_MAX_GROUPS, num_buckets)
    rel_schema = dict(relation.schema())
    return {
        "v": 1,
        "build_id": build_id,
        "index": index_name,
        "format": relation.read_format,
        "roots": list(relation.root_paths),
        "options": [list(kv) for kv in relation.options.items()],
        "partition_spec": dict(relation.partition_spec()),
        "rel_schema": rel_schema,
        "files": [{"name": f.name, "id": f.id, "rows": r}
                  for f, r in zip(files, file_rows)],
        "columns": list(columns),
        "indexed": list(resolved.indexed_columns),
        "layout": getattr(resolved, "layout", "lexicographic"),
        "lineage": bool(lineage),
        "total_rows": total,
        "batch_rows": int(batch_rows),
        "num_buckets": num_buckets,
        "groups": groups,
        "bounds": _group_bounds(num_buckets, groups),
        "chunks": _chunk_ranges(total, int(batch_rows)),
        "code_cols": _code_column_names(
            columns, resolved.indexed_columns, rel_schema, lineage),
        "max_rows_per_file": int(conf.index_max_rows_per_file),
        "compression": conf.index_file_compression,
    }


def _chunk_items(plan: Dict) -> List[str]:
    return [f"chunk-{i:05d}" for i in range(len(plan["chunks"]))]


def _group_items(plan: Dict) -> List[str]:
    return [f"group-{g:03d}" for g in range(plan["groups"])]


def _scratch(conf, build_id: str) -> str:
    return os.path.join(build_root(conf), build_id)


# -- host side: route and finalize under claims ------------------------------

def _read_global_slice(plan: Dict, start: int, end: int, cache: Dict):
    """Rows ``[start, end)`` of the global stream (files in listing
    order, rows in file order), as ``_read_chunk`` and ``_stream_build``
    give them: missing columns as nulls of the relation's type, the
    lineage column per file.  ``cache`` keeps the last two files read."""
    import pyarrow as pa

    from hyperspace_tpu_torch.actions.create import DATA_FILE_ID_COLUMN
    from hyperspace_tpu_torch.io.parquet import _dtype_from_string, read_file

    columns = plan["columns"]
    options = {k: v for k, v in plan["options"]}
    parts = []
    offset = 0
    for frec in plan["files"]:
        rows = frec["rows"]
        lo, hi = max(start, offset), min(end, offset + rows)
        if lo < hi:
            t = cache.get(frec["name"])
            if t is None:
                t = read_file(frec["name"], columns, plan["format"], options,
                              partition_roots=plan["roots"],
                              partition_spec=plan["partition_spec"])
                for c in columns:
                    if c not in t.column_names:
                        t = t.append_column(c, pa.nulls(
                            t.num_rows, type=_dtype_from_string(
                                plan["rel_schema"].get(c, "string"))))
                if plan["lineage"]:
                    t = t.append_column(DATA_FILE_ID_COLUMN, pa.array(
                        np.full(t.num_rows, frec["id"], dtype=np.int64)))
                while len(cache) >= 2:
                    cache.pop(next(iter(cache)))
                cache[frec["name"]] = t
            parts.append(t.slice(lo - offset, hi - lo))
        offset += rows
        if offset >= end:
            break
    return pa.concat_tables(parts, promote_options="default")


def _route_table(conf, plan: Dict, table, device):
    """One chunk's route: ``_BucketSpill._route_chunk``'s kernels and
    host mirror threshold on this host's one device, so bucket ids and
    tie order are the single-process build's.  Returns the routed table
    (with its carried codes) and each bucket's [start, end)."""
    import pyarrow as pa

    from hyperspace_tpu_torch.io import columnar
    from hyperspace_tpu_torch.ops.hash import (
        route_partition,
        route_partition_np,
    )

    code_cols = plan["code_cols"]
    key_cols = plan["indexed"]
    num_buckets = plan["num_buckets"]
    word_cols = [columnar.to_hash_words(table.column(c)) for c in key_cols]
    codes64 = [columnar.to_order_codes64(table.column(c))
               for c in key_cols] if code_cols else []
    if table.num_rows < conf.device_min_rows("build", device):
        buckets, perm = route_partition_np(word_cols, codes64, num_buckets)
        counts = np.bincount(buckets, minlength=num_buckets)
    else:
        perm, counts = route_partition(
            word_cols, [columnar.split_words64(k) for k in codes64],
            num_buckets, device)
    routed = table.take(pa.array(perm))
    for i, name in enumerate(code_cols):
        routed = routed.append_column(name, pa.array(codes64[i][perm]))
    starts = np.zeros(num_buckets, dtype=np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    return routed, starts, starts + counts


def _route_one_chunk(conf, plan: Dict, scratch: str, chunk_no: int,
                     cache: Dict, device) -> Dict:
    """One ``chunk-<n>`` claim's work: read the slice, route it, land one
    run file per touched bucket group (temp file and atomic rename), and
    return the claim's result: each group's buckets in batch order, and
    the kernel launches of the route."""
    from hyperspace_tpu_torch.actions.create import _write_chunk_file
    from hyperspace_tpu_torch.io import faults
    from hyperspace_tpu_torch.ops import kernels

    start, end = plan["chunks"][chunk_no]
    table = _read_global_slice(plan, start, end, cache)
    before = kernels.launch_counts()
    routed, starts, ends = _route_table(conf, plan, table, device)
    after = kernels.launch_counts()
    spill = os.path.join(scratch, "spill")
    groups: Dict[str, List[int]] = {}
    for gid in range(plan["groups"]):
        b0, b1 = plan["bounds"][gid], plan["bounds"][gid + 1]
        present = [b for b in range(b0, b1) if ends[b] > starts[b]]
        if not present:
            continue
        path = os.path.join(spill, f"chunk-{chunk_no:05d}-g{gid:03d}.arrow")
        tmp = f"{path}.tmp-{os.getpid()}-{uuid.uuid4().hex[:6]}"
        _write_chunk_file(
            routed, tmp,
            [(int(starts[b]), int(ends[b] - starts[b])) for b in present])
        faults.atomic_replace(tmp, path, "data.write")
        groups[str(gid)] = present
    result = {"rows": table.num_rows, "groups": groups,
              "launches": {k: after[k] - before[k] for k in after}}
    if not chunk_no:
        result["schema"] = {name: str(t) for name, t in
                            zip(table.column_names, table.schema.types)}
    return result


def _finalize_group(conf, plan: Dict, scratch: str, gid: int,
                    chunk_results: List[Dict], staged_dir: str) -> Dict:
    """One ``group-<g>`` claim's work: merge the group's runs in chunk
    order, sort each bucket (the carried codes, or the host's order
    words: ``_finish_group``), write Parquet into ``staged_dir`` (the
    holder's own), and return the staged manifest with each file's
    sha256."""
    import pyarrow as pa

    from hyperspace_tpu_torch.io.parquet import (
        sort_permutation_from_codes,
        sort_permutation_host,
        write_bucket_run,
    )

    spill = os.path.join(scratch, "spill")
    # bucket -> [(chunk_no, path, batch index)]: chunk order is tie order.
    runs: Dict[int, List[Tuple[int, str, int]]] = {}
    paths = []
    for chunk_no, res in enumerate(chunk_results):
        present = res["groups"].get(str(gid))
        if not present:
            continue
        path = os.path.join(spill, f"chunk-{chunk_no:05d}-g{gid:03d}.arrow")
        paths.append(path)
        for bi, b in enumerate(present):
            runs.setdefault(b, []).append((chunk_no, path, bi))
    os.makedirs(staged_dir, exist_ok=True)
    code_cols = plan["code_cols"]
    manifest: List[Dict[str, Any]] = []
    readers = {}
    handles = []
    rows_total = 0
    try:
        for p in paths:
            mm = pa.memory_map(p, "rb")
            handles.append(mm)
            readers[p] = pa.ipc.open_file(mm)
        for b in sorted(runs):
            btable = pa.Table.from_batches(
                [readers[p].get_batch(bi) for _no, p, bi in sorted(runs[b])])
            if code_cols:
                perm = sort_permutation_from_codes(btable, code_cols)
                btable = btable.take(pa.array(perm)).drop_columns(
                    list(code_cols))
            else:
                perm = sort_permutation_host(btable, plan["indexed"],
                                             plan["layout"])
                btable = btable.take(pa.array(perm))
            written = write_bucket_run(
                btable, b, staged_dir, plan["max_rows_per_file"],
                compression=plan["compression"])
            rows_total += btable.num_rows
            manifest.extend({"name": os.path.basename(p), "bucket": b,
                             "sha256": _sha256_file(p)} for p in written)
    finally:
        for mm in handles:
            mm.close()
    return {"dir": os.path.relpath(staged_dir, scratch),
            "files": manifest, "rows": rows_total}


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _safe_name(owner: str) -> str:
    return "".join(c if c.isalnum() or c in "-_." else "_" for c in owner)


def run_host(conf, build_id: str, owner: Optional[str] = None,
             device="cuda") -> int:
    """One host's loop: claim and route every chunk, then claim and
    finalize every bucket group, reclaiming expired items as they
    appear, on ``device``.  Every output is committed through the claim
    CAS; a fenced attempt deletes its staged files and moves on.  Returns
    how many items this host completed."""
    import torch

    from hyperspace_tpu_torch.exceptions import HyperspaceError
    from hyperspace_tpu_torch.io.files import remove_tree
    from hyperspace_tpu_torch.lifecycle.lease import (
        WorkClaims,
        process_identity,
    )

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise HyperspaceError(
            f"multihost build host asked for {device}, and no CUDA device "
            f"is available; it does not route on the CPU instead")
    owner = owner or process_identity()
    store = _store(conf, build_id)
    plan = json.loads(store.read(PLAN_KEY).decode("utf-8"))
    scratch = _scratch(conf, build_id)
    claims = WorkClaims(store, conf, owner=owner,
                        ttl_s=float(conf.multihost_build_claim_ttl_s),
                        index=plan["index"])
    poll_s = max(0.005, float(conf.multihost_build_poll_s))
    cache: Dict[str, Any] = {}

    def drive(items, process) -> int:
        """Claim and process items until every one is done; returns how
        many this host completed."""
        done_here = 0
        while True:
            progress = False
            remaining = False
            for item in items:
                rec, _gen = claims.get(item)
                if rec is not None and rec.get("done"):
                    continue
                claim = claims.try_claim(item)
                if claim is None:
                    remaining = True
                    continue
                outputs = process(item, claim)
                # Within the margin of its expiry, renew before the done
                # record: a lost renew means the item was reclaimed and
                # this output is a zombie's.
                committed = False
                if claims.holds(claim) or claims.renew(claim):
                    committed = claims.complete(claim, outputs["result"])
                if committed:
                    done_here += 1
                else:
                    for orphan in outputs.get("discard", ()):
                        remove_tree(orphan, ignore_errors=True)
                    remaining = True
                progress = True
            if not remaining:
                return done_here
            if not progress:
                time.sleep(poll_s)

    def route(item, claim) -> Dict:
        # Run files are shared and deterministic: a fenced duplicate
        # wrote the same bytes, so there is nothing to discard.
        return {"result": _route_one_chunk(conf, plan, scratch,
                                           int(item.split("-")[1]), cache,
                                           device)}

    completed = drive(_chunk_items(plan), route)
    cache.clear()
    chunk_results = [claims.result(it) for it in _chunk_items(plan)]

    def finalize(item, claim) -> Dict:
        gid = int(item.split("-")[1])
        staged = os.path.join(scratch, "staged", _safe_name(owner),
                              f"g{gid:03d}-e{claim['epoch']:03d}")
        return {"result": _finalize_group(conf, plan, scratch, gid,
                                          chunk_results, staged),
                "discard": [staged]}

    completed += drive(_group_items(plan), finalize)
    return completed


def host_main() -> None:
    """A host subprocess's entry: the spec in ``HS_MULTIHOST_SPEC``
    (system path, build id, device, conf fields)."""
    from hyperspace_tpu_torch.config import HyperspaceConf

    spec = json.loads(os.environ["HS_MULTIHOST_SPEC"])
    conf = HyperspaceConf()
    conf.system_path = spec["system_path"]
    for field, value in spec.get("conf", {}).items():
        setattr(conf, field, value)
    run_host(conf, spec["build_id"], owner=spec.get("owner"),
             device=spec["device"])


_WORKER_CONF_FIELDS = (
    "num_buckets", "device_batch_rows", "index_max_rows_per_file",
    "index_file_compression", "log_store_class",
    "object_store_stale_list_ms", "multihost_build_claim_ttl_s",
    "multihost_build_poll_s", "lineage_enabled",
)


def spawn_hosts(conf, build_id: str, n: int,
                device="cuda") -> List[subprocess.Popen]:
    """Start ``n`` host subprocesses on one plan, each a fresh
    interpreter on ``device`` (never a fork of a process that may hold a
    CUDA context).  The build threshold is resolved here, so every host,
    and any host that reclaims, takes the same route."""
    import hyperspace_tpu_torch

    overrides = {f: getattr(conf, f) for f in _WORKER_CONF_FIELDS}
    overrides["device_build_min_rows"] = conf.device_min_rows("build", device)
    pkg_parent = os.path.dirname(
        os.path.dirname(os.path.abspath(hyperspace_tpu_torch.__file__)))
    procs = []
    for _ in range(n):
        env = dict(os.environ)
        env["HS_MULTIHOST_SPEC"] = json.dumps({
            "system_path": conf.system_path,
            "build_id": build_id,
            "device": str(device),
            "conf": overrides,
            "owner": None,  # the subprocess's own process identity
        })
        # The child has no cwd entry on sys.path: pin the package's.
        env["PYTHONPATH"] = pkg_parent + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        procs.append(subprocess.Popen([sys.executable, "-c", HOST_CODE],
                                      env=env))
    return procs


# -- coordinator side (runs inside the CreateAction) -------------------------

def _poll_done(claims, items) -> int:
    done = 0
    for item in items:
        rec, _gen = claims.get(item)
        if rec is not None and rec.get("done"):
            done += 1
    return done


def _claim_span(claims, items) -> float:
    """A phase's wall from its done records: first acquire to last
    complete, without the hosts' interpreter start."""
    first, last = None, None
    for item in items:
        rec, _gen = claims.get(item)
        if rec is None or not rec.get("done"):
            continue
        acq = float(rec.get("acquired_at", 0.0))
        fin = float(rec.get("completed_at", 0.0))
        if acq and (first is None or acq < first):
            first = acq
        if fin and (last is None or fin > last):
            last = fin
    if first is None or last is None:
        return 0.0
    return max(0.0, last - first)


def run_multihost_build(action, files, columns, relation, resolved,
                        lineage: bool, batch_rows: int) -> None:
    """The coordinator: plan, spawn the hosts, watch the claim table,
    check and promote the union, and leave the action's commit at
    ``base_id + 2`` as the one transaction.  Called from
    ``CreateActionBase._build_index_data`` when ``armed``."""
    from hyperspace_tpu_torch.exceptions import HyperspaceError
    from hyperspace_tpu_torch.io.files import remove_tree
    from hyperspace_tpu_torch.lifecycle import journal
    from hyperspace_tpu_torch.lifecycle.lease import (
        WorkClaims,
        process_identity,
    )
    from hyperspace_tpu_torch.telemetry import metrics

    conf = action.conf
    reap_orphan_build_dirs(conf)
    n_hosts = int(conf.multihost_build_hosts)
    build_id = f"{_BUILD_DIR_PREFIX}{os.getpid()}-{uuid.uuid4().hex[:8]}"
    plan = make_plan(conf, build_id, action.index_name, relation, resolved,
                     files, columns, lineage, batch_rows)
    scratch = _scratch(conf, build_id)
    os.makedirs(os.path.join(scratch, "spill"), exist_ok=True)
    store = _store(conf, build_id)
    store.put_if_absent(PLAN_KEY, json.dumps(plan).encode("utf-8"))
    claims = WorkClaims(store, conf, owner=f"coordinator-{process_identity()}",
                        ttl_s=float(conf.multihost_build_claim_ttl_s),
                        index=action.index_name)
    poll_s = max(0.005, float(conf.multihost_build_poll_s))
    deadline = time.monotonic() + \
        max(1.0, float(conf.multihost_build_deadline_s))
    chunk_items, group_items = _chunk_items(plan), _group_items(plan)
    procs = spawn_hosts(conf, build_id, n_hosts, device=action.session.device)
    t_spawn = time.perf_counter()
    try:
        # The coordinator only watches: claims expire and survivors
        # reclaim them; it fails when nobody is left to make progress.
        expired_logged = set()
        for items, phase in ((chunk_items, "route"),
                             (group_items, "finalize")):
            while _poll_done(claims, items) < len(items):
                if time.monotonic() > deadline:
                    raise HyperspaceError(
                        f"multihost build {build_id}: {phase} phase "
                        f"missed the deadline "
                        f"({conf.multihost_build_deadline_s}s) with "
                        f"{len(items) - _poll_done(claims, items)} "
                        f"items pending")
                if all(p.poll() is not None for p in procs):
                    raise HyperspaceError(
                        f"multihost build {build_id}: every host exited "
                        f"(codes {[p.returncode for p in procs]}) with "
                        f"{phase} items pending")
                # An expired claim nobody took yet: a host died or
                # stalled.  Journal each sighting once per claim epoch.
                now = time.time()
                for item in items:
                    rec, _g = claims.get(item)
                    if rec is not None and not rec.get("done") and \
                            float(rec.get("expires_at", 0)) < now:
                        metrics.inc("build.claims.expired_seen")
                        key = (item, int(rec.get("epoch", 0)))
                        if key not in expired_logged:
                            expired_logged.add(key)
                            journal.append(conf, {
                                "decision": "claim",
                                "index": action.index_name,
                                "mode": "expired", "outcome": "observed",
                                "reason": f"{phase} claim expired "
                                          f"un-reclaimed — straggler or "
                                          f"crash; a survivor reclaims "
                                          f"after the TTL",
                                "holder": str(rec.get("holder", "")),
                                "epoch": int(rec.get("epoch", 0)),
                                "item": item,
                            })
                time.sleep(poll_s)
        route_wall = _claim_span(claims, chunk_items)
        finalize_wall = _claim_span(claims, group_items)
        total_wall = time.perf_counter() - t_spawn
        for p in procs:
            try:
                p.wait(timeout=30.0)
            except subprocess.TimeoutExpired:
                p.kill()  # a stopped zombie; its claims are already lost
                p.wait()
        _commit_staged(action, plan, claims, scratch, resolved)
        journal.append(conf, {
            "decision": "claim", "index": action.index_name,
            "mode": "commit", "outcome": "done",
            "reason": f"{len(group_items)} groups / {len(chunk_items)} "
                      f"chunks over {n_hosts} hosts",
            "holder": claims.owner, "epoch": 0, "item": build_id,
        })
        launches: Dict[str, int] = {}
        for item in chunk_items:
            for k, v in (claims.result(item) or {}).get(
                    "launches", {}).items():
                launches[k] = launches.get(k, 0) + int(v)
        action.build_report.properties.update(
            multihost_hosts=n_hosts,
            multihost_chunks=len(chunk_items),
            multihost_groups=len(group_items),
            multihost_route_wall_s=round(route_wall, 4),
            multihost_finalize_wall_s=round(finalize_wall, 4),
            multihost_total_wall_s=round(total_wall, 4),
            multihost_launches=launches)
        action._phase("mh_route_s", route_wall)
        action._phase("mh_finalize_s", finalize_wall)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        remove_tree(scratch, ignore_errors=True)


def _commit_staged(action, plan: Dict, claims, scratch: str,
                   resolved) -> None:
    """Check the union of the staged manifests (every group done, every
    file present and hashing to its manifest, every source row written)
    and move the files into the next ``v__=N`` directory.  A gap aborts
    before that directory exists."""
    from hyperspace_tpu_torch.exceptions import HyperspaceError
    from hyperspace_tpu_torch.io import faults, integrity

    manifests = {}
    rows = 0
    for item in _group_items(plan):
        res = claims.result(item)
        if res is None:
            raise HyperspaceError(
                f"multihost build: {item} has no completed claim")
        gid = int(item.split("-")[1])
        b0, b1 = plan["bounds"][gid], plan["bounds"][gid + 1]
        for frec in res["files"]:
            if not b0 <= frec["bucket"] < b1:
                raise HyperspaceError(
                    f"multihost build: {item} staged bucket "
                    f"{frec['bucket']} outside its range [{b0}, {b1})")
            staged = os.path.join(scratch, res["dir"], frec["name"])
            if not os.path.exists(staged):
                raise HyperspaceError(
                    f"multihost build: staged file missing: {staged}")
            if _sha256_file(staged) != frec["sha256"]:
                raise HyperspaceError(
                    f"multihost build: staged file {staged} does not "
                    f"match its manifest sha256")
        rows += int(res.get("rows", 0))
        manifests[item] = res
    if rows != plan["total_rows"]:
        raise HyperspaceError(
            f"multihost build: staged {rows} rows for "
            f"{plan['total_rows']} source rows — refusing to commit a "
            f"torn index")
    schema = (claims.result(_chunk_items(plan)[0]) or {}).get("schema") \
        if plan["chunks"] else None
    version = action.data_manager.get_next_version()
    out_dir = action.data_manager.version_path(version)
    os.makedirs(out_dir, exist_ok=True)
    written = 0
    for res in manifests.values():
        for frec in res["files"]:
            dst = os.path.join(out_dir, frec["name"])
            faults.atomic_replace(os.path.join(scratch, res["dir"],
                                               frec["name"]),
                                  dst, "data.write")
            integrity.record_file(dst)
            written += os.path.getsize(dst)
    action.build_report.add_bytes(
        written=written, files=sum(len(r["files"]) for r in manifests.values()))
    action._write_index_file_sketch(out_dir, resolved)
    action._written_version = version
    if schema:
        action._index_schema = dict(schema)


# -- doctor seam -------------------------------------------------------------

def scan_build_claims(conf) -> List[Dict[str, Any]]:
    """Every pending claim record of every build directory under this
    tree, with its build id.  Never raises."""
    from hyperspace_tpu_torch.lifecycle.lease import WorkClaims, _parse

    out: List[Dict[str, Any]] = []
    try:
        builds = sorted(os.listdir(build_root(conf)))
    except OSError:
        return out
    for build_id in builds:
        if not build_id.startswith(_BUILD_DIR_PREFIX):
            continue
        try:
            store = _store(conf, build_id)
            for key in store.list_keys():
                if not key.startswith(WorkClaims.PREFIX):
                    continue
                payload, _gen = store.read_with_generation(key)
                rec = _parse(payload)
                if rec is None or rec.get("done"):
                    continue
                rec = dict(rec)
                rec["build_id"] = build_id
                out.append(rec)
        except Exception:  # noqa: BLE001 - a flaky store reads as empty
            continue
    return out
