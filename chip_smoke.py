#!/usr/bin/env python3
"""Drive hyperspace_tpu_torch on one CUDA card and check it.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one
CUDA device and exits non-zero without one, or when the package is not
beside it.

  build    compile both CUDA kernels from ``hyperspace_tpu_torch/csrc``
           (one nvcc per source, started together).
  phase A  each kernel against its plain PyTorch version on the card:
           random words at n in {1, 7, 32769, 6_000_000}, k in {1, 3},
           num_buckets in {0, 16, 200, 4096}; histogram ids with -1
           padding, and n = 0.  Results must be bit-equal.
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

The data is bench.py's SF1 generator (``default_rng(7)``), copied here.
Then each kernel is timed at the main path's shape (CUDA events, L2
flushed before each launch, median of 25 launches after warm-up) beside
its bound, its plain version and, where one exists, one PyTorch call
computing the same function.  The last lines are the kernels JSON, the
card's name and power limit, and ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import json
import os
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

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
# 67 TFLOP/s of float32 outside the tensor cores counts an FMA as two
# operations; the kernels' integer ops issue one each, so 33.5e12 op/s.
ALU_OPS_PER_S = 33.5e12
L2_BYTES = 50 * 1024 * 1024
TIMED_RUNS = 25


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


def gen_data() -> dict:
    """bench.py's ``_gen_data`` random stream: the orders columns are
    drawn first (and dropped) so the lineitem is the benchmark's own."""
    rng = np.random.default_rng(7)
    o_key = np.arange(N_ORDERS, dtype=np.int64)
    rng.shuffle(o_key)
    rng.integers(0, 20_000, N_ORDERS)
    rng.random(N_ORDERS)
    rng.integers(0, 5, N_ORDERS)
    return gen_lineitem(rng, N_LINEITEM)


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


def phase_a(dev) -> None:
    import torch

    from hyperspace_tpu_torch.ops import kernels

    rng = np.random.default_rng(1)
    for n in (1, 7, 32769, N_LINEITEM):
        for k in (1, 3):
            cols = [torch.from_numpy(rng.integers(0, 2**32, size=(n, 2),
                                                  dtype=np.uint32)).to(dev)
                    for _ in range(k)]
            for nb in (0, 16, 200, 4096):
                require_equal(f"hash_buckets n={n} k={k} nb={nb}",
                              kernels.hash_buckets(cols, nb),
                              kernels.hash_buckets_plain(cols, nb))
        for nb in (16, 200, 4096):
            ids = torch.from_numpy(
                rng.integers(-1, nb, size=n).astype(np.int32)).to(dev)
            require_equal(f"bucket_histogram n={n} nb={nb}",
                          kernels.bucket_histogram(ids, nb),
                          kernels.bucket_histogram_plain(ids, nb))
    empty = torch.empty(0, dtype=torch.int32, device=dev)
    require_equal("bucket_histogram n=0", kernels.bucket_histogram(empty, 64),
                  torch.zeros(64, dtype=torch.int32, device=dev))
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


def phase_c(li: dict, root: str) -> dict:
    import pyarrow as pa
    import pyarrow.compute as pc
    import pyarrow.parquet as pq

    from hyperspace_tpu_torch import Hyperspace, HyperspaceSession, IndexConfig
    from hyperspace_tpu_torch.io.parquet import bucket_id_of_file
    from hyperspace_tpu_torch.ops import kernels
    from hyperspace_tpu_torch.ops.hash import bucket_ids_np

    src = os.path.join(root, "lineitem")
    os.makedirs(src)
    table = pa.table(li)
    step = -(-table.num_rows // N_FILES)
    for f in range(N_FILES):
        pq.write_table(table.slice(f * step, step),
                       os.path.join(src, f"part-{f:05d}.parquet"))
    del table

    session = HyperspaceSession(system_path=os.path.join(root, "indexes"))
    session.conf.num_buckets = NUM_BUCKETS
    session.conf.device_batch_rows = 1 << 23
    hs = Hyperspace(session)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    hs.create_index(session.read.parquet(src),
                    IndexConfig(INDEX_NAME, INDEXED, INCLUDED))
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    phases = session.build_stats_log[-1]

    listed = [r for r in hs.indexes() if r["name"] == INDEX_NAME]
    if len(listed) != 1 or listed[0]["state"] != "ACTIVE":
        raise AssertionError(f"phase C: {INDEX_NAME} is not ACTIVE: {listed}")
    entry = session.index_collection_manager.get_index(INDEX_NAME)
    files_by_bucket: dict = {}
    total = 0
    for info in entry.content.file_infos():
        b = bucket_id_of_file(info.name)
        files_by_bucket.setdefault(b, []).append(info.name)
        keys = pq.read_table(info.name, columns=["l_orderkey"]).column(
            "l_orderkey").to_numpy()
        total += len(keys)
        hw, _ = int64_words(keys)
        if not np.all(bucket_ids_np([hw], NUM_BUCKETS) == b):
            raise AssertionError(f"phase C: rows of {info.name} outside bucket {b}")
        if np.any(np.diff(keys) < 0):
            raise AssertionError(f"phase C: {info.name} is not sorted by l_orderkey")
    if total != N_LINEITEM:
        raise AssertionError(f"phase C: bucket files hold {total} rows, "
                             f"expected {N_LINEITEM}")
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
            "files": sum(len(v) for v in files_by_bucket.values())}


def time_ms(fn, flush) -> float:
    """Median milliseconds of ``fn`` over TIMED_RUNS launches, each timed
    by CUDA events after an L2 flush, after three warm-up calls."""
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


def measure(dev, keys: np.ndarray, launches: dict) -> list:
    import torch

    from hyperspace_tpu_torch.ops import kernels

    flush = torch.empty(2 * L2_BYTES, dtype=torch.uint8, device=dev)
    hw, _ = int64_words(keys)
    cols = [torch.from_numpy(hw).to(dev)]
    n = len(keys)
    buckets = kernels.hash_buckets(cols, NUM_BUCKETS)
    hash_err = int((buckets.to(torch.int64)
                    - kernels.hash_buckets_plain(cols, NUM_BUCKETS)
                    .to(torch.int64)).abs().max())
    # Per row and key word: fmix32 (3 shifts, 3 xors, 2 multiplies), then
    # h * 31 ^ w and the outer fmix32; one modulo per row.
    hash_ops = n * (len(cols) * 2 * (8 + 2 + 8) + 1)
    hash_bytes = n * (8 * len(cols) + 4)
    hist_err = int((kernels.bucket_histogram(buckets, NUM_BUCKETS)
                    - kernels.bucket_histogram_plain(buckets, NUM_BUCKETS))
                   .abs().max())
    hist_ops = n * 3  # two range compares and one add per row
    hist_bytes = 4 * n + 4 * NUM_BUCKETS

    def bound(nbytes, ops):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / ALU_OPS_PER_S * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    rows = []
    hb, hby = bound(hash_bytes, hash_ops)
    rows.append({
        "name": "hash_buckets", "route": "cuda",
        "source": "hyperspace_tpu_torch/csrc/hash_buckets.cu",
        "replaces": "hyperspace_tpu/ops/pallas_kernels.py:94",
        "launches": launches["hash_buckets"], "max_abs_err": hash_err,
        "ms": time_ms(lambda: kernels.hash_buckets(cols, NUM_BUCKETS), flush),
        "plain_ms": time_ms(
            lambda: kernels.hash_buckets_plain(cols, NUM_BUCKETS), flush),
        "bound_ms": hb, "bound_by": hby, "library_ms": None,
        "shape": {"n": n, "k": len(cols), "num_buckets": NUM_BUCKETS},
    })
    bb, bby = bound(hist_bytes, hist_ops)
    rows.append({
        "name": "bucket_histogram", "route": "cuda",
        "source": "hyperspace_tpu_torch/csrc/bucket_histogram.cu",
        "replaces": "hyperspace_tpu/ops/pallas_kernels.py:145",
        "launches": launches["bucket_histogram"], "max_abs_err": hist_err,
        "ms": time_ms(lambda: kernels.bucket_histogram(buckets, NUM_BUCKETS),
                      flush),
        "plain_ms": time_ms(
            lambda: kernels.bucket_histogram_plain(buckets, NUM_BUCKETS), flush),
        "bound_ms": bb, "bound_by": bby,
        "library_ms": time_ms(
            lambda: torch.bincount(buckets, minlength=NUM_BUCKETS), flush),
        "shape": {"n": n, "num_buckets": NUM_BUCKETS},
    })
    return rows


def main() -> int:
    import torch

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

    t0 = time.perf_counter()
    kernels.build_kernels()
    print(f"build: {time.perf_counter() - t0:.3f} s", flush=True)

    t0 = time.perf_counter()
    phase_a(dev)
    print(f"phase A: kernels bit-equal to their plain versions "
          f"({time.perf_counter() - t0:.3f} s)", flush=True)

    t0 = time.perf_counter()
    li = gen_data()
    print(f"data: {N_LINEITEM} rows x {len(li)} columns generated "
          f"({time.perf_counter() - t0:.3f} s)", flush=True)

    t0 = time.perf_counter()
    phase_b(dev, li["l_orderkey"])
    print(f"phase B: bucket_sort_permutation and bucket_counts bit-equal to "
          f"the numpy mirror ({time.perf_counter() - t0:.3f} s)", flush=True)

    root = tempfile.mkdtemp(prefix="hs_chip_smoke_")
    try:
        c = phase_c(li, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"phase C: create_index {INDEX_NAME} ACTIVE, {c['files']} files, "
          f"wall {c['wall_s']:.3f} s, phases "
          + json.dumps({k: v for k, v in c["phases"].items() if k != "index"}),
          flush=True)
    missing = [k for k, v in c["launches"].items() if v <= 0]
    if missing:
        raise AssertionError(f"phase C: kernels not launched on the main "
                             f"path: {missing}")

    rows = measure(dev, li["l_orderkey"], c["launches"])
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
