"""chip_smoke.py's phase selector and its phases U, V, W, X, Y, Z, MH
and FL, on the CPU.

The selector: ``--phases T,U`` runs the selected phases with phase A and
the kernel builds, plus what they read (phase C's ``li_idx`` build and
phase D's ``ord_idx`` build for T); an unknown letter is an error; and
without a card the script exits non-zero and prints no result, also
from a directory that holds it alone.  Phase U is rehearsed after phase
T, phase V alone (it builds phase C's and D's indexes itself) and phases
W, X and Y after phase C, phases Z and MH after phases C and D, and
phase FL alone (it builds phase C's and D's indexes itself), at
80,000 lineitem rows on a ``cpu`` session, where the plain kernels count
no launch."""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

import pytest

import chip_smoke
from hyperspace_tpu_torch.lifecycle import daemon as lifecycle_daemon

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("argv, selected, read", [
    ([], set(chip_smoke.PHASES), set()),
    (["--phases", "T,U"], {"A", "T", "U"}, {"C", "D"}),
    (["--phases", "U"], {"A", "U"}, {"C", "D", "T"}),
    (["--phases", "M"], {"A", "M"}, {"L"}),
    (["--phases", "A"], {"A"}, set()),
    (["--phases", "B,F"], {"A", "B", "F"}, set()),
    (["--phases", "K,G"], {"A", "G", "K"}, {"C", "D"}),
    (["--phases", "V"], {"A", "V"}, {"C", "D"}),
    (["--phases", "W"], {"A", "W"}, {"C"}),
    (["--phases", "X"], {"A", "X"}, {"C"}),
    (["--phases", "Y"], {"A", "Y"}, {"C"}),
    (["--phases", "X,Y"], {"A", "X", "Y"}, {"C"}),
    (["--phases", "Z"], {"A", "Z"}, {"C", "D"}),
    (["--phases", "MH"], {"A", "MH"}, {"C", "D"}),
    (["--phases", "Z,MH"], {"A", "Z", "MH"}, {"C", "D"}),
    (["--phases", "FL"], {"A", "FL"}, {"C", "D"}),
    (["--phases", "MH,FL"], {"A", "MH", "FL"}, {"C", "D"}),
], ids=["all", "T,U", "U", "M", "A", "B,F", "K,G", "V", "W", "X", "Y",
        "X,Y", "Z", "MH", "Z,MH", "FL", "MH,FL"])
def test_a_selection_runs_what_it_reads(argv, selected, read):
    assert chip_smoke.parse_args(argv) == (selected, read, 0)
    assert chip_smoke.parse_args(argv + ["--u-turns", "2"])[2] == 2


@pytest.mark.parametrize("argv", [["--phases", "T,1"], ["--phases", "TU"],
                                  ["--phases", ""], ["--phases", "t"],
                                  ["--phases", "mh"], ["--phases", "M,H,X1"],
                                  ["--u-turns", "-1"], ["--bogus"]])
def test_an_unknown_phase_is_an_error(argv):
    with pytest.raises(SystemExit) as ei:
        chip_smoke.parse_args(argv)
    assert ei.value.code != 0


def _run(args, cwd):
    env = dict(os.environ, PYTHONPATH="")
    return subprocess.run([sys.executable, "chip_smoke.py", *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=120)


@pytest.mark.parametrize("args", [[], ["--phases", "T,U"]])
def test_without_a_card_it_exits_non_zero(args, tmp_path):
    """In the checkout, and in a directory that holds chip_smoke.py and
    nothing else of the repository: no result, a non-zero exit."""
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), alone)
    for cwd in (REPO, str(alone)):
        proc = _run(args, cwd)
        assert proc.returncode != 0, proc.stdout
        assert '"ok"' not in proc.stdout


def test_an_unknown_phase_exits_non_zero_from_the_command_line():
    proc = _run(["--phases", "T,1"], REPO)
    assert proc.returncode != 0
    assert "unknown phases" in proc.stderr
    assert '"ok"' not in proc.stdout


def _answer(n=5_000, seed=3):
    """A keyed answer with repeated keys and rows, a signed zero, a bool,
    a date, a string column and a row number."""
    import numpy as np

    rng = np.random.default_rng(seed)
    want = {"k": rng.integers(0, 50, n), "x": rng.integers(0, 4, n) / 2.0,
            "b": rng.integers(0, 2, n).astype(bool),
            "d": rng.integers(0, 9, n).astype("datetime64[D]"),
            "s": np.array([f"s{v}" for v in rng.integers(0, 5, n)],
                          dtype=object),
            "i": np.arange(n)}
    want["x"][::11] = -0.0
    return want


def _changed(want: dict, change: str) -> dict:
    import numpy as np

    got = {c: v[np.random.default_rng(4).permutation(len(v))]
           for c, v in want.items()}
    if change == "signed zero":
        got["x"] = np.abs(got["x"])
    elif change == "one value":
        got["x"] = got["x"].copy()
        got["x"][7] += 0.5
    elif change == "two cells swapped":
        i = int(np.flatnonzero(got["k"] != got["k"][0])[0])
        got["k"] = got["k"].copy()
        got["k"][[0, i]] = got["k"][[i, 0]]
    elif change == "a row twice":
        got = {c: np.concatenate([v[:-1], v[:1]]) for c, v in got.items()}
    elif change == "a row missing":
        got = {c: v[:-1] for c, v in got.items()}
    elif change == "another dtype":
        got["k"] = got["k"].astype(np.int32)
    elif change == "a string changed":
        got["s"] = got["s"].copy()
        got["s"][3] = "t"
    return got


@pytest.mark.parametrize("columns, keys", [
    (("k", "x", "b", "d"), ["k", "x"]),
    (("k", "x", "b", "d", "s", "i"), ["k", "i"])],
    ids=["numeric", "with strings"])
@pytest.mark.parametrize("change, holds", [
    ("permuted", True), ("signed zero", True), ("one value", False),
    ("two cells swapped", False), ("a row twice", False),
    ("a row missing", False), ("another dtype", False),
    ("a string changed", False)])
def test_require_rows_holds_the_multiset_of_rows(columns, keys, change,
                                                holds):
    """A keyed check passes exactly when the answer holds the expected
    rows in any order, whether it takes the hash path (numeric columns,
    repeated rows) or the key sort (a string column, keys that name each
    row); a mismatch names its column."""
    import pyarrow as pa

    want = {c: v for c, v in _answer().items() if c in columns}
    got = {c: v for c, v in _changed(_answer(), change).items()
           if c in columns}
    if change == "a string changed" and "s" not in columns:
        holds = True
    table = pa.Table.from_pydict(got)
    if holds:
        chip_smoke.require_rows(change, table, want, keys)
        assert chip_smoke.hash_aligned_equal(got, want) == ("s" not in columns)
        return
    with pytest.raises(AssertionError, match=f"{change}: (column|columns)"):
        chip_smoke.require_rows(change, table, want, keys)
    assert not chip_smoke.hash_aligned_equal(got, want)


@pytest.mark.parametrize("keys", [["k"], ["x", "k"], ["b", "d", "k"],
                                  ["s", "k"]])
def test_sorted_rows_is_numpys_lexsort(keys):
    """``sorted_rows`` on torch's stable sorts gives ``np.lexsort``'s
    order, column for column and dtype for dtype."""
    import numpy as np

    cols = _answer()
    order = np.lexsort([cols[k] for k in reversed(keys)])
    got = chip_smoke.sorted_rows(cols, keys)
    for c, v in cols.items():
        assert got[c].dtype == v.dtype
        assert np.array_equal(got[c], v[order]), c


def test_the_sampler_writes_where_the_time_went(tmp_path, monkeypatch):
    """``HS_SMOKE_SAMPLE``'s sampler: seconds per phase function and per
    line of chip_smoke.py, as JSON."""
    import json
    import time

    monkeypatch.setattr(chip_smoke, "SAMPLE_INTERVAL_S", 0.01)
    path = tmp_path / "out" / "sample.json"
    with chip_smoke.sampled(str(path)):
        chip_smoke.wall_ms(lambda: time.sleep(0.3))
    got = json.loads(path.read_text())
    assert got["interval_s"] == 0.01
    assert [p for p, _ in got["phase"]] == ["main"]
    assert any(line.startswith("wall_ms:") for _, line, _ in got["line"])


def test_phase_u_on_the_cpu(monkeypatch, tmp_path):
    """Phase T, then phase U with its answers, at 80,000 lineitem rows:
    the async server's seven answers equal to T's threaded ones, its
    concurrent clients all right, one tenant shed and the verb's rows,
    and each wire fault's outcome."""
    import torch

    for name, value in (("N_LINEITEM", 80_000), ("N_ORDERS", 20_000),
                        ("N_FILES", 8), ("ROWS_PER_FILE", 10_000),
                        ("POINT_KEY", 1234), ("RANGE", (2000, 6000)),
                        ("Q10_WINDOW", (10_000, 40_000)),
                        ("AGG_ORDERKEY_BELOW", 10_000),
                        ("PRICE_BELOW", 20_000.0), ("T_TIMED_RUNS", 1),
                        ("T_CLIENTS", 4), ("T_ROUNDS", 1),
                        ("T_CACHE_PAIRS", 1), ("T_APPENDED_ROWS", 1000),
                        ("U_DETOUR_RUNS", 1)):
        monkeypatch.setattr(chip_smoke, name, value)
    orders, li = chip_smoke.gen_data()
    root = str(tmp_path / "smoke")
    chip_smoke.write_files(li, os.path.join(root, "lineitem"))
    chip_smoke.write_files(orders, os.path.join(root, "orders"))
    dev = torch.device("cpu")
    t = chip_smoke.phase_t(orders, li, root, dev)
    u = chip_smoke.phase_u(orders, li, root, dev, t, turns=1)
    chip_smoke.print_server_u(u)
    assert u["async"]["requests"] == 4 * 7
    assert set(u["async"]["threaded"]) >= {"qps", "p50_ms", "p99_ms"}
    assert u["tenants"]["counters"] == {"serve.shed.tenant": 1.0,
                                        "serve.tenant.hot.shed": 1.0}
    assert "quota" in u["tenants"]["shed_message"]
    hot = [r for r in u["tenants"]["verb"] if r["tenant"] == "hot"]
    assert hot and hot[0]["queued"] >= 1 and hot[0]["shed"] == 1
    wire = u["wire"]
    assert wire["torn_frame"].startswith("ConnectionError")
    assert wire["black_hole_s"] >= chip_smoke.U_BLACK_HOLE_S
    assert wire["slow_recv_ms"]["slow"] >= chip_smoke.U_SLOW_RECV_MS
    assert len(wire["join_ms"]["buffered"]) == 1
    assert not any(u["launches"].values())  # plain kernels count none
    assert [r["mode"] for r in u["turns"]] == \
        ["threaded", "async", "async", "threaded"]
    assert all(r["requests"] == 4 * 7 for r in u["turns"])
    assert set(u["steps_s"]) == {"1_async_seven", "1_async_concurrent",
                                 "1_turns", "2_tenants", "3_wire_faults"}
    assert not lifecycle_daemon.draining()


def _small(monkeypatch) -> None:
    """chip_smoke's data and queries at 80,000 lineitem rows."""
    for name, value in (("N_LINEITEM", 80_000), ("N_ORDERS", 20_000),
                        ("N_FILES", 8), ("ROWS_PER_FILE", 10_000),
                        ("POINT_KEY", 1234), ("RANGE", (2000, 6000)),
                        ("Q10_WINDOW", (10_000, 40_000)),
                        ("AGG_ORDERKEY_BELOW", 10_000),
                        ("PRICE_BELOW", 20_000.0)):
        monkeypatch.setattr(chip_smoke, name, value)


def test_phase_v_on_the_cpu(monkeypatch, tmp_path):
    """Phase V at 80,000 lineitem rows: the seven right through the
    fleet client and the proxy, each fault answered after a retry, the
    breaker open then closed, three hedges sent, the proxied BUSY's hint
    and the scrape's client series."""
    import torch

    _small(monkeypatch)
    monkeypatch.setattr(chip_smoke, "V_JOIN_RUNS", 1)
    orders, li = chip_smoke.gen_data()
    root = str(tmp_path / "smoke")
    chip_smoke.write_files(li, os.path.join(root, "lineitem"))
    chip_smoke.write_files(orders, os.path.join(root, "orders"))
    v = chip_smoke.phase_v(orders, li, root, torch.device("cpu"))
    chip_smoke.print_fleet(v)
    assert v["rebuilt"] == ["li_idx", "ord_idx"]
    assert set(v["fleet"]["ms"]) == set(chip_smoke.t_specs(root))
    assert sum(v["fleet"]["picks"].values()) == 7
    assert min(v["fleet"]["picks"].values()) >= 1
    for f in v["failover"].values():
        assert f["counters"]["client.retry"] >= 1
    assert v["failover"]["busy_parked"]["hits"] == 1
    assert v["breaker"]["doctor_open"][0] == "warn"
    assert v["breaker"]["transitions"] == {"client.breaker.open": 1.0,
                                           "client.breaker.half_open": 1.0,
                                           "client.breaker.close": 1.0}
    assert v["hedge"]["sent"] == chip_smoke.V_HEDGES
    assert v["proxy"]["busy"]["retry_after_ms"] == chip_smoke.V_PROXY_HINT_MS
    assert len(v["proxy"]["join_ms"]["proxy"]) == 1
    assert v["scrape"]["client_series"] >= len(
        [s for s in chip_smoke.V_SCRAPED if "client" in s])
    assert not any(v["launches"].values())  # plain kernels count none
    assert set(v["steps_s"]) == {"1_fleet_seven", "2_failover",
                                 "3_breaker", "4_hedge", "5_proxy",
                                 "6_scrape"}


def test_phase_w_on_the_cpu(monkeypatch, tmp_path):
    """Phase W after phase C at 80,000 lineitem rows: the CSV spill build
    and the ORC build equal to li_idx bucket by bucket, the hive index's
    partition column equal to numpy, the six queries, the glob read, the
    pattern's index refreshed with the new partition's rows only, and 2
    of 8 files kept by the data-skipping index."""
    import torch

    _small(monkeypatch)
    for name, value in (("DEFAULT_BATCH_ROWS", 16_384),
                        ("W_AVRO_ROWS", 2_000), ("W_KEY_ROW", 1_234)):
        monkeypatch.setattr(chip_smoke, name, value)
    orders, li = chip_smoke.gen_data()
    root = str(tmp_path / "smoke")
    os.makedirs(root)
    dev = torch.device("cpu")
    c = chip_smoke.phase_c(li, root, dev)
    w = chip_smoke.phase_w(orders, li, root, dev, c["phases"].get("read_s"))
    chip_smoke.print_formats(w)
    assert set(w["sources"]) == set(chip_smoke.W_SOURCES)
    assert w["builds"]["w_csv"]["spilled"]
    assert w["builds"]["w_csv"]["chunks"] == 5
    assert not w["builds"]["w_orc"]["spilled"]
    for name in ("w_csv", "w_orc", "w_hive"):
        assert w["builds"][name]["rows_checked"] == 80_000
    assert w["type_changes"] == {"l_quantity": "float64->int64"}
    assert set(w["queries"]) == {"csv_point", "csv_range", "hive_status",
                                 "csv_json_join", "avro_point",
                                 "text_point"}
    assert w["queries"]["hive_status"]["files_kept"] == (2, 8)
    assert w["queries"]["avro_point"]["rows"] == 1
    assert w["glob"]["rows_read"] == 80_000
    assert w["glob"]["refresh_rows"] == 10_000
    assert not any(w["launches"].values())  # plain kernels count none
    assert set(w["steps_s"]) == {"1_write", "2_csv_orc", "3_hive",
                                 "4_json_avro_text", "5_queries", "6_glob"}
    assert not [n for n in os.listdir(root) if n.startswith("w_")]


def test_phase_x_on_the_cpu(monkeypatch, tmp_path):
    """Phase X after phase C at 80,000 lineitem rows: the Delta index
    equal to li_idx per key, the queries at v9, the checkpoint at v10,
    the hybrid range and the refresh of the appended rows alone, time
    travel served by the v9 entry, the CDC quick refresh and the
    overwrite."""
    import torch

    _small(monkeypatch)
    # An append of 2,000 rows: its share of the merge debt stays under
    # the CDC rung's 0.2, as 93,750 of 6,000,000 rows do on the card.
    for name, value in (("DEFAULT_BATCH_ROWS", 16_384),
                        ("X_RANGE", (5_000, 6_000)), ("X_OW_ROWS", 10_000),
                        ("ROWS_PER_FILE", 2_000)):
        monkeypatch.setattr(chip_smoke, name, value)
    orders, li = chip_smoke.gen_data()
    root = str(tmp_path / "smoke")
    os.makedirs(root)
    dev = torch.device("cpu")
    c = chip_smoke.phase_c(li, root, dev)
    x = chip_smoke.phase_x(li, root, dev, c["phases"].get("read_s"))
    chip_smoke.print_delta(x)
    assert x["write"]["commits"] == 10
    assert x["build"]["chunks"] == 5
    assert x["build"]["rows_checked"] == 80_000
    assert x["build"]["delta_versions"].endswith(":9")
    assert x["queries"]["point"]["rows"] == int(
        (li["l_orderkey"] == chip_smoke.POINT_KEY).sum())
    assert set(x["queries"]) == {"point", "range", "hybrid_range"}
    assert x["queries"]["hybrid_range"]["rows"] \
        > x["queries"]["range"]["rows"]
    assert x["refresh"]["rows"] == 2_000
    assert x["refresh"]["delta_versions"].count(",") == 1
    assert set(x["travel"]) == {"version_9", "timestamp_9", "version_5"}
    assert x["travel"]["version_9"]["rows"] == x["queries"]["range"]["rows"]
    assert x["travel"]["version_5"]["rows"] \
        < x["travel"]["version_9"]["rows"]
    assert x["cdc"]["rows"] == 2
    assert "CDC merge-on-read" in x["cdc"]["reason"]
    assert x["overwrite"]["rows"] == 10_000
    assert x["overwrite"]["files_on_disk"] == 3
    assert not any(x["launches"].values())  # plain kernels count none
    assert set(x["steps_s"]) == {"1_write", "2_build", "3_queries",
                                 "4_append_refresh", "5_time_travel",
                                 "6_cdc", "7_overwrite"}
    assert not [n for n in os.listdir(root) if n.startswith("x_")]


def test_phase_y_on_the_cpu(monkeypatch, tmp_path):
    """Phase Y after phase C at 80,000 lineitem rows: the Iceberg index
    equal to li_idx per key, the queries at the 10th snapshot, the files
    planned at the 10th and 11th, the hybrid range, the refresh of the
    appended rows alone and the range after it, time travel served by
    the build's entry and by the source, the CDC quick refresh, the
    overwrite's field ids and the torn metadata."""
    import torch

    _small(monkeypatch)
    # An append of 2,000 rows: its share of the merge debt stays under
    # the CDC rung's 0.2, as 93,750 of 6,000,000 rows do on the card.
    for name, value in (("DEFAULT_BATCH_ROWS", 16_384),
                        ("Y_RANGE", (5_000, 6_000)), ("Y_OW_ROWS", 10_000),
                        ("ROWS_PER_FILE", 2_000)):
        monkeypatch.setattr(chip_smoke, name, value)
    orders, li = chip_smoke.gen_data()
    root = str(tmp_path / "smoke")
    os.makedirs(root)
    dev = torch.device("cpu")
    c = chip_smoke.phase_c(li, root, dev)
    y = chip_smoke.phase_y(li, root, dev, c["phases"].get("read_s"))
    chip_smoke.print_iceberg(y)
    assert y["write"]["snapshots"] == 10
    assert y["build"]["chunks"] == 5
    assert y["build"]["rows_checked"] == 80_000
    assert y["build"]["iceberg_snapshots"].startswith("2:")
    assert y["queries"]["point"]["rows"] == int(
        (li["l_orderkey"] == chip_smoke.POINT_KEY).sum())
    assert set(y["queries"]) == {"point", "range", "hybrid_range",
                                 "refreshed_range"}
    assert y["queries"]["hybrid_range"]["rows"] \
        == y["queries"]["refreshed_range"]["rows"] \
        > y["queries"]["range"]["rows"]
    assert set(y["plan_files"]) == {"snapshot_10_ms", "snapshot_11_ms"}
    assert y["refresh"]["rows"] == 2_000
    assert y["refresh"]["iceberg_snapshots"].count(",") == 1
    assert set(y["travel"]) == {"snapshot_10", "timestamp_10", "snapshot_6"}
    for name in ("snapshot_10", "timestamp_10"):
        assert y["travel"][name]["rows"] == y["queries"]["range"]["rows"]
    assert y["travel"]["snapshot_6"]["indexes"] == []
    assert y["travel"]["snapshot_6"]["rows"] \
        < y["travel"]["snapshot_10"]["rows"]
    assert y["cdc"]["rows"] == 2
    assert "CDC merge-on-read" in y["cdc"]["reason"]
    assert y["overwrite"]["rows"] == 10_000
    assert y["overwrite"]["files_on_disk"] == 3
    assert y["overwrite"]["field_ids"] == {
        "l_orderkey": 1, "l_discount": 4, "l_extendedprice": 3}
    assert "Truncated or corrupt Iceberg metadata" in y["torn"]
    assert not any(y["launches"].values())  # plain kernels count none
    assert set(y["steps_s"]) == {"1_write", "2_build", "3_queries",
                                 "4_append_refresh", "5_time_travel",
                                 "6_cdc", "7_overwrite", "8_torn"}
    assert not [n for n in os.listdir(root) if n.startswith("y_")]


def test_phase_z_on_the_cpu(monkeypatch, tmp_path):
    """Phase Z after phases C and D at 80,000 lineitem rows, on 8 logical
    shards of the CPU: the sharded spill build equal to li_idx, the
    distributed orders build to ord_idx, each query's mesh and single
    device routes equal to numpy, and the chunk route's two timings."""
    import torch

    from hyperspace_tpu_torch.parallel import mesh as parallel_mesh

    _small(monkeypatch)
    for name, value in (("DEFAULT_BATCH_ROWS", 16_384), ("Z_ROUTE_RUNS", 1)):
        monkeypatch.setattr(chip_smoke, name, value)
    orders, li = chip_smoke.gen_data()
    root = str(tmp_path / "smoke")
    os.makedirs(root)
    dev = torch.device("cpu")
    chip_smoke.phase_c(li, root, dev)
    chip_smoke.d_build(orders, root, dev)
    local_devices = parallel_mesh.local_devices
    z = chip_smoke.phase_z(orders, li, root, dev)
    chip_smoke.print_mesh(z)
    assert parallel_mesh.local_devices is local_devices  # the seam undone
    assert set(z["builds"]) == {"sharded spill", "single-device spill",
                                "distributed"}
    assert set(z["builds"]["sharded spill"]["device_kernel_ms"]) \
        == {str(d) for d in range(8)}
    assert "spill_route_s" in z["builds"]["sharded spill"]["phases"]
    assert "spill_route_s" not in z["builds"]["distributed"]["phases"]
    assert set(z["queries"]) == set(chip_smoke.Z_QUERIES)
    assert z["queries"]["point"]["rows"] == int(
        (li["l_orderkey"] == chip_smoke.POINT_KEY).sum())
    assert z["route"]["rows"] == 16_384 and z["route"]["shards"] == 8
    assert len(z["route"]["mesh_runs_ms"]) == 1
    assert not any(z["launches"].values())  # plain kernels count none
    assert set(z["steps_s"]) == {"1_spill_builds", "2_distributed_build",
                                 "3_queries", "4_route_timing"}
    assert not os.path.exists(os.path.join(root, chip_smoke.Z_INDEXES))


def test_the_phases_are_the_letters_then_mh():
    """The letters, then MH, then FL (the fleet plane), each of the two
    reading phases C and D."""
    assert chip_smoke.PHASES[:26] == tuple("ABCDEFGHIJKLMNOPQRSTUVWXYZ")
    assert chip_smoke.PHASES[26:] == ("MH", "FL")
    assert chip_smoke.PHASE_READS["MH"] == "CD"
    assert chip_smoke.PHASE_READS["FL"] == "CD"


def test_phase_mh_on_the_cpu(monkeypatch, tmp_path):
    """Phase MH after phases C and D at 80,000 lineitem rows on the CPU:
    both 2-host builds (the second with a host SIGKILLed while it holds a
    claim) equal to li_idx with one commit, and the two-stage shuffle of
    the orders equal to the flat one, also across two Gloo processes."""
    import torch

    from hyperspace_tpu_torch.parallel import mesh as parallel_mesh

    _small(monkeypatch)
    monkeypatch.setattr(chip_smoke, "DEFAULT_BATCH_ROWS", 16_384)
    orders, li = chip_smoke.gen_data()
    root = str(tmp_path / "smoke")
    os.makedirs(root)
    dev = torch.device("cpu")
    chip_smoke.phase_c(li, root, dev)
    local_devices = parallel_mesh.local_devices
    mh = chip_smoke.phase_mh(orders, li, root, dev)
    chip_smoke.print_multihost(mh)
    assert parallel_mesh.local_devices is local_devices  # the seam undone
    clean, kill = mh["builds"]["clean"], mh["builds"]["sigkill"]
    assert clean["chunks"] == kill["chunks"] == 5
    assert clean["groups"] == 8
    assert clean["killed_after"] is None and not clean["reclaimed"]
    assert kill["killed_after"].startswith("chunk-")
    assert set(kill["killed_holding"]) <= set(kill["reclaimed"])
    assert clean["route_wall_s"] > 0 and clean["finalize_wall_s"] > 0
    assert not any(clean["launches"].values())  # plain kernels count none
    assert mh["shuffle"]["rows"] == chip_smoke.N_ORDERS
    assert len(mh["shuffle"]["hierarchical_runs_ms"]) == 2
    assert mh["processes"]["rows"] == chip_smoke.N_ORDERS
    assert [w["rank"] for w in mh["processes"]["workers"]] == [0, 1]
    assert set(mh["steps_s"]) == {"1_build", "2_sigkill_build", "3_shuffle",
                                  "4_processes"}
    assert not os.path.exists(os.path.join(root, chip_smoke.MH_INDEXES))


def test_phase_fl_on_the_cpu(monkeypatch, tmp_path):
    """Phase FL at 80,000 lineitem rows on the CPU: two port server
    children behind the fleet client, every answer equal to numpy, the
    merged requests equal to the children's, a failed query's trace
    resolved from the parent, the parent's SLO alert firing on a wire
    fault (its bundle, its state across a restart, the doctor CLI's exit
    2, child 1 reading it over the wire) and resolving, the drained
    child skipped then gone, the killed one crit, and the timings
    taken."""
    import torch

    _small(monkeypatch)
    orders, li = chip_smoke.gen_data()
    root = str(tmp_path / "smoke")
    chip_smoke.write_files(li, os.path.join(root, "lineitem"))
    chip_smoke.write_files(orders, os.path.join(root, "orders"))
    fl = chip_smoke.phase_fl(orders, li, root, torch.device("cpu"))
    chip_smoke.print_fleet_plane(fl)
    assert fl["rebuilt"] == ["li_idx", "ord_idx"]
    assert len(fl["children"]) == chip_smoke.FL_CHILDREN
    assert len({c["process"] for c in fl["children"]}) == 2
    assert sum(fl["routing"]["picks"].values()) == \
        chip_smoke.FL_POINTS + chip_smoke.FL_JOINS
    f = fl["federation"]
    assert f["merged_requests"] == sum(f["children_requests"]) > 0
    assert all(f["device_kernel_ms"])
    assert f["ms"]["prometheus_bytes"] > 0
    assert fl["trace"]["outcome"] == "FAILED"
    gone = fl["children"][0]["address"]
    assert fl["drain"]["sent"][gone] == 0
    assert sum(fl["drain"]["sent"].values()) == \
        chip_smoke.FL_DRAINING_QUERIES
    assert fl["kill"]["kill_to_crit_s"] <= \
        2 * chip_smoke.FL_INTERVAL_S + 2.0
    assert set(fl["timings"]["publish_once_ms"]) == {
        "PosixLogStore", "EmulatedObjectStore", "bytes"}
    assert set(fl["timings"]["served_point_ms"]) == {"off", "on", "engine"}
    assert not any(fl["launches"].values())  # plain kernels count none
    a = fl["alerts"]
    assert a["cli_exit"] == 2
    assert a["arm_to_firing_ticks"] >= 1 and a["to_resolved_ticks"] >= 1
    assert a["bundle_bytes"] > 0 and a["child_sees_s"] > 0
    assert [h for h in a["history"] if h[0] == "availability"] == [
        ("availability", "firing"), ("availability", "resolved")]
    assert not any(a["launches"].values())
    assert set(fl["steps_s"]) == {"1_children", "2_routing",
                                  "3_federation", "4_trace", "5_alerts",
                                  "6_drain", "7_kill", "8_timings"}
    left = os.listdir(os.path.join(root, "indexes", "_hyperspace_fleet"))
    assert not [f for f in left if f.startswith("hb-")]  # no heartbeat
    left = os.listdir(os.path.join(root, "indexes", "_hyperspace_alerts"))
    assert not [f for f in left if f.startswith("a-")]  # no alert record
    assert not os.path.exists(os.path.join(root, chip_smoke.FL_GATE))
