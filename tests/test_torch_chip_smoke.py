"""chip_smoke.py's phase selector and its phases U and V, on the CPU.

The selector: ``--phases T,U`` runs the selected phases with phase A and
the kernel builds, plus what they read (phase C's ``li_idx`` build and
phase D's ``ord_idx`` build for T); an unknown letter is an error; and
without a card the script exits non-zero and prints no result, also
from a directory that holds it alone.  Phase U is rehearsed after phase
T, and phase V alone (it builds phase C's and D's indexes itself), at
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
], ids=["all", "T,U", "U", "M", "A", "B,F", "K,G", "V"])
def test_a_selection_runs_what_it_reads(argv, selected, read):
    assert chip_smoke.parse_args(argv) == (selected, read, 0)
    assert chip_smoke.parse_args(argv + ["--u-turns", "2"])[2] == 2


@pytest.mark.parametrize("argv", [["--phases", "T,Z"], ["--phases", "TU"],
                                  ["--phases", ""], ["--phases", "t"],
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
    proc = _run(["--phases", "T,W"], REPO)
    assert proc.returncode != 0
    assert "unknown phases" in proc.stderr
    assert '"ok"' not in proc.stdout


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
