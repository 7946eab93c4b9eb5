"""Explain, run reports and index statistics through hyperspace_tpu_torch
(on the CPU) against the JAX package.

The cases of tests/test_explain.py go through both packages on the same
data: the display modes and ``BufferStream`` give the same tags and
text, and explain gives the same string once each package's index root
is replaced by one name; in verbose mode each section is equal, apart
from the run report's duration.  A collect's run report holds the same
decisions in both packages (the indexes considered and used, each
rule's, each scan's IO), and containment's quarantine and re-plan.
``index_statistics_table``, ``Hyperspace.index(name)`` and
``Hyperspace.indexes()`` give the JAX package's tables apart from the
locations."""

from __future__ import annotations

import os
import re

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu
import hyperspace_tpu_torch
from hyperspace_tpu.config import HyperspaceConf as JaxConf
from hyperspace_tpu.plananalysis import display as jax_display
from hyperspace_tpu_torch.config import HyperspaceConf as TorchConf
from hyperspace_tpu_torch.plananalysis import display as torch_display

PKGS = (hyperspace_tpu, hyperspace_tpu_torch)
LOCATIONS = ("indexLocation", "indexContentPaths")


def _data(root: str) -> str:
    """tests/test_explain.py's table: id, name, other over 100 rows."""
    data = os.path.join(root, "data")
    os.makedirs(data)
    n = 100
    pq.write_table(pa.table({
        "id": np.arange(n, dtype=np.int64),
        "name": pa.array([f"n{i}" for i in range(n)]),
        "other": pa.array(np.arange(n) * 2, type=pa.int64()),
    }), os.path.join(data, "part-0.parquet"))
    return data


def _other(root: str) -> str:
    """The join's other side of test_explain_verbose_join_strategy."""
    d = os.path.join(root, "other")
    os.makedirs(d)
    pq.write_table(pa.table({
        "rid": np.arange(50, dtype=np.int64),
        "w": np.arange(50, dtype=np.int64) * 3,
    }), os.path.join(d, "p.parquet"))
    return d


class Side:
    """One package's session over the shared data, its index root, and
    the explain of a Dataset with that root replaced by ``<ix>``."""

    def __init__(self, pkg, root: str, data: str) -> None:
        self.pkg = pkg
        self.system_path = os.path.join(root, f"ix_{pkg.__name__}")
        kw = {"device": "cpu"} if pkg is hyperspace_tpu_torch else {}
        self.session = pkg.HyperspaceSession(system_path=self.system_path,
                                             **kw)
        self.session.conf.num_buckets = 4
        self.hs = pkg.Hyperspace(self.session)
        self.data = data

    def read(self, path=None):
        return self.session.read.parquet(path or self.data)

    def create(self, name, indexed, included, path=None):
        self.hs.create_index(self.read(path),
                             self.pkg.IndexConfig(name, indexed, included))

    def point_query(self):
        return self.read().filter(self.pkg.col("id") == 1).select("id", "name")

    def explain(self, ds, verbose=False) -> str:
        return self.hs.explain(ds, verbose=verbose).replace(
            self.system_path, "<ix>")


@pytest.fixture()
def sides(tmp_path):
    data = _data(str(tmp_path))
    return [Side(pkg, str(tmp_path), data) for pkg in PKGS]


def _sections(text: str) -> dict:
    """Explain's sections by title; the run report's duration blanked."""
    text = re.sub(r"duration=[0-9.]+ms", "duration=<ms>", text)
    bar = "=" * 64
    out = {}
    parts = text.split(bar + "\n")
    for i in range(1, len(parts) - 1, 2):
        out[parts[i].strip()] = parts[i + 1]
    return out


# ------------------------------------------------------------- display

@pytest.mark.parametrize("mode", ["PlainTextMode", "HTMLMode", "ConsoleMode"])
def test_display_mode_tags(mode):
    j = getattr(jax_display, mode)()
    t = getattr(torch_display, mode)()
    assert (t.highlight_tag.open, t.highlight_tag.close) == \
        (j.highlight_tag.open, j.highlight_tag.close)
    assert (t.begin_end_tag.open, t.begin_end_tag.close) == \
        (j.begin_end_tag.open, j.begin_end_tag.close)
    assert t.new_line == j.new_line


@pytest.mark.parametrize("name,tags", [
    ("html", ("**", "**")), ("console", ("[", "]")),
    ("plaintext", ("**", "")), ("PlainText", ("", ""))])
def test_conf_selects_mode_and_custom_tags(name, tags):
    modes = []
    for conf, mod in ((JaxConf(), jax_display), (TorchConf(), torch_display)):
        conf.display_mode = name
        conf.highlight_begin_tag, conf.highlight_end_tag = tags
        mode = mod.get_display_mode(conf)
        modes.append((type(mode).__name__, mode.highlight_tag.open,
                      mode.highlight_tag.close))
    assert modes[1] == modes[0]


def test_unknown_mode_raises_the_same_error():
    errors = []
    for conf, mod in ((JaxConf(), jax_display), (TorchConf(), torch_display)):
        conf.display_mode = "nope"
        with pytest.raises(ValueError, match="display mode") as info:
            mod.get_display_mode(conf)
        errors.append(str(info.value))
    assert errors[1] == errors[0]


@pytest.mark.parametrize("mode", ["PlainTextMode", "HTMLMode", "ConsoleMode"])
def test_buffer_stream(mode):
    outs = []
    for mod in (jax_display, torch_display):
        stream = mod.BufferStream(getattr(mod, mode)())
        stream.highlight("    Scan foo  ").write_line()
        stream.highlight("   ").write("x").write_line("y")
        outs.append((str(stream), stream.with_tag()))
    assert outs[1] == outs[0]
    if mode == "PlainTextMode":
        assert outs[1][0].startswith("    <----Scan foo---->  \n")


# ------------------------------------------------------------- explain

def test_explain_shape_and_highlight(sides):
    outs = []
    for side in sides:
        side.create("eidx", ["id"], ["name"])
        outs.append(side.explain(side.point_query()))
    assert outs[1] == outs[0]
    assert "<----Scan Hyperspace(Type: CI, Name: eidx)" in outs[1]
    assert "eidx:<ix>/eidx/v__=0" in outs[1]


def test_explain_no_indexes_used(sides):
    outs = [side.explain(side.read().filter(side.pkg.col("id") == 1))
            for side in sides]
    assert outs[1] == outs[0]
    assert "(none)" in outs[1]


def test_explain_verbose_sections(sides):
    outs = []
    for side in sides:
        side.create("eidx", ["id"], ["name"])
        outs.append(_sections(side.explain(side.point_query(), verbose=True)))
    assert list(outs[1]) == list(outs[0])
    for title in outs[0]:
        assert outs[1][title] == outs[0][title], title
    assert "IndexScanExec" in outs[1]["Physical operator stats:"]
    assert "Last run report:" not in outs[1]


def test_explain_verbose_join_strategy(sides, tmp_path):
    other = _other(str(tmp_path))
    outs = []
    for side in sides:
        side.create("eidx", ["id"], ["name"])
        col = side.pkg.col
        ds = (side.read().join(side.read(other), col("id") == col("rid"))
              .select("id", "name", "w"))
        first = _sections(side.explain(ds, verbose=True))
        side.create("ridx", ["rid"], ["w"], path=other)
        outs.append((first, _sections(side.explain(ds, verbose=True))))
    assert outs[1] == outs[0]
    assert "SortMergeJoinExec" in outs[1][0]["Physical operator stats:"]
    assert "PerBucketMergeJoinExec" in outs[1][1]["Physical operator stats:"]


def test_explain_html_and_console_modes(sides):
    for mode in ("html", "console"):
        outs = []
        for side in sides:
            if mode == "html":
                side.create("eidx", ["id"], ["name"])
            side.session.conf.display_mode = mode
            outs.append(side.explain(side.point_query()))
        assert outs[1] == outs[0], mode
    assert "\033[42mScan Hyperspace(Type: CI, Name: eidx)" in outs[1]


def test_explain_after_a_collect_shows_the_last_run_report(sides):
    outs = []
    for side in sides:
        side.create("eidx", ["id"], ["name"])
        side.session.enable_hyperspace()
        ds = side.point_query()
        ds.collect()
        text = side.explain(ds, verbose=True)
        assert text == side.session.read.parquet(side.data).filter(
            side.pkg.col("id") == 1).select("id", "name").explain(
                verbose=True).replace(side.system_path, "<ix>")
        outs.append(_sections(text))
    assert outs[1] == outs[0]
    assert "scan [index] eidx: 1/" in outs[1]["Last run report:"]


def test_explain_restores_the_enabled_state(sides):
    side = sides[1]
    side.create("eidx", ["id"], ["name"])
    ds = side.read().filter(side.pkg.col("id") == 1)
    side.session.enable_hyperspace()
    side.hs.explain(ds)
    assert side.session.is_hyperspace_enabled()
    side.session.disable_hyperspace()
    ds.explain(verbose=True)
    assert not side.session.is_hyperspace_enabled()


def test_dataset_explain_string_and_no_whatif(sides):
    outs = [side.point_query().explain_string() for side in sides]
    assert outs[1] == outs[0]
    # explain(whatif=[]) is the advisor's what-if with no candidate: the
    # JAX package's text (tests/test_torch_advisor.py covers candidates).
    whatifs = [side.point_query().explain(whatif=[]) for side in sides]
    assert whatifs[1] == whatifs[0]
    assert "Hypothetical indexes used: (none)" in whatifs[1]


# ---------------------------------------------------------- run reports

def _decisions(side, ds):
    ds.collect()
    report = ds.last_run_report()
    assert report is side.session.last_run_report_value
    return report


@pytest.mark.parametrize("query", ["filter", "join", "none", "skipping"])
def test_run_report_decisions(sides, tmp_path, query):
    other = _other(str(tmp_path))
    reports = []
    for side in sides:
        col = side.pkg.col
        if query != "none":
            side.create("eidx", ["id"], ["name"])
            side.create("ridx", ["rid"], ["w"], path=other)
        if query == "skipping":
            side.hs.create_index(side.read(), side.pkg.DataSkippingIndexConfig(
                "sk", ["other"]))
        side.session.enable_hyperspace()
        ds = {"filter": side.point_query(),
              "none": side.point_query(),
              "skipping": side.read().filter(col("other") == 4),
              "join": side.read().join(side.read(other),
                                       col("id") == col("rid"))
              .select("id", "name", "w")}[query]
        reports.append(_decisions(side, ds))
    jax, port = reports
    assert port.decisions == jax.decisions
    assert port.indexes_considered == jax.indexes_considered
    assert port.indexes_used == jax.indexes_used
    assert port.skipped_indexes() == jax.skipped_indexes()
    assert port.rules() == jax.rules()
    assert port.scans() == jax.scans()
    assert port.bytes_read() == jax.bytes_read()
    assert port.bytes_read(is_index=True) == jax.bytes_read(is_index=True)
    assert port.outcome == jax.outcome == "ok"
    def strip(report):
        return re.sub(r"duration=[0-9.]+ms", "", report.render())

    assert strip(port) == strip(jax)


def test_run_report_of_a_failed_collect(sides):
    side = sides[1]
    ds = side.read().filter(side.pkg.col("missing") == 1)
    with pytest.raises(Exception):
        ds.collect()
    assert ds.last_run_report().outcome == "error"


def test_run_report_records_containment(sides):
    """A damaged index file found at execution: the port's report holds
    the JAX package's quarantine and containment re-plan decisions (the
    JAX package's degraded-event decisions are not ported)."""
    reports = []
    for side in sides:
        side.create("eidx", ["id"], ["name"])
        entry = side.session.index_collection_manager.get_index("eidx")
        victim = sorted(f.name for f in entry.content.file_infos())[-1]
        with open(victim, "r+b") as fh:
            fh.truncate(os.path.getsize(victim) // 2)
        side.session.enable_hyperspace()
        # Every index file meets the range: the damaged one is read.
        ds = side.read().filter(side.pkg.col("id") >= 0).select("id", "name")
        assert ds.collect().num_rows == 100
        reports.append([{k: (len(v) if k == "files" else v)
                         for k, v in d.items()}
                        for d in ds.last_run_report().decisions
                        if d["kind"] in ("quarantine", "replan")])
    assert reports[1] == reports[0]
    assert [d["kind"] for d in reports[1]] == ["quarantine", "replan"]
    assert reports[1][1]["mode"] == "containment"


# ----------------------------------------------------------- statistics

def _without_locations(table) -> list:
    return [{k: v for k, v in r.items() if k not in LOCATIONS}
            for r in table.to_pylist()]


def test_index_statistics_and_listing(sides):
    for side in sides:
        side.session.conf.lineage_enabled = True
        side.create("eidx", ["id"], ["name"])
        side.session.conf.lineage_enabled = False
        side.hs.create_index(side.read(), side.pkg.DataSkippingIndexConfig(
            "sk", ["other"]))
    pq.write_table(pa.table({"id": [500], "name": ["x"], "other": [9]}),
                   os.path.join(sides[0].data, "part-1.parquet"))
    tables = []
    for side in sides:
        side.hs.refresh_index("eidx", "quick")
        tables.append((side.hs.index("eidx"), side.hs.index("sk"),
                       side.hs.index("nope"), side.hs.indexes()))
        entry = side.session.index_collection_manager.get_index("eidx")
        root = os.path.dirname(entry.content.file_infos()[0].name)
        assert tables[-1][0].column("indexLocation").to_pylist() == [root]
    jax, port = tables
    for got, want in zip(port, jax):
        assert isinstance(got, pa.Table)
        assert got.schema.equals(want.schema), (got.schema, want.schema)
        assert _without_locations(got) == _without_locations(want)
    assert port[0].column("numAppendedFiles").to_pylist() == [1]
    assert port[0].column("hasLineage").to_pylist() == [True]
    assert port[2].num_rows == 0
    assert port[3].column("name").to_pylist() == ["eidx", "sk"]


def test_index_statistics_table_falls_back_to_the_index_root(sides):
    """An entry that lists no content files reports its index root."""
    from hyperspace_tpu_torch.index.statistics import (
        EXTENDED_COLUMNS,
        INDEX_SUMMARY_COLUMNS,
        index_statistics_table,
    )

    side = sides[1]
    side.create("eidx", ["id"], ["name"])
    mgr = side.session.index_collection_manager
    entry = mgr.get_index("eidx")
    entry.content.root.files = []
    entry.content.root.subdirs = []
    table = index_statistics_table([entry], index_path=mgr.index_path)
    assert table.column_names == INDEX_SUMMARY_COLUMNS
    assert table.column("indexLocation").to_pylist() == \
        [os.path.join(side.system_path, "eidx")]
    assert table.column("numIndexFiles").to_pylist() == [0]
    assert index_statistics_table([], extended=True).column_names == \
        EXTENDED_COLUMNS
