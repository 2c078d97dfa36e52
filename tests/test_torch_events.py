"""Event-time ingestion in the port (``aggregators/``,
``readers/aggregates.py``, ``readers/events.py``, TM060) against the JAX
package's, on the CPU, on seeded event logs.

Tolerances, and why:
 * aggregated datasets: every column equal, value for value (integral,
   binary and text exactly; ``sumNumeric`` floats bit-equal: the same
   Python sum over the same events in the same order); the key order
   (``repr``-sorted keys) equal;
 * streamed chunks at any ``chunk_rows`` equal the in-core dataset row
   for row, JSON-lines and CSV sources alike (a CSV chunk's cells typed
   as pandas types them);
 * joins: the in-core joins row for row (pandas' merge order); the
   streamed join's content equal (its order is key-sorted, as in the JAX
   package), under a spill too; the secondary aggregation row for row;
 * quarantine: sidecar entries equal to the JAX package's; a retried
   ``event.window`` fault gives the clean rows;
 * TM060: rule ids, severities, features and messages equal;
 * the 300-user demo (LR grid) trained in both packages at chunk_rows
   None, 32 and 64: the same winner, holdout probabilities within 1e-6
   (the port's float64 LR solve against the JAX package's).
"""
import csv
import itertools
import json
import os
import sys

import numpy as np
import pytest
import torch

import transmogrifai_tpu_torch as tt
from transmogrifai_tpu import aggregators as jagg
from transmogrifai_tpu import readers as jr
from transmogrifai_tpu.analysis.linter import lint_dag as jlint
from transmogrifai_tpu.features.builder import FeatureBuilder as JFB
from transmogrifai_tpu.models import OpLogisticRegression as JLR
from transmogrifai_tpu.ops.transmogrify import transmogrify as jtransmogrify
from transmogrifai_tpu.preparators.sanity_checker import \
    SanityChecker as JChecker
from transmogrifai_tpu.readers import resilience as jres
from transmogrifai_tpu.selector import BinaryClassificationModelSelector \
    as JSelector
from transmogrifai_tpu.selector import grid as jgrid
from transmogrifai_tpu.types import feature_types as jft
from transmogrifai_tpu.utils import faults as jfaults
from transmogrifai_tpu.utils import uid as juid
from transmogrifai_tpu.workflow.dag import StagesDAG as JDAG
from transmogrifai_tpu.workflow.workflow import OpWorkflow as JWorkflow
from transmogrifai_tpu_torch import aggregators as pagg
from transmogrifai_tpu_torch import readers as pr
from transmogrifai_tpu_torch.analysis import PipelineLintError
from transmogrifai_tpu_torch.analysis.linter import lint_dag as plint
from transmogrifai_tpu_torch.features.builder import FeatureBuilder as PFB
from transmogrifai_tpu_torch.models import OpLogisticRegression as PLR
from transmogrifai_tpu_torch.ops.transmogrify import transmogrify as ptransmogrify
from transmogrifai_tpu_torch.preparators.sanity_checker import \
    SanityChecker as PChecker
from transmogrifai_tpu_torch.readers import resilience as pres
from transmogrifai_tpu_torch.readers.events import _SpillSorter
from transmogrifai_tpu_torch.selector import BinaryClassificationModelSelector \
    as PSelector
from transmogrifai_tpu_torch.selector import grid as pgrid
from transmogrifai_tpu_torch.types import feature_types as pft
from transmogrifai_tpu_torch.utils import faults as pfaults
from transmogrifai_tpu_torch.utils import uid as puid
from transmogrifai_tpu_torch.workflow.dag import StagesDAG as PDAG
from transmogrifai_tpu_torch.workflow.workflow import OpWorkflow as PWorkflow

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

JAX = dict(fb=JFB, r=jr, agg=jagg, ft=jft, res=jres, faults=jfaults,
           lint=jlint, dag=JDAG, uid=juid, transmogrify=jtransmogrify,
           checker=JChecker, selector=JSelector, lr=JLR, grid=jgrid,
           workflow=JWorkflow)
PORT = dict(fb=PFB, r=pr, agg=pagg, ft=pft, res=pres, faults=pfaults,
            lint=plint, dag=PDAG, uid=puid, transmogrify=ptransmogrify,
            checker=PChecker, selector=PSelector, lr=PLR, grid=pgrid,
            workflow=PWorkflow)
PKGS = (JAX, PORT)


@pytest.fixture(autouse=True)
def _cpu():
    tt.set_device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def make_events(n_keys=37, n_events=400, seed=3):
    """An interleaved multi-key log: a key's events span many chunks."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_events):
        out.append({"id": f"k{int(rng.integers(0, n_keys))}",
                    "t": int(rng.integers(0, 1000)),
                    "amount": float(np.round(rng.gamma(2.0, 10.0), 6)),
                    "label": float(rng.random() < 0.4),
                    "page": ("home", "cart", "pay")[int(rng.integers(0, 3))]})
    return out


def features(pkg, window=None):
    """Every aggregation family: sumNumeric floats and counts, a windowed
    count, maxBoolean, concatText, unionSet, concatList, the response."""
    fb = pkg["fb"]
    return [
        fb.Real("amount").as_predictor(),
        fb.Integral("n").extract(lambda r: 1).aggregate("sumNumeric")
        .as_predictor(),
        fb.Integral("n_recent").extract(lambda r: 1).window(window or 200)
        .as_predictor(),
        fb.Binary("paid").extract(lambda r: r["page"] == "pay",
                                  event_field="page").as_predictor(),
        fb.Text("pages").extract(lambda r: r["page"],
                                 event_field="page").as_predictor(),
        fb.MultiPickList("page_set").extract(lambda r: {r["page"]},
                                             event_field="page")
        .as_predictor(),
        fb.TextList("page_list").extract(lambda r: [r["page"]],
                                         event_field="page").as_predictor(),
        fb.RealNN("label").as_response()]


NAMES = ["key", "amount", "n", "n_recent", "paid", "pages", "page_set",
         "page_list", "label"]


def rows(ds, names=NAMES):
    return list(zip(*[ds[n].to_list() for n in names]))


def agg_reader(pkg, source, **kw):
    kw.setdefault("cutoff", pkg["agg"].CutOffTime.unix(500))
    return pkg["r"].AggregateDataReader(source, key_fn=lambda r: r["id"],
                                        time_fn=lambda r: r["t"], **kw)


def cond_reader(pkg, source, streaming=False, **kw):
    cls = (pkg["r"].StreamingConditionalReader if streaming
           else pkg["r"].ConditionalDataReader)
    return cls(source, key_fn=lambda r: r["id"], time_fn=lambda r: r["t"],
               target_condition=lambda r: r["label"] > 0, **kw)


# ---------------------------------------------------------------------------
# aggregators
# ---------------------------------------------------------------------------

DEFAULTS = ["Real", "Integral", "Binary", "DateTime", "Date", "Text",
            "PickList", "TextList", "MultiPickList", "RealMap", "TextMap",
            "Currency", "Percent"]


@pytest.mark.parametrize("type_name", DEFAULTS)
def test_default_aggregator_per_type(type_name):
    got = pagg.default_aggregator(getattr(pft, type_name)).name
    assert got == jagg.default_aggregator(getattr(jft, type_name)).name


REDUCE_CASES = [
    ("sumNumeric", [1.0, 2.5, None, 3.25]),
    ("maxBoolean", [False, None, True]),
    ("minTime", [30, 10, 20]),
    ("maxTime", [30, 10, 20]),
    ("concatText", ["a", "b", None, "c"]),
    ("concatList", [["a"], ("b", "c"), "d"]),
    ("unionSet", [{"x"}, ["y", "x"], "z"]),
    ("unionMap", [{"a": 1.0, "s": "u"}, {"a": 2.0, "b": 5.0, "s": "v"}]),
]


@pytest.mark.parametrize("name,values", REDUCE_CASES)
def test_registered_reduce_semantics(name, values):
    got = pagg.AGGREGATOR_REGISTRY[name].reduce(values)
    assert got == jagg.AGGREGATOR_REGISTRY[name].reduce(values)


def test_custom_and_time_based_aggregators():
    for pkg in PKGS:
        mean = pkg["agg"].CustomMonoidAggregator(
            zero=(0.0, 0), plus=lambda a, b: (a[0] + b[0], a[1] + b[1]),
            prepare=lambda v: (v, 1), present=lambda a: a[0] / max(a[1], 1))
        assert mean.reduce([2.0, 4.0]) == 3.0
        assert pkg["agg"].TimeBasedAggregator(k=2).reduce([1, 2, 3]) == [2, 3]
        assert pkg["agg"].TimeBasedAggregator(k=1, last=False).reduce(
            [7, 8]) == 7


@pytest.mark.parametrize("is_response,pw,rw,cutoff", [
    (False, None, None, 25), (False, 10, None, 25), (True, None, 15, 25),
    (True, None, None, 25), (False, None, None, None),
    (True, None, 15, 10)])
def test_feature_aggregator_windows(is_response, pw, rw, cutoff):
    events = [(5, 1.0), (10, 1.5), (18, 2.0), (22, 4.0), (25, 8.0),
              (30, 16.0), (40, 32.0)]
    out = []
    for pkg in PKGS:
        fa = pkg["agg"].FeatureAggregator(
            pkg["ft"].Real, is_response, predictor_window_ms=pw,
            response_window_ms=rw)
        out.append(fa.extract([pkg["agg"].Event(t, v)
                               for t, v in events[::-1]], cutoff))
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# in-core readers: the JAX package's datasets, column for column
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["aggregate", "unix_none", "function",
                                  "conditional", "conditional_keep",
                                  "windowed"])
def test_in_core_datasets_equal_jax(kind):
    events = make_events()
    out = []
    for pkg in PKGS:
        C = pkg["agg"].CutOffTime
        if kind == "aggregate":
            reader = agg_reader(pkg, events)
        elif kind == "unix_none":
            reader = agg_reader(pkg, events, cutoff=C.no_cutoff())
        elif kind == "function":
            reader = agg_reader(pkg, events, cutoff=C.function(
                lambda r: r["t"] + 100))
        elif kind == "conditional":
            reader = cond_reader(pkg, events)
        elif kind == "conditional_keep":
            reader = cond_reader(pkg, events, drop_if_no_target=False)
        else:
            reader = cond_reader(pkg, events, predictor_window_ms=300,
                                 response_window_ms=100)
        ds = reader.generate_dataset(features(pkg))
        out.append((rows(ds), reader.estimate_rows(),
                    reader.estimate_rows_exact()))
    assert out[0] == out[1]
    assert out[1][1] == len(out[1][0])


def test_factories_build_the_same_readers():
    events = make_events(n_keys=9, n_events=80, seed=5)
    got = []
    for pkg in PKGS:
        DR = pkg["r"].DataReaders
        a = DR.Aggregate.records(events, key_fn=lambda r: r["id"],
                                 time_fn=lambda r: r["t"])
        c = DR.Conditional.records(events, key_fn=lambda r: r["id"],
                                   time_fn=lambda r: r["t"],
                                   target_condition=lambda r: r["label"] > 0)
        feats = features(pkg)
        got.append((rows(a.generate_dataset(feats)),
                    rows(c.generate_dataset(feats))))
    assert got[0] == got[1]


# ---------------------------------------------------------------------------
# streamed readers: chunks equal the in-core dataset, every source format
# ---------------------------------------------------------------------------

def _write_sources(tmp_path, events):
    jsonl = str(tmp_path / "ev.jsonl")
    with open(jsonl, "w") as fh:
        fh.writelines(json.dumps(r) + "\n" for r in events)
    path = str(tmp_path / "ev.csv")
    with open(path, "w", newline="") as fh:
        w = csv.DictWriter(fh, fieldnames=list(events[0]))
        w.writeheader()
        w.writerows(events)
    return jsonl, path


@pytest.mark.parametrize("source", ["records", "jsonl", "csv"])
@pytest.mark.parametrize("chunk_rows", [1, 7, 64])
def test_streamed_chunks_equal_in_core(tmp_path, source, chunk_rows):
    events = make_events(n_keys=23, n_events=250, seed=7)
    jsonl, path = _write_sources(tmp_path, events)
    want = rows(cond_reader(PORT, events, predictor_window_ms=400)
                .generate_dataset(features(PORT)))
    out = []
    for pkg in PKGS:
        src = {"records": events, "jsonl": pkg["r"].JSONLinesReader(jsonl),
               "csv": pkg["r"].CSVReader(path)}[source]
        reader = cond_reader(pkg, src, streaming=True, predictor_window_ms=400,
                             scan_chunk_rows=50)
        feats = features(pkg)
        chunks = list(reader.iter_chunks(feats, chunk_rows))
        assert all(len(c) <= chunk_rows for c in chunks)
        out.append([r for c in chunks for r in rows(c)])
    assert out[1] == want
    assert out[0] == out[1]


def test_host_range_slices_the_key_grid():
    events = make_events()
    reader = agg_reader(PORT, events)
    feats = features(PORT)
    full = rows(reader.generate_dataset(feats))
    got = [r for c in reader.iter_chunks(feats, 5, host_range=(7, 23))
           for r in rows(c)]
    assert got == full[7:23]
    view = pr.streaming_view(reader)
    assert isinstance(view, pr.StreamingAggregateReader)
    assert rows(view.generate_dataset(feats)) == full


# ---------------------------------------------------------------------------
# cutoff semantics
# ---------------------------------------------------------------------------

CUT_EVENTS = [
    {"id": "a", "t": 10, "amount": 1.0, "label": 0.0, "page": "home"},
    {"id": "a", "t": 20, "amount": 2.0, "label": 1.0, "page": "pay"},
    {"id": "a", "t": 30, "amount": 4.0, "label": 0.0, "page": "cart"},
    {"id": "a", "t": 40, "amount": 8.0, "label": 1.0, "page": "pay"},
    {"id": "b", "t": 5, "amount": 16.0, "label": 0.0, "page": "home"},
]


@pytest.mark.parametrize("case", ["at_cutoff", "half_open_response",
                                  "closed_left_predictor", "first_match",
                                  "drop_if_no_target"])
def test_cutoff_semantics(case):
    got = []
    for pkg in PKGS:
        fb, C = pkg["fb"], pkg["agg"].CutOffTime
        amount = fb.Real("amount").as_predictor()
        resp = fb.RealNN("amount_after").extract(
            lambda r: r["amount"]).as_response()
        feats = [amount, resp]
        if case == "at_cutoff":          # t == cutoff: response only
            r = agg_reader(pkg, CUT_EVENTS, cutoff=C.unix(20))
        elif case == "half_open_response":   # [20, 30): 30 excluded
            r = agg_reader(pkg, CUT_EVENTS, cutoff=C.unix(20),
                           response_window_ms=10)
        elif case == "closed_left_predictor":  # [10, 20): 10 included
            r = agg_reader(pkg, CUT_EVENTS, cutoff=C.unix(20),
                           predictor_window_ms=10)
        else:
            r = cond_reader(pkg, CUT_EVENTS,
                            drop_if_no_target=case == "drop_if_no_target")
        got.append(rows(r.generate_dataset(feats),
                        ["key", "amount", "amount_after"]))
    assert got[0] == got[1]
    expect = {"at_cutoff": ("a", 1.0, 14.0),
              "half_open_response": ("a", 1.0, 2.0),
              "closed_left_predictor": ("a", 1.0, 14.0),
              "first_match": ("a", 1.0, 14.0),
              "drop_if_no_target": ("a", 1.0, 14.0)}[case]
    assert got[1][0] == expect
    if case == "drop_if_no_target":
        assert [r[0] for r in got[1]] == ["a"]


# ---------------------------------------------------------------------------
# exact estimates, joins, spills
# ---------------------------------------------------------------------------

def _join_sides(n=40, seed=4):
    rng = np.random.default_rng(seed)
    left = [{"key": f"k{int(rng.integers(0, 12))}", "x": float(i),
             "tl": int(rng.integers(0, 100)), "tag": f"t{i % 3}"}
            for i in range(n)]
    right = [{"key": f"k{int(rng.integers(0, 16))}", "z": float(i * 10),
              "tr": int(rng.integers(0, 100)),
              "set": ["a", "b"][i % 2]} for i in range(n)]
    return left, right


def _joined(pkg, join_type, n=40, seed=4, secondary=False):
    left, right = _join_sides(n, seed)
    fb = pkg["fb"]
    xf, tag = fb.Real("x").as_predictor(), fb.Text("tag").as_predictor()
    zf = fb.Real("z").as_predictor()
    sf = fb.MultiPickList("set").extract(lambda r: {r["set"]}).as_predictor()
    tl, trf = fb.Integral("tl").as_predictor(), fb.Integral("tr").as_predictor()
    jrd = pkg["r"].JoinedDataReader(
        pkg["r"].RecordsReader(left), pkg["r"].RecordsReader(right),
        [xf, tag, tl], [zf, sf, trf], join_type=join_type)
    if secondary:
        jrd = jrd.with_secondary_aggregation(pkg["r"].TimeBasedFilter(
            condition="tr", primary="tl", window_ms=50))
    return jrd, [xf, tag, zf, sf]


JNAMES = ["key", "x", "tag", "z", "set"]


@pytest.mark.parametrize("join_type", ["inner", "left", "outer"])
@pytest.mark.parametrize("secondary", [False, True])
def test_joins_equal_jax(join_type, secondary):
    out = []
    for pkg in PKGS:
        jrd, feats = _joined(pkg, join_type, secondary=secondary)
        ds = jrd.generate_dataset(feats)
        out.append((rows(ds, JNAMES), jrd.estimate_rows()))
    assert out[0] == out[1]
    assert out[1][1] == len(out[1][0])


@pytest.mark.parametrize("join_type", ["inner", "left", "outer"])
def test_stream_join_content_and_order(join_type):
    out = []
    for pkg in PKGS:
        jrd, feats = _joined(pkg, join_type)
        chunks = list(jrd.stream(feats, 7))
        assert all(len(c) <= 7 for c in chunks)
        out.append([r for c in chunks for r in rows(c, JNAMES)])
    assert out[0] == out[1]
    jrd, feats = _joined(PORT, join_type)
    assert sorted(out[1]) == sorted(rows(jrd.generate_dataset(feats), JNAMES))
    assert [r[0] for r in out[1]] == sorted(r[0] for r in out[1])


def test_stream_join_spills_under_a_tiny_budget(monkeypatch):
    jrd, feats = _joined(PORT, "outer", n=600, seed=9)
    want = [r for c in jrd.stream(feats, 13) for r in rows(c, JNAMES)]
    spills = []
    orig = _SpillSorter._spill

    def spy(self):
        orig(self)
        spills.append(len(self.runs))

    monkeypatch.setattr(_SpillSorter, "_spill", spy)
    monkeypatch.setenv("TMOG_STREAM_RETAIN_MB", "0.01")
    got = [r for c in jrd.stream(feats, 13) for r in rows(c, JNAMES)]
    assert spills and got == want


def test_stream_join_aggregate_equals_in_core():
    out = []
    for pkg in PKGS:
        jrd, feats = _joined(pkg, "left", n=60, seed=12, secondary=True)
        got = [r for c in jrd.stream(feats, 5) for r in rows(c, JNAMES)]
        assert got == rows(jrd.generate_dataset(feats), JNAMES)
        out.append(got)
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# the fold-state algebra
# ---------------------------------------------------------------------------

def test_key_owner_equals_jax():
    keys = [f"k{i}" for i in range(50)] + [1, 2.5, ("a", 1)]
    for n in (1, 2, 3, 7):
        assert [pr.key_owner(k, n) for k in keys] == \
            [jr.key_owner(k, n) for k in keys]


def test_fold_state_shard_merge_and_codec():
    events = make_events(n_keys=11, n_events=120, seed=8)
    reader = pr.StreamingAggregateReader(
        events, key_fn=lambda r: r["id"], time_fn=lambda r: r["t"],
        cutoff=pagg.CutOffTime.unix(500))
    feats = features(PORT)
    index = reader._index()
    state = reader._fold(feats, index, 0, len(index.keys))
    aggs = reader._aggregators(feats)
    want = rows(reader._finalize_block(feats, aggs, index, state, 0,
                                       len(index.keys)))
    for n in (2, 3):
        parts = state.shard(n)
        assert sum(len(p.rows) for p in parts) == len(state.rows)
        merged = pr.merge_fold_states(parts[::-1])
        got = rows(reader._finalize_block(feats, aggs, index, merged, 0,
                                          len(index.keys)))
        assert got == want
    st = state.to_state()
    back = pr.EventFoldState.from_state(st)
    assert back.rows == state.rows
    jstate = jr.EventFoldState(state.feature_names)
    jstate.rows = dict(state.rows)
    assert jstate.to_state() == st
    with pytest.raises(ValueError):
        state.merge(pr.EventFoldState(["other"]))


# ---------------------------------------------------------------------------
# resilience over event sources
# ---------------------------------------------------------------------------

def test_corrupt_line_quarantines_once_across_passes(tmp_path):
    events = make_events(n_keys=7, n_events=60, seed=13)
    p = str(tmp_path / "ev.jsonl")
    with open(p, "w") as fh:
        for i, r in enumerate(events):
            fh.write("{not json]\n" if i in (5, 18) else json.dumps(r) + "\n")
    clean = [r for i, r in enumerate(events) if i not in (5, 18)]
    out = []
    for pkg in PKGS:
        q = str(tmp_path / f"q_{id(pkg)}.jsonl")
        reader = pkg["r"].StreamingAggregateReader(
            pkg["r"].JSONLinesReader(p), key_fn=lambda r: r["id"],
            time_fn=lambda r: r["t"], cutoff=pkg["agg"].CutOffTime.unix(500)
        ).with_resilience(bad_records="quarantine", quarantine_path=q)
        feats = features(pkg)
        ds = reader.generate_dataset(feats)
        list(reader.iter_chunks(feats, 16))
        sink = reader.resilience.sink()
        with open(q) as fh:
            entries = [json.loads(line) for line in fh]
        for e in entries:
            e["source"] = os.path.basename(e["source"])
        out.append((rows(ds), sink.count, sink.rows, entries))
        assert rows(ds) == rows(agg_reader(pkg, clean).generate_dataset(
            features(pkg)))
    assert out[0] == out[1]
    assert out[1][1] == out[1][2] == 2


def test_bad_extract_quarantines_at_its_event_record(tmp_path):
    events = make_events(n_keys=5, n_events=40, seed=14)
    events[13]["amount"] = {"oops": 1}
    out = []
    for pkg in PKGS:
        q = str(tmp_path / f"q_{id(pkg)}.jsonl")
        feats = [pkg["fb"].Real("amount").extract(
            lambda r: float(r["amount"])).as_predictor(),
            pkg["fb"].RealNN("label").as_response()]
        reader = agg_reader(pkg, events).with_resilience(
            bad_records="quarantine", quarantine_path=q)
        ds = reader.generate_dataset(feats)
        list(reader.iter_chunks(feats, 8))
        with open(q) as fh:
            entries = [json.loads(line) for line in fh]
        out.append((rows(ds, ["key", "amount", "label"]), entries))
        with pytest.raises((TypeError, ValueError)):
            agg_reader(pkg, events).generate_dataset(feats)
    assert out[0] == out[1]
    assert [e["location"] for e in out[1][1]] == ["event-record#13"]


def test_event_window_io_error_rides_the_retry():
    events = make_events(n_keys=9, n_events=80, seed=15)
    reader = agg_reader(PORT, events)
    feats = features(PORT)
    want = [r for c in reader.iter_chunks(feats, 4) for r in rows(c)]
    with pfaults.inject(pfaults.FaultSpec(point="event.window",
                                          action="io_error", at=2,
                                          times=1)) as plan:
        stream = pres.RetryingChunkStream(
            lambda: reader.iter_chunks(feats, 4),
            pres.RetryPolicy(max_attempts=3, base_delay_s=0.0))
        got = [r for c in stream for r in rows(c)]
    assert got == want and stream.retries == 1
    assert plan.log == [{"point": "event.window", "index": 2, "tag": None,
                         "action": "io_error"}]


def test_join_chunk_fault_point_fires():
    jrd, feats = _joined(PORT, "inner", n=20)
    with pfaults.inject(pfaults.FaultSpec(point="join.chunk", action="raise",
                                          at=1)):
        with pytest.raises(pfaults.FaultError):
            list(jrd.stream(feats, 4))


# ---------------------------------------------------------------------------
# TM060
# ---------------------------------------------------------------------------

def _tm060(pkg, case):
    fb, C = pkg["fb"], pkg["agg"].CutOffTime
    amount = fb.Real("amount").as_predictor()
    label = fb.RealNN("label").as_response()
    feats = [amount, label]
    if case == "no_cutoff":
        reader = agg_reader(pkg, [], cutoff=C.no_cutoff())
    elif case == "response_field":
        feats = [fb.Real("leak").extract(lambda r: r["purchase"],
                                         event_field="purchase")
                 .as_predictor(),
                 fb.Binary("bought").extract(lambda r: bool(r["purchase"]),
                                             event_field="purchase")
                 .as_response()]
        reader = agg_reader(pkg, [], cutoff=C.unix(10))
    elif case == "implicit_name":
        feats = [amount, fb.RealNN("lbl").extract(
            lambda r: r["amount"], event_field="amount").as_response()]
        reader = agg_reader(pkg, [], cutoff=C.unix(10))
    elif case == "both":
        feats = [amount, fb.RealNN("lbl").extract(
            lambda r: r["amount"], event_field="amount").as_response()]
        reader = agg_reader(pkg, [], cutoff=C.no_cutoff())
    elif case == "conditional":
        reader = cond_reader(pkg, [])
    elif case == "streamed_no_cutoff":
        reader = pkg["r"].StreamingAggregateReader(
            [], key_fn=lambda r: r["id"], time_fn=lambda r: r["t"])
    else:
        reader = pkg["r"].RecordsReader([{"amount": 1.0}])
    findings = pkg["lint"](pkg["dag"]([[f.origin_stage for f in feats]]),
                           reader=reader)
    return [(d.rule, d.severity, d.message) for d in findings.diagnostics]


@pytest.mark.parametrize("case", ["no_cutoff", "response_field",
                                  "implicit_name", "both", "conditional",
                                  "streamed_no_cutoff", "non_event"])
def test_tm060_findings_equal_jax(case):
    got = _tm060(PORT, case)
    assert got == _tm060(JAX, case)
    fires = case in ("no_cutoff", "response_field", "implicit_name", "both",
                     "streamed_no_cutoff")
    assert [r for r, _, _ in got] == (["TM060"] if fires else [])


def test_tm060_suppressed_at_the_construction_site(tmp_path):
    src = ("from transmogrifai_tpu_torch.features.builder import "
           "FeatureBuilder\n"
           "prev = (FeatureBuilder.Real('prev_purchase')\n"
           "        .extract(lambda r: r['purchase'],\n"
           "                 event_field='purchase')\n"
           "        .as_predictor())  # tmog: disable=TM060\n"
           "bought = (FeatureBuilder.Binary('bought')\n"
           "          .extract(lambda r: bool(r['purchase']),\n"
           "                   event_field='purchase').as_response())\n")
    mod = tmp_path / "lagged_features.py"
    mod.write_text(src)
    ns = {}
    exec(compile(src, str(mod), "exec"), ns)
    assert ns["prev"].origin_stage.source_location == f"{mod}:5"
    findings = plint(PDAG([[ns["prev"].origin_stage,
                            ns["bought"].origin_stage]]),
                     reader=agg_reader(PORT, [], cutoff=pagg.CutOffTime.unix(
                         10)))
    assert findings.rules_fired() == []


def test_train_refuses_a_leaky_event_pipeline():
    events = make_events(n_keys=12, n_events=100, seed=33)
    amount = PFB.Real("amount").as_predictor()
    label = PFB.RealNN("label").as_response()
    checked = PChecker(min_variance=-1.0).set_input(
        label, ptransmogrify([amount])).get_output()
    pred = PSelector.with_train_validation_split(
        models_and_parameters=[(PLR(), pgrid(reg_param=[0.1]))]
    ).set_input(label, checked).get_output()
    wf = (PWorkflow().allow_non_serializable().set_result_features(pred)
          .set_reader(agg_reader(PORT, events,
                                 cutoff=pagg.CutOffTime.no_cutoff())))
    with pytest.raises(PipelineLintError, match="TM060"):
        wf.train()


# ---------------------------------------------------------------------------
# the event demo trained in both packages
# ---------------------------------------------------------------------------

def _demo(pkg, chunk_rows, jsonl, hold):
    pkg["uid"]._counter = itertools.count(1)
    ns = {"FeatureBuilder": pkg["fb"], "transmogrify": pkg["transmogrify"],
          "SanityChecker": pkg["checker"],
          "BinaryClassificationModelSelector": pkg["selector"],
          "CutOffTime": pkg["agg"].CutOffTime,
          "ConditionalDataReader": pkg["r"].ConditionalDataReader,
          "JSONLinesReader": pkg["r"].JSONLinesReader,
          "StreamingAggregateReader": pkg["r"].StreamingAggregateReader,
          "StreamingConditionalReader": pkg["r"].StreamingConditionalReader}
    pred, _, sel = chip_smoke.build_events(
        ns, models_and_parameters=[(pkg["lr"](),
                                    pkg["grid"](reg_param=[0.01, 0.1]))])
    if chunk_rows is None:
        with open(jsonl) as fh:
            reader = chip_smoke.events_reader(
                [json.loads(line) for line in fh], streamed=False, ns=ns)
    else:
        reader = chip_smoke.events_reader(jsonl, ns=ns)
    wf = (pkg["workflow"]().allow_non_serializable()
          .set_result_features(pred).set_reader(reader))
    model = wf.train(chunk_rows=chunk_rows)
    data = chip_smoke.events_reader(hold, ns=ns).generate_dataset(
        list(wf.raw_features()))
    p = model.score(data=data)[pred.name]
    proba = np.asarray([r["probability_1"] for r in p.to_list()]) \
        if pkg is JAX else p.values.probability[:, 1].double().numpy()
    summ = sel.metadata["model_selector_summary"]
    return (summ["bestModelType"], summ["bestModelParams"],
            len(model.train_data)), proba


@pytest.fixture(scope="module")
def demo_logs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("events_demo")
    jsonl, hold = str(tmp / "train.jsonl"), str(tmp / "hold.jsonl")
    chip_smoke.make_clickstream(jsonl, 300, seed=chip_smoke.EV_SEED)
    chip_smoke.make_clickstream(hold, 100, seed=chip_smoke.EV_HOLD_SEED)
    tt.set_device("cpu")
    return jsonl, hold, _demo(JAX, None, jsonl, hold)


@pytest.mark.parametrize("chunk_rows", [None, 32, 64])
def test_event_demo_trains_like_jax(demo_logs, chunk_rows):
    jsonl, hold, (want, want_p) = demo_logs
    got, got_p = _demo(PORT, chunk_rows, jsonl, hold)
    assert got == want
    np.testing.assert_allclose(got_p, want_p, rtol=0, atol=1e-6)
