"""The port's observability mechanics (``transmogrifai_tpu_torch/obs/``,
the transfer ledger of ``utils/profiling.py``) against the JAX package's
(``tests/test_obs.py``), on the CPU.

Exact, with no tolerance:
* the Chrome-trace document and ``trace_summary`` text of the same span
  and event records, injected into both packages' tracers (the same
  names, parents, attributes, threads and timings);
* ``validate_chrome_trace`` on the same malformed documents;
* ``prometheus_text`` of the same serving snapshot and counters, less the
  families the port leaves out (named in ``_LEFT_OUT``), and
  ``parse_exposition`` of it;
* ``RunCounters.to_json``'s keys and the snapshots' keys;
* the flight ring's order and bound, the JSON-lines round trip, the
  merge of dumps and the crash dump.

Also: the tracer's contracts (one ``None`` check when off, the thread
stack, explicit and adopted parents, the ``max_spans`` bound), a thread
hammer on the ``count_*`` functions with exact totals, the disabled-hook
estimator's refusal while armed, ``bench_meta``'s keys, the kernel-mix
capture (aten ops on the CPU; nothing while ``profile_to`` holds the
profiler; an empty field, never a broken stage, when the capture fails),
``StageProfile.hlo`` and ``StageObservation.hlo`` through their JSON.
"""
import json
import sys
import threading

import pytest
import torch

import transmogrifai_tpu_torch as tt
from transmogrifai_tpu import obs as jobs
from transmogrifai_tpu.serving.metrics import ServingMetrics as JMetrics
from transmogrifai_tpu.utils import profiling as jprof
from transmogrifai_tpu_torch import obs
from transmogrifai_tpu_torch.obs import kernel_mix
from transmogrifai_tpu_torch.serving.metrics import ServingMetrics
from transmogrifai_tpu_torch.utils import profiling as tprof


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tt.set_device("cpu")
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _clean_tracing():
    """Every test starts and ends untraced in both packages (tracing is
    process-global)."""
    obs.stop_trace()
    jobs.stop_trace()
    yield
    obs.stop_trace()
    jobs.stop_trace()


# ---------------------------------------------------------------------------
# the tracer's contracts
# ---------------------------------------------------------------------------

def test_disabled_hooks_are_noops():
    assert obs.current_tracer() is None
    sp = obs.begin_span("x", cat="t")
    assert sp is None
    obs.end_span(sp)
    obs.record_event("y")
    with obs.span("z") as s:
        assert s is None
    with obs.trace.adopt_span(None):
        assert obs.current_span() is None


def test_span_nesting_attrs_and_trace_id():
    tracer = obs.start_trace("unit")
    with obs.span("outer", cat="a") as outer:
        assert obs.current_span() is outer
        inner = obs.begin_span("inner", cat="b", a=1)
        assert inner.parent_id == outer.span_id
        assert inner.trace_id == tracer.trace_id
        obs.end_span(inner, b=2)
    assert obs.stop_trace() is tracer
    assert obs.stop_trace() is None
    spans = tracer.snapshot()
    assert [s.name for s in spans] == ["inner", "outer"]
    assert spans[0].attrs == {"a": 1, "b": 2}
    assert all(s.dur_s is not None and s.dur_s >= 0 for s in spans)


def test_explicit_and_adopted_parents_cross_threads():
    tracer = obs.start_trace()
    parent = obs.begin_span("root", cat="t")
    seen = {}

    def explicit():
        child = obs.begin_span("child", cat="t", parent=parent)
        seen["explicit"] = child.parent_id
        obs.end_span(child)

    def adopted():
        with obs.trace.adopt_span(parent):
            with obs.span("adopted", cat="t") as sp:
                obs.record_event("worker.event")
                seen["adopted"] = sp.parent_id
        seen["after"] = obs.current_span()

    for fn in (explicit, adopted):
        t = threading.Thread(target=fn)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    obs.end_span(parent)
    obs.stop_trace()
    assert seen["explicit"] == seen["adopted"] == parent.span_id
    assert seen["after"] is None
    [e] = tracer.flight.events()
    assert e["spanId"] != parent.span_id and e["kind"] == "worker.event"
    assert len(tracer.spans) == 3


def test_max_spans_bound_and_tracing_scope():
    with obs.tracing("scoped", max_spans=3) as tracer:
        for i in range(5):
            with obs.span(f"s{i}"):
                pass
    assert obs.current_tracer() is None
    assert [s.name for s in tracer.spans] == ["s0", "s1", "s2"]
    assert tracer.dropped == 2


# ---------------------------------------------------------------------------
# Chrome export: the same records give the same document in both packages
# ---------------------------------------------------------------------------

_SPANS = [  # name, cat, span id, parent id, t0, dur, thread, attrs
    ("workflow.train", "workflow", 1, None, 1_700_000_000.0, 2.5,
     "MainThread", {"chunked": True, "chunk_rows": 64}),
    ("plan.layer[0]", "plan", 2, 1, 1_700_000_000.25, 2.0, "MainThread",
     {"stages": 1, "rows": 400}),
    ("stage:ModelSelector", "stage", 3, 2, 1_700_000_000.5, 1.75,
     "tmog-plan_0", {"uid": "ModelSelector_1", "device": True,
                     "nested": {"k": [1, 2.5, "x"]}}),
    ("sweep.unit[0]", "sweep", 4, 3, 1_700_000_001.0, 0.0125,
     "sweep-unit-watchdog", {"candidate": "OpLogisticRegression",
                             "retries": 1, "obj": object}),
]
_EVENTS = [("fault.fired", {"point": "device.loss", "index": 0}, 4,
            1_700_000_001.001),
           ("elastic.retries", {}, 4, 1_700_000_001.002),
           ("refresh.start", {"chunk_rows": None}, None, 1_700_000_002.5)]


def _injected(pkg, dropped=0):
    tracer = pkg.Tracer(label="parity", trace_id="feedc0ffee000001")
    for name, cat, sid, pid, t0, dur, thread, attrs in _SPANS:
        sp = pkg.Span(name, cat, tracer.trace_id, sid, pid, dict(attrs))
        sp.t0_unix, sp.dur_s, sp.thread = t0, dur, thread
        tracer.spans.append(sp)
    tracer.dropped = dropped
    tracer.flight = pkg.FlightRecorder(trace_id=tracer.trace_id)
    for seq, (kind, attrs, span_id, t) in enumerate(_EVENTS, start=1):
        tracer.flight._ring.append({"seq": seq, "t": t, "kind": kind,
                                    "traceId": tracer.trace_id,
                                    "spanId": span_id, "attrs": attrs})
    return tracer


@pytest.mark.parametrize("dropped", [0, 3])
def test_chrome_document_and_summary_equal_jax(dropped):
    tdoc = obs.to_chrome_trace(_injected(obs, dropped))
    jdoc = jobs.to_chrome_trace(_injected(jobs, dropped))
    assert tdoc == jdoc
    assert obs.validate_chrome_trace(tdoc) == []
    for k in (1, 3, 15):
        assert obs.trace_summary(tdoc, top_k=k) == \
            jobs.trace_summary(jdoc, top_k=k)
    assert ("3 dropped" in obs.trace_summary(tdoc)) == bool(dropped)


def test_traced_spans_export_and_link():
    tracer = obs.start_trace("exp")
    with obs.span("a", cat="run", n=1):
        with obs.span("b", cat="plan"):
            obs.record_event("evt", z=2)
    obs.stop_trace()
    doc = obs.to_chrome_trace(tracer)
    assert obs.validate_chrome_trace(doc) == []
    xs = {e["name"]: e for e in doc["traceEvents"] if e["ph"] == "X"}
    assert xs["b"]["args"]["parentId"] == xs["a"]["args"]["spanId"]
    [inst] = [e for e in doc["traceEvents"] if e["ph"] == "i"]
    assert inst["args"]["spanId"] == xs["b"]["args"]["spanId"]


_MALFORMED = [
    [],
    {"traceEvents": {}},
    {"traceEvents": [{"ph": "X", "name": "x", "ts": -1, "dur": "no",
                      "pid": 0}]},
    {"traceEvents": [{"ph": "?"}, 3, {"ph": "i", "ts": 1.0},
                     {"ph": "M", "name": "thread_name"},
                     {"ph": "X", "name": "", "ts": 0, "dur": 1}]},
    {"traceEvents": [{"ph": "B", "name": "x", "ts": "t", "pid": 0}] * 30},
]


@pytest.mark.parametrize("doc", _MALFORMED,
                         ids=[f"doc{i}" for i in range(len(_MALFORMED))])
def test_validator_problems_equal_jax(doc):
    problems = obs.validate_chrome_trace(doc)
    assert problems and problems == jobs.validate_chrome_trace(doc)


# ---------------------------------------------------------------------------
# Prometheus: the JAX package's text, less the families left out
# ---------------------------------------------------------------------------

#: families of what the port does not count yet (ROADMAP Queue A 6.6.2,
#: 6.6.4): the JAX package renders them, the port leaves them out
_LEFT_OUT = {"tmog_compile_cache_events_total",
             "tmog_serving_swaps_accepted_total",
             "tmog_serving_swaps_rejected_total",
             "tmog_serving_rollbacks_total"}


def _drop_families(text: str, names) -> str:
    kept = []
    for line in text.splitlines():
        if line.startswith("#"):
            name = line.split()[2]
        else:
            name = line.split("{")[0].split(" ")[0]
        if name not in names:
            kept.append(line)
    return "\n".join(kept) + "\n"


def _counters(pkg_prof):
    c = pkg_prof.RunCounters()
    c.uploads, c.upload_bytes, c.upload_s = 3, 3 * 4096, 0.0123456789
    c.fetches, c.fetch_bytes, c.fetch_s = 5, 40, 0.5
    c.drains, c.drain_s = 5, 1.25
    c.launches = 7
    c.launch_tags = {"seg_hist": 6, "serving.batch": 1}
    c.elastic = {"retries": 2, "device_losses": 2, 'we"ird\\': 1}
    c.refresh = {"merged": 4, "refit": 1}
    return c


def _jax_snapshot(populated: bool):
    m = JMetrics()
    if populated:
        m.record_admitted(4)
        m.record_batch(4, 8, 0.002)
        m.record_batch(1, 1, 0.001)
        for v in (0.010, 0.020, 0.030):
            m.record_request_latency(v)
        m.record_shed(2)
    return m.snapshot()


def _port_snapshot(populated: bool):
    m = ServingMetrics()
    if populated:
        m.record_admitted(4)
        m.record_batch(4, 8)
        m.record_batch(1, 1)
        for v in (0.010, 0.020, 0.030):
            m.record_request_latency(v)
        m.record_shed(2)
    return m.snapshot()


@pytest.mark.parametrize("source", ["jax", "port", "none"])
@pytest.mark.parametrize("populated", [False, True])
def test_prometheus_text_equals_jax(source, populated):
    snap = {"jax": _jax_snapshot, "port": _port_snapshot,
            "none": lambda p: None}[source](populated)
    if snap is not None:
        snap["uptimeSecs"] = 12.5   # the one key that moves between calls
    text = obs.prometheus_text(snap, counters=_counters(tprof))
    jtext = jobs.prometheus_text(snap, counters=_counters(jprof))
    assert text == _drop_families(jtext, _LEFT_OUT)
    assert not any(name in text for name in _LEFT_OUT)
    assert "None" not in text and "NaN" not in text
    samples = obs.parse_exposition(text)
    assert samples == {k: v for k, v in jobs.parse_exposition(jtext).items()
                       if k.split("{")[0] not in _LEFT_OUT}
    assert samples["tmog_run_launches_total"] == 7
    if snap is not None:
        assert samples["tmog_serving_requests_total"] == (
            1 if populated else 0)
        quantiles = [k for k in samples if k.startswith(
            "tmog_serving_request_latency_seconds{")]
        assert len(quantiles) == (3 if populated else 0)
        assert "# TYPE tmog_serving_request_latency_seconds summary" in text


def test_prometheus_defaults_to_the_process_counters():
    tprof.reset_counters()
    try:
        tprof.count_launch("seg_hist", 3)
        samples = obs.parse_exposition(obs.prometheus_text())
        assert samples["tmog_run_launches_total"] == 3
    finally:
        tprof.reset_counters()


@pytest.mark.parametrize("bad", ["metric 1", "bad name 1\n",
                                 'm{a="1"} 2 3\n', "m NaNx\n"])
def test_parse_exposition_rejects_as_jax_does(bad):
    with pytest.raises(ValueError):
        jobs.parse_exposition(bad)
    with pytest.raises(ValueError):
        obs.parse_exposition(bad)


# ---------------------------------------------------------------------------
# the transfer ledger
# ---------------------------------------------------------------------------

def test_run_counters_keys_equal_jax():
    assert set(tprof.RunCounters().to_json()) == \
        set(jprof.RunCounters().to_json())
    assert set(tprof.elastic_snapshot()) == set(jprof.elastic_snapshot())
    assert set(tprof.refresh_snapshot()) == set(jprof.refresh_snapshot())
    assert tprof.RunCounters().to_json() == jprof.RunCounters().to_json()


def test_fetch_timed_books_drain_and_fetch():
    tprof.reset_counters()
    try:
        x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
        out = tprof.fetch_timed(x, dtype="float64", tag="sweep.final")
        assert out.dtype.name == "float64" and out.tolist() == \
            [[0, 1, 2], [3, 4, 5]]
        tprof.fetch_timed(x, tag="sweep.checkpoint", overlapped=True)
        up = tprof.upload_timed(out, "cpu")
        assert up.dtype == torch.float64
        c = tprof.COUNTERS.to_json()
        assert (c["fetches"], c["fetchBytes"]) == (2, 48 + 24)
        assert (c["drains"], c["overlaps"]) == (1, 1)
        assert set(c["drainTags"]) == {"sweep.final",
                                       "sweep.checkpoint+overlap"}
        assert (c["uploads"], c["uploadBytes"]) == (1, 48)
    finally:
        tprof.reset_counters()


def test_count_functions_hammer_exact_totals():
    """More threads than cores and a short switch interval: an unguarded
    read-modify-write would lose increments."""
    n_threads, per = 16, 1500
    tprof.reset_counters()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def hammer():
        for _ in range(per):
            tprof.count_launch("hammer")
            tprof.count_upload(8, 0.0)
            tprof.count_fetch(8, 0.0)
            tprof.count_drain(0.0, tag="t")
            tprof.count_drain(0.0, tag="t", overlapped=True)
            tprof.count_elastic("retries")
            tprof.count_refresh("merged")

    try:
        threads = [threading.Thread(target=hammer) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        total = n_threads * per
        c = tprof.COUNTERS
        assert c.launches == c.launch_tags["hammer"] == total
        assert (c.uploads, c.upload_bytes) == (total, 8 * total)
        assert (c.fetches, c.fetch_bytes) == (total, 8 * total)
        assert c.drains == c.overlaps == total
        assert tprof.elastic_snapshot()["retries"] == total
        assert tprof.refresh_snapshot()["merged"] == total
    finally:
        sys.setswitchinterval(old)
        tprof.reset_counters()


# ---------------------------------------------------------------------------
# the flight recorder
# ---------------------------------------------------------------------------

def _record(pkg, capacity, n):
    rec = pkg.FlightRecorder(capacity=capacity)
    pkg.install_recorder(rec)
    try:
        for i in range(n):
            pkg.record_event("elastic.retries" if i % 2 else "k", i=i)
    finally:
        pkg.install_recorder(None)
    return rec


def _stable(events):
    return [{k: v for k, v in e.items() if k != "t"} for e in events]


def test_ring_order_and_bound_equal_jax():
    rec, jrec = _record(obs, 4, 7), _record(jobs, 4, 7)
    assert _stable(rec.events()) == _stable(jrec.events())
    assert [e["seq"] for e in rec.events()] == [4, 5, 6, 7]
    assert [e["attrs"]["i"] for e in rec.events()] == [3, 4, 5, 6]
    assert rec.recorded == jrec.recorded == 7 and len(rec) == 4
    assert rec.kinds() == jrec.kinds()
    assert _stable(rec.events("elastic.")) == _stable(jrec.events("elastic."))


def test_dump_roundtrip_and_merge_equal_jax(tmp_path):
    paths = []
    for i, (cap, n) in enumerate([(8, 3), (8, 5)]):
        rec = _record(obs, cap, n)
        p = tmp_path / f"flight{i}.jsonl"
        assert rec.dump_jsonl(str(p)) == n
        back = [json.loads(line) for line in p.read_text().splitlines()]
        assert back == json.loads(json.dumps(rec.events()))
        paths.append(str(p))
    paths.append(str(tmp_path / "missing.jsonl"))
    out, jout = tmp_path / "merged.jsonl", tmp_path / "jmerged.jsonl"
    merged = obs.flight.merge_flight_dumps(paths, str(out))
    assert merged == jobs.flight.merge_flight_dumps(paths, str(jout))
    assert out.read_text() == jout.read_text()
    assert len(merged) == 8 and {e["process"] for e in merged} == {0, 1}


@pytest.mark.parametrize("pkg", [obs, jobs], ids=["port", "jax"])
def test_crash_dump_flushes_the_ring(pkg, tmp_path):
    prev = sys.excepthook
    rec = pkg.FlightRecorder()
    pkg.install_recorder(rec)
    pkg.record_event("before_crash")
    path = tmp_path / "crash.jsonl"
    pkg.arm_crash_dump(str(path))
    try:
        assert sys.excepthook is not prev
        # the chained hook prints the traceback to stderr, as it would
        sys.excepthook(ValueError, ValueError("boom"), None)
    finally:
        pkg.disarm_crash_dump()
        pkg.install_recorder(None)
    assert sys.excepthook is prev
    lines = [json.loads(line) for line in path.read_text().splitlines()]
    assert [e["kind"] for e in lines] == ["before_crash", "crash"]
    assert lines[1]["attrs"] == {"error": "ValueError: boom"}


# ---------------------------------------------------------------------------
# bench_meta and the disabled-hook estimator
# ---------------------------------------------------------------------------

def test_bench_meta_keys():
    jmeta = jobs.bench_meta(wall_s=1.25)
    meta = obs.bench_meta(wall_s=1.25)
    assert set(meta) == (set(jmeta) - {"jax"}) | {"torch", "cuda",
                                                  "deviceName"}
    assert meta["traceId"] is None and meta["wallSecs"] == 1.25
    assert meta["torch"] == torch.__version__
    json.dumps(meta)
    tracer = obs.start_trace()
    assert obs.bench_meta()["traceId"] == tracer.trace_id


def test_overhead_estimator_refuses_while_armed():
    est = obs.estimate_disabled_overhead_s(100, samples=1000)
    assert 0 <= est < 0.1
    obs.start_trace()
    with pytest.raises(RuntimeError, match="disabled"):
        obs.estimate_disabled_overhead_s(100, samples=10)
    obs.stop_trace()
    obs.install_recorder(obs.FlightRecorder())
    try:
        with pytest.raises(RuntimeError, match="disabled"):
            obs.estimate_disabled_overhead_s(100, samples=10)
    finally:
        obs.install_recorder(None)


# ---------------------------------------------------------------------------
# the kernel mix
# ---------------------------------------------------------------------------

def _work():
    x = torch.ones(8, 8)
    return (x @ x).sum()


def test_capture_records_aten_ops_on_the_cpu_only_when_armed():
    with kernel_mix.capture("cpu") as off:
        _work()
    assert off == {}
    obs.start_trace()
    with kernel_mix.capture("cpu") as mix:
        _work()
    with kernel_mix.capture("cpu") as outer:
        with kernel_mix.capture("cpu") as inner:
            _work()
    obs.stop_trace()
    assert mix["ops"].get("aten::mm", 0) >= 1
    assert mix["programs"] == sum(mix["ops"].values())
    assert "deviceSecs" not in mix     # the CPU is not the card
    assert inner == {"skipped": "capture active"}
    assert "aten::mm" in outer["ops"]
    assert not kernel_mix.is_armed()


def test_capture_skips_under_profile_to(tmp_path):
    obs.start_trace()
    with tprof.profile_to(str(tmp_path / "prof")):
        with kernel_mix.capture("cpu") as mix:
            _work()
        with pytest.raises(RuntimeError, match="already running"):
            with tprof.profile_to(str(tmp_path / "again")):
                pass
    assert mix == {"skipped": "profile_to active"}
    doc = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert any(e.get("name") == "aten::mm" for e in doc["traceEvents"])


def test_capture_failure_leaves_the_field_empty(monkeypatch):
    def broken(prof, card=False):
        raise RuntimeError("cupti went away")

    monkeypatch.setattr(kernel_mix, "summarize", broken)
    obs.start_trace()
    with kernel_mix.capture("cpu") as mix:
        _work()
    assert mix == {}
    # the stage's own failure still raises through the capture
    with pytest.raises(ZeroDivisionError):
        with kernel_mix.capture("cpu"):
            1 / 0
    with kernel_mix.capture("cpu") as again:   # the profiler was released
        _work()
    assert again == {}


def test_hlo_rides_the_profiles_json(tmp_path):
    from transmogrifai_tpu.tuning.costmodel import \
        StageObservation as JObs
    from transmogrifai_tpu_torch.tuning.costmodel import (
        StageObservation, observations_from_profiler,
        record_train_observations)

    mix = {"programs": 3, "ops": {"seg_hist_groups": 1,
                                  "seg_hist_reduce": 1, "memset": 1},
           "deviceSecs": 0.001}
    bare = tprof.StageProfile("u", "Op", "o", 0, "fit", True, 0.5, 10)
    assert "hlo" not in bare.to_json()
    sp = tprof.StageProfile("u", "Op", "o", 0, "fit", True, 0.5, 10, hlo=mix)
    assert sp.to_json()["hlo"] == mix
    prof = tprof.PlanProfiler()
    prof.record_stage(sp)
    prof.record_stage(bare)
    [o, o_bare] = observations_from_profiler(prof)
    assert o.hlo == mix and o_bare.hlo == {}
    assert "hlo" not in o_bare.to_json()
    back = StageObservation.from_json(json.loads(json.dumps(o.to_json())))
    assert back == o
    assert JObs.from_json(o.to_json()).hlo == mix
    path = str(tmp_path / "history.json")
    assert record_train_observations(prof, path=path)
    with open(path) as f:
        text = f.read()
    assert "seg_hist_groups" in text
