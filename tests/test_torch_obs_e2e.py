"""The port's traced runs against the JAX package's
(``tests/test_obs_e2e.py``), on the CPU.

* **The elastic chain.**  One sweep of 4 LR candidates x 2 folds in which
  unit 2 loses its device on every attempt (retry budget 2, then
  quarantine).  The port's flight kinds equal the JAX package's less
  ``elastic.mesh_shrinks``: the JAX sweep runs on a mesh of the
  conftest's 8 virtual devices and shrinks it, the port has one card,
  no mesh and no CPU rung.  Every elastic event links to the
  ``sweep.unit[2]`` span, and two runs give the same sequence.
* **The traced capstone.**  A 400-row chunked train (``chunk_rows=64``)
  with one injected device loss, in both packages: the multisets of
  (span name, category, parent's name) are equal (no difference to
  name), the Chrome export validates with no dropped span, and a stage
  profile's ``hlo`` holds the kernel mix, aten ops on the CPU.  In core
  with the plan's pool on, the pool threads' stage spans nest under their
  layer's span, and only serial stages carry a kernel mix.  The ledger
  books the sweep's metric copy (``sweep.final``) and the elastic counts;
  a halving ladder gives one ``sweep.rung[i]`` span a rung and books its
  promotions under ``halving.promote``.
* **Serving.**  ``serve.admit`` -> ``serve.batch`` -> ``serve.execute``
  nest across the submitting and dispatch threads (the JAX package's
  batch span is a root: the port hands the dispatch thread its parent);
  ``/metrics?format=prometheus`` parses and its request count is the
  JSON snapshot's.
* **Flight events at their sites.**  Checkpoint saves and resumes,
  breaker transitions, drift windows and triggers, the ledger's
  ``serving.batch`` and ``seg_hist`` launch tags.
"""
import json
import os
import threading
from collections import Counter
from http.client import HTTPConnection

import numpy as np
import pandas as pd
import pytest
import torch

import transmogrifai_tpu_torch as tt
from transmogrifai_tpu import obs as jobs
from transmogrifai_tpu.utils import faults as jfaults
from transmogrifai_tpu_torch import obs
from transmogrifai_tpu_torch.utils import faults as tfaults
from transmogrifai_tpu_torch.utils import profiling as tprof

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tt.set_device("cpu")
    yield
    torch.set_num_threads(threads)
    # the JAX capstone compiled its programs in this worker: drop them, so
    # that a later JAX test in the same worker that captures the HLO of its
    # compilations (tests/test_obs_e2e.py's capstone) sees them compile
    import jax

    jax.clear_caches()


@pytest.fixture(autouse=True)
def _clean_tracing():
    obs.stop_trace()
    jobs.stop_trace()
    tfaults.install_faults(None)
    yield
    obs.stop_trace()
    jobs.stop_trace()
    tfaults.install_faults(None)


def _subsequence(haystack, needles):
    it = iter(haystack)
    return all(any(n == h for h in it) for n in needles)


# ---------------------------------------------------------------------------
# the elastic chain
# ---------------------------------------------------------------------------

def _toy(n=240, d=10, seed=5):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    beta = rng.normal(size=d) * (rng.random(d) < 0.6)
    y = (1 / (1 + np.exp(-(X @ beta))) > rng.random(n)).astype(np.float32)
    return X, y


def _elastic_chain(port: bool):
    """One sweep whose unit 2 loses its device on every attempt; returns
    (tracer, elastic context, results)."""
    if port:
        from transmogrifai_tpu_torch.models.classification import \
            OpLogisticRegression as LR
        from transmogrifai_tpu_torch.selector.model_selector import (
            ModelSelector, grid)
        from transmogrifai_tpu_torch.selector.validators import \
            OpCrossValidation
        pkg, fl = obs, tfaults
    else:
        from transmogrifai_tpu.models import OpLogisticRegression as LR
        from transmogrifai_tpu.selector.model_selector import (
            ModelSelector, grid)
        from transmogrifai_tpu.selector.validators import OpCrossValidation
        pkg, fl = jobs, jfaults
    X, y = _toy()
    sel = ModelSelector(
        models_and_params=[(LR(), grid(reg_param=[0.001, 0.01, 0.1, 1.0],
                                       elastic_net_param=[0.0]))],
        problem_type="binary",
        validator=OpCrossValidation(num_folds=2, stratify=True))
    if port:
        ctx = sel._elastic_context(len(y), X.shape[1], 4, "cpu")
        Xv = torch.from_numpy(X)
    else:
        from transmogrifai_tpu.parallel import make_sweep_mesh

        sel = sel.with_mesh(make_sweep_mesh(4, n_devices=8))
        ctx = sel._elastic_context(len(y), X.shape[1], 4)
        Xv = X
    cands = sel._candidates(with_groups=False)
    tracer = pkg.start_trace("elastic-chain")
    try:
        with fl.inject(fl.FaultSpec(point="device.loss",
                                    action="device_loss", at=2, times=3)):
            _, results = sel.validator.validate(
                cands, Xv, y, np.ones(len(y), np.float32),
                eval_fn=sel._metric, metric_name=sel.validation_metric,
                larger_better=sel.larger_better, elastic=ctx)
    finally:
        pkg.stop_trace()
    return tracer, ctx, results


@pytest.fixture(scope="module")
def jax_chain():
    return _elastic_chain(port=False)[0].flight.kinds()


def test_elastic_chain_equals_jax_less_mesh_shrinks(jax_chain):
    tracer, ctx, results = _elastic_chain(port=True)
    kinds = tracer.flight.kinds()
    assert "elastic.mesh_shrinks" in jax_chain
    assert kinds == [k for k in jax_chain if k != "elastic.mesh_shrinks"]
    assert _subsequence(kinds, [
        "fault.fired", "elastic.device_losses", "elastic.retries",
        "fault.fired", "elastic.device_losses", "elastic.retries",
        "fault.fired", "elastic.device_losses", "elastic.quarantined"])
    assert ctx.counters.device_losses == 3 and ctx.counters.quarantined == 1
    assert "device_loss" in results[2].error
    assert sum(r.error is None for r in results) == 3
    units = {s.span_id: s for s in tracer.snapshot()
             if s.name.startswith("sweep.unit")}
    for e in tracer.flight.events("elastic."):
        assert units[e["spanId"]].name == "sweep.unit[2]", e
    sp = next(s for s in units.values() if s.name == "sweep.unit[2]")
    assert sp.attrs["retries"] == 2 and sp.attrs["watchdog_retries"] == 0
    assert sp.attrs["mesh"] == sp.attrs["mesh_after"] == ""
    [run] = [s for s in tracer.snapshot() if s.name == "sweep.run"]
    assert run.attrs["elastic"]["deviceLosses"] == 3


def test_elastic_chain_is_seed_deterministic(jax_chain):
    a = _elastic_chain(port=True)[0].flight.kinds()
    b = _elastic_chain(port=True)[0].flight.kinds()
    assert a == b


# ---------------------------------------------------------------------------
# the traced capstone
# ---------------------------------------------------------------------------

def _frame(rows=400, seed=9):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        "Survived": (rng.random(rows) > 0.62).astype(float),
        "Sex": rng.choice(["male", "female"], rows, p=[0.65, 0.35]),
        "Age": rng.normal(30, 13, rows).clip(0.4, 95),
        "Fare": rng.lognormal(3.0, 1.0, rows)})


def _capstone(port: bool):
    if port:
        from transmogrifai_tpu_torch.features.builder import FeatureBuilder
        from transmogrifai_tpu_torch.models.classification import \
            OpLogisticRegression
        from transmogrifai_tpu_torch.ops.transmogrify import transmogrify
        from transmogrifai_tpu_torch.preparators.sanity_checker import \
            SanityChecker
        from transmogrifai_tpu_torch.selector.model_selector import (
            BinaryClassificationModelSelector, grid)
        from transmogrifai_tpu_torch.workflow.workflow import OpWorkflow
        pkg, fl = obs, tfaults
    else:
        from transmogrifai_tpu import FeatureBuilder, OpWorkflow, transmogrify
        from transmogrifai_tpu.models import OpLogisticRegression
        from transmogrifai_tpu.preparators import SanityChecker
        from transmogrifai_tpu.selector import (
            BinaryClassificationModelSelector, grid)
        pkg, fl = jobs, jfaults
    survived = FeatureBuilder.RealNN("Survived").as_response()
    feats = transmogrify([FeatureBuilder.PickList("Sex").as_predictor(),
                          FeatureBuilder.Real("Age").as_predictor(),
                          FeatureBuilder.Real("Fare").as_predictor()])
    checked = SanityChecker(max_correlation=0.99).set_input(
        survived, feats).get_output()
    selector = BinaryClassificationModelSelector.with_cross_validation(
        num_folds=2, models_and_parameters=[
            (OpLogisticRegression(), grid(reg_param=[0.01, 0.1]))])
    pred = selector.set_input(survived, checked).get_output()
    wf = OpWorkflow().set_result_features(pred).set_input_data(_frame())
    tracer = pkg.start_trace("capstone")
    try:
        with fl.inject(fl.FaultSpec(point="device.loss",
                                    action="device_loss", at=0, times=1)):
            model = wf.train(profile=True, chunk_rows=64)
    finally:
        pkg.stop_trace()
    return tracer, model


def _tree(tracer):
    spans = tracer.snapshot()
    by_id = {s.span_id: s for s in spans}
    return Counter((s.name, s.cat, by_id[s.parent_id].name
                    if s.parent_id in by_id else None) for s in spans)


@pytest.mark.filterwarnings("ignore:grid group")
def test_capstone_span_tree_equals_jax():
    tprof.reset_counters()
    tracer, model = _capstone(port=True)
    ledger = tprof.COUNTERS.to_json()
    tprof.reset_counters()
    jtracer, _ = _capstone(port=False)
    assert _tree(tracer) == _tree(jtracer)
    assert {"workflow", "ingest", "plan", "stage", "sweep"} <= \
        {s.cat for s in tracer.snapshot()}
    assert tracer.flight.kinds() == jtracer.flight.kinds()
    assert _subsequence(tracer.flight.kinds(), [
        "fault.fired", "elastic.device_losses", "elastic.retries"])
    mixes = [sp.hlo for sp in model.train_profile.stages if sp.hlo]
    assert mixes and all(m["programs"] == sum(m["ops"].values())
                         and all(k.startswith("aten::") for k in m["ops"])
                         for m in mixes)
    assert any("hlo" in sp.to_json() for sp in model.train_profile.stages)
    doc = obs.to_chrome_trace(tracer)
    assert obs.validate_chrome_trace(doc) == []
    assert doc["otherData"]["droppedSpans"] == 0
    assert "workflow.train" in obs.trace_summary(doc)
    # the sweep's one metric copy, booked as the final drain
    assert ledger["fetches"] >= 1 and "sweep.final" in ledger["drainTags"]
    assert ledger["elastic"] == {"device_losses": 1, "retries": 1}


def test_halving_rungs_and_promotion_are_traced():
    """A halving ladder of LR candidates (rung sizes from min_rows=64):
    one ``sweep.rung[i]`` span a rung, each over its ``sweep.run``, and
    each rung's promotion booked as a drain under ``halving.promote``."""
    from transmogrifai_tpu_torch.models.classification import \
        OpLogisticRegression
    from transmogrifai_tpu_torch.selector.model_selector import (
        ModelSelector, grid)
    from transmogrifai_tpu_torch.selector.validators import \
        OpCrossValidation
    from transmogrifai_tpu_torch.tuning import halving as th

    X, y = _toy(n=600)
    sel = ModelSelector(
        models_and_params=[(OpLogisticRegression(), grid(
            reg_param=[0.001, 0.01, 0.1, 0.3, 1.0, 3.0]))],
        problem_type="binary",
        validator=OpCrossValidation(num_folds=2, stratify=True))
    tprof.reset_counters()
    with obs.tracing("halving") as tracer:
        _, _, sched = th.halving_validate(
            sel.validator, sel._candidates(with_groups=False),
            torch.from_numpy(X), y, np.ones(len(y), np.float32),
            eval_fn=sel._metric, metric_name="AuPR", larger_better=True,
            config=th.HalvingConfig(min_rows=64))
    ledger = tprof.COUNTERS.to_json()
    tprof.reset_counters()
    spans = tracer.snapshot()
    by_id = {s.span_id: s for s in spans}
    rungs = [s for s in spans if s.name.startswith("sweep.rung[")]
    assert len(rungs) == len(sched["rungs"]) > 1
    for s in spans:
        if s.name == "sweep.run":
            assert by_id[s.parent_id].name.startswith("sweep.rung[")
    promotions = len(rungs) - 1
    assert ledger["drainTags"].get("halving.promote") is not None
    assert ledger["fetches"] >= promotions


def test_pool_stages_nest_under_their_layer(monkeypatch):
    """In core, with the plan's pool on at any size: the host stages of a
    layer run on pool threads, their spans under the layer's span, and
    only the serial stages carry a kernel mix."""
    from transmogrifai_tpu_torch.workflow import plan as tplan

    monkeypatch.setattr(tplan, "_PARALLEL_ROW_THRESHOLD", 0)
    monkeypatch.setenv("TMOG_PLAN_WORKERS", "2")
    tracer, model = _capstone_in_core()
    spans = tracer.snapshot()
    by_id = {s.span_id: s for s in spans}
    pooled = [s for s in spans if s.thread.startswith("tmog-plan")]
    assert pooled and all(s.name.startswith("stage:") for s in pooled)
    for s in pooled:
        parent = by_id[s.parent_id]
        assert parent.name.startswith("plan.layer[")
        assert parent.attrs["stages"] > 1 and parent.thread != s.thread
    profiles = {p.uid: p for p in model.train_profile.stages}
    for s in pooled:
        assert profiles[s.attrs["uid"]].hlo == {}
    assert profiles[next(s.attrs["uid"] for s in spans
                         if s.name == "stage:ModelSelector")].hlo


def _capstone_in_core():
    from transmogrifai_tpu_torch.features.builder import FeatureBuilder
    from transmogrifai_tpu_torch.models.classification import \
        OpLogisticRegression
    from transmogrifai_tpu_torch.ops.transmogrify import transmogrify
    from transmogrifai_tpu_torch.selector.model_selector import (
        BinaryClassificationModelSelector, grid)
    from transmogrifai_tpu_torch.workflow.workflow import OpWorkflow

    survived = FeatureBuilder.RealNN("Survived").as_response()
    feats = transmogrify([FeatureBuilder.PickList("Sex").as_predictor(),
                          FeatureBuilder.Real("Age").as_predictor(),
                          FeatureBuilder.Real("Fare").as_predictor()])
    selector = BinaryClassificationModelSelector.with_cross_validation(
        num_folds=2, models_and_parameters=[
            (OpLogisticRegression(), grid(reg_param=[0.1]))])
    pred = selector.set_input(survived, feats).get_output()
    wf = OpWorkflow().set_result_features(pred).set_input_data(_frame())
    with obs.tracing("in-core") as tracer:
        model = wf.train(profile=True)
    return tracer, model


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.fixture()
def server():
    import csv

    from transmogrifai_tpu_torch.serving import ModelServer

    with open(os.path.join(FIXTURES, "model_v1_input.csv")) as f:
        rows = [{"x": float(r["x"]), "cat": r["cat"]}
                for r in csv.DictReader(f)]
    srv = ModelServer.from_path(os.path.join(FIXTURES, "model_v1"),
                                name="m", max_batch=8, max_latency_ms=2.0,
                                warmup_row=dict(rows[0]))
    with srv:
        yield srv, rows


def test_serving_spans_nest_across_threads(server):
    srv, rows = server
    tprof.reset_counters()
    tracer = obs.start_trace("serve")
    try:
        for r in rows[:20]:
            out = srv.score([r])
            assert "ShedResult" not in type(out[0]).__name__
    finally:
        obs.stop_trace()
    spans = tracer.snapshot()
    by_id = {s.span_id: s for s in spans}
    admits = [s for s in spans if s.name == "serve.admit"]
    batches = [s for s in spans if s.name == "serve.batch"]
    execs = [s for s in spans if s.name == "serve.execute"]
    assert len(admits) == 20 and len(batches) == len(execs) == 20
    assert all(s.attrs["outcome"] == "admitted" for s in admits)
    for b in batches:
        assert by_id[b.parent_id].name == "serve.admit"
        assert b.thread != by_id[b.parent_id].thread
    for e in execs:
        assert by_id[e.parent_id].name == "serve.batch"
        assert e.attrs["path"] == "device" and e.attrs["bucket"] == 1
    assert tprof.COUNTERS.launch_tags["serving.batch"] >= 20
    tprof.reset_counters()


def test_metrics_endpoint_serves_prometheus(server):
    from transmogrifai_tpu_torch.serving.http import make_http_server

    srv, rows = server
    for r in rows[:5]:
        srv.score([r])
    httpd = make_http_server(srv, port=0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        conn = HTTPConnection("127.0.0.1", httpd.server_address[1],
                              timeout=30)
        conn.request("GET", "/metrics")
        r = conn.getresponse()
        assert r.status == 200
        assert "application/json" in r.getheader("Content-Type")
        snap = json.loads(r.read())
        conn.request("GET", "/metrics?format=prometheus")
        r = conn.getresponse()
        assert r.status == 200
        assert "text/plain" in r.getheader("Content-Type")
        samples = obs.parse_exposition(r.read().decode())
        conn.close()
    finally:
        httpd.shutdown()
        httpd.server_close()
    t.join(timeout=30)
    assert samples["tmog_serving_requests_total"] == snap["requests"] >= 5
    assert samples["tmog_serving_batches_total"] == snap["batches"]


# ---------------------------------------------------------------------------
# flight events at their sites
# ---------------------------------------------------------------------------

def test_checkpoint_breaker_and_drift_events(tmp_path):
    from transmogrifai_tpu_torch.serving import drift as tdrift
    from transmogrifai_tpu_torch.serving.admission import CircuitBreaker
    from transmogrifai_tpu_torch.workflow.checkpoint import \
        SweepCheckpointManager

    tracer = obs.start_trace("sites")
    try:
        fp = {"logical": {"k": 1}, "mesh": None}
        m = SweepCheckpointManager(str(tmp_path / "ck"), fp)
        m.record_unit(0, [0.5, 0.6], None)
        SweepCheckpointManager(str(tmp_path / "ck"), fp).load()
        br = CircuitBreaker(failure_threshold=2, reset_after_s=0.0)
        br.record_failure()
        assert br.record_failure()
        assert br.allow_device()          # the half-open trial
        br.record_success()
        base = {"x": {"kind": "categorical", "n": 100.0,
                      "values": ["a", "b"], "counts": np.array([50., 50.])}}
        mon = tdrift.DriftMonitor(base, tdrift.DriftConfig(min_rows=10))
        mon.observe_rows([{"x": "a"}, {"x": "b"}] * 5)
        mon.observe_rows([{"x": "c"}] * 10)
    finally:
        obs.stop_trace()
    assert tracer.flight.kinds() == [
        "checkpoint.save", "checkpoint.resume", "breaker.open",
        "breaker.half_open", "breaker.closed", "drift.window",
        "drift.window", "drift.trigger"]
    save, resume = tracer.flight.events("checkpoint.")
    assert save["attrs"]["sweep"] and resume["attrs"]["units"] == 1
    windows = tracer.flight.events("drift.window")
    assert [w["attrs"]["drifted"] for w in windows] == [False, True]
    assert windows[1]["attrs"]["features"] == ["x"]


def test_seg_hist_launches_are_tagged(monkeypatch):
    from transmogrifai_tpu_torch.models import gbdt_kernels as tk

    tprof.reset_counters()
    before = tk.seg_level_hists.launches
    binned = torch.zeros((64, 4), dtype=torch.uint8)
    ch = torch.ones((64, 2), dtype=torch.float32)
    slot = torch.zeros(64, dtype=torch.int32)
    tk.seg_level_hists(binned, slot, ch, 1, 4)   # the CPU: plain version
    assert tk.seg_level_hists.launches == before
    assert "seg_hist" not in tprof.COUNTERS.launch_tags
    tprof.reset_counters()
