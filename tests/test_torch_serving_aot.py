"""The port's per-bucket scoring programs (``serving/aot.py``), their store
(``utils/compile_cache.AOTStore``) and the bucketed executor against the
JAX package's (``tests/test_serving_v2.py``), on the CPU.

* The store: the same operations on both packages' stores give the same
  answers (a round trip, a corrupted payload, a mismatched or truncated
  sidecar, the probe, no temp file left).
* Each family's scoring spec (binary and softmax logistic regression,
  LinearSVC, naive Bayes, linear regression, the selected model) against
  ``jax.jit(spec.fn)`` of the JAX model with the same parameters: the
  parameters bitwise, float outputs within 1e-6 (absolute, or relative
  past 1: float32 sums in another order), the prediction equal away from
  ties; trees and isotonic have no spec in either package.  Each spec
  scores bitwise as its model's eager ``predict_batch``.
* The key: equal parameters digest equally in both packages; another
  parameter, bucket or backend changes the key.
* An exported program ("jit") and the same program read back from the
  store ("aot") score bitwise alike, and as the eager path does; a
  corrupted entry re-exports and heals.  ``max_batch`` 2 keeps exports
  few.  (On the card a bucket is a CUDA graph: ``test_torch_kernels_cuda.py``.)
* The executor: warm-up largest first, a bucket the store satisfies skips
  its warm run, a failed first run stays cold; compiles and hits.
* The device-program server, and the breaker's host rung, which bypasses
  the programs.
"""
import json
import os
import threading
import time

import jax
import numpy as np
import pytest
import torch

import transmogrifai_tpu_torch as tt
from transmogrifai_tpu.models import classification as jcls
from transmogrifai_tpu.models import regression as jreg
from transmogrifai_tpu.selector.model_selector import \
    SelectedModel as JSelected
from transmogrifai_tpu.serving import aot as jaot
from transmogrifai_tpu.utils.compile_cache import AOTStore as JStore
from transmogrifai_tpu_torch.local import load_model_local
from transmogrifai_tpu_torch.local.scorer import score_function_batch
from transmogrifai_tpu_torch.models import classification as tcls
from transmogrifai_tpu_torch.models import regression as treg
from transmogrifai_tpu_torch.selector.model_selector import SelectedModel
from transmogrifai_tpu_torch.serving import (AOTStore, BucketedExecutor,
                                             ModelServer, scoring_digest)
from transmogrifai_tpu_torch.serving import aot as taot
from transmogrifai_tpu_torch.utils import compile_cache

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
MODEL_V1 = os.path.join(FIXTURES, "model_v1")
D, K, N = 6, 3, 16


@pytest.fixture(autouse=True)
def _cpu():
    tt.set_device("cpu")


@pytest.fixture(scope="module")
def rows():
    import csv

    with open(os.path.join(FIXTURES, "model_v1_input.csv")) as f:
        return [{"label": float(r["label"]), "x": float(r["x"]),
                 "cat": r["cat"]} for r in csv.DictReader(f)]


def _params(seed: int = 0):
    rng = np.random.default_rng(seed)
    return {"coef": rng.normal(size=D).astype(np.float32),
            "icpt": float(rng.normal()),
            "coefK": rng.normal(size=(K, D)).astype(np.float32),
            "icptK": rng.normal(size=K).astype(np.float32),
            "prior": np.log(np.array([0.2, 0.3, 0.5], np.float32)),
            "lik": np.log(rng.dirichlet(np.ones(D), size=K)).astype(
                np.float32),
            "X": rng.normal(size=(N, D)).astype(np.float32)}


def _pair(family: str, p):
    """(JAX model, port model) of ``family`` with the same parameters."""
    if family == "logreg.binary":
        return (jcls.LogisticRegressionModel(p["coef"].tolist(), p["icpt"]),
                tcls.LogisticRegressionModel(p["coef"], p["icpt"],
                                             device="cpu"))
    if family == "logreg.softmax":
        return (jcls.LogisticRegressionModel(p["coefK"].tolist(),
                                             p["icptK"].tolist()),
                tcls.LogisticRegressionModel(p["coefK"], p["icptK"],
                                             device="cpu"))
    if family == "linsvc":
        return (jcls.LinearSVCModel(p["coef"].tolist(), p["icpt"]),
                tcls.LinearSVCModel(p["coef"], p["icpt"], device="cpu"))
    if family == "naivebayes":
        return (jcls.NaiveBayesModel(p["prior"].tolist(), p["lik"].tolist()),
                tcls.NaiveBayesModel(p["prior"], p["lik"], device="cpu"))
    if family == "linreg":
        return (jreg.LinearRegressionModel(p["coef"].tolist(), p["icpt"]),
                treg.LinearRegressionModel(p["coef"], p["icpt"],
                                           device="cpu"))
    j, t = _pair("logreg.binary", p)   # the selected model
    return JSelected(j, best_name="lr"), SelectedModel(t, best_name="lr")


FAMILIES = ["logreg.binary", "logreg.softmax", "linsvc", "naivebayes",
            "linreg", "selected"]


def _lr():
    return tcls.LogisticRegressionModel(np.array([0.2, -0.1, 0.4]), 0.05,
                                        device="cpu")


# ---------------------------------------------------------------------------
# the store, beside the JAX package's
# ---------------------------------------------------------------------------

def _store_ops(store):
    """One sequence of store operations and what each returned."""
    out = {}
    store.put("k1", b"payload-bytes", {"backend": "cpu"})
    payload, meta = store.get("k1", expect={"backend": "cpu"})
    out["roundtrip"] = (payload, meta["bytes"], meta["backend"],
                        meta["formatVersion"])
    out["contains"] = (store.contains("k1", expect={"backend": "cpu"}),
                       store.contains("k1", expect={"backend": "gpu"}),
                       store.contains("nope"))
    out["mismatch"] = store.get("k1", expect={"backend": "gpu"})
    out["mismatch_dropped"] = "k1" not in store.keys()
    store.put("k2", b"payload-bytes", {})
    with open(store._paths("k2")[0], "wb") as f:
        f.write(b"garbage")
    out["corrupt"] = store.get("k2")
    out["corrupt_dropped"] = "k2" not in store.keys()
    store.put("k3", b"x", {})
    with open(store._paths("k3")[1], "w") as f:
        f.write('{"incomplete":')
    out["truncated_meta"] = store.get("k3")
    store.put("k4", b"x" * 1024, {})
    out["tmp_left"] = [n for n in os.listdir(store.root)
                       if n.endswith(".tmp")]
    out["stats"] = {k: v for k, v in store.stats().items() if k != "root"}
    return out


def test_store_behaves_as_the_jax_store(tmp_path):
    got = _store_ops(AOTStore(str(tmp_path / "port")))
    want = _store_ops(JStore(str(tmp_path / "jax")))
    assert got == want
    assert got["roundtrip"] == (b"payload-bytes", 13, "cpu", 1)
    assert got["contains"] == (True, False, False)
    assert got["mismatch"] is None and got["corrupt"] is None
    assert got["tmp_left"] == []


def test_default_store_dir(monkeypatch, tmp_path):
    monkeypatch.setenv("TMOG_AOT_CACHE_DIR", str(tmp_path))
    assert AOTStore().root == str(tmp_path)
    monkeypatch.delenv("TMOG_AOT_CACHE_DIR")
    assert compile_cache.default_aot_dir().endswith(
        os.path.join(".torch_cache", "aot"))


# ---------------------------------------------------------------------------
# the scoring specs against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", FAMILIES)
def test_spec_equals_jax(family):
    p = _params()
    jm, tm = _pair(family, p)
    js, ts = jm.aot_scoring_spec(), tm.aot_scoring_spec()
    assert ts.name == js.name and ts.outputs == js.outputs
    assert ts.n_features == js.n_features == D
    assert len(ts.params) == len(js.params)
    for a, b in zip(ts.params, js.params):
        b = np.asarray(b)
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape
        assert np.array_equal(a.numpy(), b)   # bitwise
    assert taot.model_params_digest(ts) == jaot.model_params_digest(js)
    want = jax.jit(js.fn)(p["X"], *js.params)
    got = ts.fn(torch.from_numpy(p["X"]), *ts.params)
    assert len(got) == len(want) == len(ts.outputs)
    for name, g, w in zip(ts.outputs, got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
        if name == "prediction":
            continue
        # float32 sums in another order: 1e-6 absolute, or relative to
        # values past 1 (naive Bayes' log posteriors reach ~4)
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
    if ts.name == "linreg":   # the prediction is the float output
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   rtol=1e-6, atol=1e-6)
        return
    # the prediction away from ties (a margin or class gap over 1e-5)
    raw = np.asarray(want[1])
    if raw.shape[1] > 2:
        top = np.sort(raw, axis=1)
        clear = top[:, -1] - top[:, -2] > 1e-5
    else:
        clear = np.abs(raw[:, 1]) > 1e-5
    assert clear.sum() >= N - 1
    assert np.array_equal(got[0].numpy()[clear], np.asarray(want[0])[clear])


@pytest.mark.parametrize("family", FAMILIES)
def test_spec_scores_as_the_eager_path(family):
    _, tm = _pair(family, _params(1))
    ts = tm.aot_scoring_spec()
    X = torch.from_numpy(_params(1)["X"])
    eager = tm.predict_batch(X)
    outs = dict(zip(ts.outputs, ts.fn(X, *ts.params)))
    assert torch.equal(outs["prediction"].to(torch.float64),
                       eager.prediction)
    for name, t in (("rawPrediction", eager.raw_prediction),
                    ("probability", eager.probability)):
        assert (name in outs) == (t is not None)
        if t is not None:
            assert torch.equal(outs[name], t)


def test_trees_and_isotonic_have_no_spec():
    iso = treg.IsotonicRegressionModel([0.0, 1.0], [0.0, 1.0], device="cpu")
    assert iso.aot_scoring_spec() is None
    assert taot.program_set_for(iso) is None
    assert taot.program_set_for(load_model_local(MODEL_V1)) is not None


def test_scoring_digest():
    a, b = _lr().aot_scoring_spec(), _lr().aot_scoring_spec()
    c = tcls.LogisticRegressionModel(np.array([0.2, -0.1, 0.5]), 0.05,
                                     device="cpu").aot_scoring_spec()
    assert scoring_digest(a, 8, "cpu") == scoring_digest(b, 8, "cpu")
    assert scoring_digest(a, 8, "cpu") != scoring_digest(c, 8, "cpu")
    assert scoring_digest(a, 8, "cpu") != scoring_digest(a, 16, "cpu")
    assert scoring_digest(a, 8, "cpu") != scoring_digest(a, 8, "gpu")
    assert scoring_digest(a, 8, "cpu").startswith("logreg_binary-b8-")


# ---------------------------------------------------------------------------
# program sets: export, load, heal
# ---------------------------------------------------------------------------

def test_jit_then_aot_bitwise(tmp_path):
    store = AOTStore(str(tmp_path / "aot"))
    X = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 3)).astype(np.float32))
    compile_cache.reset_cache_stats()
    ps1 = taot.program_set_for(_lr(), store=store, cache_key_prefix="p1")
    assert ps1.ensure_bucket(2) == "jit"
    assert ps1.ensure_bucket(2) == "jit"   # once per bucket
    out1 = ps1.predict(X)
    ps2 = taot.program_set_for(_lr(), store=store, cache_key_prefix="p2")
    assert ps2.cached_in_store(2)
    assert ps2.ensure_bucket(2) == "aot"
    out2 = ps2.predict(X)
    eager = _lr().predict_batch(X)
    for a, b in ((out1, out2), (out1, eager)):
        assert torch.equal(a.prediction, b.prediction)
        assert torch.equal(a.raw_prediction, b.raw_prediction)
        assert torch.equal(a.probability, b.probability)
    assert out1.prediction.dtype == torch.float64
    stats = compile_cache.cache_stats()["totals"]
    assert (stats["compiles"], stats["aotMisses"], stats["aotLoads"]) == \
        (1, 1, 1)
    assert ps1.replays == {2: 1} and set(ps1.seconds[2]) == {
        "export_s", "capture_s"}
    assert set(ps2.seconds[2]) == {"load_s", "capture_s"}
    # an unknown shape or width is not served by a program
    assert ps2.predict(torch.zeros(1, 3)) is None
    assert ps2.predict(torch.zeros(2, 5)) is None
    ps2.release()
    assert ps2.predict(X) is None and ps2.model._serving_programs is None


def test_concurrent_callers_build_a_bucket_once(monkeypatch):
    # a swap's warm-up and the dispatch thread reaching one cold bucket at
    # once: one export (one capture on the card), both see its mode
    real = torch.export.export
    exports = []

    def slow_export(*args, **kwargs):
        exports.append(1)
        time.sleep(0.2)
        return real(*args, **kwargs)

    monkeypatch.setattr(torch.export, "export", slow_export)
    compile_cache.reset_cache_stats()
    ps = taot.program_set_for(_lr(), cache_key_prefix="race")
    barrier = threading.Barrier(2)
    modes = []

    def build():
        barrier.wait()
        modes.append(ps.ensure_bucket(2))

    threads = [threading.Thread(target=build) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert modes == ["jit", "jit"] and len(exports) == 1
    assert compile_cache.cache_stats()["totals"]["compiles"] == 1


def test_concurrent_first_runs_count_one_compile():
    def score_fn(batch_rows):
        time.sleep(0.1)
        return [{"s": 0.0} for _ in batch_rows]

    compile_cache.reset_cache_stats()
    ex = BucketedExecutor(score_fn, max_batch=2, cache_key_prefix="first")
    barrier = threading.Barrier(2)

    def run():
        barrier.wait()
        ex.score([{"x": 1.0}, {"x": 2.0}])

    threads = [threading.Thread(target=run) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    totals = compile_cache.cache_stats()["totals"]
    assert (totals["compiles"], totals["hits"]) == (1, 1)
    assert ex.warm_buckets == [2] and ex.runs == {2: 2}


def test_corrupted_entry_exports_again_and_heals(tmp_path):
    store = AOTStore(str(tmp_path / "aot"))
    ps1 = taot.program_set_for(_lr(), store=store)
    ps1.ensure_bucket(1)
    key = scoring_digest(ps1.spec, 1, ps1.backend)
    with open(store._paths(key)[0], "ab") as f:
        f.write(b"trailing-corruption")
    assert taot.program_set_for(_lr(), store=store).ensure_bucket(1) == "jit"
    assert taot.program_set_for(_lr(), store=store).ensure_bucket(1) == "aot"


def test_device_scoring_context_gates_the_route(tmp_path):
    m = _lr()
    ps = taot.program_set_for(m)
    ps.ensure_bucket(2)
    from transmogrifai_tpu_torch.types.columns import FeatureColumn
    from transmogrifai_tpu_torch.types import feature_types as ftypes

    col = FeatureColumn(ftypes.OPVector, torch.zeros(2, 3))
    m.transform_columns(None, col)
    assert ps.replays[2] == 0          # outside the context: eager
    with taot.device_scoring():
        assert taot.device_scoring_active()
        m.transform_columns(None, col)
    assert not taot.device_scoring_active()
    assert ps.replays[2] == 1


# ---------------------------------------------------------------------------
# the executor
# ---------------------------------------------------------------------------

def test_warmup_is_largest_first(rows):
    srv = ModelServer.from_path(MODEL_V1, name="wo", max_batch=8,
                                warmup_row=dict(rows[0]))
    ex = srv._executor_for(srv.registry.get("wo"))
    seen = []
    orig = ex._run_bucket

    def spy(padded, bucket):
        seen.append(bucket)
        return orig(padded, bucket)

    ex._run_bucket = spy
    ex.warmup(dict(rows[0]))
    assert seen == [8, 4, 2, 1]


def test_aot_satisfied_buckets_skip_warm_run(tmp_path):
    store = AOTStore(str(tmp_path / "aot"))
    pre = taot.program_set_for(_lr(), store=store, cache_key_prefix="pre")
    for b in (1, 2):
        pre.ensure_bucket(b)
    calls = []

    def score_fn(batch_rows):
        calls.append(len(batch_rows))
        return [{"s": 0.0} for _ in batch_rows]

    ex = BucketedExecutor(score_fn, max_batch=2, model=_lr(),
                          aot_store=store, device_programs=True,
                          cache_key_prefix="skip")
    timings = ex.warmup({"x": 1.0})
    assert calls == [] and sorted(timings) == [1, 2]
    assert ex.programs.modes == {1: "aot", 2: "aot"}
    assert ex.warm_buckets == [1, 2]


def test_failed_warm_run_stays_cold():
    boom = {"on": True}

    def score_fn(batch_rows):
        if boom["on"]:
            raise RuntimeError("transient warm-run failure")
        return [{"s": 0.0} for _ in batch_rows]

    compile_cache.reset_cache_stats()
    ex = BucketedExecutor(score_fn, max_batch=2, model=_lr(),
                          device_programs=True, cache_key_prefix="coldfail",
                          min_bucket=2)
    assert ex.buckets == [2]
    with pytest.raises(RuntimeError):
        ex.warmup({"x": 1.0})
    assert ex.warm_buckets == [] and ex.runs == {}
    assert compile_cache.cache_stats()["compiles"] == {
        "coldfail.aot.bucket2": 1}
    boom["on"] = False
    ex.warmup({"x": 1.0})
    ex.score([{"x": 1.0}])
    stats = compile_cache.cache_stats()
    assert ex.warm_buckets == [2]
    assert stats["compiles"]["coldfail.bucket2"] == 1
    assert stats["hits"] == {"coldfail.bucket2": 1}


# ---------------------------------------------------------------------------
# the device-program server
# ---------------------------------------------------------------------------

def test_device_program_server_jit_then_aot(rows, tmp_path):
    aot_dir = str(tmp_path / "aot")
    expected = score_function_batch(load_model_local(MODEL_V1))(rows)
    compile_cache.reset_cache_stats()
    srv1 = ModelServer.from_path(MODEL_V1, name="dev1", max_batch=2,
                                 warmup_row=dict(rows[0]),
                                 device_programs=True, aot_store=aot_dir)
    with srv1:
        after_warmup = compile_cache.cache_stats()["totals"]
        out1 = [m for i in range(0, len(rows), 2)
                for m in srv1.score(rows[i:i + 2])]
        snap1 = srv1.snapshot()
    assert snap1["aotPrograms"] == {1: "jit", 2: "jit"}
    assert snap1["compileCache"]["totals"]["compiles"] == \
        after_warmup["compiles"] == 4   # 2 exports + 2 first runs
    assert snap1["compileCache"]["totals"]["hits"] == len(rows) // 2
    ex = srv1._executor_for(srv1.registry.get("dev1"))
    assert ex.programs.replays == {1: 1, 2: 1 + len(rows) // 2}
    assert out1 == expected   # the programs score as the eager path
    compile_cache.reset_cache_stats()
    srv2 = ModelServer.from_path(MODEL_V1, name="dev2", max_batch=2,
                                 warmup_row=dict(rows[0]),
                                 device_programs=True,
                                 aot_store=AOTStore(aot_dir))
    with srv2:
        out2 = srv2.score(rows[:3])
        snap2 = srv2.snapshot()
    assert snap2["aotPrograms"] == {1: "aot", 2: "aot"}
    assert snap2["compileCache"]["totals"]["compiles"] == 0
    assert json.dumps(out2, sort_keys=True) == json.dumps(
        out1[:3], sort_keys=True)


def test_breaker_host_rung_bypasses_device_programs(rows, tmp_path):
    srv = ModelServer.from_path(MODEL_V1, name="devbrk", max_batch=2,
                                failure_threshold=1, breaker_reset_s=60.0,
                                warmup_row=dict(rows[0]),
                                device_programs=True,
                                aot_store=str(tmp_path / "aot"))
    expected = score_function_batch(load_model_local(MODEL_V1))(rows[:2])
    with srv:
        ex = srv._executor_for(srv.registry.get("devbrk"))
        replays = dict(ex.programs.replays)

        def boom(_rows):
            raise RuntimeError("injected")

        ex.score_fn = boom
        assert srv.score(rows[:2]) == expected   # the host rung
        assert srv.score(rows[:2]) == expected   # breaker open
        snap = srv.snapshot()
        assert snap["breakerState"] == "open"
        assert snap["hostFallbacks"] == 2
        assert ex.programs.replays == replays     # no program ran


def test_stale_version_releases_its_programs(rows):
    srv = ModelServer.from_path(MODEL_V1, name="rel", max_batch=2,
                                warmup_row=dict(rows[0]),
                                device_programs=True)
    with srv:
        old = srv._executor_for(srv.registry.get("rel"))
        assert old.programs.buckets == [1, 2]
        srv.swap(MODEL_V1)   # the listener warms v2, v1's programs go
        assert old.programs.buckets == []
        new = srv._executor_for(srv.registry.get("rel"))
        assert new.programs.buckets == [1, 2]
        assert srv.score(rows[:2])[0]
