"""The port's serving subsystem (``transmogrifai_tpu_torch.serving``) on the
CPU, mirroring ``tests/test_serving.py``: the bucket ladder, served scores
equal to the unpadded local scorer (bitwise: one device, row-independent
stages), empty requests, warm buckets, the breaker state machine,
queue-full sheds, deadlines, coalescing, requests never split, hot swaps,
the registry's generations, pin and rollback, concurrent single-row
requests, the snapshot's shape and HTTP on an ephemeral port.

The degradation ladder is the JAX package's: a batch whose device scoring
raises is answered by the host rung (the model's CPU copy), counted in
``deviceErrors``, ``hostFallbacks`` and ``breakerOpens`` with the reason
in ``lastFallbackReason``, and while the breaker is open every batch goes
to the host rung without a device attempt; a half-open trial closes it
again.  The JAX package's ``ModelServer`` and the port's serve one saved
artifact to the same keys, values within 1e-6.  The per-bucket programs,
the guarded swap and tenancy are in ``test_torch_serving_aot.py``,
``test_torch_guarded.py`` and ``test_torch_tenancy.py``.
"""
import csv
import json
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from urllib.error import HTTPError
from urllib.request import Request, urlopen

import numpy as np
import pytest

import transmogrifai_tpu_torch as tt
from transmogrifai_tpu_torch.features.builder import FeatureBuilder
from transmogrifai_tpu_torch.local import load_model_local
from transmogrifai_tpu_torch.local.scorer import score_function_batch
from transmogrifai_tpu_torch.models.classification import OpLogisticRegression
from transmogrifai_tpu_torch.ops.dsl_transformers import MathScalarTransformer
from transmogrifai_tpu_torch.ops.transmogrify import transmogrify
from transmogrifai_tpu_torch.serving import (AdmissionController,
                                             CircuitBreaker, MicroBatcher,
                                             ModelRegistry, ModelServer,
                                             ShedResult, bucket_for,
                                             bucket_sizes)
from transmogrifai_tpu_torch.serving.executor import BucketedExecutor
from transmogrifai_tpu_torch.serving.http import make_http_server
from transmogrifai_tpu_torch.workflow.workflow import OpWorkflow

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
MODEL_V1 = os.path.join(FIXTURES, "model_v1")


@pytest.fixture(autouse=True)
def _cpu():
    tt.set_device("cpu")


@pytest.fixture(scope="module")
def rows():
    with open(os.path.join(FIXTURES, "model_v1_input.csv")) as f:
        return [{"label": float(r["label"]), "x": float(r["x"]),
                 "cat": r["cat"]} for r in csv.DictReader(f)]


@pytest.fixture(scope="module")
def expected(rows):
    tt.set_device("cpu")
    return score_function_batch(load_model_local(MODEL_V1))(rows)


@pytest.fixture()
def server(rows):
    srv = ModelServer.from_path(MODEL_V1, name="m", max_batch=8,
                                max_latency_ms=2.0, warmup_row=dict(rows[0]))
    with srv:
        yield srv


class TestBucketMath:
    def test_bucket_ladder(self):
        assert bucket_sizes(64) == [1, 2, 4, 8, 16, 32, 64]
        assert bucket_sizes(48) == [1, 2, 4, 8, 16, 32, 48]
        assert bucket_sizes(1) == [1]

    def test_bucket_for(self):
        buckets = bucket_sizes(64)
        assert bucket_for(1, buckets) == 1
        assert bucket_for(3, buckets) == 4
        assert bucket_for(33, buckets) == 64
        with pytest.raises(ValueError):
            bucket_for(65, buckets)


class TestServingParity:
    def test_served_scores_equal_unpadded_scorer(self, server, rows,
                                                 expected):
        sizes = (1, 3, 5, 7, 8, 2)   # buckets 1, 4, 8, 8, 8, 2
        got, i, k = [], 0, 0
        while i < len(rows):
            size = sizes[k % len(sizes)]
            got.extend(server.score(rows[i:i + size]))
            i += size
            k += 1
        assert got == expected

    def test_empty_request(self, server):
        assert server.score([]) == []

    def test_windowed_mode_serves_the_same(self, rows, expected):
        srv = ModelServer.from_path(MODEL_V1, name="w", max_batch=4,
                                    max_latency_ms=1.0, batch_mode="windowed")
        with srv:
            assert srv.score(rows[:6]) == expected[:6]


class TestWarmBuckets:
    def test_warmup_runs_every_bucket_once(self, rows):
        srv = ModelServer.from_path(MODEL_V1, name="warm", max_batch=8,
                                    max_latency_ms=1.0,
                                    warmup_row=dict(rows[0]))
        with srv:
            ex = srv._executor_for(srv.registry.get("warm"))
            assert ex.warm_buckets == [1, 2, 4, 8]
            assert ex.runs == {1: 1, 2: 1, 4: 1, 8: 1}
            for _ in range(5):   # steady state at one bucket
                srv.score(rows[:8])
            assert ex.runs == {1: 1, 2: 1, 4: 1, 8: 6}

    def test_failed_first_run_stays_cold(self):
        def boom(_rows):
            raise RuntimeError("injected")

        ex = BucketedExecutor(boom, max_batch=4)
        with pytest.raises(RuntimeError):
            ex.score([{"x": 1.0}])
        assert ex.warm_buckets == [] and ex.runs == {}


class _Halver(MathScalarTransformer):
    """A user's own stage: a class with no row in the persistence map."""

    def __init__(self, uid=None):
        super().__init__("divide", 2.0, uid=uid)


def _small_model(stage_kind: str):
    """A two-column LR trained on the CPU whose x0 comes through a lambda
    extractor ("lambda") or a stage of a class with no persistence row
    ("unmapped")."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(120, 2))
    y = (x[:, 0] + 0.5 * x[:, 1] + rng.normal(scale=0.3, size=120)) > 0
    data = [{"x0": float(a), "x1": float(b), "label": float(c)}
            for (a, b), c in zip(x, y)]
    label = FeatureBuilder.RealNN("label").as_response()
    x1 = FeatureBuilder.Real("x1").as_predictor()
    if stage_kind == "lambda":
        x0 = FeatureBuilder.Real("x0").extract(
            lambda r: r["x0"]).as_predictor()
    else:
        x0 = FeatureBuilder.Real("x0").as_predictor().transform_with(
            _Halver())
    pred = label.transform_with(OpLogisticRegression(),
                                transmogrify([x0, x1]))
    wf = OpWorkflow().set_result_features(pred).set_input_data(data)
    if stage_kind == "lambda":
        wf.allow_non_serializable()
    return wf.train(), [{k: v for k, v in r.items() if k != "label"}
                        for r in data[:4]]


class TestHostCopy:
    """Which model gets which host rung: the model itself on the CPU, no
    rung for a model off the CPU that would not come back whole from a
    save and load (it would be served a stubbed copy)."""

    @pytest.mark.parametrize("kind", ["lambda", "unmapped"])
    def test_model_on_the_cpu_is_its_own_host_copy(self, kind):
        model, _ = _small_model(kind)
        entry = ModelRegistry().register("m", model)
        assert entry.host_scorer is entry.scorer
        assert entry.host_unavailable is None

    @pytest.mark.parametrize("kind,why", [
        ("lambda", "extract_fn"), ("unmapped", "_Halver")])
    def test_model_that_cannot_round_trip_gets_no_host_rung(
            self, kind, why, monkeypatch):
        from transmogrifai_tpu_torch.serving import registry as reg

        model, req = _small_model(kind)
        expected = score_function_batch(model)(req)
        # as for a model on the card: its copy would take the round trip
        monkeypatch.setattr(reg, "_on_cpu", lambda model, device: False)
        with pytest.warns(UserWarning, match="no host rung"):
            srv = ModelServer(ModelRegistry(), "m", max_batch=4,
                              max_latency_ms=1.0, failure_threshold=1,
                              breaker_reset_s=60.0)
            entry = srv.registry.register("m", model)
        assert entry.host_scorer is None
        assert why in entry.host_unavailable
        with srv:
            assert srv.score(req) == expected   # it still serves
            executor = srv._executor_for(entry)

            def boom(_rows):
                raise RuntimeError("injected device failure")

            executor.score_fn = boom
            # a device error fails the batch, as it did with no rung
            with pytest.raises(RuntimeError, match="injected"):
                srv.score(req)
            with pytest.raises(RuntimeError, match="no host rung"):
                srv.score(req)   # the breaker is open
            snap = srv.snapshot()
            assert snap["hostFallbacks"] == 0
            assert snap["deviceErrors"] == 1

    def test_in_memory_model_off_the_cpu_takes_the_round_trip(
            self, monkeypatch):
        from transmogrifai_tpu_torch.serving import registry as reg

        model = load_model_local(MODEL_V1)
        monkeypatch.setattr(reg, "_on_cpu", lambda model, device: False)
        entry = ModelRegistry().register("m", model)
        assert entry.host_scorer is not entry.scorer
        assert entry.host_unavailable is None


class TestDeviceErrors:
    def test_device_failure_falls_back_to_host_path(self, rows, expected):
        srv = ModelServer.from_path(MODEL_V1, name="deg", max_batch=4,
                                    max_latency_ms=1.0, failure_threshold=1,
                                    breaker_reset_s=60.0,
                                    warmup_row=dict(rows[0]))
        with srv:
            executor = srv._executor_for(srv.registry.get("deg"))

            def boom(_rows):
                raise RuntimeError("injected device failure")

            executor.score_fn = boom
            assert srv.score(rows[:4]) == expected[:4]   # answered
            snap = srv.snapshot()
            assert snap["deviceErrors"] == 1
            assert snap["hostFallbacks"] == 1
            assert snap["breakerOpens"] == 1
            assert snap["breakerState"] == "open"
            assert snap["lastFallbackReason"] == "device_error:RuntimeError"
            assert snap["lastDeviceError"] == (
                "RuntimeError: injected device failure")
            # while open: no device attempt, the host rung answers; an
            # open breaker degrades, it does not shed
            assert srv.score(rows[:2]) == expected[:2]
            snap = srv.snapshot()
            assert snap["deviceErrors"] == 1
            assert snap["hostFallbacks"] == 2
            assert snap["lastFallbackReason"] == "breaker_open"
            assert snap["shed"] == 0

    def test_breaker_half_open_recovers(self, rows, expected):
        srv = ModelServer.from_path(MODEL_V1, name="rec", max_batch=4,
                                    max_latency_ms=1.0, failure_threshold=1,
                                    breaker_reset_s=0.05,
                                    warmup_row=dict(rows[0]))
        with srv:
            executor = srv._executor_for(srv.registry.get("rec"))
            good = executor.score_fn

            def boom(_rows):
                raise RuntimeError("injected")

            executor.score_fn = boom
            assert srv.score(rows[:2]) == expected[:2]   # the host rung
            assert srv.breaker.state == "open"
            executor.score_fn = good
            time.sleep(0.06)   # cooldown -> half-open trial
            assert srv.score(rows[:2]) == expected[:2]
            assert srv.breaker.state == "closed"

    def test_circuit_breaker_state_machine(self):
        br = CircuitBreaker(failure_threshold=2, reset_after_s=0.05)
        assert br.allow_device() and br.state == "closed"
        br.record_failure()
        assert br.state == "closed"
        assert br.record_failure() is True
        assert br.state == "open" and not br.allow_device()
        time.sleep(0.06)
        assert br.state == "half_open"
        assert br.allow_device() is True   # exactly one trial
        assert br.allow_device() is False
        br.record_success()
        assert br.state == "closed"


class TestBackpressure:
    def test_queue_full_sheds_structured_503(self):
        admission = AdmissionController(max_queue_rows=4)
        batcher = MicroBatcher(lambda rows: rows, max_batch=4,
                               admission=admission)
        batcher.submit([{"i": 1}, {"i": 2}, {"i": 3}, {"i": 4}])
        shed = batcher.submit([{"i": 5}, {"i": 6}]).result(timeout=1)
        assert len(shed) == 2
        assert all(isinstance(s, ShedResult) for s in shed)
        assert shed[0].status == 503 and shed[0].reason == "queue_full"
        assert shed[0].to_json()["status"] == 503
        assert batcher.metrics.shed == 2
        batcher.close(drain=False)

    def test_deadline_expired_while_queued(self):
        def slow(rows):
            time.sleep(0.05)
            return rows

        batcher = MicroBatcher(slow, max_batch=2, max_latency_ms=1.0)
        batcher.start()
        try:
            f1 = batcher.submit([{"i": 1}, {"i": 2}])
            f2 = batcher.submit([{"i": 3}], timeout_ms=5.0)
            assert f1.result(timeout=2) == [{"i": 1}, {"i": 2}]
            res = f2.result(timeout=2)
            assert isinstance(res[0], ShedResult)
            assert res[0].reason == "deadline_expired"
            assert batcher.metrics.deadline_expired == 1
        finally:
            batcher.close(drain=False)

    def test_admission_rows_released_after_batch(self):
        batcher = MicroBatcher(lambda rows: rows, max_batch=8,
                               admission=AdmissionController(max_queue_rows=8))
        batcher.start()
        try:
            for _ in range(5):
                out = batcher.submit([{"i": k} for k in range(8)])
                assert not isinstance(out.result(timeout=2)[0], ShedResult)
        finally:
            batcher.close()

    def test_close_sheds_new_submits(self):
        batcher = MicroBatcher(lambda rows: rows, max_batch=4).start()
        batcher.close()
        (res,) = batcher.submit([{"i": 1}]).result(timeout=1)
        assert res.reason == "shutting_down"


class TestBatcherCoalescing:
    def test_queued_requests_coalesce_into_one_batch(self):
        executed = []
        batcher = MicroBatcher(
            lambda rows: executed.append(len(rows)) or list(rows),
            max_batch=16, max_latency_ms=1.0)
        futures = [batcher.submit([{"i": i}]) for i in range(6)]
        batcher.start()
        try:
            results = [f.result(timeout=2) for f in futures]
            assert [r[0]["i"] for r in results] == list(range(6))
            assert executed == [6]
        finally:
            batcher.close()

    def test_requests_never_split_across_batches(self):
        executed = []
        batcher = MicroBatcher(
            lambda rows: executed.append(len(rows)) or list(rows),
            max_batch=4, max_latency_ms=1.0)
        f1 = batcher.submit([{"i": 0}, {"i": 1}, {"i": 2}])
        f2 = batcher.submit([{"i": 3}, {"i": 4}])
        batcher.start()
        try:
            assert len(f1.result(timeout=2)) == 3
            assert len(f2.result(timeout=2)) == 2
            assert executed == [3, 2]
        finally:
            batcher.close()


class TestRegistry:
    def test_hot_swap_versions_and_listener(self, rows):
        reg = ModelRegistry()
        swaps = []
        reg.on_swap(swaps.append)
        e1 = reg.load("m", MODEL_V1)
        assert e1.version == 1 and reg.get("m") is e1
        assert swaps == []
        e2 = reg.load("m", MODEL_V1)
        assert e2.version == 2 and reg.get("m") is e2
        assert [e.version for e in swaps] == [2]
        assert e2.scorer(rows[:2]) == e1.scorer(rows[:2])

    def test_evict_and_missing(self):
        reg = ModelRegistry()
        reg.load("m", MODEL_V1)
        assert reg.evict("m") is True
        assert reg.evict("m") is False
        with pytest.raises(KeyError, match="no model 'm'"):
            reg.get("m")
        assert reg.maybe_get("m") is None

    def test_server_hot_swap_rewarms_and_serves(self, rows, expected):
        srv = ModelServer.from_path(MODEL_V1, name="swap", max_batch=4,
                                    max_latency_ms=1.0,
                                    warmup_row=dict(rows[0]))
        with srv:
            assert srv.score(rows[:4]) == expected[:4]
            srv.swap(MODEL_V1)
            entry = srv.registry.get("swap")
            assert entry.version == 2
            # the swap listener warmed v2's buckets before traffic
            assert srv._executor_for(entry).warm_buckets == [1, 2, 4]
            assert srv.score(rows[:4]) == expected[:4]
            assert srv.snapshot()["hotSwaps"] == 1

    def test_registered_in_memory_model(self):
        reg = ModelRegistry()
        entry = reg.register("mem", load_model_local(MODEL_V1))
        assert entry.path is None and entry.version == 1
        assert reg.models()[0]["name"] == "mem"

    def test_generation_history_bounded(self):
        reg = ModelRegistry(max_generations=2)
        m = load_model_local(MODEL_V1)
        for _ in range(4):
            reg.register("m", m)
        gens = reg.generations("m")
        assert [g["version"] for g in gens] == [3, 4]
        assert gens[-1]["current"] is True

    def test_eviction_never_drops_pinned_generation(self):
        reg = ModelRegistry(max_generations=2)
        m = load_model_local(MODEL_V1)
        reg.register("m", m)
        assert reg.pin("m").version == 1
        for _ in range(5):
            reg.register("m", m)
        versions = [g["version"] for g in reg.generations("m")]
        assert 1 in versions and len(versions) <= 3
        assert reg.pinned("m").version == 1

    def test_rollback_restores_pinned_and_fires_listener(self, rows):
        reg = ModelRegistry()
        m = load_model_local(MODEL_V1)
        e1 = reg.register("m", m)
        reg.pin("m")
        reg.register("m", m)
        swaps = []
        reg.on_swap(swaps.append)
        back = reg.rollback("m")
        assert back is e1 and reg.get("m") is e1
        assert [e.version for e in swaps] == [1]
        assert back.scorer(rows[:2])

    def test_rollback_without_pin_raises(self):
        reg = ModelRegistry()
        reg.register("m", load_model_local(MODEL_V1))
        with pytest.raises(KeyError, match="no pinned"):
            reg.rollback("m")

    def test_evict_clears_pin(self):
        reg = ModelRegistry()
        reg.register("m", load_model_local(MODEL_V1))
        reg.pin("m")
        assert reg.evict("m") is True
        assert reg.pinned("m") is None


class TestConcurrentServing:
    def test_many_concurrent_single_row_requests(self, server, rows,
                                                 expected):
        def one(i):
            return server.score([rows[i % len(rows)]])[0]

        with ThreadPoolExecutor(max_workers=16) as pool:
            got = list(pool.map(one, range(64)))
        for i, g in enumerate(got):
            assert g == expected[i % len(rows)]
        snap = server.snapshot()
        assert snap["requests"] >= 64
        assert snap["batches"] < 64   # coalescing happened
        assert snap["latencyMs"]["p95"] is not None

    def test_bad_row_fails_only_its_own_request(self, rows, expected):
        srv = ModelServer.from_path(MODEL_V1, name="bad", max_batch=8,
                                    max_latency_ms=5.0, failure_threshold=1,
                                    warmup_row=dict(rows[0]))

        def one(i):
            if i % 4 == 0:
                with pytest.raises(TypeError, match="row 0 is 'int'"):
                    srv.score([1])
                return None
            return srv.score([rows[i % len(rows)]])[0]

        with srv, ThreadPoolExecutor(max_workers=16) as pool:
            got = list(pool.map(one, range(64)))
        for i, g in enumerate(got):
            if i % 4:
                assert g == expected[i % len(rows)]
        snap = srv.snapshot()
        assert snap["deviceErrors"] == 0
        assert snap["breakerOpens"] == 0
        assert snap["breakerState"] == "closed"
        assert snap["shed"] == 0


class TestServingMetricsSnapshot:
    def test_snapshot_shape(self, server, rows):
        server.score(rows[:3])
        snap = server.snapshot()
        for key in ("uptimeSecs", "queueDepth", "queueDepthPeak",
                    "requests", "rows", "batches", "paddedRows",
                    "batchSizeHistogram", "latencyMs", "latencyObservations",
                    "shed", "shedByReason", "deadlineExpired",
                    "deviceErrors", "hostFallbacks", "breakerOpens",
                    "hotSwaps", "lastFallbackReason", "lastFallbackAgeSecs",
                    "swapsAccepted", "swapsRejected", "rollbacks",
                    "compileCache", "model", "breakerState", "batchMode"):
            assert key in snap, key
        assert snap["model"]["name"] == "m"
        assert snap["hostFallbacks"] == 0
        json.dumps(snap, default=str)


class TestAttach:
    def test_drift_monitor_attaches(self):
        srv = ModelServer(ModelRegistry(), "m")
        monitor = object()   # its behaviour: tests/test_torch_drift.py
        assert srv.with_drift_monitor(monitor) is srv
        assert srv.drift_monitor is monitor


class TestHTTP:
    def test_http_endpoints(self, rows, expected):
        srv = ModelServer.from_path(MODEL_V1, name="h", max_batch=4,
                                    max_latency_ms=1.0,
                                    warmup_row=dict(rows[0]))
        try:
            httpd = make_http_server(srv, "127.0.0.1", 0)
        except OSError:   # pragma: no cover - no sockets in the sandbox
            pytest.skip("cannot bind a localhost socket")
        port = httpd.server_address[1]
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        base = f"http://127.0.0.1:{port}"

        def post(path, doc):
            req = Request(base + path, data=json.dumps(doc).encode(),
                          headers={"Content-Type": "application/json"})
            with urlopen(req, timeout=10) as resp:
                return json.loads(resp.read())

        try:
            with srv:
                assert post("/score", {"rows": rows[:3]})["scores"] == \
                    expected[:3]
                with pytest.raises(HTTPError) as err:
                    post("/score", {"rows": [1]})
                assert err.value.code == 400
                assert "row 0 is 'int'" in json.loads(
                    err.value.read())["error"]
                assert srv.snapshot()["deviceErrors"] == 0
                with urlopen(base + "/metrics", timeout=10) as resp:
                    assert json.loads(resp.read())["requests"] >= 1
                with urlopen(base + "/healthz", timeout=10) as resp:
                    health = json.loads(resp.read())
                assert health["status"] == "ok"
                assert health["breakerState"] == "closed"
                with pytest.raises(HTTPError) as err:
                    urlopen(base + "/nope", timeout=10)
                assert err.value.code == 404
                swapped = post("/swap", {"path": MODEL_V1})["swapped"]
                assert swapped["version"] == 2
                assert post("/drain", {}) == {"draining": True}
                with pytest.raises(HTTPError) as err:
                    post("/score", {"rows": rows[:1]})
                assert err.value.code == 503
                body = json.loads(err.value.read())
                assert body["scores"][0]["reason"] == "draining"
                with urlopen(base + "/healthz", timeout=10) as resp:
                    assert json.loads(resp.read())["status"] == "draining"
        finally:
            httpd.shutdown()
            httpd.server_close()


class TestAgainstJaxServer:
    def test_one_artifact_served_by_both(self, rows):
        from transmogrifai_tpu.serving import ModelServer as JModelServer

        jsrv = JModelServer.from_path(MODEL_V1, name="j", max_batch=8,
                                      max_latency_ms=1.0,
                                      warmup_row=dict(rows[0]))
        srv = ModelServer.from_path(MODEL_V1, name="p", max_batch=8,
                                    max_latency_ms=1.0,
                                    warmup_row=dict(rows[0]))
        with jsrv, srv:
            want = [m for i in range(0, len(rows), 3)
                    for m in jsrv.score(rows[i:i + 3])]
            got = [m for i in range(0, len(rows), 3)
                   for m in srv.score(rows[i:i + 3])]
        assert len(got) == len(want) == len(rows)
        for g, w in zip(got, want):
            assert list(g) == list(w)
            for name in g:
                assert list(g[name]) == list(w[name])
                for key in g[name]:
                    assert abs(g[name][key] - w[name][key]) <= 1e-6


@pytest.mark.parametrize("name", ["ServingFabric", "HashRing",
                                  "FleetSwapController"])
def test_fabric_names_its_item(name):
    import transmogrifai_tpu_torch.serving as serving

    with pytest.raises(NotImplementedError, match="6.6.6"):
        getattr(serving, name)
