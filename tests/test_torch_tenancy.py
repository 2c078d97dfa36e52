"""The port's multi-tenant server (``serving/tenancy.py``) against the JAX
package's, on the CPU, over the committed ``model_v1`` artifact.

* Routing: each tenant's scores equal the JAX server's for the same rows
  (within 1e-6) and the unpadded local scorer's (exactly); an unknown
  tenant, or none with two, is a ``KeyError``.
* A quota sheds only the offender (the server not started).
* Weighted-fair dequeue, deterministically: both lanes filled before any
  dispatch, then the dispatcher stepped batch by batch; the lane order and
  batch sizes equal the JAX dispatcher's for the same queues, and the
  dispatched rows follow the weights 3:1 (the JAX test floods for 1.2 s;
  only the card's smoke floods here).
* Isolation: a device fault on one tenant sends only that tenant's
  batches to the host rung; a rollback on one tenant leaves the other's
  generations; each tenant's drift monitor sees only its own rows;
  ``remove_tenant`` sheds the removed tenant's queue and evicts it.
* The Prometheus text with ``tenant`` labels equals the JAX package's for
  the same snapshots; over HTTP ``/tenants`` lists the tenants, the
  multi-tenant ``/healthz`` turns degraded with one tenant, ``/score``
  and ``/swap`` take a tenant.
* ``ServingCostLookup``'s three tiers (analytic, fitted ``Serving:batch``,
  measured EWMA) predict as the JAX lookup's for the same observations,
  and the batcher chooses the same bucket from them.
"""
import csv
import json
import os
import threading
from urllib.error import HTTPError
from urllib.request import Request, urlopen

import pytest

import transmogrifai_tpu_torch as tt
from transmogrifai_tpu.obs import prometheus as jprom
from transmogrifai_tpu.serving import MultiTenantServer as JMulti
from transmogrifai_tpu.serving import TenantConfig as JConfig
from transmogrifai_tpu.utils import profiling as jprof
from transmogrifai_tpu_torch.local import load_model_local
from transmogrifai_tpu_torch.local.scorer import score_function_batch
from transmogrifai_tpu_torch.obs import prometheus as tprom
from transmogrifai_tpu_torch.serving import (MultiTenantServer, ShedResult,
                                             TenantConfig)
from transmogrifai_tpu_torch.serving.http import healthz_doc, make_http_server
from transmogrifai_tpu_torch.utils import profiling as tprof

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


def _two(pkg_multi, pkg_config, **kw):
    mts = pkg_multi()
    mts.add_tenant(pkg_config("a", max_batch=8, **kw), path=MODEL_V1)
    mts.add_tenant(pkg_config("b", max_batch=8, **kw), path=MODEL_V1)
    return mts


def test_routing_equals_jax(rows, expected):
    mts, jmts = _two(MultiTenantServer, TenantConfig), _two(JMulti, JConfig)
    with mts, jmts:
        for tenant in ("a", "b"):
            got = mts.score(rows[:6], tenant=tenant)
            want = jmts.score(rows[:6], tenant=tenant)
            assert got == expected[:6]
            for g, w in zip(got, want):
                assert list(g) == list(w)
                for name in g:
                    assert list(g[name]) == list(w[name])
                    for k in g[name]:
                        assert abs(g[name][k] - w[name][k]) <= 1e-6
        with pytest.raises(KeyError):
            mts.score(rows[:1], tenant="nope")
        with pytest.raises(KeyError):
            mts.score(rows[:1])   # ambiguous with two tenants
        with pytest.raises(TypeError):
            mts.submit([1], tenant="a")
    single = MultiTenantServer()
    single.add_tenant("only", path=MODEL_V1)
    with single:
        assert single.score(rows[:2]) == expected[:2]


def test_quota_sheds_only_the_offender(rows):
    mts = MultiTenantServer()
    mts.add_tenant(TenantConfig("small", max_batch=4, max_queue_rows=4),
                   path=MODEL_V1)
    mts.add_tenant(TenantConfig("big", max_batch=4), path=MODEL_V1)
    mts.submit(rows[:4], tenant="small")   # not started: queues hold
    shed = mts.submit(rows[:2], tenant="small").result(timeout=1)
    assert isinstance(shed[0], ShedResult) and shed[0].reason == "queue_full"
    assert not mts.submit(rows[:2], tenant="big").done()
    assert mts.tenant("small").metrics.shed == 2
    assert mts.tenant("big").metrics.shed == 0
    mts.stop(drain=False)


def _fill(mts, rows, requests: int = 24):
    for _ in range(requests):
        for tenant in ("gold", "bronze"):
            mts.submit(rows[:2], tenant=tenant)


def _wfq(pkg_multi, pkg_config, rows):
    mts = pkg_multi()
    mts.add_tenant(pkg_config("gold", weight=3.0, max_batch=4,
                              max_queue_rows=64), path=MODEL_V1)
    mts.add_tenant(pkg_config("bronze", weight=1.0, max_batch=4,
                              max_queue_rows=64), path=MODEL_V1)
    _fill(mts, rows)
    return mts


def _step_jax(mts):
    """The JAX dispatcher's loop body, lock held (its source's order)."""
    lane = mts._pick_lane_locked()
    if lane is None:
        return None
    batch = mts._form_batch_locked(lane)
    n_rows = sum(len(p.rows) for p in batch)
    lane.vtime += n_rows / lane.config.weight
    lane.dispatched_rows += n_rows
    mts._vclock = max(mts._vclock, lane.vtime)
    return lane.config.name, n_rows


def _step_port(mts):
    lane = mts._pick_lane_locked()
    if lane is None:
        return None
    batch = mts._next_batch_locked(lane)
    return lane.config.name, sum(len(p.rows) for p in batch)


def test_weighted_fair_order_equals_jax(rows):
    orders = []
    for pkg_multi, pkg_config, step in ((MultiTenantServer, TenantConfig,
                                         _step_port),
                                        (JMulti, JConfig, _step_jax)):
        mts = _wfq(pkg_multi, pkg_config, rows)
        order = []
        with mts._work:
            while (got := step(mts)) is not None:
                order.append(got)
        orders.append(order)
        snap = mts.snapshot()["tenants"]
        mts.stop(drain=False)
    got, want = orders
    assert got == want
    assert sum(n for _, n in got) == 2 * 24 * 2
    # while both lanes are full, gold takes three rows to bronze's one
    saturated = got[:16]
    gold = sum(n for t, n in saturated if t == "gold")
    bronze = sum(n for t, n in saturated if t == "bronze")
    assert bronze > 0 and gold / bronze == 3.0
    assert snap["gold"]["wfq"]["dispatchedRows"] == 48


def test_idle_lane_is_clamped_to_the_virtual_clock(rows):
    mts = MultiTenantServer()
    mts.add_tenant(TenantConfig("a", max_batch=4), path=MODEL_V1)
    mts.add_tenant(TenantConfig("b", max_batch=4), path=MODEL_V1)
    for _ in range(4):
        mts.submit(rows[:4], tenant="a")
    with mts._work:
        while mts._pick_lane_locked() is not None:
            mts._next_batch_locked(mts._pick_lane_locked())
    assert mts._vclock == 16.0
    mts.submit(rows[:2], tenant="b")   # b re-enters with no hoarded credit
    assert mts._lanes["b"].vtime == 16.0
    mts.stop(drain=False)


def test_breaker_isolation_under_a_device_fault(rows, expected):
    mts = MultiTenantServer()
    mts.add_tenant(TenantConfig("a", max_batch=4, failure_threshold=1,
                                breaker_reset_s=60.0), path=MODEL_V1)
    mts.add_tenant(TenantConfig("b", max_batch=4), path=MODEL_V1)
    sa = mts.tenant("a")
    ex = sa._executor_for(sa.registry.get("a"))

    def boom(_rows):
        raise RuntimeError("injected device failure")

    ex.score_fn = boom
    with mts:
        assert mts.score(rows[:2], tenant="a") == expected[:2]   # host rung
        assert mts.score(rows[:2], tenant="b") == expected[:2]
        snap_a = mts.tenant("a").snapshot()
        snap_b = mts.tenant("b").snapshot()
        assert healthz_doc(mts)[1]["status"] == "degraded"
    assert snap_a["breakerState"] == "open"
    assert snap_a["deviceErrors"] == 1 and snap_a["hostFallbacks"] == 1
    assert snap_b["breakerState"] == "closed"
    assert (snap_b["deviceErrors"], snap_b["hostFallbacks"],
            snap_b["shed"]) == (0, 0, 0)
    assert mts.snapshot()["aggregate"]["hostFallbacks"] == 1


def test_rollback_isolation():
    mts = MultiTenantServer()
    mts.add_tenant(TenantConfig("a", max_batch=4), path=MODEL_V1)
    mts.add_tenant(TenantConfig("b", max_batch=4), path=MODEL_V1)
    reg = mts.registry
    reg.pin("b")
    mts.swap("b", MODEL_V1)
    a_before, a_gens = reg.get("a"), reg.generations("a")
    assert reg.get("b").version == 2
    assert reg.rollback("b").version == 1
    assert reg.get("a") is a_before and reg.generations("a") == a_gens
    assert mts.tenant("a").metrics.rollbacks == 0
    assert mts.tenant("a").metrics.hot_swaps == 0
    mts.stop(drain=False)


def test_drift_monitor_per_tenant(rows):
    class CountingMonitor:
        def __init__(self):
            self.rows_observed = 0

        def observe_rows(self, batch_rows):
            self.rows_observed += len(batch_rows)

        def snapshot(self):
            return {"rowsObserved": self.rows_observed}

    mts = _two(MultiTenantServer, TenantConfig)
    mon_a, mon_b = CountingMonitor(), CountingMonitor()
    mts.tenant("a").with_drift_monitor(mon_a)
    mts.tenant("b").with_drift_monitor(mon_b)
    with mts:
        mts.score(rows[:4], tenant="a")
        mts.score(rows[:2], tenant="a")
        snap = mts.snapshot()
    assert (mon_a.rows_observed, mon_b.rows_observed) == (6, 0)
    assert snap["tenants"]["a"]["drift"]["rowsObserved"] == 6
    assert snap["tenants"]["b"]["drift"]["rowsObserved"] == 0


def test_remove_tenant_sheds_and_evicts(rows):
    mts = MultiTenantServer()
    srv_x = mts.add_tenant(TenantConfig("x", max_batch=4), path=MODEL_V1)
    mts.add_tenant(TenantConfig("y", max_batch=4), path=MODEL_V1)
    fut = mts.submit(rows[:2], tenant="x")
    assert mts.remove_tenant("x") and not mts.remove_tenant("x")
    res = fut.result(timeout=1)
    assert isinstance(res[0], ShedResult)
    assert res[0].reason == "tenant_removed"
    assert srv_x.metrics.snapshot()["shed"] == 2
    assert mts.tenants() == ["y"] and mts.registry.maybe_get("x") is None
    mts.stop(drain=False)


def _counters(pkg_prof):
    c = pkg_prof.RunCounters()
    c.uploads, c.fetches, c.launches = 2, 3, 5
    return c


def test_prometheus_per_tenant_equals_jax(rows):
    mts = _two(MultiTenantServer, TenantConfig)
    with mts:
        mts.score(rows[:4], tenant="a")
        snaps = mts.tenant_snapshots()
    jmts = _two(JMulti, JConfig)
    with jmts:
        jmts.score(rows[:3], tenant="b")
        jsnaps = jmts.tenant_snapshots()
    for tenants in (snaps, jsnaps):
        for snap in tenants.values():
            snap["uptimeSecs"] = 1.5
            snap["lastFallbackAgeSecs"] = None
        text = tprom.prometheus_text(tenants=tenants,
                                     counters=_counters(tprof))
        assert text == jprom.prometheus_text(tenants=tenants,
                                             counters=_counters(jprof))
        parsed = tprom.parse_exposition(text)
        for name, snap in tenants.items():
            assert parsed[f'tmog_serving_requests_total{{tenant="{name}"}}'] \
                == snap["requests"]
    parsed = tprom.parse_exposition(tprom.prometheus_text(tenants=snaps))
    assert parsed['tmog_serving_rows_total{tenant="a"}'] == 4
    assert parsed['tmog_serving_rows_total{tenant="b"}'] == 0
    assert any(k.startswith("tmog_serving_batches_by_bucket_total{")
               and 'tenant="a"' in k for k in parsed)


def test_http_tenants_healthz_score_swap(rows, expected):
    mts = MultiTenantServer()
    mts.add_tenant(TenantConfig("gold", weight=3.0, max_batch=4,
                                failure_threshold=1, breaker_reset_s=60.0),
                   path=MODEL_V1)
    mts.add_tenant(TenantConfig("bronze", max_batch=4), path=MODEL_V1)
    try:
        httpd = make_http_server(mts, "127.0.0.1", 0)
    except OSError:   # pragma: no cover - no localhost sockets
        pytest.skip("cannot bind a localhost socket")
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def get(path):
        with urlopen(base + path, timeout=10) as resp:
            return resp.read().decode()

    def post(path, doc):
        req = Request(base + path, data=json.dumps(doc).encode(),
                      headers={"Content-Type": "application/json"})
        with urlopen(req, timeout=10) as resp:
            return json.loads(resp.read())

    try:
        with mts:
            assert post("/score", {"rows": rows[:3], "tenant": "gold"}) == {
                "scores": expected[:3]}
            with pytest.raises(HTTPError) as err:
                post("/score", {"rows": rows[:1], "tenant": "nope"})
            assert err.value.code == 404
            tenants = json.loads(get("/tenants"))["tenants"]
            assert [t["name"] for t in tenants] == ["bronze", "gold"]
            assert tenants[1]["weight"] == 3.0
            health = json.loads(get("/healthz"))
            assert health["status"] == "ok"
            assert set(health["tenants"]) == {"bronze", "gold"}
            prom = tprom.parse_exposition(get("/metrics?format=prometheus"))
            assert prom['tmog_serving_requests_total{tenant="gold"}'] == 1
            assert prom['tmog_serving_requests_total{tenant="bronze"}'] == 0
            swapped = post("/swap", {"tenant": "bronze", "path": MODEL_V1})
            assert swapped["swapped"]["version"] == 2
            gold = mts.tenant("gold")
            ex = gold._executor_for(gold.registry.get("gold"))

            def boom(_rows):
                raise RuntimeError("injected")

            ex.score_fn = boom
            assert post("/score", {"rows": rows[:2], "tenant": "gold"}) == {
                "scores": expected[:2]}   # the host rung answers
            health = json.loads(get("/healthz"))
            assert health["status"] == "degraded"
            assert health["tenants"]["gold"]["lastFallbackReason"] == \
                "device_error:RuntimeError"
            assert health["tenants"]["bronze"]["status"] == "ok"
    finally:
        httpd.shutdown()
        httpd.server_close()


# ---------------------------------------------------------------------------
# the serving cost lookup and the batcher's choice, beside the JAX package's
# ---------------------------------------------------------------------------

def _lookups(fitted: bool):
    from transmogrifai_tpu.tuning import costmodel as jcm
    from transmogrifai_tpu_torch.tuning import costmodel as tcm

    out = []
    for cm in (tcm, jcm):
        model = None
        if fitted:
            obs = [cm.StageObservation("Serving:batch", rows, 8, "float32",
                                       "cpu", 1e-4 + rows * 3e-5)
                   for rows in (1, 2, 4, 8, 16, 32, 64) for _ in range(2)]
            model = cm.CostModel().fit(obs)
        out.append(cm.ServingCostLookup(cost_model=model, cols=8))
    return out


@pytest.mark.parametrize("fitted", [False, True], ids=["analytic", "fitted"])
def test_cost_lookup_tiers_equal_jax(fitted):
    port, jax_ = _lookups(fitted)
    buckets = (1, 2, 4, 8, 16, 32, 64)
    want_source = "fitted" if fitted else "analytic"
    for lookup in (port, jax_):
        assert lookup.source(8) == want_source
    assert [port.predict_s(b) for b in buckets] == \
        [jax_.predict_s(b) for b in buckets]
    for b, secs in ((8, 0.01), (8, 0.02), (2, 0.004)):
        port.observe(b, secs)
        jax_.observe(b, secs)
    assert port.source(8) == jax_.source(8) == "measured"
    assert 0.01 < port.predict_s(8) < 0.02
    assert [port.predict_s(b) for b in buckets] == \
        [jax_.predict_s(b) for b in buckets]
    assert port.snapshot() == jax_.snapshot()


def test_batcher_bucket_choice_equals_jax():
    from transmogrifai_tpu.serving import MicroBatcher as JBatcher
    from transmogrifai_tpu.tuning.costmodel import \
        ServingCostLookup as JLookup
    from transmogrifai_tpu_torch.serving import MicroBatcher
    from transmogrifai_tpu_torch.tuning.costmodel import ServingCostLookup

    choices = []
    for batcher_cls, lookup_cls in ((MicroBatcher, ServingCostLookup),
                                    (JBatcher, JLookup)):
        lookup = lookup_cls()
        for _ in range(4):   # bucket 8 measured slow, bucket 4 cheap
            lookup.observe(8, 1.0)
            lookup.observe(4, 0.001)
        measured = batcher_cls(lambda rs: list(rs), max_batch=8,
                               cost_lookup=lookup)
        fresh = batcher_cls(lambda rs: list(rs), max_batch=8,
                            cost_lookup=lookup_cls())
        choices.append([measured._choose_bucket(q) for q in range(1, 9)]
                       + [fresh._choose_bucket(q) for q in range(1, 9)])
    assert choices[0] == choices[1]
    assert choices[0][7] == 4 and choices[0][15] == 8
