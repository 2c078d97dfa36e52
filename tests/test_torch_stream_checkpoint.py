"""Checkpoint and resume of the chunked train
(``OpWorkflow.train(chunk_rows=k, checkpoint_dir=d)``,
``workflow/checkpoint.py``) in the port, on the CPU, against the JAX
package's on the same numpy-seeded inputs (``chip_smoke.titanic_columns``
rows written to CSV and Parquet under ``tmp_path``).

Checked, after ``tests/test_resilience.py``'s recovery matrix:
 * the state codec: each streaming estimator's state taken through
   export, encode, strict JSON, decode and import halfway through its
   fit gives the uninterrupted model exactly (and the JAX package's
   uninterrupted streaming model: the same vocabularies, fills and keep
   lists; naive Bayes's float64 sums of float32 products within 1e-9);
   the sampled SanityChecker's generator continues; ``TextStats.to_state``
   equals the JAX package's key for key;
 * the manager: saves are atomic, old npz generations go, ``finish``
   removes the checkpoint; a checkpoint of another run (another
   ``chunk_rows``) raises ``CheckpointMismatchError`` naming the key;
 * the in-core path: a DAG without a selector raises the JAX package's
   ``ValueError``, a selector's sweep checkpoint is routed and removed;
 * crash and resume: an in-process ``raise`` at ``reader.chunk`` 7 with
   saves every 2 chunks resumes past 6 chunks (CSV and Parquet sources)
   with the same vocabularies and keep lists and bitwise the same
   probabilities, which match the JAX package's chunked train within
   1e-4 (naive Bayes's streamed float32 sums, ROADMAP's "streamed naive
   Bayes sums": 1.3e-5 apart on these rows); a crash at
   ``stage.transform`` in the fused pass resumes from the pass boundary;
   a SIGKILL at ``checkpoint.barrier`` in a child process resumes to the
   uninterrupted model.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import transmogrifai_tpu.native
import transmogrifai_tpu_torch as tt
from test_torch_out_of_core import JAX, PORT, _bench_ingest_dag, _by_class
from transmogrifai_tpu.ops import vectorizers as jv
from transmogrifai_tpu.preparators import sanity_checker as jsc
from transmogrifai_tpu.readers.files import CSVReader as JCSVReader
from transmogrifai_tpu.workflow.workflow import OpWorkflow as JWorkflow
from transmogrifai_tpu_torch.models.classification import (
    OpLogisticRegression, OpNaiveBayes)
from transmogrifai_tpu_torch.ops import vectorizers as tv
from transmogrifai_tpu_torch.preparators import sanity_checker as tsc
from transmogrifai_tpu_torch.readers.files import CSVReader, ParquetReader
from transmogrifai_tpu_torch.selector.model_selector import (
    BinaryClassificationModelSelector, grid)
from transmogrifai_tpu_torch.utils import faults
from transmogrifai_tpu_torch.workflow import checkpoint as ck
from transmogrifai_tpu_torch.workflow.persistence import _ArrayStore
from transmogrifai_tpu_torch.workflow.workflow import OpWorkflow

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

N_TRAIN, N_HOLD = 600, 200
CHUNK = 32
PROBA_TOL_JAX = 1e-4


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    tt.set_device("cpu")
    monkeypatch.setattr(transmogrifai_tpu.native, "AVAILABLE", False)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckpt_data")
    cols, _ = chip_smoke.titanic_columns(N_TRAIN + N_HOLD)
    paths = {"csv": str(tmp / "train.csv"), "hold": str(tmp / "hold.csv"),
             "parquet": str(tmp / "train.parquet")}
    chip_smoke.write_ooc_csv(paths["csv"], cols, 0, N_TRAIN)
    chip_smoke.write_ooc_csv(paths["hold"], cols, N_TRAIN, N_TRAIN + N_HOLD)
    pq.write_table(pa.table({k: pa.array(list(v[:N_TRAIN]))
                             for k, v in cols.items()}), paths["parquet"])
    return paths


def _reader(files, source):
    return (CSVReader(files["csv"]) if source == "csv"
            else ParquetReader(files["parquet"]))


def _train(files, source="csv", **kw):
    """The port's bench_ingest DAG trained chunked: (model, holdout
    probabilities)."""
    pred = _bench_ingest_dag(PORT)
    model = OpWorkflow().set_result_features(pred).set_reader(
        _reader(files, source)).train(chunk_rows=CHUNK, **kw)
    hold = CSVReader(files["hold"]).generate_dataset(model.raw_features())
    return model, model.score(hold)[pred.name].values.probability.numpy()


def _params(model):
    return {"vocabs": [m.vocabs for m in _by_class(
                model, "OneHotVectorizerModel")],
            "text": [[m.strategies, m.vocabs] for m in _by_class(
                model, "SmartTextVectorizerModel")],
            "fills": [m.fills for m in _by_class(
                model, "RealVectorizerModel")],
            "keep": [m.keep_indices for m in _by_class(
                model, "SanityCheckerModel")]}


@pytest.fixture(scope="module")
def uninterrupted(files):
    tt.set_device("cpu")
    return _train(files)


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------

def _roundtrip(est, state):
    """export -> encode -> strict JSON -> decode -> import."""
    store = _ArrayStore()
    payload = ck.encode_fit_state(est.export_fit_state(state), "s", store)
    payload = json.loads(json.dumps(payload))
    return est.import_fit_state(ck.decode_fit_state(payload, store.arrays))


def _streamed(pkg, make, ds, roundtrip):
    """Fit ``make()`` over ``ds`` in 37-row chunks, the state through the
    codec halfway (port only)."""
    est = make(pkg)
    chunks = [ds.slice(a, min(a + 37, len(ds)))
              for a in range(0, len(ds), 37)]
    state = est.begin_fit()
    for i, c in enumerate(chunks):
        if roundtrip and i == len(chunks) // 2:
            state = _roundtrip(est, state)
        state = est.update_chunk(state, c, *[c[n] for n in est.input_names])
    return est.adopt_model(est.finish_fit(state))


def _vector_data(pkg, n=400, seed=6):
    """(label, vector) features and a dataset: four noise columns, two
    indicator columns of a group, one leaking column."""
    rng = np.random.default_rng(seed)
    y = (rng.random(n) > 0.5).astype(np.float64)
    X = np.concatenate([rng.normal(0, 1, (n, 4)),
                        (rng.random((n, 2)) < 0.3).astype(np.float64),
                        y[:, None] + rng.normal(0, 1e-4, (n, 1))],
                       axis=1).astype(np.float32)
    vm = pkg["vmeta"]
    meta = ([vm[0]("num", "Real", descriptor_value=f"d{i}")
             for i in range(4)]
            + [vm[0]("cat", "PickList", grouping="cat",
                     indicator_value=f"v{i}") for i in range(2)]
            + [vm[0]("leak", "Real", descriptor_value="leak")])
    label = pkg["fb"].RealNN("label").as_response()
    vec = pkg["fb"].OPVector("features").as_predictor()
    ds = pkg["ds"]({"label": pkg["col"].from_values(pkg["ft"].RealNN, y),
                    "features": pkg["col"](pkg["ft"].OPVector, X,
                                           vmeta=vm[1]("features", meta))})
    return (label, vec), ds


def _raw_data(pkg, n=400, seed=4):
    rng = np.random.default_rng(seed)
    fb, t, col = pkg["fb"], pkg["ft"], pkg["col"]
    raw = {
        "c": ("PickList", [None if rng.random() < 0.15 else
                           f"v{int(rng.integers(30))}" for _ in range(n)]),
        "x": ("Real", np.where(rng.random(n) < 0.2, np.nan,
                               rng.normal(50, 9, n))),
        "i": ("Integral", [None if rng.random() < 0.1 else
                           int(rng.integers(0, 7)) for _ in range(n)]),
        "low": ("Text", [f"cat{int(rng.integers(8))}" for _ in range(n)]),
        "high": ("Text", [f"free text {int(rng.integers(10000))}"
                          for _ in range(n)]),
        "m": ("MultiPickList", [set(rng.choice(["a", "b", "c", "d"],
                                               int(rng.integers(0, 3))))
                                for _ in range(n)]),
    }
    feats = {k: getattr(fb, tn)(k).as_predictor() for k, (tn, _) in
             raw.items()}
    ds = pkg["ds"]({k: col.from_values(getattr(t, tn), v)
                    for k, (tn, v) in raw.items()})
    return feats, ds


def _pkg(p, vec_mod, checker_mod):
    from transmogrifai_tpu.ops import vector_metadata as jvm
    from transmogrifai_tpu_torch.ops import vector_metadata as tvm

    vm = jvm if p is JAX else tvm
    return dict(p, v=vec_mod, sc=checker_mod,
                vmeta=(vm.VectorColumnMetadata, vm.VectorMetadata))


JPKG, TPKG = _pkg(JAX, jv, jsc), _pkg(PORT, tv, tsc)

#: (id, estimator maker, the model's compared attributes)
CODEC = [
    ("one_hot_topk", lambda p, f: p["v"].OneHotVectorizer(
        top_k=10, min_support=2).set_input(f["c"]), ("vocabs",)),
    ("real_welford_histogram", lambda p, f: p["v"].RealVectorizer()
     .set_input(f["x"]), ("fills",)),
    ("integral_mode_counts", lambda p, f: p["v"].IntegralVectorizer()
     .set_input(f["i"]), ("fills",)),
    ("smart_text_stats", lambda p, f: p["v"].SmartTextVectorizer(
        max_cardinality=50, min_support=2).set_input(f["low"], f["high"]),
     ("strategies", "vocabs")),
    ("multi_pick_list_topk", lambda p, f: p["v"].MultiPickListVectorizer(
        min_support=2).set_input(f["m"]), ("vocabs",)),
]


@pytest.mark.parametrize("make,attrs", [c[1:] for c in CODEC],
                         ids=[c[0] for c in CODEC])
def test_codec_roundtrip_mid_fit_gives_the_uninterrupted_model(make, attrs):
    jf, jds = _raw_data(JPKG)
    tf, tds = _raw_data(TPKG)
    m_jax = _streamed(JPKG, lambda p: make(p, jf), jds, False)
    m0 = _streamed(TPKG, lambda p: make(p, tf), tds, False)
    m1 = _streamed(TPKG, lambda p: make(p, tf), tds, True)
    for a in attrs:
        assert getattr(m1, a) == getattr(m0, a) == getattr(m_jax, a), a
    base0, base1 = (m.metadata.get("drift_baseline") for m in (m0, m1))
    assert json.dumps(base0, default=repr) == json.dumps(base1,
                                                         default=repr)


@pytest.mark.parametrize("case", ["sampled_checker", "min_variance",
                                  "naive_bayes"])
def test_codec_roundtrip_of_vector_estimators(case):
    (jl, jvec), jds = _vector_data(JPKG)
    (tl, tvec), tds = _vector_data(TPKG)
    if case == "sampled_checker":
        def make(p, lab, vec):
            return p["sc"].SanityChecker(max_correlation=0.95,
                                         check_sample=0.8,
                                         sample_seed=11).set_input(lab, vec)
    elif case == "min_variance":
        def make(p, lab, vec):
            return p["sc"].MinVarianceFilter().set_input(lab, vec)
    else:
        from transmogrifai_tpu.models.classification import OpNaiveBayes \
            as JNB

        def make(p, lab, vec):
            return (JNB() if p is JPKG else OpNaiveBayes()).set_input(lab,
                                                                    vec)
    m_jax = _streamed(JPKG, lambda p: make(p, jl, jvec), jds, False)
    m0 = _streamed(TPKG, lambda p: make(p, tl, tvec), tds, False)
    m1 = _streamed(TPKG, lambda p: make(p, tl, tvec), tds, True)
    if case == "naive_bayes":
        for a in ("log_prior", "log_lik"):
            v0, v1 = (getattr(m, a).numpy() for m in (m0, m1))
            np.testing.assert_array_equal(v1, v0)
            np.testing.assert_allclose(v0, np.asarray(getattr(m_jax, a)),
                                       rtol=0, atol=1e-9)
        return
    assert m1.keep_indices == m0.keep_indices == m_jax.keep_indices
    if case == "sampled_checker":
        s0, s1, sj = (m.metadata["summary"] for m in (m0, m1, m_jax))
        assert s0["dropped"] == s1["dropped"] == sj["dropped"]
        for c0, c1, cj in zip(s0["columnStats"], s1["columnStats"],
                              sj["columnStats"]):
            assert c1["mean"] == c0["mean"] == cj["mean"]
            assert c1["corr_label"] == c0["corr_label"]


def test_text_stats_state_equals_jax():
    rng = np.random.default_rng(2)
    vals = [None if rng.random() < 0.1 else "w" * int(rng.integers(1, 9))
            + str(int(rng.integers(0, 40))) for _ in range(300)]
    states = []
    for mod in (jv, tv):
        st = mod.TextStats(max_card=30)
        for v in vals:
            st.update(v)
        states.append(st.to_state())
    assert json.dumps(states[1]) == json.dumps(states[0])
    back = tv.TextStats.from_state(json.loads(json.dumps(states[1])))
    assert back.to_state() == states[1]
    assert back.length_counts == st.length_counts


def test_codec_refuses_unknown_types():
    class Opaque:
        pass

    with pytest.raises(TypeError, match="checkpoint codec"):
        ck.encode_fit_state({"x": Opaque()}, "s", _ArrayStore())


# ---------------------------------------------------------------------------
# the manager
# ---------------------------------------------------------------------------

def test_atomic_saves_and_generation_cleanup(tmp_path):
    from transmogrifai_tpu_torch.features.builder import FeatureBuilder
    from transmogrifai_tpu_torch.types import feature_types as ft
    from transmogrifai_tpu_torch.types.columns import (ColumnarDataset,
                                                       FeatureColumn)

    est = tv.RealVectorizer().set_input(
        FeatureBuilder.Real("x").as_predictor())
    ds = ColumnarDataset({"x": FeatureColumn.from_values(
        ft.Real, np.arange(100.0))})
    state = est.update_chunk(est.begin_fit(), ds, ds["x"])
    d = tmp_path / "ck"
    mgr = ck.StreamingCheckpointManager(str(d), {"fp": 1}, every_chunks=1)
    for i in range(3):
        mgr.save_progress(0, "fit", i + 1, (i + 1) * 10, [est],
                          {est.uid: state})
        doc = json.load(open(d / ck.CHECKPOINT_JSON))
        assert doc["current"]["chunks_done"] == i + 1
        assert doc["seq"] == i + 1
        assert [n for n in os.listdir(d) if n.endswith(".npz")] == [
            doc["arrays"]]
        assert not os.path.exists(d / (ck.CHECKPOINT_JSON + ".tmp"))
    resume = ck.StreamingCheckpointManager(str(d), {"fp": 1}).load()
    restored = resume.states_for([est])[est.uid]
    assert est.finish_fit(restored).fills == est.finish_fit(state).fills
    with pytest.raises(ck.CheckpointMismatchError, match="fp"):
        ck.StreamingCheckpointManager(str(d), {"fp": 2}).load()
    mgr.finish()
    assert not os.path.exists(d)


def test_fingerprint_mismatch_names_the_key(files, tmp_path):
    d = str(tmp_path / "ck")
    with faults.inject(faults.FaultSpec(point="reader.chunk",
                                        action="raise", at=5)):
        with pytest.raises(faults.FaultError):
            _train(files, checkpoint_dir=d, checkpoint_every_chunks=2)
    assert os.path.exists(os.path.join(d, ck.CHECKPOINT_JSON))
    pred = _bench_ingest_dag(PORT)
    wf = OpWorkflow().set_result_features(pred).set_reader(
        CSVReader(files["csv"]))
    with pytest.raises(ck.CheckpointMismatchError, match="chunkRows"):
        wf.train(chunk_rows=CHUNK * 2, checkpoint_dir=d)


def _selector_dag():
    pred = _bench_ingest_dag(PORT)      # resets the uid counter
    survived, checked = pred.origin_stage.input_features
    sel = BinaryClassificationModelSelector.with_cross_validation(
        num_folds=2, models_and_parameters=[
            (OpLogisticRegression(), grid(reg_param=[0.1, 0.01]))])
    return sel.set_input(survived, checked).get_output(), sel


@pytest.mark.parametrize("selector", [False, True],
                         ids=["no_selector", "selector"])
def test_in_core_checkpoints_the_selector_sweep(files, tmp_path, selector):
    d = str(tmp_path / "ck")
    if not selector:
        pred = _bench_ingest_dag(PORT)
        wf = OpWorkflow().set_result_features(pred).set_reader(
            CSVReader(files["csv"]))
        with pytest.raises(ValueError, match="chunk_rows"):
            wf.train(checkpoint_dir=d)
        return
    pred, sel = _selector_dag()
    OpWorkflow().set_result_features(pred).set_reader(
        CSVReader(files["csv"])).train(checkpoint_dir=d)
    assert sel.metadata["sweep_checkpoint"]["restoredUnits"] == 0
    assert sel.sweep_checkpoint_dir is None    # the routing is undone
    assert not os.path.exists(d)               # success removed it


# ---------------------------------------------------------------------------
# crash and resume
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("source", ["csv", "parquet"])
def test_midpass_crash_resumes_to_the_uninterrupted_model(
        files, uninterrupted, tmp_path, source):
    m0, p0 = uninterrupted
    d = str(tmp_path / "ck")
    with faults.inject(faults.FaultSpec(point="reader.chunk",
                                        action="raise", at=7)):
        with pytest.raises(faults.FaultError):
            _train(files, source, checkpoint_dir=d,
                   checkpoint_every_chunks=2)
    mk, pk = _train(files, source, checkpoint_dir=d,
                    checkpoint_every_chunks=2)
    ip = mk.ingest_profile
    assert ip.resumed and ip.checkpoint_saves > 0
    assert ip.passes[0].chunks_skipped == 6     # the last save: chunk 6
    assert "resumed" in ip.format()
    assert _params(mk) == _params(m0)
    np.testing.assert_array_equal(pk, p0)
    assert not os.path.exists(d)
    if source == "csv":
        jpred = _bench_ingest_dag(JAX)
        jm = JWorkflow().set_result_features(jpred).set_reader(
            JCSVReader(files["csv"])).train(chunk_rows=CHUNK)
        jhold = JCSVReader(files["hold"]).generate_dataset(
            jm.raw_features())
        jp = np.asarray(jm.score(jhold)[jpred.name].values.probability)
        assert _params(mk)["vocabs"] == _params(jm)["vocabs"]
        assert _params(mk)["keep"] == _params(jm)["keep"]
        np.testing.assert_allclose(pk, jp, rtol=0, atol=PROBA_TOL_JAX)


def test_crash_in_the_fused_pass_resumes_from_the_boundary(
        files, uninterrupted, tmp_path):
    m0, p0 = uninterrupted
    d = str(tmp_path / "ck")
    # the OneHot model transforms only once layer 0 is fitted: in the
    # fused pass
    with faults.inject(faults.FaultSpec(point="stage.transform",
                                        action="raise",
                                        tag="OneHotVectorizerModel",
                                        skip=8)):
        with pytest.raises(faults.FaultError):
            _train(files, checkpoint_dir=d, checkpoint_every_chunks=2)
    mk, pk = _train(files, checkpoint_dir=d, checkpoint_every_chunks=2)
    labels = [p.label for p in mk.ingest_profile.passes]
    assert mk.ingest_profile.resumed
    assert not any(lb.startswith("fit[") for lb in labels)
    assert any(lb.startswith("fit+materialize[") for lb in labels)
    assert _params(mk) == _params(m0)
    np.testing.assert_array_equal(pk, p0)
    smart = _by_class(mk, "SmartTextVectorizerModel")[0]
    assert smart.uid == _by_class(m0, "SmartTextVectorizerModel")[0].uid
    # the restored model's fitted metadata came with it
    assert smart.metadata["text_strategies"] == _by_class(
        m0, "SmartTextVectorizerModel")[0].metadata["text_strategies"]


CHILD = r"""
import sys
sys.path.insert(0, {repo!r}); sys.path.insert(0, {tests!r})
import numpy as np, torch
import transmogrifai_tpu_torch as tt
tt.set_device("cpu")
torch.set_num_threads(1)
from test_torch_out_of_core import PORT, _bench_ingest_dag
from transmogrifai_tpu_torch.readers.files import CSVReader
from transmogrifai_tpu_torch.workflow.workflow import OpWorkflow
pred = _bench_ingest_dag(PORT)
OpWorkflow().set_result_features(pred).set_reader(CSVReader({csv!r})).train(
    chunk_rows={chunk}, checkpoint_dir={ckpt!r}, checkpoint_every_chunks=2)
print("FINISHED")
"""


def test_sigkill_at_the_barrier_resumes(files, uninterrupted, tmp_path):
    m0, p0 = uninterrupted
    d = str(tmp_path / "ck")
    env = dict(os.environ, JAX_PLATFORMS="cpu", TMOG_FAULTS=json.dumps(
        {"faults": [{"point": "checkpoint.barrier", "action": "kill",
                     "at": 1}]}))
    code = CHILD.format(repo=REPO, tests=os.path.join(REPO, "tests"),
                        csv=files["csv"], chunk=CHUNK, ckpt=d)
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == -9, proc.stderr[-2000:]
    assert "FINISHED" not in proc.stdout
    assert json.load(open(os.path.join(d, ck.CHECKPOINT_JSON)))[
        "current"]["chunks_done"] == 4
    mk, pk = _train(files, checkpoint_dir=d, checkpoint_every_chunks=2)
    assert mk.ingest_profile.resumed
    assert mk.ingest_profile.passes[0].chunks_skipped == 4
    assert _params(mk) == _params(m0)
    np.testing.assert_array_equal(pk, p0)
    assert not os.path.exists(d)
