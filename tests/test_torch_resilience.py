"""Ingestion resilience in the port (``utils/faults.py``,
``readers/resilience.py`` and the readers' bad-record paths) against the
JAX package's, on the CPU.

Tolerances, and why:
 * the fault harness: the same plan over the same calls fires the same
   faults (its ``log`` equal), seeded Bernoulli draws included;
 * backoff: the same seconds, exactly (the same seeded numpy draws);
 * quarantine sidecars of JSON-lines, CSV and Avro files: every entry
   equal to the JAX package's (source, location, reason, rows, record),
   the kept rows equal;
 * reader retry end to end: a chunked train with an injected IO error
   scores as the clean train does, bit for bit (the same chunks in the
   same order).
"""
import json
import os

import numpy as np
import pytest
import torch

import transmogrifai_tpu_torch as tt
from transmogrifai_tpu.features.builder import FeatureBuilder as JFB
from transmogrifai_tpu.readers import avro as javro
from transmogrifai_tpu.readers import files as jfiles
from transmogrifai_tpu.readers import resilience as jres
from transmogrifai_tpu.utils import faults as jfaults
from transmogrifai_tpu_torch.features.builder import FeatureBuilder as PFB
from transmogrifai_tpu_torch.models.classification import OpLogisticRegression
from transmogrifai_tpu_torch.ops.transmogrify import transmogrify
from transmogrifai_tpu_torch.preparators.sanity_checker import SanityChecker
from transmogrifai_tpu_torch.readers import avro as pavro
from transmogrifai_tpu_torch.readers import files as pfiles
from transmogrifai_tpu_torch.readers import resilience as pres
from transmogrifai_tpu_torch.utils import faults as pfaults
from transmogrifai_tpu_torch.workflow.workflow import OpWorkflow

JAX = dict(faults=jfaults, res=jres, files=jfiles, avro=javro, fb=JFB)
PORT = dict(faults=pfaults, res=pres, files=pfiles, avro=pavro, fb=PFB)


@pytest.fixture(autouse=True)
def _cpu():
    tt.set_device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# the fault harness
# ---------------------------------------------------------------------------

PLANS = {
    "at_times": [dict(point="reader.chunk", action="io_error", at=[1, 3],
                      times=1)],
    "every": [dict(point="reader.chunk", action="io_error", every=3,
                   times=None)],
    "p_seeded": [dict(point="reader.chunk", action="io_error", p=0.3,
                      times=None)],
    "tag_skip": [dict(point="avro.block", action="raise", tag="b", skip=1,
                      times=2)],
    "process": [dict(point="reader.chunk", action="io_error", process=1),
                dict(point="reader.chunk", action="raise", process=0,
                     at=4)],
}


def _drive(faults, plan_doc, seed):
    """Fire every point 12 times (tags alternating) under the plan; the
    plan's log and each call's outcome."""
    plan = faults.FaultPlan.from_json({"seed": seed, "faults": plan_doc})
    outcomes = []
    with faults.inject(*plan.faults, seed=seed) as armed:
        for i in range(12):
            for point in ("reader.chunk", "avro.block"):
                try:
                    faults.fire(point, tag="ab"[i % 2])
                    outcomes.append(None)
                except Exception as exc:
                    outcomes.append(type(exc).__name__)
    return armed.log, outcomes, plan.to_json()


@pytest.mark.parametrize("name", sorted(PLANS))
@pytest.mark.parametrize("seed", [0, 7])
def test_fault_plans_fire_as_the_jax_harness(name, seed):
    assert _drive(pfaults, PLANS[name], seed) == \
        _drive(jfaults, PLANS[name], seed)


def test_env_plan_index_override_and_actions(monkeypatch):
    doc = {"faults": [{"point": "event.window", "action": "io_error",
                       "at": 2}]}
    monkeypatch.setattr(pfaults, "_plan", pfaults._UNSET)
    monkeypatch.setenv(pfaults.ENV_VAR, json.dumps(doc))
    plan = pfaults.current_plan()
    assert plan.to_json() == {"seed": 0, "faults": [
        {**doc["faults"][0], "times": 1}]}
    pfaults.fire("event.window", index=0)
    with pytest.raises(OSError, match=r"event.window\[2\]"):
        pfaults.fire("event.window", index=2)
    assert plan.calls("event.window") == 2
    pfaults.clear_faults()
    assert pfaults.current_plan() is None
    with pytest.raises(ValueError, match="unknown fault action"):
        pfaults.FaultSpec(point="x", action="explode")
    with pfaults.inject(pfaults.FaultSpec(point="x", action="slow",
                                          delay_s=0.0)):
        pfaults.fire("x")
    with pfaults.inject(pfaults.FaultSpec(point="x", action="skip")):
        with pytest.raises(pfaults.FaultSkip):
            pfaults.fire("x")


# ---------------------------------------------------------------------------
# retry policy and the retrying stream
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, {"seed": 3, "jitter": 0.5},
                                {"base_delay_s": 0.2, "max_delay_s": 0.5},
                                {"jitter": 0.0}])
def test_backoff_equals_jax(kw):
    a, b = pres.RetryPolicy(**kw), jres.RetryPolicy(**kw)
    assert [a.backoff_s(i) for i in range(8)] == \
        [b.backoff_s(i) for i in range(8)]
    with pytest.raises(ValueError):
        pres.RetryPolicy(max_attempts=0)


@pytest.mark.parametrize("exc", [OSError("x"), IOError("x"),
                                 ConnectionResetError("x"),
                                 FileNotFoundError("x"), PermissionError("x"),
                                 ValueError("x"), EOFError("x")])
def test_transient_classification_equals_jax(exc):
    assert pres.is_transient_io_error(exc) == jres.is_transient_io_error(exc)


class _Flaky:
    """A re-creatable stream of 0..n-1 that raises ``exc`` at the given
    (open, item) points."""

    def __init__(self, n, fail_at, exc=OSError):
        self.n, self.fail_at, self.exc, self.opens = n, set(fail_at), exc, 0

    def make(self):
        k = self.opens
        self.opens += 1

        def gen():
            for i in range(self.n):
                if (k, i) in self.fail_at:
                    raise self.exc(f"flaky at {i}")
                yield i
        return gen()


@pytest.mark.parametrize("res", [jres, pres])
def test_retrying_stream_skips_exactly(res):
    src = _Flaky(6, {(0, 2), (1, 4)})
    waits = []
    s = res.RetryingChunkStream(src.make, res.RetryPolicy(
        base_delay_s=0.0), on_retry=waits.append, sleep=lambda _: None)
    assert list(s) == list(range(6))
    assert (s.retries, src.opens, len(waits)) == (2, 3, 2)
    exhausted = _Flaky(3, {(k, 1) for k in range(4)})
    with pytest.raises(OSError):
        list(res.RetryingChunkStream(exhausted.make, res.RetryPolicy(
            max_attempts=3, base_delay_s=0.0), sleep=lambda _: None))
    assert exhausted.opens == 3
    bad = _Flaky(3, {(0, 1)}, exc=ValueError)
    with pytest.raises(ValueError):
        list(res.RetryingChunkStream(bad.make, res.RetryPolicy(),
                                     sleep=lambda _: None))
    assert bad.opens == 1


# ---------------------------------------------------------------------------
# reader retry, end to end
# ---------------------------------------------------------------------------

def _csv(tmp_path, n=240, seed=5):
    rng = np.random.default_rng(seed)
    x1, x2 = rng.normal(size=n), rng.normal(size=n)
    y = (rng.random(n) < 1 / (1 + np.exp(-(1.2 * x1 - x2)))).astype(float)
    path = str(tmp_path / "d.csv")
    with open(path, "w") as fh:
        fh.write("label,x1,x2\n")
        fh.writelines(f"{a!r},{b!r},{c!r}\n" for a, b, c in zip(
            y.tolist(), x1.tolist(), x2.tolist()))
    return path


def _train(reader, chunk_rows):
    label = PFB.RealNN("label").as_response()
    feats = transmogrify([PFB.Real("x1").as_predictor(),
                          PFB.Real("x2").as_predictor()])
    checked = SanityChecker().set_input(label, feats).get_output()
    pred = OpLogisticRegression().set_input(label, checked).get_output()
    model = (OpWorkflow().set_result_features(pred).set_reader(reader)
             .train(chunk_rows=chunk_rows))
    proba = model.score(pfiles.CSVReader(reader.path))[pred.name]
    return model, proba.values.probability[:, 1]


def test_reader_retry_recovers_with_the_clean_scores(tmp_path):
    path = _csv(tmp_path)
    _, clean = _train(pfiles.CSVReader(path), 50)
    reader = pfiles.CSVReader(path).with_resilience(
        retry=pres.RetryPolicy(base_delay_s=0.0))
    with pfaults.inject(pfaults.FaultSpec(point="reader.chunk",
                                          action="io_error", at=2,
                                          times=2)):
        model, got = _train(reader, 50)
    assert torch.equal(got, clean)
    ip = model.ingest_profile
    assert ip.total_retries == 2 and ip.to_json()["retries"] == 2
    assert "2 retries" in ip.format()


def test_reader_retries_exhausted_and_the_default_fails_fast(tmp_path):
    path = _csv(tmp_path)
    for reader in (pfiles.CSVReader(path).with_resilience(
            retry=pres.RetryPolicy(max_attempts=2, base_delay_s=0.0)),
            pfiles.CSVReader(path)):
        with pfaults.inject(pfaults.FaultSpec(point="reader.chunk",
                                              action="io_error", at=1,
                                              times=None)):
            with pytest.raises(OSError, match="injected fault"):
                _train(reader, 50)


# ---------------------------------------------------------------------------
# quarantine sidecars: the JAX package's entries
# ---------------------------------------------------------------------------

def _entries(path):
    with open(path) as fh:
        out = [json.loads(line) for line in fh]
    for e in out:
        e["source"] = os.path.basename(e["source"])
    return out


def _read(pkg, reader_cls, path, q, names, chunk_rows=None, **kw):
    reader = reader_cls(pkg)(path).with_resilience(
        bad_records="quarantine", quarantine_path=q, **kw)
    feats = [pkg["fb"].Real(n).as_predictor() for n in names]
    if chunk_rows is None:
        ds = reader.generate_dataset(feats)
        vals = {n: ds[n].to_list() for n in names}
    else:
        vals = {n: [] for n in names}
        for c in reader.iter_chunks(feats, chunk_rows):
            for n in names:
                vals[n] += c[n].to_list()
    return vals, reader.resilience.sink(), _entries(q)


@pytest.mark.parametrize("chunk_rows", [None, 3])
def test_jsonl_quarantine_equals_jax(tmp_path, chunk_rows):
    p = str(tmp_path / "d.jsonl")
    with open(p, "w") as fh:
        for i in range(12):
            fh.write("{broken\n" if i in (2, 7) else
                     json.dumps({"a": float(i), "b": i * 0.5}) + "\n")
    got = [_read(pkg, lambda g: g["files"].JSONLinesReader, p,
                 str(tmp_path / f"q{k}.jsonl"), ["a", "b"], chunk_rows)
           for k, pkg in enumerate((JAX, PORT))]
    (jv, js, je), (pv, ps, pe) = got
    assert pv == jv and pe == je
    assert (ps.count, ps.rows) == (js.count, js.rows) == (2, 2)
    assert [e["location"] for e in pe] == ["line 3 (byte 42)",
                                           "line 8 (byte 134)"]
    with pytest.raises(pres.BadRecordError, match=r"line 3 \(byte 42\)"):
        pfiles.JSONLinesReader(p).generate_dataset(
            [PFB.Real("a").as_predictor()])


@pytest.mark.parametrize("chunk_rows", [None, 4])
def test_csv_quarantine_equals_jax(tmp_path, chunk_rows):
    p = str(tmp_path / "d.csv")
    lines = ["a,b"] + [f"{i}.5,{i}" for i in range(10)]
    lines[3] = "3.5,3,extra"
    lines[8] = "8.5,8,x,y"
    with open(p, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    got = [_read(pkg, lambda g: g["files"].CSVReader, p,
                 str(tmp_path / f"q{k}.jsonl"), ["a", "b"], chunk_rows)
           for k, pkg in enumerate((JAX, PORT))]
    (jv, js, je), (pv, ps, pe) = got
    assert pv == jv and pe == je and (ps.count, ps.rows) == (2, 2)
    with pytest.raises(ValueError, match="fields"):
        pfiles.CSVReader(p).generate_dataset([PFB.Real("a").as_predictor()])


def test_max_bad_records_and_the_policy_checks(tmp_path):
    p = str(tmp_path / "d.jsonl")
    with open(p, "w") as fh:
        fh.write("".join("{x\n" if i % 2 else '{"a": 1.0}\n'
                         for i in range(10)))
    reader = pfiles.JSONLinesReader(p).with_resilience(
        bad_records="quarantine", quarantine_path=str(tmp_path / "q.jsonl"),
        max_bad_records=3)
    with pytest.raises(pres.TooManyBadRecordsError, match="max_bad_records"):
        reader.generate_dataset([PFB.Real("a").as_predictor()])
    with pytest.raises(ValueError, match="quarantine_path"):
        pfiles.JSONLinesReader(p).with_resilience(bad_records="quarantine")
    with pytest.raises(ValueError, match="'fail' or 'quarantine'"):
        pfiles.JSONLinesReader(p).with_resilience(bad_records="drop")


SCHEMA = {"type": "record", "name": "R", "fields": [
    {"name": "a", "type": "double"}, {"name": "b", "type": "double"}]}


def _corrupt_avro(tmp_path):
    path = str(tmp_path / "d.avro")
    recs = [{"a": float(i), "b": float(i) / 2} for i in range(40)]
    pavro.write_avro(path, SCHEMA, recs, codec="deflate", block_records=10)
    raw = bytearray(open(path, "rb").read())
    sync = raw[-16:]
    second = raw.index(sync, raw.index(sync) + 16) + 16   # block 1's start
    raw[second + 6] ^= 0xFF                               # inside its payload
    raw[second + 7] ^= 0xFF
    with open(path, "wb") as fh:
        fh.write(raw)
    return path


@pytest.mark.parametrize("chunk_rows", [None, 7])
def test_avro_block_quarantine_equals_jax(tmp_path, chunk_rows):
    path = _corrupt_avro(tmp_path)
    got = [_read(pkg, lambda g: g["avro"].AvroReader, path,
                 str(tmp_path / f"q{k}.jsonl"), ["a", "b"], chunk_rows)
           for k, pkg in enumerate((JAX, PORT))]
    (jv, js, je), (pv, ps, pe) = got
    assert pv == jv and pe == je
    assert ps.count == 1 and ps.rows == 10 and len(pv["a"]) == 30
    assert pe[0]["location"].startswith("block 1 (byte ")
    with pytest.raises(pavro.AvroBlockError, match="block 1"):
        pavro.read_avro(path)
    cfg = pres.ResilienceConfig(bad_records=pres.BadRecordPolicy(
        "quarantine", str(tmp_path / "q.jsonl")))
    schema, records = pavro.read_avro(path, resilience=cfg)
    assert len(records) == 30 and schema == SCHEMA
    assert pavro.AvroReader(path).with_resilience(
        bad_records="quarantine",
        quarantine_path=str(tmp_path / "q2.jsonl")).estimate_rows() is None


def test_avro_block_fault_point_fires(tmp_path):
    path = str(tmp_path / "d.avro")
    pavro.write_avro(path, SCHEMA, [{"a": 1.0, "b": 2.0}] * 30,
                     block_records=10)
    with pfaults.inject(pfaults.FaultSpec(point="avro.block",
                                          action="raise", at=2)) as plan:
        with pytest.raises(pfaults.FaultError, match=r"avro.block\[2\]"):
            list(pavro.iter_avro_blocks(path))
    assert [e["index"] for e in plan.log] == [2]
