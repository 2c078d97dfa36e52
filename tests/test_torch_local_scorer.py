"""The port's local scorer (``transmogrifai_tpu_torch.local``) on the CPU,
mirroring ``tests/test_local_scorer.py``: micro-batch agreement, the
reserved-key map, scoring without the response, the edge cases, the
scoring-DAG memo and the per-stage hook; and the port's score maps against
the JAX package's scorer on the same rows of the committed ``model_v1``
artifact: the same keys, values within 1e-6 (a logistic margin in float32,
summed in another order).
"""
import csv
import os

import numpy as np
import pytest

import transmogrifai_tpu_torch as tt
from transmogrifai_tpu.local import load_model_local as jload
from transmogrifai_tpu.local import score_function_batch as jbatch
from transmogrifai_tpu_torch.local import (load_model_local, score_function,
                                           score_function_batch)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
MODEL_V1 = os.path.join(FIXTURES, "model_v1")
TOL = 1e-6


@pytest.fixture(scope="module")
def model():
    tt.set_device("cpu")
    return load_model_local(MODEL_V1)


@pytest.fixture(scope="module")
def rows():
    with open(os.path.join(FIXTURES, "model_v1_input.csv")) as f:
        return [{"label": float(r["label"]), "x": float(r["x"]),
                 "cat": r["cat"]} for r in csv.DictReader(f)]


class TestScoreFunctionBatch:
    def test_empty_rows_returns_empty_list(self, model):
        assert score_function_batch(model)([]) == []
        assert score_function_batch(model)(iter(())) == []

    def test_non_dict_row_raises_clear_type_error(self, model):
        with pytest.raises(TypeError, match="row 1 is 'tuple'"):
            score_function_batch(model)([{"x": 1.0}, (1.0, 2.0)])

    def test_micro_batch_agrees_with_batch_of_one(self, model, rows):
        batched = score_function_batch(model)(rows[:16])
        one_fn = score_function(model)
        for row, got in zip(rows[:16], batched):
            assert got == one_fn(row)

    def test_prediction_reserved_key_expansion(self, model, rows):
        (result,) = score_function_batch(model)(rows[:1])
        (pred_map,) = result.values()
        assert set(pred_map) == {"prediction", "probability_0",
                                 "probability_1", "rawPrediction_0",
                                 "rawPrediction_1"}
        assert all(isinstance(v, float) for v in pred_map.values())
        assert abs(pred_map["probability_0"] + pred_map["probability_1"]
                   - 1.0) < 1e-6

    def test_scores_without_response_present(self, model, rows):
        fn = score_function_batch(model)
        stripped = [{k: v for k, v in r.items() if k != "label"}
                    for r in rows[:8]]
        assert fn(rows[:8]) == fn(stripped)

    def test_scores_match_frozen_expectations(self, model, rows):
        expected = np.load(os.path.join(FIXTURES, "model_v1_expected.npy"))
        out = score_function_batch(model)(rows)
        got = np.array([next(iter(r.values()))["probability_1"]
                        for r in out])
        np.testing.assert_allclose(got, expected, atol=1e-5)

    def test_row_map_matches_rows(self, model, rows):
        scored = model.score(rows[:4])
        batch = scored[model.result_features[0].name].values
        assert [batch.row(i) for i in range(4)] == batch.rows()


class TestAgainstJaxScorer:
    def test_same_keys_and_values_within_tolerance(self, model, rows):
        got = score_function_batch(model)(rows)
        want = jbatch(jload(MODEL_V1))(rows)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert list(g) == list(w)
            for name in g:
                assert list(g[name]) == list(w[name])
                for key in g[name]:
                    assert abs(g[name][key] - w[name][key]) <= TOL, key


class TestScoringDagMemoization:
    def test_scoring_dag_cached_on_model(self, model):
        assert model._scoring_dag() is model._scoring_dag()

    def test_repeated_score_function_builds_share_dag(self, model):
        score_function_batch(model)
        dag = model._scoring_dag()
        score_function(model)
        assert model._scoring_dag() is dag

    def test_on_stage_reports_every_stage_of_each_batch(self, model, rows):
        seen = []
        fn = score_function_batch(
            model, on_stage=lambda s, dt: seen.append(type(s).__name__))
        assert fn(rows[:4]) == score_function_batch(model)(rows[:4])
        per_batch = list(seen)
        assert "SelectedModel" in per_batch
        fn(rows[:1])
        assert seen == per_batch * 2
