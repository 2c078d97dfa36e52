"""The card smoke's ``feature_eng`` workflow at 3 000 + 500 rows, end to
end in the port against the JAX package on the CPU.

The DAG is ``chip_smoke.build_feature_eng`` built once with each
package's entry points: the Titanic demo's columns and four more (Email,
Phone, Bio, Boarded: ``chip_smoke.feature_eng_columns``) through the
tokenizer, stop words, n-grams and hashed term frequencies, Word2Vec, the
count vectorizer and LDA, the two tree bucketizers, the scaler, fill and
percentile stages, the email, phone and language detectors, the time
period, the Jaccard similarity and ``transmogrify``, then VectorsCombiner
-> MinVarianceFilter -> SanityChecker -> the binary selector over a
logistic-regression grid of two (the default grid's forests cost minutes
on the CPU and are held to the JAX package elsewhere).

* Both packages train: the bucketizers' splits and both filters' keep
  lists equal exactly, the winner equal, every CV AuPR within 1e-4 and
  the holdout probabilities within 1e-4 absolute (Word2Vec's and LDA's
  vectors differ by up to 2e-5 and 2e-4: ``test_torch_embeddings.py``;
  the fitted regression carries that into the scores).
* The JAX package's trained model, saved, loads in the port and scores
  the holdout within 1e-5 absolute of the JAX package's own scores (the
  same parameters; LDA's E-step and the Word2Vec means in float32 on
  each side).
* The port's model saves, loads in the port and scores the holdout
  bit-equal."""
import itertools

import numpy as np
import pytest
import torch

import chip_smoke
import transmogrifai_tpu.dsl  # noqa: F401  the JAX package's fluent methods
import transmogrifai_tpu_torch as tt
from transmogrifai_tpu.features.builder import FeatureBuilder as JFB
from transmogrifai_tpu.models.classification import \
    OpLogisticRegression as JLR
from transmogrifai_tpu.ops import detectors as jdet
from transmogrifai_tpu.ops.text import OpCountVectorizer as JCountVectorizer
from transmogrifai_tpu.ops.transmogrify import transmogrify as jtransmogrify
from transmogrifai_tpu.ops.vectorizers import VectorsCombiner as JCombiner
from transmogrifai_tpu.preparators.sanity_checker import \
    MinVarianceFilter as JMinVariance
from transmogrifai_tpu.preparators.sanity_checker import \
    SanityChecker as JChecker
from transmogrifai_tpu.selector.model_selector import \
    BinaryClassificationModelSelector as JSelector
from transmogrifai_tpu.selector.model_selector import grid as jgrid
from transmogrifai_tpu.types import feature_types as jft
from transmogrifai_tpu.types.columns import ColumnarDataset as JDataset
from transmogrifai_tpu.types.columns import FeatureColumn as JColumn
from transmogrifai_tpu.utils import uid as juid
from transmogrifai_tpu.workflow.workflow import OpWorkflow as JWorkflow
from transmogrifai_tpu.workflow.workflow import OpWorkflowModel as JModel
from transmogrifai_tpu_torch.models.classification import \
    OpLogisticRegression
from transmogrifai_tpu_torch.selector.model_selector import grid
from transmogrifai_tpu_torch.types import feature_types as ft
from transmogrifai_tpu_torch.types.columns import (ColumnarDataset,
                                                   FeatureColumn)
from transmogrifai_tpu_torch.utils import uid as tuid
from transmogrifai_tpu_torch.workflow.workflow import (OpWorkflow,
                                                       OpWorkflowModel)

ROWS, HOLDOUT = 3000, 500
SCORE_ATOL, CV_ATOL, LOADED_ATOL = 1e-4, 1e-4, 1e-5

JAX_STAGES = dict(
    fb=JFB, transmogrify=jtransmogrify, count_vectorizer=JCountVectorizer,
    valid_email=jdet.ValidEmailTransformer,
    email_domains=jdet.EmailToPickListMapTransformer,
    valid_phone=jdet.IsValidPhoneDefaultCountry, lang=jdet.LangDetector,
    combiner=JCombiner, min_variance=JMinVariance, checker=JChecker,
    selector=JSelector)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _raw_columns():
    n = ROWS + HOLDOUT
    cols, _ = chip_smoke.titanic_columns(n)
    cols.update(chip_smoke.feature_eng_columns(n))
    cols["TicketText"] = cols["Ticket"]
    return cols


def _schema():
    return {**chip_smoke.TITANIC_SCHEMA, **chip_smoke.FE_SCHEMA}


def _datasets(cols, ds_cls, col_cls, types):
    def ds(lo, hi):
        return ds_cls({k: col_cls.from_values(
            getattr(types, t.type_name()), v[lo:hi])
            for k, t in _schema().items() for v in (cols[k],)})

    return ds(0, ROWS), ds(ROWS, ROWS + HOLDOUT)


def _train(stages, lr, grid_fn, wf_cls, ds_cls, col_cls, types, uidmod,
           cols):
    uidmod._counter = itertools.count(1)
    models = [(lr(), grid_fn(reg_param=[0.01, 0.1],
                             elastic_net_param=[0.0]))]
    pred, feats, selector = chip_smoke.build_feature_eng(stages, models)
    train, hold = _datasets(cols, ds_cls, col_cls, types)
    model = wf_cls().set_result_features(pred).set_input_data(train).train()
    proba = model.score(hold)[pred.name].values.probability
    return dict(model=model, pred=pred, feats=feats, selector=selector,
                hold=hold, proba=np.asarray(
                    proba.cpu() if isinstance(proba, torch.Tensor)
                    else proba, np.float64)[:, 1])


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tt.set_device("cpu")
    cols = _raw_columns()
    jax = _train(JAX_STAGES, JLR, jgrid, JWorkflow, JDataset, JColumn, jft,
                 juid, cols)
    port = _train(chip_smoke.feature_eng_stages(), OpLogisticRegression,
                  grid, OpWorkflow, ColumnarDataset, FeatureColumn, ft, tuid,
                  cols)
    path = str(tmp_path_factory.mktemp("fe") / "jax_model")
    jax["model"].save(path)
    return jax, port, path


def _fitted(model, feat):
    return next(s for s in model.stages if s.uid == feat.origin_stage.uid)


def test_filters_and_buckets_equal(trained):
    jax, port, _ = trained
    for key in ("age_buckets", "fare_buckets"):
        jm = _fitted(jax["model"], jax["feats"][key])
        tm = _fitted(port["model"], port["feats"][key])
        assert tm.split_points == jm.split_points
        assert len(tm.split_points) > 2
    for key in ("filtered", "checked"):
        jm = _fitted(jax["model"], jax["feats"][key])
        tm = _fitted(port["model"], port["feats"][key])
        assert tm.keep_indices == jm.keep_indices
        assert (port["feats"][key].origin_stage.metadata["summary"]
                ["dropped"] == jax["feats"][key].origin_stage
                .metadata["summary"]["dropped"])
    widths = [_fitted(port["model"], port["feats"][k]).keep_indices
              for k in ("filtered", "checked")]
    assert len(widths[0]) > FE_MIN_WIDTH


FE_MIN_WIDTH = chip_smoke.FE_HASH_FEATURES // 2


def test_selector_and_scores_close(trained):
    jax, port, _ = trained
    js = jax["selector"].metadata["model_selector_summary"]
    ts = port["selector"].metadata["model_selector_summary"]
    assert ts["bestModelType"] == js["bestModelType"]
    assert ts["bestModelParams"] == js["bestModelParams"]
    for tr, jr in zip(ts["validationResults"], js["validationResults"]):
        assert tr["params"] == jr["params"]
        assert abs(tr["metricValue"] - jr["metricValue"]) <= CV_ATOL
    np.testing.assert_allclose(port["proba"], jax["proba"], rtol=0,
                               atol=SCORE_ATOL)
    assert np.isfinite(port["proba"]).all()


def test_jax_saved_model_scores_in_the_port(trained):
    jax, _, path = trained
    loaded = OpWorkflowModel.load(path, device="cpu")
    _, hold = _datasets(_raw_columns(), ColumnarDataset, FeatureColumn, ft)
    proba = loaded.score(hold)[jax["pred"].name].values.probability
    np.testing.assert_allclose(proba[:, 1].numpy().astype(np.float64),
                               jax["proba"], rtol=0, atol=LOADED_ATOL)
    # the JAX package reads its own artifact back to the same scores
    again = JModel.load(path).score(jax["hold"])[jax["pred"].name]
    np.testing.assert_allclose(np.asarray(again.values.probability)[:, 1],
                               jax["proba"], rtol=0, atol=1e-7)


def test_port_round_trip_bitwise(trained, tmp_path):
    _, port, _ = trained
    path = str(tmp_path / "port_model")
    port["model"].save(path)
    loaded = OpWorkflowModel.load(path, device="cpu")
    proba = loaded.score(port["hold"])[port["pred"].name].values.probability
    np.testing.assert_array_equal(proba[:, 1].numpy().astype(np.float64),
                                  port["proba"])
