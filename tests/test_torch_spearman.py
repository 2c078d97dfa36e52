"""Spearman correlation in the port's SanityChecker against the JAX
package, on the CPU.

Both take Pearson's correlation of the float32 average ranks (a tie group
shares its midrank).  The port ranks in one batched stable sort a group of
columns and takes the midrank (first + last position) / 2 exactly; the
JAX package sums positions per group in float32, which rounds once a tie
group's position sum passes 2^24, so the correlations are held within
1e-5 (the ranks bit-equal at these sizes) and the dropped columns equal.
"""
import itertools

import numpy as np
import pytest
import torch

import transmogrifai_tpu_torch as tt
from transmogrifai_tpu.features.builder import FeatureBuilder as JFB
from transmogrifai_tpu.ops.stats import ranks as jranks
from transmogrifai_tpu.ops.stats import spearman_with_label as jspearman
from transmogrifai_tpu.ops.transmogrify import transmogrify as jtransmogrify
from transmogrifai_tpu.preparators.sanity_checker import \
    SanityChecker as JChecker
from transmogrifai_tpu.utils import uid as juid
from transmogrifai_tpu.workflow.workflow import OpWorkflow as JWorkflow
from transmogrifai_tpu_torch.features.builder import FeatureBuilder
from transmogrifai_tpu_torch.ops.stats import ranks, spearman_with_label
from transmogrifai_tpu_torch.ops.transmogrify import transmogrify
from transmogrifai_tpu_torch.preparators.sanity_checker import SanityChecker
from transmogrifai_tpu_torch.utils import uid as tuid
from transmogrifai_tpu_torch.workflow.workflow import OpWorkflow


@pytest.fixture(autouse=True)
def _cpu():
    tt.set_device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _matrix(n, seed):
    """Columns with ties, a constant one, a monotone transform of the
    label's latent score (Spearman-leaky, not Pearson-leaky) and noise."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=n)
    y = (z + 0.3 * rng.normal(size=n) > 0.2).astype(np.float32)
    cols = [rng.integers(0, 4, n), rng.integers(0, 60, n), np.full(n, 3.0),
            np.exp(4 * z), z + 0.05 * rng.normal(size=n), rng.normal(size=n),
            y * 2.0 + 1.0, rng.standard_cauchy(n)]
    return np.stack(cols, 1).astype(np.float32), y


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ranks_and_correlations(seed):
    X, y = _matrix(3000, seed)
    import jax

    jr = np.asarray(jax.vmap(jranks, in_axes=1, out_axes=1)(X))
    np.testing.assert_array_equal(ranks(torch.from_numpy(X)).numpy(), jr)
    np.testing.assert_array_equal(ranks(torch.from_numpy(y)).numpy(),
                                  np.asarray(jranks(y)))
    got = spearman_with_label(torch.from_numpy(X), torch.from_numpy(y))
    want = np.nan_to_num(np.asarray(jspearman(X, y), np.float64))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _pipeline(pkg, n, seed, max_corr):
    fb, tm, checker, wf, uid = pkg
    uid._counter = itertools.count(1)
    X, y = _matrix(n, seed)
    data = {"label": y.astype(float)}
    data.update({f"c{j}": X[:, j].astype(float) for j in range(X.shape[1])})
    label = fb.RealNN("label").as_response()
    preds = [fb.Real(f"c{j}").as_predictor() for j in range(X.shape[1])]
    checked = checker(correlation_type="spearman",
                      max_correlation=max_corr).set_input(
        label, tm(preds)).get_output()
    import pandas as pd

    model = (wf().set_result_features(checked)
             .set_input_data(pd.DataFrame(data)).train())
    stage = next(s for s in model.stages
                 if "summary" in s.metadata)
    return stage.metadata["summary"]


@pytest.mark.parametrize("max_corr", [0.7, 0.95])
def test_spearman_checker_equal(max_corr):
    jsum = _pipeline((JFB, jtransmogrify, JChecker, JWorkflow, juid), 2500,
                     4, max_corr)
    tsum = _pipeline((FeatureBuilder, transmogrify, SanityChecker,
                      OpWorkflow, tuid), 2500, 4, max_corr)
    assert tsum["correlationType"] == jsum["correlationType"] == "spearman"
    assert tsum["dropped"] == jsum["dropped"]
    assert jsum["dropped"]              # the leaky columns go
    for t, j in zip(tsum["columnStats"], jsum["columnStats"]):
        assert t["name"] == j["name"]
        assert t["corr_label"] == pytest.approx(j["corr_label"], abs=1e-5)
        assert t["reasons"] == j["reasons"]
        assert t["parent_feature"] == j["parent_feature"]
        assert t["cramers_v"] == j["cramers_v"]


def test_unknown_correlation_type():
    with pytest.raises(ValueError):
        SanityChecker(correlation_type="kendall")
