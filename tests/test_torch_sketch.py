"""The nonzero-aware tree sketch of the port against the JAX package's, on
the CPU.

``quantile_bins_sparse_aware`` must give bit-equal edges (the same row
sample, the same float32 values, the JAX package's host arithmetic).  The
sparse rule (a matrix of at least ``_SPARSE_MIN_ELEMS`` elements whose
sampled rows are at least ``_SPARSE_ZERO_FRAC`` zero) is exercised at
test size by monkeypatching ``_SPARSE_MIN_ELEMS`` down in BOTH packages'
``models.trees`` (a test-time patch; no file changes): then
``prep_tree_inputs`` must give the JAX package's edges and bins, with and
without a trailing block of zero-weight rows, a boosted fit must bin with
them, and the selector's forest and boosted groups must too."""
import numpy as np
import pytest
import torch

import transmogrifai_tpu_torch as tt
from transmogrifai_tpu.models import gbdt_kernels as jg
from transmogrifai_tpu.models import trees as jtrees
from transmogrifai_tpu_torch.models import gbdt_kernels as tk
from transmogrifai_tpu_torch.models import trees as ttrees

#: the patched element threshold: every matrix below reaches it
SMALL = 1000


@pytest.fixture(autouse=True)
def _cpu():
    tt.set_device("cpu")


@pytest.fixture
def small_threshold(monkeypatch):
    monkeypatch.setattr(jtrees, "_SPARSE_MIN_ELEMS", SMALL)
    monkeypatch.setattr(ttrees, "_SPARSE_MIN_ELEMS", SMALL)


def _sparse_matrix(n, d, seed, density=0.08):
    """Mostly zero columns of several kinds: sparse positive and signed
    values, a few dense columns, an all-zero column, NaN entries, ties,
    and zero fractions of 0.45, 0.5 and 0.55."""
    rng = np.random.default_rng(seed)
    X = np.where(rng.random((n, d)) < density,
                 rng.lognormal(0, 1, (n, d)), 0.0).astype(np.float32)
    X[:, 1] = rng.normal(size=n)                            # dense
    X[:, 2] = 0.0                                           # all zero
    X[rng.random(n) < 0.1, 3] = np.nan                      # NaN + sparse
    X[:, 4] = np.where(rng.random(n) < 0.4,
                       rng.integers(1, 4, n), 0)            # ties
    X[:, 5] = np.where(rng.random(n) < 0.3, np.nan, rng.normal(size=n))
    X[:, 6] = -X[:, 6]                                      # negative
    # zero fractions at and near the per-column rule's 0.5
    half = np.where(np.arange(n) % 2 == 0, 0.0, rng.lognormal(0, 1, n))
    X[:, 7] = rng.permutation(half)                         # exactly 0.5
    X[:, 8] = np.where(rng.random(n) < 0.55, 0.0, rng.normal(size=n))
    X[:, 9] = np.where(rng.random(n) < 0.45, 0.0, rng.normal(size=n))
    return X


@pytest.mark.parametrize("n,sample_rows", [(3000, 200_000), (5000, 1200)],
                         ids=["all_rows", "row_sample"])
@pytest.mark.parametrize("max_bins", [32, 8])
def test_sparse_aware_edges_bit_equal(n, sample_rows, max_bins):
    X = _sparse_matrix(n, 24, 1)
    want = jg.quantile_bins_sparse_aware(X, max_bins, sample_rows=sample_rows)
    got = tk.quantile_bins_sparse_aware(torch.from_numpy(X), max_bins,
                                        sample_rows=sample_rows)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    # the all-zero column keeps one edge (0) and collapses the rest to
    # +inf; a sparse column has its pinned 0 and edges above it
    assert got[2][0] == 0.0 and np.isinf(got[2][1:]).all()
    assert got[0][0] == 0.0 and np.isfinite(got[0][1:max_bins - 2]).all()


def _jax_prep(X, max_bins, row_weight):
    edges, binned, _ = jtrees._prep_tree_inputs_weighted(X, max_bins,
                                                         row_weight)
    return np.asarray(edges), np.asarray(binned)


@pytest.mark.parametrize("trailing", [0, 700], ids=["no_pad", "zero_pad"])
def test_prep_tree_inputs_matches(small_threshold, trailing):
    X = _sparse_matrix(3000, 30, 2)
    w = np.ones(len(X), np.float32)
    w[::7] = 0.0                        # interior zeros stay in the sketch
    if trailing:
        w[-trailing:] = 0.0
    before = dict(ttrees.SKETCH_KINDS)
    edges, binned = ttrees.prep_tree_inputs(torch.from_numpy(X), 32,
                                            row_weight=w)
    want_e, want_b = _jax_prep(X, 32, w)
    assert ttrees.SKETCH_KINDS["sparse_aware"] == before["sparse_aware"] + 1
    np.testing.assert_array_equal(edges, want_e)
    np.testing.assert_array_equal(binned.numpy().astype(np.int64),
                                  want_b.astype(np.int64))
    if trailing:
        # the padded rows do not move the edges: the unpadded sketch
        np.testing.assert_array_equal(edges, tk.quantile_bins_sparse_aware(
            torch.from_numpy(X[:-trailing]), 32))


def test_dense_below_threshold(small_threshold):
    """A dense matrix, and any matrix below the element threshold, takes
    the dense sketch in both packages."""
    rng = np.random.default_rng(3)
    X = rng.normal(size=(400, 10)).astype(np.float32)
    assert ttrees.sketch_kind(torch.from_numpy(X)) == "dense"
    edges, _ = ttrees.prep_tree_inputs(torch.from_numpy(X), 32)
    np.testing.assert_array_equal(edges, _jax_prep(X, 32, None)[0])
    tiny = _sparse_matrix(20, 10, 4)
    assert tiny.size < SMALL
    assert ttrees.sketch_kind(torch.from_numpy(tiny)) == "dense"


@pytest.mark.parametrize("zeros,kind", [(60, "sparse_aware"),
                                        (59, "dense")],
                         ids=["at_threshold", "below"])
def test_zero_fraction_threshold(small_threshold, zeros, kind):
    """A sampled zero fraction exactly at 0.75 counts as sparse, as the
    JAX package's float64 mean of booleans decides: 60 of 80 entries."""
    X = np.ones((20, 4), np.float32)
    X.reshape(-1)[:zeros] = 0.0
    big = np.tile(X, (100, 1))          # 8000 elements, every row sampled
    assert ttrees.sketch_kind(torch.from_numpy(big)) == kind
    step = max(1, big.shape[0] // 4096)
    jax_sparse = (float((big[::step] == 0).mean())
                  >= jtrees._SPARSE_ZERO_FRAC)
    assert jax_sparse == (kind == "sparse_aware")


def test_gbt_fit_bins_with_the_jax_edges(small_threshold):
    """A sequential boosted fit on a wide, mostly zero matrix bins with the
    JAX package's nonzero-aware edges (the JAX fit's own)."""
    from transmogrifai_tpu.models.trees import OpGBTClassifier as JGBT
    from transmogrifai_tpu_torch.models.trees import OpGBTClassifier

    X = _sparse_matrix(2000, 30, 5)
    y = (np.nan_to_num(X[:, 0]) + np.nan_to_num(X[:, 1]) > 0.5).astype(
        np.float32)
    jm = JGBT(max_iter=2, max_depth=3).fit_raw(X, y)
    tm = OpGBTClassifier(max_iter=2, max_depth=3).fit_raw(X, y)
    np.testing.assert_array_equal(tm.edges, np.asarray(jm.edges))
    dense = tk.quantile_bins(torch.from_numpy(X), 32)
    assert not np.array_equal(tm.edges, dense)


def test_grid_groups_take_the_sketch(small_threshold, monkeypatch):
    """The selector's forest and boosted groups bin through
    ``prep_tree_inputs``: the edges they grow on equal the JAX package's
    weighted sketch of the same matrix and weights, and a sequential fit's
    edges."""
    from transmogrifai_tpu_torch.features.builder import FeatureBuilder
    from transmogrifai_tpu_torch.models.trees import (
        OpGBTClassifier, OpRandomForestClassifier)
    from transmogrifai_tpu_torch.selector import grid_groups
    from transmogrifai_tpu_torch.selector.model_selector import (
        BinaryClassificationModelSelector, grid)
    from transmogrifai_tpu_torch.types import feature_types as ft
    from transmogrifai_tpu_torch.types.columns import (ColumnarDataset,
                                                       FeatureColumn)
    from transmogrifai_tpu_torch.workflow.workflow import OpWorkflow

    X = _sparse_matrix(1500, 24, 6)
    y = (np.nan_to_num(X[:, 1]) > 0.2).astype(np.float64)
    seen = []
    orig = grid_groups.prep_tree_inputs

    def spy(Xt, max_bins, row_weight=None):
        out = orig(Xt, max_bins, row_weight=row_weight)
        seen.append((Xt.numpy().copy(), np.asarray(row_weight), out[0]))
        return out

    monkeypatch.setattr(grid_groups, "prep_tree_inputs", spy)
    from transmogrifai_tpu_torch.ops.vectorizers import VectorsCombiner

    label = FeatureBuilder.RealNN("label").as_response()
    # the combiner places the raw (host) vector on the device
    vec = VectorsCombiner().set_input(
        FeatureBuilder.OPVector("X").as_predictor()).get_output()
    sel = BinaryClassificationModelSelector.with_cross_validation(
        models_and_parameters=[
            (OpRandomForestClassifier(), grid(num_trees=[2],
                                              max_depth=[2, 3])),
            (OpGBTClassifier(), grid(max_iter=[2], max_depth=[2, 3]))])
    pred = label.transform_with(sel, vec)
    OpWorkflow().set_result_features(pred).set_input_data(ColumnarDataset({
        "X": FeatureColumn.from_values(ft.OPVector, X),
        "label": FeatureColumn.from_values(ft.RealNN, y)})).train()
    assert sel.metadata["group_errors"] == {}
    assert {"RFGridGroup", "GBTGridGroup"} <= set(
        sel.metadata["sweep_seconds"])
    assert len(seen) == 2
    for Xs, w, edges in seen:
        np.testing.assert_array_equal(edges, _jax_prep(Xs, 32, w)[0])
        if w[-1] > 0:   # no trailing zero-weight block: a sequential fit's
            np.testing.assert_array_equal(
                edges, ttrees.prep_tree_inputs(torch.from_numpy(Xs), 32)[0])
