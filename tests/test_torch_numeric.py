"""The port's numeric stages (``ops/numeric.py``) against the JAX
package's on the CPU, on numpy-seeded columns.

``DecisionTreeNumericBucketizer`` grows a single-feature tree through
``grow_tree`` with a count channel (2K + 1 histogram channels, the
kernel wrapper's plain version on CPU tensors): its split points must
equal the JAX package's exactly, for a binary, a 5-class and a
continuous (K = 1) label, and its bucket blocks must be bit-equal.  The
split points of a single-feature tree cannot tie: every bin of a node's
range holds rows of that node, so two thresholds never cut its rows
alike unless a bin is empty everywhere, and then both packages' prefix
sums are bit-equal at both and the first wins in each.
``NumericBucketizer``'s blocks are bit-equal; the scaler, descaler, fill
and percentile values (float64 host arithmetic in both) equal within
1e-12 relative, masks equal."""
import numpy as np
import pytest

import transmogrifai_tpu_torch as tt
from test_torch_text import JAX, PORT, assert_same_column, run_stage
from transmogrifai_tpu.ops import numeric as jnum
from transmogrifai_tpu_torch.models import gbdt_kernels as tk
from transmogrifai_tpu_torch.ops import numeric as tnum

FLOAT_RTOL = 1e-12


@pytest.fixture(autouse=True)
def _cpu():
    tt.set_device("cpu")


def _feature(n, seed, p_null=0.15):
    rng = np.random.default_rng(seed)
    x = rng.lognormal(1.0, 0.8, n)
    x[rng.random(n) < p_null] = np.nan
    return x


def _label(x, kind, seed):
    rng = np.random.default_rng(seed)
    z = np.nan_to_num(np.log(np.where(np.isnan(x), 1.0, x)))
    if kind == "binary":
        return (1 / (1 + np.exp(-(2 * z - 1.5))) > rng.random(len(x))
                ).astype(float)
    if kind == "multiclass":
        return np.clip(np.floor(z * 2 + rng.normal(0, 0.7, len(x))), 0, 4)
    return 3 * np.sin(z) + rng.normal(0, 0.3, len(x))


SPECS = [("RealNN", "label"), ("Real", "x")]


@pytest.mark.parametrize("kind,kw", [
    ("binary", {}),
    ("binary", {"max_depth": 2, "track_invalid": True}),
    ("multiclass", {"min_instances_per_node": 30}),
    ("continuous", {"min_info_gain": 0.001}),
    ("continuous", {"max_splits": 3, "track_nulls": False}),
])
def test_tree_bucketizer_splits_equal(kind, kw):
    x = _feature(3000, 1)
    y = _label(x, kind, 2)
    x2 = _feature(400, 3) * 1.5          # values past the training range
    y2 = _label(x2, kind, 4)
    jm, jout = run_stage(JAX, lambda: jnum.DecisionTreeNumericBucketizer(
        **kw), SPECS, [y, x], [[y2, x2]])
    tm, tout = run_stage(PORT, lambda: tnum.DecisionTreeNumericBucketizer(
        **kw), SPECS, [y, x], [[y2, x2]])
    assert tm.split_points == jm.split_points
    assert len(tm.split_points) > 2
    assert tm.metadata["summary"] == jm.metadata["summary"]
    for t, j in zip(tout, jout):
        assert_same_column(t, j)


def test_tree_bucketizer_reaches_the_kernel_wrapper(monkeypatch):
    """Every level goes through the histogram function with 2K + 1
    channels on a (N, 1) binned matrix whose row stride is 16 bytes."""
    seen = []

    def spy(binned, slot, ch, M, B):
        seen.append((tuple(binned.shape), binned.stride(0), ch.shape[1], M))
        return tk.seg_level_hists_plain(binned, slot, ch, M, B)

    x = _feature(2000, 5, p_null=0.0)
    for kind, chans in (("binary", 5), ("continuous", 3)):
        y = _label(x, kind, 6)
        splits = tnum.tree_split_points(x, y, 4, 32, 0.01, 1.0, "cpu",
                                        hist_fn=spy)
        assert splits == tnum.tree_split_points(x, y, 4, 32, 0.01, 1.0,
                                                "cpu")
        assert [s[2] for s in seen] == [chans] * 4
        assert all(s[0] == (2000, 1) and s[1] == 16 for s in seen)
        assert [s[3] for s in seen] == [1, 2, 4, 8]
        seen.clear()


def test_tree_bucketizer_without_splits():
    """A constant feature (and an all-missing one) finds no split: only
    the null indicator remains."""
    y = _label(_feature(300, 7), "binary", 8)
    for x in (np.full(300, 2.5), np.full(300, np.nan)):
        jm, (jo,) = run_stage(JAX, jnum.DecisionTreeNumericBucketizer,
                              SPECS, [y, x])
        tm, (to,) = run_stage(PORT, tnum.DecisionTreeNumericBucketizer,
                              SPECS, [y, x])
        assert tm.split_points == jm.split_points == []
        assert_same_column(to, jo)


@pytest.mark.parametrize("kw", [
    {"split_points": [0.0, 1.0, 2.5, 10.0]},
    {"split_points": [-np.inf, 2.0, np.inf], "track_nulls": False},
    {"split_points": [1.0, 3.0], "track_invalid": True}])
def test_numeric_bucketizer(kw):
    specs = [("Real", "x")]
    _, jout = run_stage(JAX, lambda: jnum.NumericBucketizer(**kw), specs,
                        [_feature(500, 9)])
    _, tout = run_stage(PORT, lambda: tnum.NumericBucketizer(**kw), specs,
                        [_feature(500, 9)])
    assert_same_column(tout[0], jout[0])


@pytest.mark.parametrize("name,kw", [
    ("FillMissingWithMean", {}),
    ("OpScalarStandardScaler", {}),
    ("OpScalarStandardScaler", {"with_mean": False}),
    ("OpScalarStandardScaler", {"with_std": False}),
    ("PercentileCalibrator", {}),
    ("PercentileCalibrator", {"buckets": 7}),
    ("ScalerTransformer", {"slope": 2.5, "intercept": -1.0}),
    ("ScalerTransformer", {"scaling_type": "log"}),
])
def test_scalar_stages(name, kw):
    specs = [("Real", "x")]
    fit = [_feature(600, 10) - 2.0]
    unseen = [_feature(80, 11)]
    jm, jout = run_stage(JAX, lambda: getattr(jnum, name)(**kw), specs, fit,
                         [unseen])
    tm, tout = run_stage(PORT, lambda: getattr(tnum, name)(**kw), specs,
                         fit, [unseen])
    assert tm.metadata == jm.metadata
    for t, j in zip(tout, jout):
        assert_same_column(t, j, rtol=FLOAT_RTOL)


def test_fill_with_default_when_all_missing():
    specs = [("Real", "x")]
    raw = [np.full(20, np.nan)]
    _, (jo,) = run_stage(JAX, lambda: jnum.FillMissingWithMean(3.5), specs,
                         raw)
    _, (to,) = run_stage(PORT, lambda: tnum.FillMissingWithMean(3.5), specs,
                         raw)
    assert_same_column(to, jo)


@pytest.mark.parametrize("kw", [{"slope": 2.5, "intercept": -1.0},
                                {"scaling_type": "log"},
                                {"slope": 0.0}])
def test_descaler_inverts(kw):
    specs = [("Real", "x")]
    x = _feature(300, 12)
    _, (jscaled,) = run_stage(JAX, lambda: jnum.ScalerTransformer(**kw),
                              specs, [x])
    _, (jo,) = run_stage(JAX, lambda: jnum.DescalerTransformer(**kw), specs,
                         [jscaled.values])
    _, (to,) = run_stage(PORT, lambda: tnum.DescalerTransformer(**kw), specs,
                         [jscaled.values])
    assert_same_column(to, jo, rtol=FLOAT_RTOL)
