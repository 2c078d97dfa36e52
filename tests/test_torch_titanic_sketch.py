"""The Titanic demo's nonzero-aware-sketch leg and its forests, port
against the JAX package on the CPU (the rest of the demo's parity is
``tests/test_torch_titanic.py``, whose helpers and tolerances this file
shares; a file of its own so the two legs run on separate test workers).

``_SPARSE_MIN_ELEMS`` is patched down in both packages' ``models.trees``
(a test-time patch) so the 3 000-row demo, ~97% zero, takes the
nonzero-aware sketch in both; ``TestDemoParity`` then holds it to the
same tolerances as the leg without the sketch.  ``test_forests_equal``
holds the demo's depth-12 forest on the checked matrix equal to the JAX
package's, with its bags."""
import numpy as np
import pytest
import torch

import transmogrifai_tpu_torch as tt
from test_torch_titanic import (  # noqa: F401  fixtures and the shared class
    PORT, JRF, OpRandomForestClassifier, OpWorkflow, TestDemoParity,
    _both, _cpu, _jax_bags, build_demo, frames, one_thread, tk)


@pytest.fixture(scope="module")
def runs(frames):
    """The demo with the nonzero-aware sketch in both packages."""
    return _both(frames, True)


def test_forests_equal(frames):
    """The demo's deeper forest (depth 12; the depth-6 candidate is its
    truncation) on the checked matrix, trained on the first of the
    selector's 3 stratified folds, with the JAX package's bags: the same
    splits and bit-equal leaves; probabilities within 2 ulps of 1 (the
    float32 sum over trees in another order)."""
    depth, fold = 12, 0
    from transmogrifai_tpu_torch.selector.validators import make_folds

    train, _ = frames
    tt.set_device("cpu")
    _, checked, _ = build_demo(PORT, with_selector=False)
    X = OpWorkflow().set_result_features(checked).set_input_data(
        train).train().train_data[checked.name].values.numpy()
    y = train["Survived"].to_numpy().astype(np.float32)
    folds = make_folds(len(y), 3, y, stratify=True, seed=42)
    kw = dict(num_trees=50, max_depth=depth, min_info_gain=0.001)
    w = (folds != fold).astype(np.float32)
    jm = JRF(**kw).fit_raw(X, y, w)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tk, "rf_bags_and_features", _jax_bags)
        tm = OpRandomForestClassifier(**kw).fit_raw(X, y, w)
    np.testing.assert_array_equal(tm.feat.numpy(), np.asarray(jm.feat))
    np.testing.assert_array_equal(tm.thresh.numpy(), np.asarray(jm.thresh))
    np.testing.assert_array_equal(tm.leaf.numpy(), np.asarray(jm.leaf))
    ev = X[folds == fold]
    np.testing.assert_allclose(
        tm.predict_batch(torch.from_numpy(ev)).probability.numpy(),
        np.asarray(jm.predict_batch(ev).probability), rtol=0, atol=2.4e-7)
