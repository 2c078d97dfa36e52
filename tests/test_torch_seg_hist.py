"""The port's per-level histogram and tree growth against the JAX package.

On the CPU the port's ``seg_level_hists`` takes its plain version (a
flat-index ``index_add_``); it is held against the JAX segmented kernel in
Pallas interpret mode and against ``np.add.at`` at the tolerance of
tests/test_seg_hist.py (rtol 1e-5, atol 1e-4: float32 sums in another
order).  Tree growth must pick identical splits; leaves agree to rtol 1e-5.
The hand-written kernel itself is tested on the card by
tests/test_torch_kernels_cuda.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from transmogrifai_tpu.models import gbdt_kernels as gk
from transmogrifai_tpu_torch.models import gbdt_kernels as tk

RTOL, ATOL = 1e-5, 1e-4


def _rand(n, d, M, B, nchan=2, seed=0, even_slots_only=False):
    rng = np.random.default_rng(seed)
    binned = rng.integers(0, B, size=(n, d)).astype(np.uint8)
    slot = rng.integers(0, M, size=(n,)).astype(np.int32)
    if even_slots_only:
        slot = (2 * rng.integers(0, M // 2, size=(n,))).astype(np.int32)
    ch = rng.normal(size=(n, nchan)).astype(np.float32)
    return binned, slot, ch


def _np_ref(binned, slot, ch, M, B):
    n, d = binned.shape
    out = np.zeros((ch.shape[1], M, B, d), np.float32)
    for c in range(ch.shape[1]):
        np.add.at(out[c], (slot[:, None], binned.astype(np.int64),
                           np.arange(d)[None, :]), ch[:, c][:, None])
    return out


def _jax_seg(binned, slot, ch, M, B):
    d = binned.shape[1]
    d_pad = -(-d // gk.SEG_D_BLOCK) * gk.SEG_D_BLOCK
    bp = jnp.pad(jnp.asarray(binned.astype(np.int8)),
                 ((0, 0), (0, d_pad - d)))
    chans = [jnp.asarray(ch[:, c]) for c in range(ch.shape[1])]
    hists = jax.jit(lambda b, s, *cs: gk._seg_level_hists(
        b, s, list(cs), M, B, d))(bp, jnp.asarray(slot), *chans)
    return np.stack([np.asarray(h) for h in hists])


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


class TestSegLevelHistsPlain:
    @pytest.mark.parametrize("n,d,M,even", [(3000, 40, 16, False),
                                            (2000, 16, 32, True),
                                            (500, 130, 1, False)])
    def test_matches_jax_kernel_and_numpy(self, n, d, M, even):
        B = 32
        binned, slot, ch = _rand(n, d, M, B, even_slots_only=even)
        got = tk.seg_level_hists(*_torch(binned, slot, ch), M, B).numpy()
        assert got.shape == (2, M, B, d) and got.dtype == np.float32
        np.testing.assert_allclose(got, _np_ref(binned, slot, ch, M, B),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got, _jax_seg(binned, slot, ch, M, B),
                                   rtol=RTOL, atol=ATOL)
        if even:
            assert (got[:, 1::2] == 0).all()

    def test_cpu_tensors_take_the_plain_version(self):
        binned, slot, ch = _rand(300, 8, 4, 32)
        before = tk.seg_level_hists.launches
        a = tk.seg_level_hists(*_torch(binned, slot, ch), 4, 32)
        b = tk.seg_level_hists_plain(*_torch(binned, slot, ch), 4, 32)
        assert torch.equal(a, b)
        assert tk.seg_level_hists.launches == before

    @pytest.mark.parametrize("bad", ["binned_dtype", "slot_dtype",
                                     "ch_shape", "ch_channels", "noncontig",
                                     "bins_over_shared_memory",
                                     "slots_over_grid"])
    def test_rejects_bad_inputs(self, bad):
        binned, slot, ch = _torch(*_rand(64, 8, 4, 32))
        M, B = 4, 32
        if bad == "binned_dtype":
            binned = binned.to(torch.int32)
        elif bad == "slot_dtype":
            slot = slot.to(torch.int64)
        elif bad == "ch_shape":
            ch = ch[:10]
        elif bad == "ch_channels":   # the kernel takes gradient, hessian
            ch = ch[:, :1].repeat(1, 4).contiguous()
        elif bad == "bins_over_shared_memory":   # 2 x B x 128 f32 > 227 KiB
            B = tk.SEG_MAX_BINS + 1
        elif bad == "slots_over_grid":   # one reduce grid row per slot
            M = tk.SEG_MAX_SLOTS + 1
        else:
            binned = binned.T.contiguous().T
        with pytest.raises((TypeError, ValueError)):
            tk.seg_level_hists(binned, slot, ch, M, B)


def _tree_inputs(n=4000, d=24, seed=3):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    X[:, 5] = np.where(rng.random(n) < 0.7, 0.0, np.abs(X[:, 5]))
    y = (X[:, 0] - 0.5 * X[:, 3] + 0.3 * rng.normal(size=n) > 0
         ).astype(np.float32)
    edges = gk.quantile_bins(X, 32)
    return X, y, edges


class TestGrowTreeParity:
    @pytest.mark.parametrize("case", ["dense", "sampled"])
    def test_quantile_edges_match(self, case):
        """Edges from the port's sorted columns equal the JAX package's
        ``np.quantile`` of the unsorted sample, also with a row sample,
        signed zeros, ties and a NaN column."""
        X, _, _ = _tree_inputs()
        kw = {}
        if case == "sampled":
            X[::3, 1] = -0.0
            X[:, 2] = np.round(X[:, 2])
            X[::50, 4] = np.nan
            kw = dict(sample_rows=1500, seed=5)
        np.testing.assert_array_equal(
            tk.quantile_bins(torch.from_numpy(X), 32, **kw),
            gk.quantile_bins(X, 32, **kw))

    def test_binning_matches(self):
        X, _, edges = _tree_inputs()
        X[::97, 2] = np.nan
        ref = np.asarray(gk.apply_bins(jnp.asarray(X), jnp.asarray(edges)))
        got = tk.apply_bins(torch.from_numpy(X), edges).numpy()
        np.testing.assert_array_equal(got.astype(np.int32), ref)

    @pytest.mark.parametrize("seg_env", ["1", "0"])
    @pytest.mark.parametrize("default_dir", [False, True])
    def test_same_splits_as_jax(self, monkeypatch, seg_env, default_dir):
        monkeypatch.setenv("TMOG_SEG_HIST", seg_env)
        X, y, edges = _tree_inputs()
        n = len(y)
        p = np.full(n, 0.5, np.float32)
        G = (p - y)[:, None].astype(np.float32)
        H = (p * (1 - p))[:, None].astype(np.float32)
        dd = gk.default_dir_mask(edges)
        kw = dict(max_depth=4, n_bins=32, lam=1.0, min_child_weight=1.0,
                  learning_rate=0.3, min_gain_raw=0.1,
                  default_dir=default_dir)
        binned_j = gk.apply_bins(jnp.asarray(X), jnp.asarray(edges))
        f_j, t_j, l_j = gk.grow_tree(
            binned_j, jnp.asarray(G), jnp.asarray(H), jnp.ones(n, jnp.float32),
            min_info_gain=0.0, min_instances=0.0, newton_leaf=True,
            hist_bf16=False, seg_hist=seg_env == "1",
            dd_mask=jnp.asarray(dd) if default_dir else None, **kw)
        binned_t = tk.apply_bins(torch.from_numpy(X), edges)
        tree = tk.grow_tree(binned_t, *_torch(G, H),
                            dd_mask=torch.from_numpy(dd) if default_dir
                            else None, **kw)
        np.testing.assert_array_equal(tree.feat.numpy(), np.asarray(f_j))
        np.testing.assert_array_equal(tree.thresh.numpy(), np.asarray(t_j))
        np.testing.assert_allclose(tree.leaf.numpy(), np.asarray(l_j),
                                   rtol=1e-5, atol=1e-7)
        assert (tree.thresh.numpy() < 32).any()   # at least one real split

    def test_node_compaction_matches_jax(self):
        """Depth past log2(N): levels compact node ids into next_pow2(N)
        slots, as the JAX growth does."""
        X, y, edges = _tree_inputs(n=24, d=6, seed=9)
        G = (0.5 - y)[:, None].astype(np.float32)
        H = np.full((24, 1), 0.25, np.float32)
        kw = dict(max_depth=7, n_bins=32, lam=1.0, min_child_weight=0.0,
                  learning_rate=1.0)
        f_j, t_j, l_j = gk.grow_tree(
            gk.apply_bins(jnp.asarray(X), jnp.asarray(edges)),
            jnp.asarray(G), jnp.asarray(H), jnp.ones(24, jnp.float32),
            min_instances=0.0, hist_bf16=False, seg_hist=False, **kw)
        tree = tk.grow_tree(tk.apply_bins(torch.from_numpy(X), edges),
                            *_torch(G, H), **kw)
        np.testing.assert_array_equal(tree.feat.numpy(), np.asarray(f_j))
        np.testing.assert_array_equal(tree.thresh.numpy(), np.asarray(t_j))
        np.testing.assert_allclose(tree.leaf.numpy(), np.asarray(l_j),
                                   rtol=1e-5, atol=1e-7)

    def test_predict_matches_jax(self):
        X, y, edges = _tree_inputs(n=1500, d=10)
        rng = np.random.default_rng(1)
        T, depth = 5, 4
        feat = rng.integers(0, 10, size=(T, 2 ** depth - 1)).astype(np.int32)
        thresh = rng.integers(-5, 33, size=(T, 2 ** depth - 1)).astype(
            np.int32)
        leaf = rng.normal(size=(T, 2 ** depth, 1)).astype(np.float32)
        binned_j = gk.apply_bins(jnp.asarray(X), jnp.asarray(edges))
        ref = np.asarray(gk.predict_ensemble(binned_j, jnp.asarray(feat),
                                             jnp.asarray(thresh),
                                             jnp.asarray(leaf), depth))
        binned_t = tk.apply_bins(torch.from_numpy(X), edges)
        got = tk.predict_ensemble(binned_t, *_torch(feat, thresh, leaf),
                                  depth).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
        one = tk.predict_tree(binned_t, *_torch(feat[0], thresh[0], leaf[0]),
                              depth).numpy()
        np.testing.assert_allclose(one, np.asarray(gk.predict_tree(
            binned_j, jnp.asarray(feat[0]), jnp.asarray(thresh[0]),
            jnp.asarray(leaf[0]), depth)), rtol=0, atol=0)
