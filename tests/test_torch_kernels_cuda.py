"""The port's hand-written CUDA kernels on the card, and the layout that
feeds them on the CPU.

The ``cuda`` tests build ``csrc/seg_hist.cu`` with nvcc and compare it with
its plain version on the card (rtol 1e-5, atol 1e-4: float32 sums in
another order); they skip where there is no card.  This file imports no
JAX, so it runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda
"""
import numpy as np
import pytest
import torch

from transmogrifai_tpu_torch.models import gbdt_kernels as tk

RTOL, ATOL = 1e-5, 1e-4


def _rand(n, d, M, B, seed=0, even_slots_only=False):
    """A gradient-like channel in [-1, 1] and a hessian-like in [0, 0.25]."""
    rng = np.random.default_rng(seed)
    binned = rng.integers(0, B, size=(n, d)).astype(np.uint8)
    slot = rng.integers(0, M, size=(n,)).astype(np.int32)
    if even_slots_only:
        slot = (2 * rng.integers(0, M // 2, size=(n,))).astype(np.int32)
    ch = np.concatenate([rng.uniform(-1, 1, (n, 1)),
                         rng.uniform(0, 0.25, (n, 1))],
                        axis=1).astype(np.float32)
    return [torch.from_numpy(a) for a in (binned, slot, ch)]


def _groups(bounds, G):
    """Row groups as ``seg_plan`` states them, in group order: (slot, r0,
    r1) for each piece of a slot's sorted rows cut at multiples of G; slot
    s's first group is s + bounds[s] // G."""
    out = []
    for s in range(len(bounds) - 1):
        b0, b1 = int(bounds[s]), int(bounds[s + 1])
        assert len(out) == s + b0 // G
        for j in range(1 + b1 // G - b0 // G):
            cut = b0 // G + j
            r0 = b0 if j == 0 else cut * G
            out.append((s, r0, max(r0, min(b1, (cut + 1) * G))))
    return out


@pytest.mark.parametrize("M,R,even", [(1, 64, False), (8, 50, False),
                                      (16, 64, True)])
def test_layout_groups_partition_each_slot(M, R, even):
    """The kernel's row layout, replayed on the CPU: every sorted position
    lies in exactly one group, a group never straddles two slots, and the
    groups' partial histograms summed per slot in group order give the
    level's histograms."""
    binned, slot, ch = _rand(700, 9, M, 32, seed=M, even_slots_only=even)
    perm, bounds = tk.seg_layout(slot, M)
    assert perm.dtype == torch.int64 and bounds.dtype == torch.int32
    assert torch.equal(slot[perm], torch.sort(slot).values)
    assert torch.equal(bounds[1:] - bounds[:-1],
                       torch.bincount(slot, minlength=M).int())
    groups = _groups(bounds.numpy(), R)
    assert len(groups) == M + 700 // R
    seen = torch.zeros(700, dtype=torch.int32)
    part = torch.zeros((len(groups), 2, 32, 9))
    for g, (s, r0, r1) in enumerate(groups):
        assert r1 - r0 <= R
        seen[r0:r1] += 1
        rows = perm[r0:r1]
        assert (slot[rows] == s).all()
        for r in rows:
            part[g, :, binned[r].long(), torch.arange(9)] += ch[r][:, None]
    assert (seen == 1).all()
    out = torch.zeros((2, M, 32, 9))
    for g, (s, _, _) in enumerate(groups):
        out[:, s] += part[g]
    plain = tk.seg_level_hists_plain(binned, slot, ch, M, 32)
    np.testing.assert_allclose(out.numpy(), plain.numpy(), rtol=RTOL,
                               atol=ATOL)
    if even:
        assert (out[:, 1::2] == 0).all()


def _replay(plan, binned, slot, ch, M, B):
    """The kernel's launch, replayed block by block on the CPU as
    ``seg_plan`` states it: returns the level's histograms and how often
    each (sorted row, column) was added.  Each warp adds its rows in order
    into a float32 partial, the block adds its warps' partials in warp
    order, and each slot's block partials are added in group order in
    float64."""
    n, d = binned.shape
    perm, bounds = (t.numpy() for t in tk.seg_layout(slot, M))
    binned, slot, ch = binned.numpy(), slot.numpy(), ch.numpy()
    groups = _groups(bounds, plan.group_rows)
    assert len(groups) == plan.n_groups
    cover = np.zeros((n, d), np.int32)
    scratch = np.full((plan.n_groups, 2, B, plan.width), np.nan,
                      np.float32)
    for i in range(plan.n_blocks):
        g, t = divmod(i, plan.n_tiles)
        s, r0, r1 = groups[g]
        q = -(-(r1 - r0) // plan.warps)
        block = None
        for w in range(plan.warps):
            a = min(r0 + w * q, r1)
            e = min(a + q, r1)
            assert e - a <= plan.rows_per_warp
            # no warp sub-range straddles two slots
            assert bounds[s] <= a <= e <= bounds[s + 1]
            assert (slot[perm[a:e]] == s).all()
            hist = np.zeros((2, B, tk.SEG_TILE), np.float32)
            for lane in range(32):
                col = t * tk.SEG_TILE + 4 * lane
                if col >= d:
                    continue
                cols = np.arange(col, min(col + 4, d))
                cover[a:e, cols] += 1
                rows = perm[a:e]
                for c in range(2):
                    np.add.at(hist[c], (binned[rows][:, cols].astype(np.int64),
                                        cols - t * tk.SEG_TILE),
                              ch[rows, c][:, None])
            block = hist if block is None else block + hist
        tile = scratch[g, :, :, t * tk.SEG_TILE:(t + 1) * tk.SEG_TILE]
        assert np.isnan(tile).all()   # each (group, tile) written once
        tile[...] = block
    out = np.zeros((2, M, B, d), np.float64)
    for g, (s, _, _) in enumerate(groups):
        out[:, s] += scratch[g, :, :, :d]
    return out.astype(np.float32), cover


@pytest.mark.parametrize("d", [9, 61, 130])
@pytest.mark.parametrize("M,even", [(1, False), (8, False), (32, True),
                                    (512, False)])
def test_plan_replay_covers_every_row_once(M, even, d, monkeypatch):
    """``seg_plan``'s geometry, replayed: every (sorted row, column) is
    added by exactly one (block, warp, lane word), and the replayed sums
    equal the plain version.  Three warps of 16 rows make many groups and
    uneven warp sub-ranges at a small N."""
    B = 32
    binned, slot, ch = _rand(3000, d, M, B, seed=d + M,
                             even_slots_only=even)
    monkeypatch.setattr(tk, "SEG_WARPS", 3)
    monkeypatch.setattr(tk, "SEG_ROWS_PER_WARP", 16)
    plan = tk.seg_plan(3000, d, M, B, 2)
    assert plan.group_rows == 48 and plan.n_tiles == -(-d // 128)
    assert plan.n_groups == M + 3000 // 48
    got, cover = _replay(plan, binned, slot, ch, M, B)
    assert (cover == 1).all()
    plain = tk.seg_level_hists_plain(binned, slot, ch, M, B).numpy()
    np.testing.assert_allclose(got, plain, rtol=RTOL, atol=ATOL)
    if even:
        assert (got[:, 1::2] == 0).all()


def test_plan_fits_shared_memory(monkeypatch):
    """Warps are cut to what B's histograms leave room for; the largest B
    still fits one warp."""
    p = tk.seg_plan(1_000_000, 500, 32, 32, 2)
    assert p.warps == tk.SEG_WARPS and p.smem_bytes <= 232_448
    assert p.n_blocks == p.n_groups * 4 and p.width == 512
    assert p.n_groups == 32 + 1_000_000 // p.group_rows
    monkeypatch.setattr(tk, "SEG_WARPS", 6)
    big = tk.seg_plan(1000, 8, 1, tk.SEG_MAX_BINS, 2)
    assert big.warps == 1 and big.smem_bytes <= 232_448
    with pytest.raises(ValueError):
        tk.seg_plan(1000, 8, 1, tk.SEG_MAX_BINS + 1, 2)


def test_launcher_passes_pointers_as_void_p(monkeypatch):
    """Untyped ctypes arguments would cut each pointer to 32 bits."""
    import ctypes
    import types

    from transmogrifai_tpu_torch import cuda_build

    lib = types.SimpleNamespace(seg_hist_launch=types.SimpleNamespace())
    monkeypatch.setattr(cuda_build, "load_library", lambda name: lib)
    fn = tk._seg_lib()
    assert fn.argtypes == ([ctypes.c_void_p] * 6 + [ctypes.c_longlong]
                           + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    assert fn.restype is ctypes.c_int


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the seg_hist kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("M,even", [(1, False), (8, False), (32, True),
                                    (512, False)])
def test_seg_hist_matches_plain_and_is_deterministic(cuda_device, M, even):
    args = [t.to(cuda_device) for t in _rand(50_000, 300, M, 32,
                                              even_slots_only=even)]
    _check_kernel(args, M, 32, even)


def _check_kernel(args, M, B, even=False):
    """Two launches are bitwise identical and agree with the plain
    version; empty (odd) slots are exactly 0."""
    before = tk.seg_level_hists.launches
    a = tk.seg_level_hists(*args, M, B)
    b = tk.seg_level_hists(*args, M, B)
    torch.cuda.synchronize()
    assert tk.seg_level_hists.launches == before + 2
    assert torch.equal(a, b)
    plain = tk.seg_level_hists_plain(*args, M, B)
    np.testing.assert_allclose(a.cpu().numpy(), plain.cpu().numpy(),
                               rtol=RTOL, atol=ATOL)
    if even:
        assert (a[:, 1::2] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["d61_apply_bins", "B2", "B_max"])
def test_seg_hist_shapes_match_plain(cuda_device, case):
    """d=61 through apply_bins' padded rows (the last word of a row holds
    a padding byte), the fewest bins, and the most one warp fits."""
    M, B, d = 32, 32, 300
    if case == "d61_apply_bins":
        d = 61
        rng = np.random.default_rng(5)
        X = torch.from_numpy(rng.normal(size=(50_000, d)).astype(np.float32))
        edges = tk.quantile_bins(X, B)
        binned = tk.apply_bins(X.to(cuda_device), edges)
        assert binned.stride() == (64, 1)   # 16-byte row copies
        _, slot, ch = _rand(50_000, 1, M, B, seed=6)
        args = [binned] + [t.to(cuda_device) for t in (slot, ch)]
    else:
        B = 2 if case == "B2" else tk.SEG_MAX_BINS
        M = 8
        args = [t.to(cuda_device) for t in _rand(50_000, d, M, B, seed=B)]
    _check_kernel(args, M, B)


@pytest.mark.cuda
@pytest.mark.parametrize("warps", [1, 2, 3, 4, 6])
def test_seg_hist_every_block_shape_matches_plain(cuda_device, warps,
                                                  monkeypatch):
    """The kernel is right at every block shape (warps per block) that
    fits B=32, not only at the default ``SEG_WARPS``."""
    M, B = 16, 32
    args = [t.to(cuda_device) for t in _rand(50_000, 300, M, B, seed=warps)]
    monkeypatch.setattr(tk, "SEG_WARPS", warps)
    assert tk.seg_plan(50_000, 300, M, B, 2).warps == warps
    _check_kernel(args, M, B)


@pytest.mark.cuda
def test_grow_tree_kernel_matches_plain(cuda_device):
    rng = np.random.default_rng(3)
    X = rng.normal(size=(20_000, 40)).astype(np.float32)
    y = (X[:, 0] - 0.5 * X[:, 3] + 0.3 * rng.normal(size=len(X)) > 0
         ).astype(np.float32)
    edges = tk.quantile_bins(torch.from_numpy(X), 32)
    G = torch.from_numpy((0.5 - y)[:, None]).to(cuda_device)
    H = torch.full((len(y), 1), 0.25, device=cuda_device)
    binned = tk.apply_bins(torch.from_numpy(X).to(cuda_device), edges)
    kw = dict(max_depth=6, n_bins=32, lam=1.0, min_child_weight=1.0)
    k = tk.grow_tree(binned, G, H, **kw)
    p = tk.grow_tree(binned, G, H, hist_fn=tk.seg_level_hists_plain, **kw)
    assert torch.equal(k.feat, p.feat) and torch.equal(k.thresh, p.thresh)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 512, 2048])
def test_seg_hist_forest_levels_bitwise(cuda_device, M):
    """The forests' levels: d = 22 subset columns in 32-byte rows, integer
    channels (bw [y=0], bw) of Poisson bag counts.  Every sum is an exact
    integer below 2^24, so the kernel equals the plain version bitwise."""
    rng = np.random.default_rng(M)
    n, d, B = 200_000, 22, 32
    binned = tk.binned_empty(n, d, cuda_device)
    binned.copy_(torch.from_numpy(
        rng.integers(0, B, size=(n, d)).astype(np.uint8)))
    assert binned.stride() == (32, 1)
    bw = rng.poisson(1.0, n).astype(np.float32)
    y0 = (rng.random(n) < 0.5).astype(np.float32)
    ch = torch.from_numpy(np.stack([bw * y0, bw], 1)).to(cuda_device)
    slot = torch.from_numpy(rng.integers(0, M, n).astype(np.int32)).to(
        cuda_device)
    a = tk.seg_level_hists(binned, slot, ch, M, B)
    b = tk.seg_level_hists(binned, slot, ch, M, B)
    plain = tk.seg_level_hists_plain(binned, slot, ch, M, B)
    assert torch.equal(a, b) and torch.equal(a, plain)


def _class_channels(rng, n, K):
    """A K-class forest level's integer channels: (bw [y=0], ..,
    bw [y=K-2], bw) of Poisson bag counts and uniform labels."""
    bw = rng.poisson(1.0, n).astype(np.float32)
    y = rng.integers(0, K, n)
    return np.stack([bw * (y == k) for k in range(K - 1)] + [bw],
                    1).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("nchan", [3, 5, 13, 14, 100])
def test_seg_hist_channel_counts_bitwise(cuda_device, nchan):
    """K-class forest levels at C = K channels (d = 22 subset columns in
    32-byte rows, M = 64): one launch up to 13 channels at 32 bins, one per
    channel group past it; integer channels, so every launch equals the
    plain version bitwise."""
    rng = np.random.default_rng(nchan)
    n, d, M, B = 200_000, 22, 64, 32
    binned = tk.binned_empty(n, d, cuda_device)
    binned.copy_(torch.from_numpy(
        rng.integers(0, B, size=(n, d)).astype(np.uint8)))
    ch = torch.from_numpy(_class_channels(rng, n, nchan)).to(cuda_device)
    slot = torch.from_numpy(rng.integers(0, M, n).astype(np.int32)).to(
        cuda_device)
    before = tk.seg_level_hists.launches
    a = tk.seg_level_hists(binned, slot, ch, M, B)
    torch.cuda.synchronize()
    assert (tk.seg_level_hists.launches - before
            == len(tk.seg_channel_groups(nchan, B)))
    assert len(tk.seg_channel_groups(nchan, B)) == (1 if nchan <= 13 else
                                                    -(-nchan // 13))
    b = tk.seg_level_hists(binned, slot, ch, M, B)
    plain = tk.seg_level_hists_plain(binned, slot, ch, M, B)
    assert torch.equal(a, b) and torch.equal(a, plain)


def _general_channels(rng, n, nchan, integer):
    """The general grower's 2K+1 channels [G_0..G_{K-1}, H_0..H_{K-1}, C]
    for K = (nchan - 1) // 2, the count channel the odd one last: float
    softmax gradients in [-1, 1], hessians in [0, 0.25] and 0/1 fold
    weights; or a decision tree's integer channels (w [y=k], w in each
    hessian column, w) of Poisson weights."""
    K = (nchan - 1) // 2
    if integer:
        w = rng.poisson(1.0, n).astype(np.float32)
        y = rng.integers(0, K, n)
        cols = [w * (y == k) for k in range(K)] + [w] * K + [w]
    else:
        cols = ([rng.uniform(-1, 1, n) for _ in range(K)]
                + [rng.uniform(0, 0.25, n) for _ in range(K)]
                + [(rng.random(n) < 2 / 3).astype(np.float32)])
    return np.stack(cols, 1).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("nchan", [3, 5, 7, 11, 15])
@pytest.mark.parametrize("integer", [False, True])
def test_seg_hist_general_grower_channels(cuda_device, nchan, integer):
    """The general grower's levels at C = 2K+1 channels, the count last
    (an odd channel after the float2 pairs; 15 runs as groups of 8 + 7):
    d = 500 columns in padded rows, M = 32.  Float channels within the
    tolerance of |channels| (signed gradients cancel); integer-valued
    channels bitwise equal to the plain version; two launches bitwise
    equal."""
    rng = np.random.default_rng(100 + nchan)
    n, d, M, B = 100_000, 500, 32, 32
    binned = tk.binned_empty(n, d, cuda_device)
    binned.copy_(torch.from_numpy(
        rng.integers(0, B, size=(n, d)).astype(np.uint8)))
    ch = torch.from_numpy(_general_channels(rng, n, nchan, integer)).to(
        cuda_device)
    slot = torch.from_numpy(rng.integers(0, M, n).astype(np.int32)).to(
        cuda_device)
    groups = tk.seg_channel_groups(nchan, B)
    assert [w for _, w in groups] == ([8, 7] if nchan == 15 else [nchan])
    before = tk.seg_level_hists.launches
    a = tk.seg_level_hists(binned, slot, ch, M, B)
    torch.cuda.synchronize()
    assert tk.seg_level_hists.launches - before == len(groups)
    b = tk.seg_level_hists(binned, slot, ch, M, B)
    plain = tk.seg_level_hists_plain(binned, slot, ch, M, B)
    assert torch.equal(a, b)
    if integer:
        assert torch.equal(a, plain)
    else:
        mag = tk.seg_level_hists_plain(binned, slot, ch.abs(), M, B)
        assert bool(((a - plain).abs() <= ATOL + RTOL * mag).all())


@pytest.mark.cuda
def test_decision_tree_kernel_matches_plain(cuda_device):
    """A 3-class decision tree on the card (2K+1 = 7 integer channels, the
    count gates on) grown through the kernel and through the plain version:
    identical trees and leaves."""
    rng = np.random.default_rng(8)
    n = 40_000
    X = rng.normal(size=(n, 30)).astype(np.float32)
    y = (np.argmax(X[:, :3] + rng.gumbel(size=(n, 3)), 1)).astype(
        np.float32)
    binned = tk.apply_bins(torch.from_numpy(X).to(cuda_device),
                           tk.quantile_bins(torch.from_numpy(X), 32))
    Y = torch.nn.functional.one_hot(
        torch.from_numpy(y).long(), 3).float().to(cuda_device)
    w = torch.ones(n, device=cuda_device)
    kw = dict(C=w, lam=1e-3, min_instances=10.0, min_info_gain=0.001,
              newton_leaf=False)
    k = tk.grow_tree(binned, Y, w[:, None].repeat(1, 3), 8, 32, **kw)
    p = tk.grow_tree(binned, Y, w[:, None].repeat(1, 3), 8, 32,
                     hist_fn=tk.seg_level_hists_plain, **kw)
    assert torch.equal(k.feat, p.feat) and torch.equal(k.thresh, p.thresh)
    assert torch.equal(k.leaf, p.leaf)
    assert int((k.thresh < 32).sum()) > 10


@pytest.mark.cuda
def test_multiclass_xgb_fits_on_card(cuda_device):
    """A softmax XGBoost fit (K = 4, row and column subsampling, early
    stopping) on the card through the kernel, scoring finite probabilities
    that sum to 1; its levels launch the kernel once each."""
    from transmogrifai_tpu_torch.models.trees import OpXGBoostClassifier

    rng = np.random.default_rng(12)
    n = 30_000
    X = rng.normal(size=(n, 20)).astype(np.float32)
    y = np.argmax(X[:, :4] + rng.gumbel(size=(n, 4)), 1).astype(np.float32)
    est = OpXGBoostClassifier(num_round=12, max_depth=5, eta=0.3,
                              subsample=0.8, colsample_bytree=0.5,
                              early_stopping_rounds=4)
    before = tk.seg_level_hists.launches
    model = est.fit_raw(X, y, device="cuda")
    assert tk.seg_level_hists.launches - before == est.metadata[
        "hist_levels"] == 5 * est.metadata["rounds_grown"]
    assert model.mode == "gbdt_multi" and model.leaf.shape[-1] == 4
    p = model.predict_batch(torch.from_numpy(X).to(cuda_device)).probability
    assert p.device.type == "cuda" and bool(torch.isfinite(p).all())
    assert torch.allclose(p.sum(1), torch.ones(n, device=cuda_device))
    acc = float((p.argmax(1).cpu() == torch.from_numpy(y).long()).float()
                .mean())
    assert acc > 0.4      # the Bayes rule: 0.51, chance 0.25


@pytest.mark.cuda
def test_seg_hist_grouped_channels_take_any_base(cuda_device):
    """14 channels run as two groups, each copied into rows of its own, so
    a ``ch`` 4 bytes off its 8-byte row copy launches and equals the plain
    version bitwise."""
    rng = np.random.default_rng(14)
    n, d, M, B, nchan = 200_000, 22, 64, 32, 14
    binned = tk.binned_empty(n, d, cuda_device)
    binned.copy_(torch.from_numpy(
        rng.integers(0, B, size=(n, d)).astype(np.uint8)))
    flat = torch.empty(n * nchan + 1, device=cuda_device)
    ch = flat[1:].view(n, nchan)
    ch.copy_(torch.from_numpy(_class_channels(rng, n, nchan)))
    assert ch.data_ptr() % 8 == 4
    slot = torch.from_numpy(rng.integers(0, M, n).astype(np.int32)).to(
        cuda_device)
    before = tk.seg_level_hists.launches
    got = tk.seg_level_hists(binned, slot, ch, M, B)
    torch.cuda.synchronize()
    assert tk.seg_level_hists.launches - before == 2
    assert torch.equal(got, tk.seg_level_hists_plain(binned, slot, ch, M, B))


@pytest.mark.cuda
@pytest.mark.parametrize("nchan", [1, 4, 10])
def test_seg_hist_float_channels(cuda_device, nchan):
    """Float channels (a softmax objective's gradients and hessians at
    d = 500): within the tolerance of the plain version, and two launches
    bitwise equal."""
    rng = np.random.default_rng(nchan + 7)
    n, d, M, B = 100_000, 500, 32, 32
    binned = tk.binned_empty(n, d, cuda_device)
    binned.copy_(torch.from_numpy(
        rng.integers(0, B, size=(n, d)).astype(np.uint8)))
    ch = rng.uniform(-1, 1, (n, nchan)).astype(np.float32)
    slot = torch.from_numpy(rng.integers(0, M, n).astype(np.int32))
    _check_kernel([binned, slot.to(cuda_device),
                   torch.from_numpy(ch).to(cuda_device)], M, B)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 512, 2048])
def test_seg_hist_titanic_levels_bitwise(cuda_device, M):
    """The Titanic demo's forest levels: d = 23 subset columns (the square
    root of its ~575 checked columns) in 32-byte rows, 1M rows of a
    mostly zero matrix binned by the nonzero-aware sketch, so ~96% of the
    entries fall in bin 0 (the zeros, at the pinned 0 edge), integer channels
    (bw [y=0], bw) of Poisson bags: every sum an exact integer, so the
    kernel equals the plain version bitwise."""
    rng = np.random.default_rng(M + 1)
    n, d, B = 1_000_000, 23, 32
    bins = np.where(rng.random((n, d)) < 0.96, 0,
                    rng.integers(0, B, size=(n, d))).astype(np.uint8)
    binned = tk.binned_empty(n, d, cuda_device)
    binned.copy_(torch.from_numpy(bins))
    assert binned.stride() == (32, 1)
    bw = rng.poisson(1.0, n).astype(np.float32)
    y0 = (rng.random(n) < 0.5).astype(np.float32)
    ch = torch.from_numpy(np.stack([bw * y0, bw], 1)).to(cuda_device)
    slot = torch.from_numpy(rng.integers(0, M, n).astype(np.int32)).to(
        cuda_device)
    a = tk.seg_level_hists(binned, slot, ch, M, B)
    b = tk.seg_level_hists(binned, slot, ch, M, B)
    plain = tk.seg_level_hists_plain(binned, slot, ch, M, B)
    assert torch.equal(a, b) and torch.equal(a, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("d,M", [(169, 1), (169, 64), (169, 2048),
                                 (508, 1024), (508, 2048)])
def test_seg_hist_regression_levels(cuda_device, d, M):
    """The regression paths' levels at the widths of the smoke's checked
    matrix (508 columns): a forest's one-third subset (d = 169, rows
    padded to 176 bytes) with float channels (bw y, bw) of a
    Boston-scaled label (mean 22.5, sd 9) and Poisson bags, and the
    boosted chains' depth-12 levels (d = 508, M up to 2048) with
    channels (w (F - y), w).  Float sums: within the tolerance of the
    plain version, and two launches bitwise equal."""
    rng = np.random.default_rng(d + M)
    n, B = 200_000, 32
    binned = tk.binned_empty(n, d, cuda_device)
    binned.copy_(torch.from_numpy(
        rng.integers(0, B, size=(n, d)).astype(np.uint8)))
    y = (22.5 + 9 * rng.normal(size=n)).astype(np.float32)
    if d == 169:
        assert binned.stride() == (176, 1)
        w = rng.poisson(1.0, n).astype(np.float32)
        ch = np.stack([w * y, w], 1)
    else:
        w = (rng.random(n) < 2 / 3).astype(np.float32)
        ch = np.stack([w * (22.5 - y), w], 1)
    slot = torch.from_numpy(rng.integers(0, M, n).astype(np.int32))
    _check_kernel([binned, slot.to(cuda_device),
                   torch.from_numpy(ch.astype(np.float32)).to(cuda_device)],
                  M, B)


@pytest.mark.cuda
def test_regression_forest_and_chains_on_card(cuda_device, monkeypatch):
    """A regression forest grid and a lockstep GBT group on the card: the
    forest through the kernel equals the one through the plain version
    up to float sums (same splits, leaves within 1e-5 relative); boosted
    chains (depths 3 and 7, then one depth-8 chain on GOSS row samples)
    grown through the kernel with every level's histograms within the
    tolerance of the plain version on the same inputs; the kernel's
    launches equal the growers' counts."""
    from transmogrifai_tpu_torch.models.trees import (OpGBTRegressor,
                                                      boost_chains)
    from transmogrifai_tpu_torch.selector.grid_groups import GBTGridGroup

    rng = np.random.default_rng(9)
    n = 30_000
    X = rng.normal(size=(n, 30)).astype(np.float32)
    y = (22.5 + 5 * X[:, 0] + 3 * np.tanh(X[:, 1] * X[:, 2])
         + 2 * rng.normal(size=n)).astype(np.float32)
    Xc = torch.from_numpy(X).to(cuda_device)
    edges = tk.quantile_bins(torch.from_numpy(X), 32)
    binned = tk.apply_bins(Xc, edges)
    folds = torch.arange(n, device=cuda_device) % 3
    W = torch.stack([(folds != k).to(torch.float32) for k in range(3)])
    kw = dict(seed=3, n_trees=2, pair_fold=[0, 1, 2],
              pair_min_ig=[0.001, 0.01, 0.1], pair_min_inst=[10, 100, 10],
              pair_depth=[8, 8, 5], msub=10, subsample_rate=1.0, n_bins=32,
              leaf_levels=(3,), regression=True)
    yt = torch.from_numpy(y).to(cuda_device)
    before = tk.seg_level_hists.launches
    k = tk.grow_rf_grid(binned, yt, W, **kw)
    assert tk.seg_level_hists.launches - before == k.levels > 0
    p = tk.grow_rf_grid(binned, yt, W, hist_fn=tk.seg_level_hists_plain,
                        **kw)
    assert torch.equal(k.feat, p.feat) and torch.equal(k.thresh, p.thresh)
    np.testing.assert_allclose(k.leaf.cpu().numpy(), p.leaf.cpu().numpy(),
                               rtol=1e-5)

    checked = []

    def hist_checked(b, slot, ch, M, B):
        got = tk.seg_level_hists(b, slot, ch, M, B)
        torch.testing.assert_close(
            got, tk.seg_level_hists_plain(b, slot, ch, M, B), rtol=RTOL,
            atol=ATOL)
        checked.append(b.shape[0])
        return got

    ests = [OpGBTRegressor(max_depth=dd, max_iter=4) for dd in (3, 7)]
    grown = boost_chains(ests, binned, edges, yt, W[:2],
                         torch.full((2,), 22.5), [], hist_fn=hist_checked)
    assert grown.goss is None and len(checked) == grown.levels == 4 * 10
    monkeypatch.setenv("TMOG_GOSS", "1")
    deep = boost_chains([OpGBTRegressor(max_depth=8, max_iter=2)], binned,
                        edges, yt, W[:1], torch.full((1,), 22.5), [],
                        hist_fn=hist_checked)
    assert deep.goss == (6000, 6000)
    assert checked[40:] == [12_000] * 16 == [12_000] * deep.levels
    monkeypatch.delenv("TMOG_GOSS")

    f = (folds.cpu().numpy())
    ctxs = [((f != i).astype(np.float32), (f == i).astype(np.float32))
            for i in range(3)]
    g = GBTGridGroup(OpGBTRegressor(), [dict(max_depth=dd, max_iter=4)
                                        for dd in (3, 7)],
                     "RootMeanSquaredError")
    before = tk.seg_level_hists.launches
    m = g.run(Xc, y, ctxs)
    assert tk.seg_level_hists.launches - before == g.hist_levels == 4 * 3 * 10
    assert m.shape == (2, 3) and bool(torch.isfinite(m).all())


@pytest.mark.cuda
def test_rf_grid_kernel_matches_plain(cuda_device):
    """A small forest grid grown on the card through the kernel and through
    the plain version: integer channels, so identical trees, leaves and
    truncation snapshots."""
    rng = np.random.default_rng(4)
    n = 30_000
    X = rng.normal(size=(n, 49)).astype(np.float32)
    y = (X[:, 0] - 0.5 * X[:, 3] + 0.5 * rng.normal(size=n) > 0
         ).astype(np.float32)
    binned = tk.apply_bins(torch.from_numpy(X).to(cuda_device),
                           tk.quantile_bins(torch.from_numpy(X), 32))
    folds = torch.arange(n, device=cuda_device) % 3
    W = torch.stack([(folds != k).to(torch.float32) for k in range(3)])
    kw = dict(seed=2, n_trees=3, pair_fold=[0, 1, 2, 0],
              pair_min_ig=[0.001, 0.01, 0.0, 0.1],
              pair_min_inst=[10, 100, 1, 10], pair_depth=[9, 9, 6, 9],
              msub=7, subsample_rate=1.0, n_bins=32, leaf_levels=(3, 6))
    yt = torch.from_numpy(y).to(cuda_device)
    before = tk.seg_level_hists.launches
    k = tk.grow_rf_grid(binned, yt, W, **kw)
    assert tk.seg_level_hists.launches - before == k.levels > 0
    p = tk.grow_rf_grid(binned, yt, W, hist_fn=tk.seg_level_hists_plain,
                        **kw)
    assert torch.equal(k.feat, p.feat) and torch.equal(k.thresh, p.thresh)
    assert torch.equal(k.leaf, p.leaf)
    assert all(torch.equal(k.snaps[lv], p.snaps[lv]) for lv in (3, 6))
    assert int((k.thresh < 32).sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["xgb", "selector"])
def test_trained_model_saves_loads_and_serves_on_card(cuda_device, kind,
                                                      tmp_path):
    """A small port model trained on the card (a boosted model through the
    kernel, or the selector over LR + a forest), saved and loaded on the
    card, scores bitwise equal; the server answers from the card with no
    host fallback and the same scores within 1e-6."""
    from transmogrifai_tpu_torch.features.builder import FeatureBuilder
    from transmogrifai_tpu_torch.models.classification import \
        OpLogisticRegression
    from transmogrifai_tpu_torch.models.trees import (
        OpRandomForestClassifier, OpXGBoostClassifier)
    from transmogrifai_tpu_torch.ops.transmogrify import transmogrify
    from transmogrifai_tpu_torch.preparators.sanity_checker import \
        SanityChecker
    from transmogrifai_tpu_torch.selector.model_selector import (
        BinaryClassificationModelSelector, grid)
    from transmogrifai_tpu_torch.serving import ModelServer
    from transmogrifai_tpu_torch.types import feature_types as ft
    from transmogrifai_tpu_torch.types.columns import (ColumnarDataset,
                                                       FeatureColumn)
    from transmogrifai_tpu_torch.workflow.workflow import (OpWorkflow,
                                                           OpWorkflowModel)

    rng = np.random.default_rng(9)
    n, d = 6000, 8
    X = rng.normal(size=(n, d))
    y = (X[:, 0] - 0.7 * X[:, 2] + 0.5 * rng.normal(size=n) > 0).astype(
        np.float64)
    data = ColumnarDataset(
        {**{f"x{j}": FeatureColumn.from_values(ft.Real, X[:, j])
            for j in range(d)},
         "label": FeatureColumn.from_values(ft.RealNN, y)})
    label = FeatureBuilder.RealNN("label").as_response()
    checked = label.transform_with(
        SanityChecker(max_correlation=0.99),
        transmogrify([FeatureBuilder.Real(f"x{j}").as_predictor()
                      for j in range(d)]))
    est = (OpXGBoostClassifier(max_depth=4, num_round=10)
           if kind == "xgb" else
           BinaryClassificationModelSelector.with_cross_validation(
               models_and_parameters=[
                   (OpLogisticRegression(), grid(reg_param=[0.01])),
                   (OpRandomForestClassifier(),
                    grid(num_trees=[5], max_depth=[4]))]))
    pred = label.transform_with(est, checked)
    model = OpWorkflow(device="cuda").set_result_features(pred) \
        .set_input_data(data).train()
    path = str(tmp_path / "m")
    model.save(path)
    loaded = OpWorkflowModel.load(path, device="cuda")
    a = model.score(data)[pred.name].values.probability
    b = loaded.score(data)[pred.name].values.probability
    assert a.device.type == "cuda" and b.device.type == "cuda"
    assert torch.equal(a, b)

    rows = [{**{f"x{j}": float(X[i, j]) for j in range(d)}}
            for i in range(40)]
    srv = ModelServer.from_path(path, name="m", device="cuda", max_batch=8,
                                warmup_row=rows[0])
    with srv:
        got = [srv.score([r])[0][pred.name]["probability_1"] for r in rows]
    want = a[:40, 1].cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    snap = srv.snapshot()
    assert snap["hostFallbacks"] == 0 and snap["deviceErrors"] == 0
    assert snap["shed"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("d,M", [(2000, 1), (2000, 32), (2000, 512),
                                 (37, 8)])
def test_seg_hist_wide_and_bundled_levels_bitwise(cuda_device, d, M):
    """The wide sparse fit's levels (d = 2000, mostly bin 0) and a bundled
    width (d = 37 in 48-byte rows, bundle bins up to 31), integer channels
    (bag counts): every sum is an exact integer below 2^24, so the kernel
    equals the plain version bitwise."""
    rng = np.random.default_rng(d + M)
    n, B = 100_000, 32
    vals = rng.integers(1, B, size=(n, d)).astype(np.uint8)
    vals[rng.random((n, d)) < (0.95 if d == 2000 else 0.5)] = 0
    binned = tk.binned_empty(n, d, cuda_device)
    binned.copy_(torch.from_numpy(vals))
    bw = rng.poisson(1.0, n).astype(np.float32)
    y0 = (rng.random(n) < 0.5).astype(np.float32)
    ch = torch.from_numpy(np.stack([bw * y0, bw], 1)).to(cuda_device)
    slot = torch.from_numpy(rng.integers(0, M, n).astype(np.int32)).to(
        cuda_device)
    a = tk.seg_level_hists(binned, slot, ch, M, B)
    plain = tk.seg_level_hists_plain(binned, slot, ch, M, B)
    assert torch.equal(a, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 32, 2048])
def test_csr_histogram_on_card_matches_kernel(cuda_device, M):
    """The CSR histogram built on the card from a 95%-zero matrix (its
    rows, bins and zero bins equal to the one built on the CPU) against
    the kernel on the same level: bitwise at integer channels; at float
    channels within ATOL + RTOL x the histogram of |channels| (the float32
    kernel's rounding grows with the sum of the terms' magnitudes, and
    gradients of both signs cancel), the CSR's float64 sums within 1e-5
    of the plain version's."""
    rng = np.random.default_rng(M)
    n, d, B = 60_000, 300, 32
    X = np.zeros((n, d), np.float32)
    cols = rng.integers(0, d, size=(n, 15))
    X[np.repeat(np.arange(n), 15), cols.ravel()] = rng.exponential(
        1.0, size=n * 15).astype(np.float32)
    edges = tk.quantile_bins_sparse_aware(torch.from_numpy(X), B)
    Xc = torch.from_numpy(X).to(cuda_device)
    binned = tk.apply_bins(Xc, edges)
    csr = tk.build_feature_csr(Xc, edges, binned)
    host = tk.build_feature_csr(torch.from_numpy(X), edges,
                                binned.cpu())
    for a, b in zip(csr, host):
        assert torch.equal(a.cpu(), b)
    slot = torch.from_numpy(rng.integers(0, M, n).astype(np.int32)).to(
        cuda_device)
    bw = rng.poisson(1.0, n).astype(np.float32)
    for integer, ch in (
            (True, np.stack([bw * (rng.random(n) < 0.5), bw], 1)),
            (False, np.stack([rng.uniform(-1, 1, n),
                              rng.uniform(0, 0.25, n)], 1))):
        cht = torch.from_numpy(ch.astype(np.float32)).to(cuda_device)
        got = tk.sparse_level_hists(csr, slot, cht, M, B)
        kern = tk.seg_level_hists(binned, slot, cht, M, B)
        plain = tk.seg_level_hists_plain(binned, slot, cht, M, B)
        mag = tk.seg_level_hists_plain(binned, slot, cht.abs(), M, B)
        assert bool(((got - kern).abs() <= ATOL + RTOL * mag).all())
        assert float((got - plain).abs().max()) <= 1e-5
        assert not integer or torch.equal(got, kern)


@pytest.mark.cuda
def test_batched_histograms_on_card_match_host(cuda_device):
    """The RawFeatureFilter's batched histograms on the card equal the
    host's bit for bit (no kernel of its own: plain torch ops whose
    float64 merge arithmetic is one op a rounding on both devices)."""
    from transmogrifai_tpu_torch.utils.streaming_histogram import (
        StreamingHistogram, batched_histograms)

    rng = np.random.default_rng(21)
    X = rng.normal(size=(24, 40_000)).astype(np.float32).astype(np.float64)
    X[3] = np.round(X[3] * 3)                     # heavy duplicates
    X[5, ::7] = np.nan                            # nulls
    X[7] = np.geomspace(1e-3, 1e9, X.shape[1])    # monotone gaps
    valid = torch.from_numpy(rng.random(X.shape) > 0.01)
    C, N, L = batched_histograms(torch.from_numpy(X).to(cuda_device),
                                 valid.to(cuda_device), 100)
    hc, hn, hl = batched_histograms(torch.from_numpy(X), valid, 100)
    assert torch.equal(L.cpu(), hl)
    assert torch.equal(C.cpu(), hc) and torch.equal(N.cpu(), hn)
    for j in (0, 3, 5, 7):
        h = StreamingHistogram(100).update(X[j][valid[j].numpy()])
        m = int(hl[j])
        assert np.array_equal(hc[j, :m].numpy(), h.centroids)
        assert np.array_equal(hn[j, :m].numpy(), h.counts)


@pytest.mark.cuda
def test_ranks_on_card_match_host(cuda_device):
    from transmogrifai_tpu_torch.ops.stats import ranks, spearman_with_label

    rng = np.random.default_rng(22)
    X = rng.integers(0, 50, size=(30_000, 40)).astype(np.float32)
    X[:, 1] = rng.normal(size=30_000)
    y = (rng.random(30_000) < 0.3).astype(np.float32)
    Xt = torch.from_numpy(X)
    assert torch.equal(ranks(Xt.to(cuda_device)).cpu(), ranks(Xt))
    a = spearman_with_label(Xt.to(cuda_device), torch.from_numpy(y).to(
        cuda_device))
    b = spearman_with_label(Xt, torch.from_numpy(y))
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)


@pytest.mark.cuda
def test_loco_on_card_matches_host(cuda_device):
    """LOCO through a logistic model on the card against the same model
    on the CPU: insights within 1e-5, keys equal."""
    import json

    from transmogrifai_tpu_torch.insights import RecordInsightsLOCO
    from transmogrifai_tpu_torch.models.classification import \
        LogisticRegressionModel
    from transmogrifai_tpu_torch.types.columns import FeatureColumn
    from transmogrifai_tpu_torch.types.feature_types import OPVector

    rng = np.random.default_rng(23)
    X = rng.normal(size=(2_000, 60)).astype(np.float32)
    X[:, 5] = 0.0
    coef = rng.normal(size=60).astype(np.float32)
    out = []
    for dev in ("cpu", cuda_device):
        m = LogisticRegressionModel(coef, 0.1, device=str(dev))
        col = FeatureColumn(OPVector, torch.from_numpy(X).to(dev))
        out.append(RecordInsightsLOCO(m, top_k=10).transform_columns(
            col).values)
    for a, b in zip(*out):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_allclose(json.loads(a[k]), json.loads(b[k]),
                                       rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [3, 5, 41])
@pytest.mark.parametrize("M", [1, 8])
def test_seg_hist_single_feature_levels(cuda_device, C, M):
    """The tree bucketizer's levels: d = 1 in 16-byte rows (``apply_bins``
    of an (N, 1) column), B = 32, 2K + 1 channels (C = 41: K = 20 classes,
    four channel groups).  Integer channels (one-hot classes, unit hessians
    and counts) equal the plain version bitwise; a float label channel
    within the tolerance."""
    rng = np.random.default_rng(C * 10 + M)
    n, B = 200_000, 32
    X = torch.from_numpy(rng.lognormal(1.0, 0.8, (n, 1)).astype(
        np.float32)).to(cuda_device)
    edges = tk.quantile_bins(X, B)
    binned = tk.apply_bins(X, edges)
    assert binned.shape == (n, 1) and binned.stride(0) == 16
    k = (C - 1) // 2
    if k > 1:
        cls = rng.integers(0, k, n)
        G = np.eye(k, dtype=np.float32)[cls]
    else:
        G = rng.normal(size=(n, 1)).astype(np.float32)
    ones = np.ones((n, k), np.float32)
    ch = torch.from_numpy(np.concatenate([G, ones, ones[:, :1]], 1)).to(
        cuda_device)
    slot = torch.from_numpy(rng.integers(0, M, n).astype(np.int32)).to(
        cuda_device)
    a = tk.seg_level_hists(binned, slot, ch, M, B)
    plain = tk.seg_level_hists_plain(binned, slot, ch, M, B)
    assert a.shape == (C, M, B, 1)
    if k > 1:
        assert torch.equal(a, plain)
    else:
        np.testing.assert_allclose(a.cpu().numpy(), plain.cpu().numpy(),
                                   rtol=RTOL, atol=ATOL)
        assert torch.equal(a[1:], plain[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["binary", "multiclass", "continuous"])
def test_tree_bucketizer_splits_on_card_match_cpu(cuda_device, kind):
    """DecisionTreeNumericBucketizer's split points grown through the
    kernel on the card equal the CPU's (the plain version)."""
    from transmogrifai_tpu_torch.ops.numeric import tree_split_points

    rng = np.random.default_rng(7)
    n = 100_000
    x = rng.lognormal(1.0, 0.8, n)
    z = np.log(x)
    if kind == "binary":
        y = (1 / (1 + np.exp(-(2 * z - 1.5))) > rng.random(n)).astype(float)
    elif kind == "multiclass":
        y = np.clip(np.floor(z * 2 + rng.normal(0, 0.7, n)), 0, 4)
    else:
        y = 3 * np.sin(z) + rng.normal(0, 0.3, n)
    args = (x, y, 4, 32, 1e-4, 1.0)
    card = tree_split_points(*args, device=str(cuda_device))
    cpu = tree_split_points(*args, device="cpu")
    assert card == cpu and len(card) > 2


@pytest.mark.cuda
def test_word2vec_embedding_on_card_is_bitwise(cuda_device):
    """The Word2Vec model's row means on the card (dense gathers in token
    order, no atomics) equal the CPU's bit for bit, run after run."""
    from transmogrifai_tpu_torch.ops.embeddings import _token_means

    rng = np.random.default_rng(9)
    vecs = rng.normal(0, 0.1, (500, 50)).astype(np.float32)
    ids_of = [list(rng.integers(0, 500, rng.integers(0, 13)))
              for _ in range(20_000)]
    lens = np.array([len(r) for r in ids_of], np.int64)
    cpu = _token_means(torch.from_numpy(vecs), ids_of, lens)
    card = [_token_means(torch.from_numpy(vecs).to(cuda_device), ids_of,
                         lens) for _ in range(2)]
    assert torch.equal(card[0], card[1])
    assert torch.equal(card[0].cpu(), cpu)
