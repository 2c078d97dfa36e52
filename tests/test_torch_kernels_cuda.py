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
    plan = tk.seg_plan(3000, d, M, B)
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
    p = tk.seg_plan(1_000_000, 500, 32, 32)
    assert p.warps == tk.SEG_WARPS and p.smem_bytes <= 232_448
    assert p.n_blocks == p.n_groups * 4 and p.width == 512
    assert p.n_groups == 32 + 1_000_000 // p.group_rows
    monkeypatch.setattr(tk, "SEG_WARPS", 6)
    big = tk.seg_plan(1000, 8, 1, tk.SEG_MAX_BINS)
    assert big.warps == 1 and big.smem_bytes <= 232_448
    with pytest.raises(ValueError):
        tk.seg_plan(1000, 8, 1, tk.SEG_MAX_BINS + 1)


def test_launcher_passes_pointers_as_void_p(monkeypatch):
    """Untyped ctypes arguments would cut each pointer to 32 bits."""
    import ctypes
    import types

    from transmogrifai_tpu_torch import cuda_build

    lib = types.SimpleNamespace(seg_hist_launch=types.SimpleNamespace())
    monkeypatch.setattr(cuda_build, "load_library", lambda name: lib)
    fn = tk._seg_lib()
    assert fn.argtypes == ([ctypes.c_void_p] * 6 + [ctypes.c_longlong]
                           + [ctypes.c_int] * 7 + [ctypes.c_void_p])
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
    assert tk.seg_plan(50_000, 300, M, B).warps == warps
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
