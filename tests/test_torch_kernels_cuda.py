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


@pytest.mark.parametrize("M,R,even", [(1, 64, False), (8, 50, False),
                                      (16, 64, True)])
def test_layout_groups_partition_each_slot(M, R, even):
    """The kernel's row layout, replayed on the CPU: every sorted position
    lies in exactly one group, a group never straddles two slots, and the
    groups' partial histograms summed per slot in group order give the
    level's histograms."""
    binned, slot, ch = _rand(700, 9, M, 32, seed=M, even_slots_only=even)
    perm, ch_sorted, counts, row_off, group_off = tk.seg_layout(slot, ch,
                                                                M, R)
    assert torch.equal(slot[perm.long()], torch.sort(slot).values)
    assert torch.equal(ch_sorted, ch[perm.long()])
    n_groups = int(group_off[-1])
    assert n_groups == int(((counts + R - 1) // R).sum())
    part = torch.zeros((n_groups, 2, 32, 9))
    owner = []
    for s in range(M):
        for g in range(int(group_off[s]), int(group_off[s + 1])):
            r0 = int(row_off[s]) + (g - int(group_off[s])) * R
            r1 = min(r0 + R, int(row_off[s] + counts[s]))
            assert r0 < r1
            rows = perm[r0:r1].long()
            assert (slot[rows] == s).all()
            for r in range(r0, r1):
                b = binned[perm[r].long()].long()
                part[g, :, b, torch.arange(9)] += ch_sorted[r][:, None]
            owner.append(s)
    out = torch.zeros((2, M, 32, 9))
    for g, s in enumerate(owner):
        out[:, s] += part[g]
    plain = tk.seg_level_hists_plain(binned, slot, ch, M, 32)
    np.testing.assert_allclose(out.numpy(), plain.numpy(), rtol=RTOL,
                               atol=ATOL)
    if even:
        assert (out[:, 1::2] == 0).all()


def test_launcher_passes_pointers_as_void_p(monkeypatch):
    """Untyped ctypes arguments would cut each pointer to 32 bits."""
    import ctypes
    import types

    from transmogrifai_tpu_torch import cuda_build

    lib = types.SimpleNamespace(seg_hist_launch=types.SimpleNamespace())
    monkeypatch.setattr(cuda_build, "load_library", lambda name: lib)
    fn = tk._seg_lib()
    assert fn.argtypes == ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                           + [ctypes.c_void_p])
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
    before = tk.seg_level_hists.launches
    a = tk.seg_level_hists(*args, M, 32)
    b = tk.seg_level_hists(*args, M, 32)
    torch.cuda.synchronize()
    assert tk.seg_level_hists.launches == before + 2
    assert torch.equal(a, b)
    plain = tk.seg_level_hists_plain(*args, M, 32)
    np.testing.assert_allclose(a.cpu().numpy(), plain.cpu().numpy(),
                               rtol=RTOL, atol=ATOL)
    if even:
        assert (a[:, 1::2] == 0).all()


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
