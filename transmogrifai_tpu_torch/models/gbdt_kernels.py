"""Histogram decision-tree kernels (counterpart of
``transmogrifai_tpu.models.gbdt_kernels``), the subset the boosted-tree
slice runs:

 * ``quantile_bins`` (the JAX package's numpy row sample and quantiles, the
   sample's columns sorted on the matrix's device) and ``apply_bins``
   (binned matrix as uint8 on the device);
 * ``default_dir_mask`` and ``route_right`` — the split routing rule;
 * ``grow_tree`` — level-wise growth in ``newton`` mode (gradient and
   hessian channels, XGBoost gating), default-direction splits and node
   compaction;
 * ``predict_tree`` / ``predict_ensemble`` — plain torch gathers;
 * the per-level histogram: ``seg_level_hists`` launches the hand-written
   CUDA kernel ``csrc/seg_hist.cu`` on CUDA tensors and calls its plain
   version ``seg_level_hists_plain`` on CPU tensors.

Not ported yet (ROADMAP Queue A): EFB bundling, GOSS, the CSR sparse path,
feature subsets, sibling subtraction, leaf-level snapshots and sharded
growth.
"""
from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

__all__ = ["TreeArrays", "quantile_bins", "apply_bins", "default_dir_mask",
           "route_right", "seg_layout", "seg_level_hists",
           "seg_level_hists_plain",
           "grow_tree", "predict_tree", "predict_ensemble", "goss_plan"]

#: rows per row group of the seg_hist kernel (a group never straddles two
#: slots); ~980 groups x 4 feature tiles = ~3900 blocks at M=1, 1M x 500
SEG_ROW_GROUP = 1024
#: channels the seg_hist kernel is built for: gradient and hessian of the
#: binary objective
SEG_CHANNELS = 2
#: most bins the kernel's shared-memory histogram [2][B][128] float32 fits
#: in a Hopper block's 227 KiB
SEG_MAX_BINS = 227 * 1024 // (SEG_CHANNELS * 128 * 4)
#: most slots: the reduce pass puts one slot per grid row (gridDim.y)
SEG_MAX_SLOTS = 65535
#: GOSS engages at/above this depth and row count in the JAX package
GOSS_MIN_DEPTH = 8
GOSS_MIN_ROWS = 20000


class TreeArrays(NamedTuple):
    """One grown tree: feat/thresh (2^d-1,) int32 heap, leaf (2^d, K)."""
    feat: torch.Tensor
    thresh: torch.Tensor
    leaf: torch.Tensor


# ---------------------------------------------------------------------------
# Quantile binning
# ---------------------------------------------------------------------------

def _edges_of_sorted(cols: np.ndarray, max_bins: int) -> np.ndarray:
    """Bin edges (D, max_bins-1) float32 from the sample's columns, each
    sorted, as rows of ``cols`` (D, n).  ``np.quantile`` depends only on the
    order statistics, so this equals the JAX package's ``np.quantile`` of
    the unsorted sample, and sorted contiguous rows make it ~10x faster;
    duplicate edges collapse to +inf (unused bins)."""
    qs = np.linspace(0, 1, max_bins + 1)[1:-1]
    edges = np.quantile(cols, qs, axis=1).T.astype(np.float32)
    eps = 1e-7
    for j in range(cols.shape[0]):
        e = edges[j]
        dup = np.concatenate([[False], np.diff(e) <= eps])
        edges[j] = np.where(dup, np.inf, e)
    return edges


def quantile_bins(X: torch.Tensor, max_bins: int = 32,
                  sample_rows: int = 200_000, seed: int = 7) -> np.ndarray:
    """Per-feature quantile bin edges (D, max_bins-1) float32 of a (N, D)
    matrix: the JAX package's numpy row draw picks the sample, whose columns
    are sorted on X's device and copied to the host for the quantiles."""
    n = X.shape[0]
    if n > sample_rows:
        rng = np.random.default_rng(seed)
        idx = torch.from_numpy(rng.choice(n, sample_rows, replace=False))
        X = X.index_select(0, idx.to(X.device))
    cols = torch.sort(X.T.contiguous(), dim=1).values
    return _edges_of_sorted(cols.cpu().numpy(), max_bins)


#: rows per block of the binning pass
_BIN_ROW_BLOCK = 1 << 16


def apply_bins(X: torch.Tensor, edges: np.ndarray) -> torch.Tensor:
    """Quantized (N, D) uint8 matrix on X's device: the count of edges below
    each value (+inf edges never count; NaN lands in bin 0)."""
    n, d = X.shape
    e = torch.from_numpy(np.sort(np.asarray(edges, np.float32), axis=1))
    e = e.to(X.device).contiguous()
    out = torch.empty((n, d), dtype=torch.uint8, device=X.device)
    for a in range(0, n, _BIN_ROW_BLOCK):
        xt = X[a:a + _BIN_ROW_BLOCK].to(torch.float32).T.contiguous()
        b = torch.searchsorted(e, xt, right=False)
        b = torch.where(torch.isnan(xt), 0, b)
        out[a:a + _BIN_ROW_BLOCK] = b.T.to(torch.uint8)
    return out


def default_dir_mask(edges) -> np.ndarray:
    """(D,) bool: features whose smallest finite edge is 0.0, i.e. whose
    bin 0 is a genuine missing/zero bucket — only these may learn a
    default direction."""
    e = np.asarray(edges, np.float64)
    first = np.where(np.isfinite(e), e, np.inf).min(axis=1)
    return first == 0.0


def route_right(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """THE split routing rule, shared by growth and prediction: ``t`` in
    [0, B-1) goes right iff bin > t; ``t == B`` never splits; ``t < 0`` is
    a default-direction split with threshold -t-1 whose bin 0 goes right."""
    x = x.to(torch.int32)
    dr = t < 0
    te = torch.where(dr, -t - 1, t)
    return (x > te) | (dr & (x == 0))


def goss_plan(n_rows: int, min_depth: int) -> Optional[Tuple[int, int]]:
    """The JAX package's GOSS row budget rule, used here only to refuse the
    fits where GOSS would engage (its ``jax.random`` draws are not
    reproducible in torch)."""
    import os

    v = os.environ.get("TMOG_GOSS", "auto")
    if v == "0" or min_depth < GOSS_MIN_DEPTH:
        return None
    if v != "1" and n_rows < GOSS_MIN_ROWS:
        return None
    k_top = max(1, int(round(0.2 * n_rows)))
    k_rest = max(1, int(round(0.2 * n_rows)))
    return None if k_top + k_rest >= n_rows else (k_top, k_rest)


# ---------------------------------------------------------------------------
# Per-level histograms
# ---------------------------------------------------------------------------

#: rows per block of the plain version (bounds its int64 index scratch)
_PLAIN_ROW_BLOCK = 1 << 16


def seg_level_hists_plain(binned: torch.Tensor, slot: torch.Tensor,
                          ch: torch.Tensor, M: int, B: int) -> torch.Tensor:
    """Plain version of ``seg_level_hists``: one flat-index ``index_add_``
    per channel and row block, accumulated in float64 and rounded to
    float32 once, so it stands for the exact sum.  (A float32 ``index_add_``
    on the card adds with atomics in no fixed order; at a million rows its
    own rounding exceeds the kernel's tolerance.)  Returns (nchan, M, B, d)
    float32."""
    n, d = binned.shape
    nchan = ch.shape[1]
    out = torch.zeros((nchan, M * B * d), dtype=torch.float64,
                      device=binned.device)
    cols = torch.arange(d, device=binned.device)
    for a in range(0, n, _PLAIN_ROW_BLOCK):
        b = binned[a:a + _PLAIN_ROW_BLOCK].to(torch.int64)
        s = slot[a:a + _PLAIN_ROW_BLOCK].to(torch.int64)
        flat = ((s[:, None] * B + b) * d + cols[None, :]).reshape(-1)
        for c in range(nchan):
            w = ch[a:a + _PLAIN_ROW_BLOCK, c].to(torch.float64)
            out[c].index_add_(0, flat, w[:, None].expand(-1, d).reshape(-1))
    return out.to(torch.float32).reshape(nchan, M, B, d)


def seg_layout(slot: torch.Tensor, ch: torch.Tensor, M: int, R: int):
    """The ``seg_hist`` kernel's row layout, built with torch ops on the
    slot's device and no host synchronisation: ``perm`` (N,) int32 row ids
    sorted by slot (stable), ``ch_sorted`` the channels in that order,
    ``counts``/``row_off`` (M,) int32 rows and first sorted position per
    slot, and ``group_off`` (M+1,) int32 first row group per slot — a slot
    of c rows owns ceil(c / R) groups, so no group straddles two slots.
    (Slot bounds come from a search of the sorted slots: ``bincount`` on
    the card reads the largest slot back to the host and would stall it.)"""
    sorted_slot, order = torch.sort(slot, stable=True)
    bounds = torch.searchsorted(
        sorted_slot, torch.arange(M + 1, dtype=slot.dtype, device=slot.device))
    row_off = bounds[:-1]
    counts = bounds[1:] - row_off
    group_off = torch.zeros(M + 1, dtype=torch.int64, device=slot.device)
    group_off[1:] = torch.cumsum((counts + R - 1) // R, 0)
    return (order.to(torch.int32), ch.index_select(0, order).contiguous(),
            counts.to(torch.int32), row_off.to(torch.int32),
            group_off.to(torch.int32))


def _seg_lib():
    from ..cuda_build import load_library

    fn = load_library("seg_hist").seg_hist_launch
    # pointers and the stream as c_void_p: untyped, ctypes would pass each
    # Python int as a 32-bit int and cut the pointer
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def seg_level_hists(binned: torch.Tensor, slot: torch.Tensor,
                    ch: torch.Tensor, M: int, B: int) -> torch.Tensor:
    """One tree level's per-channel histograms (nchan, M, B, d) float32:
    ``out[c, m, b, j] = sum_i ch[i, c] [slot_i = m] [binned[i, j] = b]``,
    exact zeros for empty slots.

    ``binned`` (N, d) uint8 with values < B <= ``SEG_MAX_BINS``, ``slot``
    (N,) int32 in [0, M) with M <= ``SEG_MAX_SLOTS``, ``ch`` (N, 2) float32
    (gradient, hessian), all contiguous on one device.  CUDA tensors launch
    the ``seg_hist`` kernel (bitwise deterministic); CPU tensors take the
    plain version.  ``seg_level_hists.launches`` counts kernel launches."""
    n, d = binned.shape
    if binned.dtype != torch.uint8 or binned.dim() != 2:
        raise TypeError(f"binned must be (N, d) uint8, got "
                        f"{tuple(binned.shape)} {binned.dtype}")
    if slot.dtype != torch.int32 or tuple(slot.shape) != (n,):
        raise TypeError(f"slot must be ({n},) int32, got "
                        f"{tuple(slot.shape)} {slot.dtype}")
    if (ch.dtype != torch.float32
            or tuple(ch.shape) != (n, SEG_CHANNELS)):
        raise TypeError(f"ch must be ({n}, {SEG_CHANNELS}) float32, got "
                        f"{tuple(ch.shape)} {ch.dtype}")
    if not (binned.device == slot.device == ch.device):
        raise ValueError("binned, slot and ch must share one device")
    if not (binned.is_contiguous() and slot.is_contiguous()
            and ch.is_contiguous()):
        raise ValueError("binned, slot and ch must be contiguous")
    if not (1 <= B <= SEG_MAX_BINS and 1 <= M <= SEG_MAX_SLOTS):
        raise ValueError(f"need 1 <= B <= {SEG_MAX_BINS} (shared memory) and "
                         f"1 <= M <= {SEG_MAX_SLOTS} (grid), got B={B} M={M}")
    if binned.device.type == "cpu":
        return seg_level_hists_plain(binned, slot, ch, M, B)
    if binned.device.type != "cuda":
        raise ValueError(f"unsupported device {binned.device}")

    dev = binned.device
    nchan = SEG_CHANNELS
    R = SEG_ROW_GROUP
    perm, ch_sorted, counts, row_off, group_off = seg_layout(slot, ch, M, R)
    max_groups = -(-n // R) + M
    scratch = torch.empty((max_groups, nchan, B, d), dtype=torch.float32,
                          device=dev)
    out = torch.empty((nchan, M, B, d), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _seg_lib()(binned.data_ptr(), perm.data_ptr(), ch_sorted.data_ptr(),
                     counts.data_ptr(), row_off.data_ptr(),
                     group_off.data_ptr(), scratch.data_ptr(), out.data_ptr(),
                     d, M, B, R, max_groups, stream)
    if err != 0:
        raise RuntimeError(f"seg_hist launch failed: CUDA error {err}")
    seg_level_hists.launches += 1
    return out


seg_level_hists.launches = 0


# ---------------------------------------------------------------------------
# Tree growth
# ---------------------------------------------------------------------------

HistFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, int, int],
                  torch.Tensor]


def grow_tree(binned: torch.Tensor, G: torch.Tensor, H: torch.Tensor,
              max_depth: int, n_bins: int, lam: float = 1.0,
              min_child_weight: float = 0.0, min_gain_raw: float = 0.0,
              learning_rate: float = 1.0, default_dir: bool = False,
              dd_mask: Optional[torch.Tensor] = None,
              hist_fn: HistFn = seg_level_hists) -> TreeArrays:
    """Grow one tree level by level in ``newton`` mode (the JAX package's
    ``_grow_tree_traced`` with ``bag_mode="newton"``): channels are the K
    gradient and K hessian columns, gating is XGBoost's (min_child_weight
    on hessian mass, gamma as the raw loss-reduction threshold).

    ``binned`` (N, d) uint8; ``G``/``H`` (N, K) float32.  Nodes that fail
    the gates emit the no-split sentinel (thresh = B); levels with more
    nodes than next_pow2(N) compact their node ids into that many slots.
    ``hist_fn`` builds each level's histograms (the kernel wrapper by
    default; the plain version for comparisons on the card)."""
    n, d = binned.shape
    k = G.shape[1]
    B = n_bins
    dev = binned.device
    n_cap = 1 << int(np.ceil(np.log2(max(n, 2))))
    ch = torch.cat([G, H], dim=1).to(torch.float32).contiguous()
    rows = torch.arange(n, device=dev)
    bin_ids = torch.arange(B, device=dev)[None, :, None]
    int_max = torch.iinfo(torch.int32).max
    node = torch.zeros(n, dtype=torch.int32, device=dev)
    heap_feat, heap_thresh = [], []
    for level in range(max_depth):
        level_nodes = 2 ** level
        compact = level_nodes > n_cap
        M = n_cap if compact else level_nodes
        if compact:
            # rows occupy <= N distinct nodes: rank their sorted ids
            sorted_ids = torch.sort(node).values
            first = torch.ones(n, dtype=torch.bool, device=dev)
            first[1:] = sorted_ids[1:] != sorted_ids[:-1]
            uniq = torch.full((M,), int_max, dtype=torch.int32, device=dev)
            uniq[:n] = torch.sort(torch.where(first, sorted_ids,
                                              int_max)).values
            slot = torch.searchsorted(uniq, node).to(torch.int32)
        else:
            slot = node
        hists = hist_fn(binned, slot.contiguous(), ch, M, B)
        cums = torch.cumsum(hists, dim=2)                  # (2K, M, B, d)
        GLs, HLs = cums[:k], cums[k:2 * k]
        CL = HLs[0]   # hessian mass stands in for counts; count gates inert

        gain = 0.0
        HLmin = HRmin = None
        for GL, HL in zip(GLs, HLs):
            Gtot, Htot = GL[:, -1:, :1], HL[:, -1:, :1]
            GR, HR = Gtot - GL, Htot - HL
            gain = gain + (GL * GL / (HL + lam) + GR * GR / (HR + lam)
                           - Gtot * Gtot / (Htot + lam))
            HLmin = HL if HLmin is None else torch.minimum(HLmin, HL)
            HRmin = HR if HRmin is None else torch.minimum(HRmin, HR)
        Ctot = CL[:, -1:, :1]
        CR = Ctot - CL
        valid = ((HLmin >= min_child_weight) & (HRmin >= min_child_weight)
                 & (CL >= 0.0) & (CR >= 0.0) & (bin_ids < B - 1))
        node_w = torch.clamp(Ctot[:, 0, 0], min=1e-12)
        neg_inf = float("-inf")
        flat_gain = torch.where(valid, gain, neg_inf).reshape(M, B * d)

        if default_dir:
            # variant b: the bin-0 (missing/absent) mass routes RIGHT
            gain_b = 0.0
            HLbmin = HRbmin = None
            for GL, HL in zip(GLs, HLs):
                Gtot, Htot = GL[:, -1:, :1], HL[:, -1:, :1]
                GLb, HLb = GL - GL[:, 0:1, :], HL - HL[:, 0:1, :]
                GRb, HRb = Gtot - GLb, Htot - HLb
                gain_b = gain_b + (GLb * GLb / (HLb + lam)
                                   + GRb * GRb / (HRb + lam)
                                   - Gtot * Gtot / (Htot + lam))
                HLbmin = HLb if HLbmin is None else torch.minimum(HLbmin, HLb)
                HRbmin = HRb if HRbmin is None else torch.minimum(HRbmin, HRb)
            c0 = CL[:, 0:1, :]
            CLb = CL - c0
            CRb = Ctot - CLb
            valid_b = ((HLbmin >= min_child_weight)
                       & (HRbmin >= min_child_weight)
                       & (CLb >= 0.0) & (CRb >= 0.0) & (bin_ids < B - 1)
                       & (c0 > 0))
            if dd_mask is not None:
                valid_b = valid_b & dd_mask[None, None, :]
            flat_gain = torch.cat(
                [flat_gain,
                 torch.where(valid_b, gain_b, neg_inf).reshape(M, B * d)],
                dim=1)

        best = torch.argmax(flat_gain, dim=1)
        best_gain = flat_gain.gather(1, best[:, None])[:, 0]
        ok = ((best_gain > 0) & (best_gain / node_w >= 0.0)
              & torch.isfinite(best_gain) & (best_gain >= min_gain_raw))
        if default_dir:
            is_b = best >= B * d
            bloc = best - torch.where(is_b, B * d, 0)
            t_raw = bloc // d
            feat_l = torch.where(ok, bloc % d, 0)
            thresh_l = torch.where(ok, torch.where(is_b, -(t_raw + 1), t_raw),
                                   B)
        else:
            feat_l = torch.where(ok, best % d, 0)
            thresh_l = torch.where(ok, best // d, B)
        feat_l = feat_l.to(torch.int32)
        thresh_l = thresh_l.to(torch.int32)
        if compact:
            keep = uniq < level_nodes        # padding slots drop out
            seg_feat = torch.zeros(level_nodes, dtype=torch.int32, device=dev)
            seg_thresh = torch.full((level_nodes,), B, dtype=torch.int32,
                                    device=dev)
            seg_feat[uniq[keep].long()] = feat_l[keep]
            seg_thresh[uniq[keep].long()] = thresh_l[keep]
        else:
            seg_feat, seg_thresh = feat_l, thresh_l
        heap_feat.append(seg_feat)
        heap_thresh.append(seg_thresh)

        sl = slot.long()
        x_row = binned[rows, feat_l[sl].long()]
        go_right = route_right(x_row, thresh_l[sl])
        node = 2 * node + go_right.to(torch.int32)

    leaf = _leaf_values(node, G, H, 2 ** max_depth, lam, learning_rate)
    return TreeArrays(torch.cat(heap_feat), torch.cat(heap_thresh), leaf)


#: one-hot elements per block of the leaf sums
_LEAF_BLOCK_ELEMS = 64 << 20


def _leaf_values(node, G, H, n_leaves: int, lam: float,
                 learning_rate: float) -> torch.Tensor:
    """Newton leaf values -lr * G_leaf / (H_leaf + lam).  Sums are one-hot
    products over row blocks — a fixed summation order, so the leaves are
    deterministic on the card, unlike an atomic scatter."""
    n, k = G.shape
    stacked = torch.cat([G, H], dim=1).to(torch.float32)
    sums = torch.zeros((n_leaves, 2 * k), dtype=torch.float32,
                       device=G.device)
    leaves = torch.arange(n_leaves, device=G.device, dtype=torch.int32)
    step = max(1, _LEAF_BLOCK_ELEMS // n_leaves)
    for a in range(0, n, step):
        oh = (node[a:a + step, None] == leaves[None, :]).to(torch.float32)
        sums += oh.T @ stacked[a:a + step]
    Gs, Hs = sums[:, :k], sums[:, k:]
    return -learning_rate * Gs / (Hs + lam)


# ---------------------------------------------------------------------------
# Prediction
# ---------------------------------------------------------------------------

def predict_tree(binned: torch.Tensor, feat: torch.Tensor,
                 thresh: torch.Tensor, leaf: torch.Tensor,
                 max_depth: int) -> torch.Tensor:
    """Route rows through one tree; returns (N, K) leaf values."""
    n = binned.shape[0]
    rows = torch.arange(n, device=binned.device)
    node = torch.zeros(n, dtype=torch.int64, device=binned.device)
    for level in range(max_depth):
        heap = (2 ** level - 1) + node
        x = binned[rows, feat[heap].long()]
        node = 2 * node + route_right(x, thresh[heap]).long()
    return leaf[node]


#: (trees x rows) elements routed per block of ``predict_ensemble``
_PREDICT_BLOCK_ELEMS = 32 << 20


def predict_ensemble(binned: torch.Tensor, feat: torch.Tensor,
                     thresh: torch.Tensor, leaf: torch.Tensor,
                     max_depth: int) -> torch.Tensor:
    """Sum of all trees' outputs: feat/thresh (T, 2^d-1), leaf (T, 2^d, K).
    Trees route in parallel over blocks of trees; leaf values add in tree
    order."""
    n = binned.shape[0]
    T, nodes = feat.shape
    k = leaf.shape[2]
    dev = binned.device
    rows = torch.arange(n, device=dev)[None, :]
    out = torch.zeros((n, k), dtype=torch.float32, device=dev)
    step = max(1, _PREDICT_BLOCK_ELEMS // max(n, 1))
    for s in range(0, T, step):
        f = feat[s:s + step].long()
        t = thresh[s:s + step]
        tid = torch.arange(f.shape[0], device=dev)[:, None]
        node = torch.zeros((f.shape[0], n), dtype=torch.int64, device=dev)
        for level in range(max_depth):
            heap = (2 ** level - 1) + node
            x = binned[rows, f[tid, heap]]
            node = 2 * node + route_right(x, t[tid, heap]).long()
        vals = leaf[s:s + step][tid, node]                # (t, N, K)
        for i in range(vals.shape[0]):
            out += vals[i]
    return out
