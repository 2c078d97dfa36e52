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
 * ``grow_rf_grid`` / ``grow_forest_rf`` — binary random forests in bag
   mode ``"onehot"`` (channels bw [y=0] and bw, count gating, feature
   subsets, leaf-level truncation snapshots), bags from
   ``rf_bags_and_features``;
 * ``predict_tree`` / ``predict_ensemble`` — plain torch gathers;
 * the per-level histogram: ``seg_level_hists`` launches the hand-written
   CUDA kernel ``csrc/seg_hist.cu`` on CUDA tensors and calls its plain
   version ``seg_level_hists_plain`` on CPU tensors.  Both the boosted and
   the forest growers build every level through it.

Not ported yet (ROADMAP Queue A): EFB bundling, GOSS, the CSR sparse path,
sibling subtraction, regression and multiclass forests and sharded growth.
"""
from __future__ import annotations

import ctypes
from typing import (Callable, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

__all__ = ["TreeArrays", "quantile_bins", "apply_bins", "default_dir_mask",
           "route_right", "binned_empty", "SegPlan",
           "seg_plan", "seg_layout", "seg_level_hists",
           "seg_level_hists_plain",
           "grow_tree", "RFGrowth", "rf_bags_and_features", "grow_rf_grid",
           "grow_forest_rf", "predict_tree", "predict_ensemble",
           "goss_plan"]

#: most rows one warp of the seg_hist kernel adds into one float32 partial
#: (keeps the partial sums within the kernel's tolerance at a million rows)
SEG_ROWS_PER_WARP = 1024
#: warps per block of the seg_hist kernel (each with its own histogram);
#: chosen by a block-shape sweep on the H100 (PERF.md)
SEG_WARPS = 2
#: channels the seg_hist kernel is built for: gradient and hessian of the
#: binary objective
SEG_CHANNELS = 2
#: columns of one tile: 32 lanes x one 4-byte word of bins
SEG_TILE = 128
#: a Hopper block's shared memory (227 KiB), and the kernel's per-warp
#: staging ring: 4 stages of 8 rows x (128 bytes of bins + 8 of channels)
_SMEM_BLOCK = 232_448
_SMEM_RING = 4 * 8 * (SEG_TILE + 8)
#: most bins one warp's float2 histogram [B][128] (plus its ring) fits in
#: a block's shared memory
SEG_MAX_BINS = (_SMEM_BLOCK - _SMEM_RING) // (SEG_TILE * 8)
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


def binned_empty(n: int, d: int, device) -> torch.Tensor:
    """An uninitialised (N, d) uint8 matrix whose rows are padded to a
    multiple of 16 bytes: the (N, d) view of an (N, ceil(d/16)*16) buffer.
    The ``seg_hist`` kernel takes rows padded to 4 bytes (it loads 4
    columns as one word) and copies rows padded to 16 bytes 16 bytes a
    lane, which measured faster (PERF.md)."""
    return torch.empty((n, -(-d // 16) * 16), dtype=torch.uint8,
                       device=device)[:, :d]


def apply_bins(X: torch.Tensor, edges: np.ndarray) -> torch.Tensor:
    """Quantized (N, D) uint8 matrix on X's device: the count of edges below
    each value (+inf edges never count; NaN lands in bin 0).  Rows are
    padded to a multiple of 16 bytes (``binned_empty``)."""
    n, d = X.shape
    e = torch.from_numpy(np.sort(np.asarray(edges, np.float32), axis=1))
    e = e.to(X.device).contiguous()
    out = binned_empty(n, d, X.device)
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


class SegPlan(NamedTuple):
    """Launch geometry of the ``seg_hist`` kernel (see ``seg_plan``)."""
    warps: int          # warps per block, each with its own histogram
    rows_per_warp: int  # most rows in one warp's float32 partial
    group_rows: int     # most rows per row group: warps x rows_per_warp
    n_tiles: int        # column tiles of 128 columns
    width: int          # scratch row width: n_tiles x 128
    n_groups: int       # row groups: M + n // group_rows
    n_blocks: int       # n_groups x n_tiles
    smem_bytes: int     # dynamic shared memory per block


def seg_plan(n: int, d: int, M: int, B: int) -> SegPlan:
    """The ``seg_hist`` kernel's launch geometry for an (n, d) level of M
    slots and B bins.  The slot-sorted rows are cut at every slot bound and
    every multiple of G = group_rows; each piece is a row group, so no
    group straddles two slots.  Slot s's groups are numbered from
    goff(s) = s + bounds[s] // G (``bounds`` from ``seg_layout``; one group
    per slot more than it has cuts, possibly empty), M + n // G in all.
    Group g of slot s (j = g - goff(s), cut = bounds[s] // G + j) covers
    sorted rows [r0, r1) with r0 = bounds[s] if j == 0 else cut * G and
    r1 = max(r0, min(bounds[s+1], (cut + 1) * G)).  Block ``i`` is (group
    i // n_tiles, tile i % n_tiles); warp w adds rows [r0 + w*q,
    min(r0 + (w+1)*q, r1)) with q = ceil((r1 - r0) / warps); lane L adds
    columns t*128 + 4L .. +3 below d.  Warps per block are ``SEG_WARPS``,
    cut to what B's histograms leave room for in a block's shared memory;
    q is at most ``SEG_ROWS_PER_WARP``."""
    per_warp = B * SEG_TILE * 8 + _SMEM_RING
    warps = min(SEG_WARPS, _SMEM_BLOCK // per_warp)
    if warps < 1 or B < 1:
        raise ValueError(f"B={B} bins leave no room for one warp's "
                         f"histogram (B <= {SEG_MAX_BINS})")
    group_rows = warps * SEG_ROWS_PER_WARP
    n_tiles = -(-d // SEG_TILE)
    n_groups = M + n // group_rows
    n_blocks = n_groups * n_tiles
    if n_blocks >= 2 ** 31:
        raise ValueError(f"{n_blocks} blocks exceed the grid")
    return SegPlan(warps, SEG_ROWS_PER_WARP, group_rows, n_tiles,
                   n_tiles * SEG_TILE, n_groups, n_blocks,
                   warps * per_warp)


def seg_layout(slot: torch.Tensor, M: int):
    """The ``seg_hist`` kernel's row layout, built with torch ops on the
    slot's device and no host synchronisation: ``perm`` (N,) int64 row ids
    sorted by slot (stable) and ``bounds`` (M+1,) int32, the first sorted
    position of each slot, then N.  The sort runs on the narrowest key
    type that holds M (fewer radix passes).  (Slot bounds come from a
    search of the sorted slots: ``bincount`` on the card reads the largest
    slot back to the host and would stall it.)"""
    key = (torch.uint8 if M < 256 else torch.int16 if M < 32768
           else torch.int32)
    sorted_slot, perm = torch.sort(slot.to(key), stable=True)
    bounds = torch.searchsorted(
        sorted_slot, torch.arange(M + 1, dtype=key, device=slot.device),
        out_int32=True)
    return perm, bounds


def _seg_launcher(lib):
    """``lib.seg_hist_launch`` with its C signature declared."""
    fn = lib.seg_hist_launch
    # pointers and the stream as c_void_p: untyped, ctypes would pass each
    # Python int as a 32-bit int and cut the pointer
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _seg_lib():
    from ..cuda_build import load_library

    return _seg_launcher(load_library("seg_hist"))


def _rows_fit(binned: torch.Tensor, align: int) -> bool:
    """Whether ``binned`` has unit column stride, a base and row stride that
    are multiples of ``align`` bytes, and storage that holds its last row
    rounded up to ``align`` bytes (the kernel loads whole aligned words)."""
    n, d = binned.shape
    if (binned.stride(1) != 1 and d > 1) or binned.stride(0) % align \
            or binned.data_ptr() % align:
        return False
    need = (n - 1) * binned.stride(0) + -(-d // align) * align if n else 0
    have = binned.untyped_storage().nbytes() - binned.storage_offset()
    return need <= have


def seg_level_hists(binned: torch.Tensor, slot: torch.Tensor,
                    ch: torch.Tensor, M: int, B: int) -> torch.Tensor:
    """One tree level's per-channel histograms (nchan, M, B, d) float32:
    ``out[c, m, b, j] = sum_i ch[i, c] [slot_i = m] [binned[i, j] = b]``,
    exact zeros for empty slots.

    ``binned`` (N, d) uint8 with values < B <= ``SEG_MAX_BINS``, unit column
    stride and a row stride and base that are multiples of 4 bytes (as
    ``apply_bins`` returns it); ``slot`` (N,) int32 in [0, M) with M <=
    ``SEG_MAX_SLOTS``; ``ch`` (N, 2) float32 (gradient, hessian) with an
    8-byte-aligned base (the kernel copies a row's pair as one 8-byte
    word); slot and ch contiguous, all on one device.  CUDA tensors launch
    the ``seg_hist`` kernel (bitwise deterministic) with ``seg_plan``'s
    geometry; CPU tensors take the plain version.
    ``seg_level_hists.launches`` counts kernel launches."""
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
    if not (slot.is_contiguous() and ch.is_contiguous()):
        raise ValueError("slot and ch must be contiguous")
    if ch.data_ptr() % 8:
        raise ValueError(f"ch needs an 8-byte-aligned base, got offset "
                         f"{ch.data_ptr() % 8}")
    if not _rows_fit(binned, 4):
        raise ValueError(
            f"binned needs unit column stride, a row stride and base that are "
            f"multiples of 4 bytes and storage to its last row's 4-byte word "
            f"(binned_empty makes one), got strides "
            f"{binned.stride()}, base offset {binned.data_ptr() % 4}")
    if not (1 <= B <= SEG_MAX_BINS and 1 <= M <= SEG_MAX_SLOTS
            and SEG_CHANNELS * B * d < 2 ** 31 and n < 2 ** 31):
        raise ValueError(f"need 1 <= B <= {SEG_MAX_BINS} (shared memory), "
                         f"1 <= M <= {SEG_MAX_SLOTS} (grid) and N < 2^31 "
                         f"(int32 row positions), got B={B} M={M} N={n}")
    if binned.device.type == "cpu":
        return seg_level_hists_plain(binned, slot, ch, M, B)
    if binned.device.type != "cuda":
        raise ValueError(f"unsupported device {binned.device}")

    dev = binned.device
    nchan = SEG_CHANNELS
    plan = seg_plan(n, d, M, B)
    perm, bounds = seg_layout(slot, M)
    scratch = torch.empty((plan.n_groups, nchan, B, plan.width),
                          dtype=torch.float32, device=dev)
    out = torch.empty((nchan, M, B, d), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _seg_lib()(binned.data_ptr(), perm.data_ptr(), ch.data_ptr(),
                     bounds.data_ptr(), scratch.data_ptr(), out.data_ptr(),
                     binned.stride(0), d, M, B, plan.warps, plan.group_rows,
                     plan.n_groups, int(_rows_fit(binned, 16)), stream)
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


def _slot_cap(n: int) -> int:
    """next_pow2(N): a level holds at most this many populated nodes, so
    deeper levels compact their node ids into this many slots."""
    return 1 << int(np.ceil(np.log2(max(n, 2))))


def _compact_slots(node: torch.Tensor, n_cap: int):
    """(slot (N,) int32, uniq (n_cap,) int32): rows occupy <= N distinct
    nodes, so each node id is replaced by its rank among the sorted ids;
    ``uniq`` holds the ids by slot, padded with INT32_MAX."""
    n = node.shape[0]
    int_max = torch.iinfo(torch.int32).max
    sorted_ids = torch.sort(node).values
    first = torch.ones(n, dtype=torch.bool, device=node.device)
    first[1:] = sorted_ids[1:] != sorted_ids[:-1]
    uniq = torch.full((n_cap,), int_max, dtype=torch.int32,
                      device=node.device)
    uniq[:n] = torch.sort(torch.where(first, sorted_ids, int_max)).values
    return torch.searchsorted(uniq, node).to(torch.int32), uniq


def _uncompact(uniq, feat_l, thresh_l, level_nodes: int, B: int):
    """A compacted level's per-slot splits written back at the slots' node
    ids; padding slots drop out, unpopulated nodes get no split."""
    keep = uniq < level_nodes
    seg_feat = torch.zeros(level_nodes, dtype=torch.int32,
                           device=uniq.device)
    seg_thresh = torch.full((level_nodes,), B, dtype=torch.int32,
                            device=uniq.device)
    seg_feat[uniq[keep].long()] = feat_l[keep]
    seg_thresh[uniq[keep].long()] = thresh_l[keep]
    return seg_feat, seg_thresh


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
    n_cap = _slot_cap(n)
    ch = torch.cat([G, H], dim=1).to(torch.float32).contiguous()
    rows = torch.arange(n, device=dev)
    bin_ids = torch.arange(B, device=dev)[None, :, None]
    node = torch.zeros(n, dtype=torch.int32, device=dev)
    heap_feat, heap_thresh = [], []
    for level in range(max_depth):
        level_nodes = 2 ** level
        compact = level_nodes > n_cap
        M = n_cap if compact else level_nodes
        slot, uniq = _compact_slots(node, n_cap) if compact else (node, None)
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
            seg_feat, seg_thresh = _uncompact(uniq, feat_l, thresh_l,
                                              level_nodes, B)
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
# Random forests
# ---------------------------------------------------------------------------

class RFGrowth(NamedTuple):
    """Forests of P (candidate, fold) pairs x T trees: feat/thresh
    (P, T, 2^hd-1) int32 heaps with full-width feature ids, leaf
    (P, T, 2^hd, 2) class probabilities, ``snaps`` {level: (P, T, 2^level,
    2)} the leaves of each tree truncated at that level, and ``levels``
    the per-level histograms built (one ``hist_fn`` call each)."""
    feat: torch.Tensor
    thresh: torch.Tensor
    leaf: torch.Tensor
    snaps: Dict[int, torch.Tensor]
    levels: int


def _tree_seed(seed: int, tid: int) -> int:
    """The generator seed of tree ``tid`` of a forest seeded ``seed``."""
    a, b = np.random.SeedSequence([seed, tid]).generate_state(2, np.uint32)
    return (int(a) << 31) ^ int(b)


def rf_bags_and_features(seed: int, n_trees: int, n: int, d: int, msub: int,
                         subsample_rate: float, device):
    """Every tree's Poisson(``subsample_rate``) bag weights (T, N) float32
    and its feature subset (T, msub) int64 — the ``msub`` smallest ranks of
    a uniform draw over the d features.  Tree t draws from a generator on
    ``device`` seeded by (seed, t) alone, so every fold and candidate of a
    sweep sees the same bags (the JAX package's ``fold_in(seed, t)``
    contract; the bits differ from ``jax.random``'s)."""
    bags = torch.empty((n_trees, n), dtype=torch.float32, device=device)
    feats = torch.empty((n_trees, msub), dtype=torch.int64, device=device)
    rate = torch.full((n,), float(subsample_rate), dtype=torch.float32,
                      device=device)
    for t in range(n_trees):
        gen = torch.Generator(device=device).manual_seed(_tree_seed(seed, t))
        bags[t] = torch.poisson(rate, generator=gen)
        feats[t] = torch.argsort(torch.rand(d, device=device,
                                            generator=gen))[:msub]
    return bags, feats


def _node_sums(ids: torch.Tensor, vals: torch.Tensor, M: int
               ) -> torch.Tensor:
    """(M, c) float32 per-node sums of ``vals`` (N, c) over node ``ids``
    (N,) in [0, M): rows sorted by node (``seg_layout``), float64 running
    sums differenced at the node bounds — exact for integer values and in
    a fixed order on the card, unlike an atomic scatter.  The sums run
    along the innermost axis of a (c, N) copy: on the card a scan along
    the outer axis of an (N, c) tensor runs c threads over N rows."""
    perm, bounds = seg_layout(ids, M)
    cs = torch.cumsum(vals[perm].T.to(torch.float64).contiguous(), 1)
    cs = torch.cat([torch.zeros_like(cs[:, :1]), cs], 1)
    b = bounds.long()
    return (cs[:, b[1:]] - cs[:, b[:-1]]).T.to(torch.float32)


#: the forests' gain regulariser (the JAX package's ``lam=1e-3``)
RF_LAMBDA = 1e-3


def _grow_rf_tree(binned, sub, fidx, y0, bw, min_ig: float, min_inst: float,
                  depth_limit: int, heap_depth: int, B: int, leaf_levels,
                  hist_fn: HistFn):
    """One bagged classification tree (the JAX package's
    ``_grow_tree_traced`` in bag mode ``"onehot"`` with a feature subset),
    binary targets.

    The histogram channels are the irreducible pair (bw [y=0], bw): the
    class-1 gradient is count minus class 0 and both hessians are the
    count.  Gain is the sum over the two classes of GL^2/(HL+lam) +
    GR^2/(HR+lam) - G^2/(H+lam) (lam = ``RF_LAMBDA``); a split needs
    ``min_inst`` bag weight on each side, gain > 0 and gain / node weight
    >= ``min_ig``.  Histograms
    run at subset width over ``sub`` (the subset's columns of ``binned``,
    gathered once per tree); routing reads the full matrix through
    ``fidx``.  Levels at or past ``depth_limit`` split nothing, so they
    build no histogram; nor do the levels below one whose nodes all stayed
    closed (a closed node sends its rows left, to a child with the same
    rows and the same decision).  That flag is read one level late, so the
    host never waits on the level it just enqueued.  Returns (feat,
    thresh, leaf, snaps, levels)."""
    n, msub = sub.shape
    dev = binned.device
    n_cap = _slot_cap(n)
    lam = RF_LAMBDA
    ch = torch.stack([bw * y0, bw], 1).contiguous()
    rows = torch.arange(n, device=dev)
    bin_ids = torch.arange(B, device=dev)[None, :, None]
    node = torch.zeros(n, dtype=torch.int32, device=dev)
    heap_feat, heap_thresh, snaps = [], [], []
    levels = 0
    any_open: List[torch.Tensor] = []    # per built level, on the device
    closed = False
    for level in range(heap_depth):
        level_nodes = 2 ** level
        if level in leaf_levels:
            s = _node_sums(node, ch, level_nodes)
            c = torch.clamp(s[:, 1:], min=1e-12)
            snaps.append(torch.stack([s[:, 0], s[:, 1] - s[:, 0]], 1) / c)
        if len(any_open) >= 2 and not closed:
            # the level before the one just enqueued: long done on the card
            closed = not bool(any_open[-2])
        if level >= depth_limit or closed:
            heap_feat.append(torch.zeros(level_nodes, dtype=torch.int32,
                                         device=dev))
            heap_thresh.append(torch.full((level_nodes,), B,
                                          dtype=torch.int32, device=dev))
            node = 2 * node
            continue
        compact = level_nodes > n_cap
        M = n_cap if compact else level_nodes
        slot, uniq = _compact_slots(node, n_cap) if compact else (node, None)
        hists = hist_fn(sub, slot.contiguous(), ch, M, B)
        levels += 1
        cums = torch.cumsum(hists, dim=2)                  # (2, M, B, msub)
        CL = cums[1]
        gain = 0.0
        for GL in (cums[0], CL - cums[0]):
            Gtot, Htot = GL[:, -1:, :1], CL[:, -1:, :1]
            GR, HR = Gtot - GL, Htot - CL
            gain = gain + (GL * GL / (CL + lam) + GR * GR / (HR + lam)
                           - Gtot * Gtot / (Htot + lam))
        CR = CL[:, -1:, :1] - CL
        valid = (CL >= min_inst) & (CR >= min_inst) & (bin_ids < B - 1)
        node_w = torch.clamp(CL[:, -1, 0], min=1e-12)
        flat_gain = torch.where(valid, gain, float("-inf")).reshape(
            M, B * msub)
        best = torch.argmax(flat_gain, dim=1)
        best_gain = flat_gain.gather(1, best[:, None])[:, 0]
        ok = ((best_gain > 0) & (best_gain / node_w >= min_ig)
              & torch.isfinite(best_gain))
        any_open.append(ok.any())
        feat_l = torch.where(ok, best % msub, 0).to(torch.int32)
        thresh_l = torch.where(ok, best // msub, B).to(torch.int32)
        if compact:
            seg_feat, seg_thresh = _uncompact(uniq, feat_l, thresh_l,
                                              level_nodes, B)
        else:
            seg_feat, seg_thresh = feat_l, thresh_l
        heap_feat.append(seg_feat)
        heap_thresh.append(seg_thresh)
        sl = slot.long()
        x_row = binned[rows, fidx[feat_l.long()][sl]]
        node = 2 * node + route_right(x_row, thresh_l[sl]).to(torch.int32)
    s = _node_sums(node, torch.stack([bw * y0, bw * (1 - y0), bw], 1),
                   2 ** heap_depth)
    leaf = s[:, :2] / torch.clamp(s[:, 2:], min=1e-12)
    feat = fidx[torch.cat(heap_feat).long()].to(torch.int32)
    return feat, torch.cat(heap_thresh), leaf, snaps, levels


def grow_rf_grid(binned: torch.Tensor, y: torch.Tensor, W_tr: torch.Tensor,
                 seed: int, n_trees: int, pair_fold, pair_min_ig,
                 pair_min_inst, pair_depth, msub: int, subsample_rate: float,
                 n_bins: int, leaf_levels: Sequence[int] = (),
                 hist_fn: HistFn = seg_level_hists) -> RFGrowth:
    """Every (candidate x fold) pair's binary random forest.

    ``binned`` (N, D) uint8; ``y`` (N,) labels in {0, 1}; ``W_tr`` (F, N)
    per-fold training weights; per pair p its fold ``pair_fold[p]``,
    ``min_info_gain``, ``min_instances`` and depth.  Tree t of every pair
    draws the same bag and feature subset (``rf_bags_and_features``,
    keyed on (seed, t)) and trains on bag x its fold's weights, so the
    forests equal the per-candidate fits.  ``leaf_levels``: levels below
    the heap depth at which each tree's truncated leaves are also kept —
    a shallower ``max_depth`` candidate is exactly the deeper tree cut at
    its depth (splits at a level never depend on deeper levels).  The heap
    depth is the deepest pair's (at least 1).  Trees grow one at
    a time, each tree's subset columns gathered once for all pairs; each
    open level is one ``hist_fn`` call (``seg_level_hists``: the kernel
    on CUDA tensors)."""
    n, d = binned.shape
    dev = binned.device
    P = len(pair_fold)
    heap_depth = max(int(max(pair_depth)), 1)
    leaf_levels = tuple(sorted({int(v) for v in leaf_levels
                                if 0 < int(v) < heap_depth}))
    y0 = (y.to(dev) == 0).to(torch.float32)
    W_tr = W_tr.to(dev, torch.float32)
    bags, fidx = rf_bags_and_features(seed, n_trees, n, d, msub,
                                      subsample_rate, dev)
    out = [[None] * n_trees for _ in range(P)]
    levels = 0
    for t in range(n_trees):
        ft = fidx[t].to(dev, torch.int64)
        sub = binned_empty(n, msub, dev)
        sub.copy_(binned.index_select(1, ft))
        for p in range(P):
            bw = W_tr[int(pair_fold[p])] * bags[t].to(dev)
            *tree, lv = _grow_rf_tree(
                binned, sub, ft, y0, bw,
                float(np.float32(pair_min_ig[p])),
                float(np.float32(pair_min_inst[p])), int(pair_depth[p]),
                heap_depth, n_bins, leaf_levels, hist_fn)
            out[p][t] = tree
            levels += lv
        del sub

    def stack(i):
        return torch.stack([torch.stack([out[p][t][i]
                                         for t in range(n_trees)])
                            for p in range(P)])
    snaps = {lv: torch.stack([torch.stack([out[p][t][3][i]
                                           for t in range(n_trees)])
                              for p in range(P)])
             for i, lv in enumerate(leaf_levels)}
    return RFGrowth(stack(0), stack(1), stack(2), snaps, levels)


def grow_forest_rf(binned: torch.Tensor, y: torch.Tensor,
                   base_w: torch.Tensor, seed: int, n_trees: int, msub: int,
                   subsample_rate: float, max_depth: int, n_bins: int,
                   min_info_gain: float = 0.0, min_instances: float = 1.0,
                   hist_fn: HistFn = seg_level_hists) -> RFGrowth:
    """One binary random forest on ``base_w`` (N,) row weights: the grid
    grower with a single pair; its arrays have no pair axis (feat
    (T, 2^d-1), leaf (T, 2^d, 2))."""
    g = grow_rf_grid(binned, y, base_w[None], seed, n_trees, [0],
                     [min_info_gain], [min_instances], [max_depth], msub,
                     subsample_rate, n_bins, hist_fn=hist_fn)
    return RFGrowth(g.feat[0], g.thresh[0], g.leaf[0], {}, g.levels)


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
