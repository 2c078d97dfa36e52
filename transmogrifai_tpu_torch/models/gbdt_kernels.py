"""Histogram decision-tree kernels (counterpart of
``transmogrifai_tpu.models.gbdt_kernels``), the subset the boosted-tree
slice runs:

 * ``quantile_bins`` (the JAX package's numpy row sample and quantiles, the
   sample's columns sorted on the matrix's device),
   ``quantile_bins_sparse_aware`` (the nonzero-aware sketch of mostly
   zero columns: the same sample, copied to the host once, and the JAX
   package's per-column host arithmetic) and ``apply_bins`` (binned
   matrix as uint8 on the device);
 * ``default_dir_mask`` and ``route_right`` — the split routing rule;
 * ``grow_tree`` — the general level-wise grower: K gradient and K
   hessian channels plus, in bag mode ``"none"``, a count channel (2K+1:
   count and per-node-weight gain gates, column masks, Newton or mean
   leaves; softmax boosting, count-gated and subsampled boosting, decision
   trees), or without it (``"newton"``, XGBoost's gating);
   default-direction splits and node compaction;
 * ``grow_rf_grid`` / ``grow_forest_rf`` — random forests in bag mode
   ``"onehot"`` for K-class labels (channels bw [y=k] for k < K-1, and
   bw) and
   ``"bagged"`` for regression (channels bw y and bw): count gating,
   feature subsets, leaf-level truncation snapshots, bags from
   ``rf_bags_and_features``;
 * GOSS (``goss_plan``, ``goss_select``, ``goss_rows``): the boosted
   fits' gradient-based row sampling for deep trees;
 * ``predict_tree`` / ``predict_ensemble`` — plain torch gathers;
 * the per-level histogram: ``seg_level_hists`` launches the hand-written
   CUDA kernel ``csrc/seg_hist.cu`` on CUDA tensors and calls its plain
   version ``seg_level_hists_plain`` on CPU tensors.  Both the boosted and
   the forest growers build every level through it;
 * exclusive feature bundling (``bundle_features``, ``bundle_matrix``,
   ``unbundle_ensemble``; ``grow_tree(bundle_end=)`` and
   ``predict_tree_bundled``): the JAX package's plan, decided in numpy on a
   row sample, packs mutually exclusive columns into shared histogram
   columns, and the grown splits map back to the original columns;
 * the CSR histogram path (``build_feature_csr``, ``sparse_level_hists``,
   ``csr_hist_fn``): a level's histograms of a wide, mostly zero matrix
   from its nonzero entries, plain torch ops (XLA code in the JAX package,
   no kernel there).

Not ported yet (ROADMAP Queue A): sibling subtraction and sharded growth.
"""
from __future__ import annotations

import ctypes
import functools
from typing import (Callable, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from ..utils.profiling import count_launch, upload_timed

__all__ = ["TreeArrays", "quantile_bins", "quantile_bins_sparse_aware",
           "SPARSE_SKETCH_ZERO_FRAC", "apply_bins", "default_dir_mask",
           "route_right", "binned_empty", "SegPlan",
           "seg_plan", "seg_channel_groups", "seg_layout",
           "seg_level_hists",
           "seg_level_hists_plain",
           "grow_tree", "RFGrowth", "rf_bags_and_features", "grow_rf_grid",
           "grow_forest_rf", "predict_tree", "predict_ensemble",
           "goss_plan", "goss_select", "goss_rows",
           "EFB_MAX_ACTIVE_FRAC", "EFB_SAMPLE_ROWS", "EFB_MIN_WIDTH_RATIO",
           "FeatureBundles", "bundle_features", "bundle_matrix",
           "unbundle_ensemble", "predict_tree_bundled", "FeatureCSR",
           "build_feature_csr", "sparse_level_hists", "csr_hist_fn",
           "SPARSE_MAX_SLOTS"]

#: most rows one warp of the seg_hist kernel adds into one float32 partial.
#: Where most of a warp's rows fall in one bin (a sparse matrix's zero bin)
#: and a channel holds nearly one value (a boosted fit's first hessians),
#: every add rounds the same way and the drift grows with the rows: at
#: 1024 a 1M x 2000 sparse level reached 0.67-1.23 of the kernel's
#: tolerance, at 256 0.12 (``scripts/torch_seg_rows.py``, PERF.md)
SEG_ROWS_PER_WARP = 256
#: most warps per block of the seg_hist kernel (each with its own
#: histogram); chosen by a block-shape sweep on the H100 (PERF.md)
SEG_WARPS = 2
#: the widest channel set one launch of the seg_hist kernel takes (the
#: kernel is built for 1..13 channels: 13 one-channel histograms of 32
#: bins fill a block's shared memory); wider sets run as several launches
SEG_MAX_CHANNELS = 13
#: columns of one tile: 32 lanes x one 4-byte word of bins
SEG_TILE = 128
#: a Hopper block's shared memory (227 KiB)
_SMEM_BLOCK = 232_448


def _smem_ring(nchan: int) -> int:
    """Bytes of the kernel's per-warp staging ring: 4 stages of 8 rows x
    (128 bytes of bins + 4 bytes a channel)."""
    return 4 * 8 * (SEG_TILE + 4 * nchan)


def _smem_per_warp(B: int, nchan: int) -> int:
    """Bytes of one warp's B x 128 x nchan float histogram and its ring."""
    return B * SEG_TILE * 4 * nchan + _smem_ring(nchan)


#: most bins one warp's two-channel histogram [B][128] (plus its ring)
#: fits in a block's shared memory
SEG_MAX_BINS = (_SMEM_BLOCK - _smem_ring(2)) // (SEG_TILE * 8)
#: most slots: the reduce pass puts one slot per grid row (gridDim.y)
SEG_MAX_SLOTS = 65535
#: GOSS engages at/above this depth and row count, and keeps these
#: fractions of the rows by |gradient| and by a uniform draw of the rest
#: (the JAX package's constants)
GOSS_MIN_DEPTH = 8
GOSS_MIN_ROWS = 20000
GOSS_TOP_FRAC = 0.2
GOSS_REST_FRAC = 0.2


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
    X = _sample_rows(X, sample_rows, seed)
    cols = torch.sort(X.T.contiguous(), dim=1).values
    return _edges_of_sorted(cols.cpu().numpy(), max_bins)


def _sample_rows(X: torch.Tensor, sample_rows: int, seed: int
                 ) -> torch.Tensor:
    """The JAX package's numpy row draw (``default_rng(seed).choice``
    without replacement), gathered on X's device; X itself when it has at
    most ``sample_rows`` rows."""
    n = X.shape[0]
    if n <= sample_rows:
        return X
    rng = np.random.default_rng(seed)
    idx = torch.from_numpy(rng.choice(n, sample_rows, replace=False))
    return X.index_select(0, idx.to(X.device))


def quantile_bins_streaming(hists, max_bins: int = 32) -> np.ndarray:
    """Bin edges (D, max_bins-1) float32 from per-feature
    ``StreamingHistogram`` sketches of streamed chunks (the out-of-core
    ``quantile_bins``): each edge is a sketch quantile, duplicates and
    non-finite edges +inf.  With the default ``8 * max_bins`` sketch bins
    an edge's rank lies within about 0.05 of the exact quantile's (the
    JAX package's stated tolerance); equal to its edges bit for bit."""
    qs = np.linspace(0, 1, max_bins + 1)[1:-1]
    edges = np.empty((len(hists), max_bins - 1), np.float32)
    for j, h in enumerate(hists):
        e = np.array([h.quantile(q) for q in qs], np.float32)
        dup = np.concatenate([[False], np.diff(e) <= 1e-7])
        edges[j] = np.where(dup | ~np.isfinite(e), np.inf, e)
    return edges


def streaming_histograms_for(chunks, hist_bins: int = 256):
    """Per-feature ``StreamingHistogram`` sketches over (n, D) chunk
    matrices (arrays or tensors, sketched on the host in float64): the
    sketch pass of an external-memory tree fit."""
    from ..utils.streaming_histogram import StreamingHistogram

    hists = None
    for chunk in chunks:
        M = (chunk.detach().cpu().numpy() if isinstance(chunk, torch.Tensor)
             else np.asarray(chunk)).astype(np.float64)
        if hists is None:
            hists = [StreamingHistogram(hist_bins) for _ in range(M.shape[1])]
        for j in range(M.shape[1]):
            hists[j].update(M[:, j])
    return hists or []


#: a feature at least this fraction zero spends its quantiles on its
#: nonzero values, with an edge pinned at 0: an all-values sketch of a 95%
#: zero feature collapses every sub-0.95 quantile to 0 (XGBoost's sketch
#: is sparsity-aware)
SPARSE_SKETCH_ZERO_FRAC = 0.5


def quantile_bins_sparse_aware(X: torch.Tensor, max_bins: int = 32,
                               sample_rows: int = 200_000,
                               seed: int = 7) -> np.ndarray:
    """Bin edges (D, max_bins-1) float32 like ``quantile_bins``, but a
    mostly zero feature sketches the quantiles of its nonzero values plus
    a pinned 0.0 edge; NaN never enters a sketch.  The row sample is
    ``quantile_bins``' own, copied to the host in one (D, n) transfer; the
    per-column arithmetic is the JAX package's, on the same float32
    values in the same order, so the edges are bit-equal to its."""
    X = torch.as_tensor(X, dtype=torch.float32)
    d = X.shape[1]
    S = _sample_rows(X, sample_rows, seed)
    n = S.shape[0]
    cols = S.T.contiguous().cpu().numpy()
    del S
    edges = np.full((d, max_bins - 1), np.inf, np.float32)
    qs_dense = np.linspace(0, 1, max_bins + 1)[1:-1]
    qs_sparse = np.linspace(0, 1, max_bins)[1:-1]     # B-2 qs + the 0 edge
    eps = 1e-7
    for j in range(d):
        col = cols[j]
        nz = col[(col != 0) & ~np.isnan(col)]
        if len(nz) and 1.0 - len(nz) / n >= SPARSE_SKETCH_ZERO_FRAC:
            e = np.unique(np.concatenate(
                [[0.0], np.quantile(nz, qs_sparse)]).astype(np.float32))
        else:
            e = np.nanquantile(col, qs_dense).astype(np.float32)
            e = e[np.isfinite(e)]
            dup = (np.concatenate([[False], np.diff(e) <= eps])
                   if len(e) else np.zeros(0, bool))
            e = e[~dup]
        edges[j, :len(e)] = e[:max_bins - 1]
    return edges


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
    padded to a multiple of 16 bytes (``binned_empty``).  The edges go to
    the device as a booked upload (``utils.profiling.upload_timed``)."""
    n, d = X.shape
    e = upload_timed(np.sort(np.asarray(edges, np.float32), axis=1),
                     X.device)
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
    """The JAX package's GOSS row budget (k_top, k_rest) for fits whose
    shallowest tree has ``min_depth``, or None when GOSS stays off.
    ``TMOG_GOSS``: '1' forces it on (the row gate bypassed; the depth gate
    always holds), '0' off, 'auto' (default) engages at depth >= 8 and
    n >= ``GOSS_MIN_ROWS``."""
    import os

    v = os.environ.get("TMOG_GOSS", "auto")
    if v == "0" or min_depth < GOSS_MIN_DEPTH:
        return None
    if v != "1" and n_rows < GOSS_MIN_ROWS:
        return None
    k_top = max(1, int(round(GOSS_TOP_FRAC * n_rows)))
    k_rest = max(1, int(round(GOSS_REST_FRAC * n_rows)))
    return None if k_top + k_rest >= n_rows else (k_top, k_rest)


def _goss_seed(seed: int, round_id: int, chain: int) -> int:
    """The generator seed of GOSS round ``round_id`` of chain ``chain``."""
    a, b = np.random.SeedSequence([seed, round_id, chain]).generate_state(
        2, np.uint32)
    return (int(a) << 31) ^ int(b)


def goss_select(ga: torch.Tensor, seed: int, round_id: int, chain: int,
                k_top: int, k_rest: int):
    """One round's GOSS row selection for one chain (the JAX package's
    ``_goss_select`` contract): the ``k_top`` rows of largest |gradient|
    ``ga`` (N,) — ties to the smaller row id — kept at weight 1, then
    ``k_rest`` rows drawn uniformly without replacement from the rest,
    weighted (N - k_top) / k_rest.  Returns (row ids (k_top + k_rest,)
    int64, multipliers float32) on ``ga``'s device.  The draw comes from a
    generator seeded by (seed, round, chain): deterministic, but not
    ``jax.random``'s bits (tests inject the JAX package's selection by
    replacing this function)."""
    n = ga.shape[0]
    dev = ga.device
    top = torch.sort(-ga, stable=True).indices[:k_top]
    gen = torch.Generator(device=dev).manual_seed(
        _goss_seed(seed, round_id, chain))
    r = torch.rand(n, device=dev, generator=gen)
    r[top] = -1.0
    rest = torch.sort(-r, stable=True).indices[:k_rest]
    mult = torch.cat([torch.ones(k_top, dtype=torch.float32, device=dev),
                      torch.full((k_rest,), (n - k_top) / k_rest,
                                 dtype=torch.float32, device=dev)])
    return torch.cat([top, rest]), mult


def goss_rows(binned: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The selected rows of ``binned`` in the kernel's row layout
    (``binned_empty``)."""
    out = binned_empty(idx.shape[0], binned.shape[1], binned.device)
    out.copy_(binned.index_select(0, idx))
    return out


# ---------------------------------------------------------------------------
# Exclusive feature bundling (EFB): the JAX package's plan, its encode on the
# binned matrix's device, and the map of grown splits back to the original
# columns
# ---------------------------------------------------------------------------

#: a column qualifies for bundling when at most this fraction of sampled
#: rows is nonzero
EFB_MAX_ACTIVE_FRAC = 0.5
#: rows of the strided sample the bundling plan is decided on
EFB_SAMPLE_ROWS = 65536
#: bundling must shrink the histogram width to at most this ratio
EFB_MIN_WIDTH_RATIO = 0.85


class FeatureBundles(NamedTuple):
    """The invertible plan ``bundle_features`` makes.  ``plan``: one entry
    per bundled column, an original column id (copied as it is) or a tuple
    of (original id, base, end) members, the member's nonzero bins shifted
    to bundle bins [base, end].  ``col_feat``/``col_thresh`` (D_b, B) map a
    bundled split back to an original (feature, threshold); ``end_bin``
    (B, D_b) is each threshold's member end, which the grower reads."""

    plan: Tuple
    col_feat: np.ndarray      # (D_b, B) int32
    col_thresh: np.ndarray    # (D_b, B) int32
    end_bin: np.ndarray       # (B, D_b) int32
    n_orig: int
    n_bins: int

    @property
    def width(self) -> int:
        return int(self.col_feat.shape[0])

    @property
    def width_ratio(self) -> float:
        return self.width / max(self.n_orig, 1)

    def bundled_dd_mask(self, dd_mask: Optional[np.ndarray]) -> np.ndarray:
        """Default-direction eligibility in bundled column space: a bundle
        column never learns a default direction (its bin 0 is "every member
        at zero"); a singleton column keeps its flag."""
        out = np.zeros(self.width, bool)
        if dd_mask is None:
            return out
        dd = np.asarray(dd_mask, bool)
        for c, spec in enumerate(self.plan):
            if isinstance(spec, (int, np.integer)):
                out[c] = bool(dd[int(spec)])
        return out


#: set bits of each byte value
_POP8 = np.array([bin(v).count("1") for v in range(256)], np.int64)


def _popcount(words: np.ndarray) -> int:
    """Set bits in an array of 64-bit words."""
    if hasattr(np, "bitwise_count"):
        return int(np.bitwise_count(words).sum())
    return int(_POP8[words.view(np.uint8)].sum())


def bundle_features(binned, edges, max_bins: int,
                    max_conflict_rate: float = 0.0,
                    sample_rows: int = EFB_SAMPLE_ROWS,
                    min_width_ratio: float = EFB_MIN_WIDTH_RATIO
                    ) -> Optional[FeatureBundles]:
    """The JAX package's greedy bundling plan over a binned (N, D) matrix
    (tensor or array), or None where it declines (D < 3, ``max_bins`` >
    127, fewer than two candidate columns, no bundle of two, or a width
    above ``min_width_ratio`` x D).  Exclusivity is decided in numpy on the
    strided row sample ``binned[::max(1, N // sample_rows)][:sample_rows]``
    (only the sample leaves the device): a candidate column has two or more
    used bins, zeros in bin 0 (its smallest finite edge >= 0) and at most
    ``EFB_MAX_ACTIVE_FRAC`` of the sample nonzero; candidates pack densest
    first into the first bundle with room for their bins and conflicts
    within ``max_conflict_rate`` x the sample's rows."""
    n, d = binned.shape
    if d < 3 or max_bins > 127:
        return None
    e = np.asarray(edges, np.float32)
    finite = np.isfinite(e)
    used_bins = finite.sum(axis=1) + 1
    first_edge = np.where(finite, e, np.inf).min(axis=1)
    zero_ok = first_edge >= 0.0

    step = max(1, n // sample_rows)
    samp = torch.as_tensor(binned)[::step][:sample_rows].cpu().numpy()
    ns = samp.shape[0]
    active = samp != 0
    act_frac = active.mean(axis=0)
    cand = (used_bins >= 2) & zero_ok & (act_frac <= EFB_MAX_ACTIVE_FRAC)
    cand_ids = np.where(cand)[0]
    if len(cand_ids) < 2:
        return None
    # each column's active rows as packed 64-bit words: a conflict count
    # is the popcount of two columns' AND (the same count as the rows')
    packed = np.packbits(active, axis=0)
    packed = np.concatenate([packed, np.zeros(((-packed.shape[0]) % 8, d),
                                              np.uint8)])
    words = np.ascontiguousarray(packed.T).view(np.uint64)     # (d, w)
    del packed, samp

    budget = int(max_conflict_rate * ns)
    order = cand_ids[np.argsort(-act_frac[cand_ids], kind="stable")]
    bundles: List[dict] = []
    for j in order:
        uj = int(used_bins[j])
        aj = words[j]
        for b in bundles:
            if b["bins"] + (uj - 1) > max_bins:
                continue
            conflicts = _popcount(aj & b["active"])
            if b["conflicts"] + conflicts > budget:
                continue
            b["members"].append(int(j))
            b["bins"] += uj - 1
            b["conflicts"] += conflicts
            b["active"] |= aj
            break
        else:
            bundles.append({"members": [int(j)], "bins": uj,
                            "conflicts": 0, "active": aj.copy()})
    multi = {}
    for b in bundles:
        if len(b["members"]) >= 2:
            ms = sorted(b["members"])
            multi[ms[0]] = ms
    if not multi:
        return None
    in_multi = {j for ms in multi.values() for j in ms}
    width = d - len(in_multi) + len(multi)
    if width > min_width_ratio * d:
        return None

    B = int(max_bins)
    plan: List = []
    for j in range(d):
        if j not in in_multi:
            plan.append(j)
        elif j in multi:                      # a bundle sits at its first
            specs, base = [], 1               # member
            for m in multi[j]:
                um = int(used_bins[m])
                specs.append((m, base, base + um - 2))
                base += um - 1
            plan.append(tuple(specs))
    d_b = len(plan)
    col_feat = np.zeros((d_b, B), np.int32)
    col_thresh = np.zeros((d_b, B), np.int32)
    end_bin = np.empty((B, d_b), np.int32)
    ts = np.arange(B, dtype=np.int32)
    for c, spec in enumerate(plan):
        if isinstance(spec, (int, np.integer)):
            col_feat[c] = int(spec)
            col_thresh[c] = ts
            end_bin[:, c] = B - 1
        else:
            ends = np.asarray([s[2] for s in spec], np.int32)
            # the owner of threshold t: the member of the smallest end > t;
            # past the last member the interval (t, t] is empty
            owner = np.searchsorted(ends, ts, side="right")
            tail = owner >= len(spec)
            owner = np.minimum(owner, len(spec) - 1)
            end_bin[:, c] = np.where(tail, ts, ends[owner])
            feats = np.asarray([s[0] for s in spec], np.int32)
            bases = np.asarray([s[1] for s in spec], np.int32)
            col_feat[c] = feats[owner]
            col_thresh[c] = np.maximum(ts - bases[owner] + 1, 0)
    return FeatureBundles(plan=tuple(plan), col_feat=col_feat,
                          col_thresh=col_thresh, end_bin=end_bin,
                          n_orig=d, n_bins=B)


def bundle_matrix(bundles: FeatureBundles, binned: torch.Tensor
                  ) -> torch.Tensor:
    """The (N, D_b) bundled matrix on ``binned``'s device, in the kernel's
    row layout (``binned_empty``): singleton columns copied, a bundle's bin
    base + b - 1 for its active member's bin b > 0, else 0; where several
    members are active (a nonzero conflict budget) the largest encoded
    value wins."""
    n = binned.shape[0]
    dev = binned.device
    out = binned_empty(n, bundles.width, dev)
    single_b, single_o, mem_b, mem_o, mem_base = [], [], [], [], []
    for c, spec in enumerate(bundles.plan):
        if isinstance(spec, (int, np.integer)):
            single_b.append(c)
            single_o.append(int(spec))
        else:
            for orig, base, _end in spec:
                mem_b.append(c)
                mem_o.append(orig)
                mem_base.append(base)

    def ids(v):
        return torch.tensor(v, dtype=torch.int64, device=dev)

    sb, so, mb, mo = ids(single_b), ids(single_o), ids(mem_b), ids(mem_o)
    base = torch.tensor(mem_base, dtype=torch.int32, device=dev)
    bundle_cols = torch.unique(mb)
    slot = torch.searchsorted(bundle_cols, mb)
    for a in range(0, n, _BIN_ROW_BLOCK):
        rows = binned[a:a + _BIN_ROW_BLOCK]
        blk = out[a:a + _BIN_ROW_BLOCK]
        blk[:, sb] = rows.index_select(1, so)
        v = rows.index_select(1, mo).to(torch.int32)
        enc = torch.where(v > 0, base + v - 1, 0)
        acc = torch.zeros((rows.shape[0], len(bundle_cols)),
                          dtype=torch.int32, device=dev)
        acc.scatter_reduce_(1, slot.expand_as(enc), enc, "amax")
        blk[:, bundle_cols] = acc.to(torch.uint8)
    return out


def unbundle_ensemble(bundles: FeatureBundles, feat: torch.Tensor,
                      thresh: torch.Tensor, tables=None):
    """Splits grown in bundled column space (int32 tensors of any shape)
    as original (feature, threshold) pairs on their device: exact for every
    per-member interval split; no-split sentinels (thresh == B) and
    default-direction splits (negative, singleton columns only) keep their
    threshold.  ``tables``: ``bundles.col_feat``/``col_thresh`` already on
    the splits' device (a fit unbundling tree by tree passes them, so no
    tree waits on a host-to-device copy)."""
    dev = feat.device
    B = bundles.n_bins
    cf, ct = tables if tables is not None else (
        torch.from_numpy(bundles.col_feat).to(dev),
        torch.from_numpy(bundles.col_thresh).to(dev))
    f = feat.long()
    t_id = thresh.clamp(0, B - 1).long()
    passthrough = (thresh >= B) | (thresh < 0)
    f_out = torch.where(passthrough, cf[f, 0], cf[f, t_id])
    t_out = torch.where(passthrough, thresh, ct[f, t_id])
    return f_out.to(torch.int32), t_out.to(torch.int32)


# ---------------------------------------------------------------------------
# The CSR histogram path: a level's histograms from the nonzero entries of
# a wide, mostly zero matrix
# ---------------------------------------------------------------------------

class FeatureCSR(NamedTuple):
    """The nonzero entries of a matrix, column by column (the JAX package's
    ``build_feature_csr`` layout): ``rows`` (D, NZ) int32 row ids padded
    with N, ``bins`` (D, NZ) uint8 their bins (0 in the padding),
    ``zero_bin`` (D,) uint8 the bin 0.0 falls in, all on the matrix's
    device."""
    rows: torch.Tensor
    bins: torch.Tensor
    zero_bin: torch.Tensor

    @property
    def nz_max(self) -> int:
        return int(self.rows.shape[1])


#: columns of one block of the CSR build (an (N, block) copy of the matrix)
_CSR_BUILD_COLS = 128
#: entries per block of the sparse level histogram
SPARSE_ENTRY_BLOCK = 1 << 24
#: the sparse histogram serves levels of at most this many slots; wider
#: levels take ``seg_level_hists`` (the JAX package's constant)
SPARSE_MAX_SLOTS = 2048


def build_feature_csr(X: torch.Tensor, edges, binned: torch.Tensor
                      ) -> Optional[FeatureCSR]:
    """The per-column padded CSR of ``X``'s nonzero entries (NaN counts as
    nonzero and sits in bin 0, as binning puts it), built on X's device
    with torch ops; ``binned`` is X binned by ``edges`` (its entries are
    the CSR's bins).  None where the matrix does not qualify (the JAX
    package's rules): B + 1 > 127 bins, no nonzero, density above 0.25, or
    a column of more than max(4 x the mean, 64) nonzeros."""
    e = np.asarray(edges, np.float32)
    if e.shape[1] + 1 > 127:
        return None
    n, d = X.shape
    dev = X.device
    nnz = torch.zeros(d, dtype=torch.int64, device=dev)
    for a in range(0, n, _BIN_ROW_BLOCK):
        nnz += (X[a:a + _BIN_ROW_BLOCK] != 0).sum(0)
    counts = nnz.cpu().numpy()
    total = int(counts.sum())
    if total == 0 or total / (n * d) > 0.25:
        return None
    nz_max = int(counts.max())
    if nz_max > max(4.0 * total / d, 64.0):
        return None
    rows = torch.full((d, nz_max), n, dtype=torch.int32, device=dev)
    bins = torch.zeros((d, nz_max), dtype=torch.uint8, device=dev)
    starts = torch.from_numpy(np.concatenate([[0], np.cumsum(counts)])).to(
        dev)
    for j0 in range(0, d, _CSR_BUILD_COLS):
        j1 = min(d, j0 + _CSR_BUILD_COLS)
        # (column, row) pairs ordered by column, then row
        cr = torch.nonzero(X[:, j0:j1].T)
        col = cr[:, 0] + j0
        pos = (torch.arange(cr.shape[0], device=dev)
               - (starts[col] - starts[j0]))
        rows[col, pos] = cr[:, 1].to(torch.int32)
        bins[col, pos] = binned[cr[:, 1], col]
        del cr, col, pos
    zero_bin = (np.sort(e, axis=1) < 0.0).sum(axis=1).astype(np.uint8)
    return FeatureCSR(rows, bins, torch.from_numpy(zero_bin).to(dev))


def sparse_level_hists(csr: FeatureCSR, slot: torch.Tensor, ch: torch.Tensor,
                       M: int, B: int) -> torch.Tensor:
    """One tree level's histograms (C, M, B, d) float32 from the nonzero
    entries only (the JAX package's ``_sparse_level_hists``): each entry
    adds its row's channels at (slot, bin, column), and each column's
    zero bin gets the slot's channel totals minus the column's nonzero
    sums.  A scatter-add in float64 over blocks of columns (atomic on the
    card, so the float64 order varies, which the one rounding to float32
    hides), plain torch ops on any device; ``sparse_level_hists.levels``
    counts the levels built."""
    d, nz = csr.rows.shape
    n, C = ch.shape
    dev = ch.device
    slot_pad = torch.cat([slot.to(torch.int64),
                          torch.zeros(1, dtype=torch.int64, device=dev)])
    ch_pad = torch.cat([ch.to(torch.float64),
                        torch.zeros((1, C), dtype=torch.float64,
                                    device=dev)])
    acc = torch.zeros((M * B * d, C), dtype=torch.float64, device=dev)
    step = max(1, SPARSE_ENTRY_BLOCK // max(nz, 1))
    for j0 in range(0, d, step):
        r = csr.rows[j0:j0 + step].to(torch.int64)
        cols = torch.arange(j0, j0 + r.shape[0], device=dev)[:, None]
        flat = (slot_pad[r] * B + csr.bins[j0:j0 + step].to(torch.int64)
                ) * d + cols
        acc.index_add_(0, flat.reshape(-1), ch_pad[r].reshape(-1, C))
        del r, flat
    tot = torch.zeros((M, C), dtype=torch.float64, device=dev)
    tot.index_add_(0, slot.to(torch.int64), ch.to(torch.float64))
    acc = acc.reshape(M, B, d, C)
    zero = tot[:, None, :] - acc.sum(1)                     # (M, d, C)
    idx = csr.zero_bin.to(torch.int64)[None, None, :, None].expand(
        M, 1, d, C)
    acc.scatter_add_(1, idx, zero[:, None])
    sparse_level_hists.levels += 1
    return acc.to(torch.float32).permute(3, 0, 1, 2).contiguous()


sparse_level_hists.levels = 0


def csr_hist_fn(csr: FeatureCSR, dense: "HistFn" = None) -> "HistFn":
    """A grower's ``hist_fn`` for a matrix with a CSR: levels of at most
    ``SPARSE_MAX_SLOTS`` slots from ``sparse_level_hists``, wider ones
    from ``dense`` (the kernel wrapper by default)."""
    dense = seg_level_hists if dense is None else dense

    def hist(binned, slot, ch, M, B):
        if M <= SPARSE_MAX_SLOTS:
            return sparse_level_hists(csr, slot, ch, M, B)
        return dense(binned, slot, ch, M, B)
    return hist


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


def seg_plan(n: int, d: int, M: int, B: int, nchan: int) -> SegPlan:
    """The ``seg_hist`` kernel's launch geometry for an (n, d) level of M
    slots, B bins and ``nchan`` channels in one launch.  The slot-sorted
    rows are cut at every slot bound and
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
    cut to what B x nchan histograms leave room for in a block's shared
    memory; q is at most ``SEG_ROWS_PER_WARP``."""
    per_warp = _smem_per_warp(B, nchan)
    warps = min(SEG_WARPS, _SMEM_BLOCK // per_warp)
    if warps < 1 or B < 1 or not 1 <= nchan <= SEG_MAX_CHANNELS:
        raise ValueError(f"B={B} bins x {nchan} channels leave no room for "
                         f"one warp's histogram (B <= {SEG_MAX_BINS} at two "
                         f"channels, 1 <= channels <= {SEG_MAX_CHANNELS})")
    group_rows = warps * SEG_ROWS_PER_WARP
    n_tiles = -(-d // SEG_TILE)
    n_groups = M + n // group_rows
    n_blocks = n_groups * n_tiles
    if n_blocks >= 2 ** 31:
        raise ValueError(f"{n_blocks} blocks exceed the grid")
    return SegPlan(warps, SEG_ROWS_PER_WARP, group_rows, n_tiles,
                   n_tiles * SEG_TILE, n_groups, n_blocks,
                   warps * per_warp)


@functools.lru_cache(maxsize=None)
def seg_channel_groups(nchan: int, B: int) -> Tuple[Tuple[int, int], ...]:
    """The channel groups the ``seg_hist`` kernel runs ``nchan`` channels
    of B bins in, as (first channel, width) pairs: as few launches as the
    widest launch allows (``SEG_MAX_CHANNELS``, and one warp's histograms
    within a block's shared memory), their widths as even as can be.  Each
    group re-reads ``binned``."""
    fit = min(SEG_MAX_CHANNELS, max(
        (c for c in range(1, SEG_MAX_CHANNELS + 1)
         if _smem_per_warp(B, c) <= _SMEM_BLOCK), default=0))
    if fit < 1:
        raise ValueError(f"B={B} bins leave no room for one channel")
    k = -(-nchan // fit)
    q, r = divmod(nchan, k)
    out, c0 = [], 0
    for i in range(k):
        w = q + (i < r)
        out.append((c0, w))
        c0 += w
    return tuple(out)


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
                   + [ctypes.c_int] * 8 + [ctypes.c_void_p])
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


def _ch_copy_bytes(nchan: int) -> int:
    """Bytes the kernel copies a row's ``nchan`` channels in (16, 8 or 4:
    the widest that divides 4 x nchan); the channels' base must be a
    multiple of it."""
    return 16 if nchan % 4 == 0 else 8 if nchan % 2 == 0 else 4


def seg_level_hists(binned: torch.Tensor, slot: torch.Tensor,
                    ch: torch.Tensor, M: int, B: int) -> torch.Tensor:
    """One tree level's per-channel histograms (C, M, B, d) float32:
    ``out[c, m, b, j] = sum_i ch[i, c] [slot_i = m] [binned[i, j] = b]``,
    exact zeros for empty slots.

    ``binned`` (N, d) uint8 with values < B <= ``SEG_MAX_BINS``, unit column
    stride and a row stride and base that are multiples of 4 bytes (as
    ``apply_bins`` returns it); ``slot`` (N,) int32 in [0, M) with M <=
    ``SEG_MAX_SLOTS``; ``ch`` (N, C) float32, C >= 1 channels (gradient
    and hessian of a boosted level; a forest's class indicators and
    count) whose base, where one launch reads all C channels, is a
    multiple of the row copy's bytes (16 for C % 4 == 0, 8 for other even
    C, else 4); slot and ch contiguous, all on one
    device.  CUDA tensors launch the ``seg_hist`` kernel (bitwise
    deterministic) with ``seg_plan``'s geometry, once per channel group
    (``seg_channel_groups``: one launch for C <= 13 at 32 bins; past it,
    each group's columns are copied into rows of their own); CPU tensors
    take the plain version.  ``seg_level_hists.launches`` counts kernel
    launches, as does the run ledger under ``seg_hist``
    (``utils.profiling.count_launch``); each launch runs two device
    kernels, ``seg_hist_groups`` and ``seg_hist_reduce``."""
    n, d = binned.shape
    if binned.dtype != torch.uint8 or binned.dim() != 2:
        raise TypeError(f"binned must be (N, d) uint8, got "
                        f"{tuple(binned.shape)} {binned.dtype}")
    if slot.dtype != torch.int32 or tuple(slot.shape) != (n,):
        raise TypeError(f"slot must be ({n},) int32, got "
                        f"{tuple(slot.shape)} {slot.dtype}")
    if (ch.dtype != torch.float32 or ch.dim() != 2 or ch.shape[0] != n
            or ch.shape[1] < 1):
        raise TypeError(f"ch must be ({n}, C) float32 with C >= 1, got "
                        f"{tuple(ch.shape)} {ch.dtype}")
    nchan = ch.shape[1]
    if not (binned.device == slot.device == ch.device):
        raise ValueError("binned, slot and ch must share one device")
    if not (slot.is_contiguous() and ch.is_contiguous()):
        raise ValueError("slot and ch must be contiguous")
    if not _rows_fit(binned, 4):
        raise ValueError(
            f"binned needs unit column stride, a row stride and base that are "
            f"multiples of 4 bytes and storage to its last row's 4-byte word "
            f"(binned_empty makes one), got strides "
            f"{binned.stride()}, base offset {binned.data_ptr() % 4}")
    if not (1 <= B <= SEG_MAX_BINS and 1 <= M <= SEG_MAX_SLOTS
            and nchan * B * d < 2 ** 31 and n < 2 ** 31):
        raise ValueError(f"need 1 <= B <= {SEG_MAX_BINS} (shared memory), "
                         f"1 <= M <= {SEG_MAX_SLOTS} (grid) and N < 2^31 "
                         f"(int32 row positions), got B={B} M={M} N={n}")
    groups = seg_channel_groups(nchan, B)
    if len(groups) == 1 and ch.data_ptr() % _ch_copy_bytes(nchan):
        # one launch reads ``ch`` itself; past it, each group's columns
        # are copied into fresh rows
        raise ValueError(f"ch of {nchan} channels needs a base aligned to "
                         f"{_ch_copy_bytes(nchan)} bytes (the kernel copies "
                         f"a row's channels in such pieces), got offset "
                         f"{ch.data_ptr() % _ch_copy_bytes(nchan)}")
    if binned.device.type == "cpu":
        return seg_level_hists_plain(binned, slot, ch, M, B)
    if binned.device.type != "cuda":
        raise ValueError(f"unsupported device {binned.device}")

    dev = binned.device
    perm, bounds = seg_layout(slot, M)
    plans = {w: seg_plan(n, d, M, B, w) for _, w in groups}
    scratch = torch.empty(
        max(p.n_groups * w * B * p.width for w, p in plans.items()),
        dtype=torch.float32, device=dev)
    out = torch.empty((nchan, M, B, d), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    wide = int(_rows_fit(binned, 16))
    launch = _seg_lib()
    for c0, w in groups:
        plan = plans[w]
        cg = ch if w == nchan else ch[:, c0:c0 + w].contiguous()
        err = launch(binned.data_ptr(), perm.data_ptr(), cg.data_ptr(),
                     bounds.data_ptr(), scratch.data_ptr(),
                     out[c0].data_ptr(), binned.stride(0), w, d, M, B,
                     plan.warps, plan.group_rows, plan.n_groups, wide,
                     stream)
        if err != 0:
            raise RuntimeError(f"seg_hist launch failed: CUDA error {err}")
        seg_level_hists.launches += 1
        count_launch("seg_hist")
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
              max_depth: int, n_bins: int, C: Optional[torch.Tensor] = None,
              lam: float = 1.0, min_child_weight: float = 0.0,
              min_info_gain: float = 0.0, min_instances: float = 1.0,
              feat_mask: Optional[torch.Tensor] = None,
              newton_leaf: bool = True, min_gain_raw: float = 0.0,
              learning_rate: float = 1.0, default_dir: bool = False,
              dd_mask: Optional[torch.Tensor] = None,
              hist_fn: HistFn = seg_level_hists,
              bundle_end: Optional[torch.Tensor] = None) -> TreeArrays:
    """Grow one tree level by level (the JAX package's
    ``_grow_tree_traced``).

    ``binned`` (N, d) uint8; ``G``/``H`` (N, K) float32 gradients and
    hessians.  With a count channel ``C`` (N,) (bag mode ``"none"``) each
    level's histograms have 2K+1 channels [G_0..G_{K-1}, H_0..H_{K-1}, C]
    and a split needs ``min_instances`` count on each side and gain per
    unit of node count ``>= min_info_gain``; without one (``"newton"``,
    XGBoost's gating) the 2K channels [G.., H..] serve and the hessian
    mass stands in for counts, so the count gates are inert.  Both gate on
    ``min_child_weight`` of every class's hessian mass on each side, gain
    > 0 and the raw gain ``>= min_gain_raw`` (XGBoost's gamma).
    ``feat_mask`` (d,) bool: the features a split may use (column
    subsampling).  ``default_dir``: each split also tries sending the bin-0
    mass right (features of ``dd_mask`` only), encoded as a negative
    threshold.  Leaves are Newton steps -lr G / (H + lam) or, with
    ``newton_leaf=False``, means G / C.

    Nodes that fail the gates emit the no-split sentinel (thresh = B);
    levels with more nodes than next_pow2(N) compact their node ids into
    that many slots.  ``hist_fn`` builds each level's histograms (the
    kernel wrapper by default; the plain version for comparisons on the
    card).

    ``bundle_end`` (B, d) int32: ``binned`` is an EFB-bundled matrix
    (``bundle_matrix``) and each candidate (t, f) is the interval split
    "bin in (t, E[t, f]]" right, everything else left; rows route right
    only up to E.  Columns with E = B - 1 (singletons, a bundle's last
    member) take the standard arithmetic (totals minus the left sums), as
    the JAX package does, so on a conflict-free matrix the unbundled
    splits (``unbundle_ensemble``) equal the unbundled fit's.  ``dd_mask``
    is then in bundled space (``FeatureBundles.bundled_dd_mask``)."""
    n, d = binned.shape
    k = G.shape[1]
    B = n_bins
    dev = binned.device
    n_cap = _slot_cap(n)
    newton = C is None
    chans = [G, H] if newton else [G, H, C[:, None]]
    ch = torch.cat(chans, dim=1).to(torch.float32).contiguous()
    if newton:
        min_instances = 0.0     # the hessian mass stands in for counts
    rows = torch.arange(n, device=dev)
    bin_ids = torch.arange(B, device=dev)[None, :, None]
    fmask = None if feat_mask is None else feat_mask.to(dev)[None, None, :]
    node = torch.zeros(n, dtype=torch.int32, device=dev)
    heap_feat, heap_thresh = [], []
    for level in range(max_depth):
        level_nodes = 2 ** level
        compact = level_nodes > n_cap
        M = n_cap if compact else level_nodes
        slot, uniq = _compact_slots(node, n_cap) if compact else (node, None)
        hists = hist_fn(binned, slot.contiguous(), ch, M, B)
        cums = torch.cumsum(hists, dim=2)             # (2K[+1], M, B, d)
        GLs, HLs = cums[:k], cums[k:2 * k]
        CL = HLs[0] if newton else cums[2 * k]

        gain = 0.0
        HLmin = HRmin = None
        Ctot = CL[:, -1:, :1]
        if bundle_end is None:
            for GL, HL in zip(GLs, HLs):
                Gtot, Htot = GL[:, -1:, :1], HL[:, -1:, :1]
                GR, HR = Gtot - GL, Htot - HL
                gain = gain + (GL * GL / (HL + lam) + GR * GR / (HR + lam)
                               - Gtot * Gtot / (Htot + lam))
                HLmin = HL if HLmin is None else torch.minimum(HLmin, HL)
                HRmin = HR if HRmin is None else torch.minimum(HRmin, HR)
            CR = Ctot - CL
            CLft = CL
        else:
            # the interval split's right side: the owner member's bins
            # (t, E]; E = B-1 entries keep the standard arithmetic
            Eb = bundle_end.to(dev, torch.int64)[None].expand(M, B, d)
            is_std = Eb == B - 1

            def right(A, tot):
                return torch.where(is_std, tot - A,
                                   torch.gather(A, 1, Eb) - A)

            for GL, HL in zip(GLs, HLs):
                Gtot, Htot = GL[:, -1:, :1], HL[:, -1:, :1]
                GR, HR = right(GL, Gtot), right(HL, Htot)
                GLft = torch.where(is_std, GL, Gtot - GR)
                HLft = torch.where(is_std, HL, Htot - HR)
                gain = gain + (GLft * GLft / (HLft + lam)
                               + GR * GR / (HR + lam)
                               - Gtot * Gtot / (Htot + lam))
                HLmin = HLft if HLmin is None else torch.minimum(HLmin, HLft)
                HRmin = HR if HRmin is None else torch.minimum(HRmin, HR)
            CR = right(CL, Ctot)
            CLft = torch.where(is_std, CL, Ctot - CR)
            del Eb, is_std
        valid = ((HLmin >= min_child_weight) & (HRmin >= min_child_weight)
                 & (CLft >= min_instances) & (CR >= min_instances)
                 & (bin_ids < B - 1))
        if fmask is not None:
            valid = valid & fmask
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
                       & (CLb >= min_instances) & (CRb >= min_instances)
                       & (bin_ids < B - 1) & (c0 > 0))
            if fmask is not None:
                valid_b = valid_b & fmask
            if dd_mask is not None:
                valid_b = valid_b & dd_mask[None, None, :]
            flat_gain = torch.cat(
                [flat_gain,
                 torch.where(valid_b, gain_b, neg_inf).reshape(M, B * d)],
                dim=1)

        best = torch.argmax(flat_gain, dim=1)
        best_gain = flat_gain.gather(1, best[:, None])[:, 0]
        ok = ((best_gain > 0) & (best_gain / node_w >= min_info_gain)
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
        fid = feat_l[sl].long()
        x_row = binned[rows, fid]
        tv = thresh_l[sl]
        go_right = route_right(x_row, tv)
        if bundle_end is not None:
            # rows past the owner member's end belong to other members
            go_right = go_right & (x_row.to(torch.int32) <= _end_of(
                bundle_end, tv, fid))
        node = 2 * node + go_right.to(torch.int32)

    leaf = _leaf_values(node, ch, k, 2 ** max_depth, lam, learning_rate,
                        newton_leaf)
    return TreeArrays(torch.cat(heap_feat), torch.cat(heap_thresh), leaf)


def _end_of(bundle_end: torch.Tensor, t: torch.Tensor, f: torch.Tensor
            ) -> torch.Tensor:
    """The member end E[clip(t, 0, B-1), f] of each (threshold, bundled
    column) pair."""
    B, d = bundle_end.shape
    be = bundle_end.to(t.device).reshape(-1)
    return be[t.clamp(0, B - 1).long() * d + f.long()]


#: one-hot elements per block of the leaf sums
_LEAF_BLOCK_ELEMS = 64 << 20


def _leaf_values(node, ch, k: int, n_leaves: int, lam: float,
                 learning_rate: float, newton_leaf: bool = True
                 ) -> torch.Tensor:
    """Leaf values from the per-leaf sums of the level channels ``ch`` (N,
    2K[+1]) = [G, H(, C)]: Newton steps -lr * G_leaf / (H_leaf + lam), or
    means G_leaf / max(C_leaf, 1e-12).  Sums are one-hot products over row
    blocks — a fixed summation order, so the leaves are deterministic on
    the card, unlike an atomic scatter."""
    n = ch.shape[0]
    sums = torch.zeros((n_leaves, ch.shape[1]), dtype=torch.float32,
                       device=ch.device)
    leaves = torch.arange(n_leaves, device=ch.device, dtype=torch.int32)
    step = max(1, _LEAF_BLOCK_ELEMS // n_leaves)
    for a in range(0, n, step):
        oh = (node[a:a + step, None] == leaves[None, :]).to(torch.float32)
        sums += oh.T @ ch[a:a + step]
    Gs, Hs = sums[:, :k], sums[:, k:2 * k]
    if newton_leaf:
        return -learning_rate * Gs / (Hs + lam)
    return Gs / torch.clamp(sums[:, 2 * k:], min=1e-12)


# ---------------------------------------------------------------------------
# Random forests
# ---------------------------------------------------------------------------

class RFGrowth(NamedTuple):
    """Forests of P (candidate, fold) pairs x T trees: feat/thresh
    (P, T, 2^hd-1) int32 heaps with full-width feature ids, leaf
    (P, T, 2^hd, K) — the K class shares or the bag-weighted mean
    label (K = 1, regression) — ``snaps`` {level: (P, T, 2^level, K)} the
    leaves of each tree truncated at that level, and ``levels`` the
    per-level histograms built (one ``hist_fn`` call each)."""
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


def _rf_leaves(s: torch.Tensor, regression: bool) -> torch.Tensor:
    """Leaf values from per-node sums of a tree's histogram channels: the
    bag-weighted mean label (M, 1) from (bw y, bw), or the K class shares
    (M, K) from (bw [y=0], .., bw [y=K-2], bw), the last class's sum
    rebuilt as the count minus the others' (added left to right, as the
    JAX package sums them)."""
    c = torch.clamp(s[:, -1:], min=1e-12)
    if regression:
        return s[:, :1] / c
    cls = [s[:, k] for k in range(s.shape[1] - 1)]
    return torch.stack(cls + [s[:, -1] - sum(cls)], 1) / c


def _grow_rf_tree(binned, sub, fidx, Y, bw, min_ig: float, min_inst: float,
                  depth_limit: int, heap_depth: int, B: int, leaf_levels,
                  hist_fn: HistFn, regression: bool = False):
    """One bagged tree with a feature subset (the JAX package's
    ``_grow_tree_traced`` in bag mode ``"onehot"`` for K-class targets,
    ``"bagged"`` for regression).

    ``Y`` is the (N, K) one-hot class matrix of a K-class label (K >= 2),
    or the (N, 1) real label.  The histogram channels are (bw [y=0], ..,
    bw [y=K-2], bw): the last class's gradient is the count minus the
    others' and every hessian is the count; or (bw y, bw), whose hessian
    is the count.  Gain is the sum over the classes (in class order) of
    GL^2/(HL+lam) + GR^2/(HR+lam) - G^2/(H+lam) (lam = ``RF_LAMBDA``:
    variance reduction for regression); a split needs ``min_inst`` bag
    weight on each side, gain > 0 and gain / node weight >= ``min_ig``.
    Leaves are the K class shares or the bag-weighted mean label.
    Histograms run at subset width over ``sub`` (the subset's columns of
    ``binned``, gathered once per tree); routing reads the full matrix
    through ``fidx``.  Levels at or past ``depth_limit`` split nothing,
    so they build no histogram; nor do the levels below one whose nodes
    all stayed closed (a closed node sends its rows left, to a child with
    the same rows and the same decision).  That flag is read one level
    late, so the host never waits on the level it just enqueued.  Returns
    (feat, thresh, leaf, snaps, levels)."""
    n, msub = sub.shape
    dev = binned.device
    n_cap = _slot_cap(n)
    lam = RF_LAMBDA
    bwc = bw[:, None]
    ch = torch.cat([bwc * (Y if regression else Y[:, :-1]), bwc],
                   1).contiguous()
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
            snaps.append(_rf_leaves(_node_sums(node, ch, level_nodes),
                                    regression))
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
        cums = torch.cumsum(hists, dim=2)                  # (K, M, B, msub)
        CL = cums[-1]
        Ctot = CL[:, -1:, :1]
        GLs = list(cums[:-1])
        if not regression:
            GLs.append(CL - sum(GLs))
        gain = 0.0
        for GL in GLs:
            Gtot = GL[:, -1:, :1]
            GR, HR = Gtot - GL, Ctot - CL
            gain = gain + (GL * GL / (CL + lam) + GR * GR / (HR + lam)
                           - Gtot * Gtot / (Ctot + lam))
        CR = Ctot - CL
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
    if regression:
        leaf = _rf_leaves(_node_sums(node, ch, 2 ** heap_depth), True)
    else:
        s = _node_sums(node, torch.cat([bwc * Y, bwc], 1), 2 ** heap_depth)
        leaf = s[:, :-1] / torch.clamp(s[:, -1:], min=1e-12)
    feat = fidx[torch.cat(heap_feat).long()].to(torch.int32)
    return feat, torch.cat(heap_thresh), leaf, snaps, levels


def grow_rf_grid(binned: torch.Tensor, y: torch.Tensor, W_tr: torch.Tensor,
                 seed: int, n_trees: int, pair_fold, pair_min_ig,
                 pair_min_inst, pair_depth, msub: int, subsample_rate: float,
                 n_bins: int, leaf_levels: Sequence[int] = (),
                 hist_fn: HistFn = seg_level_hists,
                 regression: bool = False, n_classes: int = 2) -> RFGrowth:
    """Every (candidate x fold) pair's random forest: K-class
    classification (``n_classes`` K >= 2: K class shares in the leaves;
    the level histograms take K channels), or regression (``regression``:
    the bag-weighted mean label in the leaves).

    ``binned`` (N, D) uint8; ``y`` (N,) labels in {0, .., K-1} or real;
    ``W_tr`` (F, N)
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
    yt = y.to(dev, torch.float32)
    Y = (yt[:, None] if regression else torch.nn.functional.one_hot(
        yt.long(), int(n_classes)).to(torch.float32))
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
                binned, sub, ft, Y, bw,
                float(np.float32(pair_min_ig[p])),
                float(np.float32(pair_min_inst[p])), int(pair_depth[p]),
                heap_depth, n_bins, leaf_levels, hist_fn, regression)
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
                   hist_fn: HistFn = seg_level_hists,
                   regression: bool = False, n_classes: int = 2
                   ) -> RFGrowth:
    """One random forest on ``base_w`` (N,) row weights: the grid grower
    with a single pair; its arrays have no pair axis (feat (T, 2^d-1),
    leaf (T, 2^d, K))."""
    g = grow_rf_grid(binned, y, base_w[None], seed, n_trees, [0],
                     [min_info_gain], [min_instances], [max_depth], msub,
                     subsample_rate, n_bins, hist_fn=hist_fn,
                     regression=regression, n_classes=n_classes)
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


def predict_tree_bundled(binned: torch.Tensor, feat: torch.Tensor,
                         thresh: torch.Tensor, leaf: torch.Tensor,
                         max_depth: int, bundle_end: torch.Tensor
                         ) -> torch.Tensor:
    """``predict_tree`` in bundled column space (a tree grown with
    ``bundle_end``): a row goes right only up to its split's member end.
    The boosting loop's margin updates use it; a fitted model's trees are
    unbundled and route through ``predict_tree``."""
    n = binned.shape[0]
    rows = torch.arange(n, device=binned.device)
    node = torch.zeros(n, dtype=torch.int64, device=binned.device)
    for level in range(max_depth):
        heap = (2 ** level - 1) + node
        f, t = feat[heap].long(), thresh[heap]
        x = binned[rows, f]
        go = route_right(x, t) & (x.to(torch.int32)
                                  <= _end_of(bundle_end, t, f))
        node = 2 * node + go.long()
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
