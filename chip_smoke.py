#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``transmogrifai_tpu_torch``) on one
NVIDIA GPU: builds the hand-written kernels from ``csrc/``, holds each one
against its plain PyTorch version, then drives the ported AutoML paths end
to end at full width through the entry points a user calls:

    FeatureBuilder -> transmogrify -> SanityChecker -> OpXGBoostClassifier
    -> OpWorkflow.train() -> score_and_evaluate(AuPR)

    FeatureBuilder -> transmogrify -> SanityChecker
    -> BinaryClassificationModelSelector.with_cross_validation()
    -> OpWorkflow.train() -> score_and_evaluate(AuPR)

Phases (one JSON line each, after a ``device`` line that also derives the
card's aggregate shared-memory rate):
  1. build      nvcc for sm_90a of csrc/seg_hist.cu; the ptxas report, which
                must show no register spills
  2. tree       grow_tree at 50 000 x 64, depth 6, through the kernel, the
                plain version on the card and the plain version on the CPU:
                identical splits; growth through the kernel raises nothing
                under torch.cuda's sync debug mode "error" (a prototype that
                does not catch every synchronising op); a random-forest
                grid (grow_rf_grid, 3 folds x 2 gates x 3 trees, depth 8,
                8-feature subsets) through the kernel and the plain version
                on the card: identical trees
  3. slice      1 000 000 train + 100 000 held-out rows x 500 Real
                features (the recipe of examples/bench_scale.py, seed 11),
                XGBoost defaults with max_depth=6; per-phase walls, rounds,
                ms per round, holdout AuPR, kernel launches, peak memory
  4. selector   the same data through the default binary model selector:
                LR (4 x 2) and random-forest (3 x 2 x 3, 50 trees) grids
                under 3-fold CV, the winner refit; the train's split by
                stage and sweep group, every candidate's CV metric, the
                summary's metrics, holdout AuPR, trees grown and kernel
                launches against the growers' count, peak memory
  5. seg_hist   kernel vs plain at the slice's level shapes (N=1M, d=500,
                B=32, nchan=2, M=1..32, a level with empty slots), the level
                shapes of depths 7 and 10 (M=64, 512), d=497 through
                apply_bins' padded rows, one level of unpadded rows (the
                4-byte row copies) and the forests' level shapes (d=22 in
                32-byte rows, Poisson-count channels, M=1..2048, bitwise
                equal to plain): error, determinism, kernel/plain/
                library/bound ms, the layout's share, the groups and
                reduce passes' device ms and the shared-memory floor
  6. profile    an 8-round fit at the same width under torch.profiler:
                binning and boosting walls, the card's busy time and idle
                share, the boosting's heaviest device ops per round
The phases that run torch.profiler come after the slice, so no profiler
session runs in the process before the slice's walls are taken.
Then the ``kernels`` summary line (``launches``: the slice's and the
selector's), the card's name and power limit, and the result line.  Any
failed check exits non-zero.  Without a CUDA device the script exits with
code 1 and prints no result.

Usage: python3 chip_smoke.py [--rows N] [--holdout N] [--cols D]
                             [--rounds R] [--reps K]
"""
import argparse
import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from transmogrifai_tpu_torch.cuda_build import build
from transmogrifai_tpu_torch.evaluators.evaluators import Evaluators
from transmogrifai_tpu_torch.features.builder import FeatureBuilder
from transmogrifai_tpu_torch.models import gbdt_kernels as gk
from transmogrifai_tpu_torch.models.trees import OpXGBoostClassifier
from transmogrifai_tpu_torch.ops.transmogrify import transmogrify
from transmogrifai_tpu_torch.preparators.sanity_checker import SanityChecker
from transmogrifai_tpu_torch.selector.model_selector import \
    BinaryClassificationModelSelector
from transmogrifai_tpu_torch.types import feature_types as ft
from transmogrifai_tpu_torch.types.columns import ColumnarDataset, FeatureColumn
from transmogrifai_tpu_torch.workflow.workflow import OpWorkflow

#: kernel vs plain tolerance: float32 sums taken in another order
RTOL, ATOL = 1e-5, 1e-4
#: the card the port is built for and its published peaks (NVIDIA's data
#: sheet, SXM part): device memory bytes/s, float32 (non-tensor-core) ops/s
CARD = "NVIDIA H100 80GB HBM3"
PEAK_BYTES_PER_S, PEAK_F32_OPS_PER_S = 3.35e12, 67e12
SEG_HIST_SOURCE = "transmogrifai_tpu_torch/csrc/seg_hist.cu"
SEG_HIST_REPLACES = "transmogrifai_tpu/models/gbdt_kernels.py:638"
FULL_ROUNDS = 200
#: boosting rounds of the profiled fit (one early-stopping chunk)
PROFILE_ROUNDS = 8


def _smi(query: str) -> str:
    """The first card's line of ``nvidia-smi --query-gpu=<query>``."""
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median device milliseconds of ``fn`` over ``reps`` runs, each
    bracketed by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    evs = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        evs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in evs)


def device_ms(fn, reps: int = 5, tries: int = 10) -> dict:
    """Device milliseconds per call of ``fn``, by kernel name, over
    ``reps`` calls under torch.profiler (the card's own time, free of the
    host's launch gaps).  The profiler can drop device events, sometimes
    in several sessions running: a session in which some kernel ran a
    number of times that is not a multiple of ``reps``, or none ran, lost
    some, and is taken again half a second later (a ``profiler_retry``
    line says so), at most ``tries`` times."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(tries):
        if attempt:
            time.sleep(0.5)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages() if e.device_time_total > 0]
        counts = {e.key: e.count for e in evs}
        if evs and all(c % reps == 0 for c in counts.values()):
            return {e.key: e.device_time_total / reps / 1e3 for e in evs}
        emit({"phase": "profiler_retry", "attempt": attempt + 1,
              "reps": reps, "counts": counts})
    raise RuntimeError(f"check failed: the profiler dropped device events "
                       f"in {tries} sessions")


def pass_ms(by_kernel: dict, name: str) -> float:
    """The device ms of the ``seg_hist_<name>`` pass in ``device_ms``'s
    result."""
    ms = [t for k, t in by_kernel.items() if f"seg_hist_{name}" in k]
    check(len(ms) == 1, f"no single seg_hist_{name} pass in {by_kernel}")
    return ms[0]


def make_data(rows: int, cols: int, seed: int = 11):
    """examples/bench_scale.py's ``make_data`` recipe, as numpy arrays."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(rows, cols)).astype(np.float32)
    beta = np.zeros(cols, np.float32)
    informative = rng.choice(cols, max(3, cols // 20), replace=False)
    beta[informative] = rng.normal(size=len(informative)) * 1.5
    z = X @ beta + 0.5 * rng.normal(size=rows).astype(np.float32)
    y = (1 / (1 + np.exp(-z)) > rng.random(rows)).astype(np.float32)
    return X, y


def phase_build() -> None:
    t0 = time.perf_counter()
    _, log = build("seg_hist")
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "Compiling entry" in ln or "spill" in ln]
    spills = [int(x) for ln in ptxas
              for x in re.findall(r"(\d+) bytes spill (?:stores|loads)", ln)]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "source": SEG_HIST_SOURCE, "ptxas": ptxas})
    check(spills, "build: the ptxas report shows no spill counts")
    check(not any(spills), "build: ptxas reports register spills")


def _level_binned(dev, n: int, d: int, B: int, gen):
    """Random bins in the main path's row layout (rows padded as
    ``apply_bins`` pads them)."""
    binned = gk.binned_empty(n, d, dev)
    binned.copy_(torch.randint(0, B, (n, d), dtype=torch.uint8, device=dev,
                               generator=gen))
    return binned


def _apply_bins_497(dev, n: int, B: int, gen):
    """A binned matrix of d=497 columns (not a multiple of 4) made by
    ``apply_bins`` from normal columns, with the normal law's B-quantiles
    as every column's edges."""
    d = 497
    X = torch.randn(n, d, device=dev, generator=gen)
    qs = [statistics.NormalDist().inv_cdf(k / B) for k in range(1, B)]
    binned = gk.apply_bins(X, np.tile(np.asarray(qs, np.float32), (d, 1)))
    del X
    check(binned.stride() == (512, 1), f"apply_bins rows {binned.stride()}")
    return binned


def _compare(args) -> dict:
    """Two launches and the plain version on the same inputs."""
    k1 = gk.seg_level_hists(*args)
    k2 = gk.seg_level_hists(*args)
    plain = gk.seg_level_hists_plain(*args)
    torch.cuda.synchronize()
    diff = (k1 - plain).abs()
    out = {"max_abs_err": float(diff.max()),
           "max_rel_err": float((diff / plain.abs().clamp(min=1.0)).max()),
           "tol_ratio": float((diff / (ATOL + RTOL * plain.abs())).max()),
           "bitwise_equal": bool(torch.equal(k1, plain)),
           "deterministic": bool(torch.equal(k1, k2)),
           "odd_slots_zero": bool((k1[:, 1::2] == 0).all())}
    return out


def _rf_level(dev, n: int, d: int, B: int, gen):
    """A forest level's inputs: bins of a d-column feature subset gathered
    into rows padded to 16 bytes (as the forest grower gathers them), and
    the channels (bw [y=0], bw) of Poisson(1) bag counts."""
    binned = _level_binned(dev, n, d, B, gen)
    bw = torch.poisson(torch.ones(n, device=dev), generator=gen)
    y0 = (torch.rand(n, device=dev, generator=gen) < 0.5).to(torch.float32)
    return binned, torch.stack([bw * y0, bw], 1).contiguous()


def phase_seg_hist(dev, n: int, d: int, reps: int, bw: float, f32: float,
                   smem_bw: float):
    """Kernel vs plain at every level shape of a depth-6 round (M = 1..32),
    an M=32 level whose odd slots are empty, the level shapes of depths 7
    and 10 (M=64, 512), d=497 through apply_bins' padded rows, an M=32
    level of unpadded rows (stride 500: 4-byte row copies), and the
    forests' levels: d = floor(sqrt(500)) = 22 in 32-byte rows, integer
    channels, M = 1, 64, 512, 1024, 2048 (depth 12's last level), where
    the kernel must equal the plain version bitwise.  Rows with
    ``in_mean`` make the ``kernels`` line's means."""
    B, nchan = 32, 2
    gen = torch.Generator(device=dev).manual_seed(0)
    binned = _level_binned(dev, n, d, B, gen)
    ch_main = torch.stack([torch.rand(n, device=dev, generator=gen) * 2 - 1,
                           torch.rand(n, device=dev, generator=gen) * 0.25],
                          dim=1).contiguous()
    d_rf = int(d ** 0.5)
    rf_binned, ch_rf = _rf_level(dev, n, d_rf, B, gen)
    cases = [(M, False, "main") for M in (1, 2, 4, 8, 16, 32)]
    cases += [(32, True, "main"), (64, False, "main"), (512, False, "main"),
              (32, False, "d497"), (32, False, "dense")]
    cases += [(M, False, "rf") for M in (1, 64, 512, 1024, 2048)]
    rows = []
    for M, even, which in cases:
        ch = ch_rf if which == "rf" else ch_main
        if which == "main":
            b = binned
        elif which == "rf":
            b = rf_binned
        elif which == "d497":
            b = _apply_bins_497(dev, n, B, gen)
        else:   # unpadded rows (stride d): the kernel's 4-byte row copies
            b = binned.contiguous()
        dd = b.shape[1]
        cols = torch.arange(dd, device=dev)
        hi = M // 2 if even else M
        slot = torch.randint(0, hi, (n,), dtype=torch.int32, device=dev,
                             generator=gen)
        if even:
            slot = (2 * slot).contiguous()
        args = (b, slot, ch, M, B)
        cmp = _compare(args)
        kernel_ms = time_ms(lambda: gk.seg_level_hists(*args), reps)
        # the layout alone is a few small ops: timed by events, the host's
        # launch gaps between them would count, so take its device time
        layout_ms = sum(device_ms(lambda: gk.seg_layout(slot, M)).values())
        passes = device_ms(lambda: gk.seg_level_hists(*args))
        plain_ms = time_ms(lambda: gk.seg_level_hists_plain(*args), 3, 1)
        flat = ((slot.long()[:, None] * B + b.long()) * dd
                + cols[None, :]).reshape(-1)
        ws = [ch[:, c:c + 1].expand(n, dd).reshape(-1) for c in range(nchan)]
        library_ms = time_ms(lambda: [torch.bincount(flat, weights=w,
                                                     minlength=M * B * dd)
                                      for w in ws], 3, 1)
        del flat, ws
        nbytes = n * dd + n * 4 + n * nchan * 4 + M * nchan * B * dd * 4
        ops = n * dd * nchan
        bound_ms = max(nbytes / bw, ops / f32) * 1e3
        row = {"phase": "seg_hist", "N": n, "d": dd, "B": B, "nchan": nchan,
               "M": M, "empty_slots": even, "path": which,
               "row_stride": b.stride(0),
               "in_mean": which == "main" and not even and M <= 32,
               "max_abs_err": cmp["max_abs_err"],
               "max_rel_err": cmp["max_rel_err"],
               "tol_ratio": cmp["tol_ratio"],
               "bitwise_equal": cmp["bitwise_equal"],
               "deterministic": cmp["deterministic"],
               "empty_slots_zero": cmp["odd_slots_zero"] if even else None,
               "kernel_ms": kernel_ms, "layout_ms": layout_ms,
               "kernel_only_ms": kernel_ms - layout_ms,
               "groups_ms": pass_ms(passes, "groups"),
               "reduce_ms": pass_ms(passes, "reduce"),
               "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": bound_ms,
               "bound_by": "bytes" if nbytes / bw >= ops / f32
               else "operations",
               "smem_floor_ms": 16 * n * dd / smem_bw * 1e3,
               "bytes": nbytes, "kernel_GBps": nbytes / kernel_ms / 1e6}
        emit(row)
        what = f"seg_hist M={M} d={dd}"
        check(row["deterministic"], f"{what}: two launches differ")
        check(row["tol_ratio"] <= 1.0, f"{what}: kernel vs plain error "
              f"{row['max_abs_err']} beyond rtol {RTOL} / atol {ATOL}")
        check(which != "rf" or row["bitwise_equal"],
              f"{what}: integer channels, yet the kernel differs from the "
              f"plain version by {row['max_abs_err']}")
        check(row["empty_slots_zero"] is not False,
              f"{what}: empty slots not 0")
        rows.append(row)
        del b, args
    del binned, ch_main, rf_binned, ch_rf
    return rows


def phase_tree(dev) -> None:
    """One depth-6 tree with the XGBoost defaults, grown through the kernel,
    through the plain version on the card and on the CPU."""
    X, y = make_data(50_000, 64)
    edges = gk.quantile_bins(torch.from_numpy(X), 32)
    p0 = float(y.mean())
    kw = dict(max_depth=6, n_bins=32, lam=1.0, min_child_weight=1.0,
              min_gain_raw=0.8, learning_rate=0.02, default_dir=True)
    trees = {}
    for name, where, fn in [("kernel", dev, gk.seg_level_hists),
                            ("plain_cuda", dev, gk.seg_level_hists_plain),
                            ("plain_cpu", torch.device("cpu"),
                             gk.seg_level_hists_plain)]:
        Xt = torch.from_numpy(X).to(where)
        yt = torch.from_numpy(y).to(where)
        binned = gk.apply_bins(Xt, edges)
        G = (p0 - yt)[:, None].contiguous()
        H = torch.full_like(G, p0 * (1 - p0))
        dd = torch.from_numpy(gk.default_dir_mask(edges)).to(where)
        if name == "kernel":
            # growth must never wait on the host: any synchronising op that
            # torch's sync debug mode detects raises here
            gk.grow_tree(binned, G, H, dd_mask=dd, hist_fn=fn, **kw)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                tree = gk.grow_tree(binned, G, H, dd_mask=dd, hist_fn=fn, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        else:
            tree = gk.grow_tree(binned, G, H, dd_mask=dd, hist_fn=fn, **kw)
        trees[name] = [t.cpu() for t in tree]
    k = trees["kernel"]
    same = {n: bool(torch.equal(k[0], t[0]) and torch.equal(k[1], t[1]))
            for n, t in trees.items() if n != "kernel"}
    leaf_err = {n: float((k[2] - t[2]).abs().max())
                for n, t in trees.items() if n != "kernel"}
    splits = int((k[1] < 32).sum())
    rf = _rf_grid_kernel_vs_plain(dev, X, y, edges)
    emit({"phase": "tree", "rows": 50_000, "cols": 64, "depth": 6,
          "splits": splits, "same_splits": same, "leaf_max_abs_diff": leaf_err,
          "growth_sync_debug_mode": "error", "raised": False, "forest": rf})
    check(splits > 0, "tree: no split grown")
    check(all(same.values()), f"tree: splits differ {same}")
    check(rf["splits"] > 0 and rf["same_trees"],
          f"tree: forests through the kernel and the plain version differ "
          f"{rf}")


def _rf_grid_kernel_vs_plain(dev, X, y, edges) -> dict:
    """A forest grid (3 folds x 2 gates x 3 trees, depth 8, 8-feature
    subsets, Poisson bags) grown on the card through the kernel and
    through the plain version: integer channels, so identical trees."""
    Xt = torch.from_numpy(X).to(dev)
    binned = gk.apply_bins(Xt, edges)
    folds = torch.arange(len(y), device=dev) % 3
    W = torch.stack([(folds != k).to(torch.float32) for k in range(3)])
    kw = dict(seed=5, n_trees=3, pair_fold=[0, 1, 2, 0, 1, 2],
              pair_min_ig=[0.001] * 3 + [0.01] * 3,
              pair_min_inst=[10] * 3 + [100] * 3, pair_depth=[8] * 6,
              msub=8, subsample_rate=1.0, n_bins=32, leaf_levels=(3,))
    yt = torch.from_numpy(y).to(dev)
    got = [gk.grow_rf_grid(binned, yt, W, hist_fn=fn, **kw)
           for fn in (gk.seg_level_hists, gk.seg_level_hists_plain)]
    a, b = got
    return {"pairs": 6, "trees": 3, "depth": 8,
            "splits": int((a.thresh < 32).sum()), "levels": a.levels,
            "same_trees": bool(torch.equal(a.feat, b.feat)
                               and torch.equal(a.thresh, b.thresh)
                               and torch.equal(a.leaf, b.leaf)
                               and torch.equal(a.snaps[3], b.snaps[3]))}


def _dataset(X, y) -> ColumnarDataset:
    cols = {f"f{j}": FeatureColumn.from_values(ft.Real, X[:, j])
            for j in range(X.shape[1])}
    cols["label"] = FeatureColumn.from_values(ft.RealNN, y)
    return ColumnarDataset(cols)


def phase_slice(rows: int, holdout: int, cols: int, rounds: int) -> dict:
    t0 = time.perf_counter()
    X, y = make_data(rows + holdout, cols)
    train, hold = _dataset(X[:rows], y[:rows]), _dataset(X[rows:], y[rows:])
    del X
    data_s = time.perf_counter() - t0

    label = FeatureBuilder.RealNN("label").as_response()
    preds = [FeatureBuilder.Real(f"f{j}").as_predictor() for j in range(cols)]
    checked = label.transform_with(SanityChecker(max_correlation=0.99),
                                   transmogrify(preds))
    depth = 6
    est = OpXGBoostClassifier(max_depth=depth, num_round=rounds)
    pred = label.transform_with(est, checked)
    wf = OpWorkflow().set_result_features(pred).set_input_data(train)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gk.seg_level_hists.launches = 0
    t0 = time.perf_counter()
    model = wf.train()
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    scored, metrics = model.score_and_evaluate(
        Evaluators.BinaryClassification.auPR(), data=hold)
    torch.cuda.synchronize()
    score_s = time.perf_counter() - t0
    launches = gk.seg_level_hists.launches

    proba = scored[pred.name].values.probability
    rounds_grown = est.metadata["rounds_grown"]
    timing = est.metadata["fit_timing"]
    aupr = float(metrics["AuPR"])
    out = {"phase": "slice", "rows": rows, "holdout": holdout, "cols": cols,
           "max_depth": depth, "num_round": rounds,
           "num_round_cut_from": FULL_ROUNDS if rounds < FULL_ROUNDS else None,
           "data_s": data_s, "train_s": train_s, "score_s": score_s,
           "stage_seconds": model.stage_seconds,
           "binning_s": timing["binning_s"],
           "boosting_s": timing["boosting_s"],
           "rounds_grown": rounds_grown, "best_len": est.metadata["best_len"],
           "ms_per_round": timing["boosting_s"] / rounds_grown * 1e3,
           "holdout_aupr": aupr, "seg_hist_launches": launches,
           "expected_launches": depth * rounds_grown,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "dropped_columns": len(checked.origin_stage.metadata["summary"]
                                  ["dropped"])}
    emit(out)
    check(tuple(proba.shape) == (holdout, 2), f"proba shape {proba.shape}")
    check(bool(torch.isfinite(proba).all()), "non-finite probabilities")
    check(launches > 0 and launches == depth * rounds_grown,
          f"seg_hist launches {launches} != {depth} x {rounds_grown}")
    check(0.6 < aupr <= 1.0, f"holdout AuPR {aupr} outside (0.6, 1]")
    return out


def phase_selector(rows: int, holdout: int, cols: int) -> dict:
    """The default binary model selector on the slice's data: 26
    candidates under 3-fold CV, the winner refit on the training split."""
    t0 = time.perf_counter()
    X, y = make_data(rows + holdout, cols)
    train, hold = _dataset(X[:rows], y[:rows]), _dataset(X[rows:], y[rows:])
    del X
    data_s = time.perf_counter() - t0

    label = FeatureBuilder.RealNN("label").as_response()
    preds = [FeatureBuilder.Real(f"f{j}").as_predictor() for j in range(cols)]
    checked = label.transform_with(SanityChecker(max_correlation=0.99),
                                   transmogrify(preds))
    selector = BinaryClassificationModelSelector.with_cross_validation()
    pred = label.transform_with(selector, checked)
    wf = OpWorkflow().set_result_features(pred).set_input_data(train)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gk.seg_level_hists.launches = 0
    t0 = time.perf_counter()
    model = wf.train()
    train_s = time.perf_counter() - t0
    launches = gk.seg_level_hists.launches
    t0 = time.perf_counter()
    scored, metrics = model.score_and_evaluate(
        Evaluators.BinaryClassification.auPR(), data=hold)
    torch.cuda.synchronize()
    score_s = time.perf_counter() - t0

    meta = selector.metadata
    summary = meta["model_selector_summary"]
    results = summary["validationResults"]
    proba = scored[pred.name].values.probability
    aupr = float(metrics["AuPR"])
    out = {"phase": "selector", "rows": rows, "holdout": holdout,
           "cols": cols, "folds": selector.validator.num_folds,
           "data_s": data_s, "train_s": train_s, "score_s": score_s,
           "stage_seconds": model.stage_seconds,
           "sweep_seconds": meta["sweep_seconds"],
           "group_errors": meta["group_errors"],
           "tree_phase_seconds": meta["tree_phase_seconds"],
           "refit_seconds": meta["refit_seconds"],
           "metrics_seconds": meta["metrics_seconds"],
           "winner": summary["bestModelType"],
           "winner_params": summary["bestModelParams"],
           "cv": [{"model": r["modelType"], "params": r["params"],
                   "metric": r["metricValue"], "error": r.get("error")}
                  for r in results],
           "train_metrics": summary["trainEvaluationMetrics"],
           "holdout_metrics": summary["holdoutMetrics"],
           "holdout_aupr": aupr, "rf_trees": meta["rf_trees"],
           "seg_hist_launches": launches,
           "growers_hist_levels": meta["hist_levels"],
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "dropped_columns": len(checked.origin_stage.metadata["summary"]
                                  ["dropped"])}
    emit(out)
    check(tuple(proba.shape) == (holdout, 2), f"proba shape {proba.shape}")
    check(bool(torch.isfinite(proba).all()), "non-finite probabilities")
    check(len(results) == 26, f"{len(results)} validation results, not 26")
    errors = [r["error"] for r in results if r.get("error")]
    check(not errors, f"candidates failed: {errors}")
    # a failed group's members pass as sequential fits: the batched groups
    # must have run and raised nothing
    check(not meta["group_errors"],
          f"grid groups failed: {meta['group_errors']}")
    check({"LogRegGridGroup", "RFGridGroup"} <= set(meta["sweep_seconds"]),
          f"grid groups not run: {sorted(meta['sweep_seconds'])}")
    check(launches > 0 and launches == meta["hist_levels"],
          f"seg_hist launches {launches} != the growers' "
          f"{meta['hist_levels']} histogram levels")
    check(0.6 < aupr <= 1.0, f"holdout AuPR {aupr} outside (0.6, 1]")
    return out


def phase_profile(dev, rows: int, cols: int, rounds: int) -> None:
    """One XGBoost fit of ``rounds`` rounds at the slice's width under
    torch.profiler, on data drawn on the card by the same recipe: for the
    binning and the boosting range of ``fit_raw``, the wall, the card's
    busy time (kernels, copies, memsets) and idle share, and the boosting's
    heaviest device ops per round."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device=dev).manual_seed(11)
    X = torch.randn(rows, cols, generator=gen, device=dev)
    beta = torch.zeros(cols, device=dev)
    informative = torch.randperm(cols, generator=gen, device=dev)[
        :max(3, cols // 20)]
    beta[informative] = 1.5 * torch.randn(len(informative), generator=gen,
                                          device=dev)
    z = X @ beta + 0.5 * torch.randn(rows, generator=gen, device=dev)
    y = (torch.sigmoid(z) > torch.rand(rows, generator=gen, device=dev))
    y = y.to(torch.float32).cpu().numpy()
    est = OpXGBoostClassifier(max_depth=6, num_round=rounds)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        est.fit_raw(X, y, device=dev)
        torch.cuda.synchronize()
    events = prof.events()
    ranges = {e.name: e.time_range for e in events
              if e.name in ("tmog.binning", "tmog.boosting")
              and e.device_type == DeviceType.CPU}
    # the ranges also show on the card's timeline, as annotations
    dev_evs = [e for e in events if e.device_type == DeviceType.CUDA
               and e.name not in ranges]
    out = {"phase": "profile", "rows": rows, "cols": cols, "max_depth": 6,
           "rounds": est.metadata["rounds_grown"]}
    for key, tr in ranges.items():
        inside = [e for e in dev_evs if tr.start <= e.time_range.start
                  and e.time_range.end <= tr.end]
        busy_us = sum(e.time_range.elapsed_us() for e in inside)
        wall_us = tr.elapsed_us()
        part = key.split(".")[1]
        out[part] = {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
                     "device_idle_share": 1 - busy_us / wall_us}
        if part == "boosting":
            by_name = {}
            for e in inside:
                t, c = by_name.get(e.name[:60], (0.0, 0))
                by_name[e.name[:60]] = (t + e.time_range.elapsed_us(), c + 1)
            top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
            n = out["rounds"]
            out[part]["top_device_ops_per_round"] = [
                {"name": k, "ms": t / 1e3 / n, "count": c / n}
                for k, (t, c) in top]
    emit(out)
    check(len(dev_evs) > 0 and set(ranges) == {"tmog.binning",
                                                "tmog.boosting"},
          "profile: no device events or missing fit ranges")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--holdout", type=int, default=100_000)
    ap.add_argument("--cols", type=int, default=500)
    ap.add_argument("--rounds", type=int, default=FULL_ROUNDS)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke needs one",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    if name != CARD:
        raise RuntimeError(f"no published peak rates for {name!r}: the "
                           f"bounds are computed for {CARD}")
    bw, f32 = PEAK_BYTES_PER_S, PEAK_F32_OPS_PER_S
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # aggregate shared-memory rate: SMs x 128 bytes a clock (32 banks of 4
    # bytes) x the SM clock nvidia-smi reports as its maximum
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(_smi("clocks.max.sm").split()[0])
    smem_bw = sms * 128 * mhz * 1e6
    emit({"phase": "device", "name": name, "bytes_per_s": bw,
          "f32_ops_per_s": f32, "smem_bytes_per_s": smem_bw,
          "smem_rate_from": f"{sms} SMs x 128 B/clock x {mhz:g} MHz "
                            f"(nvidia-smi clocks.max.sm)",
          "torch": torch.__version__, "cuda": torch.version.cuda})

    phase_build()
    phase_tree(dev)
    torch.cuda.empty_cache()
    sl = phase_slice(args.rows, args.holdout, args.cols, args.rounds)
    torch.cuda.empty_cache()
    sel = phase_selector(args.rows, args.holdout, args.cols)
    torch.cuda.empty_cache()
    seg = phase_seg_hist(dev, args.rows, args.cols, args.reps, bw, f32,
                         smem_bw)
    torch.cuda.empty_cache()
    phase_profile(dev, args.rows, args.cols, PROFILE_ROUNDS)

    # per-launch means over the six level shapes of a depth-6 round
    levels = [r for r in seg if r["in_mean"]]

    def mean(key):
        return statistics.fmean(r[key] for r in levels)

    emit({"phase": "seg_hist_summary", "over": "M = 1..32, d=500",
          "ms": mean("kernel_ms"), "layout_ms": mean("layout_ms"),
          "kernel_only_ms": mean("kernel_only_ms"),
          "groups_ms": mean("groups_ms"), "reduce_ms": mean("reduce_ms"),
          "bound_ms": mean("bound_ms"),
          "smem_floor_ms": mean("smem_floor_ms"),
          "worst_tol_ratio": max(r["tol_ratio"] for r in seg),
          "worst_ms": max(r["kernel_ms"] for r in levels)})
    emit({"kernels": [{
        "name": "seg_hist", "route": "cuda", "source": SEG_HIST_SOURCE,
        "replaces": SEG_HIST_REPLACES,
        "launches": sl["seg_hist_launches"] + sel["seg_hist_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in seg),
        "ms": mean("kernel_ms"), "plain_ms": mean("plain_ms"),
        "bound_ms": mean("bound_ms"), "bound_by": levels[-1]["bound_by"],
        "library_ms": mean("library_ms")}]})
    print(_smi("name,power.limit"), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
