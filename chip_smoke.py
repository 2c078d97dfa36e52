#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``transmogrifai_tpu_torch``) on one
NVIDIA GPU: builds the hand-written kernels from ``csrc/``, holds each one
against its plain PyTorch version, then drives the boosted-tree AutoML
slice end to end at full width through the entry points a user calls:

    FeatureBuilder -> transmogrify -> SanityChecker -> OpXGBoostClassifier
    -> OpWorkflow.train() -> score_and_evaluate(AuPR)

Phases (one JSON line each):
  1. build      nvcc for sm_90a of csrc/seg_hist.cu
  2. seg_hist   kernel vs plain at the slice's level shapes (N=1M, d=500,
                B=32, nchan=2, M=1..32, and a level with empty slots):
                error, determinism, kernel/plain/library/bound ms
  3. tree       grow_tree at 50 000 x 64, depth 6, through the kernel, the
                plain version on the card and the plain version on the CPU:
                identical splits; growth through the kernel raises nothing
                under torch.cuda's sync debug mode "error" (a prototype that
                does not catch every synchronising op)
  4. slice      1 000 000 train + 100 000 held-out rows x 500 Real
                features (the recipe of examples/bench_scale.py, seed 11),
                XGBoost defaults with max_depth=6; per-phase walls, rounds,
                ms per round, holdout AuPR, kernel launches, peak memory
  5. profile    an 8-round fit at the same width under torch.profiler:
                binning and boosting walls, the card's busy time and idle
                share, the boosting's heaviest device ops per round
Then the ``kernels`` summary line, the card's name and power limit, and
the result line.  Any failed check exits non-zero.  Without a CUDA device
the script exits with code 1 and prints no result.

Usage: python3 chip_smoke.py [--rows N] [--holdout N] [--cols D]
                             [--rounds R] [--reps K]
"""
import argparse
import json
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
             if "registers" in ln or "Compiling entry" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "source": SEG_HIST_SOURCE, "ptxas": ptxas})


def phase_seg_hist(dev, n: int, d: int, reps: int, bw: float, f32: float):
    """Kernel vs plain at every level shape of a depth-6 round (M = 1..32)
    plus an M=32 level whose odd slots are empty."""
    B, nchan = 32, 2
    gen = torch.Generator(device=dev).manual_seed(0)
    binned = torch.randint(0, B, (n, d), dtype=torch.uint8, device=dev,
                           generator=gen)
    ch = torch.stack([torch.rand(n, device=dev, generator=gen) * 2 - 1,
                      torch.rand(n, device=dev, generator=gen) * 0.25],
                     dim=1).contiguous()
    cols = torch.arange(d, device=dev)
    rows = []
    for M, even in [(1, False), (2, False), (4, False), (8, False),
                    (16, False), (32, False), (32, True)]:
        hi = M // 2 if even else M
        slot = torch.randint(0, hi, (n,), dtype=torch.int32, device=dev,
                             generator=gen)
        if even:
            slot = (2 * slot).contiguous()
        args = (binned, slot, ch, M, B)
        k1 = gk.seg_level_hists(*args)
        k2 = gk.seg_level_hists(*args)
        plain = gk.seg_level_hists_plain(*args)
        torch.cuda.synchronize()
        diff = (k1 - plain).abs()
        max_abs = float(diff.max())
        max_rel = float((diff / plain.abs().clamp(min=1.0)).max())
        tol_ratio = float((diff / (ATOL + RTOL * plain.abs())).max())
        deterministic = bool(torch.equal(k1, k2))
        empty_zero = bool((k1[:, 1::2] == 0).all()) if even else None
        del k1, k2, plain, diff
        kernel_ms = time_ms(lambda: gk.seg_level_hists(*args), reps)
        plain_ms = time_ms(lambda: gk.seg_level_hists_plain(*args), 3, 1)
        flat = ((slot.long()[:, None] * B + binned.long()) * d
                + cols[None, :]).reshape(-1)
        ws = [ch[:, c:c + 1].expand(n, d).reshape(-1) for c in range(nchan)]
        library_ms = time_ms(lambda: [torch.bincount(flat, weights=w,
                                                     minlength=M * B * d)
                                      for w in ws], 3, 1)
        del flat, ws
        nbytes = n * d + n * 4 + n * nchan * 4 + M * nchan * B * d * 4
        ops = n * d * nchan
        bound_ms = max(nbytes / bw, ops / f32) * 1e3
        row = {"phase": "seg_hist", "N": n, "d": d, "B": B, "nchan": nchan,
               "M": M, "empty_slots": even, "max_abs_err": max_abs,
               "max_rel_err": max_rel,
               "tol_ratio": tol_ratio, "deterministic": deterministic,
               "empty_slots_zero": empty_zero, "kernel_ms": kernel_ms,
               "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": bound_ms,
               "bound_by": "bytes" if nbytes / bw >= ops / f32
               else "operations",
               "bytes": nbytes, "kernel_GBps": nbytes / kernel_ms / 1e6}
        emit(row)
        check(deterministic, f"seg_hist M={M}: two launches differ")
        check(tol_ratio <= 1.0, f"seg_hist M={M}: kernel vs plain error "
              f"{max_abs} beyond rtol {RTOL} / atol {ATOL}")
        check(empty_zero is not False, f"seg_hist M={M}: empty slots not 0")
        rows.append(row)
    del binned, ch
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
    emit({"phase": "tree", "rows": 50_000, "cols": 64, "depth": 6,
          "splits": splits, "same_splits": same, "leaf_max_abs_diff": leaf_err,
          "growth_sync_debug_mode": "error", "raised": False})
    check(splits > 0, "tree: no split grown")
    check(all(same.values()), f"tree: splits differ {same}")


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
    emit({"phase": "device", "name": name, "bytes_per_s": bw,
          "f32_ops_per_s": f32,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    phase_build()
    seg = phase_seg_hist(dev, args.rows, args.cols, args.reps, bw, f32)
    torch.cuda.empty_cache()
    phase_tree(dev)
    torch.cuda.empty_cache()
    sl = phase_slice(args.rows, args.holdout, args.cols, args.rounds)
    torch.cuda.empty_cache()
    phase_profile(dev, args.rows, args.cols, PROFILE_ROUNDS)

    # per-launch means over the six level shapes of a depth-6 round
    levels = [r for r in seg if not r["empty_slots"]]

    def mean(key):
        return statistics.fmean(r[key] for r in levels)

    emit({"kernels": [{
        "name": "seg_hist", "route": "cuda", "source": SEG_HIST_SOURCE,
        "replaces": SEG_HIST_REPLACES, "launches": sl["seg_hist_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in seg),
        "ms": mean("kernel_ms"), "plain_ms": mean("plain_ms"),
        "bound_ms": mean("bound_ms"), "bound_by": levels[-1]["bound_by"],
        "library_ms": mean("library_ms")}]})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
