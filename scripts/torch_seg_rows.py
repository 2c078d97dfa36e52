"""The ``seg_hist`` kernel's rows a warp adds into one float32 partial
(``gbdt_kernels.SEG_ROWS_PER_WARP``) and warps a block (``SEG_WARPS``)
against its precision and its time, on the card.

A level whose rows mostly fall in one bin (a sparse matrix's zero bin)
adds up to that many rows of a channel into one float32 sum, and a
channel of nearly one value (a boosted fit's hessians p (1 - p) early on)
rounds the same way at every add, so each partial drifts and the drifts
add up.  For each (rows, warps) setting this prints, as JSON lines:

* ``precision``: the kernel against the plain version on 1 000 000 rows x
  2000 columns at 5% density (``chip_smoke.make_sparse_data``'s recipe,
  binned by the nonzero-aware sketch) with round one's boosted channels
  (gradients p - y and hessians p (1 - p) of one margin) and round two's
  (margins of 64 values), at M = 1 and 2: the largest error over the
  tolerance ATOL + RTOL x the histogram of |channels| (``chip_smoke``'s);
* ``time``: the kernel's device ms (CUDA events, median of ``--reps``) at
  the smoke's level shapes: 1M x 500 at M = 1 and 32 (2 channels), 1M x
  2000 at M = 1, 32 and 512 (2 channels), 1M x 500 at M = 32 (11
  channels).

    python scripts/torch_seg_rows.py [--reps 20] [--rows 1024 512 256]
                                     [--warps 2 3]
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from transmogrifai_tpu_torch.models import gbdt_kernels as gk  # noqa: E402


def _sparse_level(dev):
    """The wide sparse matrix's binned rows and two boosted levels'
    channels (gradients p - y, hessians p (1 - p)): round one's, from the
    one starting margin (the label's log-odds, as float32), and round
    two's, from margins of 64 leaf values around it."""
    X, y, _ = chip_smoke.make_sparse_data(1_000_000, 2000, 0.05, 17)
    Xt = torch.from_numpy(X).to(dev)
    del X
    binned = gk.apply_bins(Xt, gk.quantile_bins_sparse_aware(Xt, 32))
    del Xt
    rng = np.random.default_rng(3)
    base = np.float32(np.log(y.mean() / (1 - y.mean())))
    chans = {}
    for name, F in (("round1", np.full(len(y), base, np.float32)),
                    ("round2", (base + rng.normal(size=64) * 0.02)[
                        rng.integers(0, 64, size=len(y))])):
        p = torch.sigmoid(torch.from_numpy(F.astype(np.float32)))
        yt = torch.from_numpy(y)
        chans[name] = torch.stack(
            [p - yt, torch.clamp(p * (1 - p), min=1e-6)], 1).contiguous(
            ).to(dev)
    return binned, chans


def _dense_level(dev, d: int, C: int):
    rng = np.random.default_rng(d + C)
    n = 1_000_000
    binned = gk.binned_empty(n, d, dev)
    binned.copy_(torch.from_numpy(rng.integers(0, 32, size=(n, d)).astype(
        np.uint8)))
    ch = torch.from_numpy(rng.uniform(-1, 1, size=(n, C)).astype(
        np.float32)).to(dev)
    return binned, ch


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rows", type=int, nargs="+",
                    default=[1024, 512, 256])
    ap.add_argument("--warps", type=int, nargs="+", default=[2])
    args = ap.parse_args()
    dev = torch.device("cuda")
    print(chip_smoke._smi("name,power.limit"), flush=True)
    sparse, chans = _sparse_level(dev)
    sch = chans["round2"]
    n = sparse.shape[0]
    gen = torch.Generator(device=dev).manual_seed(1)
    slots = {M: torch.randint(0, M, (n,), dtype=torch.int32, device=dev,
                              generator=gen) for M in (1, 2, 32, 512)}
    plain = {(r, M): (gk.seg_level_hists_plain(sparse, slots[M], ch, M, 32),
                      gk.seg_level_hists_plain(sparse, slots[M], ch.abs(),
                                               M, 32))
             for r, ch in chans.items() for M in (1, 2)}
    shapes = [("dense_d500_C2", 500, 2, (1, 32)),
              ("sparse_d2000_C2", 2000, 2, (1, 32, 512)),
              ("dense_d500_C11", 500, 11, (32,))]
    levels = {name: (sparse, sch) if name.startswith("sparse")
              else _dense_level(dev, d, C) for name, d, C, _ in shapes}
    for rows, warps in [(r, w) for w in args.warps for r in args.rows]:
        gk.SEG_ROWS_PER_WARP, gk.SEG_WARPS = rows, warps
        ratio = {}
        for (r, M), (p, mag) in plain.items():
            k = gk.seg_level_hists(sparse, slots[M], chans[r], M, 32)
            ratio[f"{r}_M{M}"] = float(
                ((k - p).abs() / (chip_smoke.ATOL + chip_smoke.RTOL * mag))
                .max())
        print(json.dumps({"rows_per_warp": rows, "warps": warps,
                          "precision": ratio}), flush=True)
        ms = {}
        for name, _d, _C, Ms in shapes:
            b, ch = levels[name]
            for M in Ms:
                ms[f"{name}_M{M}"] = chip_smoke.time_ms(
                    lambda: gk.seg_level_hists(b, slots[M], ch, M, 32),
                    args.reps)
        print(json.dumps({"rows_per_warp": rows, "warps": warps,
                          "time_ms": ms}), flush=True)


if __name__ == "__main__":
    main()
