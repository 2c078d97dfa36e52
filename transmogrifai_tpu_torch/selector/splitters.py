"""Data splitters (counterpart of ``transmogrifai_tpu.selector.splitters``):
the random holdout split and the binary class rebalancer.

Both are numpy-seeded exactly as in the JAX package, so the holdout mask
and the training weights are bit-identical.  The balancer expresses its
up-sampling as sample weights over the one resident matrix.  Not ported
yet (ROADMAP Queue A): ``DataCutter`` (multiclass).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

__all__ = ["SplitterSummary", "DataSplitter", "DataBalancer"]


@dataclasses.dataclass
class SplitterSummary:
    splitter: str
    details: Dict

    def to_json(self):
        return {"splitter": self.splitter, **self.details}


class DataSplitter:
    """Random train/holdout split: a row is held out when its uniform draw
    falls below ``reserve_test_fraction``."""

    def __init__(self, reserve_test_fraction: float = 0.1, seed: int = 42):
        self.reserve_test_fraction = reserve_test_fraction
        self.seed = seed
        self.summary: Optional[SplitterSummary] = None

    def split_indices(self, n: int, y: Optional[np.ndarray] = None
                      ) -> Tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng(self.seed)
        holdout = rng.random(n) < self.reserve_test_fraction
        self.summary = SplitterSummary("DataSplitter", {
            "reserveTestFraction": self.reserve_test_fraction,
            "trainCount": int((~holdout).sum()),
            "testCount": int(holdout.sum()),
        })
        return np.where(~holdout)[0], np.where(holdout)[0]

    def train_weights(self, y: np.ndarray,
                      train_mask: np.ndarray) -> np.ndarray:
        return train_mask.astype(np.float32)


class DataBalancer(DataSplitter):
    """Binary rebalance toward ``sample_fraction`` positives: when the
    minority class's share is below it, the minority rows are up-weighted
    so that their weighted share reaches it; a balanced set is left as is."""

    def __init__(self, sample_fraction: float = 0.1,
                 max_training_sample: int = 1_000_000,
                 reserve_test_fraction: float = 0.1, seed: int = 42):
        super().__init__(reserve_test_fraction, seed)
        self.sample_fraction = sample_fraction
        self.max_training_sample = max_training_sample

    def train_weights(self, y: np.ndarray,
                      train_mask: np.ndarray) -> np.ndarray:
        w = train_mask.astype(np.float32).copy()
        yt = y[train_mask.astype(bool)]
        n = len(yt)
        pos = float((yt == 1).sum())
        neg = float(n - pos)
        if n == 0 or pos == 0 or neg == 0:
            return w
        frac = pos / n
        target = self.sample_fraction
        details = {"positiveCount": pos, "negativeCount": neg,
                   "desiredFraction": target, "originalFraction": frac}
        minority_is_pos = pos <= neg
        minority_frac = frac if minority_is_pos else 1.0 - frac
        if minority_frac < target:
            mcount, ocount = (pos, neg) if minority_is_pos else (neg, pos)
            scale = target * ocount / ((1.0 - target) * mcount)
            cls = 1 if minority_is_pos else 0
            w[(y == cls) & train_mask.astype(bool)] *= scale
            details["upSamplingFraction"] = scale
        else:
            details["alreadyBalanced"] = True
        self.summary = SplitterSummary("DataBalancer", details)
        return w
