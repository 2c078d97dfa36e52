"""Data splitters (counterpart of ``transmogrifai_tpu.selector.splitters``):
the random holdout split, the binary class rebalancer and the multiclass
label cutter.

All are numpy-seeded exactly as in the JAX package, so the holdout mask
and the training weights are bit-identical.  The balancer expresses its
up-sampling, the cutter its dropped labels, as sample weights over the
one resident matrix.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

__all__ = ["SplitterSummary", "DataSplitter", "DataBalancer", "DataCutter"]


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


class DataCutter(DataSplitter):
    """Multiclass label cutting: of the training split's labels, the
    ``max_label_categories`` most frequent (ranked by numpy's argsort of
    the counts, as in the JAX package) whose share reaches
    ``min_label_fraction`` are kept; rows of any other label weigh 0.  The
    summary lists the kept and dropped labels."""

    def __init__(self, max_label_categories: int = 100,
                 min_label_fraction: float = 0.0,
                 reserve_test_fraction: float = 0.1, seed: int = 42):
        super().__init__(reserve_test_fraction, seed)
        self.max_label_categories = max_label_categories
        self.min_label_fraction = min_label_fraction
        self.labels_kept: Optional[np.ndarray] = None

    def train_weights(self, y: np.ndarray,
                      train_mask: np.ndarray) -> np.ndarray:
        w = train_mask.astype(np.float32).copy()
        yt = y[train_mask.astype(bool)]
        labels, counts = np.unique(yt, return_counts=True)
        frac = counts / max(len(yt), 1)
        keep = [labels[i] for i in np.argsort(-counts)
                [:self.max_label_categories]
                if frac[i] >= self.min_label_fraction]
        self.labels_kept = np.asarray(sorted(keep))
        dropped = [float(v) for v in labels if v not in set(keep)]
        w[~np.isin(y, self.labels_kept)] = 0.0
        self.summary = SplitterSummary("DataCutter", {
            "labelsKept": [float(v) for v in self.labels_kept],
            "labelsDropped": dropped,
            "minLabelFraction": self.min_label_fraction,
        })
        return w
