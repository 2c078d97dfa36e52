"""Learned text embeddings: Word2Vec and LDA (counterpart of
``transmogrifai_tpu.ops.embeddings``).

 * ``OpWord2Vec`` — skip-gram with negative sampling; the model embeds a
   TextList as the mean of its tokens' vectors.
 * ``OpLDA`` — batch variational Bayes over a term-count vector; the
   model emits each document's topic mixture.

Word2Vec draws from numpy's ``default_rng(seed)`` in the JAX package's
order (the pair permutation, the negatives, the step order, then the
initial vectors), builds the same (center, context) pair list with
vectorized numpy, and runs its SGD steps on the stage's device as
gathers and ``index_add_`` scatters, each row's gradient averaged over
its occurrences in the step as the JAX loop does.  LDA's E-step is two
dense products a step with ``torch.special.digamma``, in float32 as the
JAX package computes it.
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import as_device_tensor, resolve_device
from ..stages.base import UnaryEstimator, UnaryModel
from ..types.columns import ColumnarDataset, FeatureColumn
from ..types.feature_types import OPVector
from .vector_metadata import VectorColumnMetadata, VectorMetadata
from .vectorizers import _host_vec_column, _vec_column

__all__ = ["OpWord2Vec", "OpWord2VecModel", "OpLDA", "OpLDAModel",
           "skipgram_pairs"]


# ---------------------------------------------------------------------------
# Word2Vec
# ---------------------------------------------------------------------------

def skipgram_pairs(docs, index: Dict[str, int], window: int) -> np.ndarray:
    """(P, 2) int32 (center, context) ids: for each document, its
    in-vocabulary tokens in order, and for each token every other token
    within ``window`` positions, in position order (the JAX package's
    nested loop order: document, center, context)."""
    ids_of = [[index[t] for t in (toks or ()) if t in index] for toks in docs]
    lens = np.fromiter(map(len, ids_of), dtype=np.int64, count=len(ids_of))
    total = int(lens.sum())
    if total == 0:
        return np.empty((0, 2), np.int32)
    flat = np.fromiter((i for ids in ids_of for i in ids), dtype=np.int32,
                       count=total)
    doc = np.repeat(np.arange(len(ids_of)), lens)
    offsets = np.array([o for o in range(-window, window + 1) if o != 0])
    out = []
    # position blocks bound the (positions, 2 window) candidate table
    step = max(1, (1 << 22) // max(len(offsets), 1))
    for a in range(0, total, step):
        p = np.arange(a, min(a + step, total))
        j = p[:, None] + offsets[None, :]
        ok = (j >= 0) & (j < total)
        jc = np.clip(j, 0, total - 1)
        ok &= doc[jc] == doc[p][:, None]
        rows, cols = np.nonzero(ok)          # row-major: center, then context
        out.append(np.stack([flat[p[rows]], flat[jc[rows, cols]]], axis=1))
    return np.concatenate(out).astype(np.int32)


class OpWord2Vec(UnaryEstimator):
    """TextList -> a document embedding by skip-gram negative sampling
    over the tokens seen at least ``min_count`` times: ``max_iter`` passes
    of minibatch SGD (``batch_size`` pairs a step, ``num_negatives``
    negatives each, learning rate ``step_size``)."""

    def __init__(self, vector_size: int = 100, window_size: int = 5,
                 min_count: int = 5, max_iter: int = 1,
                 step_size: float = 0.025, num_negatives: int = 5,
                 batch_size: int = 1024, seed: int = 42,
                 device: Optional[str] = None, uid: Optional[str] = None):
        super().__init__(operation_name="w2v", output_type=OPVector, uid=uid)
        self.vector_size = vector_size
        self.window_size = window_size
        self.min_count = min_count
        self.max_iter = max_iter
        self.step_size = step_size
        self.num_negatives = num_negatives
        self.batch_size = batch_size
        self.seed = seed
        self.device = device

    def fit_columns(self, data: ColumnarDataset, col: FeatureColumn):
        counts: Counter = Counter()
        for toks in col.values:
            counts.update(toks or ())
        vocab = sorted(str(w) for w, n in counts.items()
                       if n >= self.min_count)
        index = {w: i for i, w in enumerate(vocab)}
        v, d = len(vocab), self.vector_size
        rng = np.random.default_rng(self.seed)
        if v == 0:
            return OpWord2VecModel(vocab=[],
                                   vectors=np.zeros((0, d), np.float32),
                                   device=self.device)
        pairs = skipgram_pairs(col.values, index, self.window_size)
        if len(pairs) == 0:
            return OpWord2VecModel(
                vocab=vocab,
                vectors=rng.normal(0, 0.1, (v, d)).astype(np.float32),
                device=self.device)
        b = min(self.batch_size, len(pairs))
        # the pair list padded to whole batches: every step has b pairs
        n_steps = -(-len(pairs) // b) * self.max_iter
        perm = rng.permutation(len(pairs))
        pad = (-len(pairs)) % b
        pairs = (np.concatenate([pairs[perm], pairs[perm[:pad]]]) if pad
                 else pairs[perm])
        negs = rng.integers(0, v, size=(n_steps, b, self.num_negatives),
                            dtype=np.int32)
        order = np.stack([rng.permutation(len(pairs) // b)
                          for _ in range(self.max_iter)]).reshape(-1)
        w_in = rng.normal(0, 1.0 / d, (v, d)).astype(np.float32)
        dev = resolve_device(self.device)
        vectors = _sgd(torch.from_numpy(w_in).to(dev),
                       torch.from_numpy(pairs).to(dev),
                       torch.from_numpy(negs).to(dev), order, b,
                       self.step_size)
        self.metadata["w2v_steps"] = int(n_steps)
        self.metadata["w2v_pairs"] = int(len(pairs))
        return OpWord2VecModel(vocab=vocab, vectors=vectors,
                               device=self.device)


def _sgd(w_in: torch.Tensor, pairs: torch.Tensor, negs: torch.Tensor,
         order: np.ndarray, b: int, lr: float) -> torch.Tensor:
    """The SGD steps: step i takes batch ``order[i]`` of ``pairs`` and
    negatives ``negs[i]``; both tables update from the step's old values,
    each row's update averaged over its occurrences in the step."""
    v, d = w_in.shape
    dev = w_in.device
    w_in = w_in.clone()
    w_out = torch.zeros_like(w_in)
    k = negs.shape[2]
    label = torch.zeros((b, 1 + k), dtype=torch.float32, device=dev)
    label[:, 0] = 1.0
    ones_b = torch.ones(b, dtype=torch.float32, device=dev)
    ones_o = torch.ones(b * (1 + k), dtype=torch.float32, device=dev)
    # int64 index tables once: a step's batch is then a view
    batches = pairs.long().view(-1, b, 2)
    negs = negs.long()
    for i, bi in enumerate(order.tolist()):
        batch = batches[bi]
        ctr = batch[:, 0]
        out_idx = torch.cat([batch[:, 1:2], negs[i]], dim=1)
        vc = w_in[ctr]                                       # (b, d)
        uo = w_out[out_idx]                                  # (b, 1+k, d)
        g = torch.sigmoid(torch.einsum("bd,bkd->bk", vc, uo)) - label
        grad_vc = torch.einsum("bk,bkd->bd", g, uo)
        grad_uo = (g[:, :, None] * vc[:, None, :]).reshape(-1, d)
        flat_out = out_idx.reshape(-1)
        ctr_cnt = torch.zeros(v, device=dev).index_add_(0, ctr, ones_b)
        out_cnt = torch.zeros(v, device=dev).index_add_(0, flat_out, ones_o)
        w_in.index_add_(0, ctr, -lr * grad_vc / ctr_cnt[ctr][:, None])
        w_out.index_add_(0, flat_out,
                         -lr * grad_uo / out_cnt[flat_out][:, None])
    return w_in


class OpWord2VecModel(UnaryModel):
    def __init__(self, vocab: List[str], vectors, device: Optional[str] = None,
                 uid: Optional[str] = None):
        super().__init__(operation_name="w2v", output_type=OPVector, uid=uid)
        self.vocab = list(vocab)
        self.vectors = as_device_tensor(vectors, torch.float32, device)
        self.device = device

    def transform_columns(self, col: FeatureColumn) -> FeatureColumn:
        f = self.input_features[0]
        index = {w: i for i, w in enumerate(self.vocab)}
        dev = self.vectors.device
        d = self.vectors.shape[1] if self.vectors.numel() else 0
        n = len(col)
        width = max(d, 1)
        meta = [VectorColumnMetadata(f.name, f.ftype.type_name(),
                                     descriptor_value=f"w2v_{j}")
                for j in range(width)]
        vmeta = VectorMetadata("w2v", meta)
        if not d:
            return _host_vec_column(np.zeros((n, width), np.float32), vmeta,
                                    dev)
        ids_of = [[index[t] for t in (toks or ()) if t in index]
                  for toks in col.values]
        lens = np.fromiter(map(len, ids_of), dtype=np.int64, count=n)
        return _vec_column(_token_means(self.vectors, ids_of, lens), vmeta)


def _token_means(vectors: torch.Tensor, ids_of, lens: np.ndarray
                 ) -> torch.Tensor:
    """(n, d) float32 mean of each row's token vectors (0 for a row with
    none), summed in token order as numpy's ``mean(axis=0)`` sums them:
    row slots by length, then token position j adds to the rows longer
    than j, one dense gather each (no atomics: bit-equal run to run)."""
    n = len(lens)
    dev = vectors.device
    order = np.argsort(-lens, kind="stable")
    by_len = lens[order]
    width = int(by_len[0]) if n else 0
    pad = np.zeros((n, width), np.int64)
    rows = np.repeat(np.arange(n), lens)
    starts = np.cumsum(lens) - lens
    pos = np.arange(int(lens.sum())) - np.repeat(starts, lens)
    pad[rows, pos] = np.fromiter((i for row in ids_of for i in row),
                                 dtype=np.int64, count=int(lens.sum()))
    pad = torch.from_numpy(pad[order]).to(dev)
    acc = torch.zeros((n, vectors.shape[1]), dtype=torch.float32,
                      device=dev)
    for j in range(width):
        k = int(np.count_nonzero(by_len > j))      # the rows longer than j
        acc[:k] += vectors[pad[:k, j]]
    cnt = torch.from_numpy(by_len.astype(np.float32)).to(dev)
    acc = torch.where(cnt[:, None] > 0,
                      acc / torch.clamp(cnt, min=1.0)[:, None], 0.0)
    out = torch.empty_like(acc)
    out[torch.from_numpy(order).to(dev)] = acc
    return out


# ---------------------------------------------------------------------------
# LDA
# ---------------------------------------------------------------------------

def _exp_elog(g: torch.Tensor) -> torch.Tensor:
    dg = torch.special.digamma
    return torch.exp(dg(g) - dg(g.sum(1, keepdim=True)))


def _lda_e_step(counts: torch.Tensor, exp_elog_beta: torch.Tensor,
                alpha: float, n_iter: int):
    """The batch variational E-step: ``n_iter`` updates of the document
    topics (two dense products each), then the topic-word statistics.
    ``counts`` (n, v), ``exp_elog_beta`` (k, v) -> (gamma (n, k), sstats
    (k, v))."""
    k = exp_elog_beta.shape[0]
    gamma = 1.0 + counts.sum(1, keepdim=True) / k
    gamma = gamma.expand(-1, k).contiguous()
    for _ in range(n_iter):
        theta = _exp_elog(gamma)
        phinorm = theta @ exp_elog_beta
        gamma = alpha + theta * ((counts / phinorm) @ exp_elog_beta.T)
    theta = _exp_elog(gamma)
    sstats = theta.T @ (counts / (theta @ exp_elog_beta))
    return gamma, sstats * exp_elog_beta


def _counts_tensor(values, dev) -> torch.Tensor:
    X = as_device_tensor(values, torch.float32, dev)
    return torch.clamp(X.to(dev, torch.float32), min=0.0)


class OpLDA(UnaryEstimator):
    """OPVector of term counts -> topic mixture over ``k`` topics: batch
    variational Bayes, ``max_iter`` M-steps of ``e_step_iter`` E-step
    updates each."""

    def __init__(self, k: int = 10, max_iter: int = 20, e_step_iter: int = 10,
                 doc_concentration: Optional[float] = None,
                 topic_concentration: Optional[float] = None,
                 seed: int = 42, device: Optional[str] = None,
                 uid: Optional[str] = None):
        super().__init__(operation_name="lda", output_type=OPVector, uid=uid)
        if k < 2:
            raise ValueError("k must be > 1")
        self.k = k
        self.max_iter = max_iter
        self.e_step_iter = e_step_iter
        self.doc_concentration = doc_concentration
        self.topic_concentration = topic_concentration
        self.seed = seed
        self.device = device

    def fit_columns(self, data: ColumnarDataset, col: FeatureColumn):
        dev = resolve_device(self.device)
        counts = _counts_tensor(col.values, dev)
        v = counts.shape[1]
        alpha = self.doc_concentration or 1.0 / self.k
        eta = self.topic_concentration or 1.0 / self.k
        rng = np.random.default_rng(self.seed)
        lam = torch.from_numpy(rng.gamma(100.0, 1.0 / 100.0, (self.k, v))
                               .astype(np.float32)).to(dev)
        for _ in range(self.max_iter):
            _, sstats = _lda_e_step(counts, _exp_elog(lam), alpha,
                                    self.e_step_iter)
            lam = eta + sstats
        return OpLDAModel(topic_word=lam, doc_concentration=float(alpha),
                          e_step_iter=self.e_step_iter, device=self.device)


class OpLDAModel(UnaryModel):
    def __init__(self, topic_word, doc_concentration: float = 0.1,
                 e_step_iter: int = 10, device: Optional[str] = None,
                 uid: Optional[str] = None):
        super().__init__(operation_name="lda", output_type=OPVector, uid=uid)
        self.topic_word = as_device_tensor(topic_word, torch.float32, device)
        self.doc_concentration = doc_concentration
        self.e_step_iter = e_step_iter
        self.device = device

    def transform_columns(self, col: FeatureColumn) -> FeatureColumn:
        f = self.input_features[0]
        counts = _counts_tensor(col.values, self.topic_word.device)
        gamma, _ = _lda_e_step(counts, _exp_elog(self.topic_word),
                               self.doc_concentration, self.e_step_iter)
        theta = gamma / gamma.sum(1, keepdim=True)
        meta = [VectorColumnMetadata(f.name, f.ftype.type_name(),
                                     descriptor_value=f"topic_{j}")
                for j in range(theta.shape[1])]
        return _vec_column(theta.contiguous(), VectorMetadata("lda", meta))
