"""Text-processing stages (counterpart of ``transmogrifai_tpu.ops.text``).

 * ``TextTokenizer`` — Text -> TextList of lower-cased word tokens
 * ``OpNGram``, ``OpStopWordsRemover`` — TextList -> TextList
 * ``OpCountVectorizer`` / ``OpCountVectorizerModel`` — bag-of-words
   counts over a vocabulary learned by document frequency
 * ``OpHashingTF`` — murmur3-hashed term frequencies
 * ``OpStringIndexer`` / ``OpStringIndexerNoFilter`` /
   ``OpStringIndexerModel`` and ``OpIndexToString`` — text <-> a
   frequency-ranked index
 * ``TextLenTransformer`` — total character length

Tokens, vocabularies and indices are host string work with the JAX
package's rules (the same regex, the same ``Counter`` orders).  The count
and hashed blocks are built as one host array (token ids scattered with
``np.add.at``: small integers, exact in float32, so each block equals a
per-token ``+= 1`` loop's) and reach the stage's device in one copy.
"""
from __future__ import annotations

import itertools
import re
from collections import Counter
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np

from ..stages.base import (SequenceEstimator, SequenceModel, UnaryEstimator,
                           UnaryModel, UnaryTransformer)
from ..types.columns import ColumnarDataset, FeatureColumn
from ..types.feature_types import OPNumeric, OPVector, RealNN, Text, TextList
from ..utils.hashing import murmur3_32
from .vector_metadata import VectorColumnMetadata, VectorMetadata
from .vectorizers import _host_vec_column

__all__ = [
    "TextTokenizer", "OpNGram", "OpStopWordsRemover", "OpCountVectorizer",
    "OpCountVectorizerModel", "OpHashingTF", "OpStringIndexer",
    "OpStringIndexerNoFilter", "OpStringIndexerModel", "OpIndexToString",
    "TextLenTransformer", "ENGLISH_STOP_WORDS",
]

_TOKEN_RE = re.compile(r"[\w']+", re.UNICODE)

ENGLISH_STOP_WORDS = frozenset(
    """a an and are as at be but by for if in into is it no not of on or such
    that the their then there these they this to was will with""".split())


def _object_column(ftype, values: Iterable, n: int) -> FeatureColumn:
    out = np.empty(n, dtype=object)
    for i, v in enumerate(values):
        out[i] = v
    return FeatureColumn(ftype, out)


def _count_block(docs, column_of: Callable[[str], Optional[int]], n: int,
                 width: int, binary: bool) -> np.ndarray:
    """(n, width) float32 term counts: each token of row i adds one at
    ``column_of(token)`` (skipped when None); 1 at most under ``binary``.
    ``column_of`` runs once a distinct token."""
    lens = np.fromiter((len(t) if t else 0 for t in docs), dtype=np.int64,
                       count=n)
    flat = list(itertools.chain.from_iterable(t for t in docs if t))
    col_of = {t: column_of(t) for t in dict.fromkeys(flat)}
    col_of = {t: -1 if j is None else j for t, j in col_of.items()}
    cols = np.fromiter(map(col_of.__getitem__, flat), dtype=np.int64,
                       count=len(flat))
    keep = cols >= 0
    rows = np.repeat(np.arange(n), lens)[keep]
    cols = cols[keep]
    block = np.zeros((n, width), np.float32)
    if binary:
        block[rows, cols] = 1.0
    else:
        np.add.at(block, (rows, cols), np.float32(1.0))
    return block


class TextTokenizer(UnaryTransformer):
    """Text -> TextList of word tokens (lower-cased unless told not to),
    at least ``min_token_length`` characters long."""

    input_types = (Text,)

    def __init__(self, to_lowercase: bool = True, min_token_length: int = 1,
                 uid: Optional[str] = None):
        super().__init__(operation_name="textTokenizer",
                         output_type=TextList, uid=uid)
        self.to_lowercase = to_lowercase
        self.min_token_length = min_token_length

    def tokenize(self, v: Optional[str]) -> List[str]:
        if v is None:
            return []
        s = v.lower() if self.to_lowercase else v
        toks = _TOKEN_RE.findall(s)
        if self.min_token_length <= 1:      # every match has a character
            return toks
        return [t for t in toks if len(t) >= self.min_token_length]

    def transform_columns(self, col: FeatureColumn) -> FeatureColumn:
        memo: Dict[str, tuple] = {}

        def tokens(v):
            if v is None:
                return ()
            t = memo.get(v)
            if t is None:
                t = memo[v] = tuple(self.tokenize(v))
            return t

        return _object_column(TextList, map(tokens, col.values), len(col))


class OpNGram(UnaryTransformer):
    """TextList -> TextList of the space-joined n-grams."""

    input_types = (TextList,)

    def __init__(self, n: int = 2, uid: Optional[str] = None):
        super().__init__(operation_name="ngram", output_type=TextList, uid=uid)
        if n < 1:
            raise ValueError("n must be >= 1")
        self.n = n

    def transform_columns(self, col: FeatureColumn) -> FeatureColumn:
        k = self.n

        def grams(toks):
            toks = list(toks or ())
            return tuple(" ".join(toks[j:j + k])
                         for j in range(len(toks) - k + 1))

        return _object_column(TextList, map(grams, col.values), len(col))


class OpStopWordsRemover(UnaryTransformer):
    """Drop stop words (English by default) from a TextList."""

    input_types = (TextList,)

    def __init__(self, stop_words: Optional[Sequence[str]] = None,
                 case_sensitive: bool = False, uid: Optional[str] = None):
        super().__init__(operation_name="stopWordsRemover",
                         output_type=TextList, uid=uid)
        self.stop_words = list(stop_words if stop_words is not None
                               else ENGLISH_STOP_WORDS)
        self.case_sensitive = case_sensitive

    def transform_columns(self, col: FeatureColumn) -> FeatureColumn:
        cs = self.case_sensitive
        stops = (set(self.stop_words) if cs
                 else {w.lower() for w in self.stop_words})

        def kept(toks):
            return tuple(t for t in (toks or ())
                         if (t if cs else t.lower()) not in stops)

        return _object_column(TextList, map(kept, col.values), len(col))


class OpCountVectorizer(SequenceEstimator):
    """TextList(s) -> term counts over a vocabulary of the ``vocab_size``
    terms with the highest document frequency (at least ``min_df``),
    sorted."""

    input_types = (TextList,)

    def __init__(self, vocab_size: int = 512, min_df: int = 1,
                 binary: bool = False, device: Optional[str] = None,
                 uid: Optional[str] = None):
        super().__init__(operation_name="countVec", output_type=OPVector,
                         uid=uid)
        self.vocab_size = vocab_size
        self.min_df = min_df
        self.binary = binary
        self.device = device

    def fit_columns(self, data: ColumnarDataset, *cols: FeatureColumn):
        df_counts: Counter = Counter()
        for c in cols:
            for toks in c.values:
                df_counts.update(set(toks or ()))
        vocab = [w for w, n in df_counts.most_common()
                 if n >= self.min_df][: self.vocab_size]
        return OpCountVectorizerModel(vocab=sorted(vocab), binary=self.binary,
                                      device=self.device)


class OpCountVectorizerModel(SequenceModel):
    input_types = (TextList,)

    def __init__(self, vocab: List[str], binary: bool = False,
                 device: Optional[str] = None, uid: Optional[str] = None):
        super().__init__(operation_name="countVec", output_type=OPVector,
                         uid=uid)
        self.vocab = list(vocab)
        self.binary = binary
        self.device = device

    def transform_columns(self, *cols: FeatureColumn) -> FeatureColumn:
        index = {w: i for i, w in enumerate(self.vocab)}
        n, v = len(cols[0]), len(self.vocab)
        parts, meta = [], []
        for f, c in zip(self.input_features, cols):
            parts.append(_count_block(c.values, index.get, n, v, self.binary))
            meta.extend(VectorColumnMetadata(f.name, f.ftype.type_name(),
                                             indicator_value=w)
                        for w in self.vocab)
        return _host_vec_column(np.concatenate(parts, axis=1),
                                VectorMetadata("count_vec", meta),
                                self.device)


class OpHashingTF(UnaryTransformer):
    """TextList -> term frequencies in ``num_features`` murmur3 buckets
    (seed ``seed``)."""

    input_types = (TextList,)

    def __init__(self, num_features: int = 512, binary: bool = False,
                 seed: int = 42, device: Optional[str] = None,
                 uid: Optional[str] = None):
        super().__init__(operation_name="hashingTF", output_type=OPVector,
                         uid=uid)
        self.num_features = num_features
        self.binary = binary
        self.seed = seed
        self.device = device

    def transform_columns(self, col: FeatureColumn) -> FeatureColumn:
        f = self.input_features[0]
        nf, seed = self.num_features, self.seed
        block = _count_block(col.values, lambda t: murmur3_32(t, seed) % nf,
                             len(col), nf, self.binary)
        meta = [VectorColumnMetadata(f.name, f.ftype.type_name(),
                                     descriptor_value=f"hash_{b}")
                for b in range(nf)]
        return _host_vec_column(block, VectorMetadata("hash_tf", meta),
                                self.device)


class OpStringIndexer(UnaryEstimator):
    """Text -> its rank by frequency (ties in first-seen order).  An unseen
    value raises (``"error"``), takes the index after the last (``"keep"``)
    or takes it and is masked missing (``"skip"``: a columnar dataset drops
    no rows mid-DAG)."""

    input_types = (Text,)

    def __init__(self, handle_invalid: str = "error",
                 uid: Optional[str] = None):
        super().__init__(operation_name="stringIndexer", output_type=RealNN,
                         uid=uid)
        if handle_invalid not in ("error", "keep", "skip"):
            raise ValueError(handle_invalid)
        self.handle_invalid = handle_invalid

    def fit_columns(self, data: ColumnarDataset, col: FeatureColumn):
        counts = Counter(v for v in col.values if v is not None)
        return OpStringIndexerModel(
            labels=[w for w, _ in counts.most_common()],
            handle_invalid=self.handle_invalid)


class OpStringIndexerNoFilter(OpStringIndexer):
    """``OpStringIndexer`` with unseen values kept in an extra index."""

    def __init__(self, uid: Optional[str] = None):
        super().__init__(handle_invalid="keep", uid=uid)


class OpStringIndexerModel(UnaryModel):
    input_types = (Text,)

    def __init__(self, labels: List[str], handle_invalid: str = "error",
                 uid: Optional[str] = None):
        super().__init__(operation_name="stringIndexer", output_type=RealNN,
                         uid=uid)
        self.labels = list(labels)
        self.handle_invalid = handle_invalid
        self.metadata["labels"] = list(labels)

    def transform_columns(self, col: FeatureColumn) -> FeatureColumn:
        index = {w: float(i) for i, w in enumerate(self.labels)}
        unseen = float(len(self.labels))
        out = np.zeros(len(col), np.float64)
        mask = np.ones(len(col), bool)
        for i, v in enumerate(col.values):
            j = index.get(v)
            if j is None:
                if self.handle_invalid == "error" and v is not None:
                    raise ValueError(f"unseen label {v!r}")
                if self.handle_invalid == "skip":
                    mask[i] = False
                out[i] = unseen
            else:
                out[i] = j
        return FeatureColumn(RealNN, out, mask)


class OpIndexToString(UnaryTransformer):
    """Index -> its label; an index outside the labels (or missing) gives
    ``unseen_name``."""

    input_types = (OPNumeric,)

    def __init__(self, labels: Sequence[str],
                 unseen_name: str = "UnseenLabel",
                 uid: Optional[str] = None):
        super().__init__(operation_name="indexToString", output_type=Text,
                         uid=uid)
        self.labels = list(labels)
        self.unseen_name = unseen_name

    def transform_columns(self, col: FeatureColumn) -> FeatureColumn:
        def label(v):
            j = int(v) if np.isfinite(v) else -1
            return (self.labels[j] if 0 <= j < len(self.labels)
                    else self.unseen_name)

        return _object_column(Text, map(label, np.asarray(col.values)),
                              len(col))


class TextLenTransformer(UnaryTransformer):
    """Text or TextList -> total character length (0 when missing)."""

    def __init__(self, uid: Optional[str] = None):
        super().__init__(operation_name="textLen", output_type=RealNN, uid=uid)

    def transform_columns(self, col: FeatureColumn) -> FeatureColumn:
        out = np.zeros(len(col), np.float64)
        for i, v in enumerate(col.values):
            if v is None:
                continue
            if isinstance(v, (tuple, list, frozenset, set)):
                out[i] = float(sum(len(t) for t in v))
            else:
                out[i] = float(len(v))
        return FeatureColumn(RealNN, out, np.ones(len(out), bool))
