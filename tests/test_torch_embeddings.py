"""The port's Word2Vec and LDA (``ops/embeddings.py``) against the JAX
package's on the CPU.

Word2Vec: the vectorized (center, context) pair list equals the JAX
loop's exactly, and both packages start from the same numpy draws
(vocabulary, permutation, negatives, step order, initial vectors), so
the trained vectors after several hundred SGD steps agree within 2e-5
absolute (float32 gathers and scatter-adds summed in another order; the
vectors are of order 1e-2) and the document embeddings within the same.
LDA: M-steps of E-step updates in float32 in both packages (the digamma,
exp and product sums differ by ulps).  EM on nearly degenerate topics
amplifies those ulps with every M-step: after 5 M-steps the topic-word
matrix agrees within 1e-4 relative and the topic mixtures within 5e-5
absolute; after the default 20, within 2e-3 and 2e-4 (measured 5.5e-4
and 7.3e-5)."""
import numpy as np
import pytest
import torch

import transmogrifai_tpu_torch as tt
from test_torch_text import JAX, PORT, WORDS, assert_same_column, run_stage
from transmogrifai_tpu.ops import embeddings as jemb
from transmogrifai_tpu_torch.ops import embeddings as temb

W2V_ATOL = 2e-5


@pytest.fixture(autouse=True)
def _cpu():
    tt.set_device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _docs(n, seed, vocab=WORDS):
    rng = np.random.default_rng(seed)
    return [tuple(str(w).lower() for w in rng.choice(
        vocab, int(rng.integers(0, 12)))) for _ in range(n)]


@pytest.mark.parametrize("window", [1, 2, 5])
def test_pair_list_equal(window):
    docs = _docs(300, 1) + [(), ("solo",), ("oov", "words", "only")]
    vocab = sorted({t for d in docs for t in d} - {"oov", "words"})
    index = {w: i for i, w in enumerate(vocab)}
    jstage = jemb.OpWord2Vec(window_size=window)
    expect = jstage._pairs(docs, index)
    got = temb.skipgram_pairs(docs, index, window)
    assert got.dtype == expect.dtype == np.int32
    np.testing.assert_array_equal(got, expect)


def test_pair_list_empty():
    assert temb.skipgram_pairs([(), ("a",)], {"a": 0}, 5).shape == (0, 2)


@pytest.mark.parametrize("kw", [
    dict(vector_size=16, window_size=3, min_count=2, batch_size=64),
    dict(vector_size=8, window_size=2, min_count=1, batch_size=100,
         max_iter=2, num_negatives=3, step_size=0.05),
])
def test_word2vec_vectors_close(kw):
    specs = [("TextList", "toks")]
    fit = [_docs(1500, 2)]
    unseen = [_docs(100, 3) + [("unknownword",), ()]]
    jm, jout = run_stage(JAX, lambda: jemb.OpWord2Vec(**kw), specs, fit,
                         [unseen])
    tm, tout = run_stage(PORT, lambda: temb.OpWord2Vec(**kw), specs, fit,
                         [unseen])
    assert tm.vocab == jm.vocab
    steps = tm.metadata["w2v_steps"]
    assert steps >= 300
    np.testing.assert_allclose(tm.vectors.numpy(), jm.vectors, rtol=0,
                               atol=W2V_ATOL)
    # the vectors moved from their start
    assert float(np.abs(jm.vectors).max()) > 0.1
    for t, j in zip(tout, jout):
        assert_same_column(t, j, atol=W2V_ATOL)


def test_word2vec_degenerate_vocabularies():
    """No token reaches min_count: one zero slot; tokens but no pairs:
    the seeded normal draw, equal in both packages."""
    specs = [("TextList", "toks")]
    for docs, kw in (([("a",), ("b",)], dict(min_count=5)),
                     ([("a",), ("b",), ("a",)], dict(min_count=1,
                                                     vector_size=4))):
        jm, (jo,) = run_stage(JAX, lambda: jemb.OpWord2Vec(**kw), specs,
                              [docs])
        tm, (to,) = run_stage(PORT, lambda: temb.OpWord2Vec(**kw), specs,
                              [docs])
        np.testing.assert_array_equal(tm.vectors.numpy(), jm.vectors)
        assert_same_column(to, jo)


def _counts(n, seed, v=40, k=4):
    """Term counts from k planted topics over v terms."""
    rng = np.random.default_rng(seed)
    topics = rng.dirichlet(np.full(v, 0.2), k)
    mix = rng.dirichlet(np.full(k, 0.3), n)
    lens = rng.integers(5, 60, n)
    return np.stack([rng.multinomial(m, mix[i] @ topics)
                     for i, m in enumerate(lens)]).astype(np.float32)


@pytest.mark.parametrize("kw,topic_rtol,mix_atol", [
    (dict(k=4), 2e-3, 2e-4),
    (dict(k=4, max_iter=5), 1e-4, 5e-5),
    (dict(k=3, max_iter=5, e_step_iter=5, doc_concentration=0.5,
          topic_concentration=0.2), 1e-4, 5e-5)])
def test_lda_close(kw, topic_rtol, mix_atol):
    specs = [("OPVector", "counts")]
    fit = [_counts(500, 4)]
    unseen = [_counts(60, 5)]
    jm, jout = run_stage(JAX, lambda: jemb.OpLDA(**kw), specs, fit,
                         [unseen])
    tm, tout = run_stage(PORT, lambda: temb.OpLDA(**kw), specs, fit,
                         [unseen])
    np.testing.assert_allclose(tm.topic_word.numpy(), jm.topic_word,
                               rtol=topic_rtol)
    for t, j in zip(tout, jout):
        assert_same_column(t, j, atol=mix_atol)
        np.testing.assert_allclose(t.values.sum(1).numpy(), 1.0, rtol=1e-5)


def test_word2vec_transform_equals_numpy_mean():
    """The port's model on the JAX model's vectors embeds each row as the
    JAX package's numpy ``mean(axis=0)`` does, bit for bit: token vectors
    summed in token order (rows of 0 to 11 tokens, unknown tokens and
    empty rows included)."""
    specs = [("TextList", "toks")]
    kw = dict(vector_size=8, min_count=2, batch_size=64)
    jm, _ = run_stage(JAX, lambda: jemb.OpWord2Vec(**kw), specs,
                      [_docs(600, 6)])
    rows = [_docs(300, 7) + [("unknownword",), (), ("the", "the")]]
    _, (jo,) = run_stage(JAX, lambda: jemb.OpWord2VecModel(jm.vocab,
                                                           jm.vectors),
                         specs, rows)
    _, (to,) = run_stage(PORT, lambda: temb.OpWord2VecModel(jm.vocab,
                                                            jm.vectors),
                         specs, rows)
    assert_same_column(to, jo)
