"""The port's mergeable sketches (``utils/sketches.py``) and the
``TextStats`` monoid against the JAX package's, on the same numpy-seeded
chunks: every state, merge and ``to_state``/``from_state`` round trip
bit-equal (the same float64 arithmetic in the same order), and the
streamed moments within 1e-12 relative of numpy's one-shot float64
statistics (another summation order)."""
import numpy as np
import pytest

from transmogrifai_tpu.ops.vectorizers import TextStats as JTextStats
from transmogrifai_tpu.utils import sketches as js
from transmogrifai_tpu_torch.ops.vectorizers import TextStats
from transmogrifai_tpu_torch.utils import sketches as ts


def _chunks(seed, n=1000, d=None, sizes=(7, 61, 1, 300)):
    rng = np.random.default_rng(seed)
    x = rng.normal(3.0, 2.0, (n,) if d is None else (n, d))
    out, a = [], 0
    while a < n:
        b = min(a + sizes[len(out) % len(sizes)], n)
        out.append(x[a:b])
        a = b
    return x, out


def _same_state(a, b):
    """Two ``to_state`` dicts bit-equal (nested, arrays included)."""
    assert type(a) is type(b) or (isinstance(a, (float, int))
                                  and isinstance(b, (float, int)))
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _same_state(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            _same_state(u, v)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b or (a != a and b != b)


@pytest.mark.parametrize("d", [None, 5])
def test_welford_updates_and_merges_equal(d):
    x, chunks = _chunks(1, d=d)
    pt, jx = ts.WelfordMoments(), js.WelfordMoments()
    for c in chunks:
        pt.update(c)
        jx.update(c)
    _same_state(pt.to_state(), jx.to_state())
    # merge of two halves, each streamed
    half = len(chunks) // 2
    pa, pb, ja, jb = (ts.WelfordMoments(), ts.WelfordMoments(),
                      js.WelfordMoments(), js.WelfordMoments())
    for c in chunks[:half]:
        pa.update(c)
        ja.update(c)
    for c in chunks[half:]:
        pb.update(c)
        jb.update(c)
    _same_state(pa.merge(pb).to_state(), ja.merge(jb).to_state())
    np.testing.assert_allclose(pt.mean, x.mean(axis=0), rtol=1e-12)
    np.testing.assert_allclose(pt.variance(), x.var(axis=0, ddof=1),
                               rtol=1e-12)
    back = ts.WelfordMoments.from_state(pt.to_state())
    _same_state(back.to_state(), pt.to_state())
    # an empty chunk and an empty merge change nothing
    before = pt.to_state()
    pt.update(np.zeros((0,) if d is None else (0, d)))
    pt.merge(ts.WelfordMoments())
    _same_state(pt.to_state(), before)


def test_pearson_sketch_equal():
    x, chunks = _chunks(2, d=4)
    rng = np.random.default_rng(3)
    y = (x[:, 0] + rng.normal(size=len(x)) > 3).astype(np.float32)
    pt, jx = ts.PearsonSketch(), js.PearsonSketch()
    a = 0
    parts = []
    for c in chunks:
        yc = y[a:a + len(c)]
        a += len(c)
        pt.update(c.astype(np.float32), yc)
        jx.update(c.astype(np.float32), yc)
        parts.append((c.astype(np.float32), yc))
    _same_state(pt.to_state(), jx.to_state())
    np.testing.assert_array_equal(pt.correlation(), jx.correlation())
    want = [np.corrcoef(x[:, j].astype(np.float32), y)[0, 1]
            for j in range(4)]
    np.testing.assert_allclose(pt.correlation(), want, rtol=1e-6)
    # merge of per-part sketches
    pm, jm = ts.PearsonSketch(), js.PearsonSketch()
    for X, yc in parts:
        pm.merge(ts.PearsonSketch().update(X, yc))
        jm.merge(js.PearsonSketch().update(X, yc))
    _same_state(pm.to_state(), jm.to_state())
    _same_state(ts.PearsonSketch.from_state(pm.to_state()).to_state(),
                pm.to_state())


@pytest.mark.parametrize("capacity", [None, 5])
def test_topk_sketch_equal(capacity):
    rng = np.random.default_rng(4)
    vals = rng.choice([f"v{i}" for i in range(12)], 900,
                      p=np.r_[[0.2, 0.2], np.full(10, 0.06)])
    pt, jx = ts.TopKSketch(capacity), js.TopKSketch(capacity)
    for a in range(0, len(vals), 61):
        pt.add_chunk(vals[a:a + 61])
        jx.add_chunk(vals[a:a + 61])
    _same_state(pt.to_state(), jx.to_state())
    assert pt.top_k(20, 10) == jx.top_k(20, 10)
    if capacity is None:
        from collections import Counter
        assert pt.top_k(20) == [v for v, _ in
                                Counter(vals.tolist()).most_common(20)]
    pa, ja = ts.TopKSketch(capacity), js.TopKSketch(capacity)
    for a in range(0, len(vals), 300):
        pa.merge(ts.TopKSketch(capacity).add_chunk(vals[a:a + 300]))
        ja.merge(js.TopKSketch(capacity).add_chunk(vals[a:a + 300]))
    _same_state(pa.to_state(), ja.to_state())
    _same_state(ts.TopKSketch.from_state(pa.to_state()).to_state(),
                pa.to_state())


def test_text_stats_merge_equal():
    rng = np.random.default_rng(5)
    vals = [None if rng.random() < 0.1 else f"t{rng.integers(0, 30)}"
            for _ in range(500)]
    for max_card in (100, 12):
        pt, jx = TextStats(max_card), JTextStats(max_card)
        for a in range(0, len(vals), 61):
            pc, jc = TextStats(max_card), JTextStats(max_card)
            for v in vals[a:a + 61]:
                pc.update(v)
                jc.update(v)
            pt, jx = pt.merge(pc), jx.merge(jc)
        assert (pt.n, pt.n_null, pt.saturated) == (jx.n, jx.n_null,
                                                   jx.saturated)
        assert list(pt.value_counts.items()) == list(
            jx.value_counts.items())
