"""The port's murmur3 hashing against the JAX package's: bit-equal
unsigned 32-bit values (UTF-8 bytes, seed 42 and others) over a corpus
with tails of 0-3 bytes, non-ASCII and empty strings, and a hypothesis
sweep of arbitrary text."""
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from transmogrifai_tpu.utils import hashing as jh
from transmogrifai_tpu_torch.utils import hashing as th

CORPUS = ["", "a", "ab", "abc", "abcd", "abcde", "abcdef", "abcdefg",
          "passenger", "von", "name42", "4999", "O'Brien", "délta",
          "Ünïcödé", "日本語", "naïve café", "emoji 🚀", "\x00", "a\x00b",
          " " * 7, "x" * 1001]


@pytest.mark.parametrize("seed", [42, 0, 7, 2 ** 32 - 1])
def test_corpus_bit_equal(seed):
    for s in CORPUS:
        got = th.murmur3_32(s, seed)
        assert got == jh.murmur3_32(s, seed), s
        assert 0 <= got < 2 ** 32


def test_known_values():
    # MurmurHash3 x86_32 of "" with seed 0 is 0; "hello" with seed 0 is
    # 0x248bfa47 (the algorithm's published test vectors)
    assert th.murmur3_32("", 0) == 0
    assert th.murmur3_32("hello", 0) == 0x248BFA47


@settings(max_examples=300, deadline=None)
@given(st.text(max_size=40), st.integers(min_value=1, max_value=4096))
def test_sweep_bit_equal(s, buckets):
    assert th.murmur3_32(s) == jh.murmur3_32(s)
    assert th.hash_to_bucket(s, buckets) == jh.hash_to_bucket(s, buckets)
