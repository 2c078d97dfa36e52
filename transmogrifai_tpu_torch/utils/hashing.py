"""Stable 32-bit MurmurHash3 for feature hashing (counterpart of
``transmogrifai_tpu.utils.hashing``; bit-equal to it).

The reference's ``OPCollectionHashingVectorizer`` hashes tokens with
MurmurHash3 x86_32 of their UTF-8 bytes, seed 42.  Python's builtin
``hash`` is salted per process, so the hash is written out here; results
are cached per token.
"""
from __future__ import annotations

from functools import lru_cache

__all__ = ["murmur3_32", "hash_to_bucket"]

_M1 = 0xCC9E2D51
_M2 = 0x1B873593
_MASK = 0xFFFFFFFF


def _rotl32(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _MASK


@lru_cache(maxsize=1 << 20)
def murmur3_32(key: str, seed: int = 42) -> int:
    """MurmurHash3 x86_32 of ``key``'s UTF-8 bytes, as an unsigned int."""
    data = key.encode("utf-8")
    n = len(data)
    h = seed & _MASK
    nblocks = n // 4
    for i in range(nblocks):
        k = int.from_bytes(data[i * 4:i * 4 + 4], "little")
        k = (k * _M1) & _MASK
        k = _rotl32(k, 15)
        k = (k * _M2) & _MASK
        h ^= k
        h = _rotl32(h, 13)
        h = (h * 5 + 0xE6546B64) & _MASK
    k = 0
    tail = data[nblocks * 4:]
    if len(tail) >= 3:
        k ^= tail[2] << 16
    if len(tail) >= 2:
        k ^= tail[1] << 8
    if len(tail) >= 1:
        k ^= tail[0]
        k = (k * _M1) & _MASK
        k = _rotl32(k, 15)
        k = (k * _M2) & _MASK
        h ^= k
    # finalisation mix
    h ^= n
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _MASK
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _MASK
    h ^= h >> 16
    return h


def hash_to_bucket(key: str, num_buckets: int, seed: int = 42) -> int:
    return murmur3_32(key, seed) % num_buckets
