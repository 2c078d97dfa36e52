"""Stable 32-bit MurmurHash3 for feature hashing (counterpart of
``transmogrifai_tpu.utils.hashing``; bit-equal to it).

The reference's ``OPCollectionHashingVectorizer`` hashes tokens with
MurmurHash3 x86_32 of their UTF-8 bytes, seed 42.  Python's builtin
``hash`` is salted per process, so the hash is written out here; results
are cached per token.  ``murmur3_32_many`` hashes a batch of keys at once
with numpy uint32 arithmetic, bit-equal to ``murmur3_32``.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Sequence

import numpy as np

__all__ = ["murmur3_32", "murmur3_32_many", "hash_to_bucket"]

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


def _rotl_u32(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def murmur3_32_many(keys: Sequence[str], seed: int = 42) -> np.ndarray:
    """``murmur3_32`` of every key, as a uint32 array: the keys' UTF-8
    bytes padded into one (n, 4w) byte matrix, mixed a 4-byte block column
    at a time, each key's blocks past its own length left out."""
    data = [k.encode("utf-8") for k in keys]
    n = len(data)
    lens = np.fromiter(map(len, data), np.int64, n)
    width = max(4, -(-int(lens.max(initial=0)) // 4) * 4)
    buf = np.zeros((n, width), np.uint8)
    rows = np.repeat(np.arange(n), lens)
    cols = np.arange(int(lens.sum())) - np.repeat(np.cumsum(lens) - lens,
                                                  lens)
    buf[rows, cols] = np.frombuffer(b"".join(data), np.uint8)
    words = buf.view("<u4").astype(np.uint32)
    m1, m2 = np.uint32(_M1), np.uint32(_M2)
    h = np.full(n, seed & _MASK, np.uint32)
    nblocks = lens // 4
    for j in range(width // 4):
        k = _rotl_u32(words[:, j] * m1, 15) * m2
        mixed = _rotl_u32(h ^ k, 13) * np.uint32(5) + np.uint32(0xE6546B64)
        h = np.where(nblocks > j, mixed, h)
    tail = lens % 4
    at = np.minimum(nblocks * 4, width - 1)[:, None] + np.arange(3)
    tb = np.take_along_axis(buf, np.minimum(at, width - 1),
                            axis=1).astype(np.uint32)
    k = np.where(tail >= 3, tb[:, 2] << np.uint32(16), np.uint32(0))
    k ^= np.where(tail >= 2, tb[:, 1] << np.uint32(8), np.uint32(0))
    k ^= np.where(tail >= 1, tb[:, 0], np.uint32(0))
    k = _rotl_u32(k * m1, 15) * m2
    h = np.where(tail >= 1, h ^ k, h)
    h ^= lens.astype(np.uint32)
    h ^= h >> np.uint32(16)
    h *= np.uint32(0x85EBCA6B)
    h ^= h >> np.uint32(13)
    h *= np.uint32(0xC2B2AE35)
    h ^= h >> np.uint32(16)
    return h
