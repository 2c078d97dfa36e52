"""Warm-program accounting and the AOT program store (counterpart of
``transmogrifai_tpu.utils.compile_cache``).

Two pieces, both host-only:

* **the in-process counters**: every warm-program site (the serving
  executor's shape buckets, the scoring program sets of
  ``serving/aot.py``) records a ``compile`` when it builds a program for a
  key and a ``hit`` when it reuses one, ``aotLoad``/``aotMiss`` for each
  lookup in the store, so a test asserts "N requests, zero compiles after
  warm-up" from the ledger instead of from timing;
* **``AOTStore``**: an on-disk, content-addressed store of serialized
  scoring programs (``torch.export.save`` bytes in the port).  One entry
  is ``<key>.bin`` plus a ``<key>.json`` sidecar holding its sha256, size
  and format version; a write is atomic (tmp + fsync + ``os.replace``),
  and a corrupted, truncated or mismatched entry reads as a miss and is
  deleted, so the write-through replaces it.  Keys are digests of the
  model's parameters, the bucket and the runtime (``serving/aot.py``), so
  several replicas can share one directory (``TMOG_AOT_CACHE_DIR``).

The JAX module's ``enable_persistent_cache`` (XLA's compilation cache
behind ``jax.config``) has no torch counterpart and is not ported: the
port compiles no XLA programs, and what it persists is the exported
program in ``AOTStore``.
"""
from __future__ import annotations

import hashlib
import os
import threading
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["record_compile", "record_hit", "record_aot_load",
           "record_aot_miss", "cache_stats", "reset_cache_stats",
           "AOTStore", "AOT_FORMAT_VERSION", "default_aot_dir"]

_stats_lock = threading.Lock()
_compiles: Dict[str, int] = {}
_hits: Dict[str, int] = {}
_aot_loads: Dict[str, int] = {}
_aot_misses: Dict[str, int] = {}


def record_compile(key: str, n: int = 1) -> None:
    """Count a program build (an export, or a bucket's first run)."""
    with _stats_lock:
        _compiles[key] = _compiles.get(key, 0) + n


def record_hit(key: str, n: int = 1) -> None:
    """Count a warm reuse of the program built for ``key``."""
    with _stats_lock:
        _hits[key] = _hits.get(key, 0) + n


def record_aot_load(key: str, n: int = 1) -> None:
    """Count a program loaded from the AOT store (no export)."""
    with _stats_lock:
        _aot_loads[key] = _aot_loads.get(key, 0) + n


def record_aot_miss(key: str, n: int = 1) -> None:
    """Count a store lookup that found no valid entry (absent, corrupted
    or mismatched) and fell back to an export."""
    with _stats_lock:
        _aot_misses[key] = _aot_misses.get(key, 0) + n


def cache_stats() -> Dict[str, Dict[str, int]]:
    """Snapshot: ``{'compiles': {key: n}, 'hits': ..., 'aotLoads': ...,
    'aotMisses': ..., 'totals': {...}}`` (the JAX package's keys)."""
    with _stats_lock:
        compiles, hits = dict(_compiles), dict(_hits)
        aot_loads, aot_misses = dict(_aot_loads), dict(_aot_misses)
    return {
        "compiles": compiles,
        "hits": hits,
        "aotLoads": aot_loads,
        "aotMisses": aot_misses,
        "totals": {"compiles": sum(compiles.values()),
                   "hits": sum(hits.values()),
                   "aotLoads": sum(aot_loads.values()),
                   "aotMisses": sum(aot_misses.values())},
    }


def reset_cache_stats() -> None:
    with _stats_lock:
        _compiles.clear()
        _hits.clear()
        _aot_loads.clear()
        _aot_misses.clear()


#: bump to invalidate every persisted program (a layout or meaning change)
AOT_FORMAT_VERSION = 1

_DEFAULT_AOT_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), ".torch_cache", "aot")


def default_aot_dir() -> str:
    """The store's root: ``TMOG_AOT_CACHE_DIR``, else
    ``<repo>/.torch_cache/aot``."""
    return os.environ.get("TMOG_AOT_CACHE_DIR", _DEFAULT_AOT_DIR)


class AOTStore:
    """On-disk content-addressed store of serialized scoring programs.

    ``put`` writes ``<key>.bin`` and its ``<key>.json`` sidecar atomically;
    ``get`` validates the sidecar (format version, size, sha256, the
    caller's ``expect`` fields) before trusting a payload and deletes an
    entry that fails.  Concurrent writers of one key race benignly: the
    key is a content digest, so both payloads describe the same program.
    """

    def __init__(self, root: Optional[str] = None):
        self.root = root or default_aot_dir()

    def _paths(self, key: str) -> Tuple[str, str]:
        return (os.path.join(self.root, f"{key}.bin"),
                os.path.join(self.root, f"{key}.json"))

    def put(self, key: str, payload: bytes, meta: Dict[str, Any]) -> None:
        """Persist one program; ``meta`` gains the payload's sha256 and
        size and the format version.  A crashed writer leaves the previous
        complete entry or none."""
        from .jsonio import write_json_atomic

        os.makedirs(self.root, exist_ok=True)
        bin_path, meta_path = self._paths(key)
        tmp = bin_path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, bin_path)
        doc = dict(meta)
        doc["sha256"] = hashlib.sha256(payload).hexdigest()
        doc["bytes"] = len(payload)
        doc["formatVersion"] = AOT_FORMAT_VERSION
        write_json_atomic(meta_path, doc)

    def get(self, key: str, expect: Optional[Dict[str, Any]] = None
            ) -> Optional[Tuple[bytes, Dict[str, Any]]]:
        """``(payload, meta)``, or None on any problem (absent, truncated,
        checksum or field mismatch against ``expect``); an invalid entry
        is deleted."""
        from .jsonio import read_json_tolerant

        bin_path, meta_path = self._paths(key)
        meta = read_json_tolerant(meta_path, default={})
        if not meta:
            return None
        try:
            with open(bin_path, "rb") as f:
                payload = f.read()
        except OSError:
            return None
        ok = (meta.get("formatVersion") == AOT_FORMAT_VERSION
              and meta.get("bytes") == len(payload)
              and meta.get("sha256") == hashlib.sha256(payload).hexdigest())
        if ok and expect:
            ok = all(meta.get(k) == v for k, v in expect.items())
        if not ok:
            self.invalidate(key)
            return None
        return payload, meta

    def contains(self, key: str,
                 expect: Optional[Dict[str, Any]] = None) -> bool:
        """A cheap validity probe of the sidecar (the checksum is checked
        by ``get``)."""
        from .jsonio import read_json_tolerant

        bin_path, meta_path = self._paths(key)
        if not os.path.exists(bin_path):
            return False
        meta = read_json_tolerant(meta_path, default={})
        if not meta or meta.get("formatVersion") != AOT_FORMAT_VERSION:
            return False
        return not (expect and any(meta.get(k) != v
                                   for k, v in expect.items()))

    def invalidate(self, key: str) -> None:
        for p in self._paths(key):
            try:
                os.unlink(p)
            except OSError:
                pass

    def keys(self) -> List[str]:
        try:
            names = os.listdir(self.root)
        except OSError:
            return []
        return sorted(n[:-4] for n in names if n.endswith(".bin"))

    def stats(self) -> Dict[str, Any]:
        """Entries and payload bytes of the store's directory."""
        entries = self.keys()
        payload_bytes = 0
        for k in entries:
            try:
                payload_bytes += os.path.getsize(self._paths(k)[0])
            except OSError:
                pass
        return {"root": self.root, "entries": len(entries),
                "payloadBytes": payload_bytes}
