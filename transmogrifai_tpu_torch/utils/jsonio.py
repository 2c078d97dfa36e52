"""Atomic JSON file IO (counterpart of ``transmogrifai_tpu.utils.jsonio``):
tmp + ``os.replace``, so a killed process never leaves a truncated JSON
artifact behind, only the previous complete one."""
from __future__ import annotations

import json
import os
from typing import Any, Optional

__all__ = ["write_json_atomic", "dumps_canonical"]


def dumps_canonical(obj: Any, indent: Optional[int] = 2,
                    sort_keys: bool = False) -> str:
    """Exactly the text :func:`write_json_atomic` writes for ``obj``."""
    return json.dumps(obj, indent=indent, sort_keys=sort_keys,
                      default=str) + "\n"


def write_json_atomic(path: str, obj: Any, indent: Optional[int] = 2,
                      sort_keys: bool = False) -> None:
    """Serialize ``obj`` to ``path`` through a temp file in the same
    directory and ``os.replace`` (atomic on POSIX)."""
    directory = os.path.dirname(os.path.abspath(path)) or "."
    tmp = os.path.join(directory, os.path.basename(path) + ".tmp")
    with open(tmp, "w") as f:
        f.write(dumps_canonical(obj, indent=indent, sort_keys=sort_keys))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
