"""Stage/feature UID generation.

Reference: utils/src/main/scala/com/salesforce/op/UID.scala — UIDs of the form
``ClassName_000000000001`` from a process-wide counter.
"""
from __future__ import annotations

import itertools
import threading

_counter = itertools.count(1)
_lock = threading.Lock()


def uid_for(cls_or_name) -> str:
    name = cls_or_name if isinstance(cls_or_name, str) else cls_or_name.__name__
    with _lock:
        n = next(_counter)
    return f"{name}_{n:012x}"

