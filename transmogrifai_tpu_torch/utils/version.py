"""Build/version stamping for model artifacts (counterpart of
``transmogrifai_tpu.utils.version``): the ``versionInfo`` record of a
saved model.  The JAX package reads the fields it knows and ignores
``torch_version``; ``jax_version`` is always None here."""
from __future__ import annotations

import dataclasses
import functools
import os
import platform
import subprocess
from typing import Optional

import torch

__all__ = ["VersionInfo", "version_info", "VERSION"]

VERSION = "0.1.0"


@dataclasses.dataclass(frozen=True)
class VersionInfo:
    version: str
    python_version: str
    jax_version: Optional[str] = None
    torch_version: Optional[str] = None
    git_branch: Optional[str] = None
    git_commit: Optional[str] = None

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def _git(*args: str) -> Optional[str]:
    """``git <args>`` in a development checkout of this package, else
    None (an installed copy inside another repo must not stamp that
    repo's commit)."""
    pkg_dir = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    try:
        top = subprocess.run(["git", "rev-parse", "--show-toplevel"],
                             capture_output=True, text=True, timeout=5,
                             cwd=pkg_dir)
        root = top.stdout.strip()
        if (top.returncode != 0 or not root or not os.path.isdir(
                os.path.join(root, "transmogrifai_tpu_torch"))):
            return None
        out = subprocess.run(["git", *args], capture_output=True, text=True,
                             timeout=5, cwd=pkg_dir)
        return (out.stdout.strip() or None) if out.returncode == 0 else None
    except (OSError, subprocess.TimeoutExpired):
        return None


@functools.lru_cache(maxsize=1)
def version_info() -> VersionInfo:
    return VersionInfo(
        version=VERSION, python_version=platform.python_version(),
        torch_version=torch.__version__,
        git_branch=_git("rev-parse", "--abbrev-ref", "HEAD"),
        git_commit=_git("rev-parse", "--short", "HEAD"))
