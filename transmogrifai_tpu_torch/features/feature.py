"""Lazy feature DAG nodes (counterpart of ``transmogrifai_tpu.features.feature``).

A ``Feature`` records which stage produces it and from which parent
features; no data is attached.  The workflow reconstructs the stage DAG
from result features by walking parents.
"""
from __future__ import annotations

from typing import (TYPE_CHECKING, Callable, Dict, List, Optional, Sequence,
                    Set, Type)

from ..types.feature_types import FeatureType
from ..utils.uid import uid_for

if TYPE_CHECKING:  # pragma: no cover
    from ..stages.base import PipelineStage

__all__ = ["Feature", "FeatureCycleError"]


class FeatureCycleError(Exception):
    """Raised when the feature graph contains a cycle."""


class Feature:
    """A typed node in the feature DAG."""

    def __init__(self, name: str, ftype: Type[FeatureType],
                 is_response: bool = False,
                 origin_stage: Optional["PipelineStage"] = None,
                 parents: Sequence["Feature"] = (),
                 uid: Optional[str] = None):
        self.name = name
        self.ftype = ftype
        self.is_response = bool(is_response)
        self.origin_stage = origin_stage
        self.parents: List[Feature] = list(parents)
        self.uid = uid or uid_for("Feature")

    @property
    def is_raw(self) -> bool:
        from ..stages.generator import FeatureGeneratorStage

        return self.origin_stage is None or isinstance(
            self.origin_stage, FeatureGeneratorStage)

    def traverse(self, visit: Callable[["Feature"], None]) -> None:
        """DFS over ancestors with cycle detection."""
        on_path: Set[int] = set()
        seen: Set[int] = set()

        def rec(f: "Feature"):
            if id(f) in on_path:
                raise FeatureCycleError(
                    f"cycle detected in feature graph at {f.name!r}")
            if id(f) in seen:
                return
            on_path.add(id(f))
            visit(f)
            for p in f.parents:
                rec(p)
            on_path.discard(id(f))
            seen.add(id(f))

        rec(self)

    def raw_features(self) -> List["Feature"]:
        """All raw ancestor features, deduplicated by uid in stable order."""
        out: List[Feature] = []
        seen: Set[str] = set()

        def visit(f: Feature):
            if f.is_raw and f.uid not in seen:
                seen.add(f.uid)
                out.append(f)

        self.traverse(visit)
        return out

    def copy_with_new_stages(self, stage_map: Dict[str, "PipelineStage"]
                             ) -> "Feature":
        """Rebuild this feature's ancestry replacing stages by uid (fitted
        models substitute for their estimators)."""
        cache: Dict[str, Feature] = {}

        def rec(f: Feature) -> Feature:
            if f.uid in cache:
                return cache[f.uid]
            parents = [rec(p) for p in f.parents]
            stage = (stage_map.get(f.origin_stage.uid, f.origin_stage)
                     if f.origin_stage else None)
            nf = Feature(f.name, f.ftype, f.is_response, stage, parents,
                         uid=f.uid)
            cache[f.uid] = nf
            return nf

        return rec(self)

    def transform_with(self, stage: "PipelineStage",
                       *others: "Feature") -> "Feature":
        stage.set_input(self, *others)
        return stage.get_output()

    def __repr__(self):
        return (f"Feature(name={self.name!r}, type={self.ftype.type_name()}, "
                f"response={self.is_response}, uid={self.uid!r})")
