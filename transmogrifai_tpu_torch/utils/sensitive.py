"""Sensitive-feature metadata records (the port's copy of
``transmogrifai_tpu.utils.sensitive``, same JSON keys).

Reference: ``SensitiveFeatureInformation`` / ``SensitiveNameInformation`` /
``GenderDetectionResults`` (utils/src/main/scala/com/salesforce/op/
SensitiveFeatureInformation.scala:47-161): per raw feature (and optional map
key), a record of detected sensitive content — e.g. human names with
name-probability and per-strategy gender-detection results — plus whether the
framework acted on the detection (dropped/ignored the feature). Stored in
vector metadata and surfaced through ModelInsights.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

__all__ = ["SensitiveFeatureInformation", "SensitiveNameInformation",
           "GenderDetectionResults", "sensitive_map_to_json",
           "sensitive_map_from_json"]


@dataclasses.dataclass
class GenderDetectionResults:
    """One gender-detection strategy's outcome (reference :150-161)."""

    strategy: str
    pct_unidentified: float

    def to_json(self) -> dict:
        return {"strategyString": self.strategy,
                "pctUnidentified": self.pct_unidentified}

    @staticmethod
    def from_json(d: dict) -> "GenderDetectionResults":
        return GenderDetectionResults(d["strategyString"],
                                      float(d["pctUnidentified"]))


@dataclasses.dataclass
class SensitiveFeatureInformation:
    """Base record: which feature (and map key) is sensitive and whether the
    detection changed the pipeline (reference :47-59)."""

    name: str
    key: Optional[str] = None
    action_taken: bool = False

    ENTRY_NAME = "SensitiveFeatureInformation"

    def to_json(self) -> dict:
        return {"DetectedSensitiveFeatureKind": self.ENTRY_NAME,
                "FeatureName": self.name, "MapKey": self.key,
                "ActionTaken": self.action_taken}

    @staticmethod
    def from_json(d: dict) -> "SensitiveFeatureInformation":
        kind = d.get("DetectedSensitiveFeatureKind",
                     SensitiveFeatureInformation.ENTRY_NAME)
        if kind == SensitiveNameInformation.ENTRY_NAME:
            return SensitiveNameInformation(
                name=d["FeatureName"], key=d.get("MapKey"),
                action_taken=bool(d.get("ActionTaken", False)),
                prob_name=float(d.get("ProbName", 0.0)),
                gender_detect_strats=[
                    GenderDetectionResults.from_json(g)
                    for g in d.get("GenderDetectStrats", [])],
                prob_male=float(d.get("ProbMale", 0.0)),
                prob_female=float(d.get("ProbFemale", 0.0)),
                prob_other=float(d.get("ProbOther", 0.0)))
        return SensitiveFeatureInformation(
            name=d["FeatureName"], key=d.get("MapKey"),
            action_taken=bool(d.get("ActionTaken", False)))


@dataclasses.dataclass
class SensitiveNameInformation(SensitiveFeatureInformation):
    """Human-name detection record (reference :114-148)."""

    prob_name: float = 0.0
    gender_detect_strats: List[GenderDetectionResults] = \
        dataclasses.field(default_factory=list)
    prob_male: float = 0.0
    prob_female: float = 0.0
    prob_other: float = 0.0

    ENTRY_NAME = "SensitiveNameInformation"

    def to_json(self) -> dict:
        d = super().to_json()
        d.update({"ProbName": self.prob_name,
                  "GenderDetectStrats": [g.to_json()
                                         for g in self.gender_detect_strats],
                  "ProbMale": self.prob_male, "ProbFemale": self.prob_female,
                  "ProbOther": self.prob_other})
        return d


def sensitive_map_to_json(
        m: Dict[str, List[SensitiveFeatureInformation]]) -> dict:
    """Map of feature name -> records, as one JSON-able dict (reference
    ``SensitiveFeatureInformation.toMetadata`` :67-77)."""
    return {k: [s.to_json() for s in v] for k, v in m.items()}


def sensitive_map_from_json(
        d: dict) -> Dict[str, List[SensitiveFeatureInformation]]:
    return {k: [SensitiveFeatureInformation.from_json(s) for s in v]
            for k, v in d.items()}
