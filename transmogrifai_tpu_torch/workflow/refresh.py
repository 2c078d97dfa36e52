"""Warm-start refresh: fit a trained workflow further on new data only
(counterpart of ``transmogrifai_tpu.workflow.refresh``).

A chunked train exports each streamed estimator's final state onto its
model (``model.fit_states``, saved with it).  A refresh restores those
states and folds only the new chunks into them, ``merge(restored,
fit_state(new chunks))``, so the refreshed model is, within each stage's
``streaming_fit_tol``, the model a streaming train over old and new rows
would give, at the cost of reading only the new window.  The tail that
cannot stream (a model selector) refits in core on the refresh window.

The geometry guard: a restored downstream state is valid only while its
upstream transforms keep their geometry (the same vocabulary slots, the
same kept indices).  ``RefreshContext`` keeps a structural signature of
every refreshed model; when the new data changes a vocabulary's set or a
keep decision, every downstream restored state is invalidated and those
estimators refit from the refresh window alone, counted and reported.

Checkpoints: a refresh reuses ``StreamingCheckpointManager`` with the
fingerprint extended by the base model's identity (``base_digest``), so a
killed refresh resumes mid-pass, and a refresh checkpoint never resumes
into a plain train.
"""
from __future__ import annotations

import copy
import hashlib
import json
from typing import Any, Dict, List, Optional, Set

from ..stages.base import Estimator, PipelineStage

__all__ = ["RefreshContext", "RefreshReport", "geometry_signature"]


def align_vocab_order(old: PipelineStage, new: PipelineStage) -> None:
    """Keep the slot order across a refresh: where a merged pivot fit
    gives the same category set as the old model in another order
    (near-tied counts trading places is noise, not geometry), the old
    order is kept, so that the downstream states folded a slot at a time
    stay mergeable.  A change of the set (a category entering or leaving
    the top k) is left alone and shows as a geometry change."""
    ov, nv = getattr(old, "vocabs", None), getattr(new, "vocabs", None)
    if ov is None or nv is None or len(ov) != len(nv):
        return
    if getattr(old, "strategies", None) != getattr(new, "strategies", None):
        return
    new.vocabs = [list(o) if set(o) == set(n) else list(n)
                  for o, n in zip(ov, nv)]


def geometry_signature(model: PipelineStage) -> Optional[str]:
    """The structural signature of a fitted model's output columns, as
    the JAX package writes it for the same fitted stage.

    Two models with equal signatures emit columns whose slots mean the
    same, so a downstream state folded under one stays mergeable under
    the other.  None: no declared geometry (taken as stable; fills move
    the numbers, not the slots).
    """
    sig: Dict[str, Any] = {}
    vocabs = getattr(model, "vocabs", None)
    if vocabs is not None:
        sig["vocabs"] = [[str(v) for v in vocab] for vocab in vocabs]
    strategies = getattr(model, "strategies", None)
    if strategies is not None:
        sig["strategies"] = list(strategies)
    keep = getattr(model, "keep_indices", None)
    if keep is not None:
        if hasattr(keep, "tolist"):     # a tensor or an array
            keep = keep.tolist()
        sig["keep_indices"] = [int(i) for i in keep]
    fills = getattr(model, "fills", None)
    if fills is not None:
        sig["n_fills"] = len(fills)
    if not sig:
        return None
    return json.dumps(sig, sort_keys=True)


class RefreshReport:
    """What the refresh did, by estimator uid."""

    def __init__(self):
        self.merged: List[str] = []          # warm-started from state
        self.refit: List[str] = []           # no state: fit from new data
        self.invalidated: List[str] = []     # upstream geometry changed
        self.geometry_changed: List[str] = []

    def to_json(self) -> Dict[str, Any]:
        return {"merged": sorted(self.merged),
                "refit": sorted(self.refit),
                "invalidated": sorted(self.invalidated),
                "geometryChanged": sorted(self.geometry_changed)}


class RefreshContext:
    """The warm-start states of one refresh.

    The streaming driver asks it for each estimator's first state
    (``initial_state``) and reports each finished model back
    (``note_finished``), so that a geometry change reaches the decisions
    downstream: a layer finishes before a later layer's states are made.
    """

    def __init__(self, model, dag):
        from ..utils.profiling import count_refresh

        self._count = count_refresh
        self.states: Dict[str, Any] = dict(getattr(model, "fit_states",
                                                   None) or {})
        self.old_models: Dict[str, PipelineStage] = {
            s.uid: s for s in model.stages}
        self.report = RefreshReport()
        self._changed: Set[str] = set()
        self._ancestors = self._estimator_ancestors(dag)

    @staticmethod
    def _estimator_ancestors(dag) -> Dict[str, Set[str]]:
        """uid -> the uids of its estimator ancestors (through its input
        features' origin stages)."""
        memo: Dict[str, Set[str]] = {}

        def walk(stage) -> Set[str]:
            got = memo.get(stage.uid)
            if got is not None:
                return got
            memo[stage.uid] = set()  # cycle guard (DAGs have none)
            anc: Set[str] = set()
            for f in stage.input_features:
                parent = f.origin_stage
                if parent is None:
                    continue
                if isinstance(parent, Estimator):
                    anc.add(parent.uid)
                anc |= walk(parent)
            memo[stage.uid] = anc
            return anc

        for layer in dag.layers:
            for s in layer:
                walk(s)
        return memo

    def base_digest(self) -> Dict[str, Any]:
        """The checkpoint fingerprint's extension naming the base model
        (its state uids and a digest of its geometry), so that a refresh
        checkpoint resumes only into a refresh of the same model."""
        sigs = {uid: geometry_signature(m) or ""
                for uid, m in sorted(self.old_models.items())}
        digest = hashlib.sha256(
            json.dumps(sigs, sort_keys=True).encode()).hexdigest()[:16]
        return {"refresh": {"stateUids": sorted(self.states),
                            "baseGeometry": digest}}

    # -- driver hooks --------------------------------------------------------

    def initial_state(self, est: Estimator):
        """The restored warm-start state of ``est``, or None where it
        fits afresh (no exported state, an upstream geometry change, or a
        state it can no longer import)."""
        payload = self.states.get(est.uid)
        if payload is None:
            self.report.refit.append(est.uid)
            self._count("refit")
            return None
        if self._ancestors.get(est.uid, set()) & self._changed:
            self.report.invalidated.append(est.uid)
            self._count("invalidated")
            return None
        try:
            # a deep copy before the import: the default hook passes the
            # payload through, update_chunk folds in place, and the
            # codec's tensors move in place, so without the copy a
            # refresh would change the base model's stored states (and
            # a second refresh from the same base would differ)
            state = est.import_fit_state(copy.deepcopy(payload))
        except Exception:
            self.report.invalidated.append(est.uid)
            self._count("invalidated")
            return None
        self.report.merged.append(est.uid)
        self._count("merged")
        return state

    def note_finished(self, est: Estimator, new_model) -> None:
        old = self.old_models.get(est.uid)
        if old is None:
            return
        align_vocab_order(old, new_model)
        if geometry_signature(old) != geometry_signature(new_model):
            self._changed.add(est.uid)
            self.report.geometry_changed.append(est.uid)
            self._count("geometry_changed")
