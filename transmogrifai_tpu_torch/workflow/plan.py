"""Execution planning for the fitted feature DAG — column liveness
(counterpart of ``transmogrifai_tpu.workflow.plan``).

Computed once per (DAG, keep-set) and memoized on the DAG: every column's
last consumer layer is known statically, so each intermediate is dropped
right after that layer instead of accumulating for the whole run, and the
stages the keep-set does not need are skipped.  With ``keep=None`` nothing
is pruned.  The JAX package's intra-layer host thread pool, per-stage
profiling and cost-planner advice are not ported: stages run in stable
layer order on the calling thread.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from ..stages.base import Estimator, PipelineStage
from ..types.columns import ColumnarDataset

__all__ = ["ExecutionPlan", "plan_for"]


def plan_for(dag, keep: Optional[Sequence[str]] = None) -> "ExecutionPlan":
    """The memoized plan for ``dag`` with the given keep-set (cached on the
    DAG object, so scoring and serving share one per model)."""
    cache = dag.__dict__.setdefault("_plan_cache", {})
    key = frozenset(keep) if keep is not None else None
    plan = cache.get(key)
    if plan is None:
        plan = cache[key] = ExecutionPlan(dag, keep=keep)
    return plan


class ExecutionPlan:
    """A per-DAG schedule: the executed layers and the liveness drops."""

    def __init__(self, dag, keep: Optional[Sequence[str]] = None):
        self.dag = dag
        self.keep: Optional[frozenset] = (
            frozenset(keep) if keep is not None else None)
        self.layers: List[List[PipelineStage]] = [
            layer for layer in dag.non_generator_layers() if layer]
        #: the most columns resident at once in the last ``transform``
        self.peak_columns: Optional[int] = None
        self._analyze()

    def _analyze(self) -> None:
        from ..stages.generator import FeatureGeneratorStage

        # raw generator outputs are "produced" at layer -1; columns the
        # plan does not know (a reader's extras) are never dropped
        produced_at: Dict[str, int] = {
            s.get_output().name: -1 for layer in self.dag.layers
            for s in layer if isinstance(s, FeatureGeneratorStage)}
        for li, layer in enumerate(self.layers):
            for s in layer:
                produced_at[s.get_output().name] = li
        self._produced_at = produced_at

        out_stage = {s.get_output().name: s
                     for layer in self.layers for s in layer}
        needed: Set[str] = set()
        if self.keep is None:
            needed = {s.uid for layer in self.layers for s in layer}
        else:
            frontier = [out_stage[n] for n in self.keep if n in out_stage]
            while frontier:
                s = frontier.pop()
                if s.uid in needed:
                    continue
                needed.add(s.uid)
                frontier += [out_stage[f.name] for f in s.input_features
                             if f.name in out_stage]
        self.needed_uids = needed

        last_use: Dict[str, int] = {}
        for li, layer in enumerate(self.layers):
            for s in layer:
                if s.uid in needed:
                    for n in s.input_names:
                        last_use[n] = li
        self.initial_drops, self.drops_after = self._drop_schedule(last_use)

    def _drop_schedule(self, last_use: Dict[str, int]
                       ) -> Tuple[List[str], List[List[str]]]:
        """(drops before layer 0, drops after each layer): a known column
        outside ``keep`` dies after its last executed consumer; one nobody
        consumes dies as soon as it exists."""
        initial: List[str] = []
        after: List[List[str]] = [[] for _ in self.layers]
        if self.keep is None:
            return initial, after
        for name, pl in self._produced_at.items():
            if name in self.keep:
                continue
            die = last_use.get(name, pl)
            (initial if die < 0 else after[die]).append(name)
        initial.sort()
        for names in after:
            names.sort()
        return initial, after

    def required_input_columns(self) -> frozenset:
        """Input-dataset columns the plan reads: the executed stages'
        raw (or plan-unknown) inputs plus the keep-set."""
        req = set(self.keep or ())
        for layer in self.layers:
            for s in layer:
                if s.uid in self.needed_uids:
                    req.update(n for n in s.input_names
                               if self._produced_at.get(n, -1) < 0)
        return frozenset(req)

    def transform(self, data: ColumnarDataset,
                  on_stage: Optional[Callable[[PipelineStage, float], None]]
                  = None) -> ColumnarDataset:
        """Apply the fitted DAG, pruned.  ``on_stage(stage, seconds)`` is
        called after each executed stage (the host's time of its
        ``transform``; the work it queued on the card may still run).
        ``peak_columns`` is left set to the most columns resident at once
        during the run."""
        for layer in self.layers:
            for s in layer:
                if isinstance(s, Estimator):
                    raise RuntimeError(
                        f"unfitted estimator {s.uid} in scoring DAG")
        if self.initial_drops:
            data = data.drop(self.initial_drops)
        peak = len(data.columns)
        for li, layer in enumerate(self.layers):
            for s in layer:
                if s.uid in self.needed_uids:
                    t0 = time.perf_counter()
                    data = s.transform(data)
                    if on_stage is not None:
                        on_stage(s, time.perf_counter() - t0)
            peak = max(peak, len(data.columns))
            if self.drops_after[li]:
                data = data.drop(self.drops_after[li])
        self.peak_columns = peak
        return data
