"""Successive-halving model selection over the selector's candidate grid
(counterpart of ``transmogrifai_tpu.tuning.halving``).

Every candidate fits cheaply first, on a stratified row subsample with
proportionally fewer boosting rounds; the best ``1/eta`` share moves on
to ``eta`` times the rows, until the survivors fit on the full data.
The full-data final rung decides the winner, so its reported metric is a
full-fidelity one; the early rungs only decide who pays for full fits.

Each rung is one ``validator.validate`` call over the surviving
candidates (one work queue), so a rung has the full sweep's folds,
failure isolation, ``max_wait`` budget and elastic ladders.  A rung's
candidates fit one by one: a grid group computes its whole family, which
would pay for eliminated candidates (the ``regroup`` hook that would
batch a rung's survivors is None on one card).

Deterministic: the schedule is a pure function of (rows, candidates,
eta, min_rows), the nested subsample order is the JAX package's numpy
draws, and promotion breaks ties toward the lower candidate index.  In
the asynchronous sweep a rung's elimination is a device reduction of
which only the survivors' indices are copied
(``selector.async_dispatch``); with a checkpoint or ``TMOG_SYNC_SWEEP=1``
each rung's metrics are copied and ranked on the host.  Under a trace
each rung is a ``sweep.rung[i]`` span over its sweep.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..obs.trace import span

__all__ = ["HalvingConfig", "Rung", "rung_schedule",
           "nested_subsample_order", "halving_validate"]


@dataclass
class HalvingConfig:
    """The successive-halving scheduler's knobs (all deterministic)."""

    #: promotion factor: a rung keeps ceil(k/eta) candidates and the row
    #: budget grows ~eta times
    eta: int = 3
    #: the least rows a rung ranks on
    min_rows: int = 2048
    #: the subsample order's seed
    seed: int = 7
    #: scale iteration params (``round_keys``) with the rung's row
    #: fraction, no lower than ``min_round_frac``
    scale_rounds: bool = True
    min_round_frac: float = 0.1
    round_keys: Tuple[str, ...] = ("max_iter", "num_round")
    #: below this many candidates halving saves nothing: the full sweep
    min_candidates: int = 3

    def to_json(self) -> Dict[str, Any]:
        return {"eta": self.eta, "minRows": self.min_rows,
                "seed": self.seed, "scaleRounds": self.scale_rounds,
                "minRoundFrac": self.min_round_frac,
                "minCandidates": self.min_candidates}


@dataclass
class Rung:
    """One rung of the schedule; the walls and promotions fill in as it
    runs."""

    index: int
    rows: int
    fraction: float          # rows / n_rows
    survivors_in: int
    survivors_out: int
    wall_s: float = 0.0
    candidate_seconds: float = 0.0
    promoted: List[int] = field(default_factory=list)

    def to_json(self) -> Dict[str, Any]:
        return {"rung": self.index, "rows": self.rows,
                "fraction": round(self.fraction, 6),
                "survivorsIn": self.survivors_in,
                "survivorsOut": self.survivors_out,
                "wallSecs": round(self.wall_s, 4),
                "candidateSeconds": round(self.candidate_seconds, 4),
                "promoted": list(self.promoted)}


def rung_schedule(n_rows: int, n_candidates: int,
                  config: Optional[HalvingConfig] = None) -> List[Rung]:
    """The rung ladder for (n_rows, n_candidates): ``s = min(the steps the
    rows allow above min_rows, the steps the candidates need to reach
    ~1)``; rung ``i`` runs ``ceil(n / eta^(s-i))`` rows with ``ceil(k /
    eta^i)`` candidates, the last rung all ``n`` rows.  Empty where no
    reduction rung exists (the caller runs the full sweep)."""
    cfg = config or HalvingConfig()
    n, k, eta = int(n_rows), int(n_candidates), max(int(cfg.eta), 2)
    if k < max(cfg.min_candidates, 2) or n <= 0:
        return []
    s_rows = int(math.floor(math.log(max(n / max(cfg.min_rows, 1), 1.0),
                                     eta)))
    s_cands = int(math.ceil(math.log(k, eta)))
    s = max(0, min(s_rows, s_cands))
    if s == 0:
        return []
    rungs: List[Rung] = []
    alive = k
    for i in range(s + 1):
        rows = n if i == s else int(math.ceil(n / eta ** (s - i)))
        out = 1 if i == s else max(1, int(math.ceil(alive / eta)))
        rungs.append(Rung(index=i, rows=rows, fraction=rows / n,
                          survivors_in=alive, survivors_out=out))
        alive = out
    return rungs


def nested_subsample_order(y: np.ndarray, seed: int,
                           stratify: bool = True) -> np.ndarray:
    """A row permutation whose every prefix is about class-stratified, so
    that rung r+1's rows hold rung r's and each rung sees the label
    ratio.  The JAX package's draws, bit for bit."""
    n = len(y)
    rng = np.random.default_rng(seed)
    if not stratify:
        return rng.permutation(n)
    keys = np.empty(n, dtype=np.float64)
    finite = np.isfinite(y)
    classes = np.unique(y[finite]) if finite.any() else []
    seen = np.zeros(n, dtype=bool)
    for cls in classes:
        idx = np.where(y == cls)[0]
        perm = rng.permutation(idx)
        # a fractional within-class rank: sorting by it interleaves the
        # classes in proportion
        keys[perm] = (np.arange(len(idx)) + rng.random()) / max(len(idx), 1)
        seen[idx] = True
    rest = np.where(~seen)[0]
    if len(rest):
        perm = rng.permutation(rest)
        keys[perm] = (np.arange(len(rest)) + rng.random()) / max(len(rest), 1)
    return np.argsort(keys, kind="stable")


def _scaled_params(params: Dict[str, Any], fraction: float,
                   cfg: HalvingConfig) -> Dict[str, Any]:
    """A rung's fit params: iteration counts shrink with the row fraction
    (floored), so that early rungs are cheap in rows and rounds."""
    if not cfg.scale_rounds or fraction >= 1.0:
        return params
    f = max(fraction, cfg.min_round_frac)
    out = dict(params)
    for key in cfg.round_keys:
        v = out.get(key)
        if isinstance(v, (int, float)) and v > 1:
            out[key] = max(int(math.ceil(v * f)), 2)
    return out


def _host_promote(alive: List[int], scores: Dict[int, float],
                  survivors_out: int, larger_better: bool) -> List[int]:
    sign = -1.0 if larger_better else 1.0
    ranked = sorted(alive, key=lambda i: (sign * scores[i], i))
    return sorted(ranked[:survivors_out])


def halving_validate(
    validator,
    candidates: Sequence[Tuple],
    X: torch.Tensor,
    y: np.ndarray,
    base_weights: np.ndarray,
    eval_fn,
    metric_name: str,
    larger_better: bool = True,
    config: Optional[HalvingConfig] = None,
    stratify: bool = True,
    checkpoint=None,
    regroup=None,
    elastic=None,
) -> Tuple[int, List, Dict[str, Any]]:
    """The candidate sweep under successive halving.

    Returns ``(best_index, results, schedule_json)``: one result per
    candidate (an eliminated one keeps its last subsample metric, with an
    ``error`` note that says so) and the index of the winner.  Where no
    ladder exists, one full ``validator.validate`` sweep (recorded in the
    schedule JSON).  ``checkpoint`` persists the rung state after every
    rung and a unit cursor a rung, so that a killed sweep resumes at its
    rung; ``regroup(alive, fit_params_list)`` may rebuild batched groups
    over a rung's survivors (None: one fit a candidate); ``elastic``
    rides into every rung's sweep."""
    from ..selector.async_dispatch import (device_promote,
                                           device_rung_scores,
                                           sync_sweep_forced)
    from ..selector.validators import ValidationResult, _materialize

    cfg = config or HalvingConfig()
    n, k = len(y), len(candidates)
    schedule = rung_schedule(n, k, cfg)
    sched_json: Dict[str, Any] = {"strategy": "halving",
                                  "config": cfg.to_json(),
                                  "nRows": n, "nCandidates": k}
    if not schedule:
        t0 = time.perf_counter()
        best, results = validator.validate(
            candidates, X, y, base_weights, eval_fn, metric_name,
            larger_better=larger_better, checkpoint=checkpoint,
            elastic=elastic)
        sched_json.update({
            "fallback": "full sweep (schedule admits no reduction rung)",
            "rungs": [], "candidateSeconds":
                round(time.perf_counter() - t0, 4)})
        return best, results, sched_json

    order = nested_subsample_order(y, cfg.seed, stratify=stratify)
    worst = float("-inf") if larger_better else float("inf")
    use_defer = (checkpoint is None
                 and getattr(validator, "supports_defer", False)
                 and not sync_sweep_forced())
    #: each rung's outputs, applied to ``last_result`` in rung order after
    #: the ladder: [alive snapshot, queue, all_vals, errors, results|None]
    deferred_rungs: List[List[Any]] = []
    alive = list(range(k))
    last_result: Dict[int, Any] = {}
    #: candidate -> (rung index, rung rows) at its elimination
    eliminated: Dict[int, Tuple[int, int]] = {}
    total_cand_s = 0.0
    rungs_done: List[Dict[str, Any]] = []
    start_rung = 0
    if checkpoint is not None:
        st = checkpoint.rung_state()
        if st is not None:
            start_rung = int(st.get("nextRung", 0))
            alive = [int(i) for i in st.get("alive", alive)]
            last_result = {int(i): ValidationResult.from_json(r)
                           for i, r in st.get("last", {}).items()}
            eliminated = {int(i): (int(v[0]), int(v[1]))
                          for i, v in st.get("eliminated", {}).items()}
            rungs_done = list(st.get("rungJson", []))

    for rung in schedule[start_rung:]:
        full = rung.rows >= n
        if full:
            Xs, ys, ws = X, y, base_weights
        else:
            idx = np.sort(order[:rung.rows])
            Xs = X.index_select(0, torch.from_numpy(idx).to(X.device))
            ys, ws = y[idx], base_weights[idx]
        fit_params_list = []
        rung_cands = []
        for i in alive:
            name, params, fitter, *_ = candidates[i]
            fit_params = params if full else _scaled_params(
                params, rung.fraction, cfg)
            fit_params_list.append(fit_params)
            rung_cands.append((name, fit_params, fitter))
        if regroup is not None:
            regrouped = regroup(list(alive), fit_params_list)
            if regrouped is not None:
                rung_cands = regrouped
        rung_ckpt = (checkpoint.scoped(f"rung{rung.index}")
                     if checkpoint is not None else None)
        t0 = time.perf_counter()
        with span(f"sweep.rung[{rung.index}]", cat="sweep",
                  rows=rung.rows, candidates=len(rung_cands), full=full,
                  deferred=use_defer):
            if use_defer:
                queue, all_vals, errs = validator.validate(
                    rung_cands, Xs, ys, ws, eval_fn, metric_name,
                    larger_better=larger_better, checkpoint=rung_ckpt,
                    elastic=elastic, defer=True)
            else:
                _, results = validator.validate(
                    rung_cands, Xs, ys, ws, eval_fn, metric_name,
                    larger_better=larger_better, checkpoint=rung_ckpt,
                    elastic=elastic)
        rung.wall_s = time.perf_counter() - t0
        rung.candidate_seconds = rung.wall_s
        total_cand_s += rung.wall_s
        if use_defer:
            entry = [list(alive), queue, all_vals, errs, None]
            deferred_rungs.append(entry)
            if all(e is not None for e in errs):
                # every unit failed: collect raises as a sync rung would
                queue.collect(all_vals, errs, metric_name, larger_better)
            if full:
                rung.promoted = list(alive)
                rungs_done.append(rung.to_json())
                break
            scores = device_rung_scores(all_vals, errs, larger_better)
            pos = device_promote(scores, rung.survivors_out, larger_better)
            promoted = sorted(alive[p] for p in pos)
        else:
            scores = {}
            for i, r in zip(alive, results):
                # results report the candidate's own params; rung scaling
                # is an execution detail
                r.params = candidates[i][1]
                last_result[i] = r
                scores[i] = r.metric_value if r.error is None else worst
            if full:
                rung.promoted = list(alive)
                rungs_done.append(rung.to_json())
                break
            promoted = _host_promote(alive, scores, rung.survivors_out,
                                     larger_better)
        rung.promoted = promoted
        for i in alive:
            if i not in promoted:
                eliminated[i] = (rung.index, rung.rows)
        alive = promoted
        rungs_done.append(rung.to_json())
        if checkpoint is not None:
            checkpoint.save_rung_state({
                "nextRung": rung.index + 1,
                "alive": [int(i) for i in alive],
                "last": {str(i): r.to_json()
                         for i, r in last_result.items()},
                "eliminated": {str(i): [ri, rr]
                               for i, (ri, rr) in eliminated.items()},
                "rungJson": rungs_done})

    if deferred_rungs:
        # one copy of every deferred rung's metrics; the rungs' results
        # then apply in rung order, so that a survivor reports its latest
        # (highest-fidelity) rung, as the host ladder's overwrites do
        combined: List[Any] = []
        for e in deferred_rungs:
            combined.extend(e[2])
        host_all = _materialize(combined, one_copy=True, tag="sweep.final")
        off = 0
        for e in deferred_rungs:
            hv = host_all[off:off + len(e[2])]
            off += len(e[2])
            _, e[4] = e[1].collect(hv, e[3], metric_name, larger_better)
        for snap, _, _, _, results in deferred_rungs:
            for i, r in zip(snap, results):
                r.params = candidates[i][1]
                last_result[i] = r

    for i, (ri, rrows) in eliminated.items():
        r = last_result[i]
        note = (f"halving: eliminated at rung {ri} "
                f"({rrows} of {n} rows); metric is the subsample "
                f"score, not a full-data result")
        if r.error is None or not str(r.error).startswith("halving:"):
            r.error = note if r.error is None else f"{note}; {r.error}"

    # the winner: the best full-rung result (ties: the lowest index)
    final_alive = [i for i in alive if last_result[i].error is None]
    pool = final_alive or alive
    sign = -1.0 if larger_better else 1.0
    best_i = min(pool, key=lambda i: (sign * (
        last_result[i].metric_value
        if last_result[i].error is None else worst), i))

    sched_json.update({
        "rungs": rungs_done,
        "candidateSeconds": round(total_cand_s, 4),
        "survivors": list(alive),
        "bestIndex": best_i,
    })
    return best_i, [last_result[i] for i in range(k)], sched_json
