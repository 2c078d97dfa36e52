#!/usr/bin/env python
"""The JAX package's holdout AuROC on chip_smoke.py's events recipe, on
the CPU: chip_smoke.make_clickstream's log (seed 9, --users users) read
by the in-core ConditionalDataReader, chip_smoke.build_events' DAG with
the JAX package's classes (the default binary selector, 3-fold CV),
scored on a fresh log (seed 10, a fifth of the users).  chip_smoke's
EV_AUROC_FLOOR is this AuROC at 5 000 users less 0.02.

Usage: JAX_PLATFORMS=cpu python scripts/events_auroc_floor.py [--users N]
"""
import argparse
import json
import os
import sys
import tempfile
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
# the JAX package's train records stage costs in benchmarks/; not here
os.environ.setdefault("TMOG_COST_HISTORY", "")
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--users", type=int, default=5000)
    args = ap.parse_args()
    import chip_smoke as cs
    from transmogrifai_tpu import FeatureBuilder, OpWorkflow, transmogrify
    from transmogrifai_tpu.aggregators import CutOffTime
    from transmogrifai_tpu.evaluators import Evaluators
    from transmogrifai_tpu.preparators import SanityChecker
    from transmogrifai_tpu.readers import (
        ConditionalDataReader, JSONLinesReader, StreamingAggregateReader,
        StreamingConditionalReader)
    from transmogrifai_tpu.selector import BinaryClassificationModelSelector

    ns = {"FeatureBuilder": FeatureBuilder, "transmogrify": transmogrify,
          "SanityChecker": SanityChecker,
          "BinaryClassificationModelSelector":
              BinaryClassificationModelSelector,
          "CutOffTime": CutOffTime,
          "ConditionalDataReader": ConditionalDataReader,
          "JSONLinesReader": JSONLinesReader,
          "StreamingAggregateReader": StreamingAggregateReader,
          "StreamingConditionalReader": StreamingConditionalReader}
    with tempfile.TemporaryDirectory() as tmp:
        train = os.path.join(tmp, "train.jsonl")
        hold = os.path.join(tmp, "hold.jsonl")
        cs.make_clickstream(train, args.users, seed=cs.EV_SEED)
        cs.make_clickstream(hold, args.users // 5, seed=cs.EV_HOLD_SEED)
        with open(train) as fh:
            records = [json.loads(line) for line in fh]
        pred, _, sel = cs.build_events(ns)
        wf = (OpWorkflow().allow_non_serializable().set_result_features(pred)
              .set_reader(cs.events_reader(records, streamed=False, ns=ns)))
        t0 = time.perf_counter()
        model = wf.train()
        train_s = time.perf_counter() - t0
        hold_ds = cs.events_reader(hold, ns=ns).generate_dataset(
            list(wf.raw_features()))
        _, metrics = model.score_and_evaluate(
            Evaluators.BinaryClassification.auROC(), data=hold_ds)
    summ = sel.metadata["model_selector_summary"]
    print(json.dumps({"users": args.users, "rows": len(model.train_data),
                      "holdout_rows": len(hold_ds),
                      "holdout_auroc": metrics["AuROC"],
                      "winner": summ["bestModelType"],
                      "train_s": train_s}))


if __name__ == "__main__":
    main()
