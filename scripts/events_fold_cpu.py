#!/usr/bin/env python
"""Host seconds of the port's event fold on the CPU: chip_smoke's events
log (``make_clickstream``, --users users, seed 9) read by
``StreamingConditionalReader`` over JSON lines: the key scan, the fold
and finalize of ``generate_dataset``, and a whole-file ``json.loads``
parse for comparison.  No device is used.

Usage: python scripts/events_fold_cpu.py [--users N]
"""
import argparse
import json
import os
import sys
import tempfile
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--users", type=int, default=25_000)
    args = ap.parse_args()
    import torch

    import chip_smoke as cs
    import transmogrifai_tpu_torch as tt
    from transmogrifai_tpu_torch.workflow import OpWorkflow

    torch.set_num_threads(1)
    tt.set_device("cpu")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "clickstream.jsonl")
        events = cs.make_clickstream(path, args.users, seed=cs.EV_SEED)
        pred, _, _ = cs.build_events()
        raw = list(OpWorkflow().set_result_features(pred).raw_features())
        reader = cs.events_reader(path)
        t0 = time.perf_counter()
        reader._index()
        t1 = time.perf_counter()
        rows = len(reader.generate_dataset(raw))
        t2 = time.perf_counter()
        with open(path) as fh:
            [json.loads(line) for line in fh]
        t3 = time.perf_counter()
    print(json.dumps({"users": args.users, "events": events, "rows": rows,
                      "scan_s": t1 - t0, "fold_finalize_s": t2 - t1,
                      "parse_s": t3 - t2}))


if __name__ == "__main__":
    main()
