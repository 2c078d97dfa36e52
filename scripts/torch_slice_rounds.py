"""Milliseconds a boosting round of the port's boosted slice fit on the
card, for comparing two checkouts in one call.

The fit is ``OpXGBoostClassifier(max_depth=6, num_round=40,
early_stopping_rounds=0).fit_raw`` on ``chip_smoke.make_data``'s
1 000 000 x 500 matrix, three times in one process (the first pays the
warm-up); each fit's ``boosting_s / rounds_grown`` is printed.  The
checkout is the directory given (its ``transmogrifai_tpu_torch`` and
``chip_smoke.py`` are imported from there), so two trees compare in turns:

    python scripts/torch_slice_rounds.py PARENT_TREE
    python scripts/torch_slice_rounds.py .
"""
import sys

sys.path.insert(0, sys.argv[1])

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from transmogrifai_tpu_torch.models.trees import \
    OpXGBoostClassifier  # noqa: E402


def main() -> None:
    X, y = chip_smoke.make_data(1_000_000, 500)
    Xt = torch.from_numpy(X).cuda()
    del X
    ms = []
    for _ in range(3):
        est = OpXGBoostClassifier(max_depth=6, num_round=40,
                                  early_stopping_rounds=0)
        est.fit_raw(Xt, y, device="cuda")
        ms.append(est.metadata["fit_timing"]["boosting_s"]
                  / est.metadata["rounds_grown"] * 1e3)
    print("slice_rounds", sys.argv[1], "ms_per_round", ms, flush=True)


if __name__ == "__main__":
    main()
