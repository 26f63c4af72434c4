#!/usr/bin/env python3
"""``chip_smoke.py`` phase 31 alone on one GPU: the full-size parity check.

Builds the kernels, trains what the chosen cells reuse of the smoke's
earlier phases (phase 4's headline, phase 5's small-data model, phase
12's serving model) through ``lgb.train`` on the card as the smoke does,
then runs phase 31 (``chip_smoke.fullsize_phase``) against the JAX
package's records in ``tests/data/torch_fullsize/``; the cells of phases
6, 8, 17 and 19 are trained inside phase 31 as their records were::

    python3 tools/fullsize_phase.py [--cells dp2_l2,headline_float,...]

On an H100 about a minute and a half with the build for the first four
cells, and 87-92 s of command time for the five PR 23 cells, against
the whole smoke's ten minutes: the loop to use while the port or a
record changes.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", default=",".join(cs.FULLSIZE_CELLS))
    cells = tuple(ap.parse_args(argv).cells.split(","))
    import torch
    if not torch.cuda.is_available():
        print("fullsize_phase: no CUDA device", file=sys.stderr)
        return 2
    import numpy as np
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.metric.metrics import binary_auc
    from lightgbm_tpu_torch.ops import cuda_build
    card = cs.card_line()
    cs.log(f"{card}; build_s {cuda_build.build_all():.2f}")
    counters = cs.launch_counters()
    X, z = cs.headline_latent()
    y = (z > 0).astype(np.float32)
    ds = lgb.Dataset(X, label=y, params={"max_bin": 63}).construct()
    if "headline" in cells:
        bst, _, _ = cs.train_path(lgb, "headline", counters,
                                  cs.HEADLINE_PARAMS, ds, cs.HEADLINE_ITERS)
        cs.FULLSIZE["headline"] = {"booster": bst,
                                   "train_auc": binary_auc(y,
                                                           bst.predict(X))}
    Xs, ys, Xv, yv = cs.small_data()
    dss = lgb.Dataset(Xs, label=ys,
                      params={"max_bin": cs.TRAIN_CONF["max_bin"]})
    dvs = lgb.Dataset(Xv, label=yv, reference=dss)
    if "small_data" in cells:
        bst, _, _ = cs.train_path(
            lgb, "small-data", counters, cs.TRAIN_CONF, dss, cs.SMALL_ITERS,
            valid_sets=[dvs], valid_names=["valid"],
            early_stopping_rounds=cs.SMALL_EARLY_STOP, verbose_eval=False)
        cs.FULLSIZE["small_data"] = {
            "booster": bst, "valid_auc": binary_auc(yv, bst.predict(Xv))}
    if "serving" in cells:
        Xsv, ysv = cs.serve_train_data(np.random.RandomState(11))
        bst, _, _ = cs.train_path(
            lgb, "serve model", counters, cs.SERVE_PARAMS,
            lgb.Dataset(Xsv, label=ysv, params={"max_bin": 63}),
            cs.SERVE_ITERS)
        cs.FULLSIZE["serving"] = {"booster": bst}
    t0 = time.time()
    cs.fullsize_phase(lgb, counters, ds, X, z, (Xs, ys, Xv, yv), dss, dvs,
                      card, cells=cells)
    cs.log(f"phase 31 {time.time() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
