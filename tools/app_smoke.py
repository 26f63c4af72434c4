"""Phase 30 of ``chip_smoke.py`` (the command-line application and the C
API) alone, with the phases whose results it is held to.

    python3 tools/app_smoke.py

Builds the kernels, trains phase 4's headline and phase 5's small-data
cell through ``lgb.train`` on the card, runs phase 28 (whose two-rank
load digest the CLI ranks are held to), then ``chip_smoke.app_phase``:
the C API host at the headline, the CLI's small-data run with predict,
convert and refit, and two CLI ranks over gloo on card 0.  Prints the
phase 30 JSON line; exits non-zero when a check fails.  Needs CUDA.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("app_smoke: no CUDA device", file=sys.stderr)
        return 2
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.ops import cuda_build
    card = cs.card_line()
    cs.log(card)
    cs.log(f"build_s {cuda_build.build_all():.1f}")
    counters = cs.launch_counters()
    X, z = cs.headline_latent()
    y = (z > 0).astype(np.float32)
    ds = lgb.Dataset(X, label=y, params={"max_bin": 63}).construct()
    params = dict(cs.HEADLINE_PARAMS)
    bst, head_s, _ = cs.train_path(lgb, "headline", counters, params, ds,
                                   cs.HEADLINE_ITERS)
    head_ref = {"params": params, "text": bst.model_to_string(),
                "digest": bst.digest(),
                "digest_trees": bst.digest(include_scores=False),
                "pred": bst.predict(X)}
    small_rows = cs.small_data()
    Xs, ys, Xv, yv = small_rows
    ds_small = lgb.Dataset(Xs, label=ys,
                           params={"max_bin": cs.TRAIN_CONF["max_bin"]})
    dv_small = lgb.Dataset(Xv, label=yv, reference=ds_small)
    bst, _, _ = cs.train_path(
        lgb, "small-data", counters, cs.TRAIN_CONF, ds_small, cs.SMALL_ITERS,
        valid_sets=[dv_small], valid_names=["valid"],
        early_stopping_rounds=cs.SMALL_EARLY_STOP, evals_result={},
        verbose_eval=False)
    small_ref = {"stop": bst.current_iteration(),
                 "best": bst.best_iteration, "digest": bst.digest(),
                 "pred": bst.predict(Xv)}
    torch.cuda.synchronize()
    t0 = time.time()
    cs.multi_gpu_phase(lgb, ds, X, y, z,
                       1e3 * head_s / cs.HEADLINE_ITERS, card)
    cs.log(f"phase 28 {time.time() - t0:.1f} s")
    t0 = time.time()
    launches = cs.app_phase(lgb, X, y, small_rows, head_ref, small_ref, card)
    cs.log(f"phase 30 {time.time() - t0:.1f} s; launches {launches}")
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
