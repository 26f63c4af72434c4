"""Phase 28 of ``chip_smoke.py`` (multiple GPUs) alone, after the phase-4
headline it is held against.

    python3 tools/multi_gpu_smoke.py

Builds the kernels, bins the headline set, trains the single-rank
headline (its digest is what the feature-parallel ranks must give), then
runs ``chip_smoke.multi_gpu_phase``: two rank processes, NCCL with a
card a rank, gloo when they share one.  Prints phase 28's JSON line;
exits non-zero when a check fails.  Needs CUDA.
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
        print("multi_gpu_smoke: no CUDA device", file=sys.stderr)
        return 2
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.ops import cuda_build
    card = cs.card_line()
    cs.log(card)
    t0 = time.time()
    cs.log(f"build_s {cuda_build.build_all():.1f}")
    X, z = cs.headline_latent()
    y = (z > 0).astype(np.float32)
    ds = lgb.Dataset(X, label=y, params={"max_bin": 63}).construct()
    cs.log(f"data {time.time() - t0:.1f} s")
    bst, head_s, _ = cs.train_path(lgb, "headline", cs.mg_counters(),
                                   dict(cs.HEADLINE_PARAMS), ds,
                                   cs.HEADLINE_ITERS)
    head_ref = {"text": bst.model_to_string(),
                "digest_trees": bst.digest(include_scores=False)}
    cs.log(f"headline digest {head_ref['digest_trees']}")
    t0 = time.time()
    launches = cs.multi_gpu_phase(lgb, ds, X, y, head_ref,
                                  1e3 * head_s / cs.HEADLINE_ITERS, card)
    cs.log(f"phase 28 {time.time() - t0:.1f} s; launches {launches}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
