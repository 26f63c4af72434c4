"""Phase 29 of ``chip_smoke.py`` (elastic training) alone.

    python3 tools/elastic_smoke.py

Builds the kernels, bins the headline set (the multi-process snapshot
barrier trains it on two ranks), then runs ``chip_smoke.elastic_phase``:
the single-process S = 2 oracle of the stream cell on the card, the
control, shrink and regrow runs of two ``train_elastic`` workers on
card 0, and the two-rank barrier resume (held to its own uninterrupted
digest here; the whole smoke also holds it to phase 28's).  Prints
phase 29's JSON line; exits non-zero when a check fails.  Needs CUDA.
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
        print("elastic_smoke: no CUDA device", file=sys.stderr)
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
    t0 = time.time()
    launches = cs.elastic_phase(lgb, ds, card)
    cs.log(f"phase 29 {time.time() - t0:.1f} s; launches {launches}")
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
