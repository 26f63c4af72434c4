"""lightgbm_tpu_torch — the PyTorch/CUDA port of lightgbm_tpu.

``import lightgbm_tpu_torch as lgb``;
``bst = lgb.train(params, lgb.Dataset(X, label=y))``; ``bst.predict(X)``.
Training runs on ``cuda`` unless the caller passes ``device="cpu"``; on
the card the learner's hot path runs hand-written CUDA kernels
(``csrc/``), on the CPU their plain PyTorch versions.  Importing the
package loads no CUDA code: kernels build at first use.
"""
from .basic import Booster, Dataset
from .engine import train

__all__ = ["Booster", "Dataset", "train"]
