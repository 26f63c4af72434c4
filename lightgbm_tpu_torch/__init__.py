"""lightgbm_tpu_torch — the PyTorch/CUDA port of lightgbm_tpu.

``import lightgbm_tpu_torch as lgb``;
``bst = lgb.train(params, lgb.Dataset(X, label=y))``; ``bst.predict(X)``.
Out of core: ``lgb.train_streaming(params, files_or_store,
block_rows=1 << 20)`` streams row blocks of a shard store
(``lgb.outofcore``) through the device.  Training runs on ``cuda``
unless the caller passes ``device="cpu"``; on the card the learner's hot
path runs hand-written CUDA kernels (``csrc/``), on the CPU their plain
PyTorch versions.  Importing the package loads no CUDA code: kernels
build at first use.  Serving: ``lgb.serve.compile_model(bst)`` packs a
model onto its device and ``lgb.serve.PredictionServer`` micro-batches
requests through it; a ``cuda`` Booster's ``bst.predict(X)`` takes that
path.  Snapshots: ``snapshot_freq`` with ``output_model`` writes atomic
snapshots during ``lgb.train`` and ``lgb.train(..., resume_from=)``
continues a run from the latest valid one, bit for bit.
"""
from . import serve
from .basic import Booster, Dataset
from .boosting.streaming import train_streaming
from .engine import predict, train
from .io import outofcore

__all__ = ["Booster", "Dataset", "outofcore", "predict", "serve", "train",
           "train_streaming"]
