"""lightgbm_tpu_torch — the PyTorch/CUDA port of lightgbm_tpu.

``import lightgbm_tpu_torch as lgb``;
``bst = lgb.train(params, lgb.Dataset(X, label=y))``; ``bst.predict(X)``.
``lgb.Dataset(path)`` loads a CSV, TSV or libsvm file (the native
parser, ``native/``); ``lgb.train`` takes custom objectives and
evaluation functions, ``init_model`` and ``learning_rates``;
``lgb.cv`` cross-validates; ``lgb.LGBMClassifier`` and its siblings are
the scikit-learn estimators and ``lgb.plot_importance`` and its siblings
the plots (both imported on first use).
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
continues a run from the latest valid one, bit for bit.  Telemetry:
``telemetry_output`` in the parameters, ``LGBM_TPU_TRACE=<path>`` or the
``lgb.telemetry`` callback write a JSONL trace of spans, counters and
events (``lgb.obs``).
"""
from . import obs, serve
from .basic import Booster, Dataset
from .boosting.streaming import train_streaming
from .callback import (EarlyStopException, early_stopping, print_evaluation,
                       record_evaluation, reset_parameter, telemetry)
from .engine import cv, predict, train
from .io import outofcore

__all__ = [
    "Dataset", "Booster", "train", "cv", "predict", "serve",
    "early_stopping", "print_evaluation", "record_evaluation",
    "reset_parameter", "EarlyStopException", "telemetry", "obs",
    "LGBMModel", "LGBMRegressor", "LGBMClassifier", "LGBMRanker",
    "plot_importance", "plot_metric", "plot_tree", "create_tree_digraph",
    "train_streaming", "outofcore",
]


def __getattr__(name):
    # the estimators and the plots are imported on first use
    if name in ("LGBMModel", "LGBMRegressor", "LGBMClassifier", "LGBMRanker"):
        from . import sklearn as _sk
        return getattr(_sk, name)
    if name in ("plot_importance", "plot_metric", "plot_tree",
                "create_tree_digraph"):
        from . import plotting as _pl
        return getattr(_pl, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
