"""Prediction serving on the card.

* :mod:`~lightgbm_tpu_torch.serve.compiler` — pack a trained booster
  (including reference-format text models) into device tensors and score
  whole batches, one CUDA graph per padding bucket on the card, with a
  binned path riding the training bin pipeline;
* :mod:`~lightgbm_tpu_torch.serve.server` — micro-batching async harness
  (request queue, padding buckets, retries, graceful drain).

Entry points::

    from lightgbm_tpu_torch.serve import compile_model, PredictionServer
    cm = compile_model(booster)            # or Booster.predict(device=True)
    scores = cm.predict(X)                 # bucket-padded
    with PredictionServer(cm) as srv:
        fut = srv.submit(row)              # micro-batched async
"""
from .compiler import (CompiledModel, ServePack, build_pack, compile_model,
                       compile_trees, next_bucket)
from .server import PredictionServer

__all__ = [
    "CompiledModel", "ServePack", "build_pack", "compile_model",
    "compile_trees", "next_bucket", "PredictionServer",
]
