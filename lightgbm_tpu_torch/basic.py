"""User-facing ``Dataset`` and ``Booster`` (the slice's subset).

The reference Python package's surface (`python-package/lightgbm/basic.py`:
``Dataset`` `:572`, ``Booster`` `:1264`), as the JAX package's
``basic.py`` offers it, for numpy input: a ``Dataset`` bins on the host
(``io/dataset.py``) and a ``Booster`` trains on one device.  A
``Booster`` trains on ``cuda`` unless it is given ``device="cpu"`` (or
the ``device`` parameter).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from .config import Config
from .io.dataset import BinnedDataset, Metadata


class Dataset:
    """Training data wrapper (numpy arrays)."""

    def __init__(self, data, label=None, weight=None, init_score=None,
                 feature_name="auto", categorical_feature="auto",
                 params: Optional[Dict[str, Any]] = None,
                 free_raw_data: bool = True):
        self.data = data
        self.label = label
        self.weight = weight
        self.init_score = init_score
        self.feature_name = feature_name
        self.categorical_feature = categorical_feature
        self.params = dict(params or {})
        self.free_raw_data = free_raw_data
        self._constructed: Optional[BinnedDataset] = None

    def construct(self) -> "Dataset":
        if self._constructed is not None:
            return self
        X = np.asarray(self.data)
        if X.dtype == np.object_:
            X = X.astype(np.float64)
        cat = ([] if self.categorical_feature in ("auto", None)
               else [int(c) for c in self.categorical_feature])
        names = (list(self.feature_name)
                 if isinstance(self.feature_name, (list, tuple)) else None)
        self._constructed = BinnedDataset.from_raw(
            X, Config.from_params(self.params), categorical_features=cat,
            feature_names=names, metadata=Metadata())
        md = self._constructed.metadata
        if self.label is not None:
            md.set_field("label", np.asarray(self.label).reshape(-1))
        if self.weight is not None:
            md.set_field("weight", self.weight)
        if self.init_score is not None:
            md.set_field("init_score", self.init_score)
        if self.free_raw_data:
            self.data = None
        return self


class Booster:
    """Trained model handle."""

    def __init__(self, params=None, train_set: Optional[Dataset] = None,
                 model_file: Optional[str] = None,
                 model_str: Optional[str] = None, device=None):
        from .boosting.gbdt import GBDT
        self.params = dict(params or {})
        cfg = Config.from_params(self.params)
        self.device = str(device or cfg.device)
        if train_set is not None:
            train_set.params = {**self.params, **train_set.params}
            train_set.construct()
            self._gbdt = GBDT(cfg, train_set._constructed, self.device)
        else:
            if model_file is not None:
                with open(model_file, encoding="utf-8") as f:
                    model_str = f.read()
            if model_str is None:
                raise ValueError(
                    "need one of train_set, model_file, model_str")
            self._gbdt = GBDT(cfg, None, self.device)
            self._gbdt.load_model_from_string(model_str)

    def update(self) -> bool:
        """One boosting iteration; True when no split was possible."""
        return self._gbdt.train_one_iter()

    def current_iteration(self) -> int:
        return self._gbdt.iter

    def digest(self, include_scores: bool = True) -> str:
        return self._gbdt.digest(include_scores=include_scores)

    def predict(self, data, num_iteration: int = -1,
                raw_score: bool = False) -> np.ndarray:
        return self._gbdt.predict(np.asarray(data), raw_score=raw_score,
                                  num_iteration=num_iteration)

    def model_to_string(self, num_iteration: int = -1) -> str:
        return self._gbdt.save_model_to_string(num_iteration)
