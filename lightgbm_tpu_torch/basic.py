"""User-facing ``Dataset`` and ``Booster`` (the port's subset).

The reference Python package's surface (`python-package/lightgbm/basic.py`:
``Dataset`` `:572`, ``Booster`` `:1264`), as the JAX package's
``basic.py`` offers it, for numpy and pandas input (``category``
columns become their codes and, with ``categorical_feature="auto"``,
categorical features): a ``Dataset`` bins on the host
(``io/dataset.py``) and a ``Booster`` trains on one device.  A
``Dataset`` made with ``reference=`` (a validation set) bins with the
reference's mappers.  A ``Booster`` trains on ``cuda`` unless it is
given ``device="cpu"`` (or the ``device`` parameter); a ``cuda``
``Booster`` predicts through the compiled predictor (``serve/``) on the
card unless ``predict`` is given ``device=False``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from .config import Config
from .io.dataset import BinnedDataset, Metadata


def _data_to_numpy(data):
    """numpy or pandas -> ``(float array, pandas info or None)``; the
    info holds the ``category`` columns and the column names."""
    if hasattr(data, "dtypes") and hasattr(data, "columns"):    # pandas
        import pandas as pd               # local import; optional dep
        out = np.empty((len(data), data.shape[1]), np.float64)
        cat_cols = []
        for i, col in enumerate(data.columns):
            s = data[col]
            if str(s.dtype) == "category":
                cat_cols.append(i)
                out[:, i] = s.cat.codes.astype(np.float64)
            else:
                out[:, i] = pd.to_numeric(s, errors="coerce").astype(
                    np.float64)
        return out, {"categorical": cat_cols,
                     "names": [str(c) for c in data.columns]}
    X = np.asarray(data)
    if X.dtype == np.object_:
        X = X.astype(np.float64)
    return X, None


class Dataset:
    """Training data wrapper (numpy arrays or a pandas DataFrame).
    ``categorical_feature`` lists column indices or names; ``"auto"``
    takes a DataFrame's ``category`` columns.  ``group`` gives the
    ranking queries: per-query sizes (or boundaries from 0), the rows of
    a query contiguous."""

    def __init__(self, data, label=None, reference: "Dataset" = None,
                 weight=None, group=None, init_score=None,
                 feature_name="auto", categorical_feature="auto",
                 params: Optional[Dict[str, Any]] = None,
                 free_raw_data: bool = True):
        self.data = data
        self.label = label
        self.reference = reference
        self.weight = weight
        self.group = group
        self.init_score = init_score
        self.feature_name = feature_name
        self.categorical_feature = categorical_feature
        self.params = dict(params or {})
        self.free_raw_data = free_raw_data
        self._constructed: Optional[BinnedDataset] = None

    def construct(self) -> "Dataset":
        if self._constructed is not None:
            return self
        X, pd_info = _data_to_numpy(self.data)
        names = pd_info["names"] if pd_info is not None else None
        cat = []
        if self.categorical_feature == "auto" and pd_info is not None:
            cat = pd_info["categorical"]
        if self.categorical_feature not in ("auto", None):
            cat = [names.index(c) if isinstance(c, str) and names
                   else int(c) for c in self.categorical_feature]
        if isinstance(self.feature_name, (list, tuple)):
            names = list(self.feature_name)
        ref = (self.reference.construct()._constructed
               if self.reference is not None else None)
        self._constructed = BinnedDataset.from_raw(
            X, Config.from_params(self.params), categorical_features=cat,
            feature_names=names, reference=ref, metadata=Metadata())
        md = self._constructed.metadata
        if self.label is not None:
            md.set_field("label", np.asarray(self.label).reshape(-1))
        for name in ("weight", "group", "init_score"):
            if getattr(self, name) is not None:
                md.set_field(name, getattr(self, name))
        if self.free_raw_data:
            self.data = None
        return self

    def create_valid(self, data, label=None, weight=None, group=None,
                     init_score=None, params=None) -> "Dataset":
        """A validation set binned with this set's mappers."""
        return Dataset(data, label=label, reference=self, weight=weight,
                       group=group, init_score=init_score,
                       params=params or self.params)

    def set_group(self, group) -> None:
        self.group = group
        if self._constructed is not None:
            self._constructed.metadata.set_field("group", group)

    def get_group(self):
        """Per-query sizes, or None."""
        qb = self.construct()._constructed.metadata.get_field("group")
        return None if qb is None else np.diff(qb)


class Booster:
    """Trained model handle."""

    def __init__(self, params=None, train_set: Optional[Dataset] = None,
                 model_file: Optional[str] = None,
                 model_str: Optional[str] = None, device=None):
        from .boosting.gbdt import GBDT
        self.params = dict(params or {})
        self.best_iteration = -1
        self.best_score: Dict[str, Dict[str, float]] = {}
        self._serve_cache: Dict[tuple, Any] = {}
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

    def add_valid(self, data: Dataset, name: str) -> "Booster":
        """Score ``data`` (binned with the training set's mappers: make it
        with ``reference=``) after every iteration."""
        data.construct()
        self._gbdt.add_valid(data._constructed, name)
        return self

    def update(self) -> bool:
        """One boosting iteration; True when no split was possible."""
        return self._gbdt.train_one_iter()

    def eval_train(self):
        """``[(name, metric, value, higher_is_better)]`` on the training
        set."""
        name = getattr(self, "_train_data_name", "training")
        return [(name, m, v, h) for _, m, v, h in self._gbdt.eval_train()]

    def eval_valid(self):
        """``[(name, metric, value, higher_is_better)]`` on every valid
        set."""
        return self._gbdt.eval_valid()

    def current_iteration(self) -> int:
        return self._gbdt.iter

    def digest(self, include_scores: bool = True) -> str:
        return self._gbdt.digest(include_scores=include_scores)

    def predict(self, data, num_iteration: int = -1, raw_score: bool = False,
                pred_leaf: bool = False, pred_contrib: bool = False,
                device=None) -> np.ndarray:
        """Predict (the reference ``Booster.predict`` surface).

        ``num_iteration <= 0`` predicts with ``best_iteration`` when it
        is set, else with every tree; every mode truncates the same way
        (``num_iteration`` x the trees per iteration).  ``device=True``
        compiles the model once per truncation (``serve.compile_model``)
        onto this Booster's device and scores there; ``False`` takes the
        host walk (the oracle the compiled path is held to); ``None``
        takes the compiled path when this Booster is on ``cuda`` and the
        host walk when it is on the CPU.  ``pred_leaf`` returns the
        ``[n, T]`` leaf indices.
        """
        X = _data_to_numpy(data)[0]
        if num_iteration is None or num_iteration <= 0:
            num_iteration = self.best_iteration
        if pred_contrib:
            raise NotImplementedError(
                "pred_contrib (SHAP contributions) is not ported to "
                "lightgbm_tpu_torch yet (ROADMAP A6)")
        if device is None:
            device = torch.device(self.device).type == "cuda"
        if device:
            cm = self._device_predictor(num_iteration)
            if pred_leaf:
                return cm.leaf_indices(X)
            return cm.predict(X, raw_score=raw_score)
        if pred_leaf:
            return self._gbdt.predict_leaf(X, num_iteration=num_iteration)
        return self._gbdt.predict(X, raw_score=raw_score,
                                  num_iteration=num_iteration)

    def _device_predictor(self, num_iteration: int = -1):
        """The serving-compiled form of this model, cached per (model
        length, truncation): training another iteration invalidates it.
        A single entry, so a stale pack does not hold device memory."""
        from .serve import compile_model
        key = (len(self._gbdt.models), int(num_iteration or -1))
        if key not in self._serve_cache:
            self._serve_cache = {key: compile_model(
                self._gbdt, num_iteration=num_iteration)}
        return self._serve_cache[key]

    def model_to_string(self, num_iteration: int = -1) -> str:
        return self._gbdt.save_model_to_string(num_iteration)
