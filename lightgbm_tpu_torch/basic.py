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
card unless ``predict`` is given ``device=False``.  The model surface
follows the JAX package's ``basic.py``: model files, the JSON dump,
feature importance, rollback, refit, SHAP contributions (on the host),
copies and pickles (which hold the model text, never tensors).  A
``Dataset`` made from a path loads a CSV, TSV or libsvm file with its
side files (``io/loader.py``, through the native parser); custom
objectives and evaluation functions see host numpy scores, as in the
JAX package.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

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
    """Training data wrapper (numpy arrays, a pandas DataFrame, or the
    path of a CSV, TSV or libsvm file: ``io/loader.py:load_file``, whose
    ``label_column``, ``has_header`` and the other file parameters come
    from ``params``).
    ``categorical_feature`` lists column indices or names; ``"auto"``
    takes a DataFrame's ``category`` columns.  ``group`` gives the
    ranking queries: per-query sizes (or boundaries from 0), the rows of
    a query contiguous."""

    def __init__(self, data, label=None, reference: "Dataset" = None,
                 weight=None, group=None, init_score=None,
                 feature_name="auto", categorical_feature="auto",
                 params: Optional[Dict[str, Any]] = None,
                 free_raw_data: bool = True, silent: bool = False):
        # ``silent`` is accepted and ignored, as in the JAX package and
        # LightGBM 2.1's Python package
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
        self.used_indices: Optional[np.ndarray] = None

    def construct(self) -> "Dataset":
        if self._constructed is not None:
            return self
        ref = (self.reference.construct()._constructed
               if self.reference is not None else None)
        if isinstance(self.data, str):
            from .io.loader import load_file
            cfg = Config.from_params(self.params)
            rank, world, ag = 0, 1, None
            if (cfg.num_machines > 1 and ref is None
                    and cfg.tree_learner in ("data", "voting")):
                # inside a process group, the row-splitting learners load
                # their data index's mod-rank rows with distributed bin
                # finding; feature-parallel and serial keep every row
                from .parallel.mesh import data_shard_loading
                rank, world, ag = data_shard_loading(cfg.mesh_shape)
            self._constructed = load_file(self.data, cfg, reference=ref,
                                          rank=rank, num_machines=world,
                                          allgather=ag)
            self._apply_fields()
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
        self._constructed = BinnedDataset.from_raw(
            X, Config.from_params(self.params), categorical_features=cat,
            feature_names=names, reference=ref, metadata=Metadata())
        self._apply_fields()
        if self.free_raw_data:
            self.data = None
        return self

    def _apply_fields(self) -> None:
        """The label, weights, groups and init scores given to the
        constructor override those a file brought."""
        md = self._constructed.metadata
        if self.label is not None:
            md.set_field("label", np.asarray(self.label).reshape(-1))
        for name in ("weight", "group", "init_score"):
            if getattr(self, name) is not None:
                md.set_field(name, getattr(self, name))

    def create_valid(self, data, label=None, weight=None, group=None,
                     init_score=None, params=None) -> "Dataset":
        """A validation set binned with this set's mappers."""
        return Dataset(data, label=label, reference=self, weight=weight,
                       group=group, init_score=init_score,
                       params=params or self.params)

    def subset(self, used_indices, params=None) -> "Dataset":
        """The rows ``used_indices`` of this set, binned as this set is;
        ``used_indices`` is kept on the subset, and ``params`` replace
        its parameters when given."""
        self.construct()
        sub = Dataset.__new__(Dataset)
        sub.__dict__.update(self.__dict__)
        sub._constructed = self._constructed.subset(np.asarray(used_indices))
        sub.used_indices = np.asarray(used_indices)
        sub.reference = self
        if params is not None:
            sub.params = dict(params)
        return sub

    def set_field(self, name, data) -> None:
        self.construct()
        self._constructed.metadata.set_field(name, data)

    def get_field(self, name):
        self.construct()
        return self._constructed.metadata.get_field(name)

    def _set(self, name, data) -> None:
        setattr(self, name, data)
        if self._constructed is not None:
            self._constructed.metadata.set_field(name, data)

    def set_label(self, label) -> None:
        self._set("label", label)

    def set_weight(self, weight) -> None:
        self._set("weight", weight)

    def set_group(self, group) -> None:
        self._set("group", group)

    def set_init_score(self, init_score) -> None:
        self._set("init_score", init_score)

    def get_label(self):
        return self.get_field("label")

    def get_weight(self):
        return self.get_field("weight")

    def get_init_score(self):
        return self.get_field("init_score")

    def get_group(self):
        """Per-query sizes, or None."""
        qb = self.get_field("group")
        return None if qb is None else np.diff(qb)

    def num_data(self) -> int:
        self.construct()
        return self._constructed.num_data

    def num_feature(self) -> int:
        self.construct()
        return self._constructed.num_total_features

    def save_binary(self, filename: str) -> None:
        """The binned set as the JAX package writes it
        (``BinnedDataset.save_binary``; either package loads it)."""
        self.construct()
        self._constructed.save_binary(filename)

    @property
    def feature_names(self) -> List[str]:
        self.construct()
        return self._constructed.feature_names


class Booster:
    """Trained model handle."""

    def __init__(self, params=None, train_set: Optional[Dataset] = None,
                 model_file: Optional[str] = None,
                 model_str: Optional[str] = None, device=None,
                 silent: bool = False):
        # ``silent`` is accepted and ignored, as in the JAX package
        from .boosting.variants import create_boosting
        self.params = dict(params or {})
        self.best_iteration = -1
        self.best_score: Dict[str, Dict[str, float]] = {}
        self._serve_cache: Dict[tuple, Any] = {}
        self._valid_sets: List[Dataset] = []
        self._name_valid_sets: List[str] = []
        cfg = Config.from_params(self.params)
        self.device = str(device or cfg.device)
        self._train_dataset = train_set
        if train_set is not None:
            train_set.params = {**self.params, **train_set.params}
            train_set.construct()
            self._gbdt = create_boosting(cfg, train_set._constructed,
                                         self.device)
            return
        if model_file is not None:
            from .utils.file_io import open_read
            with open_read(model_file) as f:
                model_str = f.read()
        if model_str is None:
            raise ValueError(
                "need one of train_set, model_file, model_str")
        self._init_from_string(model_str)

    def _init_from_string(self, text: str, copy: bool = False) -> None:
        """Load model text; ``copy`` (a copy or an unpickled Booster)
        also keeps its ``feature_infos``, so the copy writes the same
        text."""
        from .boosting.gbdt import GBDT
        self._gbdt = GBDT(Config.from_params(self.params), None,
                          self.device)
        self._gbdt.load_model_from_string(text, keep_feature_infos=copy)
        self._serve_cache = {}
        self._valid_sets = []
        self._name_valid_sets = []

    def add_valid(self, data: Dataset, name: str) -> "Booster":
        """Score ``data`` (binned with the training set's mappers: make it
        with ``reference=``) after every iteration; added after training
        started, the existing trees are replayed into its scores on this
        Booster's device."""
        data.construct()
        self._gbdt.add_valid(data._constructed, name)
        self._valid_sets.append(data)
        self._name_valid_sets.append(name)
        return self

    def update(self, train_set=None, fobj=None) -> bool:
        """One boosting iteration; True when no split was possible.  With
        ``fobj(scores, train_dataset) -> (grad, hess)``, or a callable
        ``objective`` parameter, the gradients come from it
        (``GBDT.custom_gradients``: host numpy scores, class-major when
        K > 1).  ``train_set`` is accepted and unused, as in the JAX
        package."""
        fobj = fobj or self._gbdt.config.extra.get("fobj")
        if fobj is None:
            return self._gbdt.train_one_iter()
        grad, hess = self._gbdt.custom_gradients(fobj, self._train_dataset)
        return self._gbdt.train_one_iter(grad, hess)

    def rollback_one_iter(self) -> "Booster":
        """Drop the last iteration's trees, and their outputs from the
        training and valid scores."""
        self._gbdt.rollback_one_iter()
        self._serve_cache = {}
        return self

    def eval_train(self, feval=None):
        """``[(name, metric, value, higher_is_better)]`` on the training
        set; then ``feval``'s, when given."""
        name = getattr(self, "_train_data_name", "training")
        out = [(name, m, v, h) for _, m, v, h in self._gbdt.eval_train()]
        if feval is not None:
            out.extend(self._custom_eval(feval, name, self._train_dataset,
                                         self._gbdt.scores))
        return out

    def eval_valid(self, feval=None):
        """``[(name, metric, value, higher_is_better)]`` on every valid
        set; then ``feval``'s on each, when given."""
        out = self._gbdt.eval_valid()
        if feval is not None:
            for i, vs in enumerate(self._valid_sets):
                out.extend(self._custom_eval(
                    feval, self._name_valid_sets[i], vs,
                    self._gbdt._valid_scores[i]))
        return out

    @staticmethod
    def _custom_eval(feval, name, dataset, scores):
        """``feval(scores, dataset)`` on host numpy scores (``[n]``, or
        ``[n, K]`` when K > 1, as the JAX package passes them) -> one
        ``(metric, value, higher_is_better)`` or a list of them."""
        s = scores.cpu().numpy()
        res = feval(s if s.shape[1] > 1 else s[:, 0], dataset)
        if isinstance(res, tuple):
            res = [res]
        return [(name, mn, mv, hib) for mn, mv, hib in res]

    def current_iteration(self) -> int:
        return self._gbdt.iter

    def num_trees(self) -> int:
        return self._gbdt.num_trees()

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
        ``[n, T]`` leaf indices; ``pred_contrib`` the SHAP values
        ``[n, F + 1]`` (per class for K > 1), always on the host
        (``boosting/contrib.py``).  With the ``pred_early_stop``
        parameter both paths score in rounds of
        ``pred_early_stop_freq`` iterations and a row whose margin
        passes ``pred_early_stop_margin`` takes no more trees.
        """
        X = _data_to_numpy(data)[0]
        if num_iteration is None or num_iteration <= 0:
            num_iteration = self.best_iteration
        if pred_contrib:
            from .boosting.contrib import predict_contrib
            return predict_contrib(self._gbdt, X, num_iteration)
        if device is None:
            device = torch.device(self.device).type == "cuda"
        if device:
            cm = self._device_predictor(num_iteration)
            if pred_leaf:
                return cm.leaf_indices(X)
            c = self._gbdt.config
            early = ((c.pred_early_stop_freq, c.pred_early_stop_margin)
                     if c.pred_early_stop else None)
            return cm.predict(X, raw_score=raw_score, early_stop=early)
        if pred_leaf:
            return self._gbdt.predict_leaf(X, num_iteration=num_iteration)
        return self._gbdt.predict(X, raw_score=raw_score,
                                  num_iteration=num_iteration)

    def _device_predictor(self, num_iteration: int = -1):
        """The serving-compiled form of this model, cached per (model
        length, truncation): training another iteration invalidates it;
        rollback, refit and resume clear it.  A single entry, so a stale
        pack does not hold device memory."""
        from .serve import compile_model
        key = (len(self._gbdt.models), int(num_iteration or -1))
        if key not in self._serve_cache:
            self._serve_cache = {key: compile_model(
                self._gbdt, num_iteration=num_iteration)}
        return self._serve_cache[key]

    def refit(self, data, label, decay_rate: float = 0.9,
              **kwargs) -> "Booster":
        """Refit the leaf values of the tree structures on new data
        (reference ``Booster.refit``, ``gbdt.cpp:268-280``): ``new_leaf =
        decay_rate * old + (1 - decay_rate) * refit``.  Returns a new
        Booster on this Booster's device; this one is untouched.
        ``kwargs`` go into the new Booster's parameters (``lambda_l1``,
        ``lambda_l2`` steer the refit)."""
        params = dict(self.params)
        params.update(kwargs)
        new = Booster(params=params, model_str=self.model_to_string(),
                      device=self.device)
        if kwargs:
            new._gbdt.reset_config(params)
        md = Metadata()
        md.set_field("label", np.asarray(label).reshape(-1))
        new._gbdt.refit_rows(_data_to_numpy(data)[0], md, decay_rate)
        return new

    # -- model IO ----------------------------------------------------------
    def save_model(self, filename: str, num_iteration: int = -1
                   ) -> "Booster":
        if num_iteration is None or num_iteration <= 0:
            num_iteration = self.best_iteration
        self._gbdt.save_model(filename, num_iteration)
        return self

    def model_to_string(self, num_iteration: int = -1) -> str:
        return self._gbdt.save_model_to_string(num_iteration or -1)

    def model_from_string(self, model_str: str,
                          verbose: bool = True) -> "Booster":
        # ``verbose`` is accepted and ignored, as in the JAX package
        self._init_from_string(model_str)
        self._train_dataset = None
        return self

    def dump_model(self, num_iteration: int = -1) -> Dict[str, Any]:
        """JSON dump (reference DumpModel, ``gbdt_model_text.cpp:15-49``)."""
        g = self._gbdt
        T = g._num_trees(num_iteration)
        trees = [{"tree_index": i, "num_leaves": t.num_leaves,
                  "num_cat": t.num_cat, "shrinkage": t.shrinkage_rate,
                  "tree_structure": _tree_to_json(t, 0)}
                 for i, t in enumerate(g.models[:T])]
        return {
            "name": "tree",
            "version": "v2",
            "num_class": g.num_class,
            "num_tree_per_iteration": g.num_tree_per_iteration,
            "label_index": 0,
            "max_feature_idx": g.max_feature_idx,
            "feature_names": g.feature_names,
            "objective": (g.objective.to_string() if g.objective else ""),
            "average_output": g.average_output,
            "tree_info": trees,
        }

    def feature_importance(self, importance_type: str = "split",
                           iteration: int = -1) -> np.ndarray:
        return self._gbdt.feature_importance(importance_type,
                                             iteration or -1)

    def feature_name(self) -> List[str]:
        return list(self._gbdt.feature_names)

    def num_feature(self) -> int:
        return self._gbdt.max_feature_idx + 1

    def free_dataset(self) -> "Booster":
        self._train_dataset = None
        return self

    def __copy__(self):
        return self.__deepcopy__(None)

    def __deepcopy__(self, memo):
        new = Booster.__new__(Booster)
        new.__setstate__(self.__getstate__())
        return new

    def __getstate__(self):
        return {"params": self.params, "device": self.device,
                "model_str": self.model_to_string(),
                "best_iteration": self.best_iteration,
                "best_score": self.best_score}

    def __setstate__(self, state):
        self.params = state["params"]
        self.device = state.get("device", "cuda")
        self.best_iteration = state.get("best_iteration", -1)
        self.best_score = {k: dict(v) for k, v in
                           state.get("best_score", {}).items()}
        self._train_dataset = None
        self._init_from_string(state["model_str"], copy=True)


def _tree_to_json(t, node: int) -> Dict[str, Any]:
    """One node of the JSON dump, its subtree included (the JAX
    package's ``_tree_to_json``)."""
    if t.num_leaves == 1:
        return {"leaf_value": float(t.leaf_value[0])}
    if node < 0:
        leaf = ~node
        return {"leaf_index": int(leaf),
                "leaf_value": float(t.leaf_value[leaf]),
                "leaf_count": int(t.leaf_count[leaf])}
    dt = int(t.decision_type[node])
    return {
        "split_index": int(node),
        "split_feature": int(t.split_feature[node]),
        "split_gain": float(t.split_gain[node]),
        "threshold": float(t.threshold[node]),
        "decision_type": "==" if dt & 1 else "<=",
        "default_left": bool(dt & 2),
        "missing_type": ["None", "Zero", "NaN"][(dt >> 2) & 3],
        "internal_value": float(t.internal_value[node]),
        "internal_count": int(t.internal_count[node]),
        "left_child": _tree_to_json(t, int(t.left_child[node])),
        "right_child": _tree_to_json(t, int(t.right_child[node])),
    }
