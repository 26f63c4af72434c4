"""scikit-learn estimator API (a copy of the JAX package's
``sklearn.py``).

Parity with the reference wrappers (``python-package/lightgbm/sklearn.py``:
``LGBMModel`` `:127`, ``LGBMRegressor`` `:594`, ``LGBMClassifier`` `:624`,
``LGBMRanker`` `:734`): the same constructor parameters, ``fit`` keywords
and attributes (``best_iteration_``, ``feature_importances_``,
``classes_``), so estimators drop into scikit-learn pipelines and grid
searches.  The module imports no scikit-learn.  One parameter more than
the JAX package's: ``device`` (``"cuda"`` unless set), where ``fit``
trains; the Booster predicts there too.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np

from .basic import Booster, Dataset
from .engine import train as train_fn


class LGBMModel:
    """Base sklearn-style estimator."""

    def __init__(self, boosting_type="gbdt", num_leaves=31, max_depth=-1,
                 learning_rate=0.1, n_estimators=100,
                 subsample_for_bin=200000, objective=None, class_weight=None,
                 min_split_gain=0.0, min_child_weight=1e-3,
                 min_child_samples=20, subsample=1.0, subsample_freq=0,
                 colsample_bytree=1.0, reg_alpha=0.0, reg_lambda=0.0,
                 random_state=None, n_jobs=-1, silent=True,
                 importance_type="split", device="cuda", **kwargs):
        self.boosting_type = boosting_type
        self.num_leaves = num_leaves
        self.max_depth = max_depth
        self.learning_rate = learning_rate
        self.n_estimators = n_estimators
        self.subsample_for_bin = subsample_for_bin
        self.objective = objective
        self.class_weight = class_weight
        self.min_split_gain = min_split_gain
        self.min_child_weight = min_child_weight
        self.min_child_samples = min_child_samples
        self.subsample = subsample
        self.subsample_freq = subsample_freq
        self.colsample_bytree = colsample_bytree
        self.reg_alpha = reg_alpha
        self.reg_lambda = reg_lambda
        self.random_state = random_state
        self.n_jobs = n_jobs
        self.silent = silent
        self.importance_type = importance_type
        self.device = device
        self._other_params = dict(kwargs)
        self._Booster: Optional[Booster] = None
        self._evals_result: Dict = {}
        self._best_iteration = -1
        self._n_features = 0
        self._classes = None
        self._n_classes = 0
        self.set_params(**kwargs)

    # -- sklearn protocol ------------------------------------------------
    _estimator_type = "regressor"

    def __sklearn_tags__(self):
        """The estimator tags that scikit-learn 1.6 and later asks for
        (``clone``, the searches).  Only scikit-learn calls this, so the
        import adds no dependency."""
        from sklearn.utils import (ClassifierTags, RegressorTags, Tags,
                                   TargetTags)
        classifier = self._estimator_type == "classifier"
        return Tags(estimator_type=self._estimator_type,
                    target_tags=TargetTags(required=True),
                    classifier_tags=ClassifierTags() if classifier else None,
                    regressor_tags=None if classifier else RegressorTags())

    def get_params(self, deep=True) -> Dict[str, Any]:
        params = {
            "boosting_type": self.boosting_type, "num_leaves": self.num_leaves,
            "max_depth": self.max_depth, "learning_rate": self.learning_rate,
            "n_estimators": self.n_estimators,
            "subsample_for_bin": self.subsample_for_bin,
            "objective": self.objective, "class_weight": self.class_weight,
            "min_split_gain": self.min_split_gain,
            "min_child_weight": self.min_child_weight,
            "min_child_samples": self.min_child_samples,
            "subsample": self.subsample, "subsample_freq": self.subsample_freq,
            "colsample_bytree": self.colsample_bytree,
            "reg_alpha": self.reg_alpha, "reg_lambda": self.reg_lambda,
            "random_state": self.random_state, "n_jobs": self.n_jobs,
            "silent": self.silent, "importance_type": self.importance_type,
            "device": self.device,
        }
        params.update(self._other_params)
        return params

    def set_params(self, **params) -> "LGBMModel":
        named = set(self.get_params()) - set(self._other_params)
        for key, value in params.items():
            setattr(self, key, value)
            if key not in named:
                self._other_params[key] = value
        return self

    def _process_params(self, default_objective: str) -> Dict[str, Any]:
        params = self.get_params()
        params.pop("silent", None)
        params.pop("importance_type", None)
        params.pop("class_weight", None)
        params.pop("n_jobs", None)
        params.pop("device", None)
        objective = params.pop("objective", None) or default_objective
        ren = {
            "boosting_type": "boosting_type",
            "num_leaves": "num_leaves", "max_depth": "max_depth",
            "learning_rate": "learning_rate",
            "subsample_for_bin": "bin_construct_sample_cnt",
            "min_split_gain": "min_gain_to_split",
            "min_child_weight": "min_sum_hessian_in_leaf",
            "min_child_samples": "min_data_in_leaf",
            "subsample": "bagging_fraction",
            "subsample_freq": "bagging_freq",
            "colsample_bytree": "feature_fraction",
            "reg_alpha": "lambda_l1", "reg_lambda": "lambda_l2",
        }
        out = {}
        for k, v in params.items():
            if k in ("n_estimators", "random_state"):
                continue
            out[ren.get(k, k)] = v
        if callable(objective):
            self._fobj = _ObjectiveFunctionWrapper(objective)
            out["objective"] = "none"
        else:
            self._fobj = None
            out["objective"] = objective
        if self.random_state is not None:
            out["seed"] = int(self.random_state) \
                if not hasattr(self.random_state, "randint") \
                else int(self.random_state.randint(1 << 30))
        if out.get("bagging_fraction", 1.0) < 1.0 and \
                not out.get("bagging_freq"):
            out["bagging_freq"] = 1
        return out

    def fit(self, X, y, sample_weight=None, init_score=None, group=None,
            eval_set=None, eval_names=None, eval_sample_weight=None,
            eval_init_score=None, eval_group=None, eval_metric=None,
            early_stopping_rounds=None, verbose=False, feature_name="auto",
            categorical_feature="auto", callbacks=None) -> "LGBMModel":
        params = self._process_params(self._default_objective())
        if eval_metric and not callable(eval_metric):
            params["metric"] = eval_metric if isinstance(eval_metric, str) \
                else list(eval_metric)
        if self.class_weight is not None and isinstance(self.class_weight, dict):
            cw = np.asarray([self.class_weight.get(int(v), 1.0) for v in y])
            sample_weight = cw if sample_weight is None else sample_weight * cw

        y_t = self._transform_label(np.asarray(y))
        train_set = Dataset(X, label=y_t, weight=sample_weight, group=group,
                            init_score=init_score, params=params,
                            feature_name=feature_name,
                            categorical_feature=categorical_feature)
        valid_sets: List[Dataset] = []
        valid_names: List[str] = []
        if eval_set is not None:
            if isinstance(eval_set, tuple):
                eval_set = [eval_set]
            for i, (vx, vy) in enumerate(eval_set):
                vw = eval_sample_weight[i] if eval_sample_weight else None
                vg = eval_group[i] if eval_group else None
                vi = eval_init_score[i] if eval_init_score else None
                valid_sets.append(train_set.create_valid(
                    vx, label=self._transform_label(np.asarray(vy)),
                    weight=vw, group=vg, init_score=vi))
                valid_names.append(eval_names[i] if eval_names else f"valid_{i}")

        self._evals_result = {}
        self._Booster = train_fn(
            params, train_set, num_boost_round=self.n_estimators,
            valid_sets=valid_sets, valid_names=valid_names,
            fobj=self._fobj, feval=_to_feval(eval_metric),
            early_stopping_rounds=early_stopping_rounds,
            evals_result=self._evals_result, verbose_eval=verbose,
            callbacks=callbacks, device=self.device)
        self._best_iteration = self._Booster.best_iteration
        self._n_features = np.asarray(X).shape[1] if not isinstance(X, str) else 0
        return self

    def _default_objective(self) -> str:
        return "regression"

    def _transform_label(self, y):
        return y.astype(np.float32)

    def predict(self, X, raw_score=False, num_iteration=None, device=None,
                **kwargs):
        """``device`` is ``Booster.predict``'s: ``None`` takes the compiled
        predictor (``serve/``) when the model was fitted on ``cuda``, the
        host walk otherwise."""
        if self._Booster is None:
            raise RuntimeError("fit() must be called before predict()")
        return self._Booster.predict(X, raw_score=raw_score,
                                     num_iteration=num_iteration or -1,
                                     device=device, **kwargs)

    # -- attributes ------------------------------------------------------
    @property
    def booster_(self) -> Booster:
        return self._Booster

    @property
    def best_iteration_(self) -> int:
        return self._best_iteration

    @property
    def best_score_(self):
        return getattr(self._Booster, "best_score", {})

    @property
    def evals_result_(self):
        return self._evals_result

    @property
    def feature_importances_(self) -> np.ndarray:
        return self._Booster.feature_importance(self.importance_type)

    @property
    def n_features_(self) -> int:
        return self._n_features


class LGBMRegressor(LGBMModel):
    def _default_objective(self):
        return "regression"


class LGBMClassifier(LGBMModel):
    _estimator_type = "classifier"

    def _default_objective(self):
        return "binary" if self._n_classes <= 2 else "multiclass"

    def fit(self, X, y, **kwargs):
        y = np.asarray(y)
        self._classes = np.unique(y)
        self._n_classes = len(self._classes)
        self._label_map = {c: i for i, c in enumerate(self._classes)}
        if self._n_classes > 2:
            self._other_params["num_class"] = self._n_classes
        return super().fit(X, y, **kwargs)

    def _transform_label(self, y):
        return np.asarray([self._label_map[v] for v in y], np.float32)

    def predict(self, X, raw_score=False, num_iteration=None, device=None,
                **kwargs):
        proba = self.predict_proba(X, raw_score=raw_score,
                                   num_iteration=num_iteration,
                                   device=device, **kwargs)
        if raw_score or kwargs.get("pred_leaf") or kwargs.get("pred_contrib"):
            return proba
        if proba.ndim > 1:
            return self._classes[np.argmax(proba, axis=1)]
        return self._classes[(proba > 0.5).astype(int)]

    def predict_proba(self, X, raw_score=False, num_iteration=None,
                      device=None, **kwargs):
        out = super().predict(X, raw_score=raw_score,
                              num_iteration=num_iteration, device=device,
                              **kwargs)
        if raw_score or kwargs.get("pred_leaf") or kwargs.get("pred_contrib"):
            return out
        if out.ndim == 1:
            return np.stack([1.0 - out, out], axis=1)
        return out

    @property
    def classes_(self):
        return self._classes

    @property
    def n_classes_(self):
        return self._n_classes


class LGBMRanker(LGBMModel):
    _estimator_type = "ranker"

    def _default_objective(self):
        return "lambdarank"

    def fit(self, X, y, group=None, **kwargs):
        if group is None:
            raise ValueError("LGBMRanker.fit requires group")
        return super().fit(X, y, group=group, **kwargs)


class _ObjectiveFunctionWrapper:
    """Adapts sklearn-style fobj(y_true, y_pred) -> (grad, hess) to the
    engine's fobj(score, dataset) (reference sklearn.py:28-96)."""

    def __init__(self, func: Callable):
        self.func = func

    def __call__(self, score, dataset):
        label = np.asarray(dataset.get_label() if hasattr(dataset, "get_label")
                           else dataset.metadata.label)
        return self.func(label, score)


def _to_feval(eval_metric):
    if callable(eval_metric):
        def feval(score, dataset):
            label = np.asarray(dataset.get_label()
                               if hasattr(dataset, "get_label")
                               else dataset.metadata.label)
            res = eval_metric(label, score)
            return res
        return feval
    return None
