"""``train`` — the reference's training entry point
(``python-package/lightgbm/engine.py:18``), on the JAX package's
per-iteration loop (its ``engine.py:61-200``): validation sets,
evaluation records, early stopping, callbacks, snapshots every
``snapshot_freq`` iterations and resume from them.  The JAX package's
fused-window fast path builds the same model and is not ported.
``predict`` — the module-level prediction entry point."""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

from . import callback as callback_mod
from .basic import Booster, Dataset
from .config import canonicalize_params
from .utils.log import log_info


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100,
          valid_sets: Optional[Sequence[Dataset]] = None,
          valid_names: Optional[Sequence[str]] = None,
          early_stopping_rounds: Optional[int] = None,
          evals_result: Optional[Dict] = None,
          verbose_eval=True, callbacks: Optional[Sequence] = None,
          device=None, categorical_feature="auto",
          resume_from: Optional[str] = None) -> Booster:
    """Train one model on ``device`` (default: the ``device`` parameter,
    ``cuda`` unless set).  ``num_iterations`` in ``params`` overrides
    ``num_boost_round`` and ``early_stopping_round`` sets
    ``early_stopping_rounds``, as in the reference.  With early stopping
    ``best_iteration`` is the 1-based iteration of the best score of the
    first valid metric that stopped; ``predict`` uses it by default.
    ``categorical_feature`` other than ``"auto"`` overrides the training
    set's (indices or column names).

    ``snapshot_freq > 0`` writes an atomic snapshot under the
    ``output_model`` prefix every that many iterations, after the
    iteration's callbacks ran (``boosting/snapshot.py``; the newest
    ``snapshot_keep`` are kept).  ``resume_from`` (or the parameter of
    that name) restores a run from its latest valid snapshot: a
    snapshot or manifest path, an ``output_model`` prefix, a directory,
    or ``"auto"``/``"latest"`` for this run's ``output_model`` prefix.
    The valid sets attach first, and training continues from the
    restored iteration toward ``num_boost_round`` in total, bit for bit
    where the snapshot carries its score state."""
    params = canonicalize_params(dict(params or {}))
    if resume_from is None and params.get("resume_from"):
        resume_from = str(params["resume_from"])
    if "num_iterations" in params:
        num_boost_round = int(params["num_iterations"])
    params["num_iterations"] = num_boost_round
    if early_stopping_rounds is None and params.get("early_stopping_round"):
        early_stopping_rounds = int(params["early_stopping_round"])
    params.pop("early_stopping_round", None)
    if params.get("valid_data"):
        raise NotImplementedError(
            "valid_data files are not ported to lightgbm_tpu_torch yet: "
            "pass Dataset objects as valid_sets")

    if categorical_feature != "auto":
        train_set.categorical_feature = categorical_feature
    booster = Booster(params=params, train_set=train_set, device=device)
    valid_names = list(valid_names or [])
    for i, vs in enumerate(valid_sets or []):
        name = valid_names[i] if i < len(valid_names) else f"valid_{i}"
        if vs is train_set:
            # the train set in valid_sets means "report training metrics
            # under this name"
            booster._train_data_name = name
            params["is_training_metric"] = True
            continue
        booster.add_valid(vs, name)

    gbdt = booster._gbdt
    if resume_from:
        target = resume_from
        if target in ("auto", "latest"):
            target = gbdt.config.output_model
        gbdt.resume_from_snapshot(target)
        booster._serve_cache = {}
    start_iter = gbdt.iter if resume_from else 0
    snapshot_freq = gbdt.config.snapshot_freq

    cbs = list(callbacks or [])
    if verbose_eval is True:
        cbs.append(callback_mod.print_evaluation())
    elif isinstance(verbose_eval, int) and verbose_eval > 1:
        cbs.append(callback_mod.print_evaluation(verbose_eval))
    if early_stopping_rounds is not None and early_stopping_rounds > 0:
        if not gbdt.valid_sets:
            raise ValueError("For early stopping, at least one validation "
                             "set is required")
        cbs.append(callback_mod.early_stopping(
            early_stopping_rounds, verbose=bool(verbose_eval)))
    if evals_result is not None:
        cbs.append(callback_mod.record_evaluation(evals_result))
    cbs_before = sorted(
        (cb for cb in cbs if getattr(cb, "before_iteration", False)),
        key=lambda cb: getattr(cb, "order", 0))
    cbs_after = sorted(
        (cb for cb in cbs if not getattr(cb, "before_iteration", False)),
        key=lambda cb: getattr(cb, "order", 0))
    train_metric = bool(params.get("is_training_metric"))

    for it in range(start_iter, num_boost_round):
        env = callback_mod.CallbackEnv(
            model=booster, params=params, iteration=it,
            begin_iteration=start_iter, end_iteration=num_boost_round,
            evaluation_result_list=None)
        for cb in cbs_before:
            cb(env)
        if booster.update():
            log_info(f"training stopped at iteration {it + 1}: no further "
                     f"splits possible")
            break
        results = []
        if train_metric:
            results.extend(booster.eval_train())
        results.extend(booster.eval_valid())
        env = env._replace(evaluation_result_list=results)
        try:
            for cb in cbs_after:
                cb(env)
        except callback_mod.EarlyStopException as e:
            booster.best_iteration = e.best_iteration + 1
            for name, metric, val, _ in (e.best_score or []):
                booster.best_score.setdefault(name, {})[metric] = val
            break
        if snapshot_freq > 0 and (it + 1) % snapshot_freq == 0:
            gbdt.save_snapshot(it + 1)
    if booster.best_iteration <= 0:
        booster.best_iteration = booster.current_iteration()
    return booster


def predict(model, data, num_iteration: int = -1, raw_score: bool = False,
            pred_leaf: bool = False, pred_contrib: bool = False,
            device=None):
    """Module-level prediction (the JAX package's ``engine.predict``):
    ``model`` is a :class:`Booster`, a model file path or a model string
    in the reference text format (the latter two are loaded onto the
    ``cuda`` device here, where ``Booster.predict`` then takes the
    compiled predictor); the other arguments are ``Booster.predict``'s.
    """
    if isinstance(model, Booster):
        bst = model
    elif isinstance(model, str):
        if "Tree=" in model or "\n" in model:
            bst = Booster(model_str=model)
        else:
            bst = Booster(model_file=model)
    else:
        raise TypeError(f"model must be a Booster, model file path, or "
                        f"model string, got {type(model).__name__}")
    return bst.predict(data, num_iteration=num_iteration,
                       raw_score=raw_score, pred_leaf=pred_leaf,
                       pred_contrib=pred_contrib, device=device)
