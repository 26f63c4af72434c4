"""Training callbacks (reference python-package/lightgbm/callback.py:49-215):
print_evaluation, record_evaluation, reset_parameter, early_stopping, and
the JAX package's telemetry callback.

Copied from the JAX package's ``callback.py`` (which imports no JAX);
early stopping keeps its state on the booster as the JAX package's
training loop does, so that snapshots carry it.
"""
from __future__ import annotations

import collections
from typing import Callable, Dict, Optional

from .utils.log import log_info


class EarlyStopException(Exception):
    """``stalled``: the ``"<set>:<metric>"`` key that stopped the run
    (None when the run reached its last round)."""

    def __init__(self, best_iteration, best_score, stalled=None):
        super().__init__()
        self.best_iteration = best_iteration
        self.best_score = best_score
        self.stalled = stalled


CallbackEnv = collections.namedtuple(
    "CallbackEnv",
    ["model", "params", "iteration", "begin_iteration", "end_iteration",
     "evaluation_result_list"])


def print_evaluation(period: int = 1, show_stdv: bool = True) -> Callable:
    def _callback(env: CallbackEnv) -> None:
        if period > 0 and env.evaluation_result_list \
                and (env.iteration + 1) % period == 0:
            result = "\t".join(
                f"{name}'s {metric}: {val:g}"
                for name, metric, val, _ in env.evaluation_result_list)
            log_info(f"[{env.iteration + 1}]\t{result}")
    _callback.order = 10
    return _callback


def record_evaluation(eval_result: Dict) -> Callable:
    if not isinstance(eval_result, dict):
        raise TypeError("eval_result should be a dict")
    eval_result.clear()

    def _callback(env: CallbackEnv) -> None:
        for name, metric, val, _ in env.evaluation_result_list:
            eval_result.setdefault(name, collections.OrderedDict())
            eval_result[name].setdefault(metric, [])
            eval_result[name][metric].append(val)
    _callback.order = 20
    return _callback


def reset_parameter(**kwargs) -> Callable:
    """Reset parameters before each iteration (the JAX package's
    ``callback.py:50-69``): each value is a list as long as the run (the
    iteration's entry) or a function of the iteration (counted from the
    run's first).  A new ``learning_rate`` sets ``GBDT.shrinkage_rate``,
    which the iteration's trees and score update take; the other keys
    only update ``env.params``."""
    def _callback(env: CallbackEnv) -> None:
        i = env.iteration - env.begin_iteration
        new_params = {}
        for key, value in kwargs.items():
            if isinstance(value, list):
                if len(value) != env.end_iteration - env.begin_iteration:
                    raise ValueError(
                        f"length of list {key!r} must equal num_boost_round")
                new_params[key] = value[i]
            elif callable(value):
                new_params[key] = value(i)
        if "learning_rate" in new_params:
            env.model._gbdt.shrinkage_rate = new_params["learning_rate"]
        env.params.update(new_params)
    _callback.before_iteration = True
    _callback.order = 10
    return _callback


def telemetry(record: Optional[Dict] = None,
              trace_path: Optional[str] = None) -> Callable:
    """Per-iteration telemetry callback (the JAX package's, see
    ``obs/telemetry.py``): enables telemetry (streaming the JSONL trace
    to ``trace_path`` when given), emits a ``train:iteration`` event each
    round carrying the evaluation results, and keeps
    ``record["summary"]`` refreshed with the live run summary when
    ``record`` is given.  ``telemetry_output`` in the parameters (or
    ``LGBM_TPU_TRACE``) traces a run without a callback."""
    from . import obs
    obs.enable(trace_path=trace_path)

    def _callback(env: CallbackEnv) -> None:
        fields = {"it": env.iteration}
        for name, metric, val, _ in (env.evaluation_result_list or []):
            fields[f"{name}:{metric}"] = float(val)
        obs.event("train", "iteration", **fields)
        if record is not None:
            record["summary"] = obs.summary()
    _callback.order = 25
    return _callback


def early_stopping(stopping_rounds: int, verbose: bool = True) -> Callable:
    """Stop when a valid metric has not improved for ``stopping_rounds``
    rounds (reference ``callback.py:142-215``; the rule of the JAX
    package's training loop, ``gbdt.py:_train``): after each iteration
    every valid metric updates its best, then the first metric (in the
    order they first appeared) that has stalled stops training at its
    best iteration; a run that reaches its last round ends at the first
    metric's best.  Training metrics never stop a run.

    The bookkeeping lives on the booster's ``GBDT`` as ``_es_state``,
    in the snapshot manifest's keys and units: ``best_scores`` and
    ``best_iter`` (the 1-based iteration) per ``"<set>:<metric>"`` key,
    and ``key_order``.  A snapshot carries it, so a resumed run stops
    where the uninterrupted one would, with the same best scores
    (``best_score``: each valid metric's best value)."""

    def _stop(state, key, stalled):
        if verbose:
            why = "Early stopping" if stalled else \
                "Did not meet early stopping"
            log_info(f"{why}, best iteration is:\n"
                     f"[{state['best_iter'][key]}]")
        best = [(*k.split(":", 1), v, None)
                for k, v in state["best_scores"].items()]
        raise EarlyStopException(state["best_iter"][key] - 1, best,
                                 key if stalled else None)

    def _callback(env: CallbackEnv) -> None:
        if not env.evaluation_result_list:
            raise ValueError(
                "For early stopping, at least one validation set is required")
        state = env.model._gbdt._es_state
        if verbose and not state["key_order"]:
            log_info(f"Training until validation scores don't improve for "
                     f"{stopping_rounds} rounds.")
        it = env.iteration + 1
        train_name = getattr(env.model, "_train_data_name", "training")
        for name, metric, val, higher_better in env.evaluation_result_list:
            if name in ("training", train_name):
                continue
            key = f"{name}:{metric}"
            if key not in state["key_order"]:
                state["key_order"].append(key)
            best = state["best_scores"].get(key)
            if best is None or (val > best if higher_better else val < best):
                state["best_scores"][key] = float(val)
                state["best_iter"][key] = it
        for key in state["key_order"]:
            if it - state["best_iter"][key] >= stopping_rounds:
                _stop(state, key, True)
        if env.iteration == env.end_iteration - 1 and state["key_order"]:
            _stop(state, state["key_order"][0], False)
    _callback.order = 30
    return _callback
