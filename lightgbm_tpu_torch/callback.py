"""Training callbacks (reference python-package/lightgbm/callback.py:49-215):
print_evaluation, record_evaluation, early_stopping.

Copied from the JAX package's ``callback.py`` (which imports no JAX).
"""
from __future__ import annotations

import collections
from typing import Callable, Dict, List

from .utils.log import log_info


class EarlyStopException(Exception):
    def __init__(self, best_iteration, best_score):
        super().__init__()
        self.best_iteration = best_iteration
        self.best_score = best_score


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


def early_stopping(stopping_rounds: int, verbose: bool = True) -> Callable:
    """Stop when no valid metric improves for `stopping_rounds` rounds
    (reference callback.py:142-215)."""
    best_score: List[float] = []
    best_iter: List[int] = []
    best_score_list: List = []
    cmp_op: List[Callable] = []

    def _init(env: CallbackEnv) -> None:
        if not env.evaluation_result_list:
            raise ValueError(
                "For early stopping, at least one validation set is required")
        if verbose:
            log_info(f"Training until validation scores don't improve for "
                     f"{stopping_rounds} rounds.")
        for name, metric, val, higher_better in env.evaluation_result_list:
            best_iter.append(0)
            best_score_list.append(None)
            if higher_better:
                best_score.append(float("-inf"))
                cmp_op.append(lambda x, y: x > y)
            else:
                best_score.append(float("inf"))
                cmp_op.append(lambda x, y: x < y)

    def _callback(env: CallbackEnv) -> None:
        if not best_score:
            _init(env)
        for i, (name, metric, val, _) in enumerate(env.evaluation_result_list):
            if best_score_list[i] is None or cmp_op[i](val, best_score[i]):
                best_score[i] = val
                best_iter[i] = env.iteration
                best_score_list[i] = env.evaluation_result_list
            train_name = getattr(env.model, "_train_data_name", "training")
            if name in ("training", train_name):
                continue        # train metric never triggers stopping
            if env.iteration - best_iter[i] >= stopping_rounds:
                if verbose:
                    log_info(f"Early stopping, best iteration is:\n"
                             f"[{best_iter[i] + 1}]")
                raise EarlyStopException(best_iter[i], best_score_list[i])
            if env.iteration == env.end_iteration - 1:
                if verbose:
                    log_info(f"Did not meet early stopping. Best iteration "
                             f"is: [{best_iter[i] + 1}]")
                raise EarlyStopException(best_iter[i], best_score_list[i])
    _callback.order = 30
    return _callback
