"""Objective functions (the slice's subset): binary logloss and L2.

Port of the JAX package's ``objective/objectives.py`` classes
``BinaryLogloss`` (reference ``binary_objective.hpp:13-157``) and
``RegressionL2`` (``regression_objective.hpp``), with labels and weights
as tensors on the training device.  Arithmetic follows the reference's
operation order.

A model loaded from text may name any objective of the JAX package:
:func:`load_objective` gives it the objective's output conversion
(:class:`OutputObjective`) even where the port cannot train it yet.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import Config, _canonical_objective


def _apply_weight(grad, hess, weight):
    if weight is None:
        return grad, hess
    return grad * weight, hess * weight


class ObjectiveFunction:
    """Base class (reference include/LightGBM/objective_function.h)."""
    name = "none"

    def __init__(self, config: Config):
        self.config = config
        self.label: Optional[torch.Tensor] = None
        self.weight: Optional[torch.Tensor] = None
        self.num_data = 0

    def init(self, metadata, num_data: int, device="cpu") -> None:
        self.num_data = num_data
        self._label_np = (np.asarray(metadata.label, np.float32)
                          if metadata.label is not None
                          else np.zeros(num_data, np.float32))
        self._weight_np = (np.asarray(metadata.weight, np.float32)
                           if metadata.weight is not None else None)
        self.label = torch.as_tensor(self._label_np, device=device)
        self.weight = (torch.as_tensor(self._weight_np, device=device)
                       if self._weight_np is not None else None)
        self._check_label()

    def _host_label_mean(self) -> float:
        y = self._label_np
        if self._weight_np is not None:
            w = self._weight_np
            return float((y * w).sum() / w.sum())
        return float(y.mean())

    def _check_label(self) -> None:
        pass

    def get_gradients(self, score: torch.Tensor):
        raise NotImplementedError

    def boost_from_score(self) -> float:
        return 0.0

    def convert_output(self, score: torch.Tensor) -> torch.Tensor:
        return score

    def to_string(self) -> str:
        return self.name


class RegressionL2(ObjectiveFunction):
    name = "regression"

    def __init__(self, config: Config):
        super().__init__(config)
        if config.reg_sqrt:
            raise NotImplementedError("reg_sqrt")

    def get_gradients(self, score):
        grad = score - self.label
        hess = torch.ones_like(score)
        return _apply_weight(grad, hess, self.weight)

    def boost_from_score(self):
        return self._host_label_mean()


class BinaryLogloss(ObjectiveFunction):
    name = "binary"

    def __init__(self, config: Config):
        super().__init__(config)
        self.sigmoid = float(config.sigmoid)
        self.is_unbalance = bool(config.is_unbalance)
        self.scale_pos_weight = float(config.scale_pos_weight)
        self.label_weights = (1.0, 1.0)

    def _check_label(self):
        u = np.unique(self._label_np)
        if not np.all(np.isin(u, [0.0, 1.0])):
            raise ValueError("binary objective requires labels in {0, 1}")

    def init(self, metadata, num_data, device="cpu"):
        super().init(metadata, num_data, device)
        cnt_pos = float((self._label_np > 0).sum())
        cnt_neg = float(num_data - cnt_pos)
        if self.is_unbalance and cnt_pos > 0 and cnt_neg > 0:
            if cnt_pos > cnt_neg:
                self.label_weights = (1.0, cnt_pos / cnt_neg)
            else:
                self.label_weights = (cnt_neg / cnt_pos, 1.0)
        else:
            self.label_weights = (1.0, self.scale_pos_weight)

    def get_gradients(self, score):
        y = self.label
        p = torch.sigmoid(self.sigmoid * score)
        w_cls = torch.where(
            y > 0, torch.tensor(self.label_weights[1], dtype=torch.float32,
                                device=y.device),
            torch.tensor(self.label_weights[0], dtype=torch.float32,
                         device=y.device))
        grad = self.sigmoid * (p - y) * w_cls
        hess = self.sigmoid * self.sigmoid * p * (1.0 - p) * w_cls
        return _apply_weight(grad, hess, self.weight)

    def boost_from_score(self):
        pavg = min(max(self._host_label_mean(), 1e-15), 1.0 - 1e-15)
        return float(np.log(pavg / (1.0 - pavg)) / self.sigmoid)

    def convert_output(self, score):
        return torch.sigmoid(self.sigmoid * score)

    def to_string(self):
        return f"binary sigmoid:{self.sigmoid}"


OBJECTIVES = {"regression": RegressionL2, "binary": BinaryLogloss}


def create_objective(config: Config) -> Optional[ObjectiveFunction]:
    """Factory (reference objective_function.cpp:10-47) for the objectives
    this package implements."""
    if config.objective == "none":
        return None
    cls = OBJECTIVES.get(config.objective)
    if cls is None:
        raise NotImplementedError(
            f"objective {config.objective!r} is not ported to "
            f"lightgbm_tpu_torch yet (have: {sorted(OBJECTIVES)})")
    return cls(config)


# output conversion of each objective the JAX package names
# (lightgbm_tpu/objective/objectives.py convert_output)
_IDENTITY = ("regression", "regression_l1", "huber", "fair", "quantile",
             "mape", "lambdarank")
_EXP = ("poisson", "gamma", "tweedie")


class OutputObjective(ObjectiveFunction):
    """The output conversion of a loaded model's objective, for the
    objectives the port cannot train (training with them raises in
    :func:`create_objective`).  ``to_string`` gives back the model
    file's objective line."""

    def __init__(self, name: str, text: str, sigmoid: float = 1.0,
                 sqrt: bool = False):
        super().__init__(Config())
        self.name = name
        self.text = text
        self.sigmoid = float(sigmoid)
        self.sqrt = bool(sqrt)

    def get_gradients(self, score):
        raise NotImplementedError(
            f"objective {self.name!r} is not ported to lightgbm_tpu_torch "
            f"for training yet (ROADMAP A5): a loaded model predicts only")

    def convert_output(self, score):
        n = self.name
        if n == "regression" and self.sqrt:
            return torch.sign(score) * score * score
        if n in _IDENTITY:
            return score
        if n in _EXP:
            return torch.exp(score)
        if n in ("binary", "multiclassova"):
            return torch.sigmoid(self.sigmoid * score)
        if n == "multiclass":
            return torch.softmax(score, dim=-1)
        if n == "xentropy":
            return torch.sigmoid(score)
        return 1.0 - torch.exp(-torch.exp(score))      # xentlambda

    def to_string(self):
        return self.text


def load_objective(text: str) -> Optional[ObjectiveFunction]:
    """The objective of a model file's ``objective=`` line (for example
    ``binary sigmoid:1``, ``multiclass num_class:3`` or ``regression
    sqrt``): the trainable objective where the port has it, else its
    :class:`OutputObjective`; ``None`` for a custom objective (raw
    scores).  A name the port cannot resolve raises
    ``NotImplementedError``."""
    tokens = text.split()
    try:
        name = _canonical_objective(tokens[0] if tokens else "")
    except ValueError:
        raise NotImplementedError(
            f"model objective {text!r} is not known to "
            f"lightgbm_tpu_torch: its output conversion cannot be "
            f"applied") from None
    if name == "none":
        return None
    params = dict(t.split(":", 1) for t in tokens[1:] if ":" in t)
    sigmoid = float(params.get("sigmoid", 1.0))
    sqrt = "sqrt" in tokens[1:]
    if name == "binary":
        return BinaryLogloss(Config.from_params({"sigmoid": sigmoid}))
    if name == "regression" and not sqrt:
        return RegressionL2(Config())
    return OutputObjective(name, text, sigmoid=sigmoid, sqrt=sqrt)
