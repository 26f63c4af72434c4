"""``train`` — the reference's training entry point (the slice's subset:
no validation sets, callbacks or early stopping)."""
from __future__ import annotations

from typing import Any, Dict

from .basic import Booster, Dataset
from .config import canonicalize_params
from .utils.log import log_info


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100, device=None) -> Booster:
    """Train one model on ``device`` (default: the ``device`` parameter,
    ``cuda`` unless set).  ``num_iterations`` in ``params`` overrides
    ``num_boost_round``, as in the reference."""
    params = canonicalize_params(dict(params or {}))
    if "num_iterations" in params:
        num_boost_round = int(params["num_iterations"])
    params["num_iterations"] = num_boost_round
    if params.get("valid_data") or params.get("early_stopping_round"):
        raise NotImplementedError(
            "validation sets and early stopping are not ported to "
            "lightgbm_tpu_torch yet")
    booster = Booster(params=params, train_set=train_set, device=device)
    for it in range(num_boost_round):
        if booster.update():
            log_info(f"training stopped at iteration {it + 1}: no further "
                     f"splits possible")
            break
    return booster
