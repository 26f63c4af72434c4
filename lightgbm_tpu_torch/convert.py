"""Carry state across from the JAX package (numpy and text only).

* :func:`device_data_from_numpy` builds this package's ``DeviceData``
  from the arrays of a JAX-package ``BinnedDataset`` (its ``bins``) and
  its ``feature_meta_np`` dictionary, so both packages train on the same
  bins.
* :func:`booster_from_model_string` loads a model that the JAX package
  saved with ``save_model_to_string``; predictions then equal the JAX
  booster's on the same rows.
"""
from __future__ import annotations

import numpy as np

from .basic import Booster
from .io.device import DeviceData, device_data_from_arrays


def device_data_from_numpy(bins: np.ndarray, meta: dict,
                           device="cuda") -> DeviceData:
    return device_data_from_arrays(np.asarray(bins), meta, device)


def booster_from_model_string(text: str, device="cuda") -> Booster:
    return Booster(model_str=text, device=device)
