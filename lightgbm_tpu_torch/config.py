"""Configuration system for lightgbm_tpu_torch (a copy of the JAX
package's ``config.py``, which imports no JAX).

Re-design of the reference config layer
(reference `include/LightGBM/config.h:47-525`, `src/io/config.cpp`):
the reference holds KV strings parsed into nested typed structs
(IOConfig/ObjectiveConfig/MetricConfig/TreeConfig/BoostingConfig/NetworkConfig
inside OverallConfig).  Here a single flat dataclass `Config` carries every
hyper-parameter; `ParameterAlias`-style canonicalisation
(`config.h:364-525`) is reproduced in `ALIAS_TABLE` / `canonicalize_params`.

The JAX package's mesh extensions (`mesh_shape`, `data_axis_name`,
`feature_axis_name`, `hist_dtype`) are kept as accepted keys so the two
packages read the same parameter dictionaries.  This package runs one
process per rank (`parallel/mesh.py`): a 1-D `mesh_shape` must equal the
process group's world size, and a 2-D (data x feature) one raises
(`boosting/gbdt.py:check_unported_options`, ROADMAP A11's remainder).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from .utils.log import log_warning

# ---------------------------------------------------------------------------
# Alias table — parity with reference config.h:364-455 (plus sklearn-era extras)
# ---------------------------------------------------------------------------
ALIAS_TABLE: Dict[str, str] = {
    "config": "config_file",
    "nthread": "num_threads",
    "num_thread": "num_threads",
    "random_seed": "seed",
    "random_state": "seed",
    "boosting": "boosting_type",
    "boost": "boosting_type",
    "application": "objective",
    "app": "objective",
    "train_data": "data",
    "train": "data",
    "model_output": "output_model",
    "model_out": "output_model",
    "model_input": "input_model",
    "model_in": "input_model",
    "predict_result": "output_result",
    "prediction_result": "output_result",
    "valid": "valid_data",
    "test_data": "valid_data",
    "test": "valid_data",
    "is_sparse": "is_enable_sparse",
    "enable_sparse": "is_enable_sparse",
    "pre_partition": "is_pre_partition",
    "training_metric": "is_training_metric",
    "train_metric": "is_training_metric",
    "ndcg_at": "ndcg_eval_at",
    "eval_at": "ndcg_eval_at",
    "min_data_per_leaf": "min_data_in_leaf",
    "min_data": "min_data_in_leaf",
    "min_child_samples": "min_data_in_leaf",
    "min_sum_hessian_per_leaf": "min_sum_hessian_in_leaf",
    "min_sum_hessian": "min_sum_hessian_in_leaf",
    "min_hessian": "min_sum_hessian_in_leaf",
    "min_child_weight": "min_sum_hessian_in_leaf",
    "num_leaf": "num_leaves",
    "sub_feature": "feature_fraction",
    "colsample_bytree": "feature_fraction",
    "num_iteration": "num_iterations",
    "num_tree": "num_iterations",
    "num_round": "num_iterations",
    "num_trees": "num_iterations",
    "num_rounds": "num_iterations",
    "num_boost_round": "num_iterations",
    "n_estimators": "num_iterations",
    "sub_row": "bagging_fraction",
    "subsample": "bagging_fraction",
    "subsample_freq": "bagging_freq",
    "shrinkage_rate": "learning_rate",
    "tree": "tree_learner",
    "num_machine": "num_machines",
    "local_port": "local_listen_port",
    "two_round_loading": "use_two_round_loading",
    "two_round": "use_two_round_loading",
    "mlist": "machine_list_file",
    "machine_list_filename": "machine_list_file",
    "is_save_binary": "is_save_binary_file",
    "save_binary": "is_save_binary_file",
    "early_stopping_rounds": "early_stopping_round",
    "early_stopping": "early_stopping_round",
    "verbosity": "verbose",
    "header": "has_header",
    "label": "label_column",
    "weight": "weight_column",
    "group": "group_column",
    "query": "group_column",
    "query_column": "group_column",
    "ignore_feature": "ignore_column",
    "blacklist": "ignore_column",
    "categorical_feature": "categorical_column",
    "cat_column": "categorical_column",
    "cat_feature": "categorical_column",
    "predict_raw_score": "is_predict_raw_score",
    "raw_score": "is_predict_raw_score",
    "leaf_index": "is_predict_leaf_index",
    "predict_leaf_index": "is_predict_leaf_index",
    "contrib": "is_predict_contrib",
    "predict_contrib": "is_predict_contrib",
    "min_split_gain": "min_gain_to_split",
    "topk": "top_k",
    "reg_alpha": "lambda_l1",
    "reg_lambda": "lambda_l2",
    "num_classes": "num_class",
    "unbalanced_sets": "is_unbalance",
    "bagging_fraction_seed": "bagging_seed",
    "workers": "machines",
    "nodes": "machines",
    "subsample_for_bin": "bin_construct_sample_cnt",
    "metric_freq": "output_freq",
    "resume": "resume_from",
    "snapshot_keep_cnt": "snapshot_keep",
}

# Known canonical parameter names (reference config.h:456-492 parameter_set),
# plus the JAX package's extensions.
PARAMETER_SET = frozenset({
    "config_file", "task", "device", "num_threads", "seed", "boosting_type",
    "objective", "data", "output_model", "input_model", "output_result",
    "valid_data", "is_enable_sparse", "is_pre_partition", "is_training_metric",
    "ndcg_eval_at", "min_data_in_leaf", "min_sum_hessian_in_leaf", "num_leaves",
    "feature_fraction", "num_iterations", "bagging_fraction", "bagging_freq",
    "learning_rate", "tree_learner", "num_machines", "local_listen_port",
    "use_two_round_loading", "machine_list_file", "is_save_binary_file",
    "early_stopping_round", "verbose", "has_header", "label_column",
    "weight_column", "group_column", "ignore_column", "categorical_column",
    "is_predict_raw_score", "is_predict_leaf_index", "is_predict_contrib",
    "min_gain_to_split", "top_k", "lambda_l1", "lambda_l2", "num_class",
    "is_unbalance", "max_depth", "max_bin", "bagging_seed", "drop_rate",
    "skip_drop", "max_drop", "uniform_drop", "xgboost_dart_mode", "drop_seed",
    "top_rate", "other_rate", "min_data_in_bin", "data_random_seed",
    "bin_construct_sample_cnt", "num_iteration_predict", "pred_early_stop",
    "pred_early_stop_freq", "pred_early_stop_margin", "use_missing", "sigmoid",
    "fair_c", "poisson_max_delta_step", "poission_max_delta_step",
    "scale_pos_weight", "boost_from_average", "max_position", "label_gain",
    "metric", "output_freq", "time_out", "gpu_platform_id", "gpu_device_id",
    "gpu_use_dp", "convert_model", "convert_model_language",
    "feature_fraction_seed", "enable_bundle", "data_filename",
    "valid_data_filenames", "snapshot_freq", "snapshot_keep",
    "resume_from", "sparse_threshold", "telemetry_output",
    "enable_load_from_binary_file", "max_conflict_rate", "histogram_pool_size",
    "is_provide_training_metric", "machines", "zero_as_missing",
    "init_score_file", "valid_init_score_file", "max_cat_threshold",
    "cat_smooth", "min_data_per_group", "cat_l2", "max_cat_to_onehot",
    "alpha", "reg_sqrt", "tweedie_variance_power",
    # fork additions (run_mode/yarn rendezvous, HDFS ingest - config.h:275-281)
    "run_mode", "application_master_address", "local_ip_prefix", "local_ip",
    "name_node", "username",
    # the JAX package's extensions
    "mesh_shape", "data_axis_name", "feature_axis_name", "hist_dtype",
    "growth_mode", "deterministic", "hist_mode",
    # commonly passed by the python layer
    "categorical_feature", "feature_name", "objective_seed", "metric_seed",
})

_TRUE_SET = {"true", "+", "1", "yes", "y", "t", "on"}
_FALSE_SET = {"false", "-", "0", "no", "n", "f", "off"}


def canonicalize_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """Resolve aliases to canonical names, mirroring
    ``ParameterAlias::KeyAliasTransform`` (reference ``config.h:364-525``).

    When both an alias and the canonical key appear, the canonical key wins;
    among multiple aliases the longest (then lexicographically larger) name
    wins, matching the reference's reproducible-priority rule.
    """
    out: Dict[str, Any] = {}
    alias_src: Dict[str, str] = {}
    for key in sorted(params.keys(), key=lambda k: (len(k), k)):
        value = params[key]
        canonical = ALIAS_TABLE.get(key, key)
        if canonical != key:
            if canonical in params:
                log_warning(
                    f"{canonical} is set, {key}={value!r} will be ignored.")
                continue
            if canonical in out:
                log_warning(
                    f"{canonical} is set with {alias_src[canonical]}, "
                    f"overridden by {key}={value!r}.")
            alias_src[canonical] = key
            out[canonical] = value
        else:
            if key not in PARAMETER_SET:
                log_warning(f"Unknown parameter: {key}")
            out[key] = value
    return out


def param_bool(value: Any) -> bool:
    if isinstance(value, bool):
        return value
    if isinstance(value, (int, float)):
        return bool(value)
    s = str(value).strip().lower()
    if s in _TRUE_SET:
        return True
    if s in _FALSE_SET:
        return False
    raise ValueError(f"cannot parse boolean parameter value {value!r}")


def _parse_int_list(value: Any) -> List[int]:
    if value is None:
        return []
    if isinstance(value, (list, tuple)):
        return [int(v) for v in value]
    return [int(v) for v in str(value).replace(";", ",").split(",") if v != ""]


def _parse_float_list(value: Any) -> List[float]:
    if value is None:
        return []
    if isinstance(value, (list, tuple)):
        return [float(v) for v in value]
    return [float(v) for v in str(value).replace(";", ",").split(",") if v != ""]


def _parse_str_list(value: Any) -> List[str]:
    if value is None:
        return []
    if isinstance(value, (list, tuple)):
        return [str(v) for v in value]
    return [s for s in str(value).replace(";", ",").split(",") if s != ""]


@dataclass
class Config:
    """All hyper-parameters, flattened (reference: OverallConfig, config.h:286-306)."""

    # --- task / device ------------------------------------------------------
    task: str = "train"                      # train|predict|convert_model|refit
    device: str = "cuda"                     # cuda|cpu: where tensors live
    seed: int = 0
    num_threads: int = 0
    verbose: int = 1
    deterministic: bool = True

    # --- boosting -----------------------------------------------------------
    boosting_type: str = "gbdt"              # gbdt|dart|goss|rf
    num_iterations: int = 100
    learning_rate: float = 0.1
    num_class: int = 1
    is_unbalance: bool = False
    scale_pos_weight: float = 1.0
    sigmoid: float = 1.0
    boost_from_average: bool = True
    early_stopping_round: int = 0
    output_freq: int = 1
    is_training_metric: bool = False
    snapshot_freq: int = -1
    # fault tolerance: retain the newest K snapshots (current + a
    # fallback in case a crash tears the current one mid-write), and an
    # optional snapshot to resume a preempted run from ("auto" =
    # newest valid snapshot under the output_model prefix)
    snapshot_keep: int = 2
    resume_from: str = ""
    # observability: stream the telemetry JSONL trace to this path
    # (accepted for parity with the JAX package; unused here)
    telemetry_output: str = ""

    # dart
    drop_rate: float = 0.1
    max_drop: int = 50
    skip_drop: float = 0.5
    xgboost_dart_mode: bool = False
    uniform_drop: bool = False
    drop_seed: int = 4

    # goss
    top_rate: float = 0.2
    other_rate: float = 0.1

    # --- objective ----------------------------------------------------------
    objective: str = "regression"
    alpha: float = 0.9                       # huber / quantile
    fair_c: float = 1.0
    poisson_max_delta_step: float = 0.7
    tweedie_variance_power: float = 1.5
    reg_sqrt: bool = False
    label_gain: Tuple[float, ...] = ()
    max_position: int = 20
    num_iteration_predict: int = -1
    pred_early_stop: bool = False
    pred_early_stop_freq: int = 10
    pred_early_stop_margin: float = 10.0

    # --- metric -------------------------------------------------------------
    metric: Tuple[str, ...] = ()
    ndcg_eval_at: Tuple[int, ...] = (1, 2, 3, 4, 5)

    # --- tree ---------------------------------------------------------------
    tree_learner: str = "serial"             # serial|feature|data|voting
    num_leaves: int = 31
    max_depth: int = -1
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_gain_to_split: float = 0.0
    feature_fraction: float = 1.0
    feature_fraction_seed: int = 2
    bagging_fraction: float = 1.0
    bagging_freq: int = 0
    bagging_seed: int = 3
    top_k: int = 20                          # voting parallel
    max_cat_threshold: int = 32
    cat_smooth: float = 10.0
    cat_l2: float = 10.0
    max_cat_to_onehot: int = 4
    min_data_per_group: int = 100
    histogram_pool_size: float = -1.0
    growth_mode: str = "wave"                # wave | leafwise (reference-exact)
    # histogram value mode (the analog of the reference's gpu_use_dp,
    # docs/GPU-Performance.rst:135-161): "" = the int8h default (see
    # learner/serial.py default_hist_mode).  This package implements the
    # quantized modes (int8, int8h, int8hh); the float modes raise.
    hist_mode: str = ""

    # --- io / dataset -------------------------------------------------------
    max_bin: int = 255
    min_data_in_bin: int = 3
    bin_construct_sample_cnt: int = 200000
    data_random_seed: int = 1
    use_missing: bool = True
    zero_as_missing: bool = False
    enable_bundle: bool = True
    max_conflict_rate: float = 0.0
    is_enable_sparse: bool = True
    sparse_threshold: float = 0.8
    enable_load_from_binary_file: bool = True
    is_save_binary_file: bool = False
    use_two_round_loading: bool = False
    is_pre_partition: bool = False
    has_header: bool = False
    label_column: str = ""
    weight_column: str = ""
    group_column: str = ""
    ignore_column: str = ""
    categorical_column: str = ""
    data: str = ""
    valid_data: Tuple[str, ...] = ()
    input_model: str = ""
    output_model: str = "LightGBM_model.txt"
    output_result: str = "LightGBM_predict_result.txt"
    init_score_file: str = ""
    valid_init_score_file: Tuple[str, ...] = ()
    is_predict_raw_score: bool = False
    is_predict_leaf_index: bool = False
    is_predict_contrib: bool = False
    convert_model: str = "gbdt_prediction.cpp"
    convert_model_language: str = ""

    # --- network / distributed ---------------------------------------------
    num_machines: int = 1
    local_listen_port: int = 12400
    time_out: int = 120
    machine_list_file: str = ""
    machines: str = ""
    run_mode: str = ""
    application_master_address: str = ""

    # --- mesh keys of the JAX package (accepted, unused here) --------------
    mesh_shape: Tuple[int, ...] = ()          # () == all local devices on one axis
    data_axis_name: str = "data"
    feature_axis_name: str = "feature"
    hist_dtype: str = "float32"

    # free-form extras kept for round-tripping
    extra: Dict[str, Any] = field(default_factory=dict)

    # -----------------------------------------------------------------------
    @classmethod
    def from_params(cls, params: Optional[Dict[str, Any]]) -> "Config":
        params = canonicalize_params(dict(params or {}))
        cfg = cls()
        cfg.update(params)
        cfg.check()
        return cfg

    def update(self, params: Dict[str, Any]) -> None:
        fields = {f.name: f for f in dataclasses.fields(self)}
        for key, value in params.items():
            if key == "poission_max_delta_step":   # reference typo kept as alias
                key = "poisson_max_delta_step"
            if key == "objective" and callable(value):
                # custom objective function: trained via fobj, like the
                # reference's objective=None + custom gradients path
                self.extra["fobj"] = value
                self.objective = "none"
                continue
            if key not in fields:
                self.extra[key] = value
                continue
            f = fields[key]
            try:
                if f.type in ("bool", bool):
                    value = param_bool(value)
                elif f.type in ("int", int):
                    value = int(value)
                elif f.type in ("float", float):
                    value = float(value)
                elif key in ("metric", "valid_data", "valid_init_score_file"):
                    value = tuple(_parse_str_list(value))
                elif key == "ndcg_eval_at":
                    value = tuple(_parse_int_list(value))
                elif key == "label_gain":
                    value = tuple(_parse_float_list(value))
                elif key == "mesh_shape":
                    value = tuple(_parse_int_list(value))
                elif f.type in ("str", str):
                    value = str(value)
            except (TypeError, ValueError) as exc:
                raise ValueError(f"bad value for parameter {key}: {value!r}") from exc
            setattr(self, key, value)
        # objective aliases (reference objective factory names)
        self.objective = _canonical_objective(self.objective)
        self.boosting_type = _canonical_boosting(self.boosting_type)

    def check(self) -> None:
        """Parameter conflict checks (reference ``OverallConfig::CheckParamConflict``)."""
        if self.num_leaves < 2:
            raise ValueError("num_leaves must be >= 2")
        if self.max_bin < 2:
            raise ValueError("max_bin must be >= 2")
        if not (0.0 < self.feature_fraction <= 1.0):
            raise ValueError("feature_fraction must be in (0, 1]")
        if not (0.0 < self.bagging_fraction <= 1.0):
            raise ValueError("bagging_fraction must be in (0, 1]")
        if self.boosting_type == "goss" and self.top_rate + self.other_rate > 1.0:
            raise ValueError("goss requires top_rate + other_rate <= 1")
        if self.boosting_type == "rf":
            if not (self.bagging_freq > 0 and self.bagging_fraction < 1.0):
                raise ValueError(
                    "random forest needs bagging_freq > 0 and bagging_fraction < 1")
        if self.objective in ("multiclass", "multiclassova") and self.num_class < 2:
            raise ValueError("num_class must be >= 2 for multiclass objectives")
        if self.objective not in ("multiclass", "multiclassova") and self.num_class != 1:
            raise ValueError("num_class must be 1 for non-multiclass objectives")
        if self.tree_learner not in ("serial", "feature", "data", "voting"):
            raise ValueError(f"unknown tree_learner {self.tree_learner!r}")
        if self.growth_mode not in ("wave", "leafwise"):
            raise ValueError(f"unknown growth_mode {self.growth_mode!r}")
        if self.hist_mode not in ("", "bf16", "ghilo", "hhilo", "hilo",
                                  "int8", "int8h", "int8hh"):
            raise ValueError(f"unknown hist_mode {self.hist_mode!r}")
        # gpu_use_dp is the reference's GPU double-precision knob
        # (docs/GPU-Performance.rst): honor it as "use the high-precision
        # histogram mode" unless hist_mode was given explicitly
        if not self.hist_mode and self.extra.get("gpu_use_dp") in (
                True, "true", "1", 1):
            self.hist_mode = "hilo"
        # accepted-but-inert knobs must warn loudly, not silently no-op
        if self.extra.get("gpu_platform_id") is not None or \
                self.extra.get("gpu_device_id") is not None:
            log_warning("gpu_platform_id/gpu_device_id have no effect: "
                        "pass device='cuda:<i>' to train instead")

    @property
    def is_parallel(self) -> bool:
        return self.tree_learner != "serial" or self.num_machines > 1

    @property
    def num_tree_per_iteration(self) -> int:
        if self.objective in ("multiclass", "multiclassova"):
            return self.num_class
        return 1

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d.pop("extra", None)
        return d


_OBJECTIVE_ALIASES = {
    "regression": "regression",
    "regression_l2": "regression",
    "mean_squared_error": "regression",
    "mse": "regression",
    "l2": "regression",
    "l2_root": "regression",
    "root_mean_squared_error": "regression",
    "rmse": "regression",
    "regression_l1": "regression_l1",
    "mean_absolute_error": "regression_l1",
    "mae": "regression_l1",
    "l1": "regression_l1",
    "huber": "huber",
    "fair": "fair",
    "poisson": "poisson",
    "quantile": "quantile",
    "mape": "mape",
    "mean_absolute_percentage_error": "mape",
    "gamma": "gamma",
    "tweedie": "tweedie",
    "binary": "binary",
    "multiclass": "multiclass",
    "softmax": "multiclass",
    "multiclassova": "multiclassova",
    "multiclass_ova": "multiclassova",
    "ova": "multiclassova",
    "ovr": "multiclassova",
    "lambdarank": "lambdarank",
    "xentropy": "xentropy",
    "cross_entropy": "xentropy",
    "xentlambda": "xentlambda",
    "cross_entropy_lambda": "xentlambda",
    "none": "none",
    "null": "none",
    "custom": "none",
    "": "none",
}

_BOOSTING_ALIASES = {
    "gbdt": "gbdt", "gbrt": "gbdt",
    "dart": "dart",
    "goss": "goss",
    "rf": "rf", "random_forest": "rf",
}


def _canonical_objective(name: str) -> str:
    key = str(name).strip().lower()
    if key.startswith("l2_root") or key == "rmse":
        return "regression"
    if key not in _OBJECTIVE_ALIASES:
        raise ValueError(f"unknown objective {name!r}")
    return _OBJECTIVE_ALIASES[key]


def _canonical_boosting(name: str) -> str:
    key = str(name).strip().lower()
    if key not in _BOOSTING_ALIASES:
        raise ValueError(f"unknown boosting type {name!r}")
    return _BOOSTING_ALIASES[key]
