"""Python side of the C API (handle registry and raw-pointer marshalling).

The reference exposes its 51 ``LGBM_*`` functions from C++
(``src/c_api.cpp``, ``include/LightGBM/c_api.h:41-760``).  The port's
native shim (``capi/lightgbm_tpu_torch_c.cpp``) embeds a CPython
interpreter and calls THIS module with integer handles and raw buffer
addresses; every object's lifetime lives in the registry below.  The C
surface keeps the reference's names, call shapes and 0/-1 return
convention for the whole dataset / booster / network workflow, as the
JAX package's ``capi_bridge.py`` does; here the handles are the port's
``Dataset`` and ``Booster``.

Raw pointers arrive as ``int`` addresses and are wrapped zero-copy with
``ctypes`` + ``np.frombuffer``.  Sparse inputs (CSR/CSC) are densified at
the boundary: the core is a dense binned column store, so the sparse C
API calls exist for call-shape parity, not for memory parity.

Device: a Booster lives on the ``device`` its parameter string names
(``LGBM_BoosterCreate``); where a call takes no parameter string
(``LGBM_BoosterCreateFromModelfile``, ``LGBM_BoosterLoadModelFromString``,
``LGBM_NetworkInit``), or the string names none, on the device of the
``LGBM_TPU_TORCH_DEVICE`` environment variable, else on ``cuda``.  A
caller without a card asks for the CPU (``device=cpu``); without that
request the first use of the card fails and the call returns -1.
"""
from __future__ import annotations

import ctypes
import json
import os
from typing import Dict, List, Optional

import numpy as np

_handles: Dict[int, object] = {}
_next = [1]

# C_API_DTYPE_* (c_api.h:22-29)
_DTYPE_FLOAT32 = 0
_DTYPE_FLOAT64 = 1
_DTYPE_INT32 = 2
_DTYPE_INT64 = 3

_CTYPES = {
    _DTYPE_FLOAT32: (ctypes.c_float, np.float32),
    _DTYPE_FLOAT64: (ctypes.c_double, np.float64),
    _DTYPE_INT32: (ctypes.c_int32, np.int32),
    _DTYPE_INT64: (ctypes.c_int64, np.int64),
}

# C_API_PREDICT_* (c_api.h:31-36)
_PREDICT_NORMAL = 0
_PREDICT_RAW = 1
_PREDICT_LEAF = 2
_PREDICT_CONTRIB = 3


def _put(obj) -> int:
    h = _next[0]
    _next[0] += 1
    _handles[h] = obj
    return h


def _get(h: int):
    return _handles[int(h)]


def free_handle(h: int) -> None:
    _handles.pop(int(h), None)


def _wrap(ptr: int, n: int, dtype: int) -> np.ndarray:
    ct, npt = _CTYPES[int(dtype)]
    buf = (ct * n).from_address(int(ptr))
    return np.frombuffer(buf, dtype=npt, count=n)


def _wrap_f64(ptr: int, n: int) -> np.ndarray:
    return _wrap(ptr, n, _DTYPE_FLOAT64)


def _wrap_f32(ptr: int, n: int) -> np.ndarray:
    return _wrap(ptr, n, _DTYPE_FLOAT32)


def _wrap_mat(ptr: int, nrow: int, ncol: int, is_row_major: int,
              dtype: int = _DTYPE_FLOAT64) -> np.ndarray:
    X = _wrap(ptr, nrow * ncol, dtype)
    return (X.reshape(nrow, ncol) if is_row_major
            else X.reshape(ncol, nrow).T).astype(np.float64, copy=True)


def _csr_to_dense(indptr_ptr: int, indptr_type: int, indices_ptr: int,
                  data_ptr: int, data_type: int, nindptr: int,
                  nelem: int, num_col: int) -> np.ndarray:
    """CSR triplet buffers -> dense [nrow, ncol] f64
    (LGBM_DatasetCreateFromCSR shape, c_api.h:147-172)."""
    indptr = _wrap(indptr_ptr, nindptr, indptr_type).astype(np.int64)
    indices = _wrap(indices_ptr, nelem, _DTYPE_INT32).astype(np.int64)
    data = _wrap(data_ptr, nelem, data_type).astype(np.float64)
    nrow = nindptr - 1
    ncol = int(num_col) if num_col > 0 else (
        int(indices.max()) + 1 if nelem else 0)
    X = np.zeros((nrow, ncol), np.float64)
    row = np.repeat(np.arange(nrow), np.diff(indptr))
    X[row, indices] = data
    return X


def _csc_to_dense(col_ptr_ptr: int, col_ptr_type: int, indices_ptr: int,
                  data_ptr: int, data_type: int, ncol_ptr: int,
                  nelem: int, num_row: int) -> np.ndarray:
    col_ptr = _wrap(col_ptr_ptr, ncol_ptr, col_ptr_type).astype(np.int64)
    indices = _wrap(indices_ptr, nelem, _DTYPE_INT32).astype(np.int64)
    data = _wrap(data_ptr, nelem, data_type).astype(np.float64)
    ncol = ncol_ptr - 1
    nrow = int(num_row) if num_row > 0 else (
        int(indices.max()) + 1 if nelem else 0)
    X = np.zeros((nrow, ncol), np.float64)
    col = np.repeat(np.arange(ncol), np.diff(col_ptr))
    X[indices, col] = data
    return X


def _parse_params(params: str) -> dict:
    out = {}
    for tok in params.replace("\t", " ").split():
        if "=" in tok:
            k, v = tok.split("=", 1)
            out[k] = v
    return out


# -- datasets -------------------------------------------------------------
def dataset_from_mat(ptr: int, data_type: int, nrow: int, ncol: int,
                     is_row_major: int, params: str, ref_handle: int) -> int:
    X = _wrap_mat(ptr, nrow, ncol, is_row_major, data_type)
    from . import basic as lgb
    ref = _get(ref_handle) if ref_handle else None
    ds = lgb.Dataset(X, params=_parse_params(params), reference=ref)
    return _put(ds)


def dataset_from_file(filename: str, params: str, ref_handle: int) -> int:
    """LGBM_DatasetCreateFromFile (c_api.h:53-60): text/binary autodetect
    through the loader, honoring reference bin mappers."""
    from . import basic as lgb
    ref = _get(ref_handle) if ref_handle else None
    ds = lgb.Dataset(filename, params=_parse_params(params), reference=ref)
    ds.construct()
    return _put(ds)


def dataset_from_csr(indptr_ptr: int, indptr_type: int, indices_ptr: int,
                     data_ptr: int, data_type: int, nindptr: int,
                     nelem: int, num_col: int, params: str,
                     ref_handle: int) -> int:
    X = _csr_to_dense(indptr_ptr, indptr_type, indices_ptr, data_ptr,
                      data_type, nindptr, nelem, num_col)
    from . import basic as lgb
    ref = _get(ref_handle) if ref_handle else None
    return _put(lgb.Dataset(X, params=_parse_params(params), reference=ref))


def dataset_from_csc(col_ptr_ptr: int, col_ptr_type: int, indices_ptr: int,
                     data_ptr: int, data_type: int, ncol_ptr: int,
                     nelem: int, num_row: int, params: str,
                     ref_handle: int) -> int:
    X = _csc_to_dense(col_ptr_ptr, col_ptr_type, indices_ptr, data_ptr,
                      data_type, ncol_ptr, nelem, num_row)
    from . import basic as lgb
    ref = _get(ref_handle) if ref_handle else None
    return _put(lgb.Dataset(X, params=_parse_params(params), reference=ref))


class _StreamingDataset:
    """Push-rows staging buffer behind LGBM_DatasetCreateFromSampledColumn /
    CreateByReference + PushRows[ByCSR] (c_api.h:70-146).

    The reference pre-sizes bin mappers from sampled columns, then streams
    rows in.  Dense-first here: rows land in a preallocated f64 matrix and
    the real Dataset is constructed once every row has arrived (the
    sampled values only size the buffer — bin finding runs on the full
    data, a strictly better quantization than the reference's sample)."""

    def __init__(self, nrow: int, ncol: int, params: str,
                 reference=None):
        self.X = np.full((nrow, ncol), 0.0, np.float64)
        self.params = params
        self.reference = reference
        self.pushed = 0
        self._covered = np.zeros(nrow, bool)  # which row indices arrived
        self.dataset = None                  # becomes lgb.Dataset

    def push(self, rows: np.ndarray, start_row: int):
        if self.dataset is not None:
            raise RuntimeError(
                "dataset already finalized: all rows were pushed")
        end_row = start_row + rows.shape[0]
        if end_row > self.X.shape[0]:
            raise ValueError(
                f"push of rows [{start_row}, {end_row}) exceeds declared "
                f"nrow {self.X.shape[0]}")
        if self._covered[start_row:end_row].any():
            raise ValueError(
                f"rows in [{start_row}, {end_row}) were already pushed")
        self.X[start_row:end_row] = rows
        self._covered[start_row:end_row] = True
        self.pushed += rows.shape[0]
        # finalize only once EVERY row index has been written — a pure
        # count would finalize early (zero-filling gaps) on overlapping
        # or out-of-order pushes
        if self._covered.all():
            self._finish()

    def _finish(self):
        from . import basic as lgb
        self.dataset = lgb.Dataset(self.X, params=_parse_params(self.params),
                                   reference=self.reference)
        self.dataset.construct()
        self.X = None

    # dataset-protocol passthroughs: once finished, behave as the Dataset
    def _require(self):
        if self.dataset is None:
            raise RuntimeError(
                f"dataset is still streaming: {self.pushed}/{len(self.X)} "
                "rows pushed")
        return self.dataset

    def __getattr__(self, name):
        return getattr(self._require(), name)


def dataset_from_sampled_column(nrow: int, ncol: int, params: str) -> int:
    """LGBM_DatasetCreateFromSampledColumn (c_api.h:70-84).  The sampled
    values themselves are not needed (see _StreamingDataset docstring);
    the call records the target shape for the PushRows stream."""
    return _put(_StreamingDataset(nrow, ncol, params))


def dataset_create_by_reference(ref_handle: int, nrow: int) -> int:
    ref = _get(ref_handle)
    if isinstance(ref, _StreamingDataset):
        ref = ref._require()
    return _put(_StreamingDataset(nrow, ref.num_feature(), "",
                                  reference=ref))


def dataset_push_rows(h: int, ptr: int, data_type: int, nrow: int,
                      ncol: int, start_row: int) -> None:
    rows = _wrap(ptr, nrow * ncol, data_type).reshape(nrow, ncol)
    _get(h).push(rows.astype(np.float64), int(start_row))


def dataset_push_rows_by_csr(h: int, indptr_ptr: int, indptr_type: int,
                             indices_ptr: int, data_ptr: int,
                             data_type: int, nindptr: int, nelem: int,
                             num_col: int, start_row: int) -> None:
    rows = _csr_to_dense(indptr_ptr, indptr_type, indices_ptr, data_ptr,
                         data_type, nindptr, nelem, num_col)
    _get(h).push(rows, int(start_row))


def dataset_get_subset(h: int, idx_ptr: int, n_idx: int,
                       params: str) -> int:
    idx = _wrap(idx_ptr, n_idx, _DTYPE_INT32)
    return _put(_get(h).subset(np.array(idx), _parse_params(params)))


def dataset_set_feature_names(h: int, names_json: str) -> None:
    ds = _get(h)
    ds.construct()
    ds._constructed.feature_names = list(json.loads(names_json))


def dataset_get_feature_names(h: int) -> str:
    ds = _get(h)
    return json.dumps(list(ds.feature_names))


def dataset_save_binary(h: int, filename: str) -> None:
    _get(h).save_binary(filename)


def dataset_set_field(h: int, name: str, ptr: int, n: int,
                      dtype: int) -> None:
    arr = _wrap(ptr, n, dtype)
    _get(h).set_field(name, np.array(arr))


def dataset_get_field(h: int, name: str) -> tuple:
    """-> (address, length, c_api_dtype); keeps the buffer alive on the
    handle (reference returns a pointer into the Dataset, c_api.h:290-300)."""
    ds = _get(h)
    val = ds.get_field(name)
    if val is None:
        return (0, 0, _DTYPE_FLOAT32)
    if name == "group":
        arr = np.ascontiguousarray(val, np.int32)
        dt = _DTYPE_INT32
    elif name == "init_score":
        arr = np.ascontiguousarray(val, np.float64)
        dt = _DTYPE_FLOAT64
    else:
        arr = np.ascontiguousarray(val, np.float32)
        dt = _DTYPE_FLOAT32
    if not hasattr(ds, "_field_refs"):
        ds._field_refs = {}
    ds._field_refs[name] = arr
    return (arr.ctypes.data, int(arr.size), dt)


def dataset_num_data(h: int) -> int:
    return int(_get(h).num_data())


def dataset_num_feature(h: int) -> int:
    return int(_get(h).num_feature())


# -- boosters -------------------------------------------------------------
DEVICE_ENV = "LGBM_TPU_TORCH_DEVICE"


def _device(params: dict) -> str:
    """A handle's device: ``device`` of its parameter string, else the
    ``LGBM_TPU_TORCH_DEVICE`` environment variable, else ``cuda``."""
    return str(params.get("device") or os.environ.get(DEVICE_ENV)
               or "cuda")


def _train_set(handle: int):
    ds = _get(handle)
    return ds._require() if isinstance(ds, _StreamingDataset) else ds


def booster_create(train_handle: int, params: str) -> int:
    from .basic import Booster
    p = _parse_params(params)
    return _put(Booster(params=p, train_set=_train_set(train_handle),
                        device=_device(p)))


def booster_create_from_modelfile(path: str) -> int:
    from .basic import Booster
    return _put(Booster(model_file=path, device=_device({})))


def booster_load_model_from_string(model_str: str) -> int:
    from .basic import Booster
    return _put(Booster(model_str=model_str, device=_device({})))


def booster_merge(h: int, other_h: int) -> None:
    """LGBM_BoosterMerge (c_api.h:364-371): merge the other booster's
    trees in FRONT of this booster's, as copies (reference
    GBDT::MergeFrom, gbdt.h:50-67)."""
    b = _get(h)
    b._gbdt.merge_from(_get(other_h)._gbdt)
    b._serve_cache = {}


def booster_add_valid(h: int, valid_handle: int, name: str) -> None:
    valid = _train_set(valid_handle)
    b = _get(h)
    # caller-supplied name when given, else the reference's
    # "valid_1"/"valid_2" convention: GetEval selects by data_idx, which
    # needs the sets distinguishable
    base = name.strip() if name else ""
    if not base or base in b._name_valid_sets:
        i = len(b._name_valid_sets) + 1
        while f"valid_{i}" in b._name_valid_sets:
            i += 1
        base = f"valid_{i}"
    b.add_valid(valid, base)


def booster_reset_training_data(h: int, train_handle: int) -> None:
    """LGBM_BoosterResetTrainingData (c_api.h:382-389): swap the train
    set, keeping the model (continued training on new data): the model's
    trees, bin-aligned to the new set, are replayed into its scores."""
    from .basic import Booster
    from .boosting.gbdt import GBDT
    from .config import Config
    b = _get(h)
    nb = Booster(params=b.params, train_set=_train_set(train_handle),
                 device=b.device)
    if b.num_trees() > 0:
        g = nb._gbdt
        donor = GBDT(Config.from_params({}), None, g.device)
        donor.load_model_from_string(b.model_to_string())
        fmap = {f: i for i, f in enumerate(g.train_set.used_features)}
        for t in donor.models:
            t.align_with_mappers(g.train_set.mappers, fmap)
        g.merge_from(donor)
    # valid sets survive ResetTrainingData (reference c_api.cpp
    # ResetTrainingData keeps the Booster's valid list)
    for vs, name in zip(b._valid_sets, b._name_valid_sets):
        nb.add_valid(vs, name)
    _handles[int(h)] = nb


def booster_reset_parameter(h: int, params: str) -> None:
    _get(h)._gbdt.reset_config(_parse_params(params))


def booster_update_one_iter(h: int) -> int:
    return int(bool(_get(h).update()))


def booster_update_one_iter_custom(h: int, grad_ptr: int, hess_ptr: int,
                                   n: int) -> int:
    """One iteration on the caller's class-major ``[n * K]`` gradients,
    copied to the Booster's device."""
    import torch
    b = _get(h)
    g = b._gbdt
    K = max(1, g.num_tree_per_iteration)

    def dev(ptr):
        a = np.array(_wrap_f32(ptr, n)).reshape(-1, K, order="F")
        return torch.as_tensor(np.ascontiguousarray(a), device=g.device)
    return int(bool(g.train_one_iter(dev(grad_ptr), dev(hess_ptr))))


def booster_rollback_one_iter(h: int) -> None:
    _get(h).rollback_one_iter()


def booster_num_classes(h: int) -> int:
    return int(max(1, _get(h)._gbdt.num_class))


def booster_current_iteration(h: int) -> int:
    return int(_get(h).current_iteration())


def booster_number_of_total_model(h: int) -> int:
    return int(_get(h).num_trees())


def booster_get_num_feature(h: int) -> int:
    return int(_get(h).num_feature())


def booster_get_feature_names(h: int) -> str:
    return json.dumps(_get(h).feature_name())


# eval plumbing: the reference's GetEval returns only metric VALUES in
# eval-name order for dataset idx (0 = train, i+1 = i-th valid),
# c_api.h:477-489 / c_api.cpp GetEval.
def _eval_results(b, data_idx: int) -> List[tuple]:
    g = b._gbdt
    if data_idx == 0:
        return b.eval_train()
    # select the idx-th valid set BY POSITION (names could collide)
    i = int(data_idx) - 1
    return g._eval_set(g.valid_names[i], g._valid_scores[i],
                       g.valid_sets[i].metadata)


def _metric_names(b) -> List[str]:
    # metadata query: read the configured metric names, don't run eval
    return [n for m in b._gbdt.metrics for n in m.names]


def booster_get_eval_counts(h: int) -> int:
    return len(_metric_names(_get(h)))


def booster_get_eval_names(h: int) -> str:
    return json.dumps(_metric_names(_get(h)))


def _copy_out(values, out_ptr: int) -> int:
    out = np.ascontiguousarray(np.asarray(values).reshape(-1), np.float64)
    ctypes.memmove(int(out_ptr), out.ctypes.data, out.nbytes)
    return int(out.size)


def booster_get_eval(h: int, data_idx: int, out_ptr: int) -> int:
    res = _eval_results(_get(h), int(data_idx))
    return _copy_out([v for _, _, v, _ in res], out_ptr)


def _scores(g, data_idx: int):
    return g.scores if data_idx == 0 else g._valid_scores[data_idx - 1]


def booster_get_num_predict(h: int, data_idx: int) -> int:
    return int(_scores(_get(h)._gbdt, data_idx).numel())


def booster_get_predict(h: int, data_idx: int, out_ptr: int) -> int:
    """Scores of the idx-th dataset (0=train), transformed by the
    objective the way the reference's GetPredict does (c_api.h:491-503)."""
    g = _get(h)._gbdt
    scores = _scores(g, data_idx)
    if g.objective is not None:
        scores = g.objective.convert_output(scores)
    return _copy_out(scores.cpu().numpy(), out_ptr)


def _predict_kwargs(predict_type: int):
    return {"raw_score": predict_type == _PREDICT_RAW,
            "pred_leaf": predict_type == _PREDICT_LEAF,
            "pred_contrib": predict_type == _PREDICT_CONTRIB}


def booster_calc_num_predict(h: int, nrow: int, predict_type: int,
                             num_iteration: int) -> int:
    g = _get(h)._gbdt
    K = max(1, g.num_tree_per_iteration)
    if predict_type == _PREDICT_LEAF:
        T = g.num_trees()
        if num_iteration > 0:
            T = min(T, num_iteration * K)
        return int(nrow * T)
    if predict_type == _PREDICT_CONTRIB:
        return int(nrow * K * (g.max_feature_idx + 2))
    return int(nrow * max(1, g.num_class))


def _predict_to_buffer(b, X: np.ndarray, predict_type: int,
                       num_iteration: int, out_ptr: int) -> int:
    """The Booster's own prediction path: a ``cuda`` Booster's compiled
    model on the card, a CPU one's host walk."""
    return _copy_out(b.predict(X, num_iteration=num_iteration,
                               **_predict_kwargs(predict_type)), out_ptr)


def booster_predict_for_mat(h: int, ptr: int, data_type: int, nrow: int,
                            ncol: int, is_row_major: int, predict_type: int,
                            num_iteration: int, out_ptr: int) -> int:
    X = _wrap_mat(ptr, nrow, ncol, is_row_major, data_type)
    return _predict_to_buffer(_get(h), X, predict_type, num_iteration,
                              out_ptr)


def booster_predict_for_csr(h: int, indptr_ptr: int, indptr_type: int,
                            indices_ptr: int, data_ptr: int, data_type: int,
                            nindptr: int, nelem: int, num_col: int,
                            predict_type: int, num_iteration: int,
                            out_ptr: int) -> int:
    X = _csr_to_dense(indptr_ptr, indptr_type, indices_ptr, data_ptr,
                      data_type, nindptr, nelem, num_col)
    return _predict_to_buffer(_get(h), X, predict_type, num_iteration,
                              out_ptr)


def booster_predict_for_csc(h: int, col_ptr_ptr: int, col_ptr_type: int,
                            indices_ptr: int, data_ptr: int, data_type: int,
                            ncol_ptr: int, nelem: int, num_row: int,
                            predict_type: int, num_iteration: int,
                            out_ptr: int) -> int:
    X = _csc_to_dense(col_ptr_ptr, col_ptr_type, indices_ptr, data_ptr,
                      data_type, ncol_ptr, nelem, num_row)
    return _predict_to_buffer(_get(h), X, predict_type, num_iteration,
                              out_ptr)


def booster_predict_for_file(h: int, data_filename: str, has_header: int,
                             result_filename: str, predict_type: int,
                             num_iteration: int) -> None:
    """LGBM_BoosterPredictForFile (c_api.h:524-542): parse with the
    training files' parser, write one line per row (reference Predictor
    file flow, src/application/predictor.hpp:115-155)."""
    from .io.loader import load_raw_matrix
    from .utils.file_io import open_write
    X, _ = load_raw_matrix(data_filename, has_header=bool(has_header))
    pred = np.asarray(_get(h).predict(X, num_iteration=num_iteration,
                                      **_predict_kwargs(predict_type)))
    if pred.ndim == 1:
        pred = pred[:, None]
    with open_write(result_filename) as f:
        for row in pred:
            f.write("\t".join(repr(float(v)) for v in row) + "\n")


def booster_save_model(h: int, path: str, num_iteration: int) -> None:
    _get(h).save_model(path, num_iteration=num_iteration)


def booster_model_to_string(h: int, num_iteration: int) -> str:
    return _get(h).model_to_string(num_iteration)


def booster_dump_model(h: int, num_iteration: int) -> str:
    return json.dumps(_get(h).dump_model(num_iteration))


def booster_get_leaf_value(h: int, tree_idx: int, leaf_idx: int) -> float:
    return float(_get(h)._gbdt.models[int(tree_idx)].leaf_value[int(leaf_idx)])


def booster_set_leaf_value(h: int, tree_idx: int, leaf_idx: int,
                           val: float) -> None:
    """Reference SetLeafValue (c_api.h:723-734); the training scores move
    by the tree's replayed output change, as the JAX package's
    ``GBDT.set_leaf_value`` does."""
    b = _get(h)
    g = b._gbdt
    tree = g.models[int(tree_idx)]
    leaf = int(leaf_idx)
    old = float(tree.leaf_value[leaf])
    val = float(val)
    if g.train_set is not None and val != old:
        before = g._replay(tree, g.device_data)
        tree.leaf_value[leaf] = val
        k = int(tree_idx) % max(1, g.num_tree_per_iteration)
        g.scores[:, k] += g._replay(tree, g.device_data) - before
    tree.leaf_value[leaf] = val
    b._serve_cache = {}


def booster_feature_importance(h: int, num_iteration: int,
                               importance_type: int, out_ptr: int) -> int:
    return _copy_out(_get(h).feature_importance(
        "gain" if importance_type == 1 else "split", num_iteration), out_ptr)


# -- network (LGBM_NetworkInit*, c_api.h:749-760) -------------------------
def network_init(machines: str, local_listen_port: int,
                 listen_time_out: int, num_machines: int) -> None:
    """Machine-list rendezvous -> a ``torch.distributed`` process group
    (the socket linker's analog, linkers_socket.cpp:27-68: the first
    machine hosts the rendezvous, rank = position of the local endpoint
    in the list); the rank's device as a Booster's default."""
    if num_machines <= 1:
        return
    from .parallel.mesh import init_distributed_from_machines
    init_distributed_from_machines(machines, local_listen_port, num_machines,
                                   device=_device({}))


def network_free() -> None:
    """Leave the process group (a no-op outside one)."""
    from .parallel.mesh import destroy
    destroy()


def network_init_with_functions(num_machines: int, rank: int,
                                reduce_scatter_addr: int,
                                allgather_addr: int) -> None:
    """LGBM_NetworkInitWithFunctions (c_api.h:760): the reference's
    pluggable-collective seam.  The C allgather is wrapped with ctypes
    and installed as the host collective of distributed ingest
    (io/distributed.py)."""
    from .io import distributed as dist
    dist.install_external_collectives(num_machines, rank,
                                      reduce_scatter_addr, allgather_addr)
