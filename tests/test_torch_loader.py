"""File input of the port (``io/loader.py``, ``native/``) held against the
JAX package's loader on the same files, at toy size on the CPU: CSV, TSV
and libsvm with and without a header, ``name:`` column specs,
``ignore_column`` and ``categorical_column``, the side files, the binary
cache, two-round loading, the native parser against the numpy path,
and a model trained from a file against one trained from the same
array.  Values are written with ``%.17g`` so that the parse is exact;
binned datasets (mappers, bins, metadata) must be equal.
"""
import logging
import os
import subprocess

import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io import loader as j_loader
from lightgbm_tpu.parallel.envelope import model_flip_report

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch import native
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.io import loader

torch.set_num_threads(1)   # tiny tensors: more threads only spin

PARAMS = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
          "min_data_in_leaf": 20, "verbose": -1}


@pytest.fixture(autouse=True)
def _reference_kernels(monkeypatch):
    monkeypatch.setenv("LGBM_TPU_HIST_BACKEND", "compact")
    monkeypatch.setenv("LGBM_TPU_SPLIT_INTERPRET", "1")


def _data(n=800, f=5, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    X[rng.rand(n, f) < 0.05] = 0.0
    y = (X[:, 0] - X[:, 1] + 0.5 * rng.normal(size=n) > 0).astype(np.float32)
    return X, y


def _write_delimited(path, X, y, sep, header, extra=None):
    """Label first, then the features (and ``extra`` named columns)."""
    cols = [y] + [X[:, j] for j in range(X.shape[1])]
    names = ["target"] + [f"f{j}" for j in range(X.shape[1])]
    for name, col in (extra or {}).items():
        cols.append(col)
        names.append(name)
    with open(path, "w") as f:
        if header:
            f.write(sep.join(names) + "\n")
        for row in zip(*cols):
            f.write(sep.join("%.17g" % float(v) for v in row) + "\n")


def _write_libsvm(path, X, y):
    with open(path, "w") as f:
        for i in range(len(X)):
            toks = ["%.17g" % float(y[i])]
            toks += [f"{j}:%.17g" % float(X[i, j])
                     for j in range(X.shape[1]) if X[i, j] != 0.0]
            f.write(" ".join(toks) + "\n")


def _assert_same_binned(a, b):
    """Two binned datasets (one per package) are the same."""
    np.testing.assert_array_equal(a.bins, b.bins)
    assert [m.to_dict() for m in a.mappers] == [m.to_dict() for m in b.mappers]
    assert a.used_features == b.used_features
    assert a.feature_names == b.feature_names
    for field in ("label", "weight", "init_score", "query_boundaries"):
        va, vb = getattr(a.metadata, field), getattr(b.metadata, field)
        assert (va is None) == (vb is None), field
        if va is not None:
            np.testing.assert_array_equal(va, vb)


def _load_both(path, params):
    return (loader.load_file(path, Config.from_params(params)),
            j_loader.load_file(path, JConfig.from_params(params)))


@pytest.mark.parametrize("fmt,header", [("csv", False), ("csv", True),
                                        ("tsv", False), ("tsv", True),
                                        ("libsvm", False)])
def test_formats_match_reference(fmt, header, tmp_path):
    X, y = _data()
    path = str(tmp_path / f"train.{fmt}")
    if fmt == "libsvm":
        _write_libsvm(path, X, y)
    else:
        _write_delimited(path, X, y, "," if fmt == "csv" else "\t", header)
    params = {"max_bin": 63, "has_header": header}
    assert loader.detect_format(path, header) == fmt
    t, j = _load_both(path, params)
    _assert_same_binned(t, j)
    np.testing.assert_array_equal(t.metadata.label, y)
    if header:
        assert t.feature_names == [f"f{i}" for i in range(X.shape[1])]


def test_column_specs_match_reference(tmp_path):
    """``name:`` specs for the label, weight, ignored and categorical
    columns, and the same by index."""
    X, y = _data()
    rng = np.random.RandomState(1)
    w = rng.uniform(0.5, 2.0, size=len(X)).astype(np.float32)
    cat = rng.randint(0, 6, size=len(X)).astype(np.float64)
    junk = rng.normal(size=len(X))
    path = str(tmp_path / "cols.csv")
    _write_delimited(path, X, y, ",", True,
                     {"w": w, "junk": junk, "c": cat})
    by_name = {"has_header": True, "label_column": "name:target",
               "weight_column": "name:w", "ignore_column": "name:junk",
               "categorical_column": "name:c", "max_bin": 63}
    t, j = _load_both(path, by_name)
    _assert_same_binned(t, j)
    np.testing.assert_array_equal(t.metadata.weight, w)
    assert t.num_total_features == X.shape[1] + 1
    assert t.mappers[-1].bin_type == 1          # categorical
    by_index = {"has_header": True, "label_column": "0",
                "weight_column": "6", "ignore_column": "7",
                "categorical_column": "8", "max_bin": 63}
    t2, j2 = _load_both(path, by_index)
    _assert_same_binned(t2, j2)
    np.testing.assert_array_equal(t2.bins, t.bins)


def test_side_files_match_reference(tmp_path):
    X, y = _data(n=600)
    path = str(tmp_path / "side.csv")
    _write_delimited(path, X, y, ",", False)
    rng = np.random.RandomState(2)
    np.savetxt(path + ".weight", rng.uniform(0.5, 2, size=len(X)),
               fmt="%.17g")
    np.savetxt(path + ".init", rng.normal(size=len(X)), fmt="%.17g")
    np.savetxt(path + ".query", np.full(30, 20), fmt="%d")
    t, j = _load_both(path, {"max_bin": 63})
    _assert_same_binned(t, j)
    assert len(t.metadata.query_boundaries) == 31
    ds = tlgb.Dataset(path, params={"max_bin": 63}).construct()
    np.testing.assert_array_equal(ds.get_weight(), t.metadata.weight)


def test_binary_cache_written_and_read(tmp_path, caplog):
    """``is_save_binary_file`` writes ``<file>.bin.npz`` (the JAX package's
    layout, which it loads); the next load reads it."""
    X, y = _data()
    path = str(tmp_path / "cache.csv")
    _write_delimited(path, X, y, ",", False)
    params = {"max_bin": 63, "is_save_binary_file": True}
    first = loader.load_file(path, Config.from_params(params))
    assert os.path.exists(path + ".bin.npz")
    with caplog.at_level(logging.INFO, logger="lightgbm_tpu_torch"):
        again = loader.load_file(path, Config.from_params({"max_bin": 63}))
    assert "loading binary cache" in caplog.text
    _assert_same_binned(again, first)
    ref = j_loader.load_file(path, JConfig.from_params({"max_bin": 63}))
    _assert_same_binned(again, ref)


@pytest.mark.parametrize("fmt", ["csv", "libsvm"])
def test_two_round_loading(fmt, tmp_path, monkeypatch):
    """Two-round loading bins chunk by chunk (small chunks forced) into
    the in-memory load's dataset, and the JAX package's two-round one."""
    X, y = _data(n=3000)
    path = str(tmp_path / f"two.{fmt}")
    if fmt == "libsvm":
        _write_libsvm(path, X, y)
    else:
        _write_delimited(path, X, y, ",", False)
    chunk = native.parse_delimited_chunks
    chunk_svm = native.parse_libsvm_chunks
    monkeypatch.setattr(native, "parse_delimited_chunks",
                        lambda p, d, s, chunk_bytes=0: chunk(p, d, s, 4096))
    monkeypatch.setattr(native, "parse_libsvm_chunks",
                        lambda p, s, c, chunk_bytes=0: chunk_svm(p, s, c,
                                                                 4096))
    params = {"max_bin": 63, "bin_construct_sample_cnt": 1000}
    whole = loader.load_file(path, Config.from_params(params))
    two = loader.load_file(path, Config.from_params(
        dict(params, use_two_round_loading=True)))
    _assert_same_binned(two, whole)
    ref = j_loader.load_file(path, JConfig.from_params(
        dict(params, use_two_round_loading=True)))
    _assert_same_binned(two, ref)


def test_native_parser_matches_numpy(tmp_path):
    X, y = _data(n=500)
    X[3, 2] = np.nan
    assert native.available()
    csv = str(tmp_path / "n.csv")
    _write_delimited(csv, X, y, ",", True)
    whole = native.parse_delimited(csv, ",", 1)
    np.testing.assert_array_equal(
        whole, np.genfromtxt(csv, delimiter=",", skip_header=1,
                             dtype=np.float64))
    chunks = list(native.parse_delimited_chunks(csv, ",", 1,
                                                chunk_bytes=2048))
    assert len(chunks) > 1
    np.testing.assert_array_equal(np.concatenate(chunks), whole)
    svm = str(tmp_path / "n.svm")
    X[3, 2] = 1.5
    _write_libsvm(svm, X, y)
    Xn, yn = native.parse_libsvm(svm, 0)
    Xp, yp = loader._parse_libsvm(svm, 0)
    np.testing.assert_array_equal(Xn, Xp)
    np.testing.assert_array_equal(yn, yp)
    assert native.scan_libsvm(svm, 0) == (len(X), Xn.shape[1])
    svm_chunks = list(native.parse_libsvm_chunks(svm, 0, Xn.shape[1],
                                                 chunk_bytes=2048))
    both = np.concatenate(svm_chunks)
    np.testing.assert_array_equal(both[:, 0], yn)
    np.testing.assert_array_equal(both[:, 1:], Xn)


def test_numpy_path_without_native(tmp_path, monkeypatch, caplog):
    """Without the library the loader warns once and parses with numpy,
    into the same dataset."""
    X, y = _data()
    path = str(tmp_path / "np.csv")
    _write_delimited(path, X, y, ",", False)
    with_native = loader.load_file(path, Config.from_params({"max_bin": 63}))
    def no_compiler():
        raise subprocess.CalledProcessError(1, "g++")

    monkeypatch.setattr(native, "LIB", tmp_path / "missing.so")
    monkeypatch.setattr(native, "_build", no_compiler)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_lib", None)
    with caplog.at_level(logging.WARNING, logger="lightgbm_tpu_torch"):
        assert not native.available()
        without = loader.load_file(path, Config.from_params({"max_bin": 63}))
    assert "numpy" in caplog.text
    _assert_same_binned(without, with_native)


@pytest.mark.parametrize("fmt", ["csv", "libsvm"])
def test_trained_from_file_matches_reference_and_array(fmt, tmp_path):
    """``Dataset(path)`` trains the JAX package's model from the same
    file, and the model of the same rows given as an array (with the
    ``.weight`` side file's weights), bitwise.  Against the JAX package:
    equal digests, or a first divergence that ``model_flip_report``
    classifies as a near tie (the datasets are equal; the split scans
    differ at near ties, ROADMAP C4, C8)."""
    X, _ = _data(n=1500)
    y = (X[:, 0] - X[:, 1] + np.random.RandomState(3).normal(
        size=len(X))).astype(np.float32)
    path = str(tmp_path / f"fit.{fmt}")
    if fmt == "libsvm":
        _write_libsvm(path, X, y)
    else:
        _write_delimited(path, X, y, ",", True)
        w = np.random.RandomState(4).uniform(0.5, 2, size=len(X))
        np.savetxt(path + ".weight", w, fmt="%.17g")
    params = dict(PARAMS, objective="regression", has_header=fmt == "csv")
    tb = tlgb.train(dict(params), tlgb.Dataset(path, params=params), 5,
                    verbose_eval=False, device="cpu")
    jb = jlgb.train(dict(params), jlgb.Dataset(path, params=params), 5,
                    verbose_eval=False)
    if tb.digest(include_scores=False) != jb.digest(include_scores=False):
        rep = model_flip_report(jb.model_to_string(), tb.model_to_string())
        assert rep["near_tie"], rep
    weight = None if fmt == "libsvm" else np.float32(w)
    arr = tlgb.train(dict(PARAMS, objective="regression"),
                     tlgb.Dataset(X, label=y, weight=weight),
                     5, verbose_eval=False, device="cpu")
    assert tb.digest() == arr.digest()


def test_valid_set_from_file_and_raw_matrix(tmp_path):
    X, y = _data(n=1000)
    Xv, yv = _data(n=300, seed=5)
    tr, va = str(tmp_path / "tr.csv"), str(tmp_path / "va.csv")
    _write_delimited(tr, X, y, ",", False)
    _write_delimited(va, Xv, yv, ",", False)
    ds = tlgb.Dataset(tr, params={"max_bin": 63})
    vs = tlgb.Dataset(va, reference=ds)
    ev = {}
    tlgb.train(dict(PARAMS, metric="auc"), ds, 3, valid_sets=[vs],
               valid_names=["v"], evals_result=ev, verbose_eval=False,
               device="cpu")
    assert len(ev["v"]["auc"]) == 3
    Xr, yr = loader.load_raw_matrix(va)
    Xj, yj = j_loader.load_raw_matrix(va)
    np.testing.assert_array_equal(Xr, Xj)
    np.testing.assert_array_equal(yr, yj)
    np.testing.assert_array_equal(yr, yv)


def test_distributed_loading_raises(tmp_path):
    """``num_machines=2`` loads (it raised before distributed loading was
    ported): without a collective the loader keeps rank 0's mod-rank rows,
    as the JAX package's does, and a ``Dataset`` outside a process group
    keeps every row (the distributed cases:
    ``tests/test_torch_distributed_io.py``)."""
    X, y = _data(n=100)
    path = str(tmp_path / "d.csv")
    _write_delimited(path, X, y, ",", False)
    sharded = loader.load_file(path, Config.from_params({}), num_machines=2)
    ref = j_loader.load_file(path, JConfig.from_params({}), num_machines=2)
    assert sharded.num_data == ref.num_data == 50
    np.testing.assert_array_equal(sharded.bins, ref.bins)
    whole = tlgb.Dataset(path, params={"num_machines": 2}).construct()
    assert whole._constructed.num_data == 100
