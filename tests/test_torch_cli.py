"""The port's command-line application (``python -m lightgbm_tpu_torch``)
held to the JAX package's (``lightgbm_tpu.cli.run``) on the same
``train.conf`` and CSV files, on the CPU.

The configuration is the upstream ``examples/binary_classification``
``train.conf`` as ``chip_smoke.py:TRAIN_CONF`` restates it (binary, 63
leaves, ``max_bin`` 255, feature and bagging fraction 0.8, bagging every
5 iterations, ``min_data_in_leaf`` 50), on 900 + 300 rows of the
bench's generator, with ``valid_data=`` and early stopping after 5.
The JAX side runs its kernels in Pallas interpret mode.

* ``train``: the same model text (digests equal), or a first
  divergence that ``model_flip_report`` classifies as a near tie (C8);
* ``predict``: the output files equal as text (``%.9g``), the model
  files of either package loaded by either CLI;
* ``refit`` on the training file: an L2 model's the same model text
  (C21: the port routes rows through its compiled predictor, the JAX
  package through the file's own bins, which are the training bins
  here); the binary model's leaf values within ``f32_ulp_few``;
* ``convert_model``: the same C++ text; compiled, within 1e-5 of
  ``predict(raw_score=True)`` (the reference CI's gate);
* ``input_model``: the JAX CLI loads it twice (ROADMAP C33), and so does
  the port's: the same model text;
* ``--resume`` from a snapshot: the uninterrupted run's model text.

Two processes (``num_machines=2``, ``tree_learner=data``, gloo over a
loopback machine list) load the file mod-rank with distributed bin
finding, which a JAX mesh's contiguous row blocks do not reproduce: so
the ranks' models are held byte-identical to each other and to the
port's own two-rank ``lgb.train`` of the same file
(``tests/torch_dist_worker.py``, kind ``load``).
"""
import logging
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from lightgbm_tpu import cli as jcli
from lightgbm_tpu.parallel.envelope import model_flip_report

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch import cli as tcli
from tools.numcheck.tolerance_registry import tol

from tests.test_torch_codegen import CODEGEN_TOL, compile_and_predict
from tests.torch_dist_worker import run_world

torch.set_num_threads(1)   # tiny tensors: more threads only spin

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS, VALID_ROWS, FEATURES = 900, 300, 8
CLI_TIMEOUT_S = 300
# examples/binary_classification/train.conf (chip_smoke.py:TRAIN_CONF)
TRAIN_CONF = {"objective": "binary", "metric": "binary_logloss,auc",
              "metric_freq": 1, "is_training_metric": "true",
              "num_leaves": 63, "max_bin": 255, "learning_rate": 0.1,
              "feature_fraction": 0.8, "bagging_freq": 5,
              "bagging_fraction": 0.8, "min_data_in_leaf": 50,
              "min_sum_hessian_in_leaf": 5.0, "verbose": -1}


@pytest.fixture(autouse=True)
def _reference_kernels(monkeypatch):
    monkeypatch.setenv("LGBM_TPU_HIST_BACKEND", "compact")
    monkeypatch.setenv("LGBM_TPU_SPLIT_INTERPRET", "1")
    # both CLIs set their logger's level from ``verbose``
    levels = {n: logging.getLogger(n).level
              for n in ("lightgbm_tpu", "lightgbm_tpu_torch")}
    yield
    for n, lvl in levels.items():
        logging.getLogger(n).setLevel(lvl)


def write_conf(path, **kv) -> str:
    with open(path, "w") as f:
        f.write("# examples/binary_classification/train.conf\n")
        for k, v in {**TRAIN_CONF, **kv}.items():
            f.write(f"{k} = {v}\n")
    return str(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """train.csv / valid.csv (label first, no header) of the bench's
    generator, and the conf."""
    d = tmp_path_factory.mktemp("cli")
    rng = np.random.RandomState(5)
    n = ROWS + VALID_ROWS
    X = rng.normal(size=(n, FEATURES))
    y = (X[:, 0] * 2 + X[:, 1] - X[:, 2] + rng.normal(size=n) > 0)
    rows = np.column_stack([y.astype(np.float64), X])
    np.savetxt(d / "train.csv", rows[:ROWS], delimiter=",", fmt="%.17g")
    np.savetxt(d / "valid.csv", rows[ROWS:], delimiter=",", fmt="%.17g")
    conf = write_conf(d / "train.conf", num_trees=40,
                      early_stopping_round=5, data=d / "train.csv",
                      valid_data=d / "valid.csv")
    return {"dir": d, "conf": conf, "X": X, "train": str(d / "train.csv"),
            "valid": str(d / "valid.csv")}


def run_both(args, out_key, out_dir, name):
    """Both CLIs on ``args`` plus ``<out_key>=<dir>/<pkg>.<name>``;
    -> (JAX output text, port output text)."""
    paths = [os.path.join(out_dir, f"{p}.{name}") for p in ("jax", "torch")]
    assert jcli.run(args + [f"{out_key}={paths[0]}"]) == 0
    assert tcli.run(args + [f"{out_key}={paths[1]}", "device=cpu"]) == 0
    return tuple(open(p).read() for p in paths)


def same_model(jtext: str, ttext: str) -> None:
    if jtext != ttext:
        rep = model_flip_report(jtext, ttext)
        assert rep["near_tie"], rep


@pytest.fixture(scope="module")
def trained(files):
    levels = {n: logging.getLogger(n).level
              for n in ("lightgbm_tpu", "lightgbm_tpu_torch")}
    mp = pytest.MonkeyPatch()
    mp.setenv("LGBM_TPU_HIST_BACKEND", "compact")
    mp.setenv("LGBM_TPU_SPLIT_INTERPRET", "1")
    try:
        texts = run_both([f"config={files['conf']}"], "output_model",
                         files["dir"], "model.txt")
    finally:
        mp.undo()
        for n, lvl in levels.items():
            logging.getLogger(n).setLevel(lvl)
    return texts


def test_train(files, trained):
    jtext, ttext = trained
    same_model(jtext, ttext)
    bst = tlgb.Booster(model_str=ttext, device="cpu")
    # early stopping after 5 rounds without a gain: the saved model is
    # cut at the best iteration
    assert 0 < bst.current_iteration() < 40
    # the CLI's model is lgb.train's on the same files
    params = dict(TRAIN_CONF, early_stopping_round=5)
    ds = tlgb.Dataset(files["train"], params=params)
    direct = tlgb.train(dict(params), ds, 40, valid_sets=[tlgb.Dataset(
        files["valid"], params=params, reference=ds)], device="cpu")
    assert direct.model_to_string(num_iteration=direct.best_iteration) \
        == ttext


@pytest.mark.parametrize("model", ["jax", "torch"])
def test_predict_text_equal(files, trained, model, tmp_path):
    """Either package's model file, predicted by both CLIs."""
    path = os.path.join(files["dir"], f"{model}.model.txt")
    for raw in ("false", "true"):
        a, b = run_both(["task=predict", f"data={files['valid']}",
                         f"input_model={path}", f"is_predict_raw_score={raw}",
                         "verbose=-1"], "output_result", tmp_path,
                        f"pred_{raw}.tsv")
        assert a == b
        assert len(a.splitlines()) == VALID_ROWS


def _leaf_values(text):
    b = tlgb.Booster(model_str=text, device="cpu")
    return np.concatenate([t.leaf_value[:t.num_leaves]
                           for t in b._gbdt.models])


def test_refit_on_training_file(files, trained, tmp_path):
    """``task=refit`` on the training file.  An L2 model refits to the
    JAX package's model text bitwise (C21: both route the training rows
    as the host walk).  The binary model's refit gradients differ from
    the JAX package's by an ulp-scale amount (its refit takes the
    sigmoid outside its compiled training program), so its leaf values
    are held within ``f32_ulp_few`` and the rest of the text exactly."""
    path = os.path.join(files["dir"], "torch.model.txt")
    a, b = run_both(["task=refit", f"data={files['train']}",
                     f"input_model={path}", "verbose=-1"], "output_model",
                    tmp_path, "refit.txt")
    assert b != trained[1]
    np.testing.assert_allclose(_leaf_values(b), _leaf_values(a), rtol=0,
                               atol=tol("f32_ulp_few"))
    strip = [ln for ln in b.splitlines()
             if not ln.startswith(("leaf_value=", "tree_sizes="))]
    assert strip == [ln for ln in a.splitlines()
                     if not ln.startswith(("leaf_value=", "tree_sizes="))]
    conf = write_conf(tmp_path / "l2.conf", num_trees=10,
                      data=files["train"], objective="regression")
    l2 = str(tmp_path / "l2.txt")
    assert tcli.run([f"config={conf}", f"output_model={l2}",
                     "device=cpu"]) == 0
    a, b = run_both(["task=refit", f"data={files['train']}",
                     f"input_model={l2}", "verbose=-1"], "output_model",
                    tmp_path, "refit_l2.txt")
    assert a == b
    assert b != open(l2).read()


def test_convert_model(files, trained, tmp_path):
    path = os.path.join(files["dir"], "torch.model.txt")
    a, b = run_both(["task=convert_model", f"input_model={path}",
                     "verbose=-1"], "convert_model", tmp_path, "model.cpp")
    assert a == b
    X = files["X"][ROWS:]
    got = compile_and_predict(b, X, 1)[:, 0]
    want = tlgb.Booster(model_file=path, device="cpu").predict(
        X, raw_score=True)
    np.testing.assert_allclose(got, want, rtol=0, atol=CODEGEN_TOL)


def test_input_model_loaded_twice(files, trained, tmp_path):
    """``input_model`` with ``task=train``: the booster loads it and the
    CLI passes it as ``init_model`` too, in both packages (ROADMAP C33),
    so the model holds the loaded trees twice, then the new ones."""
    first = os.path.join(files["dir"], "torch.model.txt")
    conf = write_conf(tmp_path / "more.conf", num_trees=3,
                      data=files["train"], input_model=first)
    jtext, ttext = run_both([f"config={conf}"], "output_model", tmp_path,
                            "more.txt")
    assert ttext == jtext
    loaded = tlgb.Booster(model_file=first, device="cpu")
    L = loaded.num_trees()
    more = tlgb.Booster(model_str=ttext, device="cpu")
    assert more.num_trees() == 2 * L + 3
    trees = [t.strip() for t in ttext.split("feature importances:")[0]
             .split("Tree=")[1:]]
    want = [t.strip() for t in loaded.model_to_string()
            .split("feature importances:")[0].split("Tree=")[1:]]
    strip = [t.split("\n", 1)[1] for t in trees]
    assert strip[:L] == [t.split("\n", 1)[1] for t in want]
    assert strip[L:2 * L] == strip[:L]


def test_resume_from_snapshot(files, tmp_path):
    """``--resume`` picks up the newest snapshot under ``output_model``
    and trains on to ``num_trees``: the uninterrupted run's model, in
    both packages."""
    common = dict(data=files["train"], snapshot_freq=2)
    full = write_conf(tmp_path / "full.conf", num_trees=6, **common)
    jfull, tfull = run_both([f"config={full}"], "output_model", tmp_path,
                            "full.txt")
    same_model(jfull, tfull)
    cut = write_conf(tmp_path / "cut.conf", num_trees=4, **common)
    more = write_conf(tmp_path / "more.conf", num_trees=6, **common)
    for pkg, cli in (("jax", jcli), ("torch", tcli)):
        prefix = str(tmp_path / f"{pkg}.resumed.txt")
        extra = ["device=cpu"] if pkg == "torch" else []
        assert cli.run([f"config={cut}", f"output_model={prefix}"]
                       + extra) == 0
        assert cli.run([f"config={more}", f"output_model={prefix}",
                        "--resume"] + extra) == 0
    assert open(tmp_path / "torch.resumed.txt").read() == tfull
    assert open(tmp_path / "jax.resumed.txt").read() == jfull


RANK_SCRIPT = """
import sys
sys.path.insert(0, sys.argv[1])
import torch
torch.set_num_threads(1)
from lightgbm_tpu_torch import cli, engine
got = []
real = engine.train
def train(*a, **k):
    got.append(real(*a, **k))
    return got[-1]
engine.train = train
rc = cli.main(sys.argv[3:])
with open(sys.argv[2], "w") as f:
    f.write(got[0].model_to_string())
sys.exit(rc)
"""


def _free_ports(k):
    socks = [socket.socket() for _ in range(k)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def test_two_process_data_parallel(files, tmp_path):
    """``num_machines=2`` over a loopback machine list: both ranks
    (``python -m lightgbm_tpu_torch``'s ``main``, each rank's trained
    Booster captured) hold the same model, rank 0 saved it, and it is the
    port's two-rank ``lgb.train`` of the same file."""
    ports = _free_ports(2)
    machines = ",".join(f"127.0.0.1:{p}" for p in ports)
    conf = write_conf(tmp_path / "dist.conf", num_trees=6,
                      data=files["train"], tree_learner="data",
                      num_machines=2, machines=machines)
    saved = tmp_path / "dist.txt"
    procs, outs = [], []
    for r in range(2):
        outs.append(tmp_path / f"rank{r}.txt")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", RANK_SCRIPT, REPO, str(outs[r]),
             f"config={conf}", f"local_listen_port={ports[r]}",
             f"output_model={saved}", "device=cpu"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        logs = [p.communicate(timeout=CLI_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], \
        [log[-2000:] for log in logs]
    models = [o.read_text() for o in outs]
    assert models[0] == models[1]
    assert saved.read_text() == models[0]
    params = {k: v for k, v in TRAIN_CONF.items()}
    params.update(tree_learner="data", num_machines=2)
    res = run_world([dict(name="load", kind="load", path=files["train"],
                          params=params, rounds=6)], 2,
                    str(tmp_path / "world"))
    assert [info["model"] for _, info in res["load"]] == [models[0]] * 2
