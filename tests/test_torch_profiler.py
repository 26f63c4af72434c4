"""Device-time attribution of lightgbm_tpu_torch (``obs/profiler.py``)
against the JAX package's, on the CPU.

``attribute`` equals the JAX package's on the same parsed capture (ops
without a launch key); with the key, a kernel that runs after its span
closed joins the span of its launch.  A synthetic chrome trace in
torch's device layout (``kernel`` events, ``cuda_runtime`` launches with
their correlation ids, ``kernel.<name>`` annotations) parses into ops,
programs and spans.  A CPU capture of a toy ``lgb.train`` under
``LGBM_TPU_PROFILE`` attributes the plain versions' ``cpu_op`` time to
the ``tree.*`` spans, names the kernels by their wrappers, carries the
``cpu`` sentinel, and leaves the model unchanged.
"""
import json
import os

import numpy as np
import pytest
import torch

from lightgbm_tpu.obs import profiler as jprof

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch import obs as tobs
from lightgbm_tpu_torch.obs import profiler as tprof

torch.set_num_threads(1)   # tiny tensors: more threads only spin

PARAMS = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
          "verbose": -1}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ("LGBM_TPU_PROFILE", "LGBM_TPU_PROFILE_WINDOWS",
                "LGBM_TPU_PROFILE_ITERS"):
        monkeypatch.delenv(var, raising=False)
    tobs.reset()
    yield
    tobs.reset()


def _synthetic(seed: int, n_annos=30, n_ops=200):
    """A parsed capture: nested prefixed annotations and ops, some inside
    spans, some after them, some collective."""
    rng = np.random.RandomState(seed)
    annos, t = [], 0.0
    for i in range(n_annos):
        dur = float(rng.uniform(0.01, 0.2))
        annos.append({"name": "gbdt.iteration", "ts": t, "dur": dur})
        for j, name in enumerate(("tree.route", "tree.hist", "tree.split")):
            s = t + dur * (0.1 + 0.25 * j)
            annos.append({"name": name, "ts": s, "dur": dur * 0.2})
        t += dur + float(rng.uniform(0.0, 0.05))
    ops = []
    for i in range(n_ops):
        ts = float(rng.uniform(-0.01, t + 0.02))
        ops.append({"name": ["hist_kernel", "all-reduce.1", "route_kernel",
                             "elementwise"][i % 4],
                    "ts": ts, "dur": float(rng.uniform(1e-5, 3e-3)),
                    "module": ["hist_route", "", "route", "aten"][i % 4]})
    annos.sort(key=lambda a: a["ts"])
    ops.sort(key=lambda o: o["ts"])
    return {"annotations": annos, "ops": ops, "path": "synthetic"}


@pytest.mark.parametrize("seed", range(4))
def test_attribute_is_reference_without_launch_keys(seed):
    parsed = _synthetic(seed)
    assert tprof.attribute(parsed) == jprof.attribute(parsed)


def test_launch_key_joins_the_launching_span():
    annos = [{"name": "gbdt.iteration", "ts": 0.0, "dur": 1.0},
             {"name": "tree.hist", "ts": 0.1, "dur": 0.1},
             {"name": "tree.route", "ts": 0.3, "dur": 0.1}]
    # launched inside tree.hist, run while tree.route is open
    op = {"name": "hist_kernel", "ts": 0.32, "dur": 0.02,
          "module": "hist_route"}
    without = tprof.attribute({"annotations": annos, "ops": [dict(op)]})
    assert list(without["spans"]) == ["tree.route"]
    keyed = tprof.attribute({"annotations": annos,
                             "ops": [dict(op, launch_ts=0.15)]})
    assert list(keyed["spans"]) == ["tree.hist"]
    assert keyed["programs"] == {"hist_route": 0.02}
    # launched after every span closed: the latest started before it
    late = tprof.attribute({"annotations": annos,
                            "ops": [dict(op, ts=2.0, launch_ts=1.5)]})
    assert list(late["spans"]) == ["tree.route"]


def _event(cat, name, ts_us, dur_us, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts_us,
            "dur": dur_us, "pid": 1, "tid": 1, "args": args}


def test_parse_device_layout(tmp_path):
    ev = [
        _event("user_annotation", "gbdt.iteration", 0, 1000),
        _event("user_annotation", "tree.hist", 100, 200),
        _event("user_annotation", "kernel.hist_route", 120, 50),
        _event("cuda_runtime", "cudaLaunchKernel", 130, 5, correlation=7),
        _event("user_annotation", "tree.route", 400, 100),
        _event("cuda_runtime", "cudaLaunchKernel", 410, 5, correlation=8),
        _event("user_annotation", "profile.cost", 420, 30),
        _event("cuda_runtime", "cudaLaunchKernel", 425, 5, correlation=9),
        # the kernels run after their spans closed
        _event("kernel", "void hist_kernel<true, 4>(unsigned char const*)",
               600, 40, correlation=7),
        _event("kernel", "void at::native::elementwise_kernel<128, 2>()",
               650, 10, correlation=8),
        _event("gpu_memset", "Memset (Device)", 665, 2, correlation=9),
        _event("cpu_op", "aten::add", 410, 8),
        _event("python_function", "ignored", 0, 5),
    ]
    path = tmp_path / "x.trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    parsed = tprof.parse_capture(str(tmp_path))
    assert parsed["op_source"] == "device"
    assert [o["module"] for o in parsed["ops"]] == [
        "hist_route", "at::native::elementwise_kernel", "Memset (Device)"]
    assert [o["launch_ts"] for o in parsed["ops"]] == [
        130e-6, 410e-6, 425e-6]
    rep = tprof.attribute(parsed)
    assert rep["spans"] == {
        "tree.hist": {"device_s": 4e-05, "ops": 1},
        "tree.route": {"device_s": 1e-05, "ops": 1},
        "profile.cost": {"device_s": 2e-06, "ops": 1}}
    assert rep["programs"]["hist_route"] == 4e-05
    assert rep["host_gap_s"] == round(1e-3 - 52e-6, 6)


def _toy(n=20000, f=5, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    y = (X[:, 0] + X[:, 1] + rng.normal(size=n) > 0).astype(np.float32)
    return X, y


def test_cpu_capture_of_a_toy_train(monkeypatch, tmp_path):
    X, y = _toy()
    plain = tlgb.train(dict(PARAMS), tlgb.Dataset(X, label=y), 6,
                       device="cpu", verbose_eval=False)
    tobs.reset()
    monkeypatch.setenv("LGBM_TPU_PROFILE", str(tmp_path))
    monkeypatch.setenv("LGBM_TPU_PROFILE_ITERS", "2")
    bst = tlgb.train(dict(PARAMS), tlgb.Dataset(X, label=y), 6,
                     device="cpu", verbose_eval=False)
    assert bst.digest() == plain.digest()      # profiling changes nothing
    rep = tobs.summary()["device_attribution"]
    assert "error" not in rep, rep.get("error")
    assert rep["op_source"] == "cpu_op" and rep["kind"] == "gbdt"
    assert rep["windows"] == 2 and rep["window_iters"] == 2
    assert rep["captured_through_iteration"] == 5
    assert os.path.exists(rep["source"])
    tree = {k: v for k, v in rep["spans"].items() if k.startswith("tree.")}
    assert tree and all(v["device_s"] > 0 for v in tree.values())
    assert rep["coverage"] > 0.9 and rep["window_wall_s"] > 0
    cm = rep["cost_model"]
    assert cm["device_kind"] == "cpu" and cm["peaks"]["sentinel"] is True
    kernels = {r["kernel"]: r for r in cm["kernels"]}
    assert "hist_route" in kernels
    for name, row in kernels.items():
        assert row["launches"] > 0 and row["bytes_accessed"] > 0
        assert row["device_s"] == rep["programs"][name] > 0
        assert row["pct_peak_bw"] is not None
        assert set(rep["kernel_spans"][name]) <= set(rep["spans"])
        assert all(s.startswith("tree.")
                   for s in rep["kernel_spans"][name])
    assert tprof._active_dir is None
    # the capture turned telemetry on after the first (warmup) iteration
    assert tobs.summary()["spans"]["gbdt.iteration"]["count"] == 5


def test_capture_context_and_a_failed_parse(tmp_path):
    with tprof.capture(str(tmp_path), device="cpu") as c:
        with tobs.span("tree.hist"):
            torch.ones(1000).cumsum(0)
    assert "error" not in c.report
    assert c.report["spans"]["tree.hist"]["ops"] >= 1
    bad = tprof.finalize_report(str(tmp_path / "missing"))
    assert bad["error"].startswith("FileNotFoundError")


@pytest.mark.parametrize("bins_dtype", [torch.uint8, torch.int32])
def test_kernel_costs_count_the_wave(bins_dtype):
    """The launch costs that the profiler records and ``chip_smoke.py``
    bounds (one copy, ``ops/route.py`` and ``ops/histogram.py``) against
    a hand count of a toy wave: rows in split leaves move (a row with no
    leaf does not, though leaf 0 is split), the tables of split and
    categorical leaves are read, a seeded wide histogram also reads its
    carry."""
    from lightgbm_tpu_torch.ops.histogram import (hist_cost,
                                                  hist_route_cost,
                                                  hist_wide_cost)
    from lightgbm_tpu_torch.ops.route import (ROUTE_TAB_ROWS, T_ISCAT,
                                              T_SEL, moved_rows, route_cost)
    G, n_pad, L, B, A, C = 3, 16, 8, 4, 2, 4
    elem = torch.empty((), dtype=bins_dtype).element_size()
    bins_t = torch.zeros((G, n_pad), dtype=bins_dtype)
    leaf2 = torch.tensor([[0, 0, 1, 2, 3, -1, -1, 5] * 2,
                          [0] * n_pad], dtype=torch.int32)
    tabs = torch.zeros((ROUTE_TAB_ROWS, L), dtype=torch.int32)
    tabs[T_SEL, [0, 3]] = 1
    tabs[T_ISCAT, [3, 5]] = 1                 # leaf 5 is not split
    cat = torch.zeros((L, B), dtype=torch.uint8)
    assert int(moved_rows(leaf2, tabs)) == 6
    for values, per_row in ((False, 16), (True, 20)):
        nbytes, ops, kind = route_cost(bins_t, leaf2, tabs, cat, values)
        assert int(nbytes) == per_row * n_pad + 6 * elem \
            + 4 * L * (2 if values else 1) + 40 * 2 + B * 1
        assert (ops, kind) == (n_pad, "int32")
    out = torch.zeros((A, G, B, C), dtype=torch.int32)
    nbytes, ops, _ = hist_cost(G, C, n_pad, A, L, out, 5)
    assert nbytes == 4 * n_pad + (G + C) * 5 + out.numel() * 4 \
        + (L + 1 + A) * 4 and ops == G * C * 5
    inv = torch.full((L + 1,), -1, dtype=torch.int32)
    inv[[0, 3]] = torch.tensor([0, 1], dtype=torch.int32)
    vals = torch.zeros((C, n_pad), dtype=torch.int8)
    k1 = hist_route_cost(bins_t, vals, leaf2, leaf2, inv, tabs, cat, out, L)
    slotted = int(((leaf2[1] == 0) | (leaf2[1] == 3)).sum())
    assert int(k1[0]) == hist_cost(G, C, n_pad, A, L, out, slotted)[0] \
        + 12 * n_pad + 6 * elem + 11 * L * 4 + L * B
    plain, _, _ = hist_wide_cost(bins_t, A, B, 5, False)
    seeded, ops, kind = hist_wide_cost(bins_t, A, B, 5, True)
    assert plain == 5 * (G * elem + 8) + 4 * n_pad + A * G * B * 12
    assert seeded == plain + A * G * B * 12
    assert (ops, kind) == (3 * 5 * G, "f32")
