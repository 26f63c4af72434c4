"""lightgbm_tpu_torch's CUDA kernels against their plain versions, on the
card (marked ``cuda``; skipped where no CUDA device is present).

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

(``--noconftest``: the suite's conftest imports JAX, which a GPU machine
with only PyTorch lacks.)

Each kernel wrapper runs on CUDA tensors and on CPU copies of the same
inputs (the plain version); results must be bitwise equal.  The launch
counters must move on CUDA only.
"""
import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.convert import device_data_from_numpy
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.io.dataset import BinnedDataset
from lightgbm_tpu_torch.io.device import feature_meta_np
from lightgbm_tpu_torch.ops import compact as t_compact
from lightgbm_tpu_torch.ops import histogram as t_hist
from lightgbm_tpu_torch.ops import route as t_route

L = 63


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU "
                    "mode (their plain versions are tested on the CPU)")
    return torch.device("cuda")


def _inputs(seed=0, n=20000):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, 8))
    X[rng.rand(n) < 0.1, 1] = np.nan
    ds = BinnedDataset.from_raw(X, Config.from_params({"max_bin": 63}))
    dd = device_data_from_numpy(ds.bins, feature_meta_np(ds), "cpu")
    leaf2 = torch.full((2, dd.n_pad), -1, dtype=torch.int32)
    leaf2[0, :n] = torch.as_tensor(rng.randint(0, 20, size=n))
    leaf2[1, :n] = torch.where(torch.as_tensor(rng.rand(n) < 0.8),
                               leaf2[0, :n], -1)
    F = dd.num_features
    sel = torch.as_tensor(rng.rand(L) < 0.5) & (torch.arange(L) < 20)
    tabs, cat = t_route.leaf_tables(
        torch.as_tensor(rng.randint(0, F, size=L)).int(),
        torch.as_tensor(rng.randint(0, 60, size=L)).int(),
        torch.as_tensor(rng.rand(L) < 0.5), torch.zeros(L, dtype=torch.bool),
        torch.zeros((L, 64), dtype=torch.bool), sel,
        torch.where(sel, 20 + torch.cumsum(sel.int(), 0) - 1, 0).int(),
        dd.missing_types, dd.nan_bins, dd.default_bins, dd.feat_group,
        dd.feat_offset, dd.num_bins)
    g = torch.as_tensor(rng.normal(size=n).astype(np.float32))
    h = torch.as_tensor(rng.uniform(0.01, 0.25, size=n).astype(np.float32))
    vals, _ = t_hist.pack_values_q(g, h, "int8h", dd.n_pad)
    return dd, leaf2, tabs, cat, vals, rng


@pytest.mark.cuda
def test_route_kernels_bitwise(cuda_device):
    dd, leaf2, tabs, cat, vals, rng = _inputs()
    lv = torch.as_tensor(rng.normal(size=L).astype(np.float32))
    cu = [t.to(cuda_device) for t in (dd.bins_t, leaf2, tabs, cat, lv)]
    n0 = t_route.route_rows_raw.launches
    out = t_route.route_rows_raw(*cu[:4])
    assert t_route.route_rows_raw.launches == n0 + 1
    assert torch.equal(out.cpu(), t_route.route_rows_raw(dd.bins_t, leaf2,
                                                         tabs, cat))
    l2, v = t_route.route_rows_values_raw(*cu)
    rl2, rv = t_route.route_rows_values_raw(dd.bins_t, leaf2, tabs, cat, lv)
    assert torch.equal(l2.cpu(), rl2) and torch.equal(v.cpu(), rv)


@pytest.mark.cuda
@pytest.mark.parametrize("A", [8, 32])
def test_hist_route_kernel_bitwise(cuda_device, A):
    dd, leaf2, tabs, cat, vals, rng = _inputs(seed=A)
    active = torch.as_tensor(rng.choice(40, A, replace=False)).int()
    active[-2:] = -1
    args = (dd.bins_t, vals, leaf2, active, tabs, cat)
    raw, l2 = t_hist.hist_route_raw(*[t.to(cuda_device) for t in args], L,
                                    dd.group_max_bins)
    rraw, rl2 = t_hist.hist_route_raw(*args, L, dd.group_max_bins)
    assert torch.equal(raw.cpu(), rraw) and torch.equal(l2.cpu(), rl2)


@pytest.mark.cuda
@pytest.mark.parametrize("A", [64, 128])
def test_hist_compact_kernel_bitwise(cuda_device, A):
    dd, leaf2, tabs, cat, vals, rng = _inputs(seed=A)
    hleaf = t_route.route_rows_raw(dd.bins_t, leaf2, tabs, cat)[1]
    hleaf = hleaf.contiguous()
    active = torch.full((A,), -1, dtype=torch.int32)
    active[:30] = torch.as_tensor(rng.choice(40, 30, replace=False)).int()
    args = (dd.bins_t, vals, hleaf, active)
    raw = t_compact.hist_compact_raw(*[t.to(cuda_device) for t in args], L,
                                     dd.group_max_bins)
    ref = t_compact.hist_compact_raw(*args, L, dd.group_max_bins)
    assert torch.equal(raw.cpu(), ref)
    assert (ref[30:] == 0).all()
