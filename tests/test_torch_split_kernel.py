"""lightgbm_tpu_torch's fused split scan (K6, ``ops/split_kernel.py``)
against the JAX package's ``find_best_splits_pallas`` in interpret mode.

Both take the same consistent histograms (``_consistent_hist`` of
``tests/test_pallas_split.py``: every feature partitions the same
simulated rows).  The port's plain version reproduces the reference
kernel's Hillis-Steele summation order, so every field of the result —
decisions, sums, gains and leaf outputs — must be bitwise equal.  The
cases cover missing values on and off, bin strides 16/64/256, L1/L2
regularisation with ``min_gain_to_split`` and a feature mask.
``split_kernel_ok`` must choose as the reference's does on rows,
categorical features and bin strides; the reference's lane-alignment
condition is the one it drops.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops import pallas_split as jps
from lightgbm_tpu.ops.split import SplitParams as JSplitParams

from lightgbm_tpu_torch.ops import split_kernel as tsk
from lightgbm_tpu_torch.ops.split import SplitParams as TSplitParams

from tests.test_pallas_split import _consistent_hist

torch.set_num_threads(1)   # tiny tensors: more threads only spin

FIELDS = ("gain", "feature", "threshold", "default_left", "left_sum_grad",
          "left_sum_hess", "left_count", "right_sum_grad", "right_sum_hess",
          "right_count", "left_output", "right_output")

FMASK = np.array([1, 0, 1, 0, 1, 1, 0, 1], bool)

# (seed, L2, F, B, missing, split params, feature mask)
CASES = {
    "missing_b16": (0, 14, 8, 16, True, {}, None),
    "no_missing_b16": (1, 14, 8, 16, False, {}, None),
    "missing_b64": (7, 12, 4, 64, True,
                    dict(min_data_in_leaf=20, min_sum_hessian_in_leaf=1.0),
                    None),
    "no_missing_b64": (8, 8, 6, 64, False, {}, None),
    "l1_l2_min_gain": (11, 14, 8, 16, True,
                       dict(lambda_l1=0.5, lambda_l2=2.0,
                            min_gain_to_split=0.1), None),
    "feature_mask": (13, 14, 8, 16, True, {}, FMASK),
    "train_conf_b256": (5, 6, 3, 256, True,
                        dict(min_data_in_leaf=50,
                             min_sum_hessian_in_leaf=5.0), None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_reference_kernel_bitwise(case):
    seed, L2, F, B, missing, kw, fm = CASES[case]
    kw = {"min_data_in_leaf": 5, **kw}
    args = _consistent_hist(seed, L2, F, B, missing=missing)
    ref = jps.find_best_splits_pallas(
        *args, B=B, params=JSplitParams(**kw),
        feature_mask=None if fm is None else jnp.asarray(fm),
        any_missing=missing, interpret=True)
    targs = [torch.as_tensor(np.array(a)) for a in args]
    before = tsk.find_best_splits_kernel.plain_calls
    got = tsk.find_best_splits_kernel(
        *targs, params=TSplitParams(**kw),
        feature_mask=None if fm is None else torch.as_tensor(fm),
        any_missing=missing)
    assert tsk.find_best_splits_kernel.plain_calls == before + 1
    assert (np.asarray(ref.gain) > 0).sum() >= L2 // 2
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    if fm is not None:
        assert fm[got.feature.numpy()].all()


@pytest.mark.parametrize("rows", [1000, 65536, 65537])
@pytest.mark.parametrize("categorical", [False, True])
def test_split_kernel_ok_chooses_as_reference(monkeypatch, rows,
                                              categorical):
    monkeypatch.delenv("LGBM_TPU_SPLIT_KERNEL", raising=False)
    monkeypatch.delenv("LGBM_TPU_COMPILE_LEAN_ROWS", raising=False)
    F = 16                   # F * B is lane-aligned for every B below
    for B in (8, 16, 64, 100, 256, 512):
        assert tsk.split_kernel_ok(F, B, categorical, rows) == \
            jps.split_kernel_ok(F, B, categorical, rows), (B, rows)


def test_split_kernel_ok_drops_lane_condition():
    # 6 x 16 = 96 lanes: the TPU kernel needs multiples of 128, the port
    # does not (the layout changes no result)
    assert not jps.split_kernel_ok(6, 16, False, 3000)
    assert tsk.split_kernel_ok(6, 16, False, 3000)


def test_seg_scans_match_reference_order():
    rng = np.random.RandomState(3)
    for B in (8, 64, 256):
        x = (rng.normal(size=(5, 3 * B)) * 40).astype(np.float32)
        lane_mod = jnp.arange(3 * B)[None, :] & (B - 1)

        def roll(v, k):
            return jnp.roll(v, k, axis=1)

        ref_c, ref_s = jnp.asarray(x), jnp.asarray(x)
        k = 1
        while k < B:
            ref_c = ref_c + jnp.where(lane_mod >= k, roll(ref_c, k), 0.0)
            ref_s = ref_s + jnp.where(lane_mod < B - k, roll(ref_s, -k),
                                      0.0)
            k *= 2
        t = torch.as_tensor(x).reshape(5, 3, B)
        np.testing.assert_array_equal(
            tsk.seg_cumsum(t).reshape(5, 3 * B).numpy(), np.asarray(ref_c))
        np.testing.assert_array_equal(
            tsk.seg_suffix(t).reshape(5, 3 * B).numpy(), np.asarray(ref_s))


def _shfl(r, d, up):
    """``__shfl_up_sync`` / ``__shfl_down_sync`` by ``d`` lanes over the
    lane axis (-2) of ``r``: a lane with no source keeps its own value."""
    S = r.shape[-2]
    lane = torch.arange(S)
    src = lane - d if up else lane + d
    src = torch.where((src >= 0) & (src < S), src, lane)
    return r[..., src, :]


def _lanes(x):
    """``[..., B]`` -> ``[..., S, V]``: each of ``S`` lanes of a segment
    holds ``V = B / 32`` consecutive bins (one bin for B < 32)."""
    B = x.shape[-1]
    V = max(1, B // 32)
    return x.reshape(*x.shape[:-1], B // V, V)


def _lane_prefix(x):
    """The kernel's Hillis-Steele prefix scan in its lane layout: every
    step computes new values from the old ones, a step ``k < V`` in-lane
    from registers plus the crossing term from the lane below by a
    one-lane shuffle, a step ``k >= V`` by a shuffle of ``k / V``
    lanes."""
    B = x.shape[-1]
    r = _lanes(x)
    S, V = r.shape[-2:]
    sl = torch.arange(S)[:, None]
    k = 1
    while k < B:
        if k < V:
            new = r.clone()
            new[..., k:] = r[..., k:] + r[..., :V - k]
            below = _shfl(r[..., V - k:], 1, up=True)
            new[..., :k] = r[..., :k] + torch.where(sl >= 1, below, 0.0)
        else:
            d = k // V
            new = r + torch.where(sl >= d, _shfl(r, d, up=True), 0.0)
        r = new
        k *= 2
    return r.reshape(x.shape)


def _lane_suffix_total(x):
    """The kernel's missing-cell total: of the suffix scan, only the
    adds that reach lane 0's result (``x[i] += x[i + k]`` for ``i`` a
    multiple of ``2k``), in-lane for ``k < V`` and by a shuffle down of
    register 0 by ``k / V`` lanes for ``k >= V``.  -> ``[...]``."""
    B = x.shape[-1]
    r = _lanes(x).clone()
    S, V = r.shape[-2:]
    sl = torch.arange(S)
    k = 1
    while k < V:
        r[..., 0::2 * k] = r[..., 0::2 * k] + r[..., k::2 * k]
        k *= 2
    while k < B:
        d = k // V
        t = _shfl(r[..., :1], d, up=False)[..., 0]
        r[..., 0] = torch.where(sl % (2 * d) == 0, r[..., 0] + t, r[..., 0])
        k *= 2
    return r[..., 0, 0]


def _scan_data(B, rng):
    """Random float32 rows of mixed scales with signed zeros, and rows
    with one nonzero cell among signed zeros (the missing cell's scan)."""
    x = (rng.normal(size=(6, 3, B))
         * 10.0 ** rng.randint(-3, 4, size=(6, 3, B))).astype(np.float32)
    x[rng.rand(*x.shape) < 0.2] = 0.0
    x[rng.rand(*x.shape) < 0.2] = -0.0
    hot = np.where(rng.rand(3, 3, B) < 0.5, -0.0, 0.0).astype(np.float32)
    hot[:2, :, rng.randint(B)] = rng.normal(size=(2, 3)).astype(np.float32)
    hot[2] = -0.0                       # a total of -0.0
    return torch.as_tensor(np.concatenate([x, hot]))


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("B", [2, 4, 8, 16, 32, 64, 128, 256])
def test_lane_decomposition_matches_seg_scans_bitwise(B):
    """The register/shuffle layout of ``csrc/split.cu`` sums in the
    reference's order: its prefix scan is bitwise ``seg_cumsum``, its
    missing total bitwise lane 0 of ``seg_suffix``, and its broadcast
    (the total + 0.0 in every bin) bitwise ``seg_cumsum`` of the total
    moved to lane 0, on random float32 data
    with signed zeros, one-hot rows and totals of +-0, +-inf and nan."""
    t = _scan_data(B, np.random.RandomState(B))
    assert torch.equal(_bits(_lane_prefix(t)), _bits(tsk.seg_cumsum(t)))
    total = _lane_suffix_total(t)
    assert torch.equal(_bits(total), _bits(tsk.seg_suffix(t)[..., 0]))
    tot = torch.cat([total.reshape(-1), torch.tensor(
        [0.0, -0.0, float("inf"), -float("inf"), float("nan")])])
    at0 = torch.zeros(tot.shape + (B,))
    at0[:, 0] = tot
    closed = (tot + 0.0)[:, None].expand(-1, B)
    assert torch.equal(_bits(closed), _bits(tsk.seg_cumsum(at0)))


def test_wrapper_never_runs_plain_off_the_cpu():
    args = [torch.as_tensor(np.array(a)).to("meta")
            for a in _consistent_hist(0, 4, 2, 16)]
    before = tsk.find_best_splits_kernel.plain_calls
    with pytest.raises(ValueError, match="unsupported device"):
        tsk.find_best_splits_kernel(*args, params=TSplitParams())
    assert tsk.find_best_splits_kernel.plain_calls == before
