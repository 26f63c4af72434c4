"""lightgbm_tpu_torch's CUDA kernels against their plain versions, on the
card (marked ``cuda``; skipped where no CUDA device is present).

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

(``--noconftest``: the suite's conftest imports JAX, which a GPU machine
with only PyTorch lacks.)

Each kernel wrapper runs on CUDA tensors and on CPU copies of the same
inputs (the plain version; the histogram kernels of the streamed folds
add into a nonzero carry); results must be bitwise equal — the split
scan's too, every field of its result, at the small-data path's shape
``[64, 28, 256, 3]`` and on waves built to reach every corner of its
lane layout (bin strides 16-256, more features than warps, ties).  The
launch counters must move on CUDA only.  The categorical branch of the
route kernels runs on waves with categorical splits (a bundled
categorical column included).  The compiled predictor (``serve/``, no
kernel of its own) is held to the host oracle on the card, binned
categorical rows included.  Two ranks train data-parallel on the card
(``tests/torch_dist_worker.py``: gloo on one card, NCCL with a card a
rank) to one model, and K5 histograms their waves.  A C host
(``tools/capi_train.cpp``) trains through the port's C library on the
card to ``lgb.train``'s model and predicts as ``Booster.predict``.
"""
import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.convert import device_data_from_numpy
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.io.dataset import BinnedDataset
from lightgbm_tpu_torch.io.binning import MISSING_NAN
from lightgbm_tpu_torch.io.device import feature_meta_np
from lightgbm_tpu_torch.ops import compact as t_compact
from lightgbm_tpu_torch.ops import histogram as t_hist
from lightgbm_tpu_torch.ops import route as t_route
from lightgbm_tpu_torch.ops import split_kernel as t_split
from lightgbm_tpu_torch.ops.split import SplitParams

L = 63


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU "
                    "mode (their plain versions are tested on the CPU)")
    return torch.device("cuda")


def _cat_columns(X, rng):
    """Column 2 becomes 30 categories; columns 5-7 sparse and mutually
    exclusive (EFB bundles them), 6 categorical -> categorical columns."""
    n = len(X)
    X[:, 2] = rng.randint(0, 30, size=n)
    rows = np.arange(n)
    on = rng.rand(n) < 0.3
    X[:, 5] = np.where((rows % 3 == 0) & on, rng.normal(size=n), 0.0)
    X[:, 6] = np.where((rows % 3 == 1) & on, rng.randint(1, 7, size=n), 0)
    X[:, 7] = np.where((rows % 3 == 2) & on, rng.normal(size=n), 0.0)
    return [2, 6]


def _inputs(seed=0, n=20000, max_bin=63, cat=False, cols=8):
    """A wave: leaf vectors with bagged-out rows, split tables, int8h
    values.  With ``cat`` the data has categorical columns (one bundled
    by EFB at 63 bins) and about a third of the leaves split
    categorically with random masks."""
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, cols))
    X[rng.rand(n) < 0.1, 1] = np.nan
    cats = _cat_columns(X, rng) if cat else []
    ds = BinnedDataset.from_raw(X, Config.from_params({"max_bin": max_bin}),
                                categorical_features=cats)
    # the bundle fits one uint8 column at 63 bins, not at 255
    assert not cat or (ds.bundle is not None) == (max_bin == 63)
    dd = device_data_from_numpy(ds.bins, feature_meta_np(ds), "cpu")
    leaf2 = torch.full((2, dd.n_pad), -1, dtype=torch.int32)
    leaf2[0, :n] = torch.as_tensor(rng.randint(0, 20, size=n))
    leaf2[1, :n] = torch.where(torch.as_tensor(rng.rand(n) < 0.8),
                               leaf2[0, :n], -1)
    F = dd.num_features
    B = t_hist.bin_stride(dd.max_bins)
    sel = torch.as_tensor(rng.rand(L) < 0.5) & (torch.arange(L) < 20)
    feature = torch.as_tensor(rng.randint(0, F, size=L)).int()
    threshold = torch.as_tensor(rng.randint(0, max_bin - 3, size=L)).int()
    default_left = torch.as_tensor(rng.rand(L) < 0.5)
    is_cat = torch.zeros(L, dtype=torch.bool)
    cat_mask = torch.zeros((L, B), dtype=torch.bool)
    if cat:
        is_cat = torch.as_tensor(rng.rand(L) < 1 / 3)
        cat_mask = torch.as_tensor(rng.rand(L, B) < 0.5) & is_cat[:, None]
    tabs, cat = t_route.leaf_tables(
        feature, threshold, default_left, is_cat, cat_mask, sel,
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
def test_small_path_kernels_bitwise(cuda_device):
    """K1 and K4 at the small-data path's 256-bin stride and 63 leaves,
    with bagged-out rows that the -1 slots of K1 collect."""
    dd, leaf2, tabs, cat, vals, rng = _inputs(seed=5, n=65536, max_bin=255)
    assert cat.shape == (L, 256)
    active = torch.as_tensor(rng.choice(40, 32, replace=False)).int()
    active[-2:] = -1
    args = (dd.bins_t, vals, leaf2, active, tabs, cat)
    raw, l2 = t_hist.hist_route_raw(*[t.to(cuda_device) for t in args], L,
                                    dd.group_max_bins)
    rraw, rl2 = t_hist.hist_route_raw(*args, L, dd.group_max_bins)
    assert torch.equal(raw.cpu(), rraw) and torch.equal(l2.cpu(), rl2)
    n_oob = int((rl2[1, :dd.num_data] < 0).sum())
    assert n_oob > 0 and int(rraw[-1, 0, :, -1].sum()) == n_oob
    lv = torch.as_tensor(rng.normal(size=L).astype(np.float32))
    cu = [t.to(cuda_device) for t in (dd.bins_t, leaf2, tabs, cat, lv)]
    l2, v = t_route.route_rows_values_raw(*cu)
    rl2, rv = t_route.route_rows_values_raw(dd.bins_t, leaf2, tabs, cat, lv)
    assert torch.equal(l2.cpu(), rl2) and torch.equal(v.cpu(), rv)


@pytest.mark.cuda
def test_ranking_shape_kernels_bitwise(cuda_device):
    """K1 at 32 slots, K2 + K3 at 128 and K4 at the ranking shape: 136
    columns at a 256-bin stride (more columns than one block's tile)
    with int8h values whose hessians are half exactly 0, as lambdarank
    gives every document of a query with equal labels."""
    dd, leaf2, tabs, cat, _, rng = _inputs(seed=7, n=30000, max_bin=255,
                                           cols=136)
    assert dd.bins_t.shape[0] == 136 and cat.shape == (L, 256)
    n = dd.num_data
    g = torch.as_tensor(rng.normal(size=n).astype(np.float32))
    h = torch.as_tensor(rng.uniform(0.01, 0.25, size=n).astype(np.float32))
    h[torch.as_tensor(rng.rand(n) < 0.5)] = 0.0
    g[h == 0] = 0.0
    vals, _ = t_hist.pack_values_q(g, h, "int8h", dd.n_pad)
    active = torch.as_tensor(rng.choice(40, 32, replace=False)).int()
    active[-2:] = -1
    args = (dd.bins_t, vals, leaf2, active, tabs, cat)
    raw, l2 = t_hist.hist_route_raw(*[t.to(cuda_device) for t in args], L,
                                    dd.group_max_bins)
    rraw, rl2 = t_hist.hist_route_raw(*args, L, dd.group_max_bins)
    assert torch.equal(raw.cpu(), rraw) and torch.equal(l2.cpu(), rl2)
    routed = t_route.route_rows_raw(*[t.to(cuda_device) for t in
                                      (dd.bins_t, leaf2, tabs, cat)])
    hleaf = t_route.route_rows_raw(dd.bins_t, leaf2, tabs, cat)
    assert torch.equal(routed.cpu(), hleaf)
    hleaf = hleaf[1].contiguous()
    wide = torch.full((128,), -1, dtype=torch.int32)
    wide[:40] = torch.as_tensor(rng.permutation(40)).int()
    args = (dd.bins_t, vals, hleaf, wide)
    raw = t_compact.hist_compact_raw(*[t.to(cuda_device) for t in args], L,
                                     dd.group_max_bins)
    assert torch.equal(raw.cpu(), t_compact.hist_compact_raw(
        *args, L, dd.group_max_bins))
    lv = torch.as_tensor(rng.normal(size=L).astype(np.float32))
    cu = [t.to(cuda_device) for t in (dd.bins_t, leaf2, tabs, cat, lv)]
    l2, v = t_route.route_rows_values_raw(*cu)
    rl2, rv = t_route.route_rows_values_raw(dd.bins_t, leaf2, tabs, cat, lv)
    assert torch.equal(l2.cpu(), rl2) and torch.equal(v.cpu(), rv)


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


def _carry(rng, shape, dtype):
    """A nonzero carry, as a previous block of a stream leaves it."""
    if dtype == torch.int32:
        return torch.as_tensor(rng.randint(-5000, 5000, size=shape)
                               .astype(np.int32))
    return torch.as_tensor(rng.normal(size=shape).astype(np.float32))


SEEDED_CASES = [("quantized", 32, "uniform"), ("float", 32, "uniform"),
                ("float", 128, "uniform"), ("compact", 128, "uniform"),
                ("quantized", 32, "skewed"), ("float", 32, "skewed"),
                ("quantized", 32, "sparse"), ("float", 32, "sparse"),
                ("float", 128, "sparse")]


def _wave_leaves(hleaf, active, wave, rng):
    """The uniform wave as routed, a skewed one (every row that is not
    padding in the first active slot, as every tree's first wave) or a
    sparse one (each 2,048-row chunk in 2 of the active slots, so most
    slots have no rows in most chunks)."""
    if wave == "uniform":
        return hleaf
    live = active[active >= 0]
    if wave == "skewed":
        return torch.where(hleaf >= 0, live[0], hleaf).contiguous()
    out = hleaf.clone()
    chunk = t_hist.FLOAT_CHUNK
    for k0 in range(0, out.shape[0], chunk):
        pick = live[torch.as_tensor(rng.choice(live.shape[0], 2,
                                               replace=False))]
        seg = out[k0:k0 + chunk]
        choice = pick[torch.as_tensor(rng.randint(0, 2, size=seg.shape[0]))]
        out[k0:k0 + chunk] = torch.where(seg >= 0, choice, seg)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize(
    "kind,A,wave", SEEDED_CASES,
    ids=[f"{k}-{a}" if w == "uniform" else f"{k}-{a}-{w}"
         for k, a, w in SEEDED_CASES])
def test_seeded_hist_kernels_bitwise(cuda_device, kind, A, wave):
    """K5 (quantized and float) and K3, each adding into a nonzero carry,
    against their plain versions on CPU copies of the same inputs, on a
    uniform, a skewed and a sparse wave.  Float results are compared by
    bit pattern (``torch.equal`` takes -0.0 for 0.0); the float carry
    holds some -0.0 cells, which the plain version's adds of +0.0 turn
    into +0.0 and the kernel must too."""
    dd, leaf2, tabs, cat, vals, rng = _inputs(seed=A + len(kind))
    hleaf = t_route.route_rows_raw(dd.bins_t, leaf2, tabs, cat)[1]
    hleaf = hleaf.contiguous()
    active = torch.full((A,), -1, dtype=torch.int32)
    active[:30] = torch.as_tensor(rng.choice(40, 30, replace=False)).int()
    hleaf = _wave_leaves(hleaf, active, wave, rng)
    if kind == "float":
        g = torch.as_tensor(rng.normal(size=dd.num_data).astype(np.float32))
        h = torch.as_tensor(rng.uniform(0.01, 0.25, size=dd.num_data)
                            .astype(np.float32))
        vals = t_hist.pack_values(g, h, "hhilo", dd.n_pad)
        fn, dtype = t_hist.hist_active_float_raw, torch.float32
    elif kind == "quantized":
        fn, dtype = t_hist.hist_active_raw, torch.int32
    else:
        fn, dtype = t_compact.hist_compact_raw, torch.int32
    B = t_hist.bin_stride(dd.group_max_bins)
    acc = _carry(rng, (A, dd.num_groups, B, vals.shape[0]), dtype)
    if kind == "float":
        acc[torch.as_tensor(rng.rand(*acc.shape) < 0.05)] = -0.0
    args = (dd.bins_t, vals, hleaf, active)
    n0 = fn.launches
    got = fn(*[t.to(cuda_device) for t in args], L, dd.group_max_bins,
             acc.to(cuda_device))
    torch.cuda.synchronize()
    assert fn.launches == n0 + 1
    ref = fn(*args, L, dd.group_max_bins, acc.clone())
    if dtype == torch.float32:
        assert torch.equal(got.cpu().view(torch.int32), ref.view(torch.int32))
    else:
        assert torch.equal(got.cpu(), ref)
    assert not torch.equal(ref, acc)


def _split_inputs(seed, L2, F, B, missing=True, n_rows=20000):
    """Consistent histograms from simulated rows (every feature
    partitions the same rows), as the split scan sees them."""
    rng = np.random.RandomState(seed)
    num_bins = rng.randint(B // 2, B + 1, size=F).astype(np.int32)
    mt = (rng.randint(0, 3, size=F) if missing
          else np.zeros(F)).astype(np.int32)
    db = np.array([rng.randint(0, nb) for nb in num_bins], np.int32)
    leaf = rng.randint(0, L2, size=n_rows)
    g = rng.normal(size=n_rows)
    h = np.abs(rng.normal(size=n_rows)) + 0.1
    hist = np.zeros((L2, F, B, 3), np.float32)
    for f in range(F):
        bins = rng.randint(0, num_bins[f], size=n_rows)
        np.add.at(hist[:, f, :, 0], (leaf, bins), g)
        np.add.at(hist[:, f, :, 1], (leaf, bins), h)
        np.add.at(hist[:, f, :, 2], (leaf, bins), 1.0)
    tot = [np.bincount(leaf, w, L2).astype(np.float32)
           for w in (g, h, np.ones(n_rows))]
    return [torch.as_tensor(a) for a in (hist, *tot, num_bins, mt, db)]


def _split_case(L2, F, B, missing, masked, special):
    """A split-scan wave, its feature mask and its params.  ``special``:
    ``"infeasible"`` leaves the last leaf 50 rows' worth of counts, so
    no threshold has ``min_data_in_leaf`` = 50 on both sides (every cell
    is infeasible: the winner must be bin 0 of feature 0);
    ``"nan_last"`` gives every feature all ``B`` bins and a NaN bin (the
    last, where the suffix scan starts) and adds the same large gradient
    to it and to bin 0, so the winners go missing-left and carry the
    suffix total;
    ``"tie"`` makes each odd feature a copy of the even one before it
    (bins, missing type, cells) and empties every missing cell, so the
    winner ties with its twin and, where it has a missing cell, its
    variants tie too."""
    args = _split_inputs(L2 + F + B, L2, F, B, missing)
    hist, tg, th, tc, num_bins, mt, db = args
    if special == "tie":
        for src in range(0, F - 1, 2):
            for t in (num_bins, mt, db):
                t[src + 1] = t[src]
            hist[:, src + 1] = hist[:, src]
        hist[:, t_split.split_masks(num_bins, mt, db, None, B)[1]] = 0.0
    elif special == "nan_last":
        num_bins[:] = B
        mt[:] = MISSING_NAN
        hist[:, :, 0, 0] += 1000.0
        hist[:, :, B - 1, 0] += 1000.0
        tg += 2000.0
    elif special == "infeasible":
        hist[-1, ..., 2] *= 50.0 / float(tc[-1])
        tc[-1] = 50.0
    fm = torch.as_tensor(np.random.RandomState(F).rand(F) < 0.8) \
        if masked else None
    params = SplitParams(min_data_in_leaf=50, min_sum_hessian_in_leaf=5.0)
    return args, fm, params


SPLIT_CASES = {
    "path": (64, 28, 256, True, False, None),
    "path_masked": (64, 28, 256, True, True, None),
    "b64": (16, 6, 64, False, False, None),
    "b256_no_missing": (64, 28, 256, False, True, None),
    **{f"b{B}_f40": (2, 40, B, True, True, "infeasible")
       for B in (16, 32, 64, 128, 256)},
    **{f"b{B}_tie": (1, 40, B, True, False, "tie")
       for B in (16, 32, 64, 128, 256)},
    **{f"b{B}_nan_last": (2, 28, B, True, False, "nan_last")
       for B in (16, 256)},
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_split_kernel_bitwise(cuda_device, case):
    """K6 against its plain version, every field bitwise: bin strides 16
    to 256, more features than a block has warps (F = 40), waves of 1, 2
    and 64 leaves, missing values off and on, a feature mask, a leaf
    whose cells are all infeasible and exact ties between two features
    and between the two variants."""
    L2, F, B, missing, masked, special = SPLIT_CASES[case]
    args, fm, params = _split_case(*SPLIT_CASES[case])
    n0 = t_split.find_best_splits_kernel.launches
    got = t_split.find_best_splits_kernel(
        *[a.to(cuda_device) for a in args], params=params,
        feature_mask=None if fm is None else fm.to(cuda_device),
        any_missing=missing)
    torch.cuda.synchronize()
    assert t_split.find_best_splits_kernel.launches == n0 + 1
    ref = t_split.find_best_splits_kernel(*args, params=params,
                                          feature_mask=fm,
                                          any_missing=missing)
    assert (ref.gain > 0).sum() >= L2 // 2
    if special == "infeasible":
        assert ref.feature[-1] == 0 and ref.threshold[-1] == 0
    if special == "tie":
        assert (ref.feature % 2 == 0).all() and not ref.default_left.any()
    if special == "nan_last":
        assert ref.default_left.all()
    for name in ("gain", "feature", "threshold", "default_left",
                 "left_sum_grad", "left_sum_hess", "left_count",
                 "right_sum_grad", "right_sum_hess", "right_count",
                 "left_output", "right_output"):
        assert torch.equal(getattr(got, name).cpu(), getattr(ref, name)), \
            name


FLOAT_CASES = [("hhilo", 8, "uniform"), ("hilo", 32, "uniform"),
               ("hhilo", 32, "skewed"), ("bf16", 16, "uniform"),
               ("hhilo", 16, "mixed"), ("hilo", 32, "mixed")]


def _walk_sides(hleaf, inv, A, n_pad):
    """Per window of ``FLOAT_WINDOW`` rows of the float K3: (slots with
    heavy pairs, slots walked whole with rows) by its plan kernel's rule
    (``float_walk_split``)."""
    L = inv.shape[0] - 1
    hl = hleaf.long()
    sl = inv.long()[torch.where(hl >= 0, hl, torch.full_like(hl, L))]
    plan = t_hist.float_walk_plan(n_pad, A, 1, 8, 1, L, 132)
    out = []
    for w0 in range(0, n_pad, plan.window):
        rows = min(plan.window, n_pad - w0)
        ws = sl[w0:w0 + rows]
        ks = torch.arange(rows) // t_hist.FLOAT_CHUNK
        counts = [[int(((ws == s) & (ks == k)).sum())
                   for k in range(-(-rows // t_hist.FLOAT_CHUNK))]
                  for s in range(A)]
        hb, lrows, _ = t_hist.float_walk_split(
            counts, t_hist.float_light_rows(rows),
            t_hist.float_dense_rows(rows), plan.pcap)
        out.append((sum(h >= 0 for h in hb),
                    sum(h < 0 and n > 0 for h, n in zip(hb, lrows))))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("mode,A,wave", FLOAT_CASES,
                         ids=[f"{m}-{a}-{w}" for m, a, w in FLOAT_CASES])
def test_float_k1_k3_kernels_bitwise(cuda_device, monkeypatch, mode, A, wave):
    """The float K1 and the float K3 (each over windows of 8,192 rows
    chained through the carry) against their plain versions on CPU
    copies, compared by bit pattern, into a carry with -0.0 cells; on the
    card the float K1 is bitwise K2 followed by the float K5, and the
    float K3 bitwise the float K5 on its non-negative slots (its -1 slots
    keep the carry).  A mixed wave gives two slots most rows (about 1,400
    and 300 a chunk) and the others a few, so every window of the float
    K3 has heavy slots (chunk partials, folded) and light ones
    (walked)."""
    monkeypatch.setattr(t_hist, "FLOAT_WINDOW", 8192)
    # the walk budget the mixed wave is built around
    monkeypatch.setattr(t_hist, "FLOAT_LIGHT_ROWS_PER_CHUNK", 64)
    # 40,000 rows: 20 chunks in 5 windows
    dd, leaf2, tabs, cat, _, rng = _inputs(seed=A + len(mode), n=40000)
    g = torch.as_tensor(rng.normal(size=dd.num_data).astype(np.float32))
    h = torch.as_tensor(rng.uniform(0.01, 0.25, size=dd.num_data)
                        .astype(np.float32))
    vals = t_hist.pack_values(g, h, mode, dd.n_pad)
    active = torch.as_tensor(rng.choice(40, A, replace=False)).int()
    active[-2:] = -1
    if wave == "skewed":
        # every row in leaf active[0], which no split of the wave moves
        leaf2 = torch.where(leaf2 >= 0, active[0], leaf2).contiguous()
        tabs = tabs.clone()
        tabs[t_route.T_SEL, active[0]] = 0
    if wave == "mixed":
        # 70% of the rows in leaf active[0], 15% in active[1], neither
        # split by the wave; the rest where they were
        hv = active[:2].clone()
        pick = torch.as_tensor(rng.rand(dd.num_data))
        row = leaf2[:, :dd.num_data]
        for leaf, p0, p1 in ((hv[0], 0.0, 0.7), (hv[1], 0.7, 0.85)):
            take = (pick >= p0) & (pick < p1)
            row[0] = torch.where(take, leaf, row[0])
            row[1] = torch.where(take & (row[1] >= 0), leaf, row[1])
        leaf2 = leaf2.contiguous()
        tabs = tabs.clone()
        tabs[t_route.T_SEL, hv.long()] = 0
    B = t_hist.bin_stride(dd.group_max_bins)

    def bits(t):
        return t.cpu().view(torch.int32)

    def carry(A):
        c = _carry(rng, (A, dd.num_groups, B, vals.shape[0]), torch.float32)
        c[torch.as_tensor(rng.rand(*c.shape) < 0.05)] = -0.0
        return c

    acc = carry(A)
    cu = [t.to(cuda_device) for t in (dd.bins_t, vals, leaf2, active, tabs,
                                      cat, acc)]
    n0 = t_hist.hist_route_float_raw.launches
    k1, l2 = t_hist.hist_route_float_raw(*cu[:6], L, dd.group_max_bins,
                                         cu[6].clone())
    torch.cuda.synchronize()
    assert t_hist.hist_route_float_raw.launches == n0 + 5   # 5 windows
    ref, rl2 = t_hist.hist_route_float_raw(dd.bins_t, vals, leaf2, active,
                                           tabs, cat, L, dd.group_max_bins,
                                           acc.clone())
    assert torch.equal(l2.cpu(), rl2)
    assert torch.equal(bits(k1), bits(ref)) and not torch.equal(ref, acc)
    routed = t_route.route_rows_raw(cu[0], cu[2], cu[4], cu[5])
    k5 = t_hist.hist_active_float_raw(cu[0], cu[1], routed[1].contiguous(),
                                      cu[3], L, dd.group_max_bins,
                                      cu[6].clone())
    assert torch.equal(bits(k1), bits(k5))

    hleaf = rl2[1].contiguous()
    act3 = torch.full((64 if A < 32 else 128,), -1, dtype=torch.int32)
    if wave == "mixed":
        rest = [x for x in rng.permutation(40) if x not in hv.tolist()]
        act3[:30] = torch.as_tensor(hv.tolist() + rest[:28]).int()
        inv3, _ = t_hist.slot_tables(act3, L, collect_unbagged=False)
        sides = _walk_sides(hleaf, inv3, act3.shape[0], dd.n_pad)
        assert len(sides) == 5 and all(h > 0 and n > 0 for h, n in sides)
    else:
        act3[:30] = torch.as_tensor(rng.choice(40, 30, replace=False)).int()
    if wave == "skewed":
        hleaf = torch.where(hleaf >= 0, act3[0], hleaf).contiguous()
    acc3 = carry(act3.shape[0])
    cu3 = [t.to(cuda_device) for t in (dd.bins_t, vals, hleaf, act3, acc3)]
    n0 = t_compact.hist_compact_float_raw.launches
    k3 = t_compact.hist_compact_float_raw(*cu3[:4], L, dd.group_max_bins,
                                          cu3[4].clone())
    torch.cuda.synchronize()
    assert t_compact.hist_compact_float_raw.launches == n0 + 5   # 5 windows
    ref3 = t_compact.hist_compact_float_raw(dd.bins_t, vals, hleaf, act3, L,
                                            dd.group_max_bins, acc3.clone())
    assert torch.equal(bits(k3), bits(ref3))
    k5 = t_hist.hist_active_float_raw(*cu3[:4], L, dd.group_max_bins,
                                      cu3[4].clone())
    live = act3 >= 0
    assert torch.equal(bits(k3)[live], bits(k5)[live])
    assert torch.equal(bits(k3)[~live], acc3[~live].view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("max_bin", [63, 255])
def test_categorical_kernels_bitwise(cuda_device, max_bin):
    """The categorical branch of the route kernels: K2, K4, K1, the float
    K1 and K3 on the rows K2 routed, on a wave in which about a third of
    the leaves split categorically (at 63 bins one categorical column is
    bundled by EFB), bitwise their plain versions on CPU copies."""
    dd, leaf2, tabs, cat, vals, rng = _inputs(seed=7, max_bin=max_bin,
                                              cat=True)
    assert int(tabs[t_route.T_ISCAT].sum()) > 0
    lv = torch.as_tensor(rng.normal(size=L).astype(np.float32))
    cu = [t.to(cuda_device) for t in (dd.bins_t, leaf2, tabs, cat, lv)]
    out = t_route.route_rows_raw(*cu[:4])
    ref = t_route.route_rows_raw(dd.bins_t, leaf2, tabs, cat)
    assert torch.equal(out.cpu(), ref)
    l2, v = t_route.route_rows_values_raw(*cu)
    rl2, rv = t_route.route_rows_values_raw(dd.bins_t, leaf2, tabs, cat, lv)
    assert torch.equal(l2.cpu(), rl2) and torch.equal(v.cpu(), rv)
    active = torch.as_tensor(rng.choice(40, 16, replace=False)).int()
    active[-2:] = -1
    args = (dd.bins_t, vals, leaf2, active, tabs, cat)
    raw, l2 = t_hist.hist_route_raw(*[t.to(cuda_device) for t in args], L,
                                    dd.group_max_bins)
    rraw, rl2 = t_hist.hist_route_raw(*args, L, dd.group_max_bins)
    assert torch.equal(raw.cpu(), rraw) and torch.equal(l2.cpu(), ref)
    hleaf = ref[1].contiguous()
    act3 = torch.full((64,), -1, dtype=torch.int32)
    act3[:30] = torch.as_tensor(rng.choice(40, 30, replace=False)).int()
    args = (dd.bins_t, vals, hleaf, act3)
    k3 = t_compact.hist_compact_raw(*[t.to(cuda_device) for t in args], L,
                                    dd.group_max_bins)
    assert torch.equal(k3.cpu(), t_compact.hist_compact_raw(
        *args, L, dd.group_max_bins))
    g = torch.as_tensor(rng.normal(size=dd.num_data).astype(np.float32))
    h = torch.as_tensor(rng.uniform(0.01, 0.25, size=dd.num_data)
                        .astype(np.float32))
    fv = t_hist.pack_values(g, h, "hhilo", dd.n_pad)
    args = (dd.bins_t, fv, leaf2, active, tabs, cat)
    fk1, fl2 = t_hist.hist_route_float_raw(
        *[t.to(cuda_device) for t in args], L, dd.group_max_bins)
    rk1, rfl2 = t_hist.hist_route_float_raw(*args, L, dd.group_max_bins)
    assert torch.equal(fl2.cpu(), ref)
    assert torch.equal(fk1.cpu().view(torch.int32), rk1.view(torch.int32))


@pytest.mark.cuda
def test_cuda_binned_categorical_walk(cuda_device):
    """A categorical model compiled onto the card: leaf routing of binned
    rows (unseen, negative and NaN categories at the sentinel bin) ==
    raw rows == the host walk."""
    import lightgbm_tpu_torch as tlgb
    from lightgbm_tpu_torch.models.tree import predict_leaf
    from lightgbm_tpu_torch.serve import compile_model
    rng = np.random.RandomState(3)
    X = rng.normal(size=(20000, 8)).astype(np.float32)
    y = (X[:, 0] + (X[:, 2] % 3 == 1) > 0.5).astype(np.float32)
    cats = _cat_columns(X, rng)
    y = (y + (X[:, 2] % 4 == 1) > 0.5).astype(np.float32)
    bst = tlgb.train({"objective": "binary", "num_leaves": 31,
                      "verbose": -1}, tlgb.Dataset(X, label=y,
                                                   categorical_feature=cats),
                     num_boost_round=5, device=cuda_device)
    models = bst._gbdt.models
    assert any(t.num_cat for t in models)
    Q = X[:5000].copy()
    Q[:500, 2] = 99
    Q[500:700, 2] = -2
    Q[700:900, 6] = np.nan
    cm = compile_model(bst)
    host = predict_leaf(models, Q)
    assert np.array_equal(cm.leaf_indices(Q), host)
    assert np.array_equal(cm.leaf_indices(cm.bin_rows(Q), binned=True), host)


@pytest.mark.cuda
def test_cuda_compiled_predictor_matches_host_oracle(cuda_device):
    """The compiled predictor on the card (``serve/compiler.py``) on a
    seeded 3-class forest with stumps, every missing type and
    categorical nodes: leaf indices bitwise the host oracle, scores
    within one f32 ulp of the f64 host sum, eager and as a replayed
    CUDA graph alike (the same bits); the server scores through the
    warmed graphs only."""
    from chip_smoke import forest_rows, random_forest
    from lightgbm_tpu_torch.models.tree import predict_leaf
    from lightgbm_tpu_torch.serve import PredictionServer, compile_trees
    trees = random_forest(0)
    X = forest_rows(trees, 5000, 100)
    cm = compile_trees(trees, num_class=3, device=cuda_device)
    assert np.array_equal(cm.leaf_indices(X), predict_leaf(trees, X))
    oracle = np.zeros((len(X), 3))
    for i, t in enumerate(trees):
        oracle[:, i % 3] += t.predict_batch(X.astype(np.float64))
    eager = cm.predict_raw(X)                    # bucket 8,192, eager
    assert cm.eager_calls == 1 and cm.captures == 0
    cm.warm([8192])
    graph = cm.predict_raw(X)
    assert cm.captures == 1 and cm.eager_calls == 1
    assert np.array_equal(graph.view(np.int32), eager.view(np.int32))
    ulp = np.spacing(np.abs(oracle).astype(np.float32)).astype(np.float64)
    assert np.all(np.abs(graph.astype(np.float64) - oracle) <= ulp)
    with PredictionServer(cm, max_batch=1024, max_wait_ms=1.0,
                          buckets=(256, 1024), raw_score=True) as srv:
        futs = [srv.submit(X[i:i + k]) for i, k in
                enumerate((1, 17, 300, 1024, 5))]
        for i, (k, fu) in enumerate(zip((1, 17, 300, 1024, 5), futs)):
            got = np.asarray(fu.result(60), np.float64).reshape(k, 3)
            assert np.all(np.abs(got - oracle[i:i + k]) <= ulp[i:i + k])
        st = srv.stats()
    assert st["resolved"] == 5 and st["steady_captures"] == 0
    assert st["steady_eager"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("num_class", [1, 3])
def test_cuda_scores_do_not_depend_on_the_batch(cuda_device, num_class):
    """ROADMAP C35: the same rows scored on the card alone, inside larger
    batches, in row chunks of 64, through the warmed buckets of a server
    (a graph each) and through prediction early stopping with a margin
    no row reaches are bitwise alike, and equal the host walk's f64 sum
    (tree order) rounded once."""
    from chip_smoke import forest_rows, random_forest
    from lightgbm_tpu_torch.serve import PredictionServer, compile_trees
    trees = random_forest(5, num_class=num_class, iters=120 // num_class,
                          num_leaves=31)
    X = forest_rows(trees, 20000, 6)
    want = np.zeros((len(X), num_class))
    for i, t in enumerate(trees):
        want[:, i % num_class] += t.predict_batch(X.astype(np.float64))
    want = want.astype(np.float32)
    want = want if num_class > 1 else want[:, 0]
    R = 3000
    cm = compile_trees(trees, num_class=num_class, device=cuda_device)
    small = compile_trees(trees, num_class=num_class, device=cuda_device,
                          rchunk=64)
    got = {"alone": cm.predict_raw(X[:R]),
           "in_20000": cm.predict_raw(X)[:R],
           "unpadded": cm.predict_raw(X[:R], pad=False),
           "chunks_of_64": small.predict_raw(X)[:R],
           "early_stop": cm.predict_raw_early_stop(X[:R], 3, np.inf)[0]}
    cm.warm([256, 1024, 4096])
    with PredictionServer(cm, max_batch=4096, max_wait_ms=1.0,
                          buckets=(256, 1024, 4096), min_bucket=256,
                          raw_score=True) as srv:
        for b in (256, 1024, 4096):
            got[f"server_{b}"] = np.concatenate([
                np.asarray(srv.submit(X[o:min(o + b, R)]).result(60))
                .reshape(-1, *want.shape[1:]) for o in range(0, R, b)])
        st = srv.stats()
    assert st["steady_captures"] == 0 and st["steady_eager"] == 0
    for name, v in got.items():
        assert np.array_equal(v, want[:R]), name



@pytest.mark.cuda
def test_cuda_booster_predicts_on_card_by_default(cuda_device):
    """A Booster on ``cuda``, trained there or loaded there, predicts
    through the compiled predictor unless asked for the host walk:
    ``device=None`` fills its serving cache and returns f32 within one
    ulp of the f64 host walk (``device=False``), and ``pred_leaf`` gives
    the host's leaves."""
    import lightgbm_tpu_torch as tlgb
    rng = np.random.RandomState(0)
    X = rng.normal(size=(5000, 6)).astype(np.float32)
    X[rng.rand(*X.shape) < 0.1] = np.nan
    y = (np.nan_to_num(X[:, 0]) + np.nan_to_num(X[:, 1]) > 0
         ).astype(np.float32)
    trained = tlgb.train({"objective": "binary", "num_leaves": 15,
                          "num_iterations": 5, "verbose": -1},
                         tlgb.Dataset(X, label=y), device=cuda_device)
    loaded = tlgb.Booster(model_str=trained.model_to_string(),
                          device=cuda_device)
    for bst in (trained, loaded):
        host = bst.predict(X, raw_score=True, device=False)
        assert host.dtype == np.float64 and not bst._serve_cache
        got = bst.predict(X, raw_score=True)
        assert got.dtype == np.float32 and bst._serve_cache
        ulp = np.spacing(np.abs(host).astype(np.float32)).astype(np.float64)
        assert np.all(np.abs(got.astype(np.float64) - host) <= ulp)
        assert np.array_equal(bst.predict(X, pred_leaf=True),
                              bst.predict(X, pred_leaf=True, device=False))


@pytest.mark.cuda
@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
def test_cuda_leaf_percentile_matches_cpu(cuda_device, weighted):
    """The leaf renewal's percentile (sort, searches, interpolation, the
    weighted prefix sum) on the card is bitwise its CPU run."""
    from lightgbm_tpu_torch.objective.objectives import leaf_percentile
    rng = np.random.RandomState(1)
    n, L = 200_000, 255
    values = torch.as_tensor(rng.normal(size=n).astype(np.float32))
    values[torch.as_tensor(rng.rand(n) < 0.05)] = 0.0
    row_leaf = torch.as_tensor(rng.randint(0, L - 3, size=n).astype(
        np.int32))
    w = (torch.as_tensor(rng.uniform(0.1, 2, size=n).astype(np.float32))
         if weighted else None)
    for alpha in (0.5, 0.9):
        cpu = leaf_percentile(values, row_leaf, L, alpha, w)
        gpu = leaf_percentile(values.to(cuda_device),
                              row_leaf.to(cuda_device), L, alpha,
                              None if w is None else w.to(cuda_device))
        assert torch.equal(gpu.cpu().view(torch.int32),
                           cpu.view(torch.int32))


@pytest.mark.cuda
def test_cuda_lambdarank_gradients_match_cpu(cuda_device):
    """LambdaRank gradients on the card against the CPU run of the same
    objective: within ``f32_accum`` (the card's sigmoid and sums round
    differently), and ``0.0`` for docs without pairs."""
    from tools.numcheck.tolerance_registry import tol
    from lightgbm_tpu_torch.io.dataset import Metadata
    from lightgbm_tpu_torch.objective.objectives import LambdarankNDCG
    rng = np.random.RandomState(2)
    sizes = np.concatenate([[1, 2, 17, 300], rng.randint(1, 120, size=200)])
    n = int(sizes.sum())
    md = Metadata()
    md.set_field("label", rng.randint(0, 5, size=n).astype(np.float32))
    md.set_field("group", sizes)
    score = torch.as_tensor(rng.normal(size=n).astype(np.float32))
    out = []
    for dev in ("cpu", cuda_device):
        obj = LambdarankNDCG(Config.from_params({"objective": "lambdarank"}))
        obj.init(md, n, dev)
        out.append([t.cpu().numpy()
                    for t in obj.get_gradients(score.to(dev))])
    for cpu, gpu in zip(*out):
        np.testing.assert_allclose(gpu, cpu, rtol=tol("f32_accum"),
                                   atol=tol("f32_accum"))
    assert out[1][0][0] == 0.0 and out[1][1][0] == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("objective", ["regression_l1", "quantile"])
def test_cuda_renewal_model_equals_cpu(cuda_device, objective):
    """Sign gradients and percentile leaves have no transcendental: an L1
    or quantile model trained on the card is bitwise the CPU model,
    scores included."""
    import lightgbm_tpu_torch as tlgb
    rng = np.random.RandomState(3)
    X = rng.normal(size=(100_000, 8)).astype(np.float32)
    y = (X[:, 0] * 2 + X[:, 1] + rng.normal(size=100_000)).astype(
        np.float32)
    params = {"objective": objective, "num_leaves": 63, "max_bin": 63,
              "verbose": -1}
    digests = [tlgb.train(dict(params), tlgb.Dataset(X, label=y),
                          num_boost_round=3, device=dev).digest()
               for dev in ("cpu", cuda_device)]
    assert digests[0] == digests[1]


@pytest.mark.cuda
def test_cuda_multiclass_trains_and_serves(cuda_device):
    """A 4-class model on the card: K trees an iteration, its train
    multi_logloss within ``metric_coarse`` of the CPU run's, and its
    served probabilities ``[n, K]`` within ``f32_accum_2x`` of the host
    walk's."""
    from tools.numcheck.tolerance_registry import tol
    import lightgbm_tpu_torch as tlgb
    rng = np.random.RandomState(4)
    X = rng.normal(size=(100_000, 8)).astype(np.float32)
    z = X[:, 0] * 2 + X[:, 1] - X[:, 2] + rng.normal(size=100_000)
    y = np.digitize(z, np.quantile(z, [0.25, 0.5, 0.75])).astype(np.float32)
    params = {"objective": "multiclass", "num_class": 4, "num_leaves": 63,
              "max_bin": 63, "verbose": -1}
    losses = []
    for dev in ("cpu", cuda_device):
        ev = {}
        ds = tlgb.Dataset(X, label=y)
        bst = tlgb.train(dict(params), ds, num_boost_round=4,
                         valid_sets=[ds], valid_names=["train"],
                         evals_result=ev, verbose_eval=False, device=dev)
        losses.append(ev["train"]["multi_logloss"])
    np.testing.assert_allclose(losses[1], losses[0],
                               rtol=tol("metric_coarse"),
                               atol=tol("metric_coarse"))
    assert len(bst._gbdt.models) == 16
    prob = bst.predict(X[:5000])
    assert prob.shape == (5000, 4)
    np.testing.assert_allclose(prob, bst.predict(X[:5000], device=False),
                               rtol=0, atol=tol("f32_accum_2x"))


def _replay_booster(device):
    """An L2 Booster on ``device`` over numerical, categorical and
    EFB-bundled columns (``_cat_columns``: column 2 has 30 categories,
    columns 5-7 bundle, 6 categorical), its label reaching each."""
    import lightgbm_tpu_torch as tlgb
    rng = np.random.RandomState(7)
    X = rng.normal(size=(20000, 8))
    cats = _cat_columns(X, rng)
    y = (X[:, 0] + (X[:, 2] % 4) - X[:, 5] + (X[:, 6] % 3)
         + 0.5 * X[:, 7]).astype(np.float32)
    ds = tlgb.Dataset(X, label=y, categorical_feature=cats,
                      params={"max_bin": 63})
    params = {"objective": "regression", "num_leaves": 31, "max_bin": 63,
              "min_data_in_leaf": 5, "verbose": -1}
    return tlgb.Booster(params, ds, device=device), X


@pytest.mark.parametrize("dev", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_host_tree_replay_matches_built_tree(dev):
    """A host tree goes back onto the device as node tables
    (``boosting/gbdt.py:replay_tables``) and walks the binned rows as
    the freshly built tree does: the same leaf for every row and the
    same f32 values, bitwise, with numerical, categorical and
    EFB-bundled nodes; and so does the tree reloaded from its model text
    and aligned with the mappers (categories as value bitsets)."""
    from lightgbm_tpu_torch.boosting.gbdt import replay_tables
    from lightgbm_tpu_torch.learner.serial import (built_tree_leaves,
                                                   predict_built_tree)
    from lightgbm_tpu_torch.models.tree import Tree
    if dev == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    bst, _ = _replay_booster(dev)
    g = bst._gbdt
    ds = g.train_set
    assert ds.bundle is not None and ds.bundle.is_bundled
    fmap = {f: i for i, f in enumerate(ds.used_features)}
    kinds = set()
    for _ in range(4):
        g.train_one_iter()
        bt = g._pending[-1][0]
        host = g._to_host_tree(bt)
        depth = host.max_depth
        loaded = Tree.from_string(host.to_string())
        loaded.align_with_mappers(ds.mappers, fmap)
        dd = g.device_data
        want = built_tree_leaves(bt, dd, depth)
        for t in (host, loaded):
            tabs = replay_tables(t, dd.max_bins, dd.device)
            assert torch.equal(built_tree_leaves(tabs, dd, depth), want)
            assert torch.equal(g._replay(t, dd),
                               predict_built_tree(bt, dd, depth))
        m = host.num_leaves - 1
        kinds.update(int(ds.mappers[f].bin_type)
                     for f in host.split_feature[:m])
        kinds.update("bundled" for f in host.split_feature[:m]
                     if f in (5, 6, 7))
    assert kinds == {0, 1, "bundled"}


@pytest.mark.cuda
def test_cuda_kill_and_resume_byte_identical(cuda_device, tmp_path):
    """A run on the card killed while writing its iteration-8 snapshot
    resumes from iteration 4 and writes the uninterrupted card run's
    model text; the digest, scores included, is the same."""
    import lightgbm_tpu_torch as tlgb
    from lightgbm_tpu_torch.utils import faults
    rng = np.random.RandomState(8)
    X = rng.normal(size=(50_000, 8)).astype(np.float32)
    y = (X[:, 0] * 2 + X[:, 1] + rng.normal(size=50_000) > 0).astype(
        np.float32)

    def run(prefix, **kw):
        params = {"objective": "binary", "num_leaves": 63, "max_bin": 63,
                  "verbose": -1, "snapshot_freq": 4, "bagging_freq": 2,
                  "bagging_fraction": 0.8, "output_model": str(prefix)}
        return tlgb.train(params, tlgb.Dataset(X, label=y),
                          num_boost_round=12, verbose_eval=False,
                          device=cuda_device, **kw)

    a = run(tmp_path / "A.txt")
    faults.inject("snapshot.write", times=1, skip=1)
    try:
        with pytest.raises(faults.FaultInjected):
            run(tmp_path / "B.txt")
    finally:
        faults.clear()
    b = run(tmp_path / "B.txt", resume_from=str(tmp_path / "B.txt"))
    assert b.model_to_string() == a.model_to_string()
    assert b.digest() == a.digest()


def _entry_data(n=40_000, seed=9):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, 8)).astype(np.float32)
    z = (X[:, 0] * 2 + X[:, 1] - X[:, 2] + rng.normal(size=n)).astype(
        np.float32)
    return X, z


@pytest.mark.cuda
def test_cuda_sklearn_classifier_is_train(cuda_device):
    """``LGBMClassifier`` on the card trains ``lgb.train``'s model with the
    parameters it maps to (digest with scores), and ``predict_proba``'s
    positive column is ``Booster.predict`` bitwise."""
    import lightgbm_tpu_torch as tlgb
    X, z = _entry_data()
    y = (z > 0).astype(np.float32)
    launched = t_hist.hist_route_raw.launches
    clf = tlgb.LGBMClassifier(n_estimators=6, num_leaves=63, max_bin=63,
                              verbose=-1, device=cuda_device.type).fit(X, y)
    assert t_hist.hist_route_raw.launches > launched
    params = {"objective": "binary", "num_leaves": 63, "max_bin": 63,
              "verbose": -1, "bin_construct_sample_cnt": 200000,
              "min_sum_hessian_in_leaf": 1e-3, "min_data_in_leaf": 20}
    ref = tlgb.train(params, tlgb.Dataset(X, label=y), 6,
                     verbose_eval=False, device=cuda_device)
    assert clf.booster_.digest() == ref.digest()
    np.testing.assert_array_equal(clf.predict_proba(X)[:, 1],
                                  ref.predict(X))


@pytest.mark.cuda
def test_cuda_fobj_l2_is_builtin_regression(cuda_device):
    """An L2 ``fobj`` on the card trains the built-in ``regression``
    model bitwise, scores included (both without ``boost_from_average``)."""
    import lightgbm_tpu_torch as tlgb
    X, z = _entry_data()

    def l2(score, dataset):
        return score - dataset.get_label(), np.ones_like(score)

    params = {"num_leaves": 63, "max_bin": 63, "verbose": -1,
              "boost_from_average": False}
    a = tlgb.train(dict(params, objective="regression"),
                   tlgb.Dataset(X, label=z), 6, verbose_eval=False,
                   device=cuda_device)
    b = tlgb.train(dict(params), tlgb.Dataset(X, label=z), 6, fobj=l2,
                   verbose_eval=False, device=cuda_device)
    assert b.digest() == a.digest()


def _wide_wave(seed, n, G, max_bin, L, A, n_active, int32=True, skew=False,
               one_bin=False, live_slot=0, spread=False):
    """A wave of the wide-bin / deep-tree backend: random bins (int32 or
    uint8), gradients over eight decades (where the order of a sum
    shows), hist leaves with bagged-out (-1) rows, ``A`` slots of which
    ``n_active`` hold leaves (the first ones, or with ``spread`` slots
    drawn from all ``A``); ``skew`` puts every row in leaf 0, held by
    slot ``live_slot`` alone (the root wave); ``one_bin`` puts every row
    of column 1 in one bin (one chain holds the whole slot)."""
    rng = np.random.RandomState(seed)
    n_pad = -(-n // 2048) * 2048
    dt = torch.int32 if int32 else torch.uint8
    bins_t = torch.zeros((G, n_pad), dtype=dt)
    bins_t[:, :n] = torch.as_tensor(rng.randint(0, max_bin, (G, n))).to(dt)
    if one_bin:
        bins_t[1, :n] = max_bin // 2
    g = torch.as_tensor((rng.randn(n) * 10.0 ** rng.uniform(-5, 3, n))
                        .astype(np.float32))
    h = torch.as_tensor((rng.rand(n) * 10.0 ** rng.uniform(-5, 3, n))
                        .astype(np.float32))
    leaf = (np.zeros(n, np.int64) if skew
            else rng.randint(0, min(L, 2 * n_active), n))
    hl = torch.full((n_pad,), -1, dtype=torch.int32)
    hl[:n] = torch.as_tensor(np.where(rng.rand(n) < 0.8, leaf, -1))
    active = torch.full((A,), -1, dtype=torch.int32)
    if skew:
        active[live_slot] = 0
    else:
        leaves = torch.as_tensor(
            rng.permutation(min(L, 2 * n_active))[:n_active], dtype=torch.int32)
        if spread:
            active[torch.as_tensor(rng.permutation(A)[:n_active])] = leaves
        else:
            active[:n_active] = leaves
    return bins_t, g, h, hl, active


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    (0, 200_000, 28, 1023, 255, 128, 100, {}),
    (1, 200_000, 28, 1023, 255, 128, 1, {"skew": True}),
    (2, 100_000, 8, 63, 2048, 1024, 1000, {"int32": False}),
    (3, 50_000, 5, 300, 31, 16, 16, {}),
    (4, 100_000, 6, 63, 6000, 3000, 2900, {"int32": False}),
    (5, 4_000, 3, 15, 131072, 65536, 3000, {"int32": False}),
    (6, 60_000, 3, 65535, 15, 8, 8, {}),
    (7, 60_000, 3, 63, 15, 8, 1, {"int32": False, "skew": True,
                                  "one_bin": True}),
    (8, 100_000, 28, 63, 2048, 1024, 1, {"int32": False, "skew": True,
                                         "live_slot": 517}),
    (9, 4_000, 3, 15, 131088, 65544, 3000, {"int32": False, "spread": True}),
    (10, 60_000, 3, 70000, 15, 8, 8, {})],
    ids=["wide", "wide-root", "deep", "small", "deeper", "slots65536",
         "maxbin65535", "one-bin-column", "root-among-1024", "slots65544",
         "maxbin70000"])
def test_hist_wide_kernel_bitwise(cuda_device, case):
    """The exact-f32 wide histogram on the card equals its plain version
    on CPU copies bit for bit (the row order of each cell is kept), at
    65,536 slots and a 65,536-bin stride, and past both (a third digit
    pass of the slot sort; bins staged as int32); one launch count per
    call, on the card only."""
    seed, n, G, mb, L, A, n_act, kw = case
    bins_t, g, h, hl, active = _wide_wave(seed, n, G, mb, L, A, n_act, **kw)
    ref = t_hist.hist_wide_raw(bins_t, g, h, hl, active, L, mb)
    before = t_hist.hist_wide_raw.launches
    got = t_hist.hist_wide_raw(*[t.to(cuda_device) for t in
                                 (bins_t, g, h, hl, active)], L, mb)
    torch.cuda.synchronize()
    assert t_hist.hist_wide_raw.launches == before + 1
    assert torch.equal(got.cpu().view(torch.int32), ref.view(torch.int32))
    assert ref[:, :, :, 2].sum() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    (20, 200_000, 28, 1023, 255, 128, 100, {}),
    (21, 200_000, 28, 1023, 255, 128, 1, {"skew": True}),
    (22, 100_000, 8, 63, 2048, 1024, 1000, {"int32": False}),
    (23, 60_000, 3, 65535, 15, 8, 8, {}),
    (24, 100_000, 28, 63, 2048, 1024, 1, {"int32": False, "skew": True,
                                          "live_slot": 517}),
    (25, 4_000, 3, 15, 131072, 65536, 3000, {"int32": False})],
    ids=["wide", "wide-root", "deep", "maxbin65535", "root-among-1024",
         "slots65536"])
def test_hist_wide_seeded_kernel_bitwise(cuda_device, case):
    """The seeded wide histogram on the card equals its plain version on
    CPU copies bit for bit: the carry of a previous block (large, so a
    seed added at the end would show), this block's rows added into it
    in row order, on every kind of item (warp, block, and the root's
    rounds summed in order); slots without rows keep their carry; one
    count in ``HIST_WIDE_SEEDED`` per call."""
    seed, n, G, mb, L, A, n_act, kw = case
    bins_t, g, h, hl, active = _wide_wave(seed, n, G, mb, L, A, n_act, **kw)
    b0, g0, h0, hl0, _ = _wide_wave(seed + 100, n, G, mb, L, A, n_act, **kw)
    carry = t_hist.hist_wide_raw(b0, g0 * 1048576.0, h0, hl0, active, L, mb)
    carry[A - 1] = 3.0                 # a slot no row of this block reaches
    ref = t_hist.hist_wide_raw(bins_t, g, h, hl, active, L, mb,
                               acc=carry.clone())
    before = (t_hist.HIST_WIDE_SEEDED.launches, t_hist.hist_wide_raw.launches)
    acc = carry.to(cuda_device)
    got = t_hist.hist_wide_raw(*[t.to(cuda_device) for t in
                                 (bins_t, g, h, hl, active)], L, mb, acc=acc)
    torch.cuda.synchronize()
    assert got.data_ptr() == acc.data_ptr()
    assert (t_hist.HIST_WIDE_SEEDED.launches,
            t_hist.hist_wide_raw.launches) == (before[0] + 1, before[1])
    assert torch.equal(got.cpu().view(torch.int32), ref.view(torch.int32))
    if active[A - 1] < 0:
        assert torch.equal(got[A - 1].cpu(), carry[A - 1])


@pytest.mark.cuda
def test_route_kernels_int32_bitwise(cuda_device):
    """K2 and K4 on int32 bins (a group of more than 256 bins) equal their
    plain versions, and count into the int32 instantiations."""
    dd, leaf2, tabs, cat, _, _ = _inputs(seed=9, max_bin=1023)
    assert dd.bins_t.dtype == torch.int32 and dd.group_max_bins > 256
    lv = torch.randn(L)
    cu = [t.to(cuda_device) for t in (dd.bins_t, leaf2, tabs, cat, lv)]
    before = (t_route.ROUTE_I32.launches, t_route.ROUTE_VALUES_I32.launches,
              t_route.route_rows_raw.launches)
    out = t_route.route_rows_raw(*cu[:4])
    l2, vals = t_route.route_rows_values_raw(*cu)
    torch.cuda.synchronize()
    assert torch.equal(out.cpu(), t_route.route_plain(dd.bins_t, leaf2, tabs,
                                                      cat))
    rl2, rv = t_route.route_values_plain(dd.bins_t, leaf2, tabs, cat, lv)
    assert torch.equal(l2.cpu(), rl2) and torch.equal(vals.cpu(), rv)
    assert (t_route.ROUTE_I32.launches, t_route.ROUTE_VALUES_I32.launches,
            t_route.route_rows_raw.launches) == (before[0] + 1,
                                                 before[1] + 1, before[2])


@pytest.mark.cuda
def test_route_kernels_deep_tables_bitwise(cuda_device):
    """K2 and K4 past the leaves whose records stage in shared memory
    (6,000 leaves: records packed into global memory) equal their plain
    versions."""
    rng = np.random.RandomState(4)
    n, G, Ld = 50_000, 6, 6000
    n_pad = 51_200
    bins_t = torch.zeros((G, n_pad), dtype=torch.uint8)
    bins_t[:, :n] = torch.as_tensor(rng.randint(0, 63, (G, n)))
    leaf2 = torch.full((2, n_pad), -1, dtype=torch.int32)
    leaf2[0, :n] = torch.as_tensor(rng.randint(0, 3000, n))
    leaf2[1, :n] = torch.where(torch.as_tensor(rng.rand(n) < 0.8),
                               leaf2[0, :n], -1)
    sel = torch.as_tensor(rng.rand(Ld) < 0.5) & (torch.arange(Ld) < 3000)
    zeros = torch.zeros(G, dtype=torch.int32)
    tabs, cat = t_route.leaf_tables(
        torch.as_tensor(rng.randint(0, G, Ld)).int(),
        torch.as_tensor(rng.randint(0, 60, Ld)).int(),
        torch.as_tensor(rng.rand(Ld) < 0.5), torch.zeros(Ld, dtype=torch.bool),
        torch.zeros((Ld, 64), dtype=torch.bool), sel,
        torch.where(sel, 3000 + torch.cumsum(sel.int(), 0) - 1, 0).int(),
        zeros, torch.full((G,), -1, dtype=torch.int32), zeros,
        torch.arange(G, dtype=torch.int32),
        torch.full((G,), -1, dtype=torch.int32),
        torch.full((G,), 63, dtype=torch.int32))
    lv = torch.randn(Ld)
    cu = [t.to(cuda_device) for t in (bins_t, leaf2, tabs, cat, lv)]
    out = t_route.route_rows_raw(*cu[:4])
    l2, vals = t_route.route_rows_values_raw(*cu)
    torch.cuda.synchronize()
    assert torch.equal(out.cpu(), t_route.route_plain(bins_t, leaf2, tabs,
                                                      cat))
    rl2, rv = t_route.route_values_plain(bins_t, leaf2, tabs, cat, lv)
    assert torch.equal(l2.cpu(), rl2) and torch.equal(vals.cpu(), rv)
    assert (rl2[0, :n] != leaf2[0, :n]).any()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["2048-64", "2048-1024-efb-cat",
                                  "131072-efb-cat", "131072-wide-fields",
                                  "maxbin70000"])
def test_route_kernels_deep_waves_bitwise(cuda_device, case):
    """K2 and K4 equal their plain versions on CPU copies at deep-tree
    waves (``tests/route_waves.py``, 20x the CPU tests' rows: several
    batches a thread): 2,048-leaf tables with 64 and 1,024 splits (the
    staged layout), a third of them categorical and EFB-bundled; the
    last wave of a 131,072-leaf tree, 65,536 splits (the global layout);
    int32 bins past 70,000 with group ids past 255 and right children
    past 65,535, and at ``max_bin`` 70000; bagged-out and padding rows
    in each.  One launch count per call, on the card only."""
    from tests.route_waves import CASES, deep_wave
    kw = dict(CASES[case], n=20 * CASES[case]["n"])
    bins_t, leaf2, tables, metas = deep_wave(**kw)
    order = ("feature", "threshold", "default_left", "is_categorical",
             "cat_mask", "sel", "new_id")
    meta = ("missing_types", "nan_bins", "default_bins", "feat_group",
            "feat_offset", "num_bins")
    tabs, cat = t_route.leaf_tables(
        *[torch.as_tensor(tables[k]) for k in order],
        *[torch.as_tensor(metas[k]) for k in meta])
    bt, l2 = torch.as_tensor(bins_t), torch.as_tensor(leaf2)
    lv = torch.as_tensor(np.random.RandomState(kw["seed"]).normal(
        size=kw["L"]).astype(np.float32))
    cu = [t.to(cuda_device) for t in (bt, l2, tabs, cat, lv)]
    k2 = t_route.ROUTE_I32 if kw.get("int32") else t_route.route_rows_raw
    k4 = (t_route.ROUTE_VALUES_I32 if kw.get("int32")
          else t_route.route_rows_values_raw)
    before = (k2.launches, k4.launches)
    out = t_route.route_rows_raw(*cu[:4])
    l2o, vals = t_route.route_rows_values_raw(*cu)
    torch.cuda.synchronize()
    assert (k2.launches, k4.launches) == (before[0] + 1, before[1] + 1)
    ref = t_route.route_rows_raw(bt, l2, tabs, cat)
    rl2, rv = t_route.route_rows_values_raw(bt, l2, tabs, cat, lv)
    assert torch.equal(out.cpu(), ref) and torch.equal(l2o.cpu(), rl2)
    assert torch.equal(vals.cpu().view(torch.int32), rv.view(torch.int32))
    n = kw["n"]
    assert (ref[0, :n] != l2[0, :n]).any() and (ref[:, n:] == -1).all()


def _distinct_data(n=70_000, seed=11):
    """Rows whose first column has a distinct value each: at ``max_bin``
    65535 (``min_data_in_bin`` 3) its group holds more than 16,384 bins,
    past the earlier wide kernel's 32,768-bin-stride limit; at 210,000
    rows and ``max_bin`` 70000 more than 65,536, a 131,072-bin stride."""
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, 3)).astype(np.float32)
    X[:, 0] = rng.permutation(n).astype(np.float32)
    z = (X[:, 1] * 2 + (X[:, 0] / n) - X[:, 2] + rng.normal(size=n)).astype(
        np.float32)
    return X, z


@pytest.mark.cuda
@pytest.mark.parametrize("params", [
    {"max_bin": 511, "num_leaves": 63},
    {"max_bin": 63, "num_leaves": 1100, "min_data_in_leaf": 2},
    {"max_bin": 63, "num_leaves": 6000, "min_data_in_leaf": 2},
    {"max_bin": 15, "num_leaves": 131072, "min_data_in_leaf": 1,
     "min_sum_hessian_in_leaf": 0.0},
    {"max_bin": 65535, "num_leaves": 31},
    {"max_bin": 70000, "num_leaves": 31}],
    ids=["wide", "deep", "deeper", "leaves131072", "maxbin65535",
         "maxbin70000"])
def test_cuda_wide_and_deep_train_as_cpu(cuda_device, params):
    """L2 models past the kernels' domain train on the card through the
    wide histogram and K2/K4, and equal the CPU's (plain versions) in
    every tree and score: the wide histogram adds in the CPU's order.
    LightGBM's largest ``num_leaves`` (65,536 slots a wave) and
    ``max_bin`` 65535 with more than 16,384 bins in a group train too, and
    ``max_bin`` 70000 with more than 65,536."""
    import lightgbm_tpu_torch as tlgb
    from lightgbm_tpu_torch.io.device import to_device
    if params["num_leaves"] == 131072:
        X, z = _entry_data(n=300)
        X = X[:, :3]
    elif params["max_bin"] >= 65535:
        mb = params["max_bin"]
        X, z = _distinct_data(70_000 if mb == 65535 else 210_000)
        ds = tlgb.Dataset(X, label=z, params={"max_bin": mb}).construct()
        dd = to_device(ds._constructed, "cpu")
        assert dd.bins_t.dtype == torch.int32
        assert dd.group_max_bins > (16384 if mb == 65535 else 65536)
    else:
        X, z = _entry_data()
    p = {"objective": "regression", "verbose": -1, **params}
    launched = t_hist.hist_wide_raw.launches
    a = tlgb.train(dict(p), tlgb.Dataset(X, label=z), 3, verbose_eval=False,
                   device=cuda_device)
    assert t_hist.hist_wide_raw.launches > launched
    b = tlgb.train(dict(p), tlgb.Dataset(X, label=z), 3, verbose_eval=False,
                   device="cpu")
    assert a.digest() == b.digest()
    if params["num_leaves"] == 131072:
        assert max(t.num_leaves for t in a._gbdt.models) > 256


@pytest.mark.cuda
@pytest.mark.parametrize("boosting", ["goss", "dart", "rf"])
def test_cuda_variants_train_as_cpu(cuda_device, boosting):
    """L2 GOSS, DART and random forests on the card equal the CPU's runs
    (digest with scores): the keyed draws, the replay sum's order and the
    kernels are the same on both."""
    import lightgbm_tpu_torch as tlgb
    X, z = _entry_data()
    p = {"objective": "regression", "num_leaves": 63, "max_bin": 63,
         "verbose": -1, "boosting": boosting, "drop_rate": 0.5,
         "skip_drop": 0.1, "bagging_freq": 1, "bagging_fraction": 0.8}
    a = tlgb.train(dict(p), tlgb.Dataset(X, label=z), 8, verbose_eval=False,
                   device=cuda_device)
    b = tlgb.train(dict(p), tlgb.Dataset(X, label=z), 8, verbose_eval=False,
                   device="cpu")
    assert a.model_to_string() == b.model_to_string()
    assert a.digest() == b.digest()


@pytest.mark.cuda
@pytest.mark.parametrize("params", [
    {"max_bin": 511, "num_leaves": 63},
    {"max_bin": 63, "num_leaves": 1100, "min_data_in_leaf": 2}],
    ids=["wide", "deep"])
def test_cuda_wide_and_deep_stream_as_cpu(cuda_device, params):
    """Streams past the kernels' domain train on the card through the
    seeded wide histogram and K2/K4 in two blocks, and equal the CPU's
    stream and the card's in-memory model, scores included."""
    import lightgbm_tpu_torch as tlgb
    from lightgbm_tpu_torch.boosting.streaming import StreamTrainer
    X, z = _entry_data()
    p = {"objective": "regression", "verbose": -1, **params}
    cfg = Config.from_params(p)
    ds = tlgb.Dataset(X, label=z, params={"max_bin": p["max_bin"]}).construct()
    seeded = t_hist.HIST_WIDE_SEEDED.launches
    a = StreamTrainer(cfg, ds._constructed, block_rows=32768,
                      device=cuda_device).train(3)
    assert t_hist.HIST_WIDE_SEEDED.launches > seeded
    b = StreamTrainer(cfg, ds._constructed, block_rows=32768,
                      device="cpu").train(3)
    c = tlgb.train(dict(p), tlgb.Dataset(X, label=z), 3, verbose_eval=False,
                   device=cuda_device)
    assert a.digest() == b.digest() == c.digest()


@pytest.mark.cuda
def test_cuda_profiled_train_attributes_kernels(cuda_device, tmp_path,
                                                monkeypatch):
    """``LGBM_TPU_PROFILE`` on the card: the capture's device ops are the
    port's kernels, joined by their launches to the ``tree.*`` spans,
    with a cost-model row each against the H100 peaks; the profiled
    model equals the unprofiled one."""
    import lightgbm_tpu_torch as tlgb
    from lightgbm_tpu_torch import obs
    X, z = _entry_data(n=80_000)
    p = {"objective": "regression", "num_leaves": 255, "max_bin": 63,
         "verbose": -1}
    plain = tlgb.train(dict(p), tlgb.Dataset(X, label=z), 6,
                       verbose_eval=False, device=cuda_device)
    obs.reset()
    monkeypatch.setenv("LGBM_TPU_PROFILE", str(tmp_path))
    monkeypatch.setenv("LGBM_TPU_PROFILE_ITERS", "2")
    bst = tlgb.train(dict(p), tlgb.Dataset(X, label=z), 6,
                     verbose_eval=False, device=cuda_device)
    monkeypatch.delenv("LGBM_TPU_PROFILE")
    rep = obs.summary()["device_attribution"]
    obs.reset()
    assert bst.digest() == plain.digest()
    assert "error" not in rep, rep.get("error")
    assert rep["op_source"] == "device" and rep["device_time_s"] > 0
    kernels = {r["kernel"]: r for r in rep["cost_model"]["kernels"]}
    assert {"hist_route", "route", "hist_compact", "route_values"} <= \
        set(kernels)
    for name, row in kernels.items():
        assert row["device_s"] and row["device_s"] > 0, name
        assert row["pct_peak_bw"] is not None, name
        spans = rep["kernel_spans"][name]
        assert spans and all(s and s.startswith("tree.") for s in spans), \
            (name, spans)
    assert "H100" in rep["cost_model"]["device_kind"] or \
        rep["cost_model"]["peaks"].get("hbm_bytes_per_s") is None


@pytest.mark.cuda
def test_cuda_mem_contract_catches_a_leak(cuda_device, monkeypatch):
    """On the card the watermark samples ``torch.cuda.memory_allocated``:
    a clean run has no violation, ``mem.leak`` is caught and named."""
    import lightgbm_tpu_torch as tlgb
    from lightgbm_tpu_torch import obs
    from lightgbm_tpu_torch.boosting import gbdt
    from lightgbm_tpu_torch.utils import faults
    monkeypatch.setenv("LGBM_TPU_MEM_CONTRACT", "1")
    X, z = _entry_data()
    p = {"objective": "regression", "num_leaves": 63, "verbose": -1}
    obs.reset()
    obs.enable()
    tlgb.train(dict(p), tlgb.Dataset(X, label=z), 6, verbose_eval=False,
               device=cuda_device)
    rep = obs.summary()["mem_contract"]
    assert rep["source"] == "memory_allocated" and rep["steady_ok"]
    assert rep["inplace_checked"] and rep["inplace_ok"]
    obs.reset()
    obs.enable()
    faults.inject("mem.leak", times=100)
    try:
        tlgb.train(dict(p), tlgb.Dataset(X, label=z), 6, verbose_eval=False,
                   device=cuda_device)
    finally:
        faults.clear()
        gbdt._MEM_LEAK_SINK.clear()
    rep = obs.summary()["mem_contract"]
    obs.reset()
    assert rep["violation_count"] >= 1
    assert rep["violations"][0]["span"] == "gbdt.iteration"


@pytest.mark.cuda
def test_cuda_no_steady_compile_events_after_warm(cuda_device, monkeypatch):
    """Under the trace contract a server's graph captures all fall before
    ``warm()``'s steady mark: zero steady compile events and captures."""
    from chip_smoke import forest_rows, random_forest
    from lightgbm_tpu_torch import obs
    from lightgbm_tpu_torch.serve import PredictionServer, compile_trees
    monkeypatch.setenv("LGBM_TPU_TRACE_CONTRACT", "1")
    trees = random_forest(0)
    X = forest_rows(trees, 3000, 100)
    cm = compile_trees(trees, num_class=3, device=cuda_device)
    obs.reset()
    with PredictionServer(cm, max_batch=1024, max_wait_ms=1.0,
                          buckets=(256, 1024), raw_score=True) as srv:
        futs = [srv.submit(X[i:i + k]) for i, k in
                enumerate((1, 17, 300, 1024, 5))]
        for fu in futs:
            fu.result(60)
        st = srv.stats()
    rep = obs.summary()["serve_trace_contract"]
    obs.reset()
    assert rep["compiles_warmup"] == 2 and rep["compiles_steady"] == 0
    assert rep["steady_ok"] and st["steady_captures"] == 0


@pytest.mark.cuda
def test_cuda_data_parallel_two_ranks(cuda_device, tmp_path):
    """A world of two ranks on the card (both on card 0 over gloo on a
    one-card machine): ``lgb.train(tree_learner="data")`` gives both ranks
    one model, and the in-memory K5 launches on each."""
    from tests.torch_dist_worker import run_world
    rng = np.random.RandomState(1)
    X = rng.normal(size=(20000, 8))
    y = ((X[:, 0] + 0.5 * X[:, 1] + 0.3 * rng.normal(size=20000)) > 0
         ).astype(np.float32)
    path = str(tmp_path / "xy.npz")
    np.savez(path, X=X, y=y)
    params = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
              "tree_learner": "data", "verbose": -1}
    res = run_world([dict(name="dp", kind="train", input=path, params=params,
                          rounds=3)], 2, str(tmp_path / "out"),
                    device="cuda")
    (_, a), (_, b) = res["dp"]
    assert "error" not in a and "error" not in b, a.get("traceback")
    assert a["model"] == b["model"] and a["iterations"] == 3
    assert a["k5_launches"] > 0 and b["k5_launches"] > 0


@pytest.mark.cuda
def test_cuda_capi_host_trains_on_the_card(cuda_device, tmp_path):
    """``tools/capi_train.cpp`` through the port's C library, with no
    device request (so on the card): the model is ``lgb.train``'s on the
    card, and its ``LGBM_BoosterPredictForMat`` predictions are
    ``Booster.predict``'s on the card, bitwise."""
    import os
    import subprocess
    import sysconfig
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.capi import build as capi_build
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    rng = np.random.RandomState(0)
    n, f, iters = 20000, 8, 6
    X = rng.normal(size=(n, f)).astype(np.float32)
    y = (X[:, 0] - X[:, 1] + rng.normal(size=n) > 0).astype(np.float32)
    rows, labels = tmp_path / "rows.f32", tmp_path / "y.f32"
    X.tofile(rows)
    y.tofile(labels)
    lib = capi_build.build()
    exe = tmp_path / "capi_train"
    subprocess.run(["g++", "-O2", os.path.join(repo, "tools",
                                               "capi_train.cpp"),
                    f"-I{sysconfig.get_path('include')}", "-o", str(exe)]
                   + capi_build.link_args(lib), check=True, timeout=300)
    params = {"objective": "binary", "num_leaves": 31, "max_bin": 63,
              "verbose": -1}
    model, preds = tmp_path / "model.txt", tmp_path / "pred.f64"
    out = subprocess.run(
        [str(exe), str(rows), str(labels), str(n), str(f), str(iters),
         "max_bin=63", " ".join(f"{k}={v}" for k, v in params.items()),
         str(model), str(preds), str(n)],
        env=capi_build.host_env(), capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-2000:])
    assert "CAPI_TRAIN_OK" in out.stdout
    want = lgb.train(dict(params),
                     lgb.Dataset(X, label=y, params={"max_bin": 63}), iters,
                     device="cuda")
    assert model.read_text() == want.model_to_string()
    loaded = lgb.Booster(model_file=str(model), device="cuda")
    np.testing.assert_array_equal(np.fromfile(preds, np.float64),
                                  loaded.predict(X).astype(np.float64))
