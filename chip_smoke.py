#!/usr/bin/env python3
"""Smoke run of lightgbm_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each ends in ``torch.cuda.synchronize()``; any failure raises
and the script exits non-zero):

1. build — compile the CUDA kernels from ``lightgbm_tpu_torch/csrc``
   (one ``nvcc`` per source, in parallel) into
   ``lightgbm_tpu_torch/_build/``, and beside them the empty kernel of
   the launch floor (``tools/launch_floor.cu``) into a temporary
   directory;
2. kernels — at the headline shapes (1,000,000 rows x 28 columns,
   63 bins, 255 leaves, int8h values) run each kernel and its plain
   PyTorch version on the same CUDA inputs, at every wave width the
   headline tree uses, and require bitwise equality; time kernel, plain
   version and (where one exists) a single PyTorch library call;
2b. float kernels — at the headline shapes (1,001,472 padded rows, 28
   columns, 64-bin stride, 255 leaves) the float K1 at 8 / 16 / 32 slots
   on hhilo values with bagged-out rows (the -1 slots must collect them),
   at 32 slots on hilo values and on a skewed wave (every row in one
   slot), and the float K3 at 64 / 128 slots on hhilo, at 128 on hilo
   and on a skewed 128-slot wave: each held bitwise (bit patterns) to its
   plain version on CPU copies (only the CPU adds in its fixed order),
   the float K1 also to K2 followed by the float K5 and the float K3 to
   the float K5 on its non-negative slots, on the card; each timed whole
   and in its three phases apart (the sort; the walks: heavy slots'
   chunk partials and light slots' walks; the fold), its choice of heavy
   and light slots on the card held to the host rule; beside K1 that
   composition (its yardstick, with the float K5's partial and fold
   phases apart), the f32 ``index_add_`` over the active rows (the
   library call of both), the bound and, for K1, the float K5's contract
   floor (its chunk partials written and read back);
2c. categorical kernels — on the categorical headline data (the headline
   rows, labels drawn first, then column 1 made 48 equal-frequency
   buckets and column 2 four, each relabelled by a seeded permutation,
   and column 3 200 uniform noise categories, past ``max_bin``: see
   ``categorize``), waves in which about a third of the splits are
   categorical on columns 1-3 with random masks: K2 and K4 at the
   128-slot tail state, K1 at 8 / 16 / 32 slots, K3 at 64 / 128 slots
   on the hist leaves the categorical K2 wrote, and the float K1 (hhilo,
   32 slots, 20% bagged out), each bitwise its plain version and timed
   beside its numerical twin: the same wave, its categorical leaves
   compared with a threshold (entries ``*_cat``, ``numerical_ms``);
3. small-data kernels — the same for the small-data path's shapes: the
   fused route+histogram kernel at 65,536 rows, 256 bins and 32 slots
   with bagged-out rows (hist leaf -1) that the -1 slots collect, the
   route-values kernel at 63 leaves and 256 bins, and the fused split
   scan on a ``[64, 28, 256, 3]`` and a ``[64, 28, 64, 3]`` wave;
   the route, route-values and split-scan kernels are also timed as
   launches captured in a CUDA graph (their device time, no host launch
   between two kernels), and the route kernels get a second, sector
   bound: the 32-byte sectors of the bins that the wave's moved rows
   read, counted on the device, as the card reads them;
3c. small-data categorical kernels — phase 2c's categorical waves at
   the small-data path's shapes (its rows with columns 1-3 categorical,
   256-bin stride, 63 leaves, bagging 0.8): K2, K4, K1 and the float
   K1; and K2, K4 and K1 on the same rows with column 26 a categorical
   that EFB bundles with the sparse columns 25 and 27 (63 bins), every
   categorical split of the wave on it, so the kernels unbundle before
   the mask lookup; each beside its numerical twin, as in phase 2c;
4. headline path — ``lgb.train`` of the headline binary GBDT (the
   bench's synthetic 1M x 28 set, 255 leaves, max_bin 63, lr 0.1,
   min_data_in_leaf 20) with every kernel launch counter reset first;
   require the route, histogram and route-values kernels to have
   launched and the split scan not (above 65,536 rows the torch scan
   runs), train AUC >= 0.93 and finite predictions;
5. small-data path — ``lgb.train`` of the upstream
   ``examples/binary_classification/train.conf`` configuration (binary,
   63 leaves, max_bin 255, lr 0.1, feature and bagging fraction 0.8,
   bagging_freq 5, min_data_in_leaf 50, min_sum_hessian_in_leaf 5,
   binary_logloss and auc on the training and the valid set every
   iteration) on the bench's generator at 65,536 + 13,107 rows, 100
   iterations with early stopping after 10, counters reset first;
   require the split scan, the fused route+histogram and the
   route-values kernels to have launched, valid AUC >= 0.90 and finite
   predictions;
6. float headline — the headline's ``lgb.train`` with ``gpu_use_dp``
   (so hilo values), 8 iterations, counters reset first: the float K1,
   K2, the float K3 and K4 must launch and no int8 histogram kernel;
   train AUC >= 0.93 and finite predictions;
7. stream kernels — at the stream path's shapes (a 1,048,576-row
   block, 28 columns, 64-bin stride) the wide active-leaf histogram K5
   on int8h values and on hhilo values (A = 32, C = 4), each on a
   uniform wave and on a skewed one (every row that is not padding in
   one slot, as in the first wave of every tree), and the
   leaf-compacted K3 at A = 128, each adding into the nonzero carry a
   previous block left, held bitwise against its plain version (the
   float one runs on CPU copies, compared by bit pattern: only the CPU
   adds in its fixed order); the float K5's two phases (chunk partials,
   fold) are timed apart and its contract floor (the partial traffic)
   is logged beside its bound;
8. stream identity — ``ingest_synthetic`` writes the bench's A/B store
   (4,194,304 rows x 28, max_bin 63) into a temporary directory;
   ``lgb.train_streaming`` (63 leaves, lr 0.1, blocks of 1,048,576 rows,
   2 iterations, int8h) and in-memory training on
   ``store.to_binned_dataset`` must give one digest (scores included);
   the stream must launch K5 (int8h), K2 and K4, the in-memory run K1;
9. stream scale — the bench's stream leg (``bench.py`` stream config)
   cut from 100,000,000 rows to 20,000,000: past 16,909,320 rows the
   mode is hhilo, so the float K5 must launch and the int8h K5 and K1
   must not; the scores must be finite and their AUC on the store's
   labels >= 0.93; rows per second, wall, peak device memory and the
   model's digest are logged;
10. in-memory scale — the same 20M rows (``store.to_binned_dataset``)
   trained in memory with the same parameters: hhilo there too, through
   the float K1; its digest (scores included) must be the streamed
   one's, no int8 histogram kernel may run and the peak device memory
   must stay under 4 GiB (the kernels' scratch does not grow with rows x
   slots);
11. 20M headline width — the same rows with the headline's tree (255
   leaves, ``min_data_in_leaf`` 20), streamed and in memory, 2
   iterations each: equal digests, the float K1 and K3 launched in
   memory, the same memory limit.  The temporary stores are removed at
   the end;
12. serving — the bench's serving model (``bench.py`` serve legs:
   200,000 x 28 rows, binary, 63 leaves, 100 iterations) trained with
   counters reset (K1 and K4 must launch; at 63 leaves no wave is wider
   than 32 slots, so K2 and K3 must not); ``serve.compile_model`` on the
   card, a 1,048,576-row batch scored raw and binned through CUDA graphs
   (rows/s beside an eager run and the host numpy walk): routing raw ==
   binned on every row and == the host ``predict_leaf`` on 20,000 rows,
   scores raw == binned and within 1 f32 ulp of the f64 host sum there;
   a seeded 3-class forest with categorical, NaN- and zero-missing nodes
   and stumps held to the host the same way; 300 mixed requests through
   ``PredictionServer`` (buckets 256/1024/4096), each resolved exactly
   once within 1 ulp, no graph captured and no batch run eagerly after
   warmup; then ``tools/load_harness.sweep`` at 1k/5k/20k QPS for 2 s
   each (the bench's 1k-50k for 5 s, cut), with no failure, and the same
   sweep through a stand-in that resolves each request at submit (the
   generator's own tail), both with the heap frozen (``gc.freeze``) so
   that no full collection stalls them.  Rows/s,
   compile and warm seconds, per-bucket p50/p99 and the sweep table are
   logged beside the card's name and power limit;
13. categorical headline — phase 4 on the categorical headline data
   (``categorical_feature=[1, 2, 3]``), counters reset first: K1, K2, K3
   and K4 must launch and the split kernel not (both packages gate it
   off categorical data), train AUC >= 0.93, finite predictions, and
   the trees must hold many-vs-many nodes on column 1 (more than one
   category) and one-vs-rest nodes on column 2 (one category each);
   then the same with ``gpu_use_dp`` (hilo), 8 iterations: the float K1,
   K2, the float K3 and K4 must launch, no int8 histogram kernel and no
   split kernel, train AUC >= 0.93;
14. categorical valid set — phase 5's configuration on its rows with
   columns 1-3 categorical, the valid rows holding categories the
   training rows never have (column 3 ids past 200, some column 1 ids
   past 48): K1 and K4 must launch and the split kernel not, valid AUC
   >= 0.90 at ``best_iteration``;
15. categorical serving — phase 13's model compiled on the card, 20,000
   of its rows with unseen, negative and NaN categories scored raw and
   binned: routing raw == binned == the host ``predict_leaf``, scores
   raw == binned and within 1 f32 ulp of the f64 host sum;
16. categorical stream — 262,144 rows of the categorical headline data
   written as CSV into a temporary directory, ingested with
   ``categorical_column`` and streamed (63 leaves, blocks of 131,072
   rows, 2 iterations): K5, K2 and K4 must launch, the model must hold
   categorical nodes, and its digest (scores included) must be that of
   in-memory training on ``store.to_binned_dataset``;
17. multiclass headline — the headline's rows (binned once) with 5
   classes from the quantiles of its latent ``2 X0 + X1 - X2 + noise``,
   ``multiclass``, 255 leaves, ``max_bin`` 63, 8 iterations (40 trees),
   counters reset first: K1, K2, K3 and K4 on every class tree, no split
   kernel; the train ``multi_logloss`` must fall every iteration and end
   at most 85% of ln 5; the model compiled on the card scores all rows
   ``[n, 5]``, the probabilities summing to 1 within 1e-5, its routing
   equal to the host walk and its raw scores within 1 f32 ulp of the f64
   host sum on 20,000 rows; then ``multiclassova``, 2 iterations;
18. multiclass small-data — upstream's
   ``examples/multiclass_classification/train.conf`` (5 classes,
   ``multi_logloss`` and ``multi_error`` on both sets, 31 leaves, lr
   0.05, ``max_bin`` 255, early stopping 10, at most 100 rounds) on the
   small-data rows with 5-class labels: the split kernel on every class
   tree, valid ``multi_logloss`` at ``best_iteration`` at most 85% of
   ln 5;
19. ranking — the bench's MS LTR-shaped set (``bench.py ranking_leg``:
   19,000 queries of log-normal sizes, about 2.27M docs x 136 features,
   relevance 0-4) with its configuration (``lambdarank``, 255 leaves,
   lr 0.1, ``min_data_in_leaf`` 0, ``min_sum_hessian_in_leaf`` 100,
   ``max_bin`` 255), 8 iterations: each iteration's gradient time (the
   torch lambdarank operations) beside its wall, train NDCG@10 >= 0.60
   (the bench's gate), K1-K4 launched; before it, K1 at 8/16/32 slots,
   K2 + K3 at 64/128 and K2 and K4 on a 128-slot wave on the ranking
   data (136 columns at a 256-bin stride) with the first iteration's
   int8h lambdarank values, bitwise against their plain versions (under
   ``rank`` in their kernel entries);
20. regression family — every regression-family objective (L1, Huber,
   Fair, quantile 0.9, Poisson, Gamma, Tweedie, MAPE, xentropy,
   xentlambda, ``reg_sqrt``) on the headline's rows (Gamma and Tweedie
   on ``exp(z / 8)``, see ``REG_FAMILY``), 2 iterations each:
   each default metric falls; L1's and the quantile's renewed leaves
   equal a numpy percentile of the residuals per leaf, computed on the
   host from the row leaves and scores the renewal read;
21. streams — the identity store's generator at 2,097,152 rows (two
   1,048,576-row blocks) with 3-class and continuous labels from its
   first two columns: ``multiclass`` and ``huber`` streamed and in
   memory, 2 iterations each, equal digests (scores included), K5, K2
   and K4 in the stream.

Each of phases 17-21 prints one ``{"phase": ...}`` JSON line.  A path's
ms/iter is the wall of the whole ``lgb.train`` call, the
Booster's setup (upload, objective init) and, on the small-data path,
the per-iteration evaluation included.  The last lines are the kernel
table as one JSON object (a categorical entry's ``launches`` count its
kernel on phases 13-16 only), the card's name and power limit, and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HEADLINE_ROWS = 1_000_000
HEADLINE_FEATURES = 28
HEADLINE_ITERS = 32
AUC_GATE = 0.93
SMALL_ROWS = 65_536              # the most rows the split kernel takes
SMALL_VALID = SMALL_ROWS // 5    # as bench.py valid_leg
SMALL_ITERS = 100
SMALL_EARLY_STOP = 10
VALID_AUC_GATE = 0.90
# examples/binary_classification/train.conf of the upstream project
TRAIN_CONF = {"objective": "binary", "metric": "binary_logloss,auc",
              "metric_freq": 1, "is_training_metric": True,
              "num_leaves": 63, "max_bin": 255, "learning_rate": 0.1,
              "feature_fraction": 0.8, "bagging_freq": 5,
              "bagging_fraction": 0.8, "min_data_in_leaf": 50,
              "min_sum_hessian_in_leaf": 5.0, "verbose": -1}
# the bench's stream leg (bench.py stream config): 63 leaves, max_bin 63,
# blocks of 1,048,576 rows; its A/B store size; its 100M rows cut to 20M
STREAM_PARAMS = {"objective": "binary", "num_leaves": 63, "max_bin": 63,
                 "learning_rate": 0.1, "verbose": -1}
STREAM_FEATURES = 28
STREAM_BLOCK = 1 << 20
STREAM_ITERS = 2
STREAM_IDENT_ROWS = 4_194_304
STREAM_SCALE_ROWS = 20_000_000
# the headline's tree on the 20M store (max_bin 63 as the store's bins)
HEAD20_PARAMS = dict(STREAM_PARAMS, num_leaves=255, min_data_in_leaf=20)
# in-memory float runs at 20M rows: the kernels' scratch must not grow
# with rows x slots
INMEM_PEAK_LIMIT = 4 << 30
CAT_STREAM_ROWS = 262_144
CAT_STREAM_BLOCK = 131_072
FLOAT_ITERS = 8
# the bench's serving legs (bench.py:680-795 serve_leg, :797-855
# serve_load_leg): 28 features, 200,000 training rows from seed 11, 63
# leaves, one 1,048,576-row batch, buckets (256, 1024, 4096) with a 1 ms
# wait, 300 mixed requests; its QPS sweep (1k/5k/20k/50k for 5 s each)
# cut to 1k/5k/20k for 2 s each to fit the smoke's time limit
SERVE_PARAMS = {"objective": "binary", "num_leaves": 63, "max_bin": 63,
                "learning_rate": 0.1, "min_data_in_leaf": 20, "verbose": -1}
SERVE_TRAIN_ROWS = 200_000
SERVE_ITERS = 100
SERVE_ROWS = 1 << 20
SERVE_REPS = 4
SERVE_SAMPLE = 20_000
SERVE_FOREST_ROWS = 65_536
SERVE_BUCKETS = (256, 1024, 4096)
SERVE_SIZES = (1, 3, 17, 100, 240, 900)
SERVE_REQUESTS = 300
SERVE_QPS = (1_000.0, 5_000.0, 20_000.0)
SERVE_QPS_S = 2.0
# multiclass headline (phase 17): 5 classes from the quantiles of the
# headline's latent, the headline's tree, 8 iterations (40 trees); the
# train multi_logloss must end at most this share of ln 5 (uniform)
MC_CLASSES = 5
MC_ITERS = 8
MC_OVA_ITERS = 2
MC_LOSS_SHARE = 0.85
# sum of the served class probabilities: 1 within a few f32 ulps
MC_PROB_SUM_TOL = 1e-5
# examples/multiclass_classification/train.conf of the upstream project
MC_TRAIN_CONF = {"objective": "multiclass", "num_class": MC_CLASSES,
                 "metric": "multi_logloss,multi_error", "metric_freq": 1,
                 "is_training_metric": True, "max_bin": 255,
                 "learning_rate": 0.05, "num_leaves": 31, "verbose": -1}
# the bench's ranking leg (bench.py ranking_leg, MS LTR shape): its data
# and configuration, its NDCG@10 gate; 8 iterations
RANK_QUERIES = 19_000
RANK_FEATURES = 136
RANK_ITERS = 8
RANK_NDCG_GATE = 0.60
RANK_PARAMS = {"objective": "lambdarank", "num_leaves": 255,
               "learning_rate": 0.1, "min_data_in_leaf": 0,
               "min_sum_hessian_in_leaf": 100, "max_bin": 255,
               "metric": "ndcg", "ndcg_eval_at": [10], "verbose": -1}
# the regression family on the headline's rows (phase 20): each objective
# with its label of the latent z, 2 iterations.  Gamma and Tweedie take
# exp(z / 8), not exp(z / 2) (labels over five decades), as both packages
# diverge there at the first tree: Gamma's Newton step from log(mean) is
# about mean / y (huge for the smallest labels), and Tweedie's gradients
# reach hundreds, so int8h's one-byte gradients round the rest to 0
# against float root totals and a leaf value explodes
# (tests/test_torch_objectives.py: test_gamma_first_tree_diverges_as_in_
# reference, test_int8h_heavy_tailed_gradients_match_reference)
REG_ITERS = 2
REG_FAMILY = (("regression_l1", "z", {}), ("huber", "z", {}),
              ("fair", "z", {}), ("quantile", "z", {"alpha": 0.9}),
              ("poisson", "exp", {}), ("gamma", "exp8", {}),
              ("tweedie", "exp8", {}), ("mape", "exp", {}),
              ("xentropy", "sigmoid", {}), ("xentlambda", "sigmoid", {}),
              ("regression", "abs", {"reg_sqrt": True}))
# the streams of phase 21: the identity store's generator at 2,097,152
# rows (two blocks), 3 classes and Huber, 2 iterations each
MC_STREAM_ROWS = 2_097_152
MC_STREAM_CLASSES = 3
# memory rate of one H100 SXM (NVIDIA data sheet)
PEAK_BYTES_PER_S = 3.35e12
# float32 rate outside the tensor cores of one H100 SXM (data sheet)
FP32_OPS_PER_S = 67e12
# 32-bit integer adds per clock per SM at compute capability 9.0 (CUDA C++
# Programming Guide, throughput of native arithmetic instructions).  The
# kernels' work is integer: compares in routing, shared-memory atomic adds
# in the histograms.  No shared-atomic rate is published, so each atomic
# counts as one int32 add and the bound is a lower one.
INT32_ADDS_PER_CLOCK_PER_SM = 64


def log(msg: str) -> None:
    print(msg, flush=True)


def _smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def card_line() -> str:
    return _smi("name,power.limit")


def int32_ops_per_s(sms: int) -> float:
    """The card's int32 add rate: SMs x adds per clock x max SM clock."""
    mhz = float(_smi("clocks.max.sm").split()[0])
    return sms * INT32_ADDS_PER_CLOCK_PER_SM * mhz * 1e6


def headline_latent(seed: int = 0):
    """The bench's synthetic set (bench.py synthetic_leg) before its
    threshold: ``(X, z)``, ``z = 2 X0 + X1 - X2 + noise``."""
    import numpy as np
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(HEADLINE_ROWS, HEADLINE_FEATURES)).astype(
        np.float32)
    z = (X[:, 0] * 2 + X[:, 1] - X[:, 2]
         + rng.normal(scale=1.0, size=HEADLINE_ROWS))
    return X, z


def headline_data(seed: int = 0):
    """The bench's synthetic binary set: its latent above 0."""
    import numpy as np
    X, z = headline_latent(seed)
    return X, (z > 0).astype(np.float32)


CAT_COLUMNS = [1, 2, 3]
CAT_MANY, CAT_FEW, CAT_NOISE = 48, 4, 200
CAT_UNSEEN = 20


def categorize(X, seed: int, many: int = CAT_MANY, few: int = CAT_FEW,
               noise: int = CAT_NOISE, valid_from=None):
    """Columns 1-3 of ``X`` become integer categories, in place (draw the
    labels first): column 1 ``many`` equal-frequency buckets of its
    values and column 2 ``few``, each relabelled by a seeded permutation
    so that no numerical threshold orders them (many-vs-many and
    one-vs-rest splits); column 3 ``noise`` uniform categories of noise.
    Rows from ``valid_from`` on (valid rows) also get categories the rows
    before never have: column 3 draws from ``noise + CAT_UNSEEN``, and 5%
    of column 1 takes ids past ``many``."""
    import numpy as np
    rng = np.random.RandomState(seed)
    for col, k in ((1, many), (2, few)):
        q = np.quantile(X[:valid_from, col], np.linspace(0, 1, k + 1)[1:-1])
        X[:, col] = rng.permutation(k)[np.searchsorted(q, X[:, col])]
    X[:, 3] = rng.randint(0, noise, size=len(X))
    if valid_from is not None:
        nv = len(X) - valid_from
        X[valid_from:, 3] = rng.randint(0, noise + CAT_UNSEEN, size=nv)
        rows = valid_from + np.nonzero(rng.rand(nv) < 0.05)[0]
        X[rows, 1] = many + rng.randint(0, CAT_UNSEEN, size=len(rows))
    return X


def small_latent(seed: int = 3):
    """The bench's synthetic generator at the small-data path's size
    (bench.py valid_leg) before its threshold: ``(X, z)`` over the
    training rows and then the valid rows."""
    import numpy as np
    n = SMALL_ROWS + SMALL_VALID
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, HEADLINE_FEATURES)).astype(np.float32)
    z = X[:, 0] * 2 + X[:, 1] - X[:, 2] + rng.normal(scale=1.0, size=n)
    return X, z


def small_data(seed: int = 3):
    """``(X, y, X_valid, y_valid)``: the latent above 0."""
    import numpy as np
    X, z = small_latent(seed)
    y = (z > 0).astype(np.float32)
    return X[:SMALL_ROWS], y[:SMALL_ROWS], X[SMALL_ROWS:], y[SMALL_ROWS:]


def random_forest(seed: int, num_class: int = 3, iters: int = 12,
                  num_leaves: int = 31, num_features: int = 10,
                  cat_features=(8, 9)):
    """A seeded forest of the port's ``Tree`` objects that reaches every
    rule of the serving walk: ``num_class`` trees an iteration, stumps,
    numerical nodes of every missing type (None, Zero, NaN) and either
    default side, thresholds at 0 and at the zero threshold's edges, and
    categorical nodes (value bitsets over 0-40) on ``cat_features``."""
    import numpy as np
    from lightgbm_tpu_torch.models.tree import Tree
    rng = np.random.RandomState(seed)
    trees = []
    for _ in range(iters * num_class):
        t = Tree(num_leaves)
        t.leaf_value[0] = rng.normal()
        if rng.rand() < 0.1:
            trees.append(t)                      # a stump
            continue
        parent = {0: (-1, 0)}                    # leaf -> (node, side)
        for _ in range(rng.randint(1, num_leaves)):
            leaf = rng.randint(t.num_leaves)
            node, new = t.num_leaves - 1, t.num_leaves
            up, side = parent[leaf]
            if up >= 0:
                (t.left_child if side == 0 else t.right_child)[up] = node
            t.left_child[node], t.right_child[node] = ~leaf, ~new
            parent[leaf], parent[new] = (node, 0), (node, 1)
            f = rng.randint(num_features)
            t.split_feature[node] = t.split_feature_inner[node] = f
            if f in cat_features:
                cats = rng.choice(41, size=rng.randint(1, 12), replace=False)
                words = [0] * (int(cats.max()) // 32 + 1)
                for c in cats:
                    words[c // 32] |= 1 << int(c % 32)
                t.decision_type[node] = 1
                t.threshold[node] = t.threshold_bin[node] = t.num_cat
                t.cat_threshold.extend(words)
                t.cat_boundaries.append(len(t.cat_threshold))
                t.num_cat += 1
            else:
                t.decision_type[node] = ((rng.randint(3) << 2)
                                         | (rng.randint(2) << 1))
                t.threshold[node] = rng.choice(
                    [rng.normal(), 0.0, 1e-35, -1e-35, rng.normal() * 1e-3])
            t.leaf_value[new] = rng.normal()
            t.num_leaves += 1
        t.leaf_value[:t.num_leaves] *= 10.0 ** rng.uniform(-3, 1)
        t._recompute_depth()
        trees.append(t)
    return trees


def forest_rows(trees, n: int, seed: int, num_features: int = 10,
                cat_features=(8, 9)):
    """Rows for :func:`random_forest`: normal values with 10% NaN, 10%
    exact zeros and some values of +-1e-36 (the zero threshold's inside),
    +-1e-35 and each numerical threshold rounded to f32 and one f32 step
    either side; categorical columns hold integers -3..44 (unseen and
    negative categories included) as float32."""
    import numpy as np
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, num_features)).astype(np.float32)
    thr = np.concatenate([t.threshold[:t.num_leaves - 1] for t in trees
                          if t.num_leaves > 1]).astype(np.float32)
    edges = np.concatenate([thr, np.nextafter(thr, np.float32(np.inf)),
                            np.nextafter(thr, np.float32(-np.inf)),
                            np.float32([1e-36, -1e-36, 1e-35, -1e-35])])
    pick = rng.rand(n, num_features) < 0.2
    X[pick] = rng.choice(edges, size=int(pick.sum()))
    X[rng.rand(n, num_features) < 0.1] = 0.0
    for c in cat_features:
        X[:, c] = rng.randint(-3, 45, size=n)
    X[rng.rand(n, num_features) < 0.1] = np.nan
    return X


def time_ms(fn, reps: int, warm: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def current_stream(dev) -> int:
    """The handle of torch's current stream on ``dev`` (inside a graph
    capture: the capture stream)."""
    import torch
    return torch.cuda.current_stream(dev).cuda_stream


def graph_ms(fn, n: int = 100, reps: int = 5) -> float:
    """Device time of one call of ``fn``: ``n`` calls captured in one
    ``torch.cuda.CUDAGraph`` on the capture stream and the graph replayed
    ``reps`` times between events, so no host launch sits between two
    kernels.  ``fn`` launches on torch's current stream and returns its
    CUDA error code."""
    import torch
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        codes = [fn() for _ in range(n)]
    if any(codes):
        raise RuntimeError(f"a launch captured in the graph failed: {codes}")
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * n)


# the empty kernel of the launch floor: on no path, so built here from
# tools/ and not from the package's csrc/
LAUNCH_FLOOR_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "tools", "launch_floor.cu")
_launch_floor_lib = []


def start_launch_floor_build(out_dir: str):
    """Start ``nvcc`` on ``tools/launch_floor.cu`` with the package's
    flags -> ``(process, library path)``; it compiles while the
    package's kernels do."""
    from lightgbm_tpu_torch.ops import cuda_build
    path = os.path.join(out_dir, "liblaunch_floor.so")
    cmd = [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", path,
           LAUNCH_FLOOR_SRC]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT), path


def load_launch_floor(proc, path: str) -> None:
    """Wait for the launch-floor build and load its library."""
    import ctypes
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed on tools/launch_floor.cu:\n"
                           + out.decode(errors="replace"))
    lib = ctypes.CDLL(path)
    lib.lgbm_empty.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.lgbm_empty.restype = ctypes.c_int
    _launch_floor_lib.append(lib)


def launch_floor(grid: int, block: int, dev) -> dict:
    """An empty kernel's time at a ``grid`` x ``block`` launch, back to
    back and in a CUDA graph (``tools/launch_floor.cu``): the floor under
    a kernel of that launch shape."""
    lib = _launch_floor_lib[0]

    def call(stream=current_stream(dev)):
        return lib.lgbm_empty(grid, block, stream)
    return dict(launch_floor_ms=time_ms(call, 200),
                launch_floor_graph_ms=graph_ms(
                    lambda: call(current_stream(dev))))


def bound(nbytes: float, ops: float, ops_rate: float) -> dict:
    """The least time for ``nbytes`` of traffic and ``ops`` operations at
    ``ops_rate`` per second: the larger of the two, with both parts."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / ops_rate * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes_bound_ms=t_bytes, ops_bound_ms=t_ops)


def wave_inputs(dd, nl: int, n_sel: int, A: int, gen, L: int = 255,
                bag: float = 1.0, cat_share: float = 0.0,
                cat_features=None, cat_off: bool = False):
    """A mid-tree wave on ``dd``: rows spread over ``nl`` leaves, ``n_sel``
    of them split by random numerical tables, ``A`` active slots (two of
    them -1 when A >= 16).  With ``bag`` < 1 each row is in the bag with
    that probability; out-of-bag rows carry hist leaf -1, as bagging
    leaves them.  With ``cat_share`` > 0 about that share of the split
    leaves split categorically (on ``cat_features`` when given), each
    with a random mask of left bins; ``cat_off`` draws the same wave and
    then compares those leaves' bins with their thresholds instead (the
    categorical wave's numerical twin)."""
    import torch
    from lightgbm_tpu_torch.ops.histogram import bin_stride
    from lightgbm_tpu_torch.ops.route import leaf_tables
    dev = dd.device
    n, n_pad = dd.num_data, dd.n_pad
    F = dd.num_features
    leaf2 = torch.full((2, n_pad), -1, dtype=torch.int32, device=dev)
    leaf2[0, :n] = torch.randint(0, nl, (n,), generator=gen,
                                 device=dev).int()
    if bag < 1.0:
        keep = torch.rand(n, generator=gen, device=dev) < bag
        leaf2[1, :n] = torch.where(keep, leaf2[0, :n], -1)
    else:
        leaf2[1] = leaf2[0]
    sel = torch.zeros(L, dtype=torch.bool, device=dev)
    sel[torch.randperm(nl, generator=gen, device=dev)[:n_sel]] = True
    rank = torch.cumsum(sel.int(), 0) - 1
    new_id = torch.where(sel, nl + rank, 0).int()
    feature = torch.randint(0, F, (L,), generator=gen, device=dev).int()
    threshold = torch.randint(0, dd.max_bins - 1, (L,), generator=gen,
                              device=dev).int()
    B = bin_stride(dd.max_bins)
    is_cat = torch.zeros(L, dtype=torch.bool, device=dev)
    cat_mask = torch.zeros((L, B), dtype=torch.bool, device=dev)
    if cat_share > 0:
        is_cat = sel & (torch.rand(L, generator=gen, device=dev) < cat_share)
        if cat_features is not None:
            cf = torch.as_tensor(cat_features, dtype=torch.int32, device=dev)
            pick = torch.randint(0, len(cat_features), (L,), generator=gen,
                                 device=dev)
            feature = torch.where(is_cat, cf[pick], feature)
        cat_mask = (torch.rand((L, B), generator=gen, device=dev) < 0.5
                    ) & is_cat[:, None]
        if cat_off:
            is_cat = torch.zeros_like(is_cat)
            cat_mask = torch.zeros_like(cat_mask)
    tabs, cat = leaf_tables(
        feature, threshold, torch.zeros(L, dtype=torch.bool, device=dev),
        is_cat, cat_mask, sel, new_id,
        dd.missing_types, dd.nan_bins, dd.default_bins, dd.feat_group,
        dd.feat_offset, dd.num_bins)
    live = nl + n_sel
    active = torch.randperm(live, generator=gen, device=dev)[:A].int()
    if A >= 16:
        active[-2:] = -1
    return leaf2, tabs, cat, active.contiguous()


def moved_sectors(bins_t, leaf2, tabs):
    """Rows a route wave moves and the 32-byte sectors of the transposed
    bins their split columns lie in, counted on the device: -> ``(moved
    rows, distinct sectors)``.  The card reads whole sectors, so a wave
    whose neighbouring rows split on different columns reads up to 32
    bytes for each one-byte bin."""
    import torch
    from lightgbm_tpu_torch.ops.route import T_GROUP, T_SEL
    n_pad = bins_t.shape[1]
    rl = leaf2[0].long()
    leaf = rl.clamp(min=0)
    rows = torch.nonzero((rl >= 0) & (tabs[T_SEL][leaf] != 0))[:, 0]
    addr = tabs[T_GROUP][leaf[rows]].long() * n_pad + rows
    return int(rows.numel()), int(torch.unique(addr // 32).numel())


def kernel_phase(dd, vals, entries):
    """Kernel vs plain version at the headline shapes (bitwise), with
    times and bounds; appends one dict per kernel to ``entries``."""
    import torch
    from lightgbm_tpu_torch.ops import cuda_build
    from lightgbm_tpu_torch.ops.compact import hist_compact_raw
    from lightgbm_tpu_torch.ops.histogram import (
        bin_stride, hist_launcher, hist_plain, hist_plan, hist_slab, slot_tables)
    from lightgbm_tpu_torch.ops.route import (
        ROUTE_BLOCK, _route_grid, route_plain, route_rows_raw)
    dev = dd.device
    sms = cuda_build.multiprocessor_count(dev)
    int_rate = int32_ops_per_s(sms)
    log(f"int32 add rate {int_rate:.4g}/s ({sms} SMs)")
    G, n_pad = dd.bins_t.shape
    C = vals.shape[0]
    L = 255
    B = bin_stride(dd.group_max_bins)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    tab_bytes = 11 * L * 4 + L * B

    # -- K2 / K4: route and route-values at the 128-slot tail state ------
    leaf2, tabs, cat, _ = wave_inputs(dd, 127, 64, 128, gen)
    entries.append(dict(
        name="route", route="cuda",
        source="lightgbm_tpu_torch/csrc/route.cu",
        replaces="lightgbm_tpu/ops/pallas_route.py:85",
        max_abs_err=0.0, **k2_measure(dd, leaf2, tabs, cat, int_rate)))
    lv = torch.randn(L, generator=gen, device=dev)
    entries.append(dict(
        name="route_values", route="cuda",
        source="lightgbm_tpu_torch/csrc/route.cu",
        replaces="lightgbm_tpu/ops/pallas_route.py:168", max_abs_err=0.0,
        **k4_measure(dd, leaf2, tabs, cat, lv, int_rate)))

    # -- K1: fused route + histogram at 8, 16, 32 slots ------------------
    k1_rows = [k1_measure(dd, vals, A, A // 2, gen, L, int_rate)
               for A in (8, 16, 32)]
    entries.append(_widest(dict(
        name="hist_route", route="cuda",
        source="lightgbm_tpu_torch/csrc/hist_route.cu",
        replaces="lightgbm_tpu/ops/pallas_histogram.py:637",
        max_abs_err=0.0), k1_rows))

    # -- K3: leaf-compacted histogram at 64 and 128 slots -----------------
    k3_rows = [k3_measure(dd, vals, A, gen, L, int_rate) for A in (64, 128)]
    entries.append(_widest(dict(
        name="hist_compact", route="cuda",
        source="lightgbm_tpu_torch/csrc/hist_compact.cu",
        replaces="lightgbm_tpu/ops/compact.py:179", max_abs_err=0.0),
        k3_rows))


def k2_measure(dd, leaf2, tabs, cat, int_rate: float) -> dict:
    """K2 (route) on one wave's tables: kernel vs plain version bitwise,
    times back to back and in a CUDA graph, the bound, the sector bound
    and the launch floor of its grid."""
    import torch
    from lightgbm_tpu_torch.ops import cuda_build
    from lightgbm_tpu_torch.ops.route import (
        ROUTE_BLOCK, _route_grid, route_plain, route_rows_raw)
    dev = dd.device
    n_pad = dd.n_pad
    L, B = cat.shape
    tab_bytes = 11 * L * 4 + L * B
    out = route_rows_raw(dd.bins_t, leaf2, tabs, cat)
    ref = route_plain(dd.bins_t, leaf2, tabs, cat)
    torch.cuda.synchronize()
    if not torch.equal(out, ref):
        raise AssertionError("route kernel != plain version")
    lib = cuda_build.library("route")
    buf = torch.empty_like(leaf2)

    def k2_call(stream=torch.cuda.current_stream(dev).cuda_stream):
        return lib.lgbm_route_rows(
            dd.bins_t.data_ptr(), n_pad, leaf2.data_ptr(), buf.data_ptr(),
            tabs.data_ptr(), L, cat.data_ptr(), B, _route_grid(n_pad, dev),
            ROUTE_BLOCK, stream)
    ms2 = time_ms(k2_call, 50)
    dev2 = graph_ms(lambda: k2_call(current_stream(dev)))
    plain2 = time_ms(lambda: route_plain(dd.bins_t, leaf2, tabs, cat), 5)
    moved_rows, sectors = moved_sectors(dd.bins_t, leaf2, tabs)
    b2 = bound(16 * n_pad + moved_rows + tab_bytes, n_pad, int_rate)
    sec2 = bound(16 * n_pad + 32 * sectors + tab_bytes, n_pad, int_rate)
    floor = launch_floor(_route_grid(n_pad, dev), ROUTE_BLOCK, dev)
    n_cat = int(tabs[3].sum())
    log(f"kernel route ({n_cat} categorical splits) rows={dd.num_data}: "
        f"bitwise ok, {ms2:.4f} ms back to back, {dev2:.4f} "
        f"ms in a graph (plain {plain2:.3f} ms, bound {b2['bound_ms']:.4f} "
        f"ms; {moved_rows} moved rows touch {sectors} sectors: sector "
        f"bound {sec2['bound_ms']:.4f} ms; an empty kernel of its grid "
        f"{floor['launch_floor_ms']:.4f} ms back to back, "
        f"{floor['launch_floor_graph_ms']:.4f} ms in a graph)")
    return dict(ms=ms2, graph_ms=dev2, plain_ms=plain2, library_ms=None,
                moved_rows=moved_rows, sectors=sectors,
                sector_bound_ms=sec2["bound_ms"], **floor, **b2)


def k3_measure(dd, vals, A: int, gen, L: int, int_rate: float,
               **cat) -> dict:
    """K3 (leaf-compacted histogram) at ``A`` slots on the hist leaves
    that K2 wrote for a wave (``cat``: :func:`wave_inputs`'s categorical
    arguments): K2 vs its plain version and K3 vs its plain version
    bitwise, times, the ``index_add_`` yardstick and the bound."""
    import torch
    from lightgbm_tpu_torch.ops import cuda_build
    from lightgbm_tpu_torch.ops.compact import hist_compact_raw
    from lightgbm_tpu_torch.ops.histogram import (
        bin_stride, hist_launcher, hist_plain, hist_plan, hist_slab,
        slot_tables)
    from lightgbm_tpu_torch.ops.route import route_plain, route_rows_raw
    dev = dd.device
    G, n_pad = dd.bins_t.shape
    C = vals.shape[0]
    B = bin_stride(dd.group_max_bins)
    sms = cuda_build.multiprocessor_count(dev)
    leaf2, tabs, cmask, active = wave_inputs(dd, 127 if A == 128 else 63,
                                             A - 2, A, gen, L, **cat)
    routed = route_rows_raw(dd.bins_t, leaf2, tabs, cmask)
    if not torch.equal(routed, route_plain(dd.bins_t, leaf2, tabs, cmask)):
        raise AssertionError(f"route kernel != plain (A={A})")
    hleaf = routed[1].contiguous()
    raw = hist_compact_raw(dd.bins_t, vals, hleaf, active, L,
                           dd.group_max_bins)
    inv, src = slot_tables(active, L, collect_unbagged=False)
    ref_raw = hist_plain(dd.bins_t, vals, hleaf, inv, src, B)
    torch.cuda.synchronize()
    if not torch.equal(raw, ref_raw):
        raise AssertionError(f"hist_compact kernel != plain (A={A})")
    plan = hist_plan(n_pad, G, A, B, C, sms, L, False)
    slab = hist_slab(plan, A, G, B, C, dev)
    obuf = torch.zeros_like(raw)
    ms = time_ms(hist_launcher("hist_compact", dd.bins_t, vals, hleaf,
                               inv, src, L, B, plan, slab, obuf), 20)
    pl = time_ms(lambda: hist_plain(dd.bins_t, vals, hleaf, inv, src, B), 3)
    n_active, lib_ms = index_add_ms(dd, vals, hleaf, inv, A, L, B)
    bd = bound(4 * n_pad + (G + C) * n_active + raw.numel() * 4
               + (L + 1 + A) * 4, G * C * n_active, int_rate)
    log(f"kernel hist_compact A={A} ({int(tabs[3].sum())} categorical "
        f"splits routed by K2): bitwise ok, {ms:.4f} ms (plain "
        f"{pl:.3f} ms, index_add_ {lib_ms:.4f} ms, bound "
        f"{bd['bound_ms']:.4f} ms by {bd['bound_by']}, {n_active} "
        f"active rows)")
    return dict(slots=A, ms=ms, plain_ms=pl, library_ms=lib_ms,
                plan=plan.__dict__, **bd)


CAT_SHARE = 1 / 3      # share of a wave's splits that are categorical
CAT_KERNELS = (        # (entry, counter, source, the categorical branch)
    ("route_cat", "route", "lightgbm_tpu_torch/csrc/route.cu",
     "lightgbm_tpu/ops/pallas_route.py:144"),
    ("route_values_cat", "route_values", "lightgbm_tpu_torch/csrc/route.cu",
     "lightgbm_tpu/ops/pallas_route.py:144"),
    ("hist_route_cat", "hist_route", "lightgbm_tpu_torch/csrc/hist_route.cu",
     "lightgbm_tpu/ops/pallas_histogram.py:699"),
    ("hist_compact_cat", "hist_compact",
     "lightgbm_tpu_torch/csrc/hist_compact.cu",
     "lightgbm_tpu/ops/compact.py:179"),
    ("hist_route_float_cat", "hist_route_float",
     "lightgbm_tpu_torch/csrc/hist_route_float.cu",
     "lightgbm_tpu/ops/pallas_histogram.py:699"))


def cat_kernel_phase(ddc, vals, int_rate: float, entries) -> None:
    """Phase 2c: the route kernels' categorical branch at the headline
    shapes, on the categorical headline data (columns 1-3 categorical):
    waves in which about a third of the splits are categorical, on
    columns 1-3 with random masks.  K2 and K4 at the 128-slot tail
    state, K1 at 8 / 16 / 32 slots, K3 at 64 / 128 slots on the hist
    leaves that the categorical K2 wrote, the float K1 (hhilo, 32 slots,
    20% bagged out): each bitwise its plain version, and timed beside
    its numerical twin (``numerical_ms``: the same wave, its categorical
    leaves compared with a threshold instead).  Appends one entry
    each."""
    rows, twins = (_cat_waves(ddc, vals, int_rate, off) for off in
                   (False, True))
    for name, counter, source, replaces in CAT_KERNELS:
        twin = twins[name]
        entries.append(dict(
            name=name, counter=counter, route="cuda", source=source,
            replaces=replaces, numerical_ms=twin["ms"],
            numerical_graph_ms=twin.get("graph_ms"),
            **{"max_abs_err": 0.0, **{k: v for k, v in rows[name].items()
                                      if k != "slots"}}))


def _cat_waves(ddc, vals, int_rate: float, cat_off: bool) -> dict:
    """Phase 2c's measurements, on categorical waves or (``cat_off``)
    on their numerical twins: -> rows by entry name."""
    import torch
    dev = ddc.device
    L = 255
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    cat = dict(cat_share=CAT_SHARE, cat_features=CAT_COLUMNS,
               cat_off=cat_off)
    leaf2, tabs, cmask, _ = wave_inputs(ddc, 127, 64, 128, gen, **cat)
    lv = torch.randn(L, generator=gen, device=dev)
    return {
        "route_cat": k2_measure(ddc, leaf2, tabs, cmask, int_rate),
        "route_values_cat": k4_measure(ddc, leaf2, tabs, cmask, lv,
                                       int_rate),
        "hist_route_cat": _widest({}, [
            k1_measure(ddc, vals, A, A // 2, gen, L, int_rate, **cat)
            for A in (8, 16, 32)]),
        "hist_compact_cat": _widest({}, [
            k3_measure(ddc, vals, A, gen, L, int_rate, **cat)
            for A in (64, 128)]),
        "hist_route_float_cat": k1_float_measure(ddc, "hhilo", 32, gen,
                                                 bag=0.8, **cat)}


def bundled_cat_data(X, y, max_bin: int = 63):
    """A copy of ``X`` (columns 1-3 categorical) whose columns 25-27 are
    sparse and mutually exclusive, 26 categorical: EFB bundles them into
    one group column.  -> ``(Dataset, categorical columns)``."""
    import numpy as np
    import lightgbm_tpu_torch as lgb
    rng = np.random.RandomState(5)
    n = len(X)
    Xb = X.copy()
    rows = np.arange(n)
    on = rng.rand(n) < 0.3
    Xb[:, 25] = np.where((rows % 3 == 0) & on, rng.normal(size=n), 0.0)
    Xb[:, 26] = np.where((rows % 3 == 1) & on, rng.randint(1, 7, size=n), 0)
    Xb[:, 27] = np.where((rows % 3 == 2) & on, rng.normal(size=n), 0.0)
    cats = CAT_COLUMNS + [26]
    return lgb.Dataset(Xb, label=y, params={"max_bin": max_bin},
                       categorical_feature=cats).construct(), cats


def small_cat_kernel_phase(ddc, ddb, vals, vals_b, int_rate: float,
                           entries) -> None:
    """Phase 3c: the categorical branch at the small-data path's shapes
    (65,536 rows, 256-bin stride, 63 leaves, bagging 0.8) on its
    categorical data — K2 and K4 on a tree's last pass, K1 and the float
    K1 at 32 slots — and on a bundled categorical column (column 26 of
    the same rows, EFB-bundled with 25 and 27 at 63 bins: every
    categorical split on it unbundles before the mask lookup): K2, K4
    and K1.  Added to the categorical entries under ``small_data`` and
    ``bundled``."""
    import torch
    dev = ddc.device
    L = TRAIN_CONF["num_leaves"]
    bag = TRAIN_CONF["bagging_fraction"]
    if not (ddb.is_bundled and int(ddb.feat_offset[26]) >= 0
            and bool(ddb.is_categorical[26])):
        raise AssertionError("column 26 is not a bundled categorical")
    found = {}
    for key, dd, v, feats in (("small_data", ddc, vals, CAT_COLUMNS),
                              ("bundled", ddb, vals_b, [26])):
        for off in (False, True):
            gen = torch.Generator(device=dev)
            gen.manual_seed(8)
            cat = dict(cat_share=CAT_SHARE, cat_features=feats, cat_off=off)
            leaf2, tabs, cmask, _ = wave_inputs(dd, 32, 31, 32, gen, L, bag,
                                                **cat)
            lv = torch.randn(L, generator=gen, device=dev)
            rows = {
                "route_cat": k2_measure(dd, leaf2, tabs, cmask, int_rate),
                "route_values_cat": k4_measure(dd, leaf2, tabs, cmask, lv,
                                               int_rate),
                "hist_route_cat": k1_measure(dd, v, 32, 16, gen, L,
                                             int_rate, bag, **cat)}
            if key == "small_data":
                rows["hist_route_float_cat"] = k1_float_measure(
                    dd, "hhilo", 32, gen, L, bag, **cat)
            if off:
                for name, row in rows.items():
                    found[key][name].update(
                        numerical_ms=row["ms"],
                        numerical_graph_ms=row.get("graph_ms"))
            else:
                found[key] = rows
    for e in entries:
        for key, rows in found.items():
            if e["name"] in rows:
                e[key] = dict(rows=ddc.num_data, **rows[e["name"]])


def index_add_ms(dd, vals, hleaf, inv, A: int, L: int, B: int):
    """The library yardstick of the int32 histograms: one int32
    ``index_add_`` of the active rows' values at their precomputed flat
    cells (rows whose hist leaf, -1 as leaf ``L``, has a slot) ->
    ``(active rows, ms)``."""
    import torch
    dev = dd.device
    G = dd.bins_t.shape[0]
    C = vals.shape[0]
    sl = inv.long()[torch.where(hleaf >= 0, hleaf.long(), L)]
    rows = torch.nonzero(sl >= 0)[:, 0]
    cells = ((sl[rows][None, :] * G
              + torch.arange(G, device=dev)[:, None]) * B
             + dd.bins_t[:, rows].long()) * C               # [G, r]
    idx = (cells[:, :, None]
           + torch.arange(C, device=dev)[None, None, :]).reshape(-1)
    vv = vals[:, rows].int().t()[None].expand(G, -1, -1).reshape(-1)
    vv = vv.contiguous()
    acc = torch.zeros(A * G * B * C, dtype=torch.int32, device=dev)
    return int(rows.numel()), time_ms(lambda: acc.index_add_(0, idx, vv), 5)


def k4_measure(dd, leaf2, tabs, cat, lv, int_rate: float) -> dict:
    """K4 (route + per-row leaf value, the last pass of a tree) on one
    wave's tables: kernel vs plain version bitwise, times and bound."""
    import torch
    from lightgbm_tpu_torch.ops import cuda_build
    from lightgbm_tpu_torch.ops.route import (
        ROUTE_BLOCK, _route_grid, route_rows_values_raw, route_values_plain)
    dev = dd.device
    n_pad = dd.n_pad
    L, B = cat.shape
    out, v = route_rows_values_raw(dd.bins_t, leaf2, tabs, cat, lv)
    ref, rv = route_values_plain(dd.bins_t, leaf2, tabs, cat, lv)
    torch.cuda.synchronize()
    if not (torch.equal(out, ref) and torch.equal(v, rv)):
        raise AssertionError(f"route-values kernel != plain (L={L}, B={B})")
    lib = cuda_build.library("route")
    buf = torch.empty_like(leaf2)
    vbuf = torch.empty(n_pad, dtype=torch.float32, device=dev)

    def call(stream=torch.cuda.current_stream(dev).cuda_stream):
        return lib.lgbm_route_rows_values(
            dd.bins_t.data_ptr(), n_pad, leaf2.data_ptr(), buf.data_ptr(),
            tabs.data_ptr(), L, cat.data_ptr(), B, lv.data_ptr(),
            vbuf.data_ptr(), _route_grid(n_pad, dev), ROUTE_BLOCK, stream)
    ms = time_ms(call, 50)
    gms = graph_ms(lambda: call(current_stream(dev)))
    pl = time_ms(lambda: route_values_plain(dd.bins_t, leaf2, tabs, cat,
                                            lv), 5)
    moved_rows, sectors = moved_sectors(dd.bins_t, leaf2, tabs)
    tab_bytes = 11 * L * 4 + L * B + 4 * L
    bd = bound(20 * n_pad + moved_rows + tab_bytes, n_pad, int_rate)
    sec = bound(20 * n_pad + 32 * sectors + tab_bytes, n_pad, int_rate)
    floor = launch_floor(_route_grid(n_pad, dev), ROUTE_BLOCK, dev)
    log(f"kernel route_values L={L} B={B} rows={dd.num_data} "
        f"({int(tabs[3].sum())} categorical splits): bitwise ok, "
        f"{ms:.4f} ms back to back, {gms:.4f} ms in a graph (plain "
        f"{pl:.3f} ms, bound {bd['bound_ms']:.4f} ms; {moved_rows} moved "
        f"rows touch {sectors} sectors: sector bound "
        f"{sec['bound_ms']:.4f} ms; an empty kernel of its grid "
        f"{floor['launch_floor_ms']:.4f} ms back to back, "
        f"{floor['launch_floor_graph_ms']:.4f} ms in a graph)")
    return dict(ms=ms, graph_ms=gms, plain_ms=pl, library_ms=None,
                moved_rows=moved_rows, sectors=sectors,
                sector_bound_ms=sec["bound_ms"], **floor, **bd)


def k1_measure(dd, vals, A: int, n_sel: int, gen, L: int,
               int_rate: float, bag: float = 1.0, **cat) -> dict:
    """K1 (fused route + histogram) at ``A`` slots of a wave with
    ``n_sel`` pending splits (``cat``: :func:`wave_inputs`'s categorical
    arguments) and rows in the bag with probability ``bag``: kernel vs
    plain version bitwise, times and bound.  With ``bag`` < 1 the -1
    slots must have collected every out-of-bag row."""
    import torch
    from lightgbm_tpu_torch.ops import cuda_build
    from lightgbm_tpu_torch.ops.histogram import (
        bin_stride, hist_launcher, hist_plan, hist_route_plain, hist_route_raw,
        hist_slab, slot_tables)
    dev = dd.device
    G, n_pad = dd.bins_t.shape
    C = vals.shape[0]
    B = bin_stride(dd.group_max_bins)
    tab_bytes = 11 * L * 4 + L * B
    leaf2, tabs, cat, active = wave_inputs(dd, A, n_sel, A, gen, L, bag,
                                           **cat)
    raw, l2n = hist_route_raw(dd.bins_t, vals, leaf2, active, tabs, cat,
                              L, dd.group_max_bins)
    inv, src = slot_tables(active, L, collect_unbagged=True)
    ref_raw, ref_l2 = hist_route_plain(dd.bins_t, vals, leaf2, tabs, cat,
                                       inv, src, B)
    torch.cuda.synchronize()
    if not (torch.equal(raw, ref_raw) and torch.equal(l2n, ref_l2)):
        raise AssertionError(f"hist_route kernel != plain (A={A}, B={B})")
    if bag < 1.0:
        # each -1 slot holds the out-of-bag rows: count column, column 0
        n_oob = int((ref_l2[1, :dd.num_data] < 0).sum())
        slot = int(torch.nonzero(active < 0)[0, 0])
        got = int(ref_raw[slot, 0, :, C - 1].sum())
        if n_oob == 0 or got != n_oob:
            raise AssertionError(f"hist_route -1 slot holds {got} rows, "
                                 f"{n_oob} are out of the bag")
    plan = hist_plan(n_pad, G, A, B, C, cuda_build.multiprocessor_count(dev),
                     L, True)
    slab = hist_slab(plan, A, G, B, C, dev)
    obuf = torch.zeros_like(raw)
    lbuf = torch.empty_like(leaf2)
    ms = time_ms(hist_launcher("hist_route", dd.bins_t, vals, leaf2, inv,
                               src, L, B, plan, slab, obuf, lbuf, tabs, cat),
                 20)
    pl = time_ms(lambda: hist_route_plain(dd.bins_t, vals, leaf2, tabs,
                                          cat, inv, src, B), 3)
    n_active, lib_ms = index_add_ms(dd, vals, ref_l2[1], inv, A, L, B)
    moved_rows = int((tabs[4][leaf2[0].clamp(min=0).long()] != 0).sum())
    bd = bound(16 * n_pad + moved_rows + (G + C) * n_active
               + raw.numel() * 4 + tab_bytes + (L + 1 + A) * 4,
               G * C * n_active, int_rate)
    log(f"kernel hist_route A={A} B={B} rows={dd.num_data} "
        f"({int(tabs[3].sum())} categorical splits): bitwise ok, "
        f"{ms:.4f} ms (plain {pl:.3f} ms, index_add_ {lib_ms:.4f} ms, "
        f"bound {bd['bound_ms']:.4f} ms by {bd['bound_by']}, {n_active} "
        f"active rows)")
    return dict(slots=A, ms=ms, plain_ms=pl, library_ms=lib_ms,
                plan=plan.__dict__, **bd)


def split_wave_inputs(F: int, B: int, L2: int, n: int, gen, dev):
    """A split-scan wave ``[L2, F, B, 3]``: histograms of ``n`` simulated
    rows spread over ``L2`` leaves (every feature partitions the same
    rows), their leaf totals and random per-feature bin counts and
    missing types."""
    import torch
    leaf = torch.randint(0, L2, (n,), generator=gen, device=dev)
    g = torch.randn(n, generator=gen, device=dev)
    h = torch.rand(n, generator=gen, device=dev) * 0.25 + 0.01
    num_bins = torch.randint(B // 2, B + 1, (F,), generator=gen,
                             device=dev).int()
    mt = torch.randint(0, 3, (F,), generator=gen, device=dev).int()
    db = (torch.rand(F, generator=gen, device=dev) * num_bins).int()
    bins = (torch.rand(n, F, generator=gen, device=dev) * num_bins).long()
    ghc = torch.stack([g, h, torch.ones_like(g)], -1)          # [n, 3]
    idx = (leaf[:, None] * F + torch.arange(F, device=dev)) * B + bins
    grid = torch.zeros(L2 * F * B, 3, device=dev)
    grid.index_add_(0, idx.reshape(-1),
                    ghc[:, None, :].expand(n, F, 3).reshape(-1, 3))
    tot = torch.zeros(L2, 3, device=dev).index_add_(0, leaf, ghc)
    return (grid.reshape(L2, F, B, 3), tot[:, 0].contiguous(),
            tot[:, 1].contiguous(), tot[:, 2].contiguous(), num_bins, mt,
            db)


def k6_flops_per_cell(B: int, any_missing: bool) -> int:
    """Float operations of the split scan per (leaf, feature, bin) cell:
    the 3-channel prefix scan, with missing values the suffix scan, its
    broadcast and the missing-left sums, and per variant 3 right-side
    subtractions, two gains (5 each) and their sum.  Compares and the
    argmax are not counted, so the bound is a lower one."""
    lg = B.bit_length() - 1
    per_variant = 3 + 2 * 5 + 1
    if any_missing:
        return 3 * lg + 6 * lg + 3 + 2 * per_variant
    return 3 * lg + per_variant


def small_kernel_phase(dds, vals, int_rate: float, entries) -> None:
    """The small-data path's kernels at its shapes, with the path's
    bagging fraction: K1 at 256 bins and 32 slots on 65,536 rows and K4
    at 63 leaves (added to their entries under ``small_data``), and the
    split scan K6 on a ``[64, 28, 256, 3]`` wave (its own entry) and on
    a ``[64, 28, 64, 3]`` one (under ``by_shape``)."""
    import torch
    dev = dds.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    L = TRAIN_CONF["num_leaves"]
    bag = TRAIN_CONF["bagging_fraction"]
    k1 = k1_measure(dds, vals, 32, 16, gen, L, int_rate, bag)
    # a tree's last pass: 32 leaves, 31 of them split -> 63 leaves
    leaf2, tabs, cat, _ = wave_inputs(dds, 32, 31, 32, gen, L, bag)
    lv = torch.randn(L, generator=gen, device=dev)
    k4 = k4_measure(dds, leaf2, tabs, cat, lv, int_rate)
    small = {"hist_route": dict(rows=dds.num_data, bins=256, **k1),
             "route_values": dict(rows=dds.num_data, leaves=L,
                                  bins=cat.shape[1], **k4)}
    for e in entries:
        if e["name"] in small:
            e["small_data"] = small[e["name"]]

    by_shape = [k6_measure(HEADLINE_FEATURES, B, 64, gen, dev)
                for B in (256, 64)]
    entries.append(dict(
        name="split_scan", route="cuda",
        source="lightgbm_tpu_torch/csrc/split.cu",
        replaces="lightgbm_tpu/ops/pallas_split.py:206", max_abs_err=0.0,
        **by_shape[0], by_shape=by_shape))


def k6_measure(F: int, B: int, L2: int, gen, dev) -> dict:
    """K6 on one ``[L2, F, B, 3]`` wave with the path's constraints and
    feature fraction: the wrapper's result against the plain version
    (every field bitwise), times and bound."""
    import torch
    from lightgbm_tpu_torch.ops import cuda_build
    from lightgbm_tpu_torch.ops.split import SplitParams
    from lightgbm_tpu_torch.ops.split_kernel import (
        PACKED, find_best_splits_kernel, split_epilogue, split_hyper,
        split_kernel_ok, split_scan_launch, split_scan_plain)
    if not split_kernel_ok(F, B, False, SMALL_ROWS):
        raise AssertionError(f"split_kernel_ok refuses [{L2}, {F}, {B}, 3]")
    inputs = split_wave_inputs(F, B, L2, SMALL_ROWS, gen, dev)
    params = SplitParams(
        min_data_in_leaf=TRAIN_CONF["min_data_in_leaf"],
        min_sum_hessian_in_leaf=TRAIN_CONF["min_sum_hessian_in_leaf"])
    hyper = split_hyper(params)
    fmask = torch.rand(F, generator=gen, device=dev) < 0.8
    fm8 = fmask.to(torch.uint8)
    # every packed field reaches the result unchanged through the
    # epilogue, so the wrapper's result holds the kernel's output
    res = find_best_splits_kernel(*inputs, params=params,
                                  feature_mask=fmask, any_missing=True)
    ref = split_scan_plain(*inputs, fmask, hyper, True)
    ref_res = split_epilogue(ref, *inputs[1:4], params, B)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(res.__dict__.values(),
                                                  ref_res.__dict__.values())):
        raise AssertionError(f"split scan kernel != plain version (B={B})")
    n_split = int((res.gain > 0).sum())
    if n_split < L2 // 2:
        raise AssertionError(f"split scan wave found {n_split} splits")
    lib = cuda_build.library("split")
    out = torch.empty((L2, PACKED), dtype=torch.float32, device=dev)

    def call():
        return split_scan_launch(lib, *inputs, fm8, hyper, True, out)
    ms = time_ms(call, 50)
    gms = graph_ms(call)
    pl = time_ms(lambda: split_scan_plain(*inputs, fmask, hyper, True), 5)
    nbytes = (inputs[0].numel() * 4 + 3 * L2 * 4 + 3 * F * 4 + F
              + out.numel() * 4)
    bd = bound(nbytes, L2 * F * B * k6_flops_per_cell(B, True),
               FP32_OPS_PER_S)
    log(f"kernel split_scan [{L2}, {F}, {B}, 3]: bitwise ok, {n_split} "
        f"splits, {ms:.4f} ms back to back, {gms:.4f} ms in a graph (plain "
        f"{pl:.3f} ms, bound {bd['bound_ms']:.4f} ms by {bd['bound_by']})")
    return dict(shape=[L2, F, B, 3], ms=ms, graph_ms=gms, plain_ms=pl,
                library_ms=None, splits=n_split, **bd)


def float_values(dd, mode: str, gen):
    """Float value rows (``pack_values``) of random gradients on ``dd``."""
    import torch
    from lightgbm_tpu_torch.ops.histogram import pack_values
    g = torch.randn(dd.num_data, generator=gen, device=dd.device) * 0.5
    h = torch.rand(dd.num_data, generator=gen, device=dd.device) * 0.25
    return pack_values(g, h, mode, dd.n_pad)


def skew_wave(leaf2, tabs, leaf: int):
    """Every row that is not padding in ``leaf``, which the wave's
    tables leave unsplit: the shape of every tree's first wave."""
    import torch
    from lightgbm_tpu_torch.ops.route import T_SEL
    tabs = tabs.clone()
    tabs[T_SEL, leaf] = 0
    return torch.where(leaf2 >= 0, leaf, leaf2).contiguous(), tabs


def bits_equal(a, b) -> bool:
    """Float tensors compared by bit pattern (``torch.equal`` takes -0.0
    for 0.0)."""
    import torch
    return torch.equal(a.cpu().contiguous().view(torch.int32),
                       b.cpu().contiguous().view(torch.int32))


def chunk_pairs(hl, inv, rows, A: int) -> int:
    """(chunk, accumulation slot) pairs with rows: the chunk partials the
    float K5's order writes and reads back."""
    import torch
    from lightgbm_tpu_torch.ops.histogram import FLOAT_CHUNK
    L = inv.shape[0] - 1
    slot = inv.long()[torch.where(hl >= 0, hl.long(), L)][rows]
    return int(torch.unique((rows // FLOAT_CHUNK) * A + slot).numel())


def walk_measure(dd, vals, hl, inv, src, L: int, B: int, acc_shape,
                 reps: int = 5) -> dict:
    """The float K3 launched through its window launchers: times of a
    whole call, of its three phases apart (the sort; the walks: heavy
    chunk partials and light walks; the fold of the heavy partials) and
    of each kernel in a CUDA graph, and its heavy/light choice on the
    card held against the host rule (``float_walk_split``)."""
    import torch
    from lightgbm_tpu_torch.ops import cuda_build
    from lightgbm_tpu_torch.ops.histogram import (
        FLOAT_CHUNK, FLOAT_WALK_KERNELS, FloatWalkScratch, float_dense_rows,
        float_light_rows, float_walk_launches, float_walk_plan,
        float_walk_split)
    G, n_pad = dd.bins_t.shape
    C, A = vals.shape[0], src.shape[0]
    plan = float_walk_plan(n_pad, A, G, B, C, L,
                           cuda_build.multiprocessor_count(dd.device))
    scratch = FloatWalkScratch.empty(plan, A, G, B, C, dd.device)
    obuf = torch.zeros(acc_shape, device=dd.device)

    def launches(phase):
        return float_walk_launches(dd.bins_t, vals, hl, inv, src, L, B, plan,
                                   scratch, obuf, phase)

    def run(phase):
        fns = launches(phase)
        return lambda: [f() for f in fns]

    def on_stream(phase):   # bound to the current (capture) stream
        return lambda: max(f() for f in launches(phase))
    times = {}
    for ph in ("both", "sort", "walk", "fold"):
        times[f"{ph}_ms"] = time_ms(run(ph), reps)
        times[f"{ph}_graph_ms"] = graph_ms(on_stream(ph), n=20)
    # each kernel's device time (on the scratch of the calls above)
    times["kernel_graph_ms"] = {k: graph_ms(on_stream(k), n=20)
                                for k in FLOAT_WALK_KERNELS}
    # the last window's plan, against the host rule on its rows
    run("sort")()
    torch.cuda.synchronize()
    w0 = (n_pad - 1) // plan.window * plan.window
    rows = n_pad - w0
    meta = scratch.meta(A, rows).cpu()
    hw = hl[w0:].long()
    sl = inv.long()[torch.where(hw >= 0, hw, L)]
    kw = -(-rows // FLOAT_CHUNK)
    ks = torch.arange(rows, device=hw.device) // FLOAT_CHUNK
    on = sl >= 0
    counts = torch.bincount(sl[on] * kw + ks[on], minlength=A * kw)
    hbase, lrows, hcount = float_walk_split(counts.view(A, kw).tolist(),
                                            float_light_rows(rows),
                                            float_dense_rows(rows),
                                            plan.pcap)
    if (meta[3].tolist() != hbase or meta[4].tolist() != lrows
            or meta[5].tolist() != hcount):
        raise AssertionError("hist_compact_float: the card's plan != the "
                             "host rule")
    return dict(ms=times.pop("both_ms"), graph_ms=times.pop("both_graph_ms"),
                **times, windows=-(-n_pad // plan.window),
                heavy_slots=sum(h >= 0 for h in hbase),
                light_slots=sum(h < 0 and n > 0 for h, n in zip(hbase, lrows)),
                heavy_pairs=sum(hcount), walked_rows_max=max(lrows),
                scratch_bytes=scratch.nbytes)


def kernel_line(walk: dict) -> str:
    return " ".join(f"{k} {v:.4f}" for k, v in walk["kernel_graph_ms"].items())


def k1_float_measure(dd, mode: str, A: int, gen, L: int = 255,
                     bag: float = 1.0, skew: bool = False, **cat) -> dict:
    """The float K1 at ``A`` slots of a headline wave: bitwise (bit
    patterns) against its plain version on CPU copies and against K2
    followed by the float K5 on the card; times of the kernel and of its
    partial and fold phases apart (back to back and in a CUDA graph), of
    that composition (its yardstick, with the float K5's partial and fold
    phases apart), of the plain version and of an f32 ``index_add_`` over
    the routed rows (its library call); the bound and the float K5's
    contract floor (its chunk partials written and read back)."""
    import torch
    from lightgbm_tpu_torch.ops.histogram import (
        FLOAT_WINDOW, bin_stride, float_plan, float_scratch,
        hist_active_float_raw, hist_float_launcher, hist_route_float_launches,
        hist_route_float_plain, hist_route_float_raw, slot_tables)
    from lightgbm_tpu_torch.ops.route import route_rows_raw
    dev = dd.device
    G, n_pad = dd.bins_t.shape
    B = bin_stride(dd.group_max_bins)
    vals = float_values(dd, mode, gen)
    C = vals.shape[0]
    cat_share = cat.get("cat_share", 0.0)
    leaf2, tabs, cat, active = wave_inputs(dd, max(A, 8), A // 2, A, gen, L,
                                           bag, **cat)
    if skew:
        leaf2, tabs = skew_wave(leaf2, tabs, int(active[0]))
    raw, l2n = hist_route_float_raw(dd.bins_t, vals, leaf2, active, tabs,
                                    cat, L, dd.group_max_bins)
    routed = route_rows_raw(dd.bins_t, leaf2, tabs, cat)
    k5 = hist_active_float_raw(dd.bins_t, vals, routed[1].contiguous(),
                               active, L, dd.group_max_bins)
    inv, src = slot_tables(active, L, collect_unbagged=True)
    cpu = [t.cpu() for t in (dd.bins_t, vals, leaf2, tabs, cat, inv, src)]
    t0 = time.time()
    ref, ref_l2 = hist_route_float_plain(*cpu, B, torch.zeros(raw.shape))
    pl = 1e3 * (time.time() - t0)
    torch.cuda.synchronize()
    err = float((raw.cpu() - ref).abs().max())
    if not (bits_equal(raw, ref) and torch.equal(l2n.cpu(), ref_l2)):
        raise AssertionError(f"hist_route_float kernel != plain version "
                             f"({mode}, A={A}, skew={skew}, max abs err "
                             f"{err})")
    if not (bits_equal(raw, k5) and torch.equal(l2n, routed)):
        raise AssertionError(f"hist_route_float != K2 + float K5 ({mode}, "
                             f"A={A}, skew={skew})")
    hl = ref_l2[1].to(dev)
    rows = _active_rows(hl, inv)
    n_active = int(rows.numel())
    if bag < 1.0 and bool((active < 0).any()):
        # each -1 slot holds the out-of-bag rows: count column, column 0
        n_oob = int((ref_l2[1, :dd.num_data] < 0).sum())
        slot = int(torch.nonzero(active < 0)[0, 0])
        got = int(ref[slot, 0, :, C - 1].sum())
        if n_oob == 0 or got != n_oob:
            raise AssertionError(f"hist_route_float -1 slot holds {got} "
                                 f"rows, {n_oob} are out of the bag")
    plan = float_plan(A, B, C)
    part, counts = float_scratch(min(n_pad, FLOAT_WINDOW), A, G, B, C, dev)
    obuf = torch.zeros_like(raw)
    lbuf = torch.empty_like(leaf2)

    def k1_call(phase):
        fns = hist_route_float_launches(dd.bins_t, vals, leaf2, inv, src, L,
                                        B, plan, part, counts, obuf, lbuf,
                                        tabs, cat, phase)
        return lambda: [f() for f in fns]

    def k1_graph(phase):   # bound to the current (capture) stream
        return lambda: max(f() for f in hist_route_float_launches(
            dd.bins_t, vals, leaf2, inv, src, L, B, plan, part, counts, obuf,
            lbuf, tabs, cat, phase))
    walk = {}
    for ph in ("both", "partial", "fold"):
        walk["ms" if ph == "both" else f"{ph}_ms"] = time_ms(k1_call(ph), 10)
        walk["graph_ms" if ph == "both" else f"{ph}_graph_ms"] = graph_ms(
            k1_graph(ph), n=20)
    walk["windows"] = -(-n_pad // FLOAT_WINDOW)
    del part
    part5, counts5 = float_scratch(n_pad, A, G, B, C, dev)
    hl5 = routed[1].contiguous()

    def k5_call(phase):
        return hist_float_launcher(dd.bins_t, vals, hl5, inv, src, L, B,
                                   plan, part5, counts5,
                                   torch.zeros_like(raw), phase)
    k5_both = k5_call("both")
    yard = time_ms(lambda: (route_rows_raw(dd.bins_t, leaf2, tabs, cat),
                            k5_both()), 10)
    k5_partial_ms = time_ms(k5_call("partial"), 10)
    k5_fold_ms = time_ms(k5_call("fold"), 10)
    del part5
    idx = _flat_cells(dd.bins_t, hl, inv, rows, B, C).reshape(-1)
    vv = vals[:, rows].t()[None].expand(G, -1, -1).reshape(-1).contiguous()
    lacc = torch.zeros(raw.numel(), device=dev)
    lib_ms = time_ms(lambda: lacc.index_add_(0, idx, vv), 5)
    del idx, vv
    tab_bytes = 11 * L * 4 + L * cat.shape[1]
    bd = bound(16 * n_pad + G * n_pad + 4 * C * n_pad + 2 * raw.numel() * 4
               + tab_bytes + (L + 1 + A) * 4, G * C * n_active + raw.numel(),
               FP32_OPS_PER_S)
    pairs = chunk_pairs(hl, inv, rows, A)
    floor_ms = 2 * pairs * G * B * C * 4 / PEAK_BYTES_PER_S * 1e3
    log(f"kernel hist_route_float ({mode}{', skewed' if skew else ''}"
        f"{', %d categorical splits' % int(tabs[3].sum()) if cat_share else ''}"
        f"{', bag %.1f' % bag if bag < 1 else ''}) A={A} rows={dd.num_data}: "
        f"bitwise ok (plain, K2 + float K5), {walk['ms']:.4f} ms = "
        f"partials {walk['partial_ms']:.4f} + fold {walk['fold_ms']:.4f} "
        f"ms; in a graph {walk['graph_ms']:.4f} = "
        f"{walk['partial_graph_ms']:.4f} + {walk['fold_graph_ms']:.4f} ms "
        f"(K2 + float K5 {yard:.4f} ms with the float K5's partials "
        f"{k5_partial_ms:.4f} + fold {k5_fold_ms:.4f} ms; f32 index_add_ "
        f"{lib_ms:.4f} ms; plain on the CPU {pl:.1f} ms; bound "
        f"{bd['bound_ms']:.4f} ms by {bd['bound_by']}; the float K5's "
        f"contract floor {floor_ms:.4f} ms for {pairs} chunk partials; "
        f"{walk['windows']} windows)")
    return dict(slots=A, mode=mode, shape="skewed" if skew else "uniform",
                bag=bag, **walk, yardstick_ms=yard,
                k5_partial_ms=k5_partial_ms, k5_fold_ms=k5_fold_ms,
                plain_ms=pl, plain_device="cpu", library_ms=lib_ms,
                max_abs_err=err, active_rows=n_active, chunk_partials=pairs,
                contract_floor_ms=floor_ms, **bd)


def k3_float_measure(dd, mode: str, A: int, gen, L: int = 255,
                     skew: bool = False) -> dict:
    """The float K3 at ``A`` slots of a headline wave after its route:
    bitwise (bit patterns) against its plain version on CPU copies and
    against the float K5 on its non-negative slots on the card; times of
    the kernel and of its phases (``walk_measure``), of the plain version
    and of an f32 ``index_add_``; the bound."""
    import torch
    from lightgbm_tpu_torch.ops.compact import hist_compact_float_raw
    from lightgbm_tpu_torch.ops.histogram import (
        bin_stride, hist_active_float_raw, hist_float_plain, slot_tables)
    from lightgbm_tpu_torch.ops.route import route_rows_raw
    dev = dd.device
    G, n_pad = dd.bins_t.shape
    B = bin_stride(dd.group_max_bins)
    vals = float_values(dd, mode, gen)
    C = vals.shape[0]
    leaf2, tabs, cat, active = wave_inputs(dd, 127 if A == 128 else 63,
                                           A - 2, A, gen, L, 0.8)
    hl = route_rows_raw(dd.bins_t, leaf2, tabs, cat)[1].contiguous()
    if skew:
        hl = torch.where(hl >= 0, active[0], hl).contiguous()
    raw = hist_compact_float_raw(dd.bins_t, vals, hl, active, L,
                                 dd.group_max_bins)
    k5 = hist_active_float_raw(dd.bins_t, vals, hl, active, L,
                               dd.group_max_bins)
    inv, src = slot_tables(active, L, collect_unbagged=False)
    cpu = [t.cpu() for t in (dd.bins_t, vals, hl, inv, src)]
    t0 = time.time()
    ref = hist_float_plain(*cpu, B, torch.zeros(raw.shape))
    pl = 1e3 * (time.time() - t0)
    torch.cuda.synchronize()
    err = float((raw.cpu() - ref).abs().max())
    live = active >= 0
    if not (bits_equal(raw, ref) and bits_equal(raw[live], k5[live])
            and not raw[~live].any()):
        raise AssertionError(f"hist_compact_float kernel != plain version "
                             f"or float K5 ({mode}, A={A}, skew={skew}, max "
                             f"abs err {err})")
    rows = _active_rows(hl, inv)
    n_active = int(rows.numel())
    walk = walk_measure(dd, vals, hl, inv, src, L, B, raw.shape)
    idx = _flat_cells(dd.bins_t, hl, inv, rows, B, C).reshape(-1)
    vv = vals[:, rows].t()[None].expand(G, -1, -1).reshape(-1).contiguous()
    lacc = torch.zeros(raw.numel(), device=dev)
    lib_ms = time_ms(lambda: lacc.index_add_(0, idx, vv), 5)
    del idx, vv
    bd = bound(4 * n_pad + (G + 4 * C) * n_active + 2 * raw.numel() * 4
               + (L + 1 + A) * 4, G * C * n_active, FP32_OPS_PER_S)
    log(f"kernel hist_compact_float ({mode}{', skewed' if skew else ''}) "
        f"A={A} rows={dd.num_data}: bitwise ok (plain, float K5), "
        f"{walk['ms']:.4f} ms = sort {walk['sort_ms']:.4f} + walk "
        f"{walk['walk_ms']:.4f} + fold {walk['fold_ms']:.4f} ms; in a graph "
        f"{walk['graph_ms']:.4f} = {walk['sort_graph_ms']:.4f} + "
        f"{walk['walk_graph_ms']:.4f} + {walk['fold_graph_ms']:.4f} ms "
        f"(by kernel {kernel_line(walk)}; {walk['heavy_slots']} slots with "
        f"heavy pairs, {walk['heavy_pairs']} heavy pairs, "
        f"{walk['light_slots']} walked whole, at most "
        f"{walk['walked_rows_max']} rows a walk; plain on the CPU "
        f"{pl:.1f} ms, f32 index_add_ {lib_ms:.4f} ms, bound "
        f"{bd['bound_ms']:.4f} ms by {bd['bound_by']}, {n_active} active "
        f"rows)")
    return dict(slots=A, mode=mode, shape="skewed" if skew else "uniform",
                **walk, plain_ms=pl, plain_device="cpu", library_ms=lib_ms,
                max_abs_err=err, active_rows=n_active, **bd)


def float_kernel_phase(dd, entries) -> None:
    """The float K1 and K3 at the headline shapes (255 leaves, 64-bin
    stride) on hhilo and hilo values: K1 at 8 / 16 / 32 slots with
    bagged-out rows (and a skewed 32-slot wave), K3 at 64 / 128 slots
    (and a skewed 128-slot wave).  Appends their entries (the numbers of
    the widest uniform hhilo wave, every wave under ``by_width``)."""
    import torch
    gen = torch.Generator(device=dd.device)
    gen.manual_seed(4)
    k1 = [k1_float_measure(dd, "hhilo", A, gen, bag=0.8) for A in (8, 16, 32)]
    k1 += [k1_float_measure(dd, "hilo", 32, gen, bag=0.8),
           k1_float_measure(dd, "hhilo", 32, gen, skew=True)]
    entries.append(dict(
        name="hist_route_float", route="cuda",
        source="lightgbm_tpu_torch/csrc/hist_route_float.cu",
        replaces="lightgbm_tpu/ops/pallas_histogram.py:637",
        **{k: v for k, v in k1[2].items() if k != "slots"}, by_width=k1))
    k3 = [k3_float_measure(dd, "hhilo", A, gen) for A in (64, 128)]
    k3 += [k3_float_measure(dd, "hilo", 128, gen),
           k3_float_measure(dd, "hhilo", 128, gen, skew=True)]
    entries.append(dict(
        name="hist_compact_float", route="cuda",
        source="lightgbm_tpu_torch/csrc/hist_compact_float.cu",
        replaces="lightgbm_tpu/ops/compact.py:179",
        **{k: v for k, v in k3[1].items() if k != "slots"}, by_width=k3))
    torch.cuda.synchronize()


def stream_wave(gen, nl: int, A: int, G: int = STREAM_FEATURES,
                R: int = STREAM_BLOCK, max_bins: int = 63, skew: bool = False):
    """One streamed block of a wave: bins ``[G, R]``, gradients, hist
    leaves over ``nl`` leaves with 5% of rows at -1 (padding rows), and
    ``A`` active slots, two of them -1.  With ``skew`` every row that is
    not padding sits in the first active slot, as in the first wave of
    every tree."""
    import torch
    dev = gen.device
    bins_t = torch.randint(0, max_bins, (G, R), generator=gen, device=dev,
                           dtype=torch.uint8)
    g = torch.randn(R, generator=gen, device=dev) * 0.5
    h = torch.rand(R, generator=gen, device=dev) * 0.25
    hl = torch.randint(0, nl, (R,), generator=gen, device=dev).int()
    hl[torch.rand(R, generator=gen, device=dev) < 0.05] = -1
    active = torch.randperm(nl, generator=gen, device=dev)[:A].int()
    active[-2:] = -1
    if skew:
        hl = torch.where(hl >= 0, active[0], hl)
    return bins_t, g, h, hl, active.contiguous()


def _flat_cells(bins_t, hl, inv, rows, B: int, C: int):
    """Flat ``[A, G, B, C]`` cell indices of ``rows``, ``[G, r, C]``."""
    import torch
    G = bins_t.shape[0]
    L = inv.shape[0] - 1
    sl = inv.long()[torch.where(hl >= 0, hl.long(), L)][rows]
    cells = ((sl[None, :] * G + torch.arange(G, device=hl.device)[:, None])
             * B + bins_t[:, rows].long()) * C
    return cells[:, :, None] + torch.arange(C, device=hl.device)[None, None]


def _active_rows(hl, inv):
    import torch
    L = inv.shape[0] - 1
    return torch.nonzero(inv.long()[torch.where(hl >= 0, hl.long(), L)]
                         >= 0)[:, 0]


def k5_int8h_measure(gen, shape: str, int_rate: float) -> dict:
    """The seeded K5 on int8h values at the stream block shape, adding
    into the carry a previous block left: bitwise against the plain
    version, times and bound."""
    import torch
    from lightgbm_tpu_torch.ops import cuda_build
    from lightgbm_tpu_torch.ops.histogram import (
        bin_stride, hist_active_raw, hist_launcher, hist_plain, hist_plan,
        hist_slab, pack_values_q, slot_tables)
    dev = gen.device
    L, A, G, R = STREAM_PARAMS["num_leaves"], 32, STREAM_FEATURES, \
        STREAM_BLOCK
    B = bin_stride(63)
    skew = shape == "skewed"
    prev = stream_wave(gen, L, A)
    bins_t, g, h, hl, active = stream_wave(gen, L, A, skew=skew)
    inv, src = slot_tables(active, L, collect_unbagged=True)
    rows = _active_rows(hl, inv)
    n_active = int(rows.numel())
    vp, sc = pack_values_q(prev[1], prev[2], "int8h", R)
    vals, _ = pack_values_q(g, h, "int8h", R, scales=sc)
    C = vals.shape[0]
    carry = hist_active_raw(prev[0], vp, prev[3], active, L, 63)
    got = hist_active_raw(bins_t, vals, hl, active, L, 63, carry.clone())
    ref = carry + hist_plain(bins_t, vals, hl, inv, src, B)
    torch.cuda.synchronize()
    if not (torch.equal(got, ref) and not torch.equal(carry, ref)):
        raise AssertionError(f"hist_active kernel != plain version ({shape})")
    plan = hist_plan(R, G, A, B, C, cuda_build.multiprocessor_count(dev), L,
                     False)
    slab = hist_slab(plan, A, G, B, C, dev)
    obuf = carry.clone()
    ms = time_ms(hist_launcher("hist_active", bins_t, vals, hl, inv, src, L,
                               B, plan, slab, obuf), 20)
    pl = time_ms(lambda: carry + hist_plain(bins_t, vals, hl, inv, src, B),
                 3)
    idx = _flat_cells(bins_t, hl, inv, rows, B, C).reshape(-1)
    vv = vals[:, rows].int().t()[None].expand(G, -1, -1).reshape(-1)
    vv = vv.contiguous()
    lacc = carry.clone().reshape(-1)
    lib_ms = time_ms(lambda: lacc.index_add_(0, idx, vv), 5)
    bd = bound(G * R + C * R + 4 * R + 2 * carry.numel() * 4
               + (L + 1 + A) * 4, G * C * n_active, int_rate)
    log(f"kernel hist_active (K5 int8h, {shape}) A={A} rows={R}: bitwise "
        f"ok (seeded), {ms:.4f} ms (plain {pl:.3f} ms, int32 index_add_ "
        f"{lib_ms:.4f} ms, bound {bd['bound_ms']:.4f} ms by "
        f"{bd['bound_by']}, {n_active} active rows, slab "
        f"{slab.numel() * 4 / 2**20:.1f} MiB)")
    return dict(ms=ms, plain_ms=pl, library_ms=lib_ms, rows=R, slots=A,
                mode="int8h", shape=shape, active_rows=n_active,
                plan=plan.__dict__, slab_bytes=slab.numel() * 4, **bd)


def k5_float_measure(gen, shape: str) -> dict:
    """The seeded float K5 on hhilo values at the stream block shape:
    bitwise (bit patterns) against the plain version on CPU copies (only
    the CPU adds in its fixed order), times of the whole call and of its
    two phases, the bound and the contract's floor."""
    import torch
    from lightgbm_tpu_torch.ops.histogram import (
        FLOAT_CHUNK, bin_stride, float_plan, float_scratch,
        hist_active_float_raw, hist_float_launcher, hist_float_plain,
        pack_values, slot_tables)
    dev = gen.device
    L, A, G, R = STREAM_PARAMS["num_leaves"], 32, STREAM_FEATURES, \
        STREAM_BLOCK
    B = bin_stride(63)
    skew = shape == "skewed"
    prev = stream_wave(gen, L, A)
    bins_t, g, h, hl, active = stream_wave(gen, L, A, skew=skew)
    inv, src = slot_tables(active, L, collect_unbagged=True)
    rows = _active_rows(hl, inv)
    n_active = int(rows.numel())
    vp = pack_values(prev[1], prev[2], "hhilo", R)
    vals = pack_values(g, h, "hhilo", R)
    C = vals.shape[0]
    carry = hist_active_float_raw(prev[0], vp, prev[3], active, L, 63)
    got = hist_active_float_raw(bins_t, vals, hl, active, L, 63,
                                carry.clone())
    cpu = [t.cpu() for t in (bins_t, vals, hl, inv, src, carry)]
    t0 = time.time()
    ref = hist_float_plain(*cpu[:5], B, cpu[5].clone())
    pl = 1e3 * (time.time() - t0)
    got = got.cpu()
    err = float((got - ref).abs().max())
    same = torch.equal(got.view(torch.int32), ref.view(torch.int32))
    if not (same and not torch.equal(cpu[5], ref)):
        raise AssertionError(f"hist_float kernel != plain version ({shape}, "
                             f"max abs err {err})")
    plan = float_plan(A, B, C)
    part, counts = float_scratch(R, A, G, B, C, dev)
    obuf = carry.clone()

    def run(phase):
        return hist_float_launcher(bins_t, vals, hl, inv, src, L, B, plan,
                                   part, counts, obuf, phase)
    ms = time_ms(run("both"), 10)
    partial_ms = time_ms(run("partial"), 10)
    fold_ms = time_ms(run("fold"), 10)
    idx = _flat_cells(bins_t, hl, inv, rows, B, C).reshape(-1)
    vv = vals[:, rows].t()[None].expand(G, -1, -1).reshape(-1).contiguous()
    lacc = carry.clone().reshape(-1)
    lib_ms = time_ms(lambda: lacc.index_add_(0, idx, vv), 5)
    bd = bound(G * R + 4 * C * R + 4 * R + 2 * carry.numel() * 4
               + (L + 1 + A) * 4, G * C * n_active + carry.numel(),
               FP32_OPS_PER_S)
    # the contract's own floor: each (chunk, slot) pair with rows writes a
    # G x B x C f32 partial that the fold reads back
    slot = inv.long()[torch.where(hl >= 0, hl.long(), L)][rows]
    pairs = int(torch.unique((rows // FLOAT_CHUNK) * A + slot).numel())
    partial_bytes = 2 * pairs * G * B * C * 4
    floor_ms = partial_bytes / PEAK_BYTES_PER_S * 1e3
    log(f"kernel hist_float (K5 hhilo, {shape}) A={A} rows={R}: bitwise ok "
        f"(seeded), {ms:.4f} ms = partials {partial_ms:.4f} + fold "
        f"{fold_ms:.4f} ms (plain on the CPU {pl:.1f} ms, f32 index_add_ "
        f"{lib_ms:.4f} ms, bound {bd['bound_ms']:.4f} ms by "
        f"{bd['bound_by']}, contract floor {floor_ms:.4f} ms for "
        f"{pairs} chunk partials, {plan.warps} warps/block)")
    return dict(ms=ms, plain_ms=pl, plain_device="cpu", library_ms=lib_ms,
                max_abs_err=err, rows=R, slots=A, mode="hhilo", shape=shape,
                active_rows=n_active, partial_ms=partial_ms,
                fold_ms=fold_ms, chunk_partials=pairs,
                contract_floor_ms=floor_ms, warps=plan.warps, **bd)


def stream_kernel_phase(int_rate: float, entries) -> dict:
    """K5 on int8h and hhilo values (a uniform and a skewed wave) and the
    seeded K3 at the stream path's shapes, each adding into the carry a
    previous block left: bitwise against the plain version, times and
    bounds.  Appends the two K5 entries; -> the seeded K3 numbers."""
    import torch
    from lightgbm_tpu_torch.ops import cuda_build
    from lightgbm_tpu_torch.ops.compact import hist_compact_raw
    from lightgbm_tpu_torch.ops.histogram import (
        bin_stride, hist_launcher, hist_plain, hist_plan, hist_slab,
        pack_values_q, slot_tables)
    dev = torch.device("cuda")
    sms = cuda_build.multiprocessor_count(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    G, R = STREAM_FEATURES, STREAM_BLOCK
    B = bin_stride(63)

    uni = k5_int8h_measure(gen, "uniform", int_rate)
    entries.append(dict(
        name="hist_active", route="cuda",
        source="lightgbm_tpu_torch/csrc/hist_active.cu",
        replaces="lightgbm_tpu/ops/pallas_histogram.py:343",
        max_abs_err=0.0, **uni,
        skewed=k5_int8h_measure(gen, "skewed", int_rate)))
    uni = k5_float_measure(gen, "uniform")
    entries.append(dict(
        name="hist_float", route="cuda",
        source="lightgbm_tpu_torch/csrc/hist_float.cu",
        replaces="lightgbm_tpu/ops/pallas_histogram.py:343", **uni,
        skewed=k5_float_measure(gen, "skewed")))

    # -- K3 seeded at 128 slots (255 leaves) -------------------------------
    L3, A3 = 255, 128
    prev = stream_wave(gen, L3, A3)
    bins_t, g, h, hl, active = stream_wave(gen, L3, A3)
    active = prev[4]
    vp, sc = pack_values_q(prev[1], prev[2], "int8h", R)
    vals, _ = pack_values_q(g, h, "int8h", R, scales=sc)
    C = vals.shape[0]
    carry = hist_compact_raw(prev[0], vp, prev[3], active, L3, 63)
    got = hist_compact_raw(bins_t, vals, hl, active, L3, 63, carry.clone())
    inv, src = slot_tables(active, L3, collect_unbagged=False)
    ref = carry + hist_plain(bins_t, vals, hl, inv, src, B)
    torch.cuda.synchronize()
    if not (torch.equal(got, ref) and not torch.equal(carry, ref)):
        raise AssertionError("seeded hist_compact kernel != plain version")
    plan = hist_plan(R, G, A3, B, C, sms, L3, False)
    slab = hist_slab(plan, A3, G, B, C, dev)
    obuf = carry.clone()
    ms = time_ms(hist_launcher("hist_compact", bins_t, vals, hl, inv, src, L3,
                               B, plan, slab, obuf), 20)
    log(f"kernel hist_compact (K3 seeded) A={A3} rows={R}: bitwise ok, "
        f"{ms:.4f} ms")
    return dict(rows=R, slots=A3, ms=ms, seeded=True, plan=plan.__dict__)


def stream_paths(lgb, counters, tmp: str) -> dict:
    """The identity and scale phases of the streamed path: -> launches
    per phase."""
    import numpy as np
    import torch
    from lightgbm_tpu_torch.boosting.gbdt import GBDT
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.metric.metrics import binary_auc
    oc = lgb.outofcore
    cfg = Config.from_params(STREAM_PARAMS)

    def run(name, store, params=STREAM_PARAMS):
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        bst = lgb.train_streaming(params, store,
                                  num_boost_round=STREAM_ITERS,
                                  block_rows=STREAM_BLOCK, device="cuda")
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        peak = torch.cuda.max_memory_allocated()
        log(f"{name}: {store.n} rows x {STREAM_ITERS} iterations in "
            f"{wall:.3f} s = {store.n * STREAM_ITERS / wall:.4g} rows/s; "
            f"peak device memory {peak / 2**20:.1f} MiB; launches "
            f"{launches}")
        return bst, launches

    # identity: streamed == in memory, digest with scores
    t0 = time.time()
    store = oc.ingest_synthetic(os.path.join(tmp, "ident"),
                                STREAM_IDENT_ROWS, STREAM_FEATURES, cfg,
                                seed=3, shard_rows=STREAM_IDENT_ROWS)
    log(f"stream identity: ingest {time.time() - t0:.1f} s")
    bst, ident = run("stream identity", store)
    for k in ("hist_active", "route", "route_values"):
        if ident[k] <= 0:
            raise AssertionError(f"{k} did not launch in the stream")
    if ident["hist_float"] != 0:
        raise AssertionError("the float K5 ran on an int8h stream")
    for fn in counters.values():
        fn.launches = 0
    mem = GBDT(cfg, store.to_binned_dataset(cfg), "cuda")
    for _ in range(STREAM_ITERS):
        mem.train_one_iter()
    torch.cuda.synchronize()
    if counters["hist_route"].launches <= 0:
        raise AssertionError("K1 did not launch in memory")
    d_str, d_mem = bst.digest(), mem.digest()
    log(f"stream identity: streamed {d_str} in memory {d_mem}")
    if d_str != d_mem:
        raise AssertionError("streamed digest != in-memory digest")
    del mem

    # scale: past the int8 row bound the stream runs hhilo
    t0 = time.time()
    store = oc.ingest_synthetic(
        os.path.join(tmp, "scale"), STREAM_SCALE_ROWS, STREAM_FEATURES, cfg,
        seed=2, shard_rows=max(STREAM_BLOCK, STREAM_SCALE_ROWS // 32))
    log(f"stream scale: ingest {time.time() - t0:.1f} s, "
        f"{len(store.manifest['shards'])} shards")
    bst, scale = run("stream scale", store)
    log(f"stream scale: digest {bst.digest()}")
    if scale["hist_float"] <= 0:
        raise AssertionError("the float K5 did not launch past the int8 "
                             "row bound")
    if scale["hist_active"] != 0 or scale["hist_route"] != 0:
        raise AssertionError("an int8h histogram kernel ran on the hhilo "
                             "stream")
    scores = bst.scores.numpy()[:, 0]
    auc = binary_auc(store.labels_array(), scores)
    log(f"stream scale: train auc {auc:.5f}")
    if not np.isfinite(scores).all():
        raise AssertionError("streamed scores are not finite")
    if not auc >= AUC_GATE:
        raise AssertionError(f"stream auc {auc} < {AUC_GATE}")

    # the same 20M rows in memory: past the int8 row bound the in-memory
    # learner runs hhilo through the float K1 (63 leaves: waves of <= 32
    # slots) and must build the streamed model, scores included
    t0 = time.time()
    ds20 = store.to_binned_dataset(cfg)
    log(f"in-memory 20M: dataset from the store {time.time() - t0:.1f} s")

    def in_memory(name, params):
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        mem = GBDT(Config.from_params(params), ds20, "cuda")
        for _ in range(STREAM_ITERS):
            mem.train_one_iter()
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        peak = torch.cuda.max_memory_allocated()
        log(f"{name}: {store.n} rows x {STREAM_ITERS} iterations in memory "
            f"in {wall:.3f} s (upload included); peak device memory "
            f"{peak / 2**20:.1f} MiB; launches {launches}")
        if not peak < INMEM_PEAK_LIMIT:
            raise AssertionError(f"{name}: peak device memory {peak} B >= "
                                 f"{INMEM_PEAK_LIMIT} B")
        for k in ("hist_route", "hist_compact", "hist_active"):
            if launches[k] != 0:
                raise AssertionError(f"{name}: the int8 kernel {k} ran on "
                                     f"the hhilo path")
        return mem, launches

    mem, inmem = in_memory("in-memory scale", STREAM_PARAMS)
    d_str, d_mem = bst.digest(), mem.digest()
    log(f"in-memory scale: streamed {d_str} in memory {d_mem}")
    if d_str != d_mem:
        raise AssertionError("in-memory 20M digest != streamed scale digest")
    if inmem["hist_route_float"] <= 0:
        raise AssertionError("the float K1 did not launch in memory")
    del mem, bst

    # the headline's width on the same rows: 255 leaves (float K3 on the
    # 64- and 128-slot waves in memory), streamed and in memory
    bst, head_str = run("stream 20M headline width", store,
                        HEAD20_PARAMS)
    mem, head_mem = in_memory("in-memory 20M headline width", HEAD20_PARAMS)
    d_str, d_mem = bst.digest(), mem.digest()
    log(f"20M headline width: streamed {d_str} in memory {d_mem}")
    if d_str != d_mem:
        raise AssertionError("in-memory 20M headline-width digest != "
                             "streamed digest")
    for k in ("hist_route_float", "hist_compact_float", "route",
              "route_values"):
        if head_mem[k] <= 0:
            raise AssertionError(f"{k} did not launch in memory at the "
                                 f"headline width")
    return {"stream_identity": ident, "stream_scale": scale,
            "inmem_scale": inmem, "stream_20m_headline": head_str,
            "inmem_20m_headline": head_mem}


def ulp_check(what: str, got, oracle) -> float:
    """Worst distance of f32 ``got`` from the f64 ``oracle`` in f32 ulp
    of the oracle; raises past 1."""
    import numpy as np
    ulp = np.spacing(np.abs(oracle).astype(np.float32)).astype(np.float64)
    worst = float(np.max(np.abs(np.asarray(got, np.float64) - oracle) / ulp))
    if not worst <= 1.0:
        raise AssertionError(f"{what}: {worst:.3f} f32 ulp from the f64 "
                             f"host sum")
    return worst


def host_scores(trees, X, K: int = 1):
    """The f64 sequential host sum (tree t into class t % K)."""
    import numpy as np
    X64 = np.asarray(X, np.float64)
    out = np.zeros((X.shape[0], K))
    for i, t in enumerate(trees):
        out[:, i % K] += t.predict_batch(X64)
    return out if K > 1 else out[:, 0]


def serve_phase(lgb, counters, card: str) -> dict:
    """Phase 12: the bench's serving legs through the port on the card.
    -> the training run's kernel launches."""
    import numpy as np
    import torch
    from lightgbm_tpu_torch.models.tree import predict_leaf
    from lightgbm_tpu_torch.serve import (PredictionServer, compile_model,
                                          compile_trees)
    from tools.load_harness import sweep
    F = HEADLINE_FEATURES
    rng = np.random.RandomState(11)
    X = rng.normal(size=(SERVE_TRAIN_ROWS, F)).astype(np.float32)
    y = (X[:, 0] * 2 + X[:, 1] - X[:, 2]
         + rng.normal(scale=1.0, size=SERVE_TRAIN_ROWS) > 0).astype(
             np.float32)
    ds = lgb.Dataset(X, label=y, params={"max_bin": SERVE_PARAMS["max_bin"]})
    bst, _, launches = train_path(lgb, "serve model", counters,
                                  SERVE_PARAMS, ds, SERVE_ITERS)
    del X, ds
    # 63 leaves: every wave has at most 32 slots, so the fused K1 builds
    # every histogram and K2 and K3 have no wave to run
    missing = [k for k in ("hist_route", "route_values") if launches[k] <= 0]
    ran = [k for k in ("route", "hist_compact") if launches[k] != 0]
    if missing or ran:
        raise AssertionError(f"serve model: kernels not launched {missing}, "
                             f"off its plan {ran}")
    models = bst._gbdt.models

    t0 = time.time()
    cm = compile_model(bst)
    compile_s = time.time() - t0
    if cm.device.type != "cuda" or not cm.has_binned:
        raise AssertionError(f"compiled on {cm.device}, binned "
                             f"{cm.has_binned}")
    Xq = rng.normal(size=(SERVE_ROWS, F)).astype(np.float32)
    t0 = time.time()
    bins = cm.bin_rows(Xq)
    bin_s = time.time() - t0
    t0 = time.time()
    cm.warm([SERVE_ROWS])
    cm.warm([SERVE_ROWS], binned=True)
    torch.cuda.synchronize()
    warm_big_s = time.time() - t0

    def rows_per_s(fn):
        out = fn()
        t0 = time.time()
        for _ in range(SERVE_REPS):
            fn()
        return out, SERVE_ROWS * SERVE_REPS / (time.time() - t0)
    raw, raw_rate = rows_per_s(lambda: cm.predict_raw(Xq))
    braw, bin_rate = rows_per_s(lambda: cm.predict_raw(bins, binned=True))
    cold = compile_model(bst)
    _, eager_rate = rows_per_s(lambda: cold.predict_raw(Xq))
    if cm.eager_calls or cm.captures != 2 or not cold.eager_calls:
        raise AssertionError(f"graphs: {cm.captures} captures, "
                             f"{cm.eager_calls} eager calls")
    S = SERVE_SAMPLE
    t0 = time.time()
    host = host_scores(models, Xq[:S])
    host_rate = S / (time.time() - t0)
    if raw.shape != (SERVE_ROWS,) or not np.isfinite(raw).all():
        raise AssertionError("served scores are not finite [n] values")
    if not np.array_equal(raw, braw):
        raise AssertionError("binned scores != raw scores")
    worst = max(ulp_check("serve raw", raw[:S], host),
                ulp_check("serve binned", braw[:S], host))
    leaves = cm.leaf_indices(Xq)
    if not np.array_equal(leaves, cm.leaf_indices(bins, binned=True)):
        raise AssertionError("binned routing != raw routing")
    if not np.array_equal(leaves[:S], predict_leaf(models, Xq[:S])):
        raise AssertionError("device routing != host predict_leaf")
    del leaves, bins, cold
    log(f"serve ({card}): {len(models)} trees depth {cm.pack.max_depth}; "
        f"{SERVE_ROWS} rows: raw {raw_rate:.1f} rows/s, binned "
        f"{bin_rate:.1f} rows/s (graphs), raw eager {eager_rate:.1f} "
        f"rows/s, host anchor {host_rate:.1f} rows/s on {S} rows; compile "
        f"{compile_s:.3f} s, bin_rows {bin_s:.3f} s, warm of the "
        f"{SERVE_ROWS}-row bucket raw + binned {warm_big_s:.3f} s; routing "
        f"bit-exact (all rows raw == binned, {S} == host), worst "
        f"{worst:.3f} ulp")

    # a seeded 3-class forest: categorical, NaN- and zero-missing, stumps
    trees = random_forest(7)
    Xf = forest_rows(trees, SERVE_FOREST_ROWS, 8)
    fm = compile_trees(trees, num_class=3, device="cuda")
    fm.warm([SERVE_FOREST_ROWS])
    got = fm.predict_raw(Xf)
    if not np.array_equal(fm.leaf_indices(Xf), predict_leaf(trees, Xf)):
        raise AssertionError("forest: device routing != host predict_leaf")
    fworst = ulp_check("forest", got, host_scores(trees, Xf, 3))
    log(f"serve forest ({card}): {len(trees)} trees, 3 classes, "
        f"{sum(t.num_cat for t in trees)} categorical nodes, "
        f"{sum(t.num_leaves == 1 for t in trees)} stumps, "
        f"{SERVE_FOREST_ROWS} rows: routing bit-exact, worst {fworst:.3f} "
        f"ulp")

    # the async server: 300 mixed requests, then the open-loop sweep
    t0 = time.time()
    srv = PredictionServer(cm, max_batch=max(SERVE_BUCKETS), max_wait_ms=1.0,
                           buckets=SERVE_BUCKETS, min_bucket=SERVE_BUCKETS[0],
                           raw_score=True)
    warm_s = time.time() - t0
    done = np.zeros(SERVE_REQUESTS, np.int64)
    try:
        futs, spans = [], []
        for i in range(SERVE_REQUESTS):
            off = (37 * i) % (S - 1024)
            k = SERVE_SIZES[i % len(SERVE_SIZES)]
            fu = srv.submit(Xq[off:off + k])
            fu.add_done_callback(lambda f, i=i: done.__setitem__(
                i, done[i] + 1))
            futs.append(fu)
            spans.append((off, k))
        for fu, (off, k) in zip(futs, spans):
            ulp_check("server", np.atleast_1d(fu.result(120)),
                      host[off:off + k])
        st = srv.stats()
        pool = rng.normal(size=(8192, F)).astype(np.float32)
        # a full collection walks this process's whole heap for tens of
        # ms and stalls the generator and the worker alike: frozen, the
        # sweep times the server, not the collector
        gc.collect()
        gc.freeze()
        table = sweep(srv, pool, SERVE_QPS, SERVE_QPS_S, rows_per_request=1,
                      seed=13)
        # the same schedule through a stand-in that resolves at submit:
        # the generator's own tail, in the same interpreter
        alone = sweep(_InstantServer(), pool, SERVE_QPS, SERVE_QPS_S,
                      rows_per_request=1, seed=13)
    finally:
        gc.unfreeze()
        srv.close()
    after = srv.stats()
    if not (done == 1).all() or st["resolved"] != SERVE_REQUESTS \
            or st["failed"] or st["pending"]:
        raise AssertionError(f"server delivery: {st}, resolutions "
                             f"{np.bincount(done)}")
    if after["steady_captures"] or after["steady_eager"]:
        raise AssertionError(f"server left its warmed graphs: {after}")
    if any(r["failures"] for r in table):
        raise AssertionError(f"sweep failures: {table}")
    lat = {b: (v["p50"], v["p99"]) for b, v in st["latency_ms"].items()}
    log(f"serve server ({card}): {SERVE_REQUESTS}/{SERVE_REQUESTS} resolved "
        f"exactly once in {st['batches']} batches, steady_captures "
        f"{after['steady_captures']}, steady_eager {after['steady_eager']}; "
        f"warm of {list(SERVE_BUCKETS)} {warm_s:.3f} s; p50/p99 ms by "
        f"bucket {lat}")
    for r in table:
        log(f"serve sweep ({card}): {json.dumps(r)}")
    for r in alone:
        log(f"serve sweep, generator alone ({card}): {json.dumps(r)}")
    return launches


def cat_nodes(models) -> dict:
    """Left-category counts of every categorical node, by feature."""
    out = {}
    for t in models:
        for node in range(t.num_leaves - 1):
            if t.decision_type[node] & 1:
                ci = int(t.threshold_bin[node])
                words = t.cat_threshold[t.cat_boundaries[ci]:
                                        t.cat_boundaries[ci + 1]]
                out.setdefault(int(t.split_feature[node]), []).append(
                    sum(bin(int(w)).count("1") for w in words))
    return out


def cat_headline_phase(lgb, counters, params, ds_cat, X, y):
    """Phase 13: the headline with columns 1-3 categorical through
    ``lgb.train``: -> ``(booster, launches)``."""
    import numpy as np
    import torch
    from lightgbm_tpu_torch.metric.metrics import binary_auc
    bst, _, launches = train_path(lgb, "categorical headline", counters,
                                  params, ds_cat, HEADLINE_ITERS)
    pred = bst.predict(X)
    torch.cuda.synchronize()
    auc = binary_auc(y, pred)
    nodes = cat_nodes(bst._gbdt.models)
    log(f"categorical headline: train auc {auc:.5f}; categorical nodes "
        f"by feature {{f: (nodes, most categories)}} "
        f"{ {f: (len(c), max(c)) for f, c in sorted(nodes.items())} }; "
        f"digest {bst.digest(include_scores=False)}")
    if pred.shape != (len(X),) or not np.isfinite(pred).all():
        raise AssertionError("predictions are not finite [n] values")
    if not auc >= AUC_GATE:
        raise AssertionError(f"categorical train auc {auc} < {AUC_GATE}")
    missing = [k for k in ("route", "route_values", "hist_route",
                           "hist_compact") if launches[k] <= 0]
    if missing or launches["split_scan"] != 0:
        raise AssertionError(f"categorical headline: kernels not launched "
                             f"{missing}, split kernel "
                             f"{launches['split_scan']} times")
    if not (nodes.get(1) and max(nodes[1]) > 1 and nodes.get(2)
            and set(nodes[2]) == {1}):
        raise AssertionError("no many-vs-many nodes on feature 1 or "
                             "one-vs-rest nodes on feature 2")
    return bst, launches


def cat_headline_float_phase(lgb, counters, params, ds_cat, X, y):
    """Phase 13b: the categorical headline on float values
    (``gpu_use_dp``: hilo), 8 iterations: -> launches."""
    import numpy as np
    import torch
    from lightgbm_tpu_torch.metric.metrics import binary_auc
    bst, _, launches = train_path(
        lgb, "categorical headline float (gpu_use_dp)", counters,
        dict(params, gpu_use_dp=True), ds_cat, FLOAT_ITERS)
    pred = bst.predict(X)
    torch.cuda.synchronize()
    auc = binary_auc(y, pred)
    log(f"categorical headline float: hist_mode {bst._gbdt.hist_mode}, "
        f"train auc {auc:.5f}; "
        f"{sum(t.num_cat for t in bst._gbdt.models)} categorical nodes; "
        f"digest {bst.digest(include_scores=False)}")
    if pred.shape != (len(X),) or not np.isfinite(pred).all():
        raise AssertionError("float predictions are not finite [n] values")
    if not auc >= AUC_GATE:
        raise AssertionError(f"categorical float train auc {auc} < "
                             f"{AUC_GATE}")
    missing = [k for k in ("hist_route_float", "route", "hist_compact_float",
                           "route_values") if launches[k] <= 0]
    ran = [k for k in ("hist_route", "hist_compact", "split_scan")
           if launches[k] != 0]
    if missing or ran:
        raise AssertionError(f"categorical float headline: kernels not "
                             f"launched {missing}, off its plan {ran}")
    return launches


def cat_valid_phase(lgb, counters):
    """Phase 14: the small-data path's configuration on its data with
    columns 1-3 categorical, valid rows holding categories the training
    rows never have: -> launches."""
    import numpy as np
    import torch
    from lightgbm_tpu_torch.metric.metrics import binary_auc
    Xs, ys, Xv, yv = small_data()
    X = categorize(np.concatenate([Xs, Xv]), 3, valid_from=SMALL_ROWS)
    Xs, Xv = X[:SMALL_ROWS], X[SMALL_ROWS:]
    unseen = int(((Xv[:, 1] >= CAT_MANY) | (Xv[:, 3] >= CAT_NOISE)).sum())
    ds = lgb.Dataset(Xs, label=ys, params={"max_bin": TRAIN_CONF["max_bin"]},
                     categorical_feature=CAT_COLUMNS)
    dv = lgb.Dataset(Xv, label=yv, reference=ds)
    evals = {}
    bst, _, launches = train_path(
        lgb, "categorical small-data", counters, TRAIN_CONF, ds,
        SMALL_ITERS, valid_sets=[dv], valid_names=["valid"],
        early_stopping_rounds=SMALL_EARLY_STOP, evals_result=evals,
        verbose_eval=False)
    pred = bst.predict(Xv)
    torch.cuda.synchronize()
    vauc = binary_auc(yv, pred)
    log(f"categorical small-data: valid auc {vauc:.5f} at best_iteration "
        f"{bst.best_iteration} ({unseen} valid rows with an unseen "
        f"category; {sum(t.num_cat for t in bst._gbdt.models)} categorical "
        f"nodes); digest {bst.digest(include_scores=False)}")
    if pred.shape != (SMALL_VALID,) or not np.isfinite(pred).all():
        raise AssertionError("valid predictions are not finite [n] values")
    if not vauc >= VALID_AUC_GATE:
        raise AssertionError(f"categorical valid auc {vauc} < "
                             f"{VALID_AUC_GATE}")
    missing = [k for k in ("hist_route", "route_values") if launches[k] <= 0]
    if missing or launches["split_scan"] != 0 or not unseen:
        raise AssertionError(f"categorical small-data: kernels not "
                             f"launched {missing}, split kernel "
                             f"{launches['split_scan']} times, {unseen} "
                             f"unseen rows")
    return launches


def cat_serve_phase(bst, X) -> None:
    """Phase 15: the categorical headline model compiled on the card,
    20,000 rows raw and binned with unseen, negative and NaN categories:
    routing raw == binned == the host ``predict_leaf``, scores raw ==
    binned and within 1 f32 ulp of the f64 host sum."""
    import numpy as np
    from lightgbm_tpu_torch.models.tree import predict_leaf
    from lightgbm_tpu_torch.serve import compile_model
    rng = np.random.RandomState(13)
    Q = X[:SERVE_SAMPLE].copy()
    odd = rng.rand(SERVE_SAMPLE, 3)
    Q[:, CAT_COLUMNS] = np.where(odd < 0.03, CAT_NOISE + 7, Q[:, CAT_COLUMNS])
    Q[:, CAT_COLUMNS] = np.where((odd >= 0.03) & (odd < 0.05), -1.0,
                                 Q[:, CAT_COLUMNS])
    Q[:, CAT_COLUMNS] = np.where((odd >= 0.05) & (odd < 0.07), np.nan,
                                 Q[:, CAT_COLUMNS])
    models = bst._gbdt.models
    cm = compile_model(bst)
    if cm.device.type != "cuda" or cm.pack.catbin_words is None:
        raise AssertionError("the categorical model did not compile binned "
                             "on the card")
    bins = cm.bin_rows(Q)
    host = predict_leaf(models, Q)
    raw = cm.leaf_indices(Q)
    binned = cm.leaf_indices(bins, binned=True)
    if not (np.array_equal(raw, host) and np.array_equal(binned, host)):
        raise AssertionError(f"categorical routing: raw != host on "
                             f"{int((raw != host).sum())}, binned != host "
                             f"on {int((binned != host).sum())} (row, tree)")
    s_raw = cm.predict_raw(Q)
    s_bin = cm.predict_raw(bins, binned=True)
    if not np.array_equal(s_raw.view(np.int32), s_bin.view(np.int32)):
        raise AssertionError("categorical scores: raw != binned")
    worst = ulp_check("categorical scores", s_raw, host_scores(models, Q))
    log(f"categorical serving: {SERVE_SAMPLE} rows, {len(models)} trees, "
        f"{int((odd < 0.07).sum())} unseen / negative / NaN categories: "
        f"routing raw == binned == host, scores raw == binned, {worst:.3f} "
        f"ulp from the f64 host sum")


def cat_stream_phase(lgb, counters, X, y, tmp: str) -> dict:
    """Phase 16: 262,144 rows of the categorical set written as CSV,
    ingested with ``categorical_column`` and streamed (63 leaves, blocks
    of 131,072 rows, 2 iterations): its digest (scores included) must be
    in-memory training's on ``store.to_binned_dataset``.  -> the
    stream's launches."""
    import numpy as np
    import torch
    from lightgbm_tpu_torch.boosting.gbdt import GBDT
    from lightgbm_tpu_torch.config import Config
    n = CAT_STREAM_ROWS
    t0 = time.time()
    path = os.path.join(tmp, "categorical.csv")
    np.savetxt(path, np.concatenate([y[:n, None], X[:n]], axis=1),
               delimiter=",", fmt="%.9g")
    params = dict(STREAM_PARAMS, categorical_column=",".join(
        str(c + 1) for c in CAT_COLUMNS))
    cfg = Config.from_params(params)
    store = lgb.outofcore.ingest([path], cfg, os.path.join(tmp, "cat_store"))
    prep_s = time.time() - t0
    if [store.mappers[c].bin_type for c in CAT_COLUMNS] != [1, 1, 1]:
        raise AssertionError("the store's columns 1-3 are not categorical")
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    bst = lgb.train_streaming(params, store, num_boost_round=STREAM_ITERS,
                              block_rows=CAT_STREAM_BLOCK, device="cuda")
    torch.cuda.synchronize()
    stream_s = time.time() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    mem = GBDT(cfg, store.to_binned_dataset(cfg), "cuda")
    for _ in range(STREAM_ITERS):
        mem.train_one_iter()
    torch.cuda.synchronize()
    d_str, d_mem = bst.digest(), mem.digest()
    log(f"categorical stream: CSV + ingest {prep_s:.2f} s, {n} x "
        f"{STREAM_ITERS} streamed in {stream_s:.3f} s; launches {launches}; "
        f"{sum(t.num_cat for t in bst.models)} categorical nodes; streamed "
        f"{d_str} in memory {d_mem}")
    if d_str != d_mem:
        raise AssertionError("categorical streamed digest != in-memory")
    if not any(t.num_cat for t in bst.models):
        raise AssertionError("no categorical node in the streamed model")
    missing = [k for k in ("hist_active", "route", "route_values")
               if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched in the categorical "
                             f"stream: {missing}")
    return launches


def relabel_binned(ds, label):
    """A ``BinnedDataset`` over ``ds``'s bins and mappers with other
    labels: the rows are binned once."""
    import copy
    from lightgbm_tpu_torch.io.dataset import Metadata
    out = copy.copy(ds)
    out.metadata = Metadata()
    out.metadata.set_field("label", label)
    return out


def relabel(ds, label):
    """The same for a user ``Dataset``."""
    import copy
    out = copy.copy(ds.construct())
    out.label, out.weight, out.init_score = label, None, None
    out._constructed = relabel_binned(ds._constructed, label)
    return out


def class_labels(z, k: int, cut_rows=None):
    """``k`` classes from the quantiles of the latent (of its first
    ``cut_rows`` rows)."""
    import numpy as np
    q = np.quantile(z[:cut_rows], np.arange(1, k) / k)
    return np.digitize(z, q).astype(np.float32)


def phase_line(name: str, card: str, **fields) -> None:
    """A new phase's result as one JSON line."""
    print(json.dumps({"phase": name, "card": card, **fields}), flush=True)


def multiclass_phase(lgb, counters, ds, X, z, card: str) -> dict:
    """Phase 17: the headline's rows with 5 classes through ``lgb.train``
    (K1, K2 + K3 and K4 on every class tree), served on the card, then
    ``multiclassova``: -> launches by path."""
    import numpy as np
    import torch
    from lightgbm_tpu_torch.serve import compile_model
    y = class_labels(z, MC_CLASSES)
    ds5 = relabel(ds, y)
    params = {"objective": "multiclass", "num_class": MC_CLASSES,
              "num_leaves": 255, "max_bin": 63, "learning_rate": 0.1,
              "min_data_in_leaf": 20, "verbose": -1}
    evals = {}
    bst, seconds, launches = train_path(
        lgb, "multiclass headline", counters, params, ds5, MC_ITERS,
        valid_sets=[ds5], valid_names=["training"], evals_result=evals,
        verbose_eval=False)
    ll = evals["training"]["multi_logloss"]
    limit = MC_LOSS_SHARE * float(np.log(MC_CLASSES))
    log(f"multiclass headline: train multi_logloss {ll}; digest "
        f"{bst.digest(include_scores=False)}")
    if not all(b < a for a, b in zip(ll, ll[1:])) or not ll[-1] <= limit:
        raise AssertionError(f"multi_logloss {ll} does not fall every "
                             f"iteration to <= {limit}")
    missing = [k for k in ("route", "route_values", "hist_route",
                           "hist_compact") if launches[k] <= 0]
    if missing or launches["split_scan"] != 0:
        raise AssertionError(f"multiclass headline: kernels not launched "
                             f"{missing}, split kernel "
                             f"{launches['split_scan']} times")
    trees = bst._gbdt.models
    if len(trees) != MC_CLASSES * MC_ITERS:
        raise AssertionError(f"{len(trees)} trees, not "
                             f"{MC_CLASSES * MC_ITERS}")
    # serving on the card: [n, K] probabilities, routing == host walk
    t0 = time.time()
    cm = compile_model(bst)
    prob = cm.predict(X)
    torch.cuda.synchronize()
    serve_s = time.time() - t0
    Xs = X[:SERVE_SAMPLE]
    leaf = cm.leaf_indices(Xs)
    host_leaf = bst.predict(Xs, pred_leaf=True, device=False)
    raw = cm.predict_raw(Xs)
    ulp = ulp_check("multiclass raw scores", raw,
                    host_scores(trees, Xs, MC_CLASSES))
    gap = float(np.abs(prob.sum(axis=1) - 1.0).max())
    log(f"multiclass serving: {len(X)} rows in {serve_s:.3f} s (compile "
        f"included), probabilities sum to 1 within {gap:.3g}; routing on "
        f"{SERVE_SAMPLE} rows == host: {np.array_equal(leaf, host_leaf)}; "
        f"raw within {ulp:.3f} ulp")
    if prob.shape != (len(X), MC_CLASSES) or not np.isfinite(prob).all():
        raise AssertionError("served probabilities are not finite [n, K]")
    if not gap <= MC_PROB_SUM_TOL:
        raise AssertionError(f"probabilities sum to 1 within {gap}")
    if not np.array_equal(leaf, host_leaf):
        raise AssertionError("multiclass routing differs from the host")
    # one-vs-all on the same rows
    ova = {}
    bst_o, ova_s, ova_launch = train_path(
        lgb, "multiclassova headline", counters,
        dict(params, objective="multiclassova"), ds5, MC_OVA_ITERS,
        valid_sets=[ds5], valid_names=["training"], evals_result=ova,
        verbose_eval=False)
    oll = ova["training"]["multi_logloss"]
    log(f"multiclassova: train multi_logloss {oll}; digest "
        f"{bst_o.digest(include_scores=False)}")
    if not oll[-1] < oll[0] or len(bst_o._gbdt.models) != (
            MC_CLASSES * MC_OVA_ITERS):
        raise AssertionError(f"multiclassova did not learn: {oll}")
    phase_line("17_multiclass_headline", card,
               ms_per_iter=1e3 * seconds / MC_ITERS,
               multi_logloss=ll, digest=bst.digest(include_scores=False),
               serve_rows_per_s=len(X) / serve_s, prob_sum_gap=gap,
               raw_ulp=ulp, ova_ms_per_iter=1e3 * ova_s / MC_OVA_ITERS,
               ova_multi_logloss=oll,
               ova_digest=bst_o.digest(include_scores=False),
               launches=launches, launches_per_tree={
                   k: v / len(trees) for k, v in launches.items()})
    return {"multiclass": launches, "multiclass_ova": ova_launch}


def multiclass_small_phase(lgb, counters, ds_small, dv_small,
                           card: str) -> dict:
    """Phase 18: upstream's multiclass ``train.conf`` on the small-data
    rows (5 classes; K6 runs for every class tree): -> launches."""
    import numpy as np
    _, z = small_latent()
    y = class_labels(z, MC_CLASSES, cut_rows=SMALL_ROWS)
    ds = relabel(ds_small, y[:SMALL_ROWS])
    dv = relabel(dv_small, y[SMALL_ROWS:])
    evals = {}
    bst, seconds, launches = train_path(
        lgb, "multiclass small-data", counters, MC_TRAIN_CONF, ds,
        SMALL_ITERS, valid_sets=[dv], valid_names=["valid"],
        early_stopping_rounds=SMALL_EARLY_STOP, evals_result=evals,
        verbose_eval=False)
    best = bst.best_iteration
    vll = evals["valid"]["multi_logloss"][best - 1]
    verr = evals["valid"]["multi_error"][best - 1]
    limit = MC_LOSS_SHARE * float(np.log(MC_CLASSES))
    trees = len(bst._gbdt.models)
    log(f"multiclass small-data: {bst.current_iteration()} iterations, "
        f"best {best}: valid multi_logloss {vll:.5f}, multi_error "
        f"{verr:.5f}; digest {bst.digest(include_scores=False)}")
    if not vll <= limit:
        raise AssertionError(f"valid multi_logloss {vll} > {limit}")
    missing = [k for k in ("split_scan", "hist_route", "route_values")
               if launches[k] <= 0]
    if missing:
        raise AssertionError(f"multiclass small-data: kernels not launched "
                             f"{missing}")
    phase_line("18_multiclass_small_data", card,
               ms_per_iter=1e3 * seconds / bst.current_iteration(),
               iterations=bst.current_iteration(), best_iteration=best,
               valid_multi_logloss=vll, valid_multi_error=verr,
               digest=bst.digest(include_scores=False), launches=launches,
               launches_per_tree={k: v / trees for k, v in launches.items()})
    return launches


def rank_data():
    """The bench's MS LTR-shaped ranking set (bench.py ranking_leg):
    ``(X, relevance, query sizes)``."""
    import numpy as np
    rng = np.random.RandomState(7)
    sizes = np.clip(np.round(rng.lognormal(mean=4.55, sigma=0.7,
                                           size=RANK_QUERIES)),
                    1, 1251).astype(np.int64)
    n = int(sizes.sum())
    X = rng.normal(size=(n, RANK_FEATURES)).astype(np.float32)
    raw = X[:, 0] + 0.6 * X[:, 1] - 0.4 * X[:, 2] \
        + rng.normal(scale=0.8, size=n)
    rel = np.digitize(raw, np.quantile(raw, [0.55, 0.78, 0.92, 0.98])
                      ).astype(np.float32)
    return X, rel, sizes


def rank_kernel_phase(ds, entries) -> None:
    """The ranking path's kernels on its data (136 columns at a 256-bin
    stride, which ``hist_plan`` tiles into one column a block from 32
    slots on) with the first iteration's int8h lambdarank values: K1 at
    8, 16 and 32 slots, K2 + K3 at 64 and 128, and K2 and K4 on one
    128-slot wave, each bitwise against its plain version (added to
    their entries under ``rank``).  The exact-zero hessians are counted:
    only a query whose labels are all equal has them, and this data's
    queries (about 120 documents, relevance 0-4) have none, so
    ``tests/test_torch_cuda.py::test_ranking_shape_kernels_bitwise``
    holds the kernels to half-zero hessians at this width."""
    import torch
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.io.device import to_device
    from lightgbm_tpu_torch.objective.objectives import create_objective
    from lightgbm_tpu_torch.ops import cuda_build
    from lightgbm_tpu_torch.ops.histogram import bin_stride, pack_values_q
    t0 = time.time()
    dd = to_device(ds._constructed, "cuda")
    n = dd.num_data
    obj = create_objective(Config.from_params(RANK_PARAMS))
    obj.init(ds._constructed.metadata, n, "cuda")
    g, h = obj.get_gradients_k(torch.zeros((n, 1), device="cuda"))
    vals, _ = pack_values_q(g[:, 0], h[:, 0], "int8h", dd.n_pad)
    zero_h = int((h == 0).sum())
    G = dd.bins_t.shape[0]
    B = bin_stride(dd.group_max_bins)
    del obj, g, h
    if G != RANK_FEATURES or B != 256:
        raise AssertionError(f"rank kernels: {G} columns, stride {B}")
    int_rate = int32_ops_per_s(cuda_build.multiprocessor_count(dd.device))
    gen = torch.Generator(device=dd.device)
    gen.manual_seed(19)
    L = RANK_PARAMS["num_leaves"]
    leaf2, tabs, cat, _ = wave_inputs(dd, 127, 64, 128, gen, L)
    lv = torch.randn(L, generator=gen, device=dd.device)
    shape = dict(rows=n, columns=G, bins=B, zero_hessians=zero_h)
    rank = {"route": dict(shape, **k2_measure(dd, leaf2, tabs, cat,
                                              int_rate)),
            "route_values": dict(shape, **k4_measure(dd, leaf2, tabs, cat,
                                                     lv, int_rate)),
            "hist_route": dict(shape, by_width=[
                k1_measure(dd, vals, A, A // 2, gen, L, int_rate)
                for A in (8, 16, 32)]),
            "hist_compact": dict(shape, by_width=[
                k3_measure(dd, vals, A, gen, L, int_rate)
                for A in (64, 128)])}
    for e in entries:
        if e["name"] in rank:
            e["rank"] = rank[e["name"]]
    del dd, vals
    torch.cuda.synchronize()
    log(f"rank kernels at {G} columns x {B} bins, {n} rows ({zero_h} zero "
        f"hessians): bitwise ok, {time.time() - t0:.1f} s")


def rank_phase(lgb, counters, card: str, entries) -> dict:
    """Phase 19: lambdarank at the bench's MS LTR shape through
    ``lgb.train``, each iteration's gradient time (the torch lambdarank
    operations, synchronized around) beside the rest of it: ->
    launches."""
    import numpy as np
    import torch
    from lightgbm_tpu_torch.metric.metrics import NDCGMetric
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.objective.objectives import LambdarankNDCG
    t0 = time.time()
    X, rel, sizes = rank_data()
    gen_s = time.time() - t0
    t0 = time.time()
    ds = lgb.Dataset(X, label=rel, group=sizes,
                     params={"max_bin": RANK_PARAMS["max_bin"]}).construct()
    bin_s = time.time() - t0
    del X
    log(f"rank: {len(sizes)} queries, {len(rel)} docs x {RANK_FEATURES}; "
        f"data {gen_s:.1f} s, binning {bin_s:.1f} s")
    rank_kernel_phase(ds, entries)
    grad_ms, ends = [], []
    plain = LambdarankNDCG.get_gradients

    def timed(self, score):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = plain(self, score)
        torch.cuda.synchronize()
        grad_ms.append(1e3 * (time.perf_counter() - t))
        return out

    def mark(env):
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
    LambdarankNDCG.get_gradients = timed
    try:
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        start = time.perf_counter()
        bst = lgb.train(dict(RANK_PARAMS), ds, num_boost_round=RANK_ITERS,
                        device="cuda", callbacks=[mark], verbose_eval=False)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        launches = {k: fn.launches for k, fn in counters.items()}
    finally:
        LambdarankNDCG.get_gradients = plain
    iter_ms = [1e3 * (b - a) for a, b in zip([start] + ends[:-1], ends)]
    g = bst._gbdt
    qb = np.concatenate([[0], np.cumsum(sizes)])
    scores = g.scores[:, 0].cpu().numpy()
    (_, ndcg10, _), = NDCGMetric(Config.from_params(RANK_PARAMS)).eval(
        rel, scores, None, qb)
    share = sum(grad_ms) / max(1e-9, sum(iter_ms))
    # the first iteration also uploads the rows and builds the buckets
    steady = sum(grad_ms[1:]) / max(1e-9, sum(iter_ms[1:]))
    log(f"rank: {RANK_ITERS} iterations in {seconds:.3f} s (setup "
        f"included); per iteration ms {[round(x, 2) for x in iter_ms]}, "
        f"of which gradients {[round(x, 2) for x in grad_ms]} (share "
        f"{share:.3f}, after the first iteration {steady:.3f}); train "
        f"NDCG@10 {ndcg10:.5f}; launches {launches}; digest "
        f"{g.digest(include_scores=False)}")
    if not np.isfinite(scores).all():
        raise AssertionError("ranking scores are not finite")
    if not ndcg10 >= RANK_NDCG_GATE:
        raise AssertionError(f"train NDCG@10 {ndcg10} < {RANK_NDCG_GATE}")
    missing = [k for k in ("route", "route_values", "hist_route",
                           "hist_compact") if launches[k] <= 0]
    if missing or launches["split_scan"] != 0:
        raise AssertionError(f"rank: kernels not launched {missing}, split "
                             f"kernel {launches['split_scan']} times")
    phase_line("19_rank_mslr_shape", card, docs=len(rel),
               queries=len(sizes), features=RANK_FEATURES,
               binning_s=bin_s, seconds=seconds, iter_ms=iter_ms,
               grad_ms=grad_ms, grad_share=share, grad_share_steady=steady,
               ndcg10=float(ndcg10),
               digest=g.digest(include_scores=False), launches=launches,
               launches_per_tree={k: v / RANK_ITERS
                                  for k, v in launches.items()})
    return launches


def host_percentile(values, row_leaf, num_leaves: int, alpha: float):
    """Per-leaf percentile of f32 ``values`` on the host, in numpy f32
    arithmetic: sorted within the leaf, read at ``alpha * (count - 1)``
    with linear interpolation (the reference's PercentileFun)."""
    import numpy as np
    order = np.lexsort((values, row_leaf))
    sv, sl = values[order], row_leaf[order]
    lid = np.arange(num_leaves)
    start = np.searchsorted(sl, lid, side="left")
    cnt = np.searchsorted(sl, lid, side="right") - start
    pos = np.float32(alpha) * (cnt - 1).astype(np.float32)
    lo, hi = np.floor(pos).astype(np.int64), np.ceil(pos).astype(np.int64)
    frac = pos - lo.astype(np.float32)
    n = len(sv)
    vlo = sv[np.clip(start + lo, 0, n - 1)]
    vhi = sv[np.clip(start + hi, 0, n - 1)]
    out = vlo * (np.float32(1) - frac) + vhi * frac
    return np.where(cnt > 0, out, np.float32(0))


def regression_phase(lgb, counters, ds, z, card: str) -> dict:
    """Phase 20: every regression-family objective on the headline's
    rows (binned once), 2 iterations each; the renewed leaves of L1 and
    quantile held to a host percentile of the residuals: -> launches by
    objective."""
    import numpy as np
    import torch
    from lightgbm_tpu_torch.objective import objectives as objs
    labels = {"z": z, "exp": np.exp(z / 2), "exp8": np.exp(z / 8),
              "sigmoid": 1 / (1 + np.exp(-z)), "abs": np.abs(z)}
    out, lines = {}, {}
    for name, kind, extra in REG_FAMILY:
        key = name + ("_sqrt" if extra.get("reg_sqrt") else "")
        y = labels[kind].astype(np.float32)
        dsr = relabel(ds, y)
        params = {"objective": name, "num_leaves": 255, "max_bin": 63,
                  "learning_rate": 0.1, "min_data_in_leaf": 20,
                  "verbose": -1, **extra}
        renewals = []
        cls = objs.OBJECTIVES[name]
        plain = cls.renew_tree_output

        def record(self, score, row_leaf, L, plain=plain):
            res = plain(self, score, row_leaf, L)
            renewals.append(tuple(t.cpu().numpy().copy() for t in (
                score, row_leaf, res, self.label)))
            return res
        checked = name in ("regression_l1", "quantile")
        if checked:
            cls.renew_tree_output = record
        evals = {}
        try:
            bst, seconds, launches = train_path(
                lgb, f"regression family: {key}", counters, params, dsr,
                REG_ITERS, valid_sets=[dsr], valid_names=["training"],
                evals_result=evals, verbose_eval=False)
        finally:
            if checked:
                cls.renew_tree_output = plain
        (metric, vals), = evals["training"].items()
        log(f"{key}: train {metric} {vals}; digest "
            f"{bst.digest(include_scores=False)}")
        if len(vals) != REG_ITERS or not vals[1] < vals[0]:
            raise AssertionError(f"{key}: {metric} {vals} did not fall")
        if launches["route_values"] <= 0 or launches["hist_route"] <= 0:
            raise AssertionError(f"{key}: kernels not launched {launches}")
        worst = None
        if checked:
            alpha = 0.5 if name == "regression_l1" else extra["alpha"]
            worst = 0
            for score, row_leaf, res, label in renewals:
                want = host_percentile(label - score, row_leaf, len(res),
                                       alpha)
                worst = max(worst, int((want != res).sum()))
            log(f"{key}: {len(renewals)} renewed trees, leaves differing "
                f"from the host percentile: {worst}")
            if len(renewals) != REG_ITERS or worst:
                raise AssertionError(f"{key}: renewed leaves differ from the "
                                     f"host percentile ({worst})")
        out[f"reg_{key}"] = launches
        lines[key] = {"metric": metric, "values": vals,
                      "ms_per_iter": 1e3 * seconds / REG_ITERS,
                      "digest": bst.digest(include_scores=False),
                      "renewal_mismatches": worst}
        del bst, dsr
        torch.cuda.synchronize()
    phase_line("20_regression_family", card, objectives=lines)
    return out


def multiclass_stream_phase(lgb, counters, tmp: str, card: str) -> dict:
    """Phase 21: the identity store's generator at 2,097,152 rows (two
    1,048,576-row blocks), labels of 3 classes and a continuous one from
    its first two columns; ``multiclass`` then ``huber`` streamed and in
    memory, 2 iterations each: equal digests, scores included: ->
    launches by path."""
    import numpy as np
    import torch
    from lightgbm_tpu_torch.boosting.gbdt import GBDT
    from lightgbm_tpu_torch.boosting.streaming import StreamTrainer
    from lightgbm_tpu_torch.config import Config
    cfg = Config.from_params(STREAM_PARAMS)
    store = lgb.outofcore.ingest_synthetic(
        os.path.join(tmp, "mc"), MC_STREAM_ROWS, STREAM_FEATURES, cfg,
        seed=4, shard_rows=MC_STREAM_ROWS)
    base = store.to_binned_dataset(cfg)
    b = base.bins
    latent = (b[:, 0].astype(np.float32) + 0.5 * b[:, 1]
              + np.random.RandomState(5).normal(size=len(b)).astype(
                  np.float32) * 4)
    out, lines = {}, {}
    for name, label in (("multiclass", class_labels(latent,
                                                    MC_STREAM_CLASSES)),
                        ("huber", latent / 16)):
        params = dict(STREAM_PARAMS, objective=name)
        if name == "multiclass":
            params["num_class"] = MC_STREAM_CLASSES
        c = Config.from_params(params)
        res = relabel_binned(base, label)
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.time()
        st = StreamTrainer(c, res, block_rows=STREAM_BLOCK,
                           device="cuda").train(STREAM_ITERS)
        torch.cuda.synchronize()
        wall = time.time() - t0
        streamed = {k: fn.launches for k, fn in counters.items()}
        for fn in counters.values():
            fn.launches = 0
        mem = GBDT(c, res, "cuda")
        for _ in range(STREAM_ITERS):
            mem.train_one_iter()
        torch.cuda.synchronize()
        inmem = {k: fn.launches for k, fn in counters.items()}
        d_str, d_mem = st.digest(), mem.digest()
        log(f"stream {name}: {MC_STREAM_ROWS} rows x {STREAM_ITERS} "
            f"iterations in {wall:.3f} s, {len(st.models)} trees; streamed "
            f"{d_str} in memory {d_mem}; launches streamed {streamed}, in "
            f"memory {inmem}")
        if d_str != d_mem:
            raise AssertionError(f"stream {name}: streamed digest != in "
                                 f"memory")
        if len(st.models) != STREAM_ITERS * mem.num_tree_per_iteration:
            raise AssertionError(f"stream {name}: {len(st.models)} trees")
        for k in ("hist_active", "route", "route_values"):
            if streamed[k] <= 0:
                raise AssertionError(f"stream {name}: {k} did not launch")
        out[f"stream_{name}"] = streamed
        out[f"inmem_{name}"] = inmem
        lines[name] = {"seconds": wall, "digest": d_str,
                       "trees": len(st.models), "launches": streamed}
        del st, mem
    phase_line("21_streams", card, rows=MC_STREAM_ROWS, streams=lines)
    return out



class _InstantServer:
    """Resolves each request as it is submitted: a sweep through it
    times the load generator alone."""

    def submit(self, X):
        from concurrent.futures import Future
        fu = Future()
        fu.set_result(X[:, 0])
        return fu


def train_path(lgb, name, counters, params, ds, rounds, **kw):
    """One user-facing ``lgb.train`` with every launch counter reset just
    before and read just after: -> ``(booster, seconds, launches)``."""
    import torch
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    bst = lgb.train(dict(params), ds, num_boost_round=rounds, device="cuda",
                    **kw)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    log(f"{name}: {bst.current_iteration()} iterations in {seconds:.3f} s "
        f"= {1e3 * seconds / max(1, bst.current_iteration()):.2f} ms/iter "
        f"(setup included); launches {launches}")
    return bst, seconds, launches


def _widest(entry: dict, by_width: list) -> dict:
    """One kernel's entry: the numbers of its widest wave, plus every
    measured wave width under ``by_width``."""
    entry.update({k: v for k, v in by_width[-1].items() if k != "slots"})
    entry["by_width"] = by_width
    return entry


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.io.device import to_device
    from lightgbm_tpu_torch.metric.metrics import binary_auc
    from lightgbm_tpu_torch.ops import cuda_build
    from lightgbm_tpu_torch.ops.compact import (hist_compact_float_raw,
                                                hist_compact_raw)
    from lightgbm_tpu_torch.ops.histogram import (hist_active_float_raw,
                                                  hist_active_raw,
                                                  hist_route_float_raw,
                                                  hist_route_raw,
                                                  pack_values_q)
    from lightgbm_tpu_torch.ops.route import (route_rows_raw,
                                              route_rows_values_raw)
    from lightgbm_tpu_torch.ops.split_kernel import find_best_splits_kernel
    card = card_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; {card}")

    # 1. build
    floor_dir = tempfile.mkdtemp(prefix="lgbm_launch_floor_")
    try:
        floor_build = start_launch_floor_build(floor_dir)
        build_s = cuda_build.build_all()
        load_launch_floor(*floor_build)
    finally:
        shutil.rmtree(floor_dir, ignore_errors=True)
    log(f"build_s {build_s:.2f}")
    torch.cuda.synchronize()

    # 2. kernels at the headline shapes
    t0 = time.time()
    X, z = headline_latent()
    y = (z > 0).astype(np.float32)
    ds = lgb.Dataset(X, label=y, params={"max_bin": 63}).construct()
    log(f"headline data + binning {time.time() - t0:.1f} s")
    dd = to_device(ds._constructed, "cuda")
    g = torch.randn(dd.num_data, device="cuda") * 0.5
    h = torch.rand(dd.num_data, device="cuda") * 0.25
    vals, _ = pack_values_q(g, h, "int8h", dd.n_pad)
    entries = []
    kernel_phase(dd, vals, entries)
    torch.cuda.synchronize()
    float_kernel_phase(dd, entries)

    # 2c. the categorical branch at the headline shapes, on the
    # categorical headline data (the labels drawn first)
    t0 = time.time()
    Xc = categorize(X.copy(), 1)
    ds_cat = lgb.Dataset(Xc, label=y, params={"max_bin": 63},
                         categorical_feature=CAT_COLUMNS).construct()
    log(f"categorical headline data + binning {time.time() - t0:.1f} s")
    ddc = to_device(ds_cat._constructed, "cuda")
    t0 = time.time()
    cat_kernel_phase(ddc, vals, int32_ops_per_s(
        cuda_build.multiprocessor_count(ddc.device)), entries)
    torch.cuda.synchronize()
    log(f"categorical kernel phase {time.time() - t0:.1f} s")
    del ddc

    # 3. kernels at the small-data path's shapes
    t0 = time.time()
    Xs, ys, Xv, yv = small_data()
    ds_small = lgb.Dataset(Xs, label=ys,
                           params={"max_bin": TRAIN_CONF["max_bin"]})
    dv_small = lgb.Dataset(Xv, label=yv, reference=ds_small)
    ds_small.construct()
    dv_small.construct()
    log(f"small-data data + binning {time.time() - t0:.1f} s")
    dds = to_device(ds_small._constructed, "cuda")
    gs = torch.randn(dds.num_data, device="cuda") * 0.5
    hs = torch.rand(dds.num_data, device="cuda") * 0.25
    vals_s, _ = pack_values_q(gs, hs, "int8h", dds.n_pad)
    small_kernel_phase(dds, vals_s, int32_ops_per_s(
        cuda_build.multiprocessor_count(dds.device)), entries)
    torch.cuda.synchronize()

    # 3c. the categorical branch at the small-data path's shapes, and on
    # a bundled categorical column
    t0 = time.time()
    Xsc = categorize(Xs.copy(), 3)
    dsc = lgb.Dataset(Xsc, label=ys, params={"max_bin": TRAIN_CONF["max_bin"]},
                      categorical_feature=CAT_COLUMNS).construct()
    dsb, _ = bundled_cat_data(Xsc, ys)
    ddsc = to_device(dsc._constructed, "cuda")
    ddsb = to_device(dsb._constructed, "cuda")
    vals_b, _ = pack_values_q(gs, hs, "int8h", ddsb.n_pad)
    small_cat_kernel_phase(ddsc, ddsb, vals_s, vals_b, int32_ops_per_s(
        cuda_build.multiprocessor_count(dds.device)), entries)
    torch.cuda.synchronize()
    log(f"small categorical kernel phase {time.time() - t0:.1f} s")
    del ddsc, ddsb, dsc, dsb

    counters = {"route": route_rows_raw, "route_values": route_rows_values_raw,
                "hist_route": hist_route_raw, "hist_compact": hist_compact_raw,
                "split_scan": find_best_splits_kernel,
                "hist_active": hist_active_raw,
                "hist_float": hist_active_float_raw,
                "hist_route_float": hist_route_float_raw,
                "hist_compact_float": hist_compact_float_raw}

    # 4. the headline path through the user entry points
    params = {"objective": "binary", "num_leaves": 255, "max_bin": 63,
              "learning_rate": 0.1, "min_data_in_leaf": 20, "verbose": -1}
    bst, _, head = train_path(lgb, "headline", counters, params, ds,
                              HEADLINE_ITERS)
    pred = bst.predict(X)
    torch.cuda.synchronize()
    auc = binary_auc(y, pred)
    log(f"headline: train auc {auc:.5f}; digest "
        f"{bst.digest(include_scores=False)}")
    if pred.shape != (HEADLINE_ROWS,) or not np.isfinite(pred).all():
        raise AssertionError("predictions are not finite [n] values")
    if not auc >= AUC_GATE:
        raise AssertionError(f"train auc {auc} < {AUC_GATE}")
    missing = [k for k in ("route", "route_values", "hist_route",
                           "hist_compact") if head[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the headline path: "
                             f"{missing}")
    if head["split_scan"] != 0:
        raise AssertionError("the split kernel ran above 65,536 rows")

    # 5. the small-data path: train.conf with a valid set and early stop
    evals = {}
    bst, _, small = train_path(
        lgb, "small-data", counters, TRAIN_CONF, ds_small, SMALL_ITERS,
        valid_sets=[dv_small], valid_names=["valid"],
        early_stopping_rounds=SMALL_EARLY_STOP, evals_result=evals,
        verbose_eval=False)
    pred = bst.predict(Xv)
    torch.cuda.synchronize()
    vauc = binary_auc(yv, pred)
    log(f"small-data: valid auc {vauc:.5f} at best_iteration "
        f"{bst.best_iteration}; last recorded valid auc "
        f"{evals['valid']['auc'][-1]:.5f}, train auc "
        f"{evals['training']['auc'][-1]:.5f}; digest "
        f"{bst.digest(include_scores=False)}")
    if pred.shape != (SMALL_VALID,) or not np.isfinite(pred).all():
        raise AssertionError("valid predictions are not finite [n] values")
    if not vauc >= VALID_AUC_GATE:
        raise AssertionError(f"valid auc {vauc} < {VALID_AUC_GATE}")
    missing = [k for k in ("split_scan", "hist_route", "route_values")
               if small[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the small-data "
                             f"path: {missing}")

    # 6. the headline through lgb.train on float values: gpu_use_dp
    # selects hilo
    fparams = dict(params, gpu_use_dp=True)
    bst, _, hfloat = train_path(lgb, "headline float (gpu_use_dp)", counters,
                                fparams, ds, FLOAT_ITERS)
    pred = bst.predict(X)
    torch.cuda.synchronize()
    auc = binary_auc(y, pred)
    log(f"headline float: hist_mode {bst._gbdt.hist_mode}, train auc "
        f"{auc:.5f}; digest {bst.digest(include_scores=False)}")
    if bst._gbdt.hist_mode != "hilo":
        raise AssertionError("gpu_use_dp did not select hilo")
    if pred.shape != (HEADLINE_ROWS,) or not np.isfinite(pred).all():
        raise AssertionError("float predictions are not finite [n] values")
    if not auc >= AUC_GATE:
        raise AssertionError(f"float train auc {auc} < {AUC_GATE}")
    missing = [k for k in ("hist_route_float", "route", "hist_compact_float",
                           "route_values") if hfloat[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the float headline "
                             f"path: {missing}")
    ran = [k for k in ("hist_route", "hist_compact", "hist_active")
           if hfloat[k] != 0]
    if ran:
        raise AssertionError(f"int8 kernels ran on the float path: {ran}")
    del bst

    # 7.-11. the streamed out-of-core path
    int_rate = int32_ops_per_s(cuda_build.multiprocessor_count(dd.device))
    k3 = stream_kernel_phase(int_rate, entries)
    for e in entries:
        if e["name"] == "hist_compact":
            e["stream_seeded"] = k3
    torch.cuda.synchronize()
    tmp = tempfile.mkdtemp(prefix="lgbm_stream_")
    try:
        by_path = {"headline": head, "small_data": small,
                   "headline_float": hfloat,
                   **stream_paths(lgb, counters, tmp)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # 12. serving
    by_path["serve"] = serve_phase(lgb, counters, card)

    # 13.-16. categorical features: the headline, a valid set, serving
    # and a stream
    t0 = time.time()
    bst, by_path["cat_headline"] = cat_headline_phase(lgb, counters, params,
                                                      ds_cat, Xc, y)
    by_path["cat_headline_float"] = cat_headline_float_phase(
        lgb, counters, params, ds_cat, Xc, y)
    log(f"phase 13 {time.time() - t0:.1f} s")
    t0 = time.time()
    by_path["cat_small_data"] = cat_valid_phase(lgb, counters)
    log(f"phase 14 {time.time() - t0:.1f} s")
    t0 = time.time()
    cat_serve_phase(bst, Xc)
    log(f"phase 15 {time.time() - t0:.1f} s")
    del bst, ds_cat
    t0 = time.time()
    tmp = tempfile.mkdtemp(prefix="lgbm_cat_stream_")
    try:
        by_path["cat_stream"] = cat_stream_phase(lgb, counters, Xc, y, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"phase 16 {time.time() - t0:.1f} s")

    # 17.-21. multiclass, ranking, the regression family, K-tree streams
    t0 = time.time()
    by_path.update(multiclass_phase(lgb, counters, ds, X, z, card))
    log(f"phase 17 {time.time() - t0:.1f} s")
    t0 = time.time()
    by_path["multiclass_small"] = multiclass_small_phase(
        lgb, counters, ds_small, dv_small, card)
    log(f"phase 18 {time.time() - t0:.1f} s")
    t0 = time.time()
    by_path["rank"] = rank_phase(lgb, counters, card, entries)
    log(f"phase 19 {time.time() - t0:.1f} s")
    t0 = time.time()
    by_path.update(regression_phase(lgb, counters, ds, z, card))
    log(f"phase 20 {time.time() - t0:.1f} s")
    t0 = time.time()
    tmp = tempfile.mkdtemp(prefix="lgbm_mc_stream_")
    try:
        by_path.update(multiclass_stream_phase(lgb, counters, tmp, card))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"phase 21 {time.time() - t0:.1f} s")

    for e in entries:
        # a categorical entry counts its kernel's launches on the
        # categorical paths only
        key = e.get("counter", e["name"])
        e["launches_by_path"] = {p: c[key] for p, c in by_path.items()
                                 if "counter" not in e
                                 or p.startswith("cat_")}
        e["launches"] = sum(e["launches_by_path"].values())
    print(json.dumps({"kernels": entries}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
