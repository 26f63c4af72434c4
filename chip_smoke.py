#!/usr/bin/env python3
"""Smoke run of lightgbm_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each ends in ``torch.cuda.synchronize()``; any failure raises
and the script exits non-zero):

1. build — compile the CUDA kernels from ``lightgbm_tpu_torch/csrc``
   (one ``nvcc`` per source, in parallel) into
   ``lightgbm_tpu_torch/_build/``, and beside them the empty kernel of
   the launch floor (``tools/launch_floor.cu``) and the route's gather
   floor (``tools/gather_floor.cu``) into a temporary directory;
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
   100,000 of those rows scored alone, inside the 1,048,576-row batch
   (raw and binned), through each server bucket (256, 1024, 4096) and
   through ``predict_raw_early_stop`` with a margin no row reaches are
   bitwise alike and == the host walk's f64 sum rounded once (ROADMAP
   C35);
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
16. categorical stream — 131,072 rows of the categorical headline data
   written as CSV into a temporary directory, ingested with
   ``categorical_column`` and streamed (63 leaves, blocks of 65,536
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
   0.05, ``max_bin`` 255, early stopping 10, at most 50 rounds, cut
   from 100) on the small-data rows with 5-class labels: the split
   kernel on every class tree, valid ``multi_logloss`` at
   ``best_iteration`` at most 85% of ln 5;
19. ranking — the bench's MS LTR-shaped set (``bench.py ranking_leg``:
   its 19,000 queries of log-normal sizes cut to 4,750, about 562,000
   docs x 136 features,
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
   and K4 in the stream;
22. model surface — phase 4's headline with ``snapshot_freq`` 8 and
   ``snapshot_keep`` 2 into a temporary ``output_model`` prefix, killed
   by the ``snapshot.write`` fault point while writing its iteration-24
   snapshot (the latest valid one must be iteration 16) and resumed
   with ``lgb.train(..., resume_from=prefix)``: its model text and
   digest (scores included) must be phase 4's, K1-K4 launched on the
   resumed run; phase 5's small-data run with ``snapshot_freq`` 10,
   killed in its iteration-40 snapshot and resumed from 30: the same
   stop and best iteration and digest as phase 5; on the resumed
   headline Booster ``rollback_one_iter`` (31 trees; the training
   scores within the f32 summation bound, ``F32_UNIT_ROUNDOFF``, of
   the host f64 walk on 100,000 rows), ``add_valid`` of 200,000 fresh
   headline rows (seed 1; the 31 trees replayed on the card, within the
   same bound of the compiled predictor, valid AUC >= 0.93) and one
   ``update`` (``predict`` within 1 f32 ulp of the host walk of the new
   32 trees: no stale compiled pack); ``refit`` on 200,000 rows of seed
   2 (the card's leaves == the host ``predict_leaf`` on 100,000 rows,
   every leaf value bitwise a numpy refit from those leaves and the
   card's own gradients; a leaf whose rows all have a zero hessian, a
   saturated f32 sigmoid, fits 0/0 and is set to 0, as in both
   packages); prediction early stopping every 4 iterations
   at margin 4.0 on the 200,000 fresh rows (rounds taken == the host
   early-stop walk's and scores within 1 f32 ulp of its f64 sums on
   100,000 rows, some rows stopped, their sign the full prediction's on
   >= 99% of them; rows/s beside the full compiled prediction);
   ``save_model`` then ``Booster(model_file=)`` on the card (the same
   text but for ``feature_infos``, which a loaded model writes as
   ``none``, and bitwise the same predictions) and a pickle round trip
   (the same text).  The ms of each snapshot write, of the resume, the
   rollback, ``add_valid``, refit and model IO are logged.

23. entry surface — ``LGBMClassifier`` on phase 4's rows with its
   parameters (255 leaves, ``max_bin`` 63, lr 0.1, 32 estimators; every
   default the estimator maps is ``train``'s too) on the card: digest
   (scores included) == phase 4's, ``predict_proba[:, 1]`` == phase 4's
   ``Booster.predict`` bitwise, K1-K4 launched and K6 not; an L2
   ``fobj`` (``score - label``, ones) on the headline's latent against
   the built-in ``regression``, both without ``boost_from_average``, 8
   iterations: equal digests (scores included), ms/iter of each; a numpy
   AUC ``feval`` beside the built-in ``auc`` on phase 5's run for phase
   5's iterations: within ``FEVAL_AUC_TOL`` at every iteration, the model
   phase 5's; phase 4's configuration for 16 iterations, then
   ``init_model=`` its text for 16 more: the first 16 trees are the
   16-tree model's, the raw prediction the sum of the two parts' within
   ``CONTINUE_TOL``, the digest printed (it differs from phase 4's: the
   JAX package's continued training counts ``boost_from_average``
   twice, ROADMAP C23); phase 5's run with ``learning_rates=[0.1] *
   100``: phase 5's stop, best iteration and digest, then a decaying
   schedule (its stop and valid AUC); ``cv`` with phase 5's
   configuration, 3 stratified folds, seed 0, early stopping 10 (K6 on
   every fold): every iteration's mean == the mean of three ``lgb.train``
   runs on the same folds, bitwise; phase 5's rows written as CSV (a
   header, ``label_column=name:target``, a ``.weight`` side file) and as
   libsvm, with their valid rows: ``lgb.Dataset(path)`` trains the
   weighted array model and phase 5's model; the native parser
   (required) parses a 262,144-row x 28 CSV (MB/s, rows/s).
24. boosting variants — on phase 4's rows and configuration: GOSS
   (``top_rate`` 0.2, ``other_rate`` 0.1) 32 iterations; DART
   (``drop_rate`` 0.1, ``max_drop`` 50, ``skip_drop`` 0.5, LightGBM's
   defaults) 32 iterations, then the same with ``snapshot_freq`` 8
   killed in its iteration-16 snapshot and resumed from 8 to 32: the
   model text byte-identical to the uninterrupted run's, digest (scores
   included) too; DART in ``xgboost_dart_mode`` 8 iterations; a random
   forest (``bagging_freq`` 1, ``bagging_fraction`` 0.8) 32 iterations.
   Each: K1-K4 launched and K6 not, digest, train AUC >= 0.93 (the
   forest's averaged prediction), steady ms/iter (the host clock between
   iterations after the first, synchronized), launches per tree, and its
   prediction through the compiled model on the card (the forest's
   ``average_output`` division included) within ``VARIANT_PRED_TOL`` of
   the host walk on 20,000 rows; DART's per-iteration replay of the
   dropped trees and host-tree conversion are timed.  Then GOSS on phase
   5's configuration with its valid set and early stopping: K6 launched,
   valid AUC >= 0.90 at ``best_iteration``;
25. wide bins and deep trees — phase 4's rows binned at ``max_bin``
   1023 (int32 bins, more than 256 bins a column): the exact-f32 wide
   histogram at the 128-slot waves its trees take (a root wave with
   every row in one slot, a mid-tree wave with bagged-out rows) and at
   the 1,024-slot waves of a 2,048-leaf tree on the uint8 bins of phase
   4, the 65,536-slot mid-tree wave of a 131,072-leaf tree on those
   bins, and a mid-tree wave of 8 slots at ``max_bin`` 65535 (synthetic
   int32 bins, a 65,536-bin stride, phase 4's row count), each bitwise
   its plain version on CPU copies (a sequential ``index_add_`` in row
   order), timed beside an f32 ``index_add_`` of the same cells on the
   card and its bound; K2 and K4 on int32 bins at a 128-slot wave, and
   on phase 4's uint8 bins at 2,048-leaf tables (64 and 1,024 splits)
   and at the last wave of a 131,072-leaf tree (65,536 splits), bitwise
   their plain versions, timed as phase 3 times them (K2 also beside
   its gather floor); then ``lgb.train`` at ``max_bin`` 1023 and 255
   leaves, 8 iterations (the wide histogram, K2 and K4 on int32 bins,
   no K1/K3), and at 2,048 leaves on phase 4's set, 8 iterations (the wide
   histogram, K2 and K4 on uint8 bins): train AUC >= 0.93, ms/iter, and
   the wide model served binned (int32 rows) == raw on 20,000 rows.
26. wide and deep streams — the seeded wide histogram (a carry a
   previous block's rows left, this block's rows added into it) at
   ``max_bin`` 1023 on int32 bins at 128 slots, at 1,024 slots of a
   2,048-leaf tree on phase 4's uint8 bins and at the 8-slot ``max_bin``
   65535 wave, each bitwise its plain version on CPU copies, timed in a
   CUDA graph beside the unseeded kernel and beside a seeded f32
   ``index_add_``, with its bound (the carry read and written);
   ``ingest_synthetic`` stores of 2,097,152 x 28 rows (two 1,048,576-row
   blocks) at ``max_bin`` 1023 (int32 bins) and 63, streamed by
   ``lgb.train_streaming`` at 255 and 2,048 leaves, 2 iterations: each
   digest (scores included) == in-memory training on
   ``store.to_binned_dataset``, the seeded wide histogram, K2 and K4
   launched and no K1, K3, K5 or unseeded wide histogram, the first
   with the telemetry trace on (every ``stream.*`` span and counter in
   it); the ``max_bin`` 1023 stream again at 8,388,608 rows: its peak
   device memory within 5% of the 2,097,152-row run's; 131,072 rows of
   the headline generator (seed 26) as a libsvm file with a quarter of
   the values zero and left out: ``train_streaming([path])`` (the store
   placed by ``LGBM_TPU_STREAM_CACHE``), again with
   ``LGBM_TPU_STREAM_ROWS=65536`` and ``LGBM_TPU_STREAM_PIPELINE=0``,
   both == ``lgb.train(Dataset(path))``; the headline ``lgb.train``
   with telemetry off and on (``telemetry_output``) in turns, twice
   each: every digest phase 4's (``25aa16f3...``), the trace parsed with
   its ``gbdt.*`` and ``tree.*`` spans, the steady ms/iter of each run
   logged.
   Rows x iterations/s, walls and peak memory are logged beside the
   card's name and power limit; the temporary stores are removed.

28. multiple GPUs — a world of two ranks, each a process of this script
   (``chip_smoke.py --multi-gpu-rank``), joins through
   ``parallel/mesh.py:init_distributed`` (NCCL with a card a rank,
   gloo with both ranks on card 0) and trains through ``lgb.train``:
   every world trains ``MG_ITERS`` (8) iterations of phase 4's
   configuration (32 before the 2-D mesh joined the phase): (a)
   data-parallel on phase 4's
   headline, each rank its contiguous half of the rows: the ranks'
   models byte-identical, a second run and the overlapped reduction
   (``LGBM_TPU_OVERLAP=1``) give the same digest, train AUC >= 0.93,
   K2, K5, K3 and the last route's K4 launched on every rank (no K1),
   steady ms/iter printed beside phase 4's; (b) feature-parallel: the
   digest of phase 4's configuration trained serially for as many
   iterations; (c) voting-parallel (``top_k`` 20): identical ranks, the
   AUC gate; (c2) leaf renewal: phase 20's L1, quantile 0.9 and MAPE
   (on seeded weights) data-parallel and L1 voting-parallel, 255
   leaves, 2 iterations: identical ranks, and every renewed leaf of each
   tree == the percentile over both ranks' rows (L1 and quantile phase
   20's host percentile, weighted MAPE the port's plain CPU renewal);
   (d) a CSV of 200,000 headline rows loaded with ``num_machines`` 2
   (mod-rank rows, distributed bin finding): identical mappers on both
   ranks, then data-parallel training to one model; (e) after a
   data-parallel run, the ``spmd.skip_record`` fault on rank 1 drops the
   record of the middle one of three host gathers: the merged summary
   holds both ranks, their collective skew and a
   ``flight_recorder_check`` naming the skipped site and rank 1; (f) a
   world of four ranks on card 0 with ``mesh_shape`` [2, 2]
   (``MG_MESH``): data-, feature- and voting-parallel, the four ranks'
   models byte-identical and each digest == the two-rank run's of
   (a)-(c).  A rank's failure fails the phase.
29. elastic training — the bench's stream cell (``bench.py:1209-1218``:
   28 features, ``max_bin`` 63, 63 leaves, int8h, lr 0.1, binary,
   1,048,576-row blocks) on 4,194,304 synthetic rows ingested once into a
   shard store under a temporary directory, in S = 2 protocol shards (two
   blocks a shard), 8 iterations, a barrier snapshot every iteration:
   the single-process ``StreamTrainer(num_shards=2)`` oracle on the card
   (train AUC >= 0.93; K5, K2, K4 launched, no K1 or K6); then
   ``tools/chaos_torch.run_chaos`` hosts the elastic coordinator here and
   starts two workers on card 0 (``chip_smoke.py --elastic-worker SPEC
   MEMBER``, ``train_elastic`` over the mmapped store, the kernels this
   process built): a control run, a shrink (worker-1 SIGKILLed when its
   heartbeat reports iteration 3) and a regrow (the same kill and a
   joiner); every worker's model sha256 and ``digest()`` == the oracle's,
   every worker launched K5, K2 and K4 and no K1 or K6, each recovery's
   phases sum to its ``mttr_s``, and the survivor's ``/healthz`` walked
   ready -> recovering -> ready.  Then phase 28's two ranks train the
   data-parallel headline (``MG_ITERS``) with a snapshot halfway and
   resume at W = 2 from it: the resumed digest (and each rank's scores) == the
   uninterrupted run's == phase 28's, and a one-process resume from that
   snapshot refuses.  Walls, MTTR and its phases, and launches are in the
   phase line; every coordinator, worker and rank is gone when it ends.

30. the command-line application and the C API — (a) phase 4's rows
   written as raw float32 files, ``tools/capi_train.cpp`` built against
   the port's C library (``lightgbm_tpu_torch/capi/build.py``, g++ at
   first use) trains ``HEADLINE_PARAMS`` for 32 iterations on the card
   through ``LGBM_DatasetCreateFromMat`` -> ``LGBM_BoosterCreate`` ->
   ``LGBM_BoosterUpdateOneIter`` (the launch counters reset and read in
   the library's embedded interpreter): the saved model text and the
   digests are phase 4's, K1-K4 launched and K6 not, and
   ``LGBM_BoosterPredictForMat`` on 100,000 rows is bitwise those rows
   of phase 4's ``Booster.predict`` of all 1,000,000; the C host's wall and ms/iter are
   printed.  (b) Phase 5's rows as CSV files and a ``train.conf`` of
   ``TRAIN_CONF`` with ``valid_data=`` and ``early_stopping_round`` 10:
   ``python -m lightgbm_tpu_torch config=train.conf`` (run as ``-m``
   runs it, in a child ``chip_smoke.py --app-child``) gives phase 5's
   stop, best iteration and digest with K6 launched; on its model
   ``task=predict`` is phase 5's ``Booster.predict`` as ``%.9g`` text,
   ``task=convert_model`` compiled with g++ is within 1e-5 of
   ``predict(raw_score=True)`` on 1,000 rows, and ``task=refit`` on the
   training file is the in-process refit's model text (but for
   ``feature_infos``).  (c) Two CLI ranks on card 0 (gloo) over a
   loopback ``machines=`` list with ``num_machines`` 2 on phase 28's
   200,000-row CSV and parameters: byte-identical models, rank 0's
   saved file the same, K5 launched on each rank, the digest phase
   28's load's.  Every child is gone when the phase ends.
31. full-size parity — the card's models held to models of the JAX
   package recorded at the same full size on a CPU
   (``tests/data/torch_fullsize/<cell>.json.gz``, written by
   ``tools/torch_fullsize_ref.py``), nine cells: phase 4's headline,
   phase 5's small-data model, phase 12's serving model, phase 6's float
   headline, phase 8's identity stream, phase 17's multiclass model and
   phase 19's ranking model as they were trained (the port's model does
   not depend on the ``evals_result`` or ``callbacks`` those phases
   pass), and, trained here, ``headline_l2`` (the headline's rows and
   parameters, objective ``regression`` on the latent, 8 iterations) and
   ``dp2_l2`` (the same with ``tree_learner=data`` from a zero init
   score over a world of two ranks, gloo on one card and NCCL on two,
   against the JAX package's 2-device mesh).  For each cell the data's
   sha256 (the stream's: its store's bins and labels) and the
   parameters must be the record's; the trees are compared digest by
   digest and by ``parallel/envelope.py:model_flip_report`` (identical
   trees, the first divergence, the leaf-value gap over the identical
   prefix); a divergence must be a near-tie, ``headline_l2`` and both
   ``dp2_l2`` ranks bitwise the record (L2's gradient has no
   transcendental), each other cell's metric within its named tolerance
   of the record's (train or valid AUC, ``multi_logloss``, NDCG@10),
   and a whole identical model's raw scores of the record's 4,096
   sample rows (through ``Booster.predict`` on the card; for
   ``serving`` the compiled model the server serves) the record's host
   walk rounded once to f32.  Then each cell that may part is trained
   again on the card with its gradients taken on the CPU (the objective
   on a host copy of its state and of the card's scores: torch's host
   transcendentals, ROADMAP C6), every gradient call (an iteration's,
   or a stream block's) counting the rows whose gradients and, on the
   int8h cells, quanta the card's own gradients move: that model is
   held to the record the same way.

Each of phases 17-31 prints one ``{"phase": ...}`` JSON line.  A path's
ms/iter is the wall of the whole ``lgb.train`` call, the
Booster's setup (upload, objective init) and, on the small-data path,
the per-iteration evaluation included.  The last lines are the kernel
table as one JSON object (a categorical entry's ``launches`` count its
kernel on phases 13-16 only), the card's name and power limit, and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import gc
import json
import os
import random
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import types

HEADLINE_ROWS = 1_000_000
HEADLINE_FEATURES = 28
HEADLINE_ITERS = 32
HEADLINE_PARAMS = {"objective": "binary", "num_leaves": 255, "max_bin": 63,
                   "learning_rate": 0.1, "min_data_in_leaf": 20,
                   "verbose": -1}
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
CAT_STREAM_ROWS = 131_072       # two blocks (262,144 cut to hold the wall)
CAT_STREAM_BLOCK = 65_536
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
SERVE_SAME_ROWS = 100_000   # scored alike in every batch shape (ROADMAP C35)
# multiclass headline (phase 17): 5 classes from the quantiles of the
# headline's latent, the headline's tree, 8 iterations (40 trees); the
# train multi_logloss must end at most this share of ln 5 (uniform)
MC_CLASSES = 5
MC_ITERS = 8
MC_PARAMS = {"objective": "multiclass", "num_class": MC_CLASSES,
             "num_leaves": 255, "max_bin": 63, "learning_rate": 0.1,
             "min_data_in_leaf": 20, "verbose": -1}
MC_OVA_ITERS = 2
MC_LOSS_SHARE = 0.85
# sum of the served class probabilities: 1 within a few f32 ulps
MC_PROB_SUM_TOL = 1e-5
# examples/multiclass_classification/train.conf of the upstream project
MC_TRAIN_CONF = {"objective": "multiclass", "num_class": MC_CLASSES,
                 "metric": "multi_logloss,multi_error", "metric_freq": 1,
                 "is_training_metric": True, "max_bin": 255,
                 "learning_rate": 0.05, "num_leaves": 31, "verbose": -1}
MC_SMALL_ITERS = 50     # its rounds on the small-data rows (100, cut)
# the bench's ranking leg (bench.py ranking_leg, MS LTR shape): its data
# and configuration, its NDCG@10 gate; 8 iterations; its 19,000 queries
# (about 2.27M docs) cut to 4,750 to hold the smoke's wall
RANK_QUERIES = 4_750
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
REG_PARAMS = {"num_leaves": 255, "max_bin": 63, "learning_rate": 0.1,
              "min_data_in_leaf": 20, "verbose": -1}
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
# the model surface (phase 22): the headline snapshotted every 8
# iterations, 2 kept, its iteration-24 snapshot torn by the fault point
# (skip the calls of snapshots 8 and 16); the small-data run every 10,
# its iteration-40 snapshot torn (skip 10, 20, 30); 200,000 fresh
# headline rows for add_valid (seed 1), refit (seed 2) and prediction
# early stopping (every 4 iterations, margin 4.0); the host f64 walks of
# the rollback and refit checks on the first 100,000 rows
SURFACE_SNAPSHOT_FREQ = 8
SURFACE_SNAPSHOT_KEEP = 2
SURFACE_KILL_SKIP = 2
SURFACE_SMALL_FREQ = 10
SURFACE_SMALL_KILL_SKIP = 3
SURFACE_ROWS = 200_000
SURFACE_HOST_ROWS = 100_000
SURFACE_PES_FREQ = 4
SURFACE_PES_MARGIN = 4.0
# early-stopped rows whose sign agrees with the full prediction
SURFACE_SIGN_SHARE = 0.99
SHAP_ROWS = 10_000          # pred_contrib of phase 12's model, natively
SHAP_SMALL_ROWS = 200       # native against the Python recursion ...
SHAP_SMALL_ITERS = 5        # ... on the first trees
# the entry surface (phase 23): continued training splits phase 4's run
# into two halves; a decaying learning-rate schedule on phase 5's run;
# cv with phase 5's configuration; the native parser's throughput file is
# the small-data rows' text written 4 times (16, cut to hold the wall)
ENTRY_FIRST_ITERS = 16
ENTRY_FOBJ_ITERS = 8
ENTRY_DECAY = (0.2, 0.97)          # lr = 0.2 * 0.97 ** iteration
ENTRY_NFOLD = 3                    # 5, cut to hold the wall
ENTRY_PARSE_REPEAT = 4             # x 65,536 rows = 262,144 rows
# a numpy AUC against the built-in one: both are exact sums of ranks
# (half-integers) in float64 and one division, so they agree to the
# last bits
FEVAL_AUC_TOL = 1e-12
# the raw prediction of a continued model against the sum of its two
# parts' (f32 leaf outputs summed in another order): the registry's
# f32_accum
CONTINUE_TOL = 1e-5
# f32 sums held to an f64 oracle: a sum of m f32 terms (the init score
# and each tree's output, or a subtraction) carries at most m rounding
# errors of one half ulp (2^-24) of the running sum's magnitude, which
# the sum of the terms' magnitudes bounds (the standard bound of
# recursive summation); the card's scores of the same trees are one
# more rounding (1 ulp) away
F32_UNIT_ROUNDOFF = 2.0 ** -24
# the boosting variants (phase 24): LightGBM's documented defaults for
# GOSS and DART; a forest needs bagging
VARIANT_GOSS = {"top_rate": 0.2, "other_rate": 0.1}
VARIANT_DART = {"drop_rate": 0.1, "max_drop": 50, "skip_drop": 0.5}
VARIANT_RF = {"bagging_freq": 1, "bagging_fraction": 0.8}
VARIANT_DART_FREQ = 8
VARIANT_XGB_ITERS = 8
# the compiled prediction (f64 sums rounded to f32 once, then the link)
# against the host walk (f64 throughout): a few f32 ulps of a probability
VARIANT_PRED_TOL = 1e-6
# wide bins and deep trees (phase 25)
WIDE_MAX_BIN = 1023
WIDE_DEEP_LEAVES = 2048
WIDE_ITERS = 8
WIDEST_LEAVES = 131072      # LightGBM's largest num_leaves: 65,536 slots
WIDEST_MAX_BIN = 65535      # a 65,536-bin stride (synthetic int32 bins)
# memory rate of one H100 SXM (NVIDIA data sheet)
# phase 26: wide and deep streams (two 1,048,576-row blocks, then the
# memory check at twice the rows, cut from four times to hold the
# wall), a libsvm
# stream, telemetry
WS_ROWS = 2_097_152
WS_BIG_ROWS = 8_388_608
WS_ITERS = 2
WS_PEAK_SHARE = 0.05         # 8M peak within 5% of the 2M peak
WS_LIBSVM_ROWS = 131_072     # 262,144 cut to hold the wall
WS_LIBSVM_ZERO = 0.25        # share of values zeroed and left out
WS_LIBSVM_BLOCK = 65_536
TELEMETRY_SPANS = ("engine.train", "gbdt.train", "gbdt.iteration",
                   "gbdt.eval", "tree.init", "tree.route", "tree.hist",
                   "tree.split_find", "tree.update")
STREAM_SPANS = ("stream.train", "stream.gradients", "stream.prefetch",
                "stream.upload", "stream.fold")
STREAM_COUNTERS = ("stream.waves", "stream.trees",
                   "stream.pipeline.overlap_s")
HEADLINE_DIGEST = "25aa16f3"  # the headline's trees (PERF.md)
PEAK_BYTES_PER_S = 3.35e12
# float32 rate outside the tensor cores of one H100 SXM (data sheet)
FP32_OPS_PER_S = 67e12
# 32-bit integer adds per clock per SM at compute capability 9.0 (CUDA C++
# Programming Guide, throughput of native arithmetic instructions).  The
# kernels' work is integer: compares in routing, shared-memory atomic adds
# in the histograms.  No shared-atomic rate is published, so each atomic
# counts as one int32 add and the bound is a lower one.
INT32_ADDS_PER_CLOCK_PER_SM = 64


# what phase 27 reuses of the earlier phases: the trees' digests of the
# DART (24) and max_bin 1023 (25) paths, and phase 12's compiled model,
# request pool and sweep
PATH_DIGESTS = {}
SERVE_STATE = {}
# phase 31 (full-size parity): the L2 cell trained there, the tolerance
# of a model's train or valid AUC past a near-tie flip (the registry's
# metric_coarse: the serving model parts at tree 23 of 100 and its train
# AUC lands 2.5e-4 from the record's, on the CPU as on the card), and
# what phases 4, 5 and 12 trained (cell -> {"booster", ...})
FULLSIZE_L2_PARAMS = dict(HEADLINE_PARAMS, objective="regression")
FULLSIZE_L2_ITERS = 8
FULLSIZE_AUC_TOL = 1e-3
FULLSIZE = {}
# the two-rank data-parallel L2 headline against the JAX package's
# 2-device mesh: from a zero init score (with boost_from_average the two
# packages' init scores part in the last bits by design, ROADMAP C27),
# phase 28's 8 iterations
FULLSIZE_DP_PARAMS = dict(FULLSIZE_L2_PARAMS, tree_learner="data",
                          boost_from_average=False)
FULLSIZE_DP_ITERS = 8
FULLSIZE_DP_WORLD = 2
# the metric of each cell that may part from its record at a near-tie,
# held to the record's within a tolerance set from the port-on-the-CPU's
# own distance to it (tools/torch_fullsize_ref.py --check cpu; PERF.md
# section 6): the float headline's train AUC 5.6e-9 and the stream's 0
# (both without a structural divergence), so the registry's f32_tight;
# multi_logloss 7.7e-5 (a structural near-tie at tree 16 of 40) and
# NDCG@10 0 (the record's trees; the card parts at a near-tie flip in
# tree 1, 9.8e-5 from the record), so metric_coarse
FULLSIZE_FLOAT_AUC_TOL = 1e-6
FULLSIZE_MC_LOSS_TOL = 1e-3
FULLSIZE_NDCG_TOL = 1e-3
FULLSIZE_STREAM_AUC_TOL = 1e-6


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


# the empty kernel of the launch floor and the route's gather floor: on
# no path, so built here from tools/ and not from the package's csrc/
TOOLS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools")
FLOOR_SOURCES = ("launch_floor", "gather_floor")
_floor_libs = {}


def start_launch_floor_build(out_dir: str):
    """Start one ``nvcc`` with the package's flags on each of
    ``tools/launch_floor.cu`` and ``tools/gather_floor.cu`` -> ``[(name,
    process, library path)]``; they compile while the package's kernels
    do."""
    from lightgbm_tpu_torch.ops import cuda_build
    builds = []
    for name in FLOOR_SOURCES:
        path = os.path.join(out_dir, f"lib{name}.so")
        cmd = [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", path,
               os.path.join(TOOLS_DIR, f"{name}.cu")]
        builds.append((name, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT), path))
    return builds


def load_launch_floor(builds) -> None:
    """Wait for the floor kernels' builds and load their libraries."""
    import ctypes
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    argtypes = {"lgbm_empty": [I, I, P],
                "lgbm_gather_floor": [P, I, LL, P, P, P, I, P]}
    for name, proc, path in builds:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on tools/{name}.cu:\n"
                               + out.decode(errors="replace"))
        lib = ctypes.CDLL(path)
        for fn, at in argtypes.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = at
                getattr(lib, fn).restype = ctypes.c_int
        _floor_libs[name] = lib


def launch_floor(grid: int, block: int, dev) -> dict:
    """An empty kernel's time at a ``grid`` x ``block`` launch, back to
    back and in a CUDA graph (``tools/launch_floor.cu``): the floor under
    a kernel of that launch shape."""
    lib = _floor_libs["launch_floor"]

    def call(stream=current_stream(dev)):
        return lib.lgbm_empty(grid, block, stream)
    return dict(launch_floor_ms=time_ms(call, 200),
                launch_floor_graph_ms=graph_ms(
                    lambda: call(current_stream(dev))))


def gather_floor(bins_t, leaf2, tabs) -> float:
    """The route's gather floor on one wave, in a CUDA graph
    (``tools/gather_floor.cu``): each row's leaves read and written, and
    the bin K2 reads for a row of a split leaf, with no decision."""
    import torch
    from lightgbm_tpu_torch.ops.route import T_GROUP, T_SEL
    lib = _floor_libs["gather_floor"]
    dev = bins_t.device
    group = torch.where(tabs[T_SEL] != 0, tabs[T_GROUP], -1).int()
    out = torch.empty_like(leaf2)

    def call():
        return lib.lgbm_gather_floor(
            bins_t.data_ptr(), int(bins_t.dtype == torch.int32),
            bins_t.shape[1], leaf2.data_ptr(), out.data_ptr(),
            group.data_ptr(), -1, current_stream(dev))
    ms = graph_ms(call)
    if not torch.equal(out, leaf2):
        raise AssertionError("the gather floor changed the leaves")
    return ms


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
    addr = (tabs[T_GROUP][leaf[rows]].long() * n_pad + rows) \
        * bins_t.element_size()
    return int(rows.numel()), int(torch.unique(addr // 32).numel())


def kernel_phase(dd, vals, entries):
    """Kernel vs plain version at the headline shapes (bitwise), with
    times and bounds; appends one dict per kernel to ``entries``."""
    import torch
    from lightgbm_tpu_torch.ops import cuda_build
    dev = dd.device
    sms = cuda_build.multiprocessor_count(dev)
    int_rate = int32_ops_per_s(sms)
    log(f"int32 add rate {int_rate:.4g}/s ({sms} SMs)")
    L = 255
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

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


def route_timer(bins_t, leaf2, tabs, cat, lv=None):
    """One bound K2 (with ``lv``: K4) launch on a wave, into buffers and
    scratch allocated once, for :func:`time_ms` and :func:`graph_ms`:
    -> ``(call, grid, block)``."""
    import torch
    from lightgbm_tpu_torch.ops import cuda_build
    from lightgbm_tpu_torch.ops.route import (route_grid, route_launch,
                                              route_plan)
    dev = bins_t.device
    n_pad, L = bins_t.shape[1], tabs.shape[1]
    plan = route_plan(cuda_build.library("route"), dev, L, lv is not None,
                      bins_t.dtype == torch.int32)
    scratch = (torch.empty(plan.scratch_bytes, dtype=torch.uint8,
                           device=dev) if plan.scratch_bytes else None)
    buf = torch.empty_like(leaf2)
    vbuf = (torch.empty(n_pad, dtype=torch.float32, device=dev)
            if lv is not None else None)

    def call():
        return route_launch(bins_t, leaf2, buf, tabs, cat, lv, vbuf,
                            scratch)
    return call, route_grid(n_pad, plan), plan.threads


def k2_measure(dd, leaf2, tabs, cat, int_rate: float) -> dict:
    """K2 (route) on one wave's tables: kernel vs plain version bitwise,
    times back to back and in a CUDA graph, the bound, the sector bound,
    the launch floor of its grid and the gather floor of its wave."""
    import torch
    from lightgbm_tpu_torch.ops.route import (route_cost, route_plain,
                                              route_rows_raw)
    dev = dd.device
    L = cat.shape[0]
    out = route_rows_raw(dd.bins_t, leaf2, tabs, cat)
    ref = route_plain(dd.bins_t, leaf2, tabs, cat)
    torch.cuda.synchronize()
    if not torch.equal(out, ref):
        raise AssertionError("route kernel != plain version")
    k2_call, grid, block = route_timer(dd.bins_t, leaf2, tabs, cat)
    ms2 = time_ms(k2_call, 50)
    dev2 = graph_ms(k2_call)
    plain2 = time_ms(lambda: route_plain(dd.bins_t, leaf2, tabs, cat), 5)
    moved_rows, sectors = moved_sectors(dd.bins_t, leaf2, tabs)
    nbytes, ops, _ = route_cost(dd.bins_t, leaf2, tabs, cat, False)
    nbytes = float(nbytes)
    b2 = bound(nbytes, ops, int_rate)
    # the moved rows' bins as whole 32-byte sectors
    sec2 = bound(nbytes - moved_rows * dd.bins_t.element_size()
                 + 32 * sectors, ops, int_rate)
    floor = launch_floor(grid, block, dev)
    gather = gather_floor(dd.bins_t, leaf2, tabs)
    n_cat = int(tabs[3].sum())
    log(f"kernel route L={L} ({n_cat} categorical splits) "
        f"rows={dd.num_data}: bitwise ok, {ms2:.4f} ms back to back, "
        f"{dev2:.4f} ms in a graph (plain {plain2:.3f} ms, bound "
        f"{b2['bound_ms']:.4f} ms; {moved_rows} moved rows touch {sectors} "
        f"sectors: sector bound {sec2['bound_ms']:.4f} ms; gather floor "
        f"{gather:.4f} ms in a graph; an empty kernel of its grid "
        f"{floor['launch_floor_ms']:.4f} ms back to back, "
        f"{floor['launch_floor_graph_ms']:.4f} ms in a graph)")
    return dict(ms=ms2, graph_ms=dev2, plain_ms=plain2, library_ms=None,
                moved_rows=moved_rows, sectors=sectors,
                sector_bound_ms=sec2["bound_ms"], gather_floor_ms=gather,
                **floor, **b2)


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
        bin_stride, hist_cost, hist_launcher, hist_plain, hist_plan,
        hist_slab, slot_tables)
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
    nbytes, ops, _ = hist_cost(G, C, n_pad, A, L, raw, n_active)
    bd = bound(nbytes, ops, int_rate)
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
    from lightgbm_tpu_torch.ops.route import (route_cost,
                                              route_rows_values_raw,
                                              route_values_plain)
    dev = dd.device
    L, B = cat.shape
    out, v = route_rows_values_raw(dd.bins_t, leaf2, tabs, cat, lv)
    ref, rv = route_values_plain(dd.bins_t, leaf2, tabs, cat, lv)
    torch.cuda.synchronize()
    if not (torch.equal(out, ref) and torch.equal(v, rv)):
        raise AssertionError(f"route-values kernel != plain (L={L}, B={B})")
    call, grid, block = route_timer(dd.bins_t, leaf2, tabs, cat, lv)
    ms = time_ms(call, 50)
    gms = graph_ms(call)
    pl = time_ms(lambda: route_values_plain(dd.bins_t, leaf2, tabs, cat,
                                            lv), 5)
    moved_rows, sectors = moved_sectors(dd.bins_t, leaf2, tabs)
    nbytes, ops, _ = route_cost(dd.bins_t, leaf2, tabs, cat, True)
    nbytes = float(nbytes)
    bd = bound(nbytes, ops, int_rate)
    sec = bound(nbytes - moved_rows * dd.bins_t.element_size()
                + 32 * sectors, ops, int_rate)
    floor = launch_floor(grid, block, dev)
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
        bin_stride, hist_launcher, hist_plan, hist_route_cost,
        hist_route_plain, hist_route_raw, hist_slab, slot_tables)
    dev = dd.device
    G, n_pad = dd.bins_t.shape
    C = vals.shape[0]
    B = bin_stride(dd.group_max_bins)
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
    nbytes, ops, _ = hist_route_cost(dd.bins_t, vals, leaf2, ref_l2, inv,
                                     tabs, cat, raw, L)
    bd = bound(float(nbytes), float(ops), int_rate)
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
    FULLSIZE["stream"] = {"booster": bst}

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


def served_in_bucket(srv, X, bucket: int):
    """Raw scores of ``X`` through the server, one request of ``bucket``
    rows at a time (each its own batch, in that bucket; the tail in the
    smallest bucket that holds it)."""
    import numpy as np
    return np.concatenate([
        np.atleast_1d(srv.submit(X[o:o + bucket]).result(120))
        for o in range(0, len(X), bucket)])


def serve_train_data(rng):
    """The serving legs' training rows ``(X, y)``, drawn first from
    ``rng`` (seed 11)."""
    import numpy as np
    X = rng.normal(size=(SERVE_TRAIN_ROWS, HEADLINE_FEATURES)).astype(
        np.float32)
    y = (X[:, 0] * 2 + X[:, 1] - X[:, 2]
         + rng.normal(scale=1.0, size=SERVE_TRAIN_ROWS) > 0).astype(
             np.float32)
    return X, y


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
    X, y = serve_train_data(rng)
    ds = lgb.Dataset(X, label=y, params={"max_bin": SERVE_PARAMS["max_bin"]})
    bst, _, launches = train_path(lgb, "serve model", counters,
                                  SERVE_PARAMS, ds, SERVE_ITERS)
    FULLSIZE["serving"] = {"booster": bst}
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

    # the same rows alone, inside the 1M-row batch, through prediction
    # early stopping with a margin no row reaches and (below) through
    # each bucket of the server: one score each, the host walk's f64 sum
    # rounded once (ROADMAP C35)
    R = SERVE_SAME_ROWS
    t0 = time.time()
    same = host_scores(models, Xq[:R]).astype(np.float32)
    same_host_s = time.time() - t0
    shapes = {"in_1m_batch": raw[:R], "alone": cm.predict_raw(Xq[:R]),
              "binned_1m_batch": braw[:R],
              "early_stop": cm.predict_raw_early_stop(
                  Xq[:R], SURFACE_PES_FREQ, float("inf"))[0]}

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
        for b in SERVE_BUCKETS:
            shapes[f"server_bucket_{b}"] = served_in_bucket(srv, Xq[:R], b)
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
    for name, got in shapes.items():
        if got.shape != same.shape or not np.array_equal(got, same):
            raise AssertionError(
                f"serve: {R} rows {name} differ from the host walk's f64 "
                f"sum rounded once on {int(np.sum(got != same))} rows")
    log(f"serve batch shapes ({card}): {R} rows bitwise alike alone, in "
        f"the {SERVE_ROWS}-row batch (raw and binned), in server buckets "
        f"{list(SERVE_BUCKETS)} and through early stopping with no stop, "
        f"== the host walk's f64 sum rounded once ({same_host_s:.1f} s on "
        f"the host); rows/s raw {raw_rate:.1f}, binned {bin_rate:.1f} "
        f"(with a tree-axis reduction: 15.2-17.9 M raw)")
    lat = {b: (v["p50"], v["p99"]) for b, v in st["latency_ms"].items()}
    log(f"serve server ({card}): {SERVE_REQUESTS}/{SERVE_REQUESTS} resolved "
        f"exactly once in {st['batches']} batches, steady_captures "
        f"{after['steady_captures']}, steady_eager {after['steady_eager']}; "
        f"warm of {list(SERVE_BUCKETS)} {warm_s:.3f} s; p50/p99 ms by "
        f"bucket {lat}")
    for r in table:
        log(f"serve sweep ({card}): {json.dumps(r)}")
    log(f"serve sweep p99 ms at {[int(q) for q in SERVE_QPS]} QPS "
        f"({card}): {[r.get('p99_ms') for r in table]} (with a tree-axis "
        f"reduction: 4.407 / 6.764 / 54.847)")
    for r in alone:
        log(f"serve sweep, generator alone ({card}): {json.dumps(r)}")
    SERVE_STATE.update(model=cm, pool=pool, table=table, booster=bst,
                       rows=Xq[:SHAP_ROWS])
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
    small_ref = {"stop": bst.current_iteration(),
                 "best": bst.best_iteration, "digest": bst.digest(),
                 "pred": pred}
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


def relabel_binned(ds, label, weight=None):
    """A ``BinnedDataset`` over ``ds``'s bins and mappers with other
    labels (and weights): the rows are binned once."""
    import copy
    from lightgbm_tpu_torch.io.dataset import Metadata
    out = copy.copy(ds)
    out.metadata = Metadata()
    out.metadata.set_field("label", label)
    if weight is not None:
        out.metadata.set_field("weight", weight)
    return out


def relabel(ds, label, weight=None):
    """The same for a user ``Dataset``."""
    import copy
    out = copy.copy(ds.construct())
    out.label, out.weight, out.init_score = label, weight, None
    out._constructed = relabel_binned(ds._constructed, label, weight)
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
    params = MC_PARAMS
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
    # phase 31 holds this model to the JAX package's record (the port's
    # model is the same with and without evals_result:
    # tests/test_torch_fullsize_float.py)
    FULLSIZE["multiclass"] = {"booster": bst, "dataset": ds5}
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
        MC_SMALL_ITERS, valid_sets=[dv], valid_names=["valid"],
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
    # phase 31 holds this model to the JAX package's record (the port's
    # model is the same with and without callbacks)
    FULLSIZE["rank"] = {"booster": bst, "data": (X, rel, sizes),
                        "dataset": ds}
    phase_line("19_rank_mslr_shape", card, docs=len(rel),
               queries=len(sizes), features=RANK_FEATURES,
               binning_s=bin_s, seconds=seconds, iter_ms=iter_ms,
               grad_ms=grad_ms, grad_share=share, grad_share_steady=steady,
               ndcg10=float(ndcg10),
               digest=g.digest(include_scores=False), launches=launches,
               launches_per_tree={k: v / RANK_ITERS
                                  for k, v in launches.items()})
    return launches


def host_prefix_sum(x, block: int):
    """Inclusive f32 prefix sum in the port's fixed order
    (``ops/split.py:prefix_sum``), in numpy: sequential within blocks of
    ``block``, plus the recursively summed exclusive prefix of the block
    totals."""
    import numpy as np
    n = len(x)
    if n <= block:
        return np.cumsum(x, dtype=np.float32)
    nb = -(-n // block)
    xp = np.zeros(nb * block, np.float32)
    xp[:n] = x
    within = np.cumsum(xp.reshape(nb, block), axis=1, dtype=np.float32)
    incl = host_prefix_sum(within[:, -1], block)
    excl = np.concatenate([np.zeros(1, np.float32), incl[:-1]])
    return (within + excl[:, None]).reshape(-1)[:n]


def host_percentile(values, row_leaf, num_leaves: int, alpha: float,
                    weight=None):
    """Per-leaf percentile of f32 ``values`` on the host, in numpy f32
    arithmetic, rows sorted by (leaf, value) and ties in row order.
    Unweighted: read at ``alpha * (count - 1)`` with linear
    interpolation (the reference's PercentileFun).  Weighted: the first
    row of the leaf whose cumulative weight (an f32 prefix sum over the
    sorted rows, :func:`host_prefix_sum`) reaches the leaf's first
    cumulative weight before it plus ``alpha`` of its total (the JAX
    package's rule for WeightedPercentileFun, which the port keeps)."""
    import numpy as np
    from lightgbm_tpu_torch.ops.split import PREFIX_BLOCK
    order = np.lexsort((values, row_leaf))
    sv, sl = values[order], row_leaf[order]
    lid = np.arange(num_leaves)
    start = np.searchsorted(sl, lid, side="left")
    end = np.searchsorted(sl, lid, side="right")
    cnt = end - start
    n = len(sv)
    if weight is None:
        pos = np.float32(alpha) * (cnt - 1).astype(np.float32)
        lo, hi = np.floor(pos).astype(np.int64), np.ceil(pos).astype(
            np.int64)
        frac = pos - lo.astype(np.float32)
        vlo = sv[np.clip(start + lo, 0, n - 1)]
        vhi = sv[np.clip(start + hi, 0, n - 1)]
        out = vlo * (np.float32(1) - frac) + vhi * frac
    else:
        cum = host_prefix_sum(np.asarray(weight, np.float32)[order],
                              PREFIX_BLOCK)
        zero = np.float32(0)
        base = np.where(start > 0, cum[np.maximum(start - 1, 0)], zero)
        total = np.where(end > 0, cum[np.maximum(end - 1, 0)], zero) - base
        target = base + np.float32(alpha) * total
        pos = np.searchsorted(cum, target, side="left")
        pos = np.minimum(np.maximum(pos, start), np.maximum(end - 1, start))
        out = sv[np.clip(pos, 0, n - 1)]
    return np.where(cnt > 0, out, np.float32(0))


def mape_weight(label, weight=None):
    """MAPE's per-row percentile weight in numpy f32: ``1 / max(|label|,
    1)``, times the row weight when there is one."""
    import numpy as np
    lw = np.float32(1) / np.maximum(np.abs(label), np.float32(1))
    return lw if weight is None else lw * np.asarray(weight, np.float32)


@contextlib.contextmanager
def recorded_renewals(cls):
    """Every ``renew_tree_output`` of the objective class ``cls`` inside
    the block -> a list of ``(score, row_leaf, renewed leaves, label)``
    host arrays, one a tree of this rank."""
    had = "renew_tree_output" in cls.__dict__
    plain = cls.renew_tree_output
    seen = []

    def record(self, score, row_leaf, num_leaves, gather_rows=None):
        res = plain(self, score, row_leaf, num_leaves, gather_rows)
        seen.append(tuple(t.cpu().numpy().copy() for t in (
            score, row_leaf, res, self.label)))
        return res
    cls.renew_tree_output = record
    try:
        yield seen
    finally:
        if had:
            cls.renew_tree_output = plain
        else:
            del cls.renew_tree_output


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
        params = dict(REG_PARAMS, objective=name, **extra)
        cls = objs.OBJECTIVES[name]
        checked = cls.need_renew_tree_output
        evals = {}
        with recorded_renewals(cls) as renewals:
            bst, seconds, launches = train_path(
                lgb, f"regression family: {key}", counters, params, dsr,
                REG_ITERS, valid_sets=[dsr], valid_names=["training"],
                evals_result=evals, verbose_eval=False)
        (metric, vals), = evals["training"].items()
        log(f"{key}: train {metric} {vals}; digest "
            f"{bst.digest(include_scores=False)}")
        if len(vals) != REG_ITERS or not vals[1] < vals[0]:
            raise AssertionError(f"{key}: {metric} {vals} did not fall")
        if launches["route_values"] <= 0 or launches["hist_route"] <= 0:
            raise AssertionError(f"{key}: kernels not launched {launches}")
        worst = None
        if checked:
            alpha = extra.get("alpha", 0.5)
            worst = 0
            for score, row_leaf, res, label in renewals:
                want = host_percentile(
                    label - score, row_leaf, len(res), alpha,
                    mape_weight(label) if name == "mape" else None)
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


def f32_sum_check(what: str, got, oracle, abs_terms, terms: int) -> float:
    """``got`` (f32 sums) against the f64 ``oracle`` within the recursive
    summation bound ``terms * 2^-24 * abs_terms`` plus one f32 ulp of
    the oracle; raises past it.  -> the worst share of the bound used."""
    import numpy as np
    oracle = np.asarray(oracle, np.float64)
    bound = (terms * F32_UNIT_ROUNDOFF * np.asarray(abs_terms, np.float64)
             + np.spacing(np.abs(oracle).astype(np.float32)))
    worst = float(np.max(np.abs(np.asarray(got, np.float64) - oracle)
                         / bound))
    if not worst <= 1.0:
        raise AssertionError(f"{what}: {worst:.3f} of the f32 summation "
                             f"bound from the f64 host walk")
    return worst


def host_outputs(trees, X):
    """Each tree's f64 output per row of ``X`` (the host walk) ->
    ``[T, n]``."""
    import numpy as np
    X64 = np.asarray(X, np.float64)
    return np.stack([t.predict_batch(X64) for t in trees])


class CallTimes:
    """Times every call of ``owner.name`` (host clock, the device
    synchronized before and after) while in a ``with`` block."""

    def __init__(self, owner, name: str):
        self.owner, self.name, self.ms = owner, name, []

    def __enter__(self):
        import torch
        fn = self.fn = getattr(self.owner, self.name)

        def timed(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                torch.cuda.synchronize()
                self.ms.append(1e3 * (time.perf_counter() - t0))
        setattr(self.owner, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.fn)


def killed_and_resumed(lgb, name, counters, params, ds, rounds, skip: int,
                       want_iter: int, **kw):
    """``lgb.train`` with ``snapshot_freq`` killed by the
    ``snapshot.write`` fault point after ``skip`` snapshots, then resumed
    from the prefix: -> ``(resumed booster, launches of both runs, ms
    per snapshot write, resume ms, launches of the resumed run)``."""
    from lightgbm_tpu_torch.boosting import snapshot as snap
    from lightgbm_tpu_torch.boosting.gbdt import GBDT
    from lightgbm_tpu_torch.utils import faults
    prefix = params["output_model"]
    faults.inject("snapshot.write", times=1, skip=skip)
    try:
        with CallTimes(snap, "write_snapshot") as writes:
            try:
                train_path(lgb, f"{name} (killed)", counters, params, ds,
                           rounds, **kw)
            except faults.FaultInjected:
                pass
            else:
                raise AssertionError(f"{name}: the fault did not fire")
            killed = {k: fn.launches for k, fn in counters.items()}
            m = snap.latest_valid_snapshot(prefix)
            if m is None or m["iteration"] != want_iter:
                raise AssertionError(
                    f"{name}: latest valid snapshot "
                    f"{m and m['iteration']}, not {want_iter}")
            faults.clear()
            with CallTimes(GBDT, "resume_from_snapshot") as resume:
                bst, _, resumed = train_path(
                    lgb, f"{name} (resumed from {want_iter})", counters,
                    params, ds, rounds, resume_from=prefix, **kw)
    finally:
        faults.clear()
    both = {k: killed[k] + resumed[k] for k in killed}
    return bst, both, writes.ms, resume.ms[0], resumed


def model_surface_phase(lgb, counters, ds, X, y, ds_small, dv_small,
                        head: dict, small: dict, card: str) -> dict:
    """Phase 22: the model surface on the card -> launches.  ``head``
    and ``small`` hold phases 4 and 5's model text, digests (scores
    included), stop and best iterations."""
    import numpy as np
    import torch
    from lightgbm_tpu_torch.io.dataset import Metadata
    from lightgbm_tpu_torch.metric.metrics import binary_auc
    from lightgbm_tpu_torch.models.tree import predict_leaf
    from lightgbm_tpu_torch.serve import compile_model
    tmp = tempfile.mkdtemp(prefix="lgbm_snapshots_")
    out = {}
    try:
        # 1. the headline killed in its iteration-24 snapshot, resumed
        params = dict(head["params"],
                      snapshot_freq=SURFACE_SNAPSHOT_FREQ,
                      snapshot_keep=SURFACE_SNAPSHOT_KEEP,
                      output_model=os.path.join(tmp, "headline.txt"))
        bst, launches, writes, resume_ms, resumed = killed_and_resumed(
            lgb, "headline", counters, params, ds, HEADLINE_ITERS,
            SURFACE_KILL_SKIP, 16)
        missing = [k for k in ("route", "route_values", "hist_route",
                               "hist_compact") if resumed[k] <= 0]
        if missing:
            raise AssertionError(f"kernels not launched on the resumed "
                                 f"headline: {missing}")
        if bst.model_to_string() != head["text"]:
            raise AssertionError("the resumed headline's model text is "
                                 "not phase 4's")
        if bst.digest() != head["digest"]:
            raise AssertionError("the resumed headline's digest (scores "
                                 "included) is not phase 4's")
        out.update(snapshot_write_ms=writes, resume_ms=resume_ms,
                   headline_digest=head["digest"])
        log(f"model surface: headline resumed from 16 == phase 4 (text, "
            f"digest {head['digest'][:8]} with scores); snapshot writes "
            f"{[round(w, 1) for w in writes]} ms, resume {resume_ms:.1f} "
            f"ms; resumed launches {resumed}")

        # 2. early stopping across a resume: the small-data run killed in
        # its iteration-40 snapshot
        sparams = dict(TRAIN_CONF, snapshot_freq=SURFACE_SMALL_FREQ,
                       snapshot_keep=SURFACE_SNAPSHOT_KEEP,
                       output_model=os.path.join(tmp, "small.txt"))
        sb, small_launch, swrites, sresume_ms, _ = killed_and_resumed(
            lgb, "small-data", counters, sparams, ds_small, SMALL_ITERS,
            SURFACE_SMALL_KILL_SKIP, 30, valid_sets=[dv_small],
            valid_names=["valid"], early_stopping_rounds=SMALL_EARLY_STOP,
            verbose_eval=False)
        got = (sb.current_iteration(), sb.best_iteration, sb.digest())
        want = (small["stop"], small["best"], small["digest"])
        if got != want:
            raise AssertionError(f"resumed small-data run (stop, best, "
                                 f"digest) {got} != phase 5's {want}")
        launches = {k: launches[k] + small_launch[k] for k in launches}
        out.update(small_stop=got[0], small_best=got[1],
                   small_snapshot_write_ms=swrites,
                   small_resume_ms=sresume_ms)
        log(f"model surface: small-data resumed from 30 stops at {got[0]}, "
            f"best {got[1]}, digest {got[2][:8]} == phase 5")

        # 3. rollback, add_valid mid-run, one more update
        g = bst._gbdt
        Xh = X[:SURFACE_HOST_ROWS]
        bst.predict(Xh, raw_score=True)       # caches the 32-tree pack
        outs = host_outputs(g.models, Xh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bst.rollback_one_iter()
        torch.cuda.synchronize()
        rollback_ms = 1e3 * (time.perf_counter() - t0)
        if bst.num_trees() != HEADLINE_ITERS - 1:
            raise AssertionError(f"{bst.num_trees()} trees after rollback")
        # init, 32 adds, 1 subtraction, over all 32 trees' magnitudes
        rb = f32_sum_check("scores after rollback",
                           g.scores[:SURFACE_HOST_ROWS, 0].cpu().numpy(),
                           np.sum(outs[:-1], axis=0),
                           np.abs(outs).sum(axis=0)
                           + abs(g.init_score_value), HEADLINE_ITERS + 2)
        X2, z2 = headline_latent(1)
        X2, y2 = X2[:SURFACE_ROWS], (z2[:SURFACE_ROWS] > 0).astype(
            np.float32)
        dv = lgb.Dataset(X2, label=y2, reference=ds)
        dv.construct()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bst.add_valid(dv, "fresh")
        torch.cuda.synchronize()
        add_valid_ms = 1e3 * (time.perf_counter() - t0)
        vs = g._valid_scores[-1][:, 0].cpu().numpy()
        cm31 = compile_model(g)
        served = cm31.predict_raw(X2)
        mag2 = compile_model_abs(g.models).predict_raw(X2)
        av = f32_sum_check("add_valid scores vs the compiled predictor", vs,
                           served, mag2, HEADLINE_ITERS)
        vauc = binary_auc(y2, vs)
        if not vauc >= AUC_GATE:
            raise AssertionError(f"valid auc {vauc} < {AUC_GATE}")
        bst.update()
        if bst.num_trees() != HEADLINE_ITERS:
            raise AssertionError("update after rollback")
        ulp_new = ulp_check("predict after rollback + update",
                            bst.predict(Xh, raw_score=True,
                                        num_iteration=HEADLINE_ITERS),
                            np.sum(np.concatenate(
                                [outs[:-1], host_outputs(g.models[-1:], Xh)]),
                                axis=0))
        out.update(rollback_ms=rollback_ms, rollback_bound_share=rb,
                   add_valid_ms=add_valid_ms, add_valid_bound_share=av,
                   valid_auc=vauc, predict_after_update_ulp=ulp_new)
        log(f"model surface: rollback {rollback_ms:.1f} ms ({rb:.3f} of the "
            f"bound); add_valid of {SURFACE_ROWS} rows {add_valid_ms:.1f} ms "
            f"({av:.3f} of the bound), valid auc {vauc:.5f}; after update "
            f"{ulp_new:.3f} ulp")

        # 4. refit on fresh rows (seed 2)
        X3, z3 = headline_latent(2)
        X3, y3 = X3[:SURFACE_ROWS], (z3[:SURFACE_ROWS] > 0).astype(
            np.float32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new = bst.refit(X3, y3)
        torch.cuda.synchronize()
        refit_ms = 1e3 * (time.perf_counter() - t0)
        leaves = compile_model(g).leaf_indices(X3)
        if not np.array_equal(leaves[:SURFACE_HOST_ROWS],
                              predict_leaf(g.models, X3[:SURFACE_HOST_ROWS])):
            raise AssertionError("refit leaves on the card != host walk")
        zero_hess = refit_numpy_check(new._gbdt, g.models, leaves, y3)
        out.update(refit_ms=refit_ms, refit_zero_hessian_leaves=zero_hess)
        log(f"model surface: refit of {SURFACE_ROWS} rows {refit_ms:.1f} ms, "
            f"leaves == host walk, leaf values == the numpy refit "
            f"({zero_hess} leaves of zero hessian set to 0)")

        # 5. prediction early stopping
        out.update(pes_phase(lgb, bst, X2))

        # 6. model IO
        out.update(model_io_check(lgb, bst, X2, tmp))

        # 7. SHAP contributions of phase 12's model, natively
        out.update(shap_check(card))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    phase_line("model_surface", card, launches=launches, **out)
    return launches


def shap_check(card: str) -> dict:
    """``pred_contrib`` of phase 12's model (``SERVE_STATE``) on
    ``SHAP_ROWS`` rows through the native TreeSHAP recursion: each row's
    phis plus its expected value are the host walk's raw score within
    ``f64_chain``; on ``SHAP_SMALL_ROWS`` rows of the first
    ``SHAP_SMALL_ITERS`` trees the native phis are the Python
    recursion's within the same tolerance."""
    import numpy as np
    from lightgbm_tpu_torch import native
    from tools.numcheck.tolerance_registry import tol
    if not native.available():
        raise AssertionError("the native library (TreeSHAP) is not built")
    bst, X = SERVE_STATE["booster"], SERVE_STATE["rows"][:SHAP_ROWS]
    atol = tol("f64_chain")
    t0 = time.time()
    phis = bst.predict(X, pred_contrib=True)
    native_s = time.time() - t0
    raw = bst.predict(X, raw_score=True, device=False)
    sum_err = float(np.max(np.abs(phis.sum(axis=1) - raw)))
    if phis.shape != (len(X), X.shape[1] + 1) or not sum_err <= atol:
        raise AssertionError(f"SHAP: phis {phis.shape} sum {sum_err} from "
                             f"the raw score (tolerance {atol})")
    Xs, k = X[:SHAP_SMALL_ROWS], SHAP_SMALL_ITERS
    t0 = time.time()
    small = bst.predict(Xs, pred_contrib=True, num_iteration=k)
    small_native_s = time.time() - t0
    treeshap, native.treeshap_patterns = (native.treeshap_patterns,
                                          lambda *a, **kw: None)
    try:
        t0 = time.time()
        python = bst.predict(Xs, pred_contrib=True, num_iteration=k)
        small_python_s = time.time() - t0
    finally:
        native.treeshap_patterns = treeshap
    py_err = float(np.max(np.abs(small - python)))
    if not py_err <= atol:
        raise AssertionError(f"SHAP: native phis {py_err} from the Python "
                             f"recursion's (tolerance {atol})")
    log(f"model surface SHAP ({card}): {len(X)} rows x {bst.num_trees()} "
        f"trees native {native_s:.3f} s (phis + expected value within "
        f"{sum_err:.3g} of the raw score); {len(Xs)} rows x {k} trees "
        f"native {small_native_s:.4f} s, Python {small_python_s:.3f} s, "
        f"{py_err:.3g} apart")
    return {"shap_rows": len(X), "shap_native_s": native_s,
            "shap_sum_err": sum_err, "shap_small_native_s": small_native_s,
            "shap_small_python_s": small_python_s, "shap_python_err": py_err}


def compile_model_abs(trees):
    """The trees with each leaf's magnitude, compiled on the card: each
    row's sum of the trees' output magnitudes."""
    import copy
    from lightgbm_tpu_torch.serve import compile_trees
    mags = []
    for t in trees:
        t = copy.deepcopy(t)
        t.leaf_value = abs(t.leaf_value)
        mags.append(t)
    return compile_trees(mags, device="cuda")


def refit_numpy_check(new, trees, leaves, label) -> None:
    """``new``'s refit leaf values (decay 0.9) against a numpy refit of
    the source ``trees`` from the same leaves and the card's own
    gradients (the objective's, at each iteration's scores), copied to
    the host: bitwise.  -> the number of leaves that fitted 0/0."""
    import numpy as np
    import torch
    c = new.config
    decay = 0.9                     # Booster.refit's default
    zero_hess = 0
    score = np.zeros(len(label), np.float32)
    for i, t in enumerate(trees):
        s = torch.from_numpy(score[:, None].copy()).to(new.device)
        grad, hess = new.objective.get_gradients_k(s)
        gr, he = grad[:, 0].cpu().numpy(), hess[:, 0].cpu().numpy()
        nl = t.num_leaves
        sg, sh, cnt = np.zeros(nl), np.zeros(nl), np.zeros(nl)
        np.add.at(sg, leaves[:, i], gr)
        np.add.at(sh, leaves[:, i], he)
        np.add.at(cnt, leaves[:, i], 1.0)
        with np.errstate(divide="ignore", invalid="ignore"):
            fit = (-(np.sign(sg) * np.maximum(np.abs(sg) - c.lambda_l1, 0.0))
                   / (sh + c.lambda_l2))
        old = np.asarray(t.leaf_value[:nl], np.float64)
        want = np.where(cnt > 0, decay * old
                        + (1.0 - decay) * fit * c.learning_rate, old)
        # a leaf whose rows all have zero hessians (a saturated sigmoid
        # in f32) fits 0/0: Tree.set_leaf_output stores 0.0
        want = np.where(np.isfinite(want), want, 0.0)
        got = new.models[i].leaf_value[:nl]
        if not np.array_equal(got, want):
            raise AssertionError(f"refit tree {i}: leaf values != the "
                                 f"numpy refit")
        zero_hess += int(((cnt > 0) & (sh + c.lambda_l2 == 0)).sum())
        score = score + want.astype(np.float32)[leaves[:, i]]
    return zero_hess


def pes_phase(lgb, bst, X) -> dict:
    """Prediction early stopping on the card (every ``SURFACE_PES_FREQ``
    iterations, margin ``SURFACE_PES_MARGIN``) against the host rounds
    and the full prediction."""
    import numpy as np
    import torch
    params = dict(bst.params, pred_early_stop=True,
                  pred_early_stop_freq=SURFACE_PES_FREQ,
                  pred_early_stop_margin=SURFACE_PES_MARGIN)
    pes = lgb.Booster(params, model_str=bst.model_to_string(),
                      device="cuda")
    cm = pes._device_predictor()
    raw, taken = cm.predict_raw_early_stop(X, SURFACE_PES_FREQ,
                                           SURFACE_PES_MARGIN)
    full = cm.predict_raw(X)
    Xh = X[:SURFACE_HOST_ROWS]
    hraw, htaken = pes._gbdt.predict_raw_early_stop(Xh, pes.num_trees())
    if not np.array_equal(taken[:SURFACE_HOST_ROWS], htaken):
        raise AssertionError("early-stop rounds on the card != host")
    ulp = ulp_check("early-stopped scores", raw[:SURFACE_HOST_ROWS],
                    hraw[:, 0])
    rounds = -(-HEADLINE_ITERS // SURFACE_PES_FREQ)
    stopped = taken < rounds
    share = float(stopped.mean())
    agree = float((np.sign(raw[stopped]) == np.sign(full[stopped])).mean())
    if not share > 0:
        raise AssertionError("no row stopped early")
    if not agree >= SURFACE_SIGN_SHARE:
        raise AssertionError(f"sign agrees on {agree} of the stopped rows")

    def rate(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        return 3 * len(X) / (time.perf_counter() - t0)
    es_rate = rate(lambda: pes.predict(X, raw_score=True))
    full_rate = rate(lambda: cm.predict_raw(X))
    log(f"model surface: early stop routing == host on "
        f"{SURFACE_HOST_ROWS} rows, {ulp:.3f} ulp; {share:.4f} of rows "
        f"stop, sign agrees on {agree:.4f} of them; {es_rate:.0f} rows/s "
        f"(full prediction {full_rate:.0f})")
    return dict(pes_stopped_share=share, pes_sign_agree=agree,
                pes_ulp=ulp, pes_rows_per_s=es_rate,
                full_rows_per_s=full_rate)


def model_io_check(lgb, bst, X, tmp: str) -> dict:
    """``save_model`` then ``Booster(model_file=)`` on the card: the same
    model text but for ``feature_infos`` (a loaded model writes them as
    ``none``, as the JAX package's loaded model does), bitwise the same
    predictions; a pickle round trip keeps the text."""
    import pickle
    import numpy as np
    path = os.path.join(tmp, "model.txt")
    t0 = time.perf_counter()
    bst.save_model(path)
    loaded = lgb.Booster(model_file=path, device="cuda")
    io_ms = 1e3 * (time.perf_counter() - t0)
    with open(path) as f:
        saved = f.read().splitlines()
    back = loaded.model_to_string().splitlines()
    diff = [i for i, (a, b) in enumerate(zip(saved, back)) if a != b]
    if len(saved) != len(back) or any(
            not back[i].startswith("feature_infos=")
            or set(back[i].split("=", 1)[1].split()) != {"none"}
            for i in diff):
        raise AssertionError("a loaded model writes another text")
    if not np.array_equal(loaded.predict(X), bst.predict(X)):
        raise AssertionError("a loaded model predicts otherwise")
    text = bst.model_to_string()
    if pickle.loads(pickle.dumps(bst)).model_to_string() != text:
        raise AssertionError("a pickle round trip changes the model text")
    log(f"model surface: save + load {io_ms:.1f} ms, same text and "
        f"predictions; pickle keeps the text")
    return dict(model_io_ms=io_ms)


def counted(counters, fn):
    """``fn()`` with every launch counter reset just before and read just
    after: -> ``(result, seconds, launches)``."""
    import torch
    for c in counters.values():
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, time.time() - t0, {k: c.launches for k, c in
                                   counters.items()}


def add_launches(total: dict, more: dict) -> None:
    for k, v in more.items():
        total[k] = total.get(k, 0) + v


def need(launches: dict, kernels, what: str, absent=()) -> None:
    missing = [k for k in kernels if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on {what}: {missing}")
    ran = [k for k in absent if launches[k] != 0]
    if ran:
        raise AssertionError(f"kernels launched on {what}: {ran}")


def auc_feval(score, dataset):
    """A numpy AUC as a ``feval``: the rank sum of the positives (average
    ranks for ties)."""
    import numpy as np
    pos = np.asarray(dataset.get_label()) > 0
    _, inv, counts = np.unique(score, return_inverse=True,
                               return_counts=True)
    rank = (np.cumsum(counts) - (counts - 1) / 2.0)[inv]
    n_pos = int(pos.sum())
    n_neg = len(pos) - n_pos
    auc = (rank[pos].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg)
    return "auc_numpy", float(auc), True


def write_libsvm(path: str, X, y) -> None:
    """Every feature of every row written, ``%.17g`` (exact)."""
    import numpy as np
    fmt = "%.17g " + " ".join(f"{j}:%.17g" for j in range(X.shape[1]))
    np.savetxt(path, np.column_stack([y, X]).astype(np.float64), fmt=fmt)


def write_csv(path: str, X, y) -> None:
    """A header ``target,f0,...``, the label first, ``%.17g`` (exact)."""
    import numpy as np
    names = ["target"] + [f"f{j}" for j in range(X.shape[1])]
    np.savetxt(path, np.column_stack([y, X]).astype(np.float64),
               fmt="%.17g", delimiter=",", header=",".join(names),
               comments="")


def entry_surface_phase(lgb, counters, ds, X, y, z, ds_small, dv_small,
                        small_rows, head: dict, small: dict,
                        card: str) -> dict:
    """Phase 23: the user entry surface on the card -> launches.
    ``small_rows`` are phase 5's ``(X, y, X_valid, y_valid)``; ``head``
    and ``small`` hold phases 4 and 5's results (model text, digests with
    scores, phase 4's predictions, phase 5's stop and best iteration)."""
    Xv = small_rows[2]
    import numpy as np
    import torch
    from lightgbm_tpu_torch.engine import cv_folds
    from lightgbm_tpu_torch.metric.metrics import binary_auc
    out, total = {}, {}
    head_params = head["params"]

    # 1. LGBMClassifier at the headline's width.  Every default that
    # LGBMModel._process_params maps (min_child_weight 1e-3,
    # min_child_samples 20, subsample_for_bin 200,000, the zero
    # regularizers, no bagging) is train's default too; the headline's
    # own values go in explicitly
    clf = lgb.LGBMClassifier(
        n_estimators=HEADLINE_ITERS, num_leaves=head_params["num_leaves"],
        max_bin=head_params["max_bin"],
        learning_rate=head_params["learning_rate"],
        min_child_samples=head_params["min_data_in_leaf"], verbose=-1,
        device="cuda")
    _, secs, launches = counted(counters, lambda: clf.fit(X, y))
    need(launches, ("route", "route_values", "hist_route", "hist_compact"),
         "the sklearn headline", ("split_scan",))
    add_launches(total, launches)
    if clf.booster_.digest() != head["digest"]:
        raise AssertionError("LGBMClassifier's digest (scores included) is "
                             "not phase 4's")
    proba = clf.predict_proba(X)
    torch.cuda.synchronize()
    if not np.array_equal(proba[:, 1], head["pred"]):
        raise AssertionError("predict_proba[:, 1] is not phase 4's "
                             "Booster.predict bitwise")
    if not np.array_equal(proba[:, 0], 1.0 - head["pred"]):
        raise AssertionError("predict_proba[:, 0] is not 1 - p")
    out.update(sklearn_fit_s=secs, sklearn_ms_per_iter=1e3 * secs
               / HEADLINE_ITERS,
               sklearn_digest=clf.booster_.digest(include_scores=False))
    log(f"entry surface: LGBMClassifier fit {secs:.3f} s, digest == phase "
        f"4 (scores included), predict_proba == Booster.predict; launches "
        f"{launches}")
    del clf, proba

    # 2. a custom objective: L2 on the latent against the built-in
    # regression, both without boost_from_average
    dsz = relabel(ds, np.asarray(z, np.float32))

    def l2(score, dataset):
        return score - dataset.get_label(), np.ones_like(score)

    rparams = dict(head_params, objective="regression",
                   boost_from_average=False)
    ref, ref_s, launches = train_path(lgb, "built-in regression", counters,
                                      rparams, dsz, ENTRY_FOBJ_ITERS,
                                      verbose_eval=False)
    add_launches(total, launches)
    fparams = dict(head_params, boost_from_average=False)
    fb, fobj_s, launches = train_path(lgb, "fobj L2", counters, fparams,
                                      dsz, ENTRY_FOBJ_ITERS, fobj=l2,
                                      verbose_eval=False)
    need(launches, ("route", "route_values", "hist_route", "hist_compact"),
         "the fobj run")
    add_launches(total, launches)
    if fb.digest() != ref.digest():
        raise AssertionError("the fobj L2 model is not the built-in "
                             "regression's (digest with scores)")
    out.update(fobj_ms_per_iter=1e3 * fobj_s / ENTRY_FOBJ_ITERS,
               builtin_l2_ms_per_iter=1e3 * ref_s / ENTRY_FOBJ_ITERS,
               fobj_digest=fb.digest(include_scores=False))
    log(f"entry surface: fobj L2 == built-in regression, digest "
        f"{fb.digest(include_scores=False)[:8]}; "
        f"{out['fobj_ms_per_iter']:.2f} vs "
        f"{out['builtin_l2_ms_per_iter']:.2f} ms/iter")
    del ref, fb, dsz

    # 3. feval: a numpy AUC beside the built-in auc on phase 5's run,
    # for phase 5's iterations
    evals = {}
    fe, fe_s, launches = train_path(
        lgb, "small-data with feval", counters, TRAIN_CONF, ds_small,
        small["stop"], valid_sets=[dv_small], valid_names=["valid"],
        feval=auc_feval, evals_result=evals, verbose_eval=False)
    add_launches(total, launches)
    got = np.asarray(evals["valid"]["auc_numpy"])
    want = np.asarray(evals["valid"]["auc"])
    gap = float(np.max(np.abs(got - want)))
    if len(got) != small["stop"] or not gap <= FEVAL_AUC_TOL:
        raise AssertionError(f"feval AUC differs from the built-in auc by "
                             f"{gap} (> {FEVAL_AUC_TOL})")
    if fe.digest() != small["digest"]:
        raise AssertionError("the feval run's model is not phase 5's")
    out.update(feval_auc_max_gap=gap,
               feval_ms_per_iter=1e3 * fe_s / small["stop"])
    log(f"entry surface: feval AUC within {gap:.3g} of auc at each of "
        f"{len(got)} iterations; model == phase 5")
    del fe

    # 4. continued training: phase 4's configuration for 16 iterations,
    # then init_model= its text for 16 more
    first, _, launches = train_path(lgb, "headline first half", counters,
                                    head_params, ds, ENTRY_FIRST_ITERS,
                                    verbose_eval=False)
    add_launches(total, launches)
    first_text = first.model_to_string()
    cont, cont_s, launches = train_path(
        lgb, "headline continued", counters, head_params, ds,
        HEADLINE_ITERS - ENTRY_FIRST_ITERS, init_model=first_text,
        verbose_eval=False)
    need(launches, ("route", "route_values", "hist_route", "hist_compact"),
         "the continued headline")
    add_launches(total, launches)

    def trees(text):
        return [t.strip() for t in text.split("feature importances:")[0]
                .split("Tree=")[1:]]
    if trees(cont.model_to_string())[:ENTRY_FIRST_ITERS] != \
            trees(first_text):
        raise AssertionError("the continued model's first trees are not "
                             "the init model's")
    second = lgb.Booster(model_str=cont.model_to_string())
    second._gbdt.models = second._gbdt.models[ENTRY_FIRST_ITERS:]
    raw = cont.predict(X, raw_score=True)
    parts = (first.predict(X, raw_score=True)
             + second.predict(X, raw_score=True))
    torch.cuda.synchronize()
    gap = np.abs(raw - parts)
    if not np.all(gap <= CONTINUE_TOL * (1.0 + np.abs(parts))):
        raise AssertionError(f"continued raw prediction differs from the "
                             f"sum of its parts by {gap.max()}")
    v = cont._gbdt.init_score_value
    bias_gap = float(np.mean(cont._gbdt.scores[:, 0].cpu().numpy() - raw))
    out.update(continued_digest=cont.digest(include_scores=False),
               continued_ms_per_iter=1e3 * cont_s
               / (HEADLINE_ITERS - ENTRY_FIRST_ITERS),
               continued_raw_gap=float(gap.max()),
               continued_score_minus_raw=bias_gap, boost_from_average=v)
    log(f"entry surface: continued headline digest "
        f"{out['continued_digest'][:8]} (phase 4's is "
        f"{head['digest_trees'][:8]}: the double boost_from_average), raw "
        f"== parts within {gap.max():.3g}; training scores - raw "
        f"{bias_gap:.6f} (init score {v:.6f})")
    del first, cont, second, raw, parts

    # 5. learning_rates: a constant schedule is phase 5's run; then a
    # decaying one
    lr_evals = {}
    lb, lr_s, launches = train_path(
        lgb, "small-data, constant learning_rates", counters, TRAIN_CONF,
        ds_small, SMALL_ITERS, valid_sets=[dv_small], valid_names=["valid"],
        early_stopping_rounds=SMALL_EARLY_STOP, evals_result=lr_evals,
        verbose_eval=False, learning_rates=[0.1] * SMALL_ITERS)
    add_launches(total, launches)
    got = (lb.current_iteration(), lb.best_iteration, lb.digest())
    if got != (small["stop"], small["best"], small["digest"]):
        raise AssertionError(f"constant learning_rates (stop, best, "
                             f"digest) {got} is not phase 5's")
    a0, r = ENTRY_DECAY
    db, decay_s, launches = train_path(
        lgb, "small-data, decaying learning_rates", counters, TRAIN_CONF,
        ds_small, SMALL_ITERS, valid_sets=[dv_small], valid_names=["valid"],
        early_stopping_rounds=SMALL_EARLY_STOP, verbose_eval=False,
        learning_rates=lambda i: a0 * r ** i)
    need(launches, ("split_scan", "hist_route", "route_values"),
         "the learning_rates runs")
    add_launches(total, launches)
    vauc = binary_auc(dv_small.get_label(), db.predict(Xv))
    out.update(lr_constant_digest=lb.digest(include_scores=False),
               lr_decay_stop=db.current_iteration(),
               lr_decay_best=db.best_iteration, lr_decay_valid_auc=vauc)
    log(f"entry surface: constant learning_rates == phase 5 (stop "
        f"{got[0]}, best {got[1]}); decaying stops at "
        f"{db.current_iteration()}, best {db.best_iteration}, valid auc "
        f"{vauc:.5f}")
    del lb, db

    # 6. cv with phase 5's configuration: five stratified folds, each of
    # about 52,429 training rows (K6 on every fold), early stopping 10
    res, cv_s, launches = counted(counters, lambda: lgb.cv(
        dict(TRAIN_CONF), ds_small, num_boost_round=SMALL_ITERS,
        nfold=ENTRY_NFOLD, stratified=True, seed=0,
        early_stopping_rounds=SMALL_EARLY_STOP, device="cuda"))
    need(launches, ("split_scan", "hist_route", "route_values"), "cv")
    add_launches(total, launches)
    kept = len(res["auc-mean"])
    per_fold = []
    for tr_idx, va_idx in cv_folds(ds_small, TRAIN_CONF, nfold=ENTRY_NFOLD,
                                   seed=0):
        ev = {}
        train_path(lgb, "cv fold through lgb.train", counters, TRAIN_CONF,
                   ds_small.subset(np.sort(tr_idx)), kept,
                   valid_sets=[ds_small.subset(np.sort(va_idx))],
                   valid_names=["valid"], evals_result=ev,
                   verbose_eval=False)
        per_fold.append(ev["valid"])
    for metric in ("binary_logloss", "auc"):
        want = [float(np.mean(v)) for v in
                zip(*(f[metric] for f in per_fold))]
        if res[f"{metric}-mean"] != want:
            raise AssertionError(f"cv {metric}-mean is not the mean of the "
                                 f"folds' lgb.train runs")
    out.update(cv_s=cv_s, cv_kept_iterations=kept,
               cv_auc_mean=res["auc-mean"][-1],
               cv_auc_stdv=res["auc-stdv"][-1])
    log(f"entry surface: cv {cv_s:.3f} s, {kept} iterations kept, auc "
        f"{res['auc-mean'][-1]:.5f} +- {res['auc-stdv'][-1]:.5f}; every "
        f"mean == the folds' lgb.train runs")

    # 7. file input: phase 5's rows as CSV (a header, name: columns, a
    # .weight side file) and as libsvm
    tmp = tempfile.mkdtemp(prefix="lgbm_files_")
    try:
        out.update(file_phase(lgb, counters, total, tmp, small_rows,
                              small))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    phase_line("entry_surface", card, launches=total, **out)
    return total


def file_phase(lgb, counters, total, tmp, small_rows, small):
    """Phase 23's file input -> its figures."""
    import numpy as np
    from lightgbm_tpu_torch import native
    out = {}
    if not native.available():
        raise AssertionError("the native parser is not available")
    Xs, ys, Xv, yv = small_rows
    rng = np.random.RandomState(11)
    w = rng.uniform(0.5, 2.0, size=len(Xs))
    t0 = time.time()
    csv, csv_v = os.path.join(tmp, "train.csv"), os.path.join(tmp, "valid.csv")
    write_csv(csv, Xs, ys)
    write_csv(csv_v, Xv, yv)
    np.savetxt(csv + ".weight", w, fmt="%.17g")
    svm, svm_v = os.path.join(tmp, "train.svm"), os.path.join(tmp, "valid.svm")
    write_libsvm(svm, Xs, ys)
    write_libsvm(svm_v, Xv, yv)
    log(f"entry surface: files written in {time.time() - t0:.1f} s")
    kw = dict(valid_names=["valid"], early_stopping_rounds=SMALL_EARLY_STOP,
              verbose_eval=False)
    fparams = {"has_header": True, "label_column": "name:target"}
    dcsv = lgb.Dataset(csv, params=fparams)
    csv_b, csv_s, launches = train_path(
        lgb, "small-data from CSV + .weight", counters, TRAIN_CONF, dcsv,
        SMALL_ITERS, valid_sets=[lgb.Dataset(csv_v, reference=dcsv,
                                             params=fparams)], **kw)
    add_launches(total, launches)
    weighted = lgb.Dataset(Xs, label=ys, weight=np.float32(w),
                           params={"max_bin": TRAIN_CONF["max_bin"]})
    arr_b, _, launches = train_path(
        lgb, "small-data array with the same weights", counters, TRAIN_CONF,
        weighted, SMALL_ITERS,
        valid_sets=[lgb.Dataset(Xv, label=yv, reference=weighted)], **kw)
    add_launches(total, launches)
    if csv_b.digest() != arr_b.digest():
        raise AssertionError("the CSV model is not the weighted array "
                             "model")
    dsvm = lgb.Dataset(svm)
    svm_b, svm_s, launches = train_path(
        lgb, "small-data from libsvm", counters, TRAIN_CONF, dsvm,
        SMALL_ITERS, valid_sets=[lgb.Dataset(svm_v, reference=dsvm)], **kw)
    need(launches, ("split_scan", "hist_route", "route_values"),
         "the file-input runs")
    add_launches(total, launches)
    got = (svm_b.current_iteration(), svm_b.best_iteration, svm_b.digest())
    if got != (small["stop"], small["best"], small["digest"]):
        raise AssertionError(f"the libsvm model (stop, best, digest) {got} "
                             f"is not phase 5's")
    out.update(csv_digest=csv_b.digest(include_scores=False),
               csv_train_s=csv_s, libsvm_train_s=svm_s)
    log(f"entry surface: CSV + .weight == weighted array model, digest "
        f"{out['csv_digest'][:8]}; libsvm == phase 5")

    # the native parser's throughput: 1,048,576 rows x 28 columns
    big = os.path.join(tmp, "big.csv")
    body = os.path.join(tmp, "block.csv")
    np.savetxt(body, Xs.astype(np.float64), fmt="%.17g", delimiter=",")
    with open(body, "rb") as f:
        block = f.read()
    with open(big, "wb") as f:
        for _ in range(ENTRY_PARSE_REPEAT):
            f.write(block)
    nbytes = os.path.getsize(big)
    t0 = time.time()
    parsed = native.parse_delimited(big, ",", 0)
    secs = time.time() - t0
    rows = len(Xs) * ENTRY_PARSE_REPEAT
    if parsed is None or parsed.shape != (rows, Xs.shape[1]):
        raise AssertionError(f"native parse of the big CSV gave "
                             f"{None if parsed is None else parsed.shape}")
    if not (np.array_equal(parsed[:len(Xs)], Xs.astype(np.float64))
            and np.array_equal(parsed[-len(Xs):], Xs.astype(np.float64))):
        raise AssertionError("the native parse is not the written values")
    out.update(parse_rows=rows, parse_bytes=nbytes, parse_s=secs,
               parse_mb_per_s=nbytes / secs / 1e6,
               parse_rows_per_s=rows / secs)
    log(f"entry surface: native parse of {rows} x {Xs.shape[1]} "
        f"({nbytes / 1e6:.1f} MB) in {secs:.3f} s = "
        f"{out['parse_mb_per_s']:.1f} MB/s, {rows / secs:.0f} rows/s")
    return out


class IterClock:
    """A callback that synchronizes the card after every iteration and
    keeps the host clock: ``steady_ms`` is the mean of the iterations
    after the first (setup and the first tree's warm-up excluded)."""

    def __init__(self):
        self.t = [time.perf_counter()]

    def __call__(self, env):
        import torch
        torch.cuda.synchronize()
        self.t.append(time.perf_counter())

    @property
    def steady_ms(self) -> float:
        d = self.iter_ms()[1:]
        return sum(d) / max(1, len(d))

    def iter_ms(self) -> list:
        """Each iteration's milliseconds, the first included."""
        return [1e3 * (b - a) for a, b in zip(self.t, self.t[1:])]


def per_tree(launches: dict, trees: int) -> dict:
    return {k: round(v / max(1, trees), 3) for k, v in launches.items() if v}


def variant_path(lgb, name, counters, params, ds, X, y, rounds, **kw):
    """One variant through ``lgb.train`` on the headline rows ->
    ``(booster, fields)``: K1-K4 launched and K6 not, train AUC (the
    card's compiled prediction) >= ``AUC_GATE``, the compiled
    prediction within ``VARIANT_PRED_TOL`` of the host walk."""
    import numpy as np
    from lightgbm_tpu_torch.metric.metrics import binary_auc
    clock = IterClock()
    bst, seconds, launches = train_path(lgb, name, counters, params, ds,
                                        rounds, callbacks=[clock], **kw)
    need(launches, ("route", "route_values", "hist_route", "hist_compact"),
         name, absent=("split_scan",))
    pred = bst.predict(X)
    if pred.shape != (HEADLINE_ROWS,) or not np.isfinite(pred).all():
        raise AssertionError(f"{name}: predictions are not finite [n]")
    auc = binary_auc(y, pred)
    if not auc >= AUC_GATE:
        raise AssertionError(f"{name}: train auc {auc} < {AUC_GATE}")
    host = bst.predict(X[:SERVE_SAMPLE], device=False)
    gap = float(np.abs(pred[:SERVE_SAMPLE] - host).max())
    if not gap <= VARIANT_PRED_TOL:
        raise AssertionError(f"{name}: compiled prediction {gap} from the "
                             f"host walk")
    trees = bst.num_trees()
    fields = dict(iterations=bst.current_iteration(), auc=auc,
                  digest=bst.digest(include_scores=False),
                  wall_ms_per_iter=1e3 * seconds / max(1, rounds),
                  steady_ms_per_iter=clock.steady_ms,
                  launches_per_tree=per_tree(launches, trees),
                  served_vs_host=gap, launches=launches)
    log(f"{name}: auc {auc:.5f}, steady {clock.steady_ms:.2f} ms/iter, "
        f"digest {fields['digest'][:8]}, per tree "
        f"{fields['launches_per_tree']}, served - host {gap:.2e}")
    return bst, fields


def variants_phase(lgb, counters, ds, X, y, ds_small, dv_small, small_xy,
                   params, card: str) -> dict:
    """Phase 24: GOSS, DART (resumed too), DART in xgboost mode and a
    random forest on the headline, GOSS on the small-data path ->
    launches."""
    import numpy as np
    from lightgbm_tpu_torch.boosting.gbdt import GBDT
    from lightgbm_tpu_torch.metric.metrics import binary_auc
    total, out = {}, {}
    goss = dict(params, boosting="goss", **VARIANT_GOSS)
    _, out["goss"] = variant_path(lgb, "goss", counters, goss, ds, X, y,
                                  HEADLINE_ITERS)
    dart = dict(params, boosting="dart", **VARIANT_DART)
    with CallTimes(GBDT, "_replay_sum") as replay, \
            CallTimes(GBDT, "_to_host_tree") as to_host:
        bst, out["dart"] = variant_path(lgb, "dart", counters, dart, ds, X,
                                        y, HEADLINE_ITERS)
    out["dart"].update(
        replay_ms_per_iter=sum(replay.ms) / HEADLINE_ITERS,
        replay_calls=len(replay.ms),
        to_host_tree_ms_per_iter=sum(to_host.ms) / HEADLINE_ITERS)
    log(f"dart: replay of the dropped trees {sum(replay.ms):.1f} ms in "
        f"{len(replay.ms)} calls, host trees {sum(to_host.ms):.1f} ms "
        f"over {HEADLINE_ITERS} iterations")
    text = bst.model_to_string()
    tmp = tempfile.mkdtemp(prefix="lgbm_dart_")
    try:
        sp = dict(dart, snapshot_freq=VARIANT_DART_FREQ,
                  output_model=os.path.join(tmp, "dart.txt"))
        rb, both, writes, resume_ms, _ = killed_and_resumed(
            lgb, "dart", counters, sp, ds, HEADLINE_ITERS, 1,
            VARIANT_DART_FREQ)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if rb.model_to_string() != text:
        raise AssertionError("the resumed DART model text is not the "
                             "uninterrupted run's")
    if rb.digest() != bst.digest():
        raise AssertionError("the resumed DART digest (scores included) "
                             "is not the uninterrupted run's")
    out["dart"].update(resumed_identical=True, snapshot_write_ms=writes,
                       resume_ms=resume_ms)
    add_launches(total, both)
    log(f"dart: killed at {2 * VARIANT_DART_FREQ}, resumed from "
        f"{VARIANT_DART_FREQ}: model text byte-identical")
    xgb = dict(dart, xgboost_dart_mode=True)
    _, out["dart_xgboost"] = variant_path(lgb, "dart xgboost_dart_mode",
                                          counters, xgb, ds, X, y,
                                          VARIANT_XGB_ITERS)
    rf = dict(params, boosting="rf", **VARIANT_RF)
    _, out["rf"] = variant_path(lgb, "rf", counters, rf, ds, X, y,
                                HEADLINE_ITERS)
    for f in out.values():
        add_launches(total, f.pop("launches"))
    evals = {}
    clock = IterClock()
    sb, _, small = train_path(
        lgb, "goss small-data", counters, dict(TRAIN_CONF, boosting="goss",
                                               **VARIANT_GOSS),
        ds_small, SMALL_ITERS, valid_sets=[dv_small], valid_names=["valid"],
        early_stopping_rounds=SMALL_EARLY_STOP, evals_result=evals,
        verbose_eval=False, callbacks=[clock])
    need(small, ("split_scan", "hist_route", "route_values"),
         "goss small-data")
    _, _, Xv, yv = small_xy
    vauc = binary_auc(yv, sb.predict(Xv))
    if not vauc >= VALID_AUC_GATE:
        raise AssertionError(f"goss small-data valid auc {vauc}")
    add_launches(total, small)
    out["goss_small"] = dict(stop=sb.current_iteration(),
                             best=sb.best_iteration, valid_auc=vauc,
                             steady_ms_per_iter=clock.steady_ms,
                             launches_per_tree=per_tree(small,
                                                        sb.num_trees()))
    log(f"goss small-data: stop {sb.current_iteration()}, best "
        f"{sb.best_iteration}, valid auc {vauc:.5f}, steady "
        f"{clock.steady_ms:.2f} ms/iter")
    phase_line("variants", card, **out)
    PATH_DIGESTS["dart"] = out["dart"]["digest"]
    return total


def wide_hist_case(dd, L: int, A: int, gen, skew: bool, bag: float = 0.8):
    """A wave of the wide histogram on ``dd``: hist leaves over ``2 A``
    leaves (``skew``: every row in leaf 0, the root wave), bagged-out
    rows at -1, ``A`` slots two of them -1 (the root wave: one live);
    gradients over eight decades."""
    import torch
    dev = dd.device
    n, n_pad = dd.num_data, dd.n_pad
    live = min(L, 2 * A)
    leaf = (torch.zeros(n, dtype=torch.int32, device=dev) if skew else
            torch.randint(0, live, (n,), generator=gen, device=dev).int())
    hl = torch.full((n_pad,), -1, dtype=torch.int32, device=dev)
    keep = torch.rand(n, generator=gen, device=dev) < bag
    hl[:n] = torch.where(keep, leaf, -1)
    active = torch.full((A,), -1, dtype=torch.int32, device=dev)
    if skew:
        active[0] = 0
    else:
        active[:A - 2] = torch.randperm(live, generator=gen,
                                        device=dev)[:A - 2].int()
    mag = 10.0 ** (torch.rand(n, generator=gen, device=dev) * 8 - 5)
    g = (torch.randn(n, generator=gen, device=dev) * mag).float()
    h = (torch.rand(n, generator=gen, device=dev) * mag).float()
    return g, h, hl, active


def synthetic_bins(dd, max_bin: int, gen):
    """``dd``'s rows with uniform int32 bins in ``[0, max_bin)`` in each of
    its columns (binning real data to ``max_bin`` 65535 would cost most
    of the phase), as the fields :func:`wide_hist_measure` reads."""
    import torch
    bins_t = torch.zeros(dd.bins_t.shape, dtype=torch.int32,
                         device=dd.device)
    bins_t[:, :dd.num_data] = torch.randint(
        0, max_bin, (bins_t.shape[0], dd.num_data), generator=gen,
        device=dd.device, dtype=torch.int32)
    return types.SimpleNamespace(bins_t=bins_t, group_max_bins=max_bin,
                                 num_data=dd.num_data, n_pad=dd.n_pad,
                                 device=dd.device)


def wide_hist_measure(dd, L: int, A: int, gen, skew: bool) -> dict:
    """The wide histogram on one wave: the kernel bitwise its plain
    version on CPU copies, its time, the plain version's (CPU), an f32
    ``index_add_`` of the same (cell, column) updates on the card, and
    the bound: each active row's bins and two values read once, every
    hist leaf read once, the histogram written once."""
    import torch
    from lightgbm_tpu_torch.ops.histogram import (bin_stride,
                                                  hist_wide_cost,
                                                  hist_wide_launch,
                                                  hist_wide_raw, slot_tables,
                                                  wide_cells)
    g, h, hl, active = wide_hist_case(dd, L, A, gen, skew)
    mb = dd.group_max_bins
    B = bin_stride(mb)
    G = dd.bins_t.shape[0]
    n = dd.num_data
    got = hist_wide_raw(dd.bins_t, g, h, hl, active, L, mb)
    cpu = [t.cpu() for t in (dd.bins_t, g, h, hl, active)]
    t0 = time.perf_counter()
    ref = hist_wide_raw(*cpu, L, mb)
    plain_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    if not torch.equal(got.cpu().view(torch.int32), ref.view(torch.int32)):
        raise AssertionError(f"wide histogram != plain (A={A}, B={B}, "
                             f"{dd.bins_t.dtype})")
    ms = time_ms(lambda: hist_wide_raw(dd.bins_t, g, h, hl, active, L, mb),
                 10)
    out = torch.empty_like(got)
    inv = slot_tables(active, L, collect_unbagged=False)[0]
    gms = graph_ms(lambda: hist_wide_launch(dd.bins_t, g, h, hl, inv, L, B,
                                            out), 10, 3)
    del got, ref, out
    rows, cells = wide_cells(dd.bins_t, hl, active, n, L, B)
    vals = torch.stack([g[rows], h[rows], torch.ones_like(g[rows])], -1)
    vals = vals[:, None, :].expand(-1, G, -1).reshape(-1, 3).contiguous()
    acc = torch.zeros((A * G * B, 3), dtype=torch.float32, device=dd.device)
    lib_ms = time_ms(lambda: acc.index_add_(0, cells, vals), 10)
    r = int(rows.numel())
    bd = bound(*hist_wide_cost(dd.bins_t, A, B, r, False)[:2],
               FP32_OPS_PER_S)
    log(f"kernel hist_wide {dd.bins_t.dtype} A={A} B={B} G={G} "
        f"({'root' if skew else 'mid-tree'} wave, {r} active rows): "
        f"bitwise ok, {ms:.4f} ms, in a graph {gms:.4f} ms (plain "
        f"{plain_ms:.1f} ms on the CPU, "
        f"index_add_ {lib_ms:.4f} ms, bound {bd['bound_ms']:.4f} ms by "
        f"{bd['bound_by']})")
    return dict(slots=A, bin_stride=B, bins=str(dd.bins_t.dtype),
                wave="root" if skew else "mid-tree", active_rows=r, ms=ms,
                graph_ms=gms, plain_ms=plain_ms, library_ms=lib_ms, **bd)


def wide_dataset(lgb, X, y):
    """The headline rows binned at ``WIDE_MAX_BIN`` (phases 25 and 26)."""
    t0 = time.time()
    dsw = lgb.Dataset(X, label=y, params={"max_bin": WIDE_MAX_BIN})
    dsw.construct()
    log(f"wide: binning at max_bin {WIDE_MAX_BIN} {time.time() - t0:.1f} s")
    return dsw


def wide_phase(lgb, counters, X, y, ds, dsw, params, card: str,
               entries: list, dev="cuda") -> dict:
    """Phase 25: the wide histogram, K2/K4 on int32 bins and K2/K4 at
    2,048 leaves against their plain versions, then ``lgb.train`` at
    ``max_bin`` 1023 (``dsw``) and at 2,048 leaves -> launches."""
    import numpy as np
    import torch
    from lightgbm_tpu_torch.io.device import to_device
    from lightgbm_tpu_torch.metric.metrics import binary_auc
    from lightgbm_tpu_torch.ops import cuda_build
    from lightgbm_tpu_torch.serve import compile_model
    ddw = to_device(dsw._constructed, dev)
    if ddw.bins_t.dtype != torch.int32 or ddw.group_max_bins <= 256:
        raise AssertionError("max_bin 1023 did not give int32 bins past "
                             "256 bins")
    dd = to_device(ds._constructed, dev)
    int_rate = int32_ops_per_s(cuda_build.multiprocessor_count(dd.device))
    gen = torch.Generator(device=dev)
    gen.manual_seed(25)
    rows = [wide_hist_measure(ddw, 255, 128, gen, True),
            wide_hist_measure(ddw, 255, 128, gen, False),
            wide_hist_measure(dd, WIDE_DEEP_LEAVES, 1024, gen, True),
            wide_hist_measure(dd, WIDE_DEEP_LEAVES, 1024, gen, False),
            wide_hist_measure(synthetic_bins(dd, WIDEST_MAX_BIN, gen), 15,
                              8, gen, False),
            wide_hist_measure(dd, WIDEST_LEAVES, WIDEST_LEAVES // 2, gen,
                              False)]
    entries.append(_widest(dict(
        name="hist_wide", route="cuda",
        source="lightgbm_tpu_torch/csrc/hist_wide.cu",
        replaces="lightgbm_tpu/ops/pallas_histogram.py:588 (XLA scatter "
                 "hist_active_scatter; no Pallas kernel)",
        max_abs_err=0.0),
        [rows[0], rows[2], rows[3], rows[1], rows[4], rows[5]]))
    leaf2, tabs, cat, _ = wave_inputs(ddw, 127, 64, 128, gen)
    entries.append(dict(
        name="route_i32", route="cuda",
        source="lightgbm_tpu_torch/csrc/route.cu",
        replaces="lightgbm_tpu/ops/pallas_route.py:360 (route_rows_xla)",
        max_abs_err=0.0, **k2_measure(ddw, leaf2, tabs, cat, int_rate)))
    lv = torch.randn(255, generator=gen, device=dev)
    entries.append(dict(
        name="route_values_i32", route="cuda",
        source="lightgbm_tpu_torch/csrc/route.cu",
        replaces="lightgbm_tpu/ops/pallas_route.py:168",
        max_abs_err=0.0, **k4_measure(ddw, leaf2, tabs, cat, lv, int_rate)))
    # K2/K4 on uint8 bins at the deep path's own tables: 2,048 leaves (the
    # staged layout past 48 KB of shared memory), an early wave of 64
    # splits and the last wave of 1,024; and the last wave of a
    # 131,072-leaf tree, 65,536 splits (the global layout)
    Ld, half = WIDE_DEEP_LEAVES, WIDE_DEEP_LEAVES // 2
    Lw, half_w = WIDEST_LEAVES, WIDEST_LEAVES // 2
    deep = {"route": [], "route_values": []}
    for L, nl in ((Ld, 64), (Ld, half), (Lw, half_w)):
        leaf2, tabs, cat, _ = wave_inputs(dd, nl, nl, min(nl, half), gen, L)
        deep["route"].append(dict(leaves=L, split_leaves=nl, **k2_measure(
            dd, leaf2, tabs, cat, int_rate)))
        if nl > 64:
            lv = torch.randn(L, generator=gen, device=dev)
            deep["route_values"].append(dict(
                leaves=L, split_leaves=nl,
                **k4_measure(dd, leaf2, tabs, cat, lv, int_rate)))
    for e in entries:
        if e["name"] in deep:
            e["deep"] = deep[e["name"]]
    log(f"K2/K4 at {Ld} and {Lw} leaves on uint8 bins: bitwise ok")
    del dd, ddw
    total, out = {}, {}
    for name, p, data, need_k, absent in (
            ("wide", dict(params, max_bin=WIDE_MAX_BIN), dsw,
             ("hist_wide", "route_i32", "route_values_i32"),
             ("hist_route", "hist_compact", "route", "route_values")),
            ("deep", dict(params, num_leaves=WIDE_DEEP_LEAVES), ds,
             ("hist_wide", "route", "route_values"),
             ("hist_route", "hist_compact", "route_i32"))):
        clock = IterClock()
        bst, seconds, launches = train_path(
            lgb, f"{name} ({p['max_bin']} bins, {p['num_leaves']} leaves)",
            counters, p, data, WIDE_ITERS, callbacks=[clock])
        need(launches, need_k, name, absent=absent)
        pred = bst.predict(X)
        auc = binary_auc(y, pred)
        if not auc >= AUC_GATE or not np.isfinite(pred).all():
            raise AssertionError(f"{name}: train auc {auc}")
        nl = max(t.num_leaves for t in bst._gbdt.models)
        out[name] = dict(auc=auc, steady_ms_per_iter=clock.steady_ms,
                         wall_ms_per_iter=1e3 * seconds / WIDE_ITERS,
                         max_leaves=nl,
                         digest=bst.digest(include_scores=False),
                         launches_per_tree=per_tree(launches,
                                                    bst.num_trees()))
        add_launches(total, launches)
        log(f"{name}: auc {auc:.5f}, steady {clock.steady_ms:.2f} ms/iter, "
            f"largest tree {nl} leaves, per tree "
            f"{out[name]['launches_per_tree']}")
        if name == "wide":
            cm = compile_model(bst)
            Xs = X[:SERVE_SAMPLE]
            bins = cm.bin_rows(Xs)
            if bins.dtype != np.int32 or bins.max() <= 255:
                raise AssertionError("wide serving did not bin to int32")
            if not (np.array_equal(cm.leaf_indices(bins, binned=True),
                                   cm.leaf_indices(Xs))
                    and np.array_equal(cm.predict_raw(bins, binned=True),
                                       cm.predict_raw(Xs))):
                raise AssertionError("wide serving: binned != raw")
        del bst
    phase_line("wide", card, kernels=rows, deep_routes=deep, **out)
    PATH_DIGESTS["wide"] = out["wide"]["digest"]
    return total


def wide_seeded_measure(dd, L: int, A: int, gen) -> dict:
    """The seeded wide histogram on one wave: a previous block's rows
    make the carry (the unseeded kernel), this block's rows add into it;
    bitwise its plain version on CPU copies (bit patterns), timed back to
    back, in a CUDA graph beside the unseeded launch, beside a seeded f32
    ``index_add_`` of the same updates, and its bound: the unseeded
    traffic with the carry read and written once."""
    import torch
    from lightgbm_tpu_torch.ops.histogram import (bin_stride,
                                                  hist_wide_cost,
                                                  hist_wide_launch,
                                                  hist_wide_raw, slot_tables,
                                                  wide_cells)
    g0, h0, hl0, active = wide_hist_case(dd, L, A, gen, False)
    g, h, hl, _ = wide_hist_case(dd, L, A, gen, False)
    mb = dd.group_max_bins
    B = bin_stride(mb)
    G = dd.bins_t.shape[0]
    n = dd.num_data
    carry = hist_wide_raw(dd.bins_t, g0, h0, hl0, active, L, mb)
    if not bool((carry != 0).any()):
        raise AssertionError("the carry of the seeded check is zero")
    got = hist_wide_raw(dd.bins_t, g, h, hl, active, L, mb,
                        acc=carry.clone())
    cpu = [t.cpu() for t in (dd.bins_t, g, h, hl, active)]
    t0 = time.perf_counter()
    ref = hist_wide_raw(*cpu, L, mb, acc=carry.cpu())
    plain_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    if not bits_equal(got.cpu(), ref):
        raise AssertionError(f"seeded wide histogram != plain (A={A}, "
                             f"B={B}, {dd.bins_t.dtype})")
    acc = carry.clone()
    ms = time_ms(lambda: hist_wide_raw(dd.bins_t, g, h, hl, active, L, mb,
                                       acc=acc), 10)
    inv = slot_tables(active, L, collect_unbagged=False)[0]
    gms = graph_ms(lambda: hist_wide_launch(dd.bins_t, g, h, hl, inv, L, B,
                                            acc, seeded=True), 10, 3)
    out = torch.empty_like(carry)
    unseeded_gms = graph_ms(lambda: hist_wide_launch(
        dd.bins_t, g, h, hl, inv, L, B, out), 10, 3)
    del got, ref, out
    rows, cells = wide_cells(dd.bins_t, hl, active, n, L, B)
    vals = torch.stack([g[rows], h[rows], torch.ones_like(g[rows])], -1)
    vals = vals[:, None, :].expand(-1, G, -1).reshape(-1, 3).contiguous()
    flat = carry.reshape(A * G * B, 3).clone()
    lib_ms = time_ms(lambda: flat.index_add_(0, cells, vals), 10)
    r = int(rows.numel())
    bd = bound(*hist_wide_cost(dd.bins_t, A, B, r, True)[:2],
               FP32_OPS_PER_S)
    log(f"kernel hist_wide seeded {dd.bins_t.dtype} A={A} B={B} G={G} "
        f"({r} active rows, nonzero carry): bitwise ok, {ms:.4f} ms, in a "
        f"graph {gms:.4f} ms (unseeded {unseeded_gms:.4f} ms; plain "
        f"{plain_ms:.1f} ms on the CPU, seeded index_add_ {lib_ms:.4f} ms, "
        f"bound {bd['bound_ms']:.4f} ms by {bd['bound_by']})")
    return dict(slots=A, bin_stride=B, bins=str(dd.bins_t.dtype),
                active_rows=r, ms=ms, graph_ms=gms,
                unseeded_graph_ms=unseeded_gms, plain_ms=plain_ms,
                library_ms=lib_ms, max_abs_err=0.0, **bd)


def sparse_libsvm(path: str, X, y, zero: float, seed: int):
    """``X`` with a ``zero`` share of its values set to 0 and those left
    out of the file, ``%.17g`` (exact): -> the matrix written."""
    import numpy as np
    X = X.copy()
    X[np.random.RandomState(seed).uniform(size=X.shape) < zero] = 0.0
    with open(path, "w") as f:
        # Python floats' repr is the shortest string that reads back
        # exactly
        for yi, row in zip(y.tolist(), X.tolist()):
            f.write(repr(yi) + " " + " ".join(
                f"{j}:{v!r}" for j, v in enumerate(row) if v != 0.0)
                + "\n")
    return X


def trace_records(path: str) -> list:
    """The JSONL trace at ``path``, every record checked for the schema's
    keys."""
    with open(path) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    for r in recs:
        for k in ("ts", "kind", "name", "rank"):
            if k not in r:
                raise AssertionError(f"trace record without {k}: {r}")
        if r["kind"] == "span" and not (r["dur_s"] >= 0 and "parent" in r
                                        and r["depth"] >= 0):
            raise AssertionError(f"bad span record: {r}")
    return recs


def wide_stream_phase(lgb, counters, ds, dsw, head_ref, card: str,
                      entries: list) -> dict:
    """Phase 26: the seeded wide histogram at three shapes, the wide and
    deep streams against in memory, rows-independent memory, a libsvm
    stream and the stream seams, telemetry on the headline and a wide
    stream -> launches per path."""
    import numpy as np
    import torch
    from lightgbm_tpu_torch import obs
    from lightgbm_tpu_torch.boosting.gbdt import GBDT
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.io.device import to_device
    dd = to_device(ds._constructed, "cuda")
    ddw = to_device(dsw._constructed, "cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(26)
    seeded = [wide_seeded_measure(ddw, 255, 128, gen),
              wide_seeded_measure(dd, WIDE_DEEP_LEAVES, 1024, gen),
              wide_seeded_measure(synthetic_bins(dd, WIDEST_MAX_BIN, gen),
                                  15, 8, gen)]
    for e in entries:
        if e["name"] == "hist_wide":
            e["seeded"] = _widest(dict(
                name="hist_wide_seeded", route="cuda",
                source="lightgbm_tpu_torch/csrc/hist_wide.cu",
                replaces="lightgbm_tpu/boosting/streaming.py:420 (the "
                         "seeded XLA scatter StreamTrainer._hist_into; no "
                         "Pallas kernel)"), seeded)
    del dd, ddw
    torch.cuda.empty_cache()

    oc = lgb.outofcore
    tmp = tempfile.mkdtemp(prefix="lgbm_wide_stream_")
    launches, out = {}, {}
    try:
        def stream(name, params, store, trace=None, **kw):
            p = dict(params, telemetry_output=trace) if trace else params
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            bst, wall, got = counted(counters, lambda: lgb.train_streaming(
                p, store, num_boost_round=WS_ITERS, device="cuda", **kw))
            peak = torch.cuda.max_memory_allocated()
            rate = store.n * WS_ITERS / wall
            log(f"{name}: {store.n} rows x {WS_ITERS} iterations in "
                f"{wall:.3f} s = {rate:.4g} rows x iterations/s, peak "
                f"device memory {peak / 2**20:.1f} MiB; launches {got} "
                f"[{card}]")
            add_launches(launches, got)
            out[name] = dict(rows=store.n, wall_s=wall,
                             rows_iter_per_s=rate, peak_bytes=peak,
                             digest=bst.digest())
            return bst, got

        def in_memory(store, params):
            cfg = Config.from_params(params)
            mem = GBDT(cfg, store.to_binned_dataset(cfg), "cuda")
            for _ in range(WS_ITERS):
                mem.train_one_iter()
            torch.cuda.synchronize()
            return mem.digest()

        wide_p = dict(HEADLINE_PARAMS, max_bin=WIDE_MAX_BIN)
        deep_p = dict(HEADLINE_PARAMS, num_leaves=WIDE_DEEP_LEAVES)
        trace = os.path.join(tmp, "stream_trace.jsonl")
        for name, p, k2 in (("wide", wide_p, ("route_i32",
                                              "route_values_i32")),
                            ("deep", deep_p, ("route", "route_values"))):
            t0 = time.time()
            store = oc.ingest_synthetic(
                os.path.join(tmp, name), WS_ROWS, STREAM_FEATURES,
                Config.from_params(p), seed=26, shard_rows=WS_ROWS)
            nb = max(m.num_bin for m in store.mappers)
            log(f"{name} stream: ingest {time.time() - t0:.1f} s, "
                f"{store.dtype} bins, {nb} bins a column at most")
            bst, got = stream(f"{name} stream", p, store,
                              trace=trace if name == "wide" else None)
            if name == "wide":
                obs.reset()
            need(got, ("hist_wide_seeded",) + k2, f"the {name} stream",
                 absent=("hist_route", "hist_compact", "hist_active",
                         "hist_float", "hist_wide"))
            d_mem = in_memory(store, p)
            log(f"{name} stream: streamed {bst.digest()} in memory {d_mem}")
            if bst.digest() != d_mem:
                raise AssertionError(f"{name} stream digest != in memory")
            del bst
            if name == "wide":
                recs = trace_records(trace)
                names = {r["name"] for r in recs}
                lost = [k for k in STREAM_SPANS + STREAM_COUNTERS
                        if k not in names]
                if lost:
                    raise AssertionError(f"stream trace lacks {lost}")
                small = out["wide stream"]["peak_bytes"]
                store = oc.ingest_synthetic(
                    os.path.join(tmp, "wide_big"), WS_BIG_ROWS,
                    STREAM_FEATURES, Config.from_params(p), seed=27,
                    shard_rows=WS_BIG_ROWS // 4)
                stream("wide stream 8M", p, store)
                big = out["wide stream 8M"]["peak_bytes"]
                log(f"wide stream peak memory: {big / 2**20:.1f} MiB at "
                    f"{WS_BIG_ROWS} rows, {small / 2**20:.1f} MiB at "
                    f"{WS_ROWS}")
                if abs(big - small) > WS_PEAK_SHARE * small:
                    raise AssertionError("the wide stream's peak memory "
                                         "grew with its rows")
            shutil.rmtree(os.path.join(tmp, name), ignore_errors=True)
        shutil.rmtree(os.path.join(tmp, "wide_big"), ignore_errors=True)

        # a libsvm file of the headline generator, a quarter of the
        # values zero and left out: streamed == lgb.train(Dataset(path)),
        # and the same with the seams set
        X, z = headline_latent(seed=26)
        X, y = X[:WS_LIBSVM_ROWS], (z[:WS_LIBSVM_ROWS] > 0).astype(
            np.float32)
        path = os.path.join(tmp, "train.svm")
        t0 = time.time()
        sparse_libsvm(path, X, y, WS_LIBSVM_ZERO, 26)
        log(f"libsvm: {WS_LIBSVM_ROWS} rows written in "
            f"{time.time() - t0:.1f} s")
        bst, _, got = counted(counters, lambda: lgb.train(
            dict(STREAM_PARAMS), lgb.Dataset(path),
            num_boost_round=WS_ITERS, device="cuda"))
        d_file = bst.digest()
        cache = os.path.join(tmp, "svm_cache")
        digests = {}
        for name, env in (("libsvm stream", {}),
                          ("libsvm stream, seams",
                           {"LGBM_TPU_STREAM_ROWS": str(WS_LIBSVM_BLOCK),
                            "LGBM_TPU_STREAM_PIPELINE": "0"})):
            saved = {k: os.environ.get(k) for k in
                     ("LGBM_TPU_STREAM_ROWS", "LGBM_TPU_STREAM_PIPELINE",
                      "LGBM_TPU_STREAM_CACHE")}
            os.environ.update(env, LGBM_TPU_STREAM_CACHE=cache)
            try:
                t0 = time.time()
                b, got = counted(counters, lambda: lgb.train_streaming(
                    dict(STREAM_PARAMS), [path], num_boost_round=WS_ITERS,
                    device="cuda"))[0::2]
                wall = time.time() - t0
            finally:
                for k, v in saved.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v
            digests[name] = b.digest()
            add_launches(launches, got)
            log(f"{name}: {wall:.3f} s (ingest included on the first), "
                f"digest {digests[name]}; launches {got}")
        if not os.path.exists(os.path.join(cache, oc.MANIFEST)):
            raise AssertionError("LGBM_TPU_STREAM_CACHE did not place the "
                                 "store")
        log(f"libsvm: lgb.train(Dataset(path)) {d_file}")
        if set(digests.values()) != {d_file}:
            raise AssertionError(f"libsvm stream digests {digests} != "
                                 f"in memory {d_file}")
        out["libsvm"] = dict(digest=d_file, **digests)
        del bst, b

        # telemetry on the headline: off and on in turns, in one call
        # (the host clock's spread between runs is milliseconds an
        # iteration)
        steady, head_trace = {}, os.path.join(tmp, "head_trace.jsonl")
        for name in ("off", "on", "off again", "on again"):
            clock = IterClock()
            p = dict(head_ref["params"])
            if name.startswith("on"):
                p["telemetry_output"] = head_trace
            bst, _, got = train_path(lgb, f"headline, telemetry {name}",
                                     counters, p, ds, HEADLINE_ITERS,
                                     callbacks=[clock])
            steady[name] = clock.steady_ms
            d = bst.digest(include_scores=False)
            if bst.digest() != head_ref["digest"]:
                raise AssertionError(f"headline digest, telemetry {name}: "
                                     f"{d} != phase 4's")
            if not d.startswith(HEADLINE_DIGEST):
                raise AssertionError(f"headline digest {d} is not "
                                     f"{HEADLINE_DIGEST}...")
            if name == "on":
                bst.model_to_string()      # the host trees, traced too
                obs.reset()
                recs = trace_records(head_trace)
                names = {r["name"] for r in recs if r["kind"] == "span"}
                lost = [k for k in TELEMETRY_SPANS if k not in names]
                if lost:
                    raise AssertionError(f"headline trace lacks {lost}")
                out["headline_trace_records"] = len(recs)
                os.remove(head_trace)
            obs.reset()
            del bst
        off = (steady["off"], steady["off again"])
        on = (steady["on"], steady["on again"])
        spread = max(off) - min(off)
        overhead = sum(on) / 2 - sum(off) / 2
        log(f"headline steady ms/iter: telemetry off {off[0]:.2f} / "
            f"{off[1]:.2f} (spread {spread:.2f}), on {on[0]:.2f} / "
            f"{on[1]:.2f} (mean overhead {overhead:.2f} ms/iter); "
            f"{out['headline_trace_records']} trace records [{card}]")
        out["headline_steady_ms"] = dict(steady, off_spread=spread,
                                         on_spread=max(on) - min(on),
                                         overhead=overhead)
    finally:
        obs.reset()
        shutil.rmtree(tmp, ignore_errors=True)
    phase_line("wide_stream", card, seeded=seeded, **out)
    return launches


# phase 27: the runtime contracts and the live health plane
OBS_PROFILE = {"LGBM_TPU_PROFILE_WINDOWS": "2", "LGBM_TPU_PROFILE_ITERS": "4"}
OBS_FAULT_ITERS = 8
OBS_STALL_S = "2"
OBS_DART_DRIFT = {"boosting": "dart", "drop_rate": 0.5, "skip_drop": 0.0}
OBS_QPS = 5_000.0
OBS_COST_RUNS = 32           # plane-toggled headline runs: 480 pairs
OBS_COST_BOUND_MS = 2.0      # the held median of on - off, ms/iter
# every switch of the contracts: unset before and after each run
OBS_SWITCHES = ("LGBM_TPU_PROFILE", "LGBM_TPU_PROFILE_WINDOWS",
                "LGBM_TPU_PROFILE_ITERS", "LGBM_TPU_WATCHDOG_S",
                "LGBM_TPU_SENTINELS", "LGBM_TPU_OPS_PORT",
                "LGBM_TPU_MEM_CONTRACT", "LGBM_TPU_TRACE_CONTRACT",
                "LGBM_TPU_NUM_CONTRACT", "LGBM_TPU_DETERMINISM",
                "LGBM_TPU_FORENSIC")


class obs_env:
    """``with obs_env(LGBM_TPU_...="1"):`` — exactly these switches set,
    every other contract switch unset; the health plane, ops plane,
    faults and telemetry are reset on the way in and out."""

    def __init__(self, **env):
        self.env = env

    def _clean(self):
        from lightgbm_tpu_torch import obs
        from lightgbm_tpu_torch.obs import health, ops_plane
        from lightgbm_tpu_torch.utils import faults
        faults.clear()
        ops_plane.shutdown()
        health._set_active(False)
        obs.reset()
        for k in OBS_SWITCHES:
            os.environ.pop(k, None)

    def __enter__(self):
        self._clean()
        os.environ.update({k: str(v) for k, v in self.env.items()})
        return self

    def __exit__(self, *exc):
        self._clean()
        return False


def http_get(port: int, path: str):
    """-> ``(status, body)`` of a GET on the local ops plane."""
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=30) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def profiled_path(lgb, name, counters, params, ds, rounds, ref: str,
                  include_scores: bool, total: dict) -> dict:
    """One path under ``LGBM_TPU_PROFILE`` (a warmup iteration, then 2
    windows of 4): its digest must be ``ref``, its report must carry no
    error and attribute a port kernel to a ``tree.*`` span.  The same
    path runs first unprofiled under :class:`IterClock`: the idle share
    is one less the profiled device time (the profiler's own
    ``profile.cost`` work left out) over that run's wall of the same
    iterations; the profiled window's share, stretched by the
    profiler's host work, is an upper bound beside it."""
    from lightgbm_tpu_torch import obs
    with obs_env():
        clock = IterClock()
        bst, _, launches = train_path(lgb, f"{name} unprofiled", counters,
                                      params, ds, rounds, callbacks=[clock])
    add_launches(total, launches)
    if bst.digest(include_scores=include_scores) != ref:
        raise AssertionError(f"{name}: the unprofiled run is another model")
    windows = (int(OBS_PROFILE["LGBM_TPU_PROFILE_WINDOWS"])
               * int(OBS_PROFILE["LGBM_TPU_PROFILE_ITERS"]))
    captured = clock.iter_ms()[1:1 + windows]     # after the warmup one
    tmp = tempfile.mkdtemp(prefix="lgbm_profile_")
    try:
        with obs_env(LGBM_TPU_PROFILE=tmp, **OBS_PROFILE):
            bst, seconds, launches = train_path(lgb, f"{name} profiled",
                                                counters, params, ds, rounds)
            rep = obs.summary().get("device_attribution") or {
                "error": "no device_attribution section"}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    add_launches(total, launches)
    if rep.get("error"):
        raise AssertionError(f"{name}: device attribution: {rep['error']}")
    digest = bst.digest(include_scores=include_scores)
    if digest != ref:
        raise AssertionError(f"{name}: the profiled digest {digest[:8]} is "
                             f"not the unprofiled {ref[:8]}")
    kspans = rep["kernel_spans"]
    on_tree = sorted(k for k, sp in kspans.items()
                     if any(s and s.startswith("tree.") for s in sp))
    if not on_tree:
        raise AssertionError(f"{name}: no port kernel attributed to a "
                             f"tree.* span: {kspans}")
    kernels = [{k: r.get(k) for k in ("kernel", "launches", "device_s",
                                      "bytes_accessed", "flops",
                                      "pct_peak_bw", "pct_peak_flops",
                                      "bound")}
               for r in rep["cost_model"]["kernels"]]
    share = (rep["host_gap_s"] / rep["window_wall_s"]
             if rep["window_wall_s"] else None)
    profile_cost_s = rep["spans"].get("profile.cost", {}).get("device_s",
                                                               0.0)
    work_s = rep["device_busy_s"] - profile_cost_s
    unprofiled_s = 1e-3 * sum(captured)
    idle = 1.0 - work_s / unprofiled_s
    out = dict(digest=digest[:8], wall_s=seconds,
               device_time_s=rep["device_time_s"],
               device_busy_s=rep["device_busy_s"],
               profile_cost_device_s=profile_cost_s,
               captured_iterations=len(captured),
               unprofiled_wall_s=unprofiled_s, idle_share=idle,
               capture_wall_s=rep["capture_wall_s"],
               window_wall_s=rep["window_wall_s"],
               host_gap_s=rep["host_gap_s"],
               profiled_idle_share_bound=share,
               coverage=rep["coverage"],
               spans={k: v["device_s"] for k, v in rep["spans"].items()},
               kernels=kernels, kernel_spans=kspans,
               top_programs=rep["top_programs"],
               peaks=rep["cost_model"]["peaks"])
    log(f"{name} profiled: digest held, device {rep['device_time_s']:.4f} s "
        f"({work_s:.4f} s without the profiler's own) against "
        f"{unprofiled_s:.4f} s unprofiled over the same "
        f"{len(captured)} iterations: idle {100 * idle:.1f}% (profiled "
        f"window {rep['window_wall_s']:.4f} s, host gap "
        f"{rep['host_gap_s']:.4f} s, {100 * (share or 0):.1f}%); spans "
        f"{out['spans']}; kernels {kernels}")
    return out


def contracts_path(lgb, counters, ds, head_ref, total: dict) -> dict:
    """The headline with every contract on, twice: no memory violation,
    no steady compile event, the digest held, equal digest ledgers."""
    from lightgbm_tpu_torch import obs
    from lightgbm_tpu_torch.obs import determinism, health, ops_plane
    params = dict(HEADLINE_PARAMS)
    on = dict(LGBM_TPU_OPS_PORT="0", LGBM_TPU_MEM_CONTRACT="1",
              LGBM_TPU_TRACE_CONTRACT="1", LGBM_TPU_NUM_CONTRACT="1",
              LGBM_TPU_DETERMINISM="1")
    runs = []
    for turn in range(2):
        with obs_env(**on):
            bst, seconds, launches = train_path(
                lgb, f"headline, every contract on ({turn + 1})", counters,
                params, ds, HEADLINE_ITERS)
            add_launches(total, launches)
            s = obs.summary()
            code, body = http_get(ops_plane.plane().port, "/healthz")
            runs.append(dict(
                digest=bst.digest(), seconds=seconds, summary=s,
                healthz=(code, json.loads(body)["state"]),
                state=health.state()["state"]))
    for r in runs:
        s = r["summary"]
        mem, tc = s["mem_contract"], s["trace_contract"]
        if r["digest"] != head_ref["digest"]:
            raise AssertionError("the headline with the contracts on is "
                                 "another model")
        if mem["violation_count"] or not mem["inplace_ok"]:
            raise AssertionError(f"memory contract: {mem}")
        if tc["compiles_steady"]:
            raise AssertionError(f"trace contract: {tc}")
        if r["healthz"] != (200, "ready") or s["numerics"]["trips"]:
            raise AssertionError(f"health {r['healthz']}, numerics "
                                 f"{s['numerics']['trips']}")
    l1 = runs[0]["summary"]["determinism"]["digests"]
    l2 = runs[1]["summary"]["determinism"]["digests"]
    div = determinism.first_divergence(l1, l2)
    if div is not None or len(l1) != HEADLINE_ITERS:
        raise AssertionError(f"window-digest ledgers differ at {div}")
    s = runs[0]["summary"]
    drifts = [d for _, d, _ in s["numerics"]["windows"]]
    out = dict(digest=runs[0]["digest"][:8],
               seconds=[r["seconds"] for r in runs],
               mem_violations=0, mem_source=s["mem_contract"]["source"],
               mem_baseline_bytes=s["mem_contract"]["baseline_bytes"],
               mem_max_bytes=s["mem_contract"]["max_bytes"],
               inplace_checked=s["mem_contract"]["inplace_checked"],
               compiles_warmup=s["trace_contract"]["compiles_warmup"],
               compiles_steady=0, ledger_windows=len(l1),
               ledgers_equal=True, max_drift_ulps=max(drifts),
               sentinel_checks=s["counters"].get("health.sentinel_checks"),
               healthz=list(runs[0]["healthz"]))
    log(f"contracts: digest held, 0 memory violations "
        f"({out['mem_source']}, baseline {out['mem_baseline_bytes']} B, "
        f"max {out['mem_max_bytes']} B), {out['compiles_warmup']} warmup "
        f"and 0 steady compile events, {len(l1)} equal ledger windows, "
        f"largest drift {max(drifts)} ulp")
    return out


def faults_path(lgb, counters, ds_small, total: dict) -> dict:
    """The silent faults on the small-data path (K6): each caught and
    named."""
    from lightgbm_tpu_torch import obs
    from lightgbm_tpu_torch.boosting import gbdt
    from lightgbm_tpu_torch.obs import determinism, health, ops_plane
    from lightgbm_tpu_torch.utils import faults
    p = dict(TRAIN_CONF)
    out = {}

    def run(name, params=p, rounds=OBS_FAULT_ITERS):
        bst, seconds, launches = train_path(lgb, name, counters, params,
                                            ds_small, rounds)
        need(launches, ("split_scan",), name)
        add_launches(total, launches)
        return bst
    with obs_env(LGBM_TPU_SENTINELS="1", LGBM_TPU_OPS_PORT="0"):
        faults.inject("health.nan_grad", times=1, skip=2)
        bst = run("small-data, health.nan_grad")
        st = health.state()
        code, body = http_get(ops_plane.plane().port, "/healthz")
        ev = obs.summary()["events"].get("health:nonfinite", 0)
    if (st["state"], st["detail"].get("window"), code, ev) != \
            ("degraded", 2, 503, 1):
        raise AssertionError(f"nan_grad: {st}, /healthz {code}, {ev}")
    out["nan_grad"] = dict(state=st["state"], window=st["detail"]["window"],
                           what=st["detail"].get("what"), healthz=code,
                           stopped_at=bst.current_iteration())
    tmp = tempfile.mkdtemp(prefix="lgbm_stall_")
    try:
        trace = os.path.join(tmp, "trace.jsonl")
        with obs_env(LGBM_TPU_WATCHDOG_S=OBS_STALL_S):
            faults.inject("watchdog.stall", times=1, skip=1)
            run("small-data, watchdog.stall",
                dict(p, telemetry_output=trace), 4)
            ev = obs.summary()["events"].get("health:stall", 0)
            st = health.state()
        dump = json.load(open(trace + ".forensic.json"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if ev != 1 or dump["span"] != "gbdt.iteration" \
            or "Thread" not in dump["stacks"] or st["state"] != "stalled":
        raise AssertionError(f"stall: {ev} events, {st}, {dump['span']}")
    out["watchdog_stall"] = dict(span=dump["span"], it=dump["attrs"]["it"],
                                 deadline_s=dump["deadline_s"],
                                 stack_bytes=len(dump["stacks"]),
                                 state=st["state"])
    with obs_env(LGBM_TPU_MEM_CONTRACT="1"):
        faults.inject("mem.leak", times=1000)
        try:
            run("small-data, mem.leak")
        finally:
            gbdt._MEM_LEAK_SINK.clear()
        mem = obs.summary()["mem_contract"]
    if not mem["violation_count"] \
            or mem["violations"][0]["span"] != "gbdt.iteration":
        raise AssertionError(f"mem.leak not caught: {mem}")
    out["mem_leak"] = dict(violations=mem["violation_count"],
                           span=mem["violations"][0]["span"],
                           grew_bytes=mem["violations"][0]["grew_bytes"],
                           source=mem["source"])
    dart = dict(p, **OBS_DART_DRIFT)
    ledgers = []
    for drift in (False, True):
        with obs_env(LGBM_TPU_DETERMINISM="1"):
            if drift:
                faults.inject("det.rng_drift", times=1, skip=2)
            run(f"small-data DART{', det.rng_drift' if drift else ''}",
                dart)
            ledgers.append(determinism.section()["digests"])
    div = determinism.first_divergence(*ledgers)
    if div is None:
        raise AssertionError("det.rng_drift: no divergent window")
    out["rng_drift"] = dict(first_divergent_window=div[0])
    log(f"faults: nan_grad degraded at window 2 (/healthz 503); stall named "
        f"{dump['span']} with {len(dump['stacks'])} B of stacks; mem.leak "
        f"{mem['violation_count']} violations at gbdt.iteration; rng_drift "
        f"first divergent window {div[0]}")
    return out


def serve_plane_path(card: str) -> dict:
    """Phase 12's model in a server with the plane mounted, the watchdog
    armed and the memory and trace contracts on: scraped during a
    5k-QPS step, drained over ``/drain``."""
    import threading
    import numpy as np
    from lightgbm_tpu_torch import obs
    from lightgbm_tpu_torch.obs import ops_plane
    from lightgbm_tpu_torch.serve import PredictionServer
    from tools.load_harness import sweep
    cm, pool = SERVE_STATE["model"], SERVE_STATE["pool"]
    ref = next(r for r in SERVE_STATE["table"]
               if r["offered_qps"] == OBS_QPS)
    scrapes = []
    with obs_env(LGBM_TPU_OPS_PORT="0", LGBM_TPU_WATCHDOG_S="30",
                 LGBM_TPU_MEM_CONTRACT="1", LGBM_TPU_TRACE_CONTRACT="1"):
        srv = PredictionServer(cm, max_batch=max(SERVE_BUCKETS),
                               max_wait_ms=1.0, buckets=SERVE_BUCKETS,
                               min_bucket=SERVE_BUCKETS[0], raw_score=True)
        port = ops_plane.plane().port
        stop = threading.Event()

        def scrape():
            while not stop.is_set():
                m = http_get(port, "/metrics")
                h = http_get(port, "/healthz")
                scrapes.append((m[0], h[0], json.loads(h[1])["state"],
                                "lgbm_tpu_serve_requests_total" in m[1]))
                time.sleep(0.1)
        th = threading.Thread(target=scrape, daemon=True)
        # one request answered before the first scrape: every scrape
        # then must show the serving counters
        srv.predict(pool[:1])
        gc.collect()
        gc.freeze()
        try:
            th.start()
            table = sweep(srv, pool, (OBS_QPS,), SERVE_QPS_S,
                          rows_per_request=1, seed=13)
        finally:
            stop.set()
            th.join(30)
            gc.unfreeze()
        code, body = http_get(port, "/drain")
        drain = json.loads(body)
        st = srv.stats()
        s = obs.summary()
    rep = drain["reports"][0] if drain["reports"] else {}
    tc, mem = s.get("serve_trace_contract", {}), s.get("serve_mem_contract",
                                                       {})
    row = table[0]
    if not scrapes or any(m != 200 or h != 200 or not seen
                          for m, h, _, seen in scrapes):
        raise AssertionError(f"scrapes during the sweep: {scrapes[:5]}")
    if code != 200 or not rep.get("drained") or rep.get("pending") \
            or rep.get("failed") or row["failures"]:
        raise AssertionError(f"/drain: {code} {drain}")
    if st["steady_captures"] or tc.get("compiles_steady", 1) \
            or mem.get("violation_count", 1):
        raise AssertionError(f"serve contracts: captures "
                             f"{st['steady_captures']}, trace {tc}, "
                             f"memory {mem}")
    out = dict(scrapes=len(scrapes),
               states=sorted({x for _, _, x, _ in scrapes}),
               drain_code=code, drained=rep["resolved"],
               steady_captures=0, compiles_steady=0,
               compiles_warmup=tc["compiles_warmup"], mem_violations=0,
               mem_batches=mem["windows_sampled"],
               watchdog_arms=s["counters"].get("watchdog.arms"),
               p50_ms=row["p50_ms"], p99_ms=row["p99_ms"],
               achieved_qps=row["achieved_qps"],
               phase12_p50_ms=ref["p50_ms"], phase12_p99_ms=ref["p99_ms"])
    log(f"serve plane ({card}): {len(scrapes)} scrapes of /metrics and "
        f"/healthz during {OBS_QPS:.0f} QPS, all 200; /drain resolved "
        f"{rep['resolved']}; 0 steady captures and compile events, 0 "
        f"memory violations over {mem['windows_sampled']} batches; p50 "
        f"{row['p50_ms']} / p99 {row['p99_ms']} ms (phase 12: "
        f"{ref['p50_ms']} / {ref['p99_ms']})")
    return out


class PlaneToggle:
    """A before-iteration callback of a run with the ops plane mounted:
    after the first iteration, iterations go in pairs, one with the
    plane's live work on and one with it off, the order in each pair
    drawn from ``seed`` (so no period in the iterations' own times
    lines up with it); ``flags[i]`` says whether iteration ``i`` had it
    on.  The live work is ``pieces``: telemetry with the registry as
    its sink, the sentinels, the health marks; a piece not named stays
    off throughout.  The plane's HTTP thread runs throughout."""

    PIECES = ("telemetry", "sentinels", "health")
    before_iteration = True

    def __init__(self, iters: int, seed: int, pieces=PIECES):
        rng = random.Random(seed)
        self.flags = [True] * iters
        for i in range(1, iters - 1, 2):
            first = bool(rng.getrandbits(1))
            self.flags[i], self.flags[i + 1] = first, not first
        self.pieces = pieces
        self.registry = None

    def __call__(self, env):
        from lightgbm_tpu_torch.obs import health, ops_plane, telemetry
        if self.registry is None:
            self.registry = ops_plane.plane().registry
        on = self.flags[env.iteration]
        sentinels = on and "sentinels" in self.pieces
        os.environ["LGBM_TPU_SENTINELS"] = "1" if sentinels else "0"
        health._set_active(on and "health" in self.pieces)
        if on and "telemetry" in self.pieces:
            telemetry.enable()
            telemetry.set_sink(self.registry)
        else:
            telemetry.set_sink(None)
            telemetry.disable()

    def pair_diffs(self, iter_ms: list) -> list:
        """Each whole pair's on - off milliseconds."""
        return [(iter_ms[i] - iter_ms[i + 1]) * (1 if self.flags[i] else -1)
                for i in range(1, len(iter_ms) - 1, 2)]


def plane_cost_path(lgb, counters, ds, head_ref, total: dict,
                    runs: int = OBS_COST_RUNS, hold: bool = True) -> dict:
    """What the ops plane and the sentinels cost the headline's steady
    iteration, paired inside each run (:class:`PlaneToggle`, timed by
    :class:`IterClock`), so that neighbouring iterations share the
    host's state: the median of the pairs' on - off differences over
    ``runs`` runs is held within ``OBS_COST_BOUND_MS`` (unless not
    ``hold``: ``tools/plane_cost.py`` reports it).  Each run must
    give the headline's model, with one sentinel check and one sketched
    ``gbdt.iteration`` for each iteration that had the plane on."""
    from lightgbm_tpu_torch import obs
    params = dict(HEADLINE_PARAMS)
    diffs, on_ms, off_ms = [], [], []
    for run in range(runs):
        with obs_env(LGBM_TPU_OPS_PORT="0"):
            clock = IterClock()
            toggle = PlaneToggle(HEADLINE_ITERS, seed=run)
            bst, _, launches = train_path(
                lgb, f"headline, plane toggled ({run + 1})", counters,
                params, ds, HEADLINE_ITERS, callbacks=[toggle, clock])
            checks = obs.summary()["counters"].get("health.sentinel_checks")
            sketched = toggle.registry.spans["gbdt.iteration"].count
        add_launches(total, launches)
        if bst.digest() != head_ref["digest"]:
            raise AssertionError("plane toggled: another model")
        n_on = sum(toggle.flags)
        if checks != n_on or sketched != n_on:
            raise AssertionError(f"plane toggled: {checks} sentinel checks "
                                 f"and {sketched} sketched iterations, "
                                 f"{n_on} iterations had the plane on")
        ms = clock.iter_ms()
        diffs += toggle.pair_diffs(ms)
        on_ms += [m for i, m in enumerate(ms) if i and toggle.flags[i]]
        off_ms += [m for i, m in enumerate(ms) if not toggle.flags[i]]
    median = statistics.median(diffs)
    log(f"plane cost: {len(diffs)} pairs, median on - off {median:.3f} "
        f"ms/iter (bound {OBS_COST_BOUND_MS}); on iterations median "
        f"{statistics.median(on_ms):.3f}, off {statistics.median(off_ms):.3f}")
    if hold and median > OBS_COST_BOUND_MS:
        raise AssertionError(f"the plane costs {median:.3f} ms/iter, past "
                             f"{OBS_COST_BOUND_MS}")
    return dict(pairs=len(diffs), median_diff_ms=median,
                bound_ms=OBS_COST_BOUND_MS, diffs_ms=diffs,
                on_median_ms=statistics.median(on_ms),
                off_median_ms=statistics.median(off_ms))


def observability_phase(lgb, counters, ds, dsw, ds_small, head_ref,
                        card: str) -> dict:
    """Phase 27: the profiler on the headline, DART and ``max_bin`` 1023
    paths; the headline with every contract on; the silent faults on the
    small-data path; the serving plane; the plane's cost -> launches."""
    total, out = {}, {}
    t0 = time.time()
    params = dict(HEADLINE_PARAMS)
    out["profile"] = {
        "headline": profiled_path(lgb, "headline", counters, params, ds,
                                  HEADLINE_ITERS, head_ref["digest"], True,
                                  total),
        "dart": profiled_path(lgb, "dart", counters,
                              dict(params, boosting="dart", **VARIANT_DART),
                              ds, HEADLINE_ITERS, PATH_DIGESTS["dart"],
                              False, total),
        "wide": profiled_path(lgb, "wide", counters,
                              dict(params, max_bin=WIDE_MAX_BIN), dsw,
                              WIDE_ITERS, PATH_DIGESTS["wide"], False,
                              total)}
    out["profile_s"] = time.time() - t0
    out["contracts"] = contracts_path(lgb, counters, ds, head_ref, total)
    out["faults"] = faults_path(lgb, counters, ds_small, total)
    out["serve"] = serve_plane_path(card)
    out["cost"] = plane_cost_path(lgb, counters, ds, head_ref, total)
    out["seconds"] = time.time() - t0
    print(json.dumps({"phase": 27, "name": "observability", "card": card,
                      **out}), flush=True)
    return total


def train_path(lgb, name, counters, params, ds, rounds, **kw):
    """One user-facing ``lgb.train`` with every launch counter reset just
    before and read just after: -> ``(booster, seconds, launches)``."""
    bst, seconds, launches = counted(counters, lambda: lgb.train(
        dict(params), ds, num_boost_round=rounds, device="cuda", **kw))
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


# phase 28: multiple GPUs
MG_WORLD = 2
MG_ITERS = 8                 # every world's (32, cut to hold the wall)
MG_MESH = (2, 2)             # the 2-D (data x feature) mesh: four ranks
MG_RENEWAL = (("regression_l1", {}), ("quantile", {"alpha": 0.9}),
              ("mape", {}))  # phase 20's renewal objectives
MG_TOP_K = 20
MG_LOAD_ROWS = 200_000
MG_LOAD_ITERS = 8
MG_DESYNC_ITERS = 4
MG_TIMEOUT_S = 420


def mg_counters():
    """The launch counters a rank reads: the wrappers the in-memory
    distributed build reaches (K2, K5, K3, the last route's K4) and the
    fused one it must not (K1)."""
    from lightgbm_tpu_torch.ops.compact import hist_compact_raw
    from lightgbm_tpu_torch.ops.histogram import (hist_active_raw,
                                                  hist_route_raw)
    from lightgbm_tpu_torch.ops.route import (route_rows_raw,
                                              route_rows_values_raw)
    from lightgbm_tpu_torch.ops.split_kernel import find_best_splits_kernel
    return {"route": route_rows_raw, "route_values": route_rows_values_raw,
            "hist_route": hist_route_raw, "hist_compact": hist_compact_raw,
            "hist_active": hist_active_raw,
            "split_scan": find_best_splits_kernel}


def mg_train(lgb, counters, params, ds, rounds) -> dict:
    """One ``lgb.train`` of a rank: its model, digest (trees), wall,
    steady ms/iter (the median gap between iteration ends after the
    first) and launches."""
    import numpy as np
    import torch
    ends = []

    def mark(env):
        torch.cuda.synchronize()
        ends.append(time.perf_counter())

    for c in counters.values():
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bst = lgb.train(dict(params), ds, num_boost_round=rounds, device="cuda",
                    callbacks=[mark])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    gaps = np.diff(ends)[1:] if len(ends) > 2 else np.diff([t0] + ends)
    return {"model": bst.model_to_string(),
            "digest": bst.digest(include_scores=False),
            "iterations": bst.current_iteration(), "seconds": wall,
            "steady_ms": 1e3 * float(np.median(gaps)),
            "launches": {k: c.launches for k, c in counters.items()}}


def mg_parts(lgb, counters, job, full, mine, rank: int, world: int,
             out: dict) -> None:
    """Phase 28's parts on one rank, in order, into ``out``."""
    import hashlib
    from lightgbm_tpu_torch import obs
    from lightgbm_tpu_torch.utils import faults
    params = dict(job["params"])
    iters = job["iters"]
    data = dict(params, tree_learner="data")
    out["data"] = mg_train(lgb, counters, data, mine, iters)
    out["data_again"] = mg_train(lgb, counters, data, mine, iters)
    os.environ["LGBM_TPU_OVERLAP"] = "1"
    try:
        out["data_overlap"] = mg_train(lgb, counters, data, mine, iters)
    finally:
        os.environ.pop("LGBM_TPU_OVERLAP", None)
    out["feature"] = mg_train(lgb, counters,
                              dict(params, tree_learner="feature"), full,
                              iters)
    out["voting"] = mg_train(lgb, counters,
                             dict(params, tree_learner="voting",
                                  top_k=MG_TOP_K), mine, iters)
    out["renewal"] = mg_renewal(lgb, counters, job, mine, rank)
    load = lgb.Dataset(job["csv"], params=dict(
        params, tree_learner="data", num_machines=world)).construct()
    b = load._constructed
    out["load"] = {
        "rows": int(b.num_data),
        "mappers": hashlib.sha256(json.dumps(
            [m.to_dict() for m in b.mappers],
            default=str).encode()).hexdigest(),
        **mg_train(lgb, counters, dict(params, tree_learner="data",
                                       num_machines=world), load,
                   job["load_iters"])}
    obs.reset()
    obs.enable()
    mg_train(lgb, counters, data, mine, job["desync_iters"])
    # rank 1 skips the record of the middle one of three host
    # gathers, as a rank-conditional branch around it would
    from lightgbm_tpu_torch.io.distributed import process_allgather
    for step in range(3):
        if rank == 1 and step == 1:
            faults.inject("spmd.skip_record", times=1)
        try:
            process_allgather({"step": step, "rank": rank})
        finally:
            faults.clear()
    merged = obs.merged_summary()
    out["desync"] = {
        "ranks": [r.get("rank") for r in merged["ranks"]],
        "check": merged.get("flight_recorder_check"),
        "skew": merged.get("collective_skew")}
    obs.reset()


def mg_mesh_parts(lgb, counters, job, full, mine, out: dict) -> None:
    """Phase 28's [2, 2] mesh on one of four ranks: the data-, feature-
    and voting-parallel headline with ``mesh_shape`` [2, 2], at the
    parameters and iterations of the 1-D runs."""
    params = dict(job["params"], mesh_shape=",".join(map(str, MG_MESH)))
    for learner, extra, ds in (("data", {}, mine), ("feature", {}, full),
                               ("voting", {"top_k": MG_TOP_K}, mine)):
        out[learner] = mg_train(lgb, counters,
                                dict(params, tree_learner=learner, **extra),
                                ds, job["iters"])


def mg_renewal(lgb, counters, job, mine, rank: int) -> dict:
    """Phase 20's renewal objectives data-parallel on this rank's rows
    (MAPE with the job's weights), and one voting-parallel L1 run: each
    run's model, launches and, in ``<job dir>/renew_<run>.rank<r>.npz``,
    this rank's scores and leaf ids and the renewed leaves of every
    tree."""
    import numpy as np
    from lightgbm_tpu_torch.objective import objectives as objs
    z = np.load(job["labels"])
    lo = rank * (-(-len(z["z"]) // MG_WORLD))
    rows = slice(lo, lo + mine.num_data())
    out = {}
    runs = [(name, "data", extra) for name, extra in MG_RENEWAL]
    runs.append(("regression_l1", "voting", {"top_k": MG_TOP_K}))
    for name, learner, extra in runs:
        run = f"{name}_{learner}"
        y = z["exp"] if name == "mape" else z["z"]
        w = z["w"] if name == "mape" else None
        ds = relabel(mine, y[rows], None if w is None else w[rows])
        params = dict(REG_PARAMS, objective=name, tree_learner=learner,
                      **extra)
        with recorded_renewals(objs.OBJECTIVES[name]) as seen:
            out[run] = mg_train(lgb, counters, params, ds, REG_ITERS)
        np.savez(os.path.join(os.path.dirname(job["labels"]),
                              f"renew_{run}.rank{rank}.npz"),
                 **{f"{k}{i}": a for i, trio in enumerate(seen)
                    for k, a in zip(("score", "leaf", "res"), trio)})
    return out


def mg_renewal_check(ranks, tmp: str, z, w) -> dict:
    """Phase 28's renewal runs, in the parent: the ranks' models are
    byte-identical, and every renewed leaf of each tree equals the
    percentile over all rows of both ranks (rank-major), phase 20's host
    percentile (weighted MAPE's weights :func:`mape_weight` of the
    labels and row weights) -> per run its digest, steady ms/iter and
    launches a tree a rank."""
    import numpy as np
    out = {}
    for run in ranks[0]["renewal"]:
        models = [r["renewal"][run]["model"] for r in ranks]
        if any(m != models[0] for m in models):
            raise AssertionError(f"multi-gpu renewal {run}: the ranks' "
                                 f"models differ: "
                                 f"{first_line_diff(*models[:2])}")
        name = run.rsplit("_", 1)[0]
        parts = [np.load(os.path.join(tmp, f"renew_{run}.rank{r}.npz"))
                 for r in range(MG_WORLD)]
        trees = len(parts[0].files) // 3
        if trees != REG_ITERS:
            raise AssertionError(f"multi-gpu renewal {run}: {trees} renewed "
                                 f"trees")
        label = np.exp(z / 2).astype(np.float32) if name == "mape" \
            else z.astype(np.float32)
        weight = mape_weight(label, w) if name == "mape" else None
        alpha = dict(MG_RENEWAL)[name].get("alpha", 0.5)
        worst = 0
        for i in range(trees):
            res = parts[0][f"res{i}"]
            if not all(np.array_equal(res, p[f"res{i}"]) for p in parts):
                raise AssertionError(f"multi-gpu renewal {run}: the ranks "
                                     f"renewed tree {i} differently")
            score = np.concatenate([p[f"score{i}"] for p in parts])
            leaf = np.concatenate([p[f"leaf{i}"] for p in parts])
            want = host_percentile(label - score, leaf, len(res), alpha,
                                   weight)
            worst = max(worst, int((want != res).sum()))
        if worst:
            raise AssertionError(f"multi-gpu renewal {run}: {worst} leaves "
                                 f"differ from the percentile over all rows")
        out[run] = {"digest": ranks[0]["renewal"][run]["digest"],
                    "steady_ms_per_iter": [r["renewal"][run]["steady_ms"]
                                           for r in ranks],
                    "launches_per_tree": [
                        per_tree(r["renewal"][run]["launches"], REG_ITERS)
                        for r in ranks]}
    log(f"multi-gpu renewal: {sorted(out)} byte-identical ranks, every "
        f"renewed leaf == the percentile over both ranks' rows; steady "
        f"ms/iter { {k: v['steady_ms_per_iter'] for k, v in out.items()} }")
    return out


def mg_rank(job_path: str, rank: int, world: int, port: int) -> int:
    """One rank of phase 28 (``chip_smoke.py --multi-gpu-rank JOB RANK
    WORLD PORT``): every part in order, its results into
    ``<job dir>/rank<r>.json``; the process group is left on every exit
    path.  A job with ``barrier`` runs phase 29's snapshot-barrier part
    (:func:`el_barrier_rank`) instead."""
    import traceback
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.io.dataset import BinnedDataset
    from lightgbm_tpu_torch.parallel import mesh
    with open(job_path) as f:
        job = json.load(f)
    out = {"rank": rank}
    try:
        out["backend"] = mesh.init_distributed(
            f"127.0.0.1:{port}", world, rank, local_rank=rank,
            local_world=world, timeout_s=240.0)
        dev = torch.cuda.current_device()
        out["device"] = f"cuda:{dev} {torch.cuda.get_device_name(dev)}"
        counters = mg_counters()
        full = lgb.Dataset(None)
        full._constructed = BinnedDataset.load_binary(job["bin"])
        n = full._constructed.num_data
        # a 2-D mesh's rank holds the rows of its data index
        d_rank, d_world = mesh.mesh_data_rank(job.get("mesh_shape", ()),
                                              rank, world)
        per = -(-n // d_world)
        mine = full.subset(np.arange(d_rank * per,
                                     min(n, (d_rank + 1) * per)))
        if job.get("barrier"):
            out["barrier"] = el_barrier_rank(lgb, job, mine)
        elif job.get("fullsize"):
            out["fullsize"] = fullsize_dp_rank(lgb, counters, job, full,
                                               rank, world)
        elif job.get("mesh_shape"):
            mg_mesh_parts(lgb, counters, job, full, mine, out)
        else:
            mg_parts(lgb, counters, job, full, mine, rank, world, out)
    except Exception:                 # noqa: BLE001 - the parent reports it
        out["error"] = traceback.format_exc()
    finally:
        mesh.destroy()
        with open(os.path.join(os.path.dirname(job_path),
                               f"rank{rank}.json"), "w") as f:
            json.dump(out, f, default=str)
    return 1 if "error" in out else 0


def run_rank_world(job: str, world: int, timeout_s: float,
                   what: str) -> list:
    """``world`` rank processes of this script over ``job`` (one JSON
    file; each rank writes ``rank<r>.json`` beside it), every one on
    card ``local_rank % device_count``; waits for them, kills any left at
    the deadline, and raises on a rank that failed -> the ranks'
    results in rank order."""
    from lightgbm_tpu_torch.parallel.mesh import free_port
    port = free_port()
    procs = []
    try:
        for r in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__),
                 "--multi-gpu-rank", job, str(r), str(world), str(port)],
                env={**{k: v for k, v in os.environ.items()
                        if not k.startswith("LGBM_TPU_")},
                     "LOCAL_RANK": str(r), "LOCAL_WORLD_SIZE": str(world)}))
        deadline = time.time() + timeout_s
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.time()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ranks = []
    for r in range(world):
        path = os.path.join(os.path.dirname(job), f"rank{r}.json")
        if not os.path.exists(path):
            raise AssertionError(f"{what} rank {r} wrote no result (exit "
                                 f"{procs[r].returncode})")
        with open(path) as f:
            res = json.load(f)
        if "error" in res or procs[r].returncode != 0:
            raise AssertionError(f"{what} rank {r} failed:\n"
                                 f"{res.get('error')}")
        ranks.append(res)
    return ranks


def first_line_diff(a: str, b: str) -> str:
    for i, (x, y) in enumerate(zip(a.splitlines(), b.splitlines())):
        if x != y:
            return f"line {i}: {x[:160]!r} != {y[:160]!r}"
    return "lengths differ"


def multi_gpu_phase(lgb, ds, X, y, z, head_ms: float, card: str) -> dict:
    """Phase 28 in the parent: the rank processes' inputs, the world of
    two, the world of four on the [2, 2] mesh, the checks -> the
    data-parallel run's launches summed over ranks."""
    import numpy as np
    import torch
    from lightgbm_tpu_torch.metric.metrics import binary_auc
    tmp = tempfile.mkdtemp(prefix="lgbm_multi_gpu_")
    try:
        t0 = time.time()
        ds._constructed.save_binary(os.path.join(tmp, "headline"))
        csv = os.path.join(tmp, "headline.csv")
        np.savetxt(csv, np.column_stack([y[:MG_LOAD_ROWS],
                                         X[:MG_LOAD_ROWS]]),
                   fmt="%.9g", delimiter=",")
        labels = os.path.join(tmp, "labels.npz")
        w = np.random.RandomState(29).uniform(0.5, 2.0, len(z))
        np.savez(labels, z=z.astype(np.float32),
                 exp=np.exp(z / 2).astype(np.float32),
                 w=w.astype(np.float32))
        base = {"bin": os.path.join(tmp, "headline.npz"),
                "params": HEADLINE_PARAMS, "iters": MG_ITERS}
        job = os.path.join(tmp, "job.json")
        with open(job, "w") as f:
            json.dump({**base, "csv": csv, "labels": labels,
                       "load_iters": MG_LOAD_ITERS,
                       "desync_iters": MG_DESYNC_ITERS}, f)
        log(f"multi-gpu inputs {time.time() - t0:.1f} s")
        ranks = run_rank_world(job, MG_WORLD, MG_TIMEOUT_S, "multi-gpu")
        seconds = time.time() - t0
        renewal = mg_renewal_check(ranks, tmp, z, w)
        t1 = time.time()
        os.makedirs(os.path.join(tmp, "mesh"))
        mesh_job = os.path.join(tmp, "mesh", "job.json")
        with open(mesh_job, "w") as f:
            json.dump({**base, "mesh_shape": list(MG_MESH)}, f)
        mranks = run_rank_world(mesh_job, MG_MESH[0] * MG_MESH[1],
                                MG_TIMEOUT_S, "multi-gpu [2, 2]")
        mesh_s = time.time() - t1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    def same(part, ranks=ranks):
        models = [r[part]["model"] for r in ranks]
        if any(m != models[0] for m in models):
            raise AssertionError(f"multi-gpu {part}: the ranks' models "
                                 f"differ: {first_line_diff(*models[:2])}")
        return ranks[0][part]

    def auc_of(part):
        bst = lgb.Booster(model_str=same(part)["model"], device="cuda")
        pred = bst.predict(X)
        if pred.shape != (len(y),) or not np.isfinite(pred).all():
            raise AssertionError(f"multi-gpu {part}: predictions are not "
                                 f"finite [n] values")
        return float(binary_auc(y, pred))

    a = same("data")
    PATH_DIGESTS["multi_gpu_data"] = a["digest"]
    for part in ("data_again", "data_overlap"):
        if same(part)["digest"] != a["digest"]:
            raise AssertionError(f"multi-gpu {part}: digest "
                                 f"{same(part)['digest']} != {a['digest']}")
    auc_data = auc_of("data")
    if not auc_data >= AUC_GATE:
        raise AssertionError(f"multi-gpu data-parallel auc {auc_data} < "
                             f"{AUC_GATE}")
    for r in ranks:
        la = r["data"]["launches"]
        need(la, ("route", "hist_active", "hist_compact", "route_values"),
             f"the data-parallel headline, rank {r['rank']}",
             absent=("hist_route",))
    # phase 4's configuration serially for as many iterations
    serial = lgb.train(dict(HEADLINE_PARAMS), ds, num_boost_round=MG_ITERS,
                       device="cuda")
    feat = same("feature")
    if feat["digest"] != serial.digest(include_scores=False):
        raise AssertionError(
            f"multi-gpu feature-parallel digest {feat['digest']} != the "
            f"serial {MG_ITERS}-iteration run's "
            f"{serial.digest(include_scores=False)}: "
            f"{first_line_diff(feat['model'], serial.model_to_string())}")
    auc_voting = auc_of("voting")
    if not auc_voting >= AUC_GATE:
        raise AssertionError(f"multi-gpu voting auc {auc_voting} < "
                             f"{AUC_GATE}")
    load = same("load")
    PATH_DIGESTS["multi_gpu_load"] = load["digest"]
    if len({r["load"]["mappers"] for r in ranks}) != 1:
        raise AssertionError("multi-gpu load: the ranks' bin mappers differ")
    if sum(r["load"]["rows"] for r in ranks) != MG_LOAD_ROWS:
        raise AssertionError("multi-gpu load: the ranks' rows do not add "
                             "up to the file's")
    for r in ranks:
        d = r["desync"]
        check = d["check"] or {}
        div = check.get("first_divergence") or {}
        if (d["ranks"] != list(range(MG_WORLD)) or check.get("ok") is not False
                or div.get("rank") != 1
                or div.get("site") != "io.distributed.process_allgather"
                or not d["skew"]):
            raise AssertionError(f"multi-gpu desync not localized on rank "
                                 f"{r['rank']}: {d}")
    mesh = {}
    for part in ("data", "feature", "voting"):
        m = same(part, mranks)
        if m["digest"] != same(part)["digest"]:
            raise AssertionError(
                f"multi-gpu [2, 2] {part}: digest {m['digest']} != the 1-D "
                f"[2] run's {same(part)['digest']}: "
                f"{first_line_diff(m['model'], same(part)['model'])}")
        mesh[part] = {"digest": m["digest"], "equals_1d": True,
                      "steady_ms_per_iter": [r[part]["steady_ms"]
                                             for r in mranks],
                      "launches_per_tree": [
                          per_tree(r[part]["launches"], MG_ITERS)
                          for r in mranks]}
    log(f"multi-gpu [2, 2] ({card}): four ranks byte-identical, data / "
        f"feature / voting digests == the [2] runs'; steady ms/iter "
        f"{ {p: v['steady_ms_per_iter'] for p, v in mesh.items()} }; "
        f"{mesh_s:.1f} s")
    launches = {}
    for r in ranks:
        add_launches(launches, r["data"]["launches"])
    torch.cuda.synchronize()
    out = {
        "phase": 28, "name": "multi_gpu", "card": card,
        "world": MG_WORLD, "backend": ranks[0]["backend"],
        "devices": [r["device"] for r in ranks],
        "shares_one_card": len({r["device"] for r in ranks}) < MG_WORLD,
        "data": {"digest": a["digest"], "auc": auc_data,
                 "steady_ms_per_iter": [r["data"]["steady_ms"]
                                        for r in ranks],
                 "ms_per_iter_with_setup": [
                     1e3 * r["data"]["seconds"] / MG_ITERS
                     for r in ranks],
                 "overlap_steady_ms": [r["data_overlap"]["steady_ms"]
                                       for r in ranks],
                 "phase4_ms_per_iter_with_setup": head_ms,
                 "launches": [r["data"]["launches"] for r in ranks]},
        "feature": {"digest": feat["digest"],
                    "equals_phase4": True,
                    "steady_ms_per_iter": [r["feature"]["steady_ms"]
                                           for r in ranks]},
        "voting": {"digest": same("voting")["digest"], "auc": auc_voting,
                   "steady_ms_per_iter": [r["voting"]["steady_ms"]
                                          for r in ranks]},
        "load": {"rows": [r["load"]["rows"] for r in ranks],
                 "mappers": load["mappers"], "digest": load["digest"]},
        "desync": {"site": ranks[0]["desync"]["check"]["first_divergence"][
            "site"], "rank": 1,
            "skew_sites": sorted(ranks[0]["desync"]["skew"])},
        "renewal": renewal, "mesh_2x2": mesh, "mesh_2x2_seconds": mesh_s,
        "seconds": seconds}
    print(json.dumps(out), flush=True)
    return launches


# phase 29: elastic training (the bench's stream cell, bench.py:1209-1218,
# over two protocol shards)
EL_ROWS = 4_194_304
EL_SHARDS = 2
EL_WORKERS = 2
EL_ITERS = 8
EL_KILL_ITER = 3
EL_PARAMS = dict(STREAM_PARAMS, num_iterations=EL_ITERS, snapshot_freq=1,
                 snapshot_keep=2)
# the regrow's survivor waits this long an iteration, so that the joiner
# (a fresh process: imports, CUDA context, the store) arrives while it
# still trains; the sleep changes no byte
EL_REGROW_SLEEP_S = "1.5"
EL_TIMEOUT_S = 240
EL_BARRIER_FREQ = MG_ITERS // 2   # the resume point of the barrier part
EL_BARRIER_TIMEOUT_S = 300
EL_DEVICE = "cuda"


def el_barrier_rank(lgb, job, mine) -> dict:
    """Phase 29's multi-process snapshot barrier on one rank of phase
    28's world: the data-parallel headline with ``snapshot_freq`` 16, then
    a resume at W = 2 from iteration 16 (each rank's own scores)."""
    params = dict(job["params"], tree_learner="data",
                  output_model=job["prefix"], snapshot_freq=EL_BARRIER_FREQ,
                  snapshot_keep=4)
    iters = job["iters"]
    t0 = time.perf_counter()
    full = lgb.train(dict(params), mine, num_boost_round=iters,
                     device="cuda")
    t1 = time.perf_counter()
    res = lgb.train(dict(params), mine, num_boost_round=iters,
                    device="cuda", resume_from=job["resume_from"])
    t2 = time.perf_counter()
    return {"digest": full.digest(include_scores=False),
            "digest_scores": full.digest(),
            "resumed_digest": res.digest(include_scores=False),
            "resumed_digest_scores": res.digest(),
            "seconds": t1 - t0, "resume_seconds": t2 - t1}


def el_barrier_part(lgb, ds, tmp: str) -> dict:
    """Phase 28's two ranks train the data-parallel headline with
    snapshots every 16 iterations and resume at W = 2 from iteration 16;
    this process (W = 1) must refuse that snapshot."""
    from lightgbm_tpu_torch.boosting import snapshot as snap
    prefix = os.path.join(tmp, "barrier", "headline.txt")
    os.makedirs(os.path.dirname(prefix))
    ds._constructed.save_binary(os.path.join(tmp, "headline"))
    manifest = snap.snapshot_paths(prefix, EL_BARRIER_FREQ)[2]
    job = os.path.join(tmp, "barrier-job.json")
    with open(job, "w") as f:
        json.dump({"bin": os.path.join(tmp, "headline.npz"), "barrier": True,
                   "params": HEADLINE_PARAMS, "iters": MG_ITERS,
                   "prefix": prefix, "resume_from": manifest}, f)
    t0 = time.time()
    ranks = [r["barrier"] for r in run_rank_world(
        job, MG_WORLD, EL_BARRIER_TIMEOUT_S, "elastic barrier")]
    want = PATH_DIGESTS.get("multi_gpu_data", ranks[0]["digest"])
    for r, b in enumerate(ranks):
        if b["digest"] != want or b["resumed_digest"] != want:
            raise AssertionError(
                f"elastic barrier rank {r}: uninterrupted {b['digest']}, "
                f"resumed {b['resumed_digest']}, phase 28 {want}")
        if b["resumed_digest_scores"] != b["digest_scores"]:
            raise AssertionError(f"elastic barrier rank {r}: the resumed "
                                 f"scores differ from the uninterrupted")
    man = snap.resolve_snapshot(manifest)
    if man is None or man["world_size"] != MG_WORLD \
            or sorted(man["rank_state_paths"]) != list(range(MG_WORLD)):
        raise AssertionError(f"elastic barrier: the snapshot at iteration "
                             f"{EL_BARRIER_FREQ} is not a committed "
                             f"{MG_WORLD}-rank snapshot: {man}")
    try:
        lgb.train(dict(HEADLINE_PARAMS, output_model=prefix), ds,
                  num_boost_round=MG_ITERS, device="cuda",
                  resume_from=manifest)
    except ValueError as exc:
        refusal = str(exc)
    else:
        raise AssertionError("elastic barrier: a one-process run resumed a "
                             "two-rank snapshot")
    if f"{MG_WORLD}-process mesh" not in refusal:
        raise AssertionError(f"elastic barrier: another refusal: {refusal}")
    return {"digest": want, "resumed_at": EL_BARRIER_FREQ,
            "w1_refused": True, "seconds": time.time() - t0,
            "train_s": [b["seconds"] for b in ranks],
            "resume_s": [b["resume_seconds"] for b in ranks]}


def elastic_worker(spec_path: str, member: str) -> int:
    """One elastic worker of phase 29 (``chip_smoke.py --elastic-worker
    SPEC MEMBER``): ``train_elastic`` on card 0 against the coordinator
    the parent hosts (``tools/chaos_torch.py``'s worker, which fails
    without a card when the spec names ``cuda``)."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tools import chaos_torch
    return chaos_torch.worker_main(spec_path, member)


def walked(walk, states) -> bool:
    """Whether ``states`` occur in ``walk`` in this order."""
    it = iter(walk)
    return all(any(w == s for w in it) for s in states)


def elastic_phase(lgb, ds, card: str) -> dict:
    """Phase 29: the bench's stream cell (28 features, ``max_bin`` 63, 63
    leaves, int8h, 1,048,576-row blocks) on 4,194,304 rows in two
    protocol shards, ingested once into a shard store the workers mmap;
    the single-process oracle on the card, then two ``train_elastic``
    workers on card 0 against a coordinator in this process: a control
    run, a SIGKILL of worker-1 at iteration 3 (shrink), the same kill
    with a joiner (regrow), each worker's bytes == the oracle's; then
    phase 28's two ranks through the multi-process snapshot barrier.
    -> the workers' launches, summed."""
    import numpy as np
    import torch
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.metric.metrics import binary_auc
    from tools import chaos_torch
    tmp = tempfile.mkdtemp(prefix="lgbm_elastic_")
    counters = chaos_torch.counters()
    saved = os.environ.get("LGBM_TPU_CHAOS_ITER_SLEEP_S")
    try:
        t0 = time.time()
        store = lgb.outofcore.ingest_synthetic(
            os.path.join(tmp, "store"), EL_ROWS, STREAM_FEATURES,
            Config.from_params(EL_PARAMS), seed=29, shard_rows=EL_ROWS)
        ingest_s = time.time() - t0
        spec = {"store": store.cache_dir, "shards": EL_SHARDS,
                "device": EL_DEVICE, "block_rows": STREAM_BLOCK,
                "params": dict(EL_PARAMS, output_model="")}

        # the oracle: StreamTrainer(num_shards=2) in this process
        for c in counters.values():
            c.launches = 0
        bst, oracle_s = chaos_torch.train_oracle(spec)
        oracle_launches = {k: c.launches for k, c in counters.items()}
        need(oracle_launches, ("hist_active", "route", "route_values"),
             "the elastic oracle", absent=("hist_route", "split_scan"))
        scores = bst.scores.numpy()[:, 0]
        auc = float(binary_auc(store.labels_array(), scores))
        if not np.isfinite(scores).all() or not auc >= AUC_GATE:
            raise AssertionError(f"elastic oracle: train auc {auc} < "
                                 f"{AUC_GATE} or non-finite scores")
        want = chaos_torch.model_identity(bst)
        log(f"elastic oracle: {EL_ROWS} rows x {EL_ITERS} iterations at "
            f"S = {EL_SHARDS} in {oracle_s:.3f} s; auc {auc:.5f}; digest "
            f"{want['digest']}; launches {oracle_launches}")
        del bst

        worker_cmd = [sys.executable, os.path.abspath(__file__),
                      "--elastic-worker"]
        runs, launches = {}, {}
        for name, kill, respawn, sleep in (
                ("control", None, False, "0"),
                ("shrink", EL_KILL_ITER, False, "0"),
                ("regrow", EL_KILL_ITER, True, EL_REGROW_SLEEP_S)):
            os.environ["LGBM_TPU_CHAOS_ITER_SLEEP_S"] = sleep
            rundir = os.path.join(tmp, name)
            os.makedirs(rundir)
            v = chaos_torch.run_chaos(
                workers=EL_WORKERS, kill_iter=kill, respawn=respawn,
                rundir=rundir, timeout_s=EL_TIMEOUT_S,
                spec=dict(spec, params=dict(spec["params"], output_model=
                                            os.path.join(rundir, "m.txt"))),
                oracle=want, worker_cmd=worker_cmd)
            if not v["ok"]:
                logs = "".join(
                    open(os.path.join(rundir, n)).read()[-3000:]
                    for n in sorted(os.listdir(rundir))
                    if n.startswith("log-"))
                raise AssertionError(f"elastic {name}: {v['errors']}\n{logs}")
            members = sorted(r["member"] for r in v["results"])
            expect = {"control": ["worker-0", "worker-1"],
                      "shrink": ["worker-0"],
                      "regrow": ["joiner-0", "worker-0"]}[name]
            if members != expect:
                raise AssertionError(f"elastic {name}: results from "
                                     f"{members}, expected {expect}")
            for r in v["results"]:
                need(r["launches"], ("hist_active", "route", "route_values"),
                     f"elastic {name}, {r['member']}",
                     absent=("hist_route", "split_scan"))
                add_launches(launches, r["launches"])
            if kill is not None:
                rec = v["recovery"]
                if abs(sum(rec["phases"].values()) - rec["mttr_s"]) > 1e-9:
                    raise AssertionError(f"elastic {name}: recovery phases "
                                         f"do not sum to mttr: {rec}")
                surv = next(r for r in v["results"]
                            if r["member"] == "worker-0")
                if not walked(surv["health_walk"],
                              ("ready", "recovering", "ready")):
                    raise AssertionError(
                        f"elastic {name}: /healthz walked "
                        f"{surv['health_walk']}, not ready -> recovering "
                        f"-> ready")
            runs[name] = {
                "seconds": v["seconds"],
                "worker_s": {r["member"]: r["seconds"]
                             for r in v["results"]},
                "killed": v["killed"], "respawned": v["respawned"],
                "mttr_s": v.get("mttr_s"),
                "recovery": v.get("recovery"),
                "episodes": {r["member"]: r["episodes"]
                             for r in v["results"]},
                "health_walk": {r["member"]: r["health_walk"]
                                for r in v["results"]},
                "launches": {r["member"]: r["launches"]
                             for r in v["results"]},
                "counters": {r["member"]: r["counters"]
                             for r in v["results"]},
                "bytes_sent_per_wave": {
                    r["member"]: r["counters"].get(
                        "elastic.bytes_exchanged", 0)
                    / max(1, r["counters"].get("stream.waves", 0))
                    for r in v["results"]},
                "collective_skew": {r["member"]: r["collective_skew"]
                                    for r in v["results"]}}
            log(f"elastic {name}: {v['seconds']:.1f} s; workers "
                f"{runs[name]['worker_s']}; mttr {v.get('mttr_s')}; "
                f"phases {(v.get('recovery') or {}).get('phases')}; bytes "
                f"sent a wave {runs[name]['bytes_sent_per_wave']}")
        barrier = el_barrier_part(lgb, ds, tmp)
        log(f"elastic barrier: {barrier}")
    finally:
        if saved is None:
            os.environ.pop("LGBM_TPU_CHAOS_ITER_SLEEP_S", None)
        else:
            os.environ["LGBM_TPU_CHAOS_ITER_SLEEP_S"] = saved
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.synchronize()
    phase_line("29_elastic", card, rows=EL_ROWS, shards=EL_SHARDS,
               workers=EL_WORKERS, iterations=EL_ITERS, ingest_s=ingest_s,
               oracle={"seconds": oracle_s, "auc": auc, **want,
                       "launches": oracle_launches},
               runs=runs, barrier=barrier)
    return launches


# phase 30: the command-line application and the C API
APP_PRED_ROWS = 100_000        # the C API's prediction rows (phase 4's)
APP_CONVERT_ROWS = 1_000       # rows the converted model scores
APP_CONVERT_TOL = 1e-5         # the reference CI's gate (.travis/test.sh)
APP_TIMEOUT_S = 420
APP_BEFORE = ("import chip_smoke as cs\n"
              "for c in cs.launch_counters().values():\n"
              "    c.launches = 0\n")
APP_AFTER = ("import json, torch, chip_smoke as cs\n"
             "from lightgbm_tpu_torch import capi_bridge as cb\n"
             "torch.cuda.synchronize()\n"
             "b = [h for h in cb._handles.values() if hasattr(h, 'digest')]\n"
             "report = {'launches': {k: c.launches for k, c in\n"
             "                       cs.launch_counters().items()},\n"
             "          'digest': b[-1].digest(include_scores=False),\n"
             "          'digest_scores': b[-1].digest()}\n"
             "with open(REPORT, 'w') as f:\n"
             "    json.dump(report, f)\n")


def launch_counters() -> dict:
    """Every kernel wrapper's launch counter, by the name the kernel table
    and the phases use."""
    from lightgbm_tpu_torch.ops.compact import (hist_compact_float_raw,
                                                hist_compact_raw)
    from lightgbm_tpu_torch.ops.histogram import (HIST_WIDE_SEEDED,
                                                  hist_active_float_raw,
                                                  hist_active_raw,
                                                  hist_route_float_raw,
                                                  hist_route_raw,
                                                  hist_wide_raw)
    from lightgbm_tpu_torch.ops.route import (ROUTE_I32, ROUTE_VALUES_I32,
                                              route_rows_raw,
                                              route_rows_values_raw)
    from lightgbm_tpu_torch.ops.split_kernel import find_best_splits_kernel
    return {"route": route_rows_raw, "route_values": route_rows_values_raw,
            "hist_route": hist_route_raw, "hist_compact": hist_compact_raw,
            "split_scan": find_best_splits_kernel,
            "hist_active": hist_active_raw,
            "hist_float": hist_active_float_raw,
            "hist_route_float": hist_route_float_raw,
            "hist_compact_float": hist_compact_float_raw,
            "hist_wide": hist_wide_raw,
            "hist_wide_seeded": HIST_WIDE_SEEDED,
            "route_i32": ROUTE_I32,
            "route_values_i32": ROUTE_VALUES_I32}


def app_run(cmd, what: str) -> str:
    """Run a child to its end (killed past ``APP_TIMEOUT_S``); its output,
    or an error with its tail."""
    from lightgbm_tpu_torch.capi.build import host_env
    res = subprocess.run(cmd, env=host_env(), capture_output=True, text=True,
                         timeout=APP_TIMEOUT_S)
    if res.returncode != 0:
        raise AssertionError(f"{what} exited {res.returncode}:\n"
                             f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
    return res.stdout


def app_child(out_path: str, runs_path: str) -> int:
    """A child of phase 30 (``chip_smoke.py --app-child OUT RUNS``): each
    argument list of ``RUNS`` (JSON) run as ``python -m
    lightgbm_tpu_torch <arguments>`` runs it (``runpy.run_module`` of the
    package's ``__main__``), one after another in this process, every
    launch counter reset just before each and read just after; the
    Booster a training run builds is kept (``engine.train`` wrapped) for
    its model text, stop, best iteration and digests.  The results go to
    ``OUT`` (JSON)."""
    import runpy
    import traceback
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from lightgbm_tpu_torch import engine
    with open(runs_path) as f:
        runs = json.load(f)
    counters = launch_counters()
    kept = []
    real_train = engine.train

    def train(*args, **kw):
        kept.append(real_train(*args, **kw))
        return kept[-1]

    engine.train = train
    results = []
    try:
        for argv in runs:
            kept.clear()
            for c in counters.values():
                c.launches = 0
            torch.cuda.synchronize()
            sys.argv = ["lightgbm_tpu_torch"] + list(argv)
            t0 = time.time()
            try:
                runpy.run_module("lightgbm_tpu_torch", run_name="__main__",
                                 alter_sys=True)
                rc = 0
            except SystemExit as exc:
                rc = exc.code if isinstance(exc.code, int) else int(
                    exc.code is not None)
            torch.cuda.synchronize()
            res = {"argv": argv, "rc": rc, "seconds": time.time() - t0,
                   "launches": {k: c.launches for k, c in counters.items()}}
            if kept:
                b = kept[0]
                res.update(model=b.model_to_string(),
                           stop=b.current_iteration(),
                           best=b.best_iteration, digest=b.digest(),
                           digest_trees=b.digest(include_scores=False))
            results.append(res)
            if rc != 0:
                break
    except Exception:                 # noqa: BLE001 - the parent reports it
        results.append({"error": traceback.format_exc()})
    finally:
        engine.train = real_train
        with open(out_path, "w") as f:
            json.dump(results, f)
    return 0 if all(r.get("rc") == 0 for r in results) else 1


def app_children(tmp: str, runs_by_child, what: str):
    """Start one ``--app-child`` per entry of ``runs_by_child`` at once,
    wait for all (every one is killed on the way out), -> their results."""
    from lightgbm_tpu_torch.capi.build import host_env
    procs, outs = [], []
    try:
        for i, runs in enumerate(runs_by_child):
            spec = os.path.join(tmp, f"{what}{i}.runs.json")
            outs.append(os.path.join(tmp, f"{what}{i}.out.json"))
            with open(spec, "w") as f:
                json.dump(runs, f)
            log_path = os.path.join(tmp, f"{what}{i}.log")
            with open(log_path, "w") as log_f:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__),
                     "--app-child", outs[-1], spec],
                    env=host_env(), stdout=log_f, stderr=subprocess.STDOUT))
        deadline = time.time() + APP_TIMEOUT_S
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.time()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for i, (p, out) in enumerate(zip(procs, outs)):
        res = []
        if os.path.exists(out):
            with open(out) as f:
                res = json.load(f)
        bad = [r for r in res if "error" in r or r.get("rc") != 0]
        if p.returncode != 0 or bad or len(res) != len(runs_by_child[i]):
            with open(os.path.join(tmp, f"{what}{i}.log")) as f:
                tail = f.read()[-3000:]
            raise AssertionError(f"{what} child {i} failed (exit "
                                 f"{p.returncode}): {bad}\n{tail}")
        results.append(res)
    return results


def write_conf(path: str, params: dict) -> str:
    """A ``key = value`` configuration file (``train.conf``)."""
    with open(path, "w") as f:
        for k, v in params.items():
            v = str(v).lower() if isinstance(v, bool) else v
            f.write(f"{k} = {v}\n")
    return path


def build_capi_host(tmp: str) -> str:
    """The port's C library (``capi/build.py``) and ``tools/capi_train.cpp``
    linked against it."""
    import sysconfig
    from lightgbm_tpu_torch.capi import build as capi_build
    lib = capi_build.build()
    exe = os.path.join(tmp, "capi_train")
    app_run(["g++", "-O2", os.path.join(TOOLS_DIR, "capi_train.cpp"),
             f"-I{sysconfig.get_path('include')}", "-o", exe]
            + capi_build.link_args(lib), "building the C API host")
    return exe


def capi_part(X, y, head_ref: dict, tmp: str, exe: str) -> tuple:
    """Phase 30 (a): phase 4's headline through the C API."""
    import numpy as np
    rows, labels = os.path.join(tmp, "rows.f32"), os.path.join(tmp, "y.f32")
    np.ascontiguousarray(X, np.float32).tofile(rows)
    np.ascontiguousarray(y, np.float32).tofile(labels)
    model, preds = os.path.join(tmp, "capi.txt"), os.path.join(tmp, "p.f64")
    report = os.path.join(tmp, "capi.json")
    bparams = " ".join(f"{k}={v}" for k, v in HEADLINE_PARAMS.items())
    t0 = time.time()
    stdout = app_run([exe, rows, labels, str(len(X)), str(X.shape[1]),
                      str(HEADLINE_ITERS), f"max_bin={HEADLINE_PARAMS['max_bin']}",
                      bparams, model, preds, str(APP_PRED_ROWS), APP_BEFORE,
                      APP_AFTER.replace("REPORT", repr(report))],
                     "the C API host")
    wall = time.time() - t0
    if "CAPI_TRAIN_OK" not in stdout:
        raise AssertionError(f"the C API host: {stdout[-2000:]}")
    fields = dict(kv.split("=", 1) for ln in stdout.splitlines()
                  for kv in ln.split() if "=" in kv)
    with open(report) as f:
        rep = json.load(f)
    with open(model) as f:
        text = f.read()
    if text != head_ref["text"]:
        raise AssertionError(f"the C API's model is not phase 4's: "
                             f"{first_line_diff(text, head_ref['text'])}")
    if (rep["digest"] != head_ref["digest_trees"]
            or rep["digest_scores"] != head_ref["digest"]
            or not rep["digest"].startswith(HEADLINE_DIGEST)):
        raise AssertionError(f"the C API's digests {rep['digest'][:16]} / "
                             f"{rep['digest_scores'][:16]} are not phase 4's")
    need(rep["launches"], ("route", "route_values", "hist_route",
                           "hist_compact"), "the C API headline",
         absent=("split_scan",))
    # the same rows inside phase 4's 1M-row batch: a row's score does
    # not depend on its batch (the compiled walk sums in tree order)
    pred = np.fromfile(preds, np.float64)
    want = np.asarray(head_ref["pred"][:APP_PRED_ROWS], np.float64)
    if pred.shape != want.shape or not np.array_equal(pred, want):
        raise AssertionError(
            f"LGBM_BoosterPredictForMat of {APP_PRED_ROWS} rows is not "
            f"phase 4's Booster.predict of {len(head_ref['pred'])} rows "
            f"bitwise")
    out = {"digest": rep["digest"], "equals_phase4": True,
           "iterations": int(fields["iterations"]),
           "train_s": float(fields["train_s"]),
           "ms_per_iter": float(fields["ms_per_iter"]),
           "predict_rows": APP_PRED_ROWS,
           "predict_s": float(fields["predict_s"]),
           "shim_call_us": float(fields["call_us"]),
           "host_wall_s": wall, "predict_equals_1m_row_batch": True,
           "launches": rep["launches"],
           "launches_per_tree": per_tree(rep["launches"], HEADLINE_ITERS)}
    log(f"phase 30 C API: {HEADLINE_ITERS} iterations in "
        f"{out['train_s']:.3f} s = {out['ms_per_iter']:.2f} ms/iter "
        f"(setup included), C host wall {wall:.1f} s, "
        f"{out['shim_call_us']:.2f} us a shim call; model == phase 4's, "
        f"predictions bitwise; launches {rep['launches']}")
    return out, rep["launches"]


def cli_part(lgb, small_rows, small_ref: dict, tmp: str) -> tuple:
    """Phase 30 (b): phase 5's configuration through ``python -m
    lightgbm_tpu_torch``, then ``predict``, ``convert_model`` and
    ``refit`` on its model."""
    import ctypes
    import numpy as np
    Xs, ys, Xv, yv = small_rows
    t0 = time.time()
    train, valid = os.path.join(tmp, "train.csv"), os.path.join(tmp, "v.csv")
    np.savetxt(train, np.column_stack([ys, Xs]).astype(np.float64),
               fmt="%.17g", delimiter=",")
    np.savetxt(valid, np.column_stack([yv, Xv]).astype(np.float64),
               fmt="%.17g", delimiter=",")
    files_s = time.time() - t0
    model = os.path.join(tmp, "model.txt")
    conf = write_conf(os.path.join(tmp, "train.conf"), dict(
        TRAIN_CONF, task="train", num_iterations=SMALL_ITERS,
        early_stopping_round=SMALL_EARLY_STOP, data=train, valid_data=valid,
        output_model=model))
    pred, code = os.path.join(tmp, "pred.tsv"), os.path.join(tmp, "m.cpp")
    refit = os.path.join(tmp, "refit.txt")
    tr, pr, cv, rf = app_children(tmp, [[
        [f"config={conf}"],
        ["task=predict", f"data={valid}", f"input_model={model}",
         f"output_result={pred}", "verbose=-1"],
        ["task=convert_model", f"input_model={model}",
         f"convert_model={code}", "verbose=-1"],
        ["task=refit", f"data={train}", f"input_model={model}",
         f"output_model={refit}", "verbose=-1"]]], "cli")[0]
    got = (tr["stop"], tr["best"], tr["digest"])
    if got != (small_ref["stop"], small_ref["best"], small_ref["digest"]):
        raise AssertionError(f"the CLI's (stop, best, digest) {got} is not "
                             f"phase 5's")
    need(tr["launches"], ("split_scan", "hist_route", "route_values"),
         "the CLI's small-data run")
    want = os.path.join(tmp, "want.tsv")
    np.savetxt(want, np.asarray(small_ref["pred"])[:, None], delimiter="\t",
               fmt="%.9g")
    with open(pred) as f, open(want) as g:
        if f.read() != g.read():
            raise AssertionError("task=predict is not phase 5's "
                                 "Booster.predict as %.9g text")
    bst = lgb.Booster(model_file=model, device="cuda")
    Xc = np.asarray(Xv[:APP_CONVERT_ROWS], np.float64)
    raw = bst.predict(Xc, raw_score=True)
    lib = os.path.join(tmp, "model.so")
    t0 = time.time()
    app_run(["g++", "-O1", "-shared", "-fPIC", "-o", lib, code],
            "compiling the converted model")
    compile_s = time.time() - t0
    so = ctypes.CDLL(lib)
    so.Predict.argtypes = [ctypes.POINTER(ctypes.c_double)] * 2
    got = np.zeros(len(Xc))
    outv = np.zeros(1)
    for i in range(len(Xc)):
        row = np.ascontiguousarray(Xc[i])
        so.Predict(row.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                   outv.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        got[i] = outv[0]
    convert_err = float(np.max(np.abs(got - raw)))
    if not convert_err <= APP_CONVERT_TOL:
        raise AssertionError(f"the converted model is {convert_err} off "
                             f"predict(raw_score=True)")
    # refit in this process: the CLI's text but for feature_infos (the
    # CLI writes the data file's, a refitted Booster a loaded model's)
    mine = bst.refit(Xs, ys, decay_rate=0.9).model_to_string()
    with open(refit) as f:
        theirs = f.read()
    keep = [ln for ln in theirs.splitlines()
            if not ln.startswith("feature_infos=")]
    if keep != [ln for ln in mine.splitlines()
                if not ln.startswith("feature_infos=")]:
        raise AssertionError(f"task=refit is not the in-process refit: "
                             f"{first_line_diff(theirs, mine)}")
    launches = {}
    for r in (tr, pr, cv, rf):
        add_launches(launches, r["launches"])
    out = {"stop": tr["stop"], "best": tr["best"],
           "digest": tr["digest_trees"], "equals_phase5": True,
           "train_s": tr["seconds"],
           "ms_per_iter": 1e3 * tr["seconds"] / max(1, tr["stop"]),
           "predict_s": pr["seconds"], "convert_s": cv["seconds"],
           "convert_compile_s": compile_s, "convert_max_abs_err": convert_err,
           "refit_s": rf["seconds"], "files_s": files_s,
           "launches": tr["launches"],
           "launches_per_tree": per_tree(tr["launches"], tr["stop"])}
    log(f"phase 30 CLI: stop {tr['stop']}, best {tr['best']}, digest "
        f"{tr['digest_trees'][:8]} == phase 5; train {tr['seconds']:.2f} s, "
        f"predict {pr['seconds']:.2f} s (== phase 5 as text), convert "
        f"{cv['seconds']:.2f} s (max err {convert_err:.2e}), refit "
        f"{rf['seconds']:.2f} s (== in process)")
    return out, launches


def cli_ranks_part(X, y, tmp: str) -> tuple:
    """Phase 30 (c): two CLI ranks on card 0 (gloo) over a loopback
    machine list, on phase 28's 200,000-row CSV and parameters."""
    import numpy as np
    from lightgbm_tpu_torch.parallel.mesh import free_port
    csv = os.path.join(tmp, "headline.csv")
    np.savetxt(csv, np.column_stack([y[:MG_LOAD_ROWS], X[:MG_LOAD_ROWS]]),
               fmt="%.9g", delimiter=",")
    ports = [free_port() for _ in range(MG_WORLD)]
    conf = write_conf(os.path.join(tmp, "dist.conf"), dict(
        HEADLINE_PARAMS, task="train", tree_learner="data",
        num_machines=MG_WORLD, num_iterations=MG_LOAD_ITERS, data=csv,
        machines=",".join(f"127.0.0.1:{p}" for p in ports),
        output_model=os.path.join(tmp, "dist.txt")))
    t0 = time.time()
    ranks = [r[0] for r in app_children(
        tmp, [[[f"config={conf}", f"local_listen_port={p}"]] for p in ports],
        "rank")]
    seconds = time.time() - t0
    models = [r["model"] for r in ranks]
    if any(m != models[0] for m in models):
        raise AssertionError(f"the CLI ranks' models differ: "
                             f"{first_line_diff(*models[:2])}")
    with open(os.path.join(tmp, "dist.txt")) as f:
        if f.read() != models[0]:
            raise AssertionError("rank 0 did not save the ranks' model")
    launches = {}
    for i, r in enumerate(ranks):
        need(r["launches"], ("hist_active", "route"),
             f"CLI rank {i}", absent=("hist_route",))
        add_launches(launches, r["launches"])
    digest = ranks[0]["digest_trees"]
    phase28 = PATH_DIGESTS.get("multi_gpu_load")
    if digest != phase28:
        raise AssertionError(f"the CLI ranks' digest {digest[:16]} is not "
                             f"phase 28's load {str(phase28)[:16]}")
    out = {"world": MG_WORLD, "digest": digest, "phase28_load_digest": phase28,
           "seconds": seconds, "rank_seconds": [r["seconds"] for r in ranks],
           "launches": [r["launches"] for r in ranks],
           "launches_per_tree": [per_tree(r["launches"], MG_LOAD_ITERS)
                                 for r in ranks]}
    log(f"phase 30 CLI ranks: identical models, digest {digest[:8]} == "
        f"phase 28's load, {seconds:.1f} s")
    return out, launches


def app_phase(lgb, X, y, small_rows, head_ref: dict, small_ref: dict,
              card: str) -> dict:
    """Phase 30 -> launches by part (``app_capi``, ``app_cli``,
    ``app_ranks``)."""
    tmp = tempfile.mkdtemp(prefix="lgbm_app_")
    out = {"phase": 30, "name": "app", "card": card}
    by_part = {}
    try:
        t0 = time.time()
        exe = build_capi_host(tmp)
        out["build_s"] = time.time() - t0
        t0 = time.time()
        out["capi"], by_part["app_capi"] = capi_part(X, y, head_ref, tmp,
                                                      exe)
        out["capi"]["part_s"] = time.time() - t0
        t0 = time.time()
        out["cli"], by_part["app_cli"] = cli_part(lgb, small_rows, small_ref,
                                                  tmp)
        out["cli"]["part_s"] = time.time() - t0
        t0 = time.time()
        out["cli_ranks"], by_part["app_ranks"] = cli_ranks_part(X, y, tmp)
        out["cli_ranks"]["part_s"] = time.time() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(out), flush=True)
    return by_part


def widest_leaf_gap(rec: dict, trees) -> dict:
    """Over the leading trees whose structure is the record's, the leaf
    whose value moved most: its tree, leaf, row count and both values."""
    import numpy as np
    from lightgbm_tpu_torch.basic import Booster
    ref = Booster(model_str=rec["model"], device="cpu")._gbdt.models
    out = None
    for i, (a, b) in enumerate(zip(ref, trees)):
        n = int(a.num_leaves)
        if n != int(b.num_leaves) or any(
                not np.array_equal(getattr(a, k)[:n - 1],
                                   getattr(b, k)[:n - 1])
                for k in ("split_feature", "threshold", "decision_type",
                          "left_child", "right_child")):
            break
        gap = np.abs(np.asarray(a.leaf_value[:n], np.float64)
                     - np.asarray(b.leaf_value[:n], np.float64))
        j = int(np.argmax(gap))
        if gap[j] > 0 and (out is None or gap[j] > out["gap"]):
            out = {"tree": i, "leaf": j, "gap": float(gap[j]),
                   "rows": int(a.leaf_count[j]),
                   "record": float(a.leaf_value[j]),
                   "card": float(b.leaf_value[j])}
    return out


def against_record(rec: dict, bst) -> dict:
    """A Booster of the port against a record: identical trees (by
    digest, from the first), the tree digest, and ``model_flip_report``'s
    first divergence; raises where that divergence is not a near-tie."""
    from lightgbm_tpu_torch.parallel.envelope import model_flip_report
    from tools.torch_fullsize_ref import tree_digests
    g = getattr(bst, "_gbdt", bst)     # a Booster, or a stream's GBDT
    got, want = tree_digests(g.models), rec["tree_digests"]
    same = 0
    while same < min(len(got), len(want)) and got[same] == want[same]:
        same += 1
    rep = model_flip_report(rec["model"], g.save_model_to_string())
    if rep["flip_tree"] is not None:
        first = {"tree": rep["flip_tree"], "node": rep["flip_node"],
                 "kind": rep["flip_kind"], "gain_record": rep["gain_a"],
                 "gain_card": rep["gain_b"],
                 "abs_gain_gap": rep["abs_gain_gap"],
                 "rel_gain_gap": rep["rel_gain_gap"]}
    elif same < min(len(got), len(want)):
        first = {"tree": same, "kind": "leaf_values"}   # same structure
    elif len(got) != len(want):
        first = {"tree": same, "kind": "tree_count"}
    else:
        first = None
    if not rep["near_tie"]:
        raise AssertionError(f"{rec['cell']}: the first divergence from the "
                             f"JAX package's model is not a near-tie: {rep}")
    return {"trees": len(got), "record_trees": len(want),
            "identical_trees": same,
            "identical": (first is None and g.digest(include_scores=False)
                          == rec["digest_trees"]),
            "first_divergence": first, "near_tie": rep["near_tie"],
            "max_leaf_value_gap": rep["max_leaf_value_gap"],
            "widest_leaf_gap": widest_leaf_gap(rec, g.models)}


def sample_raw_check(rec: dict, raw) -> dict:
    """Raw scores of the record's sample rows against the record's host
    walk (f64) rounded once to f32: rows bitwise that, the worst distance
    in f32 ulp (raises past 1)."""
    import numpy as np
    from tools.torch_fullsize_ref import from_hex
    host = from_hex(rec["sample"]["host_raw"])
    got = np.asarray(raw, np.float64)
    bitwise = int(np.sum(got.astype(np.float32) == host.astype(np.float32)))
    worst = ulp_check(f"{rec['cell']} sample raw scores", got, host)
    return {"rows": len(host), "bitwise_rows": bitwise, "worst_ulp": worst}


def host_twin(obj):
    """A copy of an objective with every tensor it holds (labels,
    weights, lambdarank's query buckets) on the host."""
    import copy
    import torch

    def cpu(v):
        if torch.is_tensor(v):
            return v.cpu()
        if isinstance(v, list):
            return [cpu(x) for x in v]
        if isinstance(v, dict):
            return {k: cpu(x) for k, x in v.items()}
        return v
    twin = copy.copy(obj)
    for k, v in vars(obj).items():
        setattr(twin, k, cpu(v))
    return twin


@contextlib.contextmanager
def host_gradients(moved: list, quanta: bool = True):
    """Every gradient call on the card (the objective's
    ``get_gradients_k``: once an iteration in memory, once a block in a
    stream) takes its gradients from the CPU: the same objective on a
    host copy of its state and of the card's scores (torch's host
    transcendentals, ROADMAP C6), the result sent back.  For each call
    ``moved`` gets the rows whose gradient or hessian differs, in any
    class, between the card's own gradients and the host's and, where
    ``quanta``, the rows whose int8h quanta (each side quantized by its
    own absmax per class, on the card) differ; a float mode has no
    quanta (None)."""
    import torch
    from lightgbm_tpu_torch.objective.objectives import ObjectiveFunction
    from lightgbm_tpu_torch.ops.histogram import pack_values_q
    on_card = ObjectiveFunction.get_gradients_k

    def on_host(self, score):
        g_dev, h_dev = on_card(self, score)
        if score.device.type == "cpu":
            return g_dev, h_dev
        g, h = on_card(host_twin(self), score.cpu())
        g, h = g.to(g_dev.device), h.to(h_dev.device)
        n = g.shape[0]
        rows = [((g_dev != g) | (h_dev != h)).any(1).sum()]
        if quanta:
            q = torch.zeros(n, dtype=torch.bool, device=g.device)
            for k in range(g.shape[1]):
                qd, _ = pack_values_q(g_dev[:, k], h_dev[:, k], "int8h", n)
                qh, _ = pack_values_q(g[:, k], h[:, k], "int8h", n)
                q |= (qd != qh).any(0)[:n]
            rows.append(q.sum())
        rows = torch.stack(rows).tolist()
        moved.append({"gradient_rows": rows[0],
                      "quanta_rows": rows[1] if quanta else None})
        return g, h

    ObjectiveFunction.get_gradients_k = on_host
    try:
        yield
    finally:
        ObjectiveFunction.get_gradients_k = on_card


def moved_by_iteration(moved: list, calls: int) -> list:
    """The per-call counts of :func:`host_gradients` summed over each
    iteration's ``calls`` calls (a stream's blocks)."""
    out = []
    for i in range(0, len(moved), calls):
        part = moved[i:i + calls]
        q = [m["quanta_rows"] for m in part]
        out.append({"gradient_rows": sum(m["gradient_rows"] for m in part),
                    "quanta_rows": None if None in q else sum(q)})
    return out


def host_gradient_rerun(lgb, counters, cell: str, rec: dict, res: dict,
                        rerun, quanta: bool = True, calls: int = 1,
                        metric=None) -> dict:
    """The cell trained again on the card with the CPU's gradients
    (``rerun() -> (booster, seconds, launches)``), held to the record the
    same way, into ``res["host_gradients"]``: where it parts, the rows
    the card's own gradients moved at iteration 0 and at the card's
    first divergence, and the iterations with moved quanta (``metric(
    booster)``, if given, its metric).  -> its launches."""
    from tools.torch_fullsize_ref import num_class
    moved = []
    with host_gradients(moved, quanta):
        hbst, seconds, launches = rerun()
    hres = against_record(rec, hbst)
    per_iter = moved_by_iteration(moved, calls)
    flip = (res["first_divergence"] or {}).get("tree")
    it = None if flip is None else flip // num_class(rec["cell"])
    res["host_gradients"] = {
        "identical_trees": hres["identical_trees"],
        "identical": hres["identical"],
        "first_divergence": hres["first_divergence"],
        "widest_leaf_gap": hres["widest_leaf_gap"],
        "seconds": round(seconds, 3),
        "moved_iter0": per_iter[0] if per_iter else None,
        "moved_at_card_flip": (per_iter[it] if it is not None
                               and it < len(per_iter) else None),
        "iterations_with_moved_gradients": sum(
            m["gradient_rows"] > 0 for m in per_iter),
        "iterations_with_moved_quanta": (
            sum(m["quanta_rows"] > 0 for m in per_iter) if quanta
            else None)}
    if metric is not None:
        res["host_gradients"].update(metric(hbst))
    return launches


def fullsize_held(lgb, counters, cell: str, rec: dict, bst, got: dict,
                  tol: float, rerun, card: str, quanta: bool = True,
                  calls: int = 1, metric=None, raw_of=None,
                  extra=None) -> dict:
    """A cell that may part from its record at a near-tie (C6 on the
    card, C8 and C10 on the CPU): its model against the record, its
    metric (``got``, one name: value) within ``tol`` of the record's, an
    identical model's raw scores of the sample rows (``raw_of(booster)``)
    against the record's host walk, then :func:`host_gradient_rerun`
    (``extra``: more fields of the phase's line).  -> the rerun's
    launches."""
    res = against_record(rec, bst)
    res.update(extra or {})
    (name, value), = got.items()
    want = rec["metrics"][name]
    res[name], res["record_" + name], res["tolerance"] = value, want, tol
    gap = abs(value - want)
    if not gap <= tol:
        raise AssertionError(f"{cell}: {name} {value} is {gap:.3g} from "
                             f"the record's {want} (tolerance {tol})")
    if res["identical"] and raw_of is not None:
        res["sample_raw"] = sample_raw_check(rec, raw_of(bst))
    launches = host_gradient_rerun(lgb, counters, cell, rec, res, rerun,
                                   quanta, calls, metric)
    phase_line(f"fullsize_{cell}", card, **res)
    return launches


def fullsize_binary(lgb, counters, cell: str, rec: dict, fs: dict, X, y,
                    ds, rounds: int, card: str, Xv=None, yv=None,
                    **kw) -> dict:
    """One binary cell: its model from phases 4, 5 or 12 against the
    record, its train (or valid) AUC within ``FULLSIZE_AUC_TOL`` of the
    record's, through :func:`fullsize_held`.  -> the host-gradient run's
    launches."""
    import numpy as np
    from lightgbm_tpu_torch.metric.metrics import binary_auc
    from lightgbm_tpu_torch.serve import compile_model
    bst = fs["booster"]
    rows = np.asarray(rec["sample"]["rows"])
    if Xv is None:
        auc = fs.get("train_auc")
        got, extra = {"train_auc": binary_auc(y, bst.predict(X))
                      if auc is None else auc}, {}
    else:
        # the train AUC of every tree, beside the record's (not held: the
        # two models stop at other iterations)
        got = {"valid_auc": fs["valid_auc"]}
        extra = dict(best_iteration=bst.best_iteration,
                     record_best_iteration=rec["metrics"]["best_iteration"],
                     train_auc=binary_auc(y, bst.predict(
                         X, num_iteration=bst.current_iteration())),
                     record_train_auc=rec["metrics"]["train_auc"])

    def raw_of(b):
        if cell == "serving":
            return compile_model(b).predict_raw(X[rows])
        return b.predict(X[rows], num_iteration=b.current_iteration(),
                         raw_score=True)
    return fullsize_held(
        lgb, counters, cell, rec, bst, got, FULLSIZE_AUC_TOL,
        lambda: train_path(lgb, f"full-size {cell}, gradients from the "
                           f"CPU", counters, rec["params"], ds, rounds,
                           **kw), card, extra=extra, raw_of=raw_of,
        metric=None if Xv is not None else (
            lambda b: {"train_auc": binary_auc(y, b.predict(X))}))


def fullsize_dp_rank(lgb, counters, job, full, rank: int,
                     world: int) -> dict:
    """One rank of phase 31's ``dp2_l2``: the headline's bins with the
    latent as the label, this rank's contiguous half of the rows (the
    JAX package's mesh order), ``lgb.train`` data-parallel."""
    import numpy as np
    z = np.load(job["labels"])["z"]
    n = len(z)
    per = -(-n // world)
    mine = relabel(full, z).subset(np.arange(rank * per,
                                             min(n, (rank + 1) * per)))
    return mg_train(lgb, counters, job["params"], mine, job["iters"])


def fullsize_dp(lgb, ds, X, z32, rec: dict, card: str) -> dict:
    """``dp2_l2``: the L2 headline over a world of two ranks (gloo on one
    card, NCCL on two) against the JAX package's 2-device mesh: both
    ranks' models and the record bitwise, the sample rows' raw scores
    the record's host walk rounded once.  -> launches summed over the
    ranks."""
    import numpy as np
    tmp = tempfile.mkdtemp(prefix="lgbm_fullsize_dp_")
    try:
        t0 = time.time()
        ds._constructed.save_binary(os.path.join(tmp, "headline"))
        labels = os.path.join(tmp, "labels.npz")
        np.savez(labels, z=z32)
        job = os.path.join(tmp, "job.json")
        with open(job, "w") as f:
            json.dump({"bin": os.path.join(tmp, "headline.npz"),
                       "labels": labels, "fullsize": True,
                       "params": FULLSIZE_DP_PARAMS,
                       "iters": FULLSIZE_DP_ITERS}, f)
        ranks = run_rank_world(job, FULLSIZE_DP_WORLD, MG_TIMEOUT_S,
                               "full-size dp2_l2")
        seconds = time.time() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    models = [r["fullsize"]["model"] for r in ranks]
    if any(m != models[0] for m in models):
        raise AssertionError(f"dp2_l2: the ranks' models differ: "
                             f"{first_line_diff(*models[:2])}")
    bst = lgb.Booster(model_str=models[0], device="cuda")
    res = against_record(rec, bst)
    if not res["identical"]:
        raise AssertionError(f"dp2_l2: the ranks' model is not the JAX "
                             f"package's 2-device mesh model: {res}")
    rows = np.asarray(rec["sample"]["rows"])
    res["sample_raw"] = sample_raw_check(rec, bst.predict(X[rows],
                                                          raw_score=True))
    launches = {}
    for r in ranks:
        add_launches(launches, r["fullsize"]["launches"])
        need(r["fullsize"]["launches"], ("route", "hist_active",
                                         "hist_compact", "route_values"),
             f"dp2_l2 rank {r['rank']}", absent=("hist_route",))
    res.update(backend=ranks[0]["backend"],
               devices=[r["device"] for r in ranks],
               steady_ms_per_iter=[r["fullsize"]["steady_ms"]
                                   for r in ranks],
               seconds=round(seconds, 3),
               launches_per_tree=[per_tree(r["fullsize"]["launches"],
                                           FULLSIZE_DP_ITERS)
                                  for r in ranks])
    phase_line("fullsize_dp2_l2", card, **res)
    return launches


# phase 31's cells, in the order the phase runs them
FULLSIZE_CELLS = ("headline_l2", "headline", "small_data", "serving",
                  "dp2_l2", "headline_float", "multiclass", "rank",
                  "stream")


def fullsize_phase(lgb, counters, ds, X, z, small_xy, ds_small, dv_small,
                   card: str, cells=FULLSIZE_CELLS) -> dict:
    """Phase 31: the card's full-size models against the JAX package's
    recorded models (``cells``, by default all nine).  A cell whose model
    an earlier phase did not leave in ``FULLSIZE`` is trained here as its
    record was.  -> launches by path."""
    import numpy as np
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.metric.metrics import binary_auc
    from tools.torch_fullsize_ref import (data_sha256, load_record,
                                          multi_logloss, ndcg10,
                                          store_sha256, stream_store)
    recs = {c: load_record(c) for c in cells}
    y = (z > 0).astype(np.float32)
    z32 = z.astype(np.float32)
    Xs, ys, Xv, yv = small_xy
    Xsv, ysv = serve_train_data(np.random.RandomState(11))
    y5 = class_labels(z, MC_CLASSES)
    if "rank" in cells and "rank" not in FULLSIZE:
        Xr, rel, sizes = rank_data()
        FULLSIZE["rank"] = {"data": (Xr, rel, sizes), "dataset": lgb.Dataset(
            Xr, label=rel, group=sizes,
            params={"max_bin": RANK_PARAMS["max_bin"]}).construct()}
    data = {"headline": (X, y), "headline_l2": (X, z32),
            "small_data": (Xs, ys, Xv, yv), "serving": (Xsv, ysv),
            "headline_float": (X, y), "multiclass": (X, y5),
            "dp2_l2": (X, z32)}
    if "rank" in cells:
        data["rank"] = FULLSIZE["rank"]["data"]
    float_params = dict(HEADLINE_PARAMS, gpu_use_dp=True)
    params = {"headline": (HEADLINE_PARAMS, HEADLINE_ITERS, None),
              "headline_l2": (FULLSIZE_L2_PARAMS, FULLSIZE_L2_ITERS, None),
              "small_data": (TRAIN_CONF, SMALL_ITERS, SMALL_EARLY_STOP),
              "serving": (SERVE_PARAMS, SERVE_ITERS, None),
              "headline_float": (float_params, FLOAT_ITERS, None),
              "multiclass": (MC_PARAMS, MC_ITERS, None),
              "rank": (RANK_PARAMS, RANK_ITERS, None),
              "dp2_l2": (FULLSIZE_DP_PARAMS, FULLSIZE_DP_ITERS, None),
              "stream": (STREAM_PARAMS, STREAM_ITERS, None)}
    for cell, rec in recs.items():
        if cell in data and data_sha256(*data[cell]) \
                != rec["data"]["sha256"]:
            raise AssertionError(f"{cell}: the data's sha256 is not the "
                                 f"record's")
        p, rounds, stop = params[cell]
        if (rec["params"], rec["rounds"], rec["early_stopping_rounds"]) \
                != (p, rounds, stop):
            raise AssertionError(f"{cell}: the record's parameters are not "
                                 f"this script's")
    out = {}

    def timed(cell):
        log(f"phase 31 through {cell}: {time.time() - t0:.1f} s")

    # headline_l2: trained here, bitwise the record
    t0 = time.time()
    if "headline_l2" in cells:
        dsl = relabel(ds, z32)
        bst, _, out["fullsize_l2"] = train_path(
            lgb, "full-size headline_l2", counters, FULLSIZE_L2_PARAMS, dsl,
            FULLSIZE_L2_ITERS)
        need(out["fullsize_l2"], ("route", "route_values", "hist_route",
                                  "hist_compact"), "the full-size L2 path",
             absent=("split_scan",))
        rec = recs["headline_l2"]
        res = against_record(rec, bst)
        pred = bst.predict(X)
        d = pred.astype(np.float64) - z32
        res.update(train_l2=float(np.mean(d * d)),
                   record_train_l2=rec["metrics"]["train_l2"])
        if not res["identical"]:
            raise AssertionError(f"headline_l2: the card's L2 model is not "
                                 f"the JAX package's: {res}")
        rows = np.asarray(rec["sample"]["rows"])
        res["sample_raw"] = sample_raw_check(rec, bst.predict(
            X[rows], raw_score=True))
        phase_line("fullsize_headline_l2", card, **res)
        del bst, dsl
        timed("headline_l2")

    # the binary cells: phases 4, 5 and 12's models, then the CPU's
    # gradients on the card
    if "headline" in cells:
        out["fullsize_headline"] = fullsize_binary(
            lgb, counters, "headline", recs["headline"],
            FULLSIZE["headline"], X, y, ds, HEADLINE_ITERS, card)
    if "small_data" in cells:
        out["fullsize_small_data"] = fullsize_binary(
            lgb, counters, "small_data", recs["small_data"],
            FULLSIZE["small_data"], Xs, ys, ds_small, SMALL_ITERS, card,
            Xv=Xv, yv=yv, valid_sets=[dv_small], valid_names=["valid"],
            early_stopping_rounds=SMALL_EARLY_STOP, verbose_eval=False)
    if "serving" in cells:
        dsv = lgb.Dataset(Xsv, label=ysv,
                          params={"max_bin": SERVE_PARAMS["max_bin"]})
        out["fullsize_serving"] = fullsize_binary(
            lgb, counters, "serving", recs["serving"], FULLSIZE["serving"],
            Xsv, ysv, dsv, SERVE_ITERS, card)
    timed("binary cells")

    # dp2_l2: two ranks, bitwise the JAX package's 2-device mesh
    if "dp2_l2" in cells:
        out["fullsize_dp2_l2"] = fullsize_dp(lgb, ds, X, z32,
                                             recs["dp2_l2"], card)
        timed("dp2_l2")

    def kept(cell, train):
        """The booster an earlier phase left for ``cell``, else one
        trained here as the record was."""
        if "booster" not in FULLSIZE.get(cell, {}):
            FULLSIZE.setdefault(cell, {})["booster"] = train()[0]
        return FULLSIZE[cell]["booster"]

    # the float headline (phase 6): hilo through the float K1 and K3
    if "headline_float" in cells:
        def float_run():
            return train_path(lgb, "full-size headline_float", counters,
                              float_params, ds, FLOAT_ITERS)
        bst = kept("headline_float", float_run)
        auc = FULLSIZE["headline_float"].get("train_auc")
        if auc is None:
            auc = binary_auc(y, bst.predict(X))
        rows = np.asarray(recs["headline_float"]["sample"]["rows"])
        out["fullsize_headline_float"] = fullsize_held(
            lgb, counters, "headline_float", recs["headline_float"], bst,
            {"train_auc": float(auc)}, FULLSIZE_FLOAT_AUC_TOL, float_run,
            card, quanta=False,
            raw_of=lambda b: b.predict(X[rows], raw_score=True),
            metric=lambda b: {"train_auc": float(binary_auc(
                y, b.predict(X)))})
        need(out["fullsize_headline_float"], (
            "hist_route_float", "hist_compact_float", "route",
            "route_values"), "the full-size float headline",
            absent=("hist_route", "hist_compact", "hist_active"))
        del bst
        timed("headline_float")

    # multiclass (phase 17): 5 trees an iteration, softmax
    if "multiclass" in cells:
        ds5 = FULLSIZE.get("multiclass", {}).get("dataset")
        if ds5 is None:
            ds5 = relabel(ds, y5)

        def mc_run():
            return train_path(lgb, "full-size multiclass", counters,
                              MC_PARAMS, ds5, MC_ITERS)
        bst = kept("multiclass", mc_run)
        rows = np.asarray(recs["multiclass"]["sample"]["rows"])
        out["fullsize_multiclass"] = fullsize_held(
            lgb, counters, "multiclass", recs["multiclass"], bst,
            {"train_multi_logloss": multi_logloss(y5, bst.predict(X))},
            FULLSIZE_MC_LOSS_TOL, mc_run, card,
            raw_of=lambda b: b.predict(X[rows], raw_score=True).ravel(),
            metric=lambda b: {"train_multi_logloss": multi_logloss(
                y5, b.predict(X))})
        del bst, ds5
        timed("multiclass")

    # ranking (phase 19): lambdarank's buckets at 136 x 256 bins
    if "rank" in cells:
        Xr, rel, sizes = FULLSIZE["rank"]["data"]
        dsr = FULLSIZE["rank"]["dataset"]

        def rank_run():
            return train_path(lgb, "full-size rank", counters, RANK_PARAMS,
                              dsr, RANK_ITERS)
        bst = kept("rank", rank_run)
        rows = np.asarray(recs["rank"]["sample"]["rows"])
        out["fullsize_rank"] = fullsize_held(
            lgb, counters, "rank", recs["rank"], bst,
            {"train_ndcg10": ndcg10(rel, sizes, bst.predict(
                Xr, raw_score=True))},
            FULLSIZE_NDCG_TOL, rank_run, card,
            raw_of=lambda b: b.predict(Xr[rows], raw_score=True),
            metric=lambda b: {"train_ndcg10": ndcg10(rel, sizes, b.predict(
                Xr, raw_score=True))})
        del bst, Xr, dsr
        timed("rank")

    # the 4,194,304-row stream (phase 8): K5's seeded carry, a block's
    # gradients
    if "stream" in cells:
        rec = recs["stream"]
        tmp = tempfile.mkdtemp(prefix="lgbm_fullsize_stream_")
        try:
            store = stream_store(lgb.outofcore, Config, tmp)
            if store_sha256(store) != rec["data"]["sha256"]:
                raise AssertionError("stream: the store's sha256 is not "
                                     "the record's")
            labels = store.labels_array()

            def stream_run():
                return counted(counters, lambda: lgb.train_streaming(
                    dict(STREAM_PARAMS), store,
                    num_boost_round=STREAM_ITERS, block_rows=STREAM_BLOCK,
                    device="cuda"))

            def stream_auc(g):
                return {"train_auc": float(binary_auc(
                    labels, g.scores.numpy()[:, 0]))}
            g = kept("stream", stream_run)
            rows = np.asarray(rec["sample"]["rows"])
            want = np.array([float.fromhex(v)
                             for v in rec["sample"]["scores"]], np.float32)
            got = g.scores.numpy()[rows, 0]
            out["fullsize_stream"] = fullsize_held(
                lgb, counters, "stream", rec, g, stream_auc(g),
                FULLSIZE_STREAM_AUC_TOL, stream_run, card, quanta=False,
                calls=-(-store.n // STREAM_BLOCK), metric=stream_auc,
                extra={"sample_scores_bitwise": int(np.sum(got == want)),
                       "sample_rows": len(rows)})
            need(out["fullsize_stream"], ("hist_active", "route",
                                          "route_values"),
                 "the full-size stream", absent=("hist_float",))
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        timed("stream")
    FULLSIZE.clear()
    return out


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
    from lightgbm_tpu_torch.ops.histogram import pack_values_q
    card = card_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; {card}")

    # 1. build
    floor_dir = tempfile.mkdtemp(prefix="lgbm_launch_floor_")
    try:
        floor_build = start_launch_floor_build(floor_dir)
        build_s = cuda_build.build_all()
        load_launch_floor(floor_build)
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

    counters = launch_counters()

    # 4. the headline path through the user entry points
    params = dict(HEADLINE_PARAMS)
    bst, head_s, head = train_path(lgb, "headline", counters, params, ds,
                                   HEADLINE_ITERS)
    head_ref = {"params": params, "text": bst.model_to_string(),
                "digest": bst.digest(),
                "digest_trees": bst.digest(include_scores=False)}
    pred = bst.predict(X)
    torch.cuda.synchronize()
    head_ref["pred"] = pred
    auc = binary_auc(y, pred)
    FULLSIZE["headline"] = {"booster": bst, "train_auc": auc}
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
    small_ref = {"stop": bst.current_iteration(),
                 "best": bst.best_iteration, "digest": bst.digest(),
                 "pred": pred}
    FULLSIZE["small_data"] = {"booster": bst, "valid_auc": vauc}
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
    FULLSIZE["headline_float"] = {"booster": bst, "train_auc": auc}
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

    # 22. the model surface: snapshots and resume, rollback, add_valid,
    # refit, prediction early stopping, model IO
    t0 = time.time()
    by_path["model_surface"] = model_surface_phase(
        lgb, counters, ds, X, y, ds_small, dv_small, head_ref, small_ref,
        card)
    log(f"phase 22 {time.time() - t0:.1f} s")

    # 23. the entry surface: sklearn, fobj, feval, init_model,
    # learning_rates, cv, file input
    t0 = time.time()
    by_path["entry_surface"] = entry_surface_phase(
        lgb, counters, ds, X, y, z, ds_small, dv_small, (Xs, ys, Xv, yv),
        head_ref, small_ref, card)
    log(f"phase 23 {time.time() - t0:.1f} s")

    # 24. the boosting variants: GOSS, DART, random forests
    t0 = time.time()
    by_path["variants"] = variants_phase(lgb, counters, ds, X, y, ds_small,
                                         dv_small, (Xs, ys, Xv, yv), params,
                                         card)
    log(f"phase 24 {time.time() - t0:.1f} s")

    # 25. wide bins and deep trees
    t0 = time.time()
    dsw = wide_dataset(lgb, X, y)
    by_path["wide"] = wide_phase(lgb, counters, X, y, ds, dsw, params, card,
                                 entries)
    log(f"phase 25 {time.time() - t0:.1f} s")

    # 26. wide and deep streams, libsvm and the seams, telemetry
    t0 = time.time()
    by_path["wide_stream"] = wide_stream_phase(lgb, counters, ds, dsw,
                                               head_ref, card, entries)
    log(f"phase 26 {time.time() - t0:.1f} s")

    # 27. the runtime contracts and the live health plane
    t0 = time.time()
    by_path["observability"] = observability_phase(
        lgb, counters, ds, dsw, ds_small, head_ref, card)
    del dsw
    SERVE_STATE.clear()
    log(f"phase 27 {time.time() - t0:.1f} s")

    # 28. multiple GPUs: data-, feature- and voting-parallel, loading
    t0 = time.time()
    by_path["multi_gpu"] = multi_gpu_phase(
        lgb, ds, X, y, z, 1e3 * head_s / HEADLINE_ITERS, card)
    log(f"phase 28 {time.time() - t0:.1f} s")

    # 29. elastic training: the S-shard stream over a world of processes
    # that die and join, barrier snapshots, the multi-process barrier
    t0 = time.time()
    by_path["elastic"] = elastic_phase(lgb, ds, card)
    log(f"phase 29 {time.time() - t0:.1f} s")

    # 30. the command-line application and the C API
    t0 = time.time()
    by_path.update(app_phase(lgb, X, y, (Xs, ys, Xv, yv), head_ref,
                             small_ref, card))
    log(f"phase 30 {time.time() - t0:.1f} s")

    # 31. full-size parity: the card's models against the JAX package's
    t0 = time.time()
    by_path.update(fullsize_phase(lgb, counters, ds, X, z,
                                  (Xs, ys, Xv, yv), ds_small, dv_small,
                                  card))
    log(f"phase 31 {time.time() - t0:.1f} s")

    for e in entries:
        # a categorical entry counts its kernel's launches on the
        # categorical paths only
        key = e.get("counter", e["name"])
        e["launches_by_path"] = {p: c.get(key, 0)
                                 for p, c in by_path.items()
                                 if "counter" not in e
                                 or p.startswith("cat_")}
        e["launches"] = sum(e["launches_by_path"].values())
        if "seeded" in e:
            e["seeded"]["launches_by_path"] = {
                p: c.get("hist_wide_seeded", 0) for p, c in by_path.items()}
            e["seeded"]["launches"] = sum(
                e["seeded"]["launches_by_path"].values())
    print(json.dumps({"kernels": entries}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 6 and sys.argv[1] == "--multi-gpu-rank":
        sys.exit(mg_rank(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]),
                         int(sys.argv[5])))
    if len(sys.argv) == 4 and sys.argv[1] == "--elastic-worker":
        sys.exit(elastic_worker(sys.argv[2], sys.argv[3]))
    if len(sys.argv) == 4 and sys.argv[1] == "--app-child":
        sys.exit(app_child(sys.argv[2], sys.argv[3]))
    sys.exit(main())
