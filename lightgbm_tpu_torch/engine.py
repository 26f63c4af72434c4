"""``train`` and ``cv`` — the reference's training entry points
(``python-package/lightgbm/engine.py:18``, ``:312``), on the JAX
package's per-iteration loop (its ``engine.py:61-260``): custom
objectives (``fobj``) and evaluation functions (``feval``), continued
training from ``init_model``, ``learning_rates`` through
``reset_parameter``, validation sets, evaluation records, early
stopping, callbacks, snapshots every ``snapshot_freq`` iterations and
resume from them.  The JAX package's fused-window fast path builds the
same model and is not ported.  ``cv`` is the JAX package's
(``engine.py:269-391``): the same folds from the same seeds, each
fold's Booster on the device.  ``predict`` — the module-level
prediction entry point."""
from __future__ import annotations

import collections
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np

from . import callback as callback_mod
from . import obs
from .basic import Booster, Dataset
from .config import canonicalize_params
from .utils.log import log_info


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100,
          valid_sets: Optional[Sequence[Dataset]] = None,
          valid_names: Optional[Sequence[str]] = None,
          fobj=None, feval=None, init_model=None,
          feature_name="auto", categorical_feature="auto",
          early_stopping_rounds: Optional[int] = None,
          evals_result: Optional[Dict] = None,
          verbose_eval=True, learning_rates=None,
          keep_training_booster: bool = False,
          callbacks: Optional[Sequence] = None,
          resume_from: Optional[str] = None, device=None) -> Booster:
    """Train one model on ``device`` (default: the ``device`` parameter,
    ``cuda`` unless set).  ``num_iterations`` in ``params`` overrides
    ``num_boost_round`` and ``early_stopping_round`` sets
    ``early_stopping_rounds``, as in the reference.  With early stopping
    ``best_iteration`` is the 1-based iteration of the best score of the
    first valid metric that stopped; ``predict`` uses it by default.
    ``categorical_feature`` other than ``"auto"`` overrides the training
    set's (indices or column names), ``feature_name`` likewise its
    names.

    ``fobj(scores, train_set) -> (grad, hess)`` replaces the objective
    (``objective`` becomes ``none``: raw scores, no ``boost_from_average``);
    ``feval(scores, dataset) -> (name, value, higher_is_better)`` (or a
    list of them) is evaluated after the built-in metrics on every
    evaluated set.  Both see host numpy scores, class-major ``[n * K]``
    for ``fobj`` and ``[n, K]`` for ``feval`` when K > 1.
    ``init_model`` (a model file, a model string or a ``Booster``)
    continues training: its trees go in front and are replayed into the
    training scores (``GBDT.merge_from``), and ``num_boost_round`` more
    iterations follow.  ``learning_rates`` (a list as long as the run, or
    a function of the iteration) sets each iteration's shrinkage
    (``callback.reset_parameter``).  ``keep_training_booster=False``
    lets the Booster drop its training ``Dataset`` at the end.

    ``snapshot_freq > 0`` writes an atomic snapshot under the
    ``output_model`` prefix every that many iterations, after the
    iteration's callbacks ran (``boosting/snapshot.py``; the newest
    ``snapshot_keep`` are kept).  ``resume_from`` (or the parameter of
    that name) restores a run from its latest valid snapshot: a
    snapshot or manifest path, an ``output_model`` prefix, a directory,
    or ``"auto"``/``"latest"`` for this run's ``output_model`` prefix.
    The valid sets attach first, and training continues from the
    restored iteration toward ``num_boost_round`` in total, bit for bit
    where the snapshot carries its score state.  In a multi-process run
    every rank writes through the commit barrier of
    ``GBDT.save_snapshot`` (each rank's scores in its own state file)
    and resumes its own rows; a snapshot resumes only on a world of the
    size that wrote it.

    ``telemetry_output=<path>`` (or ``LGBM_TPU_TRACE``) enables the
    telemetry of ``obs/telemetry.py`` and streams its JSONL trace there;
    the run summary is ``lgb.obs.summary()`` either way."""
    params = canonicalize_params(dict(params or {}))
    if params.get("telemetry_output"):
        obs.enable(trace_path=str(params["telemetry_output"]))
    with obs.span("engine.train"):
        return _train(params, train_set, num_boost_round, valid_sets,
                      valid_names, fobj, feval, init_model, feature_name,
                      categorical_feature, early_stopping_rounds,
                      evals_result, verbose_eval, learning_rates,
                      keep_training_booster, callbacks, resume_from, device)


def _train(params, train_set, num_boost_round, valid_sets, valid_names,
           fobj, feval, init_model, feature_name, categorical_feature,
           early_stopping_rounds, evals_result, verbose_eval,
           learning_rates, keep_training_booster, callbacks, resume_from,
           device) -> Booster:
    if resume_from is None and params.get("resume_from"):
        resume_from = str(params["resume_from"])
    if "num_iterations" in params:
        num_boost_round = int(params["num_iterations"])
    params["num_iterations"] = num_boost_round
    if early_stopping_rounds is None and params.get("early_stopping_round"):
        early_stopping_rounds = int(params["early_stopping_round"])
    params.pop("early_stopping_round", None)
    if resume_from and init_model is not None:
        raise ValueError("resume_from and init_model are mutually "
                         "exclusive: a resumed run continues its own "
                         "snapshot, not another model")
    if fobj is not None:
        params["objective"] = "none"

    if feature_name != "auto":
        train_set.feature_name = feature_name
    if categorical_feature != "auto":
        train_set.categorical_feature = categorical_feature
    booster = Booster(params=params, train_set=train_set, device=device)
    if init_model is not None:
        _continue_training(booster, _model_text(init_model))
    valid_names = list(valid_names or [])
    for i, vs in enumerate(valid_sets or []):
        name = valid_names[i] if i < len(valid_names) else f"valid_{i}"
        if vs is train_set:
            # the train set in valid_sets means "report training metrics
            # under this name"
            booster._train_data_name = name
            params["is_training_metric"] = True
            continue
        booster.add_valid(vs, name)

    gbdt = booster._gbdt
    if resume_from:
        target = resume_from
        if target in ("auto", "latest"):
            target = gbdt.config.output_model
        with obs.span("snapshot.resume"):
            gbdt.resume_from_snapshot(target)
        booster._serve_cache = {}
    start_iter = gbdt.iter if resume_from else 0
    snapshot_freq = gbdt.config.snapshot_freq

    cbs = list(callbacks or [])
    if verbose_eval is True:
        cbs.append(callback_mod.print_evaluation())
    elif isinstance(verbose_eval, int) and verbose_eval > 1:
        cbs.append(callback_mod.print_evaluation(verbose_eval))
    if early_stopping_rounds is not None and early_stopping_rounds > 0:
        if not gbdt.valid_sets:
            raise ValueError("For early stopping, at least one validation "
                             "set is required")
        cbs.append(callback_mod.early_stopping(
            early_stopping_rounds, verbose=bool(verbose_eval)))
    if evals_result is not None:
        cbs.append(callback_mod.record_evaluation(evals_result))
    if learning_rates is not None:
        cbs.append(callback_mod.reset_parameter(learning_rate=learning_rates))
    cbs_before = sorted(
        (cb for cb in cbs if getattr(cb, "before_iteration", False)),
        key=lambda cb: getattr(cb, "order", 0))
    cbs_after = sorted(
        (cb for cb in cbs if not getattr(cb, "before_iteration", False)),
        key=lambda cb: getattr(cb, "order", 0))

    with obs.span("gbdt.train"):
        _boost(booster, params, fobj, feval, start_iter, num_boost_round,
               cbs_before, cbs_after, snapshot_freq)
    gbdt.trim_trailing_stumps()
    if booster.best_iteration <= 0:
        booster.best_iteration = booster.current_iteration()
    if not keep_training_booster:
        booster.free_dataset()
    return booster


def _boost(booster: Booster, params, fobj, feval, start_iter: int,
           num_boost_round: int, cbs_before, cbs_after,
           snapshot_freq: int) -> None:
    """The per-iteration loop: update, evaluation, callbacks, snapshots;
    the ``gbdt.iteration`` and ``gbdt.eval`` spans, the ``train_stop``
    and ``early_stop`` events and the ``gbdt.iterations`` and
    ``gbdt.num_trees`` gauges of the JAX package's loop.

    The runtime contracts and the health plane ride the JAX package's
    seams (its ``GBDT.train`` and ``_train``), an iteration in place of
    its fused window: the ops plane mounted and the stall watchdog armed
    around each update (``obs/ops_plane.py``, ``obs/health.py``), the
    trace contract's steady mark after the first iteration
    (``obs/trace_contract.py``), a memory sample
    (``obs/mem_contract.py``), a digest (``obs/determinism.py``) and the
    scores checked by the sentinels and the ulp contract
    (``obs/num_contract.py``; one host copy for both when the latter is
    on) at every iteration boundary, the windowed
    profile (``obs/profiler.py``), and the ``gbdt.dispatch_gap_s``
    counter: host time between one update's return and the next
    update."""
    from .obs import determinism, health, num_contract, ops_plane
    from .obs.mem_contract import maybe_watermark
    from .obs.profiler import maybe_profile
    from .obs.trace_contract import maybe_track
    gbdt = booster._gbdt
    resumed = start_iter > 0
    if determinism.enabled() and not resumed:
        determinism.reset()
    if num_contract.enabled() and not resumed:
        num_contract.reset()
    ops_plane.mount("train")
    wd = health.Watchdog.maybe("train")
    # LGBM_TPU_SENTINELS=1 turns the health plane on without a mount
    health.sentinels_enabled()
    health.mark_warming("train")
    try:
        with maybe_track() as tracker, \
                maybe_watermark("gbdt", device=gbdt.device) as wm, \
                maybe_profile("gbdt", device=gbdt.device) as prof:
            _iterations(booster, params, fobj, feval, start_iter,
                        num_boost_round, cbs_before, cbs_after,
                        snapshot_freq, wd, tracker, wm, prof)
    finally:
        if wd is not None:
            wd.stop()
    obs.gauge_set("gbdt.iterations", int(gbdt.iter))
    obs.gauge_set("gbdt.num_trees", int(gbdt._num_models()))
    if obs.enabled():
        c = obs.summary()["counters"]
        gaps = c.get("gbdt.dispatch_gaps", 0)
        if gaps:
            obs.gauge_set("gbdt.dispatch_gap_mean_s",
                          c.get("gbdt.dispatch_gap_s", 0.0) / gaps)


def _iterations(booster: Booster, params, fobj, feval, start_iter: int,
                num_boost_round: int, cbs_before, cbs_after,
                snapshot_freq: int, wd, tracker, wm, prof) -> None:
    from .boosting.gbdt import mem_leak_fault
    from .obs import determinism, health, num_contract
    gbdt = booster._gbdt
    train_metric = bool(params.get("is_training_metric"))
    t_ret = None                        # the last update's return
    for it in range(start_iter, num_boost_round):
        env = callback_mod.CallbackEnv(
            model=booster, params=params, iteration=it,
            begin_iteration=start_iter, end_iteration=num_boost_round,
            evaluation_result_list=None)
        for cb in cbs_before:
            cb(env)
        if t_ret is not None and obs.enabled():
            obs.counter_add("gbdt.dispatch_gap_s",
                            time.perf_counter() - t_ret)
            obs.counter_add("gbdt.dispatch_gaps")
        if wd is not None:
            wd.arm("gbdt.iteration", it=it, window=1)
            health.stall_fault(wd)
        try:
            with obs.span("gbdt.iteration", it=it):
                stop = booster.update(fobj=fobj)
        finally:
            if wd is not None:
                wd.disarm()
        t_ret = time.perf_counter()
        # the first iteration done == warmup over (idempotent)
        tracker.mark_steady()
        health.mark_ready()
        if prof is not None and prof.window(it=gbdt.iter):
            t_ret = None                # profiler work is not host gap
        mem_leak_fault(gbdt.iter, gbdt.device)
        if wm is not None:
            wm.sample("gbdt.iteration", it=gbdt.iter)
            if gbdt.iter & (gbdt.iter - 1) == 0:
                # at power-of-two iterations: the probe walks the heap
                wm.check_inplace(gbdt.scores.shape, gbdt.scores.dtype,
                                 gbdt.device, gbdt.score_state_tensors)
        if determinism.enabled():
            determinism.window_digest(gbdt, gbdt.iter)
        sentinels = health.sentinels_enabled()
        if num_contract.enabled():
            # one host copy for both consumers
            s_np = gbdt.scores.cpu().numpy()
            if sentinels:
                health.check_scores(s_np, window=gbdt.iter)
            num_contract.window_check(s_np, it=gbdt.iter)
        elif sentinels:
            # the sentinel alone checks on the scores' device: a host
            # copy only when a value is not finite
            health.check_scores(gbdt.scores, window=gbdt.iter)
        if stop:
            log_info(f"training stopped at iteration {it + 1}: no further "
                     f"splits possible")
            obs.event("train_stop", "no_more_splits", iteration=gbdt.iter)
            break
        results = []
        with obs.span("gbdt.eval", it=it):
            if train_metric:
                results.extend(booster.eval_train(feval))
            results.extend(booster.eval_valid(feval))
        if gbdt._pr is not None and results:
            results = _sync_window(results, gbdt.iter)
        if results and health.sentinels_enabled():
            health.check_metrics(results, window=gbdt.iter)
        env = env._replace(evaluation_result_list=results)
        try:
            for cb in cbs_after:
                cb(env)
        except callback_mod.EarlyStopException as e:
            booster.best_iteration = e.best_iteration + 1
            for name, metric, val, _ in (e.best_score or []):
                booster.best_score.setdefault(name, {})[metric] = val
            if e.stalled is not None:
                obs.event("early_stop", e.stalled, iteration=it,
                          best_iteration=booster.best_iteration)
            break
        if snapshot_freq > 0 and (it + 1) % snapshot_freq == 0:
            gbdt.save_snapshot(it + 1)


def _sync_window(results, it: int):
    """Rank-identical stop decisions in a multi-process run (the JAX
    package's eval-window sync, ``boosting/gbdt.py:1876-1900``): the
    metric values differ across ranks (the training metric is each
    rank's own rows), so every rank adopts rank 0's before the callbacks
    decide.  The collective flight recorder's and the determinism
    contract's fingerprints ride the same gather, and are cross-checked
    there (a mismatch takes a second gather to localize the first
    diverging site and rank)."""
    from .io.distributed import process_allgather
    from .obs import determinism, flight_recorder
    gathered = process_allgather({"vals": [float(r[2]) for r in results],
                                  "fr": flight_recorder.fingerprint(),
                                  "det": determinism.fingerprint()})
    flight_recorder.window_check([g["fr"] for g in gathered],
                                 allgather=process_allgather)
    determinism.window_check([g["det"] for g in gathered], it=it)
    return [(n, m, float(v), h) for (n, m, _, h), v
            in zip(results, gathered[0]["vals"])]


def _model_text(init_model) -> str:
    """A model file path, model text or ``Booster`` -> the model text."""
    if isinstance(init_model, Booster):
        return init_model.model_to_string()
    if "Tree=" in init_model or "\n" in init_model:
        return init_model
    from .utils.file_io import open_read
    with open_read(init_model) as f:
        return f.read()


def _continue_training(booster: Booster, init_model_str: str) -> None:
    """Merge a loaded model's trees in front of ``booster``'s, iteration
    numbering continued (the JAX package's ``engine._continue_training``;
    reference ``boosting.cpp:44-62`` MergeFrom): the loaded trees are
    aligned to the training set's bins and replayed into its scores on
    the device.  As in the JAX package, scores that ``boost_from_average``
    filled keep the average, and the replay of the first loaded tree adds
    its own bias again (ROADMAP C23); the new trees carry no bias."""
    from .boosting.gbdt import GBDT
    from .config import Config
    g = booster._gbdt
    loaded = GBDT(Config.from_params({}), None, g.device)
    loaded.load_model_from_string(init_model_str)
    if loaded.num_tree_per_iteration != g.num_tree_per_iteration:
        raise ValueError("cannot continue training: num_tree_per_iteration "
                         "differs between init_model and params")
    fmap = {f: i for i, f in enumerate(g.train_set.used_features)}
    for t in loaded.models:
        t.align_with_mappers(g.train_set.mappers, fmap)
    g.merge_from(loaded)


def predict(model, data, num_iteration: int = -1, raw_score: bool = False,
            pred_leaf: bool = False, pred_contrib: bool = False,
            device=None):
    """Module-level prediction (the JAX package's ``engine.predict``):
    ``model`` is a :class:`Booster`, a model file path or a model string
    in the reference text format (the latter two are loaded onto the
    ``cuda`` device here, where ``Booster.predict`` then takes the
    compiled predictor); the other arguments are ``Booster.predict``'s.
    """
    if isinstance(model, Booster):
        bst = model
    elif isinstance(model, str):
        if "Tree=" in model or "\n" in model:
            bst = Booster(model_str=model)
        else:
            bst = Booster(model_file=model)
    else:
        raise TypeError(f"model must be a Booster, model file path, or "
                        f"model string, got {type(model).__name__}")
    return bst.predict(data, num_iteration=num_iteration,
                       raw_score=raw_score, pred_leaf=pred_leaf,
                       pred_contrib=pred_contrib, device=device)


def _cv_permutation(seed: int, salt: int, n: int) -> np.ndarray:
    """The fold shuffle as a pure function of ``(seed, salt)`` (the JAX
    package's): one ``permutation`` draw of a fresh ``np.random.Philox``
    stream keyed by the pair, so fold assignments do not depend on any
    earlier draw.  Salts: 0 the row or query permutation, ``1000 +
    class index`` each class's stratified shuffle."""
    gen = np.random.Generator(np.random.Philox(key=[seed, salt]))
    return gen.permutation(n)


def _stratified_folds(label, nfold: int, seed: int, shuffle: bool):
    """Each class's rows (classes in sorted order) shuffled under their
    own ``(seed, 1000 + class index)`` key, then dealt to the folds in
    turn -> ``[(train rows, test rows)] * nfold``."""
    classes = np.unique(label)
    test_folds = np.empty(len(label), int)
    for ci, cls in enumerate(classes):
        idx = np.nonzero(label == cls)[0]
        if shuffle:
            idx = idx[_cv_permutation(seed, 1000 + ci, len(idx))]
        for f in range(nfold):
            test_folds[idx[f::nfold]] = f
    return [(np.nonzero(test_folds != f)[0], np.nonzero(test_folds == f)[0])
            for f in range(nfold)]


def cv_folds(train_set: Dataset, params: Dict[str, Any], folds=None,
             nfold: int = 5, stratified: bool = True, shuffle: bool = True,
             seed: int = 0):
    """``cv``'s folds, ``[(train rows, test rows)]`` (the JAX package's
    rules): ``folds`` as a splitter (``split(X, y)``) or a list; else
    whole queries dealt to folds when the set has groups; else
    stratified by label for the classification objectives; else a
    shuffled deal of the rows."""
    from .obs import determinism
    determinism.rng_site("engine.cv_folds", "seed/salt")
    n = train_set.num_data()
    label = np.asarray(train_set.get_label())
    if folds is not None:
        return list(folds.split(np.zeros(n), label)
                    if hasattr(folds, "split") else folds)
    if train_set.get_group() is not None:
        qb = np.asarray(train_set.get_field("group"))
        nq = len(qb) - 1
        order = _cv_permutation(seed, 0, nq) if shuffle else np.arange(nq)
        fold_of_q = np.empty(nq, int)
        for i, q in enumerate(order):
            fold_of_q[q] = i % nfold
        row_fold = np.repeat(fold_of_q, np.diff(qb))
        return [(np.nonzero(row_fold != f)[0], np.nonzero(row_fold == f)[0])
                for f in range(nfold)]
    if stratified and params.get("objective") in ("binary", "multiclass",
                                                  "multiclassova"):
        return _stratified_folds(label, nfold, seed, shuffle)
    idx = _cv_permutation(seed, 0, n) if shuffle else np.arange(n)
    return [(np.sort(np.concatenate(
        [idx[j::nfold] for j in range(nfold) if j != f])),
        np.sort(idx[f::nfold])) for f in range(nfold)]


def cv(params: Dict[str, Any], train_set: Dataset, num_boost_round: int = 100,
       folds=None, nfold: int = 5, stratified: bool = True,
       shuffle: bool = True, metrics=None, fobj=None, feval=None,
       init_model=None, feature_name="auto", categorical_feature="auto",
       early_stopping_rounds=None, fpreproc=None, verbose_eval=None,
       show_stdv: bool = True, seed: int = 0, callbacks=None,
       device=None) -> Dict:
    """K-fold cross-validation (the JAX package's ``cv``, reference
    ``engine.py:312-448``): one Booster per fold (:func:`cv_folds`), each
    on the fold's training rows of ``train_set`` (binned with its
    mappers, ``Dataset.subset``) with its test rows as the valid set
    ``"valid"``, on ``device``; ``fpreproc(train, test, params)`` may
    replace all three per fold (its parameters carry on to the next
    fold's call, as in the JAX package).  Every iteration updates each fold
    (``fobj`` gives the gradients when set) and records, per valid
    metric (``metrics`` replaces the ``metric`` parameter; ``feval``'s
    follow), ``"<metric>-mean"`` and ``"<metric>-stdv"`` over the folds.
    With ``early_stopping_rounds`` the first metric's mean stops the run
    once it has not improved for that many iterations, and every list
    is cut at its best iteration.  ``feature_name`` and
    ``categorical_feature`` apply to ``train_set`` as in :func:`train`
    (the JAX package ignores them, ROADMAP C24); ``init_model`` and
    ``callbacks`` are not supported and raise.  ``show_stdv`` is
    accepted and unused."""
    for name, given in (("init_model", init_model is not None),
                        ("callbacks", bool(callbacks))):
        if given:
            raise NotImplementedError(
                f"cv({name}=...) is not supported: the JAX package's cv "
                f"ignores it, so the folds would not run as asked "
                f"(ROADMAP C24)")
    params = canonicalize_params(dict(params or {}))
    if metrics:
        params["metric"] = metrics
    if feature_name != "auto":
        train_set.feature_name = feature_name
    if categorical_feature != "auto":
        train_set.categorical_feature = categorical_feature
    train_set.construct()
    fold_list = cv_folds(train_set, params, folds, nfold, stratified,
                         shuffle, seed)

    results = collections.defaultdict(list)
    boosters = []
    for tr_idx, va_idx in fold_list:
        tr = train_set.subset(np.sort(tr_idx))
        va = train_set.subset(np.sort(va_idx))
        if fpreproc is not None:
            tr, va, params = fpreproc(tr, va, dict(params))
        bst = Booster(params=params, train_set=tr, device=device)
        bst.add_valid(va, "valid")
        boosters.append(bst)

    best_iter = num_boost_round
    es_counter = 0
    best_mean = None
    for it in range(num_boost_round):
        iter_results = collections.defaultdict(list)
        for bst in boosters:
            bst.update(fobj=fobj)
            for _, metric, val, hib in bst.eval_valid(feval):
                iter_results[(metric, hib)].append(val)
        for (metric, _), vals in iter_results.items():
            results[f"{metric}-mean"].append(float(np.mean(vals)))
            results[f"{metric}-stdv"].append(float(np.std(vals)))
        if verbose_eval:
            msg = "\t".join(
                f"cv_agg {m}: {results[f'{m}-mean'][-1]:g} + "
                f"{results[f'{m}-stdv'][-1]:g}"
                for (m, _h) in iter_results)
            log_info(f"[{it + 1}]\t{msg}")
        if early_stopping_rounds:
            metric0, hib0 = next(iter(iter_results))
            cur = results[f"{metric0}-mean"][-1]
            if best_mean is None or (cur > best_mean if hib0
                                     else cur < best_mean):
                best_mean = cur
                best_iter = it + 1
                es_counter = 0
            else:
                es_counter += 1
                if es_counter >= early_stopping_rounds:
                    for key in list(results):
                        results[key] = results[key][:best_iter]
                    break
    return dict(results)
