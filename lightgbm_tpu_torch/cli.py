"""Command-line application.

Counterpart of the reference CLI (``src/main.cpp:4-23`` ->
``Application``; ``src/application/application.cpp:49-82`` reads the
configuration, ``:239-342`` trains and predicts) and of the JAX
package's ``cli.py``: the same ``key=value`` configuration file
(``train.conf``), ``task=train|predict|refit|convert_model``
(``config.h:89-91``), data and ``valid_data`` files with their
``.weight`` / ``.query`` / ``.init`` side files, model save and load, and
the snapshot behaviour with resume: ``--resume`` (or
``resume_from=<path|prefix|dir|auto>``) restarts a preempted run from
its newest valid snapshot and continues to the original
``num_iterations``.

``num_machines > 1`` joins a ``torch.distributed`` process group through
the machine list (``machines=ip:port,...`` or ``machine_list_file=``,
``parallel/mesh.py:init_distributed_from_machines``); every rank runs the
same configuration, trains the same model, and rank 0 saves it.  Ranks
that share a card (or run on the CPU) use gloo.

Training runs on ``cuda`` unless the configuration says ``device=cpu``.

Usage:
    python -m lightgbm_tpu_torch config=train.conf [key=value ...] [--resume]
"""
from __future__ import annotations

import sys
from typing import Dict, List

import numpy as np

from .config import Config
from .utils.log import log_info, log_warning, set_verbosity


def parse_cli_args(argv: List[str]) -> Dict[str, str]:
    """argv ``key=value`` pairs and the optional configuration file
    (``application.cpp:49-82``: arguments override the file)."""
    kv: Dict[str, str] = {}
    for arg in argv:
        if "=" not in arg:
            if arg.lstrip("-") == "resume":
                # a bare --resume picks up the newest valid snapshot
                # under the output_model prefix
                kv["resume_from"] = "auto"
                continue
            log_warning(f"unknown argument {arg!r} (expected key=value)")
            continue
        k, v = arg.split("=", 1)
        kv[k.strip().lstrip("-")] = v.strip()
    file_kv: Dict[str, str] = {}
    cfg_path = kv.get("config", kv.get("config_file"))
    if cfg_path:
        file_kv = parse_config_file(cfg_path)
    file_kv.update(kv)
    file_kv.pop("config", None)
    file_kv.pop("config_file", None)
    return file_kv


def parse_config_file(path: str) -> Dict[str, str]:
    """``key=value`` lines, ``#`` comments (``application.cpp:60-77``)."""
    out: Dict[str, str] = {}
    from .utils.file_io import open_read
    with open_read(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line or "=" not in line:
                continue
            k, v = line.split("=", 1)
            out[k.strip()] = v.strip()
    return out


def run(argv: List[str]) -> int:
    params = parse_cli_args(argv)
    cfg = Config.from_params(params)
    set_verbosity(cfg.verbose)
    if cfg.telemetry_output:
        # the JSONL trace (per-rank suffixed once the group is up), and
        # <path>.summary.json after training (rank 0's merged summary in
        # a multi-process run)
        from . import obs
        obs.enable(trace_path=cfg.telemetry_output)
    task = cfg.task
    if cfg.num_machines > 1:
        _init_network(cfg)
    if task == "train":
        _run_train(cfg, params)
    elif task in ("predict", "prediction", "test"):
        _run_predict(cfg, params)
    elif task == "refit":
        _run_refit(cfg, params)
    elif task == "convert_model":
        _run_convert(cfg, params)
    else:
        raise ValueError(f"unknown task {task!r}")
    return 0


def machine_list(cfg: Config) -> str:
    """``machines=`` or the lines of ``machine_list_file`` (the
    reference's ``mlist.txt``: ``ip port`` a line) as ``ip:port,...``."""
    if cfg.machines:
        return cfg.machines
    if cfg.machine_list_file:
        from .utils.file_io import open_read
        with open_read(cfg.machine_list_file) as f:
            return ",".join(":".join(ln.split()) for ln in f if ln.strip())
    raise ValueError(
        "num_machines > 1 needs machines=ip:port,... or "
        "machine_list_file= (reference mlist.txt semantics)")


def _init_network(cfg: Config) -> None:
    """Reference ``Application`` -> ``Network::Init``
    (``application.cpp:249-254``, ``linkers_socket.cpp``): every machine
    runs the same configuration; the machine list names the world, its
    first entry hosts the rendezvous, and each process finds its rank by
    its local endpoint in the list.  A process already in a group keeps
    it."""
    from .parallel import mesh
    if mesh.is_initialized():
        return
    mesh.init_distributed_from_machines(machine_list(cfg),
                                        cfg.local_listen_port,
                                        cfg.num_machines, device=cfg.device)
    rank, world = mesh.rank_world()
    log_info(f"distributed: rank {rank} of {world} joined the group")


def _run_train(cfg: Config, params) -> None:
    from .basic import Dataset
    from .engine import train
    from .parallel.mesh import rank_world

    if not cfg.data:
        raise ValueError("task=train requires data=<file>")
    train_set = Dataset(cfg.data, params=params)
    valid_sets = [Dataset(v, params=params, reference=train_set)
                  for v in cfg.valid_data]
    valid_names = [f"valid_{i}" for i in range(len(valid_sets))]
    resume = cfg.resume_from or None
    # as the JAX package's CLI: input_model goes in as init_model too,
    # besides the booster's own load of it (ROADMAP C33)
    booster = train(params, train_set, num_boost_round=cfg.num_iterations,
                    valid_sets=valid_sets, valid_names=valid_names,
                    init_model=(cfg.input_model or None)
                    if not resume else None,
                    early_stopping_rounds=cfg.early_stopping_round or None,
                    verbose_eval=cfg.output_freq,
                    resume_from=resume)
    if rank_world()[0] == 0:       # every rank holds the same model
        booster.save_model(cfg.output_model)
        log_info(f"finished training; model saved to {cfg.output_model}")
    _write_telemetry_summary(cfg)


def _write_telemetry_summary(cfg: Config) -> None:
    """After a traced run: every rank's summary merged over the process
    group, written by rank 0 as ``<telemetry_output>.summary.json`` (one
    process: its own summary, the same file name)."""
    if not cfg.telemetry_output:
        return
    from . import obs
    from .parallel.mesh import rank_world
    rank, world = rank_world()
    merged = None
    if world > 1:
        merged = obs.merged_summary()
        if rank != 0:
            return
    path = cfg.telemetry_output + ".summary.json"
    obs.write_summary(path, merged)
    log_info(f"telemetry summary written to {path}")


def _load_booster(cfg: Config, params):
    from .basic import Booster
    if not cfg.input_model:
        raise ValueError(f"task={cfg.task} requires input_model=<file>")
    return Booster(params=dict(params), model_file=cfg.input_model)


def _run_predict(cfg: Config, params) -> None:
    from .io.loader import parse_file
    booster = _load_booster(cfg, params)
    X = parse_file(cfg.data, cfg)[0]
    if cfg.is_predict_leaf_index:
        out = booster.predict(X, pred_leaf=True,
                              num_iteration=cfg.num_iteration_predict)
    elif cfg.is_predict_contrib:
        out = booster.predict(X, pred_contrib=True,
                              num_iteration=cfg.num_iteration_predict)
    else:
        out = booster.predict(X, raw_score=cfg.is_predict_raw_score,
                              num_iteration=cfg.num_iteration_predict)
    out = np.asarray(out)
    if out.ndim == 1:
        out = out[:, None]
    from .utils.file_io import open_write
    with open_write(cfg.output_result) as f:
        np.savetxt(f, out, delimiter="\t", fmt="%.9g")
    log_info(f"finished prediction; results saved to {cfg.output_result}")


def _run_refit(cfg: Config, params) -> None:
    """``task=refit`` (``application.cpp:293-318``, ``KRefitTree``): the
    model's leaf outputs re-estimated on the rows of ``data`` (its label,
    weights and side files) with decay 0.9, the JAX package's CLI's; the
    saved model's ``feature_infos`` are the file's, as there.  Rows reach
    their leaves through the compiled predictor's walk over the raw
    values, not through bins of the file's own mappers as in the JAX
    package (ROADMAP C21): on the training file the two agree."""
    from .basic import Dataset
    from .boosting.gbdt import feature_infos
    from .io.loader import parse_file
    booster = _load_booster(cfg, params)
    data = Dataset(cfg.data, params=dict(params)).construct()._constructed
    g = booster._gbdt
    g.refit_rows(parse_file(cfg.data, cfg)[0], data.metadata)
    g._loaded_feature_infos = feature_infos(data.mappers)
    booster.save_model(cfg.output_model)
    log_info(f"finished refit; model saved to {cfg.output_model}")


def _run_convert(cfg: Config, params) -> None:
    """``task=convert_model``: if-else C++ (``gbdt_model_text.cpp:51-233``,
    ``ModelToIfElse``) into ``convert_model``."""
    from .models.codegen import model_to_ifelse
    booster = _load_booster(cfg, params)
    from .utils.file_io import open_write
    with open_write(cfg.convert_model) as f:
        f.write(model_to_ifelse(booster._gbdt))
    log_info(f"model converted to if-else code at {cfg.convert_model}")


def main(argv: List[str] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__)
        return 1
    try:
        return run(argv)
    finally:
        from .parallel import mesh
        mesh.destroy()


if __name__ == "__main__":
    sys.exit(main())
