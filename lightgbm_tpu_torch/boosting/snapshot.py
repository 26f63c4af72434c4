"""Atomic, resumable training snapshots (the plain half of the JAX
package's ``boosting/snapshot.py``; the fork's first addition to
upstream, whose ``gbdt.cpp:309-327`` writes snapshots it never loads).

* **Atomic writes**: every file lands as ``tmp + os.replace``
  (``utils/file_io.atomic_write``); a crash mid-write leaves a stray
  ``.tmp``, never a torn file under a published name.
* **Commit marker**: a snapshot is (model text, f32 score state, JSON
  manifest); the manifest is written last and carries the sha256 and
  size of the other two, so a snapshot is valid iff its manifest exists
  and verifies.  Loading walks the candidates newest first and takes
  the latest one that validates.
* **Exact resume**: the state sidecar holds the f32 training scores
  (and each valid set's) bit for bit, so a resumed run continues in the
  numeric state the dead run was in and writes a model byte-identical
  to an uninterrupted run.  Without a usable sidecar the scores are
  replayed from the trees.
* **Retention**: only the newest ``snapshot_keep`` snapshots survive a
  write.

The layout and the manifest (version 1) are the JAX package's, so a
snapshot written by either package validates and resumes in the other::

    <prefix>.snapshot_iter_<N>                 model text
    <prefix>.snapshot_iter_<N>.state.npz       f32 scores (train + valids)
    <prefix>.snapshot_iter_<N>.manifest.json   commit marker + checksums

The port trains on one device: ``world_size`` is 1.  The elastic
barrier snapshots and the snapshot spans and counters are not ported
(ROADMAP A12, A13).
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..utils.file_io import atomic_write
from ..utils.log import log_info, log_warning

MANIFEST_VERSION = 1
_SNAP_RE = re.compile(r"\.snapshot_iter_(\d+)\.manifest\.json$")


def snapshot_paths(prefix: str, iteration: int) -> Tuple[str, str, str]:
    base = f"{prefix}.snapshot_iter_{iteration}"
    return base, base + ".state.npz", base + ".manifest.json"


def _sha256_bytes(payload: bytes) -> str:
    return hashlib.sha256(payload).hexdigest()


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def config_hash(config) -> str:
    """Stable hash of the training hyper-parameters (a resume sanity
    check): path-like outputs, the resume and retention knobs and
    verbosity are left out, since none changes what is computed."""
    d = config.to_dict()
    for k in ("output_model", "output_result", "data", "valid_data",
              "input_model", "machine_list_file", "machines",
              "resume_from", "snapshot_keep", "snapshot_freq", "verbose",
              "telemetry_output"):
        d.pop(k, None)
    payload = json.dumps(d, sort_keys=True, default=str)
    return _sha256_bytes(payload.encode())


def write_snapshot(gbdt, iteration: int) -> str:
    """Write one snapshot of ``gbdt`` at ``iteration`` under its
    ``output_model`` prefix and prune to its ``snapshot_keep``; returns
    the model path.  A failed write raises: its torn bytes stay in
    ``.tmp`` files that never shadow a valid snapshot."""
    c = gbdt.config
    prefix = c.output_model
    model_path, state_path, manifest_path = snapshot_paths(prefix, iteration)

    model_text = gbdt.save_model_to_string(-1)
    # two chunks: the `snapshot.write` fault point sits between them
    atomic_write(model_path, model_text, chunks=2)

    state = {}
    if gbdt.train_set is not None:
        state["scores"] = gbdt.scores.cpu().numpy()
        for i, vs in enumerate(gbdt._valid_scores):
            state[f"valid_scores_{i}"] = vs.cpu().numpy()
    if state:
        buf = io.BytesIO()
        np.savez(buf, **state)
        atomic_write(state_path, buf.getvalue(), binary=True)

    es = gbdt._es_state
    manifest = {
        "version": MANIFEST_VERSION,
        "iteration": int(iteration),
        "world_size": 1,
        "num_trees": int(gbdt.num_trees()),
        "num_tree_per_iteration": int(max(1, gbdt.num_tree_per_iteration)),
        "init_score_value": float(gbdt.init_score_value),
        "config_hash": config_hash(c),
        "model_file": os.path.basename(model_path),
        "model_size": len(model_text.encode()),
        "model_sha256": _sha256_bytes(model_text.encode()),
        "state_file": os.path.basename(state_path) if state else "",
        "state_sha256": _sha256_file(state_path) if state else "",
        "best_scores": dict(es["best_scores"]),
        "best_iter": {k: int(v) for k, v in es["best_iter"].items()},
        "key_order": list(es["key_order"]),
        "extra_state": gbdt.snapshot_extra_state(),
    }
    # the manifest last: its appearance commits the snapshot
    atomic_write(manifest_path, json.dumps(manifest, indent=1))
    log_info(f"saved snapshot to {model_path} (iteration {iteration})")
    prune_snapshots(prefix, c.snapshot_keep)
    return model_path


def list_snapshots(prefix_or_dir: str) -> List[Tuple[int, str]]:
    """Every snapshot manifest of a prefix (or directory) as
    ``(iteration, manifest_path)``, newest first."""
    if os.path.isdir(prefix_or_dir):
        directory, stem = prefix_or_dir, ""
    else:
        directory = os.path.dirname(prefix_or_dir) or "."
        stem = os.path.basename(prefix_or_dir)
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    out = []
    for name in names:
        m = _SNAP_RE.search(name)
        if m is None:
            continue
        if stem and not name.startswith(stem + ".snapshot_iter_"):
            continue
        out.append((int(m.group(1)), os.path.join(directory, name)))
    out.sort(key=lambda t: -t[0])
    return out


def validate_snapshot(manifest_path: str) -> Optional[Dict]:
    """Parse and verify one snapshot: the manifest (with ``model_path``
    and ``state_path`` resolved), or None when anything is wrong (a
    missing file, truncation, a checksum mismatch, unparsable JSON).  A
    state sidecar that fails its checksum only empties ``state_path``:
    resume then replays the trees."""
    try:
        with open(manifest_path) as f:
            manifest = json.load(f)
    except (OSError, ValueError):
        return None
    directory = os.path.dirname(manifest_path) or "."
    model_path = os.path.join(directory, manifest.get("model_file", ""))
    try:
        if os.path.getsize(model_path) != manifest["model_size"]:
            return None
        if _sha256_file(model_path) != manifest["model_sha256"]:
            return None
    except (OSError, KeyError):
        return None
    manifest["model_path"] = model_path
    state_file = manifest.get("state_file", "")
    manifest["state_path"] = ""
    if state_file:
        state_path = os.path.join(directory, state_file)
        try:
            if _sha256_file(state_path) == manifest.get("state_sha256"):
                manifest["state_path"] = state_path
            else:
                log_warning(f"snapshot state {state_path} fails its "
                            f"checksum; resume will replay trees instead")
        except OSError:
            log_warning(f"snapshot state {state_path} is missing; "
                        f"resume will replay trees instead")
    return manifest


def latest_valid_snapshot(prefix_or_dir: str) -> Optional[Dict]:
    """The newest snapshot that validates; torn or corrupt ones are
    skipped with a warning."""
    for it, manifest_path in list_snapshots(prefix_or_dir):
        manifest = validate_snapshot(manifest_path)
        if manifest is not None:
            return manifest
        log_warning(f"snapshot at iteration {it} is invalid "
                    f"({manifest_path}); trying the previous one")
    return None


def resolve_snapshot(path_or_dir: str) -> Optional[Dict]:
    """A manifest path, a snapshot model path, a prefix or a directory
    -> a validated manifest, or None."""
    if path_or_dir.endswith(".manifest.json"):
        return validate_snapshot(path_or_dir)
    if os.path.isfile(path_or_dir + ".manifest.json"):
        return validate_snapshot(path_or_dir + ".manifest.json")
    return latest_valid_snapshot(path_or_dir)


def prune_snapshots(prefix: str, keep: int) -> None:
    """Drop all but the newest ``keep`` snapshots, with the ``.tmp``
    residue of the dropped ones."""
    if keep <= 0:
        return
    for _, manifest_path in list_snapshots(prefix)[keep:]:
        base = manifest_path[:-len(".manifest.json")]
        for path in (base, base + ".state.npz", manifest_path,
                     base + ".tmp", base + ".state.npz.tmp",
                     manifest_path + ".tmp"):
            try:
                os.unlink(path)
            except OSError:
                pass
