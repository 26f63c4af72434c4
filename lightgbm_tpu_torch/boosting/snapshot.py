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

The manifest records the live ``world_size``; a resume on another world
refuses (``GBDT.resume_from_snapshot``).  In a multi-process run
(``GBDT.save_snapshot``'s commit barrier) each rank writes its own f32
scores to ``<base>.state.rank<r>.npz`` and rank 0's manifest lists them
under ``rank_states`` (file and sha256) in place of the one sidecar, so
every rank of a resumed world takes its own rows' scores back bit for
bit; the JAX package writes no sidecar there and replays the trees.

**Barrier snapshots** (elastic training, ``parallel/elastic.py``; the
JAX package's layout)::

    <prefix>.barrier_iter_<N>               model text        (rank 0)
    <prefix>.barrier_iter_<N>.shard<k>.npz  shard k's scores  (its owner)
    <prefix>.barrier_iter_<N>.manifest.json commit marker     (rank 0, last)

Every rank writes its owned protocol shards' scores, the ranks agree on
``(iteration, model digest)`` and collect the shards' sha256s, and
rank 0 writes the model text and then the manifest.  A barrier is valid
only when its manifest exists and every file it names verifies, so a
SIGKILL anywhere in the sequence leaves a complete barrier or a torn
one that validation skips.

Telemetry: the spans ``snapshot.write`` (with the bytes written),
``snapshot.barrier``, ``snapshot.prune`` and ``snapshot.validate``, the
counters ``snapshot.writes``, ``snapshot.bytes_written``,
``snapshot.barrier_shards`` and ``snapshot.barrier_commits``
(``obs/telemetry.py``).
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..obs import counter_add, span
from ..utils.file_io import atomic_write
from ..utils.log import log_info, log_warning

MANIFEST_VERSION = 1
_SNAP_RE = re.compile(r"\.snapshot_iter_(\d+)\.manifest\.json$")
_BARRIER_RE = re.compile(r"\.barrier_iter_(\d+)\.manifest\.json$")


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


def rank_state_path(prefix: str, iteration: int, rank: int) -> str:
    """A rank's score state of a multi-process snapshot."""
    return f"{prefix}.snapshot_iter_{iteration}.state.rank{rank}.npz"


def _score_state(gbdt) -> bytes:
    """The f32 training scores (and each valid set's) as ``.npz`` bytes;
    empty when the booster has no training set."""
    if gbdt.train_set is None:
        return b""
    state = {"scores": gbdt.scores.cpu().numpy()}
    for i, vs in enumerate(gbdt._valid_scores):
        state[f"valid_scores_{i}"] = vs.cpu().numpy()
    buf = io.BytesIO()
    np.savez(buf, **state)
    return buf.getvalue()


def write_rank_state(gbdt, iteration: int, rank: int) -> str:
    """Publish one rank's score state for a pending multi-process
    snapshot; returns its sha256 (the commit gather carries it into rank
    0's manifest)."""
    payload = _score_state(gbdt)
    atomic_write(rank_state_path(gbdt.config.output_model, iteration, rank),
                 payload, binary=True)
    return _sha256_bytes(payload)


def write_snapshot(gbdt, iteration: int,
                   rank_states: Optional[List[str]] = None) -> str:
    """Write one snapshot of ``gbdt`` at ``iteration`` under its
    ``output_model`` prefix and prune to its ``snapshot_keep``; returns
    the model path.  ``rank_states`` (a multi-process run's, the sha256
    of each rank's :func:`write_rank_state` file in rank order; its
    length is the world size) replaces the one score sidecar.  A failed
    write raises: its torn bytes stay in ``.tmp`` files that never
    shadow a valid snapshot."""
    c = gbdt.config
    prefix = c.output_model
    model_path, state_path, manifest_path = snapshot_paths(prefix, iteration)

    with span("snapshot.write", iteration=int(iteration)) as sp:
        model_text = gbdt.save_model_to_string(-1)
        # two chunks: the `snapshot.write` fault point sits between them
        atomic_write(model_path, model_text, chunks=2)

        payload = b"" if rank_states is not None else _score_state(gbdt)
        if payload:
            atomic_write(state_path, payload, binary=True)

        es = gbdt._es_state
        manifest = {
            "version": MANIFEST_VERSION,
            "iteration": int(iteration),
            "world_size": len(rank_states) if rank_states else 1,
            "num_trees": int(gbdt.num_trees()),
            "num_tree_per_iteration": int(max(1, gbdt.num_tree_per_iteration)),
            "init_score_value": float(gbdt.init_score_value),
            "config_hash": config_hash(c),
            "model_file": os.path.basename(model_path),
            "model_size": len(model_text.encode()),
            "model_sha256": _sha256_bytes(model_text.encode()),
            "state_file": os.path.basename(state_path) if payload else "",
            "state_sha256": _sha256_bytes(payload) if payload else "",
            "best_scores": dict(es["best_scores"]),
            "best_iter": {k: int(v) for k, v in es["best_iter"].items()},
            "key_order": list(es["key_order"]),
            "extra_state": gbdt.snapshot_extra_state(),
        }
        state_bytes = len(payload)
        if rank_states is not None:
            manifest["rank_states"] = {
                str(r): {"file": os.path.basename(
                    rank_state_path(prefix, iteration, r)), "sha256": sha}
                for r, sha in enumerate(rank_states)}
        # the manifest last: its appearance commits the snapshot
        atomic_write(manifest_path, json.dumps(manifest, indent=1))
        total_bytes = manifest["model_size"] + state_bytes
        sp["bytes"] = total_bytes
        counter_add("snapshot.writes")
        counter_add("snapshot.bytes_written", total_bytes)
    log_info(f"saved snapshot to {model_path} (iteration {iteration})")
    with span("snapshot.prune"):
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
    with span("snapshot.validate"):
        return _validate_snapshot(manifest_path)


def _validate_snapshot(manifest_path: str) -> Optional[Dict]:
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
    manifest["rank_state_paths"] = {}
    for r, ent in (manifest.get("rank_states") or {}).items():
        path = os.path.join(directory, ent.get("file", ""))
        try:
            if _sha256_file(path) == ent.get("sha256"):
                manifest["rank_state_paths"][int(r)] = path
        except OSError:
            pass
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
        _unlink([base, base + ".state.npz", manifest_path, base + ".tmp",
                 base + ".state.npz.tmp", manifest_path + ".tmp"]
                + _siblings(base + ".state.rank"))


def _siblings(stem: str) -> List[str]:
    """Every file whose path starts with ``stem``."""
    directory = os.path.dirname(stem) or "."
    try:
        return [os.path.join(directory, name)
                for name in os.listdir(directory)
                if os.path.join(directory, name).startswith(stem)]
    except OSError:
        return []


def _unlink(paths: List[str]) -> None:
    for path in paths:
        try:
            os.unlink(path)
        except OSError:
            pass


# ---------------------------------------------------------------------------
# barrier snapshots (elastic training)
# ---------------------------------------------------------------------------
def barrier_paths(prefix: str, iteration: int) -> Tuple[str, str]:
    base = f"{prefix}.barrier_iter_{iteration}"
    return base, base + ".manifest.json"


def barrier_shard_path(prefix: str, iteration: int, shard: int) -> str:
    return f"{prefix}.barrier_iter_{iteration}.shard{shard}.npz"


def write_barrier_shard(prefix: str, iteration: int, shard: int,
                        scores: np.ndarray) -> str:
    """Publish one shard's f32 score rows for a pending barrier; returns
    the payload's sha256 (the commit gather carries it into rank 0's
    manifest)."""
    buf = io.BytesIO()
    np.savez(buf, scores=np.asarray(scores, np.float32))
    payload = buf.getvalue()
    atomic_write(barrier_shard_path(prefix, iteration, shard), payload,
                 binary=True)
    counter_add("snapshot.barrier_shards")
    return _sha256_bytes(payload)


def commit_barrier(prefix: str, iteration: int, model_text: str,
                   shard_shas: Dict[int, str], meta: Dict,
                   keep: int = 2) -> str:
    """Rank 0's half of the barrier commit: the model text, then the
    manifest last (its appearance is the global commit marker; it names
    every shard file's sha256, and every shard file exists by then: the
    commit gather collected the shas from their writers).  Prunes to the
    newest ``keep`` barriers."""
    model_path, manifest_path = barrier_paths(prefix, iteration)
    with span("snapshot.barrier", iteration=int(iteration)) as sp:
        atomic_write(model_path, model_text, chunks=2)
        manifest = {
            "version": MANIFEST_VERSION,
            "kind": "barrier",
            "iteration": int(iteration),
            "model_file": os.path.basename(model_path),
            "model_size": len(model_text.encode()),
            "model_sha256": _sha256_bytes(model_text.encode()),
            "shards": {str(s): sha
                       for s, sha in sorted(shard_shas.items())},
            **meta,
        }
        atomic_write(manifest_path, json.dumps(manifest, indent=1))
        sp["bytes"] = manifest["model_size"]
        counter_add("snapshot.barrier_commits")
    log_info(f"committed barrier snapshot at iteration {iteration} "
             f"({len(shard_shas)} shards): {model_path}")
    prune_barriers(prefix, keep)
    return model_path


def list_barriers(prefix: str) -> List[Tuple[int, str]]:
    """Every barrier manifest of a prefix as ``(iteration, path)``, newest
    first."""
    directory = os.path.dirname(prefix) or "."
    stem = os.path.basename(prefix)
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    out = []
    for name in names:
        m = _BARRIER_RE.search(name)
        if m is None or not name.startswith(stem + ".barrier_iter_"):
            continue
        out.append((int(m.group(1)), os.path.join(directory, name)))
    out.sort(key=lambda t: -t[0])
    return out


def validate_barrier(manifest_path: str) -> Optional[Dict]:
    """Parse and verify one barrier: the manifest, the model text and
    every shard file against its sha256.  None when anything is missing
    or torn: a barrier is all or nothing."""
    with span("snapshot.validate"):
        try:
            with open(manifest_path) as f:
                manifest = json.load(f)
        except (OSError, ValueError):
            return None
        directory = os.path.dirname(manifest_path) or "."
        model_path = os.path.join(directory,
                                  manifest.get("model_file", ""))
        try:
            if os.path.getsize(model_path) != manifest["model_size"]:
                return None
            if _sha256_file(model_path) != manifest["model_sha256"]:
                return None
        except (OSError, KeyError):
            return None
        base = manifest_path[:-len(".manifest.json")]
        shard_paths = {}
        for s, sha in manifest.get("shards", {}).items():
            path = f"{base}.shard{int(s)}.npz"
            try:
                if _sha256_file(path) != sha:
                    return None
            except OSError:
                return None
            shard_paths[int(s)] = path
        manifest["model_path"] = model_path
        manifest["shard_paths"] = shard_paths
        return manifest


def latest_valid_barrier(prefix: str,
                         num_shards: Optional[int] = None) -> Optional[Dict]:
    """The newest barrier that validates in full and, when ``num_shards``
    is given, was written for that protocol shard count (another shard
    count is another model, never resumed)."""
    for it, manifest_path in list_barriers(prefix):
        manifest = validate_barrier(manifest_path)
        if manifest is None:
            log_warning(f"barrier snapshot at iteration {it} is torn "
                        f"({manifest_path}); trying the previous one")
            continue
        if num_shards is not None \
                and int(manifest.get("num_shards", -1)) != int(num_shards):
            log_warning(
                f"barrier snapshot at iteration {it} was written for "
                f"{manifest.get('num_shards')} protocol shards, this "
                f"run uses {num_shards}; skipping it")
            continue
        return manifest
    return None


def barrier_candidates(prefix: str,
                       num_shards: Optional[int] = None) -> Dict[int, str]:
    """``{iteration: model_sha256}`` of every barrier that validates in
    full on this rank's view of the shared storage.  The elastic restore
    gathers these and adopts the newest barrier every member sees, so a
    lagging file system or a concurrent prune never lets ranks resume at
    different iterations."""
    out: Dict[int, str] = {}
    for _, manifest_path in list_barriers(prefix):
        manifest = validate_barrier(manifest_path)
        if manifest is None:
            continue
        if num_shards is not None \
                and int(manifest.get("num_shards", -1)) != int(num_shards):
            continue
        out[int(manifest["iteration"])] = manifest["model_sha256"]
    return out


def prune_barriers(prefix: str, keep: int) -> None:
    """Keep the newest ``keep`` committed barriers; the shard files of
    the dropped iterations go with them."""
    if keep <= 0:
        return
    for _, manifest_path in list_barriers(prefix)[keep:]:
        base = manifest_path[:-len(".manifest.json")]
        _unlink([base, manifest_path, base + ".tmp", manifest_path + ".tmp"]
                + _siblings(base + ".shard"))
