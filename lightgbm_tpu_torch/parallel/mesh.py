"""Process groups, ranks and devices — the communication seam.

Port of the JAX package's ``parallel/mesh.py`` onto ``torch.distributed``
(reference network stack ``src/network/``; the fork's YARN-style
machine-list rendezvous, ``linkers_socket.cpp:27-68``).  The JAX package
puts every device of a host into one process and runs one SPMD program
over a device mesh; the port runs one process per rank, PyTorch's idiom:

* :func:`init_distributed` joins the process group over a TCP store (or
  reads ``torchrun``'s environment), retried through the shared policy
  with the ``rendezvous.connect`` fault point;
* a rank's device is ``cuda:<local_rank % device_count>``, set before
  anything is allocated;
* the backend follows the cards: NCCL when every rank of the host has a
  card of its own, gloo when ranks share one (NCCL refuses two ranks on
  one device) and on the CPU.  Under gloo the compute stays on the card:
  gloo takes CUDA tensors for ``all_reduce``, and the
  collective seam (:class:`MeshContext`) stages the operands of its
  gathers through the host, explicitly;
* :class:`MeshContext` is the learner's view of the group (world, rank,
  device, backend, the partition rules of ``parallel/partition.py``) and
  its collective seam: ``all_reduce_sum`` (in place, optionally async),
  ``all_gather``, ``all_gather_rows``, ``all_gather_object`` and the
  host gather ``allgather_host``.  A 2-D ``mesh_shape`` [d, f] (data x
  feature) puts ``d * f`` ranks in a row-major grid: rank ``r`` holds
  data index ``r // f``, and the learner runs over the ``d`` ranks of
  its feature index, one sub-group each, so each data shard counts
  once (the JAX package's learners never read the feature axis, and
  its [d, f] model is its [d] model);
* :class:`ProcessRows` is a rank's block of the global row axis, and
  :func:`shard_row_ranges` the protocol shards of a stream.
"""
from __future__ import annotations

import os
import socket
from typing import List, Optional, Tuple

import torch

from ..utils.log import log_info

# what init_distributed chose (read back by the learners and the smoke)
_STATE = {"backend": None, "device": None, "local_rank": 0}
# the sub-groups of a 2-D mesh, by (d, f): made once per process group
_GROUPS = {}


def _dist():
    import torch.distributed as dist
    return dist


def is_initialized() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def rank_world() -> Tuple[int, int]:
    """``(rank, world)`` of the process group, ``(0, 1)`` without one."""
    if not is_initialized():
        return 0, 1
    dist = _dist()
    return int(dist.get_rank()), int(dist.get_world_size())


def local_rank() -> int:
    return int(_STATE["local_rank"])


def rank_device(device=None, local: Optional[int] = None) -> torch.device:
    """This rank's device: the CPU when asked for, else
    ``cuda:<local_rank % device_count>``."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        if device is None:
            return torch.device("cpu")
        raise RuntimeError(f"device {device!r} asked for, but CUDA is not "
                           f"available")
    lr = local_rank() if local is None else int(local)
    return torch.device("cuda", lr % torch.cuda.device_count())


def choose_backend(device: torch.device, local_world: int) -> str:
    """NCCL when every local rank has a card of its own, else gloo."""
    if device.type != "cuda":
        return "gloo"
    if torch.cuda.device_count() >= max(1, local_world):
        return "nccl"
    return "gloo"


def free_port() -> int:
    """A free TCP port on localhost (for a world started here)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return int(s.getsockname()[1])


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device=None, backend: Optional[str] = None,
                     local_rank: Optional[int] = None,
                     local_world: Optional[int] = None,
                     timeout_s: float = 300.0) -> str:
    """Join the process group (the JAX package's ``init_distributed``;
    reference YARN AM rendezvous and TCP handshake,
    ``linkers_socket.cpp:27-68,225-274``) and return its backend.

    ``coordinator_address`` is ``host:port`` of rank 0's TCP store.
    Arguments left None come from ``torchrun``'s environment:
    ``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
    ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE``.  ``device="cpu"`` keeps the
    rank on the CPU (gloo); otherwise the rank's card is
    ``cuda:<local_rank % device_count>`` and :func:`choose_backend`
    picks the backend unless ``backend`` is given.

    The handshake runs under the shared retry policy with the
    ``rendezvous.connect`` fault point in front, inside the
    ``mesh.rendezvous`` span; trace records are held until the group
    has told this process its rank (each rank's trace file opens under
    its own rank).  Idempotent: a process already in a group returns its
    backend."""
    dist = _dist()
    if is_initialized():
        return str(dist.get_backend())
    env = os.environ
    if coordinator_address is None and env.get("MASTER_ADDR"):
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    if coordinator_address is None:
        raise ValueError("init_distributed needs a coordinator_address "
                         "(host:port) or torchrun's MASTER_ADDR/MASTER_PORT")
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(env.get("RANK", "0"))
    if local_rank is None:
        local_rank = int(env.get("LOCAL_RANK", process_id))
    if local_world is None:
        local_world = int(env.get("LOCAL_WORLD_SIZE", num_processes))
    _STATE["local_rank"] = int(local_rank)
    dev = rank_device(device, local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or choose_backend(dev, local_world)

    from datetime import timedelta
    from ..obs import span
    from ..obs.flight_recorder import record as fr_record
    from ..obs.telemetry import hold_trace, release_trace
    from ..utils.faults import fault_point
    from ..utils.retry import RetryPolicy, retry_call

    def _connect():
        fault_point("rendezvous.connect")
        dist.init_process_group(
            backend=backend, init_method=f"tcp://{coordinator_address}",
            world_size=int(num_processes), rank=int(process_id),
            timeout=timedelta(seconds=timeout_s))

    fr_record("parallel.mesh.rendezvous", "distributed.initialize")
    hold_trace()
    try:
        with span("mesh.rendezvous", backend=backend,
                  world=int(num_processes)):
            retry_call(_connect, policy=RetryPolicy.from_env(),
                       what="rendezvous.connect")
    finally:
        release_trace()
    _STATE["backend"] = backend
    _STATE["device"] = str(dev)
    log_info(f"rank {process_id}/{num_processes}: backend {backend}, "
             f"device {dev}")
    return backend


def init_distributed_from_machines(machines: str, local_listen_port: int,
                                   num_machines: int, **kw) -> str:
    """``LGBM_NetworkInit`` semantics (``c_api.h:749-756``): a
    comma-separated ``ip:port`` machine list.  The first machine hosts
    the TCP store; this process's rank is its entry, found by binding
    the entry's host (``linkers_socket.cpp:97-107``) and, where several
    entries are local (an all-loopback list), by ``local_listen_port``."""
    entries = [m.strip() for m in machines.replace("\n", ",").split(",")
               if m.strip()]
    if num_machines > len(entries):
        raise ValueError(
            f"num_machines={num_machines} but machine list has "
            f"{len(entries)} entries")
    entries = entries[:num_machines]

    def _is_local_ip(host: str) -> bool:
        if host in ("127.0.0.1", "localhost", "0.0.0.0"):
            return True
        try:
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            try:
                s.bind((host, 0))
                return True
            finally:
                s.close()
        except OSError:
            return False

    # port matching applies only among local entries: on a multi-host
    # list every machine may listen on the same port
    local = [i for i, e in enumerate(entries)
             if _is_local_ip(e.rsplit(":", 1)[0])]
    if len(local) == 1:
        rank = local[0]
    else:
        cands = local if local else range(len(entries))
        matches = [i for i in cands
                   if ":" in entries[i]
                   and int(entries[i].rsplit(":", 1)[1]) == local_listen_port]
        if len(matches) != 1:
            raise ValueError(
                "cannot resolve local rank from machine list "
                f"{entries!r} with local_listen_port={local_listen_port}")
        rank = matches[0]
    kw.setdefault("local_world", max(1, len(local)))
    kw.setdefault("local_rank", local.index(rank) if rank in local else 0)
    return init_distributed(coordinator_address=entries[0],
                            num_processes=num_machines, process_id=rank,
                            **kw)


def destroy() -> None:
    """Leave the process group (every exit path of a rank calls this)."""
    if is_initialized():
        _dist().destroy_process_group()
    _GROUPS.clear()
    _STATE["backend"] = None
    _STATE["device"] = None


def mesh_data_rank(mesh_shape, rank: int, world: int) -> Tuple[int, int]:
    """``(data index, data shards)`` of global ``rank``: under a 2-D
    ``mesh_shape`` [d, f] rank ``r`` holds data index ``r // f`` of
    ``d`` (the JAX package's row-major device grid,
    ``parallel/mesh.py:214-221``); else ``(rank, world)``.  A rank of a
    data- or voting-parallel run passes the rows of its data index."""
    shape = tuple(int(v) for v in mesh_shape)
    if len(shape) == 2:
        return rank // shape[1], shape[0]
    return rank, world


def one_per_data_index(parts: List, replicas: int) -> List:
    """``parts`` (one entry per global rank, in rank order) -> one entry
    per data index of a [d, ``replicas``] mesh.  The ``replicas`` ranks
    of a data index hold the same rows, so they must send the same
    entry (compared pickled, without the arrival stamp ``_fleet_us``
    that the bin finding's gathers carry): one that differs raises,
    naming the ranks, rather than letting feature index 0 stand for
    them all."""
    if replicas == 1:
        return parts
    import pickle

    def key(part):
        if isinstance(part, dict) and "_fleet_us" in part:
            part = {k: v for k, v in part.items() if k != "_fleet_us"}
        return pickle.dumps(part)
    out = []
    for i in range(0, len(parts), replicas):
        first = key(parts[i])
        bad = [i + j for j in range(1, replicas)
               if key(parts[i + j]) != first]
        if bad:
            raise ValueError(
                f"mesh_shape [d, {replicas}]: ranks {bad} disagree with "
                f"rank {i} on data index {i // replicas}, whose ranks must "
                f"hold the same rows (a rank loads the rows of "
                f"mesh_data_rank)")
        out.append(parts[i])
    return out


def data_shard_loading(mesh_shape) -> Tuple[int, int, object]:
    """``(data index, data shards, allgather)`` with which a rank of a
    row-splitting learner loads a file in the process group: the rows of
    its data index (:func:`mesh_data_rank`), and a host gather with one
    entry per data index for the distributed bin finding (its replicas'
    entries checked alike).  Under a 1-D mesh: ``(rank, world,
    process_allgather)``; outside a process group ``(0, 1, None)``."""
    from ..io.distributed import process_allgather
    if not is_initialized():
        return 0, 1, None
    rank, world = rank_world()
    d_rank, d_world = mesh_data_rank(mesh_shape, rank, world)
    if world % d_world:
        raise ValueError(f"mesh_shape {tuple(mesh_shape)} does not divide "
                         f"the process group's {world} ranks")
    replicas = world // d_world
    return d_rank, d_world, (
        lambda obj: one_per_data_index(process_allgather(obj), replicas))


def _feature_groups(d: int, f: int):
    """The ``f`` sub-groups of a [d, f] mesh, group ``j`` holding the
    ranks ``j, f + j, ..., (d - 1) f + j`` (data indices 0..d-1 of
    feature index ``j``); every rank makes all of them, in one order,
    as ``new_group`` asks."""
    if (d, f) not in _GROUPS:
        _GROUPS[(d, f)] = [_dist().new_group([i * f + j for i in range(d)])
                           for j in range(f)]
    return _GROUPS[(d, f)]


class MeshContext:
    """The learner's view of the process group: a data axis over the
    ranks, this rank's device, the partition rules, and the collective
    seam.  A 1-D ``mesh_shape`` must equal the world size.  A 2-D one
    [d, f] must have ``d * f`` ranks: ``rank`` and ``world`` are then
    this rank's data index and ``d``, and the tensor collectives run
    over the sub-group of this rank's feature index (``group``), whose
    ``d`` ranks hold one data shard each."""

    def __init__(self, config, device=None):
        self.config = config
        self.global_rank, self.global_world = rank_world()
        self.rank, self.world = self.global_rank, self.global_world
        shape = tuple(config.mesh_shape)
        if len(shape) > 2:
            raise ValueError(f"mesh_shape {shape}: at most two axes "
                             f"(data x feature)")
        need = 1
        for v in shape:
            need *= int(v)
        if shape and need != self.global_world:
            raise ValueError(
                f"mesh_shape {shape} needs {need} ranks, the process "
                f"group has {self.global_world}")
        # the feature axis only replicates: f ranks hold each data shard
        self.feature_shards = int(shape[1]) if len(shape) == 2 else 1
        self.feature_index = self.global_rank % self.feature_shards
        self.group = None
        if self.feature_shards > 1:
            self.rank, self.world = mesh_data_rank(
                shape, self.global_rank, self.global_world)
            self.group = _feature_groups(
                self.world, self.feature_shards)[self.feature_index]
        self.data_axis = config.data_axis_name
        self.device = torch.device(device) if device is not None else (
            rank_device())
        self.backend = (str(_dist().get_backend()) if is_initialized()
                        else None)
        # gloo moves CUDA tensors for all_reduce only
        self._stage = self.backend == "gloo" and self.device.type == "cuda"

    @property
    def row_sharded(self) -> bool:
        """Data- and voting-parallel split the rows; feature-parallel
        replicates them."""
        return self.config.tree_learner in ("data", "voting")

    def partition_rules(self):
        from .partition import train_rules
        return train_rules(self.data_axis, self.row_sharded)

    def place_data(self, dd):
        """This rank's ``DeviceData`` under the partition rules (the JAX
        package's ``place_data``, run once before the first tree).  A
        rank is a process that already holds its part (its own rows of
        ``data/bins`` for data/voting, every row for feature), so no
        tensor moves; what the rules decide is checked instead: every
        name matches exactly one rule (else ``PartitionRuleError`` with
        the audit's findings), and every replicated tensor (the bin
        metadata; the bins too under feature-parallel) holds the same
        bytes on every rank, by one gather of digests.  The JAX package
        assumes the second (``gbdt.py:_to_device_multiproc``); ranks
        that binned with different mappers would train one model over
        differently binned rows, so a difference raises, naming the
        tensor and the ranks.  Returns ``dd``."""
        import hashlib
        from .partition import (PartitionRuleError, audit_rules,
                                device_data_names, match_name)
        rules = self.partition_rules()
        named = device_data_names(dd)
        findings = audit_rules(rules, [f"data/{n}" for n in named])
        if findings:
            raise PartitionRuleError("; ".join(findings))
        replicated = [name for name in named
                      if not match_name(rules, f"data/{name}")]
        # a 2-D mesh's replicas of a data index also hold the same rows:
        # allgather_host checks that they agree on every tensor's digest
        keep = replicated if self.feature_shards == 1 else list(named)
        mine = {name: hashlib.sha256(
                    named[name].detach().contiguous().cpu().numpy()
                    .tobytes()).hexdigest()
                for name in keep}
        every = self.allgather_host(mine)
        for name in replicated:
            digest = mine[name]
            differ = [r for r, d in enumerate(every) if d.get(name) != digest]
            if differ:
                raise ValueError(
                    f"data/{name} is replicated under the partition rules "
                    f"but rank {self.rank}'s differs from ranks {differ}: "
                    f"every rank must bin with the same mappers (load "
                    f"with num_machines, or subset one binned set)")
        return dd

    # -- the collective seam -------------------------------------------------
    def all_reduce_sum(self, t: torch.Tensor, async_op: bool = False):
        """Sum ``t`` over the ranks in place; every rank gets the same
        bits.  ``async_op``: returns the work handle to ``wait()`` on."""
        dist = _dist()
        return dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group,
                               async_op=async_op)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """``[world, *t.shape]``: every rank's ``t`` in rank order (staged
        through the host under gloo with CUDA operands)."""
        dist = _dist()
        src = t.contiguous()
        if self._stage:
            src = src.cpu()
        out = [torch.empty_like(src) for _ in range(self.world)]
        dist.all_gather(out, src, group=self.group)
        return torch.stack(out).to(t.device)

    def all_gather_rows(self, t: torch.Tensor, counts: List[int]
                        ) -> torch.Tensor:
        """A per-row tensor of this rank (``counts[rank]`` rows) laid over
        the global row axis: every rank's rows, in rank order."""
        per = max(counts)
        block = t.new_zeros((per,) + tuple(t.shape[1:]))
        block[:t.shape[0]] = t
        g = self.all_gather(block)
        return torch.cat([g[r, :c] for r, c in enumerate(counts)])

    def all_gather_object(self, obj) -> List:
        """Every rank's picklable ``obj``, in global rank order (under a
        2-D mesh ``feature_shards`` entries a data index)."""
        out: List = [None] * self.global_world
        _dist().all_gather_object(out, obj)
        return out

    def allgather_host(self, obj) -> List:
        """``io/distributed.py:process_allgather`` (its deadline, retry
        and flight-recorder record) over every rank, one entry per data
        index (:func:`one_per_data_index`: a replica that sends another
        entry than its data index's first raises), so the dataset-level
        statistics count each data shard once."""
        from ..io.distributed import process_allgather
        return one_per_data_index(process_allgather(obj),
                                  self.feature_shards)


class ProcessRows:
    """A rank's block of the global row axis (the JAX package's
    ``ProcessRows``; reference mod-rank sharding,
    ``dataset_loader.cpp:639-742``).  Global row space: ``world`` blocks
    of ``per`` rows, block ``r`` holding rank ``r``'s ``n_local`` real
    rows then padding.  The rank's own tensors hold its real rows only."""

    def __init__(self, mesh_ctx: MeshContext, n_local: int):
        self.mesh_ctx = mesh_ctx
        self.world = mesh_ctx.world
        self.rank = mesh_ctx.rank
        self.counts = [int(x) for x in mesh_ctx.allgather_host(int(n_local))]
        self.n_local = int(n_local)
        self.n_global = sum(self.counts)
        self.per = max(self.counts)
        self.n_pad = self.per * self.world

    @property
    def offset(self) -> int:
        """This rank's first row in the global padded row space."""
        return self.rank * self.per


def shard_row_ranges(n: int, num_shards: int) -> List[Tuple[int, int]]:
    """The row partition of ``num_shards`` protocol shards as global
    ``[(lo, hi), ...]`` ranges (the JAX package's ``shard_row_ranges``):
    contiguous blocks of ``per = ceil(n / num_shards)`` rows, shard ``d``
    owning ``[d * per, (d + 1) * per)``; the last range may run past
    ``n`` (its rows beyond ``n`` are padding).  The streamed trainer
    (``boosting/streaming.py``) cuts each shard's range into blocks and
    folds each shard apart, which is what lets a rank of an elastic run
    own whole shards."""
    d = max(1, int(num_shards))
    per = (int(n) + d - 1) // d
    return [(i * per, (i + 1) * per) for i in range(d)]
