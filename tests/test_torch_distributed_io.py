"""lightgbm_tpu_torch's distributed ingest and host collectives against
the JAX package's, in one process (ranks as threads over
``ThreadedAllgather``, the JAX package's own stand-in):

* ``find_bins_distributed`` gives the JAX package's mappers, on every
  rank;
* ``load_file`` with ``num_machines=2`` shards rows mod-rank (in memory
  and two-round) or keeps a rank's own file (``is_pre_partition``), as
  the JAX package's loader does: the same rows, bins and mappers;
* ``deadline_call`` raises ``RankLostError`` under ``collective.hang``;
* the rendezvous retries through ``rendezvous.connect`` (a world of one
  process), and records itself in the flight recorder;
* ``MeshContext.place_data`` checks the partition rules on the training
  path: a replicated tensor must be the same on every rank;
* the overlapped wave reduction equals the plain bookkeeping bitwise,
  and is off unless ``LGBM_TPU_OVERLAP`` asks for it.
"""
import json
import threading

import numpy as np
import pytest
import torch

from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io import distributed as j_dist
from lightgbm_tpu.io import loader as j_loader

from lightgbm_tpu_torch import obs as t_obs
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.io import distributed as t_dist
from lightgbm_tpu_torch.io import loader as t_loader
from lightgbm_tpu_torch.obs import flight_recorder as t_fr
from lightgbm_tpu_torch.utils import faults as t_faults

torch.set_num_threads(1)   # tiny tensors: more threads only spin

W = 2


def _mappers(ms):
    """Mapper dicts as JSON (their NaN fields compare equal there)."""
    return json.dumps([m.to_dict() for m in ms], default=str)


def _threads(fn, world=W):
    """``fn(rank, allgather)`` on ``world`` threads -> per-rank results."""
    ag = [j_dist.ThreadedAllgather(world), t_dist.ThreadedAllgather(world)]
    out = [None] * world
    err = []

    def run(r):
        try:
            out[r] = fn(r, ag)
        except Exception as exc:    # noqa: BLE001 - re-raised below
            err.append(exc)

    ts = [threading.Thread(target=run, args=(r,)) for r in range(world)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(120)
    if err:
        raise err[0]
    return out


def _data(n=3001, seed=5):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, 5))
    X[:, 4] = rng.randint(0, 6, size=n)
    X[rng.rand(n) < 0.05, 1] = np.nan
    y = (X[:, 0] + 0.3 * rng.normal(size=n) > 0).astype(np.float32)
    return X, y


def test_find_bins_distributed_matches_jax():
    X, y = _data()
    params = {"max_bin": 31, "bin_construct_sample_cnt": 500}

    def fn(r, ag):
        local = X[r::W]
        jm = j_dist.find_bins_distributed(local, JConfig.from_params(params),
                                          r, W, ag[0].for_rank(r), [4])
        tm = t_dist.find_bins_distributed(local, Config.from_params(params),
                                          r, W, ag[1].for_rank(r), [4])
        return _mappers(jm), _mappers(tm)

    out = _threads(fn)
    for jm, tm in out:
        assert tm == jm
    assert out[0][1] == out[1][1]


def _write_csv(path, X, y):
    with open(path, "w") as f:
        for xi, yi in zip(X, y):
            f.write(",".join([repr(float(yi))] + [
                "" if np.isnan(v) else repr(float(v)) for v in xi]) + "\n")


@pytest.mark.parametrize("mode", ["mod_rank", "two_round", "pre_partition"])
def test_num_machines_loading_matches_jax(tmp_path, mode):
    X, y = _data()
    if mode == "pre_partition":
        paths = []
        for r in range(W):
            p = str(tmp_path / f"part{r}.csv")
            _write_csv(p, X[r::W], y[r::W])
            paths.append(p)
    else:
        p = str(tmp_path / "all.csv")
        _write_csv(p, X, y)
        paths = [p] * W
    params = {"max_bin": 31, "bin_construct_sample_cnt": 700,
              "categorical_column": "4",
              "use_two_round_loading": mode == "two_round",
              "is_pre_partition": mode == "pre_partition"}

    def fn(r, ag):
        jd = j_loader.load_file(paths[r], JConfig.from_params(params),
                                rank=r, num_machines=W,
                                allgather=ag[0].for_rank(r))
        td = t_loader.load_file(paths[r], Config.from_params(params),
                                rank=r, num_machines=W,
                                allgather=ag[1].for_rank(r))
        return jd, td

    out = _threads(fn)
    for r, (jd, td) in enumerate(out):
        assert td.num_data == jd.num_data == len(y[r::W])
        np.testing.assert_array_equal(td.bins, jd.bins)
        np.testing.assert_array_equal(td.metadata.label, y[r::W])
        np.testing.assert_array_equal(td.metadata.label, jd.metadata.label)
        assert _mappers(td.mappers) == _mappers(jd.mappers)
    assert _mappers(out[0][1].mappers) == _mappers(out[1][1].mappers)


def test_num_machines_without_collective_shards_locally(tmp_path):
    """Without a collective (outside a process group) the loader keeps
    rank 0's mod-rank rows and bins them alone, as the JAX package's."""
    X, y = _data(400)
    p = str(tmp_path / "d.csv")
    _write_csv(p, X, y)
    jd = j_loader.load_file(p, JConfig.from_params({}), num_machines=2)
    td = t_loader.load_file(p, Config.from_params({}), num_machines=2)
    assert td.num_data == jd.num_data == 200
    np.testing.assert_array_equal(td.bins, jd.bins)


@pytest.fixture
def _clean_obs():
    t_obs.reset()
    t_faults.clear()
    yield
    t_obs.reset()
    t_faults.clear()


def test_deadline_call_raises_rank_lost_under_hang(monkeypatch, _clean_obs):
    assert t_dist.deadline_call(lambda: 7, "s") == 7      # no deadline
    monkeypatch.setenv("LGBM_TPU_COLLECTIVE_DEADLINE_S", "0.2")
    assert t_dist.collective_deadline_s() == 0.2
    assert t_dist.deadline_call(lambda: 8, "s") == 8
    t_obs.enable()
    t_faults.inject("collective.hang", times=1)
    with pytest.raises(t_dist.RankLostError, match="'s'") as ei:
        t_dist.deadline_call(lambda: 9, "s")
    assert ei.value.deadline_s == 0.2
    assert t_obs.summary()["counters"]["collective.deadline_exceeded"] == 1
    assert not issubclass(t_dist.RankLostError, t_faults.FaultInjected)


def test_rendezvous_retries_through_fault(monkeypatch, _clean_obs):
    from lightgbm_tpu_torch.parallel import mesh
    if mesh.is_initialized():
        pytest.skip("a process group is already up in this process")
    monkeypatch.setenv("LGBM_TPU_RETRY_BASE_S", "0.01")
    monkeypatch.setenv("LGBM_TPU_RETRY_JITTER", "0")
    t_obs.enable()
    t_faults.inject("rendezvous.connect", times=1)
    try:
        backend = mesh.init_distributed(f"127.0.0.1:{mesh.free_port()}", 1,
                                        0, device="cpu", timeout_s=30.0)
        assert backend == "gloo"
        assert mesh.rank_world() == (0, 1)
        # idempotent
        assert mesh.init_distributed("127.0.0.1:1", 1, 0) == "gloo"
        assert t_dist.process_allgather({"a": 1}) == [{"a": 1}]
        c = t_obs.summary()["counters"]
        assert c["retry.rendezvous.connect.retries"] == 1
        assert c["retry.rendezvous.connect.recovered"] == 1
        sites = [e["site"] for e in t_fr.snapshot()["last"]]
        assert sites[0] == "parallel.mesh.rendezvous"
        assert "io.distributed.process_allgather" in sites
        assert "mesh.rendezvous" in t_obs.summary()["spans"]
    finally:
        mesh.destroy()
    assert not mesh.is_initialized()


def test_mesh_shape_rules():
    from lightgbm_tpu_torch.parallel.mesh import MeshContext
    with pytest.raises(NotImplementedError, match="A11"):
        MeshContext(Config.from_params({"mesh_shape": "2,2"}), "cpu")
    with pytest.raises(ValueError, match="needs 2 ranks"):
        MeshContext(Config.from_params({"mesh_shape": "2"}), "cpu")
    ctx = MeshContext(Config.from_params({"tree_learner": "voting"}), "cpu")
    assert (ctx.world, ctx.rank, ctx.row_sharded) == (1, 0, True)


# (learner, the tensor another rank holds differently, what place_data
# does): data/voting ranks hold their own bins, feature ranks every row
PLACE_CASES = [
    ("data", "bins", None),
    ("voting", None, None),
    ("feature", "bins", "data/bins is replicated"),
    ("data", "num_bins", "data/num_bins is replicated"),
]


@pytest.mark.parametrize("learner,differ,error", PLACE_CASES,
                         ids=["data_own_bins", "voting_same",
                              "feature_bins_differ", "data_mappers_differ"])
def test_place_data_checks_replicated_tensors(monkeypatch, learner, differ,
                                              error):
    """``MeshContext.place_data`` on the training path: no tensor moves
    (a rank holds its part); a replicated tensor that differs on another
    rank raises, naming it, and a split one may differ."""
    import hashlib
    from lightgbm_tpu_torch.io.dataset import BinnedDataset
    from lightgbm_tpu_torch.io.device import to_device
    from lightgbm_tpu_torch.parallel.mesh import MeshContext
    X, _ = _data(1001)
    dd = to_device(BinnedDataset.from_raw(X, Config.from_params({})), "cpu")
    ctx = MeshContext(Config.from_params({"tree_learner": learner}), "cpu")
    ctx.world = 2

    def two_ranks(mine):
        other = dict(mine)
        if differ in other:
            other[differ] = hashlib.sha256(b"another rank").hexdigest()
        return [mine, other]
    monkeypatch.setattr(t_dist, "process_allgather", two_ranks)
    if error is None:
        assert ctx.place_data(dd) is dd
    else:
        with pytest.raises(ValueError, match=error):
            ctx.place_data(dd)


def test_place_data_raises_on_an_unmatched_name(monkeypatch):
    from lightgbm_tpu_torch.io.dataset import BinnedDataset
    from lightgbm_tpu_torch.io.device import to_device
    from lightgbm_tpu_torch.parallel import partition
    from lightgbm_tpu_torch.parallel.mesh import MeshContext
    X, _ = _data(1001)
    dd = to_device(BinnedDataset.from_raw(X, Config.from_params({})), "cpu")
    ctx = MeshContext(Config.from_params({"tree_learner": "data"}), "cpu")
    rules = [r for r in ctx.partition_rules() if r[0] != "data_meta"]
    monkeypatch.setattr(ctx, "partition_rules", lambda: tuple(rules))
    with pytest.raises(partition.PartitionRuleError,
                       match="data/num_bins: matches NO partition rule"):
        ctx.place_data(dd)


class _FakeComm:
    """A collective seam of ``world`` identical ranks: the sum over ranks
    is ``world * x`` (exact for a power of two)."""
    data_axis = "data"

    def __init__(self, world=2):
        self.world = world
        self.calls = 0

    def all_reduce_sum(self, t, async_op=False):
        self.calls += 1
        t.mul_(self.world)

        class _Work:
            def wait(self):
                return True
        return _Work() if async_op else None


@pytest.mark.parametrize("chunks", [1, 2, 3, 7])
def test_overlapped_reduction_equals_plain_bookkeeping(chunks, _clean_obs):
    """``reduce_apply_overlapped`` == the sum then
    ``learner/serial.py:apply_hist_wave``, bitwise, with one logical
    ``hist_psum`` record a wave and one all-reduce a chunk."""
    from lightgbm_tpu_torch.learner.serial import apply_hist_wave
    from lightgbm_tpu_torch.ops.overlap import (_chunk_bounds,
                                                reduce_apply_overlapped)
    rng = np.random.RandomState(2)
    L, A, G, B = 15, 8, 6, 16
    state = torch.as_tensor(rng.normal(size=(L + 1, G, B, 3)).astype(
        np.float32))
    new_h = torch.as_tensor(rng.normal(size=(A, G, B, 3)).astype(np.float32))
    small = torch.tensor([3, 5, 1, -1, 7, -1, 9, -1], dtype=torch.int32)
    parent = torch.tensor([0, 2, 1, -1, 4, -1, 6, -1], dtype=torch.int32)
    sib = torch.tensor([10, 11, 12, -1, 13, -1, 14, -1], dtype=torch.int32)
    plain_state = state.clone()
    ids_p, grid_p = apply_hist_wave(plain_state, new_h * 2, small, parent,
                                    sib, L)
    comm = _FakeComm()
    over_state = state.clone()
    ids_o, grid_o = reduce_apply_overlapped(over_state, new_h.clone(), small,
                                            parent, sib, L, comm, chunks)
    assert torch.equal(ids_o, ids_p)
    assert torch.equal(grid_o, grid_p)
    assert torch.equal(over_state[:L], plain_state[:L])
    assert comm.calls == len(_chunk_bounds(G, chunks))
    assert [e["site"] for e in t_fr.snapshot()["last"]] == [
        "parallel.learners.hist_psum"]


@pytest.mark.parametrize("value,on", [(None, False), ("0", False),
                                      ("", False), ("1", True)])
def test_overlap_is_off_unless_asked(monkeypatch, value, on):
    """One all-reduce a wave unless ``LGBM_TPU_OVERLAP`` asks for the
    overlapped reduction (bitwise the same either way)."""
    from lightgbm_tpu_torch.ops.overlap import overlap_enabled
    if value is None:
        monkeypatch.delenv("LGBM_TPU_OVERLAP", raising=False)
    else:
        monkeypatch.setenv("LGBM_TPU_OVERLAP", value)
    assert overlap_enabled() is on


def test_machine_list_resolves_rank(monkeypatch):
    """``init_distributed_from_machines``: the first entry hosts the store;
    among local entries the listen port names this rank."""
    from lightgbm_tpu_torch.parallel import mesh
    seen = {}
    monkeypatch.setattr(mesh, "init_distributed",
                        lambda **kw: seen.update(kw) or "gloo")
    machines = "127.0.0.1:12400,127.0.0.1:12401,\n127.0.0.1:12402"
    assert mesh.init_distributed_from_machines(machines, 12401, 3) == "gloo"
    assert (seen["coordinator_address"], seen["num_processes"],
            seen["process_id"], seen["local_rank"],
            seen["local_world"]) == ("127.0.0.1:12400", 3, 1, 1, 3)
    with pytest.raises(ValueError, match="cannot resolve"):
        mesh.init_distributed_from_machines(machines, 9999, 3)
    with pytest.raises(ValueError, match="num_machines=4"):
        mesh.init_distributed_from_machines(machines, 12400, 4)
