"""Streams past the histogram kernels' domain (groups of more than 256
bins, trees of more than 1,024 leaves) in lightgbm_tpu_torch, held
against its in-memory model and the JAX package at toy size on the CPU.

Such a stream folds each block into an exact-f32 carry with the seeded
wide histogram (``hist_wide_raw(..., acc=)``): every cell's sum starts at
the carry and adds the block's rows in row order, so a chain of blocks is
the in-memory wave's row-order sum bit for bit, and the JAX package's
seeded scatter (``StreamTrainer._hist_into``) too.  The stream takes the
in-memory wide plan (``round8(L / 2)`` slots every wave), so its model is
the in-memory model, scores included.  Up to 256 leaves that is also the
JAX package's streamed model.  Past 256 leaves the JAX package streams
waves of at most 128 slots (``stage_plan``'s tail), another model than
its own in-memory scatter backend (ROADMAP C26); there the port's stream
is held to the JAX package's in-memory model, and, run with the JAX
stream's 128-slot plan, to its streamed model.  The JAX side runs with
``LGBM_TPU_HIST_BACKEND=compact`` and ``LGBM_TPU_SPLIT_INTERPRET=1``.
"""
import os
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgbm_tpu.boosting.gbdt import GBDT as JGBDT
from lightgbm_tpu.boosting.streaming import StreamTrainer as JStream
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io import outofcore as j_oc

from lightgbm_tpu_torch.boosting import streaming as t_stream
from lightgbm_tpu_torch.boosting.gbdt import GBDT
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.io import outofcore as t_oc
from lightgbm_tpu_torch.learner import serial as tserial
from lightgbm_tpu_torch.learner.serial import STREAM_CHUNK
from lightgbm_tpu_torch.ops import compact as t_compact
from lightgbm_tpu_torch.ops import histogram as t_hist
from lightgbm_tpu_torch.ops import route as t_route

torch.set_num_threads(1)   # tiny tensors: more threads only spin

N, F = 20_000, 6           # three blocks of STREAM_CHUNK rows
ITERS = 2
WIDE = {"max_bin": 511, "num_leaves": 31, "min_data_in_leaf": 5}
DEEP = {"max_bin": 63, "num_leaves": 1100, "min_data_in_leaf": 1,
        "min_sum_hessian_in_leaf": 0.0}
# the JAX package's streamed waves (stage_plan's capped tail)
JAX_STREAM_SLOTS = 128


@pytest.fixture(autouse=True)
def _reference_kernels(monkeypatch):
    monkeypatch.setenv("LGBM_TPU_HIST_BACKEND", "compact")
    monkeypatch.setenv("LGBM_TPU_SPLIT_INTERPRET", "1")


def _wave(seed, n, G, max_bin, L, int32):
    """A wave past the kernels' domain: random bins, gradients over eight
    decades (where the order of a sum shows), bagged-out rows at -1, the
    wide plan's slots, two of them -1."""
    rng = np.random.RandomState(seed)
    A = tserial.wide_wave_slots(L)
    dt = torch.int32 if int32 else torch.uint8
    bins_t = torch.as_tensor(rng.randint(0, max_bin, (G, n))).to(dt)
    g = torch.as_tensor((rng.randn(n) * 10.0 ** rng.uniform(-5, 3, n))
                        .astype(np.float32))
    h = torch.as_tensor((rng.rand(n) * 10.0 ** rng.uniform(-5, 3, n))
                        .astype(np.float32))
    live = min(L, 2 * A)
    leaf = rng.randint(0, live, n)
    hl = torch.as_tensor(np.where(rng.rand(n) < 0.8, leaf, -1)
                         .astype(np.int32))
    active = torch.full((A,), -1, dtype=torch.int32)
    active[:A - 2] = torch.as_tensor(rng.permutation(live)[:A - 2],
                                     dtype=torch.int32)
    return bins_t, g, h, hl, active, A


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("scale", [1.0, 2.0 ** 20], ids=["x1", "x2^20"])
@pytest.mark.parametrize("shape", [(511, 31, True), (63, 1100, False)],
                         ids=["wide", "deep"])
def test_seeded_plain_fold_is_the_whole_wave(shape, scale):
    """The seeded plain fold over two blocks equals the unseeded plain
    version over all rows, bit for bit, and the JAX package's seeded
    scatter block by block.  With the first block's values about 2^20
    times the second's, a seed added once at the end gives other bits."""
    mb, L, int32 = shape
    n, cut = 2 * STREAM_CHUNK + 1000, STREAM_CHUNK
    bins_t, g, h, hl, active, A = _wave(3, n, F, mb, L, int32)
    g[:cut] *= scale
    h[:cut] *= scale
    B = t_hist.bin_stride(mb)
    whole = t_hist.hist_wide_raw(bins_t, g, h, hl, active, L, mb)
    acc = torch.zeros((A, F, B, 3), dtype=torch.float32)
    jacc = jnp.zeros((A, F, B, 3), jnp.float32)
    jself = types.SimpleNamespace(Bh=B, L=L)
    before = t_hist.HIST_WIDE_SEEDED.plain_calls
    for lo, hi in ((0, cut), (cut, n)):
        blk = [t[..., lo:hi].contiguous() for t in (bins_t, g, h, hl)]
        first = acc.clone()
        out = t_hist.hist_wide_raw(*blk, active, L, mb, acc=acc)
        assert out is acc
        jacc = JStream._hist_into(
            jself, jacc, jnp.asarray(blk[0].t().numpy().astype(np.int32)),
            jnp.asarray(blk[1].numpy()), jnp.asarray(blk[2].numpy()),
            jnp.asarray(blk[3].numpy()), jnp.asarray(active.numpy()))
        assert np.array_equal(np.asarray(jacc).view(np.int32),
                              acc.numpy().view(np.int32))
    assert t_hist.HIST_WIDE_SEEDED.plain_calls == before + 2
    assert torch.equal(_bits(acc), _bits(whole))
    # slots of id -1 keep their (zero) seed; every count is the row count
    assert not bool(acc[A - 2:].any())
    assert int(acc[..., 2].sum(dim=(1, 2))[0]) == int(
        (hl == active[0]).sum()) * F
    if scale > 1.0:
        blk = [t[..., cut:].contiguous() for t in (bins_t, g, h, hl)]
        late = first + t_hist.hist_wide_raw(*blk, active, L, mb)
        assert not torch.equal(_bits(late), _bits(whole))


def _csv_store(tmp_path, params, objective):
    """Two CSV files of N rows (label first), ingested by the port; the
    JAX package opens the same store."""
    rng = np.random.RandomState(11)
    X = rng.normal(size=(N, F))
    z = X[:, 0] * 2 + X[:, 1] - X[:, 2] + rng.normal(size=N)
    y = (z > 0) if objective == "binary" else z
    rows = np.column_stack([y, X])
    paths = []
    for i, (a, b) in enumerate([(0, 9000), (9000, N)]):
        p = os.path.join(str(tmp_path), f"part{i}.csv")
        np.savetxt(p, rows[a:b], delimiter=",", fmt="%.9g")
        paths.append(p)
    cdir = str(tmp_path / "store")
    store = t_oc.ingest(paths, Config.from_params(params), cdir)
    jstore = j_oc.load_store(cdir, paths, JConfig.from_params(params))
    assert jstore is not None and store.n == N
    return store, jstore


CASES = {"wide": (WIDE, "regression"), "wide_binary": (WIDE, "binary"),
         "deep": (DEEP, "regression")}


@pytest.mark.parametrize("case", list(CASES))
def test_wide_stream_matches_in_memory_and_reference(tmp_path, monkeypatch,
                                                     case):
    config, objective = CASES[case]
    params = {"objective": objective, "learning_rate": 0.1, "verbose": -1,
              **config}
    store, jstore = _csv_store(tmp_path, params, objective)
    cfg, jcfg = Config.from_params(params), JConfig.from_params(params)
    wide_i32 = store.dtype == np.int32
    assert wide_i32 == (config["max_bin"] > 256)
    counts = (t_hist.HIST_WIDE_SEEDED, t_hist.hist_wide_raw,
              t_hist.hist_active_raw, t_compact.hist_compact_raw,
              t_route.ROUTE_I32 if wide_i32 else t_route.route_rows_raw)
    before = [c.plain_calls for c in counts]
    tr = t_stream.StreamTrainer(cfg, store, block_rows=STREAM_CHUNK,
                                device="cpu")
    assert len(tr.blocks) == 3
    assert (tr.fold.backend, tr.A) == ("scatter", tserial.wide_wave_slots(
        config["num_leaves"]))
    streamed = tr.train(ITERS)
    moved = [c.plain_calls > b for c, b in zip(counts, before)]
    assert moved == [True, False, False, False, True]
    assert max(t.num_leaves for t in streamed.models) > 256 or \
        config["num_leaves"] <= 256

    mem = GBDT(cfg, store.to_binned_dataset(cfg), "cpu")
    for _ in range(ITERS):
        mem.train_one_iter()
    assert streamed.digest() == mem.digest()
    assert streamed.save_model_to_string() == mem.save_model_to_string()

    if config["num_leaves"] <= 256:
        jst = JStream(jcfg, jstore, block_rows=STREAM_CHUNK).train(ITERS)
        assert jst.digest() == streamed.digest()
        return
    jmem = JGBDT(jcfg, jstore.to_binned_dataset(jcfg))
    jmem.train(ITERS)
    assert jmem.digest() == streamed.digest()
    # the JAX package's stream, with its own 128-slot waves
    monkeypatch.setattr(t_stream, "wide_wave_slots",
                        lambda L: JAX_STREAM_SLOTS)
    narrow = t_stream.StreamTrainer(cfg, store, block_rows=STREAM_CHUNK,
                                    device="cpu")
    assert narrow.A == JAX_STREAM_SLOTS
    jst = JStream(jcfg, jstore, block_rows=STREAM_CHUNK).train(ITERS)
    assert jst.digest() == narrow.train(ITERS).digest()
    assert jst.digest() != streamed.digest()


def test_wide_stream_block_size_invariance(tmp_path):
    """The wide stream's model does not depend on the block size."""
    params = {"objective": "binary", "learning_rate": 0.1, "verbose": -1,
              **WIDE}
    store, _ = _csv_store(tmp_path, params, "binary")
    cfg = Config.from_params(params)
    digests = {t_stream.StreamTrainer(cfg, store, block_rows=rows,
                                      device="cpu").train(ITERS).digest()
               for rows in (STREAM_CHUNK, 2 * STREAM_CHUNK, N)}
    assert len(digests) == 1
