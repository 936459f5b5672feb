"""Sharded and async checkpoints of the port (``trainer/checkpoint_io.py``)
in one process: the single-process cases of the JAX package's
``tests/test_sharded_checkpoint.py``.

A mesh's ranks are simulated by writing each rank's pieces (its slices,
``parallel/logical.py:shard_of``) in turn; the restore assembles whole
leaves from any mesh's pieces. The fits run on the CPU through
``Trainer(device="cpu")`` with ``ModelCheckpoint(save_sharded=True)``.
The four-rank cases (a sharded save from tensor-parallel ranks, restored
into other meshes; a resumed fit) are in ``tests/test_torch_gspmd.py``.
"""
import os
import warnings

import numpy as np
import pytest
import torch

from ray_lightning_tpu_torch.models.boring import BoringModule
from ray_lightning_tpu_torch.models.gpt import GPTConfig, GPTLM
from ray_lightning_tpu_torch.parallel.logical import shard_of
from ray_lightning_tpu_torch.parallel.mesh import AXES, mesh_coords
from ray_lightning_tpu_torch.trainer import ModelCheckpoint, Trainer
from ray_lightning_tpu_torch.trainer.checkpoint_io import (
    AsyncShardedCheckpointIO,
    ShardedCheckpointIO,
    average_checkpoints,
    is_sharded_checkpoint,
)
from ray_lightning_tpu_torch.trainer.optim import PieceRef
from ray_lightning_tpu_torch.utils.state_stream import (
    state_stream_to_file,
    to_state_stream,
)

TINY = GPTConfig(vocab_size=64, n_layer=2, n_head=2, d_model=32, max_seq=32,
                 attn_impl="reference")


def _state():
    g = torch.Generator()
    g.manual_seed(0)
    return {
        "params": {"w": torch.randn(8, 16, generator=g),
                   "blocks": {"wqkv": torch.randn(2, 8, 3, 8, 6, generator=g)},
                   "b": torch.randn(12, generator=g)},
        "opt_state": {"optimizer": {"state": {0: {
            "step": torch.tensor(3.0),
            "exp_avg": torch.randn(8, 16, generator=g)}},
            "param_groups": [{"lr": 0.1, "params": [0, 1, 2]}]},
            "mini_step": 0, "update_count": 3, "acc": None},
    }


SPECS = {"params/w": ("fsdp", "model"),
         "params/blocks/wqkv": (None, "fsdp", None, "model", None),
         "params/b": (None,),
         "opt/0/step": (),
         "opt/0/exp_avg": ("fsdp", "model")}


def _skeleton():
    return {
        "params": {"w": PieceRef("params/w"),
                   "blocks": {"wqkv": PieceRef("params/blocks/wqkv")},
                   "b": PieceRef("params/b")},
        "opt_state": {"optimizer": {"state": {0: {
            "step": PieceRef("opt/0/step"),
            "exp_avg": PieceRef("opt/0/exp_avg")}},
            "param_groups": [{"lr": 0.1, "params": [0, 1, 2]}]},
            "mini_step": 0, "update_count": 3, "acc": None},
    }


def _full(state):
    return {"params/w": state["params"]["w"],
            "params/blocks/wqkv": state["params"]["blocks"]["wqkv"],
            "params/b": state["params"]["b"],
            "opt/0/step": state["opt_state"]["optimizer"]["state"][0]["step"],
            "opt/0/exp_avg":
                state["opt_state"]["optimizer"]["state"][0]["exp_avg"]}


def _save_mesh(io, path, state, shape, meta):
    """Every rank of ``shape`` writes its pieces, rank 0 first (it empties
    the directory and writes the index)."""
    world = int(np.prod([shape.get(ax, 1) for ax in AXES]))
    full = _full(state)
    for r in range(world):
        coords = mesh_coords(r, shape)
        pieces = {k: (shard_of(v, SPECS[k], coords, shape), SPECS[k])
                  for k, v in full.items()}
        io.save(path, _skeleton(), pieces,
                ({ax: shape.get(ax, 1) for ax in AXES}, coords), meta,
                is_rank_zero=r == 0)


def _assert_state_equal(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_state_equal(got[k], want[k])
    elif isinstance(want, torch.Tensor):
        assert torch.equal(got, want)
    else:
        assert got == want


def test_sharded_roundtrip_same_mesh(tmp_path):
    """Eight ranks of ``{"fsdp": 4, "model": 2}`` write their slices; the
    restore is the state, bitwise, with the meta (JAX ``:50``). Each rank
    file holds only the blocks it is the first holder of."""
    path = str(tmp_path / "ckpt")
    state = _state()
    _save_mesh(ShardedCheckpointIO(), path, state, {"fsdp": 4, "model": 2},
               {"epoch": 1, "global_step": 7})
    assert is_sharded_checkpoint(path)
    assert not is_sharded_checkpoint(str(tmp_path))
    files = sorted(os.listdir(os.path.join(path, "state")))
    assert files == ["index.pt"] + [f"rank{r:05d}.pt" for r in range(8)]
    restored, meta = ShardedCheckpointIO().restore(path)
    _assert_state_equal(restored, state)
    assert meta == {"epoch": 1, "global_step": 7}
    # The replicated leaves come from rank 0 alone.
    rank1 = torch.load(os.path.join(path, "state", "rank00001.pt"),
                       weights_only=False)
    assert "params/b" not in rank1 and "opt/0/step" not in rank1
    assert rank1["params/w"]["spec"] == ("fsdp", "model")
    assert rank1["params/w"]["block"] == (0, 1)


@pytest.mark.parametrize("shape", [{"data": 2, "model": 4}, {"model": 8},
                                   {"data": 8}, {"fsdp": 2, "model": 2,
                                                 "data": 2}])
def test_sharded_restore_is_mesh_independent(tmp_path, shape):
    """A checkpoint written from ``{"fsdp": 4, "model": 2}`` and one
    written from another mesh (or world size) restore to the same whole
    state, bitwise (JAX ``:84``)."""
    state = _state()
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    _save_mesh(ShardedCheckpointIO(), a, state, {"fsdp": 4, "model": 2}, {})
    _save_mesh(ShardedCheckpointIO(), b, state, shape, {})
    ra, _ = ShardedCheckpointIO().restore(a)
    rb, _ = ShardedCheckpointIO().restore(b)
    _assert_state_equal(rb, ra)
    _assert_state_equal(rb, state)


def test_partial_restore_params_only(tmp_path):
    """``partial=True`` reads the parameters alone (an eval's restore) and
    needs no meta; a full restore without meta warns (JAX ``:124``)."""
    path = str(tmp_path / "ckpt")
    state = _state()
    _save_mesh(ShardedCheckpointIO(), path, state, {"model": 2}, {"epoch": 0})
    os.remove(os.path.join(path, "meta.ckpt"))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        restored, meta = ShardedCheckpointIO().restore(path, partial=True)
    assert set(restored) == {"params"} and meta == {}
    _assert_state_equal(restored["params"], state["params"])
    with pytest.warns(UserWarning, match="meta.ckpt"):
        ShardedCheckpointIO().restore(path)


def test_a_missing_rank_file_raises(tmp_path):
    path = str(tmp_path / "ckpt")
    _save_mesh(ShardedCheckpointIO(), path, _state(), {"model": 2}, {})
    os.remove(os.path.join(path, "state", "rank00001.pt"))
    with pytest.raises(ValueError, match="lacks pieces"):
        ShardedCheckpointIO().restore(path)


def test_async_io_defers_meta_until_finalize(tmp_path):
    """The meta marker (the restart scan's gate) appears only at finalize
    (JAX ``:263``)."""
    io = AsyncShardedCheckpointIO()
    path = str(tmp_path / "async_ck")
    state = _state()
    _save_mesh(io, path, state, {"data": 1}, {"epoch": 3, "global_step": 7})
    assert not os.path.exists(os.path.join(path, "meta.ckpt"))
    io.finalize()
    assert os.path.exists(os.path.join(path, "meta.ckpt"))
    restored, meta = ShardedCheckpointIO().restore(path)
    _assert_state_equal(restored, state)
    assert meta == {"epoch": 3, "global_step": 7}
    io.finalize()  # idempotent


def test_async_io_unfinalizes_reused_path_during_write(tmp_path):
    """Re-saving into a reused directory (a rolling ``last``) removes its
    meta for the whole write: a crash mid-write leaves an unfinalized
    directory, never new state under the old meta (JAX ``:327``)."""
    io = AsyncShardedCheckpointIO()
    path = str(tmp_path / "last")
    meta_path = os.path.join(path, "meta.ckpt")
    _save_mesh(io, path, _state(), {"data": 1}, {"epoch": 0})
    io.finalize()
    assert os.path.exists(meta_path)
    _save_mesh(io, path, _state(), {"data": 1}, {"epoch": 1})
    assert not os.path.exists(meta_path)
    io.finalize()
    assert os.path.exists(meta_path)
    assert ShardedCheckpointIO().restore(path)[1] == {"epoch": 1}


def _fit(tmp_path, tag, epochs, async_ck, resume=None, **ck_kw):
    module = GPTLM(TINY, batch_size=4, n_train=16, warmup_steps=2)
    ck = ModelCheckpoint(dirpath=str(tmp_path / tag), save_sharded=True,
                         **ck_kw)
    t = Trainer(max_epochs=epochs, callbacks=[ck], seed=0,
                num_sanity_val_steps=0, limit_val_batches=1,
                enable_model_summary=False, async_checkpointing=async_ck,
                default_root_dir=str(tmp_path / tag), device="cpu")
    t.fit(module, ckpt_path=resume)
    return t, module, ck


def test_async_checkpointing_fit_and_resume(tmp_path):
    """``async_checkpointing=True``: the rolling sharded ``last`` is
    finalized by the fit's end and resumes bitwise as the synchronous
    path's uninterrupted fit ends (JAX ``:291``); ``ckpt_path="last"``
    finds the directory, and evaluation reads its parameters alone."""
    t1, m1, ck1 = _fit(tmp_path, "async", 1, True, save_last=True)
    assert os.path.exists(os.path.join(ck1.last_model_path, "meta.ckpt"))
    assert is_sharded_checkpoint(ck1.best_model_path)
    t2, m2, _ = _fit(tmp_path, "async2", 2, True,
                     resume=ck1.last_model_path, save_last=True)
    assert t2.current_epoch == 1 and t2.global_step == 2 * t1.global_step
    t3, m3, _ = _fit(tmp_path, "sync", 2, False)
    for k in ("wte", "lnf_g"):
        assert torch.equal(m2.params[k], m3.params[k]), k
    for k, v in m3.params["blocks"].items():
        assert torch.equal(m2.params["blocks"][k], v), k
    t4 = Trainer(callbacks=[ModelCheckpoint(dirpath=str(tmp_path / "async"),
                                            save_sharded=True)],
                 default_root_dir=str(tmp_path / "async"), device="cpu",
                 limit_val_batches=1)
    assert t4._resolve_last_ckpt() == ck1.last_model_path
    def validate(ckpt):
        return Trainer(device="cpu", limit_val_batches=1,
                       enable_checkpointing=False).validate(
            m1, ckpt_path=ckpt)[0]["val_loss"]

    # The last save holds the fit's final parameters.
    assert validate(ck1.best_model_path) == validate(None)


def test_async_checkpointing_with_monitor_prune(tmp_path):
    """Async writes with monitored top-1 pruning: every save is drained
    before the worse one is deleted, so one finalized directory stays
    (JAX ``:347``)."""
    m = BoringModule(lr=0.0)  # the loss never improves: later saves go
    ck = ModelCheckpoint(dirpath=str(tmp_path / "ck"), save_sharded=True,
                         monitor="val_loss", save_top_k=1)
    t = Trainer(max_epochs=3, callbacks=[ck], seed=0, num_sanity_val_steps=0,
                async_checkpointing=True, device="cpu",
                enable_model_summary=False,
                default_root_dir=str(tmp_path))
    t.fit(m)
    assert ck.best_model_path and os.path.exists(
        os.path.join(ck.best_model_path, "meta.ckpt"))
    assert len(os.listdir(tmp_path / "ck")) == 1


def test_restart_scan_skips_an_unfinalized_directory(tmp_path):
    """A sharded directory without its meta (a save cut mid-write) is not
    a resume point; the next newest checkpoint is."""
    import time

    d = tmp_path / "ckpts"
    d.mkdir()
    started = time.time()
    state_stream_to_file(to_state_stream({"params": {"w": torch.ones(2)},
                                          "global_step": 2}),
                         str(d / "epoch=0-step=2.ckpt"))
    _save_mesh(ShardedCheckpointIO(), str(d / "last"), _state(),
               {"model": 2}, {"global_step": 4})
    trainer = Trainer(callbacks=[ModelCheckpoint(dirpath=str(d))],
                      default_root_dir=str(tmp_path), device="cpu")
    path, data = trainer._restart_checkpoint(started)
    assert path == str(d / "last") and data == {"sharded_path": path}
    os.remove(d / "last" / "meta.ckpt")
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        path, _ = trainer._restart_checkpoint(started)
    assert path == str(d / "epoch=0-step=2.ckpt")


def test_average_checkpoints(tmp_path):
    """The element-wise mean of state-stream checkpoints' params, in
    float64 and cast back, the first one's other state carried; a sharded
    directory is refused."""
    a = {"params": {"w": torch.tensor([1.0, 2.0]), "n": torch.tensor([3])},
         "global_step": 5}
    b = {"params": {"w": torch.tensor([3.0, 4.0]), "n": torch.tensor([3])},
         "global_step": 9}
    pa, pb = str(tmp_path / "a.ckpt"), str(tmp_path / "b.ckpt")
    state_stream_to_file(to_state_stream(a), pa)
    state_stream_to_file(to_state_stream(b), pb)
    out = average_checkpoints([pa, pb], out_path=str(tmp_path / "avg.ckpt"))
    assert torch.equal(out["params"]["w"], torch.tensor([2.0, 3.0]))
    assert out["params"]["w"].dtype == torch.float32
    assert out["global_step"] == 5 and os.path.exists(tmp_path / "avg.ckpt")
    with pytest.raises(ValueError, match="at least two"):
        average_checkpoints([pa])
    sharded = str(tmp_path / "sh")
    _save_mesh(ShardedCheckpointIO(), sharded, _state(), {"data": 1}, {})
    with pytest.raises(ValueError, match="sharded"):
        average_checkpoints([pa, sharded])
