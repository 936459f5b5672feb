"""``GSPMDStrategy``'s fits and sharded checkpoints (``trainer/
checkpoint_io.py``, ``trainer/loop.py``) on a four-rank gloo world on the
CPU: a sharded save from four ranks restored into other meshes, folded
steps, validation and prediction over the data-parallel group, and
resumed fits (sync and async saves) bitwise the uninterrupted one.
``tests/_torch_gspmd_common.py`` holds the world and the bars.
"""
import numpy as np
import pytest
import torch

from ray_lightning_tpu_torch.trainer.checkpoint_io import ShardedCheckpointIO
from tests import _torch_dist_worker as W
from tests._torch_gspmd_common import (  # noqa: F401
    GPT_CFG,
    GPT_TOL,
    assert_tree,
    make_batches,
    world,
)


# -- sharded checkpoints ---------------------------------------------------


def _flat_opt(state):
    return {f"{idx}/{k}": v.numpy()
            for idx, st in state["optimizer"]["state"].items()
            for k, v in st.items() if torch.is_tensor(v)}


def test_sharded_save_restores_bitwise_into_other_meshes(world, tmp_path):
    """Four ranks on ``{"fsdp": 2, "model": 2}`` write a sharded checkpoint
    (every leaf split over both axes); restored in this process (a world
    of one) and onto ``{"data": 2, "model": 2}``, the parameters and the
    Adam moments are bitwise the state the ranks gathered."""
    path = str(tmp_path / "ckpt")
    params = W.gpt_numpy_params(GPT_CFG)
    saved = world(W.gspmd_save_sharded, {"fsdp": 2, "model": 2}, params,
                  make_batches("gpt", 2), GPT_CFG, path)
    want = saved[0]
    state, meta = ShardedCheckpointIO().restore(path)
    assert meta == {"global_step": 2}
    assert_tree(W._to_numpy(state["params"]), want["params"],
                 dict(rtol=0, atol=0), "params")
    got_opt = _flat_opt(state["opt_state"])
    assert got_opt.keys() == want["opt"].keys()
    for k in got_opt:
        np.testing.assert_array_equal(got_opt[k], want["opt"][k], err_msg=k)
    moved = world(W.gspmd_restore_sharded, {"data": 2, "model": 2}, path,
                  GPT_CFG)
    for r in moved:
        assert r["step"] == 2
        assert_tree(r["params"], want["params"], dict(rtol=0, atol=0))
        for k in want["opt"]:
            np.testing.assert_array_equal(r["opt"][k], want["opt"][k],
                                          err_msg=k)


FIT_SHAPE = {"data": 2, "model": 2}


@pytest.fixture(scope="module")
def full_fit(world, tmp_path_factory):
    """The uninterrupted 2-epoch fit on ``FIT_SHAPE`` (one step per
    dispatch) the fold and resume cases are held against."""
    return world(W.gspmd_fit, FIT_SHAPE, GPT_CFG,
                 str(tmp_path_factory.mktemp("full")), 2)


def test_steps_per_execution_folds_under_gspmd(world, full_fit, tmp_path):
    """``steps_per_execution=2`` under ``GSPMDStrategy`` on gloo (eager):
    the same losses and parameters as one step per dispatch (JAX
    ``tests/test_gpt.py:792``)."""
    shape = FIT_SHAPE
    one = full_fit
    two = world(W.gspmd_fit, shape, GPT_CFG, str(tmp_path / "k2"), 2, None,
                False, 2)
    for a, b in zip(one, two):
        assert b["step"] == a["step"] == 4
        # The callbacks see each chunk's last step.
        np.testing.assert_allclose(b["losses"], a["losses"][1::2], rtol=0,
                                   atol=1e-6)
        assert_tree(b["params"], a["params"], dict(rtol=0, atol=1e-6))


def test_validate_and_predict_take_one_model_rank_per_shard(world):
    """Validation sums over the data-parallel group only and predictions
    come from one model rank per data-parallel shard: the metrics and the
    predictions equal the in-process ones on the same weights, rank 0
    returns each row once, and the callbacks of the model rank 0 of each
    shard see its rows (the others none)."""
    from ray_lightning_tpu_torch.trainer.loop import TrainerSpec, TrainingLoop

    params = W.gpt_numpy_params(GPT_CFG)
    ranks = world(W.gspmd_eval, {"data": 2, "model": 2}, GPT_CFG, params)

    class Predicting(W.SharedGPT):
        def predict_dataloader(self):
            from ray_lightning_tpu_torch.trainer.data import DataLoader

            return DataLoader(self._data(), batch_size=self.batch_size)

    from ray_lightning_tpu_torch.strategies import SingleDeviceStrategy

    m = Predicting(GPT_CFG, batch_size=4, n_train=12)
    m.params = W._from_numpy(params)
    spec = TrainerSpec(seed=0, limit_val_batches=1)
    want = TrainingLoop(spec, m, SingleDeviceStrategy("cpu")).run_evaluate(
        "validate")[0]
    preds = TrainingLoop(spec, m, SingleDeviceStrategy("cpu")).run_predict()
    for r in ranks:
        np.testing.assert_allclose(r["metrics"]["val_loss"],
                                   want["val_loss"], **GPT_TOL)
    from ray_lightning_tpu_torch.trainer.data import DataLoader

    # The dataset rows of each global batch, shard 0's then shard 1's.
    base = DataLoader(np.zeros((12, 1)), batch_size=2)
    sels = [list(base.with_sampler(2, r, seed=0)._iter_selections(1))
            for r in range(2)]
    order = [i for b in range(len(sels[0])) for r in range(2)
             for i in sels[r][b][0][sels[r][b][1]].tolist()]
    assert sorted(order) == list(range(12))
    got = np.concatenate(ranks[0]["preds"])
    np.testing.assert_array_equal(
        got, np.concatenate([p.numpy() for p in preds])[order])
    assert [r["rows"] for r in ranks] == [6, 0, 6, 0]


@pytest.mark.parametrize("async_ckpt", [False, True])
def test_resumed_fit_is_bitwise_the_uninterrupted_one(world, full_fit,
                                                      tmp_path, async_ckpt):
    """A 2-epoch fit on ``{"data": 2, "model": 2}`` against 1 epoch, its
    rolling sharded ``last`` checkpoint (written synchronously, or from a
    background thread), and a resume to 2 epochs: the losses and the
    parameters are bitwise equal (JAX ``tests/test_sharded_checkpoint.py:
    160-262``)."""
    shape = FIT_SHAPE
    full = full_fit
    first = world(W.gspmd_fit, shape, GPT_CFG, str(tmp_path / "a"), 1, None,
                  async_ckpt)
    last = first[0]["last"]
    assert last and ShardedCheckpointIO().restore(last)[1]["global_step"] == 2
    resumed = world(W.gspmd_fit, shape, GPT_CFG, str(tmp_path / "b"), 2,
                    last)
    for f, r in zip(full, resumed):
        assert r["step"] == f["step"] == 4
        assert r["losses"] == f["losses"]
        assert_tree(r["params"], f["params"], dict(rtol=0, atol=0))
