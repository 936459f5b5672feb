"""PyTorch port, dispatch programs on the CPU: the engine's dispatch plan
against the JAX engine's compiled executables, the dispatch and training
bodies run with every host read made to raise (the CPU stand-in for a CUDA
graph's no-sync rule), the device draw, and ``steps_per_execution``.

On the card every key of ``DecodeEngine.dispatch_plan`` is captured as a
CUDA graph at construction and replayed; on the CPU the same bodies run on
the same buffers without capture, so these tests cover the data flow the
graphs hold. The ``cuda_hw`` tests hold replay against the eager body and
the frozen ``compiled_count`` on the card.
"""
import contextlib
import dataclasses
import importlib
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_lightning_tpu.models.gpt as jgpt
from ray_lightning_tpu.serve.engine import DecodeEngine as JEngine
from ray_lightning_tpu_torch.models import gpt as tgpt
from ray_lightning_tpu_torch.models.boring import BoringModule
from ray_lightning_tpu_torch.models.weights import params_from_jax
from ray_lightning_tpu_torch.serve.engine import DecodeEngine
from ray_lightning_tpu_torch.serve.scheduler import SamplingParams, Scheduler
from ray_lightning_tpu_torch.strategies import SingleDeviceStrategy
from ray_lightning_tpu_torch.trainer import Callback, ModelCheckpoint, Trainer
from ray_lightning_tpu_torch.trainer.optim import (
    TrainOptimizer,
    warmup_cosine_decay_schedule,
)

JAX_CFG = jgpt.GPTConfig(
    vocab_size=97, n_layer=2, n_head=4, n_kv_head=2, d_model=32, max_seq=64,
    attn_impl="reference", compute_dtype="float32",
)
CFG = tgpt.GPTConfig(**dataclasses.asdict(JAX_CFG))
TOL = dict(atol=1e-4, rtol=1e-4)  # the JAX trainer tests' bar, fp32
cuda_hw = pytest.mark.cuda_hw


@pytest.fixture(scope="module")
def weights():
    """(JAX params, port params) holding the same numpy weights."""
    rng = np.random.default_rng(0)
    tree = {
        k: (
            {n: 0.1 * rng.standard_normal(s).astype(np.float32)
             for n, s in v.items()}
            if isinstance(v, dict)
            else 0.1 * rng.standard_normal(v).astype(np.float32)
        )
        for k, v in tgpt.param_shapes(CFG).items()
    }
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            params_from_jax(tree, CFG, "cpu"))


# -- (a) the dispatch plan is the JAX engine's set of executables ----------
PLAN_CONFIGS = {
    "dense_mono": dict(num_slots=2, max_seq=64, prefill_buckets=[8, 16],
                       fold_ladder=[1, 2], decode_fold=2),
    "dense_chunked_ngram_pb": dict(num_slots=2, max_seq=64, prefill_chunk=16,
                                   decode_fold=2, spec="ngram", spec_depth=2,
                                   piggyback_chunks=1),
    "paged_pb": dict(num_slots=2, max_seq=64, kv_page=8, kv_pages=17,
                     prefill_chunk=16, fold_ladder=[1, 4], decode_fold=4,
                     piggyback_chunks=2),
}


@pytest.mark.parametrize("name", list(PLAN_CONFIGS))
def test_dispatch_plan_matches_jax_executables(weights, name):
    """Fold programs per JAX ``_step_exec`` rung, each in a greedy and a
    sampling variant; chunk programs per ``_chunk_exec`` bucket; admission
    programs per ``_admit_exec`` bucket. Nothing is captured on the CPU."""
    kw = PLAN_CONFIGS[name]
    j_params, params = weights
    jeng = JEngine(j_params, JAX_CFG, **kw)
    eng = DecodeEngine(params, CFG, device="cpu", **kw)
    folds = [k for k in eng.dispatch_plan if k[0] == "fold"]
    assert {k[1] for k in folds} == set(jeng._step_exec)
    assert sorted((k[1], k[3]) for k in folds) == sorted(
        (r, s) for r in jeng._step_exec for s in (False, True))
    kind = ("paged" if "kv_pages" in kw else "dense") + "-" + (
        kw.get("spec", "off").replace("off", "plain"))
    assert {k[2] for k in folds} == {kind}
    assert {k[1] for k in eng.dispatch_plan if k[0] == "chunk"} == set(
        jeng._chunk_exec)
    assert {k[1] for k in eng.dispatch_plan if k[0] == "admit"} == set(
        jeng._admit_exec)
    assert len(set(eng.dispatch_plan)) == len(eng.dispatch_plan)
    assert eng.compiled_count == 0 and jeng.compiled_count > 0


# -- (b) the bodies read nothing back ---------------------------------------
@contextlib.contextmanager
def no_host_reads():
    """Every way a tensor's value reaches the host raises."""
    def refuse(*a, **k):
        raise AssertionError("host read inside a dispatch body")

    names = ("item", "tolist", "__bool__", "cpu", "numpy", "__int__",
             "__float__")
    saved = {n: getattr(torch.Tensor, n) for n in names}
    for n in names:
        setattr(torch.Tensor, n, refuse)
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(torch.Tensor, n, f)


def _guarded(eng, key):
    with torch.no_grad(), no_host_reads():
        eng._programs[key]()


@pytest.mark.parametrize("spec", ["off", "ngram", "model"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_dispatch_bodies_make_no_host_read(weights, spec, paged):
    """Each fold (greedy and sampling, with a piggybacked final chunk row
    of a sampled request), chunk and admission body runs with host reads
    raising, the sampled speculative fold included."""
    _, params = weights
    kw = dict(num_slots=3, max_seq=64, decode_fold=2, fold_ladder=[1, 2],
              device="cpu")
    if spec != "off":
        kw.update(spec=spec, spec_depth=2)
    if spec == "model":
        kw.update(spec_params=params, spec_config=CFG, spec_window=8)
    if paged:
        kw.update(kv_page=8, kv_pages=25, piggyback_chunks=2)
    elif spec == "ngram":
        kw.update(prefill_chunk=8, piggyback_chunks=2)
    eng = DecodeEngine(params, CFG, **kw)
    sampled = dict(temperature=0.8, top_k=20, top_p=0.9, seed=3)
    eng.admit(list(range(1, 12)), request_id="a", max_new_tokens=20, **sampled)
    eng.admit(list(range(20, 25)), request_id="b", max_new_tokens=20)
    if eng.chunked and not eng.piggyback_chunks:
        while eng.num_prefilling:
            eng.prefill_step(4)
    if eng.piggyback_chunks:
        eng._pb_rows.fill(eng._plan_piggyback()[0])
    keys = [k for k in eng.dispatch_plan if k[0] == "fold"]
    for key in keys:
        _guarded(eng, key)
    if eng.chunked:
        task = eng.admit(list(range(40, 50)), request_id="c",
                         max_new_tokens=4)[0]
        row = eng._chunk_row(task, eng._prefills[task])
        cb = eng._chunk_bucket_for(row.length)
        eng._chunk_rows[cb].fill([row])
        _guarded(eng, ("chunk", cb))
    else:
        eng._admit_one(2, dict(sampled), np.arange(5, 14), 9, 4,
                       eng.bucket_for(9), -1)
        _guarded(eng, ("admit", eng.bucket_for(9)))
    st = eng.device_state()
    assert np.isfinite(st["temps"]).all() and (st["ctrs"] >= 0).all()


@pytest.fixture
def capturable_on_cpu(monkeypatch):
    """Let torch's capturable Adam run on the CPU: it accepts only
    accelerators, but its capturable arithmetic is plain tensor ops."""
    monkeypatch.setattr(importlib.import_module("torch.optim.adam"),
                        "_get_capturable_supported_devices",
                        lambda *a, **k: ["cpu"])


def _gpt_program(fold, clip, accumulate, capturable, optimizer=None):
    module = tgpt.GPTLM(CFG, batch_size=2, n_train=8, warmup_steps=0)
    params = SingleDeviceStrategy("cpu").place_params(
        tgpt.init_gpt_params(torch.Generator().manual_seed(0), CFG))
    opts = module.configure_optimizers()
    leaves = [params["wte"], params["lnf_g"], params["lnf_b"],
              params["wpe"], *params["blocks"].values()]
    opt = TrainOptimizer(optimizer or opts["optimizer"], leaves,
                         opts["lr_schedule"], clip=clip,
                         accumulate=accumulate, capturable=capturable)
    program = SingleDeviceStrategy("cpu").compile_train_step(
        module, opt, seed=0, log_grad_norm=True, fold_steps=fold)
    return params, opt, program


def _guarded_train_bodies(in_graph):
    params, opt, program = _gpt_program(
        3, 0.5, 2, capturable=in_graph,
        optimizer=None if in_graph else (
            lambda ls: torch.optim.SGD(ls, lr=0.0, momentum=0.9)))
    assert opt.step_in_graph == in_graph
    batches = [np.random.default_rng(i).integers(0, 97, (2, 17))
               for i in range(3)]
    program(params, batches, 0)
    (plan, progs), = program.programs.items()
    assert [u for _, u in plan] == [False, True, False]
    assert len(progs) == (1 if in_graph else 3)
    before = params["wte"].detach().clone()
    with no_host_reads():
        for prog in progs:
            prog.body()
    assert torch.equal(before, params["wte"]) != in_graph
    assert set(program.out) == {"loss", "acc", "grad_norm"}


def test_train_step_body_makes_no_host_read(capturable_on_cpu):
    """The K-step training body (AdamW with a schedule, clipping and
    accumulation over 2) runs with host reads raising, the update in
    torch's capturable mode inside the body, as the card captures it."""
    _guarded_train_bodies(in_graph=True)


def test_train_bodies_before_an_eager_step_make_no_host_read():
    """An optimizer whose step reads a value back (SGD with a schedule)
    steps after each step's body; those bodies run with host reads
    raising too."""
    _guarded_train_bodies(in_graph=False)


# -- (c) the device draw ------------------------------------------------------
def test_draw_is_a_function_of_seed_counter_and_index():
    """A row's uniforms depend on its (seed, counter) alone, lie in (0, 1),
    and differ across counters and seeds."""
    seeds = torch.tensor([7, -3, 2**40 + 5, 7])
    ctrs = torch.tensor([0, 4, 1, 1])
    u = tgpt.draw_uniforms(seeds, ctrs, 1000)
    alone = tgpt.draw_uniforms(seeds[1:2], ctrs[1:2], 1000)
    assert torch.equal(u[1], alone[0])
    assert (u > 0).all() and (u < 1).all()
    assert not torch.equal(u[0], u[3])
    assert abs(float(u.mean()) - 0.5) < 0.02
    assert tgpt.seed64(2**64 + 5) == 5 and tgpt.seed64(-1) == -1


def _serve(eng, reqs):
    sched = Scheduler(eng, max_prefills_per_step=2)
    outs = {}
    for rid, p, sp in reqs:
        sched.submit(p, sp, request_id=rid)
        outs[rid] = []
    for ev in sched.run_until_idle():
        if ev.token is not None:
            outs[ev.request_id].append(ev.token)
    return outs


SAMPLED = SamplingParams(max_new_tokens=10, temperature=0.9, top_k=20,
                         top_p=0.9, seed=11)
DRAW_ENGINES = {
    "mono_fold1": dict(decode_fold=1),
    "mono_ladder_pipe": dict(decode_fold=4, fold_ladder=[1, 2, 4]),
    "chunked_pb": dict(prefill_chunk=4, piggyback_chunks=2, decode_fold=2),
    "paged_ngram_pb": dict(kv_page=4, kv_pages=40, piggyback_chunks=2,
                           spec="ngram", spec_depth=3, decode_fold=2),
    "dense_ngram_nopipe": dict(spec="ngram", spec_depth=2, decode_fold=3,
                               pipeline=False),
}


@pytest.mark.parametrize("name", list(DRAW_ENGINES))
def test_sampled_tokens_are_the_solo_draws_on_every_path(weights, name):
    """A sampled request beside two greedy ones: its tokens are the solo
    ``gpt_generate`` with its seed (its n-th token uses draw n) whatever
    the rung, spec, piggyback and pipelining; the greedy ones equal the
    JAX package's ``gpt_generate`` token for token."""
    j_params, params = weights
    eng = DecodeEngine(params, CFG, num_slots=3, max_seq=64,
                       prefill_buckets=[16], device="cpu",
                       **DRAW_ENGINES[name])
    rng = np.random.default_rng(4)
    reqs = [("s", rng.integers(0, 97, 9).tolist(), SAMPLED)] + [
        (f"g{i}", rng.integers(0, 97, n).tolist(),
         SamplingParams(max_new_tokens=8)) for i, n in enumerate((5, 12))
    ]
    outs = _serve(eng, reqs)
    for rid, p, sp in reqs:
        solo = tgpt.gpt_generate(
            params, CFG, [p], sp.max_new_tokens, temperature=sp.temperature,
            top_k=sp.top_k, top_p=sp.top_p, seed=sp.seed or 0, device="cpu",
        )[0, len(p):].tolist()
        assert outs[rid] == solo, rid
        if sp.temperature == 0:
            want = jax.jit(jgpt.gpt_generate, static_argnums=(1, 3))(
                j_params, JAX_CFG, jnp.asarray([p], jnp.int32),
                sp.max_new_tokens)
            assert solo == np.asarray(want)[0, len(p):].tolist(), rid


# -- (d) steps_per_execution ---------------------------------------------------
class _Rec(Callback):
    def __init__(self):
        self.losses = []

    def on_train_batch_end(self, trainer, module, logs, batch_idx):
        self.losses.append(logs["loss"])


def _boring_weights():
    rng = np.random.default_rng(5)
    return {"w": (0.1 * rng.standard_normal((32, 2))).astype(np.float32),
            "b": np.zeros((2,), np.float32)}


class _Det(BoringModule):
    """BoringModule from fixed numpy weights."""

    def init_params(self, generator, batch):
        return {k: torch.from_numpy(v) for k, v in _boring_weights().items()}


def _fit(n=64, batch=16, module=None, ckpt=None, **kw):
    """Fit on the CPU; returns the trainer, the final params and the
    epoch-mean loss per step (every step's loss)."""
    m = module or _Det(dataset_length=n, batch_size=batch)
    opts = dict(seed=0, enable_checkpointing=False,
                enable_model_summary=False, num_sanity_val_steps=0,
                log_every_n_steps=1, device="cpu")
    opts.update(kw)
    t = Trainer(**opts)
    t.fit(m, ckpt_path=ckpt)
    return t, {k: v.detach().cpu().numpy() for k, v in m.params.items()
               if not isinstance(v, dict)}


def _close(a, b):
    for k in a:
        np.testing.assert_allclose(a[k], b[k], **TOL)


@pytest.mark.parametrize("case", [
    "matches_single", "tail_remainder", "max_steps_exact",
    "accumulation", "accumulation_unaligned", "clip_and_grad_norm",
])
def test_steps_per_execution_matches_single_steps(case):
    """tests/test_trainer.py:1951-2019 (matches_single, tail_remainder,
    max_steps_exact, composes_with_accumulation) and two more: K steps per
    dispatch give the K = 1 run's params, step count and epoch-mean loss
    at 1e-4 (bitwise here: the same bodies)."""
    kw = {
        "matches_single": dict(max_epochs=2),  # 4 batches/epoch, K=4
        "tail_remainder": dict(n=80, max_epochs=1),  # 5 batches: 4 + 1
        "max_steps_exact": dict(max_epochs=5, max_steps=6),
        "accumulation": dict(max_epochs=2, accumulate_grad_batches=2),
        "accumulation_unaligned": dict(n=80, max_epochs=2,
                                       accumulate_grad_batches=3),
        "clip_and_grad_norm": dict(max_epochs=2, gradient_clip_val=0.05,
                                   log_grad_norm=True),
    }[case]
    t1, w1 = _fit(**kw)
    tk, wk = _fit(steps_per_execution=4, **kw)
    assert tk.global_step == t1.global_step
    _close(wk, w1)
    np.testing.assert_allclose(tk.callback_metrics["loss"],
                               t1.callback_metrics["loss"], **TOL)


def test_gptlm_steps_per_execution_matches_single_steps():
    """GPTLM (AdamW, warmup-cosine schedule, the flash plain forward and
    backward): per-step losses and final params of K = 2 equal K = 1's."""
    def run(k):
        rec = _Rec()
        m = tgpt.GPTLM(dataclasses.replace(CFG, attn_impl="flash"),
                       batch_size=2, n_train=8, warmup_steps=2)
        t, _ = _fit(module=m, max_epochs=2, limit_val_batches=1,
                    callbacks=[rec], steps_per_execution=k)
        flat = {k2: v.detach().numpy() for k2, v in m.params["blocks"].items()}
        return t, rec.losses, flat

    t1, l1, w1 = run(1)
    t2, l2, w2 = run(2)
    assert t1.global_step == t2.global_step == 8
    # K = 2 logs at its 2-step boundaries: the K = 1 run's every other loss.
    np.testing.assert_allclose(l2, l1[1::2], **TOL)
    _close(w2, w1)


def test_steps_per_execution_cadences_and_errors():
    """tests/test_trainer.py:2020-2036: an unaligned int
    ``val_check_interval`` fails fast, ``steps_per_execution=0`` is
    refused; a fraction quantizes to a chunk boundary; K above the epoch's
    batches warns and still trains every batch."""
    with pytest.raises(ValueError, match="multiple of steps_per_execution"):
        _fit(max_epochs=1, steps_per_execution=4, val_check_interval=3)
    with pytest.raises(ValueError, match="steps_per_execution"):
        Trainer(steps_per_execution=0, device="cpu")
    vals = []

    class Count(Callback):
        def on_validation_end(self, trainer, module):
            vals.append(trainer.global_step)

    # 8 batches/epoch: 0.3 -> 2 batches -> quantized to 4.
    _fit(n=128, max_epochs=1, steps_per_execution=4, val_check_interval=0.3,
         callbacks=[Count()])
    assert vals == [4, 8]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t, _ = _fit(n=48, max_epochs=1, steps_per_execution=4)
    assert any("exceeds the batches per epoch" in str(w.message)
               for w in caught)
    assert t.global_step == 3


def test_fold_mid_epoch_checkpoint_and_resume(tmp_path):
    """tests/test_trainer.py:2141: a mid-epoch checkpoint saved under
    ``steps_per_execution=2`` resumes by re-running its epoch, folded or
    not, to the same params."""
    def fit(fold, resume=None, ckpt_dir=None):
        cbs = ([ModelCheckpoint(dirpath=str(ckpt_dir), monitor="val_loss",
                                save_top_k=-1)] if ckpt_dir else [])
        return _fit(n=96, max_epochs=1, steps_per_execution=fold,
                    enable_checkpointing=bool(ckpt_dir), callbacks=cbs,
                    val_check_interval=2 if ckpt_dir else None, ckpt=resume)

    t, _ = fit(2, ckpt_dir=tmp_path)
    assert t.global_step == 6
    mid = [p for p in os.listdir(tmp_path) if p.endswith("step=2.ckpt")]
    assert mid, os.listdir(tmp_path)
    t1, w1 = fit(1, resume=str(tmp_path / mid[0]))
    t2, w2 = fit(2, resume=str(tmp_path / mid[0]))
    assert t1.current_epoch == t2.current_epoch == 0
    assert t1.global_step == t2.global_step == 2 + 6
    _close(w2, w1)


def test_optimizer_plan_and_flush_follow_the_window():
    """The host plan of window positions under accumulation 3, the
    learning rates of its updates, and the epoch-end flush of a partial
    window (SGD with a schedule: its step runs after the graph)."""
    leaf = torch.zeros(3, requires_grad=True)
    sched = warmup_cosine_decay_schedule(0.0, 1.0, 2, 10)
    opt = TrainOptimizer(lambda ls: torch.optim.SGD(ls, lr=0.0), [leaf],
                         sched, accumulate=3)
    assert not opt.step_in_graph
    plan = opt.plan(4)
    assert plan == [(1, False), (2, False), (3, True), (1, False)]
    assert opt.lrs(plan) == [0.0, 0.0, sched(0), 0.0]
    for (pos, updates), lr, g in zip(plan, opt.lrs(plan), (1.0, 2.0, 3.0, 4.0)):
        opt.take([torch.full((3,), g)], pos, updates, torch.tensor(lr))
        if updates:
            opt.update(lr)
    opt.commit(plan)
    assert opt.mini_step == 1 and opt.update_count == 1
    assert torch.equal(leaf.detach(), torch.full((3,), 0.0))  # lr(0) = 0
    assert opt.flush() and opt.update_count == 2 and opt.mini_step == 0
    np.testing.assert_allclose(leaf.detach().numpy(), -4.0 * sched(1))


@pytest.mark.parametrize("accumulate", [1, 2])
def test_capturable_step_matches_the_eager_step(capturable_on_cpu,
                                                accumulate):
    """The card's update (AdamW in torch's capturable mode, the lr a
    device tensor, inside the body) against the CPU's (the step after the
    body, the lr a host float): the same params and moments at 1e-6 after
    six micro-batches of a warmup-cosine schedule with clipping, and an
    optimizer state that loads into the other mode."""
    runs = []
    for capturable in (False, True):
        params, opt, program = _gpt_program(2, 0.05, accumulate, capturable)
        assert opt.step_in_graph == capturable
        for i in range(3):
            program(params, [np.random.default_rng(10 * i + j).integers(
                0, 97, (2, 17)) for j in range(2)], 2 * i)
        runs.append((params, opt))
    (p0, o0), (p1, o1) = runs
    for name in p0["blocks"]:
        np.testing.assert_allclose(p1["blocks"][name].detach().numpy(),
                                   p0["blocks"][name].detach().numpy(),
                                   atol=1e-6, rtol=1e-6)
    s0, s1 = o0.opt.state_dict()["state"], o1.state_dict()["optimizer"]["state"]
    for i in s0:
        np.testing.assert_allclose(s1[i]["exp_avg_sq"].numpy(),
                                   s0[i]["exp_avg_sq"].numpy(), rtol=1e-5,
                                   atol=1e-12)
        assert float(s1[i]["step"]) == float(s0[i]["step"]) == 6 / accumulate
    o0.load_state_dict(o1.state_dict())
    assert o0.opt.param_groups[0]["capturable"] is False
    assert isinstance(o1.state_dict()["optimizer"]["param_groups"][0]["lr"],
                      float)


def test_capturable_step_keeps_zero_gradients_finite_at_lr_zero(
        capturable_on_cpu):
    """A warmup from lr 0 with an element that gets no gradient: torch's
    capturable AdamW alone makes it 0/0; the optimizer floors the device
    lr so the element stays as it was, and the others take the eager
    step's values."""
    sched = warmup_cosine_decay_schedule(0.0, 1e-2, 2, 10)
    runs = []
    for capturable in (False, True):
        leaf = torch.ones(3, requires_grad=True)
        opt = TrainOptimizer(lambda ls: torch.optim.AdamW(ls, lr=0.0),
                             [leaf], sched, capturable=capturable)
        for _ in range(3):
            plan = opt.plan(1)
            (lr,) = opt.lrs(plan)
            opt.take([torch.tensor([0.0, 1.0, -2.0])], *plan[0],
                     torch.tensor(lr))
            if not opt.step_in_graph:
                opt.update(lr)
            opt.commit(plan)
        runs.append(leaf.detach())
    assert runs[1][0] == runs[0][0] < 1.0  # decayed only, from step 2 on
    torch.testing.assert_close(runs[1], runs[0], atol=1e-6, rtol=1e-6)


# -- (e) on the card -----------------------------------------------------------
@cuda_hw
@pytest.mark.parametrize("kw", [
    dict(decode_fold=4, fold_ladder=[1, 4]),
    dict(kv_page=8, kv_pages=33, piggyback_chunks=2, spec="ngram",
         spec_depth=2, decode_fold=2),
], ids=["mono", "paged_ngram_pb"])
def test_replay_equals_eager_and_compiled_count_is_frozen(weights, kw):
    """Replayed graphs give the eager bodies' tokens, bit for bit, and no
    dispatch captures a graph after construction."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, params = weights
    rng = np.random.default_rng(6)
    reqs = [(f"r{i}", rng.integers(0, 97, n).tolist(),
             SAMPLED if i == 0 else SamplingParams(max_new_tokens=9))
            for i, n in enumerate((7, 15, 30))]
    outs = []
    for graphs in (True, False):
        eng = DecodeEngine(params, CFG, num_slots=3, max_seq=64,
                           prefill_buckets=[16, 32], device="cuda",
                           _graphs=graphs, **kw)
        n = eng.compiled_count
        assert n == (len(eng.dispatch_plan) if graphs else 0)
        outs.append(_serve(eng, reqs))
        assert eng.compiled_count == n
    assert outs[0] == outs[1]


_SCHED = warmup_cosine_decay_schedule(0.0, 0.05, 2, 20)
CARD_OPTIMIZERS = {
    # name: (factory, schedule, whether the step runs inside the graph)
    "adamw_schedule": (lambda ls: torch.optim.AdamW(
        ls, lr=0.0, weight_decay=0.1), _SCHED, True),
    "sgd_momentum": (lambda ls: torch.optim.SGD(
        ls, lr=0.05, momentum=0.9), None, True),
    "adam_amsgrad": (lambda ls: torch.optim.Adam(
        ls, lr=0.01, amsgrad=True), None, True),
    "rmsprop_schedule": (lambda ls: torch.optim.RMSprop(
        ls, lr=0.0, momentum=0.5), _SCHED, True),
    "adagrad": (lambda ls: torch.optim.Adagrad(ls, lr=0.05), None, False),
    "sgd_schedule": (lambda ls: torch.optim.SGD(ls, lr=0.0), _SCHED, False),
}


class _Opt(_Det):
    """_Det with the optimizer of ``CARD_OPTIMIZERS[name]``."""

    def __init__(self, name, **kw):
        super().__init__(**kw)
        self.opt_name = name

    def configure_optimizers(self):
        factory, sched, _ = CARD_OPTIMIZERS[self.opt_name]
        return {"optimizer": factory, "lr_schedule": sched}


class _Dropout(_Opt):
    """_Opt with a dropout mask drawn from the step's generator."""

    def training_step(self, params, batch, generator):
        keep = torch.rand(batch.shape, generator=generator,
                          device=batch.device) > 0.2
        loss = torch.mean(self._forward(params, batch * keep / 0.8) ** 2)
        return loss, {"loss": loss}


@cuda_hw
@pytest.mark.parametrize("name", list(CARD_OPTIMIZERS))
def test_train_program_replay_equals_the_eager_body(name):
    """A 2-step program under accumulation 3 (three plans of window
    positions, captured one after another, then replayed), a module that
    draws from its generator, and each optimizer: the replays give the
    eager bodies' losses, params and optimizer state, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from ray_lightning_tpu_torch.strategies.base import TrainProgram
    from ray_lightning_tpu_torch.utils.tree import tree_leaves

    rng = np.random.default_rng(3)
    batches = [rng.standard_normal((16, 32)).astype(np.float32)
               for _ in range(12)]
    runs = []
    for graphs in (True, False):
        module = _Dropout(name, dataset_length=64, batch_size=16)
        strategy = SingleDeviceStrategy("cuda")
        params = strategy.place_params(module.init_params(None, None))
        factory, sched, in_graph = CARD_OPTIMIZERS[name]
        opt = TrainOptimizer(factory, tree_leaves(params), sched,
                             clip=0.5, accumulate=3)
        assert opt.step_in_graph == in_graph
        prog = TrainProgram(strategy, module, opt, seed=7,
                            log_grad_norm=True, fold=2, _graphs=graphs)
        losses = [prog(params, batches[i : i + 2], i)["loss"]
                  for i in range(0, 12, 2)]
        assert opt.flush() is False and opt.update_count == 4
        assert len(prog.programs) == 3
        assert prog.compiled_count == (
            (3 if in_graph else 6) if graphs else 0)
        runs.append((torch.cat(losses), params, opt.opt.state_dict()))
    (l0, p0, s0), (l1, p1, s1) = runs
    assert torch.equal(l0, l1)
    for k in p0:
        assert torch.equal(p0[k], p1[k]), k
    for i, st in s0["state"].items():
        for k, v in st.items():
            assert torch.equal(torch.as_tensor(v),
                               torch.as_tensor(s1["state"][i][k])), (i, k)


@cuda_hw
@pytest.mark.parametrize("name", list(CARD_OPTIMIZERS))
def test_fit_on_the_card_matches_the_cpu(name):
    """Trainer.fit on the card (graph replays, K = 1 and K = 2 with an
    epoch tail) against the same fit on the CPU, for every optimizer kind:
    the same step count and params at the JAX bar."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for fold in (1, 2):
        fits = [_fit(n=80, max_epochs=2, steps_per_execution=fold,
                     module=_Opt(name, dataset_length=80, batch_size=16),
                     device=device) for device in ("cpu", "cuda")]
        (t0, w0), (t1, w1) = fits
        assert t0.global_step == t1.global_step == 10
        _close(w1, w0)
