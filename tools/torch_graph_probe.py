"""A first check of the CUDA graphs on the card: a monolithic engine, a
paged n-gram speculative engine with piggyback and the fold ladder, and a
draft-model engine, each built with graphs and with the eager dispatch
(``_graphs=False``) on the same requests (capture seconds, graph pool,
wall, mismatched requests), then a 2-layer GPT-2-small-width GPTLM
trained 8 steps with ``steps_per_execution`` 1 and 4 (losses at the
K = 4 run's boundaries, steps 4 and 8, against the K = 1 run's), and the
training pair of ``chip_smoke.py``'s train phase (GPT-2 small, 4
batches per epoch, 20 steps) with AdamW in torch's capturable mode
(captured with the step, the card's default) and in its ordinary mode
(stepping between per-step graphs): the per-step losses of both.

Run on the card from the repo root: ``python3 tools/torch_graph_probe.py
[mono] [paged] [model] [train] [adam]`` (the sections named, or all).
"""
import os, sys, time, json, traceback
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np
import torch
import chip_smoke as cs
from ray_lightning_tpu_torch.models import gpt
from ray_lightning_tpu_torch.serve.engine import DecodeEngine
from ray_lightning_tpu_torch.ops.flash_attention import counters

print(sys.version, torch.__version__, torch.version.cuda, flush=True)
cs.phase_build()
cfg = gpt.GPTConfig.gpt2_small()
params = gpt.init_gpt_params(torch.Generator(device="cuda").manual_seed(0), cfg)


def drive(eng, reqs):
    outs = {}
    for rid, p, kw in reqs:
        slot, tok, done = eng.admit(p, request_id=rid, **kw)
        outs[rid] = [tok]
    t0 = time.perf_counter(); folds = 0
    while eng.num_active:
        for _, rid, t, _ in eng.step():
            outs[rid].append(t)
        folds += 1
    torch.cuda.synchronize()
    return outs, time.perf_counter() - t0, folds


def try_(name, fn):
    try:
        fn()
    except Exception:
        print(f"[{name}] FAILED", flush=True)
        traceback.print_exc()


def mono():
    rng = np.random.default_rng(0)
    reqs = [(f"r{i}", rng.integers(0, 50257, n).tolist(),
             dict(max_new_tokens=33, **({} if i % 3 else dict(temperature=0.8, top_k=50, top_p=0.9, seed=i))))
            for i, n in enumerate([16, 24, 40, 96, 128, 256, 384, 16])]
    res = {}
    for graphs in (True, False):
        t0 = time.perf_counter()
        eng = DecodeEngine(params, cfg, num_slots=8, max_seq=1024, decode_fold=8,
                           pipeline=False, device="cuda", _graphs=graphs)
        torch.cuda.synchronize()
        print(f"[mono graphs={graphs}] built {time.perf_counter()-t0:.2f}s compiled {eng.compiled_count} "
              f"capture_s {eng.capture_s:.2f} graph MiB {eng.graph_bytes/2**20:.1f}", flush=True)
        counters.reset()
        outs, wall, folds = drive(eng, reqs)
        print(f"[mono graphs={graphs}] wall {wall:.3f}s folds {folds} K1 {counters.launches} "
              f"compiled {eng.compiled_count}", flush=True)
        res[graphs] = outs
    mism = [r for r in res[True] if res[True][r] != res[False][r]]
    print(f"[mono] graph vs eager mismatched requests: {mism}", flush=True)


def paged_spec():
    rng = np.random.default_rng(1)
    base = rng.integers(0, 50257, 64).tolist()
    reqs = [(f"p{i}", (base * 8)[: n], dict(max_new_tokens=40, **({} if i % 2 else dict(temperature=0.8, top_k=20, seed=i))))
            for i, n in enumerate([100, 300, 520, 40])]
    res = {}
    for graphs in (True, False):
        t0 = time.perf_counter()
        eng = DecodeEngine(params, cfg, num_slots=8, max_seq=1024, kv_page=16, kv_pages=257,
                           prefill_chunk=256, piggyback_chunks=4, fold_ladder=[1, 2, 4, 8],
                           decode_fold=8, spec="ngram", spec_depth=4, device="cuda", _graphs=graphs)
        torch.cuda.synchronize()
        print(f"[paged graphs={graphs}] built {time.perf_counter()-t0:.2f}s compiled {eng.compiled_count} "
              f"capture_s {eng.capture_s:.2f} graph MiB {eng.graph_bytes/2**20:.1f}", flush=True)
        outs = {}
        for rid, p, kw in reqs:
            eng.admit(p, request_id=rid, **kw); outs[rid] = []
        t0 = time.perf_counter(); folds = 0
        while eng.num_active:
            for _, rid, t, _ in eng.step():
                outs[rid].append(t)
            for slot, task, tok, done in eng.pop_chunk_events():
                outs[task.request_id].insert(0, tok)
            folds += 1
        torch.cuda.synchronize()
        print(f"[paged graphs={graphs}] wall {time.perf_counter()-t0:.3f}s folds {folds} "
              f"lens {[len(v) for v in outs.values()]}", flush=True)
        res[graphs] = outs
    mism = [r for r in res[True] if res[True][r] != res[False][r]]
    print(f"[paged] graph vs eager mismatched requests: {mism}", flush=True)


def spec_model():
    draft = cs.draft_params_of(params, 6)
    dcfg = gpt.GPTConfig.gpt2_small(n_layer=6)
    eng = DecodeEngine(params, cfg, num_slots=8, max_seq=1024, decode_fold=4, spec="model",
                       spec_depth=4, spec_params=draft, spec_config=dcfg, spec_window=32,
                       pipeline=False, device="cuda")
    print(f"[model] compiled {eng.compiled_count} capture_s {eng.capture_s:.2f}", flush=True)
    counters.reset()
    outs, wall, folds = drive(eng, [("m0", list(range(100, 164)), dict(max_new_tokens=20))])
    print(f"[model] wall {wall:.3f} folds {folds} K1 {counters.launches} n {len(outs['m0'])}", flush=True)


def train():
    from ray_lightning_tpu_torch.trainer import Trainer
    from ray_lightning_tpu_torch.trainer.callbacks import Callback

    class Rec(Callback):
        def __init__(self): self.l = []
        def on_train_batch_end(self, trainer, module, logs, batch_idx): self.l.append(logs["loss"])

    out = {}
    for K in (1, 4):
        tcfg = gpt.GPTConfig.gpt2_small(n_layer=2, max_seq=256)
        m = gpt.GPTLM(tcfg, batch_size=8, n_train=64, warmup_steps=2)
        rec = Rec()
        t = Trainer(max_steps=8, log_every_n_steps=1, seed=0, enable_checkpointing=False,
                    enable_model_summary=False, precision="bf16-mixed", callbacks=[rec],
                    num_sanity_val_steps=0, limit_val_batches=0, steps_per_execution=K)
        counters.reset()
        t0 = time.perf_counter()
        t.fit(m)
        torch.cuda.synchronize()
        print(f"[train K={K}] {time.perf_counter()-t0:.2f}s losses {rec.l} K2 {counters.bwd_dkv_launches}", flush=True)
        out[K] = rec.l
    # K = 4 logs at its 4-step boundaries: the K = 1 run's steps 4 and 8.
    print("[train] equal", out[1][3::4] == out[4])


def adam_modes():
    import functools

    from ray_lightning_tpu_torch.trainer import loop, optim
    from ray_lightning_tpu_torch.trainer import Trainer
    from ray_lightning_tpu_torch.trainer.callbacks import Callback

    class Rec(Callback):
        def __init__(self): self.l = []
        def on_train_batch_end(self, trainer, module, logs, batch_idx): self.l.append(logs["loss"])

    out = {}
    for capturable in (True, False):
        loop.TrainOptimizer = functools.partial(optim.TrainOptimizer, capturable=capturable)
        rec = Rec()
        t = Trainer(max_steps=20, max_epochs=20, limit_val_batches=0, enable_checkpointing=False,
                    enable_model_summary=False, seed=0, log_every_n_steps=1, callbacks=[rec])
        t.fit(gpt.GPTLM(gpt.GPTConfig.gpt2_small(), batch_size=8, warmup_steps=2, n_train=4 * 8))
        print(f"[adam capturable={capturable}] losses {rec.l}", flush=True)
        out[capturable] = rec.l
    loop.TrainOptimizer = optim.TrainOptimizer
    diff = [abs(a - b) / abs(b) for a, b in zip(out[True], out[False])]
    print(f"[adam] relative loss difference per step {diff}", flush=True)


if __name__ == "__main__":
    only = sys.argv[1:]
    for n, f in (("mono", mono), ("paged", paged_spec), ("model", spec_model),
                 ("train", train), ("adam", adam_modes)):
        if not only or n in only:
            try_(n, f)
