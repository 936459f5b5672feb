"""Where the time of a paged and of a speculative fold goes, and what the
sampled-spec draw restore costs, on one CUDA card.

    python3 tools/torch_spec_profile.py

GPT-2 small at published widths (random weights from a seed, bf16), the
engines of ``chip_smoke.py``'s serve-paged and serve-spec phases, each
with every slot decoding 64-token prompts of tiled 8-16-token spans:

- a dense chunked and a paged engine (16 slots, ``PAGED_ENGINE``), fold 4;
- the paged engine with ``spec="ngram"`` (depth 4, fold 4);
- a dense monolithic engine (8 slots, fold 4) with ``spec="off"`` and
  with ``spec="model"`` (the 6-block self-draft, a 32-token window).

For each: one fold traced with ``torch.profiler`` (host wall, device time
and kernel count, the device's idle share, the kernels that took the most
device time), then five folds untraced on the host clock and their
median.

Then the draw restore. A sampled slot's generator state is kept before
each of a verify's depth + 1 draws, and the host reads the verify's
emitted counts (a device sync) to restore it. The paged n-gram fold is run
on the same state with no generator and with one generator on a slot
whose temperature is 0 (its tokens stay the greedy ones), ten times each
in turns; the difference, less the extra sampling work (one row's filter
and draw, timed alone), is the read's cost per verify. Prints the card's
name and power limit.
"""
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _report(name, prof, wall_s, top=10):
    from torch.autograd import DeviceType

    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.device_time_total for e in kernels)
    print(f"[{name}] wall {wall_s * 1e3:.3f} ms, device kernels "
          f"{len(kernels)}, device time {busy_us / 1e3:.3f} ms, idle share "
          f"{1 - busy_us / 1e6 / wall_s:.3f}")
    by_name = {}
    for e in kernels:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.device_time_total, n + 1)
    for kname, (t, n) in sorted(by_name.items(), key=lambda x: -x[1][0])[:top]:
        print(f"[{name}]   {t / 1e3:9.3f} ms  x{n:<5d} {kname[:110]}")


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


def tiled_prompts(n, vocab, seed=0):
    """``n`` 64-token prompts, each an 8-16-token span tiled."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        span = rng.integers(0, vocab, int(rng.integers(8, 17))).tolist()
        out.append((span * 8)[:64])
    return out


def fill(engine, n_new):
    """Every slot decoding a tiled 64-token prompt."""
    prompts = tiled_prompts(engine.num_slots, engine.cfg.vocab_size)
    engine.admit_many([dict(prompt=p, request_id=f"d{i}", max_new_tokens=n_new)
                       for i, p in enumerate(prompts)])
    while engine.num_prefilling:
        engine.prefill_step(engine.num_slots)


def profile_folds(name, engine, profiled=True):
    """One fold to warm up, one traced, five untraced; returns the
    untraced median in ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fill(engine, 160)
    engine.step()
    _sync(engine.device)
    if profiled:
        acts = [ProfilerActivity.CPU]
        if engine.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            engine.step()
            _sync(engine.device)
            wall = time.perf_counter() - t0
        _report(name, prof, wall)
    ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        n = len(engine.step())
        _sync(engine.device)
        ms.append((time.perf_counter() - t0) * 1e3)
    med = statistics.median(ms)
    print(f"[{name}] untraced folds ms {[round(t, 3) for t in ms]}, median "
          f"{med:.3f}, tokens in the last {n}")
    return med


def draw_restore_cost(engine, pairs=10):
    """The paged n-gram fold on one state, with no generator and with one
    on slot 0 at temperature 0, in turns; and one row's extra sampling
    work alone. Returns the read's ms per verify and the parts."""
    import torch

    from ray_lightning_tpu_torch.models.gpt import (
        gpt_decode_fold_spec,
        sample_logits_batched,
    )

    fill(engine, 160)
    engine.step()
    dev = engine.device
    B = engine.num_slots
    state = [t.clone() for t in (engine._cur, engine._pos)]
    temps = torch.zeros(B, device=dev)
    top_ks = torch.full((B,), 50, device=dev, dtype=torch.long)
    top_ps = torch.full((B,), 0.9, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def fold(gens):
        _sync(dev)
        t0 = time.perf_counter()
        with torch.no_grad():
            gpt_decode_fold_spec(
                engine.params, engine.cfg, *state, gens, temps, top_ks,
                top_ps, engine._active.clone(), engine._remaining.clone(),
                engine._eos, engine._hist.clone(), engine._pool_k,
                engine._pool_v, fold=engine.decode_fold,
                depth=engine.spec_depth, draft_fn=engine._draft,
                page_table=engine._table, page_size=engine.kv_page,
            )
        _sync(dev)
        return (time.perf_counter() - t0) * 1e3

    none, one = [None] * B, [gen] + [None] * (B - 1)
    fold(none)
    fold(one)
    plain, sampled = [], []
    for i in range(pairs):
        for gens, out in ((none, plain), (one, sampled))[:: 1 if i % 2 else -1]:
            out.append(fold(gens))
    logits = torch.randn((B, engine.cfg.vocab_size), device=dev)

    def sample_ms(gens, n=50):
        sample_logits_batched(logits, temps, top_ks, top_ps, gens)
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(n):
            sample_logits_batched(logits, temps, top_ks, top_ps, gens)
        _sync(dev)
        return (time.perf_counter() - t0) * 1e3 / n

    extra_sample = sample_ms(one) - sample_ms(none)
    verifies = engine.decode_fold
    d_fold = statistics.median(sampled) - statistics.median(plain)
    read = d_fold / verifies - (engine.spec_depth + 1) * extra_sample
    out = {
        "fold_ms_no_generator": statistics.median(plain),
        "fold_ms_one_generator": statistics.median(sampled),
        "fold_ms_no_generator_all": plain,
        "fold_ms_one_generator_all": sampled,
        "extra_sampling_ms_per_draw": extra_sample,
        "read_ms_per_verify": read,
    }
    print(f"[draw restore] {out}")
    return out


def run(params, cfg, device):
    """Every section on ``device`` (a CUDA card, or the CPU at a small
    width to rehearse the control flow)."""
    import dataclasses

    import chip_smoke
    from ray_lightning_tpu_torch.serve.engine import DecodeEngine

    paged = dict(chip_smoke.PAGED_ENGINE, decode_fold=chip_smoke.SPEC_FOLD)
    dense = {k: v for k, v in paged.items() if not k.startswith("kv_")}
    ngram = dict(paged, spec="ngram", spec_depth=chip_smoke.SPEC_DEPTH)
    draft = chip_smoke.draft_params_of(params, chip_smoke.SPEC_DRAFT_LAYERS)
    model = dict(
        chip_smoke.SPEC_MODEL_ENGINE, spec="model",
        spec_depth=chip_smoke.SPEC_DEPTH, spec_params=draft,
        spec_config=dataclasses.replace(
            cfg, n_layer=chip_smoke.SPEC_DRAFT_LAYERS),
        spec_window=chip_smoke.SPEC_WINDOW,
    )
    folds = {}
    for name, kw in (("dense chunked fold, 16 slots", dense),
                     ("paged fold, 16 slots", paged),
                     ("paged n-gram spec fold, 16 slots", ngram),
                     ("dense monolithic fold, 8 slots",
                      chip_smoke.SPEC_MODEL_ENGINE),
                     ("dense model spec fold, 8 slots", model)):
        engine = DecodeEngine(params, cfg, device=device, **kw)
        folds[name] = profile_folds(name, engine)
        if kw is ngram:
            engine = DecodeEngine(params, cfg, device=device, **kw)
            restore = draw_restore_cost(engine)
        del engine
    print(f"[summary] untraced median ms per fold {folds}; draw restore "
          f"{ {k: v for k, v in restore.items() if not k.endswith('_all')} }")


def main():
    import torch

    from ray_lightning_tpu_torch.models import gpt

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"[card] {card}")
    cfg = gpt.GPTConfig.gpt2_small()
    params = gpt.init_gpt_params(
        torch.Generator(device="cuda").manual_seed(0), cfg
    )
    run(params, cfg, torch.device("cuda"))
    print(f"[card] {card}")


if __name__ == "__main__":
    main()
