"""Where the time of a paged and of a speculative fold goes, and what the
sampling variant of a fold costs, on one CUDA card.

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

Every fold is a CUDA graph replay. Then the sampling variant: the paged
n-gram engine's deepest fold program replayed in its greedy and its
sampling variant (every row's top-k/top-p filter and the device draw),
ten times each in turns, device ms through CUDA events. Prints the
card's name and power limit.
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


def sampling_cost(engine, pairs=10):
    """The engine's deepest fold program in its greedy and its sampling
    variant (the per-row filter and the device draw), replayed in turns:
    device ms of each, through CUDA events around the replay."""
    import torch

    fill(engine, 160)
    engine.step()
    k = engine.fold_ladder[-1]
    progs = {s: engine._programs[engine._fold_key(k, s)]
             for s in (False, True)}

    def replay(prog):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        _sync(engine.device)
        a.record()
        with torch.no_grad():
            prog()
        b.record()
        _sync(engine.device)
        return a.elapsed_time(b)

    times = {False: [], True: []}
    for i in range(pairs):
        for s in ((False, True) if i % 2 else (True, False)):
            times[s].append(replay(progs[s]))
    out = {"fold_ms_greedy": statistics.median(times[False]),
           "fold_ms_sampling": statistics.median(times[True]),
           "fold_ms_greedy_all": times[False],
           "fold_ms_sampling_all": times[True]}
    print(f"[sampling variant] {out}")
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
            sampling = sampling_cost(engine)
        del engine
    print(f"[summary] untraced median ms per fold {folds}; sampling variant "
          f"{ {k: v for k, v in sampling.items() if not k.endswith('_all')} }")


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
