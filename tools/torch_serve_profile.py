"""Where the time goes in the PyTorch port's serving path, on one CUDA card.

    python3 tools/torch_serve_profile.py

Builds the GPT-2-small engine of ``chip_smoke.py`` (random weights from a
seed, bf16, 8 slots, decode fold 8), warms it up, then traces with
``torch.profiler``: one admission of a 1000-token prompt (bucket 1024),
and two decode folds with all 8 slots busy. For each it prints the host
wall time, the summed device time of the kernels and their count, the
device's idle share (1 - device time / wall; the profiler's own host cost
is in the wall) and the kernels that took the most device time; then the
wall time of each of five more folds without the profiler, and their
median (the host sets a fold's time, and its clock varies from fold to
fold). Then the chunked engine of ``chip_smoke.py``'s serve-chunked phase
(``CHUNKED_ENGINE``, its disk tier in a temporary directory under
``build/``): a 256-token chunk at position 512, a final chunk with the
first token and the insertion of 62 blocks into a pool with room, and the
same into a full pool, whose 62 evictions spill to the host and the disk
tier; each traced as above, then the same three untraced on the host
clock. Needs a CUDA device; prints the card's name and power limit.
"""
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _report(name, prof, wall_s, top=12):
    from torch.autograd import DeviceType

    kernels = [
        e for e in prof.events() if e.device_type == DeviceType.CUDA
    ]
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


def main():
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ray_lightning_tpu_torch.models import gpt
    from ray_lightning_tpu_torch.serve.engine import DecodeEngine

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
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
    engine = DecodeEngine(
        params, cfg, num_slots=8, max_seq=1024, decode_fold=8, pipeline=False,
        device="cuda"
    )
    rng = np.random.default_rng(0)

    def admit(n, rid, new):
        return engine.admit(rng.integers(0, cfg.vocab_size, n).tolist(),
                            request_id=rid, max_new_tokens=new)

    # Warm-up: every bucket the trace uses, and a few folds.
    admit(1000, "w0", 2)
    engine.step()
    torch.cuda.synchronize()

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        admit(1000, "p", 2)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _report("admit P=1000 (bucket 1024)", prof, wall)
    engine.step()

    for s in range(engine.num_slots):
        admit(16, f"d{s}", 8 * 8 + 1)
    engine.step()
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        engine.step()
        engine.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _report("2 decode folds, 8 slots", prof, wall)
    folds_ms = []
    while engine.num_active:
        t0 = time.perf_counter()
        n = len(engine.step())
        folds_ms.append((time.perf_counter() - t0) * 1e3)
    print(f"[decode unprofiled] {len(folds_ms)} folds of {n} tokens, ms: "
          f"{[round(t, 3) for t in folds_ms]}, median "
          f"{sorted(folds_ms)[len(folds_ms) // 2]:.3f}")
    chunked(params, cfg, rng, acts)


def chunked(params, cfg, rng, acts):
    """A chunk, a final chunk with its insertion into a pool with room,
    and one whose insertion evicts and spills: 1000-token prompts, 4
    chunks each, 62 full blocks of 16 positions into a 64-block pool.
    Three passes: untraced (warm-up), traced, untraced."""
    import shutil
    import tempfile

    import torch
    from torch.profiler import profile

    import chip_smoke
    from ray_lightning_tpu_torch.serve.engine import DecodeEngine

    root = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "build")
    os.makedirs(root, exist_ok=True)
    disk = tempfile.mkdtemp(prefix="profile_prefix_", dir=root)

    def run(name, fn, traced):
        torch.cuda.synchronize()
        if not traced:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        _report(name, prof, wall)
        return wall * 1e3

    try:
        for traced in (False, True, False):
            # A new engine starts with an empty pool and an empty disk tier.
            engine = DecodeEngine(params, cfg, device="cuda",
                                  prefix_disk_dir=disk,
                                  **chip_smoke.CHUNKED_ENGINE)
            times = {}
            for label in ("empty pool", "full pool"):
                engine.admit(rng.integers(0, cfg.vocab_size, 1000).tolist(),
                             request_id=label, max_new_tokens=2)
                engine.prefill_step(2)
                times[f"chunk at 512, {label}"] = run(
                    "chunk of 256 at 512", lambda: engine.prefill_step(1),
                    traced and label == "empty pool")
                spills = engine.tier_counters["device"]["spills"]
                times[f"final chunk + insert, {label}"] = run(
                    f"final chunk + insert, {label}",
                    lambda: engine.prefill_step(1), traced)
                print(f"[chunked] {label}: {engine.prefix_inserts} inserts "
                      f"so far, spills in the final chunk "
                      f"{engine.tier_counters['device']['spills'] - spills}")
                while engine.num_active:
                    engine.step()
            print(f"[chunked] host-clock ms ({'traced' if traced else 'untraced'}): "
                  f"{times}")
    finally:
        shutil.rmtree(disk, ignore_errors=True)


if __name__ == "__main__":
    main()
