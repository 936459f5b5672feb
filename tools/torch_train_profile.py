"""Where the time goes in the PyTorch port's training step, on one CUDA card.

    python3 tools/torch_train_profile.py

Builds the train step ``Trainer.fit`` runs for GPT-2 small in
``chip_smoke.py`` (``SingleDeviceStrategy.compile_train_step``: bf16
compute over fp32 master weights, flash attention forward and backward,
dense ``lm_loss``, AdamW with warmup; random weights from a seed; B=8,
S=1024), warms it up for 3 steps, then traces 2 steps with
``torch.profiler``. Prints the host wall time, the summed device time of
the kernels and their count, the device's idle share (1 - device time /
wall; the profiler's own host cost is in the wall), the device time by
kernel and by group (the port's flash kernels, GEMMs, the rest), then the
wall time of 5 more steps without the profiler. Needs a CUDA device;
prints the card's name and power limit.
"""
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _group(name: str) -> str:
    if "flash_fwd" in name:
        return "K1 flash_fwd"
    if "flash_bwd_dkv" in name:
        return "K2 flash_bwd_dkv"
    if "flash_bwd_dq" in name:
        return "K3 flash_bwd_dq"
    low = name.lower()
    if any(w in low for w in ("gemm", "cutlass", "xmma", "nvjet")):
        return "GEMM (cuBLAS)"
    return "other"


def main():
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ray_lightning_tpu_torch.models.gpt import GPTLM, GPTConfig
    from ray_lightning_tpu_torch.strategies import SingleDeviceStrategy
    from ray_lightning_tpu_torch.trainer.module import unpack_optimizers
    from ray_lightning_tpu_torch.trainer.optim import TrainOptimizer
    from ray_lightning_tpu_torch.utils.tree import tree_leaves

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"[card] {card}")
    cfg = GPTConfig.gpt2_small()
    module = GPTLM(cfg, batch_size=8, warmup_steps=2, n_train=16)
    strategy = SingleDeviceStrategy("cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = strategy.place_params(module.init_params(gen, None))
    factory, sched = unpack_optimizers(module.configure_optimizers())
    opt = TrainOptimizer(factory, tree_leaves(params), sched)
    step = strategy.compile_train_step(module, opt, seed=0)
    batches = [strategy.place_batch(b)
               for b in module.train_dataloader().iter_batches(1)]

    def run(n, start):
        for i in range(n):
            logs = step(params, batches[(start + i) % len(batches)], start + i)
        torch.cuda.synchronize()
        return float(logs["loss"])

    run(3, 0)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run(2, 3)
        wall = time.perf_counter() - t0
    # Device events, without the ranges that annotate them (such as
    # "Optimizer.step#AdamW.step"), which would count their kernels twice.
    kernels = [
        e for e in prof.events()
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation
    ]
    busy_us = sum(e.device_time_total for e in kernels)
    print(f"[2 train steps] wall {wall * 1e3:.3f} ms, device kernels "
          f"{len(kernels)}, device time {busy_us / 1e3:.3f} ms, idle share "
          f"{1 - busy_us / 1e6 / wall:.3f}")
    by_name, by_group = {}, {}
    for e in kernels:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.device_time_total, n + 1)
        g = _group(e.name)
        t, n = by_group.get(g, (0.0, 0))
        by_group[g] = (t + e.device_time_total, n + 1)
    for g, (t, n) in sorted(by_group.items(), key=lambda x: -x[1][0]):
        print(f"[group] {t / 1e3:9.3f} ms ({t / busy_us:.3f})  x{n:<5d} {g}")
    for kname, (t, n) in sorted(by_name.items(), key=lambda x: -x[1][0])[:25]:
        print(f"[kernel] {t / 1e3:9.3f} ms  x{n:<5d} {kname[:110]}")
    t0 = time.perf_counter()
    loss = run(5, 5)
    print(f"[unprofiled] 5 steps: {(time.perf_counter() - t0) * 1e3 / 5:.3f} "
          f"ms per step, last loss {loss}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")


if __name__ == "__main__":
    main()
