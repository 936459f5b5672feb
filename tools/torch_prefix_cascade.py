"""Replay the tier cascade of ``chip_smoke.py``'s serve-chunked phase on the CPU.

    python3 tools/torch_prefix_cascade.py

Which prefix-cache tier serves a block is decided by the pool's LRU, the
host tier's and the disk tier's byte budgets and the order of admissions,
chunks and insertions: not by the model. This tool runs the phase's
requests (``chip_smoke.chunked_workload``) through the function that runs
the phase (``chip_smoke.serve_chunked_run``) and engine settings with a one-layer
model 8 wide instead of GPT-2 small, and budgets that hold the same
number of blocks (16 in the host tier, 113 on disk), so the per-tier
counters and the source of every wave-B admission's blocks are those the
card run must print. To try another flood size, edit
``chip_smoke.CHUNKED_FLOODS`` and run it again. Exits non-zero unless wave
B hit the device pool and promoted blocks from the host and the disk tier.
Timings here are the CPU's and mean nothing for the card.
"""
import io
import json
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def npy_bytes(shape, dtype) -> int:
    import numpy as np

    buf = io.BytesIO()
    np.save(buf, np.zeros(shape, dtype))
    return len(buf.getvalue())


def block_files(cfg, block: int) -> int:
    """Bytes of one block's three files in the disk tier (bf16)."""
    import numpy as np

    raw = (1, cfg.n_layer, 1, block, cfg.kv_head, cfg.head_dim * 2)
    return npy_bytes((1, 5, 2), np.int64) + 2 * npy_bytes(raw, np.uint8)


def main() -> None:
    import torch

    from ray_lightning_tpu_torch.models import gpt
    from ray_lightning_tpu_torch.serve.engine import DecodeEngine
    from ray_lightning_tpu_torch.serve.scheduler import Scheduler

    full = gpt.GPTConfig.gpt2_small()
    tiny = gpt.GPTConfig(vocab_size=full.vocab_size, n_layer=1, n_head=2,
                         d_model=8, max_seq=full.max_seq,
                         compute_dtype="bfloat16")
    kw = dict(chip_smoke.CHUNKED_ENGINE)
    bs = kw["prefix_block"]

    def block_kv(cfg):
        return 2 * cfg.n_layer * bs * cfg.kv_head * cfg.head_dim * 2

    host_blocks = int(kw["prefix_host_mb"] * (1 << 20)) // block_kv(full)
    disk_blocks = int(kw["prefix_disk_mb"] * (1 << 20)) // block_files(full, bs)
    kw["prefix_host_mb"] = host_blocks * block_kv(tiny) / (1 << 20)
    kw["prefix_disk_mb"] = (disk_blocks + 0.5) * block_files(tiny, bs) / (1 << 20)
    print(f"[cascade] GPT-2 small: block {block_kv(full)} bytes; host tier "
          f"{host_blocks} blocks, disk tier {disk_blocks} blocks "
          f"({block_files(full, bs)} bytes of files each)")
    params = gpt.init_gpt_params(torch.Generator().manual_seed(0), tiny)
    disk = tempfile.mkdtemp(prefix="prefix_cascade_")
    try:
        engine = DecodeEngine(params, tiny, device="cpu",
                              prefix_disk_dir=disk, **kw)
        sched = Scheduler(engine, **chip_smoke.CHUNKED_SCHED)
        work = chip_smoke.chunked_workload(tiny.vocab_size)
        res = chip_smoke.serve_chunked_run(engine, sched, work,
                                           chip_smoke.SERVE_NEW)
    finally:
        shutil.rmtree(disk, ignore_errors=True)
    snap = sched.metrics.snapshot()
    print(json.dumps({
        "floods": chip_smoke.CHUNKED_FLOODS,
        "prefix_hit_rate": snap["prefix_hit_rate"],
        "prefill_chunks_per_admit": snap["prefill_chunks_per_admit"],
        "tiers": engine.prefix_tier_counters(),
        "long_prompt_chunks": res["long_chunks"],
    }))
    wave_b = {k: sum(src[k] for src in res["sources"].values())
              for k in ("device_hits", "host_promotions", "disk_promotions")}
    print(f"[cascade] wave B: {json.dumps(wave_b)}")
    if not all(wave_b.values()):
        sys.exit(1)


if __name__ == "__main__":
    main()
