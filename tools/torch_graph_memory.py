"""Where the device memory of a serving engine's CUDA graphs goes.

For the engines of ``chip_smoke.py``'s serve phase and serve-fused phase
(a) and (b), at GPT-2-small width, built without graphs, this prints:

- each dispatch body's transient working set: the peak bytes it
  allocates above what was live before it, run once eagerly;
- the graph pool when every body of the dispatch plan is captured into
  one pool, as the engine does, with every capture on one side stream
  (``utils/graphs.py:side_stream``) and, for comparison, each capture on
  a stream of its own;
- what the shared-stream pool still holds once the captures are done:
  its live blocks (with the line of the port that allocated the largest)
  and its free ones, from ``torch.cuda.memory_snapshot()``.

Run on the card from the repo root (about a minute, the kernels' build
included): ``python3 tools/torch_graph_memory.py``.
"""
from __future__ import annotations

import gc
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from ray_lightning_tpu_torch.models import gpt  # noqa: E402
from ray_lightning_tpu_torch.serve.engine import DecodeEngine  # noqa: E402
from ray_lightning_tpu_torch.utils import graphs  # noqa: E402

MIB = 2**20
ENGINES = {
    "serve (monolithic, 8 slots, fold 8)": cs.SERVE_ENGINE,
    "serve-fused (a) (paged, piggyback 4, ladder 1-8)": cs.FUSED_PAGED_ENGINE,
    "serve-fused (b) (dense chunked n-gram, piggyback 2)":
        cs.FUSED_SPEC_ENGINE,
}


def reserved() -> int:
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved()


def body_peaks(eng) -> dict:
    """Each dispatch body's peak allocation above the live bytes, eager."""
    out = {}
    with torch.no_grad():
        for key in eng.dispatch_plan:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            live = torch.cuda.memory_allocated()
            eng._programs[key]()
            torch.cuda.synchronize()
            out[key] = torch.cuda.max_memory_allocated() - live
        eng._reset_state()
    return out


def site(block: dict) -> str:
    """The innermost frame of the port in a block's allocation stack."""
    for f in block.get("frames") or ():
        if "ray_lightning_tpu_torch" in f.get("filename", ""):
            name = f["filename"].split("ray_lightning_tpu_torch/")[-1]
            return f"{name}:{f['line']} ({f['name']})"
    return "?"


def capture_all(eng, stream_per_graph: bool, record: bool) -> dict:
    """Capture every body of the plan into one pool; the pool's bytes and,
    with ``record``, its live and free blocks."""
    base = reserved()
    pool = torch.cuda.graph_pool_handle()
    shared = graphs.side_stream
    progs = []
    if record:
        torch.cuda.memory._record_memory_history(max_entries=200000)
    try:
        with torch.no_grad():
            for key in eng.dispatch_plan:
                if stream_per_graph:
                    s = torch.cuda.Stream()
                    graphs.side_stream = lambda s=s: s
                prog = graphs.Program(eng._body(key))
                prog.warm_up()
                prog.capture(pool)
                progs.append(prog)
            eng._reset_state()
    finally:
        graphs.side_stream = shared
    out = {"pool_mib": (reserved() - base) / MIB}
    if record:
        segs = [s for s in torch.cuda.memory_snapshot()
                if tuple(s.get("segment_pool_id", (0, 0))) == tuple(pool)]
        live = [b for s in segs for b in s["blocks"]
                if b["state"] == "active_allocated"]
        out.update(
            pool_segments_mib=sum(s["total_size"] for s in segs) / MIB,
            pool_live_mib=sum(b["size"] for b in live) / MIB,
            pool_free_mib=sum(b["size"] for s in segs for b in s["blocks"]
                              if b["state"] == "inactive") / MIB,
            largest_live=[(round(b["size"] / MIB, 3), site(b))
                          for b in sorted(live, key=lambda b: -b["size"])[:6]],
        )
        torch.cuda.memory._record_memory_history(enabled=None)
    del progs
    reserved()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    cs.phase_build()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    cfg = gpt.GPTConfig.gpt2_small()
    params = gpt.init_gpt_params(
        torch.Generator(device="cuda").manual_seed(0), cfg)
    for name, kw in ENGINES.items():
        eng = DecodeEngine(params, cfg, device="cuda", _graphs=False, **kw)
        peaks = body_peaks(eng)
        top = sorted(peaks.items(), key=lambda kv: -kv[1])[:4]
        row = {
            "engine": name,
            "graphs": len(eng.dispatch_plan),
            "max_body_peak_mib": max(peaks.values()) / MIB,
            "sum_body_peaks_mib": sum(peaks.values()) / MIB,
            "largest_bodies": [(list(k), round(v / MIB, 1)) for k, v in top],
            "stream_per_graph": capture_all(eng, True, False),
            "shared_stream": capture_all(eng, False, True),
        }
        print(f"[graph-memory] {json.dumps(row)} on {card}", flush=True)
        del eng
        reserved()
    return 0


if __name__ == "__main__":
    sys.exit(main())
