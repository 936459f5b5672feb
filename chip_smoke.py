#!/usr/bin/env python3
"""Smoke run of the PyTorch port (ray_lightning_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero (nothing is caught):

1. Build every kernel of the port from the sources in this checkout
   (``nvcc``, one process per source, all started together) and print the
   build time and the card's name and power limit.
2. Hold each kernel against its plain PyTorch version on the card, in bf16
   and fp32, causal, non-causal, window and window + sinks, at the serving
   path's shapes (B=1, S in {16, 128, 1024}, H=12, D=64) plus a ragged
   S=40 and a D=128 shape; time the kernel, the plain version and
   ``torch.nn.functional.scaled_dot_product_attention`` (a yardstick only:
   the port never calls it) with CUDA events, beside the kernel's bound.
3. Hold the backward kernels K2 (dK/dV) and K3 (dQ) against
   ``flash_attention_bwd_plain`` on the same cases, in bf16 and fp32.
   Then, at the training call (B=8, S=1024, H=12, D=64, bf16, causal,
   q/k/v the strided views of the fused projection), hold K1's out/lse
   and K2/K3's dq/dk/dv against the plain versions, and time K2 and K3
   beside the backward of ``scaled_dot_product_attention`` (a yardstick
   only) and each kernel's bound.
4. Serve GPT-2-small width (random weights from a seeded generator, bf16)
   through ``Scheduler`` -> ``DecodeEngine``: 8 requests with prompts
   spread over the prefill buckets, 32 new tokens each, 6 greedy and 2
   sampled (temperature 0.8, top-k 50, top-p 0.9). Every request must
   finish with its token count, the caches must stay finite, the flash
   kernel must have run once per layer per admission and the reference
   path never. Greedy requests are compared with the port's solo
   ``gpt_generate``; then a full batch decodes alone, its folds timed.
5. Train GPT-2 small at full width and depth for 20 steps through
   ``Trainer.fit`` (B=8, S=1024, bf16 compute, flash attention, AdamW
   with warmup): every step's loss must be finite and the last below the
   first, each backward kernel must have run once per layer per step and
   the reference path never. Prints step time, tokens/s, MFU and peak
   memory.
6. Print the ``{"kernels": [...]}`` line, the card line, and last
   ``{"ok": true, "device": {...}}``.

Exits non-zero without a CUDA device, and when the package is not beside
this file.
"""
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

#: bf16 and fp32 peak rates (dense) and memory rate of one H100 SXM.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
MEM_BYTES_PER_S = 3.35e12
#: Kernel vs plain version: |kernel - plain| <= ATOL + RTOL * |plain|.
#: fp32: both sum in fp32 in other orders. bf16: both compute in fp32 from
#: the same bf16 inputs and round the output once, so they may differ by
#: about two bf16 units in the last place. lse is fp32 in both dtypes.
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-2, 1e-2)}
LSE_TOL = 1e-3
#: Greedy engine vs solo generate: a token may differ only where the solo
#: run's top-2 logit margin is below this.
MARGIN = 1e-3


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_build():
    from ray_lightning_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build_all()
    print(f"[build] kernels {_build.kernel_sources()} built in "
          f"{time.perf_counter() - t0:.3f} s into {_build.BUILD_DIR}")
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"[build] {name}: {line.strip()}")
    print(f"[card] {card_line()}")


def flash_bound(q, window, sinks, causal):
    """(bound_ms, bound_by): each input read once and each output written
    once over the memory rate; 4*D FLOPs per visible (query, key) pair
    (QK^T and PV) over the peak rate of the input type."""
    import torch

    from ray_lightning_tpu_torch.ops.attention import band_allowed

    B, S, H, D = q.shape
    rows = torch.arange(S, device=q.device)[:, None]
    cols = torch.arange(S, device=q.device)[None, :]
    pairs = (
        int(band_allowed(rows, cols, window, sinks).sum()) if causal else S * S
    )
    flops = 4.0 * D * pairs * B * H
    nbytes = 4 * q.numel() * q.element_size() + B * H * S * 4
    dtype = str(q.dtype).replace("torch.", "")
    t_ops = flops / PEAK_FLOPS[dtype]
    t_mem = nbytes / MEM_BYTES_PER_S
    return max(t_ops, t_mem) * 1e3, "operations" if t_ops > t_mem else "bytes"


def phase_kernels():
    import torch
    import torch.nn.functional as F

    from ray_lightning_tpu_torch.ops.flash_attention import (
        _flash_fwd_cuda,
        flash_attention_plain,
    )

    shapes = [
        (1, 16, 12, 64), (1, 128, 12, 64), (1, 1024, 12, 64),
        (1, 40, 12, 64), (1, 256, 8, 128),
    ]
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    timed = None
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).replace("torch.", "")
        atol, rtol = TOL[dname]
        for B, S, H, D in shapes:
            q, k, v = (
                torch.randn((B, S, H, D), generator=gen, device="cuda")
                .to(dtype) for _ in range(3)
            )
            window = max(5, S // 4)
            for causal, w, s in (
                (True, 0, 0), (False, 0, 0), (True, window, 0),
                (True, window, 4),
            ):
                scale = D ** -0.5
                out, lse = _flash_fwd_cuda(q, k, v, causal, scale, w, s)
                ref, ref_lse = flash_attention_plain(q, k, v, causal, scale, w, s)
                torch.cuda.synchronize()
                if not (torch.isfinite(out).all() and torch.isfinite(lse).all()):
                    fail(f"non-finite kernel output {dname} {(B, S, H, D)}")
                err = (out.float() - ref.float()).abs()
                lse_err = float((lse - ref_lse).abs().max())
                ok = bool((err <= atol + rtol * ref.float().abs()).all())
                print(f"[kernel] flash_fwd {dname} B={B} S={S} H={H} D={D} "
                      f"causal={causal} window={w} sinks={s} "
                      f"max_abs_err={float(err.max())} lse_err={lse_err} "
                      f"tol=({atol}+{rtol}*|ref|, lse {LSE_TOL})")
                if not ok or lse_err > LSE_TOL:
                    fail(f"flash_fwd disagrees with its plain version "
                         f"({dname}, {(B, S, H, D)}, causal={causal}, "
                         f"window={w}, sinks={s})")
                worst[dname] = max(worst[dname], float(err.max()))
            if dtype == torch.bfloat16 and D == 64 and S in (16, 128, 1024):
                # The serving path's call: causal self-attention, bf16.
                scale = D ** -0.5
                qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
                row = {
                    "S": S,
                    "ms": cuda_ms(
                        lambda: _flash_fwd_cuda(q, k, v, True, scale, 0, 0)
                    ),
                    "plain_ms": cuda_ms(
                        lambda: flash_attention_plain(q, k, v, True, scale)
                    ),
                    "library_ms": cuda_ms(
                        lambda: F.scaled_dot_product_attention(
                            qt, kt, vt, is_causal=True
                        )
                    ),
                }
                row["bound_ms"], row["bound_by"] = flash_bound(q, 0, 0, True)
                print(f"[kernel] flash_fwd timing bf16 causal B={B} S={S} "
                      f"H={H} D={D}: {json.dumps(row)}")
                timed = row
    return worst, timed


def bwd_inputs(B, S, H, D, dtype, gen, causal, window, sinks):
    """q, k, v, dO on the card and the forward's out and lse from K1: the
    inputs K2 and K3 are given on the main path."""
    import torch

    from ray_lightning_tpu_torch.ops.flash_attention import _flash_fwd_cuda

    q, k, v, do = (
        torch.randn((B, S, H, D), generator=gen, device="cuda").to(dtype)
        for _ in range(4)
    )
    out, lse = _flash_fwd_cuda(q, k, v, causal, D ** -0.5, window, sinks)
    return q, k, v, do, out, lse


def training_bwd_inputs(gen):
    """The attention inputs of one GPT-2-small training layer on the card:
    q, k, v from the port's own fused projection (``gpt._project_qkv``),
    so they are the strided (B, S, 3, H, D) views the training path hands
    K1, K2 and K3 (seq stride 3*H*D, batch stride S*3*H*D); a contiguous
    dO; out and lse from K1."""
    import torch

    from ray_lightning_tpu_torch.models import gpt
    from ray_lightning_tpu_torch.ops.flash_attention import _flash_fwd_cuda

    cfg = gpt.GPTConfig.gpt2_small()
    B, S, H, D, dm = 8, cfg.max_seq, cfg.n_head, cfg.head_dim, cfg.d_model
    dt = torch.bfloat16
    a = torch.randn((B, S, dm), generator=gen, device="cuda").to(dt)
    lp = {
        "wqkv": (torch.randn((dm, 3, H, D), generator=gen, device="cuda")
                 * dm ** -0.5).to(dt),
        "bqkv": torch.zeros((3, H, D), device="cuda", dtype=dt),
    }
    with torch.no_grad():
        q, k, v = gpt._project_qkv(a, lp, cfg, dt)
    do = torch.randn((B, S, H, D), generator=gen, device="cuda").to(dt)
    out, lse = _flash_fwd_cuda(q, k, v, True, D ** -0.5, 0, 0)
    return q, k, v, do, out, lse


def check_training_call(fa, q, k, v, do, out, lse, scale):
    """K1's out/lse and K2/K3's dq/dk/dv at the training call against the
    plain versions on the same inputs; fails on a miss."""
    import torch

    B, S, H, D = q.shape
    atol, rtol = TOL["bfloat16"]
    ref, ref_lse = fa.flash_attention_plain(q, k, v, True, scale)
    got = fa._flash_bwd_cuda(q, k, v, out, lse, do, True, scale, 0, 0)
    ref_grads = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, True,
                                             scale)
    torch.cuda.synchronize()
    errs = {"lse": float((lse - ref_lse).abs().max())}
    if not errs["lse"] <= LSE_TOL:
        fail(f"flash_fwd lse disagrees at the training call: {errs['lse']}")
    for name, a, b in zip(("out", "dq", "dk", "dv"), (out,) + got,
                          (ref,) + ref_grads):
        if not torch.isfinite(a).all():
            fail(f"non-finite {name} at the training call")
        err = (a.float() - b.float()).abs()
        errs[name] = float(err.max())
        if not bool((err <= atol + rtol * b.float().abs()).all()):
            fail(f"{name} disagrees with its plain version at the training "
                 f"call (B={B}, S={S}, H={H}, D={D}, bf16, causal, strided "
                 f"q/k/v): max abs err {errs[name]}")
    print(f"[kernel] training call bf16 causal B={B} S={S} H={H} D={D}, q/k/v "
          f"strides {q.stride()}/{k.stride()}/{v.stride()}: max abs err "
          f"{json.dumps(errs)} tol=({atol}+{rtol}*|ref|, lse {LSE_TOL})")


def bwd_bound(q, causal, n_products, out_tensors):
    """(bound_ms, bound_by) of one backward kernel: q, k, v, dO read once,
    lse and delta (fp32) read once, its outputs written once, over the
    memory rate; ``n_products`` products of 2*D FLOPs per visible
    (query, key) pair over the peak rate of the input type."""
    B, S, H, D = q.shape
    pairs = S * (S + 1) // 2 if causal else S * S
    flops = n_products * 2.0 * D * pairs * B * H
    nbytes = (4 + out_tensors) * q.numel() * q.element_size() + 2 * B * H * S * 4
    dtype = str(q.dtype).replace("torch.", "")
    t_ops = flops / PEAK_FLOPS[dtype]
    t_mem = nbytes / MEM_BYTES_PER_S
    return max(t_ops, t_mem) * 1e3, "operations" if t_ops > t_mem else "bytes"


def phase_bwd_kernels():
    """K2 (dK/dV) and K3 (dQ) against ``flash_attention_bwd_plain`` on the
    card over the K1 cases, then timed at the training shape."""
    import importlib

    import torch
    import torch.nn.functional as F

    # The ops package re-exports the function under the module's name.
    fa = importlib.import_module("ray_lightning_tpu_torch.ops.flash_attention")
    shapes = [
        (1, 16, 12, 64), (1, 128, 12, 64), (1, 1024, 12, 64),
        (1, 40, 12, 64), (1, 256, 8, 128),
    ]
    gen = torch.Generator(device="cuda").manual_seed(1)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    n_cases = 0
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).replace("torch.", "")
        atol, rtol = TOL[dname]
        for B, S, H, D in shapes:
            window = max(5, S // 4)
            for causal, w, s in (
                (True, 0, 0), (False, 0, 0), (True, window, 0),
                (True, window, 4),
            ):
                q, k, v, do, out, lse = bwd_inputs(
                    B, S, H, D, dtype, gen, causal, w, s
                )
                scale = D ** -0.5
                got = fa._flash_bwd_cuda(q, k, v, out, lse, do, causal, scale,
                                         w, s)
                ref = fa.flash_attention_bwd_plain(q, k, v, out, lse, do,
                                                   causal, scale, w, s)
                torch.cuda.synchronize()
                errs = []
                for name, a, b in zip(("dq", "dk", "dv"), got, ref):
                    if not torch.isfinite(a).all():
                        fail(f"non-finite {name} {dname} {(B, S, H, D)}")
                    err = (a.float() - b.float()).abs()
                    if not bool((err <= atol + rtol * b.float().abs()).all()):
                        fail(f"flash_bwd {name} disagrees with its plain "
                             f"version ({dname}, {(B, S, H, D)}, causal="
                             f"{causal}, window={w}, sinks={s}): max abs "
                             f"err {float(err.max())}")
                    errs.append(float(err.max()))
                worst[dname] = max(worst[dname], *errs)
                n_cases += 1
                print(f"[kernel] flash_bwd {dname} B={B} S={S} H={H} D={D} "
                      f"causal={causal} window={w} sinks={s} max_abs_err "
                      f"dq={errs[0]} dk={errs[1]} dv={errs[2]} "
                      f"tol=({atol}+{rtol}*|ref|)")
    print(f"[kernel] flash_bwd: {n_cases} cases held against the plain "
          f"version; worst bf16 {worst['bfloat16']}, fp32 {worst['float32']}")

    # The training call: B=8, H=12, S=1024, D=64, bf16, causal, with q/k/v
    # the strided views of the fused projection that gpt_forward gives the
    # kernels. Held against the plain versions first, then timed.
    q, k, v, do, out, lse = training_bwd_inputs(gen)
    B, S, H, D = q.shape
    scale = D ** -0.5
    check_training_call(fa, q, k, v, do, out, lse, scale)
    dq, dk, dv = (
        torch.empty(q.shape, dtype=q.dtype, device=q.device) for _ in range(3)
    )
    args = fa.prepare_bwd(q, k, v, out, lse, do, True, scale, 0, 0)
    qt, kt, vt = (
        x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v)
    )
    sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2)
    plain_ms = cuda_ms(
        lambda: fa.flash_attention_bwd_plain(q, k, v, out, lse, do, True,
                                             scale), iters=5, warmup=1
    )
    library_ms = cuda_ms(
        lambda: torch.autograd.grad(sdpa_out, (qt, kt, vt), dot,
                                    retain_graph=True)
    )
    rows = {}
    for name, fn, n_products, n_out in (
        ("flash_bwd_dkv", lambda: fa.launch_bwd_dkv(args, dk, dv), 4, 2),
        ("flash_bwd_dq", lambda: fa.launch_bwd_dq(args, dq), 3, 1),
    ):
        row = {"ms": cuda_ms(fn), "plain_ms": plain_ms,
               "library_ms": library_ms}
        row["bound_ms"], row["bound_by"] = bwd_bound(q, True, n_products, n_out)
        rows[name] = row
        print(f"[kernel] {name} timing bf16 causal B={B} S={S} H={H} D={D}: "
              f"{json.dumps(row)} (plain_ms and library_ms are the whole "
              f"backward: dq, dk and dv)")
    return worst, rows


def greedy_margin(params, cfg, tokens):
    """Top-2 logit margin of the next token after ``tokens``."""
    import torch

    from ray_lightning_tpu_torch.models import gpt

    with torch.no_grad():
        h, _, _ = gpt.gpt_prefill(
            params, cfg, torch.tensor([tokens], device="cuda")
        )
        norm = gpt._make_norm(cfg)
        h = norm(h[:, -1:], params["lnf_g"], params["lnf_b"])[:, 0]
        logits = gpt._lm_head(h, gpt._head_weight(params, cfg))
    top = torch.topk(logits[0], 2).values
    return float(top[0] - top[1])


def phase_serve():
    import numpy as np
    import torch

    from ray_lightning_tpu_torch.models import gpt
    from ray_lightning_tpu_torch.ops.flash_attention import counters
    from ray_lightning_tpu_torch.serve.engine import DecodeEngine
    from ray_lightning_tpu_torch.serve.scheduler import SamplingParams, Scheduler

    cfg = gpt.GPTConfig.gpt2_small()
    params = gpt.init_gpt_params(
        torch.Generator(device="cuda").manual_seed(0), cfg
    )
    t0 = time.perf_counter()
    engine = DecodeEngine(
        params, cfg, num_slots=8, max_seq=1024, decode_fold=8, device="cuda"
    )
    torch.cuda.synchronize()
    print(f"[serve] engine built in {time.perf_counter() - t0:.3f} s, "
          f"buckets {engine.prefill_buckets}")
    sched = Scheduler(engine)
    rng = np.random.default_rng(0)
    # One prompt per prefill bucket (16 ... 1024), two in the last. The
    # greedy ones have lengths at which the solo gpt_generate's prefill
    # takes the flash kernel too (the shape rule sends other lengths to the
    # reference, whose bf16 probabilities round differently), so solo and
    # engine share their attention arithmetic; the engine still pads them
    # to their bucket. The two sampled ones have unaligned lengths.
    lengths = (5, 24, 40, 96, 200, 384, 768, 896)
    n_new = 32
    sampled = {0, 4}
    reqs = []
    for i, n in enumerate(lengths):
        prompt = rng.integers(0, cfg.vocab_size, n).tolist()
        sp = (
            SamplingParams(max_new_tokens=n_new, temperature=0.8, top_k=50,
                           top_p=0.9, seed=i)
            if i in sampled else SamplingParams(max_new_tokens=n_new)
        )
        reqs.append((f"r{i}", prompt, sp))

    counters.reset()
    t0 = time.perf_counter()
    for rid, prompt, sp in reqs:
        sched.submit(prompt, sp, request_id=rid)
    events = sched.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, ref_calls = counters.launches, counters.reference

    toks = {rid: [] for rid, _, _ in reqs}
    reasons = {}
    for ev in events:
        if ev.token is not None:
            toks[ev.request_id].append(ev.token)
        if ev.done:
            reasons[ev.request_id] = ev.reason
    for rid, _, _ in reqs:
        if reasons.get(rid) != "finished" or len(toks[rid]) != n_new:
            fail(f"{rid}: {reasons.get(rid)} with {len(toks[rid])} tokens")
        if not all(0 <= t < cfg.vocab_size for t in toks[rid]):
            fail(f"{rid}: token out of range")
    if not (torch.isfinite(engine._k).all() and torch.isfinite(engine._v).all()):
        fail("non-finite values in the KV cache")
    admissions = sched.metrics.admitted
    print(f"[serve] {len(reqs)} requests, {admissions} admissions, "
          f"flash launches {launches}, reference-path calls {ref_calls}, "
          f"wall {wall:.3f} s")
    if launches != admissions * cfg.n_layer or ref_calls != 0:
        fail(f"flash launches {launches} != admissions x layers "
             f"{admissions * cfg.n_layer}, or reference calls {ref_calls}")

    near_ties = 0
    for i, (rid, prompt, _) in enumerate(reqs):
        if i in sampled:
            continue
        solo = gpt.gpt_generate(params, cfg, [prompt], n_new, device="cuda")
        solo = solo[0, len(prompt):].tolist()
        if toks[rid] == solo:
            continue
        j = next(j for j, (a, b) in enumerate(zip(toks[rid], solo)) if a != b)
        margin = greedy_margin(params, cfg, prompt + solo[:j])
        print(f"[serve] {rid}: engine and solo differ first at token {j}, "
              f"solo top-2 margin {margin}")
        if margin >= MARGIN:
            fail(f"{rid}: greedy mismatch at token {j} with margin {margin}")
        near_ties += 1
    print(f"[serve] greedy vs solo gpt_generate: {len(lengths) - len(sampled)}"
          f" requests, mismatches at near-ties (margin < {MARGIN}): "
          f"{near_ties}")
    snap = sched.metrics.snapshot()

    # Decode alone: a full batch of short prompts, folds timed on the host
    # clock (each step ends in its token-block read, a device sync).
    for s in range(engine.num_slots):
        engine.admit(rng.integers(0, cfg.vocab_size, 16).tolist(),
                     request_id=f"d{s}", max_new_tokens=4 * 8 + 1)
    engine.step()
    fold_s = []
    while engine.num_active:
        t0 = time.perf_counter()
        n = len(engine.step())
        fold_s.append((time.perf_counter() - t0, n))
    decode = {
        "ms_per_fold": 1e3 * sum(t for t, _ in fold_s) / len(fold_s),
        "tokens_per_s": sum(n for _, n in fold_s) / sum(t for t, _ in fold_s),
        "fold": engine.decode_fold,
        "slots": engine.num_slots,
    }
    serve = {
        "ttft_p50_s": snap["ttft_p50_s"],
        "ttft_max_s": snap["ttft_max_s"],
        "tokens_per_s": snap["tokens_per_sec"],
        "wall_s": wall,
        "decode_only": decode,
        "near_tie_mismatches": near_ties,
    }
    print(f"[serve] {json.dumps(serve)} on {card_line()}")
    return launches


def phase_train(n_steps: int = 20):
    """GPT-2 small at full width and depth through ``Trainer.fit``: bf16
    compute over fp32 master weights, flash attention forward (K1) and
    backward (K2, K3), dense ``lm_loss``, AdamW with warmup. Step times are
    host time between consecutive step ends (each step's loss is read on
    the host, a device sync)."""
    import shutil
    import statistics

    import torch

    from ray_lightning_tpu_torch.models.gpt import GPTLM, GPTConfig
    from ray_lightning_tpu_torch.ops.flash_attention import counters
    from ray_lightning_tpu_torch.trainer import Callback, Trainer
    from ray_lightning_tpu_torch.utils.tree import tree_leaves

    class StepClock(Callback):
        def __init__(self):
            self.ends, self.losses = [], []

        def on_train_batch_end(self, trainer, module, logs, batch_idx):
            self.ends.append(time.perf_counter())
            self.losses.append(logs["loss"])

    cfg = GPTConfig.gpt2_small()
    batch = 8
    # Two batches per epoch: every sequence comes back every other step,
    # so 20 steps lower the loss well clear of its step-to-step noise (on
    # fresh rows of this corpus it hardly moves from ln(V) in 20 steps).
    # Validation (2 batches) and the default checkpoint run every 5
    # epochs.
    module = GPTLM(cfg, batch_size=batch, warmup_steps=2, n_train=2 * batch)
    clock = StepClock()
    root = os.path.join(HERE, "build", "smoke_train")
    shutil.rmtree(root, ignore_errors=True)
    trainer = Trainer(
        max_epochs=n_steps // 2, max_steps=n_steps, limit_val_batches=2,
        check_val_every_n_epoch=5,
        seed=0, log_every_n_steps=1, callbacks=[clock], default_root_dir=root,
    )
    counters.reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer.fit(module)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {
        "flash_fwd": counters.launches,
        "flash_bwd_dkv": counters.bwd_dkv_launches,
        "flash_bwd_dq": counters.bwd_dq_launches,
        "reference": counters.reference,
    }
    shutil.rmtree(root, ignore_errors=True)
    losses = clock.losses
    print(f"[train] {n_steps} steps of GPT-2 small (B={batch}, S="
          f"{cfg.max_seq}, bf16 compute, flash attention) through "
          f"Trainer.fit in {wall:.3f} s; launches {json.dumps(launches)}")
    print(f"[train] losses {losses}")
    if len(losses) != n_steps or trainer.global_step != n_steps:
        fail(f"trained {trainer.global_step} steps, {len(losses)} losses, "
             f"expected {n_steps}")
    if not all(math.isfinite(x) for x in losses):
        fail("non-finite training loss")
    if not losses[-1] < losses[0]:
        fail(f"the loss did not fall: first {losses[0]}, last {losses[-1]}")
    expect = cfg.n_layer * n_steps
    if (launches["flash_bwd_dkv"] != expect
            or launches["flash_bwd_dq"] != expect
            or launches["reference"] != 0):
        fail(f"backward kernel launches {launches} != {expect} each (12 "
             f"layers x {n_steps} steps) with 0 reference-path calls")
    if launches["flash_fwd"] < expect:
        fail(f"flash_fwd launched {launches['flash_fwd']} < {expect} times")
    steps_s = [b - a for a, b in zip(clock.ends, clock.ends[1:])]
    # Steps 4.. (after the first 3); the median steps over the two that
    # also hold an epoch-end validation and checkpoint.
    step_s = statistics.median(steps_s[2:])
    tokens = batch * cfg.max_seq
    n_params = sum(int(x.numel()) for x in tree_leaves(module.params))
    # The JAX package's FLOPs per token (obs/telemetry.py:133): 6N + 12*L*D*S.
    fpt = 6.0 * n_params + 12.0 * cfg.n_layer * cfg.d_model * cfg.max_seq
    train = {
        "steps": n_steps,
        "step_ms_median": step_s * 1e3,
        "step_ms_all": [x * 1e3 for x in steps_s],
        "tokens_per_s": tokens / step_s,
        "mfu": fpt * tokens / step_s / PEAK_FLOPS["bfloat16"],
        "n_params": n_params,
        "loss_first": losses[0],
        "loss_last": losses[-1],
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "val_loss": trainer.callback_metrics.get("val_loss"),
        "wall_s": wall,
    }
    print(f"[train] {json.dumps(train)} on {card_line()}")
    return launches, train


def main() -> None:
    if not os.path.isdir(os.path.join(HERE, "ray_lightning_tpu_torch")):
        fail("the ray_lightning_tpu_torch package is not beside chip_smoke.py")
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this run needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    phase_build()
    worst, timed = phase_kernels()
    bwd_worst, bwd_rows = phase_bwd_kernels()
    serve_launches = phase_serve()
    train_launches, _ = phase_train()
    src = "ray_lightning_tpu_torch/ops/csrc/"
    kernels = [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": src + "flash_fwd.cu",
        "replaces": "ray_lightning_tpu/ops/flash_attention.py:29",
        "launches": serve_launches + train_launches["flash_fwd"],
        "launches_by_path": {"serve": serve_launches,
                             "train": train_launches["flash_fwd"]},
        "max_abs_err": worst["bfloat16"],
        "max_abs_err_fp32": worst["float32"],
        "ms": timed["ms"],
        "plain_ms": timed["plain_ms"],
        "bound_ms": timed["bound_ms"],
        "bound_by": timed["bound_by"],
        "library_ms": timed["library_ms"],
        "shape": [1, timed["S"], 12, 64],
    }]
    for name, line in (("flash_bwd_dkv", 189), ("flash_bwd_dq", 254)):
        row = bwd_rows[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": src + "flash_bwd.cu",
            "replaces": f"ray_lightning_tpu/ops/flash_attention.py:{line}",
            "launches": train_launches[name],
            "max_abs_err": bwd_worst["bfloat16"],
            "max_abs_err_fp32": bwd_worst["float32"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "shape": [8, 1024, 12, 64],
        })
    print(json.dumps({"kernels": kernels}))
    print(f"[card] {card_line()}")
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))


if __name__ == "__main__":
    main()
