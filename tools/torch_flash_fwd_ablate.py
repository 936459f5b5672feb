"""Where the time of the bf16 flash-attention forward kernel (K1) goes, on one CUDA card.

    python3 tools/torch_flash_fwd_ablate.py [--baseline OTHER_flash_fwd.cu]

Builds ``ops/csrc/flash_fwd.cu`` as it stands and variants of it, each with
one piece of the bf16 kernel's work taken out (their outputs are then
wrong: only the time is read), and times K1 of each at the training call
of ``chip_smoke.py`` (B=8, S=1024, H=12, D=64, bf16, causal, q/k/v the
strided views of the fused projection) and at the serving calls (B=1,
S=16, 128 and 1024, H=12, D=64, causal), with ``chip_smoke.cuda_ms``, in
turns (every variant, then every variant again):

- ``base``: the source as it stands;
- ``mask_all``: every tile takes the per-element band mask (not only the
  tiles across the band's edge);
- ``no_exp``: p = the exponent's argument instead of its exp2;
- ``no_softmax``: no online softmax at all (the scores go to P V as they
  are, O is never rescaled);
- ``no_prefetch``: the next tile's TMA copies are never issued (each
  iteration computes on the tile already in shared memory);
- ``no_scores``: the S = Q K^T product is left out (the softmax runs on
  zeros);
- ``no_pv``: the O += P V product is left out;
- ``baseline``, with ``--baseline``: another ``flash_fwd.cu`` with the same
  C entry point (an earlier commit's, say), timed as it stands.

Prints one JSON line of milliseconds per variant and call, and the card's
name and power limit. Fails if a variant's edit no longer applies to the
source.
"""
import ctypes
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

#: variant -> (old, new, expected count) edits of the source.
EDITS = {
    "mask_all": [("online_softmax<false>(", "online_softmax<true>(", 1)],
    "no_exp": [(": fast_exp2(fmaf(x, scale_log2, -m_new[half]));",
                ": fmaf(x, scale_log2, -m_new[half]);", 1)],
    "no_softmax": [
        ("  if (tile_visible(p, q0, ROWS, c0, BK)) {\n"
         "    online_softmax<false>(p, s, m2, l, alpha, q0 + 16 * w, c0, "
         "lane);\n"
         "  } else {\n"
         "    online_softmax<true>(p, s, m2, l, alpha, q0 + 16 * w, c0, "
         "lane);\n"
         "  }\n",
         "  alpha[0] = alpha[1] = 1.f;\n", 1),
    ],
    "no_prefetch": [
        ("      mbar_expect(&full[buf ^ 1], tile_bytes);\n"
         "      load_key_tile(it + 1, buf ^ 1);\n", "", 1),
        ("mbar_wait(&full[buf], (it >> 1) & 1);",
         "if (it == 0) mbar_wait(&full[0], 0);", 1),
        ("const int buf = it & 1;", "const int buf = 0;", 1),
    ],
    "no_scores": [
        ("    wgmma_ss<BK>(s, desc_k<ROWS>(Qs, ks), desc_k<BK>(Kb, ks));\n",
         "", 1),
    ],
    "no_pv": [
        ("    wgmma_rs<D>(o, pa[kk], desc_mn<BK>(Vb, kk));\n",
         "    o[kk] += __uint_as_float(pa[kk][0]);\n", 1),
    ],
}


def main():
    import torch

    import chip_smoke
    from torch_flash_bwd_ablate import build, variant_sources

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    src_path = os.path.join(ROOT, "ray_lightning_tpu_torch", "ops", "csrc",
                            "flash_fwd.cu")
    with open(src_path) as f:
        sources = variant_sources(f.read(), EDITS, "flash_fwd")
    if "--baseline" in sys.argv:
        with open(sys.argv[sys.argv.index("--baseline") + 1]) as f:
            sources["baseline"] = f.read()
    libs = build(sources, os.path.join(ROOT, "build", "ablate"), "flash_fwd")

    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v, _, _, _ = chip_smoke.training_bwd_inputs(gen)
    B, S, H, D = q.shape
    serve = {
        f"serve_s{n}": [torch.randn((1, n, H, D), generator=gen, device="cuda")
                        .to(torch.bfloat16) for _ in range(3)]
        for n in (16, 128, S)
    }
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    calls = {}
    for name, path in libs.items():
        fn = ctypes.CDLL(path).rlt_flash_fwd
        # As ops/flash_attention.py:_kernel binds it.
        fn.argtypes = ([ptr] * 5 + [i32] * 5 + [i64] * 9
                       + [ctypes.c_float, i32, i32, i32, i32, i32, ptr])
        fn.restype = i32
        for call, (qq, kk, vv) in (("train", (q, k, v)), *serve.items()):
            n = qq.shape[1]
            out = torch.empty(qq.shape, dtype=qq.dtype, device="cuda")
            lse = torch.empty((qq.shape[0], H, n), dtype=torch.float32,
                              device="cuda")
            args = (qq.data_ptr(), kk.data_ptr(), vv.data_ptr(),
                    out.data_ptr(), lse.data_ptr(), qq.shape[0], H, n, n, D,
                    *qq.stride()[:3], *kk.stride()[:3], *vv.stride()[:3],
                    D ** -0.5, 1, 0, 0, 1, 0,
                    torch.cuda.current_stream().cuda_stream)
            calls.setdefault(name, {})[call] = (
                lambda fn=fn, args=args, out=out, lse=lse: fn(*args))
    times = {}
    for _ in range(2):
        for name, by_call in calls.items():
            for call, fn in by_call.items():
                if fn() != 0:
                    sys.exit(f"flash_fwd ({name}) failed to launch")
                times.setdefault(name, {}).setdefault(call, []).append(
                    chip_smoke.cuda_ms(fn, iters=50, warmup=5))
    print(json.dumps({"train_shape": list(q.shape), "ms": times}))
    print(f"[card] {chip_smoke.card_line()}")


if __name__ == "__main__":
    main()
