"""Where the time of the bf16 backward kernels (K2, K3) goes, on one CUDA card.

    python3 tools/torch_flash_bwd_ablate.py

Builds ``ops/csrc/flash_bwd.cu`` as it stands and variants of it, each with
one piece of the bf16 kernels' work taken out (their outputs are then
wrong: only the time is read), and times K2 (dK/dV) and K3 (dQ) of each at
the training call of ``chip_smoke.py`` (B=8, S=1024, H=12, D=64, bf16,
causal, q/k/v the strided views of the fused projection), with CUDA
events, in turns (every variant, then every variant again):

- ``base``: the source as it stands;
- ``mask_all``: every tile takes the per-element band mask (not only the
  tiles across the band's edge);
- ``no_exp``: p = the exponent's argument instead of its exp2;
- ``no_prefetch``: the next tile's TMA copies are never issued (each
  iteration recomputes on the tile already in shared memory);
- ``no_grad_products``: the dV/dK (K2) and dQ (K3) wgmma products are
  left out.

Prints one JSON line of milliseconds per variant and kernel, and the
card's name and power limit. Fails if a variant's edit no longer applies
to the source.
"""
import ctypes
import importlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

#: variant -> (old, new, expected count) edits of the source.
EDITS = {
    "mask_all": [
        ("dkv_probs<BQ, false>", "dkv_probs<BQ, true>", 1),
        ("dq_dscores<BK, false>", "dq_dscores<BK, true>", 1),
    ],
    "no_exp": [("ok ? fast_exp2(", "ok ? (", 2)],
    "no_prefetch": [
        ("      load_query_tile(qt + 1, buf ^ 1);\n", "", 1),
        ("      load_key_tile(it + 1, buf ^ 1);\n", "", 1),
        ("      if (threadIdx.x == 0) mbar_expect(&full[buf ^ 1], tile_bytes);\n",
         "", 1),
        ("      mbar_expect(&full[buf ^ 1], tile_bytes);\n", "", 1),
        ("mbar_wait(&full[buf], ((qt - start) >> 1) & 1);",
         "if (qt == start) mbar_wait(&full[0], 0);", 1),
        ("mbar_wait(&full[buf], (it >> 1) & 1);",
         "if (it == 0) mbar_wait(&full[0], 0);", 1),
        ("const int buf = (qt - start) & 1;", "const int buf = 0;", 1),
        ("const int buf = it & 1;", "const int buf = 0;", 1),
    ],
    "no_grad_products": [
        ("      wgmma_rs<D>(dv, pa, desc_mn<BQ>(dOb, kq));\n"
         "      wgmma_rs<D>(dk, da, desc_mn<BQ>(Qb, kq));\n",
         "      dv[0] += __uint_as_float(pa[0]);\n"
         "      dk[0] += __uint_as_float(da[0]);\n", 1),
        ("      wgmma_rs<D>(dq, da, desc_mn<BK>(Kb, kk));\n",
         "      dq[0] += __uint_as_float(da[0]);\n", 1),
    ],
}


def variant_sources(src: str, edits: dict = EDITS,
                    stem: str = "flash_bwd") -> dict:
    """The source as it stands (``base``) and one variant per entry of
    ``edits``; exits if an edit no longer applies to ``stem``.cu."""
    out = {"base": src}
    for name, variant_edits in edits.items():
        text = src
        for old, new, count in variant_edits:
            found = text.count(old)
            if found != count:
                sys.exit(f"variant {name}: expected {count} of {old!r} in "
                         f"{stem}.cu, found {found}")
            text = text.replace(old, new)
        out[name] = text
    return out


def build(sources: dict, out_dir: str, stem: str = "flash_bwd") -> dict:
    """One nvcc per variant, all started together; name -> library path."""
    from ray_lightning_tpu_torch.ops import _build

    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        cu = os.path.join(out_dir, f"{stem}_{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        lib = os.path.join(out_dir, f"lib{stem}_{name}.so")
        procs[name] = (lib, subprocess.Popen(
            _build.nvcc_command(cu, lib),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"nvcc failed for variant {name}:\n{log}")
        libs[name] = lib
    return libs


def main():
    import torch

    import chip_smoke

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    fa = importlib.import_module("ray_lightning_tpu_torch.ops.flash_attention")
    src_path = os.path.join(ROOT, "ray_lightning_tpu_torch", "ops", "csrc",
                            "flash_bwd.cu")
    with open(src_path) as f:
        sources = variant_sources(f.read())
    libs = build(sources, os.path.join(ROOT, "build", "ablate"))

    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v, do, out, lse = chip_smoke.training_bwd_inputs(gen)
    args = fa.prepare_bwd(q, k, v, out, lse, do, True, q.shape[-1] ** -0.5,
                          0, 0)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    tail = [i32] * 5 + [ptr, ctypes.c_float] + [i32] * 5 + [ptr]
    calls = {}
    for name, path in libs.items():
        lib = ctypes.CDLL(path)
        lib.rlt_flash_bwd_dkv.argtypes = [ptr] * 8 + tail
        lib.rlt_flash_bwd_dq.argtypes = [ptr] * 7 + tail
        lib.rlt_flash_bwd_dkv.restype = lib.rlt_flash_bwd_dq.restype = i32
        calls[name] = (
            lambda lib=lib: lib.rlt_flash_bwd_dkv(
                *args.ptrs(), dk.data_ptr(), dv.data_ptr(), *args.tail),
            lambda lib=lib: lib.rlt_flash_bwd_dq(
                *args.ptrs(), dq.data_ptr(), *args.tail),
        )
    times = {}
    for _ in range(2):
        for name, (dkv_fn, dq_fn) in calls.items():
            for kernel, fn in (("flash_bwd_dkv", dkv_fn),
                               ("flash_bwd_dq", dq_fn)):
                if fn() != 0:
                    sys.exit(f"{kernel} ({name}) failed to launch")
                times.setdefault(name, {}).setdefault(kernel, []).append(
                    chip_smoke.cuda_ms(fn, iters=50, warmup=5))
    print(json.dumps({"shape": list(q.shape), "ms": times}))
    print(f"[card] {chip_smoke.card_line()}")


if __name__ == "__main__":
    main()
