"""What the tensor-parallel serving tests run on each rank of their gloo
world (``tests/test_torch_serve_mesh.py``, ``_chunked.py``, ``_spec.py``,
``_fused.py``),
and the engine drivers both packages' engines share in the test process.

A fabric actor imports this module by reference, so it imports neither JAX
nor the JAX package; cases take numpy weights and return numpy arrays and
plain Python. ``join``/``leave`` come from ``tests/_torch_dist_worker.py``.
"""
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


def to_torch(tree: Any, cfg_kwargs: Dict[str, Any]) -> Any:
    """A numpy weight tree (the JAX package's layout) as the port's CPU
    tree, through ``models/weights.py``."""
    from ray_lightning_tpu_torch.models.gpt import GPTConfig
    from ray_lightning_tpu_torch.models.weights import params_from_jax

    return params_from_jax(tree, GPTConfig(**cfg_kwargs), "cpu")


# -- engine drivers (any engine with the DecodeEngine surface) ---------------


def run_workload(eng: Any, reqs: Sequence[Tuple[List[int], int]],
                 join: Optional[Tuple[List[int], int]] = None
                 ) -> Dict[str, List[int]]:
    """Admit ``reqs`` at once, drive to idle with an optional mid-flight
    join (JAX ``tests/test_serve_sharded.py:_run_workload``)."""
    outs: Dict[str, List[int]] = {}
    for i, (p, n) in enumerate(reqs):
        _, tok, done = eng.admit(p, request_id=f"r{i}", max_new_tokens=n)
        outs[f"r{i}"] = [] if tok is None else [tok]
        assert not done
    joined = join is None
    for _ in range(300):
        if not eng.num_active:
            break
        for _, task, tok, _ in eng.prefill_step(1):
            outs[task.request_id].append(tok)
        for _, rid, tok, _ in eng.step():
            outs[rid].append(tok)
        if not joined and eng.free_slots():
            p4, n4 = join
            rid = f"r{len(reqs)}"
            _, tok, _ = eng.admit(p4, request_id=rid, max_new_tokens=n4)
            outs[rid] = [] if tok is None else [tok]
            joined = True
    assert joined and eng.num_active == 0
    return outs


def run_one_by_one(eng: Any, reqs: Sequence[Tuple[List[int], int]]
                   ) -> Dict[str, List[int]]:
    """Admit each request and drive it to idle before the next (JAX
    ``_drive``: chunked prefills interleaved with folds)."""
    outs: Dict[str, List[int]] = {}
    for i, (p, n) in enumerate(reqs):
        outs[f"r{i}"] = []
        eng.admit(p, request_id=f"r{i}", max_new_tokens=n)
        while eng.num_active:
            for _, task, tok, _ in eng.prefill_step(1):
                outs[task.request_id].append(tok)
            for _, rid, tok, _ in eng.step():
                outs[rid].append(tok)
    return outs


def run_scheduler(eng: Any, sched_mod: Any,
                  reqs: Sequence[Tuple[List[int], int]]
                  ) -> Dict[str, List[int]]:
    """``reqs`` through ``sched_mod``'s Scheduler (two prefills per
    step) to idle."""
    sched = sched_mod.Scheduler(eng, max_prefills_per_step=2)
    outs: Dict[str, List[int]] = {}
    for i, (p, n) in enumerate(reqs):
        rid = sched.submit(p, sched_mod.SamplingParams(max_new_tokens=n),
                           request_id=f"m{i}")
        outs[rid] = []
    for ev in sched.run_until_idle():
        if ev.token is not None:
            outs[ev.request_id].append(ev.token)
    assert not sched.has_work() and eng.num_active == 0
    return outs


# -- rank-side cases -----------------------------------------------------------


def engine_case(spec: str, cfg_kwargs: Dict[str, Any], params: Any,
                kw: Dict[str, Any], reqs: List[Tuple[List[int], int]],
                driver: str, join: Optional[Tuple[List[int], int]] = None
                ) -> Dict[str, Any]:
    """This rank's DecodeEngine on the ``spec`` mesh ("MODELxDATA") over
    the joined world, driven by ``driver`` ("workload", "one_by_one" or
    "scheduler"): its tokens and its facts."""
    from ray_lightning_tpu_torch.models.gpt import GPTConfig
    from ray_lightning_tpu_torch.parallel.mesh import mesh_from_spec
    from ray_lightning_tpu_torch.serve import scheduler as sched_mod
    from ray_lightning_tpu_torch.serve.engine import DecodeEngine

    eng = DecodeEngine(to_torch(params, cfg_kwargs), GPTConfig(**cfg_kwargs),
                       mesh=mesh_from_spec(spec), device="cpu", **kw)
    compiled = eng.compiled_count
    if driver == "scheduler":
        toks = run_scheduler(eng, sched_mod, reqs)
    elif driver == "workload":
        toks = run_workload(eng, list(reqs), join)
    else:
        toks = run_one_by_one(eng, reqs)
    return {
        "tokens": toks,
        "compiled": (compiled, eng.compiled_count),
        "graphed": eng.graphed,
        "mesh": eng.mesh_desc,
        "hit_tokens": (eng.prefix_stats()["hit_tokens"]
                       if eng.prefix_blocks else 0),
        "verifies": eng.spec_stats()["verifies"] if eng.spec != "off" else 0,
        "piggyback_rows": eng.piggyback_chunk_rows,
        "device_state": eng.device_state(),
    }


def memory_case(spec: str, cfg_kwargs: Dict[str, Any], params: Any,
                kw: Dict[str, Any]) -> Dict[str, Any]:
    """This rank's ``memory_stats`` and the ``rlt_serve_hbm_bytes`` gauges
    a fresh registry takes from them."""
    from ray_lightning_tpu_torch.models.gpt import GPTConfig
    from ray_lightning_tpu_torch.obs.registry import MetricsRegistry
    from ray_lightning_tpu_torch.parallel.mesh import mesh_from_spec
    from ray_lightning_tpu_torch.serve.engine import DecodeEngine
    from ray_lightning_tpu_torch.serve.metrics import ServeMetrics

    eng = DecodeEngine(to_torch(params, cfg_kwargs), GPTConfig(**cfg_kwargs),
                       mesh=mesh_from_spec(spec), device="cpu", **kw)
    mem = eng.memory_stats()
    reg = MetricsRegistry()
    ServeMetrics(eng.num_slots, registry=reg).record_memory(mem)
    return {"memory": mem, "text": reg.render(),
            "gauges": {k: v for k, v in reg.to_dict().items()
                       if k.startswith("rlt_serve_hbm_bytes")}}


def mesh_error(spec: str) -> str:
    """``mesh_from_spec``'s message for a spec the world does not
    factor."""
    from ray_lightning_tpu_torch.parallel.mesh import mesh_from_spec

    try:
        mesh_from_spec(spec)
    except ValueError as exc:
        return str(exc)
    return ""


def model_case(spec: Optional[str], cfg_kwargs: Dict[str, Any],
               params: Any, seed: int = 0) -> Dict[str, np.ndarray]:
    """The serving functions on this rank's slices of ``params`` over the
    ``spec`` mesh (None: whole weights, no mesh): a chunked prefill of a
    prompt in two chunks, a decode step, a verify of three candidate rows,
    and the same step and verify through a paged cache. Returns their
    fp32 logits and the prefill's hidden states."""
    from ray_lightning_tpu_torch.models import gpt
    from ray_lightning_tpu_torch.parallel.mesh import mesh_from_spec

    cfg = gpt.GPTConfig(**cfg_kwargs)
    mesh = mesh_from_spec(spec) if spec else None
    p = gpt.cast_params(
        gpt.gpt_param_slices(to_torch(params, cfg_kwargs), cfg, mesh), cfg)
    rng = np.random.default_rng(seed)
    B, S, P = 3, 32, 11
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, P)))
    hkv = gpt._local_kv_heads(p, cfg)
    shape = (cfg.n_layer, B, S, hkv, cfg.head_dim)
    k, v = torch.zeros(shape), torch.zeros(shape)
    out: Dict[str, np.ndarray] = {}
    with torch.no_grad():
        h1, k, v = gpt.gpt_prefill_chunk(p, cfg, prompt[:, :8], k, v, 0,
                                         mesh=mesh)
        h2, k, v = gpt.gpt_prefill_chunk(p, cfg, prompt[:, 8:], k, v, 8,
                                         mesh=mesh)
        out["prefill_h"] = torch.cat([h1, h2], 1).numpy()
        pos = torch.full((B,), P, dtype=torch.long)
        cur = torch.as_tensor(rng.integers(0, cfg.vocab_size, B))
        kd, vd = k.clone(), v.clone()
        out["step"], kd, vd = gpt.gpt_decode_step(p, cfg, cur, pos, kd, vd,
                                                  mesh=mesh)
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, 3)))
        out["verify"], _, _ = gpt.gpt_decode_verify(
            p, cfg, toks, pos, k.clone(), v.clone(), mesh=mesh)
        page = 8
        table = torch.arange(1, 1 + B * (S // page)).reshape(B, S // page)
        pool_shape = (cfg.n_layer, 1 + B * (S // page), page, hkv,
                      cfg.head_dim)
        pk, pv = torch.zeros(pool_shape), torch.zeros(pool_shape)
        pk[:, 1:] = k.reshape(cfg.n_layer, B * (S // page), page, hkv,
                              cfg.head_dim)
        pv[:, 1:] = v.reshape(cfg.n_layer, B * (S // page), page, hkv,
                              cfg.head_dim)
        out["step_paged"], _, _ = gpt.gpt_decode_step_paged(
            p, cfg, cur, pos, pk.clone(), pv.clone(), table, page, mesh=mesh)
        out["verify_paged"], _, _ = gpt.gpt_decode_verify_paged(
            p, cfg, toks, pos, pk, pv, table, page, mesh=mesh)
    return {k: np.asarray(t) for k, t in out.items()}
