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


# -- a split gang's KV plane and store ---------------------------------------


def _duo(cfg_kwargs: Dict[str, Any], params: Any, kw: Dict[str, Any],
         specs: Sequence[Optional[str]], layerwise: bool = False) -> Any:
    """Two engines of this rank (each on its ``specs`` mesh, or unsplit)
    with schedulers joined by fleet KV planes over plain queues."""
    import queue
    import types

    from ray_lightning_tpu_torch.models.gpt import GPTConfig
    from ray_lightning_tpu_torch.parallel.mesh import mesh_from_spec
    from ray_lightning_tpu_torch.serve import kvfleet
    from ray_lightning_tpu_torch.serve import scheduler as sched_mod
    from ray_lightning_tpu_torch.serve.engine import DecodeEngine

    tree = to_torch(params, cfg_kwargs)
    cfg = GPTConfig(**cfg_kwargs)
    inboxes = {0: queue.Queue(), 1: queue.Queue()}
    engines = [DecodeEngine(tree, cfg, mesh=mesh_from_spec(spec),
                            device="cpu", **kw) for spec in specs]
    planes = [kvfleet.KVFleetPlane(
        index=i, inbox=inboxes[i], peers=dict(inboxes),
        block_bytes=e.prefix_block_nbytes, timeout_s=5.0, min_poll_s=0.0,
        layerwise_ship=layerwise) for i, e in enumerate(engines)]
    scheds = [sched_mod.Scheduler(e, kvfleet=p)
              for e, p in zip(engines, planes)]
    return types.SimpleNamespace(engines=engines, planes=planes,
                                 scheds=scheds, sched_mod=sched_mod)


def _drive(scheds: Sequence[Any], max_steps: int = 400) -> List[List[Any]]:
    events: List[List[Any]] = [[] for _ in scheds]
    for _ in range(max_steps):
        busy = False
        for i, s in enumerate(scheds):
            busy = busy or s.has_work()
            events[i].extend(s.step())
        if not busy:
            break
    return events


def _tokens(events: Sequence[Any], rid: str) -> List[int]:
    return [e.token for e in events if e.request_id == rid
            and e.token is not None]


def gang_disagg_case(cfg_kwargs: Dict[str, Any], params: Any,
                     kw: Dict[str, Any], specs: Sequence[Optional[str]],
                     prompt: List[int], n: int,
                     layerwise: bool) -> Dict[str, Any]:
    """Engine 0 prefills ``prompt`` and ships its blocks to engine 1 (the
    JAX ``tests/test_kvfleet.py:498,1219`` scenario); the resubmission on
    engine 1 decodes. Returns both streams, the terminals and the
    planes' and engines' transfer counters."""
    duo = _duo(cfg_kwargs, params, kw, specs, layerwise)
    sp = duo.sched_mod.SamplingParams(max_new_tokens=n, seed=0)
    duo.scheds[0].submit(prompt, sp, request_id="r", ship_to=1)
    ev_a, _ = _drive(duo.scheds)
    duo.scheds[1].submit(prompt, sp, request_id="r")
    _, ev_b = _drive(duo.scheds)
    a, b = duo.engines
    pa, pb = (p.stats() for p in duo.planes)
    return {
        "done": [(e.reason, e.ship_to) for e in ev_a if e.done],
        "first": _tokens(ev_a, "r"), "full": _tokens(ev_b, "r"),
        "ships": pa["ships"], "layer_ships": pa["layer_ships"],
        "layer_ship_messages": pa["layer_ship_messages"],
        "ship_bytes": pa["ship_bytes"],
        "exports": a.prefix_handoff_exports,
        "imports": b.prefix_handoff_imports,
        "layer_block_imports": b.layer_block_imports,
        "hit_tokens": b.prefix_hit_tokens,
        "gather_bytes": (a.kv_gather_bytes, b.kv_gather_bytes),
        "split": (a.heads_split, b.heads_split),
        "compiled": [e.compiled_count for e in duo.engines],
    }


def gang_store_case(cfg_kwargs: Dict[str, Any], params: Any,
                    kw: Dict[str, Any], spec: str, prompts: List[List[int]],
                    n: int, store_dir: str) -> Dict[str, Any]:
    """A round trip through the KV object store between a split engine
    and an unsplit one. The split engine (``kvstore_dir``, a pool of few
    blocks and a host tier too small for one) serves ``prompts[0]``, then ``prompts[1]``,
    whose blocks push the first chain out of the pool into the store:
    the eviction gathers every rank's heads and the gang's first rank
    writes whole blocks. An unsplit engine reads that chain from the
    store, imports it and serves the prompt warm. Then the unsplit engine
    writes ``prompts[2]``'s exported chain (as a leader's write-through
    does) and the split engine reads, imports (each rank its heads) and
    serves it warm. Returns each engine's streams, hits and the stored
    and read block counts."""
    import torch.distributed as dist

    from ray_lightning_tpu_torch.models.gpt import GPTConfig
    from ray_lightning_tpu_torch.parallel.mesh import mesh_from_spec
    from ray_lightning_tpu_torch.serve.engine import DecodeEngine
    from ray_lightning_tpu_torch.serve.kvstore import FleetKVStore
    from ray_lightning_tpu_torch.serve.router import prompt_block_digests

    tree = to_torch(params, cfg_kwargs)
    cfg = GPTConfig(**cfg_kwargs)
    split = DecodeEngine(tree, cfg, mesh=mesh_from_spec(spec), device="cpu",
                         kvstore_dir=store_dir, **kw)
    whole = DecodeEngine(tree, cfg, device="cpu", **kw)
    store = FleetKVStore(store_dir, namespace=split.kvstore_namespace)
    block = split.prefix_block
    p0, p1, p2 = prompts
    out: Dict[str, Any] = {"writer": split.kvstore is not None}
    out["split_cold"] = run_one_by_one(split, [(p0, n), (p1, n)])
    dist.barrier()
    digs = [d.hex() for d in prompt_block_digests(p0, block)]
    blocks, _ = store.get_chain(digs)
    out["stored"] = len(blocks)
    out["imported_whole"] = whole.import_prefix_blocks(blocks)
    out["whole_warm"] = run_one_by_one(whole, [(p0, n)])
    out["whole_hits"] = whole.prefix_hit_tokens
    # The unsplit engine's chain of a prompt it served, written through.
    run_one_by_one(whole, [(p2, n)])
    exported = whole.export_prefix_blocks(p2)
    if dist.get_rank() == 0:
        store.put_blocks(exported)
    dist.barrier()
    digs2 = [d.hex() for d in prompt_block_digests(p2, block)]
    blocks2, _ = store.get_chain(digs2)
    hits0 = split.prefix_hit_tokens
    out["imported_split"] = split.import_prefix_blocks(blocks2)
    out["split_warm"] = run_one_by_one(split, [(p2, n)])
    out["split_hits"] = split.prefix_hit_tokens - hits0
    out["gather_bytes"] = split.kv_gather_bytes
    # A split engine's export of the imported chain is the unsplit
    # engine's, bitwise.
    again = split.export_prefix_blocks(p2)
    out["export_bitwise"] = (
        [h for h, _, _ in again] == [h for h, _, _ in exported]
        and all(torch.equal(a, b) for (_, ka, va), (_, kb, vb)
                in zip(again, exported) for a, b in ((ka, kb), (va, vb))))
    return out
