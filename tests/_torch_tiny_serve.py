"""A tiny GPT of the port for the fleet tests that spawn replicas
(``test_torch_recovery.py``, ``test_torch_remote.py``): its weights made
from a seed with numpy, a checkpoint every replica loads, and the
uninterrupted oracle, the same engine configuration in process serving
one request at a time. Imports no JAX: replica processes never import
it, but the head of ``test_torch_remote.py`` need not either.
"""
import dataclasses
import os

import numpy as np

from ray_lightning_tpu_torch.models import gpt as tgpt
from ray_lightning_tpu_torch.models.weights import params_from_jax
from ray_lightning_tpu_torch.utils.state_stream import (
    state_stream_to_file,
    to_state_stream,
)

CFG = tgpt.GPTConfig(
    vocab_size=97, n_layer=2, n_head=4, n_kv_head=2, d_model=64,
    max_seq=128, attn_impl="reference", compute_dtype="float32",
)


def numpy_params(seed: int = 0):
    rng = np.random.default_rng(seed)
    return {
        k: (
            {n: 0.1 * rng.standard_normal(s).astype(np.float32)
             for n, s in v.items()}
            if isinstance(v, dict)
            else 0.1 * rng.standard_normal(v).astype(np.float32)
        )
        for k, v in tgpt.param_shapes(CFG).items()
    }


def write_ckpt(directory, tree) -> str:
    """The port's checkpoint of ``tree`` (numpy) under ``directory``."""
    path = os.path.join(str(directory), "gpt.ckpt")
    state_stream_to_file(to_state_stream({
        "params": params_from_jax(tree, CFG, "cpu"),
        "gpt_config": dataclasses.asdict(CFG)}), path)
    return path


def jobs(n: int, seed: int, plen: int, new: int, sampled=(3,)):
    """``n`` (prompt, sampling) pairs: greedy, seeded, and at the indices
    of ``sampled`` a seeded sampled rider."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        prompt = rng.integers(0, CFG.vocab_size, size=plen).tolist()
        sampling = {"max_new_tokens": new, "seed": i}
        if i in sampled:
            sampling["temperature"] = 0.8
        out.append((prompt, sampling))
    return out


def baseline(tree, engine_kw, job_list):
    """The uninterrupted oracle: the same engine configuration in process,
    one request at a time."""
    from ray_lightning_tpu_torch.serve.engine import DecodeEngine
    from ray_lightning_tpu_torch.serve.scheduler import (
        SamplingParams,
        Scheduler,
    )

    eng = DecodeEngine(params_from_jax(tree, CFG, "cpu"), CFG,
                       device="cpu", **engine_kw)
    sched = Scheduler(eng)
    out = []
    for prompt, sampling in job_list:
        rid = sched.submit(prompt, SamplingParams(**sampling))
        out.append([e.token for e in sched.run_until_idle()
                    if e.request_id == rid and e.token is not None])
    return out
