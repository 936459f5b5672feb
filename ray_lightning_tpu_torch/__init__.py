"""ray_lightning_tpu_torch — the PyTorch/CUDA port of ray_lightning_tpu.

A second package beside the JAX one, which stays the reference. This slice
ports the serving path: GPT prefill and cached decode (``models/gpt.py``),
the weight bridge from the JAX parameter tree (``models/weights.py``), the
slot decode engine and scheduler core (``serve/``), and a hand-written
Hopper flash-attention forward kernel (``ops/``). It imports ``torch``,
never ``jax``, and nothing of ``ray_lightning_tpu``.
"""
__version__ = "0.1.0"

_LAZY = {
    "GPTConfig": "ray_lightning_tpu_torch.models.gpt",
    "init_gpt_params": "ray_lightning_tpu_torch.models.gpt",
    "gpt_generate": "ray_lightning_tpu_torch.models.gpt",
    "params_from_jax": "ray_lightning_tpu_torch.models.weights",
    "DecodeEngine": "ray_lightning_tpu_torch.serve.engine",
    "Scheduler": "ray_lightning_tpu_torch.serve.scheduler",
    "SamplingParams": "ray_lightning_tpu_torch.serve.scheduler",
    "ServeMetrics": "ray_lightning_tpu_torch.serve.metrics",
    "flash_attention": "ray_lightning_tpu_torch.ops.flash_attention",
}


def __getattr__(name):
    # Lazy exports keep `import ray_lightning_tpu_torch` light (no torch
    # import until a name is used).
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(
        f"module 'ray_lightning_tpu_torch' has no attribute {name!r}"
    )


__all__ = list(_LAZY)
