"""Engine construction for serving (PyTorch port of the build functions of
``ray_lightning_tpu/serve/server.py``).

``build_engine`` is the entry point a replica (and a journal replay)
builds its engine through: it loads the weights (a checkpoint the port's
``Trainer`` wrote, or explicit params), optionally quantizes them to
weight-only int8 (``int8=True``; ``spec_draft_int8`` for the draft
model), and constructs the :class:`DecodeEngine`. The serving replica
itself (``ServeReplica``) is ROADMAP queue 1 item 10.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

from ray_lightning_tpu_torch.models.gpt import GPTConfig, params_to
from ray_lightning_tpu_torch.utils.device import resolve_device
from ray_lightning_tpu_torch.utils.quantize import quantize_params_int8
from ray_lightning_tpu_torch.utils.state_stream import load_state_stream


def load_serve_params(
    ckpt_path: str, model_config: Optional[Dict[str, Any]] = None
) -> Tuple[Dict[str, Any], GPTConfig]:
    """Load (params, GPTConfig) for serving from a checkpoint file: a state
    stream holding ``{"params", "gpt_config"}`` (``model_config`` entries
    override the stored config) or a trainer checkpoint ``{"params": ...}``
    (plus optimizer state, ignored), which needs ``model_config``. Tensors
    land on the CPU; the engine moves them."""
    overrides = dict(model_config or {})
    with open(ckpt_path, "rb") as f:
        tree = load_state_stream(f.read())
    stored = dict(tree.get("gpt_config") or {})
    if stored:
        stored.update(overrides)
        cfg_fields = stored
    elif overrides:
        cfg_fields = overrides
    else:
        raise ValueError(
            f"checkpoint {ckpt_path} carries no gpt_config; pass the model "
            "config (model_config)"
        )
    params = tree["params"] if "params" in tree else tree
    return params, GPTConfig(**cfg_fields)


#: Engine-facing construction kwargs (the JAX package's set): what a
#: journal header's engine section and a replica's config carry into
#: :func:`build_engine`.
ENGINE_KEYS = frozenset((
    "ckpt_path", "model_config", "params", "int8", "num_slots", "max_seq",
    "prefill_buckets", "decode_fold", "pipeline", "prefill_chunk",
    "prefix_blocks", "prefix_block", "prefix_host_mb", "prefix_disk_dir",
    "prefix_disk_mb", "kv_page", "kv_pages", "spec", "spec_depth",
    "spec_draft_ckpt", "spec_draft_config", "spec_draft_int8",
    "spec_window", "mesh", "piggyback_chunks", "fold_ladder",
))


def build_engine(
    ckpt_path: Optional[str] = None,
    model_config: Optional[Dict[str, Any]] = None,
    params: Any = None,
    int8: bool = False,
    num_slots: int = 4,
    max_seq: Optional[int] = None,
    prefill_buckets: Optional[Sequence[int]] = None,
    decode_fold: int = 1,
    pipeline: bool = True,
    prefill_chunk: int = 0,
    prefix_blocks: int = 0,
    prefix_block: int = 16,
    prefix_host_mb: float = 0.0,
    prefix_disk_dir: Optional[str] = None,
    prefix_disk_mb: float = 0.0,
    kvstore_dir: Optional[str] = None,
    kvstore_mb: float = 0.0,
    kvstore_namespace: Optional[str] = None,
    kv_page: int = 0,
    kv_pages: int = 0,
    spec: str = "off",
    spec_depth: int = 4,
    spec_draft_ckpt: Optional[str] = None,
    spec_draft_config: Optional[Dict[str, Any]] = None,
    spec_draft_int8: bool = False,
    spec_window: int = 32,
    mesh: Optional[str] = None,
    piggyback_chunks: int = 0,
    fold_ladder: Optional[Sequence[int]] = None,
    device: Any = "cuda",
) -> Any:
    """Load weights (and the draft model for ``spec="model"``) and
    construct the engine on ``device`` (the card unless ``"cpu"`` is
    passed). ``int8`` quantizes the weights at load
    (``utils/quantize.py:quantize_params_int8``, on the device), and
    ``spec_draft_int8`` the draft's. ``mesh`` other than None or ``"1x1"``
    raises (ROADMAP queue 1 item 11), and so does the KV object store
    (``kvstore_dir``, ``kvstore_mb``, ``kvstore_namespace``: item 9)."""
    from ray_lightning_tpu_torch.serve.engine import DecodeEngine

    device = resolve_device(device)
    if mesh not in (None, "1x1"):
        raise NotImplementedError(
            f"build_engine mesh={mesh!r} is not ported yet (ROADMAP queue 1 "
            "item 11, mesh serving); serve on one card (mesh None or '1x1')"
        )
    if params is None:
        if ckpt_path is None:
            raise ValueError("need ckpt_path or params")
        params, cfg = load_serve_params(ckpt_path, model_config)
    else:
        if model_config is None:
            raise ValueError("explicit params need model_config")
        cfg = (
            model_config
            if isinstance(model_config, GPTConfig)
            else GPTConfig(**model_config)
        )
    if int8:
        params = quantize_params_int8(params_to(params, device))
    spec_params = None
    spec_cfg = None
    if spec == "model":
        if spec_draft_ckpt is None:
            raise ValueError(
                "spec='model' needs spec_draft_ckpt (the draft model's "
                "checkpoint)"
            )
        spec_params, spec_cfg = load_serve_params(
            spec_draft_ckpt, spec_draft_config
        )
        if spec_draft_int8:
            spec_params = quantize_params_int8(params_to(spec_params, device))
    return DecodeEngine(
        params,
        cfg,
        num_slots=num_slots,
        max_seq=max_seq,
        prefill_buckets=prefill_buckets,
        decode_fold=decode_fold,
        pipeline=pipeline,
        prefill_chunk=prefill_chunk,
        prefix_blocks=prefix_blocks,
        prefix_block=prefix_block,
        prefix_host_mb=prefix_host_mb,
        prefix_disk_dir=prefix_disk_dir,
        prefix_disk_mb=prefix_disk_mb,
        kvstore_dir=kvstore_dir,
        kvstore_mb=kvstore_mb,
        kvstore_namespace=kvstore_namespace,
        kv_page=kv_page,
        kv_pages=kv_pages,
        spec=spec,
        spec_depth=spec_depth,
        spec_params=spec_params,
        spec_config=spec_cfg,
        spec_window=spec_window,
        piggyback_chunks=piggyback_chunks,
        fold_ladder=fold_ladder,
        device=device,
    )
