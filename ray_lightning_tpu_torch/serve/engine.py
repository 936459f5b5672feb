"""Slot-based continuous-batching decode engine (PyTorch port, plain path).

Port of ``ray_lightning_tpu/serve/engine.py``'s plain configuration: a
fixed ``(L, num_slots, max_seq, Hkv, hd)`` KV cache; requests are admitted
into free slots between folds (one fused admission each: bucketed prefill,
cache write, first-token sample, slot-state write); each :meth:`step` runs
one fold of ``decode_fold`` decode iterations with per-slot EOS and budget
freezing on the device (``models/gpt.py:gpt_decode_fold``) and reads the
``(fold, num_slots)`` token block back once.

Exactness: a greedy request decodes the same tokens as a solo
``gpt_generate``, whatever its batchmates, because the decode step masks
each slot to ``position <= pos[slot]`` with exact ``-inf`` masking and the
bucketed prefill's padded rows never reach a real row (causal attention).
On the CPU, under ``attn_impl="reference"`` and fp32, this holds token for
token. On the card it holds too for a prompt whose length the flash kernel
takes: the default buckets leave such a prompt unpadded, and the decode
step rounds a slot's row the same whatever the batch and the cache length
(``models/gpt.py:DECODE_ROWS``).

What the JAX engine also offers and this port does not yet (each raises
``NotImplementedError`` naming its ROADMAP item): chunked prefill and the
prefix cache with its spill tiers, paged KV, the KV object store,
speculative decoding, piggybacked prefill chunks, a fold ladder, a device
mesh, and the double-buffered ``pipeline=True`` dispatch. The JAX
engine's compile-count contract has no eager counterpart.

All methods must be driven from one thread (the scheduler loop).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ray_lightning_tpu_torch.models.gpt import (
    GPTConfig,
    _head_weight,
    _lm_head,
    _make_norm,
    cast_params,
    compute_dtype,
    gpt_decode_fold,
    gpt_prefill,
    params_to,
    sample_logits_batched,
)
from ray_lightning_tpu_torch.ops.flash_attention import takes_reference_path
from ray_lightning_tpu_torch.utils.device import resolve_device

#: Constructor options of the JAX engine that the port does not run yet:
#: name -> (the JAX default, which the port accepts, and the ROADMAP item).
_UNPORTED: Dict[str, Tuple[Any, str]] = {
    "fold_ladder": (None, "queue 1 item 6 (fold ladder)"),
    "piggyback_chunks": (0, "queue 1 item 6 (piggyback)"),
    "prefill_chunk": (0, "queue 1 item 3 (chunked prefill)"),
    "prefix_blocks": (0, "queue 1 item 3 (prefix cache)"),
    "prefix_block": (16, "queue 1 item 3 (prefix cache)"),
    "prefix_host_mb": (0.0, "queue 1 item 3 (prefix cache tiers)"),
    "prefix_disk_dir": (None, "queue 1 item 3 (prefix cache tiers)"),
    "prefix_disk_mb": (0.0, "queue 1 item 3 (prefix cache tiers)"),
    "kvstore_dir": (None, "queue 1 item 9 (KV object store)"),
    "kvstore_mb": (0.0, "queue 1 item 9 (KV object store)"),
    "kvstore_namespace": (None, "queue 1 item 9 (KV object store)"),
    "kv_page": (0, "queue 1 item 4 (paged KV)"),
    "kv_pages": (0, "queue 1 item 4 (paged KV)"),
    "spec": ("off", "queue 1 item 5 (speculative decoding)"),
    "spec_depth": (4, "queue 1 item 5 (speculative decoding)"),
    "spec_params": (None, "queue 1 item 5 (speculative decoding)"),
    "spec_config": (None, "queue 1 item 5 (speculative decoding)"),
    "spec_window": (32, "queue 1 item 5 (speculative decoding)"),
    "mesh": (None, "queue 1 item 11 (mesh serving)"),
}


@dataclasses.dataclass
class SlotInfo:
    """Host-side record of one occupied slot."""

    request_id: str
    max_new_tokens: int
    n_generated: int
    eos_token: int  # -1 = disabled


def default_buckets(max_seq: int) -> Tuple[int, ...]:
    """Prefill lengths up to ``max_seq``: each length the flash kernel's
    shape rule takes (``takes_reference_path``: multiples of 8 up to 128,
    then of 128) and ``max_seq`` itself.

    A prompt is padded to the next of these, so one whose length the kernel
    takes is not padded at all and its prefill is the solo
    ``gpt_generate``'s, shapes included: on the card a GEMM over more rows
    may round differently. The JAX engine's power-of-two buckets bound its
    compiles; eager PyTorch compiles nothing.
    """
    out = [
        n for n in range(8, max_seq + 1, 8)
        if not takes_reference_path(n, n, causal=True)
    ]
    return tuple(sorted(set(out + [max_seq])))


class DecodeEngine:
    """Continuous-batching decode over a fixed slot-indexed KV cache.

    The caches and every per-slot scalar (current token, position,
    sampling knobs, active/remaining/eos) live on ``device`` and are
    updated there; the host keeps request bookkeeping (``SlotInfo``) and
    each sampling slot's ``torch.Generator``. :meth:`device_state` is the
    explicit sync point that copies the slot state to the host.
    """

    def __init__(
        self,
        params: Dict[str, Any],
        config: GPTConfig | Dict[str, Any],
        num_slots: int = 4,
        max_seq: Optional[int] = None,
        prefill_buckets: Optional[Sequence[int]] = None,
        decode_fold: int = 1,
        pipeline: bool = False,
        device: Any = "cuda",
        **options: Any,
    ) -> None:
        for name, value in options.items():
            if name not in _UNPORTED:
                raise TypeError(
                    f"DecodeEngine got an unexpected keyword argument {name!r}"
                )
            default, item = _UNPORTED[name]
            if value != default and not (name == "fold_ladder" and not value):
                raise NotImplementedError(
                    f"DecodeEngine option {name}={value!r} is not ported yet "
                    f"(ROADMAP {item})"
                )
        if pipeline:
            raise NotImplementedError(
                "DecodeEngine(pipeline=True), the double-buffered dispatch, "
                "is not ported yet (ROADMAP queue 1 item 7)"
            )
        if isinstance(config, dict):
            config = GPTConfig(**config)
        config.validate_variants()
        self.cfg = config
        self.device = resolve_device(device)
        self.num_slots = int(num_slots)
        if self.num_slots < 1:
            raise ValueError("num_slots must be >= 1")
        self.decode_fold = int(decode_fold)
        if self.decode_fold < 1:
            raise ValueError("decode_fold must be >= 1")
        self.max_seq = int(max_seq or config.max_seq)
        if self.max_seq > config.max_seq:
            raise ValueError(
                f"engine max_seq {self.max_seq} exceeds model max_seq "
                f"{config.max_seq}"
            )
        buckets = tuple(
            sorted(set(prefill_buckets or default_buckets(self.max_seq)))
        )
        if not buckets or buckets[-1] > self.max_seq:
            raise ValueError(
                f"prefill buckets {buckets} must be non-empty and <= "
                f"max_seq {self.max_seq}"
            )
        self.prefill_buckets = buckets
        # The compute-dtype copy of the weights, made once here (see
        # models/gpt.py:cast_params): the JAX engine casts inside its
        # compiled step, where XLA fuses the cast into the matmul.
        self.params = cast_params(params_to(params, self.device), config)

        cdt = compute_dtype(config)
        L, Hkv, hd = config.n_layer, config.kv_head, config.head_dim
        B, S = self.num_slots, self.max_seq
        dev = self.device
        self._k = torch.zeros((L, B, S, Hkv, hd), dtype=cdt, device=dev)
        self._v = torch.zeros_like(self._k)
        self._cur = torch.zeros(B, dtype=torch.long, device=dev)
        self._pos = torch.zeros(B, dtype=torch.long, device=dev)
        self._temps = torch.zeros(B, dtype=torch.float32, device=dev)
        self._top_ks = torch.zeros(B, dtype=torch.long, device=dev)
        self._top_ps = torch.ones(B, dtype=torch.float32, device=dev)
        self._active = torch.zeros(B, dtype=torch.bool, device=dev)
        self._remaining = torch.zeros(B, dtype=torch.long, device=dev)
        self._eos = torch.full((B,), -1, dtype=torch.long, device=dev)
        #: Per slot: the generator of a sampling request (None = greedy).
        self._gens: List[Optional[torch.Generator]] = [None] * B
        self._slots: List[Optional[SlotInfo]] = [None] * B
        self._norm = _make_norm(config)

    # -- introspection ---------------------------------------------------
    def device_state(self) -> Dict[str, np.ndarray]:
        """Host snapshot of the device-resident per-slot state (a sync
        point: tests and debugging only)."""
        return {
            name: getattr(self, f"_{name}").cpu().numpy()
            for name in (
                "cur", "pos", "temps", "top_ks", "top_ps", "active",
                "remaining", "eos",
            )
        }

    @property
    def num_active(self) -> int:
        """Occupied slots."""
        return sum(1 for s in self._slots if s is not None)

    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self._slots) if s is None]

    def bucket_for(self, prompt_len: int) -> int:
        for b in self.prefill_buckets:
            if b >= prompt_len:
                return b
        raise ValueError(
            f"prompt length {prompt_len} exceeds largest prefill bucket "
            f"{self.prefill_buckets[-1]}"
        )

    def check_prompt_len(self, prompt_len: int) -> None:
        """Raise when a prompt can never be admitted (over every bucket)."""
        self.bucket_for(prompt_len)

    # -- request lifecycle -----------------------------------------------
    def admit(
        self,
        prompt: Sequence[int],
        *,
        request_id: str,
        max_new_tokens: int,
        temperature: float = 0.0,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
        seed: int = 0,
        eos_token: Optional[int] = None,
    ) -> Tuple[int, int, bool]:
        """Prefill ``prompt`` into a free slot; returns (slot, first_token,
        done). Raises when no slot is free or the request cannot fit."""
        return self.admit_many(
            [
                dict(
                    prompt=prompt,
                    request_id=request_id,
                    max_new_tokens=max_new_tokens,
                    temperature=temperature,
                    top_k=top_k,
                    top_p=top_p,
                    seed=seed,
                    eos_token=eos_token,
                )
            ]
        )[0]

    def admit_many(
        self, requests: Sequence[Dict[str, Any]]
    ) -> List[Tuple[int, int, bool]]:
        """Admit a burst of requests between folds; returns ``(slot,
        first_token, done)`` per request, in order. Every request is
        validated before any device state moves, and every admission is
        queued on the device before the first token is read back."""
        free = self.free_slots()
        if len(requests) > len(free):
            raise RuntimeError(
                f"{len(requests)} admissions but only {len(free)} free "
                "slots (check free_slots() first)"
            )
        staged = []
        for r, slot in zip(requests, free):
            prompt = np.asarray(r["prompt"], np.int64).reshape(-1)
            P = int(prompt.shape[0])
            n_new = int(r["max_new_tokens"])
            if P < 1 or n_new < 1:
                raise ValueError(
                    "need a non-empty prompt and max_new_tokens >= 1"
                )
            if P + n_new > self.max_seq:
                raise ValueError(
                    f"prompt ({P}) + max_new_tokens ({n_new}) exceeds "
                    f"engine max_seq {self.max_seq}"
                )
            eos = r.get("eos_token")
            staged.append(
                (slot, r, prompt, P, n_new, self.bucket_for(P),
                 -1 if eos is None else int(eos))
            )
        pending = []
        with torch.no_grad():
            for slot, r, prompt, P, n_new, pb, eos in staged:
                tok = self._admit_one(slot, r, prompt, P, n_new, pb, eos)
                pending.append((slot, r, n_new, eos, tok))
            toks = torch.stack([t for *_, t in pending]).tolist()
        out: List[Tuple[int, int, bool]] = []
        for (slot, r, n_new, eos, _), tok in zip(pending, toks):
            # Mirrors the device-side `live` predicate: a request done at
            # its first token never occupies the slot.
            done = n_new == 1 or tok == eos
            if done:
                self._gens[slot] = None
            else:
                self._slots[slot] = SlotInfo(
                    request_id=r["request_id"],
                    max_new_tokens=n_new,
                    n_generated=1,
                    eos_token=eos,
                )
            out.append((slot, tok, done))
        return out

    def _admit_one(self, slot, r, prompt, P, n_new, pb, eos) -> torch.Tensor:
        """The fused admission of one request: bucketed prefill, cache
        write into the slot's rows [0, pb), first-token sample and the
        slot's state write, all queued on the device."""
        dev = self.device
        params = self.params
        padded = torch.zeros((1, pb), dtype=torch.long)
        padded[0, :P] = torch.from_numpy(prompt)
        h, pf_k, pf_v = gpt_prefill(params, self.cfg, padded.to(dev))
        h_last = self._norm(h[:, P - 1 : P], params["lnf_g"], params["lnf_b"])
        logits = _lm_head(h_last[:, 0], _head_weight(params, self.cfg))
        # In place: the slot's rows of the one cache.
        self._k[:, slot, :pb] = pf_k[:, 0]
        self._v[:, slot, :pb] = pf_v[:, 0]
        temp = float(r.get("temperature", 0.0))
        top_k = r.get("top_k")
        top_p = r.get("top_p")
        gen = None
        if temp > 0.0:
            gen = torch.Generator(device=dev).manual_seed(int(r.get("seed", 0)))
        self._gens[slot] = gen
        knobs = torch.tensor(
            [temp, 1.0 if top_p is None else float(top_p)], device=dev
        )
        self._temps[slot] = knobs[0]
        self._top_ps[slot] = knobs[1]
        self._top_ks[slot] = 0 if top_k is None else int(top_k)
        tok = sample_logits_batched(
            logits, self._temps[slot : slot + 1],
            self._top_ks[slot : slot + 1], self._top_ps[slot : slot + 1],
            [gen],
        )[0]
        self._cur[slot] = tok
        self._pos[slot] = P
        self._active[slot] = (n_new > 1) & (tok != eos)
        self._remaining[slot] = n_new - 1
        self._eos[slot] = eos
        return tok

    def release(self, slot: int) -> None:
        """Evict a slot (cancelled, or host-observed finished); it is
        reusable at once. Its stale cache rows are invisible behind the
        slot masks and are overwritten by the next tenant."""
        if self._slots[slot] is None:
            return
        self._slots[slot] = None
        self._gens[slot] = None
        self._active[slot] = False
        self._remaining[slot] = 0
        self._eos[slot] = -1
        self._temps[slot] = 0.0
        self._top_ks[slot] = 0
        self._top_ps[slot] = 1.0

    # -- the hot loop ----------------------------------------------------
    def step(self) -> List[Tuple[int, str, int, bool]]:
        """One fold: up to ``decode_fold`` tokens per occupied slot, in fold
        order; returns ``(slot, request_id, token, done)`` per emitted
        token. Finished slots are released before returning."""
        if not any(s is not None for s in self._slots):
            return []
        with torch.no_grad():
            (
                tok_block, emit_block, self._cur, self._pos, self._active,
                self._remaining, self._k, self._v,
            ) = gpt_decode_fold(
                self.params, self.cfg, self._cur, self._pos, self._gens,
                self._temps, self._top_ks, self._top_ps, self._active,
                self._remaining, self._eos, self._k, self._v,
                fold=self.decode_fold,
            )
            # The one device-to-host read per fold.
            block = torch.stack([tok_block, emit_block.long()]).cpu().numpy()
        return self._harvest(block[0], block[1].astype(bool))

    def _harvest(
        self, toks: np.ndarray, emits: np.ndarray
    ) -> List[Tuple[int, str, int, bool]]:
        out: List[Tuple[int, str, int, bool]] = []
        snapshot = list(self._slots)
        for kk in range(toks.shape[0]):
            for slot, info in enumerate(snapshot):
                # The device froze a finished slot on the same condition
                # the host tests below, so it emits nothing after `done`.
                if info is None or not emits[kk, slot]:
                    continue
                tok = int(toks[kk, slot])
                info.n_generated += 1
                done = (
                    info.n_generated >= info.max_new_tokens
                    or tok == info.eos_token
                )
                out.append((slot, info.request_id, tok, done))
                if done:
                    # The fold already froze the slot on the device at
                    # exactly this token: host bookkeeping only.
                    self._slots[slot] = None
                    self._gens[slot] = None
        return out
