"""Slot-based continuous-batching decode engine (PyTorch port).

Port of ``ray_lightning_tpu/serve/engine.py``'s dense configuration: a
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
(``models/gpt.py:DECODE_ROWS``). A chunked or prefix-seeded prompt holds
it against a solo ``gpt_generate`` under ``attn_impl="reference"``, whose
prefill is the same chunk function run once over the whole prompt.

Chunked prefill (``prefill_chunk=C``): admission becomes a per-slot state
machine. :meth:`admit_many` parks the slot inactive with its ``pos`` at the
first row not yet prefilled and returns no token; each
:meth:`prefill_step` extends one slot's cache by a C-token chunk
(``models/gpt.py:gpt_prefill_chunk``), so the scheduler interleaves chunks
with decode folds instead of stalling them behind one long prefill. An
interleaved fold writes a parked slot's row at ``pos`` only, and the next
chunk writes that row before it attends to it. The final chunk samples
the first token (draw 0 of the request's seed) and arms the slot.

Prefix cache (``prefix_blocks=N``): a device pool of N blocks of
``prefix_block`` positions, (L, N, block, Hkv, hd) K and V, keyed by
chained digests of the prompt's full blocks. Admission walks the longest
cached prefix, copies it into the slot's rows and prefills only the rest;
a finished prefill inserts its new full blocks. Blocks are pinned while a
matching prefill runs and evicted least recently used. With
``prefix_host_mb`` and ``prefix_disk_dir`` an evicted block spills to a
byte-budgeted host-RAM tier and from there to ``.npy`` files on disk; a
hit in either is promoted back into the pool. K/V of a position are a
function of the token prefix alone, and copies and tiers move bytes, so
a seeded slot decodes as a cold prefill would.

Paged KV (``kv_pages=N``, ``kv_page=P``): the slots' dense strips and the
prefix pool become one pool of N pages of P positions, with page 0 kept
as a scratch page. Each slot holds a page table; attention gathers the
slot's pages into the dense layout and runs the dense functions
(``models/gpt.py:gpt_decode_step_paged``), so paged and dense rows are
bitwise equal. A prefix hit aliases the cached pages into the new slot's
table (a refcount, no copy), and admission allocates the rest of the
request's pages for its whole life up front. Capacity becomes a token
budget of (N - 1) * P shared by all slots. Paging implies chunked
prefill and rides the prefix pool's digests, LRU and tiers.

Speculative decoding (``spec="ngram"`` or ``"model"``): each fold
iteration drafts ``spec_depth`` tokens per slot from its token history
(prompt lookup, or a small draft model's window prefill and greedy
steps), verifies them in one forward and emits the longest matching
prefix plus one token (``models/gpt.py:gpt_decode_fold_spec``). The
verify is the decode step with a query axis, so the tokens are those of
the plain engine; a sampled slot's n-th token uses its n-th draw either
way (a per-slot seed and draw counter on the device,
``models/gpt.py:draw_uniforms``).

Piggybacked prefill chunks (``piggyback_chunks=C``): up to C prefill
chunks, one per prefilling slot, ride each decode dispatch after the
fold's iterations (``models/gpt.py:piggyback_prefill``, the separate
chunk's own code), so a chunked admission pays no dispatch of its own;
the scheduler reads their first tokens from :meth:`pop_chunk_events`.
The fold-depth ladder (``fold_ladder``) picks each dispatch's number of
iterations: the shallowest rung while prefills wait, else the deepest
that every resident's remaining budget can use.

Pipelined dispatch (``pipeline=True``, the default): :meth:`step`
queues fold N+1 on the stream before it reads fold N's tokens, so the
harvest and the scheduler's host work overlap the card's work. Each
dispatch copies its token block non-blocking into one of two pinned
host buffers and records an event; the harvest waits on that event
alone, not on the fold queued behind it. A slot released between a
dispatch and its harvest may still decode in that fold: its tokens are
dropped at harvest by the ``released`` marker of the dispatch-time
snapshot, its freed pages wait in the quarantine until the harvest, and
its next tenant's writes queue after the fold on the same stream.

Dispatch programs (the JAX engine's construction-time compile): every
dispatch is a body that reads fixed device buffers and writes fixed
device buffers, keyed in :attr:`DecodeEngine.dispatch_plan`: a fold per
ladder rung in an all-greedy and a sampling variant (the host knows which
slots sample; a graph has no branch), with the ``piggyback_chunks`` chunk
rows as a fixed block with a validity mask; a chunk per chunk bucket
(chunked mode); a fused admission per prompt bucket (monolithic mode). On
the card each is captured as a CUDA graph at construction and replayed
(``utils/graphs.py``); ``compiled_count`` counts the graphs and does not
move afterwards. On the CPU the same bodies run on the same buffers
without capture. The host writes a dispatch's inputs into its buffers
with pinned non-blocking copies; the slot, table and history writes of
admission and release stay small eager ops.

Weight-only int8 (an int8 tree from ``utils/quantize.py``, or
``serve/server.py:build_engine(int8=True)``): the int8 nodes stay int8 on
the device; every product dequantizes its weight where it is used, inside
the dispatch bodies (``models/gpt.py:cast_params``).

Prefix handoff (the preemption drain's cross-replica KV move):
:meth:`export_prefix_blocks` serializes a prompt's cached chain from every
tier as ``(digest_hex, k, v)`` host blocks, :meth:`import_prefix_blocks`
writes a peer's blocks into the pool (or the host tier), and
:meth:`evict_prefix_chain` frees a chain from every tier. A digest that
leaves every tier is noted in :meth:`dropped_digests`. The engine records
the spans only it sees (prefill dispatches, chunks, prefix seeds) on
``tracer`` and its pool evictions on ``events`` when the scheduler sets
them, and its fused-dispatch series in the process registry
(``obs/registry.py:get_registry``).

The fleet KV plane and the KV object store (``serve/kvfleet.py``,
``serve/kvstore.py``): :meth:`export_blocks_by_digest` answers a peer's
fetch, :meth:`cached_prefix_blocks` is the scheduler's probe before it
asks for one, :meth:`import_prefix_block_layer` stages a layer-wise ship
(a block is matchable only once its last layer lands), and with
``kvstore_dir`` a block that leaves every local tier is written to the
store instead of dying.

A serving mesh (``mesh``, ``parallel/mesh.py:mesh_from_spec``): PyTorch is
multi-controller and the port runs one process per card, so a mesh
engine is a gang. Every rank of the serving world builds the same engine
on its own slice (``models/gpt.py:gpt_param_slices``): H/m query heads,
Hkv/m KV heads of the cache, the pool and the pages, d_ff/m MLP columns;
the model functions all-reduce the out projection's and the MLP's partial
sums over the ``"model"`` group, so every rank samples the same logits and
emits the same tokens. The rank that serves drives the others through its
op stream (``serve/server.py:_GangLeaderEngine``). The prefix tiers spill
and refill this rank's slice, on per-rank budgets (the disk tier in a
``rank<N>`` directory of its own). On an NCCL model group the dispatch
graphs capture the collectives; on gloo (ranks sharing a card, or the
CPU) the bodies run eagerly, ``graphed`` is False and ``compiled_count``
stays 0. A split engine's KV plane moves whole blocks, in the form an
unsplit engine's exports take: an export gathers every rank's heads of
each block over the model group (every rank runs it, as an op of the
gang's stream), an import keeps this rank's heads of each whole block,
and with ``kvstore_dir`` a block leaving the local tiers is gathered on
every rank and written whole by the gang's first rank.

All methods must be driven from one thread (the scheduler loop).
"""
from __future__ import annotations

import dataclasses
import gc
import hashlib
import os
import time
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ray_lightning_tpu_torch.models.gpt import (
    ChunkRow,
    ChunkRows,
    GPTConfig,
    cast_params,
    check_decode_mesh,
    compute_dtype,
    first_token,
    gpt_decode_fold,
    gpt_decode_fold_spec,
    gpt_param_slices,
    gpt_prefill,
    model_propose,
    ngram_propose,
    params_to,
    piggyback_prefill,
    seed64,
)
from ray_lightning_tpu_torch.obs import trace as _trace
from ray_lightning_tpu_torch.obs.registry import get_registry
from ray_lightning_tpu_torch.ops.flash_attention import takes_reference_path
from ray_lightning_tpu_torch.serve.metrics import TIER_COUNTERS
from ray_lightning_tpu_torch.utils.device import host_to, resolve_device
from ray_lightning_tpu_torch.utils.graphs import Program, pinned_copy

#: Constructor options of the JAX engine that the port does not run yet:
#: name -> (the JAX default, which the port accepts, and the ROADMAP item).
#: Every option is ported.
_UNPORTED: Dict[str, Tuple[Any, str]] = {}

#: The tiers of the prefix cache, warmest first.
TIERS = ("device", "host", "disk")


@dataclasses.dataclass
class SlotInfo:
    """Host-side record of one occupied slot."""

    request_id: str
    max_new_tokens: int
    n_generated: int
    eos_token: int  # -1 = disabled
    #: Set when the slot is released: a fold dispatched before the release
    #: may still emit tokens for this tenant, and the harvest drops them.
    released: bool = False


@dataclasses.dataclass
class PrefillTask:
    """Host-side state machine of one in-progress chunked admission."""

    request_id: str
    tokens: np.ndarray  # (P,) prompt
    next: int  # first position not yet prefilled (cache rows [0, next) live)
    max_new_tokens: int
    eos_token: int
    temperature: float
    top_k: int
    top_p: float
    #: The request's seed, written into the slot's device seed at
    #: admission (the JAX engine carries the request's PRNG key here).
    seed: int
    #: Tokens seeded from the prefix pool (suffix prefill starts there).
    matched_tokens: int = 0
    #: Pool block indices pinned (ref-counted) for this prefill's lifetime.
    block_refs: List[int] = dataclasses.field(default_factory=list)
    chunks: int = 0  # chunk dispatches so far


#: A piggybacked final chunk of a dispatch: (its row in the dispatch, slot,
#: task, the SlotInfo armed at dispatch).
_Final = Tuple[int, int, PrefillTask, SlotInfo]


@dataclasses.dataclass
class _Fold:
    """One dispatched fold, until its harvest: the host buffer its token
    block is copied into, the event recorded after that copy (None on the
    CPU, where the copy is synchronous), the slot snapshot and the
    piggybacked finals of its dispatch, and its rung."""

    buf: torch.Tensor  # (2 * rows [+ 1], B): tokens, emit mask, first tokens
    event: Optional[Any]
    rows: int
    snapshot: List[Optional[SlotInfo]]
    finals: List[_Final]
    k: int


@dataclasses.dataclass
class _PoolBlock:
    """Host metadata of one occupied prefix-pool block (or page)."""

    #: None for a paged slot's private page until its prompt registers it.
    digest: Optional[bytes]
    refs: int = 0
    stamp: int = 0  # LRU clock (higher = more recently used)


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


def chunk_buckets(prefill_chunk: int) -> Tuple[int, ...]:
    """Chunk lengths a chunk is padded to: powers of two from
    ``min(16, prefill_chunk)`` and ``prefill_chunk`` itself (the JAX
    engine's ``default_buckets(prefill_chunk, lo=min(16, prefill_chunk))``).
    """
    out, b = [], min(16, prefill_chunk)
    while b < prefill_chunk:
        out.append(b)
        b *= 2
    return tuple(sorted(set(out + [prefill_chunk])))


class DecodeEngine:
    """Continuous-batching decode over a fixed slot-indexed KV cache.

    The caches, the prefix pool and every per-slot scalar (current token,
    position, sampling knobs, active/remaining/eos) live on ``device`` and
    are updated there; the host keeps request bookkeeping (``SlotInfo``,
    ``PrefillTask``), the pool's digest map and LRU, the spill tiers, and
    which slots sample. :meth:`device_state` is the explicit sync point
    that copies the slot state to the host.

    ``_graphs=False`` (private) runs the dispatch bodies eagerly on the
    card instead of replaying their graphs: a timing baseline, never
    chosen by the engine itself.
    """

    def __init__(
        self,
        params: Dict[str, Any],
        config: GPTConfig | Dict[str, Any],
        num_slots: int = 4,
        max_seq: Optional[int] = None,
        prefill_buckets: Optional[Sequence[int]] = None,
        decode_fold: int = 1,
        fold_ladder: Optional[Sequence[int]] = None,
        piggyback_chunks: int = 0,
        pipeline: bool = True,
        prefill_chunk: int = 0,
        prefix_blocks: int = 0,
        prefix_block: int = 16,
        prefix_host_mb: float = 0.0,
        prefix_disk_dir: Optional[str] = None,
        prefix_disk_mb: float = 0.0,
        kvstore_dir: Optional[str] = None,
        kvstore_mb: float = 0.0,
        kv_page: int = 0,
        kv_pages: int = 0,
        kvstore_namespace: Optional[str] = None,
        spec: str = "off",
        spec_depth: int = 4,
        spec_params: Optional[Dict[str, Any]] = None,
        spec_config: Optional[GPTConfig | Dict[str, Any]] = None,
        spec_window: int = 32,
        mesh: Any = None,
        device: Any = "cuda",
        _graphs: bool = True,
        **options: Any,
    ) -> None:
        for name, value in options.items():
            if name not in _UNPORTED:
                raise TypeError(
                    f"DecodeEngine got an unexpected keyword argument {name!r}"
                )
            default, item = _UNPORTED[name]
            if value != default:
                raise NotImplementedError(
                    f"DecodeEngine option {name}={value!r} is not ported yet "
                    f"(ROADMAP {item})"
                )
        if isinstance(config, dict):
            config = GPTConfig(**config)
        config.validate_variants()
        # Before anything is allocated: a mesh that cannot split this
        # config's heads rejects now.
        if mesh is not None:
            check_decode_mesh(config, mesh)
        self.cfg = config
        self.mesh = mesh
        #: The model group this rank all-reduces over (None: whole heads).
        self._tp = mesh.group("model") if mesh is not None else None
        self._model = int(mesh.shape["model"]) if mesh is not None else 1
        self.device = resolve_device(device)
        self.num_slots = int(num_slots)
        if self.num_slots < 1:
            raise ValueError("num_slots must be >= 1")
        self.decode_fold = int(decode_fold)
        if self.decode_fold < 1:
            raise ValueError("decode_fold must be >= 1")
        # The fold-depth ladder: _pick_fold_k picks a rung per dispatch.
        if fold_ladder:
            ladder = tuple(sorted({int(k) for k in fold_ladder}))
            if ladder[0] < 1:
                raise ValueError(
                    f"fold_ladder {list(fold_ladder)} rungs must be >= 1 "
                    "(decode iterations per dispatch)"
                )
            if self.decode_fold not in ladder:
                raise ValueError(
                    f"fold_ladder {list(ladder)} must include decode_fold "
                    f"{self.decode_fold} (the default rung)"
                )
        else:
            ladder = (self.decode_fold,)
        self.fold_ladder = ladder
        self.piggyback_chunks = int(piggyback_chunks)
        if not 0 <= self.piggyback_chunks <= self.num_slots:
            raise ValueError(
                f"piggyback_chunks {self.piggyback_chunks} must be in "
                f"[0, num_slots={self.num_slots}] (prefill-chunk rows fused "
                "into each decode dispatch; one row per slot)"
            )
        self.pipeline = bool(pipeline)
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
        # Paged KV (kv_pages > 0): one refcounted page pool in place of the
        # slot strips and the prefix pool; page 0 is the scratch page.
        self.kv_pages = int(kv_pages)
        self.kv_page = int(kv_page) if kv_page else (16 if kv_pages else 0)
        self.paged = self.kv_pages > 0
        if kv_page and not self.paged:
            raise ValueError(
                "kv_page needs kv_pages > 0 (the paged-KV page budget); "
                "the dense engine takes neither"
            )
        if self.paged:
            if prefix_blocks:
                raise ValueError(
                    "paged KV (kv_pages > 0) unifies the prefix pool into "
                    "the page allocator: prefix sharing is built in and "
                    "keyed per kv_page-sized page; drop prefix_blocks/"
                    "prefix_block"
                )
            if not 1 <= self.kv_page <= self.max_seq or (
                self.max_seq % self.kv_page
            ):
                raise ValueError(
                    f"kv_page {self.kv_page} must divide the bucket sizes: "
                    f"a divisor of max_seq {self.max_seq} in "
                    f"[1, {self.max_seq}]"
                )
            min_pages = self.max_seq // self.kv_page + 1
            if self.kv_pages < min_pages:
                raise ValueError(
                    f"kv_pages {self.kv_pages} cannot hold one max-length "
                    f"request: need >= {min_pages} (max_seq {self.max_seq} "
                    f"/ kv_page {self.kv_page} + the reserved scratch page)"
                )
            # The page pool rides the prefix pool's machinery (digests,
            # LRU, refcounts, tiers) on kv_page-sized pages.
            prefix_blocks, prefix_block = self.kv_pages, self.kv_page
        # Chunked mode: prefill_chunk > 0, or any prefix pool or paging (a
        # suffix-only prefill needs the cache-seeded chunk path).
        self.prefix_blocks = int(prefix_blocks)
        self.prefix_block = int(prefix_block)
        if self.prefix_blocks and not prefill_chunk:
            prefill_chunk = buckets[-1]
        self.prefill_chunk = int(prefill_chunk)
        self.chunked = self.prefill_chunk > 0
        if self.piggyback_chunks and not self.chunked:
            raise ValueError(
                f"piggyback_chunks {self.piggyback_chunks} needs chunked "
                "prefill (prefill_chunk > 0, or any prefix pool / paged KV): "
                "only chunk-state-machine admissions can ride a decode "
                "dispatch"
            )
        if self.chunked:
            if self.prefill_chunk > self.max_seq:
                raise ValueError(
                    f"prefill_chunk {self.prefill_chunk} exceeds max_seq "
                    f"{self.max_seq}"
                )
            self.chunk_buckets = chunk_buckets(self.prefill_chunk)
        else:
            self.chunk_buckets = ()
        if self.prefix_blocks and not 1 <= self.prefix_block <= self.max_seq:
            raise ValueError(
                f"prefix_block {self.prefix_block} must be in "
                f"[1, max_seq={self.max_seq}]"
            )
        # Spill tiers below the device pool: host RAM (prefix_host_mb MiB),
        # then an optional disk tier (prefix_disk_dir; its budget defaults
        # to 1 GiB when only the directory is given).
        self.prefix_host_mb = float(prefix_host_mb)
        self.prefix_disk_dir = str(prefix_disk_dir) if prefix_disk_dir else None
        self.prefix_disk_mb = float(prefix_disk_mb)
        if self.prefix_host_mb < 0 or self.prefix_disk_mb < 0:
            raise ValueError("prefix tier budgets must be >= 0")
        if self.prefix_disk_dir and self.prefix_disk_mb == 0:
            self.prefix_disk_mb = 1024.0
        if (
            self.prefix_host_mb > 0 or self.prefix_disk_dir
        ) and not self.prefix_blocks:
            raise ValueError(
                "prefix tiers (prefix_host_mb / prefix_disk_dir) need a "
                "device prefix pool (prefix_blocks > 0) to spill from"
            )
        self._check_spec(spec, spec_depth, spec_params, spec_config, spec_window)
        # The compute-dtype copy of the weights, made once here (see
        # models/gpt.py:cast_params): the JAX engine casts inside its
        # compiled step, where XLA fuses the cast into the matmul.
        # Under a mesh this rank's slices, cut before they move.
        self.params = cast_params(
            params_to(gpt_param_slices(params, config, mesh), self.device),
            config)
        self._spec_params = (
            cast_params(params_to(spec_params, self.device), self._spec_cfg)
            if self.spec == "model"
            else None
        )
        #: Accept accounting (spec_stats, the scheduler's metrics diff).
        self.spec_verifies = 0
        self.spec_drafted_tokens = 0
        self.spec_accepted_tokens = 0
        self.spec_emitted_tokens = 0

        cdt = compute_dtype(config)
        # This rank's KV heads: Hkv/m under a model split.
        L, hd = config.n_layer, config.head_dim
        Hkv = config.kv_head // self._model
        B, S = self.num_slots, self.max_seq
        dev = self.device
        if self.paged:
            # No dense strips: the page pool is the KV cache, and each
            # slot's view of it is its table row (all scratch until
            # admission gives it pages).
            self._k = self._v = None
            self._table = torch.zeros((B, S // self.kv_page),
                                      dtype=torch.long, device=dev)
        else:
            self._k = torch.zeros((L, B, S, Hkv, hd), dtype=cdt, device=dev)
            self._v = torch.zeros_like(self._k)
            self._table = None
        # Prefix pool: device K/V blocks + the host digest map and LRU.
        pool_shape = (L, self.prefix_blocks, self.prefix_block, Hkv, hd)
        self._pool_k = torch.zeros(pool_shape, dtype=cdt, device=dev)
        self._pool_v = torch.zeros_like(self._pool_k)
        self._pool_map: Dict[bytes, int] = {}
        self._pool_meta: List[Optional[_PoolBlock]] = [None] * self.prefix_blocks
        # Paged mode keeps page 0 as the scratch page: never allocated,
        # never read, its meta None for good.
        self._pool_free: List[int] = list(
            range(1 if self.paged else 0, self.prefix_blocks)
        )
        self._pool_tick = 0
        #: Paged bookkeeping: each slot's pages (aliased prefix pages
        #: first), the token span its allocation covers (min(P + new,
        #: S - 1) + 1, the fragmentation stat's denominator), and the
        #: quarantine of freed private pages, which a fold in flight may
        #: still write: it is flushed when no fold is in flight, else at
        #: the top of the next harvest.
        self._slot_pages: List[List[int]] = [[] for _ in range(B)]
        self._slot_span: List[int] = [0] * B
        self._quarantine: List[int] = []
        self.page_allocs = 0
        self.page_frees = 0
        self.page_alias_hits = 0
        self.prefix_lookups = 0
        self.prefix_hit_tokens = 0
        self.prefix_prompt_tokens = 0
        self.prefix_inserts = 0
        self.prefix_evictions = 0
        # -- spill tiers (host RAM, then disk) ---------------------------
        # Budgets hold on logical block bytes (one K + one V block).
        self._blk_shape = (L, 1, self.prefix_block, Hkv, hd)
        #: Where this rank's block sits in the whole block, per dim (the
        #: disk files' ``keys``): its heads' range under a model split.
        h0 = (mesh.coords["model"] * Hkv) if mesh is not None else 0
        self._blk_keys = [(0, n) for n in self._blk_shape]
        self._blk_keys[3] = (h0, h0 + Hkv)
        self._blk_dtype = cdt
        self._blk_nbytes = (
            2 * int(np.prod(self._blk_shape)) * cdt.itemsize
        )
        self._host_budget = int(self.prefix_host_mb * (1 << 20))
        self._disk_budget = (
            int(self.prefix_disk_mb * (1 << 20)) if self.prefix_disk_dir else 0
        )
        self._tiered = self._host_budget > 0 or self._disk_budget > 0
        #: digest -> (k, v) CPU blocks, oldest first (the tier's LRU).
        self._host_map: "OrderedDict[bytes, Tuple[torch.Tensor, torch.Tensor]]" = (
            OrderedDict()
        )
        #: digest -> on-disk bytes, oldest first; files live under
        #: ``prefix_disk_dir`` as ``<digest-hex>.{keys,k,v}.npy``.
        self._disk_map: "OrderedDict[bytes, int]" = OrderedDict()
        self._disk_bytes = 0
        #: The disk tier's directory: a gang's ranks hold different slices
        #: of a digest's block, so each writes under its own.
        self._disk_dir = (
            os.path.join(self.prefix_disk_dir, f"rank{mesh.rank}")
            if self.prefix_disk_dir and mesh is not None
            else self.prefix_disk_dir
        )
        if self._disk_budget:
            os.makedirs(self._disk_dir, exist_ok=True)
            self._disk_prune_stale()
        #: Cumulative per-tier accounting (the scheduler diffs these into
        #: ServeMetrics): hits/misses are digest-walk probes; spills are
        #: blocks moved one tier colder (still alive); promotions are
        #: blocks moved back into the device pool; evictions are blocks
        #: dropped from the tier entirely.
        self.tier_counters: Dict[str, Dict[str, int]] = {
            t: {c: 0 for c in TIER_COUNTERS} for t in TIERS
        }
        #: Host seconds spent refilling promoted blocks (payload read +
        #: the host-to-device copy): what a cold hit costs.
        self.refill_s = 0.0
        #: Cross-replica prefix handoff: blocks exported and imported.
        self.prefix_handoff_exports = 0
        self.prefix_handoff_imports = 0
        # The KV object store, the tier of last resort shared by the
        # fleet: a block that falls off the bottom of the local tier walk
        # is written there instead of dying (_store_sink), and the fleet
        # KV plane reads chains back from it. Unlike the disk tier it is
        # not adopted into this engine's maps at start: warm content
        # comes back only through a fetch. Its keys carry the model's
        # namespace (the checkpoint and config, serve/kvstore.py:
        # kvstore_namespace), since the token digests do not say which
        # model made the bytes.
        self.kvstore_dir = str(kvstore_dir) if kvstore_dir else None
        self.kvstore_mb = float(kvstore_mb)
        self.kvstore: Any = None
        self.kvstore_namespace: Optional[str] = None
        if self.kvstore_dir:
            from ray_lightning_tpu_torch.serve.kvstore import (
                FleetKVStore,
                kvstore_namespace as _kvs_ns,
            )

            self.kvstore_namespace = (
                str(kvstore_namespace) if kvstore_namespace
                else _kvs_ns(None, config)
            )
        # A split gang gathers a block leaving its tiers on every rank
        # (_store_sink); its first rank alone opens the store and writes.
        if self.kvstore_dir and (mesh is None or mesh.rank == 0):
            self.kvstore = FleetKVStore(
                self.kvstore_dir,
                budget_mb=self.kvstore_mb,
                registry=get_registry(),
                namespace=self.kvstore_namespace,
            )
        #: Digests that left every tier (the fleet directory's eviction
        #: feed): a bounded ring of hexes and the running total.
        self._dropped_ring: "deque[str]" = deque(maxlen=256)
        self.kv_dropped_total = 0

        self._cur = torch.zeros(B, dtype=torch.long, device=dev)
        self._pos = torch.zeros(B, dtype=torch.long, device=dev)
        self._temps = torch.zeros(B, dtype=torch.float32, device=dev)
        self._top_ks = torch.zeros(B, dtype=torch.long, device=dev)
        self._top_ps = torch.ones(B, dtype=torch.float32, device=dev)
        self._active = torch.zeros(B, dtype=torch.bool, device=dev)
        self._remaining = torch.zeros(B, dtype=torch.long, device=dev)
        self._eos = torch.full((B,), -1, dtype=torch.long, device=dev)
        #: Per slot: the request's seed and its next draw's number (the
        #: n-th token of a request uses draw n).
        self._seeds = torch.zeros(B, dtype=torch.long, device=dev)
        self._ctrs = torch.zeros(B, dtype=torch.long, device=dev)
        #: Per-slot token history (hist[b, p] = the token at position p),
        #: what the drafters read; None with spec off.
        self._hist = (
            torch.zeros((B, S), dtype=torch.long, device=dev)
            if self.spec != "off"
            else None
        )
        #: Per slot: whether its request samples (temperature > 0), so the
        #: host picks a fold's variant without reading the device.
        self._samples: List[bool] = [False] * B
        self._slots: List[Optional[SlotInfo]] = [None] * B
        #: slot -> in-progress chunked admission (chunked mode only).
        self._prefills: Dict[int, PrefillTask] = {}
        #: The piggybacked prefill completions of the last harvest that had
        #: any, for pop_chunk_events.
        self._pb_events: List[Tuple[int, PrefillTask, int, bool]] = []
        #: Layer-wise imports in flight: digest -> {"idx": pool block,
        #: "next": the layer expected, "n": layers}. A staged block has no
        #: digest and one pin until its last layer lands or it aborts.
        self._layer_imports: Dict[bytes, Dict[str, int]] = {}
        self.layer_block_imports = 0
        self.layer_import_aborts = 0
        #: Fused-dispatch accounting (stats and the registry's series).
        self.piggyback_dispatches = 0
        self.piggyback_chunk_rows = 0
        self.fold_dispatches: Dict[int, int] = {k: 0 for k in ladder}
        reg = get_registry()
        self._m_pb_dispatches = reg.counter(
            "rlt_serve_piggyback_dispatches_total",
            "Decode dispatches that carried >= 1 piggybacked prefill "
            "chunk row",
        )
        self._m_pb_rows = reg.counter(
            "rlt_serve_piggyback_chunk_rows_total",
            "Prefill chunk rows run inside decode dispatches",
        )
        self._m_fold_depth = reg.histogram(
            "rlt_serve_fold_depth",
            "Fold depth K chosen per decode dispatch",
            buckets=(1, 2, 4, 8, 16, 32, 64),
        )
        #: Optional obs.trace.RequestTracer: the spans only the engine sees
        #: (prefill dispatches, chunks, prefix seeds). Set by the
        #: Scheduler; None keeps the hot paths branch-only.
        self.tracer: Optional[Any] = None
        #: Optional obs.events.EventLog: prefix-pool evictions and
        #: handoff imports. Set by the Scheduler; None = off.
        self.events: Optional[Any] = None
        #: The fold queued on the stream and not yet harvested.
        self._inflight: Optional[_Fold] = None
        # The double buffer: dispatches alternate between two host buffers
        # (pinned on the card, so the copy does not wait for the stream),
        # sized for the deepest rung's token and emit rows plus the row of
        # piggybacked first tokens (piggyback_chunks <= num_slots).
        group = self.spec_depth + 1 if self.spec != "off" else 1
        self._host_bufs = [
            torch.empty((2 * ladder[-1] * group + 1, B), dtype=torch.long,
                        pin_memory=dev.type == "cuda")
            for _ in range(2)
        ]
        self._buf_next = 0
        # -- the dispatch programs' fixed buffers -------------------------
        #: A fold's packed output: token rows, emit rows and the row of
        #: piggybacked first tokens.
        self._fold_out = torch.zeros((2 * ladder[-1] * group + 1, B),
                                     dtype=torch.long, device=dev)
        #: The first token of a chunk or an admission.
        self._tok_out = torch.zeros(1, dtype=torch.long, device=dev)
        self._pb_rows = (
            ChunkRows(self.piggyback_chunks, self.prefill_chunk, dev)
            if self.piggyback_chunks else None
        )
        self._chunk_rows = {cb: ChunkRows(1, cb, dev)
                            for cb in self.chunk_buckets}
        #: A monolithic admission's prompt (its bucket's leading columns),
        #: its integers (slot, length, top_k, eos, max_new_tokens, seed)
        #: and its floats (temperature, top_p).
        self._admit_prompt = torch.zeros((1, buckets[-1]), dtype=torch.long,
                                         device=dev)
        self._admit_ints = torch.zeros(6, dtype=torch.long, device=dev)
        self._admit_floats = torch.zeros(2, dtype=torch.float32, device=dev)
        self.dispatch_plan: Tuple[tuple, ...] = self._plan()
        self._build_programs(bool(_graphs))

    def _check_spec(self, spec, spec_depth, spec_params, spec_config,
                    spec_window) -> None:
        """Validate the speculative-decoding options and set ``spec``,
        ``spec_depth``, ``spec_window`` and the draft config."""
        self.spec = str(spec)
        if self.spec not in ("off", "ngram", "model"):
            raise ValueError(
                f"unknown spec mode {spec!r}; use 'off', 'ngram', or 'model'"
            )
        self.spec_depth = int(spec_depth)
        if self.spec != "off" and self.spec_depth < 1:
            raise ValueError("spec_depth must be >= 1")
        self.spec_window = int(spec_window)
        self._spec_cfg: Optional[GPTConfig] = None
        if self.spec != "model":
            return
        if spec_params is None or spec_config is None:
            raise ValueError(
                "spec='model' needs spec_params and spec_config (the draft "
                "model's weights and GPTConfig)"
            )
        if isinstance(spec_config, dict):
            spec_config = GPTConfig(**spec_config)
        spec_config.validate_variants()
        if spec_config.vocab_size != self.cfg.vocab_size:
            raise ValueError(
                f"draft model vocab {spec_config.vocab_size} != main vocab "
                f"{self.cfg.vocab_size}"
            )
        if self.spec_window < 1:
            raise ValueError("spec_window must be >= 1")
        if self.spec_window + self.spec_depth > spec_config.max_seq:
            raise ValueError(
                f"spec_window ({self.spec_window}) + spec_depth "
                f"({self.spec_depth}) exceeds the draft model's max_seq "
                f"({spec_config.max_seq})"
            )
        self._spec_cfg = spec_config

    # -- introspection ---------------------------------------------------
    def device_state(self) -> Dict[str, np.ndarray]:
        """Host snapshot of the device-resident per-slot state, the token
        history included with spec on (a sync point: tests and debugging
        only)."""
        names = ["cur", "pos", "temps", "top_ks", "top_ps", "active",
                 "remaining", "eos", "seeds", "ctrs"]
        if self._hist is not None:
            names.append("hist")
        return {name: getattr(self, f"_{name}").cpu().numpy() for name in names}

    @property
    def num_active(self) -> int:
        """Occupied slots: decoding residents plus in-progress chunked
        prefills (both hold their slot and still need engine work)."""
        return sum(1 for s in self._slots if s is not None) + len(
            self._prefills
        )

    @property
    def num_prefilling(self) -> int:
        return len(self._prefills)

    @property
    def mesh_desc(self) -> str:
        """``"MODELxDATA"`` of the serve mesh; ``"1x1"`` on one card."""
        if self.mesh is None:
            return "1x1"
        return f"{self.mesh.shape['model']}x{self.mesh.shape['data']}"

    @property
    def heads_split(self) -> bool:
        """Whether this rank holds only its own heads of every block (a
        model split): its exports gather, its imports slice, and a
        layer-wise ship from it falls back to the whole-prompt form."""
        return self._tp is not None

    #: Bytes and host seconds of the head gathers of this engine's exports
    #: and store writes (a split engine's; 0 on one card).
    kv_gather_bytes = 0
    kv_gather_s = 0.0

    def _gather_bytes(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """Every rank's bytes of ``parts`` (on the card or the host),
        gathered over the model group: an (m, nbytes) CPU uint8 tensor in
        group-rank order (one all-gather, staged through the host on
        gloo)."""
        from ray_lightning_tpu_torch.parallel.mesh import all_gather

        flat = torch.cat([
            (p if p.device.type == self.device.type
             else host_to(p, self.device))
            .contiguous().reshape(-1).view(torch.uint8) for p in parts])
        out = torch.empty((self._model * flat.numel(),), dtype=torch.uint8,
                          device=flat.device)
        all_gather(out, flat, self._tp)
        return out.view(self._model, -1).cpu()

    def _gather_heads(self, parts: Sequence[torch.Tensor]
                      ) -> List[torch.Tensor]:
        """Every rank's heads of ``parts`` (blocks of this rank's heads,
        head dim -2) gathered over the model group into whole CPU blocks
        (a collective every rank of the split runs with the same
        shapes)."""
        t0 = time.perf_counter()
        out = self._gather_bytes(parts)
        whole, at = [], 0
        for p in parts:
            n = p.numel() * p.element_size()
            t = out[:, at:at + n].contiguous().view(p.dtype).view(
                (self._model,) + tuple(p.shape))
            # (m, ..., Hkv/m, hd) -> (..., m, Hkv/m, hd) -> (..., Hkv, hd)
            t = t.movedim(0, -3).reshape(tuple(p.shape[:-2]) + (
                self._model * p.shape[-2], p.shape[-1]))
            whole.append(t)
            at += n
        self.kv_gather_bytes += out.numel()
        self.kv_gather_s += time.perf_counter() - t0
        return whole

    def _own_heads(self, t: Any, shape: Tuple[int, ...]) -> torch.Tensor:
        """This rank's heads of a whole block payload (an unsplit
        engine's form), as ``shape`` (the local block's, or one layer of
        it)."""
        t = torch.as_tensor(t).to(self._blk_dtype)
        if self._tp is None:
            return t.reshape(shape)
        hl = shape[3]
        whole = tuple(shape[:3]) + (hl * self._model,) + tuple(shape[4:])
        h0 = self._blk_keys[3][0]
        return t.reshape(whole)[:, :, :, h0:h0 + hl].contiguous()

    def memory_stats(self) -> Dict[str, Dict[str, int]]:
        """Resident device-state footprint by component (the JAX engine's
        ``memory_stats``): logical ``bytes`` and ``per_device_bytes``, what
        this rank holds. The KV cache and the prefix pool split their heads
        over the mesh's model axis, so this rank's bytes are 1/model of
        the whole; the token history and the page table are whole on every
        rank. The paged engine's page pool reports under ``prefix_pool``
        (``kv_cache`` reads 0) and its table under ``page_table``.
        Metadata only: reads tensor sizes, never values."""

        def row(*ts: Optional[torch.Tensor], split: bool = False
                ) -> Dict[str, int]:
            mine = sum(t.numel() * t.element_size() for t in ts
                       if t is not None)
            return {"bytes": mine * (self._model if split else 1),
                    "per_device_bytes": mine}

        out = {
            "kv_cache": row(self._k, self._v, split=True),
            "prefix_pool": row(self._pool_k, self._pool_v, split=True),
            "token_history": row(self._hist),
        }
        if self.paged:
            out["page_table"] = row(self._table)
        out["total"] = {
            k: sum(r[k] for r in out.values())
            for k in ("bytes", "per_device_bytes")
        }
        return out

    def free_slots(self) -> List[int]:
        return [
            i for i, s in enumerate(self._slots)
            if s is None and i not in self._prefills
        ]

    def bucket_for(self, prompt_len: int) -> int:
        for b in self.prefill_buckets:
            if b >= prompt_len:
                return b
        raise ValueError(
            f"prompt length {prompt_len} exceeds largest prefill bucket "
            f"{self.prefill_buckets[-1]}"
        )

    def check_prompt_len(self, prompt_len: int) -> None:
        """Raise when a prompt can never be admitted: over every bucket
        (monolithic) or leaving no room for a generated token (chunked:
        chunking lifts the bucket cap; prompts go up to max_seq - 1)."""
        if self.chunked:
            if prompt_len >= self.max_seq:
                raise ValueError(
                    f"prompt length {prompt_len} leaves no room for a "
                    f"generated token (engine max_seq {self.max_seq})"
                )
            return
        self.bucket_for(prompt_len)

    def _chunk_bucket_for(self, n: int) -> int:
        for b in self.chunk_buckets:
            if b >= n:
                return b
        raise ValueError(
            f"chunk length {n} exceeds largest chunk bucket "
            f"{self.chunk_buckets[-1]}"
        )

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
    ) -> Tuple[int, Optional[int], bool]:
        """Prefill ``prompt`` into a free slot; returns (slot, first_token,
        done). Raises when no slot is free or the request cannot fit.
        Chunked mode only seeds the slot and returns ``(slot, None,
        False)``: the first token comes from a later :meth:`prefill_step`.
        """
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
    ) -> List[Tuple[int, Optional[int], bool]]:
        """Admit a burst of requests between folds; returns ``(slot,
        first_token, done)`` per request, in order. Every request is
        validated before any device state moves. Monolithic mode queues
        every admission on the device before the first token is read back;
        chunked mode walks the prefix cache, seeds and parks each slot and
        returns ``(slot, None, False)``."""
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
                (slot, r, prompt, P, n_new,
                 None if self.chunked else self.bucket_for(P),
                 -1 if eos is None else int(eos))
            )
        with torch.no_grad():
            if self.chunked:
                return [
                    self._admit_chunked(slot, r, prompt, P, n_new, eos)
                    for slot, r, prompt, P, n_new, _, eos in staged
                ]
            pending = []
            for slot, r, prompt, P, n_new, pb, eos in staged:
                tok = self._admit_one(slot, r, prompt, P, n_new, pb, eos)
                pending.append((slot, r, n_new, eos, tok))
                if self.tracer is not None:
                    self.tracer.event(
                        r["request_id"], _trace.SPAN_PREFILL,
                        attrs={"bucket": pb, "tokens": P, "slot": slot},
                    )
            toks = torch.cat([t for *_, t in pending]).tolist()
        out: List[Tuple[int, Optional[int], bool]] = []
        for (slot, r, n_new, eos, _), tok in zip(pending, toks):
            out.append((slot, tok, self._arm(slot, r["request_id"], n_new,
                                             eos, tok)))
        return out

    def _arm(self, slot: int, request_id: str, n_new: int, eos: int,
             tok: int) -> bool:
        """Host bookkeeping once a slot's first token is read; returns
        whether the request is done. Mirrors the device-side ``live``
        predicate: a request done at its first token never occupies the
        slot."""
        done = n_new == 1 or tok == eos
        if done:
            # Done at its first token: the slot never decodes, so its pages
            # go back now (the JAX engine keeps them until the slot's next
            # admission overwrites its page list).
            self._samples[slot] = False
            self._release_pages(slot)
        else:
            self._slots[slot] = SlotInfo(
                request_id=request_id,
                max_new_tokens=n_new,
                n_generated=1,
                eos_token=eos,
            )
        return done

    def _admit_one(self, slot, r, prompt, P, n_new, pb, eos) -> torch.Tensor:
        """The fused admission of one request, one dispatch of its
        bucket's program: bucketed prefill, cache write into the slot's rows
        [0, pb), the knobs, first-token sample and the slot's state write.
        Returns the first token on the device (a copy: the next admission's
        dispatch writes the program's output again)."""
        padded = torch.zeros((1, pb), dtype=torch.long)
        padded[0, :P] = torch.from_numpy(prompt)
        temp = float(r.get("temperature", 0.0))
        top_k, top_p = r.get("top_k"), r.get("top_p")
        pinned_copy(self._admit_prompt[:, :pb], padded)
        pinned_copy(self._admit_ints, torch.tensor(
            [slot, P, 0 if top_k is None else int(top_k), eos, n_new,
             seed64(r.get("seed", 0))]))
        pinned_copy(self._admit_floats, torch.tensor(
            [temp, 1.0 if top_p is None else float(top_p)]))
        self._samples[slot] = temp > 0.0
        self._programs[("admit", pb)]()
        return self._tok_out.clone()

    def _set_knobs(self, slot: int, temp: float, top_k: int, top_p: float,
                   eos: int, seed: int = 0) -> None:
        """The slot's sampling knobs, eos and seed, its draw counter at 0;
        the scalars ride the kernels as arguments (``fill_``): assigning a
        Python number copies it from pageable memory, which waits for the
        stream (a fold in flight included)."""
        self._temps[slot].fill_(temp)
        self._top_ps[slot].fill_(top_p)
        self._top_ks[slot].fill_(top_k)
        self._eos[slot].fill_(eos)
        self._seeds[slot].fill_(seed64(seed))
        self._ctrs[slot].fill_(0)
        self._samples[slot] = temp > 0.0

    def _admit_chunked(self, slot, r, prompt, P, n_new, eos):
        """Walk the prefix cache, pin and copy the matched blocks into the
        slot's rows (paged: alias the matched pages into its table and
        allocate the rest of its pages), park the slot inactive with
        ``pos`` at the first row not seeded (the only row an interleaved
        fold writes; the first chunk writes it again before reading it)
        and queue its state machine. Returns ``(slot, None, False)``."""
        matched_idxs, matched_tiers = self._match_prefix(prompt)
        matched = len(matched_idxs) * self.prefix_block
        if self.prefix_blocks:
            self.prefix_lookups += 1
            self.prefix_hit_tokens += matched
            self.prefix_prompt_tokens += P
        if self.paged:
            self._alloc_pages(slot, matched_idxs, P, n_new)
        else:
            for b in matched_idxs:
                self._pool_meta[b].refs += 1  # pinned until done or cancel
        temp = float(r.get("temperature", 0.0))
        top_k, top_p = r.get("top_k"), r.get("top_p")
        task = PrefillTask(
            request_id=r["request_id"],
            tokens=prompt,
            next=matched,
            max_new_tokens=n_new,
            eos_token=eos,
            temperature=temp,
            top_k=0 if top_k is None else int(top_k),
            top_p=1.0 if top_p is None else float(top_p),
            seed=int(r.get("seed", 0)),
            matched_tokens=matched,
            # Paged: the slot's page list holds the alias refs until
            # release, not the prefill task until its end.
            block_refs=[] if self.paged else list(matched_idxs),
        )
        self._park(slot, matched, task.temperature, task.top_k, task.top_p,
                   eos, task.seed)
        if self._hist is not None:
            # The whole prompt, matched prefix included (the pool holds no
            # tokens); each chunk heals its own rows again.
            self._hist_seed(slot, prompt)
        if not self.paged:
            for j, b in enumerate(matched_idxs):
                self._copy_block(b, slot, j * self.prefix_block, to_slot=True)
        if self.tracer is not None and matched:
            self.tracer.event(
                task.request_id, _trace.SPAN_PREFIX_SEED,
                attrs={
                    "tokens": matched,
                    "blocks": len(matched_idxs),
                    "slot": slot,
                    # Where each seeded block came from: a host or disk
                    # count means this admission paid a promotion.
                    "tiers": {t: matched_tiers.count(t) for t in TIERS},
                },
            )
        self._prefills[slot] = task
        return slot, None, False

    def _alloc_pages(self, slot: int, matched_idxs: List[int], P: int,
                     n_new: int) -> None:
        """Give a paged slot its pages for the request's whole life: the
        matched prefix pages aliased (refcount up, no copy) and the private
        rest (suffix and decode reserve) allocated now, so decode never
        runs out mid-request. Raises "out of KV pages" when they cannot all
        be had; the scheduler admits only when ``pages_available()``
        covers ``pages_for()``, so through it that never happens."""
        total = self.pages_for(P, n_new)
        avoid = set(matched_idxs)
        private: List[int] = []
        for _ in range(total - len(matched_idxs)):
            pg = self._pool_alloc(frozenset(avoid))
            if pg is None:
                break
            avoid.add(pg)
            private.append(pg)
        if len(matched_idxs) + len(private) < total:
            self._pool_free.extend(private)
            self.page_frees += len(private)
            raise RuntimeError(
                f"out of KV pages: request needs {total}, only "
                f"{len(matched_idxs) + len(private)} allocatable (check "
                "pages_available() before admitting)"
            )
        for b in matched_idxs:
            self._pool_meta[b].refs += 1
            self.page_alias_hits += 1
        for pg in private:
            self._pool_tick += 1
            self._pool_meta[pg] = _PoolBlock(digest=None, refs=1,
                                             stamp=self._pool_tick)
        pages = list(matched_idxs) + private
        self._slot_pages[slot] = pages
        self._slot_span[slot] = min(P + n_new, self.max_seq - 1) + 1
        self._table_write(slot, pages)

    def prefill_step(
        self, max_chunks: int = 1
    ) -> List[Tuple[int, PrefillTask, int, bool]]:
        """Advance up to ``max_chunks`` prefill chunks, round-robin across
        prefilling slots; returns ``(slot, task, first_token, done)`` for
        every prefill that completed (its final chunk sampled the first
        token and armed the slot for the next fold, or finished the
        request outright). The scheduler calls this between decode folds:
        the chunk-vs-fold interleave that keeps a long prompt from stalling
        resident decodes for its whole prefill."""
        out: List[Tuple[int, PrefillTask, int, bool]] = []
        budget = int(max_chunks)
        while budget > 0 and self._prefills:
            progressed = False
            for slot in sorted(self._prefills):
                if budget <= 0:
                    break
                task = self._prefills.get(slot)
                if task is None:  # completed earlier in this sweep
                    continue
                progressed = True
                budget -= 1
                tok = self._run_chunk(slot, task)
                if tok is None:
                    continue
                del self._prefills[slot]
                self._unref_blocks(task)
                # Insert the finished prompt's full blocks before any new
                # tenant can overwrite the slot's rows (decode writes only
                # at pos >= P, so the prompt rows stay intact).
                self._insert_prefix(slot, task.tokens)
                tok = int(tok)  # the one device-to-host read per admission
                done = self._arm(slot, task.request_id,
                                 task.max_new_tokens, task.eos_token, tok)
                out.append((slot, task, tok, done))
            if not progressed:
                break
        return out

    def _run_chunk(self, slot: int, task: PrefillTask) -> Optional[torch.Tensor]:
        """One chunk of one slot as a dispatch of its own: the row of
        :meth:`_chunk_row` through its chunk bucket's program, which runs
        ``models/gpt.py:piggyback_prefill``, the code a piggybacked chunk
        runs. A chunk before the final one leaves the slot parked at the
        next row; the final one returns the first token on the device (the
        slot armed), else None."""
        row = self._chunk_row(slot, task)
        cb = self._chunk_bucket_for(row.length)
        self._chunk_rows[cb].fill([row])
        self._programs[("chunk", cb)]()
        self._trace_chunk(task, row)
        return self._tok_out.clone() if row.final else None

    def _trace_chunk(self, task: PrefillTask, row: ChunkRow,
                     piggyback: bool = False) -> None:
        if self.tracer is None:
            return
        attrs = {
            "index": task.chunks - 1,
            "tokens": row.length,
            "start": row.start,
            "slot": row.slot,
            "final": row.final,
        }
        if piggyback:
            attrs["piggyback"] = True
        self.tracer.event(task.request_id, _trace.SPAN_PREFILL_CHUNK,
                          attrs=attrs)

    def _chunk_row(self, slot: int, task: PrefillTask) -> ChunkRow:
        """The task's next chunk as a ``ChunkRow``: the next
        ``prefill_chunk`` prompt tokens; on the final chunk the request's
        budget and eos. Advances the task past the chunk."""
        P = len(task.tokens)
        start = task.next
        n = min(self.prefill_chunk, P - start)
        task.next += n
        task.chunks += 1
        return ChunkRow(
            slot=slot, tokens=task.tokens[start : start + n], start=start,
            length=n, final=task.next >= P, n_new=task.max_new_tokens,
            eos=task.eos_token,
        )

    def _cache_args(self) -> Tuple[Tuple[torch.Tensor, torch.Tensor],
                                   Dict[str, Any]]:
        """The caches a fold or a chunk writes, and its paging keywords:
        the pools and the page table when paged, else the slot strips."""
        if self.paged:
            return (self._pool_k, self._pool_v), dict(
                page_table=self._table, page_size=self.kv_page)
        return (self._k, self._v), {}

    def release(self, slot: int) -> None:
        """Evict a slot (cancelled, or host-observed finished); it is
        reusable at once. Its stale cache rows are invisible behind the
        slot masks and are overwritten by the next tenant. A slot released
        mid-prefill drops its state machine and unpins its prefix blocks.
        The device-side deactivation queues after any fold in flight, whose
        tokens for this tenant the harvest drops (``SlotInfo.released``)."""
        task = self._prefills.pop(slot, None)
        if task is not None:
            self._unref_blocks(task)
        else:
            info = self._slots[slot]
            if info is None:
                return
            info.released = True
        self._slots[slot] = None
        self._release_pages(slot)
        self._park(slot)

    def _release_synced(self, slot: int, info: SlotInfo) -> None:
        """A completion the fold saw: it froze the slot on the device at
        exactly this token, so only host bookkeeping and the pages remain
        (a frozen slot writes at its last position; the table reset sends
        that to scratch)."""
        info.released = True
        self._slots[slot] = None
        self._samples[slot] = False
        self._release_pages(slot)

    def _park(self, slot: int, pos: int = 0, temp: float = 0.0,
              top_k: int = 0, top_p: float = 1.0, eos: int = -1,
              seed: int = 0) -> None:
        """The slot inactive on the device at ``pos``, with these knobs and
        seed: a chunked admission's parking write (with the request's
        knobs) and a release's deactivation (the defaults)."""
        self._cur[slot].fill_(0)
        self._pos[slot].fill_(pos)
        self._active[slot].fill_(False)
        self._remaining[slot].fill_(0)
        self._set_knobs(slot, temp, top_k, top_p, eos, seed)

    # -- prefix pool -----------------------------------------------------
    def _block_digests(self, tokens: np.ndarray) -> List[bytes]:
        """Chained digests of the prompt's full blocks: digest i commits
        to tokens[0:(i+1)*bs], so block i can only hit behind its exact
        prefix chain. The same bytes as the JAX engine's (int32 tokens)."""
        bs = self.prefix_block
        out: List[bytes] = []
        d = b""
        for i in range(len(tokens) // bs):
            d = hashlib.blake2b(
                d + np.asarray(
                    tokens[i * bs : (i + 1) * bs], np.int32
                ).tobytes(),
                digest_size=16,
            ).digest()
            out.append(d)
        return out

    def _match_prefix(self, tokens: np.ndarray) -> Tuple[List[int], List[str]]:
        """Longest cached prefix walk across all tiers: device-pool hits
        are free; host and disk hits are promoted back into the pool
        first. Returns the pool block indices and the tier each came from,
        capped so the final chunk always runs (the first token needs the
        last prompt position's hidden state, which no tier stores). Blocks
        matched earlier in the walk are shielded from eviction by a later
        promotion."""
        if not self.prefix_blocks:
            return [], []
        matched: List[int] = []
        tiers: List[str] = []
        tc = self.tier_counters
        for d in self._block_digests(tokens):
            idx = self._pool_map.get(d)
            tier = "device"
            if idx is not None:
                tc["device"]["hits"] += 1
            else:
                tc["device"]["misses"] += 1
                tier = None
                if self._host_budget:
                    if d in self._host_map:
                        tc["host"]["hits"] += 1
                        tier = "host"
                    else:
                        tc["host"]["misses"] += 1
                if tier is None and self._disk_budget:
                    if d in self._disk_map:
                        tc["disk"]["hits"] += 1
                        tier = "disk"
                    else:
                        tc["disk"]["misses"] += 1
                if tier is None:
                    break
                idx = self._promote(d, tier, frozenset(matched))
                if idx is None:
                    # No allocatable block (all pinned) or an unreadable
                    # disk entry: the rest is prefilled uncached.
                    break
            matched.append(idx)
            tiers.append(tier)
        while matched and len(matched) * self.prefix_block >= len(tokens):
            matched.pop()
            tiers.pop()
        for idx in matched:
            self._pool_tick += 1
            self._pool_meta[idx].stamp = self._pool_tick
        return matched, tiers

    def _pool_alloc(self, avoid: frozenset = frozenset()) -> Optional[int]:
        """A free pool block, else the least recently used unpinned one,
        whose contents spill one tier down when tiers are on; None when
        every block is pinned or in ``avoid``."""
        if self._pool_free:
            self.page_allocs += 1
            return self._pool_free.pop()
        victim = None
        for i, m in enumerate(self._pool_meta):
            if m is None or m.refs > 0 or i in avoid:
                continue
            if victim is None or m.stamp < self._pool_meta[victim].stamp:
                victim = i
        if victim is None:
            return None
        vm = self._pool_meta[victim]
        if self._tiered:
            self._spill_block(victim, vm.digest)
        else:
            self._note_dropped(vm.digest)
        del self._pool_map[vm.digest]
        self._pool_meta[victim] = None
        self.prefix_evictions += 1
        self.tier_counters["device"]["evictions"] += 1
        if self.events is not None:
            self.events.record(
                "engine", "prefix_evict", block=victim,
                evictions=self.prefix_evictions, spilled=self._tiered,
            )
        # An evicted-and-reused page is one free plus one alloc in the page
        # ledger (allocs - frees = live pages stays an invariant).
        self.page_frees += 1
        self.page_allocs += 1
        return victim

    def _insert_prefix(self, slot: int, tokens: np.ndarray) -> None:
        """Insert the freshly prefilled prompt's full blocks (slot rows ->
        pool). Chain-ordered: stop at the first block that cannot be
        allocated, since a later block without its ancestors can never be
        matched. Paged: no copy, the slot's own prompt pages take their
        digests (see :meth:`_register_pages`)."""
        if not self.prefix_blocks:
            return
        if self.paged:
            self._register_pages(slot, tokens)
            return
        bs = self.prefix_block
        for i, d in enumerate(self._block_digests(tokens)):
            idx = self._pool_map.get(d)
            if idx is not None:
                self._pool_tick += 1
                self._pool_meta[idx].stamp = self._pool_tick
                continue
            idx = self._pool_alloc()
            if idx is None:
                break
            self._copy_block(idx, slot, i * bs, to_slot=False)
            self._pool_tick += 1
            self._pool_map[d] = idx
            self._pool_meta[idx] = _PoolBlock(
                digest=d, refs=0, stamp=self._pool_tick
            )
            self.prefix_inserts += 1
            # A fresh device copy supersedes a spilled copy of the same
            # digest (the same bytes): dropping it keeps the budgets honest.
            if self._tiered:
                self._host_map.pop(d, None)
                if d in self._disk_map:
                    self._disk_drop(d)

    def _register_pages(self, slot: int, tokens: np.ndarray) -> None:
        """Paged insertion: the slot's prompt pages hold the bytes a pool
        insert would copy, so they gain digests in the pool map, become
        shareable at once and outlive the slot's release as evictable
        cache pages."""
        pages = self._slot_pages[slot]
        for i, d in enumerate(self._block_digests(tokens)):
            existing = self._pool_map.get(d)
            if existing is not None:
                # The alias this slot was admitted with, or the page of a
                # twin prefill that finished first (ours stays private and
                # dies at release).
                self._pool_tick += 1
                self._pool_meta[existing].stamp = self._pool_tick
                continue
            meta = self._pool_meta[pages[i]]
            if meta is None or meta.digest is not None:
                continue
            self._pool_tick += 1
            meta.digest = d
            meta.stamp = self._pool_tick
            self._pool_map[d] = pages[i]
            self.prefix_inserts += 1
            # A fresh device page supersedes a spilled copy of the same
            # digest (the same bytes): dropping it keeps the budgets honest.
            if self._tiered:
                self._host_map.pop(d, None)
                if d in self._disk_map:
                    self._disk_drop(d)

    def _copy_block(self, block: int, slot: int, row: int,
                    to_slot: bool) -> None:
        """Pool block -> slot rows ``[row, row + prefix_block)`` when
        ``to_slot`` (seeding a prefix hit), slot rows -> pool block
        otherwise (insertion)."""
        rows = slice(row, row + self.prefix_block)
        if to_slot:
            self._k[:, slot, rows] = self._pool_k[:, block]
            self._v[:, slot, rows] = self._pool_v[:, block]
        else:
            self._pool_k[:, block] = self._k[:, slot, rows]
            self._pool_v[:, block] = self._v[:, slot, rows]

    def _unref_blocks(self, task: PrefillTask) -> None:
        for b in task.block_refs:
            meta = self._pool_meta[b]
            if meta is not None:
                meta.refs -= 1
        task.block_refs = []

    # -- spill tiers (host RAM + disk) -----------------------------------
    def _spill_block(self, victim: int, digest: bytes) -> None:
        """Copy the evicted block to the host (a sync, off the decode hot
        path: eviction only happens at admission and insertion) and push
        it one tier down: host RAM, else disk."""
        k = self._pool_k[:, victim : victim + 1].to("cpu", copy=True)
        v = self._pool_v[:, victim : victim + 1].to("cpu", copy=True)
        self.tier_counters["device"]["spills"] += 1
        if self._host_budget:
            self._host_insert(digest, k, v)
        else:
            self._disk_insert(digest, k, v)

    def _host_bytes(self) -> int:
        return len(self._host_map) * self._blk_nbytes

    def _host_insert(self, digest: bytes, k: torch.Tensor,
                     v: torch.Tensor) -> None:
        """Insert one spilled block into the host tier, pushing the oldest
        blocks down to disk (or dropping them) until the byte budget holds:
        the tier is never over budget."""
        self._host_map.pop(digest, None)
        if self._blk_nbytes > self._host_budget:
            # A block the tier can never hold goes straight down.
            if self._disk_budget:
                self.tier_counters["host"]["spills"] += 1
                self._disk_insert(digest, k, v)
            else:
                self.tier_counters["host"]["evictions"] += 1
                self._store_sink(digest, k, v)
                self._note_dropped(digest)
            return
        while self._host_map and (
            self._host_bytes() + self._blk_nbytes > self._host_budget
        ):
            old_d, (ok, ov) = self._host_map.popitem(last=False)
            if self._disk_budget:
                self.tier_counters["host"]["spills"] += 1
                self._disk_insert(old_d, ok, ov)
            else:
                self.tier_counters["host"]["evictions"] += 1
                self._store_sink(old_d, ok, ov)
                self._note_dropped(old_d)
        self._host_map[digest] = (k, v)

    def _disk_paths(self, digest: bytes) -> Tuple[str, str, str]:
        hexd = digest.hex()
        return tuple(
            os.path.join(self._disk_dir, f"{hexd}.{part}.npy")
            for part in ("keys", "k", "v")
        )

    def _disk_prune_stale(self) -> None:
        """Start the disk tier empty: block files left by an earlier engine
        are removed, not adopted, so pool decisions depend on the op
        stream alone."""
        for name in os.listdir(self._disk_dir):
            if name.endswith((".keys.npy", ".k.npy", ".v.npy")):
                try:
                    os.remove(os.path.join(self._disk_dir, name))
                except OSError:
                    pass

    def _disk_insert(self, digest: bytes, k: torch.Tensor,
                     v: torch.Tensor) -> None:
        """Write one block to the disk tier (atomic per file: tmp +
        rename), then hold the byte budget on the measured file sizes:
        oldest entries drop first, and the tier is never over budget.

        The JAX engine's file form: ``keys`` (1, 5, 2) int64, the block's
        (start, stop) per dim (this rank's heads under a model split: one
        shard of the JAX form), and K and V as (1, L, 1, block, Hkv,
        hd * itemsize) uint8, the bytes of the compute dtype (numpy has no
        bfloat16; the load views them back)."""
        if not self._disk_budget:
            return
        if digest in self._disk_map:
            self._disk_map.move_to_end(digest)
            return
        keys = np.asarray([self._blk_keys], np.int64)
        parts = [t[None].contiguous().view(torch.uint8).numpy() for t in (k, v)]
        size = 0
        paths = self._disk_paths(digest)
        try:
            for path, arr in zip(paths, [keys] + parts):
                tmp = path + ".tmp"
                with open(tmp, "wb") as f:
                    np.save(f, arr)
                os.replace(tmp, path)
                size += os.path.getsize(path)
        except OSError:
            # Best-effort tier: a full or failing disk drops the block
            # (after a write to the object store).
            self._remove_files(paths)
            self.tier_counters["disk"]["evictions"] += 1
            self._store_sink(digest, k, v)
            self._note_dropped(digest)
            return
        while self._disk_map and self._disk_bytes + size > self._disk_budget:
            oldest = next(iter(self._disk_map))
            if self.kvstore_dir:
                # The bottom of the local walk holds the only copy: read
                # the victim back before its files go.
                payload = self._disk_load(oldest)
                if payload is not None:
                    self._store_sink(oldest, payload[0], payload[1])
            self._disk_drop(oldest)
            self.tier_counters["disk"]["evictions"] += 1
            self._note_dropped(oldest)
        if self._disk_bytes + size > self._disk_budget:
            # One block alone exceeds the whole budget.
            self._remove_files(paths)
            self.tier_counters["disk"]["evictions"] += 1
            self._store_sink(digest, k, v)
            self._note_dropped(digest)
            return
        self._disk_map[digest] = size
        self._disk_bytes += size

    @staticmethod
    def _remove_files(paths: Sequence[str]) -> None:
        for path in paths:
            try:
                os.remove(path)
            except OSError:
                pass

    def _disk_drop(self, digest: bytes) -> None:
        self._disk_bytes -= self._disk_map.pop(digest, 0)
        self._remove_files(self._disk_paths(digest))

    def _disk_load(self, digest: bytes) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """Read one block back (memory-mapped); an unreadable entry is
        dropped and reported as a failed promotion, never raised on the
        admission path."""
        kpath, kfile, vfile = self._disk_paths(digest)
        try:
            np.load(kpath)
            out = []
            for path in (kfile, vfile):
                raw = np.array(np.load(path, mmap_mode="r")[0])
                t = torch.from_numpy(raw).view(self._blk_dtype)
                if tuple(t.shape) != self._blk_shape:
                    raise ValueError(f"block of shape {tuple(t.shape)}")
                out.append(t)
            return out[0], out[1]
        except (OSError, ValueError, RuntimeError):
            self._disk_drop(digest)
            self._note_dropped(digest)
            return None

    def _promote(self, digest: bytes, tier: str,
                 avoid: frozenset) -> Optional[int]:
        """Move one cold-tier block back into the device pool; returns its
        pool index, or None when no block can be allocated (every block
        pinned) or the disk entry is unreadable."""
        # Take the payload before allocating: the allocation's spill
        # cascade can push this digest out of the host map. On failure it
        # goes back as the tier's newest entry.
        if tier == "host":
            payload = self._host_map.pop(digest, None)
        else:
            payload = self._disk_load(digest)
        if payload is None:
            return None
        idx = self._pool_alloc(avoid)
        if idx is None:
            if tier == "host":
                self._host_map[digest] = payload
            elif digest in self._disk_map:
                self._disk_map.move_to_end(digest)
            return None
        t0 = time.monotonic()
        k, v = payload
        self._pool_k[:, idx : idx + 1] = k.to(self.device)
        self._pool_v[:, idx : idx + 1] = v.to(self.device)
        if tier != "host":
            self._disk_drop(digest)
        self._pool_tick += 1
        self._pool_map[digest] = idx
        self._pool_meta[idx] = _PoolBlock(
            digest=digest, refs=0, stamp=self._pool_tick
        )
        self.tier_counters[tier]["promotions"] += 1
        self.refill_s += time.monotonic() - t0
        return idx

    def _store_sink(self, digest: bytes, k: torch.Tensor,
                    v: torch.Tensor) -> None:
        """The tier of last resort: a block falling off the bottom of the
        local tier walk is written to the object store, when there is
        one. A failed write counts in the store's ``write_errors`` and
        the drop goes on: pages are lost loudly, never silently."""
        if not self.kvstore_dir:
            return
        if self._tp is not None:
            k, v = self._gather_heads([k, v])
        if self.kvstore is not None:
            self.kvstore.put_block(digest.hex(), k, v)

    # -- cross-replica prefix handoff (drain, fleet KV plane) ------------
    def _note_dropped(self, digest: bytes) -> None:
        """A digest left every tier (nowhere to spill, the disk budget, an
        unreadable entry, an evicted chain): noted for the fleet
        directory's eviction feed."""
        self.kv_dropped_total += 1
        self._dropped_ring.append(digest.hex())

    def dropped_digests(self) -> List[str]:
        """Recent fully dropped digest hexes (a bounded ring, not drained:
        several consumers may read it)."""
        return list(self._dropped_ring)

    @property
    def prefix_block_nbytes(self) -> int:
        """Logical bytes of one pool block or page (K + V)."""
        return int(self._blk_nbytes) if self.prefix_blocks else 0

    def evict_prefix_chain(self, digests_hex: Sequence[str]) -> int:
        """Free a chain's blocks from every local tier (the caller has
        persisted them). A pool block frees only when unreferenced (a
        resident request's pins win); freed digests are noted as dropped.
        Returns the blocks freed across all tiers."""
        freed = 0
        for hexd in digests_hex:
            try:
                digest = bytes.fromhex(hexd)
            except (ValueError, TypeError):
                continue
            dropped = False
            idx = self._pool_map.get(digest) if self.prefix_blocks else None
            if idx is not None:
                meta = self._pool_meta[idx]
                if meta is not None and meta.refs == 0:
                    del self._pool_map[digest]
                    self._pool_meta[idx] = None
                    self._pool_free.append(idx)
                    self.page_frees += 1
                    self.prefix_evictions += 1
                    self.tier_counters["device"]["evictions"] += 1
                    dropped = True
            if self._host_map.pop(digest, None) is not None:
                self.tier_counters["host"]["evictions"] += 1
                dropped = True
            if digest in self._disk_map:
                self._disk_drop(digest)
                self.tier_counters["disk"]["evictions"] += 1
                dropped = True
            if dropped:
                self._note_dropped(digest)
                freed += 1
        return freed

    def cached_prefix_blocks(self, tokens: Sequence[int]) -> int:
        """How many leading full blocks of ``tokens`` some local tier
        holds: a host-side probe (no promotion, no refcounts, no
        counters), capped as the admission walk is, so the final chunk's
        block never counts. The fleet KV plane fetches only when a hint
        promises more than this."""
        if not self.prefix_blocks:
            return 0
        matched = 0
        for d in self._block_digests(np.asarray(tokens, np.int32)):
            if d in self._pool_map or d in self._host_map or d in self._disk_map:
                matched += 1
            else:
                break
        while matched and matched * self.prefix_block >= len(tokens):
            matched -= 1
        return matched

    def _export_block(self, digest: bytes) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """One block's host copy from whichever tier holds it (a device
        block is copied out, as a spill does; a split engine's stays on
        the card for its gather), else None."""
        idx = self._pool_map.get(digest)
        if idx is not None:
            if self._tp is not None:
                return (self._pool_k[:, idx : idx + 1],
                        self._pool_v[:, idx : idx + 1])
            return (self._pool_k[:, idx : idx + 1].to("cpu", copy=True),
                    self._pool_v[:, idx : idx + 1].to("cpu", copy=True))
        if digest in self._host_map:
            return self._host_map[digest]
        if digest in self._disk_map:
            return self._disk_load(digest)
        return None

    def export_blocks_by_digest(
        self, digests_hex: Sequence[str]
    ) -> List[Tuple[str, torch.Tensor, torch.Tensor]]:
        """Serialize a digest chain (the wire form of
        :meth:`export_prefix_blocks`, addressed by digests): chain order,
        stopping at the first digest no tier holds. A split engine
        gathers every rank's heads of the chain's blocks (a collective of
        the model group; the ranks keep the chain all of them hold), so
        its blocks are whole, as an unsplit engine's are."""
        if not self.prefix_blocks:
            return []
        out: List[Tuple[str, torch.Tensor, torch.Tensor]] = []
        for hexd in digests_hex:
            try:
                d = bytes.fromhex(hexd)
            except ValueError:
                break
            block = self._export_block(d)
            if block is None:
                break
            out.append((hexd, *block))
        if self._tp is not None:
            held = self._gather_bytes([torch.tensor([len(out)])])
            out = out[:int(held.view(torch.int64).min())]
            if out:
                whole = self._gather_heads(
                    [k for _, k, _ in out] + [v for _, _, v in out])
                n = len(out)
                out = [(hexd, whole[i], whole[n + i])
                       for i, (hexd, _, _) in enumerate(out)]
        self.prefix_handoff_exports += len(out)
        return out

    def export_prefix_blocks(
        self, tokens: Sequence[int]
    ) -> List[Tuple[str, torch.Tensor, torch.Tensor]]:
        """Serialize the cached prefix of ``tokens`` for a peer engine:
        ``[(digest_hex, k, v), ...]`` in chain order, stopping at the
        first block no tier holds (a later block without its ancestors can
        never be matched). ``k`` and ``v`` are CPU tensors of one block,
        (L, 1, block, Hkv, hd) in the compute dtype, the host tier's form.
        Read-only: every tier keeps its copy. A device block's copy waits
        for the stream (a fold in flight included), outside any dispatch."""
        if not self.prefix_blocks:
            return []
        return self.export_blocks_by_digest(
            [d.hex() for d in self._block_digests(np.asarray(tokens, np.int64))]
        )

    def import_prefix_blocks(
        self, blocks: Sequence[Tuple[str, Any, Any]]
    ) -> int:
        """Accept a peer's serialized prefix blocks (chain order, the
        :meth:`export_prefix_blocks` form) into the device pool, so a
        migrated request's admission walk hits warm. A block the pool holds
        is touched (LRU), not rewritten; with no allocatable block it lands
        in the host tier, and with no host tier the chain stops. On a paged
        engine each import takes a page from the allocator as an
        unreferenced cache page (``page_allocs`` counts it). The writes
        are plain copies into the pool's buffers, queued on the stream
        behind any fold in flight: no graph, no wait for the card. Returns
        the blocks accepted. A split engine keeps this rank's heads of
        each whole block."""
        if not self.prefix_blocks:
            return 0
        accepted = 0
        for hexd, kp, vp in blocks:
            d = bytes.fromhex(hexd)
            idx = self._pool_map.get(d)
            if idx is not None:
                self._pool_tick += 1
                self._pool_meta[idx].stamp = self._pool_tick
                accepted += 1
                continue
            k = self._own_heads(kp, self._blk_shape)
            v = self._own_heads(vp, self._blk_shape)
            idx = self._pool_alloc()
            if idx is None:
                if self._host_budget:
                    self._host_insert(d, k.cpu(), v.cpu())
                    accepted += 1
                    self.prefix_handoff_imports += 1
                    continue
                break
            self._pool_k[:, idx : idx + 1] = host_to(k, self.device)
            self._pool_v[:, idx : idx + 1] = host_to(v, self.device)
            self._pool_tick += 1
            self._pool_map[d] = idx
            self._pool_meta[idx] = _PoolBlock(
                digest=d, refs=0, stamp=self._pool_tick
            )
            # An imported device copy supersedes a colder local copy.
            if self._tiered:
                self._host_map.pop(d, None)
                if d in self._disk_map:
                    self._disk_drop(d)
            accepted += 1
            self.prefix_handoff_imports += 1
        if accepted and self.events is not None:
            self.events.record(
                "engine", "prefix_handoff_import", blocks=accepted,
            )
        return accepted

    def import_prefix_block_layer(self, hexd: str, kp: Any, vp: Any,
                                  layer: int, n_layers: int) -> bool:
        """Accept one layer of a peer's prefix block (a layer-wise ship):
        the block stages into a pool block that carries no digest and a
        pin, so no prefix walk can match it and no eviction can take it,
        and gains its digest only when the last layer lands: a
        half-shipped block never serves a hit. Layers must come in order
        (the sender streams them so); a gap aborts the staging and
        returns False. True when the layer was taken, including for a
        block the pool already holds (the rest of its stream is then a
        no-op).

        The layer write is a plain copy into the pool's buffers, queued
        on the stream like :meth:`import_prefix_blocks`'s, not a graph:
        its shape never changes and it runs between dispatches, so a
        capture would add pool memory and nothing else, and the graph
        plan (``dispatch_plan``, ``compiled_count``) stays the one the
        dispatches need. A split engine keeps this rank's heads of the
        whole layer."""
        if not self.prefix_blocks:
            return False
        d = bytes.fromhex(hexd)
        resident = self._pool_map.get(d)
        if resident is not None:
            # Already keyed (an alias, a local prefill that finished
            # first, an earlier import): touch it, swallow the stream and
            # drop any half-staged twin so its pin cannot leak.
            self._pool_tick += 1
            self._pool_meta[resident].stamp = self._pool_tick
            if d in self._layer_imports:
                self.abort_layer_imports([hexd])
            return True
        st = self._layer_imports.get(d)
        if st is None:
            if layer != 0:
                return False
            idx = self._pool_alloc()
            if idx is None:
                return False
            self._pool_tick += 1
            self._pool_meta[idx] = _PoolBlock(
                digest=None, refs=1, stamp=self._pool_tick
            )
            st = {"idx": idx, "next": 0, "n": int(n_layers)}
            self._layer_imports[d] = st
        if layer != st["next"]:
            self.abort_layer_imports([hexd])
            return False
        shape = (1,) + self._blk_shape[1:]
        k = self._own_heads(kp, shape)
        v = self._own_heads(vp, shape)
        idx = st["idx"]
        self._pool_k[layer : layer + 1, idx : idx + 1] = host_to(k, self.device)
        self._pool_v[layer : layer + 1, idx : idx + 1] = host_to(v, self.device)
        st["next"] += 1
        if st["next"] < st["n"]:
            return True
        # The last layer: the block takes its digest and becomes
        # matchable and evictable at once, as a whole-block import does.
        meta = self._pool_meta[idx]
        meta.digest = d
        meta.refs = 0
        self._pool_map[d] = idx
        if self._tiered:
            self._host_map.pop(d, None)
            if d in self._disk_map:
                self._disk_drop(d)
        del self._layer_imports[d]
        self.layer_block_imports += 1
        self.prefix_handoff_imports += 1
        return True

    def abort_layer_imports(self, digests_hex: Sequence[str]) -> None:
        """Tear down half-staged layer imports (the sender died, a layer
        came out of order, the deadline passed): their pinned blocks go
        back to the free list. None was ever matchable."""
        for hexd in digests_hex:
            st = self._layer_imports.pop(bytes.fromhex(hexd), None)
            if st is None:
                continue
            idx = st["idx"]
            self._pool_meta[idx] = None
            self._pool_free.append(idx)
            self.page_frees += 1
            self.layer_import_aborts += 1

    def _pool_used(self) -> int:
        """Occupied pool blocks (paged: pages, less the scratch page and
        the quarantine, which hold nothing live)."""
        used = self.prefix_blocks - len(self._pool_free)
        if self.paged:
            used -= 1 + len(self._quarantine)
        return max(0, used)

    # -- paged KV --------------------------------------------------------
    def _table_write(self, slot: int, pages: Sequence[int]) -> None:
        """One slot's page-table row: ``pages`` first, the scratch page
        (0) after them."""
        row = torch.zeros(self._table.shape[1], dtype=torch.long)
        row[: len(pages)] = torch.as_tensor(list(pages), dtype=torch.long)
        self._table[slot] = host_to(row, self.device)

    def pages_for(self, prompt_len: int, max_new_tokens: int) -> int:
        """Pages one request needs for its whole life: the prompt, every
        generated token and the frozen slot's last (masked) write at
        ``min(P + new, S - 1)``. Admission reserves them all up front."""
        last = min(prompt_len + max_new_tokens, self.max_seq - 1)
        return last // self.kv_page + 1

    def free_pages(self) -> int:
        """Pages allocatable at once (the free list)."""
        return len(self._pool_free)

    def pages_available(self) -> int:
        """Allocatable pages: the free list plus the evictable cache pages
        (digest-keyed, unreferenced: the LRU victims an allocation may
        spill or drop). Quarantined pages are not counted."""
        evictable = sum(
            1 for m in self._pool_meta
            if m is not None and m.refs == 0 and m.digest is not None
        )
        return len(self._pool_free) + evictable

    def _flush_quarantine(self) -> None:
        """Recycle the quarantined private pages. Call only when no fold
        dispatched before their slots' table resets can still write them:
        at release with no fold in flight, or at the top of a harvest,
        after its wait."""
        if self._quarantine:
            self._pool_free.extend(self._quarantine)
            self._quarantine = []

    def _release_pages(self, slot: int) -> None:
        """Drop one slot's claim on its pages (paged mode): each page's
        refcount falls; a private page that reaches zero goes to the
        quarantine, a digest-keyed one stays resident as evictable cache.
        The slot's table row is reset to scratch, so no later fold writes
        its old pages; a fold already in flight may, so the quarantine
        waits for its harvest."""
        if not self.paged:
            return
        pages = self._slot_pages[slot]
        self._slot_pages[slot] = []
        self._slot_span[slot] = 0
        for pg in pages:
            m = self._pool_meta[pg]
            if m is None:
                continue
            m.refs -= 1
            if m.refs <= 0 and m.digest is None:
                self._pool_meta[pg] = None
                self._quarantine.append(pg)
                self.page_frees += 1
        self._table_write(slot, ())
        if self._inflight is None:
            self._flush_quarantine()

    def kv_page_counters(self) -> Dict[str, int]:
        """Cumulative page-allocator counters (the scheduler diffs them)."""
        return {
            "allocs": self.page_allocs,
            "frees": self.page_frees,
            "alias_hits": self.page_alias_hits,
        }

    def kv_page_stats(self) -> Dict[str, Any]:
        """The ``kv_pages`` block: pages by state (free, resident, aliased),
        the token budget, occupancy, and fragmentation: tokens inside
        allocated pages that no position of their slot's span can use."""
        usable = self.kv_pages - 1  # less the scratch page
        aliased = sum(1 for m in self._pool_meta if m is not None and m.refs > 1)
        allocated = sum(1 for m in self._pool_meta if m is not None)
        frag = sum(
            len(self._slot_pages[b]) * self.kv_page - self._slot_span[b]
            for b in range(self.num_slots) if self._slot_span[b]
        )
        return {
            "page_size": self.kv_page,
            "pages_total": usable,
            "token_budget": usable * self.kv_page,
            "free": len(self._pool_free) + len(self._quarantine),
            "resident": allocated - aliased,
            "aliased": aliased,
            "occupancy": round(allocated / usable, 4) if usable else 0.0,
            "fragmentation_tokens": frag,
            **self.kv_page_counters(),
        }

    # -- speculative decoding --------------------------------------------
    def _hist_seed(self, slot: int, prompt: np.ndarray) -> None:
        """The slot's token history rows [0, P) from its prompt."""
        self._hist[slot, : len(prompt)] = host_to(
            torch.from_numpy(np.asarray(prompt, np.int64)), self.device
        )

    def _draft(self, hist: torch.Tensor, pos: torch.Tensor,
               cur: torch.Tensor) -> torch.Tensor:
        """The configured drafter's (B, spec_depth) proposals."""
        if self.spec == "ngram":
            return ngram_propose(hist, pos, cur, depth=self.spec_depth)
        return model_propose(
            self._spec_params, self._spec_cfg, hist, pos, cur,
            depth=self.spec_depth, window=self.spec_window,
        )

    def spec_stats(self) -> Dict[str, Any]:
        """Speculative-decoding counters: accept_rate = accepted draft
        tokens / proposed ones, in [0, 1]; tokens_per_verify = emitted
        tokens per (verify, slot), in [1, spec_depth + 1]."""
        v, d = self.spec_verifies, self.spec_drafted_tokens
        return {
            "mode": self.spec,
            "depth": self.spec_depth,
            "verifies": v,
            "drafted_tokens": d,
            "accepted_tokens": self.spec_accepted_tokens,
            "emitted_tokens": self.spec_emitted_tokens,
            "accept_rate": (
                round(self.spec_accepted_tokens / d, 4) if d else 0.0
            ),
            "tokens_per_verify": (
                round(self.spec_emitted_tokens / v, 4) if v else 0.0
            ),
        }

    def prefix_stats(self) -> Dict[str, Any]:
        """Pool counters; with a pool, the per-tier breakdown, and with
        tiers on, the cumulative refill seconds."""
        out: Dict[str, Any] = {
            "lookups": self.prefix_lookups,
            "hit_tokens": self.prefix_hit_tokens,
            "prompt_tokens": self.prefix_prompt_tokens,
            "inserts": self.prefix_inserts,
            "evictions": self.prefix_evictions,
            "blocks_used": self._pool_used(),
            "blocks_total": self.prefix_blocks,
        }
        if self.prefix_blocks:
            out["tiers"] = self.prefix_tier_stats()
        if self._tiered:
            out["refill_s"] = self.refill_s
        return out

    def prefix_tier_stats(self) -> Dict[str, Dict[str, int]]:
        """Per-tier cumulative counters plus resident and budget bytes
        (the device always; host and disk when budgeted)."""
        out = {}
        for tier, nbytes in self.prefix_tier_bytes().items():
            out[tier] = {
                **self.tier_counters[tier],
                "bytes": nbytes,
                "budget_bytes": {
                    "device": self.prefix_blocks * self._blk_nbytes,
                    "host": self._host_budget,
                    "disk": self._disk_budget,
                }[tier],
            }
        return out

    def prefix_tier_counters(self) -> Dict[str, Dict[str, int]]:
        """Cumulative per-tier event counters (all three tiers, zeros for
        disabled ones): the scheduler diffs consecutive snapshots."""
        return {t: dict(c) for t, c in self.tier_counters.items()}

    def prefix_tier_bytes(self) -> Dict[str, int]:
        """Resident bytes per enabled tier."""
        out = {"device": self._pool_used() * self._blk_nbytes}
        if self._host_budget:
            out["host"] = self._host_bytes()
        if self._disk_budget:
            out["disk"] = self._disk_bytes
        return out

    # -- the hot loop ----------------------------------------------------
    def _pick_fold_k(self) -> int:
        """This dispatch's fold depth from the ladder, a function of the
        host bookkeeping alone (``serve/engine.py:3218`` of the JAX
        package): the shallowest rung while prefills wait (piggybacked or
        interleaved chunks then come round as often as possible), else the
        deepest rung no longer than the largest remaining budget of a
        resident (a deeper fold would run frozen iterations)."""
        ladder = self.fold_ladder
        if len(ladder) == 1 or self._prefills:
            return ladder[0]
        runway = max(
            (info.max_new_tokens - info.n_generated for info in self._slots
             if info is not None and not info.released),
            default=0,
        )
        return max([k for k in ladder if k <= runway], default=ladder[0])

    def _plan_piggyback(
        self,
    ) -> Tuple[List[ChunkRow], List[_Final], List[Tuple[int, np.ndarray]]]:
        """The chunk rows of one fused dispatch: up to ``piggyback_chunks``,
        one per prefilling slot in slot order (``prefill_step``'s order).
        The host bookkeeping advances now: each task steps past its chunk,
        and a final leaves ``_prefills`` with its slot armed (a SlotInfo),
        so a fold dispatched before this one's harvest carries the tenant;
        only its first token waits for the harvest. Returns the rows, the
        finals and the prefix insertions to make once the fold is queued
        (a dense pool copy must read the chunk's rows)."""
        rows: List[ChunkRow] = []
        finals: List[_Final] = []
        inserts: List[Tuple[int, np.ndarray]] = []
        for slot in sorted(self._prefills):
            if len(rows) >= self.piggyback_chunks:
                break
            task = self._prefills[slot]
            row = self._chunk_row(slot, task)
            self._trace_chunk(task, row, piggyback=True)
            if row.final:
                del self._prefills[slot]
                self._unref_blocks(task)
                inserts.append((slot, task.tokens))
                info = SlotInfo(
                    request_id=task.request_id,
                    max_new_tokens=task.max_new_tokens,
                    n_generated=1,
                    eos_token=task.eos_token,
                )
                self._slots[slot] = info
                finals.append((len(rows), slot, task, info))
            rows.append(row)
        return rows, finals, inserts

    def _dispatch(self) -> _Fold:
        """Queue one fold on the stream: the rung's program in its greedy
        or sampling variant, with the planned chunk rows written into its
        row block first, then a non-blocking copy of its packed output into
        the next host buffer, behind which an event is recorded. The fold
        writes the slot state in place, so a later admission or release
        writes after it. Nothing in it waits for the card."""
        k = self._pick_fold_k()
        self.fold_dispatches[k] += 1
        self._m_fold_depth.observe(float(k))
        finals: List[_Final] = []
        inserts: List[Tuple[int, np.ndarray]] = []
        if self.piggyback_chunks:
            rows, finals, inserts = self._plan_piggyback()
            if rows:
                self.piggyback_dispatches += 1
                self.piggyback_chunk_rows += len(rows)
                self._m_pb_dispatches.inc()
                self._m_pb_rows.inc(float(len(rows)))
            self._pb_rows.fill(rows)
        self._programs[self._fold_key(k, any(self._samples))]()
        R = k * (self.spec_depth + 1 if self.spec != "off" else 1)
        n = 2 * R + (1 if self.piggyback_chunks else 0)
        buf = self._host_bufs[self._buf_next][:n]
        self._buf_next ^= 1
        buf.copy_(self._fold_out[:n], non_blocking=True)
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        for slot, tokens in inserts:
            self._insert_prefix(slot, tokens)
        return _Fold(buf=buf, event=event, rows=R, snapshot=list(self._slots),
                     finals=finals, k=k)

    # -- the dispatch programs ---------------------------------------------
    def _fold_key(self, k: int, sampling: bool) -> tuple:
        kind = ("paged" if self.paged else "dense") + "-" + (
            "plain" if self.spec == "off" else self.spec)
        return ("fold", k, kind, bool(sampling))

    def _plan(self) -> Tuple[tuple, ...]:
        """The engine's dispatch programs, the JAX engine's executables one
        for one: ``("fold", rung, kind, sampling)`` for every ladder rung in
        both variants (``_step_exec``), ``("chunk", bucket)`` for every
        chunk bucket in chunked mode (``_chunk_exec``), and ``("admit",
        bucket)`` for every prompt bucket in monolithic mode
        (``_admit_exec``)."""
        plan = [self._fold_key(k, s) for k in self.fold_ladder
                for s in (False, True)]
        if self.chunked:
            plan += [("chunk", cb) for cb in self.chunk_buckets]
        else:
            plan += [("admit", pb) for pb in self.prefill_buckets]
        return tuple(plan)

    def _build_programs(self, graphs: bool) -> None:
        """One :class:`Program` per key of the plan; on the card (unless
        ``graphs`` is off) each is captured now, into one graph pool, and
        the slot state the captures' warm-up runs wrote is reset.
        ``compiled_count`` is the number of graphs, ``capture_s`` their
        capture seconds and ``graph_bytes`` the device memory the pool
        reserved. A model split captures only on an NCCL group, after one
        all-reduce on it (an NCCL communicator must have run a collective
        before a graph can capture one); on gloo, whose collectives stage
        through the host, the bodies run eagerly and :attr:`graphed` says
        so."""
        capture = graphs and self.device.type == "cuda" and (
            self._tp is None or self.mesh.backend == "nccl")
        if capture and self._tp is not None:
            import torch.distributed as dist

            dist.all_reduce(torch.ones(1, device=self.device), group=self._tp)
        #: Whether the dispatches replay CUDA graphs.
        self.graphed = capture
        pool = torch.cuda.graph_pool_handle() if capture else None
        t0 = time.monotonic()
        reserved = self._reserved() if capture else 0
        self._programs: Dict[tuple, Program] = {}
        with torch.no_grad():
            for key in self.dispatch_plan:
                self._programs[key] = Program(self._body(key), capture, pool)
            if capture:
                self._reset_state()
        self.graph_bytes = self._reserved() - reserved if capture else 0
        self.capture_s = time.monotonic() - t0 if capture else 0.0
        #: Graphs captured; frozen after construction (the JAX engine's
        #: compile count): no dispatch captures anything.
        self.compiled_count = sum(
            p.graph is not None for p in self._programs.values())

    def _reserved(self) -> int:
        """Device bytes the caching allocator holds once every free cached
        block is released: what live tensors and graph pools keep (the
        garbage collected first, as each capture does)."""
        gc.collect()
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        return torch.cuda.memory_reserved(self.device)

    def _reset_state(self) -> None:
        """Every slot empty, as constructed (after the warm-up runs)."""
        for t, v in ((self._cur, 0), (self._pos, 0), (self._temps, 0.0),
                     (self._top_ks, 0), (self._top_ps, 1.0),
                     (self._active, False), (self._remaining, 0),
                     (self._eos, -1), (self._seeds, 0), (self._ctrs, 0),
                     (self._fold_out, 0), (self._tok_out, 0)):
            t.fill_(v)
        for t in (self._hist, self._k, self._v, self._pool_k, self._pool_v):
            if t is not None:
                t.zero_()

    def _body(self, key: tuple):
        if key[0] == "fold":
            return lambda: self._fold_body(key[1], key[3])
        if key[0] == "chunk":
            return lambda: self._chunk_body(key[1])
        return lambda: self._admit_body(key[1])

    def _state(self) -> tuple:
        return (self._cur, self._pos, self._seeds, self._ctrs, self._temps,
                self._top_ks, self._top_ps, self._active, self._remaining,
                self._eos)

    def _fold_body(self, k: int, sampling: bool) -> None:
        """One fold: the rung's iterations, then the chunk row block; the
        slot state copied back in place and the packed output written."""
        caches, paging = self._cache_args()
        pb = self._pb_rows
        if self.spec == "off":
            out = gpt_decode_fold(
                self.params, self.cfg, *self._state(), *caches, fold=k,
                sampling=sampling, piggyback=pb, mesh=self.mesh, **paging,
            )
            new = out[2:7]
        else:
            out = gpt_decode_fold_spec(
                self.params, self.cfg, *self._state(), self._hist, *caches,
                fold=k, depth=self.spec_depth, draft_fn=self._draft,
                sampling=sampling, piggyback=pb, mesh=self.mesh, **paging,
            )
            new = out[2:8]
            self._hist.copy_(out[7])
        for dst, src in zip((self._cur, self._pos, self._ctrs, self._active,
                             self._remaining), new):
            dst.copy_(src)
        tok, emit = out[0], out[1]
        R = tok.shape[0]
        self._fold_out[:R] = tok
        self._fold_out[R : 2 * R] = emit.long()
        if pb is not None:
            self._fold_out[2 * R].fill_(-1)
            self._fold_out[2 * R, : self.piggyback_chunks] = out[-1]

    def _chunk_body(self, cb: int) -> None:
        """One separate chunk: its one row through ``piggyback_prefill``,
        which writes the slot state in place; the first token out."""
        caches, paging = self._cache_args()
        tok = piggyback_prefill(
            self.params, self.cfg, self._chunk_rows[cb], self._cur,
            self._pos, self._ctrs, self._active, self._remaining, self._temps,
            self._top_ks, self._top_ps, self._seeds, *caches, hist=self._hist,
            mesh=self.mesh, **paging,
        )
        self._tok_out.copy_(tok)

    def _admit_body(self, pb: int) -> None:
        """One fused admission at prompt bucket ``pb``: the prefill (flash
        K1 per layer), the slot's cache rows, its knobs, the first token
        (draw 0 of its seed) and its state, all indexed by device values."""
        prompt = self._admit_prompt[:, :pb]
        ints, floats = self._admit_ints, self._admit_floats
        slot, P = ints[0:1], ints[1:2]
        h, pf_k, pf_v = gpt_prefill(self.params, self.cfg, prompt,
                                    mesh=self.mesh)
        self._k[:, slot, :pb] = pf_k
        self._v[:, slot, :pb] = pf_v
        self._temps.index_copy_(0, slot, floats[0:1])
        self._top_ps.index_copy_(0, slot, floats[1:2])
        self._top_ks.index_copy_(0, slot, ints[2:3])
        self._eos.index_copy_(0, slot, ints[3:4])
        self._seeds.index_copy_(0, slot, ints[5:6])
        if self._hist is not None:
            # The fold writes the first token itself (hist[pos] = cur).
            cols = torch.arange(self.max_seq, device=prompt.device)
            src = prompt[0].index_select(0, cols.clamp(max=pb - 1))
            self._hist.index_copy_(0, slot, torch.where(
                cols < P, src, self._hist.index_select(0, slot)[0])[None])
        h_last = h.index_select(1, (P - 1).clamp(min=0))
        tok = first_token(
            self.params, self.cfg, h_last, floats[0:1], ints[2:3],
            floats[1:2], ints[5:6], torch.zeros_like(slot), mesh=self.mesh,
        )
        n_new, eos = ints[4:5], ints[3:4]
        self._cur.index_copy_(0, slot, tok)
        self._pos.index_copy_(0, slot, P)
        self._active.index_copy_(0, slot, (n_new > 1) & (tok != eos))
        self._remaining.index_copy_(0, slot, n_new - 1)
        self._ctrs.index_copy_(0, slot, torch.ones_like(slot))
        self._tok_out.copy_(tok)

    def _want_next(self, snapshot: List[Optional[SlotInfo]], k: int) -> bool:
        """Whether to queue fold N+1 before harvesting fold N: while
        piggybacked prefills wait (each fused dispatch advances them), or
        while some occupied slot can outlive fold N by token count (fold N
        emits at least ``k`` tokens for each slot of its snapshot; with
        spec on, at least one per verify). An EOS inside fold N can still
        leave fold N+1 idle: its frozen slots emit nothing."""
        if self.piggyback_chunks and self._prefills:
            return True
        for slot, info in enumerate(self._slots):
            if info is None:
                continue
            consumed = k if snapshot[slot] is info else 0
            if info.max_new_tokens - info.n_generated > consumed:
                return True
        return False

    def step(self) -> List[Tuple[int, str, int, bool]]:
        """One fold boundary: queue a fold (with ``pipeline``, the next one
        too, before reading this one) and fan out its tokens: up to
        ``k`` per decoding slot for the dispatch's rung ``k`` (with spec, up
        to ``spec_depth + 1`` per fold iteration), in order; returns
        ``(slot, request_id, token, done)`` per emitted token. Finished
        slots are released before returning. Parked (prefilling) slots are
        inactive: the fold emits nothing for them. Piggybacked prefill
        completions are read with :meth:`pop_chunk_events` after this."""
        if self._inflight is None:
            # Only decoding residents, or with piggyback on pending chunks,
            # warrant a fold.
            if not any(s is not None for s in self._slots) and not (
                self.piggyback_chunks and self._prefills
            ):
                return []
            self._inflight = self._dispatch()
        fold = self._inflight
        self._inflight = (
            self._dispatch()
            if self.pipeline and self._want_next(fold.snapshot, fold.k)
            else None
        )
        return self._harvest(fold)

    def pop_chunk_events(self) -> List[Tuple[int, PrefillTask, int, bool]]:
        """The piggybacked prefill completions of the last harvest, as
        ``(slot, task, first_token, done)`` like :meth:`prefill_step`'s;
        the buffer is replaced at each harvest that has any."""
        out = self._pb_events
        self._pb_events = []
        return out

    def _harvest(self, fold: _Fold) -> List[Tuple[int, str, int, bool]]:
        # The one wait per fold: its token block's copy, not the fold
        # queued behind it.
        if fold.event is not None:
            fold.event.synchronize()
        block = fold.buf.numpy()
        R = fold.rows
        toks, emits = block[:R], block[R : 2 * R].astype(bool)
        # Every fold dispatched up to this one has finished: pages
        # quarantined before this harvest can be recycled. Those released
        # below wait for the next one, since a fold may be in flight.
        self._flush_quarantine()
        out: List[Tuple[int, str, int, bool]] = []
        spec_on = self.spec != "off"
        #: (fold iteration, slot) -> tokens that verify emitted (spec on);
        #: a released tenant's tokens are neither emitted nor counted.
        counts: Dict[Tuple[int, int], int] = {}
        for kk in range(R):
            for slot, info in enumerate(fold.snapshot):
                # The device froze a finished slot on the same condition
                # the host tests below, so it emits nothing after `done`.
                if info is None or info.released or not emits[kk, slot]:
                    continue
                tok = int(toks[kk, slot])
                info.n_generated += 1
                done = (
                    info.n_generated >= info.max_new_tokens
                    or tok == info.eos_token
                )
                out.append((slot, info.request_id, tok, done))
                if spec_on:
                    key = (kk // (self.spec_depth + 1), slot)
                    counts[key] = counts.get(key, 0) + 1
                if done:
                    self._release_synced(slot, info)
        if counts:
            # Per (verify, slot): spec_depth drafted, all but the last
            # emitted token accepted (the last is the verify's own sample:
            # a mismatch, the bonus token or an EOS).
            self.spec_verifies += len(counts)
            self.spec_drafted_tokens += self.spec_depth * len(counts)
            self.spec_emitted_tokens += sum(counts.values())
            self.spec_accepted_tokens += sum(m - 1 for m in counts.values())
        if fold.finals:
            events: List[Tuple[int, PrefillTask, int, bool]] = []
            for r, slot, task, info in fold.finals:
                if info.released:
                    # A cancel raced the dispatch: the release tore the slot
                    # down and its deactivation queued after the fold.
                    continue
                tok = int(block[2 * R, r])
                done = task.max_new_tokens == 1 or tok == task.eos_token
                if done:
                    self._release_synced(slot, info)
                events.append((slot, task, tok, done))
            self._pb_events = events
        return out
