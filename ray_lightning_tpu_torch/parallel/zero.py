"""ZeRO-style sharding rules for parameter and optimizer-state trees (the
port of ``ray_lightning_tpu/parallel/zero.py``).

The JAX package annotates each leaf with a ``NamedSharding`` that splits
its largest divisible axis over the mesh's ``"data"`` axis and lets XLA
emit the gathers. Here the same rule picks the dim a leaf is split along
(:func:`shard_dim_for`), each rank keeps its slice of that dim (a
:class:`Split`: one axis, or data x fsdp together), and the gathers are
explicit ``torch.distributed`` all-gathers (:meth:`Split.gather_into`,
:func:`gather_full`, :func:`gather_to_host`).

ZeRO-3's step gathers layer by layer (:class:`LayerGather`), as XLA
places the gather of each layer's parameters inside the JAX package's
layer scan: a stacked block leaf's row ``li`` is gathered just before
block ``li`` runs, the other leaves where they are read, and each is
gathered again in the backward instead of being kept; each layer's
gradient is reduced into this rank's slice as the backward leaves it.
"""
from __future__ import annotations

import time
import weakref
from collections import OrderedDict
from collections.abc import Mapping
from dataclasses import dataclass, replace
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from ray_lightning_tpu_torch.utils.tree import tree_leaves, tree_map


def shard_dim_for(shape: Sequence[int], world: int) -> Optional[int]:
    """The dim to split a leaf of ``shape`` along over ``world`` ranks:
    the largest dim divisible by ``world`` and at least ``world`` long
    (the first such on a tie), or None (replicated: scalars, and leaves
    with no such dim) — the rule of JAX ``shard_spec_for``."""
    best_dim: Optional[int] = None
    best_size = 0
    for dim, size in enumerate(shape):
        if size % world == 0 and size > best_size and size >= world:
            best_dim = dim
            best_size = size
    return best_dim


def tree_shard_dims(tree: Any, world: int) -> Any:
    """A tree mirroring ``tree`` with each leaf's :func:`shard_dim_for`."""
    return tree_map(lambda x: shard_dim_for(tuple(x.shape), world), tree)


def gather_full(shard: torch.Tensor, dim: Optional[int], world: int,
                group: Any = None) -> torch.Tensor:
    """A new full tensor from every rank's ``shard``, split along ``dim``
    over ``group``'s ``world`` ranks (a collective; ``shard`` itself when
    ``dim`` is None)."""
    if dim is None:
        return shard
    return Split((dim,), (world,), (0,), group).gather(shard)


def gather_to_host(shards: Any, dims: Any, world: int,
                   group: Any = None) -> Any:
    """All-gather a tree of slices (split as ``dims`` says) over ``group``
    into a tree of full CPU tensors: the checkpoint path of sharded state.
    Every rank of the group must call it."""
    dim_leaves = iter(tree_leaves(dims))
    return tree_map(
        lambda x: gather_full(x, next(dim_leaves), world, group)
        .detach().cpu(),
        shards)


def sharded_bytes_fraction(tree: Any, dims: Any) -> float:
    """Fraction of the tree's elements in leaves that are split (the
    diagnostic of JAX ``sharded_bytes_fraction``, which counts elements
    too)."""
    total = sharded = 0
    for leaf, dim in zip(tree_leaves(tree), tree_leaves(dims)):
        n = 1
        for s in tuple(leaf.shape):
            n *= int(s)
        total += n
        if dim is not None:
            sharded += n
    return sharded / total if total else 0.0


# -- splits over one or two mesh axes ---------------------------------------


@dataclass(frozen=True)
class Split:
    """How the ranks of ``group`` (None: the world) hold a tensor: along
    ``dims[j]`` in ``sizes[j]`` equal blocks, this rank holding block
    ``index[j]``. The group's ranks ascend with the blocks in row-major
    order over ``sizes`` (one axis, or ``"data"`` then ``"fsdp"``, the
    rank order of the mesh's ``"dp"`` group). ``axes`` names the mesh axis
    of each dim (a checkpoint's piece spec)."""

    dims: Tuple[int, ...]
    sizes: Tuple[int, ...]
    index: Tuple[int, ...]
    group: Any = None
    axes: Tuple[str, ...] = ("data",)

    @property
    def world(self) -> int:
        n = 1
        for s in self.sizes:
            n *= int(s)
        return n

    def row(self) -> "Split":
        """The split of one row of a stacked leaf (no dim 0 split)."""
        return replace(self, dims=tuple(d - 1 for d in self.dims))

    def shard(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``full`` (a view)."""
        for d, n, i in zip(self.dims, self.sizes, self.index):
            size = full.shape[d] // n
            full = full.narrow(d, i * size, size)
        return full

    def full_shape(self, shard_shape: Sequence[int]) -> Tuple[int, ...]:
        shape = list(shard_shape)
        for d, n in zip(self.dims, self.sizes):
            shape[d] *= n
        return tuple(shape)

    @torch.no_grad()
    def gather_into(self, full: torch.Tensor, shard: torch.Tensor) -> None:
        """Every rank's block into ``full``, in place (a collective)."""
        from ray_lightning_tpu_torch.parallel.mesh import all_gather

        shard = shard.contiguous()
        shape = tuple(shard.shape)
        if self.dims == (0,) and full.is_contiguous():
            all_gather(full, shard, self.group)
            return
        buf = torch.empty((self.world * shape[0],) + shape[1:],
                          dtype=shard.dtype, device=shard.device)
        all_gather(buf, shard, self.group)
        k = len(self.sizes)
        perm: List[int] = []
        for d in range(len(shape)):
            if d in self.dims:
                perm.append(self.dims.index(d))
            perm.append(k + d)
        full.copy_(buf.view(tuple(self.sizes) + shape).permute(perm)
                   .reshape(full.shape))

    def gather(self, shard: torch.Tensor) -> torch.Tensor:
        """A new full tensor from every rank's block (a collective)."""
        full = torch.empty(self.full_shape(shard.shape), dtype=shard.dtype,
                           device=shard.device)
        self.gather_into(full, shard)
        return full


def _reduce_scatter(out: torch.Tensor, inp: torch.Tensor, group: Any) -> None:
    import torch.distributed as dist

    # As with the all-gather, torch 2.13 adds a new name for the
    # collective that earlier releases call reduce_scatter_tensor.
    fn = (getattr(dist, "reduce_scatter_single", None)
          or dist.reduce_scatter_tensor)
    fn(out, inp, group=group)


def blocks_first(g: torch.Tensor, split: "Split") -> torch.Tensor:
    """``g`` (split along one dim) with its blocks stacked along a new
    leading dim in group-rank order, the other dims in their order: the
    input of a reduce-scatter, which hands rank ``r`` block ``r``."""
    d, n = split.dims[0], split.world
    return g.unflatten(d, (n, g.shape[d] // n)).movedim(d, 0).contiguous()


@torch.no_grad()
def reduce_to_shard(g: torch.Tensor, split: "Split", group: Any,
                    size: int) -> torch.Tensor:
    """This rank's block of the mean of ``g`` over the ``size`` ranks of
    ``group`` (None: the world), a new contiguous fp32 tensor: a
    reduce-scatter on NCCL where ``split`` spans the whole group along one
    dim, else (gloo has no reduce-scatter) an all-reduce and the block.
    The sum and then the divide, as data parallelism's gradient mean."""
    import torch.distributed as dist

    # A copy: autograd's gradient is not written in place.
    g = g.to(torch.float32, copy=True)
    if size > 1 and (g.is_cuda and dist.get_backend(group) == "nccl"
                     and split.world == size and len(split.dims) == 1):
        inp = blocks_first(g, split)
        out = torch.empty(inp.shape[1:], dtype=g.dtype, device=g.device)
        _reduce_scatter(out.view(-1), inp.view(-1), group)
        out.div_(float(size))
        return out
    if size > 1:
        dist.all_reduce(g, group=group)
        g.div_(float(size))
    return split.shard(g).contiguous()


# -- ZeRO-3's per-layer gathers -----------------------------------------------


class _Token:
    """A saved tensor that was a gathered parameter (or a view of one),
    held as where to gather it again."""

    __slots__ = ("key", "j", "shape", "stride", "offset")

    def __init__(self, key: tuple, j: int, t: torch.Tensor) -> None:
        self.key, self.j = key, j
        self.shape, self.stride = tuple(t.shape), tuple(t.stride())
        self.offset = t.storage_offset()


class _Gather(torch.autograd.Function):
    """The gather of one layer's rows (or of one whole leaf): the forward
    gathers and casts; the backward reduces the gradients into this rank's
    slices (:meth:`LayerGather._reduce`) and hands the anchor a zero, so
    no gradient of a full leaf ever reaches autograd."""

    @staticmethod
    def forward(ctx, anchor: torch.Tensor, step: "LayerGather",
                key: tuple) -> Tuple[torch.Tensor, ...]:
        ctx.step, ctx.key = step, key
        return step._gather(key)

    @staticmethod
    def backward(ctx, *grads: torch.Tensor):
        ctx.step._reduce(ctx.key, grads)
        return grads[0].new_zeros((), dtype=torch.float32), None, None


class _Blocks(Mapping):
    """The step's view of a stacked ``blocks`` dict: :meth:`layer` gathers
    one layer's rows; an item is the storage-less full leaf (its shape
    only: reading its values fails loudly)."""

    def __init__(self, tree: Dict[str, Any], step: "LayerGather") -> None:
        self._tree, self._step = tree, step

    def __getitem__(self, k: str) -> Any:
        return self._tree[k]

    def __contains__(self, k: object) -> bool:
        return k in self._tree

    def __iter__(self) -> Iterator[str]:
        return iter(self._tree)

    def __len__(self) -> int:
        return len(self._tree)

    def layer(self, li: int) -> Dict[str, torch.Tensor]:
        return self._step.layer(self._tree, li)


class _View(Mapping):
    """The step's view of a parameter tree: each read of a leaf gathers it
    (cast to the step's compute dtype); ``"blocks"`` is a :class:`_Blocks`."""

    def __init__(self, tree: Dict[str, Any], step: "LayerGather") -> None:
        self._tree, self._step = tree, step

    def __getitem__(self, k: str) -> Any:
        v = self._tree[k]
        if isinstance(v, dict):
            return (_Blocks(v, self._step) if k == "blocks"
                    else _View(v, self._step))
        return self._step.leaf(v)

    def __contains__(self, k: object) -> bool:
        return k in self._tree

    def __iter__(self) -> Iterator[str]:
        return iter(self._tree)

    def __len__(self) -> int:
        return len(self._tree)


def layer_of(blocks: Any, li: int) -> Optional[Dict[str, torch.Tensor]]:
    """Layer ``li`` gathered from a ZeRO-3 step's blocks view, or None
    for a plain dict (the model indexes it itself)."""
    return blocks.layer(li) if isinstance(blocks, _Blocks) else None


@dataclass
class GatherStats:
    """A ZeRO-3 optimizer's per-layer traffic since its creation: layer
    rows and whole leaves gathered in the forwards (``gathers``) and again
    in the backwards (``regathers``), the gradients reduced into slices
    (``reductions``), the most layers whose gathered rows were alive at
    once (``peak_layers``) and, on gloo, the host seconds of the gathers
    and reductions (each timed from a device sync to its return; on NCCL,
    queued on the stream or captured in a graph, they are counted only)."""

    gathers: int = 0
    regathers: int = 0
    reductions: int = 0
    peak_layers: int = 0
    gather_s: float = 0.0
    reduce_s: float = 0.0


class LayerGather:
    """One micro-batch of a ZeRO-3 step: the parameter view the module's
    forward reads (:meth:`view`), the saved-tensor hooks that drop each
    gathered parameter and gather it again in the backward (:meth:`hooks`),
    and the backward that returns this rank's reduced slices
    (:meth:`backward`).

    ``opt`` is the sharded optimizer (``leaves``, ``shards``, ``splits``,
    the reduction group and size); ``cdt`` the compute dtype the step's
    floating parameters are cast to after the gather (None: as stored).
    Block rows are gathered as one :class:`_Gather` per layer; a leaf
    outside the blocks, each time it is read. A gradient of a block row
    is reduced as the backward leaves its layer; the reads of another
    leaf are summed in the compute dtype (as autograd sums the uses of one
    cast leaf) and reduced once the backward is done. At most two layers'
    gathered rows are alive at once: the layer running and the next one
    gathered (forward) or cached (backward)."""

    def __init__(self, opt: Any, cdt: Optional[torch.dtype]) -> None:
        self.opt = opt
        self.cdt = cdt
        self.stats: GatherStats = opt.gather_stats
        device = opt.leaves[0].device
        self.anchor = torch.zeros((), device=device, requires_grad=True)
        self.grads: Dict[int, torch.Tensor] = {}
        self._top: Dict[int, torch.Tensor] = {}
        self._whole: Dict[int, torch.Tensor] = {}
        self._rows: "OrderedDict[int, Tuple[torch.Tensor, ...]]" = OrderedDict()
        self._live: Dict[int, int] = {}

    # -- the forward's reads ----------------------------------------------
    def view(self, params: Dict[str, Any]) -> _View:
        return _View(params, self)

    def hooks(self) -> Any:
        return torch.autograd.graph.saved_tensors_hooks(self._pack,
                                                        self._unpack)

    def _cast(self, t: torch.Tensor) -> torch.Tensor:
        if self.cdt is not None and torch.is_floating_point(t):
            return t.to(self.cdt)
        return t

    def _tag(self, outs: Sequence[torch.Tensor], key: tuple) -> None:
        for j, o in enumerate(outs):
            o._zero_tag = (self, key, j)
        if key[0] == "row":
            li = key[1]
            self._live[li] = self._live.get(li, 0) + len(outs)
            for o in outs:
                weakref.finalize(o, self._dead, li)
            self.stats.peak_layers = max(self.stats.peak_layers,
                                         len(self._live))

    def _dead(self, li: int) -> None:
        n = self._live.get(li, 0) - 1
        if n > 0:
            self._live[li] = n
        else:
            self._live.pop(li, None)

    def leaf(self, t: torch.Tensor) -> torch.Tensor:
        """A leaf outside the blocks (or a block leaf split along its layer
        dim), gathered for this read."""
        i = self.opt.index_of(t)
        if self.opt.splits[i] is None:
            # One cast per step, as the whole tree's cast gives every read
            # of a leaf the same copy (its uses' gradients then sum in the
            # compute dtype).
            if i not in self._whole:
                self._whole[i] = self._cast(t)
            return self._whole[i]
        key = ("leaf", i)
        (out,) = _Gather.apply(self.anchor, self, key)
        self._tag((out,), key)
        self.stats.gathers += 1
        return out

    def layer(self, blocks: Dict[str, Any], li: int) -> Dict[str, Any]:
        """Row ``li`` of every stacked block leaf: the split ones gathered
        (one :class:`_Gather`), the others indexed."""
        out: Dict[str, Any] = {}
        idx = []
        for k, t in blocks.items():
            i = self.opt.index_of(t)
            split = self.opt.splits[i]
            if split is None:
                out[k] = self.leaf(t)[li]
            elif 0 in split.dims:
                out[k] = self.leaf(t)[li]
            else:
                idx.append((k, i))
        if idx:
            key = ("row", li, tuple(i for _, i in idx))
            rows = _Gather.apply(self.anchor, self, key)
            self._tag(rows, key)
            self.stats.gathers += 1
            out.update({k: r for (k, _), r in zip(idx, rows)})
        return {k: out[k] for k in blocks}

    # -- the collectives ------------------------------------------------------
    def _timed(self, t: torch.Tensor) -> bool:
        import torch.distributed as dist

        group = self.opt.reduce_group
        if not dist.is_initialized() or dist.get_backend(group) != "gloo":
            return False
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
        return True

    @torch.no_grad()
    def _gather(self, key: tuple) -> Tuple[torch.Tensor, ...]:
        opt = self.opt
        ids = (key[1],) if key[0] == "leaf" else key[2]
        timed = self._timed(opt.shards[ids[0]])
        t0 = time.perf_counter()
        outs = []
        for i in ids:
            split, shard = opt.splits[i], opt.shards[i]
            if key[0] == "row":
                split, shard = split.row(), shard[key[1]]
            outs.append(self._cast(split.gather(shard)))
        if timed:
            self.stats.gather_s += time.perf_counter() - t0
        return tuple(outs)

    def _reduce(self, key: tuple, grads: Sequence[torch.Tensor]) -> None:
        opt = self.opt
        if key[0] == "leaf":
            i = key[1]
            prev = self._top.get(i)
            self._top[i] = grads[0] if prev is None else prev + grads[0]
            return
        li = key[1]
        timed = self._timed(grads[0])
        t0 = time.perf_counter()
        for i, g in zip(key[2], grads):
            split = opt.splits[i]
            part = reduce_to_shard(g, split.row(), opt.reduce_group,
                                   opt.reduce_size)
            buf = self.grads.get(i)
            if buf is None:
                buf = self.grads[i] = torch.empty(
                    opt.shards[i].shape, dtype=torch.float32,
                    device=part.device)
            buf[li].copy_(part)
        self.stats.reductions += 1
        if timed:
            self.stats.reduce_s += time.perf_counter() - t0
        self._rows.pop(li, None)

    # -- saved tensors ---------------------------------------------------------
    def _pack(self, t: torch.Tensor) -> Any:
        base = t if t._base is None else t._base
        tag = getattr(base, "_zero_tag", None)
        if tag is None or tag[0] is not self:
            return t
        return _Token(tag[1], tag[2], t)

    def _unpack(self, x: Any) -> torch.Tensor:
        if not isinstance(x, _Token):
            return x
        key = x.key
        if key[0] == "row":
            outs = self._rows.get(key[1])
            if outs is None:
                outs = self._gather(key)
                self._tag(outs, key)
                self.stats.regathers += 1
                self._rows[key[1]] = outs
                while len(self._rows) > 2:
                    self._rows.popitem(last=False)
        else:
            outs = self._gather(key)
            self.stats.regathers += 1
        return outs[x.j].as_strided(x.shape, x.stride, x.offset)

    # -- the backward ------------------------------------------------------------
    def backward(self, loss: torch.Tensor) -> List[torch.Tensor]:
        """The gradient of every leaf: this rank's reduced slice of each
        split leaf, the unreduced whole gradient of each other one."""
        opt = self.opt
        whole = [i for i, s in enumerate(opt.splits) if s is None]
        got = torch.autograd.grad(
            loss, [self.anchor] + [opt.leaves[i] for i in whole],
            allow_unused=True)
        self._rows.clear()
        timed = bool(self._top) and self._timed(next(iter(
            self._top.values())))
        t0 = time.perf_counter()
        for i, g in sorted(self._top.items()):
            self.grads[i] = reduce_to_shard(g, opt.splits[i],
                                            opt.reduce_group, opt.reduce_size)
            self.stats.reductions += 1
        if timed:
            self.stats.reduce_s += time.perf_counter() - t0
        self._top.clear()
        self._whole.clear()
        out: List[Optional[torch.Tensor]] = [None] * len(opt.leaves)
        for i, g in zip(whole, got[1:]):
            out[i] = g if g is not None else torch.zeros_like(opt.leaves[i])
        for i, s in enumerate(opt.splits):
            if s is not None:
                if i not in self.grads:
                    raise RuntimeError(
                        f"ZeRO-3: leaf {i} of shape "
                        f"{tuple(opt.leaves[i].shape)} was not read by the "
                        "forward")
                out[i] = self.grads.pop(i)
        return out  # type: ignore[return-value]
