"""Sharded checkpoints: every rank writes its own slices, and a restore
reads whole leaves into any mesh (the port of
``ray_lightning_tpu/trainer/checkpoint_io.py``).

The state-stream checkpoint (``utils/state_stream.py``) gathers the whole
state onto rank 0. A sharded checkpoint has no gather: each rank writes
the tensors it holds at rest (its slices of the parameters and of their
optimizer state) with each one's placement, and the restore assembles
whole leaves from the pieces, whatever mesh wrote them, so the caller
places them on its own mesh, another world size included. The JAX
package writes through orbax; this is the port's own format, and nothing
reads a JAX checkpoint.

Layout of a sharded checkpoint directory::

    <path>/state/index.pt        rank 0: the state's skeleton (its tree,
                                 with each tensor replaced by its key) and
                                 the mesh that wrote it
    <path>/state/rank00003.pt    rank 3: {key: piece, its spec (per dim,
                                 the mesh axis it is split over), its
                                 block index on the split axes, the whole
                                 leaf's shape}
    <path>/meta.ckpt             rank 0's state stream: epoch, step,
                                 callbacks, resume_batch

A rank writes a piece only where it is the first holder of that block:
its coordinate is 0 on every mesh axis the piece is not split over, so
replicas write nothing twice. ``meta.ckpt`` is written last, after every
rank's file (a barrier): a directory without it is an unfinished save,
which the resume scan skips.
"""
from __future__ import annotations

import glob
import os
import shutil
import threading
import warnings
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from ray_lightning_tpu_torch.parallel.logical import block_index, unshard
from ray_lightning_tpu_torch.trainer.optim import PieceRef
from ray_lightning_tpu_torch.utils.state_stream import (
    load_state_stream,
    state_stream_to_file,
    to_state_stream,
)

_STATE_SUBDIR = "state"
_META_FILE = "meta.ckpt"
_INDEX_FILE = "index.pt"

#: ``(mesh axis sizes, this rank's coordinates)``.
Layout = Tuple[Dict[str, int], Dict[str, int]]


def is_sharded_checkpoint(path: str) -> bool:
    return os.path.isdir(os.path.join(path, _STATE_SUBDIR))


def _rank_of(coords: Dict[str, int], mesh_shape: Dict[str, int]) -> int:
    rank = 0
    for axis, size in mesh_shape.items():
        rank = rank * int(size) + int(coords.get(axis, 0))
    return rank


def _rank_pieces(pieces: Dict[str, Tuple[torch.Tensor, tuple]],
                 layout: Layout) -> Dict[str, Dict[str, Any]]:
    """The pieces this rank writes, as CPU copies with their placement."""
    mesh_shape, coords = layout
    out = {}
    for key, (t, spec) in pieces.items():
        if any(coords.get(axis, 0) for axis in mesh_shape
               if axis not in spec):
            continue  # another rank holds the same block
        full = [n * (int(mesh_shape.get(ax, 1)) if ax is not None else 1)
                for n, ax in zip(t.shape, spec)]
        out[key] = {"tensor": t.detach().cpu().clone(), "spec": tuple(spec),
                    "block": block_index(spec, coords, mesh_shape),
                    "full_shape": tuple(full)}
    return out


def _write(state_dir: str, rank: int, rank_pieces: Dict[str, Any],
           index: Optional[Dict[str, Any]]) -> None:
    state_stream_to_file(to_state_stream(rank_pieces),
                         os.path.join(state_dir, f"rank{rank:05d}.pt"))
    if index is not None:
        state_stream_to_file(to_state_stream(index),
                             os.path.join(state_dir, _INDEX_FILE))


def _fill(tree: Any, leaves: Dict[str, torch.Tensor]) -> Any:
    if isinstance(tree, PieceRef):
        return leaves[str(tree)]
    if isinstance(tree, dict):
        return {k: _fill(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_fill(v, leaves) for v in tree)
    return tree


def _refs(tree: Any) -> list:
    if isinstance(tree, PieceRef):
        return [str(tree)]
    if isinstance(tree, dict):
        return [k for v in tree.values() for k in _refs(v)]
    if isinstance(tree, (list, tuple)):
        return [k for v in tree for k in _refs(v)]
    return []


class ShardedCheckpointIO:
    """Synchronous sharded save and restore."""

    def _begin(self, path: str, is_rank_zero: bool,
               barrier: Callable[[], None]) -> str:
        """Unfinalize and empty a reused path (a rolling ``last``) before
        any rank writes: without its meta, a crash mid-write leaves a
        directory the resume scan skips, never new state under the
        previous save's progress."""
        path = os.path.abspath(path)
        state_dir = os.path.join(path, _STATE_SUBDIR)
        if is_rank_zero:
            try:
                os.remove(os.path.join(path, _META_FILE))
            except OSError:
                pass
            shutil.rmtree(state_dir, ignore_errors=True)
            os.makedirs(state_dir, exist_ok=True)
        barrier()
        return path

    def save(
        self,
        path: str,
        skeleton: Dict[str, Any],
        pieces: Dict[str, Tuple[torch.Tensor, tuple]],
        layout: Layout,
        meta: Dict[str, Any],
        is_rank_zero: bool = True,
        barrier: Callable[[], None] = lambda: None,
    ) -> None:
        """Write this rank's pieces of ``skeleton``'s tensors (every rank
        calls this: it holds barriers) and, on rank zero, the index and,
        once every rank has written, the meta stream."""
        path = self._begin(path, is_rank_zero, barrier)
        mesh_shape, coords = layout
        index = ({"skeleton": skeleton, "mesh_shape": dict(mesh_shape)}
                 if is_rank_zero else None)
        _write(os.path.join(path, _STATE_SUBDIR),
               _rank_of(coords, mesh_shape), _rank_pieces(pieces, layout),
               index)
        barrier()
        if is_rank_zero:
            state_stream_to_file(to_state_stream(meta),
                                 os.path.join(path, _META_FILE))

    def finalize(self, barrier: Callable[[], None] = lambda: None) -> None:
        """Nothing in flight for the synchronous IO."""

    def restore(
        self, path: str, partial: bool = False,
    ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """The whole state ``{"params": tree, "opt_state": ...}`` and the
        meta, from the pieces of any mesh. ``partial=True`` reads the
        parameters only (an eval's restore) and needs no meta."""
        path = os.path.abspath(path)
        state_dir = os.path.join(path, _STATE_SUBDIR)
        with open(os.path.join(state_dir, _INDEX_FILE), "rb") as f:
            index = load_state_stream(f.read())
        skeleton = index["skeleton"]
        if partial:
            skeleton = {"params": skeleton["params"]}
        want = set(_refs(skeleton))
        blocks: Dict[str, Dict[tuple, torch.Tensor]] = {}
        specs: Dict[str, tuple] = {}
        shapes: Dict[str, tuple] = {}
        for name in sorted(glob.glob(os.path.join(state_dir, "rank*.pt"))):
            with open(name, "rb") as f:
                part = load_state_stream(f.read())
            for key, piece in part.items():
                if key not in want:
                    continue
                blocks.setdefault(key, {})[piece["block"]] = piece["tensor"]
                specs[key] = piece["spec"]
                shapes[key] = piece["full_shape"]
        mesh_shape = index["mesh_shape"]

        def complete(key: str) -> bool:
            n = 1
            for axis in specs.get(key, ()):
                if axis is not None:
                    n *= int(mesh_shape.get(axis, 1))
            return key in blocks and len(blocks[key]) == n

        missing = sorted(k for k in want if not complete(k))
        if missing:
            raise ValueError(
                f"sharded checkpoint at {path} lacks pieces of "
                f"{missing[:3]}: a rank's file is missing")
        leaves = {}
        for key in want:
            full = unshard(blocks[key], specs[key], mesh_shape)
            if tuple(full.shape) != tuple(shapes[key]):
                raise ValueError(
                    f"sharded checkpoint at {path}: {key} assembles to "
                    f"{tuple(full.shape)}, expected {shapes[key]}")
            leaves[key] = full
        meta_path = os.path.join(path, _META_FILE)
        meta: Dict[str, Any] = {}
        if os.path.exists(meta_path):
            with open(meta_path, "rb") as f:
                meta = load_state_stream(f.read())
        elif not partial:
            warnings.warn(
                f"sharded checkpoint at {path} has no {_META_FILE}; "
                "epoch/global_step/callback progress will reset to 0 (an "
                "unfinished save, or a copy without its meta file)",
                stacklevel=2,
            )
        return _fill(skeleton, leaves), meta


class AsyncShardedCheckpointIO(ShardedCheckpointIO):
    """Sharded save that overlaps the file writes with training.

    :meth:`save` copies this rank's pieces to host memory and returns; a
    background thread writes them. :meth:`finalize` (before the next
    save, so at most one is in flight, and at the fit's end) waits for
    the thread, then for every rank, and only then writes ``meta.ckpt``:
    a process killed mid-write leaves an unfinalized directory, which the
    resume scan skips. A reused path is unfinalized for the whole write.
    """

    def __init__(self) -> None:
        self._pending: Optional[Tuple[threading.Thread, str, bytes, bool,
                                      list]] = None

    def save(
        self,
        path: str,
        skeleton: Dict[str, Any],
        pieces: Dict[str, Tuple[torch.Tensor, tuple]],
        layout: Layout,
        meta: Dict[str, Any],
        is_rank_zero: bool = True,
        barrier: Callable[[], None] = lambda: None,
    ) -> None:
        self.finalize(barrier)  # at most one save in flight
        path = self._begin(path, is_rank_zero, barrier)
        mesh_shape, coords = layout
        index = ({"skeleton": skeleton, "mesh_shape": dict(mesh_shape)}
                 if is_rank_zero else None)
        rank_pieces = _rank_pieces(pieces, layout)  # host copies, now
        errors: list = []

        def write() -> None:
            try:
                _write(os.path.join(path, _STATE_SUBDIR),
                       _rank_of(coords, mesh_shape), rank_pieces, index)
            except BaseException as exc:  # noqa: BLE001 - raised at finalize
                errors.append(exc)

        thread = threading.Thread(target=write, name="rlt-ckpt-write",
                                  daemon=True)
        thread.start()
        self._pending = (thread, path, to_state_stream(meta), is_rank_zero,
                         errors)

    def finalize(self, barrier: Callable[[], None] = lambda: None) -> None:
        """Wait for the save in flight, if any, on every rank, then write
        its meta marker (rank 0). Every rank calls this."""
        if self._pending is None:
            return
        thread, path, meta_stream, is_rank_zero, errors = self._pending
        self._pending = None
        thread.join()
        if errors:
            raise errors[0]
        barrier()
        if is_rank_zero:
            state_stream_to_file(meta_stream, os.path.join(path, _META_FILE))


def average_checkpoints(paths: Sequence[str], out_path: Optional[str] = None,
                        keys: Sequence[str] = ("params",)) -> Dict[str, Any]:
    """The element-wise mean of the listed state-stream checkpoints'
    ``params`` (and any other ``keys`` whose trees match): the "model
    soup" utility. The first checkpoint's other state is carried over.
    Floating leaves are averaged in float64 and cast back; other leaves
    must be identical across inputs. Writes to ``out_path`` when given."""
    paths = list(paths)
    if len(paths) < 2:
        raise ValueError("average_checkpoints needs at least two inputs")
    states = []
    for p in paths:
        if is_sharded_checkpoint(p):
            raise ValueError(
                f"{p} is a sharded checkpoint directory; restore it to a "
                "state-stream file first (validate/save_checkpoint)"
            )
        with open(p, "rb") as f:
            states.append(load_state_stream(f.read()))
    out = dict(states[0])

    def structure(tree: Any) -> Any:
        if isinstance(tree, dict):
            return {k: structure(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(structure(v) for v in tree)
        return None

    def avg(*leaves: Any) -> Any:
        first = torch.as_tensor(leaves[0])
        if not torch.is_floating_point(first):
            for other in leaves[1:]:
                if not torch.equal(first, torch.as_tensor(other)):
                    raise ValueError(
                        "non-float leaves differ across checkpoints; only "
                        "float parameters can be averaged")
            return leaves[0]
        acc = torch.stack([torch.as_tensor(x).double() for x in leaves])
        return acc.mean(0).to(first.dtype)

    def walk(*trees: Any) -> Any:
        head = trees[0]
        if isinstance(head, dict):
            return {k: walk(*[t[k] for t in trees]) for k in head}
        if isinstance(head, (list, tuple)):
            return type(head)(walk(*[t[i] for t in trees])
                              for i in range(len(head)))
        return avg(*trees)

    for key in keys:
        trees = [s[key] for s in states if key in s]
        if not trees:
            continue
        if len(trees) != len(states):
            raise ValueError(
                f"checkpoint key {key!r} present in only {len(trees)} of "
                f"{len(states)} inputs"
            )
        if any(structure(t) != structure(trees[0]) for t in trees[1:]):
            raise ValueError(
                f"checkpoint trees under {key!r} have different structures"
            )
        out[key] = walk(*trees)
    if out_path is not None:
        state_stream_to_file(to_state_stream(out), out_path)
    return out
