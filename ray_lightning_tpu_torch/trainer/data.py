"""Map-style data loading with the JAX package's sharding semantics
(subset of ``ray_lightning_tpu/trainer/data.py``).

Batches are numpy arrays on the host; the strategy moves them to the
device. The shuffle order, the sampler's wrap-around padding and the tail
batch with its validity mask are the JAX package's exactly, so both
packages see the same rows in the same order from the same seed.
Streaming ``IterableDataset``s and ``TokenBinDataset`` are ROADMAP queue 1
item 14.
"""
from __future__ import annotations

import math
from typing import Any, Iterator, Optional, Sequence, Tuple

import numpy as np


class Dataset:
    """Minimal map-style dataset protocol: __len__ + __getitem__."""

    def __len__(self) -> int:
        raise NotImplementedError

    def __getitem__(self, idx: int) -> Any:
        raise NotImplementedError


class ArrayDataset(Dataset):
    """Dataset over parallel numpy arrays (features, labels, ...)."""

    def __init__(self, *arrays: np.ndarray) -> None:
        assert arrays and all(len(a) == len(arrays[0]) for a in arrays)
        self.arrays = tuple(np.asarray(a) for a in arrays)

    def __len__(self) -> int:
        return len(self.arrays[0])

    def __getitem__(self, idx):
        item = tuple(a[idx] for a in self.arrays)
        return item if len(item) > 1 else item[0]


class DistributedSampler:
    """Deterministic shard of dataset indices for one replica, padded by
    wrap-around so every replica sees the same number of samples."""

    def __init__(
        self,
        dataset_len: int,
        num_replicas: int = 1,
        rank: int = 0,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = False,
    ) -> None:
        if rank >= num_replicas:
            raise ValueError(f"rank {rank} >= num_replicas {num_replicas}")
        self.dataset_len = dataset_len
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        if drop_last and dataset_len % num_replicas:
            self.num_samples = dataset_len // num_replicas
        else:
            self.num_samples = math.ceil(dataset_len / num_replicas)
        self.total_size = self.num_samples * num_replicas

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def indices_and_mask(self) -> Tuple[np.ndarray, np.ndarray]:
        """This replica's indices plus a validity mask, False for
        wrap-around padding entries (each real sample is True on exactly
        one replica, which keeps masked eval metrics exact)."""
        if self.shuffle:
            g = np.random.default_rng(self.seed + self.epoch)
            idx = g.permutation(self.dataset_len)
        else:
            idx = np.arange(self.dataset_len)
        mask = np.ones(len(idx), dtype=bool)
        if not self.drop_last and len(idx) < self.total_size:
            extra = self.total_size - len(idx)
            idx = np.concatenate([idx, np.resize(idx, extra)])
            mask = np.concatenate([mask, np.zeros(extra, dtype=bool)])
        else:
            idx = idx[: self.total_size]
            mask = mask[: self.total_size]
        sl = slice(self.rank, self.total_size, self.num_replicas)
        return idx[sl], mask[sl]


class DataLoader:
    """Batching spec over a map-style dataset. ``batch_size`` is per
    device; the loop attaches the sampler (``with_sampler``) and the
    strategy's batch multiplier before iterating."""

    def __init__(
        self,
        dataset: Dataset | Sequence,
        batch_size: int = 1,
        shuffle: bool = False,
        drop_last: bool = False,
        seed: int = 0,
        collate_fn: Optional[Any] = None,
    ) -> None:
        if not hasattr(dataset, "__len__"):
            raise NotImplementedError(
                "streaming (IterableDataset) loaders are not ported yet "
                "(ROADMAP queue 1 item 14); pass a map-style dataset"
            )
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.collate_fn = collate_fn
        self.sampler: Optional[DistributedSampler] = None

    def with_sampler(self, num_replicas: int, rank: int, seed: int) -> "DataLoader":
        loader = DataLoader(
            self.dataset,
            batch_size=self.batch_size,
            shuffle=self.shuffle,
            drop_last=self.drop_last,
            seed=self.seed,
            collate_fn=self.collate_fn,
        )
        loader.sampler = DistributedSampler(
            len(self.dataset),
            num_replicas=num_replicas,
            rank=rank,
            shuffle=self.shuffle,
            seed=seed,
            drop_last=self.drop_last,
        )
        return loader

    def set_epoch(self, epoch: int) -> None:
        if self.sampler is not None:
            self.sampler.set_epoch(epoch)

    def _collate(self, items: list) -> Any:
        if self.collate_fn is not None:
            return self.collate_fn(items)
        first = items[0]
        if isinstance(first, tuple):
            return tuple(
                np.stack([np.asarray(it[j]) for it in items])
                for j in range(len(first))
            )
        return np.stack([np.asarray(it) for it in items])

    def _gather(self, sel: np.ndarray) -> Any:
        """One batch for the row indices ``sel``: a whole-batch row gather
        for an ``ArrayDataset``, else the per-item collate."""
        if self.collate_fn is None and type(self.dataset) is ArrayDataset:
            outs = tuple(a[sel] for a in self.dataset.arrays)
            return outs if len(outs) > 1 else outs[0]
        return self._collate([self.dataset[int(i)] for i in sel])

    def _iter_selections(
        self, batch_multiplier: int
    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yield (row indices, validity mask) per batch; the mask is False
        for padding rows (sampler and tail-batch wrap-around)."""
        if self.sampler is not None:
            idx, valid = self.sampler.indices_and_mask()
        else:
            if self.shuffle:
                g = np.random.default_rng(self.seed)
                idx = g.permutation(len(self.dataset))
            else:
                idx = np.arange(len(self.dataset))
            valid = np.ones(len(idx), dtype=bool)
        bs = self.batch_size * batch_multiplier
        n_full = len(idx) // bs
        remainder = len(idx) - n_full * bs
        for b in range(n_full):
            yield idx[b * bs : (b + 1) * bs], valid[b * bs : (b + 1) * bs]
        if remainder and not self.drop_last:
            # The tail batch keeps the full batch shape by wrap-around, as
            # in the JAX package (its padding rows train too; eval masks
            # them out).
            sel = idx[n_full * bs :]
            pad = np.resize(idx, bs - len(sel))
            yield (
                np.concatenate([sel, pad]),
                np.concatenate(
                    [valid[n_full * bs :], np.zeros(len(pad), dtype=bool)]
                ),
            )

    def iter_batches(
        self, batch_multiplier: int = 1, with_mask: bool = False
    ) -> Iterator[Any]:
        """Yield host batches of ``batch_size * batch_multiplier`` rows;
        ``with_mask=True`` yields ``(batch, validity_mask)`` pairs."""
        for sel, mask in self._iter_selections(batch_multiplier):
            batch = self._gather(sel)
            yield (batch, mask) if with_mask else batch

    def num_batches(self, batch_multiplier: int = 1) -> int:
        n = (
            self.sampler.num_samples
            if self.sampler is not None
            else len(self.dataset)
        )
        bs = self.batch_size * batch_multiplier
        return n // bs if self.drop_last else math.ceil(n / bs)

    def __iter__(self) -> Iterator[Any]:
        return self.iter_batches(1)

    def __len__(self) -> int:
        return self.num_batches(1)
