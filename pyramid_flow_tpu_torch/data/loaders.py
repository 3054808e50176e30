"""Loader factories: sharded, prefetched input pipelines.

The port's copy of the JAX package's numpy-only ``data/loaders.py``.
Re-design of `dataset/dataloaders.py`:
* per-host data sharding replaces ``DistributedSampler`` — each host reads
  ``rank::world`` of the dataset (or, with ``sync_group``, groups of ranks
  read the SAME items so each trains a different AR position — the
  reference's video_sync_group trick, `train/train_pyramid_flow.py:425-434`)
* ``create_mixed_loaders``: first ``world - ceil(world*image_ratio)`` ranks
  read video, the rest images (VAE mixed training,
  `train/train_video_vae.py:203-216`)
* background-thread prefetch replaces torch DataLoader workers; the C++
  prefetcher (native/) slots in behind the same interface
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator, Optional

import numpy as np

from .bucket import Bucketeer, TemporalLengthBucketeer

__all__ = [
    "ShardedDataset",
    "Prefetcher",
    "create_image_text_dataloader",
    "create_length_grouped_video_text_dataloader",
    "create_mixed_dataloaders",
]


class ShardedDataset:
    """View of a dataset restricted to one data-parallel shard.

    ``sync_group > 1``: ranks within a group map to the SAME underlying
    items (dataloader rank = rank // sync_group, reference :425-434).
    """

    def __init__(self, dataset, rank: int = 0, world: int = 1,
                 sync_group: int = 1):
        self.dataset = dataset
        eff_rank = rank // sync_group
        eff_world = max(world // sync_group, 1)
        self.offset = eff_rank % eff_world
        self.stride = eff_world

    def __len__(self):
        return max((len(self.dataset) - self.offset + self.stride - 1)
                   // self.stride, 1)

    def __getitem__(self, idx):
        return self.dataset[self.offset + (idx % len(self)) * self.stride]


class Prefetcher:
    """Background-thread batch prefetch (host -> ready queue)."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._it = it
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        try:
            for batch in self._it:
                if self._stop.is_set():
                    return
                self._q.put(batch)
        except Exception as e:  # surface on the consumer side
            self._q.put(e)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if isinstance(item, Exception):
            raise item
        return item

    def close(self):
        self._stop.set()


def create_image_text_dataloader(dataset, batch_size: int, rank: int = 0,
                                 world: int = 1, seed: int = 0,
                                 prefetch: int = 2):
    """Aspect-bucketed image-text batches (reference :60-102)."""
    sharded = ShardedDataset(dataset, rank, world)
    return Prefetcher(Bucketeer(sharded, batch_size, seed=seed), prefetch)


def create_length_grouped_video_text_dataloader(
        dataset, batch_size: int, rank: int = 0, world: int = 1,
        sync_group: int = 1, seed: int = 0, prefetch: int = 2):
    """Latent-length-grouped batches with video-sync sharding (:105-137)."""
    sharded = ShardedDataset(dataset, rank, world, sync_group)
    return Prefetcher(
        TemporalLengthBucketeer(sharded, batch_size, seed=seed), prefetch)


def create_mixed_dataloaders(video_dataset, image_dataset, batch_size: int,
                             rank: int = 0, world: int = 1,
                             image_mix_ratio: float = 0.1, seed: int = 0,
                             prefetch: int = 2):
    """Rank-role split between image and video datasets (:140-190).

    Returns (loader, role): first ``world - ceil(world*ratio)`` ranks get
    video, the rest image.
    """
    import math
    image_ranks = int(math.ceil(world * image_mix_ratio))
    video_ranks = max(world - image_ranks, 1)
    if rank < video_ranks:
        ds, role = video_dataset, "video"
        sharded = ShardedDataset(ds, rank, video_ranks)
    else:
        ds, role = image_dataset, "image"
        sharded = ShardedDataset(ds, rank - video_ranks, max(image_ranks, 1))

    def batches():
        bucket = Bucketeer(sharded, batch_size, bucket_fn=lambda it: 0,
                           seed=seed)
        for items in bucket:
            yield {
                "video": np.stack([it["video"] for it in items]),
                "identifier": [it["identifier"] for it in items],
            }

    return Prefetcher(batches(), prefetch), role
