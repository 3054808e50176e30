"""Batch bucketing (aspect-ratio and temporal-length).

The port's copy of the JAX package's numpy-only ``data/bucket.py``.
Re-design of `dataset/bucket_loader.py`: accumulate per-bucket item lists
until one bucket fills a batch; infinite epoch wrap (:9-73). The temporal
variant keys by latent length and re-packs pre-extracted text features into
batch arrays (:76-148).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np

__all__ = ["Bucketeer", "TemporalLengthBucketeer"]


class Bucketeer:
    """Yields batches of same-bucket items from an (infinite) item iterator.

    ``bucket_fn(item) -> hashable`` assigns each item to a bucket
    (e.g. its aspect-ratio bucket index).
    """

    def __init__(self, dataset, batch_size: int,
                 bucket_fn: Optional[Callable] = None, seed: int = 0,
                 shuffle: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.bucket_fn = bucket_fn or (lambda item: item.get("bucket", 0))
        self.rng = np.random.default_rng(seed)
        self.shuffle = shuffle
        self._buckets: Dict[Any, List] = defaultdict(list)
        self._order = None
        self._pos = 0

    def _next_item(self):
        n = len(self.dataset)
        if self._order is None or self._pos >= n:
            self._order = (self.rng.permutation(n) if self.shuffle
                           else np.arange(n))
            self._pos = 0
        item = self.dataset[int(self._order[self._pos])]
        self._pos += 1
        return item

    def __iter__(self) -> Iterator[List]:
        return self

    def __next__(self) -> List:
        while True:
            item = self._next_item()
            key = self.bucket_fn(item)
            self._buckets[key].append(item)
            if len(self._buckets[key]) >= self.batch_size:
                batch = self._buckets[key]
                self._buckets[key] = []
                return batch


class TemporalLengthBucketeer(Bucketeer):
    """Buckets by latent temporal length; collates into stacked arrays with
    text features re-packed (reference :100-142)."""

    def __init__(self, dataset, batch_size: int, seed: int = 0,
                 shuffle: bool = True):
        super().__init__(dataset, batch_size,
                         bucket_fn=lambda it: it["temporal_length"],
                         seed=seed, shuffle=shuffle)

    def __next__(self):
        items = super().__next__()
        out = {
            "latents": np.stack([it["latent"] for it in items]),
            "identifier": [it["identifier"] for it in items],
        }
        if "prompt_embed" in items[0]:
            out["text_emb"] = np.stack([it["prompt_embed"] for it in items])
            out["text_mask"] = np.stack(
                [it["prompt_attention_mask"] for it in items])
            out["pooled"] = np.stack(
                [it["pooled_prompt_embed"] for it in items])
        else:
            out["text"] = [it.get("text", "") for it in items]
        return out
