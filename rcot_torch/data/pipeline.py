"""Input pipeline: threaded host decode and crop, batches moved to the card
ahead of use.

Counterpart of the PIL path of rcot_tpu/data/pipeline.py:40-190:

- `TrainLoader.epoch(epoch, start_step)` shuffles the index with
  random.Random(f"{seed}:{epoch}") and crops batch `bstep` with
  random.Random(f"{seed}:{epoch}:{bstep}:0"), so its batches equal the JAX
  package's byte for byte and a run resumes mid-epoch exactly; a thread
  pool decodes a few batches ahead (PIL releases the GIL in decode).
- `device_prefetch` copies the next batches from pinned host memory on a
  side CUDA stream; the consumer's stream waits on each batch's event.

One process: the JAX package's process slice is pi = 0 of pc = 1. The
native C++ loader is not ported.
"""

from __future__ import annotations

import collections
import random
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, NamedTuple

import numpy as np
import torch

from ..utils.config import Config
from .datasets import TrainIndex, get_patch_pair


class HostBatch(NamedTuple):
    degraded: np.ndarray  # (B, P, P, 3) uint8
    clean: np.ndarray     # (B, P, P, 3) uint8
    de_id: np.ndarray     # (B,) int32


class TrainLoader:
    """Deterministic, resumable epoch iterator over host batches."""

    def __init__(self, cfg: Config, *, seed: int = 0):
        self.cfg = cfg
        self.seed = seed
        self.index = TrainIndex(cfg.data, random.Random(seed))
        self.pool = ThreadPoolExecutor(max_workers=max(1, cfg.data.num_workers))

    def steps_per_epoch(self) -> int:
        return len(self.index) // self.cfg.train.batch_size

    def batch(self, order, epoch: int, bstep: int) -> HostBatch:
        rng = random.Random(f"{self.seed}:{epoch}:{bstep}:0")
        bs = self.cfg.train.batch_size
        pairs = [get_patch_pair(self.index.samples[order[bstep * bs + k]],
                                self.cfg.data.patch_size, self.cfg.data.crop_base, rng)
                 for k in range(bs)]
        degs, cleans, ids = zip(*pairs)
        return HostBatch(np.stack(degs), np.stack(cleans), np.asarray(ids, np.int32))

    def epoch(self, epoch: int, start_step: int = 0) -> Iterator[HostBatch]:
        """Batches of `epoch`, from `start_step` on (a resume)."""
        order = list(range(len(self.index)))
        random.Random(f"{self.seed}:{epoch}").shuffle(order)
        n_batches = len(order) // self.cfg.train.batch_size
        window = max(2, self.cfg.data.prefetch + 1)
        pending = collections.deque()
        nxt = start_step
        while nxt < n_batches and len(pending) < window:
            pending.append(self.pool.submit(self.batch, order, epoch, nxt))
            nxt += 1
        while pending:
            yield pending.popleft().result()
            if nxt < n_batches:
                pending.append(self.pool.submit(self.batch, order, epoch, nxt))
                nxt += 1


class DeviceBatch(NamedTuple):
    degraded: torch.Tensor  # (B, P, P, 3) uint8
    clean: torch.Tensor     # (B, P, P, 3) uint8
    de_id: torch.Tensor     # (B,) int32


def device_prefetch(host_iter, size: int = 2, device="cuda") -> Iterator[DeviceBatch]:
    """Host batches on `device`, `size` ahead of use. On a CUDA device the
    copies run from pinned memory on a side stream, and each batch is handed
    out after the current stream waits on its copy's event; on the CPU the
    arrays are wrapped as they are."""
    dev = torch.device(device)
    if dev.type != "cuda":
        for b in host_iter:
            yield DeviceBatch(*(torch.from_numpy(a) for a in b))
        return
    side = torch.cuda.Stream(dev)

    def put(b):
        host = [torch.from_numpy(a).pin_memory() for a in b]
        with torch.cuda.stream(side):
            on_dev = [t.to(dev, non_blocking=True) for t in host]
            done = torch.cuda.Event()
            done.record(side)
        return on_dev, done

    queue = collections.deque()
    it = iter(host_iter)
    for b in it:
        queue.append(put(b))
        if len(queue) >= max(1, size):
            break
    while queue:
        on_dev, done = queue.popleft()
        for b in it:
            queue.append(put(b))
            break
        current = torch.cuda.current_stream(dev)
        current.wait_event(done)
        for t in on_dev:
            t.record_stream(current)  # allocated on the side stream
        yield DeviceBatch(*on_dev)
