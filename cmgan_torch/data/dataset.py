"""VCTK-DEMAND paired dataset and the training batch pipeline.

The port's own copy of the JAX package's loader (numpy and threads
only): clean/noisy wavs paired by identical filename (natural order),
short clips tile-repeated to cut_len, long clips randomly cropped (same
offset for both sides), batches stacked by a background prefetch
thread. The same seed gives the same batches as the JAX package's
loader. `num_processes` / `process_index` shard the indices for
data-parallel runs; one process is the default.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Iterator, Tuple

import numpy as np

from cmgan_torch.data.sorting import natsorted
from cmgan_torch.data.wav import read_wav


class DemandDataset:
    """Paired clean/noisy utterances under <root>/{clean,noisy}/X.wav."""

    def __init__(self, data_dir: str, cut_len: int = 32000):
        self.cut_len = cut_len
        self.clean_dir = os.path.join(data_dir, "clean")
        self.noisy_dir = os.path.join(data_dir, "noisy")
        self.names = natsorted(os.listdir(self.clean_dir))

    def __len__(self) -> int:
        return len(self.names)

    def load_pair(self, idx: int) -> Tuple[np.ndarray, np.ndarray, int]:
        """Full-length (clean, noisy, length) without crop/pad."""
        clean, _ = read_wav(os.path.join(self.clean_dir, self.names[idx]))
        noisy, _ = read_wav(os.path.join(self.noisy_dir, self.names[idx]))
        clean, noisy = clean[0], noisy[0]
        length = clean.shape[-1]
        if length != noisy.shape[-1]:
            raise ValueError(f"{self.names[idx]}: clean has {length} samples, "
                             f"noisy {noisy.shape[-1]}")
        return clean, noisy, length

    def __getitem__(self, idx: int, rng: np.random.Generator | None = None):
        clean, noisy, length = self.load_pair(idx)
        cut = self.cut_len
        if length < cut:
            # tile-repeat then top up with a prefix slice
            reps = cut // length
            tail = cut % length
            clean = np.concatenate([np.tile(clean, reps), clean[:tail]])
            noisy = np.concatenate([np.tile(noisy, reps), noisy[:tail]])
        else:
            rng = rng or np.random.default_rng()
            start = int(rng.integers(0, length - cut + 1))
            clean = clean[start : start + cut]
            noisy = noisy[start : start + cut]
        return clean.astype(np.float32), noisy.astype(np.float32), length


class BatchLoader:
    """Epoch iterator yielding (clean [B, cut_len], noisy [B, cut_len]).

    Shuffling is seeded per epoch, so every process of a data-parallel
    run draws consistent global batches (DistributedSampler.set_epoch
    semantics) and takes its own stride of them.
    """

    def __init__(
        self,
        dataset: DemandDataset,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = True,
        seed: int = 0,
        num_processes: int = 1,
        process_index: int = 0,
        prefetch: int = 2,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_processes = num_processes
        self.process_index = process_index
        self.prefetch = prefetch
        self.epoch = 0

    def _epoch_indices(self) -> np.ndarray:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            order = np.random.default_rng(self.seed + self.epoch).permutation(n)
        if self.num_processes > 1:
            # tile-pad to a multiple so every process sees the same batch
            # count (a single wrap slice can fall short when
            # n < num_processes, desyncing collectives across processes)
            per = -(-n // self.num_processes)
            padded = np.resize(order, per * self.num_processes)
            order = padded[self.process_index :: self.num_processes]
        return order

    def __len__(self) -> int:
        n = len(self._epoch_indices())
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        order = self._epoch_indices()
        rng = np.random.default_rng(
            (self.seed + self.epoch) * 7919 + self.process_index
        )
        self.epoch += 1

        def batches():
            nb = len(order) // self.batch_size
            rem = len(order) % self.batch_size
            for b in range(nb + (0 if self.drop_last or rem == 0 else 1)):
                idx = order[b * self.batch_size : (b + 1) * self.batch_size]
                cleans, noisys = [], []
                for i in idx:
                    c, n, _ = self.dataset.__getitem__(int(i), rng=rng)
                    cleans.append(c)
                    noisys.append(n)
                yield np.stack(cleans), np.stack(noisys)

        if self.prefetch <= 0:
            yield from batches()
            return

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()

        def worker():
            try:
                for item in batches():
                    q.put(item)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item


def load_data(
    data_dir: str,
    batch_size: int,
    cut_len: int = 32000,
    seed: int = 0,
) -> Tuple[BatchLoader, BatchLoader]:
    """(train_loader, test_loader) over <data_dir>/{train,test}: the train
    loader shuffles and drops the last partial batch, the test loader
    does neither."""
    train = BatchLoader(
        DemandDataset(os.path.join(data_dir, "train"), cut_len),
        batch_size,
        shuffle=True,
        drop_last=True,
        seed=seed,
    )
    test = BatchLoader(
        DemandDataset(os.path.join(data_dir, "test"), cut_len),
        batch_size,
        shuffle=False,
        drop_last=False,
        seed=seed,
    )
    return train, test
