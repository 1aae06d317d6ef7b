"""Ring-buffer batch sampler with the reference's exact epoch semantics (the
port's own copy of the JAX package's ``data/sampler.py``; numpy only).

The reference epoch is NOT "one pass over the dataset": it is ``n_samples``
draws from a once-shuffled ring buffer with a persistent cursor that wraps
modulo the dataset length and carries over between epochs
(``src/data_generator_mscmrseg.py:274-291``). The final batch of an epoch is
truncated when ``n_samples`` is hit mid-batch. SURVEY.md §7 flags this as
easy to get subtly wrong — this module reproduces it exactly and is tested
against hand-derived index sequences.

Distinct from the reference: sampling (this class) is decoupled from
decoding/augmentation (the adapters) and from device transfer (prefetch), so
each stage can be parallelised independently.
"""

from __future__ import annotations

from typing import Iterator, List

import numpy as np


class RingSampler:
    """Yields lists of dataset indices per batch.

    ``shuffle_seed`` controls the single permutation applied at construction
    (the reference shuffles once in ``__init__``, never re-shuffles).
    """

    def __init__(
        self,
        n_items: int,
        batch_size: int,
        n_samples: int = -1,
        shuffle_seed: int | None = 0,
    ):
        if n_items <= 0:
            raise ValueError("empty dataset")
        self._len = n_items
        self._batch_size = batch_size
        self._n_samples = n_items if n_samples == -1 else n_samples
        if shuffle_seed is None:
            self._order = np.arange(n_items)
        else:
            self._order = np.random.default_rng(shuffle_seed).permutation(n_items)
        self._cursor = 0  # persists across epochs, like the reference _index

    def __len__(self) -> int:
        return self._len

    @property
    def steps_per_epoch(self) -> int:
        return -(-self._n_samples // self._batch_size)

    def epoch(self) -> Iterator[List[int]]:
        """One epoch = n_samples draws, cursor carried over."""
        total = 0
        while total < self._n_samples:
            positions = []
            for _ in range(self._batch_size):
                positions.append(self._cursor)
                self._cursor = (self._cursor + 1) % self._len
                total += 1
                if total >= self._n_samples:
                    break
            yield [int(self._order[p]) for p in positions]

    def state(self) -> dict:
        return {"cursor": self._cursor, "order": self._order.copy()}

    def restore(self, state: dict) -> None:
        self._cursor = int(state["cursor"])
        self._order = np.asarray(state["order"])
