"""Data loading utilities (counterpart of ``deepspeed_tpu/runtime/dataloader.py``).

The engine consumes any iterator of ``dict[str, np.ndarray]`` micro-batches
with a global batch dimension; the helpers here build such iterators from
arrays or token streams. The checkpointable loaders' ``state_dict`` is the
JAX package's dict, so the ``dataloader_state`` of a manifest written by
either package restores in the other.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np


class _QuarantineMixin:
    """Fingerprint-keyed batch quarantine shared by the checkpointable
    loaders (the sentinel's self-healing ladder): a quarantined batch is
    pulled from the underlying stream and dropped, so the position state,
    which counts raw pulls, stays aligned with the stream while the
    training loop never sees the batch again. ``load_state_dict`` unions
    the quarantine, never clears it."""

    _quarantine: set
    quarantined_skipped: int

    def quarantine(self, fingerprints) -> None:
        """Never deliver batches with these content fingerprints again
        (``sentinel.batch_fingerprint`` of the micro-batch dict)."""
        self._quarantine.update(f for f in fingerprints if f)

    @property
    def quarantined(self) -> list:
        return sorted(self._quarantine)

    def _dequarantine(self, item, raw_next):
        if not self._quarantine:
            return item
        from deepspeed_tpu_torch.runtime.sentinel import batch_fingerprint

        while batch_fingerprint(item) in self._quarantine:
            self.quarantined_skipped += 1
            item = raw_next()
        return item


class RepeatingLoader(_QuarantineMixin):
    """Wrap an iterable so it restarts on StopIteration. ``state_dict()``
    records ``(epoch, pos)`` and ``load_state_dict()`` replays the wrapped
    iterable to that point (the iterable must re-iterate the same way)."""

    def __init__(self, loader):
        self.loader = loader
        self._iter = iter(loader)
        self._epoch = 0
        self._pos = 0
        self._quarantine = set()
        self.quarantined_skipped = 0

    def __iter__(self):
        return self

    def _raw_next(self):
        try:
            item = next(self._iter)
        except StopIteration:
            self._iter = iter(self.loader)
            self._epoch += 1
            self._pos = 0
            item = next(self._iter)
        self._pos += 1
        return item

    def __next__(self):
        return self._dequarantine(self._raw_next(), self._raw_next)

    def state_dict(self) -> dict:
        return {"epoch": self._epoch, "pos": self._pos, "quarantine": self.quarantined}

    def load_state_dict(self, state: dict) -> None:
        self._epoch = 0
        self._pos = 0
        self._iter = iter(self.loader)
        target = int(state.get("epoch", 0)) or 0
        while self._epoch < target:
            try:
                next(self._iter)
            except StopIteration:
                self._iter = iter(self.loader)
                self._epoch += 1
        # raw pulls: the position counts the underlying stream, so skips on
        # delivery must not distort it
        for _ in range(int(state.get("pos", 0))):
            self._raw_next()
        self._epoch = target
        self._pos = int(state.get("pos", 0))
        self.quarantine(state.get("quarantine", ()))


class CheckpointableLoader(_QuarantineMixin):
    """Make an iterator factory exactly resumable by counting batches.

    ``factory(skip)`` returns an iterator positioned after ``skip`` batches
    of the deterministic stream. ``state_dict()`` / ``load_state_dict()``
    go through the engine's checkpoint manifest, so ``load_checkpoint``
    restores the data position with the model."""

    def __init__(self, factory, batches_consumed: int = 0):
        self._factory = factory
        self._consumed = int(batches_consumed)
        self._iter = factory(self._consumed)
        self._quarantine = set()
        self.quarantined_skipped = 0

    def __iter__(self):
        return self

    def _raw_next(self):
        item = next(self._iter)
        self._consumed += 1
        return item

    def __next__(self):
        return self._dequarantine(self._raw_next(), self._raw_next)

    @property
    def batches_consumed(self) -> int:
        return self._consumed

    def state_dict(self) -> dict:
        return {"batches_consumed": self._consumed, "quarantine": self.quarantined}

    def load_state_dict(self, state: dict) -> None:
        self._consumed = int(state.get("batches_consumed", 0))
        self._iter = self._factory(self._consumed)
        self.quarantine(state.get("quarantine", ()))


def array_loader(arrays: dict, batch_size: int, seed: int = 0, shuffle: bool = True,
                 drop_last: bool = True) -> Iterator[dict]:
    """Yield dict micro-batches from same-length arrays, reshuffled each epoch
    (``np.random.default_rng(seed)``, the JAX package's draws)."""
    n = len(next(iter(arrays.values())))
    rng = np.random.default_rng(seed)
    while True:
        idx = rng.permutation(n) if shuffle else np.arange(n)
        end = (n // batch_size) * batch_size if drop_last else n
        for start in range(0, end, batch_size):
            sel = idx[start:start + batch_size]
            yield {k: np.asarray(v)[sel] for k, v in arrays.items()}
        if not shuffle:
            return


def random_token_loader(batch_size: int, seq_len: int, vocab_size: int,
                        seed: int = 0) -> Iterator[dict]:
    """Endless random-token batches (a test and benchmark fixture)."""
    rng = np.random.default_rng(seed)
    while True:
        yield {"input_ids": rng.integers(0, vocab_size, (batch_size, seq_len), dtype=np.int32)}
