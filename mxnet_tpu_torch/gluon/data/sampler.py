"""Samplers (counterpart of ``mxnet_tpu/gluon/data/sampler.py``; ref:
python/mxnet/gluon/data/sampler.py). ``RandomSampler`` draws from
numpy's global generator, as in the JAX package."""
from __future__ import annotations

import numpy as onp


class Sampler:
    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class SequentialSampler(Sampler):
    def __init__(self, length, start=0):
        self._length = length
        self._start = start

    def __iter__(self):
        return iter(range(self._start, self._start + self._length))

    def __len__(self):
        return self._length


class RandomSampler(Sampler):
    def __init__(self, length):
        self._length = length

    def __iter__(self):
        indices = onp.arange(self._length)
        onp.random.shuffle(indices)
        return iter(indices.tolist())

    def __len__(self):
        return self._length


class FilterSampler(Sampler):
    def __init__(self, fn, dataset):
        self._indices = [i for i, sample in enumerate(dataset) if fn(sample)]

    def __iter__(self):
        return iter(self._indices)

    def __len__(self):
        return len(self._indices)


class BatchSampler(Sampler):
    """Ref: sampler.py BatchSampler; last_batch in {keep, discard, rollover}."""

    def __init__(self, sampler, batch_size, last_batch='keep'):
        self._sampler = sampler
        self._batch_size = batch_size
        self._last_batch = last_batch
        self._prev = []

    def __iter__(self):
        batch, self._prev = self._prev, []
        for i in self._sampler:
            batch.append(i)
            if len(batch) == self._batch_size:
                yield batch
                batch = []
        if batch:
            if self._last_batch == 'keep':
                yield batch
            elif self._last_batch == 'discard':
                return
            elif self._last_batch == 'rollover':
                self._prev = batch
            else:
                raise ValueError(f"last_batch must be one of 'keep', 'discard', "
                                 f"or 'rollover', but got {self._last_batch}")

    def __len__(self):
        if self._last_batch == 'keep':
            return (len(self._sampler) + self._batch_size - 1) // self._batch_size
        if self._last_batch == 'discard':
            return len(self._sampler) // self._batch_size
        if self._last_batch == 'rollover':
            return (len(self._prev) + len(self._sampler)) // self._batch_size
        raise ValueError(f"last_batch must be one of 'keep', 'discard', or "
                         f"'rollover', but got {self._last_batch}")


class ElasticSampler(Sampler):
    """Batch sampler with world-indexed deterministic sample
    assignment for elastic data parallelism. Wraps
    ``io.ElasticShard``: each ``__iter__`` pass yields this rank's
    block of successive GLOBAL batches (so it plugs into
    ``DataLoader(batch_sampler=...)``), the global position is stream
    state that survives ``reset``/re-iteration and round-trips through
    the checkpoint manifest (``state()``/``from_state``), and
    ``reshard(rank, world)`` re-partitions the same global sequence
    after a shrink or grow — no sample dropped or double-seen across
    any world-size history."""

    def __init__(self, length, global_batch, rank=0, world=1, seed=0,
                 position=0, shuffle=True, shard=None):
        from ...io.io import ElasticShard
        self._shard = shard if shard is not None else ElasticShard(
            length, global_batch, rank=rank, world=world, seed=seed,
            position=position, shuffle=shuffle)

    @property
    def shard(self):
        return self._shard

    def __iter__(self):
        for _ in range(len(self)):
            yield self._shard.next_batch()

    def __len__(self):
        # batches per pass: one epoch's worth of GLOBAL batches (the
        # stream itself is unbounded — epoch wrap re-permutes)
        return max(1, self._shard.num_samples // self._shard.global_batch)

    def reshard(self, rank, world):
        self._shard.reshard(rank, world)
        return self

    def state(self):
        return self._shard.state()

    @classmethod
    def from_state(cls, state, rank=None, world=None):
        from ...io.io import ElasticShard
        return cls(1, 1, shard=ElasticShard.from_state(
            state, rank=rank, world=world))


class IntervalSampler(Sampler):
    def __init__(self, length, interval, rollover=True):
        self._length = length
        self._interval = interval
        self._rollover = rollover

    def __iter__(self):
        for i in range(self._interval if self._rollover else 1):
            for j in range(i, self._length, self._interval):
                yield j

    def __len__(self):
        return self._length
