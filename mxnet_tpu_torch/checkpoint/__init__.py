"""Fault-tolerant async checkpointing (counterpart of
``mxnet_tpu/checkpoint``).

``CheckpointManager`` snapshots params + optimizer state + step + RNG
state on the training thread, writes atomically (per-array files + a
hashed JSON manifest committed by one ``os.replace``) on a background
thread, enforces keep-last-N / keep-every-K retention, and resumes via
hash-verified ``restore_latest()`` with fallback to the previous
committed step on corruption (``manager``). The on-disk layout and its
validation are ``manifest``, which ``PredictServer``'s ``/reload`` uses
too. The replica layer (``ReplicaManager``: peer replication, the
integrity scrubber, the any-replica restore) waits for the membership
side channel (ROADMAP queue 1 item 10) and raises naming it.
"""
from ..base import MXNetError
from . import manifest
from .manifest import (CorruptCheckpointError, atomic_write_bytes,
                       committed_steps, read_manifest, step_dir_name,
                       validate_step_dir)
from .manager import (CheckpointManager, RestoredCheckpoint,
                      last_committed_step)

__all__ = ['manifest', 'CheckpointManager', 'RestoredCheckpoint',
           'ReplicaManager', 'CorruptCheckpointError', 'atomic_write_bytes',
           'committed_steps', 'last_committed_step', 'read_manifest',
           'step_dir_name', 'validate_step_dir']


def ReplicaManager(*args, **kwargs):
    raise MXNetError("checkpoint.ReplicaManager: peer replication runs over "
                     "the membership side channel, which is not ported "
                     "(ROADMAP queue 1 item 10)")
