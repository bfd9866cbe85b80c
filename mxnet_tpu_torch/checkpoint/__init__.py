"""Checkpoints (counterpart of ``mxnet_tpu/checkpoint``): the on-disk
layout of one committed step, its JSON manifest of content hashes and
its validation (``manifest``). ``PredictServer``'s ``/reload`` resolves
and validates a step directory with it. ``CheckpointManager`` and the
replica layer wait for ROADMAP queue 1 items 9 and 10."""
from . import manifest
from .manifest import (CorruptCheckpointError, atomic_write_bytes,
                       committed_steps, read_manifest, step_dir_name,
                       validate_step_dir)

__all__ = ['manifest', 'CorruptCheckpointError', 'atomic_write_bytes',
           'committed_steps', 'read_manifest', 'step_dir_name',
           'validate_step_dir']
