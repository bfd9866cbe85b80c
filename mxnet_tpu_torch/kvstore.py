"""MXNet's KVStore (counterpart of ``mxnet_tpu/kvstore/``): not ported,
ROADMAP queue 1 item 8. The port reduces gradients over a dp world in
``gluon.Trainer`` (``kvstore='device'`` or ``'local'``) and in
``parallel.ShardedTrainStep``; the store itself, its ``row_sparse_pull``
included, raises here, naming that item."""
from __future__ import annotations

from .base import MXNetError

__all__ = ['create', 'row_sparse_pull']


def create(name='local'):
    raise MXNetError(
        f"kvstore.create({name!r}): the KVStore is not ported (ROADMAP "
        f"queue 1 item 8); gluon.Trainer(kvstore='device') and "
        f"parallel.ShardedTrainStep reduce gradients over the dp world")


def row_sparse_pull(key, out=None, priority=0, row_ids=None):
    raise MXNetError(
        "kvstore.row_sparse_pull: the KVStore's row-sparse pull is not "
        "ported (ROADMAP queue 1 item 8); Parameter.row_sparse_data(row_id) "
        "retains the rows from the local weight")
