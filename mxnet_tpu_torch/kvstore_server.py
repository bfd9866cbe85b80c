"""The KVStore server role (counterpart of ``mxnet_tpu/kvstore_server.py``,
ref: python/mxnet/kvstore_server.py).

MXNet's dist_sync runs server processes that aggregate the workers'
pushes (kvstore_dist_server.h). The port has none: every process is a
worker, and the dist stores all-reduce over the process group
(``parallel.dist``). A process started in the server role
(``DMLC_ROLE=server``) exits at package import, before the script's body
runs, so launch scripts that start server processes keep working."""
from __future__ import annotations

import logging
import os
import sys


class KVStoreServer:
    """The server role (ref: kvstore_server.py:KVStoreServer). ``run()``
    returns at once: there is no aggregation work to do."""

    def __init__(self, kvstore):
        self.kvstore = kvstore

    def run(self):
        logging.info(
            "mxnet_tpu_torch kvstore server role: the workers all-reduce "
            "over their process group; the server role has no work and "
            "exits")


def _init_kvstore_server_module():
    """Called at package import: a ``DMLC_ROLE=server`` process runs the
    (empty) server role and exits; returns False in any other role."""
    if os.environ.get('DMLC_ROLE') == 'server':
        KVStoreServer(None).run()
        sys.exit(0)
    return False
