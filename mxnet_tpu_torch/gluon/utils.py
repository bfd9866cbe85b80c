"""Gluon utilities (counterpart of ``mxnet_tpu/gluon/utils.py``, ref:
python/mxnet/gluon/utils.py). ``download`` finds only local files: the
port uses no network."""
from __future__ import annotations

import hashlib
import math
import os
import warnings

import torch

from ..base import MXNetError
from ..ndarray.utils import split_data, split_and_load  # noqa: F401

__all__ = ['clip_global_norm', 'shape_is_known', 'HookHandle', 'check_sha1',
           'replace_file', 'download', 'split_data', 'split_and_load']


def clip_global_norm(arrays, max_norm, check_isfinite=True):
    """Scale ``arrays`` (NDArrays) in place so that their joint 2-norm is
    at most ``max_norm``; returns the norm before scaling. In place, as
    MXNet's ``arr *= scale``: the arrays of ``p.grad()`` are views of the
    Parameters' gradients, which the Trainer's next step reads."""
    if not arrays:
        raise MXNetError("clip_global_norm needs at least one array")
    total = torch.stack([a._data.detach().float().pow(2).sum()
                         for a in arrays]).sum().sqrt()
    tn = float(total)
    if check_isfinite and not math.isfinite(tn):
        warnings.warn(UserWarning('nan or inf is detected.'))
        return tn
    scale = min(1.0, max_norm / (tn + 1e-8))
    with torch.no_grad():
        for a in arrays:
            a._data.mul_(scale)
    return tn


def replace_file(src, dst):
    """Atomically move src over dst."""
    os.replace(src, dst)


def check_sha1(filename, sha1_hash):
    sha1 = hashlib.sha1()
    with open(filename, 'rb') as f:
        while True:
            data = f.read(1048576)
            if not data:
                break
            sha1.update(data)
    return sha1.hexdigest() == sha1_hash


def download(url, path=None, overwrite=False, sha1_hash=None, retries=5,
             verify_ssl=True):
    """The local file that ``url`` would be downloaded to, when it is
    there (and matches ``sha1_hash``); otherwise raises."""
    fname = path if path and not os.path.isdir(path) else \
        os.path.join(path or '.', url.split('/')[-1])
    if os.path.exists(fname) and not overwrite and \
            (not sha1_hash or check_sha1(fname, sha1_hash)):
        return fname
    raise MXNetError(f"download({url}): the port does not download; place "
                     f"the file at {fname}")


def shape_is_known(shape):
    if shape is None:
        return False
    return all(d not in (0, None) for d in shape)


class HookHandle:
    """What ``register_forward_(pre_)hook`` returns: ``detach()`` (or
    leaving a ``with`` block) removes the hook."""

    def __init__(self, handle=None):
        self._handle = handle

    def detach(self):
        if self._handle is not None:
            self._handle.remove()
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.detach()
