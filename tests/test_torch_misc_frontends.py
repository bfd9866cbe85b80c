"""``mx.log``, ``mx.libinfo`` and ``mx.runtime`` of the port against the
JAX package's, on the CPU.

tests/test_misc_modules.py's log and libinfo cases run through both
packages; the loggers format a record alike. ``Features()`` has the
JAX package's key set, so ``is_enabled`` answers for every name the JAX
package knows, and each value is what this process has: ``CUDA``,
``CUDNN`` and ``NCCL`` from torch, ``TPU``, ``XLA`` and ``PALLAS`` false.
"""
import logging
import os

import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from test_torch_jax_globals import jax_globals  # noqa: F401

PKGS = {'jax': jmx, 'port': mx}


@pytest.mark.parametrize('pkg', ['jax', 'port'])
def test_log_get_logger(pkg):
    log = PKGS[pkg].log
    lg = log.get_logger(f'mxtpu_test_logger_{pkg}', level=log.INFO)
    assert lg.level == logging.INFO
    assert log.get_logger(f'mxtpu_test_logger_{pkg}') is lg
    assert log.getLogger is log.get_logger


def test_log_levels_and_format_are_the_jax_packages():
    for name in ('CRITICAL', 'ERROR', 'WARNING', 'INFO', 'DEBUG', 'NOTSET'):
        assert getattr(mx.log, name) == getattr(jmx.log, name)
    rec = logging.LogRecord('x', logging.WARNING, __file__, 1, 'hello %s',
                            ('there',), None)
    rec.created = 0.0
    got = mx.log._Formatter(colored=False).format(rec)
    want = jmx.log._Formatter(colored=False).format(rec)
    assert got == want and got.startswith('W') and got.endswith(
        'hello there')


def test_log_to_a_file(tmp_path):
    path = str(tmp_path / 'run.log')
    lg = mx.log.get_logger('mxtpu_test_file_logger', filename=path,
                           level=mx.log.DEBUG)
    lg.debug('step %d', 3)
    for h in lg.handlers:
        h.flush()
    with open(path) as f:
        line = f.read().strip()
    assert line.startswith('D') and line.endswith('step 3')


@pytest.mark.parametrize('pkg', ['jax', 'port'])
def test_libinfo_paths(pkg):
    libinfo = PKGS[pkg].libinfo
    libs = libinfo.find_lib_path()
    assert all(p.endswith('.so') for p in libs)
    assert os.path.isdir(libinfo.find_include_path())


def test_libinfo_of_the_port():
    """The include path is the port's own ``csrc/`` (the op library
    header and the embedding ABIs' headers, laid out as under the JAX
    package's ``src/``); the libraries are the port's build
    directory's."""
    from mxnet_tpu_torch.telemetry import compile as _compile
    inc = mx.libinfo.find_include_path()
    assert inc == os.path.join(os.path.dirname(mx.__file__), 'csrc')
    assert inc != jmx.libinfo.find_include_path()
    for header in (('lib_api', 'mxtpu_lib_api.h'),
                   ('embed', 'c_predict_api.h'), ('embed', 'c_api_train.h')):
        assert os.path.isfile(os.path.join(inc, *header))
        assert os.path.isfile(os.path.join(
            jmx.libinfo.find_include_path(),
            header[0] if header[0] == 'lib_api' else
            {'c_predict_api.h': 'predict', 'c_api_train.h': 'train'}[
                header[1]], header[1]))
    assert all(os.path.dirname(p) == _compile.cache_dir()
               for p in mx.libinfo.find_lib_path())
    assert mx.libinfo.__version__ == jmx.libinfo.__version__


def test_features_keys_are_the_jax_packages():
    assert set(mx.runtime.Features()) == set(jmx.runtime.Features())
    assert [f.name for f in mx.runtime.feature_list()] == \
        list(mx.runtime.Features())


def test_features_values_are_this_process():
    import torch.distributed as dist
    f = mx.runtime.Features()
    assert f.is_enabled('CUDA') == torch.cuda.is_available()
    assert f.is_enabled('cudnn') == torch.backends.cudnn.is_available()
    assert f.is_enabled('NCCL') == (dist.is_available() and
                                    dist.is_nccl_available())
    for name in ('TPU', 'XLA', 'PALLAS'):
        assert f.is_enabled(name) is False
    assert f.is_enabled('PROFILER') and f.is_enabled('CPU')
    assert mx.runtime.Features() is f
    assert repr(f['CPU']) == '[✔ CPU]'


@pytest.mark.parametrize('pkg', ['jax', 'port'])
def test_features_unknown_name_raises(pkg):
    with pytest.raises(RuntimeError, match='unknown'):
        PKGS[pkg].runtime.Features().is_enabled('NOT_A_FEATURE')


def test_package_exposes_the_frontends():
    """``mx.torch`` is the bridge, and PyTorch stays PyTorch."""
    for name in ('profiler', 'runtime', 'libinfo', 'log', 'library',
                 'torch', 'test_utils'):
        assert hasattr(mx, name), name
    assert mx.torch.__name__ == 'mxnet_tpu_torch.torch'
    assert 'torch' not in mx.__all__
    assert torch.__name__ == 'torch'
    for name in ('quantization', 'onnx', 'text', 'tensorboard',
                 'svrg_optimization', 'amp'):
        assert hasattr(mx.contrib, name), name
