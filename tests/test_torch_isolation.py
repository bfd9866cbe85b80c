"""The port stands alone: no module of ``mxnet_tpu_torch`` (nor
``chip_smoke.py``) imports jax, jaxlib or ``mxnet_tpu``, and its entry
points raise instead of running on the CPU when asked for a card that is
not there. Whether a card is present is decided inside each test."""
import ast
import glob
import os

import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.context import resolve_device
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.models.bert import BertForPretraining, BertModel
from mxnet_tpu_torch.ops import fused_ffn, fused_layernorm
from mxnet_tpu_torch.ops import flash_attention as fa
from mxnet_tpu_torch.weights import params_from_mxnet_tpu

ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), os.pardir))
FORBIDDEN = {'jax', 'jaxlib', 'mxnet_tpu'}
SMALL = dict(vocab_size=32, hidden=16, layers=1, heads=2, intermediate=32,
             max_len=16)


def _port_files():
    files = glob.glob(os.path.join(ROOT, 'mxnet_tpu_torch', '**', '*.py'),
                      recursive=True)
    return sorted(files) + [os.path.join(ROOT, 'chip_smoke.py')]


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str) and \
                getattr(node.func, 'attr', getattr(node.func, 'id', None)) \
                in ('import_module', '__import__'):
            yield node.args[0].value


DP_MODULES = ('resilience/__init__.py', 'resilience/retry.py',
              'parallel/dist.py', 'parallel/collectives.py',
              'parallel/mesh.py', 'parallel/step.py')


@pytest.mark.parametrize('module', DP_MODULES)
def test_dp_modules_import_no_jax(module):
    """The data-parallel slice's modules are the port's own: each is
    among the files checked above and imports neither jax nor the
    reference package."""
    path = os.path.join(ROOT, 'mxnet_tpu_torch', module)
    assert path in _port_files()
    bad = [m for m in _imported_modules(path)
           if m.split('.')[0] in FORBIDDEN]
    assert not bad, bad


@pytest.mark.parametrize('test_file', ['test_torch_dist.py',
                                       'test_torch_zero1.py',
                                       'test_torch_dp_bert.py',
                                       'test_torch_zero3.py'])
def test_dp_worker_scripts_import_only_the_port_and_numpy(test_file):
    """The ranks the dp tests spawn run a worker that imports the port,
    numpy, torch and the standard library only."""
    with open(os.path.join(ROOT, 'tests', test_file)) as f:
        tree = ast.parse(f.read())
    worker = next(n.value.value for n in tree.body
                  if isinstance(n, ast.Assign) and
                  getattr(n.targets[0], 'id', None) == 'WORKER')
    mods = set()
    for node in ast.walk(ast.parse(worker)):
        if isinstance(node, ast.Import):
            mods |= {a.name.split('.')[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            mods.add(node.module.split('.')[0])
    assert mods <= {'mxnet_tpu_torch', 'numpy', 'torch', 'os', 'sys',
                    'pickle', 'time'}, mods


KNOB_MODULES = ('ops/autotune.py', 'ops/flash_attention.py',
                'ops/_build.py', 'parallel/step.py',
                'parallel/collectives.py', 'config.py')


@pytest.mark.parametrize('module', KNOB_MODULES)
def test_the_memory_and_tile_knob_modules_import_no_jax(module):
    """The autotuner, the tiled flash wrappers, the remat and ZeRO-3 step
    and the knobs' registry are the port's own, and importing the
    autotuner in a fresh interpreter loads no jax."""
    import subprocess
    import sys
    path = os.path.join(ROOT, 'mxnet_tpu_torch', module)
    assert path in _port_files()
    bad = [m for m in _imported_modules(path)
           if m.split('.')[0] in FORBIDDEN]
    assert not bad, bad
    code = ('import sys\n'
            'import mxnet_tpu_torch.ops.autotune, '
            'mxnet_tpu_torch.parallel.step\n'
            'print(sorted(m for m in sys.modules if m.split(".")[0] in '
            '("jax", "mxnet_tpu")))')
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == '[]', out.stdout


def test_port_imports_no_jax_and_no_reference_package():
    files = _port_files()
    assert len(files) > 15 and os.path.exists(files[-1])
    bad = []
    for path in files:
        for mod in _imported_modules(path):
            # whole top-level names: 'mxnet_tpu_torch' is not 'mxnet_tpu'
            if mod.split('.')[0] in FORBIDDEN:
                bad.append(f'{os.path.relpath(path, ROOT)}: {mod}')
    assert not bad, bad


def test_the_import_check_covers_the_training_step_modules():
    """The compiled step and the optimizer stack are port modules like
    the others: the import check above reads them, and none of them pulls
    in the JAX package when imported."""
    rel = {os.path.relpath(p, ROOT) for p in _port_files()}
    for name in ('parallel/__init__.py', 'parallel/mesh.py',
                 'parallel/step.py', 'lr_scheduler.py', '_capture.py',
                 'optimizer/optimizer.py', 'ops/optimizer_ops.py',
                 'gluon/trainer.py'):
        assert os.path.join('mxnet_tpu_torch', name) in rel, name
    assert mt.parallel.ShardedTrainStep and mt.lr_scheduler.CosineScheduler


def test_the_import_check_covers_the_serving_front_modules():
    """The serving front, its telemetry and the modules it stands on are
    port modules like the others: the import check reads them, and
    importing them pulls in no jax and nothing of the JAX package (checked
    in a fresh interpreter, against what it had loaded before)."""
    import subprocess
    import sys
    rel = {os.path.relpath(p, ROOT) for p in _port_files()}
    new = ('serving/server.py', 'serving/fleet.py', 'telemetry/server.py',
           'telemetry/fleet.py', 'telemetry/attribution.py',
           'parallel/compression.py', 'checkpoint/__init__.py',
           'checkpoint/manifest.py')
    for name in new:
        assert os.path.join('mxnet_tpu_torch', name) in rel, name
    code = ('import sys\n'
            'before = set(sys.modules)\n'
            'import mxnet_tpu_torch.serving.server, '
            'mxnet_tpu_torch.serving.fleet, '
            'mxnet_tpu_torch.telemetry.server, '
            'mxnet_tpu_torch.telemetry.fleet, '
            'mxnet_tpu_torch.telemetry.attribution, '
            'mxnet_tpu_torch.parallel.compression, '
            'mxnet_tpu_torch.checkpoint.manifest\n'
            'bad = sorted(m for m in set(sys.modules) - before '
            'if m.split(".")[0] in ("jax", "jaxlib", "mxnet_tpu"))\n'
            'print(bad)\n')
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == '[]', out.stdout


IO_MODULES = ('_native.py', 'recordio.py', 'io/__init__.py', 'io/io.py',
              'image/__init__.py', 'image/image.py',
              'gluon/data/__init__.py', 'gluon/data/dataset.py',
              'gluon/data/sampler.py', 'gluon/data/dataloader.py',
              'gluon/data/vision/__init__.py',
              'gluon/data/vision/datasets.py',
              'gluon/data/vision/transforms.py')


@pytest.mark.parametrize('module', IO_MODULES)
def test_input_pipeline_modules_import_no_jax(module):
    path = os.path.join(ROOT, 'mxnet_tpu_torch', module)
    assert path in _port_files()
    bad = [m for m in _imported_modules(path)
           if m.split('.')[0] in FORBIDDEN]
    assert not bad, bad


LM_ZOO_MODULES = (
    'metric.py', 'models/__init__.py', 'models/gpt.py',
    'models/transformer.py', 'ndarray/utils.py', 'gluon/contrib/__init__.py',
    'gluon/contrib/nn.py', 'gluon/contrib/estimator.py',
    'gluon/model_zoo/model_store.py', 'gluon/model_zoo/vision/__init__.py',
    'gluon/model_zoo/vision/alexnet.py', 'gluon/model_zoo/vision/vgg.py',
    'gluon/model_zoo/vision/squeezenet.py',
    'gluon/model_zoo/vision/mobilenet.py',
    'gluon/model_zoo/vision/densenet.py',
    'gluon/model_zoo/vision/inception.py')


@pytest.mark.parametrize('module', LM_ZOO_MODULES)
def test_language_model_metric_and_zoo_modules_import_no_jax(module):
    """GPT, the Transformer, the metrics, the Estimator and the rest of
    the vision zoo are among the files checked above and import neither
    jax nor the reference package."""
    path = os.path.join(ROOT, 'mxnet_tpu_torch', module)
    assert path in _port_files()
    bad = [m for m in _imported_modules(path)
           if m.split('.')[0] in FORBIDDEN]
    assert not bad, bad


SEQ_DET_MODULES = ('gluon/rnn/__init__.py', 'gluon/rnn/rnn_layer.py',
                   'gluon/rnn/rnn_cell.py', 'ops/contrib.py',
                   'ops/detection.py', 'models/ssd.py',
                   'image/detection.py')


@pytest.mark.parametrize('module', SEQ_DET_MODULES)
def test_sequence_and_detection_modules_import_no_jax(module):
    """gluon.rnn, the box and detection ops, SSD and the detection
    iterator are among the files checked above and import neither jax
    nor the reference package."""
    path = os.path.join(ROOT, 'mxnet_tpu_torch', module)
    assert path in _port_files()
    bad = [m for m in _imported_modules(path)
           if m.split('.')[0] in FORBIDDEN]
    assert not bad, bad


def test_importing_the_sequence_and_detection_modules_loads_no_jax():
    """In a fresh interpreter, importing gluon.rnn, ops.contrib,
    ops.detection, models.ssd and image.detection loads neither jax nor
    anything of the JAX package."""
    import subprocess
    import sys
    code = ('import sys\n'
            'import mxnet_tpu_torch.gluon.rnn, mxnet_tpu_torch.ops.contrib, '
            'mxnet_tpu_torch.ops.detection, mxnet_tpu_torch.models.ssd, '
            'mxnet_tpu_torch.image.detection\n'
            'print(sorted(m for m in sys.modules if m.split(".")[0] in '
            '("jax", "jaxlib", "mxnet_tpu")))')
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == '[]', out.stdout


@pytest.mark.parametrize('device', [None, 'cuda'])
def test_sequence_and_detection_models_refuse_a_missing_card(device):
    """The RNN layers and SSD are built on the card unless the CPU is
    asked for; ImageDetIter's batches go to the card by default."""
    _require_no_card()
    from mxnet_tpu_torch.gluon import rnn
    from mxnet_tpu_torch.models import ssd_512
    ctx = None if device is None else mt.gpu(0)
    with pytest.raises(MXNetError, match='no CUDA device'):
        net = rnn.LSTM(4, input_size=3)
        net.initialize(ctx=ctx)
    with pytest.raises(MXNetError, match='no CUDA device'):
        net = ssd_512()
        net.initialize(ctx=ctx)
        net(mt.nd.zeros((1, 3, 64, 64), ctx=ctx))
    with mt.cpu():
        net = rnn.GRU(4, input_size=3)
        net.initialize()
        assert net.l0_i2h_weight.tensor.device.type == 'cpu'


def test_native_loader_builds_and_loads_only_the_ports_library():
    """The port's native IO loader resolves its library under
    build/mxnet_tpu_torch/ and never under mxnet_tpu/_lib/: in a fresh
    interpreter, importing the input pipeline and loading the library
    pulls in no jax and nothing of the JAX package, and the process maps
    no file of mxnet_tpu/_lib."""
    import subprocess
    import sys
    code = ('import sys\n'
            'import mxnet_tpu_torch.io, mxnet_tpu_torch.gluon.data, '
            'mxnet_tpu_torch.image, mxnet_tpu_torch.recordio\n'
            'from mxnet_tpu_torch import _native\n'
            'lib = _native.get_lib()\n'
            'print(lib._name if lib is not None else None)\n'
            'print(sorted(m for m in sys.modules if m.split(".")[0] in '
            '("jax", "jaxlib", "mxnet_tpu")))\n'
            'maps = open("/proc/self/maps").read()\n'
            'print("libmxtpu_io" in maps, "mxnet_tpu/_lib" in maps)\n')
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr
    lib, mods, maps = out.stdout.strip().splitlines()[-3:]
    want = os.path.join(ROOT, 'build', 'mxnet_tpu_torch') + os.sep
    assert lib.startswith(want), lib
    assert os.path.join('mxnet_tpu', '_lib') not in lib
    assert mods == '[]', mods
    assert maps == 'True False', maps


def test_iterators_refuse_a_missing_card(tmp_path):
    """An iterator's default context is the card: without one it raises
    instead of falling back to the host."""
    _require_no_card()
    from mxnet_tpu_torch.gluon.data import ArrayDataset, DataLoader
    from mxnet_tpu_torch.io import NDArrayIter
    x = onp.zeros((4, 2), onp.float32)
    with pytest.raises(MXNetError, match='no CUDA device'):
        next(iter(NDArrayIter(x, batch_size=2)))
    with pytest.raises(MXNetError, match='no CUDA device'):
        next(iter(DataLoader(ArrayDataset(x), batch_size=2)))


def test_forbidden_name_check_is_not_a_prefix_check():
    assert 'mxnet_tpu_torch'.split('.')[0] not in FORBIDDEN
    assert 'mxnet_tpu.ops'.split('.')[0] in FORBIDDEN


def _require_no_card():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: nothing to refuse')


@pytest.mark.parametrize('device', [None, 'cuda', 'cuda:0'])
def test_entry_points_refuse_a_missing_card(device):
    _require_no_card()
    with pytest.raises(MXNetError, match='no CUDA device'):
        resolve_device(device)
    with pytest.raises(MXNetError, match='no CUDA device'):
        BertModel(**SMALL, device=device)
    with pytest.raises(MXNetError, match='no CUDA device'):
        BertForPretraining(SMALL, device=device)
    with pytest.raises(MXNetError, match='no CUDA device'):
        nn.Dense(4, in_units=4, device=device)
    cpu_net = BertModel(**SMALL, device='cpu')
    with pytest.raises(MXNetError, match='no CUDA device'):
        mt.serving.BlockRunner(cpu_net, device=device)
    # NDArrays with no ctx go to the card (gpu(0) is the default context)
    with pytest.raises(MXNetError, match=r'no CUDA device.*ctx=mx.cpu\(\)'):
        mt.nd.zeros((2, 3))
    with pytest.raises(MXNetError, match='no CUDA device'):
        mt.nd.array([1.0], ctx=mt.gpu(0))
    with pytest.raises(MXNetError, match='no CUDA device'):
        mt.rtc.CudaModule('extern "C" __global__ void k() {}')
    # the compiled step's mesh holds the card unless the CPU is named
    with pytest.raises(MXNetError, match='no CUDA device'):
        mt.parallel.make_mesh(devices=None if device is None else [device])
    assert mt.parallel.make_mesh(devices=['cpu']).device.type == 'cpu'


@pytest.mark.parametrize('device', [None, 'cuda'])
def test_language_models_refuse_a_missing_card(device):
    """GPT, the Transformer, BERT and the Estimator are built on the card
    unless the CPU is asked for (by name, or by a ``with mx.cpu():``
    scope)."""
    _require_no_card()
    from mxnet_tpu_torch.gluon.contrib.estimator import Estimator
    from mxnet_tpu_torch.models import GPTModel, TransformerModel
    small = dict(hidden=16, layers=1, heads=2, max_len=16)
    with pytest.raises(MXNetError, match='no CUDA device'):
        GPTModel(vocab_size=32, **small, device=device)
    with pytest.raises(MXNetError, match='no CUDA device'):
        TransformerModel(32, 32, hidden=16, enc_layers=1, dec_layers=1,
                         heads=2, ffn_hidden=32, max_len=16, device=device)
    with pytest.raises(MXNetError, match='no CUDA device'):
        Estimator(nn.Dense(2, in_units=3), mt.gluon.loss.L2Loss(),
                  context=None if device is None else [mt.gpu(0)])
    with mt.cpu():
        assert GPTModel(vocab_size=32, **small).word_embed.weight.tensor \
            .device.type == 'cpu'
        assert next(BertModel(**SMALL).parameters()).device.type == 'cpu'
        assert Estimator(nn.Dense(2, in_units=3),
                         mt.gluon.loss.L2Loss()).context == [mt.cpu()]
        assert next(TransformerModel(32, 32, hidden=16, enc_layers=1,
                                     dec_layers=1, heads=2, ffn_hidden=32,
                                     max_len=16, device='cpu').parameters()
                    ).device.type == 'cpu'


def test_weights_follow_the_module_device():
    net = BertModel(**SMALL, device='cpu')
    arrays = {k: onp.zeros(tuple(p.shape), 'float32')
              for k, p in net.named_parameters()}
    out = params_from_mxnet_tpu(arrays, net)
    assert {t.device.type for t in out.values()} == {'cpu'}


def test_cpu_tensors_take_the_plain_versions():
    """On the CPU each wrapper runs its plain version, and only because
    the tensor lies on the CPU; the launch counters stay at zero."""
    mt.ops.reset_launch_counts()
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 2, 5, 8, generator=g) for _ in range(3))
    torch.testing.assert_close(fa.flash_attention(q, k, v),
                               fa.flash_attention_reference(q, k, v)[0])
    x, r = torch.randn(3, 16, generator=g), torch.randn(3, 16, generator=g)
    gm, bt = torch.ones(16), torch.zeros(16)
    torch.testing.assert_close(
        fused_layernorm.fused_add_layer_norm(x, r, gm, bt),
        fused_layernorm.add_layer_norm_reference(x, r, gm, bt))
    w, b = torch.randn(6, 16, generator=g), torch.randn(6, generator=g)
    torch.testing.assert_close(fused_ffn.fused_dense_gelu(x, w, b),
                               fused_ffn.dense_gelu_reference(x, w, b))
    assert set(mt.ops.launch_counts.values()) == {0}


def test_importing_the_port_builds_nothing():
    from mxnet_tpu_torch.ops import _build
    assert _build.SOURCES and all(
        os.path.exists(os.path.join(_build.CSRC_DIR, s))
        for s in _build.SOURCES)
    assert not _build._libs


def test_dropout_draws_on_the_tensors_device():
    """A generator on another device than the tensor raises instead of
    drawing on the host and copying; in eval mode nothing is drawn."""
    drop = nn.Dropout(0.5, generator=torch.Generator())
    x = torch.ones(4, 8, device='meta')
    assert drop.eval()(x) is x
    with pytest.raises(MXNetError, match="tensor's device"):
        drop.train()(x)
    y = drop(torch.ones(64, 64))
    kept = y != 0
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 2.0))
    assert 0.4 < kept.float().mean().item() < 0.6


SYMBOLIC_MODULES = ('name.py', 'attribute.py', 'symbol.py', 'executor.py',
                    'executor_manager.py', 'model.py', 'callback.py',
                    'module.py', 'monitor.py', 'visualization.py',
                    'operator.py', 'subgraph.py', 'ops/misc.py',
                    'ops/control_flow.py', 'ops/attention.py',
                    'ndarray/contrib.py', 'gluon/block.py',
                    'gluon/parameter.py')


@pytest.mark.parametrize('module', SYMBOLIC_MODULES)
def test_symbolic_api_modules_import_no_jax(module):
    """The symbolic API (Symbol, the Executor, Module, the checkpoint
    pair, the callbacks, the monitor, CustomOp, the subgraph backends,
    the loss and control-flow ops, SymbolBlock) is among the files
    checked above and imports neither jax nor the reference package."""
    path = os.path.join(ROOT, 'mxnet_tpu_torch', module)
    assert path in _port_files()
    bad = [m for m in _imported_modules(path)
           if m.split('.')[0] in FORBIDDEN]
    assert not bad, bad


def test_importing_the_symbolic_api_loads_no_jax():
    """In a fresh interpreter, importing the symbolic modules and binding,
    training and exporting a small graph on the CPU loads neither jax nor
    anything of the JAX package."""
    import subprocess
    import sys
    code = ('import sys\n'
            'import mxnet_tpu_torch as mx\n'
            'from mxnet_tpu_torch import sym\n'
            'with mx.cpu():\n'
            '    out = sym.SoftmaxOutput(sym.FullyConnected(\n'
            '        sym.Variable("data"), num_hidden=2, name="fc"),\n'
            '        sym.Variable("softmax_label"), name="sm")\n'
            '    mod = mx.mod.Module(out)\n'
            '    it = mx.io.NDArrayIter(mx.nd.ones((4, 3)), mx.nd.zeros((4,)),'
            ' batch_size=2)\n'
            '    mod.fit(it, num_epoch=1)\n'
            '    mx.subgraph.get_backend("fuse_attention")\n'
            'print(sorted(m for m in sys.modules if m.split(".")[0] in '
            '("jax", "jaxlib", "mxnet_tpu")))')
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == '[]', out.stdout


@pytest.mark.parametrize('device', [None, 'gpu'])
def test_symbolic_entry_points_refuse_a_missing_card(device, tmp_path):
    """simple_bind, bind, Module, BucketingModule, the executor manager,
    load_checkpoint and SymbolBlock.imports put their arrays on the card
    unless the CPU is asked for (ctx=mx.cpu() or ``with mx.cpu():``);
    with no card they raise."""
    _require_no_card()
    ctx = None if device is None else mt.gpu(0)
    sym = mt.sym
    out = sym.FullyConnected(sym.Variable('data'), num_hidden=2, name='fc')
    with pytest.raises(MXNetError, match='no CUDA device'):
        out.simple_bind(ctx, data=(2, 3))
    with pytest.raises(MXNetError, match='no CUDA device'):
        mt.module.Module(out, label_names=None, context=ctx) \
            .bind(data_shapes=[('data', (2, 3))])
    with pytest.raises(MXNetError, match='no CUDA device'):
        mt.module.BucketingModule(lambda k: (out, ('data',), None),
                                  default_bucket_key=1, context=ctx)
    with pytest.raises(MXNetError, match='no CUDA device'):
        mt.executor_manager.DataParallelExecutorManager(
            out, ctx=ctx, data_shapes=[('data', (2, 3))])
    with mt.cpu():
        exe = out.simple_bind(data=(2, 3))
        args = dict(exe.arg_dict)
        mt.model.save_checkpoint(str(tmp_path / 'ck'), 1, out,
                                 {k: v for k, v in args.items()
                                  if k != 'data'}, {})
    assert exe.arg_dict['data']._data.device.type == 'cpu'
    with pytest.raises(MXNetError, match='no CUDA device'):
        out.bind(ctx, args={k: mt.nd.array(v.asnumpy(), ctx=ctx)
                            for k, v in args.items()})
    with pytest.raises(MXNetError, match='no CUDA device'):
        mt.model.load_checkpoint(str(tmp_path / 'ck'), 1, ctx=ctx)
    with pytest.raises(MXNetError, match='no CUDA device'):
        mt.gluon.SymbolBlock.imports(str(tmp_path / 'ck-symbol.json'),
                                     ['data'],
                                     str(tmp_path / 'ck-0001.params'),
                                     ctx=ctx)


SPARSE_MODULES = ('ndarray/sparse.py', 'ops/rowsparse.py',
                  'ops/sparse_ops.py', 'ops/graph.py', 'kvstore.py',
                  'models/wide_deep.py', 'optimizer/optimizer.py',
                  'gluon/parameter.py', 'gluon/trainer.py',
                  'checkpoint/manager.py', 'test_utils.py')


@pytest.mark.parametrize('module', SPARSE_MODULES)
def test_sparse_modules_import_no_jax(module):
    """The sparse slice's modules (sparse NDArrays, the dedup and the
    RowSparse capture, the storage ops, the DGL ops, Wide & Deep) are
    among the files checked above and import neither jax nor the
    reference package."""
    path = os.path.join(ROOT, 'mxnet_tpu_torch', module)
    assert path in _port_files()
    bad = [m for m in _imported_modules(path)
           if m.split('.')[0] in FORBIDDEN]
    assert not bad, bad


def test_importing_the_sparse_modules_loads_no_jax():
    """In a fresh interpreter, importing nd.sparse, the sparse ops, the
    DGL ops and Wide & Deep loads neither jax nor the JAX package."""
    import subprocess
    import sys
    code = ('import sys\n'
            'import mxnet_tpu_torch.ndarray.sparse, '
            'mxnet_tpu_torch.ops.rowsparse, mxnet_tpu_torch.ops.sparse_ops, '
            'mxnet_tpu_torch.ops.graph, mxnet_tpu_torch.models.wide_deep\n'
            'print(sorted(m for m in sys.modules if m.split(".")[0] in '
            '("jax", "jaxlib", "mxnet_tpu")))')
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == '[]', out.stdout
