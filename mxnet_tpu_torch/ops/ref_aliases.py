"""MXNet's op names as aliases, and the explicit descope table
(counterpart of ``mxnet_tpu/ops/ref_aliases.py``).

MXNet resolves many spellings per op (nnvm ``add_alias``: legacy
CamelCase such as ``FullyConnected``/``_Plus``, deprecated short names
such as ``uniform``, and the ``_npx_*``/``_contrib_*`` namespaces). The
registry keeps one canonical snake_case name per op; this module makes
every spelling of MXNet 1.6's inventory (``reference_op_names.txt``, the
port's own copy of the JAX package's file) resolve to it through
``base.register_op_alias``, by the JAX module's rules: a mechanical
derivation (``_derive_candidates``), a table of spellings whose canonical
name differs in words (``MANUAL_ALIASES``), and the names left out on
purpose (``DESCOPED``, and every explicit backward op). It is imported
after every op module (``ops/__init__.py``).
"""
from __future__ import annotations

import os
import re

from ..base import _OP_REGISTRY, _OP_ALIASES, register_op_alias

# reference spelling -> canonical op, where the derivation cannot reach
MANUAL_ALIASES = {
    'BatchNorm_v1': 'batch_norm',
    'BlockGrad': 'stop_gradient',
    'CTCLoss': 'ctc_loss',
    'Custom': 'custom',
    '_npi_Custom': 'custom',
    'ElementWiseSum': 'add_n',
    'LeakyReLU': 'leaky_relu',
    'SwapAxis': 'swapaxes',
    'UpSampling': 'upsampling',
    'ROIPooling': 'roi_pooling',
    'SoftmaxActivation': 'softmax_activation',
    'IdentityAttachKLSparseReg': 'identity_attach_kl_sparse_reg',
    'LinearRegressionOutput': 'linear_regression_output',
    'LogisticRegressionOutput': 'logistic_regression_output',
    'MAERegressionOutput': 'mae_regression_output',
    '_Plus': 'elemwise_add', '_plus': 'elemwise_add',
    '_Minus': 'elemwise_sub', '_minus': 'elemwise_sub',
    '_grad_add': 'elemwise_add',
    '_copy': 'identity',
    '_RDivScalar': 'rdiv_scalar', '_RMinusScalar': 'rminus_scalar',
    '_RModScalar': 'rmod_scalar', '_RPowerScalar': 'rpower_scalar',
    '_scatter_elemwise_div': 'scatter_elemwise_div',
    '_np_amax': '_np_max' if '_np_max' in _OP_REGISTRY else 'max',
    '_np_amin': '_np_min' if '_np_min' in _OP_REGISTRY else 'min',
    '_np_product': '_np_prod',
    'max_axis': 'max', 'min_axis': 'min', 'sum_axis': 'sum',
    'broadcast_axes': 'broadcast_axis',
    'broadcast_plus': 'broadcast_add',
    'broadcast_minus': 'broadcast_sub',
    'choose_element_0index': 'pick',
    'crop': 'slice',
    '_crop_assign': 'slice_assign',
    '_crop_assign_scalar': 'slice_assign_scalar',
    '_split_v2': 'split_v2',
    '_square_sum': 'square_sum',
    '_zeros_without_dtype': 'zeros',
    '_npx_batch_flatten': 'flatten',
    '_npx_reshape_like': 'reshape_like',
    '_npx_roi_pooling': 'roi_pooling',
    '_rnn_param_concat': 'concat',
    '_npi_rnn_param_concat': 'concat',
    '_npi_normal_n': '_npi_normal',
    '_npi_uniform_n': '_npi_uniform',
    '_contrib_AdaptiveAvgPooling2D': 'adaptive_avg_pooling2d',
    '_contrib_BilinearResize2D': 'bilinear_resize2d',
    '_contrib_CTCLoss': 'ctc_loss',
    '_contrib_MultiBoxDetection': 'multibox_detection',
    '_contrib_MultiBoxPrior': 'multibox_prior',
    '_contrib_MultiBoxTarget': 'multibox_target',
    '_contrib_ROIAlign': 'roi_align',
    '_contrib_RROIAlign': 'rroi_align',
    '_contrib_SparseEmbedding': 'embedding',
    '_contrib_SyncBatchNorm': 'sync_batch_norm_op',
    '_contrib_box_non_maximum_suppression': 'box_nms',
    '_contrib_hawkesll': 'hawkes_ll',
    '_contrib_gradientmultiplier': 'gradient_multiplier',
    '_contrib_bipartite_matching': 'bipartite_matching',
    '_contrib_calibrate_entropy': 'calibrate_entropy',
    '_contrib_getnnz': 'getnnz',
    '_contrib_index_array': 'index_array',
    '_contrib_group_adagrad_update': 'group_adagrad_update',
    '_contrib_quantized_act': 'quantized_act',
    '_contrib_quantized_batch_norm': 'quantized_batch_norm',
    '_contrib_quantized_elemwise_mul': 'quantized_elemwise_mul',
    '_contrib_quantized_embedding': 'quantized_embedding',
    '_mp_adamw_update': 'mp_adamw_update',
    '_multi_mp_adamw_update': 'multi_mp_adamw_update',
    '_multi_mp_lamb_update': 'multi_mp_lamb_update',
    '_sparse_adagrad_update': 'sparse_adagrad_update',
    '_cond': 'cond', '_foreach': 'foreach', '_while_loop': 'while_loop',
    '_scatter_set_nd': 'scatter_set_nd',
    '_npi_scatter_set_nd': 'scatter_set_nd',
    '_slice_assign': 'slice_assign',
    '_slice_assign_scalar': 'slice_assign_scalar',
    '_npi_slice_assign': 'slice_assign',
    '_npi_slice_assign_scalar': 'slice_assign_scalar',
    '_identity_with_attr_like_rhs': 'identity_with_attr_like_rhs',
    '_sample_unique_zipfian': 'sample_unique_zipfian',
}

# reference op -> why it has no counterpart (the JAX package's table);
# every explicit backward op is left out too (``is_descoped``)
DESCOPED = {
    '_FusedOp': 'RTC pointwise-fusion internal; ops run as they are',
    '_FusedOpHelper': 'RTC fusion internal',
    '_FusedOpOutHelper': 'RTC fusion internal',
    '_TensorRT': 'TensorRT subgraph op; not part of this framework',
    '_sg_mkldnn_conv': 'MKLDNN subgraph op; no MKLDNN here',
    '_sg_mkldnn_fully_connected': 'MKLDNN subgraph op; no MKLDNN here',
    '_contrib_tvm_dot': 'TVM bridge descoped (SURVEY §2.1)',
    '_contrib_tvm_dot_fallback': 'TVM bridge descoped',
    '_contrib_tvm_vadd': 'TVM bridge descoped',
    'CuDNNBatchNorm': 'cuDNN-specific op; batch_norm covers the semantics',
    'RNN': 'covered by canonical op `rnn` (the fused RNN)',
    'LRN': 'covered by canonical op `lrn`',
}

BACKWARD_REASON = 'explicit backward op; gradients come from autograd'


def _derive_candidates(name):
    """Mechanical spellings -> candidate canonical names, most specific
    first (prefix namespaces and CamelCase legacy names)."""
    seen, out = set(), []

    def add(x):
        if x and x not in seen:
            seen.add(x)
            out.append(x)

    snake = re.sub(r'(?<=[a-zA-Z0-9])([A-Z])', r'_\1', name).lower() \
        .replace('__', '_')
    forms = [name, name.lstrip('_'), snake, snake.lstrip('_')]
    for f in list(forms):
        g = f.lstrip('_')
        for pre in ('npx__', 'npx_', 'npi_', 'np_', 'contrib_', 'random_',
                    'sample_', 'image_', 'linalg_'):
            if g.startswith(pre):
                rest = g[len(pre):]
                forms += [rest, '_npi_' + rest, 'linalg_' + rest,
                          'random_' + rest, 'sample_' + rest,
                          'image_' + rest, 'broadcast_' + rest]
    for f in forms:
        add(f)
        add(f.lstrip('_'))
        base = f.lstrip('_')
        add('_npi_' + base)
        add('broadcast_' + base)
        add('elemwise_' + base)
    return out


def resolve_reference_name(name):
    """The canonical op of a reference spelling, or None."""
    if name in _OP_REGISTRY:
        return name
    if name in _OP_ALIASES:
        return _OP_ALIASES[name]
    manual = MANUAL_ALIASES.get(name)
    if manual is not None and manual in _OP_REGISTRY:
        return manual
    for cand in _derive_candidates(name):
        if cand in _OP_REGISTRY:
            return cand
    return None


def is_descoped(name):
    """The reason when ``name`` is left out on purpose, else None."""
    if name in DESCOPED:
        return DESCOPED[name]
    if 'backward' in name:
        return BACKWARD_REASON
    return None


def reference_op_names():
    """MXNet 1.6's op-name inventory (the port's copy of the file the JAX
    package ships)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        'reference_op_names.txt')
    with open(path) as fh:
        return [ln.strip() for ln in fh
                if ln.strip() and not ln.startswith('#')]


def install_reference_aliases():
    """Register every resolvable reference spelling as an alias, so that
    ``get_op(<MXNet name>)`` works at run time."""
    installed = 0
    for n in sorted(set(reference_op_names())):
        if n in _OP_REGISTRY or n in _OP_ALIASES or is_descoped(n):
            continue
        target = resolve_reference_name(n)
        if target is not None:
            register_op_alias(n, target)
            installed += 1
    return installed


install_reference_aliases()
