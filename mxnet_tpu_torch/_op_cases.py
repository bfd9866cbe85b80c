"""The inputs of the op sweep: one case, (args, kwargs) of numpy arrays
and Python values, for every registered op that runs on made-up inputs.
The CPU tests feed a case to the port's op and to the JAX package's
(tests/test_torch_op_registry.py); ``chip_smoke.py``'s ``ops`` phase
feeds it to the op on the card and on the CPU. The tables transliterate
the JAX package's sweep (tests/test_op_registry.py: ``_explicit_cases``,
``_legacy_explicit_cases`` and its family rules) and add ``_extra`` for
the ops that sweep leaves to other files; ``EXEMPT`` names the ops held
against the JAX package elsewhere, with the file, and ``card_case`` gives
them the inputs on which the card runs them against the CPU. Each case
draws from a generator seeded by the op's name, so a case does not
depend on which others were made before it.

``BF16(array)`` marks an argument the op takes in bfloat16 (numpy has no
bfloat16); ``to_torch`` converts a case for the port.
"""
from __future__ import annotations

import inspect
import zlib

import numpy as onp

__all__ = ['BF16', 'case', 'card_case', 'to_torch', 'EXEMPT', 'RANDOM',
           'INVARIANT', 'HOST', 'parse_np_op', 'NON_SMOOTH']

_F32 = onp.float32


class BF16:
    """An array argument the op takes in bfloat16."""

    def __init__(self, array):
        self.array = onp.asarray(array, _F32)


# --- the JAX sweep's family rules (tests/test_op_registry.py) --------------

UNARY_DOMAIN = {
    'sqrt': (0.1, 2.0), 'cbrt': (0.1, 2.0), 'log': (0.1, 3.0),
    'log2': (0.1, 3.0), 'log10': (0.1, 3.0), 'log1p': (-0.5, 2.0),
    'arcsin': (-0.9, 0.9), 'arccos': (-0.9, 0.9),
    'arctanh': (-0.9, 0.9), 'arccosh': (1.1, 3.0), 'reciprocal': (0.5, 2.0),
}
UNARY_INT = {'invert', 'bitwise_not'}
BINARY_INT = {'lcm', 'gcd', 'bitwise_and', 'bitwise_or', 'bitwise_xor',
              'bitwise_left_shift', 'bitwise_right_shift'}
BINARY_NAMES = {
    'add', 'subtract', 'multiply', 'mod', 'power', 'true_divide',
    'floor_divide', 'arctan2', 'hypot', 'copysign', 'ldexp', 'lcm', 'gcd',
    'bitwise_and', 'bitwise_or', 'bitwise_xor', 'bitwise_left_shift',
    'bitwise_right_shift', 'maximum', 'minimum', 'fmax', 'fmin', 'fmod',
    'equal', 'not_equal', 'greater', 'greater_equal', 'less', 'less_equal',
    'logical_and', 'logical_or', 'logical_xor',
}
UNARY_NAMES = {
    'abs', 'absolute', 'negative', 'reciprocal', 'sign', 'rint', 'ceil',
    'floor', 'trunc', 'fix', 'square', 'sqrt', 'cbrt', 'exp', 'expm1',
    'log', 'log2', 'log10', 'log1p', 'degrees', 'radians', 'deg2rad',
    'rad2deg', 'sin', 'cos', 'tan', 'arcsin', 'arccos', 'arctan', 'sinh',
    'cosh', 'tanh', 'arcsinh', 'arccosh', 'arctanh', 'invert',
    'bitwise_not', 'exp2', 'positive', 'conjugate', 'logical_not',
    'isnan', 'isinf', 'isfinite', 'isposinf', 'isneginf',
}
REDUCTIONS = {'_np_sum', '_np_prod', '_np_max', '_np_min', '_np_any',
              '_np_all', '_npi_mean', '_npi_std', '_npi_var', '_np_cumsum',
              '_npi_argmax', '_npi_argmin'}
REFLECTED = {'subtract', 'mod', 'power', 'true_divide', 'floor_divide',
             'arctan2', 'copysign', 'ldexp'}
NON_SMOOTH = {'floor_divide', 'mod', 'fmod', 'rint', 'ceil', 'floor',
              'trunc', 'fix', 'sign', 'around'}
LEGACY_BINARY_SUFFIX = {
    'add', 'sub', 'mul', 'div', 'mod', 'power', 'maximum', 'minimum',
    'hypot', 'equal', 'not_equal', 'greater', 'greater_equal', 'lesser',
    'lesser_equal', 'logical_and', 'logical_or', 'logical_xor',
}
_UPDATE_ARRAYS = {'weight', 'grad', 'mean', 'var', 'mom', 'n', 'z', 'd',
                  'v', 'g_acc', 'delta', 'history', 'acc_g', 'acc_delta',
                  'weight32', 'g_update', 'r1', 'r2'}

# ops held against the JAX package in other files
EXEMPT = {
    **{n: 'tests/test_torch_detection.py' for n in (
        'box_decode', 'box_encode', 'box_iou', 'box_nms', 'correlation',
        'deformable_convolution', 'multibox_detection', 'multibox_target',
        'proposal', 'psroi_pooling')},
    **{n: 'tests/test_torch_graph_ops.py' for n in (
        'dgl_adjacency', 'dgl_csr_neighbor_non_uniform_sample',
        'dgl_csr_neighbor_uniform_sample', 'dgl_graph_compact',
        'dgl_subgraph', 'edge_id')},
    'ctc_loss': 'tests/test_torch_ctc.py',
    'rnn': 'tests/test_torch_rnn.py',
    'custom': 'tests/test_torch_custom_op.py',
    'dropout': 'tests/test_torch_autograd.py (random mask)',
    'multi_head_attention': 'tests/test_torch_symbol.py',
    'interleaved_matmul_selfatt_qk': 'tests/test_torch_symbol.py',
    'interleaved_matmul_selfatt_valatt': 'tests/test_torch_symbol.py',
}

# drawn from a random stream: held by dtype and shape, and by their laws
RANDOM = {
    '_npi_uniform', '_npi_normal', '_npi_gamma', '_npi_bernoulli',
    '_npi_exponential', '_npi_gumbel', '_npi_logistic', '_npi_laplace',
    '_npi_rayleigh', '_npi_weibull', '_npi_pareto', '_npi_powerd',
    '_npi_multinomial', '_npi_choice', '_npi_shuffle', '_npi_randint',
    'shuffle', 'sample_multinomial', 'sample_uniform', 'sample_normal',
    'sample_gamma', 'sample_unique_zipfian', 'image_random_lighting',
    'image_random_brightness', 'image_random_contrast',
    'image_random_saturation', 'image_random_hue',
    'image_random_color_jitter', 'image_random_flip_left_right',
    'image_random_flip_top_bottom', 'random_uniform', 'random_normal',
    'random_gamma', 'random_exponential', 'random_poisson',
    'random_negative_binomial', 'random_generalized_negative_binomial',
    'random_randint', 'random_uniform_like', 'random_normal_like',
    'random_gamma_like', 'random_exponential_like', 'random_poisson_like',
    'random_negative_binomial_like',
    'random_generalized_negative_binomial_like', 'dropout',
}
# decompositions with sign and order freedoms, held by invariants
INVARIANT = {'_npi_svd', '_npi_eig', '_npi_eigh', 'linalg_syevd'}
# ops that compute on the host whatever their inputs' device (the
# samplers among them draw from the port's CPU generator)
HOST = {'calibrate_entropy', 'sample_unique_zipfian', 'dgl_subgraph',
        'dgl_csr_neighbor_uniform_sample',
        'dgl_csr_neighbor_non_uniform_sample', 'dgl_graph_compact'}


def parse_np_op(op):
    """(base, scalar, reflected) of an ``_npi_*``/``_np_*`` op name."""
    name = op[5:] if op.startswith('_npi_') else op[4:]
    scalar = name.endswith('_scalar')
    base = name[:-len('_scalar')] if scalar else name
    reflected = False
    if scalar and base.startswith('r') and base[1:] in REFLECTED:
        base, reflected = base[1:], True
    return base, scalar, reflected


class _Draw:
    """Seeded draws for one op's case."""

    def __init__(self, op):
        self.rng = onp.random.RandomState(zlib.crc32(op.encode()) & 0xffff)

    def f(self, *shape, low=-1.0, high=1.0):
        return self.rng.uniform(low, high, shape).astype(_F32)

    def i(self, *shape, low=0, high=8):
        return self.rng.randint(low, high, shape).astype(onp.int32)

    def spd(self, n=4):
        a = self.rng.randn(n, n).astype(_F32)
        return a @ a.T + 3.0 * onp.eye(n, dtype=_F32)


def _family(op, r, fn=None):
    if op.startswith('_np'):
        base, scalar, _ = parse_np_op(op)
        if op in REDUCTIONS:
            return (r.f(3, 4),), {}
        if base in BINARY_NAMES:
            if base in BINARY_INT:
                a, b = r.i(3, 4, low=1, high=5), r.i(3, 4, low=1, high=4)
            else:
                a, b = r.f(3, 4, low=0.5, high=2.0), r.f(3, 4, low=0.5,
                                                         high=2.0)
            return ((a, 2) if scalar else (a, b)), {}
        if base in UNARY_NAMES:
            if base in UNARY_INT:
                return (r.i(3, 4),), {}
            lo, hi = UNARY_DOMAIN.get(base, (-1.0, 1.0))
            return (r.f(3, 4, low=lo, high=hi),), {}
        return None
    if op in UNARY_NAMES:
        lo, hi = UNARY_DOMAIN.get(op, (-1.0, 1.0))
        return (r.f(3, 4, low=lo, high=hi),), {}
    if op.startswith('broadcast_') and \
            op[len('broadcast_'):] in LEGACY_BINARY_SUFFIX:
        return (r.f(3, 4, low=0.5, high=2.0), r.f(3, 4, low=0.5,
                                                  high=2.0)), {}
    if op.endswith('_update') and not op.startswith(('multi_',
                                                     'preloaded_')) \
            and fn is not None:
        args = []
        for p in inspect.signature(fn).parameters.values():
            if p.name in _UPDATE_ARRAYS:
                if p.name in ('r1', 'r2'):
                    args.append(r.f(1, low=0.5, high=1.0))
                elif p.name in ('weight', 'grad', 'g_update'):
                    args.append(r.f(3, 4, low=0.1, high=1.0))
                else:
                    args.append(onp.zeros((3, 4), _F32))
            elif p.default is inspect.Parameter.empty:
                return None
            else:
                break
        return tuple(args), {}
    return None


def _np_explicit(op, r):
    """The JAX sweep's ``_explicit_cases`` for the numpy namespace."""
    a34, a44, v6 = r.f(3, 4), r.f(4, 4), r.f(6)
    ints = r.i(5, low=0, high=4)
    spd = r.spd()
    samplers = {'_npi_uniform', '_npi_normal', '_npi_gamma',
                '_npi_bernoulli', '_npi_exponential', '_npi_gumbel',
                '_npi_logistic', '_npi_laplace', '_npi_rayleigh',
                '_npi_weibull', '_npi_pareto', '_npi_powerd'}
    if op in samplers:
        return {'args': (), 'kwargs': {'size': (64,)}}
    table = {
        '_np_copy': (a34,), '_npi_around': (a34,),
        '_npi_nan_to_num': (onp.asarray([1.0, onp.nan, onp.inf], _F32),),
        '_npi_average': (a34,), '_npi_norm': (a34,),
        '_npi_percentile': (a34, 50.0), '_npi_quantile': (a34, 0.5),
        '_npi_diff': (v6,), '_npi_ediff1d': (v6,),
        '_npi_bincount': (ints,),
        '_np_reshape': (a34, (4, 3)), '_np_transpose': (a34,),
        '_np_squeeze': (r.f(3, 1, 4),), '_np_moveaxis': (a34, 0, 1),
        '_npi_swapaxes': (a34, 0, 1), '_np_roll': (a34, 1),
        '_npi_flip': (a34, 0), '_npi_rot90': (a34,),
        '_npi_broadcast_to': (r.f(1, 4), (3, 4)),
        '_npi_expand_dims': (a34, 0),
        '_npi_concatenate': (a34, a34), '_npi_stack': (a34, a34),
        '_npi_vstack': (a34, a34), '_npi_hstack': (a34, a34),
        '_npi_dstack': (a34, a34), '_npi_column_stack': (v6, v6),
        '_npi_split': (a34, 2, 1), '_npi_hsplit': (a34, 2),
        '_npi_vsplit': (r.f(4, 3), 2), '_npi_dsplit': (r.f(2, 2, 4), 2),
        '_npi_array_split': (a34, 3, 1),
        '_np_atleast_1d': (v6,), '_np_atleast_2d': (v6,),
        '_np_atleast_3d': (v6,),
        '_np_diag': (v6,), '_np_diagflat': (v6,), '_np_diagonal': (a44,),
        '_np_trace': (a44,), '_npi_tril': (a44,), '_npi_triu': (a44,),
        '_npi_diag_indices_from': (a44,),
        '_npi_pad': (a34, ((1, 1), (0, 0))),
        '_npi_squeeze': (r.f(3, 1, 4),), '_npi_tile': (a34, (2, 1)),
        '_npi_repeat': (a34, 2), '_npi_ravel': (a34,),
        '_npi_share_memory': (a34, a34),
        '_npi_insert_scalar': (v6, 2, 9.0),
        '_npi_insert_slice': (v6, onp.asarray([1.0], _F32), 0, 2, 1),
        '_npi_insert_tensor': (v6, onp.asarray([1, 3], onp.int32), 9.0),
        '_npi_delete': (v6, 1),
        '_npi_unique': (ints,), '_npi_nonzero': (ints,),
        '_npi_flatnonzero': (ints,),
        '_npi_searchsorted': (onp.sort(v6), a34),
        '_npi_where': (ints % 2, r.f(5), r.f(5)),
        '_npi_where_lscalar': (ints % 2, r.f(5), 1.0),
        '_npi_where_rscalar': (ints % 2, r.f(5), 1.0),
        '_npi_where_scalar2': (ints % 2, 1.0, 0.0),
        '_npi_boolean_mask_assign_scalar': (a34, a34 > 0, 0.5),
        '_npi_boolean_mask_assign_tensor': (a34, a34 > 0,
                                            onp.zeros_like(a34)),
        '_npi_polyval': (r.f(3), v6),
        '_npi_constraint_check': (onp.asarray([True, True]),),
        '_npi_matmul': (a34, r.f(4, 3)), '_np_dot': (a34, r.f(4, 3)),
        '_npi_tensordot': (a34, r.f(4, 3), (1,), (0,)),
        '_npi_tensordot_int_axes': (a34, r.f(4, 3), 1),
        '_npi_kron': (r.f(2, 2), r.f(2, 2)),
        '_npi_einsum': {'args': (a34, r.f(4, 3)),
                        'kwargs': {'subscripts': 'ij,jk->ik'}},
        '_npi_cross': (r.f(3), r.f(3)), '_npi_vdot': (v6, v6),
        '_npi_inner': (v6, v6), '_npi_outer': (v6, v6),
        '_npi_cholesky': (spd,), '_npi_svd': (a34,),
        '_npi_eig': (spd,), '_npi_eigh': (spd,),
        '_npi_eigvals': (spd,), '_npi_eigvalsh': (spd,),
        '_npi_solve': (spd, r.f(4)), '_npi_lstsq': (a34, r.f(3)),
        '_npi_inv': (spd,), '_npi_pinv': (a34, 1e-15),
        '_npi_pinv_scalar_rcond': (a34,),
        '_npi_tensorinv': (r.f(4, 2, 2), 1),
        '_npi_tensorsolve': (spd, r.f(4)),
        '_npi_matrix_rank': (a34,), '_npi_det': (spd,),
        '_npi_slogdet': (spd,), '_npi_qr': (a34,),
        '_npi_multi_dot': (a34, r.f(4, 3), r.f(3, 2)),
        '_npi_matrix_power': (spd, 2),
        '_npi_zeros': ((2, 3),), '_npi_ones': ((2, 3),),
        '_npi_full': ((2, 3), 7.0), '_npi_full_like': (a34, 7.0),
        '_npi_arange': (0, 5, 1), '_npi_linspace': (0.0, 1.0, 5),
        '_npi_logspace': (0.0, 2.0, 5), '_npi_eye': (3,),
        '_npi_identity': (3,), '_npi_indices': ((2, 3),),
        '_npi_tri': (3,), '_npi_hanning': (8,), '_npi_hamming': (8,),
        '_npi_blackman': (8,), '_npi_meshgrid': (v6, v6),
        '_npi_multinomial': {'args': (5, [0.3, 0.7]), 'kwargs': {}},
        '_npi_choice': {'args': (8,), 'kwargs': {'size': (4,)}},
        '_npi_shuffle': (v6,),
        '_npi_randint': {'args': (0, 9), 'kwargs': {'size': (8,)}},
    }
    return table.get(op)


def _legacy_explicit(op, r):
    """The JAX sweep's ``_legacy_explicit_cases``."""
    a34, v6 = r.f(3, 4), r.f(6)
    nchw = r.f(2, 3, 8, 8)
    hwc = r.f(8, 8, 3, low=0.0, high=1.0)
    spd = r.spd()
    spd_b = onp.stack([r.spd(), r.spd()])
    w, g = r.f(3, 4), r.f(3, 4)
    zeros = onp.zeros((3, 4), _F32)
    half = (r.f(3, 4, low=0.5, high=2.0), 2.0)
    scalar_ops = ('div_scalar', 'rdiv_scalar', 'plus_scalar', 'minus_scalar',
                  'rminus_scalar', 'mul_scalar', 'mod_scalar', 'rmod_scalar',
                  'power_scalar', 'rpower_scalar', 'maximum_scalar',
                  'minimum_scalar', 'equal_scalar', 'not_equal_scalar',
                  'greater_scalar', 'greater_equal_scalar', 'lesser_scalar',
                  'lesser_equal_scalar', 'logical_and_scalar',
                  'logical_or_scalar', 'logical_xor_scalar')
    if op in scalar_ops:
        return half
    i8 = onp.clip(a34 * 100, -127, 127).astype(onp.int8)
    table = {
        'adaptive_avg_pooling2d': (nchw, (2, 2)),
        'all_finite': (a34, v6), 'amp_cast': (a34, 'float16'),
        'arange_like': (a34,),
        'argmin': (a34, 1), 'prod': (a34, 1), 'cumprod': (a34, 1),
        'nanprod': (a34, 1),
        'batch_take': (a34, r.i(3, low=0, high=4)),
        'bilinear_resize2d': {'args': (nchw,),
                              'kwargs': {'height': 4, 'width': 4}},
        'bilinear_sampler': (nchw, onp.zeros((2, 2, 4, 4), _F32)),
        'boolean_mask': (a34, onp.asarray([1, 0, 1], onp.int32)),
        'broadcast_axis': (r.f(1, 4), 0, 3),
        'broadcast_to': (r.f(1, 4), (3, 4)),
        'cast_storage': (a34, 'row_sparse'),
        'depth_to_space': (r.f(1, 8, 2, 2), 2),
        'space_to_depth': (r.f(1, 2, 4, 4), 2),
        'div_sqrt_dim': (a34,),
        'dot_csr_dense': (a34, r.f(4, 2)),
        'grid_generator': {'args': (r.f(2, 6),),
                           'kwargs': {'transform_type': 'affine',
                                      'target_shape': (4, 4)}},
        'group_norm': (nchw, onp.ones((1, 3, 1, 1), _F32),
                       onp.zeros((1, 3, 1, 1), _F32), 3),
        'histogram': (a34, 5, (-1.0, 1.0)),
        'image_crop': {'args': (hwc,), 'kwargs': {'x': 1, 'y': 1,
                                                  'width': 4, 'height': 4}},
        'image_flip_left_right': (hwc,), 'image_flip_top_bottom': (hwc,),
        'image_normalize': (r.f(3, 8, 8, low=0.0, high=1.0),
                            (0.5, 0.5, 0.5), (0.2, 0.2, 0.2)),
        'image_resize': (hwc, (4, 4)), 'image_to_tensor': (hwc,),
        'index_add': (v6, r.i(3, low=0, high=6), r.f(3)),
        # distinct indices: a repeated one makes which copy lands
        # unspecified (MXNet's too), and the card and the CPU differ
        'index_copy': (v6, r.rng.permutation(6)[:3].astype(onp.int32),
                       r.f(3)),
        'instance_norm': (nchw, onp.ones((3,), _F32),
                          onp.zeros((3,), _F32)),
        'interleaved_matmul_encdec_qk': (r.f(5, 2, 8), r.f(5, 2, 16), 2),
        'interleaved_matmul_encdec_valatt': (r.f(5, 2, 16), r.f(4, 5, 5), 2),
        'l2_normalization': (a34,),
        'lamb_update_phase1': (w, g, zeros, zeros),
        'lamb_update_phase2': (w, g, r.f(1, low=0.5, high=1.0),
                               r.f(1, low=0.5, high=1.0)),
        'leaky_relu': (a34,),
        'linalg_det': (spd_b,), 'linalg_extractdiag': (spd,),
        'linalg_gemm': (a34, r.f(4, 3), onp.zeros((3, 3), _F32)),
        'linalg_gemm2': (a34, r.f(4, 3)),
        'linalg_inverse': (spd_b,), 'linalg_makediag': (v6,),
        'linalg_potrf': (spd,), 'linalg_potri': (spd,),
        'linalg_slogdet': (spd,), 'linalg_sumlogdiag': (spd,),
        'linalg_syrk': (a34,), 'linalg_trmm': (spd, r.f(4, 4)),
        'linalg_trsm': (spd, r.f(4, 4)),
        'linspace': (0.0, 1.0, 5), 'lrn': (nchw,), 'make_loss': (a34,),
        'moments': (a34, (0, 1)),
        'multibox_prior': (nchw, (0.5,), (1.0,)),
        'multi_sum_sq': (a34, v6),
        'multi_sgd_update': ([w, v6], [g, r.f(6)], [0.1, 0.1], [0.0, 0.0]),
        'multi_sgd_mom_update': ([w, v6], [g, r.f(6)],
                                 [zeros, onp.zeros(6, _F32)], [0.1, 0.1],
                                 [0.0, 0.0]),
        'multi_mp_sgd_update': ([w], [g], [zeros], [0.1], [0.0]),
        'multi_mp_sgd_mom_update': ([w], [g], [zeros], [zeros], [0.1],
                                    [0.0]),
        'preloaded_multi_sgd_update': ([w], [g], onp.asarray([0.1], _F32),
                                       onp.asarray([0.0], _F32)),
        'preloaded_multi_sgd_mom_update': ([w], [g], [zeros],
                                           onp.asarray([0.1], _F32),
                                           onp.asarray([0.0], _F32)),
        'preloaded_multi_mp_sgd_update': ([w], [g], [zeros],
                                          onp.asarray([0.1], _F32),
                                          onp.asarray([0.0], _F32)),
        'preloaded_multi_mp_sgd_mom_update': ([w], [g], [zeros], [zeros],
                                              onp.asarray([0.1], _F32),
                                              onp.asarray([0.0], _F32)),
        'multi_lamb_update': ([w], [g], [zeros], [zeros], [0.1], [0.01],
                              [1]),
        'multi_lans_update': ([w], [g], [zeros], [zeros], [0.1], [0.01],
                              [1]),
        'multi_adamw_update': ([w], [g], [zeros], [zeros],
                               onp.float32(1.0), [0.1], [1.0], [0.01]),
        'ravel_multi_index': (r.i(2, 3, low=0, high=3), (4, 4)),
        'reverse': (a34, 0),
        'roi_align': (nchw, onp.asarray([[0, 0.0, 0.0, 4.0, 4.0]], _F32),
                      (2, 2)),
        'sample_gamma': (r.f(3, low=0.5, high=2.0), r.f(3, low=0.5,
                                                        high=2.0)),
        'sample_multinomial': (onp.asarray([[0.3, 0.7], [0.5, 0.5]],
                                           _F32),),
        'sample_normal': (r.f(3), r.f(3, low=0.5, high=1.0)),
        'sample_uniform': (r.f(3, low=0.0, high=0.4),
                           r.f(3, low=0.5, high=1.0)),
        'sequence_mask_like': (a34, onp.ones((3, 4), _F32)),
        'shape_array': (a34,), 'size_array': (a34,),
        'slice': (a34, (0, 1), (2, 3)), 'slice_axis': (a34, 1, 0, 2),
        'slice_channel': (a34, 2, 1), 'slice_like': (a34, r.f(2, 2)),
        'softmax_cross_entropy': (a34, r.i(3, low=0, high=4)),
        'softmax_output': (a34, r.i(3, low=0, high=4)),
        'softmin': (a34,), 'softsign': (a34,),
        'spatial_transformer': {'args': (nchw, r.f(2, 6)),
                                'kwargs': {'target_shape': (4, 4)}},
        'squeeze': (r.f(3, 1, 4),), 'tile': (a34, (2, 1)), 'triu': (a34,),
        'upsampling': {'args': (nchw,), 'kwargs': {'scale': 2}},
        'random_uniform': {'args': (), 'kwargs': {'shape': (8,)}},
        'random_normal': {'args': (), 'kwargs': {'shape': (8,)}},
        'random_gamma': {'args': (), 'kwargs': {'shape': (8,)}},
        'random_exponential': {'args': (), 'kwargs': {'shape': (8,)}},
        'random_poisson': {'args': (), 'kwargs': {'shape': (8,)}},
        'random_negative_binomial': {'args': (5, 0.5),
                                     'kwargs': {'shape': (8,)}},
        'random_generalized_negative_binomial': {
            'args': (), 'kwargs': {'shape': (8,)}},
        'random_randint': {'args': (0, 9), 'kwargs': {'shape': (8,)}},
        'sparse_retain': (a34, onp.asarray([0, 2], onp.int32)),
        'elemwise_add': (a34, r.f(3, 4)), 'elemwise_sub': (a34, r.f(3, 4)),
        'elemwise_mul': (a34, r.f(3, 4)),
        'elemwise_div': (a34, r.f(3, 4, low=0.5, high=2.0)),
        'repeat': (a34, 2), 'storage_type': (a34,),
        'identity': (a34,), 'ones_like': (a34,),
        'erf': (a34,), 'erfinv': (r.f(3, 4, low=-0.9, high=0.9),),
        'gammaln': (r.f(3, 4, low=0.5, high=3.0),),
        'gelu': (a34,), 'gelu_tanh': (a34,), 'hard_sigmoid': (a34,),
        'rcbrt': (r.f(3, 4, low=0.5, high=2.0),),
        'zeros': {'args': (), 'kwargs': {'shape': (2, 3)}},
        'ones': {'args': (), 'kwargs': {'shape': (2, 3)}},
        'full': {'args': (), 'kwargs': {'shape': (2, 2), 'val': 3.0}},
        'eye': {'args': (), 'kwargs': {'N': 3}},
        'arange': {'args': (), 'kwargs': {'start': 0, 'stop': 6}},
        'diag': (a34,), 'tril': (a34,), 'flip': (a34, (0,)),
        'pad': {'args': (nchw,),
                'kwargs': {'mode': 'constant',
                           'pad_width': (0, 0, 0, 0, 1, 1, 1, 1)}},
        'cumsum': (a34,), 'nansum': (a34,), 'shuffle': (v6,),
        'gamma': (r.f(3, 4, low=0.5, high=3.0),),
        'einsum': {'args': (a34, a34), 'kwargs': {'subscripts': 'ij,ij->i'}},
        'unravel_index': {'args': (onp.asarray([3, 7], onp.int32),),
                          'kwargs': {'shape': (3, 4)}},
        'identity_with_attr_like_rhs': (a34, a34),
        'softmax_activation': (a34,),
        'slice_assign': {'args': (a34, onp.zeros((1, 2), _F32)),
                         'kwargs': {'begin': (0, 0), 'end': (1, 2)}},
        'scatter_plus_scalar': (a34, 1.0), 'scatter_minus_scalar': (a34, 1.0),
        'scatter_elemwise_div': (a34, a34 + 2.0),
        'image_adjust_lighting': {'args': (hwc,),
                                  'kwargs': {'alpha': (0.01, 0.0, -0.01)}},
        'sync_batch_norm_op': (nchw, r.f(3, low=0.5, high=1.5), r.f(3),
                               onp.zeros(3, _F32), onp.ones(3, _F32)),
        'quantized_batch_norm': (i8.reshape(1, 3, 2, 2), onp.ones(3, _F32),
                                 onp.zeros(3, _F32), onp.zeros(3, _F32),
                                 onp.ones(3, _F32), onp.float32(-1.0),
                                 onp.float32(1.0)),
        'mp_lamb_update_phase1': (BF16(w), BF16(g), zeros, zeros, w),
        'mp_lamb_update_phase2': {
            'args': (BF16(w), g, r.f(1, low=0.5, high=1.0),
                     r.f(1, low=0.5, high=1.0), w),
            'kwargs': {'lr': 0.01}},
        'cond': {'args': (onp.asarray(True), lambda xs: xs[0] + 1.0,
                          lambda xs: xs[0] - 1.0, [a34]), 'kwargs': {}},
        'while_loop': {'args': (lambda i: i[0] < 3,
                                lambda i: ((), (i[0] + 1,)),
                                (onp.asarray(0, onp.int32),)),
                       'kwargs': {'max_iterations': 8}},
        'foreach': {'args': (lambda x, s: (x * 2.0, s), v6, ()),
                    'kwargs': {}},
    }
    return table.get(op)


def _extra(op, r):
    """Cases for the ops the JAX sweep's tables leave to other files."""
    a34 = r.f(3, 4)
    nchw = r.f(2, 3, 8, 8)
    i8 = onp.clip(r.f(3, 8) * 127, -127, 127).astype(onp.int8)
    w8 = onp.clip(r.f(5, 8) * 127, -127, 127).astype(onp.int8)
    q4 = onp.clip(nchw * 100, -127, 127).astype(onp.int8)
    img = r.f(8, 8, 3, low=0.0, high=1.0)
    seq = (r.f(5, 2, 3), onp.asarray([3, 5], _F32))
    zero34 = onp.zeros((3, 4), _F32)
    if op.startswith('random_') and op.endswith('_like'):
        return (onp.zeros((64,), _F32),)
    if op in ('image_random_brightness', 'image_random_contrast',
              'image_random_saturation', 'image_random_hue'):
        return (img, 0.8, 1.2)
    table = {
        'InstanceNorm': (nchw, onp.ones(3, _F32), onp.zeros(3, _F32)),
        'L2Normalization': (a34,), 'MakeLoss': (a34,),
        'SliceChannel': (a34, 2, 1), 'SoftmaxOutput': (a34, r.i(3, high=4)),
        'activation': (a34,), 'add_n': (a34, r.f(3, 4)),
        'allclose': (a34, a34 + 1e-7),
        'amp_multicast': (a34, r.f(3, 4).astype(onp.float16)),
        'argmax': (a34, 1), 'argmax_channel': (a34,), 'argsort': (a34,),
        'batch_dot': (r.f(2, 3, 4), r.f(2, 4, 5)),
        'batch_norm': (nchw, r.f(3, low=0.5, high=1.5), r.f(3),
                       onp.zeros(3, _F32), onp.ones(3, _F32)),
        'bipartite_matching': (r.f(3, 4, low=0.0, high=1.0),),
        'blockgrad': (a34,), 'broadcast_like': (r.f(1, 4), a34),
        'calibrate_entropy': (onp.abs(r.f(64)) + 0.1,
                              onp.linspace(-1, 1, 65).astype(_F32), 15),
        'cast': (a34, 'float16'), 'clip': (a34, -0.5, 0.5),
        'col2im': (r.f(1, 8, 9), (4, 4), (2, 2)),
        'concat': (a34, r.f(3, 2)),
        'convolution': {'args': (nchw, r.f(4, 3, 3, 3)),
                        'kwargs': {'kernel': (3, 3), 'num_filter': 4,
                                   'no_bias': True}},
        'count_sketch': (r.f(2, 6), r.i(6, high=4),
                         onp.sign(r.f(6)).astype(_F32), 4),
        'deconvolution': {'args': (nchw, r.f(3, 2, 3, 3)),
                          'kwargs': {'kernel': (3, 3), 'num_filter': 2,
                                     'no_bias': True}},
        'dequantize': (i8, -1.0, 1.0),
        'dot': (a34, r.f(4, 2)), 'embedding': (r.i(5, high=4), r.f(4, 3)),
        'expand_dims': (a34, 1), 'fft': (r.f(2, 8),), 'flatten': (nchw,),
        'fully_connected': (r.f(2, 4), r.f(3, 4), r.f(3)),
        'gather_nd': (a34, r.i(2, 3, high=3)),
        'getnnz': (onp.where(a34 > 0, a34, 0).astype(_F32),),
        'gradient_multiplier': (a34, -1.0),
        'hawkes_ll': (r.f(2, 3, low=0.5, high=1.0), r.f(3, low=0.1, high=0.5),
                      r.f(3, low=1.0, high=2.0), onp.zeros((2, 3), _F32),
                      r.f(2, 4, low=0.1, high=1.0), r.i(2, 4, high=3),
                      onp.asarray([4, 2], _F32),
                      onp.asarray([5.0, 4.0], _F32)),
        'identity_attach_kl_sparse_reg': (r.f(4, 3, low=0.1, high=0.9),),
        'ifft': (r.f(2, 8),), 'im2col': (nchw, (3, 3)),
        'index_array': (a34,), 'khatri_rao': (r.f(2, 3), r.f(4, 3)),
        'layer_norm': (a34, onp.ones(4, _F32), onp.zeros(4, _F32)),
        'linalg_extracttrian': (r.f(4, 4),), 'linalg_gelqf': (r.f(3, 4),),
        'linalg_maketrian': (r.f(10),), 'linalg_syevd': (r.spd(),),
        'linear_regression_output': (a34, r.f(3, 4)),
        'log_softmax': (a34,),
        'logistic_regression_output': (a34, r.f(3, 4)),
        'mae_regression_output': (a34, r.f(3, 4)),
        'max': (a34, 1), 'mean': (a34, 0), 'min': (a34,),
        'multi_all_finite': (a34, r.f(6)),
        'multi_lars': (r.f(3, low=0.1, high=1.0), r.f(3, low=0.1, high=1.0),
                       r.f(3, low=0.1, high=1.0), r.f(3, low=0.0, high=0.1)),
        'multi_mp_adamw_update': {
            'args': ([a34.astype(onp.float16)], [r.f(3, 4)], [zero34],
                     [zero34], [a34]),
            'kwargs': {'lrs': [0.1], 'etas': [1.0], 'wds': [0.01]}},
        'multi_mp_lamb_update': {
            'args': ([a34.astype(onp.float16)], [r.f(3, 4)], [zero34],
                     [zero34], [a34]),
            'kwargs': {'lrs': [0.1], 'wds': [0.01], 'step_count': [1]}},
        'nnz': (onp.where(a34 > 0, a34, 0).astype(_F32),),
        'norm': (a34,), 'one_hot': {'args': (r.i(5, high=4),),
                                    'kwargs': {'depth': 4}},
        'pick': (a34, r.i(3, high=4)),
        'pooling': {'args': (nchw,), 'kwargs': {'kernel': (2, 2),
                                                'stride': (2, 2)}},
        'quadratic': {'args': (a34,), 'kwargs': {'a': 2.0, 'b': -1.0,
                                                 'c': 0.5}},
        'quantize': (a34, -1.0, 1.0), 'quantize_v2': (a34,),
        'quantized_act': (i8, -1.0, 1.0),
        'quantized_concat': {'args': (i8, -1.0, 1.0, i8, -2.0, 2.0),
                             'kwargs': {'dim': 0}},
        'quantized_conv': {
            'args': (q4, onp.clip(r.f(4, 3, 3, 3) * 100, -127,
                                  127).astype(onp.int8)),
            'kwargs': {'min_data': -1.0, 'max_data': 1.0,
                       'min_weight': -1.0, 'max_weight': 1.0,
                       'kernel': (3, 3), 'num_filter': 4, 'no_bias': True}},
        'quantized_elemwise_add': (i8, i8, -1.0, 1.0, -2.0, 2.0),
        'quantized_elemwise_mul': (i8, i8, -1.0, 1.0, -2.0, 2.0),
        'quantized_embedding': (r.i(4, high=3), i8, -1.0, 1.0),
        'quantized_flatten': (q4, -1.0, 1.0),
        'quantized_fully_connected': {
            'args': (i8, w8),
            'kwargs': {'min_data': -1.0, 'max_data': 1.0,
                       'min_weight': -1.0, 'max_weight': 1.0,
                       'no_bias': True}},
        'quantized_pooling': {'args': (q4, -1.0, 1.0),
                              'kwargs': {'kernel': (2, 2), 'stride': (2, 2),
                                         'pool_type': 'avg'}},
        'relu': (a34,),
        'requantize': ((r.f(3, 4) * 1e6).astype(onp.int32), -100.0, 100.0),
        'reset_arrays': (a34, r.f(6)),
        'reshape': {'args': (a34,), 'kwargs': {'shape': (2, -1)}},
        'reshape_like': (r.f(6), r.f(2, 3)),
        'roi_pooling': (nchw, onp.asarray([[0, 0.0, 0.0, 5.0, 5.0],
                                           [1, 2.0, 1.0, 7.0, 6.0]], _F32),
                        (2, 2)),
        'round': (onp.asarray([-2.5, -0.5, 0.5, 1.5, 2.5], _F32),),
        'round_ste': (a34 * 3,),
        'rroi_align': (nchw, onp.asarray([[0, 4.0, 4.0, 4.0, 3.0, 30.0]],
                                         _F32), (2, 2)),
        'rsqrt': (r.f(3, 4, low=0.5, high=2.0),),
        'scatter_nd': {'args': (r.f(3), onp.asarray([[0, 2, 1]], onp.int32)),
                       'kwargs': {'shape': (4,)}},
        'scatter_set_nd': (r.f(4), r.f(2), onp.asarray([[0, 3]], onp.int32)),
        'sequence_last': {'args': seq,
                          'kwargs': {'use_sequence_length': True}},
        'sequence_mask': {'args': seq,
                          'kwargs': {'use_sequence_length': True,
                                     'value': -1.0}},
        'sequence_reverse': {'args': seq,
                             'kwargs': {'use_sequence_length': True}},
        'sigmoid': (a34,), 'sign_ste': (a34,),
        'slice_assign_scalar': {'args': (a34,),
                                'kwargs': {'scalar': 7.0, 'begin': (1, 2),
                                           'end': (3, 4)}},
        'smooth_l1': (a34 * 3,), 'softmax': (a34,), 'sort': (a34,),
        'split': {'args': (a34,), 'kwargs': {'num_outputs': 2}},
        'split_v2': {'args': (r.f(10),), 'kwargs': {'indices': (3, 7)}},
        'square_sum': (a34, 1), 'stack': (a34, r.f(3, 4)),
        'stop_gradient': (a34,), 'sum': (a34, 1), 'swapaxes': (a34,),
        'take': (a34, r.i(2, high=3)),
        'topk': {'args': (a34,), 'kwargs': {'k': 2, 'ret_typ': 'both'}},
        'transpose': (a34,),
        'where': ((a34 > 0).astype(_F32), a34, r.f(3, 4)),
        'zeros_like': (a34,),
        'image_random_color_jitter': (img, 0.2, 0.2, 0.2, 0.1),
        'image_random_lighting': (img,),
        'image_random_flip_left_right': (r.f(8, 8, 3),),
        'image_random_flip_top_bottom': (r.f(8, 8, 3),),
        'sample_unique_zipfian': {'args': (100,), 'kwargs': {'shape': (8,)}},
    }
    return table.get(op)


def _boxes(r, *shape, size=0.4):
    """Corner boxes (x0, y0, x1, y1) in the unit square, none empty."""
    xy = r.rng.rand(*shape, 2) * 0.8
    return onp.concatenate([xy, xy + 0.02 + r.rng.rand(*shape, 2) * size],
                           -1).astype(_F32)


def _clique(n=5):
    """The edge-id matrix of the n-clique (ids 1.. in row order)."""
    dense = onp.zeros((n, n), _F32)
    dense[~onp.eye(n, dtype=bool)] = onp.arange(1, n * (n - 1) + 1)
    return dense


_CUSTOM_TYPE = 'op_cases_scale_shift'


def _custom_op_type():
    """The op type of the ``custom`` card case, 2x + 1 as a user's
    CustomOp, registered on first use."""
    from . import operator
    if _CUSTOM_TYPE in operator._registry:
        return _CUSTOM_TYPE

    class ScaleShift(operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], in_data[0] * 2.0 + 1.0)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0], out_grad[0] * 2.0)

    @operator.register(_CUSTOM_TYPE)
    class ScaleShiftProp(operator.CustomOpProp):
        def create_operator(self, ctx, shapes, dtypes):
            return ScaleShift()

    return _CUSTOM_TYPE


def _card_extra(op, r):
    """Cases for the ``EXEMPT`` ops, whose parity with the JAX package is
    held in other files: the card runs them against the CPU on these."""
    nchw = r.f(1, 4, 6, 6)
    lstm = dict(T=5, N=3, I=4, H=6)
    n_lstm = 4 * lstm['H'] * (lstm['I'] + lstm['H'] + 2)
    clique = _clique()
    probs = onp.exp(r.f(2, 4, 20) * 3)
    table = {
        'box_iou': (_boxes(r, 5), _boxes(r, 6)),
        'box_nms': {'args': (onp.concatenate(
            [r.i(2, 12, 1, high=3).astype(_F32),
             r.rng.permutation(24).reshape(2, 12, 1).astype(_F32) / 24,
             _boxes(r, 2, 12)], -1),),
            'kwargs': {'overlap_thresh': 0.3, 'id_index': 0}},
        'box_encode': ((r.f(2, 10) > 0).astype(_F32),
                       r.i(2, 10, high=3).astype(_F32), _boxes(r, 2, 10),
                       _boxes(r, 2, 3)),
        'box_decode': (r.f(2, 10, 4) * 0.5, _boxes(r, 2, 10)),
        'multibox_target': (_boxes(r, 1, 20, size=0.3),
                            onp.concatenate([onp.asarray(
                                [[[1.0], [0.0], [-1.0]], [[2.0], [-1.0],
                                                          [-1.0]]], _F32),
                                _boxes(r, 2, 3)], -1),
                            r.f(2, 4, 20)),
        'multibox_detection': {
            'args': (probs / probs.sum(1, keepdims=True), r.f(2, 80) * 0.2,
                     _boxes(r, 1, 20)),
            'kwargs': {'threshold': 0.2}},
        'proposal': {'args': (r.f(1, 24, 4, 5, low=0.0, high=1.0),
                              r.f(1, 48, 4, 5) * 0.1,
                              onp.asarray([[64.0, 80.0, 1.0]], _F32)),
                     'kwargs': {'rpn_pre_nms_top_n': 50,
                                'rpn_post_nms_top_n': 10,
                                'rpn_min_size': 4}},
        'psroi_pooling': (r.f(1, 8, 6, 6), onp.asarray(
            [[0, 1.0, 1.0, 20.0, 18.0]], _F32), 0.25, 2, 2),
        'correlation': {'args': (r.f(1, 3, 6, 7), r.f(1, 3, 6, 7)),
                        'kwargs': {'kernel_size': 1, 'max_displacement': 1}},
        'deformable_convolution': {
            'args': (nchw, r.f(1, 18, 6, 6) * 0.7, r.f(3, 4, 3, 3)),
            'kwargs': {'num_filter': 3, 'no_bias': True}},
        'dgl_adjacency': (onp.diag(onp.asarray([1.0, 2.0, 3.0], _F32)),),
        'edge_id': (onp.diag(onp.asarray([1.0, 2.0, 3.0], _F32)),
                    onp.asarray([0, 0, 1, 1, 2, 2], onp.int32),
                    onp.asarray([0, 1, 1, 2, 0, 2], onp.int32)),
        'dgl_subgraph': {'args': (clique, onp.asarray([0, 2, 3], onp.int32)),
                         'kwargs': {'return_mapping': True}},
        'dgl_csr_neighbor_uniform_sample': {
            'args': (clique, onp.asarray([0, 1], onp.int32)),
            'kwargs': {'num_hops': 2, 'num_neighbor': 2,
                       'max_num_vertices': 5}},
        'dgl_csr_neighbor_non_uniform_sample': {
            'args': (clique, onp.asarray([1.0, 1.0, 0.5, 0.0, 0.2], _F32),
                     onp.asarray([0, 3], onp.int32)),
            'kwargs': {'num_hops': 1, 'num_neighbor': 2,
                       'max_num_vertices': 5}},
        'dgl_graph_compact': {'args': (clique,),
                              'kwargs': {'graph_sizes': (3,),
                                         'return_mapping': True}},
        'ctc_loss': (r.f(6, 2, 5) * 2, onp.asarray(
            [[1, 2, -1, -1], [3, -1, -1, -1]], _F32)),
        'rnn': {'args': (r.f(lstm['T'], lstm['N'], lstm['I']),
                         r.f(n_lstm) * 0.4, r.f(1, lstm['N'], lstm['H']),
                         r.f(1, lstm['N'], lstm['H'])),
                'kwargs': {'state_size': lstm['H'], 'mode': 'lstm'}},
        'dropout': {'args': (onp.ones((4096,), _F32),),
                    'kwargs': {'p': 0.3, 'mode': 'always'}},
        # head dim 64: the flash kernels take CUDA tensors
        'multi_head_attention': {'args': (r.f(2, 16, 128), r.f(2, 16, 128),
                                          r.f(2, 16, 128)),
                                 'kwargs': {'num_heads': 2}},
        'interleaved_matmul_selfatt_qk': {'args': (r.f(5, 2, 24),),
                                          'kwargs': {'heads': 2}},
        'interleaved_matmul_selfatt_valatt': {
            'args': (r.f(5, 2, 24), r.f(4, 5, 5, low=0.0, high=1.0)),
            'kwargs': {'heads': 2}},
    }
    if op == 'custom':
        return {'args': (r.f(3, 4),), 'kwargs': {'op_type': _custom_op_type()}}
    return table.get(op)


def card_case(op, fn=None):
    """``case(op, fn)``, or for an ``EXEMPT`` op the case the card runs it
    on against the CPU."""
    if op not in EXEMPT:
        return case(op, fn)
    c = _card_extra(op, _Draw(op))
    if c is None:
        return None
    if isinstance(c, dict):
        return c['args'], c.get('kwargs', {})
    return c, {}


def case(op, fn=None):
    """(args, kwargs) of ``op``'s sweep case, or None (``fn``: the op's
    function, whose signature the update-op family reads)."""
    r = _Draw(op)
    c = _family(op, r, fn)
    if c is not None:
        return c
    c = _np_explicit(op, r) if op.startswith('_np') else \
        _legacy_explicit(op, r)
    if c is None:
        c = _extra(op, _Draw(op))
    if c is None:
        return None
    if isinstance(c, dict):
        return c['args'], c.get('kwargs', {})
    return c, {}


def to_torch(x, device='cpu'):
    """A case argument for the port: numpy arrays (and BF16 marks) as
    tensors on ``device``, recursively through lists and tuples."""
    import torch
    if isinstance(x, BF16):
        return torch.tensor(x.array, device=device).to(torch.bfloat16)
    if isinstance(x, (onp.ndarray, onp.generic)):
        return torch.tensor(onp.asarray(x), device=device)
    if isinstance(x, (list, tuple)):
        return type(x)(to_torch(v, device) for v in x)
    return x
