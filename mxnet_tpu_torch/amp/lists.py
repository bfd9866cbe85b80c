"""AMP op lists (counterpart of ``mxnet_tpu/amp/lists.py``, ref:
python/mxnet/contrib/amp/lists/symbol_fp16.py).

The port's own copy of the JAX package's lists and family rules, so that
the two packages give every op they both register the same policy.
Three hand lists, mirroring the reference's FP16_FUNCS / FP32_FUNCS /
WIDEST_TYPE_CASTS:

- LP16_OPS: matrix-product ops, run in the target dtype (bfloat16 or
  float16) on the tensor cores.
- FP32_OPS: numerically sensitive ops pinned to fp32.
- WIDEST_OPS: multi-input elementwise ops cast to the widest input dtype.

``derive_policy`` gives every other registered op one policy by family
rules, the hand lists winning; ``policy_table`` runs it over the port's
registry (``base.list_ops``).
"""

# Matrix-product ops: cast float inputs down to the target dtype.
LP16_OPS = [
    'fully_connected',
    'convolution',
    'deconvolution',
    'dot',
    'batch_dot',
    'rnn',
    'interleaved_matmul_selfatt_qk',
    'interleaved_matmul_selfatt_valatt',
    'interleaved_matmul_encdec_qk',
    'interleaved_matmul_encdec_valatt',
]

# Numerically sensitive: cast low-precision float inputs up to fp32.
FP32_OPS = [
    'softmax',
    'log_softmax',
    'softmax_cross_entropy',
    'softmax_output',
    'batch_norm',
    'layer_norm',
    'group_norm',
    'instance_norm',
    'l2_normalization',
    'lrn',
    'norm',
    'exp',
    'log',
    'log2',
    'log10',
    'log1p',
    'expm1',
    'power',
    'erfinv',
    'gamma',
    'gammaln',
    'sum',
    'mean',
    'prod',
    'nansum',
    'nanprod',
    'ctc_loss',
    'smooth_l1',
    'make_loss',
]

# Multi-input elementwise: unify on the widest floating dtype present.
WIDEST_OPS = [
    'broadcast_add',
    'broadcast_sub',
    'broadcast_mul',
    'broadcast_div',
    'broadcast_maximum',
    'broadcast_minimum',
    'broadcast_hypot',
    'broadcast_power',
    'elemwise_add',
    'elemwise_sub',
    'elemwise_mul',
    'elemwise_div',
    'add_n',
    'concat',
    'stack',
    'where',
    'maximum',
    'minimum',
]


# ---------------------------------------------------------------------------
# Full-registry policy derivation: every registered op gets exactly one
# policy:
#
#   lp16        matmul-class, cast float inputs to the target dtype
#   fp32        numerically sensitive, cast low-precision floats up
#   widest      multi-float-input elementwise, unify on widest input
#   nofloat     integer/bool/index/sampling semantics — casting is
#               meaningless or harmful
#   passthrough runs in whatever dtype the inputs already have (an
#               EXPLICIT decision now, not a fallthrough)
#
# The reference's per-dtype lists (ref: python/mxnet/contrib/amp/lists/
# symbol_fp16.py, ~600 lines) are hand-enumerated; here the long tail is
# derived by family rules with the hand lists as overrides, and
# tests/test_torch_amp.py asserts total coverage.
# ---------------------------------------------------------------------------

# Family matching works on NAME TOKENS (underscore-split segments), not
# bare substrings: 'exp' must catch `exp`/`broadcast_exp` but NOT
# `expand_dims`, and 'sign' must catch `sign` but NOT `softsign` or
# `copysign` (those are float math). A few families are genuine
# substrings ('conv' in deconvolution/convolution) and stay that way.
_LP16_PAT = ('conv', 'fully_connected', 'dot', 'gemm', 'matmul', 'einsum',
             'rnn', 'attention', 'krprod')
_FP32_TOKENS = frozenset([
    'softmax', 'norm', 'normalization', 'loss', 'exp', 'expm1', 'log',
    'log2', 'log10', 'log1p', 'gamma', 'gammaln', 'digamma', 'erf',
    'erfinv', 'entropy', 'pdf', 'moments', 'cumsum', 'cumprod', 'mean',
    'var', 'std', 'nanvar', 'nanstd', 'svd', 'det', 'slogdet',
    'inverse', 'potrf', 'potri', 'eig', 'eigh', 'eigvals', 'eigvalsh',
    'trsm', 'trmm', 'syrk', 'syevd', 'gelqf', 'cholesky', 'pinv',
    'lstsq', 'solve', 'tensorinv', 'tensorsolve', 'regression', 'power',
    'softrelu', 'softplus', 'xent'])
_NOFLOAT_TOKENS = frozenset([
    'index', 'indices', 'one', 'hot', 'shape', 'size', 'nonzero',
    'topk', 'sort', 'argsort', 'equal', 'greater', 'less', 'lesser',
    'logical', 'bitwise', 'boolean', 'isnan', 'isinf', 'isfinite',
    'isneginf', 'isposinf', 'quantize', 'quantized', 'requantize',
    'dequantize', 'randint', 'bernoulli', 'multinomial', 'categorical',
    'zipfian', 'unique', 'nnz', 'getnnz', 'digitize', 'searchsorted',
    'bincount', 'invert', 'sign', 'argmax', 'argmin', 'argwhere'])
_WIDEST_PREF = ('broadcast_', 'elemwise_', '_npi_add', '_npi_subtract',
                '_npi_multiply', '_npi_true_divide', '_npi_mod',
                '_npi_maximum', '_npi_minimum', '_npi_fmax',
                '_npi_fmin', '_npi_hypot', '_npi_arctan2', '_npi_ldexp',
                '_npi_copysign', '_npi_lcm', '_npi_gcd')
_WIDEST_NAMES = frozenset(['add_n', 'concat', 'stack', 'where', 'maximum',
                           'minimum', 'hypot', 'vstack', 'hstack',
                           'dstack', 'column_stack'])


def derive_policy(name):
    """Family-rule policy for one op name; explicit lists win."""
    if name in LP16_OPS:
        return 'lp16'
    if name in FP32_OPS:
        return 'fp32'
    if name in WIDEST_OPS:
        return 'widest'
    base = name
    for pre in ('_npi_', '_npx_', '_np_', '_contrib_'):
        if base.startswith(pre):
            base = base[len(pre):]
            break
    low = base.lower()
    toks = set(low.split('_'))
    # order matters: update ops first (their states must never be cast
    # behind the optimizer's back), then integer semantics, then the
    # numerics-sensitive and matmul families
    if low.endswith('_update') or low in ('multi_lars', 'reset_arrays',
                                          'multi_sum_sq', 'multi_all_finite',
                                          'all_finite', 'amp_cast',
                                          'amp_multicast'):
        return 'passthrough'
    if toks & _NOFLOAT_TOKENS or any(t.startswith('arg') for t in toks):
        return 'nofloat'
    if any(p in low for p in _LP16_PAT):
        return 'lp16'
    if toks & _FP32_TOKENS:
        return 'fp32'
    # accumulation-sensitive reductions only: cheap elementwise math
    # (sqrt, square, reciprocal, rsqrt, rcbrt, cbrt) runs in the dtype it
    # receives — pinning those to fp32 upcast bf16 activations
    # mid-network and dragged every downstream op back to fp32
    if low in ('sum', 'prod', 'nansum', 'nanprod', 'max', 'min', 'amax',
               'amin', 'average', 'trace'):
        return 'fp32'
    if name.startswith(_WIDEST_PREF) or low in _WIDEST_NAMES:
        return 'widest'
    return 'passthrough'


def policy_table():
    """{canonical op name: policy} covering every registered op."""
    from ..base import list_ops
    return {op: derive_policy(op) for op in list_ops()}


def derived_ops(policy):
    """All registered ops whose derived policy is `policy`."""
    return sorted(op for op, p in policy_table().items() if p == policy)
