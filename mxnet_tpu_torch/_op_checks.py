"""The port's registered ops held on a device against the same ops on the
CPU, and its samplers held against their laws. ``chip_smoke.py``'s
``ops`` phase and tests/test_torch_ops_cuda.py run these on the card;
tests/test_torch_op_checks.py runs them with the CPU as the device.

``compare_on_device(op, device)`` runs the op on its case
(``_op_cases.card_case``) on the CPU and on ``device``: f32, f64 and
complex64 outputs within rel 1e-4 of the output's scale, bf16 and f16
within 1e-2, integer and bool outputs exactly, dtypes and shapes
exactly. The decompositions with sign or order freedoms are held by
their f64 residuals, the eigenvalues of a general matrix by value. A
sampler's stream differs by device, so its draws are held by dtype and
shape there and by its law in ``law_check``; a sampler that runs on the
host draws from the port's CPU generator on either device and is held
exactly.

``law_check(op, device)`` draws from a sampler on ``device`` and holds
each mean within ``Z_MAX`` standard errors of its law's and each test
(Kolmogorov-Smirnov for a continuous law, chi-square for a discrete
one) at p > ``P_MIN``; structural rules (a shuffle is a permutation, a
dropout survivor is scaled by 1/(1-p), an image op's output is its input
under one drawn factor) are held exactly.
"""
from __future__ import annotations

import numpy as onp

from . import _op_cases as C

__all__ = ['TOL', 'Z_MAX', 'P_MIN', 'LAWS', 'family', 'compare_on_device',
           'law_check']

TOL = {'f32': 1e-4, 'f16': 1e-2}
Z_MAX, P_MIN = 5.0, 1e-4
# decompositions whose signs may differ between cuSOLVER and LAPACK
INVARIANT_ON_DEVICE = C.INVARIANT | {'_npi_qr'}
# results in no defined order (eigenvalues of a general matrix)
UNORDERED = {'_npi_eigvals'}


def _ctx(device):
    import mxnet_tpu_torch as mt
    return mt.Context('cpu' if device == 'cpu' else 'gpu', 0)


def family(op):
    """The family an op's worst error is reported under."""
    if op.startswith(('_np_', '_npi_')):
        return 'numpy'
    for pre, fam in (('linalg_', 'linalg'), ('quantiz', 'quantized'),
                     ('random_', 'random'), ('sample_', 'random'),
                     ('image_', 'image'), ('dgl_', 'graph')):
        if op.startswith(pre):
            return fam
    if op.endswith('_update') or op.startswith(('multi_', 'preloaded_')):
        return 'optimizer'
    return 'legacy'


def _leaves(out):
    if isinstance(out, (list, tuple)):
        return [leaf for o in out for leaf in _leaves(o)]
    return [getattr(out, '_data', out)]


def _by_value(t):
    """t's values sorted (complex by real, then imaginary part)."""
    import torch
    if t.is_complex():
        return t[torch.argsort(t.real * 1e6 + t.imag)]
    return torch.sort(t.reshape(-1)).values


def _residual(op, a, leaves):
    """Relative residual of the decomposition ``leaves`` of ``a``, in f64."""
    a = onp.asarray(a, onp.float64)
    g = [leaf.detach().cpu().numpy() for leaf in leaves]
    g = [x.astype(onp.complex128 if x.dtype.kind == 'c' else onp.float64)
         for x in g]
    if op == '_npi_svd':
        rec = g[0] @ onp.diag(g[1]) @ g[2]
    elif op == '_npi_eig':
        return float(onp.abs(a @ g[1] - g[1] * g[0][None, :]).max() /
                     onp.abs(a).max())
    elif op == '_npi_eigh':
        rec = g[1] @ onp.diag(g[0]) @ g[1].T
    elif op == 'linalg_syevd':
        rec = g[0].T @ onp.diag(g[1]) @ g[0]
    else:                               # _npi_qr
        rec = g[0] @ g[1]
    return float(onp.abs(rec - a).max() / onp.abs(a).max())


def _held(op, got, want):
    """(worst error, fault or None) of ``got`` against ``want``."""
    import torch
    err = 0.0
    for g, w in zip(got, want):
        if not isinstance(w, torch.Tensor):
            if g != w:
                return err, f'{g} != {w}'
            continue
        if g.shape != w.shape or g.dtype != w.dtype:
            return err, (f'{tuple(g.shape)} {g.dtype} != '
                         f'{tuple(w.shape)} {w.dtype}')
        if (op in C.RANDOM and op not in C.HOST) or \
                op in INVARIANT_ON_DEVICE:
            continue
        g, w = g.detach().cpu(), w.detach()
        if op in UNORDERED:
            g, w = _by_value(g), _by_value(w)
        if not (w.is_floating_point() or w.is_complex()):
            if not torch.equal(g, w):
                return err, 'integer/bool output differs'
            continue
        if not w.numel():
            continue
        wide = torch.complex128 if w.is_complex() else torch.float64
        e = float((g.to(wide) - w.to(wide)).abs().max()) / max(
            float(w.abs().max()), 1e-6)
        tol = TOL['f32' if w.dtype in (torch.float32, torch.float64,
                                       torch.complex64) else 'f16']
        err = max(err, e)
        if not e <= tol:
            return err, f'rel err {e:.3g} > {tol}'
    return err, None


def compare_on_device(op, device, seed=0):
    """Run ``op`` on its case on the CPU and on ``device``, each after
    ``mx.random.seed(seed)``; returns (worst error, fault), the fault None
    when the op holds, else a line naming what did not."""
    import torch
    import mxnet_tpu_torch as mt
    from .base import get_op
    fn = get_op(op).fn
    case = C.card_case(op, fn)
    if case is None:
        return 0.0, 'no case'
    args, kwargs = case
    try:
        mt.random.seed(seed)
        with mt.cpu():
            want = _leaves(fn(*C.to_torch(args), **C.to_torch(kwargs)))
        mt.random.seed(seed)
        with _ctx(device):
            got = _leaves(fn(*C.to_torch(args, device),
                             **C.to_torch(kwargs, device)))
        if device == 'cuda':
            torch.cuda.synchronize()
    except Exception as e:              # noqa: BLE001 (named as the fault)
        return 0.0, f'{type(e).__name__}: {e}'
    tensors = [g for g in got if isinstance(g, torch.Tensor)]
    if op not in C.HOST and tensors and \
            not any(g.device.type == device for g in tensors):
        return 0.0, f'no output on {device}'
    if len(got) != len(want):
        return 0.0, f'{len(got)} outputs, {len(want)} on the CPU'
    err, fault = _held(op, got, want)
    if fault is None and op in INVARIANT_ON_DEVICE:
        e = _residual(op, args[0], got)
        err = max(err, e)
        if not e <= TOL['f32']:
            fault = f'residual {e:.3g}'
    return err, fault


# --- the samplers' laws -----------------------------------------------------

def _cont(x, law):
    """(z, p) of continuous draws: the mean in standard errors, KS."""
    import scipy.stats as st
    x = onp.asarray(x, onp.float64).ravel()
    z = abs(x.mean() - law.mean()) / onp.sqrt(law.var() / x.size)
    return float(z), float(st.kstest(x, law.cdf).pvalue)


def _chi2(counts, expected):
    """p of a chi-square test, the bins expecting under 5 lumped into one."""
    import scipy.stats as st
    counts = onp.asarray(counts, onp.float64)
    expected = onp.asarray(expected, onp.float64)
    big = expected >= 5
    obs = list(counts[big]) + ([counts[~big].sum()] if (~big).any() else [])
    exp = list(expected[big]) + ([expected[~big].sum()]
                                 if (~big).any() else [])
    if len(obs) > 1 and exp[-1] < 5:        # a lumped bin still too small
        obs[-2:] = [obs[-2] + obs[-1]]
        exp[-2:] = [exp[-2] + exp[-1]]
    if len(obs) < 2:
        return 1.0
    exp = onp.asarray(exp) * (sum(obs) / sum(exp))
    return float(st.chisquare(obs, exp).pvalue)


def _disc(x, law):
    """(z, p) of integer draws: the mean in standard errors, chi-square
    over the values the law gives at least 5 expected draws."""
    x = onp.asarray(x, onp.float64).ravel().astype(onp.int64)
    z = abs(x.mean() - law.mean()) / onp.sqrt(law.var() / x.size)
    lo = int(min(x.min(), law.ppf(1e-9)))
    hi = int(max(x.max(), law.ppf(1 - 1e-9)))
    ks = onp.arange(lo, hi + 1)
    counts = onp.bincount(x - lo, minlength=ks.size)
    return float(z), _chi2(counts, x.size * law.pmf(ks))


def _cat(x, probs):
    """(z, p) of category draws against ``probs``."""
    x = onp.asarray(x).ravel().astype(onp.int64)
    probs = onp.asarray(probs, onp.float64)
    probs = probs / probs.sum()
    k = onp.arange(probs.size)
    mean, var = (k * probs).sum(), (k * k * probs).sum() - (
        (k * probs).sum()) ** 2
    z = abs(x.mean() - mean) / onp.sqrt(var / x.size)
    counts = onp.bincount(x, minlength=probs.size)
    if counts.size > probs.size:
        return float('inf'), 0.0
    return float(z), _chi2(counts, x.size * probs)


def _binom(k, m, p):
    """z of k successes in m trials of probability p."""
    return float(abs(k - m * p) / onp.sqrt(m * p * (1 - p))), 1.0


def _np(t):
    import torch
    t = getattr(t, '_data', t)
    return t.detach().to(torch.float64).cpu().numpy()


# the samplers that draw ``shape`` (``size`` for _npi_) from their
# parameters alone, and their laws (a scipy distribution and its
# arguments); each ``*_like`` op takes its base op's parameters
_SIMPLE = {
    'random_uniform': (dict(low=-2.0, high=3.0), 'uniform', (-2.0, 5.0)),
    'random_normal': (dict(loc=1.0, scale=2.0), 'norm', (1.0, 2.0)),
    'random_gamma': (dict(alpha=2.5, beta=1.5), 'gamma', (2.5, 0, 1.5)),
    'random_exponential': (dict(lam=4.0), 'expon', (0, 0.25)),
    'random_poisson': (dict(lam=3.5), 'poisson', (3.5,)),
    'random_negative_binomial': (dict(k=4, p=0.4), 'nbinom', (4, 0.4)),
    # mu, alpha: r = 1 / alpha failures, success probability 1/(1+alpha mu)
    'random_generalized_negative_binomial': (dict(mu=2.0, alpha=0.5),
                                             'nbinom', (2.0, 0.5)),
    'random_randint': (dict(low=-3, high=7), 'randint', (-3, 7)),
    '_npi_uniform': (dict(low=1.0, high=2.0), 'uniform', (1.0, 1.0)),
    '_npi_normal': (dict(loc=-1.0, scale=0.5), 'norm', (-1.0, 0.5)),
    '_npi_gamma': (dict(shape=3.0, scale=2.0), 'gamma', (3.0, 0, 2.0)),
    '_npi_exponential': (dict(scale=2.0), 'expon', (0, 2.0)),
    '_npi_gumbel': (dict(loc=1.0, scale=2.0), 'gumbel_r', (1.0, 2.0)),
    '_npi_logistic': (dict(loc=0.5, scale=1.5), 'logistic', (0.5, 1.5)),
    '_npi_laplace': (dict(loc=0.0, scale=2.0), 'laplace', (0.0, 2.0)),
    '_npi_rayleigh': (dict(scale=2.0), 'rayleigh', (0, 2.0)),
    '_npi_weibull': (dict(a=1.5), 'weibull_min', (1.5,)),
    '_npi_pareto': (dict(a=5.0), 'lomax', (5.0,)),
    '_npi_powerd': (dict(a=3.0), 'powerlaw', (3.0,)),
    '_npi_randint': (dict(low=2, high=9), 'randint', (2, 9)),
    '_npi_bernoulli': (dict(prob=0.3), 'bernoulli', (0.3,)),
}


def _law(name, args):
    import scipy.stats as st
    return getattr(st, name)(*args)


def _judge(x, law):
    return _disc(x, law) if hasattr(law.dist, 'pmf') else _cont(x, law)


def _simple(op, device, n):
    from .base import get_op
    kw, name, args = _SIMPLE[op]
    key = 'size' if op.startswith('_npi') else 'shape'
    with _ctx(device):
        x = get_op(op).fn(**kw, **{key: (n,)})
    return x, [_judge(_np(x), _law(name, args))]


def _like(op, device, n):
    import torch
    from .base import get_op
    kw, name, args = _SIMPLE[op[:-len('_like')]]
    x = get_op(op).fn(torch.zeros(n, device=device), **kw)
    return x, [_judge(_np(x), _law(name, args))]


def _rows(op, device, n):
    """The per-row samplers: each row's draws against its own law."""
    import torch
    from .base import get_op
    params = {'sample_uniform': ([-2.0, 5.0], [-1.0, 9.0], 'uniform',
                                 lambda a, b: (a, b - a)),
              'sample_normal': ([0.0, 10.0], [1.0, 3.0], 'norm',
                                lambda a, b: (a, b)),
              'sample_gamma': ([0.5, 4.0], [2.0, 0.5], 'gamma',
                               lambda a, b: (a, 0, b))}[op]
    a, b, name, law_args = params
    x = get_op(op).fn(torch.tensor(a, device=device),
                      torch.tensor(b, device=device), shape=(n // 2,))
    rows = _np(x)
    return x, [_cont(rows[i], _law(name, law_args(a[i], b[i])))
               for i in range(2)]


def _multinomial(op, device, n):
    import torch
    from .base import get_op
    probs = [[0.1, 0.2, 0.7], [0.5, 0.25, 0.25]]
    if op == 'sample_multinomial':
        x = get_op(op).fn(torch.tensor(probs, device=device),
                          shape=(n // 2,))
        rows = _np(x)
        return x, [_cat(rows[i], probs[i]) for i in range(2)]
    draws = 20
    with _ctx(device):
        x = get_op(op).fn(n=draws, pvals=probs[0], size=(n // draws,))
    counts = _np(x)
    out = [_cat(onp.repeat(onp.arange(3), counts.sum(0).astype(onp.int64)),
                probs[0])]
    if not (counts.sum(1) == draws).all():
        out.append((float('inf'), 0.0))
    return x, out


def _choice(op, device, n):
    from .base import get_op
    p = [0.1, 0.2, 0.3, 0.25, 0.15]
    with _ctx(device):
        x = get_op(op).fn(5, size=(n,), p=p)
        y = get_op(op).fn(6, size=(n,))
    return x, [_cat(_np(x), p), _cat(_np(y), [1.0] * 6)]


def _shuffle(op, device, n):
    """A permutation of its input, the first half's mean as that of n/2
    draws without replacement."""
    import torch
    from .base import get_op
    x = get_op(op).fn(torch.arange(n, dtype=torch.float32, device=device))
    v = _np(x)
    if not onp.array_equal(onp.sort(v), onp.arange(n)):
        return x, [(float('inf'), 0.0)]
    k = n // 2
    sd = onp.sqrt((n * n - 1) / 12.0 / k * (n - k) / (n - 1))
    return x, [(float(abs(v[:k].mean() - (n - 1) / 2.0) / sd), 1.0)]


def _dropout(op, device, n):
    """The share of zeros against p; every survivor scaled by 1/(1-p)."""
    import torch
    from .base import get_op
    p = 0.3
    x = get_op(op).fn(torch.ones(n, device=device), p=p, mode='always')
    v = _np(x)
    kept = v[v != 0]
    out = [_binom(int((v == 0).sum()), n, p)]
    if not onp.allclose(kept, 1.0 / (1.0 - p), rtol=1e-6, atol=0):
        out.append((float('inf'), 0.0))
    return x, out


def _zipfian(op, device, n):
    """Single draws against P(k) = log((k+2)/(k+1)) / log(R+1); a long
    draw's samples distinct and in [0, R)."""
    from .base import get_op
    fn, R = get_op(op).fn, 100
    with _ctx(device):
        single = onp.concatenate([_np(fn(R, shape=(1,))[0])
                                  for _ in range(2000)])
        long_, tries = fn(R, shape=(50,))
    k = onp.arange(R)
    out = [_cat(single, onp.log((k + 2) / (k + 1)) / onp.log(R + 1))]
    v = _np(long_)
    if len(set(v.tolist())) != 50 or v.min() < 0 or v.max() >= R or \
            int(_np(tries)[0]) < 50:
        out.append((float('inf'), 0.0))
    return long_, out


def _image(op, device, n, calls=400):
    """The factor each call drew, recovered from its output, against the
    uniform (the lighting's alphas against the normal) it is drawn from;
    a flip's output is its input or the flipped input, at rate p."""
    import torch
    from .base import get_op
    fn = get_op(op).fn
    rng = onp.random.RandomState(0)
    img = torch.tensor(rng.uniform(0.1, 0.9, (8, 8, 3)), dtype=torch.float32,
                       device=device)
    x = img.to(torch.float64).cpu()
    gray = (0.299 * x[..., 0:1] + 0.587 * x[..., 1:2] + 0.114 * x[..., 2:3])
    t_yiq = torch.tensor([[0.299, 0.587, 0.114], [0.596, -0.274, -0.321],
                          [0.211, -0.523, 0.311]], dtype=torch.float64)

    def iq(t):
        yiq = t.reshape(-1, 3) @ t_yiq.T
        return torch.complex(yiq[:, 1], yiq[:, 2])

    def fit(out, base):
        d = x - base
        f = float(((out - base) * d).sum() / (d * d).sum())
        return f, float((out - (base + f * d)).abs().max())

    args = {'image_random_brightness': (0.6, 1.4),
            'image_random_contrast': (0.6, 1.4),
            'image_random_saturation': (0.6, 1.4),
            'image_random_hue': (-0.4, 0.4),
            'image_random_color_jitter': (0.3,),
            'image_random_lighting': (0.1,)}.get(op, ())
    factors, misfit, flips = [], 0.0, 0
    for _ in range(calls):
        last = fn(img, *args)
        o = last.to(torch.float64).cpu()
        if op in ('image_random_brightness', 'image_random_color_jitter'):
            f, e = fit(o, torch.zeros_like(x))
        elif op == 'image_random_contrast':
            f, e = fit(o, gray.mean())
        elif op == 'image_random_saturation':
            f, e = fit(o, gray)
        elif op == 'image_random_hue':
            f = float(torch.angle((iq(x).conj() * iq(o)).sum())) / onp.pi
            e = 0.0
        elif op == 'image_random_lighting':
            delta = (o - x).reshape(-1, 3).mean(0).numpy()
            eigval = onp.asarray([55.46, 4.794, 1.148])
            eigvec = onp.asarray([[-0.5675, 0.7192, 0.4009],
                                  [-0.5808, -0.0045, -0.814],
                                  [-0.5836, -0.6948, 0.4203]])
            factors.extend(onp.linalg.solve(eigvec, delta) / eigval)
            e = float((o - x - torch.tensor(delta)).abs().max())
            f = None
        else:                           # the flips
            axis = -2 if op.endswith('left_right') else -3
            flipped = bool(torch.equal(o, x.flip(axis)))
            flips += flipped
            e = 0.0 if flipped or torch.equal(o, x) else float('inf')
            f = None
        misfit = max(misfit, e)
        if f is not None:
            factors.append(f)
    stats = [(float('inf'), 0.0)] if not misfit <= 1e-4 else []
    if op == 'image_random_lighting':
        stats.append(_cont(factors, _law('norm', (0.0, 0.1))))
    elif op.startswith('image_random_flip'):
        stats.append(_binom(flips, calls, 0.5))
    else:
        lo, hi = (1 - args[0], 1 + args[0]) if len(args) == 1 else args
        stats.append(_cont(factors, _law('uniform', (lo, hi - lo))))
    return last, stats


LAWS = {
    **{op: _simple for op in _SIMPLE},
    **{op + '_like': _like for op in _SIMPLE if op.startswith('random_')
       and op != 'random_randint'},
    'sample_uniform': _rows, 'sample_normal': _rows, 'sample_gamma': _rows,
    'sample_multinomial': _multinomial, '_npi_multinomial': _multinomial,
    '_npi_choice': _choice, 'shuffle': _shuffle, '_npi_shuffle': _shuffle,
    'dropout': _dropout, 'sample_unique_zipfian': _zipfian,
    **{op: _image for op in C.RANDOM if op.startswith('image_random_')},
}


def law_check(op, device, n=200000, seed=0):
    """(worst z, worst p, fault) of ``op``'s draws on ``device`` against
    its law; the fault None when every mean is within ``Z_MAX`` standard
    errors and every test at p > ``P_MIN``, and the draws lie on
    ``device``."""
    import mxnet_tpu_torch as mt
    mt.random.seed(seed)
    x, stats = LAWS[op](op, device, n)
    x = getattr(x, '_data', x)
    z = max(s[0] for s in stats)
    p = min(s[1] for s in stats)
    if x.device.type != device and op not in C.HOST:
        return z, p, f'drew on {x.device}'
    if not (z < Z_MAX and p > P_MIN):
        return z, p, f'mean {z:.3g} standard errors, p {p:.3g}'
    return z, p, None
