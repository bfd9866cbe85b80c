"""The port's AdamW (ops/optimizer_ops.py and optimizer/optimizer.py)
against the JAX package's ``adamw_update`` and its AdamW optimizer class,
on the same numpy weights and gradients over a few iterations."""
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

from mxnet_tpu import nd
from mxnet_tpu import optimizer as jopt
from mxnet_tpu.ops import optimizer_ops as jops
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import optimizer_ops as tops
from test_torch_jax_globals import jax_globals  # noqa: F401

RTOL, ATOL = 1e-6, 1e-7     # one f32 update: rounding order only


def _problem(seed, shape=(5, 7), steps=4):
    rng = onp.random.RandomState(seed)
    w0 = rng.randn(*shape).astype(onp.float32)
    grads = [rng.randn(*shape).astype(onp.float32) * 3 for _ in range(steps)]
    return w0, grads


@pytest.mark.parametrize('kw', [
    dict(lr=1e-2, wd=0.01),
    dict(lr=1e-3, wd=0.1, rescale_grad=0.25, clip_gradient=0.5),
    dict(lr=5e-3, wd=0.0, beta1=0.8, beta2=0.95, epsilon=1e-6, eta=0.5),
])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_adamw_update_matches_jax(kw, dtype):
    w0, grads = _problem(0)
    jw = jnp.asarray(w0).astype(dtype)
    jm = jv = jnp.zeros(w0.shape, jnp.float32)
    tw = torch.from_numpy(w0).to(getattr(torch, dtype))
    tm = tv = torch.zeros(w0.shape)
    for g in grads:
        jw, jm, jv = jops.adamw_update(jw, jnp.asarray(g).astype(dtype), jm,
                                       jv, **kw)
        tw, tm, tv = tops.adamw_update(
            tw, torch.from_numpy(g).to(getattr(torch, dtype)), tm, tv, **kw)
        assert tw.dtype == getattr(torch, dtype) and tm.dtype == torch.float32
    onp.testing.assert_allclose(tm.numpy(), onp.asarray(jm), rtol=RTOL,
                                atol=ATOL)
    onp.testing.assert_allclose(tv.numpy(), onp.asarray(jv), rtol=RTOL,
                                atol=ATOL)
    if dtype == 'float32':
        onp.testing.assert_allclose(tw.numpy(), onp.asarray(jw), rtol=RTOL,
                                    atol=ATOL)
    else:
        # the f32 results round to bf16 the same way, or one ulp apart
        onp.testing.assert_allclose(tw.float().numpy(),
                                    onp.asarray(jw.astype(jnp.float32)),
                                    rtol=2 ** -7, atol=0)


@pytest.mark.parametrize('multi_precision', [False, True])
def test_adamw_class_matches_jax_class(multi_precision):
    """create('adamw') with bf16 weights: with multi_precision an f32
    master copy carries the trajectory and the bf16 weight is its cast;
    without it the bf16 weight is updated directly (f32 states)."""
    w0, grads = _problem(1, steps=5)
    kw = dict(learning_rate=1e-2, wd=0.01, rescale_grad=0.5,
              multi_precision=multi_precision)
    jo = jopt.create('adamw', **kw)
    jw = nd.array(w0).astype('bfloat16')
    jstate = jo.create_state_multi_precision(0, jw)
    to = topt.create('AdamW', **kw)
    tw = torch.from_numpy(w0).to(torch.bfloat16)
    tstate = to.create_state_multi_precision(0, tw)
    for g in grads:
        jo.update_multi_precision(0, jw, nd.array(g).astype('bfloat16'),
                                  jstate)
        to.update_multi_precision(0, tw, torch.from_numpy(g).to(
            torch.bfloat16), tstate)
    assert to.num_update == jo.num_update == len(grads)
    if multi_precision:
        jmaster, (jm, jv) = jstate
        tmaster, (tm, tv) = tstate
        assert tmaster.dtype == torch.float32
        onp.testing.assert_allclose(tmaster.numpy(), jmaster.asnumpy(),
                                    rtol=1e-6, atol=1e-7)
        onp.testing.assert_array_equal(
            tw.float().numpy(), jw.astype('float32').asnumpy())
    else:
        (jm, jv), (tm, tv) = jstate, tstate
        onp.testing.assert_allclose(tw.float().numpy(),
                                    jw.astype('float32').asnumpy(),
                                    rtol=2 ** -7, atol=0)
    onp.testing.assert_allclose(tm.numpy(), jm.asnumpy(), rtol=1e-5,
                                atol=1e-7)
    onp.testing.assert_allclose(tv.numpy(), jv.asnumpy(), rtol=1e-5,
                                atol=1e-7)


def test_lr_and_wd_multipliers_come_from_the_parameter():
    p = torch.nn.Parameter(torch.zeros(3))
    p.lr_mult, p.wd_mult = 0.5, 0.0
    o = topt.create('adamw', learning_rate=0.1, wd=0.2, param_dict={0: p})
    assert o._get_lr(0) == pytest.approx(0.05) and o._get_wd(0) == 0.0
    assert o._get_lr(1) == pytest.approx(0.1) and o._get_wd(1) == 0.2
    o.set_learning_rate(0.3)
    assert o.learning_rate == 0.3


def test_create_refuses_what_is_not_ported():
    """Every optimizer the JAX package registers is created by its name
    (case-insensitive); a name neither package has raises and lists the
    ported ones."""
    assert isinstance(topt.create('adamw'), topt.AdamW)
    for name in jopt.optimizer._REG.list():
        assert type(topt.create(name)).__name__.lower() == name
    assert isinstance(topt.create('RMSProp'), topt.RMSProp)
    with pytest.raises(MXNetError,
                       match=r"'adabelief' is not ported.*adamw.*sgd"):
        topt.create('adabelief')


@pytest.mark.parametrize('call', ['step', 'update'])
def test_ignore_stale_grad_is_accepted_and_changes_nothing(call):
    """``trainer.step(bs, ignore_stale_grad=True)`` (an MXNet script's
    call) gives the update a call without it gives, for a parameter with
    a gradient and for one whose gradient the loss never reached (updated
    from a zeroed buffer, as the JAX Trainer's)."""
    from mxnet_tpu_torch import gluon
    rng = onp.random.RandomState(3)
    w0, g0, s0 = (rng.randn(4, 3).astype(onp.float32) for _ in range(3))
    results = []
    for flag in (False, True):
        used = torch.nn.Parameter(torch.from_numpy(w0.copy()))
        stale = torch.nn.Parameter(torch.from_numpy(s0.copy()))
        used.grad = torch.from_numpy(g0.copy())
        trainer = gluon.Trainer([used, stale], 'adamw',
                                {'learning_rate': 0.1, 'wd': 0.01})
        kwargs = {'ignore_stale_grad': True} if flag else {}
        for _ in range(2):
            getattr(trainer, call)(2, **kwargs)
        results.append((used.detach().clone(), stale.detach().clone()))
    for a, b in zip(*results):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(results[0][1], torch.from_numpy(s0))


# ---- every optimizer_ops function against JAX, its per-step scalars as
# Python floats and as 0-d tensors (what a captured update reads)

_SCALARS = ('lr', 'wd', 'rescale_grad', 't')


def _operands(seed):
    rng = onp.random.RandomState(seed)
    shape = (5, 7)
    f = lambda s=1.0: rng.randn(*shape).astype(onp.float32) * s  # noqa
    w, w32 = f(), f()
    return {'w': w, 'g': f(3), 's': f(0.1), 'v': onp.abs(f(0.1)),
            'w16': w32, 'g16': f(3), 'w32': w32, 'u': f(0.5),
            'r1': onp.float32(2.5), 'r2': onp.float32(0.7),
            'n': onp.abs(f(0.1))}


_OPS = {
    'sgd_update': ('w g', dict(lr=0.1, wd=0.01, rescale_grad=0.5,
                               clip_gradient=0.3)),
    'sgd_mom_update': ('w g s', dict(lr=0.1, momentum=0.9, wd=0.01,
                                     rescale_grad=0.5)),
    'mp_sgd_update': ('w16 g16 w32', dict(lr=0.1, wd=0.01,
                                          rescale_grad=0.5)),
    'mp_sgd_mom_update': ('w16 g16 s w32', dict(lr=0.1, momentum=0.9,
                                                wd=0.01)),
    'nag_mom_update': ('w g s', dict(lr=0.1, momentum=0.9, wd=0.01,
                                     clip_gradient=2.0)),
    'adam_update': ('w g s v', dict(lr=0.01, wd=0.01, rescale_grad=0.5,
                                    clip_gradient=1.0)),
    'adamw_update': ('w g s v', dict(lr=0.01, wd=0.01, rescale_grad=0.5,
                                     eta=0.7)),
    'lamb_update_phase1': ('w g s v', dict(t=3, wd=0.01, rescale_grad=0.5)),
    'lamb_update_phase2': ('w u r1 r2', dict(lr=0.01, lower_bound=0.1,
                                             upper_bound=10.0)),
    'ftrl_update': ('w g s n', dict(lr=0.1, lamda1=0.05, beta=1.5, wd=0.01,
                                    rescale_grad=0.5)),
    'rmsprop_update': ('w g n', dict(lr=0.01, gamma1=0.8, wd=0.01,
                                     clip_weights=1.5)),
    'rmspropalex_update': ('w g n s u', dict(lr=0.01, wd=0.01,
                                             rescale_grad=0.5,
                                             clip_gradient=2.0)),
    'signsgd_update': ('w g', dict(lr=0.1, wd=0.01, rescale_grad=0.5)),
    'signum_update': ('w g s', dict(lr=0.1, momentum=0.8, wd=0.01,
                                    wd_lh=0.05)),
    'adagrad_update': ('w g n', dict(lr=0.1, wd=0.01, rescale_grad=0.5,
                                     clip_gradient=1.0)),
    'adadelta_update': ('w g n v', dict(rho=0.8, wd=0.01,
                                        rescale_grad=0.5)),
    'ftml_update': ('w g v n s', dict(lr=0.05, t=3, wd=0.01,
                                      rescale_grad=0.5, clip_grad=2.0)),
}


def _to_jax(name, a):
    x = jnp.asarray(a)
    return x.astype('bfloat16') if name.endswith('16') else x


def _to_torch(name, a):
    x = torch.as_tensor(onp.asarray(a))
    return x.to(torch.bfloat16) if name.endswith('16') else x


def _tensor_scalars(kw, scalars, make=torch.tensor):
    """kw with its per-step scalars as 0-d f32 arrays of ``make``'s kind
    in 'tensor' mode: JAX then computes with f32 scalars too (as its fused
    Trainer does with traced ones), so both sides round alike, e.g. in
    1 - beta2 ** t."""
    if scalars == 'float':
        return dict(kw)
    return {k: make(float(v), dtype=getattr(torch if make is torch.tensor
                                            else jnp, 'float32'))
            if k in _SCALARS else v for k, v in kw.items()}


def _assert_like(t, j):
    t = t if isinstance(t, (list, tuple)) else (t,)
    j = j if isinstance(j, (list, tuple)) else (j,)
    assert len(t) == len(j)
    for a, b in zip(t, j):
        if isinstance(a, (list, tuple)):
            _assert_like(a, b)
            continue
        b = onp.asarray(b.astype(jnp.float32) if b.dtype == jnp.bfloat16
                        else b)
        if a.dtype == torch.bfloat16:
            assert b.dtype == onp.float32
            onp.testing.assert_allclose(a.float().numpy(), b, rtol=2 ** -7,
                                        atol=0)
        else:
            assert a.dtype == torch.float32
            onp.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize('scalars', ['float', 'tensor'])
@pytest.mark.parametrize('name', sorted(_OPS))
def test_update_op_matches_jax(name, scalars):
    args, kw = _OPS[name]
    data = _operands(sorted(_OPS).index(name))
    jargs = [_to_jax(a, data[a]) for a in args.split()]
    targs = [_to_torch(a, data[a]) for a in args.split()]
    want = getattr(jops, name)(*jargs, **_tensor_scalars(kw, scalars,
                                                         jnp.asarray))
    got = getattr(tops, name)(*targs, **_tensor_scalars(kw, scalars))
    _assert_like(got, want)


def _lists(seed, n=3):
    rng = onp.random.RandomState(seed)
    shapes = [(4, 3), (6,), (2, 5)]
    mk = lambda s=1.0: [rng.randn(*sh).astype(onp.float32) * s  # noqa
                        for sh in shapes[:n]]
    return dict(w=mk(), g=mk(3), s=mk(0.1), v=[onp.abs(x) for x in mk(0.1)],
                w32=mk(), lrs=[0.1, 0.05, 0.02], wds=[0.0, 0.01, 0.1],
                etas=[1.0, 0.5, 0.8], t=[1, 2, 5])


_MULTI = {
    'multi_sgd_update': ('w g', 'lrs wds', dict(rescale_grad=0.5)),
    'multi_sgd_mom_update': ('w g s', 'lrs wds', dict(momentum=0.9)),
    'multi_mp_sgd_update': ('w16 g16 w32', 'lrs wds',
                            dict(clip_gradient=1.0)),
    'multi_mp_sgd_mom_update': ('w16 g16 s w32', 'lrs wds',
                                dict(momentum=0.8)),
    'preloaded_multi_sgd_update': ('w g', 'lrs wds', dict(rescale_grad=0.5)),
    'preloaded_multi_sgd_mom_update': ('w g s', 'lrs wds',
                                       dict(momentum=0.9)),
    'preloaded_multi_mp_sgd_update': ('w16 g16 w32', 'lrs wds', {}),
    'preloaded_multi_mp_sgd_mom_update': ('w16 g16 s w32', 'lrs wds',
                                          dict(momentum=0.9)),
    'multi_lamb_update': ('w g s v', 'lrs wds t',
                          dict(rescale_grad=0.5, lower_bound=0.01)),
    'multi_adamw_update': ('w g s v', 'rescale lrs etas wds',
                           dict(clip_gradient=2.0)),
    'multi_lans_update': ('w g s v', 'lrs wds t',
                          dict(rescale_grad=0.5, clip_gradient=2.0)),
}


def _multi_args(spec, data, scalar_spec, scalars, to_jax):
    out = []
    for a in spec.split():
        base = a.replace('16', '') if a != 'w32' else 'w32'
        src = data[base] if a in ('w16', 'g16') else data[a]
        conv = _to_jax if to_jax else _to_torch
        out.append([conv(a, x) for x in src])
    preloaded = 'preloaded' in scalar_spec[0]
    for a in scalar_spec[1].split():
        if a == 'rescale':
            out.append(jnp.float32(0.5) if to_jax else torch.tensor(0.5))
            continue
        vals = data[a]
        if to_jax:
            out.append(jnp.asarray(vals, jnp.float32) if preloaded
                       else vals)
        elif preloaded or scalars == 'tensor':
            out.append(torch.tensor(vals, dtype=torch.float32))
        else:
            out.append(vals)
    return out


@pytest.mark.parametrize('scalars', ['float', 'tensor'])
@pytest.mark.parametrize('name', sorted(_MULTI))
def test_multi_tensor_op_matches_jax(name, scalars):
    """The multi-tensor updates over 3 tensors of different shapes; lrs,
    wds (and etas, step counts) per tensor, as Python lists or as device
    vectors (the ``preloaded_*`` contract always takes vectors)."""
    tensors, scal, kw = _MULTI[name]
    data = _lists(sorted(_MULTI).index(name))
    jargs = _multi_args(tensors, data, (name, scal), scalars, True)
    targs = _multi_args(tensors, data, (name, scal), scalars, False)
    want = getattr(jops, name)(*jargs, **kw)
    got = getattr(tops, name)(*targs, **kw)
    _assert_like(got, want)


def test_multi_adamw_skips_a_non_finite_scale_on_the_device():
    data = _lists(99)
    ws = [torch.from_numpy(x) for x in data['w']]
    gs = [torch.from_numpy(x) for x in data['g']]
    ms = [torch.from_numpy(x) for x in data['s']]
    vs = [torch.from_numpy(x) for x in data['v']]
    out = tops.multi_adamw_update(ws, gs, ms, vs, torch.tensor(float('inf')),
                                  data['lrs'], data['etas'], data['wds'])
    for new, old in zip(out, (ws, ms, vs)):
        for a, b in zip(new, old):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_multi_sum_sq_and_all_finite_match_jax():
    data = _lists(7)
    arrs = data['w'] + [data['g'][0].astype('float32')]
    jw = [jnp.asarray(a).astype('bfloat16') if i == 1 else jnp.asarray(a)
          for i, a in enumerate(arrs)]
    tw = [_to_torch('x16' if i == 1 else 'x', a)
          for i, a in enumerate(arrs)]
    _assert_like(tops.multi_sum_sq(*tw), jops.multi_sum_sq(*jw))
    assert float(tops.all_finite(*tw)) == float(jops.all_finite(*jw)) == 1.0
    bad = arrs[0].copy()
    bad[1, 1] = onp.nan
    assert float(tops.all_finite(tw[1], torch.from_numpy(bad))) == \
        float(jops.all_finite(jw[1], jnp.asarray(bad))) == 0.0


_CLASSES = {
    'sgd': dict(learning_rate=0.05, momentum=0.9, wd=0.01),
    'sgd0': dict(learning_rate=0.05, wd=0.01),
    'nag': dict(learning_rate=0.05, momentum=0.9, wd=0.01),
    'adam': dict(learning_rate=1e-2, wd=0.01, clip_gradient=2.0),
    'lamb': dict(learning_rate=1e-2, wd=0.01, lower_bound=1e-3,
                 upper_bound=10.0),
}


@pytest.mark.parametrize('multi_precision', [False, True])
@pytest.mark.parametrize('opt', sorted(_CLASSES))
def test_optimizer_class_matches_jax_class(opt, multi_precision):
    """create(name) of SGD (with and without momentum), NAG, Adam and LAMB
    over 5 updates of a bf16 weight, with and without an f32 master."""
    w0, grads = _problem(4, steps=5)
    kw = dict(_CLASSES[opt], rescale_grad=0.5,
              multi_precision=multi_precision)
    name = opt.rstrip('0')
    jo, to = jopt.create(name, **kw), topt.create(name, **kw)
    assert to.fused_update is True
    jw = nd.array(w0).astype('bfloat16')
    tw = torch.from_numpy(w0).to(torch.bfloat16)
    js = jo.create_state_multi_precision(0, jw)
    ts = to.create_state_multi_precision(0, tw)
    for g in grads:
        jo.update_multi_precision(0, jw, nd.array(g).astype('bfloat16'), js)
        to.update_multi_precision(0, tw, torch.from_numpy(g).to(
            torch.bfloat16), ts)
    assert to.num_update == jo.num_update == len(grads)
    onp.testing.assert_allclose(tw.float().numpy(),
                                jw.astype('float32').asnumpy(),
                                rtol=2 ** -7, atol=1e-6)

    def leaves(s):
        if isinstance(s, (list, tuple)):
            return [x for y in s for x in leaves(y)]
        return [] if s is None else [s]
    jl, tl = leaves(js), leaves(ts)
    assert len(jl) == len(tl)
    for a, b in zip(tl, jl):
        assert a.dtype == torch.float32
        onp.testing.assert_allclose(a.numpy(), b.asnumpy(), rtol=1e-5,
                                    atol=1e-6)


def test_updater_payload_round_trip():
    """``Updater.get_states`` pickles {index: numpy state}, with the
    optimizer when asked; ``set_states`` takes both forms back."""
    import pickle
    w = torch.ones(3)
    o = topt.create('adam', learning_rate=0.1)
    up = topt.get_updater(o)
    up(0, torch.full((3,), 0.5), w)
    plain = pickle.loads(up.get_states())
    assert list(plain) == [0] and all(isinstance(x, onp.ndarray)
                                      for x in plain[0])
    other = topt.get_updater(topt.create('adam'))
    other.set_states(up.get_states(dump_optimizer=True))
    assert other.optimizer.num_update == 1 and other.optimizer.lr == 0.1
    for a, b in zip(other.states[0], up.states[0]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# the optimizers ported with AMP: each class against the JAX class, f32
# weights and gradients, 5 updates (rounding order only: 1e-6)
_MORE_CLASSES = {
    'signum': dict(learning_rate=0.05, momentum=0.9, wd=0.01, wd_lh=0.01),
    'signum0': dict(learning_rate=0.05, momentum=0.0, wd=0.01),
    'ftml': dict(learning_rate=0.05, wd=0.01, clip_gradient=2.0),
    'lars': dict(learning_rate=0.05, momentum=0.9, wd=0.01),
    'adagrad': dict(learning_rate=0.05, wd=0.01),
    'rmsprop': dict(learning_rate=0.01, wd=0.01, clip_weights=2.0),
    'rmsprop_centered': dict(learning_rate=0.01, wd=0.01, centered=True),
    'adadelta': dict(wd=0.01, clip_gradient=2.0),
    'ftrl': dict(learning_rate=0.1, wd=0.01),
    'adamax': dict(learning_rate=0.01, wd=0.01, clip_gradient=2.0),
    'nadam': dict(learning_rate=0.01, wd=0.01),
    'dcasgd': dict(learning_rate=0.05, momentum=0.9, wd=0.01),
    'dcasgd0': dict(learning_rate=0.05, wd=0.01),
    'test': dict(),
}


@pytest.mark.parametrize('multi_precision', [False, True])
@pytest.mark.parametrize('opt', sorted(_MORE_CLASSES))
def test_more_optimizer_classes_match_jax_class(opt, multi_precision):
    """create(name) over 5 updates of an f32 weight (with
    ``multi_precision``, which an f32 weight ignores, and without): the
    weight and every state within 1e-6, the update counts equal, and the
    same ``fused_update`` flag as the JAX class."""
    w0, grads = _problem(8, steps=5)
    kw = dict(_MORE_CLASSES[opt], rescale_grad=0.5,
              multi_precision=multi_precision)
    name = opt.rstrip('0').replace('_centered', '')
    jo, to = jopt.create(name, **kw), topt.create(name, **kw)
    assert to.fused_update is jo.fused_update
    jw, tw = nd.array(w0), torch.from_numpy(w0.copy())
    js = jo.create_state_multi_precision(0, jw)
    ts = to.create_state_multi_precision(0, tw)
    for g in grads:
        jo.update_multi_precision(0, jw, nd.array(g), js)
        to.update_multi_precision(0, tw, torch.from_numpy(g), ts)
    assert to.num_update == jo.num_update
    onp.testing.assert_allclose(tw.numpy(), jw.asnumpy(), rtol=1e-6,
                                atol=1e-6)

    def leaves(s):
        if isinstance(s, (list, tuple)):
            return [x for y in s for x in leaves(y)]
        return [] if s is None else [s]
    jl, tl = leaves(js), leaves(ts)
    assert len(jl) == len(tl)
    for a, b in zip(tl, jl):
        onp.testing.assert_allclose(a.numpy(), b.asnumpy(), rtol=1e-6,
                                    atol=1e-6)


@pytest.mark.parametrize('opt', ['signum', 'ftml', 'rmsprop', 'adamax',
                                 'dcasgd', 'test'])
def test_more_optimizers_run_fused_in_the_trainer(opt):
    """The fused update (per-step scalars as device tensors, as the
    captured program reads them) gives the per-parameter loop's weights
    over 3 steps: to 1e-5, since its scalars are f32 values where the
    loop's are Python floats (FTML's (1 - beta1**t) / lr moves most)."""
    from mxnet_tpu_torch import gluon
    rng = onp.random.RandomState(11)
    w0 = rng.randn(4, 3).astype(onp.float32)
    gs = [rng.randn(4, 3).astype(onp.float32) for _ in range(3)]
    kw = dict(_MORE_CLASSES[opt])
    outs = []
    for fused in (True, False):
        p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
        o = topt.create(opt, **kw)
        o.fused_update = fused
        trainer = gluon.Trainer([p], o)
        for g in gs:
            p.grad = torch.from_numpy(g.copy())
            trainer.step(2)
        assert (trainer._fused is not None) is fused
        outs.append(p.detach().clone())
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-5, atol=1e-6)


def test_sgld_noise_is_normal_with_variance_lr():
    """SGLD's step is -lr/2 (g + wd w) plus Normal(0, sqrt(lr)) noise,
    drawn from the port's generator: the JAX package draws other numbers
    (ROADMAP queue 1 item 2), so the noise is held by its statistics on
    a 200 x 200 weight: the mean within 4 standard errors of 0 and the
    variance within 3% of lr. A second draw differs; the JAX step's
    deterministic part is the port's."""
    import mxnet_tpu_torch as mt
    lr, wd = 0.01, 0.1
    rng = onp.random.RandomState(12)
    w0 = rng.randn(200, 200).astype(onp.float32)
    g = rng.randn(200, 200).astype(onp.float32)
    mt.random.seed(3)
    to = topt.create('sgld', learning_rate=lr, wd=wd, rescale_grad=0.5)
    assert to.fused_update is False
    tw = torch.from_numpy(w0.copy())
    to.update(0, tw, torch.from_numpy(g), None)
    drift = w0 - lr / 2 * (g * 0.5 + wd * w0)
    noise = tw.numpy().astype(onp.float64) - drift
    n = noise.size
    assert abs(noise.mean()) < 4 * (lr / n) ** 0.5
    assert abs(noise.var() / lr - 1) < 0.03
    tw2 = torch.from_numpy(w0.copy())
    to.update(0, tw2, torch.from_numpy(g), None)
    assert not torch.equal(tw, tw2)
    jo = jopt.create('sgld', learning_rate=lr, wd=wd, rescale_grad=0.5)
    jw = nd.array(w0)
    jo.update(0, jw, nd.array(g), None)
    jnoise = jw.asnumpy().astype(onp.float64) - drift
    assert abs(jnoise.var() / lr - 1) < 0.03
