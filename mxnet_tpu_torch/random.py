"""Random state (counterpart of ``mxnet_tpu/random.py``).

One ``torch.Generator`` per device, made at first use. ``nd.dropout``
draws its mask from the generator of its input's device, so noise for a
tensor on the card is drawn on the card, never on the host and copied.
The generators give other numbers than the JAX package's keys from the
same seed: tests feed both packages the same numpy noise, or compare
distributions.

``get_state`` / ``set_state`` snapshot and restore every stream a
training step draws from, as JSON (a checkpoint's manifest carries it):
the generators of this module, torch's default generators, the
generators a block's modules hold (``module=``: the BERT models' hidden
dropout and attention seeds) and numpy's global state. A CUDA generator
is its seed and Philox offset, which a CUDA graph that registered it
advances on every replay as an eager step would, so the state after N
replays is the state after N eager steps. The JAX package's state (a
threefry seed and counter) cannot carry over: ``set_state`` given one
takes its numpy state and its seed, reseeds the generators from that
seed, and says so in its return value.
"""
from __future__ import annotations

import base64
import threading

import numpy as _onp
import torch

__all__ = ['seed', 'generator', 'get_state', 'set_state']

_lock = threading.Lock()
_seed = 0
_generators = {}


def seed(seed_state: int, ctx=None):
    """Seed the generator of ``ctx`` (every device's when None) and, as the
    JAX package does, numpy's global generator."""
    global _seed
    s = int(seed_state)
    with _lock:
        if ctx is None:
            _seed = s
            for g in _generators.values():
                g.manual_seed(s)
        else:
            generator(ctx.device).manual_seed(s)
    _onp.random.seed(s % (2 ** 31))


def generator(device) -> torch.Generator:
    """The generator of a torch device, seeded with the last global seed
    when first made."""
    device = torch.device(device)
    key = (device.type, device.index or 0)
    g = _generators.get(key)
    if g is None:
        with _lock:
            g = _generators.get(key)
            if g is None:
                g = torch.Generator(device=device).manual_seed(_seed)
                _generators[key] = g
    return g


def _encode(g):
    return base64.b64encode(g.get_state().numpy().tobytes()).decode('ascii')


def _decode(g, text):
    g.set_state(torch.frombuffer(bytearray(base64.b64decode(text)),
                                 dtype=torch.uint8))


def _device_name(key):
    return f'{key[0]}:{key[1]}'


def _defaults():
    """{name: torch's default generator} of the CPU and of each card CUDA
    has been initialised for."""
    out = {'cpu': torch.default_generator}
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for i, g in enumerate(torch.cuda.default_generators):
            out[f'cuda:{i}'] = g
    return out


def _module_generators(module):
    """{'<module path>.generator': generator} of the generators a block's
    modules hold, each once, under the first path that holds it."""
    out, seen = {}, set()
    if module is None:
        return out
    for name, m in module.named_modules():
        g = getattr(m, 'generator', None)
        if isinstance(g, torch.Generator) and id(g) not in seen:
            seen.add(id(g))
            out[f'{name}.generator' if name else 'generator'] = g
    return out


def get_state(module=None) -> dict:
    """JSON-serialisable snapshot of every random stream a training step
    draws from (see the module docstring): ``seed`` (the last global
    seed), ``counter`` (0: the JAX package's field, which a JAX restore
    reads as the start of that seed's stream), ``numpy`` (the JAX
    package's layout) and ``torch``: this module's generators by device,
    torch's defaults, and with ``module`` its modules' generators, each a
    base64 string of the generator's state bytes."""
    with _lock:
        st = {'seed': _seed, 'counter': 0}
        devices = {_device_name(k): _encode(g)
                   for k, g in _generators.items()}
    kind, keys, pos, has_gauss, cached = _onp.random.get_state()
    st['numpy'] = {'kind': kind, 'keys': [int(k) for k in keys],
                   'pos': int(pos), 'has_gauss': int(has_gauss),
                   'cached_gaussian': float(cached)}
    st['torch'] = {
        'devices': devices,
        'defaults': {n: _encode(g) for n, g in _defaults().items()},
        'modules': {n: _encode(g)
                    for n, g in _module_generators(module).items()}}
    return st


def set_state(state: dict, module=None) -> str:
    """Restore a ``get_state`` snapshot, in place (a generator registered
    with a CUDA graph stays registered). Returns 'exact'. Given the JAX
    package's state (no ``torch`` entry), restores its numpy state,
    reseeds this module's and torch's default generators with its seed
    and the i-th generator of ``module`` with seed + 1 + i, and returns
    'reseeded'."""
    global _seed
    np_st = state.get('numpy')
    if np_st:
        _onp.random.set_state((
            np_st['kind'], _onp.asarray(np_st['keys'], dtype=_onp.uint32),
            int(np_st['pos']), int(np_st['has_gauss']),
            float(np_st['cached_gaussian'])))
    s = int(state.get('seed', 0))
    tst = state.get('torch')
    mods = _module_generators(module)
    if tst is None:
        with _lock:
            _seed = s
            for g in _generators.values():
                g.manual_seed(s)
        for g in _defaults().values():
            g.manual_seed(s)
        for i, g in enumerate(mods.values()):
            g.manual_seed(s + 1 + i)
        return 'reseeded'
    with _lock:
        _seed = s
    for name, text in tst.get('devices', {}).items():
        _decode(generator(name), text)
    defaults = _defaults()
    for name, text in tst.get('defaults', {}).items():
        if name in defaults:
            _decode(defaults[name], text)
    for name, text in tst.get('modules', {}).items():
        if name in mods:
            _decode(mods[name], text)
    return 'exact'
