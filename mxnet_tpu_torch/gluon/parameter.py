"""Parameter, Constant and ParameterDict (counterpart of
``mxnet_tpu/gluon/parameter.py``, ref: python/mxnet/gluon/parameter.py),
and ``collect_params(module)`` for plain ``torch.nn.Module``s.

A ``Parameter`` owns one torch tensor, ``Parameter.tensor``: a
``torch.nn.Parameter`` that the Block registers under its attribute name,
so ``named_parameters()``, ``state_dict()``, ``.to()`` and every torch
entry point see the JAX package's structured names
(``_collect_params_with_prefix``: ``features.1.gamma``). Until its shape
is known (deferred initialisation, resolved by the first forward) it is a
``torch.nn.parameter.UninitializedParameter``, materialised in place, so
the object registered on the blocks stays the same. ``grad_req='null'``
(BatchNorm's running statistics) is ``requires_grad=False``.

``data()`` and ``grad()`` return NDArrays over the tensor and its
``.grad``, sharing their storage: a gradient that ``mx.autograd``'s
backward computes for a parameter is written into the tensor's ``.grad``
by ``grad_req`` ('write' replaces it, 'add' adds to it), and that is
where the Trainer reads it.

The tensor side, for torch code that holds a layer's ``weight`` (the
port's Trainer tests, the BERT models): tensor attributes a Parameter
does not have itself (``copy_``, ``detach``, ...) are its tensor's, torch
functions take it in the tensor's place (``__torch_function__``:
``t.copy_(param)``), and ``grad`` reads as torch's: None while the tensor
has no ``.grad``, else an accessor that gives the NDArray when called
(``p.grad()``, MXNet) and stands for the gradient tensor otherwise.
``p.grad = None`` clears the tensor's ``.grad``. ``copy.deepcopy`` of a
block gives each Parameter a tensor and a gradient of its own.

Device. A Parameter whose shape is known is placed when its block is
built, on the block's ``device`` or the current context's (``gpu(0)``
unless a ``with mx.cpu():`` scope says otherwise), so a missing card
raises there. A block built with ``device=`` given (the port's own
layers inside ``models/bert.py``) is usable at once: weights zero,
gamma and running_var one, everything else zero, until an initializer or
a weight file fills them. Otherwise the Parameter must be initialised
(``initialize``, ``set_data`` or ``load_parameters``) before a forward,
as in MXNet.
"""
from __future__ import annotations

import copy
from collections import OrderedDict

import numpy as onp
import torch
from torch.nn.parameter import UninitializedParameter

from ..base import MXNetError, torch_dtype
from ..context import Context, context_of, current_context, resolve_device
from ..ndarray.ndarray import NDArray
from .. import initializer as init_mod

__all__ = ['DeferredInitializationError', 'Parameter', 'Constant',
           'ParameterDict', 'collect_params', 'tensor_of']


class DeferredInitializationError(MXNetError):
    pass


def tensor_of(x):
    """The tensor behind a Parameter, or x itself."""
    return x.tensor if isinstance(x, Parameter) else x


def _device_of(ctx):
    if isinstance(ctx, (list, tuple)):
        if len(ctx) != 1:
            raise MXNetError(f"the port keeps one copy of a parameter; "
                             f"got {len(ctx)} contexts (data parallelism "
                             f"is ROADMAP queue 1 item 6)")
        ctx = ctx[0]
    if ctx is None:
        ctx = current_context()
    if isinstance(ctx, Context):
        return ctx.device
    return resolve_device(ctx)


def _unwrap(x):
    if isinstance(x, (Parameter, _Grad)):
        return x._tensor_value()
    if isinstance(x, (list, tuple)):
        return type(x)(_unwrap(v) for v in x)
    if isinstance(x, dict):
        return {k: _unwrap(v) for k, v in x.items()}
    return x


class _Grad:
    """``param.grad`` while the tensor has a gradient: called, the NDArray
    over it (MXNet's ``grad()``); otherwise the gradient tensor."""

    __slots__ = ('_param',)

    def __init__(self, param):
        self._param = param

    def __call__(self, ctx=None):
        return self._param._grad_array()

    def _tensor_value(self):
        return self._param.tensor.grad

    def __getattr__(self, name):
        return getattr(self._param.tensor.grad, name)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        return func(*_unwrap(args), **_unwrap(kwargs or {}))

    def __repr__(self):
        return f"grad of {self._param.name}: {self._param.tensor.grad!r}"


class Parameter:
    """A Block parameter (ref: gluon/parameter.py Parameter)."""

    def __init__(self, name, grad_req='write', shape=None, dtype='float32',
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True,
                 stype='default', grad_stype='default', device=None):
        if stype != 'default' or grad_stype != 'default':
            raise MXNetError("sparse parameters are not ported (ROADMAP "
                             "queue 1 item 12)")
        self.name = name
        self._grad_req = grad_req if differentiable else 'null'
        if isinstance(shape, int):
            shape = (shape,)
        self._shape = tuple(shape) if shape is not None else None
        self._dtype = torch_dtype(dtype)
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        self._deferred_init = ()
        # usable by a forward: after initialize / set_data / a load
        # (_initialised too), or at once when built with device= given
        self._ready = self._initialised = False
        self._home = resolve_device(device) if device is not None else None
        self._var = UninitializedParameter(
            requires_grad=self._grad_req != 'null')
        if self._shape_complete():
            self._materialize(self._home or _device_of(None))
            if self._home is not None:
                init_mod.Zero()(init_mod.InitDesc(name), self._var)
                self._ready = True

    def __deepcopy__(self, memo):
        """A copy with a tensor and a gradient of its own, as the JAX
        Parameter's deep copy (``amp.convert_hybrid_block`` clones a model
        with ``copy.deepcopy``): torch's Parameter copy leaves ``.grad``
        behind, so the gradient is carried over here."""
        new = object.__new__(type(self))
        memo[id(self)] = new
        for k, v in self.__dict__.items():
            new.__dict__[k] = copy.deepcopy(v, memo)
        if self._var.grad is not None:
            new._var.grad = copy.deepcopy(self._var.grad, memo)
        return new

    # ---- the tensor ---------------------------------------------------
    @property
    def tensor(self):
        """The ``torch.nn.Parameter`` registered on the owning blocks."""
        return self._var

    def _tensor_value(self):
        return self._var

    def __getattr__(self, name):
        var = self.__dict__.get('_var')
        if var is None or name.startswith('_'):
            raise AttributeError(name)
        return getattr(var, name)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        return func(*_unwrap(args), **_unwrap(kwargs or {}))

    @property
    def grad(self):
        """None while the tensor has no gradient (torch's ``.grad``);
        otherwise ``p.grad()`` is the gradient NDArray (MXNet's)."""
        return None if self._var.grad is None else _Grad(self)

    @grad.setter
    def grad(self, value):
        self._var.grad = value

    @property
    def shape(self):
        """MXNet's shape: 0 marks a dimension not known yet."""
        if self._is_materialized():
            return tuple(self._var.shape)
        return self._shape

    @shape.setter
    def shape(self, new):
        self._shape = tuple(new) if new is not None else None

    @property
    def dtype(self):
        """The dtype ``data()`` has: a numpy dtype, or torch.bfloat16."""
        t = self._var.dtype if self._is_materialized() else self._dtype
        return t if t == torch.bfloat16 else onp.dtype(str(t)[6:])

    def _is_materialized(self):
        return not isinstance(self._var, UninitializedParameter)

    def _shape_complete(self):
        return self._shape is not None and all(s > 0 for s in self._shape)

    def _materialize(self, device):
        self._var.materialize(self._shape, device=device, dtype=self._dtype)

    # ---- grad_req -----------------------------------------------------
    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in ('write', 'add', 'null'):
            raise MXNetError(f"grad_req must be write, add or null, got "
                             f"{req!r}")
        self._grad_req = req
        self._var.requires_grad_(req != 'null')
        if req == 'null':
            self._var.grad = None
        elif self._ready and self._var.grad is None:
            self._init_grad()

    @property
    def stype(self):
        return 'default'

    # ---- initialisation -------------------------------------------------
    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        """Ref: parameter.py initialize. ``init`` wins over the
        Parameter's own ``init``, which wins over ``default_init``."""
        if default_init is None:
            default_init = init_mod.Uniform()
        if self._initialised and not force_reinit:
            return
        if not self._shape_complete() and not self._is_materialized():
            if self.allow_deferred_init:
                self._deferred_init = (init, ctx, default_init)
                return
            raise MXNetError(
                f"Cannot initialize Parameter '{self.name}' because it has "
                f"invalid shape: {self._shape}.")
        self._finish_init(init, ctx, default_init)

    def _finish_init(self, init, ctx, default_init):
        device = self._home if ctx is None and self._home is not None \
            else _device_of(ctx)
        if not self._is_materialized():
            self._materialize(device)
        elif self._var.device != device:
            self._var.data = self._var.data.to(device)
        initializer = init_mod.create(init or self.init or default_init)
        initializer(init_mod.InitDesc(self.name,
                                      {'__init_name__': self.name}),
                    self._var)
        self._deferred_init = ()
        self._mark_ready()

    def _mark_ready(self):
        self._ready = True
        self._initialised = True
        if self._grad_req != 'null':
            self._init_grad()

    def _init_grad(self):
        self._var.grad = torch.zeros_like(self._var.detach())

    def _finish_deferred_init(self, shape=None):
        """Set the shape the first forward inferred and initialise as the
        deferred ``initialize`` asked."""
        if shape is not None:
            new = tuple(shape)
            if self._shape is not None:
                for old, n in zip(self._shape, new):
                    if old > 0 and n > 0 and old != n:
                        raise MXNetError(
                            f"deferred shape mismatch for {self.name}: "
                            f"{self._shape} vs {new}")
            self._shape = new
        if not self._deferred_init:
            raise DeferredInitializationError(
                f"Parameter '{self.name}' has not been initialized")
        init, ctx, default_init = self._deferred_init
        self._finish_init(init, ctx, default_init)

    def _check_initialized(self):
        if self._ready:
            return
        if self._deferred_init:
            raise DeferredInitializationError(
                f"Parameter '{self.name}' has not been initialized yet "
                "because initialization was deferred. Call net(data) once "
                "or initialize with a complete shape.")
        raise MXNetError(
            f"Parameter '{self.name}' has not been initialized. You should "
            "initialize parameters and create Trainer first.")

    # ---- data and gradient ----------------------------------------------
    def data(self, ctx=None):
        """The NDArray over the tensor (shared storage). Under
        ``autograd.record()`` it is a variable: its gradient goes to the
        tensor's ``.grad``."""
        self._check_initialized()
        return ParamArray(self)

    def list_data(self):
        return [self.data()]

    def _grad_array(self):
        self._check_initialized()
        if self._grad_req == 'null':
            raise MXNetError(f"Parameter '{self.name}' does not have "
                             f"gradient (grad_req='null')")
        if self._var.grad is None:
            self._init_grad()
        return NDArray(self._var.grad)

    def list_grad(self):
        return [self._grad_array()]

    def list_ctx(self):
        if not self._is_materialized() and self._deferred_init:
            ctx = self._deferred_init[1]
            return list(ctx) if isinstance(ctx, (list, tuple)) else \
                [ctx or current_context()]
        self._check_initialized()
        return [context_of(self._var.device)]

    def set_data(self, data):
        """Copy ``data`` (an NDArray, tensor or array) into the tensor, in
        place; a deferred Parameter takes its shape."""
        src = data._data if isinstance(data, NDArray) else \
            torch.as_tensor(data)
        if not self._is_materialized():
            if not self._deferred_init:
                raise MXNetError(f"Parameter '{self.name}' not initialized")
            self._shape = tuple(src.shape)
            self._finish_deferred_init()
        if tuple(src.shape) != tuple(self._var.shape):
            raise MXNetError(
                f"Parameter '{self.name}': shape mismatch in set_data: "
                f"expected {tuple(self._var.shape)}, got "
                f"{tuple(src.shape)}")
        with torch.no_grad():
            self._var.copy_(src.detach().to(self._var.device,
                                            self._var.dtype))
        if not self._initialised:
            self._mark_ready()
        return self

    def zero_grad(self):
        if self._var.grad is not None:
            self._var.grad.zero_()

    def _tape_write(self, g):
        """Where ``mx.autograd``'s backward puts this parameter's
        gradient: the tensor's ``.grad``, by ``grad_req``."""
        g = g.detach().to(self._var.dtype)
        cur = self._var.grad
        if cur is None or cur.shape != g.shape:
            self._var.grad = g if self._grad_req != 'add' or cur is None \
                else cur + g
        elif self._grad_req == 'add':
            cur.add_(g)
        else:
            cur.copy_(g)

    def reset_ctx(self, ctx):
        device = _device_of(ctx)
        if self._is_materialized() and self._var.device != device:
            self._var.data = self._var.data.to(device)
            if self._var.grad is not None:
                self._var.grad = self._var.grad.to(device)
        elif self._deferred_init:
            init, _, default_init = self._deferred_init
            self._deferred_init = (init, ctx, default_init)

    def cast(self, dtype):
        """The tensor (and its gradient) to ``dtype``, in place."""
        self._dtype = torch_dtype(dtype)
        if not self._is_materialized():
            return
        self._var.data = self._var.data.to(self._dtype)
        if self._var.grad is not None:
            self._var.grad = self._var.grad.to(self._dtype)

    def var(self):
        """This parameter as a symbol variable: its name, its shape as
        the ``__shape__`` hint (ref: parameter.py var)."""
        from .. import symbol
        return symbol.var(self.name, shape=self.shape, dtype=self.dtype)

    def row_sparse_data(self, row_id):
        raise MXNetError("row_sparse_data: sparse parameters are not ported "
                         "(ROADMAP queue 1 item 12)")

    def __repr__(self):
        return (f"Parameter {self.name} (shape={self.shape}, "
                f"dtype={self.dtype})")


class ParamArray(NDArray):
    """``Parameter.data()``: an NDArray whose tensor is the parameter's,
    a variable for ``mx.autograd`` whose gradient goes to the parameter
    (``Parameter._tape_write``). Writing it (``p.data()[:] = v``) writes
    the parameter in place."""

    __slots__ = ('_param',)

    def __init__(self, param):
        self._param = param
        self._in_graph = param._grad_req != 'null'

    @property
    def _data(self):
        return self._param._var

    @_data.setter
    def _data(self, value):
        with torch.no_grad():
            self._param._var.copy_(value.detach().to(
                self._param._var.device, self._param._var.dtype))

    @property
    def _grad(self):
        p = self._param
        return None if p._grad_req == 'null' else p._grad_array()

    @_grad.setter
    def _grad(self, value):
        raise MXNetError("a Parameter's gradient buffer is its tensor's "
                         ".grad; set grad_req instead")

    @property
    def _grad_req(self):
        return self._param._grad_req

    @_grad_req.setter
    def _grad_req(self, req):
        self._param.grad_req = req

    @property
    def _tape_key(self):
        return id(self._param)

    def _tape_write(self, g):
        self._param._tape_write(g)

    def attach_grad(self, grad_req='write', stype=None):
        self._param.grad_req = grad_req


class Constant(Parameter):
    """A non-differentiable parameter holding ``value`` (ref:
    parameter.py Constant)."""

    def __init__(self, name, value, device=None):
        t = value._data if isinstance(value, NDArray) else \
            torch.as_tensor(value)
        self.value = t.detach().cpu()
        value_cpu = self.value

        class _CInit(init_mod.Initializer):
            def _init_weight(self2, _, arr):
                init_mod._fill(arr, value_cpu.float())
            _init_default = _init_weight

        super().__init__(name, grad_req='null', shape=tuple(t.shape),
                         dtype=t.dtype, init=_CInit(), device=device)
        if self._ready:
            # built on a device at once: the value, not the zeros other
            # parameters start from
            self._finish_init(None, None, None)


class ParameterDict:
    """Parameters by prefixed name (ref: gluon/parameter.py
    ParameterDict)."""

    def __init__(self, prefix='', shared=None):
        self._prefix = prefix
        self._params = OrderedDict()
        self._shared = shared

    @property
    def prefix(self):
        return self._prefix

    def __getitem__(self, key):
        return self._params[key]

    def __contains__(self, key):
        return key in self._params

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def __repr__(self):
        s = f"{type(self).__name__}(\n"
        for p in self._params.values():
            s += f"  {p}\n"
        return s + ")"

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    def _get_impl(self, name):
        if name in self._params:
            return self._params[name]
        if self._shared is not None and name in self._shared._params:
            self._params[name] = self._shared._params[name]
            return self._params[name]
        return None

    def get(self, name, **kwargs):
        """The Parameter ``prefix + name``, made with ``kwargs`` when it
        does not exist (a shared one is reused, its unknown dimensions
        filled from ``shape``)."""
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            param = Parameter(name, **kwargs)
            self._params[name] = param
        elif 'shape' in kwargs and kwargs['shape'] is not None and \
                param._shape is not None and \
                len(kwargs['shape']) == len(param._shape):
            param._shape = tuple(e if e > 0 else n for e, n in
                                 zip(param._shape, kwargs['shape']))
        return param

    def get_constant(self, name, value=None, device=None):
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            if value is None:
                raise MXNetError(f"No constant named '{name}'")
            param = Constant(name, value, device=device)
            self._params[name] = param
        return param

    def update(self, other):
        for k, v in other.items():
            if k in self._params and self._params[k] is not v:
                raise MXNetError(f"duplicate parameter name {k}")
            self._params[k] = v

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        if init is None:
            init = init_mod.Uniform()
        for v in self.values():
            v.initialize(None, ctx, init, force_reinit=force_reinit)

    def zero_grad(self):
        for p in self.values():
            p.zero_grad()

    def reset_ctx(self, ctx):
        for p in self.values():
            p.reset_ctx(ctx)

    def list_ctx(self):
        s = []
        for p in self.values():
            for c in p.list_ctx():
                if c not in s:
                    s.append(c)
        return s

    def setattr(self, name, value):
        for p in self.values():
            setattr(p, name, value)

    def save(self, filename, strip_prefix=''):
        """The reference's binary .params container, keyed by name."""
        from ..serialization import atomic_write_file, save_ndarray_file
        arg_dict = {}
        for p in self.values():
            name = p.name
            if name.startswith(strip_prefix):
                name = name[len(strip_prefix):]
            arg_dict[name] = p.data().asnumpy()
        atomic_write_file(filename, save_ndarray_file(arg_dict))

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix=''):
        from ..serialization import load_params_dict
        with open(filename, 'rb') as f:
            arg_dict = load_params_dict(f.read())
        if restore_prefix:
            arg_dict = {restore_prefix + k: v for k, v in arg_dict.items()}
        for name, p in self.items():
            if name not in arg_dict:
                if not allow_missing:
                    raise MXNetError(f"Parameter {name} missing in file")
                continue
            _load_into(p, arg_dict[name], ctx)
        if not ignore_extra:
            extra = set(arg_dict) - set(self._params)
            if extra:
                raise MXNetError(f"extra parameters in file: {sorted(extra)}")


def _load_into(param, value, ctx):
    """Set ``param`` from a loaded numpy array, placing it first if it
    has no tensor yet."""
    from ..serialization import is_bfloat16, to_tensor
    t = to_tensor(value).float() if is_bfloat16(value) else to_tensor(value)
    if not param._is_materialized() and not param._deferred_init:
        param._deferred_init = (None, ctx, init_mod.Zero())
    elif ctx is not None:
        param.reset_ctx(ctx)
    param.set_data(t)


def collect_params(module):
    """OrderedDict {structured name: torch.nn.Parameter} of a plain
    ``torch.nn.Module`` (the BERT models), each given the JAX
    ``Parameter``'s ``lr_mult`` and ``wd_mult`` (default 1.0), which the
    optimizer reads. A Gluon Block has ``Block.collect_params()``."""
    out = OrderedDict()
    for name, p in module.named_parameters():
        for attr in ('lr_mult', 'wd_mult'):
            if not hasattr(p, attr):
                setattr(p, attr, 1.0)
        out[name] = p
    return out

