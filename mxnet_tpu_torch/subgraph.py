"""Subgraph backends (counterpart of ``mxnet_tpu/subgraph.py``, ref:
src/operator/subgraph/subgraph_property.h:86,252 and the partitioner
registry of subgraph/build_subgraph.cc).

A backend pattern-matches regions of a hybridized block's operator graph
and swaps them for fused kernels, at ``hybridize(backend=...)`` or
``optimize_for``. Where the JAX package scans the traced jaxpr, the port
traces the block's forward into an aten graph with
``torch.fx.experimental.proxy_tensor.make_fx``, its parameters as
placeholders, once per call signature (the inputs' shapes, dtypes,
devices and ``requires_grad``, the training flag, grad mode, the
parameters' shapes and dtypes), rewrites that graph (``partition``) and
runs it in place of the forward: eagerly on the CPU, and on the card as
the block's CUDA graph (``gluon.block.CachedOp`` captures the rewritten
program). ``stats['matches']`` adds each trace's matches, as the JAX
backend adds each jaxpr's.

A trace runs the forward once. A forward that launches one of the port's
hand-written kernels (a ctypes call ``make_fx`` cannot see) or draws
random numbers is refused with an ``MXNetError`` that names it: its
graph would be wrong.

One backend ships, ``fuse_attention``, which matches what the JAX
matcher (``mxnet_tpu/subgraph.py:86-295``) matches: a product Q K^T (K
given (B, H, Tk, D), or already transposed to (B, H, D, Tk)), scaled by
scalars (``mul``/``div``), an optional additive key mask ((B or 1, 1, 1,
Tk)) or a select mask (``where``/``masked_fill`` against a constant below
-1e20), softmax over the keys, and the product with V. make_fx lowers
each ``matmul`` to ``expand``/``view``/``bmm``; the matcher walks through
those views to the 4-D operands. The chain is replaced by the port's
``flash_attention`` (kernel A forward; K2 and K3 through its autograd
Function), the chain's scale folded into q as ``_fused_attention`` does
in the JAX package (``:299-320``) and the mask passed as ``key_mask``;
the rest of the chain is removed only where nothing else reads it (dead
code elimination keeps operands the program still needs, as
``_run_rewritten``'s liveness pass does). No library attention stands in
for kernel A.
"""
from __future__ import annotations

import math

import torch

from .base import MXNetError

__all__ = ['SubgraphBackend', 'register_backend', 'get_backend',
           'list_backends', 'FuseAttentionBackend']

_backends = {}


class SubgraphBackend:
    """A graph partitioner (ref: SubgraphProperty). A subclass overrides
    ``partition(gm) -> matches``, which rewrites the aten graph module
    ``gm`` in place; ``stats['matches']`` adds the matches of each
    trace."""

    name = 'base'

    def __init__(self):
        self.stats = {'matches': 0}
        self._programs = {}

    def partition(self, gm):
        return 0

    def run(self, block, args):
        """The block's forward on ``args`` (tensors, or None), through the
        rewritten program of this call's signature."""
        params = _block_params(block)
        key = _signature(block, params, args)
        prog = self._programs.get(key)
        if prog is None:
            prog = self._programs[key] = self._build(block, params, args)
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        return prog(*[p._var for p in params], *tensors)

    def _build(self, block, params, args):
        from torch.fx.experimental.proxy_tensor import make_fx
        from .gluon.block import plain_calls
        from .ops import _build as _kernels
        if any(not p._is_materialized() for p in params):
            # a forward in predict mode places deferred parameters
            training = block.training
            with plain_calls(), torch.no_grad():
                torch.nn.Module.__call__(block.eval(), *args)
            block.train(training)
        slots = [i for i, a in enumerate(args) if isinstance(a, torch.Tensor)]
        n = len(params)

        def forward(*flat):
            full = list(args)
            for i, t in zip(slots, flat[n:]):
                full[i] = t
            saved = [p._var for p in params]
            try:
                for p, t in zip(params, flat[:n]):
                    p._var = t
                with plain_calls():
                    return torch.nn.Module.__call__(block, *full)
            finally:
                for p, t in zip(params, saved):
                    p._var = t

        before = dict(_kernels.launch_counts)
        with torch.no_grad():
            # copies: the trace runs the forward, whose in-place writes
            # (running statistics) must not reach the parameters
            gm = make_fx(forward)(*[p._var.detach().clone() for p in params],
                                  *[args[i].detach() for i in slots])
        launched = {k: v - before.get(k, 0)
                    for k, v in _kernels.launch_counts.items()
                    if v != before.get(k, 0)}
        if launched:
            raise MXNetError(
                f"subgraph backend {self.name!r}: {block.name}'s forward "
                f"launches hand-written kernels {sorted(launched)}, which a "
                f"make_fx trace cannot see; hybridize it without a backend")
        drawn = [nd.name for nd in gm.graph.nodes
                 if nd.op == 'call_function' and
                 torch.Tag.nondeterministic_seeded in
                 getattr(nd.target, 'tags', ())]
        if drawn:
            raise MXNetError(
                f"subgraph backend {self.name!r}: {block.name}'s forward "
                f"draws random numbers ({drawn[:3]}), which a traced "
                f"program would repeat; run it in predict mode or "
                f"hybridize it without a backend")
        matches = self.partition(gm)
        gm.graph.eliminate_dead_code()
        gm.recompile()
        self.stats['matches'] += matches
        return gm


def _block_params(block):
    """The block's Parameters, each once (shared ones appear under several
    structured names)."""
    seen, out = set(), []
    for p in block._collect_params_with_prefix().values():
        if id(p) not in seen:
            seen.add(id(p))
            out.append(p)
    return out


def _signature(block, params, args):
    from .amp import amp as _amp

    def sig(t):
        return (tuple(t.shape), t.dtype, str(t.device), t.requires_grad)
    return (tuple(sig(a) if isinstance(a, torch.Tensor) else repr(a)
                  for a in args),
            block.training, torch.is_grad_enabled(), _amp.patch_epoch(),
            tuple(sig(p._var) if p._is_materialized() else None
                  for p in params))


def register_backend(cls):
    _backends[cls.name] = cls
    return cls


def get_backend(name):
    """A new instance of the backend registered as ``name``."""
    backend = _backends.get(name)
    if backend is None:
        raise MXNetError(f"subgraph backend {name!r} is not registered; "
                         f"available: {list_backends()}")
    return backend()


def list_backends():
    return sorted(_backends)


# ---------------------------------------------------------------------------
# fuse_attention
# ---------------------------------------------------------------------------

_A = torch.ops.aten
_VIEWS = (_A.view.default, _A._unsafe_view.default, _A.reshape.default,
          _A.clone.default, _A.expand.default, _A.alias.default,
          _A.lift_fresh_copy.default)


def _shape(node):
    val = node.meta.get('val') if hasattr(node, 'meta') else None
    return tuple(val.shape) if isinstance(val, torch.Tensor) else None


def _dtype(node):
    return node.meta['val'].dtype


def _strip(node):
    """The first node under a run of views, copies and expands."""
    while isinstance(node, torch.fx.Node) and node.target in _VIEWS:
        node = node.args[0]
    return node


def _scalar(v, gm):
    """A Python number, or the value of a one-element constant (a
    ``full``/``scalar_tensor`` node, a tensor constant of ``gm``), else
    None."""
    if isinstance(v, (int, float)) and not isinstance(v, bool):
        return float(v)
    if isinstance(v, torch.fx.Node):
        v = _strip(v)
        if v.target in (_A.full.default, _A.scalar_tensor.default) and \
                all(s == 1 for s in (_shape(v) or ())):
            return float(v.args[1] if v.target == _A.full.default
                         else v.args[0])
        if v.op == 'get_attr':
            t = getattr(gm, v.target, None)
            if isinstance(t, torch.Tensor) and t.numel() == 1:
                return float(t)
    return None


def _key_mask(node, scores_shape):
    """Whether ``node`` broadcasts over the scores (B, H, Tq, Tk) along
    the key axis only: shape (B or 1, 1, 1, Tk)."""
    s = _shape(node)
    B, H, Tq, Tk = scores_shape
    return s is not None and len(s) == 4 and s[3] == Tk and \
        s[0] in (1, B) and s[1] == 1 and s[2] == 1


def _single_user(node):
    users = list(node.users)
    return users[0] if len(users) == 1 else None


def _is_swap_last_two(node):
    if node.target == _A.transpose.int:
        dims = {d % 4 for d in node.args[1:3]}
        return dims == {2, 3}
    if node.target == _A.permute.default:
        return list(node.args[1]) in ([0, 1, 3, 2], [-4, -3, -1, -2])
    return False


class _Match:
    def __init__(self):
        self.scale = 1.0
        self.add_mask = None
        self.add_mask_scale = 1.0
        self.sel_mask = None
        self.sel_keep = True       # False: the mask marks the dropped keys


def _match_after(sm):
    """(the AV bmm's 4-D output node, v) after softmax node ``sm``, or
    None."""
    cur = sm
    while True:
        nxt = _single_user(cur)
        if nxt is None:
            return None
        if nxt.target in _VIEWS or nxt.target == _A._to_copy.default:
            cur = nxt
            continue
        break
    if nxt.target != _A.bmm.default or nxt.args[0] is not cur:
        return None
    out = _single_user(nxt)
    if out is None or out.target not in _VIEWS or \
            len(_shape(out) or ()) != 4:
        return None
    v = _strip(nxt.args[1])
    B, H, Tq, _ = _shape(out)
    vs = _shape(v)
    if vs is None or len(vs) != 4 or vs[:2] != (B, H):
        return None
    return out, v


def _match_before(x, m, scores_shape, gm):
    """(q, k, k_transposed) at the end of the pre-softmax chain from
    ``x``, filling ``m``'s scale and mask; None where the chain is not
    one the matcher knows."""
    cur = x
    for _ in range(8):
        if not isinstance(cur, torch.fx.Node):
            return None
        src = _strip(cur)
        if src.target == _A.bmm.default:
            q, kt = _strip(src.args[0]), _strip(src.args[1])
            if len(_shape(q) or ()) != 4 or len(_shape(kt) or ()) != 4:
                return None
            if _is_swap_last_two(kt):
                return q, kt.args[0], False
            return q, kt, True
        if cur.target in (_A.mul.Tensor, _A.div.Tensor):
            a, b = cur.args[:2]
            sa, sb = _scalar(a, gm), _scalar(b, gm)
            if cur.target == _A.mul.Tensor and sa is not None:
                m.scale *= sa
                cur = b
                continue
            if sb is None:
                return None
            m.scale *= (1.0 / sb if cur.target == _A.div.Tensor else sb)
            cur = a
            continue
        if cur.target == _A.add.Tensor and m.add_mask is None and \
                len(cur.args) == 2 and cur.kwargs.get('alpha', 1) == 1:
            a, b = cur.args
            for cand, other in ((b, a), (a, b)):
                if isinstance(cand, torch.fx.Node) and \
                        _key_mask(_strip(cand), scores_shape):
                    m.add_mask = _strip(cand)
                    # scales matched so far sit between the add and the
                    # softmax, so they apply to the mask too
                    m.add_mask_scale = m.scale
                    cur = other
                    break
            else:
                return None
            continue
        if cur.target == _A.where.self and m.sel_mask is None:
            cond, on_true, on_false = cur.args
            neg = _scalar(on_false, gm)
            if neg is not None and neg < -1e20 and \
                    _key_mask(_strip(cond), scores_shape):
                m.sel_mask = _strip(cond)
                cur = on_true
                continue
            return None
        if cur.target == _A.masked_fill.Scalar and m.sel_mask is None:
            data, mask, value = cur.args
            if float(value) < -1e20 and _key_mask(_strip(mask),
                                                  scores_shape):
                m.sel_mask, m.sel_keep = _strip(mask), False
                cur = data
                continue
            return None
        return None
    return None


def _fused_attention(q, k, v, scale, add_mask, add_mask_scale, sel_mask,
                     sel_keep, k_transposed, out_dtype):
    """The matched chain as one call of the port's flash attention: the
    chain's scale folded into q (the kernel applies 1/sqrt(D) itself),
    the mask as its key_mask."""
    from .ops.flash_attention import flash_attention
    if k_transposed:                       # (B, H, D, Tk) -> (B, H, Tk, D)
        k = k.transpose(-1, -2)
        if k.stride(-1) != 1:              # the kernels read D unit-strided
            k = k.contiguous()
    B, D, Tk = q.shape[0], q.shape[-1], k.shape[2]
    # the scale rounded to q's dtype, as the JAX backend's array of it
    qs = q * float(torch.tensor(scale * math.sqrt(D), dtype=q.dtype))
    km = None
    if add_mask is not None:
        km = add_mask.reshape(-1, Tk).float() * add_mask_scale
    elif sel_mask is not None:
        km = sel_mask.reshape(-1, Tk).to(torch.bool)
        if not sel_keep:
            km = ~km
    if km is not None and km.shape[0] == 1:
        km = km.expand(B, Tk)
    return flash_attention(qs, k, v, key_mask=km).to(out_dtype)


@register_backend
class FuseAttentionBackend(SubgraphBackend):
    """Swaps hand-written attention for the port's flash attention."""

    name = 'fuse_attention'

    def partition(self, gm):
        graph = gm.graph
        count = 0
        for sm in list(graph.nodes):
            if sm.op != 'call_function' or sm.target != _A._softmax.default:
                continue
            scores_shape = _shape(sm)
            if scores_shape is None or len(scores_shape) != 4 or \
                    sm.args[1] % 4 != 3:
                continue
            after = _match_after(sm)
            if after is None:
                continue
            out, v = after
            m = _Match()
            before = _match_before(sm.args[0], m, scores_shape, gm)
            if before is None:
                continue
            q, k, k_transposed = before
            with graph.inserting_before(out):
                fused = graph.call_function(
                    _fused_attention,
                    (q, k, v, m.scale, m.add_mask, m.add_mask_scale,
                     m.sel_mask, m.sel_keep, k_transposed, _dtype(out)))
            fused.meta['val'] = out.meta['val']
            out.replace_all_uses_with(fused)
            count += 1
        return count
