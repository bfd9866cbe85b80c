"""The port's box and detection ops (``ops/contrib.py``'s box ops and
``ops/detection.py``) against the JAX package's, on the CPU in f32, the
same numpy inputs in both.

Integer-valued outputs (kept ids and their order, class targets, masks)
are compared exactly; float outputs within atol 1e-5 (rtol 1e-5 where the
values reach the image's pixel scale).

``box_nms``: scores with ties, topk > 0 and <= 0, per class and
``force_suppress``, a background id, center boxes. At SSD-512's 24572
anchors with topk 400 the port builds the IoU of the first 400 sorted
rows against all 24572, never the 24572 x 24572 matrix the JAX op forms
(checked through the shapes ``_iou_corner`` is asked for).

``multibox_target``: two ground-truth boxes that share their best
anchor (the JAX scatter on the CPU gives the anchor to the higher gt
index, and so does the port), hard-negative mining with its stable rank.
"""
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

from mxnet_tpu.ops import contrib as jc
from mxnet_tpu.ops import detection as jd
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops import contrib as tc
from mxnet_tpu_torch.ops import detection as td
from test_torch_jax_globals import jax_globals  # noqa: F401

ATOL = 1e-5


def _both(jfn, tfn, *arrays, **kw):
    def conv(a, to):
        return to(a) if isinstance(a, onp.ndarray) else a
    j = jfn(*[conv(a, jnp.asarray) for a in arrays], **kw)
    t = tfn(*[conv(a, lambda x: torch.from_numpy(onp.ascontiguousarray(x)))
              for a in arrays], **kw)
    j = [onp.asarray(o) for o in (j if isinstance(j, tuple) else (j,))]
    t = [o.numpy() for o in (t if isinstance(t, tuple) else (t,))]
    for a, b in zip(j, t):
        assert a.shape == b.shape
    return j, t


def _boxes(rng, shape, scale=0.8, size=0.4):
    xy = rng.rand(*shape, 2) * scale
    return onp.concatenate([xy, xy + 0.02 + rng.rand(*shape, 2) * size],
                           -1).astype(onp.float32)


@pytest.mark.parametrize('fmt', ['corner', 'center'])
def test_box_iou_matches_jax(fmt):
    rng = onp.random.RandomState(0)
    a, b = _boxes(rng, (2, 7)), _boxes(rng, (2, 5))
    j, t = _both(jc.box_iou, tc.box_iou, a, b, format=fmt)
    onp.testing.assert_allclose(t[0], j[0], rtol=0, atol=ATOL)
    iou = mt.nd.box_iou(mt.nd.array(onp.array([[0, 0, 2, 2], [1, 1, 3, 3]],
                                              onp.float32), ctx=mt.cpu()),
                        mt.nd.array(onp.array([[0, 0, 2, 2]], onp.float32),
                                    ctx=mt.cpu())).asnumpy()
    onp.testing.assert_allclose(iou[:, 0], [1.0, 1.0 / 7.0], rtol=1e-6)


def _det_rows(rng, B, N, n_cls=3):
    d = onp.concatenate([rng.randint(0, n_cls, (B, N, 1)),
                         rng.rand(B, N, 1) - 0.1, _boxes(rng, (B, N))],
                        -1).astype(onp.float32)
    d[:, ::5, 1] = 0.5      # ties among the valid scores
    return d


NMS_CASES = [dict(topk=-1), dict(topk=0), dict(topk=6), dict(topk=25),
             dict(topk=-1, force_suppress=True),
             dict(topk=10, force_suppress=True),
             dict(topk=-1, background_id=1),
             dict(topk=-1, id_index=-1),
             dict(topk=8, in_format='center', valid_thresh=0.3)]


@pytest.mark.parametrize('kw', NMS_CASES, ids=lambda kw: ','.join(
    f'{k}={v}' for k, v in kw.items()))
def test_box_nms_matches_jax(kw):
    kw = dict(dict(overlap_thresh=0.3, id_index=0), **kw)
    d = _det_rows(onp.random.RandomState(1), 3, 40)
    j, t = _both(jc.box_nms, tc.box_nms, d, **kw)
    # the kept rows, their order and ids exactly; every value as JAX's
    onp.testing.assert_array_equal(t[0][..., 1] >= 0, j[0][..., 1] >= 0)
    onp.testing.assert_array_equal(t[0], j[0])


def test_box_nms_leading_dims_and_nd():
    d = _det_rows(onp.random.RandomState(2), 6, 12).reshape(2, 3, 12, 6)
    j, t = _both(jc.box_nms, tc.box_nms, d, topk=5, id_index=0)
    onp.testing.assert_array_equal(t[0], j[0])
    out = mt.nd.box_nms(mt.nd.array(d, ctx=mt.cpu()), topk=5, id_index=0)
    onp.testing.assert_array_equal(out.asnumpy(), j[0])


def test_box_nms_at_ssd512_forms_no_n_by_n_tensor(monkeypatch):
    """24572 rows, topk 400: the IoU the op builds is (1, 400, 24572)."""
    N, K = 24572, 400
    seen = []
    real = tc._iou_corner

    def spy(a, b):
        out = real(a, b)
        seen.append(tuple(out.shape))
        return out
    monkeypatch.setattr(tc, '_iou_corner', spy)
    rng = onp.random.RandomState(3)
    d = torch.from_numpy(_det_rows(rng, 1, N, n_cls=20))
    out = tc.box_nms(d, overlap_thresh=0.45, topk=K, id_index=0)
    assert seen == [(1, K, N)]
    kept = out[0, :, 1] >= 0
    assert 0 < int(kept.sum()) <= K
    assert not bool(kept[K:].any())
    # the kept rows are sorted by score and pairwise below the threshold
    # within a class
    rows = out[0, kept]
    assert bool((rows[1:, 1] <= rows[:-1, 1]).all())
    iou = real(rows[:, 2:6], rows[:, 2:6])
    same = rows[:, None, 0] == rows[None, :, 0]
    off = ~torch.eye(len(rows), dtype=torch.bool)
    assert not bool(((iou > 0.45) & same & off).any())


PRIOR_CASES = [dict(sizes=(.3,), ratios=(1,)),
               dict(sizes=(.2, .3), ratios=(1, 2, .5)),
               dict(sizes=(.07, .1025), ratios=(1, 2, .5, 3, 1. / 3),
                    clip=True),
               dict(sizes=(.5,), ratios=(1, 2), steps=(0.2, 0.25),
                    offsets=(0.3, 0.6))]


@pytest.mark.parametrize('kw', PRIOR_CASES)
def test_multibox_prior_matches_jax(kw):
    data = onp.zeros((1, 2, 5, 7), onp.float32)
    j, t = _both(jc.multibox_prior, tc.multibox_prior, data, **kw)
    onp.testing.assert_allclose(t[0], j[0], rtol=0, atol=ATOL)


def test_box_encode_and_decode_match_jax():
    rng = onp.random.RandomState(4)
    B, A, M = 2, 30, 3
    samples = (rng.rand(B, A) > 0.5).astype(onp.float32)
    matches = rng.randint(0, M, (B, A)).astype(onp.float32)
    anchors = _boxes(rng, (B, A))
    refs = _boxes(rng, (B, M))
    j, t = _both(jd.box_encode, td.box_encode, samples, matches, anchors,
                 refs)
    onp.testing.assert_allclose(t[0], j[0], rtol=0, atol=ATOL)
    onp.testing.assert_array_equal(t[1], j[1])
    deltas = (rng.randn(B, A, 4) * 0.5).astype(onp.float32)
    for kw in (dict(), dict(clip=1.0), dict(std0=0.2, std3=0.1),
               dict(format='center')):
        j, t = _both(jd.box_decode, td.box_decode, deltas, anchors, **kw)
        onp.testing.assert_allclose(t[0], j[0], rtol=0, atol=ATOL)


def _target_inputs(rng, A=60, B=3, M=5, n_cls=4):
    anchor = _boxes(rng, (1, A), size=0.3)
    label = onp.full((B, M, 5), -1.0, onp.float32)
    for b in range(B):
        for m in range(rng.randint(1, M)):
            label[b, m] = onp.concatenate([[rng.randint(n_cls)],
                                           _boxes(rng, ())])
    cls_pred = rng.randn(B, n_cls + 1, A).astype(onp.float32)
    return anchor, label, cls_pred


def _hold_targets(j, t):
    onp.testing.assert_allclose(t[0], j[0], rtol=0, atol=ATOL)
    onp.testing.assert_array_equal(t[1], j[1])
    onp.testing.assert_array_equal(t[2], j[2])


@pytest.mark.parametrize('kw', [dict(), dict(negative_mining_ratio=3.0),
                                dict(negative_mining_ratio=1.0,
                                     minimum_negative_samples=10,
                                     negative_mining_thresh=0.4),
                                dict(overlap_threshold=0.3,
                                     ignore_label=-2.0,
                                     negative_mining_ratio=2.0)])
def test_multibox_target_matches_jax(kw):
    for seed in range(3):
        args = _target_inputs(onp.random.RandomState(10 + seed))
        _hold_targets(*_both(jd.multibox_target, td.multibox_target, *args,
                             **kw))


def test_multibox_target_shared_best_anchor_goes_to_the_higher_gt():
    """Boxes 0 and 2 of row 0 have the same best anchor (identical
    boxes): the JAX scatter on the CPU keeps the last write, gt 2, and
    the port's max-reduce picks gt 2 too."""
    rng = onp.random.RandomState(5)
    anchor = _boxes(rng, (1, 40), size=0.3)
    label = onp.full((2, 4, 5), -1.0, onp.float32)
    box = anchor[0, 7] + onp.array([0.01, 0.0, 0.02, 0.01], onp.float32)
    label[0, 0] = [1, *box]
    label[0, 1] = [0, 0.6, 0.6, 0.9, 0.95]
    label[0, 2] = [3, *box]
    label[1, 0] = [2, *box]
    cls_pred = rng.randn(2, 5, 40).astype(onp.float32)
    j, t = _both(jd.multibox_target, td.multibox_target, anchor, label,
                 cls_pred, overlap_threshold=0.99, negative_mining_ratio=3.)
    _hold_targets(j, t)
    assert t[2][0, 7] == 4.0        # class 3 of gt 2, plus one
    assert t[2][1, 7] == 3.0


@pytest.mark.parametrize('kw', [dict(), dict(nms_topk=10),
                                dict(force_suppress=True, threshold=0.3),
                                dict(clip=False, nms_threshold=0.3),
                                dict(background_id=2)])
def test_multibox_detection_matches_jax(kw):
    rng = onp.random.RandomState(6)
    B, A, C = 2, 50, 4
    logits = rng.randn(B, C + 1, A).astype(onp.float32) * 2
    prob = onp.exp(logits) / onp.exp(logits).sum(1, keepdims=True)
    loc = (rng.randn(B, A * 4) * 0.2).astype(onp.float32)
    anchor = _boxes(rng, (1, A))
    kw = dict(dict(threshold=0.2), **kw)
    j, t = _both(jd.multibox_detection, td.multibox_detection,
                 prob.astype(onp.float32), loc, anchor, **kw)
    onp.testing.assert_array_equal(t[0][..., 0], j[0][..., 0])
    onp.testing.assert_allclose(t[0], j[0], rtol=0, atol=ATOL)


def test_proposal_matches_jax():
    rng = onp.random.RandomState(7)
    K, H, W = 12, 4, 5
    cls_prob = rng.rand(2, 2 * K, H, W).astype(onp.float32)
    bbox = (rng.randn(2, 4 * K, H, W) * 0.1).astype(onp.float32)
    info = onp.array([[64, 80, 1.0], [60, 70, 1.0]], onp.float32)
    for kw in (dict(rpn_pre_nms_top_n=100, rpn_post_nms_top_n=20,
                    rpn_min_size=4),
               dict(rpn_pre_nms_top_n=30, rpn_post_nms_top_n=40,
                    rpn_min_size=8, threshold=0.5)):
        j, t = _both(jd.proposal, td.proposal, cls_prob, bbox, info, **kw)
        onp.testing.assert_allclose(t[0], j[0], rtol=1e-5, atol=ATOL)


def test_psroi_pooling_matches_jax():
    rng = onp.random.RandomState(8)
    data = rng.randn(2, 3 * 9, 10, 12).astype(onp.float32)
    rois = onp.array([[0, 1, 1, 30, 25], [1, 5, 3, 40, 35],
                      [0, 0, 0, 47, 39], [1, 20, 20, 20.2, 20.1]],
                     onp.float32)
    j, t = _both(jd.psroi_pooling, td.psroi_pooling, data, rois, 0.25, 3, 3)
    onp.testing.assert_allclose(t[0], j[0], rtol=0, atol=ATOL)
    j, t = _both(jd.psroi_pooling, td.psroi_pooling,
                 data[:, :2 * 9], rois, 0.25, 2, 2, group_size=3)
    onp.testing.assert_allclose(t[0], j[0], rtol=0, atol=ATOL)


@pytest.mark.parametrize('groups', [(1, 1), (2, 1), (2, 2)])
def test_deformable_convolution_matches_jax(groups):
    dg, g = groups
    rng = onp.random.RandomState(9)
    x = rng.randn(2, 4, 7, 8).astype(onp.float32)
    off = (rng.randn(2, 2 * 9 * dg, 7, 8) * 0.7).astype(onp.float32)
    w = rng.randn(6, 4 // g, 3, 3).astype(onp.float32)
    b = rng.randn(6).astype(onp.float32)
    j, t = _both(jd.deformable_convolution, td.deformable_convolution, x,
                 off, w, b, num_deformable_group=dg, num_group=g)
    onp.testing.assert_allclose(t[0], j[0], rtol=1e-5, atol=ATOL)
    j, t = _both(jd.deformable_convolution, td.deformable_convolution, x,
                 off[:, :, ::2, ::2], w, stride=(2, 2), num_group=g,
                 num_deformable_group=dg)
    onp.testing.assert_allclose(t[0], j[0], rtol=1e-5, atol=ATOL)


@pytest.mark.parametrize('kw', [dict(),
                                dict(kernel_size=3, max_displacement=2,
                                     stride2=2, pad_size=2),
                                dict(is_multiply=False, stride1=2,
                                     pad_size=1)])
def test_correlation_matches_jax(kw):
    rng = onp.random.RandomState(10)
    a = rng.randn(2, 3, 9, 10).astype(onp.float32)
    b = rng.randn(2, 3, 9, 10).astype(onp.float32)
    j, t = _both(jd.correlation, td.correlation, a, b, **kw)
    onp.testing.assert_allclose(t[0], j[0], rtol=0, atol=ATOL)


def test_the_detection_ops_are_registered_under_the_jax_names():
    names = set(mt.base.list_ops())
    assert {'box_iou', 'box_nms', 'multibox_prior', 'box_encode',
            'box_decode', 'multibox_target', 'multibox_detection',
            'proposal', 'psroi_pooling', 'deformable_convolution',
            'correlation'} <= names
    assert set(td.__all__) == set(jd.__all__)
