"""The port's NMS (``tstar_tpu_torch/ops/nms.py`` and the plain version of
the ``kernels/nms.py`` kernel) against the JAX package's
``tstar_tpu/ops/nms.py``, on the CPU.

Boxes, scores and classes are made from a seed with numpy; scores sit on a
few levels, so ties are common.  ``keep`` and ``valid`` must be EQUAL: the
same stable score order, the same f32 IoU rounding, the same compaction
into ``max_outputs`` slots (index 0 in invalid slots), the same class
offsets.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tstar_tpu_torch.kernels import launch_counts, reset_launch_counts
from tstar_tpu_torch.kernels import nms as knms
from tstar_tpu_torch.ops import nms as tnms

jnms = importlib.import_module("tstar_tpu.ops.nms")   # ``tstar_tpu.ops.nms`` is also a function


def _inputs(seed, n, levels=10, classes=5, size=100.0, max_wh=30.0):
    rng = np.random.default_rng(seed)
    cxy = rng.random((n, 2)) * size
    wh = rng.random((n, 2)) * max_wh + 1.0
    boxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1).astype(np.float32)
    scores = (np.floor(rng.random(n) * levels) / levels).astype(np.float32)
    cls = rng.integers(0, classes, n).astype(np.int32)
    return boxes, scores, cls


def _both(fn_j, fn_t, *arrays, **kw):
    jk, jv = fn_j(*(jnp.asarray(a) for a in arrays), **kw)
    tk, tv = fn_t(*(torch.from_numpy(a) for a in arrays), **kw)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert tk.dtype == torch.int32 and tv.dtype == torch.bool
    return tk, tv


def test_box_iou_matches_reference():
    a, _, _ = _inputs(0, 40)
    b, _, _ = _inputs(1, 30)
    want = np.asarray(jnms.box_iou(jnp.asarray(a), jnp.asarray(b)))
    got = tnms.box_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("thresh", [0.3, 0.5, 0.7])
def test_nms_matches_reference(seed, thresh):
    boxes, scores, _ = _inputs(seed, 200)
    _both(jnms.nms, tnms.nms, boxes, scores, iou_threshold=thresh, max_outputs=64)


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("max_outputs", [1, 20, 250])
def test_class_aware_nms_matches_reference(seed, max_outputs):
    """Ties, truncation at ``max_outputs`` (1 and 20 slots), and as many
    slots as boxes (the tail past the survivors is index 0, invalid)."""
    boxes, scores, cls = _inputs(seed, 250, levels=4)
    tk, tv = _both(jnms.batched_class_nms, tnms.batched_class_nms, boxes, scores, cls,
                   iou_threshold=0.5, max_outputs=max_outputs)
    if max_outputs == 250:
        assert not tv.all() and (tk[~tv] == 0).all()
        assert tv[: int(tv.sum())].all()
    else:
        assert tv.all()


def test_more_slots_than_boxes():
    """max_outputs > N: every slot past the survivors is invalid.  (The
    reference's compaction scatters the suppressed boxes to slot N, which
    lies inside the output then, so its slot N holds one of them, marked
    valid: ROADMAP "The reference's own faults".  The search's max_dets 50
    is below any detector's anchor count.)"""
    boxes, scores, cls = _inputs(0, 250, levels=4)
    tk, tv = tnms.batched_class_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                                    torch.from_numpy(cls), 0.5, 300)
    jk, jv = jnms.batched_class_nms(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(cls),
                                    0.5, 300)
    n_kept = int(tv.sum())
    np.testing.assert_array_equal(tk[:n_kept].numpy(), np.asarray(jk)[:n_kept])
    assert tv[:n_kept].all() and not tv[n_kept:].any() and (tk[n_kept:] == 0).all()
    assert int(np.asarray(jv).sum()) == n_kept + 1 and bool(np.asarray(jv)[250])


def test_all_scores_tied_keeps_index_order():
    """All-zero scores (every box below the threshold in postprocess): the
    stable order is the index order."""
    boxes, _, cls = _inputs(7, 120)
    scores = np.zeros(120, np.float32)
    tk, tv = _both(jnms.batched_class_nms, tnms.batched_class_nms, boxes, scores, cls,
                   iou_threshold=0.7, max_outputs=50)
    kept = tk[tv].numpy()
    assert (np.diff(kept) > 0).all()


def test_class_aware_never_crosses_classes():
    boxes = np.array([[0, 0, 10, 10], [0, 0, 10, 10], [1, 1, 10, 10]], np.float32)
    scores = np.array([0.9, 0.8, 0.7], np.float32)
    cls = np.array([0, 1, 0], np.int32)
    tk, tv = _both(jnms.batched_class_nms, tnms.batched_class_nms, boxes, scores, cls,
                   iou_threshold=0.5, max_outputs=3)
    # box 1 (class 1) survives though it equals box 0; box 2 is box 0's class
    assert tk[tv].tolist() == [0, 1]


def test_batched_images_equal_one_by_one():
    """A leading image axis: each image computed alone, with its own span."""
    imgs = [_inputs(s, 150, size=50.0 * (s + 1)) for s in range(3)]
    boxes, scores, cls = (np.stack(x) for x in zip(*imgs))
    tk, tv = tnms.batched_class_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                                    torch.from_numpy(cls), 0.6, 40)
    for i, (b, s, c) in enumerate(imgs):
        jk, jv = jnms.batched_class_nms(jnp.asarray(b), jnp.asarray(s), jnp.asarray(c), 0.6, 40)
        np.testing.assert_array_equal(tk[i].numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tv[i].numpy(), np.asarray(jv))


def test_greedy_nms_plain_is_the_reference_loop():
    """The kernel's plain version on a given order: the reference's loop."""
    boxes, scores, _ = _inputs(11, 180)
    order = torch.argsort(-torch.from_numpy(scores), stable=True)
    keep, valid = knms.greedy_nms_plain(torch.from_numpy(boxes)[None], order[None], 0.5, 30)
    jk, jv = jnms.nms(jnp.asarray(boxes), jnp.asarray(scores), 0.5, 30)
    np.testing.assert_array_equal(keep[0].numpy(), np.asarray(jk))
    np.testing.assert_array_equal(valid[0].numpy(), np.asarray(jv))


def test_cpu_tensors_launch_no_kernel():
    boxes, scores, cls = _inputs(0, 50)
    reset_launch_counts()
    tnms.batched_class_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                           torch.from_numpy(cls), 0.7, 10)
    assert launch_counts()["greedy_nms"] == 0
