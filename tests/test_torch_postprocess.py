"""The port's postprocess (orienmask_tpu_torch/ops/postprocess.py), in its
twostage and exact selection modes, and NMS against orienmask_tpu's, on the
same numpy head tensors.

The JAX mask assembly is switched (on the module, as the JAX package's own
tests do) to the anchor-resident Pallas kernel in interpret mode, so both
sides evaluate the kernel's coordinate arithmetic: valid counts, classes,
and mask bytes must be identical, boxes and scores allclose at 1e-6
(sigmoid/exp may differ by an ulp between XLA and torch on the CPU)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orienmask_tpu.ops import pallas_masks
from orienmask_tpu.ops.nms import greedy_nms_fixpoint as jax_greedy_nms_fixpoint
from orienmask_tpu.ops.postprocess import OrienMaskYOLOPostProcess as JaxPostProcess
from orienmask_tpu_torch.config import orienmask_yolo_coco_544_anchor4_fpn_plus_infer as cfg
from orienmask_tpu_torch.ops import OrienMaskYOLOPostProcess
from orienmask_tpu_torch.ops.nms import ROUND_CHUNK, greedy_nms_fixpoint

SIZE = 128


def _postprocess_kwargs(size=SIZE, topk_mode="twostage"):
    kw = {k: v for k, v in cfg["postprocess"].items() if k != "type"}
    kw.update(grid_size=[[size // 32] * 2, [size // 16] * 2, [size // 8] * 2],
              image_size=[size, size], pack_masks=True, topk_mode=topk_mode)
    return kw


def _heads(seed, b, size=SIZE):
    """Head tensors in the JAX layout: class/objectness logits N(0, 3) so
    scores spread far beyond an ulp; box and orientation logits N(0, 1)."""
    rng = np.random.default_rng(seed)
    heads = []
    for stride in (32, 16, 8):
        n = size // stride
        bbox = rng.standard_normal((b, n, n, 3, 85)).astype(np.float32)
        bbox[..., 4:] *= 3.0
        orien = rng.standard_normal((b, size // 4, size // 4, 6)).astype(np.float32)
        heads.append((bbox.reshape(b, n, n, 255), orien))
    return heads


def _run_both(heads, topk_mode):
    """JAX _run_batch (masks through the anchor-resident Pallas kernel in
    interpret mode) and the port's on the CPU, as numpy dicts."""
    mp = pytest.MonkeyPatch()
    mp.setattr(pallas_masks, "assemble_masks_packed", functools.partial(
        pallas_masks.assemble_masks_anchor_resident, interpret=True))
    try:
        jpp = JaxPostProcess(**_postprocess_kwargs(topk_mode=topk_mode), use_pallas_topk=False)
        jpp.use_pallas_masks = True
        want = jax.tree_util.tree_map(np.asarray, jpp._run_batch(
            tuple((jnp.asarray(b), jnp.asarray(o)) for b, o in heads)))
    finally:
        mp.undo()
    pp = OrienMaskYOLOPostProcess(**_postprocess_kwargs(topk_mode=topk_mode), device="cpu")
    got = pp.apply_device([(torch.from_numpy(b), torch.from_numpy(o)) for b, o in heads])
    return want, {k: v.numpy() for k, v in got.items()}


@pytest.fixture(scope="module")
def runs():
    """(numpy heads, JAX _run_batch output, port _run_batch output) at B=2."""
    torch.set_num_threads(1)
    heads = _heads(0, 2)
    return (heads, *_run_both(heads, "twostage"))


def test_exact_selection_matches_jax():
    """topk_mode="exact" (the test and val configs' mode): the top nms_pre
    of all 1008 x 80 pair scores, past one kernel launch's row.  Valid
    counts, classes and mask bytes identical, boxes and scores at 1e-6."""
    torch.set_num_threads(1)
    want, got = _run_both(_heads(5, 2), "exact")
    np.testing.assert_array_equal(got["valid"], want["valid"])
    assert got["valid"].sum(axis=1).min() > 10
    np.testing.assert_array_equal(got["cls"], want["cls"])
    np.testing.assert_allclose(got["bbox"], want["bbox"], rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got["mask"], want["mask"])
    assert got["mask"].any()


def test_exact_selection_indices_match_jax():
    """The flat head buffer and the exact selection's candidates: the same
    pair indices, scores and head rows as JAX ``_select_candidates``."""
    torch.set_num_threads(1)
    heads = _heads(6, 2)
    jpp = JaxPostProcess(**_postprocess_kwargs(topk_mode="exact"), use_pallas_topk=False)
    pp = OrienMaskYOLOPostProcess(**_postprocess_kwargs(topk_mode="exact"), device="cpu")
    scores, det_idx, cls_idx, rows = pp._select_exact([torch.from_numpy(b) for b, _ in heads])
    for i in range(2):
        flat = jpp._flat_head([jnp.asarray(b[i]) for b, _ in heads])
        w_det, w_cls, w_scores, _ = jpp._select_candidates(flat)
        np.testing.assert_array_equal(det_idx[i].numpy(), np.asarray(w_det))
        np.testing.assert_array_equal(cls_idx[i].numpy(), np.asarray(w_cls))
        np.testing.assert_allclose(scores[i].numpy(), np.asarray(w_scores), rtol=1e-6)
        np.testing.assert_array_equal(rows[i].numpy(), np.asarray(flat[w_det]))


def test_run_batch_detections_match_jax(runs):
    _, want, got = runs
    assert got["bbox"].shape == (2, 100, 5) and got["bbox"].dtype == np.float32
    np.testing.assert_array_equal(got["valid"], want["valid"])
    assert got["valid"].sum(axis=1).min() > 10
    np.testing.assert_array_equal(got["cls"], want["cls"])
    np.testing.assert_allclose(got["bbox"], want["bbox"], rtol=1e-6, atol=1e-6)


def test_run_batch_mask_bytes_match_jax(runs):
    _, want, got = runs
    assert got["mask"].shape == (2, 100, SIZE, SIZE // 8) and got["mask"].dtype == np.uint8
    np.testing.assert_array_equal(got["mask"], want["mask"])
    assert got["mask"].any()


def test_selected_detection_indices_match_jax(runs):
    """First top-k of the detect stage: the same flat detection indices."""
    heads, _, _ = runs
    jpp = JaxPostProcess(**_postprocess_kwargs(), use_pallas_topk=False)
    pp = OrienMaskYOLOPostProcess(**_postprocess_kwargs(), device="cpu")
    got_scores = pp._flat_scores([torch.from_numpy(b) for b, _ in heads])
    got_scores = torch.where(got_scores > pp.conf_thresh, got_scores, -1.0)
    _, got_idx = pp._topk(got_scores, pp.nms_pre)
    for i in range(2):
        s = jpp._flat_scores([jnp.asarray(b[i]) for b, _ in heads])
        s = jnp.where(s > jpp.conf_thresh, s, -1.0)
        _, want_idx = jpp._topk(s, jpp.nms_pre)
        np.testing.assert_array_equal(got_idx[i].numpy(), np.asarray(want_idx))


def test_to_host_list_trims_and_unpacks(runs):
    _, _, got = runs
    pp = OrienMaskYOLOPostProcess(**_postprocess_kwargs(), device="cpu")
    res = pp.to_host_list({k: torch.from_numpy(v) for k, v in got.items()})
    for b, r in enumerate(res):
        n = int(got["valid"][b].sum())
        assert r["bbox"].shape == (n, 5) and r["cls"].shape == (n,)
        assert r["mask"].shape == (n, SIZE, SIZE) and r["mask"].dtype == bool
        np.testing.assert_array_equal(np.packbits(r["mask"], axis=-1), got["mask"][b, :n])


def _chain(n, b):
    """Squares of side 0.1 stepping right by 0.3 of their side: IoU of
    neighbours is 0.54 (>= 0.5), of the next-but-one 0.25, so greedy
    suppression runs down the whole chain, one link per fixpoint round."""
    x = np.arange(n, dtype=np.float32) * 0.03 + 0.1
    boxes = np.stack([x, np.full(n, 0.5), np.full(n, 0.1), np.full(n, 0.1)], -1)
    boxes = np.repeat(boxes[None].astype(np.float32), b, axis=0)
    scores = np.repeat(np.linspace(0.9, 0.1, n, dtype=np.float32)[None], b, axis=0)
    return boxes, scores


def _greedy(boxes, scores, thr):
    """Sequential greedy NMS on presorted candidates (host oracle)."""
    kept = []
    for j in range(len(scores)):
        if scores[j] <= -1e29:
            continue
        lo_j, hi_j = boxes[j, :2] - boxes[j, 2:] / 2, boxes[j, :2] + boxes[j, 2:] / 2
        ok = True
        for i in kept:
            lo_i, hi_i = boxes[i, :2] - boxes[i, 2:] / 2, boxes[i, :2] + boxes[i, 2:] / 2
            d = np.clip(np.minimum(hi_i, hi_j) - np.maximum(lo_i, lo_j), 0, None)
            inter = d[0] * d[1]
            iou = inter / (boxes[i, 2] * boxes[i, 3] + boxes[j, 2] * boxes[j, 3] - inter)
            ok &= iou < thr
        if ok:
            kept.append(j)
    return kept


@pytest.mark.parametrize("n,n_keep,invalid_tail", [
    (3 * ROUND_CHUNK + 5, 20, 0),   # chain depth 29 > 3 round chunks
    (60, 25, 12),                   # invalid (NEG_INF) suffix, as the detect stage feeds
    (40, 10, 0),                    # fewer slots than survivors
], ids=["deep_chain", "invalid_tail", "truncated"])
def test_nms_fixpoint_matches_jax_on_deep_chains(n, n_keep, invalid_tail):
    torch.set_num_threads(1)
    boxes, scores = _chain(n, 2)
    boxes[1] = boxes[1][::-1].copy()  # second row: the chain runs the other way
    if invalid_tail:
        scores[:, -invalid_tail:] = -1e30
    got_idx, got_valid = greedy_nms_fixpoint(torch.from_numpy(boxes),
                                             torch.from_numpy(scores), n_keep)
    for b in range(2):
        want_idx, want_valid = jax_greedy_nms_fixpoint(
            jnp.asarray(boxes[b]), jnp.asarray(scores[b]), n_keep, presorted=True)
        np.testing.assert_array_equal(got_idx[b].numpy(), np.asarray(want_idx))
        np.testing.assert_array_equal(got_valid[b].numpy(), np.asarray(want_valid))
        kept = _greedy(boxes[b], scores[b], 0.5)[:n_keep]
        assert got_idx[b][got_valid[b]].tolist() == kept
