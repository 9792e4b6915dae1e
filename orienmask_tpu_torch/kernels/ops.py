"""Kernels 1 and 2 as ``torch.library`` custom operators, so that
``torch.export`` traces the inference program through them and a served
program (``serving.py``) calls them:

* ``omt::exact_topk(Tensor x, int k) -> (Tensor, Tensor)``: kernel 1,
  ``ops/topk.py``;
* ``omt::assemble_masks_packed(Tensor field, Tensor boxes, Tensor
  anchor_idx, Tensor anchor_table, float orien_thresh, int? coord_h, int
  row0, Tensor? valid) -> Tensor``: kernel 2, ``ops/masks.py``.

Each has a CPU implementation, the kernel's plain version, and a CUDA one,
the kernel's launch with its argument checks, which raises on a launch
error and counts the launch in ``kernels.launches``; so an eager call and a
served one count alike.  ``register_fake`` gives each output's shape and
type from the inputs' shapes alone, which is all that tracing reads.

Loading this module loads no model code: the implementations are imported
at their first call.  Kernels 3 to 6 lie on no exported path and stay plain
functions.
"""

import torch

torch.library.define("omt::exact_topk", "(Tensor x, int k) -> (Tensor, Tensor)")
torch.library.define(
    "omt::assemble_masks_packed",
    "(Tensor field, Tensor boxes, Tensor anchor_idx, Tensor anchor_table, float orien_thresh, "
    "int? coord_h, int row0, Tensor? valid) -> Tensor")

exact_topk = torch.ops.omt.exact_topk
assemble_masks_packed = torch.ops.omt.assemble_masks_packed


@torch.library.impl("omt::exact_topk", "cpu")
def _exact_topk_cpu(x, k):
    from ..ops.topk import exact_topk_plain

    # an operator's outputs are fresh tensors, laid out as the fake ones
    return tuple(t.contiguous() for t in exact_topk_plain(x, k))


@torch.library.impl("omt::exact_topk", "cuda")
def _exact_topk_cuda(x, k):
    from ..ops.topk import check_topk_args, exact_topk_cuda

    check_topk_args(x, k)
    return exact_topk_cuda(x, k)


@torch.library.register_fake("omt::exact_topk")
def _exact_topk_fake(x, k):
    b = x.shape[0]
    return x.new_empty((b, k), dtype=torch.float32), x.new_empty((b, k), dtype=torch.int64)


@torch.library.impl("omt::assemble_masks_packed", "cpu")
def _assemble_masks_packed_cpu(field, boxes, anchor_idx, anchor_table, orien_thresh, coord_h,
                               row0, valid):
    from ..ops.masks import assemble_masks_packed_plain

    return assemble_masks_packed_plain(field, boxes, anchor_idx, anchor_table, orien_thresh,
                                       coord_h, row0, valid)


@torch.library.impl("omt::assemble_masks_packed", "cuda")
def _assemble_masks_packed_cuda(field, boxes, anchor_idx, anchor_table, orien_thresh,
                                coord_h, row0, valid):
    from ..ops.masks import assemble_masks_packed_cuda

    return assemble_masks_packed_cuda(field, boxes, anchor_idx, anchor_table, orien_thresh,
                                      coord_h, row0, valid)


@torch.library.register_fake("omt::assemble_masks_packed")
def _assemble_masks_packed_fake(field, boxes, anchor_idx, anchor_table, orien_thresh,
                                coord_h, row0, valid):
    b, _, _, h, w = field.shape
    return field.new_empty((b, boxes.shape[1], h, w // 8), dtype=torch.uint8)
