"""Streaming, batched and 736² inference in the port, on the CPU.

* ``StreamingPipeline`` keeps orienmask_tpu's order and depth behaviour
  (``tests/test_stream.py``), and each streamed frame's outputs equal
  ``pipeline(frame)``.
* A batch of three distinct images gives each image's B = 1 outputs.
* The 736² config's postprocess grid and transform size are JAX's.

The slim model (stage blocks (1, 1, 1, 1, 1)) at 128², f32, with the bbox
heads' logits spread as in ``test_torch_pipeline.py``."""

import numpy as np
import pytest
import torch

from orienmask_tpu.config import orienmask_yolo_coco_736_anchor4_fpn_plus_infer as jax_cfg736
from orienmask_tpu_torch.config import orienmask_yolo_coco_736_anchor4_fpn_plus_infer as cfg736
from orienmask_tpu_torch.data import FastCOCOTransform
from orienmask_tpu_torch.models import OrienMaskYOLOFPNPlus, variables_from_jax
from orienmask_tpu_torch.ops import OrienMaskYOLOPostProcess
from orienmask_tpu_torch.pipeline import InferencePipeline
from orienmask_tpu_torch.stream import StreamingPipeline
from test_torch_pipeline import SLIM, TRANSFORM, _postprocess_kwargs, _variables


@pytest.fixture(scope="module")
def pipe():
    from orienmask_tpu.models import OrienMaskYOLOFPNPlus as JaxModel

    torch.set_num_threads(1)
    pm = OrienMaskYOLOFPNPlus(3, 80, backbone_stage_blocks=SLIM)
    pm.load_state_dict(variables_from_jax(pm, _variables(JaxModel(3, 80, backbone_stage_blocks=SLIM))), strict=True)
    return InferencePipeline(pm, FastCOCOTransform(TRANSFORM),
                             OrienMaskYOLOPostProcess(**_postprocess_kwargs(), device="cpu"),
                             compute_dtype="float32", device="cpu")


def _frames(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (1, 96, 128, 3), dtype=np.uint8) for _ in range(n)]


def test_736_config_matches_jax():
    pp = cfg736["postprocess"]
    assert pp["image_size"] == [736, 736]
    assert pp["grid_size"] == [[23, 23], [46, 46], [92, 92]]
    assert cfg736["transform"]["pipeline"][0]["size"] == (736, 736)
    assert cfg736["stream_depth"] == 2
    assert cfg736 == jax_cfg736


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_streaming_order_and_depth(depth):
    """Frames come out in order, and at most depth + 1 are in flight."""

    class FakePipe:
        device = torch.device("cpu")

        class postprocess:
            @staticmethod
            def to_host_list(out):
                return [{"frame": out}]

        def run_device(self, image):
            return int(image[0, 0, 0, 0])

    sp = StreamingPipeline(FakePipe(), depth=depth, device="cpu")
    frames = [np.full((1, 2, 2, 3), i, np.uint8) for i in range(7)]
    results, most = [], 0
    for frame in frames:
        sp.submit(frame)
        most = max(most, len(sp._inflight))
        if sp.ready():
            results.append(sp.retrieve()[0]["frame"])
    results += [r[0]["frame"] for r in sp.drain()]
    assert results == list(range(7))
    assert most == depth + 1
    assert [r[0]["frame"] for r in StreamingPipeline(FakePipe(), depth, "cpu")(frames)] \
        == list(range(7))


def test_streaming_refuses_depth_zero_and_another_device(pipe):
    with pytest.raises(ValueError, match="depth"):
        StreamingPipeline(pipe, depth=0, device="cpu")

    class OnTheCard:
        device = torch.device("cuda")

    with pytest.raises(ValueError, match="pipeline is on cuda"):
        StreamingPipeline(OnTheCard(), depth=2, device="cpu")


def _assert_same_host_lists(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for key in g:
            np.testing.assert_array_equal(g[key], w[key])


def test_streamed_frames_equal_the_pipeline(pipe):
    frames = _frames(5)
    streamed = list(StreamingPipeline(pipe, depth=2, device="cpu")(frames))
    assert len(streamed) == len(frames)
    for dets, frame in zip(streamed, frames):
        want, _ = pipe(frame)
        _assert_same_host_lists(dets, want)
    assert sum(len(d[0]["bbox"]) for d in streamed) > 0


def test_batch_of_three_equals_each_image_alone(pipe):
    """B = 3 against three B = 1 runs: the same valid detections and
    classes, boxes and scores to 1e-5, and every mask byte (the convolutions
    batch differently, but the scores they give stay 1e-5 or more apart)."""
    frames = _frames(3, seed=1)
    batch = pipe.run_device(np.concatenate(frames))
    for b, frame in enumerate(frames):
        one = pipe.run_device(frame)
        np.testing.assert_array_equal(batch["valid"][b].numpy(), one["valid"][0].numpy())
        np.testing.assert_array_equal(batch["cls"][b].numpy(), one["cls"][0].numpy())
        np.testing.assert_allclose(batch["bbox"][b].numpy(), one["bbox"][0].numpy(),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(batch["mask"][b].numpy(), one["mask"][0].numpy())
    assert batch["valid"].sum() > 0
    results, pad_info = pipe(np.concatenate(frames))
    assert len(results) == 3 and pad_info == (0, 0, 0, 0, 128, 128)
