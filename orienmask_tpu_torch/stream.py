"""Streaming (video) inference with a bounded in-flight frame queue
(counterpart of ``orienmask_tpu/stream.py``).

``depth`` frames stay submitted but not fetched.  On the card, ``submit``
stages the frame in pinned host memory, uploads it without blocking, queues
the frame's work on the current stream and records an event after it;
``retrieve`` copies the oldest frame's outputs into pinned host buffers on a
copy stream that waits for that event alone, then waits for the copy's own
event (never ``torch.cuda.synchronize``), so frame i's copy and
``to_host_list`` overlap the queued work of frames i+1 ... i+depth.

The NMS convergence check (``ops/nms.py``) reads a flag on the host once per
8 rounds, so ``submit`` returns only when the frame's work up to NMS has run:
what overlaps the host's handling of frame i is the work queued behind
frame i+1's last NMS check (its mask tail) and the copies, not whole frames.
"""

from collections import deque

import torch

from .device import resolve_device


class StreamingPipeline:
    """Wraps an ``InferencePipeline`` with a bounded in-flight frame queue."""

    def __init__(self, pipeline, depth=2, device=None):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.device = resolve_device(device)
        if pipeline.device != self.device:
            raise ValueError(f"the pipeline is on {pipeline.device}, the stream on "
                             f"{self.device}")
        self.pipeline = pipeline
        self.depth = depth
        self._inflight = deque()
        self._copy_stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" \
            else None

    def submit(self, image):
        """Queue one frame (B, H, W, 3) uint8 (host array or tensor)."""
        if self._copy_stream is None:
            self._inflight.append((self.pipeline.run_device(image), None))
            return
        image = torch.as_tensor(image)
        if image.device.type == "cpu":
            staged = torch.empty(image.shape, dtype=image.dtype, pin_memory=True)
            staged.copy_(image)
            image = staged.to(self.device, non_blocking=True)
        out = self.pipeline.run_device(image)
        done = torch.cuda.Event()
        done.record()
        self._inflight.append((out, done))

    def ready(self):
        return len(self._inflight) > self.depth

    def retrieve(self):
        """The oldest frame's detections (host list of per-image dicts)."""
        out, done = self._inflight.popleft()
        if done is not None:
            with torch.cuda.stream(self._copy_stream):
                self._copy_stream.wait_event(done)
                host = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                        for k, v in out.items()}
                for k, v in out.items():
                    host[k].copy_(v, non_blocking=True)
                copied = torch.cuda.Event()
                copied.record(self._copy_stream)
            copied.synchronize()
            out = host
        return self.pipeline.postprocess.to_host_list(out)

    def drain(self):
        while self._inflight:
            yield self.retrieve()

    def __call__(self, frames):
        """Generator: an iterable of (B, H, W, 3) frames -> each frame's
        detections, in order, with ``depth`` frames in flight."""
        for frame in frames:
            self.submit(frame)
            if self.ready():
                yield self.retrieve()
        yield from self.drain()
