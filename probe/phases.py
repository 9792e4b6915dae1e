"""Per-block phase times of kernel 2's one-byte design (probe/designs/byte.cu)
from clock64 and globaltimer probes put into a copy of it: set-up, grouping,
the empty masks, the sample positions and the per-detection loop, with the
spread of block start and end times, on cases (a), (b), none valid and K = 1
(see probe/designs.py); then the profiler's times of a 1-element add, a
3.7 MB zero_ and a 2.4 MB copy for scale.

Run from the repository's root on a machine with the card:
    python3 probe/phases.py
"""
import ctypes
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, ".")
import numpy as np
import torch

import chip_smoke as cs
from orienmask_tpu_torch import kernels
from orienmask_tpu_torch.ops.masks import _f32

src = Path("probe/designs/byte.cu").read_text()
def put(after, text):
    global src
    assert src.count(after) >= 1, after
    src = src.replace(after, after + "\n" + text, 1)


put("  extern __shared__ __align__(16) unsigned char smem_raw[];",
    "  unsigned long long* PR = g_probe + (blockIdx.y * gridDim.x + blockIdx.x) * 8;\n"
    "  const bool T0 = threadIdx.x == 0 && threadIdx.y == 0;\n"
    "  if (T0) { PR[6] = gtimer(); PR[0] = clock64(); }")
put("  for (int w = 0; w < kThreads / 32; ++w) used |= warp_used[w];", "  if (T0) PR[1] = clock64();")
put("    if (lane == 0) start[n_used + 1] = n;\n  }\n  __syncthreads();", "  if (T0) PR[2] = clock64();")
put("    o[order[j] * kstride] = 0;\n  }", "  if (T0) PR[3] = clock64();")
put("    if (has_nan) tb.y = CUDART_NAN_F;  // refuses all in", "    if (T0 && ja == 0) PR[5] = clock64();")
src = src.replace("        o[order[j] * kstride] = (uint8_t)byte;\n      }\n    }\n  }\n}",
                  "        o[order[j] * kstride] = (uint8_t)byte;\n      }\n    }\n  }\n"
                  "  if (T0) { PR[4] = clock64(); PR[7] = gtimer(); }\n}")
assert "PR[4]" in src
src = src.replace("namespace {", "namespace {\n__device__ unsigned long long g_probe[1 << 20];\n"
                  "__device__ __forceinline__ unsigned long long gtimer() {\n"
                  "  unsigned long long t; asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t)); return t; }\n", 1)
src += ("\nextern \"C\" int omt_probe_read(unsigned long long* dst, int n) {\n"
        "  return (int)cudaMemcpyFromSymbol(dst, g_probe, n * 8); }\n")
build = Path("probe/build"); build.mkdir(parents=True, exist_ok=True)
(build / "phases.cu").write_text(src)
subprocess.run([kernels._nvcc(), *[f for f in kernels.NVCC_FLAGS if f not in ("-v", "-Xptxas")],
                "-o", str(build / "libphases.so"), str(build / "phases.cu")], check=True)
lib = ctypes.CDLL(str(build / "libphases.so"))
lib.omt_assemble_masks_packed.argtypes = kernels.SIGNATURES["masks"]["omt_assemble_masks_packed"]
lib.omt_probe_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
cs.log("card:", cs.card_line())

pipe, pp_kw = cs.build_pipeline()
image = torch.from_numpy(np.random.default_rng(cs.SEED).integers(
    0, 256, (1, 480, 640, 3), dtype=np.uint8)).cuda()
field, boxes, aidx, valid = cs.main_path_inputs(pipe, image)["masks"][0]
pp = pipe.postprocess
spread = cs.mask_inputs(np.random.default_rng(cs.SEED + 2), 1)
spread[2] = torch.arange(100, device="cuda", dtype=torch.int32).remainder(9)[None]
cases = [("a", (field, boxes, aidx, pp.norm_anchors), pp.orien_thresh, valid),
         ("b", tuple(spread), 0.3, None),
         ("none", (field, boxes, aidx, pp.norm_anchors), pp.orien_thresh, torch.zeros_like(valid)),
         ("K=1", (field, boxes[:, :1].contiguous(), aidx[:, :1].contiguous(), pp.norm_anchors),
          pp.orien_thresh, None)]
for name, (f, bx, ai, tb), th, v in cases:
    b, a, _, h, w = f.shape
    k = bx.shape[1]
    out = torch.empty((b, k, h, w // 8), dtype=torch.uint8, device="cuda")
    for _ in range(3):
        assert lib.omt_assemble_masks_packed(
            f.data_ptr(), bx.data_ptr(), ai.data_ptr(), tb.data_ptr(),
            None if v is None else v.data_ptr(), out.data_ptr(), b, a, h, w, k, th,
            _f32(1.0 / w), _f32(1.0 / h), 0, torch.cuda.current_stream().cuda_stream) == 0
        torch.cuda.synchronize()
    nb = b * ((h * (w // 8) + 63) // 64)
    buf = np.zeros(nb * 8, np.uint64)
    assert lib.omt_probe_read(buf.ctypes.data, nb * 8) == 0
    p = buf.reshape(nb, 8).astype(np.int64)
    d = np.diff(p[:, [0, 1, 2, 3, 5, 4]], axis=1)
    g0 = p[:, 6] - p[:, 6].min()
    g1 = p[:, 7] - p[:, 6].min()
    cs.log(f"  ({name}) cycles median/max: setup {np.median(d[:, 0]):.0f}/{d[:, 0].max()}, "
           f"grouping {np.median(d[:, 1]):.0f}/{d[:, 1].max()}, zeros {np.median(d[:, 2]):.0f}/"
           f"{d[:, 2].max()}, g {np.median(d[:, 3]):.0f}/{d[:, 3].max()}, "
           f"dets {np.median(d[:, 4]):.0f}/{d[:, 4].max()}; block start ns "
           f"median {np.median(g0):.0f} max {g0.max()}; block end ns median {np.median(g1):.0f} "
           f"max {g1.max()}")

from torch.profiler import ProfilerActivity, profile


def device_us(fn, n=20):
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.device_time_total > 0]
    return ", ".join(f"{e.key[:30]} {e.device_time_total / e.count:.2f} us" for e in ev)


one = torch.ones(1, device="cuda")
m = torch.empty((1, 100, 544, 68), dtype=torch.uint8, device="cuda")
cs.log("  1-element add_:", device_us(lambda: one.add_(1)))
cs.log("  zero_ of 3.7 MB:", device_us(lambda: m.zero_()))
cs.log("  copy of 2.4 MB:", device_us(lambda: field[0, 0].clone()))
