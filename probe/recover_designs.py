"""Kernel 6 (``csrc/recover.cu``, the COCO conversion's mask recovery) in
its designs, side by side on phase 16's cases (a)-(g) of chip_smoke.py: each
held bit for bit against the plain version, then timed in turns (each
design's first timing in one order, its second in the reverse) with
``chip_smoke.time_ms`` (CUDA graph replays between events).  Designs:

* per pixel: the first kernel, a warp per (detection, 32 output columns, 32
  output rows), a lane a column, seven loads from device memory and the
  whole arithmetic on every pixel (``probe/designs/recover_pixels.cu``);
* lanes on columns (``probe/designs/recover_lanes.cu``): the same staging
  and tables as the shipped kernel, but a lane owns an
  output column and walks the tile's 32 rows, loading each row's record,
  two 64-bit windows of staged word pairs and its table entry from shared
  memory (about five wavefronts a row); its uniform-tile check reads the
  source rectangle; identity tiles one at a time;
* row parts (``probe/designs/recover_rowsplit.cu``): the shipped kernel with
  a block a (detection, band, part of 8 row tiles), staging only the rows
  its part reads (a table of each image's parts);
* persistent (``probe/designs/recover_persistent.cu``): the shipped tiles,
  but as many blocks as the card holds, each walking a run of (band,
  detection) items (all rows) with its tables built once a band and the next
  item's rows staged (a second buffer) while it works on one;
* shipped: a lane owns an output row, its windows in registers, a table load
  and a fused multiply-add a pixel, a transpose a tile; a block a
  (detection, band of 64 columns);
* band 32, band 128: the shipped source with a block owning that many
  output columns (64 shipped);
* no tile check: the shipped source with the uniform-tile paths removed
  (every tile of an image that is not an identity takes the per-pixel path);
* 2 warps, 4 warps, 16 warps: the shipped source with other block sizes (8
  shipped);
* identity 4 tiles: the shipped source with a warp transposing four tiles at
  once, their shuffle rounds interleaved (one at a time shipped);
* phases (not timed): the shipped source with clock64 read by thread 0 of
  every block at each phase's end, each phase's cycles summed over the
  blocks (``g_phase``) and printed as a mean a block;
* identity as general: the shipped kernel with the identity flag cleared on
  the host, so that (b) takes the per-pixel path.

ptxas's lines (registers, shared memory, spills) of every design first, and
each case's shared memory a block and blocks an SM.  Writes the times to OUT
(default probe/build/recover_designs.json, ignored by git).  Run from the
repository's root on a machine with the card:
    python3 probe/recover_designs.py [OUT]
"""
import ctypes
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, ".")
import numpy as np
import torch

import chip_smoke as cs
from orienmask_tpu_torch import kernels
from orienmask_tpu_torch.ops import recover

SHIPPED = Path("orienmask_tpu_torch/csrc/recover.cu").read_text()
BAND = "constexpr int kBand = 64;"
WARPS = "constexpr int kWarps = 8;"
ZERO = "    if (__all_sync(0xFFFFFFFFu, zero)) {"
ONE = "    } else if (__all_sync(0xFFFFFFFFu, one)) {"
LOOP1 = "  for (int q = warp; q < tiles; q += kWarps) {"
IDENTITY_END = "  __syncthreads();\n  for (int q = threadIdx.x; q < ow * wpc; q += blockDim.x) "
LOOP4 = """  for (int q0 = 4 * warp; q0 < tiles; q0 += 4 * kWarps) {
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int q = min(q0 + j, tiles - 1), k = q % groups, row = 32 * (q / groups) + lane;
      w[j] = row < oh ? lsb_first(*(const uint32_t*)(smem + row * Wb + 4 * k)) : 0u;
    }
#pragma unroll
    for (int m = 16; m; m >>= 1)
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = transpose_round(w[j], lane, m);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int q = q0 + j, k = q % groups, t = q / groups;
      if (q < tiles && 32 * k + lane < ow) words[(32 * k + lane) * wpc + t] = w[j];
    }
  }
"""
BULK = "  bulk_load(smem, mask, align16(oh * Wb), (uint64_t*)(smem + lay.bar));\n"
# clock64 phase probe: thread 0 of every block adds each phase's cycles to
# g_phase (other images 0-6, identity images 8-10) and counts its block (15, 14)
PHASE = ("__device__ unsigned long long g_phase[16];\n"
         "#define PHASE(i) if (threadIdx.x == 0) { const unsigned long long now = clock64(); "
         "atomicAdd(&g_phase[i], now - t_last); t_last = now; }\n")
PHASE_READ = """
extern "C" int omt_phase_read(unsigned long long* h) {
  return (int)cudaMemcpyFromSymbol(h, g_phase, sizeof(g_phase));
}
extern "C" int omt_phase_reset() {
  static const unsigned long long z[16] = {};
  return (int)cudaMemcpyToSymbol(g_phase, z, sizeof(z));
}
"""
PHASE_NAMES = {0: "stage issue", 1: "tables", 2: "records", 3: "chunks wait", 5: "tiles",
               6: "write", 8: "identity bulk load", 9: "identity transposes",
               10: "identity write"}
_P, _I = ctypes.c_void_p, ctypes.c_int
ARGS = {"per pixel": [_P] * 7 + [_I] * 5 + [_P],
        "lanes on columns": [_P] * 8 + [_I] * 10 + [_P],
        "persistent": [_P] * 8 + [_I] * 10 + [_P],
        "row parts": [_P] * 9 + [_I] * 8 + [_P]}
OCCUPANCY = {"lanes on columns": [_I] * 6, "persistent": [_I] * 5, "row parts": [_I] * 4}


def variant(*edits):
    src = SHIPPED
    for a, b in edits:
        assert a in src, a
        src = src.replace(a, b)
    return src


def phases_source():
    t0 = "  unsigned long long t_last = clock64();\n"
    words = "  uint32_t* words = (uint32_t*)(smem + align16(oh * Wb));\n"
    return variant(
        ("namespace {\n", "namespace {\n" + PHASE),
        (words + BULK, t0 + words + BULK + "  PHASE(8)\n"),
        (IDENTITY_END + "out[q] = words[q];\n",
         "  __syncthreads();\n  PHASE(9)\n  for (int q = threadIdx.x; q < ow * wpc; "
         "q += blockDim.x) out[q] = words[q];\n  PHASE(10)\n"
         "  if (threadIdx.x == 0) atomicAdd(&g_phase[14], 1ull);\n"),
        ("  const int* g = geom + kGeom * blockIdx.y;\n",
         "  const int* g = geom + kGeom * blockIdx.y;\n" + t0),
        ("  cp_async_commit();\n  // while the chunks arrive",
         "  cp_async_commit();\n  PHASE(0)\n  // while the chunks arrive"),
        ("  build_tables(xtab, xfrac, xoff, c0, ow, g0, columns);\n",
         "  build_tables(xtab, xfrac, xoff, c0, ow, g0, columns);\n  PHASE(1)\n"),
        ("  cp_async_wait<0>();\n  __syncthreads();\n  uint32_t* words",
         "  PHASE(2)\n  cp_async_wait<0>();\n  __syncthreads();\n  PHASE(3)\n  uint32_t* words"),
        ("g0, kw);\n  __syncthreads();\n",
         "g0, kw);\n  __syncthreads();\n  PHASE(5)\n"),
        ("q += blockDim.x) dst[q] = words[q];\n}",
         "q += blockDim.x) dst[q] = words[q];\n  PHASE(6)\n"
         "  if (threadIdx.x == 0) atomicAdd(&g_phase[15], 1ull);\n}"),
    ) + PHASE_READ


def four_tiles_source():
    start, end = SHIPPED.index(LOOP1), SHIPPED.index(IDENTITY_END)
    return SHIPPED[:start] + LOOP4 + SHIPPED[end:]


def sources():
    return {"per pixel": Path("probe/designs/recover_pixels.cu").read_text(),
            "lanes on columns": Path("probe/designs/recover_lanes.cu").read_text(),
            "shipped": SHIPPED,
            "band 32": variant((BAND, "constexpr int kBand = 32;")),
            "band 128": variant((BAND, "constexpr int kBand = 128;")),
            "no tile check": variant((ZERO, "    if (false) {"), (ONE, "    } else if (false) {")),
            "persistent": Path("probe/designs/recover_persistent.cu").read_text(),
            "row parts": Path("probe/designs/recover_rowsplit.cu").read_text(),
            "2 warps": variant((WARPS, "constexpr int kWarps = 2;")),
            "4 warps": variant((WARPS, "constexpr int kWarps = 4;")),
            "16 warps": variant((WARPS, "constexpr int kWarps = 16;")),
            "identity 4 tiles": four_tiles_source(),
            "phases": phases_source()}


def build(srcs, outdir):
    """Each source with nvcc, in parallel; ptxas's lines; the loaded libraries."""
    outdir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, src) in enumerate(srcs.items()):
        cu = outdir / f"recover{i}.cu"
        cu.write_text(src)
        procs[name] = (cu.with_suffix(".so"), subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(cu.with_suffix(".so")), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, ptxas = {}, {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        assert proc.returncode == 0, out
        ptxas[name] = [ln.strip() for ln in out.splitlines()
                       if "Compiling entry" in ln or "registers" in ln or "spill" in ln]
        for ln in ptxas[name]:
            cs.log(f"  ptxas ({name}): {ln}")
        lib = ctypes.CDLL(str(so))
        lib.omt_recover_masks.argtypes = ARGS.get(
            name, kernels.SIGNATURES["recover"]["omt_recover_masks"])
        lib.omt_recover_masks.restype = ctypes.c_int
        if name in OCCUPANCY:  # the other designs with this entry point
            lib.omt_recover_occupancy.argtypes = OCCUPANCY[name] + [_P, _P]
        elif name != "per pixel":
            lib.omt_recover_occupancy.argtypes = \
                kernels.SIGNATURES["recover"]["omt_recover_occupancy"]
        if name == "phases":
            lib.omt_phase_read.argtypes = [ctypes.c_void_p]
        libs[name] = lib
    return libs, ptxas


def stream():
    return torch.cuda.current_stream().cuda_stream


def run_pixels(lib, packed, geom):
    """The first kernel's entry point: (B, 8) geometry rows, a warp per
    (detection, 32 columns, 32 rows)."""
    b, k, h, wb = packed.shape
    rows = torch.cat([geom.geom[:, :7], torch.zeros_like(geom.geom[:, :1])], 1).contiguous()
    warps = max([n * -(-ow // 32) * -(-oh // 32) for n, (oh, ow) in zip(geom.counts, geom.sizes)])
    out = torch.empty(geom.offsets[-1], dtype=torch.int32, device="cuda")
    err = lib.omt_recover_masks(packed.data_ptr(), rows.data_ptr(), geom.xtab.data_ptr(),
                                geom.xfrac.data_ptr(), geom.ytab.data_ptr(),
                                geom.yfrac.data_ptr(), out.data_ptr(), b, k, h, wb, warps,
                                stream())
    assert err == 0, err
    return out


@dataclasses.dataclass
class Design:
    """A design's tables and the entry point's arguments after the packed
    masks: its geometry rows, tables, grid and shared memory sizes."""
    geom: torch.Tensor
    tables: tuple  # device tensors between the geometry and the column table
    grid: tuple
    sizes: tuple


def shipped_design(geom):
    return Design(geom.geom, (geom.bands,), (geom.max_tasks,),
                  (geom.kw_max, geom.rows_max, geom.wpc_max, geom.identity_rows))


def identity(geom):
    return [bool(f & recover.IDENTITY) for f in geom.geom[:, 7].tolist()]


def lanes_design(geom):
    """The first design's band windows: pixel p at bit p - 32 g0 >= 10 of a
    band's staged rows, g0 = (min p - 10) // 32, and kw word pairs a row (the
    top window's, one more for the check); a block a (detection, band)."""
    bands, kw_max = [], 0
    for (n, _, ow, _, xo, *_), ident in zip(geom.geom.tolist(), identity(geom)):
        if not n:
            continue
        p = geom.xtab[xo:xo + ow].min(1).values.cpu().numpy().astype(np.int64)
        starts = np.arange(0, ow, geom.band)
        lo, hi = np.minimum.reduceat(p, starts), np.maximum.reduceat(p, starts)
        g0 = (lo - 10) // 32
        kw = (hi - 32 * g0 - 8) // 32 + 2
        bands.append(np.stack([g0, kw], 1))
        if not ident:
            kw_max = max(kw_max, int(kw.max()))
    bands = torch.from_numpy(np.concatenate(bands).astype(np.int32)).to(geom.geom.device)
    return Design(geom.geom, (bands,), (geom.band, geom.max_tasks),
                  (kw_max, geom.rows_max, geom.wpc_max, geom.identity_rows))


def persistent_design(geom):
    """As many blocks as the card holds, shared by the images that are not
    identities: (identity detections, such images)."""
    ident = identity(geom)
    return Design(geom.geom, (geom.bands,),
                  (max([n for n, i in zip(geom.counts, ident) if i], default=0),
                   sum(n > 0 and not i for n, i in zip(geom.counts, ident))),
                  (geom.kw_max, geom.rows_max, geom.wpc_max, geom.identity_rows))


def rowsplit_design(geom, tiles=8):
    """A block a (detection, band, part of 8 row tiles), staging the rows
    its part reads: ints 9-11 of an image's row (first part, columns a
    sub-band, 0) and a table of each part's (first staged row, staged rows)."""
    g, parts, rows_max, blocks = geom.geom.clone(), [], 0, 0
    ident = identity(geom)
    for b, (n, oh, ow, _, _, yo, *_) in enumerate(geom.geom.tolist()):
        g[b, 9], g[b, 10], g[b, 11] = sum(len(p) for p in parts), geom.geom[b, 11], 0
        if not n:
            continue
        if ident[b]:
            blocks = max(blocks, n)
            continue
        y = geom.ytab[yo:yo + oh].cpu().numpy()
        starts = np.arange(0, oh, 32 * tiles)
        ylo = np.minimum.reduceat(y.min(1), starts)
        staged = np.maximum.reduceat(y.max(1), starts) - ylo + 1
        parts.append(np.stack([ylo, staged], 1))
        rows_max = max(rows_max, int(staged.max()))
        blocks = max(blocks, n * -(-ow // geom.band) * len(starts))
    parts = np.concatenate(parts) if parts else np.zeros((1, 2), np.int64)
    return Design(g, (geom.bands, torch.from_numpy(parts.astype(np.int32)).to(g.device)),
                  (blocks,), (geom.kw_max, rows_max, geom.identity_rows))


def as_general(geom):
    """The shipped design with the identity flag cleared: identity images
    take the per-pixel path, staging the rows they read."""
    g = geom.geom.clone()
    rows_max, wpc_max = geom.rows_max, geom.wpc_max
    for b, (n, oh, ow, wpc, _, yo, _, flags, *_) in enumerate(geom.geom.tolist()):
        if n and flags & recover.IDENTITY:
            y = geom.ytab[yo:yo + oh]
            g[b, 7], g[b, 9], g[b, 10] = 0, int(y.min()), int(y.max() - y.min()) + 1
            rows_max, wpc_max = max(rows_max, int(g[b, 10])), max(wpc_max, wpc)
    blocks = int((geom.geom[:, 0] * -(-geom.geom[:, 2] // geom.band)).max())
    return Design(g, (geom.bands,), (blocks,),
                  (max(geom.kw_max, int(geom.bands[:, 1].max())), rows_max, wpc_max, 0))


def run(lib, packed, geom, design):
    b, k, h, wb = packed.shape
    out = torch.empty(geom.offsets[-1], dtype=torch.int32, device="cuda")
    err = lib.omt_recover_masks(
        packed.data_ptr(), design.geom.data_ptr(), *(t.data_ptr() for t in design.tables),
        geom.xtab.data_ptr(), geom.xfrac.data_ptr(), geom.ytab.data_ptr(), geom.yfrac.data_ptr(),
        out.data_ptr(), b, k, h, wb, *design.grid, *design.sizes, stream())
    assert err == 0, err
    return out


def occupancy(lib, design, wb, lanes=False):
    smem, blocks = ctypes.c_int(), ctypes.c_int()
    band = (design.grid[0],) if lanes else ()
    assert lib.omt_recover_occupancy(*band, *design.sizes, wb, ctypes.byref(smem),
                                     ctypes.byref(blocks)) == 0
    return smem.value, blocks.value


def phases(lib, packed, geom):
    """The phase probe's cycles a block, each phase's mean over the blocks
    that ran it (one launch after a warm-up)."""
    design = shipped_design(geom)
    run(lib, packed, geom, design)
    assert lib.omt_phase_reset() == 0
    run(lib, packed, geom, design)
    torch.cuda.synchronize()
    raw = (ctypes.c_ulonglong * 16)()
    assert lib.omt_phase_read(raw) == 0
    general, identity = raw[15] or 1, raw[14] or 1
    out = {name: raw[i] / (identity if i >= 8 else general) for i, name in PHASE_NAMES.items()
           if raw[i]}
    out.update(blocks=raw[15], identity_blocks=raw[14])
    return out


def main():
    t0 = time.perf_counter()
    cs.log("card:", cs.card_line(), f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    libs, ptxas = build(sources(), Path("probe/build"))
    cs.log(f"built in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(cs.SEED + 16)  # phase 16's cases
    results = {}
    for key, label, packed, infos, counts in cs.recover_cases(rng):
        hw, wb = (packed.shape[2], 8 * packed.shape[3]), packed.shape[3]
        geoms = {band: recover.recover_geometry(infos, counts, hw, "cuda", band=band)
                 for band in (32, 64, 128)}
        want = recover.recover_masks_plain(packed, geoms[64])
        designs = {"lanes on columns": lanes_design(geoms[64]),
                   "persistent": persistent_design(geoms[64]),
                   "row parts": rowsplit_design(geoms[64]),
                   "band 32": shipped_design(geoms[32]),
                   "band 128": shipped_design(geoms[128])}
        fns = {"per pixel": lambda: run_pixels(libs["per pixel"], packed, geoms[64])}
        occ = {}
        for name in ("lanes on columns", "persistent", "row parts", "shipped", "band 32",
                     "band 128", "no tile check", "2 warps", "4 warps", "16 warps",
                     "identity 4 tiles"):
            design = designs.get(name, shipped_design(geoms[64]))
            fns[name] = lambda lib=libs[name], d=design: run(lib, packed, geoms[64], d)
            occ[name] = occupancy(libs[name], design, wb, name == "lanes on columns")
        if key == "b":
            fns["identity as general"] = lambda d=as_general(geoms[64]): run(
                libs["shipped"], packed, geoms[64], d)
        cs.log(f"  ({key}) shared memory bytes, blocks an SM: {occ}")
        wrong = [d for d, fn in fns.items() if not torch.equal(fn(), want)]
        times = {d: [] for d in fns}
        for order in (list(fns), list(fns)[::-1]):
            for d in order:
                times[d].append(cs.time_ms(fns[d]) * 1e3)
        cs.log(f"  ({key}) {label}; us: " + "; ".join(
            f"{d} {t[0]:.2f}, {t[1]:.2f}" for d, t in times.items())
            + (f"; WRONG: {wrong}" if wrong else "; all identical to the plain version"))
        results[key] = dict(label=label, us=times, wrong=wrong, occupancy=occ,
                            phases=phases(libs["phases"], packed, geoms[64]))
        cs.log(f"  ({key}) cycles a block (thread 0): {results[key]['phases']}")
    cs.log(f"card: {cs.card_line()}; total {time.perf_counter() - t0:.1f} s")
    path = Path(sys.argv[1] if len(sys.argv) > 1 else "probe/build/recover_designs.json")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(dict(card=cs.card_line(), ptxas=ptxas, cases=results), indent=1))
    if any(r["wrong"] for r in results.values()):
        sys.exit(1)


if __name__ == "__main__":
    main()
