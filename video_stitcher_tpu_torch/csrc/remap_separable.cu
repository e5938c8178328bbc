// K2: the vertical pass (Pass V) of the separable two-pass warp.
//
// Replaces the TPU kernel experiments/remap_separable.py (_kernel, launched
// by pass_v). What it computes, per camera n, channel c and band pixel
// (y, x), with I1 = pass_h(src) lane-padded by xpad zero columns on the
// left:
//
//   out[n,c,y,x] = bilinear(I1[n,c], x = vmaps[n,0,y,x] + xpad,
//                                    y = vmaps[n,1,y,x])
//
// with the x tent weights rounded to bf16, as the TPU kernel feeds them to
// its matrix unit, and the y weights and all sums in f32, each computed
// with the TPU kernel's f32 arithmetic. A tap outside
// I1 adds exactly 0, so the -2 marker of invalid pixels gives 0. Its plain
// version is experiments/remap_separable.py::pass_v_plain.
//
// What bounds it: memory. Per call it must write three f32 channels of
// every band pixel and read the vmaps of the pixels whose taps reach I1,
// and the I1 (bf16) pixels those taps read. At the 6x1080p rig (bands
// 1664x1280, I1 1792x1088) that is 153 MB of output, ~55 MB of the maps of
// the ~54% of tiles that are active and up to 70 MB of I1. The arithmetic
// (a few dozen flops a pixel) is far below the card's rate.
//
// What held the one-thread-per-pixel kernel this replaces at a third of
// that bound, and below grid_sample on the same function (PERF.md, section 6):
// the dependent, masked scalar tap loads after scalar map loads, threads
// that loaded maps only to write zeros, and a runtime division for the
// chunk base in every thread. The design is K1's (warp_tiles.cuh): a tile
// plan lets the empty tiles write zeros without reading their vmaps;
// persistent blocks keep the next active tile's vmaps coming into a
// shared-memory ring by cp.async.bulk while the current tile gathers its
// taps through L1; each thread reads the vmaps of 4 pixels as two 16-byte
// vectors and writes them per channel as one 16-byte streaming store. A
// thread's 4 pixels share one 32-column chunk, whose base is a mask of
// the column: no division.
//
// Built by nvcc into a shared library with a plain C interface (no torch
// headers) and called through ctypes; see video_stitcher_tpu_torch/_build.py.

#include "warp_tiles.cuh"

namespace {

constexpr int kChunkW = 32;   // the TPU kernel's column chunk (CHUNK_W)
static_assert(warp_tiles::kTileW % kChunkW == 0
                  && kChunkW % warp_tiles::kVec == 0,
              "a thread's pixels must share one chunk");

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

struct PassV {
  using T = __nv_bfloat16;
  struct Ctx {};
  struct Pixel {
    int x0, y0;
    float wx0, wx1, wy0, wy1;
  };
  const T* src;   // I1
  int h, w;       // padded I1 rows and lanes
  int xpad;

  __device__ Ctx tile(int) const { return {}; }

  __device__ Pixel pixel(float mx, float my, int x) const {
    // The TPU kernel's x arithmetic: the tent is evaluated relative to the
    // first lane of the output column's chunk (band x = base), which
    // decides where f32 rounds. Outside padded lanes [-2, w + 1] and rows
    // [-2, h + 1] every tap is out, so clamping there changes nothing.
    const int base = (x & ~(kChunkW - 1)) - xpad;
    const float lx = fminf(fmaxf(mx, -2.0f - xpad), w + 1.0f - xpad)
                     - static_cast<float>(base);
    const float ly = fminf(fmaxf(my, -2.0f), h + 1.0f);
    const float kx = floorf(lx);
    const float ky = floorf(ly);
    return {static_cast<int>(kx) + base + xpad,   // padded lane
            static_cast<int>(ky),
            round_bf16(__fsub_rn(1.0f, __fsub_rn(lx, kx))),
            round_bf16(__fsub_rn(1.0f, __fsub_rn(kx + 1.0f, lx))),
            __fsub_rn(1.0f, __fsub_rn(ly, ky)),
            __fsub_rn(1.0f, __fsub_rn(ky + 1.0f, ly))};
  }

  __device__ float blend(const Ctx&, const Pixel& p, float v00, float v01,
                         float v10, float v11) const {
    // explicit roundings, no fused multiply-add: the sums round where the
    // plain version's (and the TPU kernel's) do
    const float h0 = __fadd_rn(__fmul_rn(p.wx0, v00), __fmul_rn(p.wx1, v01));
    const float h1 = __fadd_rn(__fmul_rn(p.wx0, v10), __fmul_rn(p.wx1, v11));
    return __fadd_rn(__fmul_rn(p.wy0, h0), __fmul_rn(p.wy1, h1));
  }
};

}  // namespace

// i1: bf16 [n, channels, hp, wp]; vmaps: f32 [n, 2, bh, bw]; out: f32
// [n, channels, bh, bw]; wp = bw + xpad + right pad; chunk_w the width of
// the TPU kernel's column chunks (32); order: int32 [n * tiles_y *
// tiles_x], the tile plan of the vmaps (ops/warp_tiles.py); count: int32
// [1], how many of order are active, read by the kernel from device
// memory. All contiguous, on the current device, vmaps
// 16-byte aligned; channels 3, bw a multiple of 4. Returns the
// cudaError_t of the launch (0 = success).
extern "C" int remap_separable_v(const void* i1, const void* vmaps, void* out,
                                 const void* order, const void* count, int n,
                                 int channels, int hp, int wp, int bh, int bw,
                                 int xpad, int chunk_w, void* stream) {
  if (channels != warp_tiles::kChannels || chunk_w != kChunkW)
    return static_cast<int>(cudaErrorInvalidValue);
  const PassV op{static_cast<const __nv_bfloat16*>(i1), hp, wp, xpad};
  warp_tiles::Plan p;
  p.order = static_cast<const int*>(order);
  p.count = static_cast<const int*>(count);
  p.n_maps = n;
  p.tiles_x = (bw + warp_tiles::kTileW - 1) / warp_tiles::kTileW;
  p.tiles_y = (bh + warp_tiles::kTileH - 1) / warp_tiles::kTileH;
  p.n_tiles = n * p.tiles_x * p.tiles_y;
  p.n_items = p.n_tiles;
  const warp_tiles::Band b{static_cast<const float*>(vmaps),
                           static_cast<float*>(out), bh, bw};
  return warp_tiles::launch(op, p, b, stream);
}
