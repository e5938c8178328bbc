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
// What bounds it: memory. Per call it must read I1 (bf16) and the two map
// floats of every band pixel, and write three f32 channels. At the 6x1080p
// rig (bands 1664x1280, I1 1792x1088) that is 70 MB + 102 MB + 153 MB,
// ~326 MB, about 97 us at 3.35 TB/s. The arithmetic (a few dozen flops a
// pixel) is far below the card's rate.
//
// Design: one thread per output pixel, x fastest in a 32x8 block, so a warp
// reads 32 neighbouring map entries and writes 32 neighbouring outputs
// (coalesced); each thread reads its map pair once, computes its weights
// once and loops over the channels, gathering its 2x2 taps through L1.
// The TPU kernel's strip DMAs, row windows and tent-weight matmuls exist
// for the TPU's lane tiling and are not carried over.
//
// Built by nvcc into a shared library with a plain C interface (no torch
// headers) and called through ctypes; see video_stitcher_tpu_torch/_build.py.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

__device__ __forceinline__ float load_bf16(const uint16_t* p) {
  return __uint_as_float(static_cast<uint32_t>(__ldg(p)) << 16);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__global__ void __launch_bounds__(kBlockX * kBlockY)
pass_v_kernel(const uint16_t* __restrict__ i1, const float* __restrict__ vmaps,
              float* __restrict__ out, int channels, int hp, int wp, int bh,
              int bw, int xpad, int chunk_w) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  const int n = blockIdx.z;
  if (x >= bw || y >= bh) return;

  const int64_t plane = static_cast<int64_t>(bh) * bw;
  const int64_t o = static_cast<int64_t>(y) * bw + x;
  const float* mp = vmaps + static_cast<int64_t>(n) * 2 * plane;
  // The TPU kernel's x arithmetic: the tent is evaluated relative to the
  // first lane of the output column's chunk_w window (band x = base),
  // which decides where f32 rounds. Outside padded lanes [-2, wp + 1] and
  // rows [-2, hp + 1] every tap is out, so clamping there changes nothing.
  const int base = (x / chunk_w) * chunk_w - xpad;
  const float lx = fminf(fmaxf(__ldg(mp + o), -2.0f - xpad),
                         wp + 1.0f - xpad) - static_cast<float>(base);
  const float ly = fminf(fmaxf(__ldg(mp + plane + o), -2.0f), hp + 1.0f);
  const float kx = floorf(lx);
  const float ky = floorf(ly);
  const float wx0 = round_bf16(__fsub_rn(1.0f, __fsub_rn(lx, kx)));
  const float wx1 = round_bf16(__fsub_rn(1.0f, __fsub_rn(kx + 1.0f, lx)));
  const float wy0 = __fsub_rn(1.0f, __fsub_rn(ly, ky));
  const float wy1 = __fsub_rn(1.0f, __fsub_rn(ky + 1.0f, ly));
  const int x0 = static_cast<int>(kx) + base + xpad;   // padded lane
  const int y0 = static_cast<int>(ky);
  const int x1 = x0 + 1;
  const int y1 = y0 + 1;
  const bool vx0 = x0 >= 0 && x0 < wp;
  const bool vx1 = x1 >= 0 && x1 < wp;
  const bool vy0 = y0 >= 0 && y0 < hp;
  const bool vy1 = y1 >= 0 && y1 < hp;
  const int64_t r0 = static_cast<int64_t>(y0) * wp;
  const int64_t r1 = static_cast<int64_t>(y1) * wp;

  const int64_t src_plane = static_cast<int64_t>(hp) * wp;
  const uint16_t* s = i1 + static_cast<int64_t>(n) * channels * src_plane;
  float* d = out + static_cast<int64_t>(n) * channels * plane + o;
  for (int c = 0; c < channels; ++c) {
    const float v00 = (vy0 && vx0) ? load_bf16(s + r0 + x0) : 0.0f;
    const float v01 = (vy0 && vx1) ? load_bf16(s + r0 + x1) : 0.0f;
    const float v10 = (vy1 && vx0) ? load_bf16(s + r1 + x0) : 0.0f;
    const float v11 = (vy1 && vx1) ? load_bf16(s + r1 + x1) : 0.0f;
    // explicit roundings, no fused multiply-add: the sums round where the
    // plain version's (and the TPU kernel's) do
    const float h0 = __fadd_rn(__fmul_rn(wx0, v00), __fmul_rn(wx1, v01));
    const float h1 = __fadd_rn(__fmul_rn(wx0, v10), __fmul_rn(wx1, v11));
    d[c * plane] = __fadd_rn(__fmul_rn(wy0, h0), __fmul_rn(wy1, h1));
    s += src_plane;
  }
}

}  // namespace

// i1: bf16 [n, channels, hp, wp]; vmaps: f32 [n, 2, bh, bw]; out: f32
// [n, channels, bh, bw]; wp = bw + xpad + right pad; chunk_w the width of
// the TPU kernel's column chunks. All contiguous, on the current device.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int remap_separable_v(const void* i1, const void* vmaps, void* out,
                                 int n, int channels, int hp, int wp, int bh,
                                 int bw, int xpad, int chunk_w, void* stream) {
  const dim3 block(kBlockX, kBlockY, 1);
  const dim3 grid((bw + kBlockX - 1) / kBlockX, (bh + kBlockY - 1) / kBlockY,
                  n);
  pass_v_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(i1), static_cast<const float*>(vmaps),
      static_cast<float*>(out), channels, hp, wp, bh, bw, xpad, chunk_w);
  return static_cast<int>(cudaGetLastError());
}
