// K1: per-camera backward-map bilinear warp with the gain and the u8-range
// clamp fused into the store.
//
// Replaces the TPU strip-warp kernel video_stitcher_tpu/ops/remap_strips.py
// (_kernel, launched by remap_strips). What it computes, per camera n,
// channel c and band pixel (y, x), with m = n % n_maps:
//
//   out[n,c,y,x] = clamp(gain[n] * bilerp(src[n,c], maps[m,0,y,x],
//                                          maps[m,1,y,x]), 0, 255)
//
// with BORDER_CONSTANT partial taps: a tap outside the source adds exactly
// 0, so the reference's -1 "invalid" map value yields 0 and coordinates in
// (-1, 0) keep the weight of their in-source taps. Its plain version is
// ops/remap_strips.py::remap_strips_plain.
//
// What bounds it: memory. Per call it must read the two map floats of every
// band pixel, the source taps, and write three f32 channels. At the 6x1080p
// rig (bands 1664x1280) that is 102 MB of maps + 153 MB of output + ~37 MB
// of u8 source, ~293 MB, about 87 us at 3.35 TB/s. The arithmetic (a few
// dozen flops per pixel) is far below the card's rate.
//
// Design: one thread per output pixel, x fastest in a 32x8 block, so a warp
// reads 32 neighbouring map entries and writes 32 neighbouring outputs
// (coalesced); the 4-tap gathers of neighbouring pixels fall on
// neighbouring source addresses and are served by L1/L2. Each thread reads
// its map pair once and loops over the channels. The TPU kernel's strip
// DMAs, tent-weight matmuls and strip planner exist only for the TPU's lane
// tiling and are not carried over.
//
// Built by nvcc into a shared library with a plain C interface (no torch
// headers) and called through ctypes; see video_stitcher_tpu_torch/_build.py.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

__device__ __forceinline__ float load_f(const uint8_t* p) {
  return static_cast<float>(__ldg(p));
}
__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }

template <typename T>
__global__ void __launch_bounds__(kBlockX * kBlockY)
remap_gain_kernel(const T* __restrict__ src, const float* __restrict__ maps,
                  const float* __restrict__ gains, float* __restrict__ out,
                  int n_maps, int channels, int h, int w, int bh, int bw) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  const int n = blockIdx.z;
  if (x >= bw || y >= bh) return;

  const int64_t plane = static_cast<int64_t>(bh) * bw;
  const int64_t o = static_cast<int64_t>(y) * bw + x;
  const float* mp = maps + static_cast<int64_t>(n % n_maps) * 2 * plane;
  // clamp far-away coordinates before the int conversion: outside
  // [-2, size + 1] every tap is out of the source either way
  const float mx = fminf(fmaxf(__ldg(mp + o), -2.0f), w + 1.0f);
  const float my = fminf(fmaxf(__ldg(mp + plane + o), -2.0f), h + 1.0f);
  const float x0f = floorf(mx);
  const float y0f = floorf(my);
  const float fx = mx - x0f;
  const float fy = my - y0f;
  const int x0 = static_cast<int>(x0f);
  const int y0 = static_cast<int>(y0f);
  const int x1 = x0 + 1;
  const int y1 = y0 + 1;
  const bool vx0 = x0 >= 0 && x0 < w;
  const bool vx1 = x1 >= 0 && x1 < w;
  const bool vy0 = y0 >= 0 && y0 < h;
  const bool vy1 = y1 >= 0 && y1 < h;
  const float w00 = (1.0f - fx) * (1.0f - fy);
  const float w01 = fx * (1.0f - fy);
  const float w10 = (1.0f - fx) * fy;
  const float w11 = fx * fy;
  const int64_t r0 = static_cast<int64_t>(y0) * w;
  const int64_t r1 = static_cast<int64_t>(y1) * w;
  const float g = __ldg(gains + n);

  const int64_t src_plane = static_cast<int64_t>(h) * w;
  const T* s = src + static_cast<int64_t>(n) * channels * src_plane;
  float* d = out + static_cast<int64_t>(n) * channels * plane + o;
  for (int c = 0; c < channels; ++c) {
    const float v00 = (vy0 && vx0) ? load_f(s + r0 + x0) : 0.0f;
    const float v01 = (vy0 && vx1) ? load_f(s + r0 + x1) : 0.0f;
    const float v10 = (vy1 && vx0) ? load_f(s + r1 + x0) : 0.0f;
    const float v11 = (vy1 && vx1) ? load_f(s + r1 + x1) : 0.0f;
    const float acc = v00 * w00 + v01 * w01 + v10 * w10 + v11 * w11;
    d[c * plane] = fminf(fmaxf(acc * g, 0.0f), 255.0f);
    s += src_plane;
  }
}

template <typename T>
int launch(const void* src, const void* maps, const void* gains, void* out,
           int n, int n_maps, int channels, int h, int w, int bh, int bw,
           void* stream) {
  const dim3 block(kBlockX, kBlockY, 1);
  const dim3 grid((bw + kBlockX - 1) / kBlockX, (bh + kBlockY - 1) / kBlockY,
                  n);
  remap_gain_kernel<T><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(src), static_cast<const float*>(maps),
      static_cast<const float*>(gains), static_cast<float*>(out), n_maps,
      channels, h, w, bh, bw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// src: [n, channels, h, w] u8 or f32; maps: f32 [n_maps, 2, bh, bw];
// gains: f32 [n]; out: f32 [n, channels, bh, bw]. All contiguous, on the
// current device. Returns the cudaError_t of the launch (0 = success).
extern "C" int remap_gain_u8(const void* src, const void* maps,
                             const void* gains, void* out, int n, int n_maps,
                             int channels, int h, int w, int bh, int bw,
                             void* stream) {
  return launch<uint8_t>(src, maps, gains, out, n, n_maps, channels, h, w, bh,
                         bw, stream);
}

extern "C" int remap_gain_f32(const void* src, const void* maps,
                              const void* gains, void* out, int n, int n_maps,
                              int channels, int h, int w, int bh, int bw,
                              void* stream) {
  return launch<float>(src, maps, gains, out, n, n_maps, channels, h, w, bh,
                       bw, stream);
}
