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
// What bounds it: memory. Per call it must write three f32 channels of
// every band pixel and read the maps of the pixels whose taps reach the
// source, and the source pixels those taps read. At the 6x1080p rig
// (bands 1664x1280) that is 153 MB of output, 49 MB of the maps of the 49%
// of tiles that are active, and ~37 MB of u8 source. The arithmetic (a
// few dozen flops a pixel) is far below the card's rate.
//
// What held the one-thread-per-pixel kernel this replaces at a third of
// that bound (PERF.md, section 6): not its bytes (its maps in and zeros out
// alone took 0.095 ms) but its gather: the 12 dependent, masked scalar tap
// loads of each thread after its scalar map loads took 0.174 ms with no
// store at all, and more than half its threads loaded maps only to write
// zeros. The design (warp_tiles.cuh): a tile plan lets the empty tiles
// write zeros without reading their maps; persistent blocks at 64
// registers, four to an SM, keep the next active tile's maps coming into
// a shared-memory ring by cp.async.bulk while the current tile gathers
// its taps through L1; each thread reads the maps of 4 pixels as two
// 16-byte vectors and writes them per channel as one 16-byte streaming
// store, which keeps the output from evicting the sources from L2.
//
// Built by nvcc into a shared library with a plain C interface (no torch
// headers) and called through ctypes; see video_stitcher_tpu_torch/_build.py.

#include "warp_tiles.cuh"

namespace {

template <typename Src>
struct RemapGain {
  using T = Src;
  struct Ctx {
    float gain;
  };
  struct Pixel {
    int x0, y0;
    float w00, w01, w10, w11;
  };
  const T* src;
  int h, w;
  const float* gains;

  __device__ Ctx tile(int n) const { return {__ldg(gains + n)}; }

  __device__ Pixel pixel(float mx, float my, int) const {
    // clamp far-away coordinates before the int conversion: outside
    // [-2, size + 1] every tap is out of the source either way
    mx = fminf(fmaxf(mx, -2.0f), w + 1.0f);
    my = fminf(fmaxf(my, -2.0f), h + 1.0f);
    const float x0f = floorf(mx);
    const float y0f = floorf(my);
    const float fx = mx - x0f;
    const float fy = my - y0f;
    return {static_cast<int>(x0f), static_cast<int>(y0f),
            (1.0f - fx) * (1.0f - fy), fx * (1.0f - fy), (1.0f - fx) * fy,
            fx * fy};
  }

  __device__ float blend(const Ctx& ctx, const Pixel& p, float v00, float v01,
                         float v10, float v11) const {
    const float acc = v00 * p.w00 + v01 * p.w01 + v10 * p.w10 + v11 * p.w11;
    return fminf(fmaxf(acc * ctx.gain, 0.0f), 255.0f);
  }
};

template <typename T>
int launch(const void* src, const void* maps, const void* gains, void* out,
           const void* order, const void* count, int n, int n_maps,
           int channels, int h, int w, int bh, int bw, void* stream) {
  if (channels != warp_tiles::kChannels || n_maps <= 0 || n % n_maps)
    return static_cast<int>(cudaErrorInvalidValue);
  const RemapGain<T> op{static_cast<const T*>(src), h, w,
                        static_cast<const float*>(gains)};
  warp_tiles::Plan p;
  p.order = static_cast<const int*>(order);
  p.count = static_cast<const int*>(count);
  p.n_maps = n_maps;
  p.tiles_x = (bw + warp_tiles::kTileW - 1) / warp_tiles::kTileW;
  p.tiles_y = (bh + warp_tiles::kTileH - 1) / warp_tiles::kTileH;
  p.n_tiles = n_maps * p.tiles_x * p.tiles_y;
  p.n_items = p.n_tiles * (n / n_maps);
  const warp_tiles::Band b{static_cast<const float*>(maps),
                           static_cast<float*>(out), bh, bw};
  return warp_tiles::launch(op, p, b, stream);
}

}  // namespace

// src: [n, channels, h, w] u8 or f32; maps: f32 [n_maps, 2, bh, bw];
// gains: f32 [n]; out: f32 [n, channels, bh, bw]; order: int32
// [n_maps * tiles_y * tiles_x], the tile plan of the maps
// (ops/warp_tiles.py); count: int32 [1], how many of order are active,
// read by the kernel from device memory. All contiguous, on the current
// device, maps 16-byte aligned; channels 3, bw a multiple of 4. Returns
// the cudaError_t of the launch (0 = success).
extern "C" int remap_gain_u8(const void* src, const void* maps,
                             const void* gains, void* out, const void* order,
                             const void* count, int n, int n_maps,
                             int channels, int h, int w, int bh, int bw,
                             void* stream) {
  return launch<uint8_t>(src, maps, gains, out, order, count, n, n_maps,
                         channels, h, w, bh, bw, stream);
}

extern "C" int remap_gain_f32(const void* src, const void* maps,
                              const void* gains, void* out, const void* order,
                              const void* count, int n, int n_maps,
                              int channels, int h, int w, int bh, int bw,
                              void* stream) {
  return launch<float>(src, maps, gains, out, order, count, n, n_maps,
                       channels, h, w, bh, bw, stream);
}
