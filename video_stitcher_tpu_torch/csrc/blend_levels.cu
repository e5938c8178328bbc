// The multiband blend's pyramid (blend/multiband.py), one level a launch,
// in three kernels: down (the next Gaussian level), lap_place (a level of
// the panorama's Laplacian sum: each camera's Laplacian times its weight,
// added in camera order at the columns it covers) and collapse (a level's
// sum plus pyrUp of the collapsed level above). blend/levels.py launches
// them; its plain versions, down_plain, lap_place_plain and
// collapse_plain, compute the same functions.
//
// They replace no Pallas kernel: the JAX package leaves the blend to XLA's
// fusion of blend/multiband.py and ops/pyramid.py. What they replace here
// is the plain chain of ops/resize.py's apply_taps, one index_select, one
// multiply and one add a tap, with a dtype copy around every pass.
//
// Arithmetic: each separable pass reads the tap table the plain pass reads
// (ops/resize.device_taps of ops/pyramid.py's _down_matrix / _up_matrix:
// each output's nonzero taps in ascending order, the reflect-101 border
// folded into their weights) and sums the same products in the same order,
// each a separate multiply and add (__fmul_rn / __fadd_rn, never an FMA).
// Each result is rounded to the storage dtype T (bf16 under precision
// "bf16", f32 under "highest") exactly where the plain chain stores it.
// A table pads short rows with taps of weight 0, which are skipped: with
// finite inputs the result has the plain chain's value (a zero may differ
// in sign).
//
// What bounds them: bytes. At the 6x1080p rig (bands [6, 3, 1280, 1664],
// panorama [3, 1280, 4928], 6 bands) one frame's blend has to read K1's f32
// bands, the f32 weights and each Gaussian level once, and write each bf16
// level and the f32 panorama once: about 704 MB, 0.21 ms at 3.35 TB/s; a
// few flops a byte. The design keeps every intermediate of a pass in
// shared memory: a block takes a tile of 64 columns by 16 rows of its
// output, runs the width pass over the input rows the tile's taps reach
// (its halo) into shared memory, rounded as the plain pass rounds, and the
// height pass from there, so each level is read and written once. The
// Laplacian is never stored: lap_place computes pyrUp of the next level,
// the difference, the product with the weight (read in f32 and rounded in
// registers) and the sum over the cameras in one pass over the panorama's
// tiles, a gather with no atomics, so the sum's order is fixed.
//
// Built by nvcc into a shared library with a plain C interface (no torch
// headers) and called through ctypes; see video_stitcher_tpu_torch/_build.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kDownTaps = 5;       // _down_matrix: at most 5 taps an output
constexpr int kUpTaps = 3;         // _up_matrix: at most 3
constexpr int kMaxCams = 64;
constexpr int kChannels = 3;       // lap_place's and collapse's (RGB)
constexpr int kTileW = 64;         // a block's output columns, one a thread
constexpr int kThreadRows = 4;     // rows of threads in a block
constexpr int kTileH = 16;         // a block's output rows
constexpr int kRowsPerThread = kTileH / kThreadRows;
constexpr int kThreads = kTileW * kThreadRows;
constexpr int kDownRows = 2 * kTileH + 3;   // input rows of a down tile
constexpr int kUpRows = kTileH / 2 + 2;     // next-level rows of an up tile
constexpr int kDownRowSteps = (kDownRows + kThreadRows - 1) / kThreadRows;
constexpr int kUpRowSteps = (kUpRows + kThreadRows - 1) / kThreadRows;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v stored in T and read back, as the plain chain's .to(T).float()
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// *p as the plain chain reads a level it stores in T: rounded to T first
// (the f32 bands at level 0), or as it is
template <typename T, typename TIn>
__device__ __forceinline__ float load_as(const TIn* p) {
  if constexpr (std::is_same<TIn, T>::value)
    return to_f32(*p);
  else
    return round_to<T>(to_f32(*p));
}

// one axis of a banded map: idx int64 [t, n_out], w f32 [t, n_out]
struct Taps {
  const int64_t* idx;
  const float* w;
  int t;
  int n_out;
};

template <int kMax>
struct Row {
  int idx[kMax];
  float w[kMax];
};

// output o's taps; those past the table's t have weight 0
template <int kMax>
__device__ __forceinline__ Row<kMax> load_taps(const Taps& k, int o) {
  Row<kMax> r;
#pragma unroll
  for (int t = 0; t < kMax; ++t) {
    const bool in = t < k.t;
    r.idx[t] = in ? static_cast<int>(k.idx[t * k.n_out + o]) : 0;
    r.w[t] = in ? k.w[t * k.n_out + o] : 0.0f;
  }
  return r;
}

// the height taps of a block's kTileH output rows from y0, in shared
// memory: loaded by its first threads; read after the block's next barrier
template <int kMax>
struct TileTaps {
  Row<kMax> row[kTileH];

  __device__ void load(const Taps& k, int y0, int rows, int tid) {
    if (tid < kTileH && tid < rows) row[tid] = load_taps<kMax>(k, y0 + tid);
  }
};

// sum_t at(idx[t]) * w[t] in the table's order, as apply_taps sums it; the
// first tap of a row always has a nonzero weight
template <int kMax, typename At>
__device__ __forceinline__ float apply(const Row<kMax>& r, At at) {
  float acc = __fmul_rn(at(r.idx[0]), r.w[0]);
#pragma unroll
  for (int t = 1; t < kMax; ++t)
    if (r.w[t] != 0.0f) acc = __fadd_rn(acc, __fmul_rn(at(r.idx[t]), r.w[t]));
  return acc;
}

// g_{l+1} = pyr_down(g_l) for each plane (blockIdx.z): src [planes, h, w]
// in TIn (f32 bands at level 0, rounded to T on load as .to(T) rounds them,
// or T), dst [planes, h2, w2] in T.
template <typename TIn, typename T>
__global__ void __launch_bounds__(kThreads)
    blend_down_kernel(const TIn* __restrict__ src, T* __restrict__ dst,
                      Taps tw, Taps th, int h, int w, int h2, int w2) {
  __shared__ float rows[kDownRows][kTileW];
  __shared__ TileTaps<kDownTaps> taps_h;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int x2 = blockIdx.x * kTileW + tx;
  const int y2_0 = blockIdx.y * kTileH;
  const size_t plane = blockIdx.z;
  const TIn* in = src + plane * h * w;
  taps_h.load(th, y2_0, h2 - y2_0, ty * kTileW + tx);
  // output row y2's taps lie in rows [2 y2 - 2, 2 y2 + 2] of the input
  const int r_lo = max(0, 2 * y2_0 - 2);
  const int r_hi = min(h - 1, 2 * (y2_0 + kTileH - 1) + 2);
  if (x2 < w2) {
    const Row<kDownTaps> cols = load_taps<kDownTaps>(tw, x2);
#pragma unroll
    for (int i = 0; i < kDownRowSteps; ++i) {
      const int r = r_lo + ty + i * kThreadRows;
      if (r <= r_hi) {
        const TIn* row = in + static_cast<size_t>(r) * w;
        rows[r - r_lo][tx] = round_to<T>(
            apply(cols, [&](int c) { return load_as<T>(row + c); }));
      }
    }
  }
  __syncthreads();
  if (x2 >= w2) return;
  T* out = dst + plane * h2 * w2;
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int i = ty + k * kThreadRows;
    if (y2_0 + i < h2)
      out[static_cast<size_t>(y2_0 + i) * w2 + x2] = from_f32<T>(apply(
          taps_h.row[i], [&](int r) { return rows[r - r_lo][tx]; }));
  }
}

// where each camera's band lies in the panorama at this level: camera i
// covers column X when d = X - start[i] (plus pw if wrap and d < 0) lies in
// [0, bw); d is then its band column
struct Place {
  int n_cams;
  int pw;
  int bw;
  int wrap;
  int start[kMaxCams];
};

// out [kChannels, h, pw] in T: at each panorama pixel, for each camera
// covering it in camera order, lap = g - pyr_up(g_next) (g alone without
// g_next), times the camera's weight rounded to T, added into the sum (from
// 0), each step rounded to T. g [N, kChannels, h, w] in TIn (f32 bands at
// level 0); g_next [N, kChannels, h2, w2] in T or null; weight f32
// [N, 1, h, w]. A camera that covers no column of the block's tile costs
// nothing; one that does, one barrier, after the width passes of all its
// channels (two buffers of them, so that the next camera's are written
// while this one's may still be read). Each thread loads its own band and
// weight values before the width pass, so their loads overlap it.
template <typename TIn, typename T>
__global__ void __launch_bounds__(kThreads, 3)
    blend_lap_place_kernel(const TIn* __restrict__ g,
                           const T* __restrict__ g_next,
                           const float* __restrict__ weight,
                           T* __restrict__ out, Taps uw, Taps uh, Place pl,
                           int h, int w, int h2, int w2) {
  __shared__ float up_rows[2][kChannels][kUpRows][kTileW];
  __shared__ TileTaps<kUpTaps> taps_h;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int X0 = blockIdx.x * kTileW;
  const int X = X0 + tx;
  const int tile_w = min(kTileW, pl.pw - X0);
  const int y0 = blockIdx.y * kTileH;
  const bool has_next = g_next != nullptr;
  if (has_next) taps_h.load(uh, y0, h - y0, ty * kTileW + tx);
  // output row y's taps lie in rows [y / 2 - 1, y / 2 + 1] of g_next
  const int r_lo = max(0, y0 / 2 - 1);
  const int r_hi = min(h2 - 1, (y0 + kTileH - 1) / 2 + 1);
  float acc[kChannels][kRowsPerThread];
#pragma unroll
  for (int c = 0; c < kChannels; ++c)
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) acc[c][k] = 0.0f;
  int buf = 0;
  for (int cam = 0; cam < pl.n_cams; ++cam) {
    const int start = pl.start[cam];
    int d0 = X0 - start;
    if (pl.wrap && d0 < 0) d0 += pl.pw;
    if (pl.wrap ? (d0 >= pl.bw && d0 + tile_w <= pl.pw)
                : (d0 >= pl.bw || d0 + tile_w <= 0))
      continue;                              // no column of the tile
    int x = X - start;
    if (pl.wrap && x < 0) x += pl.pw;
    const bool mine = X < pl.pw && x >= 0 && x < pl.bw;
    const size_t cam0 = static_cast<size_t>(cam) * kChannels;
    float wt[kRowsPerThread], gv[kChannels][kRowsPerThread];
    if (mine) {
#pragma unroll
      for (int k = 0; k < kRowsPerThread; ++k) {
        const int y = min(y0 + ty + k * kThreadRows, h - 1);
        wt[k] = round_to<T>(weight[(static_cast<size_t>(cam) * h + y) * w + x]);
#pragma unroll
        for (int c = 0; c < kChannels; ++c)
          gv[c][k] = load_as<T>(g + ((cam0 + c) * h + y) * w + x);
      }
    }
    if (has_next) {
      if (mine) {
        const Row<kUpTaps> up_w = load_taps<kUpTaps>(uw, x);
#pragma unroll
        for (int c = 0; c < kChannels; ++c)
#pragma unroll
          for (int i = 0; i < kUpRowSteps; ++i) {
            const int r = r_lo + ty + i * kThreadRows;
            if (r <= r_hi) {
              const T* row = g_next + ((cam0 + c) * h2 + r) * w2;
              up_rows[buf][c][r - r_lo][tx] = round_to<T>(
                  apply(up_w, [&](int col) { return to_f32(row[col]); }));
            }
          }
      }
      __syncthreads();
    }
    if (mine) {
#pragma unroll
      for (int k = 0; k < kRowsPerThread; ++k) {
        const int i = ty + k * kThreadRows;
        if (y0 + i >= h) break;
#pragma unroll
        for (int c = 0; c < kChannels; ++c) {
          float lap = gv[c][k];
          if (has_next) {
            const float up = round_to<T>(apply(taps_h.row[i], [&](int r) {
              return up_rows[buf][c][r - r_lo][tx];
            }));
            lap = round_to<T>(__fsub_rn(lap, up));
          }
          const float prod = round_to<T>(__fmul_rn(lap, wt[k]));
          acc[c][k] = round_to<T>(__fadd_rn(acc[c][k], prod));
        }
      }
    }
    buf ^= 1;
  }
  if (X >= pl.pw) return;
#pragma unroll
  for (int c = 0; c < kChannels; ++c)
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      const int y = y0 + ty + k * kThreadRows;
      if (y < h)
        out[(static_cast<size_t>(c) * h + y) * pl.pw + X] =
            from_f32<T>(acc[c][k]);
    }
}

// one collapse step for all kChannels of a tile: o = acc (in f32) +
// pyr_up(next) with its width pass stored in T and its height pass left in
// f32 (the plain collapse's out_dtype=torch.float32); stored in T, or with
// kFinal in f32 and times valid when given. acc [kChannels, h, w] in T;
// next [kChannels, h2, w2] in T or null; valid f32 [h, w] or null. Each
// thread loads its own acc and valid values before the width pass.
template <typename T, bool kFinal>
__global__ void __launch_bounds__(kThreads)
    blend_collapse_kernel(const T* __restrict__ acc, const T* __restrict__ next,
                          const float* __restrict__ valid,
                          void* __restrict__ out, Taps uw, Taps uh, int h,
                          int w, int h2, int w2) {
  __shared__ float up_rows[kChannels][kUpRows][kTileW];
  __shared__ TileTaps<kUpTaps> taps_h;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int X = blockIdx.x * kTileW + tx;
  const int y0 = blockIdx.y * kTileH;
  const bool has_next = next != nullptr;
  if (has_next) taps_h.load(uh, y0, h - y0, ty * kTileW + tx);
  const int r_lo = max(0, y0 / 2 - 1);
  const int r_hi = min(h2 - 1, (y0 + kTileH - 1) / 2 + 1);
  float av[kChannels][kRowsPerThread], vv[kRowsPerThread];
  if (X < w) {
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      const int y = min(y0 + ty + k * kThreadRows, h - 1);
      vv[k] = kFinal && valid != nullptr
                  ? valid[static_cast<size_t>(y) * w + X] : 1.0f;
#pragma unroll
      for (int c = 0; c < kChannels; ++c)
        av[c][k] = to_f32(acc[(static_cast<size_t>(c) * h + y) * w + X]);
    }
  }
  if (has_next) {
    if (X < w) {
      const Row<kUpTaps> up_w = load_taps<kUpTaps>(uw, X);
#pragma unroll
      for (int c = 0; c < kChannels; ++c)
#pragma unroll
        for (int i = 0; i < kUpRowSteps; ++i) {
          const int r = r_lo + ty + i * kThreadRows;
          if (r <= r_hi) {
            const T* row = next + (static_cast<size_t>(c) * h2 + r) * w2;
            up_rows[c][r - r_lo][tx] = round_to<T>(
                apply(up_w, [&](int col) { return to_f32(row[col]); }));
          }
        }
    }
    __syncthreads();
  }
  if (X >= w) return;
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int i = ty + k * kThreadRows;
    if (y0 + i >= h) break;
#pragma unroll
    for (int c = 0; c < kChannels; ++c) {
      float o = av[c][k];
      if (has_next)
        o = __fadd_rn(o, apply(taps_h.row[i], [&](int r) {
                        return up_rows[c][r - r_lo][tx];
                      }));
      const size_t at = (static_cast<size_t>(c) * h + y0 + i) * w + X;
      if (kFinal) {
        if (valid != nullptr) o = __fmul_rn(o, vv[k]);
        static_cast<float*>(out)[at] = o;
      } else {
        static_cast<T*>(out)[at] = from_f32<T>(o);
      }
    }
  }
}

enum Dtype { kF32 = 0, kBF16 = 1 };

Taps taps(const void* idx, const void* w, int t, int n_out) {
  return {static_cast<const int64_t*>(idx), static_cast<const float*>(w), t,
          n_out};
}

dim3 grid(int w, int h, int z) {
  return dim3((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, z);
}

int launched() { return static_cast<int>(cudaGetLastError()); }

int invalid() { return static_cast<int>(cudaErrorInvalidValue); }

bool bad_taps(const Taps& k, int max_taps) {
  return k.idx == nullptr || k.w == nullptr || k.t < 1 || k.t > max_taps;
}

}  // namespace

// src [planes, h, w] in f32 or the storage dtype, dst [planes, ceil(h/2),
// ceil(w/2)] in the storage dtype (in_dtype / store_dtype: 0 f32, 1 bf16);
// tw: _down_matrix(w)'s taps, th: _down_matrix(h)'s. All contiguous, on
// the current device. Returns the cudaError_t of the launch (0 = success).
extern "C" int blend_down(int in_dtype, int store_dtype, const void* src,
                          void* dst, const void* tw_idx, const void* tw_w,
                          int tw_t, const void* th_idx, const void* th_w,
                          int th_t, int planes, int h, int w, int h2, int w2,
                          void* stream) {
  const Taps tw = taps(tw_idx, tw_w, tw_t, w2);
  const Taps th = taps(th_idx, th_w, th_t, h2);
  if (planes < 1 || planes > 65535 || h < 1 || w < 1 ||
      h2 != (h + 1) / 2 || w2 != (w + 1) / 2 || bad_taps(tw, kDownTaps) ||
      bad_taps(th, kDownTaps))
    return invalid();
  const dim3 block(kTileW, kThreadRows);
  const dim3 g = grid(w2, h2, planes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (store_dtype == kBF16 && in_dtype == kF32)
    blend_down_kernel<float, __nv_bfloat16><<<g, block, 0, s>>>(
        static_cast<const float*>(src), static_cast<__nv_bfloat16*>(dst), tw,
        th, h, w, h2, w2);
  else if (store_dtype == kBF16 && in_dtype == kBF16)
    blend_down_kernel<__nv_bfloat16, __nv_bfloat16><<<g, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(src),
        static_cast<__nv_bfloat16*>(dst), tw, th, h, w, h2, w2);
  else if (store_dtype == kF32 && in_dtype == kF32)
    blend_down_kernel<float, float><<<g, block, 0, s>>>(
        static_cast<const float*>(src), static_cast<float*>(dst), tw, th, h,
        w, h2, w2);
  else
    return invalid();
  return launched();
}

// g [n_cams, 3, h, w] in f32 or the storage dtype; g_next [n_cams, 3, h2,
// w2] in the storage dtype, or null at the top level; weight f32
// [n_cams, 1, h, w]; out [3, h, pw] in the storage dtype. uw,
// uh: _up_matrix(w2, w)'s and _up_matrix(h2, h)'s taps (unread without
// g_next). starts: n_cams ints in host memory (each camera's first
// panorama column, see Place), copied into the launch. All tensors
// contiguous, on the current device. Returns the launch's cudaError_t.
extern "C" int blend_lap_place(int in_dtype, int store_dtype, const void* g,
                               const void* g_next, const void* weight,
                               void* out, const void* uw_idx,
                               const void* uw_w, int uw_t,
                               const void* uh_idx, const void* uh_w, int uh_t,
                               const int* starts, int n_cams, int wrap,
                               int pw, int bw, int channels, int h, int w,
                               int h2, int w2, void* stream) {
  const Taps uw = taps(uw_idx, uw_w, uw_t, w);
  const Taps uh = taps(uh_idx, uh_w, uh_t, h);
  if (n_cams < 1 || n_cams > kMaxCams || channels != kChannels || h < 1 ||
      w < 1 || pw < 1 || bw < 1 || bw > pw || bw > w)
    return invalid();
  if (g_next != nullptr &&
      (h2 < 1 || w2 < 1 || bad_taps(uw, kUpTaps) || bad_taps(uh, kUpTaps)))
    return invalid();
  Place pl;
  pl.n_cams = n_cams;
  pl.pw = pw;
  pl.bw = bw;
  pl.wrap = wrap;
  for (int i = 0; i < n_cams; ++i) pl.start[i] = starts[i];
  const dim3 block(kTileW, kThreadRows);
  const dim3 gr = grid(pw, h, 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (store_dtype == kBF16 && in_dtype == kF32)
    blend_lap_place_kernel<float, __nv_bfloat16><<<gr, block, 0, s>>>(
        static_cast<const float*>(g),
        static_cast<const __nv_bfloat16*>(g_next),
        static_cast<const float*>(weight), static_cast<__nv_bfloat16*>(out),
        uw, uh, pl, h, w, h2, w2);
  else if (store_dtype == kBF16 && in_dtype == kBF16)
    blend_lap_place_kernel<__nv_bfloat16, __nv_bfloat16><<<gr, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(g),
        static_cast<const __nv_bfloat16*>(g_next),
        static_cast<const float*>(weight), static_cast<__nv_bfloat16*>(out),
        uw, uh, pl, h, w, h2, w2);
  else if (store_dtype == kF32 && in_dtype == kF32)
    blend_lap_place_kernel<float, float><<<gr, block, 0, s>>>(
        static_cast<const float*>(g), static_cast<const float*>(g_next),
        static_cast<const float*>(weight), static_cast<float*>(out), uw, uh,
        pl, h, w, h2, w2);
  else
    return invalid();
  return launched();
}

// acc [3, h, w] and next [3, h2, w2] (or null) in the storage dtype; out
// [3, h, w] in the storage dtype, or with final in f32 (times valid f32 [h, w] when valid is not null). uw, uh:
// _up_matrix(w2, w)'s and _up_matrix(h2, h)'s taps (unread without next).
// All contiguous, on the current device. Returns the launch's cudaError_t.
extern "C" int blend_collapse(int store_dtype, int final_level,
                              const void* acc, const void* next,
                              const void* valid, void* out,
                              const void* uw_idx, const void* uw_w, int uw_t,
                              const void* uh_idx, const void* uh_w, int uh_t,
                              int channels, int h, int w, int h2, int w2,
                              void* stream) {
  const Taps uw = taps(uw_idx, uw_w, uw_t, w);
  const Taps uh = taps(uh_idx, uh_w, uh_t, h);
  if (channels != kChannels || h < 1 || w < 1) return invalid();
  if (next != nullptr &&
      (h2 < 1 || w2 < 1 || bad_taps(uw, kUpTaps) || bad_taps(uh, kUpTaps)))
    return invalid();
  const dim3 block(kTileW, kThreadRows);
  const dim3 g = grid(w, h, 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* v = static_cast<const float*>(valid);
  if (store_dtype == kBF16) {
    const auto* a = static_cast<const __nv_bfloat16*>(acc);
    const auto* n = static_cast<const __nv_bfloat16*>(next);
    if (final_level)
      blend_collapse_kernel<__nv_bfloat16, true><<<g, block, 0, s>>>(
          a, n, v, out, uw, uh, h, w, h2, w2);
    else
      blend_collapse_kernel<__nv_bfloat16, false><<<g, block, 0, s>>>(
          a, n, v, out, uw, uh, h, w, h2, w2);
  } else if (store_dtype == kF32) {
    const auto* a = static_cast<const float*>(acc);
    const auto* n = static_cast<const float*>(next);
    if (final_level)
      blend_collapse_kernel<float, true><<<g, block, 0, s>>>(
          a, n, v, out, uw, uh, h, w, h2, w2);
    else
      blend_collapse_kernel<float, false><<<g, block, 0, s>>>(
          a, n, v, out, uw, uh, h, w, h2, w2);
  } else {
    return invalid();
  }
  return launched();
}
