// The tile machinery the warp kernels K1 (remap_gain.cu) and K2
// (remap_separable.cu) share: persistent blocks walk a tile plan, a
// two-stage ring in dynamic shared memory holds each tile's maps, filled
// by cp.async.bulk while the previous tile computes, and each thread turns
// the map values of 4 neighbouring band pixels into three 16-byte
// streaming stores.
//
// The plan (video_stitcher_tpu_torch/ops/warp_tiles.py) orders the
// kTileH x kTileW tiles of the band: first the active tiles, which have a
// tap in the source, map-major, so one camera's source stays in L2 while
// its tiles run; then the empty ones. Per tile a block
// - writes zeros, and reads nothing, for an empty tile;
// - otherwise waits for the tile's maps in its stage (one bulk copy per
//   map row, completing on the stage's mbarrier), and gathers each
//   pixel's four taps through L1, each masked to the source.
//
// The source's taps are not staged: staging each tile's source box in
// the ring as well (by cp.async.bulk per box row, or by 16-byte cp.async
// per thread) made both kernels slower at every stage size tried on the
// H100, since the box takes shared memory from L1 and blocks from the SM
// (PERF.md, section 6).
//
// An Op supplies what differs between the kernels:
//   using T                 the source's element type
//   const T* src; int h, w  the planar source [n, kChannels, h, w]
//   Ctx tile(int n)         per-camera constants (K1: the gain)
//   Pixel pixel(mx, my, x)  tap origin x0, y0 and weights of the band
//                           pixel in column x with map values (mx, my)
//   float blend(ctx, p, v00, v01, v10, v11)   one channel's output

#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace warp_tiles {

constexpr int kTileW = 64;                         // == TILE_W
constexpr int kTileH = 16;                         // == TILE_H
constexpr int kVec = 4;                            // pixels per thread
constexpr int kLanesX = kTileW / kVec;             // threads per tile row
constexpr int kThreads = kLanesX * kTileH;         // 256
constexpr int kChannels = 3;
constexpr int kStages = 2;
constexpr int kMapBytes = 2 * kTileH * kTileW * 4;
constexpr int kSmemBytes = kStages * (kMapBytes + 16);
// four blocks of 256 threads fill half an SM's threads at 64 registers
// each, which measured faster than three blocks at 80
constexpr int kBlocksPerSm = 4;
constexpr int kMaxDevices = 64;

static_assert(kTileW % kVec == 0 && kMapBytes % 16 == 0,
              "map rows must stay 16-byte aligned for cp.async.bulk");

struct Plan {
  const int* order;    // [n_maps * tiles_y * tiles_x]: flat tile ids
  // [1], in device memory: the first count[0] of order are active. The
  // kernel reads it there, so a CUDA graph that captured the launch
  // walks whatever plan was last copied into its buffers.
  const int* count;
  int n_maps, tiles_x, tiles_y;
  int n_tiles;         // n_maps * tiles_y * tiles_x
  int n_items;         // n_tiles * (cameras / n_maps)
};

struct Band {
  const float* maps;   // [n_maps, 2, bh, bw]
  float* out;          // [n, kChannels, bh, bw]
  int bh, bw;          // bw a multiple of kVec
};

__device__ __forceinline__ float to_f(uint8_t v) { return v; }
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
               :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Wait for the phase `parity` of a stage's barrier to complete. A copy
// that never lands traps after ~kWaitCycles (seconds) rather than hang.
constexpr long long kWaitCycles = 1LL << 34;

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - t0 > kWaitCycles) __trap();
  }
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// One work item: camera n's tile of map m at band (x0, y0).
struct Tile {
  int n, m, x0, y0;
  bool active;
};

__device__ __forceinline__ Tile tile_at(const Plan& p, int n_active,
                                        int item) {
  const int rep = item / p.n_tiles;
  const int k = item - rep * p.n_tiles;
  const int id = __ldg(p.order + k);
  const int per_map = p.tiles_x * p.tiles_y;
  const int m = id / per_map;
  const int t = id - m * per_map;
  const int ty = t / p.tiles_x;
  Tile tile;
  tile.n = rep * p.n_maps + m;
  tile.m = m;
  tile.y0 = ty * kTileH;
  tile.x0 = (t - ty * p.tiles_x) * kTileW;
  tile.active = k < n_active;
  return tile;
}

// Warp 0: start the copies of an active `item`'s maps into a stage.
__device__ inline void fetch_maps(const Plan& p, int n_active,
                                  const Band& b, int item, float* smaps,
                                  uint64_t* bar) {
  const Tile t = tile_at(p, n_active, item);
  if (!t.active) return;
  const int lane = threadIdx.x;
  const int rows = min(kTileH, b.bh - t.y0);
  const uint32_t row_bytes = min(kTileW, b.bw - t.x0) * 4u;
  if (lane == 0) mbar_expect_tx(bar, 2u * rows * row_bytes);
  // the stage was last read through the generic proxy, by threads that
  // have since passed the block barrier; the copies refill it through the
  // async proxy
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncwarp();
  const int64_t plane = static_cast<int64_t>(b.bh) * b.bw;
  const float* mp = b.maps + 2 * t.m * plane
                    + static_cast<int64_t>(t.y0) * b.bw + t.x0;
  for (int r = lane; r < 2 * rows; r += 32) {
    const int xy = r >= rows;
    const int row = r - xy * rows;
    bulk_copy(smaps + (xy * kTileH + row) * kTileW,
              mp + xy * plane + static_cast<int64_t>(row) * b.bw, row_bytes,
              bar);
  }
}

// One band pixel: its kChannels values into acc[c][j]; g is the camera's
// source. A tap outside the source reads nothing and adds 0.
template <class Op>
__device__ __forceinline__ void sample(const Op& op,
                                       const typename Op::Ctx& ctx,
                                       const typename Op::Pixel& px,
                                       const typename Op::T* g,
                                       float (&acc)[kChannels][kVec], int j) {
  const bool vx0 = px.x0 >= 0 && px.x0 < op.w;
  const bool vx1 = px.x0 + 1 >= 0 && px.x0 + 1 < op.w;
  const bool vy0 = px.y0 >= 0 && px.y0 < op.h;
  const bool vy1 = px.y0 + 1 >= 0 && px.y0 + 1 < op.h;
  const int64_t src_plane = static_cast<int64_t>(op.h) * op.w;
  const int64_t r0 = static_cast<int64_t>(px.y0) * op.w;
  const int64_t r1 = r0 + op.w;
#pragma unroll
  for (int c = 0; c < kChannels; ++c, g += src_plane) {
    const float v00 = (vy0 && vx0) ? to_f(__ldg(g + r0 + px.x0)) : 0.0f;
    const float v01 = (vy0 && vx1) ? to_f(__ldg(g + r0 + px.x0 + 1)) : 0.0f;
    const float v10 = (vy1 && vx0) ? to_f(__ldg(g + r1 + px.x0)) : 0.0f;
    const float v11 = (vy1 && vx1) ? to_f(__ldg(g + r1 + px.x0 + 1)) : 0.0f;
    acc[c][j] = op.blend(ctx, px, v00, v01, v10, v11);
  }
}

__device__ __forceinline__ float lane_of(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

template <class Op>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
tiles_kernel(const Op op, const Plan p, const Band b) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* smaps = reinterpret_cast<float*>(smem);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kStages * kMapBytes);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bars + s);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // the active count, clamped so that a bad one cannot index out of order
  const int n_active = min(max(__ldg(p.count), 0), p.n_tiles);

  const int lx = threadIdx.x % kLanesX;
  const int ly = threadIdx.x / kLanesX;
  const int64_t plane = static_cast<int64_t>(b.bh) * b.bw;
  uint32_t parity = 0;     // bit s: the phase of stage s to wait for
  int item = blockIdx.x;
  if (item < p.n_items && threadIdx.x < 32)
    fetch_maps(p, n_active, b, item, smaps, bars);
  for (int k = 0; item < p.n_items; ++k, item += gridDim.x) {
    const int s = k % kStages;
    const int next = item + gridDim.x;
    if (next < p.n_items && threadIdx.x < 32) {
      const int ns = (k + 1) % kStages;
      fetch_maps(p, n_active, b, next, smaps + ns * (kMapBytes / 4),
                 bars + ns);
    }
    const Tile t = tile_at(p, n_active, item);
    const int x = t.x0 + kVec * lx;
    const int y = t.y0 + ly;
    const bool inside = x < b.bw && y < b.bh;
    float* d = b.out + (static_cast<int64_t>(t.n) * kChannels * b.bh + y)
                       * b.bw + x;
    if (!t.active) {
      if (inside) {
        const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
        for (int c = 0; c < kChannels; ++c)
          __stcs(reinterpret_cast<float4*>(d + c * plane), zero);
      }
    } else {
      mbar_wait(bars + s, (parity >> s) & 1u);
      parity ^= 1u << s;
      if (inside) {
        const float* sm = smaps + s * (kMapBytes / 4) + ly * kTileW
                          + kVec * lx;
        const float4 mx = *reinterpret_cast<const float4*>(sm);
        const float4 my =
            *reinterpret_cast<const float4*>(sm + kTileH * kTileW);
        const typename Op::Ctx ctx = op.tile(t.n);
        const typename Op::T* g =
            op.src + static_cast<int64_t>(t.n) * kChannels * op.h * op.w;
        float acc[kChannels][kVec];
#pragma unroll
        for (int j = 0; j < kVec; ++j)
          sample(op, ctx, op.pixel(lane_of(mx, j), lane_of(my, j), x + j),
                 g, acc, j);
#pragma unroll
        for (int c = 0; c < kChannels; ++c)
          __stcs(reinterpret_cast<float4*>(d + c * plane),
                 make_float4(acc[c][0], acc[c][1], acc[c][2], acc[c][3]));
      }
    }
    __syncthreads();       // every thread is done with stage s
  }
}

// Launch one persistent block per free slot (at most the work items),
// on the current device. Returns a cudaError_t (0 = success).
template <class Op>
int launch(const Op& op, const Plan& p, const Band& b, void* stream) {
  if (b.bw % kVec != 0 || p.order == nullptr || p.count == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.n_items == 0) return 0;
  static int slots[kMaxDevices] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (slots[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, tiles_kernel<Op>, kThreads, kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    slots[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int grid = p.n_items < slots[dev] ? p.n_items : slots[dev];
  tiles_kernel<Op><<<grid, kThreads, kSmemBytes,
                     static_cast<cudaStream_t>(stream)>>>(op, p, b);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace warp_tiles
