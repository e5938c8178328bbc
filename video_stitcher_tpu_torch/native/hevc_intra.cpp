// Built-in LOSSY HEVC intra encoder, native twin of
// io_plane/hevc_intra.py: Main profile, all-intra, DC prediction, 4x4
// DST/DCT + quantization + full CABAC residual coding at configurable
// QP. The Python module is the reference implementation (FFmpeg decodes
// its streams to the encoder's own reconstruction bit-exactly); this
// twin exists because the live egress encodes full panoramas per frame
// (~6 s/frame in Python at 640x360 — unusable live). Bitstreams are
// byte-identical to the Python module's (tested).
//
// Design (see the Python module's docstring for the full rationale):
// CTB = MinCb = 16 (no split_cu flags), every CU intra 2Nx2N DC,
// min = max TB = 4 (every transform split inferred), deblocking + SAO
// off so decoder output == reconstruction. Bit-level references:
// ITU-T H.265 (02/2018) 7.3.8, 8.4.4.2, 8.6, 9.3.
//
// C ABI (ctypes, mirrors hevc_pcm.cpp conventions):
//   void* hevcintra_create(int w, int h, int qp)
//   long  hevcintra_max_size(void* enc)
//   long  hevcintra_encode(void* e, const uint8_t* i420, uint8_t* out,
//                          long cap)   // -> bytes written, -1 error
//   void  hevcintra_destroy(void* enc)
//
// Build: make libhevcintra.so (on demand via io_plane/hevc_intra.py).

#include <algorithm>
#include <cstdint>
#include <cstring>

#include "cabac_tables.h"
#include <vector>

namespace {

constexpr int CTB = 16;

// H.265 tables 9-46 / 9-47: shared spec constants (cabac_tables.h)
using hevc_cabac_tables::kRangeLps;
using hevc_cabac_tables::kTransLps;

// context init values, I slices (9.3.2.2 / tables 9-4ff)
const uint8_t kInitLastXY[18] = {110, 110, 124, 125, 140, 153, 125, 127,
                                 140, 109, 111, 143, 127, 111, 79, 108,
                                 123, 63};
const uint8_t kInitSig[44] = {111, 111, 125, 110, 110, 94,  124, 108,
                              124, 107, 125, 141, 179, 153, 125, 107,
                              125, 141, 179, 153, 125, 107, 125, 141,
                              179, 153, 125, 140, 139, 182, 182, 152,
                              136, 152, 136, 153, 136, 139, 111, 136,
                              139, 111, 141, 111};
const uint8_t kInitGt1[24] = {140, 92,  137, 138, 140, 152, 138, 139,
                              153, 74,  149, 92,  139, 107, 122, 152,
                              140, 179, 166, 182, 140, 227, 122, 197};
const uint8_t kInitGt2[6] = {138, 153, 136, 167, 152, 152};
const uint8_t kInitCbfLuma[2] = {111, 141};
const uint8_t kInitCbfCbCr[3] = {94, 138, 182};

// sig_coeff_flag 4x4 position -> ctx (table 9-39), y*4+x; chroma +27
const uint8_t kSigCtx[16] = {0, 1, 4, 5, 2, 3, 4, 5,
                             6, 6, 8, 8, 7, 7, 8, 8};

// up-right diagonal scan: pos -> (x, y)
const uint8_t kDiagX[16] = {0, 0, 1, 0, 1, 2, 0, 1, 2, 3, 1, 2, 3, 2, 3, 3};
const uint8_t kDiagY[16] = {0, 1, 0, 2, 1, 0, 3, 2, 1, 0, 3, 2, 1, 3, 2, 3};

const int kLevScale[6] = {40, 45, 51, 57, 64, 72};
const int kQuantScale[6] = {26214, 23302, 20560, 18396, 16384, 14564};

const int kDst4[4][4] = {{29, 55, 74, 84},
                         {74, 74, 0, -74},
                         {84, -29, -74, 55},
                         {55, -84, 74, -29}};
const int kDct4[4][4] = {{64, 64, 64, 64},
                         {83, 36, -36, -83},
                         {64, -64, -64, 64},
                         {36, -83, 83, -36}};

const int kQpcTab[13] = {29, 30, 31, 32, 33, 33, 34,
                         34, 35, 35, 36, 36, 37};

int chroma_qp(int qp) {
  int q = std::min(57, std::max(0, qp));
  if (q < 30) return q;
  if (q > 42) return q - 6;
  return kQpcTab[q - 30];
}

// --- bit sink with on-the-fly emulation prevention (hevc_pcm.cpp) ----
struct Writer {
  uint8_t* out;
  long cap, n = 0;
  uint64_t acc = 0;
  int nbits = 0;
  int zrun = 0;
  bool in_rbsp = false;
  bool overflow = false;

  void raw(uint8_t b) {
    if (n >= cap) { overflow = true; return; }
    out[n++] = b;
  }
  void byte(uint8_t b) {
    if (in_rbsp && zrun >= 2 && b <= 3) {
      if (n >= cap) { overflow = true; return; }
      out[n++] = 3;
      zrun = 0;
    }
    if (n >= cap) { overflow = true; return; }
    out[n++] = b;
    zrun = (b == 0) ? zrun + 1 : 0;
  }
  void bits(uint32_t v, int width) {
    acc = (acc << width) |
          (width >= 32 ? (uint64_t)v : (v & ((1u << width) - 1)));
    nbits += width;
    while (nbits >= 8) {
      nbits -= 8;
      byte((acc >> nbits) & 0xFF);
    }
    acc &= nbits ? ((1ull << nbits) - 1) : 0;
  }
  void ue(uint32_t v) {
    ++v;
    int len = 32 - __builtin_clz(v);
    bits(0, len - 1);
    bits(v, len);
  }
  void se(int v) { ue(v > 0 ? 2 * v - 1 : -2 * v); }
  void align_zero() {
    if (nbits) bits(0, 8 - nbits);
  }
  void nal_start(int nal_type) {
    in_rbsp = false;
    raw(0); raw(0); raw(0); raw(1);
    raw(uint8_t(nal_type << 1));
    raw(1);
    zrun = 0;
    in_rbsp = true;
  }
};

// --- arithmetic encoder with bypass (9.3.4.3) ------------------------
struct CtxVar {
  uint8_t state, mps;
};

CtxVar ctx_init(int init_value, int qp) {
  int slope = (init_value >> 4) * 5 - 45;
  int offset = ((init_value & 15) << 3) - 16;
  int pre = std::min(
      126, std::max(1, ((slope * std::min(51, std::max(0, qp))) >> 4)
                           + offset));
  if (pre <= 63) return {uint8_t(63 - pre), 0};
  return {uint8_t(pre - 64), 1};
}

struct Cabac {
  Writer& w;
  uint32_t low = 0, range = 510;
  int outstanding = 0;
  bool first = true;

  explicit Cabac(Writer& wr) : w(wr) {}

  void putbit(int v) {
    if (first) {
      first = false;
    } else {
      w.bits(v, 1);
    }
    for (; outstanding > 0; --outstanding) w.bits(1 - v, 1);
  }
  void renorm() {
    while (range < 256) {
      if (low >= 512) {
        low -= 512;
        putbit(1);
      } else if (low < 256) {
        putbit(0);
      } else {
        low -= 256;
        ++outstanding;
      }
      range <<= 1;
      low <<= 1;
    }
  }
  void bin(CtxVar& c, int v) {
    uint32_t lps = kRangeLps[c.state][(range >> 6) & 3];
    range -= lps;
    if (v != c.mps) {
      low += range;
      range = lps;
      if (c.state == 0) c.mps = 1 - c.mps;
      c.state = kTransLps[c.state];
    } else {
      c.state = c.state < 62 ? c.state + 1 : 62;
    }
    renorm();
  }
  void bypass(int v) {
    low <<= 1;
    if (v) low += range;
    if (low >= 1024) {
      low -= 1024;
      putbit(1);
    } else if (low < 512) {
      putbit(0);
    } else {
      low -= 512;
      ++outstanding;
    }
  }
  void term(int v) {
    range -= 2;
    if (v) {
      low += range;
      flush();
    } else {
      renorm();
    }
  }
  void flush() {
    range = 2;
    renorm();
    putbit((low >> 9) & 1);
    w.bits(((low >> 7) & 3) | 1, 2);
  }
};

struct Ctx {
  CtxVar part_mode, prev_intra, chroma_mode;
  CtxVar cbf_luma[2], cbf_cbcr[3];
  CtxVar last_x[18], last_y[18], sig[44], gt1[24], gt2[6];

  explicit Ctx(int qp) {
    part_mode = ctx_init(184, qp);
    prev_intra = ctx_init(184, qp);
    chroma_mode = ctx_init(63, qp);
    for (int i = 0; i < 2; i++) cbf_luma[i] = ctx_init(kInitCbfLuma[i], qp);
    for (int i = 0; i < 3; i++) cbf_cbcr[i] = ctx_init(kInitCbfCbCr[i], qp);
    for (int i = 0; i < 18; i++) {
      last_x[i] = ctx_init(kInitLastXY[i], qp);
      last_y[i] = ctx_init(kInitLastXY[i], qp);
    }
    for (int i = 0; i < 44; i++) sig[i] = ctx_init(kInitSig[i], qp);
    for (int i = 0; i < 24; i++) gt1[i] = ctx_init(kInitGt1[i], qp);
    for (int i = 0; i < 6; i++) gt2[i] = ctx_init(kInitGt2[i], qp);
  }
};

// --- transforms / quant (8.6, HM forward convention) -----------------
using Blk = int32_t[4][4];

void fwd_xform(const int32_t res[4][4], const int (*mat)[4],
               int64_t coef[4][4]) {
  int64_t t[4][4];
  for (int i = 0; i < 4; i++)
    for (int j = 0; j < 4; j++) {
      int64_t s = 0;
      for (int k = 0; k < 4; k++) s += (int64_t)mat[i][k] * res[k][j];
      t[i][j] = (s + 1) >> 1;
    }
  for (int i = 0; i < 4; i++)
    for (int j = 0; j < 4; j++) {
      int64_t s = 0;
      for (int k = 0; k < 4; k++) s += t[i][k] * mat[j][k];
      coef[i][j] = (s + 128) >> 8;
    }
}

void inv_xform(const int32_t lev[4][4], const int (*mat)[4], int qp,
               int32_t res[4][4]) {
  // dequant (8.6.3, nTbS 4, 8-bit, m = 16 -> bdShift = 5)
  int64_t d[4][4];
  const int64_t sc = 16 * kLevScale[qp % 6];
  const int sh = qp / 6;
  for (int i = 0; i < 4; i++)
    for (int j = 0; j < 4; j++) {
      int64_t v = ((((int64_t)lev[i][j] * sc) << sh) + 16) >> 5;
      d[i][j] = std::min<int64_t>(32767, std::max<int64_t>(-32768, v));
    }
  int64_t t[4][4];
  for (int i = 0; i < 4; i++)       // columns: mat^T . d
    for (int j = 0; j < 4; j++) {
      int64_t s = 0;
      for (int k = 0; k < 4; k++) s += (int64_t)mat[k][i] * d[k][j];
      s = (s + 64) >> 7;
      t[i][j] = std::min<int64_t>(32767, std::max<int64_t>(-32768, s));
    }
  for (int i = 0; i < 4; i++)       // rows: t . mat
    for (int j = 0; j < 4; j++) {
      int64_t s = 0;
      for (int k = 0; k < 4; k++) s += t[i][k] * mat[k][j];
      s = (s + 2048) >> 12;
      res[i][j] = (int32_t)std::min<int64_t>(
          32767, std::max<int64_t>(-32768, s));
    }
}

bool quantize(const int64_t coef[4][4], int qp, int32_t lev[4][4]) {
  const int qbits = 19 + qp / 6;
  const int64_t f = (int64_t)171 << (qbits - 9);
  const int64_t qs = kQuantScale[qp % 6];
  bool any = false;
  for (int i = 0; i < 4; i++)
    for (int j = 0; j < 4; j++) {
      int64_t a = coef[i][j] < 0 ? -coef[i][j] : coef[i][j];
      int64_t l = (a * qs + f) >> qbits;
      l = std::min<int64_t>(32767, l);
      lev[i][j] = (int32_t)(coef[i][j] < 0 ? -l : l);
      any |= l != 0;
    }
  return any;
}

// --- encoder state ---------------------------------------------------
struct Enc {
  int w, h, pw, ph, qp, qpc;
  std::vector<uint8_t> headers;
  bool sent_headers = false;
  std::vector<int32_t> ysrc, usrc, vsrc;   // padded planes (int32)
  std::vector<int32_t> yrec, urec, vrec;
};

void profile_tier_level(Writer& b) {
  b.bits(0, 2);
  b.bits(0, 1);
  b.bits(1, 5);
  b.bits(0x60000000u, 32);
  b.bits(0b1001, 4);
  b.bits(0, 32);
  b.bits(0, 12);
  b.bits(180, 8);
}

void write_vps(Writer& b) {
  b.nal_start(32);
  b.bits(0, 4);
  b.bits(1, 1);
  b.bits(1, 1);
  b.bits(0, 6);
  b.bits(0, 3);
  b.bits(1, 1);
  b.bits(0xFFFF, 16);
  profile_tier_level(b);
  b.bits(0, 1);
  b.ue(0); b.ue(0); b.ue(0);
  b.bits(0, 6);
  b.ue(0);
  b.bits(0, 1);
  b.bits(0, 1);
  b.bits(1, 1);
  b.align_zero();
}

void write_sps(Writer& b, const Enc& e) {
  b.nal_start(33);
  b.bits(0, 4);
  b.bits(0, 3);
  b.bits(1, 1);
  profile_tier_level(b);
  b.ue(0);                            // sps_seq_parameter_set_id
  b.ue(1);                            // chroma_format_idc 4:2:0
  b.ue(e.pw);
  b.ue(e.ph);
  bool pad = e.pw != e.w || e.ph != e.h;
  b.bits(pad ? 1 : 0, 1);
  if (pad) {
    b.ue(0);
    b.ue((e.pw - e.w) / 2);
    b.ue(0);
    b.ue((e.ph - e.h) / 2);
  }
  b.ue(0);                            // bit_depth_luma_minus8
  b.ue(0);                            // bit_depth_chroma_minus8
  b.ue(0);                            // log2_max_pic_order_cnt
  b.bits(0, 1);
  b.ue(0); b.ue(0); b.ue(0);
  b.ue(1);                            // MinCb = 16
  b.ue(0);                            // CTB = MinCb
  b.ue(0);                            // min TB = 4
  b.ue(0);                            // max TB = 4 (splits inferred)
  b.ue(2);                            // max_transform_depth_inter
  b.ue(2);                            // max_transform_depth_intra
  b.bits(0, 1);                       // scaling_list
  b.bits(0, 1);                       // amp
  b.bits(0, 1);                       // sao
  b.bits(0, 1);                       // pcm
  b.ue(0);                            // num_short_term_ref_pic_sets
  b.bits(0, 1);                       // long_term_ref_pics
  b.bits(0, 1);                       // temporal_mvp
  b.bits(0, 1);                       // strong_intra_smoothing
  b.bits(0, 1);                       // vui
  b.bits(0, 1);                       // sps_extension
  b.bits(1, 1);
  b.align_zero();
}

void write_pps(Writer& b) {
  b.nal_start(34);
  b.ue(0);
  b.ue(0);
  b.bits(0, 1);
  b.bits(0, 1);
  b.bits(0, 3);
  b.bits(0, 1);                       // sign_data_hiding
  b.bits(0, 1);                       // cabac_init_present
  b.ue(0); b.ue(0);
  b.se(0);                            // init_qp_minus26
  b.bits(0, 1);
  b.bits(0, 1);                       // transform_skip
  b.bits(0, 1);                       // cu_qp_delta
  b.se(0); b.se(0);
  b.bits(0, 1);
  b.bits(0, 1); b.bits(0, 1); b.bits(0, 1);
  b.bits(0, 1);                       // tiles
  b.bits(0, 1);                       // entropy_sync
  b.bits(0, 1);                       // loop_filter_across_slices
  b.bits(1, 1);                       // deblocking_control_present
  b.bits(0, 1);                       // deblocking_override
  b.bits(1, 1);                       // deblocking_DISABLED
  b.bits(0, 1);
  b.bits(0, 1);
  b.ue(0);
  b.bits(0, 1);
  b.bits(0, 1);
  b.bits(1, 1);
  b.align_zero();
}

// decode-order key of the 4x4 luma block containing (x, y)
inline long zkey(const Enc& e, int x, int y) {
  long ctb = (long)(y / CTB) * (e.pw / CTB) + (x / CTB);
  int bx = (x % CTB) / 4, by = (y % CTB) / 4;
  int z = ((((by >> 1) << 1) | (bx >> 1)) << 2) | (((by & 1) << 1)
                                                  | (bx & 1));
  return ctb * 16 + z;
}

// INTRA_DC for one 4x4 TB of `rec` (stride `stride`), refs per
// 8.4.4.2.2 substitution; luma edge filter per 8.4.4.2.5
void dc_predict(const Enc& e, const int32_t* rec, int stride, int pw,
                int ph, int x0, int y0, long cur_key, int scale,
                bool filter_edges, int32_t pred[4][4]) {
  const int n = 4;
  int32_t vals[17];
  bool avail[17];
  int coords[17][2];
  int idx = 0;
  for (int i = 2 * n - 1; i >= 0; i--, idx++) {   // left col bottom->top
    coords[idx][0] = x0 - 1;
    coords[idx][1] = y0 + i;
  }
  coords[idx][0] = x0 - 1; coords[idx][1] = y0 - 1; idx++;   // corner
  for (int i = 0; i < 2 * n; i++, idx++) {        // top row left->right
    coords[idx][0] = x0 + i;
    coords[idx][1] = y0 - 1;
  }
  bool any = false;
  for (int i = 0; i < 17; i++) {
    int x = coords[i][0], y = coords[i][1];
    avail[i] = x >= 0 && y >= 0 && x < pw && y < ph &&
               zkey(e, x * scale, y * scale) < cur_key;
    if (avail[i]) {
      vals[i] = rec[(long)y * stride + x];
      any = true;
    }
  }
  if (!any) {
    for (int i = 0; i < 17; i++) vals[i] = 128;
  } else {
    if (!avail[0]) {
      for (int i = 1; i < 17; i++)
        if (avail[i]) { vals[0] = vals[i]; break; }
      avail[0] = true;
    }
    for (int i = 1; i < 17; i++)
      if (!avail[i]) vals[i] = vals[i - 1];
  }
  // left[j] = p[-1][j] top->bottom = vals[2n-1-j]; top[j] = vals[2n+1+j]
  int32_t left[4], top[4];
  int sum = 0;
  for (int j = 0; j < n; j++) {
    left[j] = vals[2 * n - 1 - j];
    top[j] = vals[2 * n + 1 + j];
    sum += left[j] + top[j];
  }
  int dc = (sum + n) >> 3;
  for (int i = 0; i < 4; i++)
    for (int j = 0; j < 4; j++) pred[i][j] = dc;
  if (filter_edges) {
    pred[0][0] = (left[0] + 2 * dc + top[0] + 2) >> 2;
    for (int j = 1; j < 4; j++) pred[0][j] = (top[j] + 3 * dc + 2) >> 2;
    for (int i = 1; i < 4; i++) pred[i][0] = (left[i] + 3 * dc + 2) >> 2;
  }
}

// residual_coding() for one 4x4 TB (7.3.8.11), single CG
void code_residual(Cabac& cab, Ctx& ctx, const int32_t lev[4][4],
                   bool chroma) {
  int npos[16], nval[16], nn = 0;
  for (int p = 0; p < 16; p++) {
    int v = lev[kDiagY[p]][kDiagX[p]];
    if (v) {
      npos[nn] = p;
      nval[nn] = v;
      nn++;
    }
  }
  const int last_pos = npos[nn - 1];
  const int lx = kDiagX[last_pos], ly = kDiagY[last_pos];
  const int off = chroma ? 15 : 0;
  for (int pass = 0; pass < 2; pass++) {
    int val = pass ? ly : lx;
    CtxVar* ctxs = pass ? ctx.last_y : ctx.last_x;
    for (int i = 0; i < val; i++) cab.bin(ctxs[off + i], 1);
    if (val < 3) cab.bin(ctxs[off + val], 0);
  }
  bool sig[16] = {};
  for (int i = 0; i < nn; i++) sig[npos[i]] = true;
  const int sig_off = chroma ? 27 : 0;
  for (int p = last_pos - 1; p >= 0; p--) {
    int pos = (kDiagY[p] << 2) | kDiagX[p];
    cab.bin(ctx.sig[sig_off + kSigCtx[pos]], sig[p] ? 1 : 0);
  }
  // reverse-scan coefficients
  int coeffs[16];
  for (int i = 0; i < nn; i++) coeffs[i] = nval[nn - 1 - i];
  const int g1_base = chroma ? 16 : 0;
  const int g2_ctx = chroma ? 4 : 0;
  int greater1_ctx = 1;
  int gt2_idx = -1;
  const int n_g1 = std::min(8, nn);
  for (int i = 0; i < n_g1; i++) {
    int a = coeffs[i] < 0 ? -coeffs[i] : coeffs[i];
    int flag = a > 1 ? 1 : 0;
    cab.bin(ctx.gt1[g1_base + greater1_ctx], flag);
    if (flag) {
      greater1_ctx = 0;
      if (gt2_idx < 0) gt2_idx = i;
    } else if (greater1_ctx > 0 && greater1_ctx < 3) {
      greater1_ctx++;
    }
  }
  if (gt2_idx >= 0) {
    int a = coeffs[gt2_idx] < 0 ? -coeffs[gt2_idx] : coeffs[gt2_idx];
    cab.bin(ctx.gt2[g2_ctx], a > 2 ? 1 : 0);
  }
  for (int i = 0; i < nn; i++) cab.bypass(coeffs[i] < 0 ? 1 : 0);
  int rice = 0;
  for (int i = 0; i < nn; i++) {
    int a = coeffs[i] < 0 ? -coeffs[i] : coeffs[i];
    int rem;
    if (i < n_g1) {
      if (a == 1) continue;
      if (i == gt2_idx) {
        if (a == 2) continue;
        rem = a - 3;
      } else {
        rem = a - 2;
      }
    } else {
      rem = a - 1;
    }
    if (rem < (3 << rice)) {
      int prefix = rem >> rice;
      for (int k = 0; k < prefix; k++) cab.bypass(1);
      cab.bypass(0);
      for (int k = rice - 1; k >= 0; k--) cab.bypass((rem >> k) & 1);
    } else {
      int p = 3;
      while (rem >= (((1 << (p - 2)) + 2) << rice)) p++;
      for (int k = 0; k < p; k++) cab.bypass(1);
      cab.bypass(0);
      int suffix = rem - (((1 << (p - 3)) + 2) << rice);
      int nbits = p - 3 + rice;
      for (int k = nbits - 1; k >= 0; k--) cab.bypass((suffix >> k) & 1);
    }
    if (a > (3 << rice)) rice = std::min(rice + 1, 4);
  }
}

// process one 4x4 TB: predict, transform, quant, recon; returns cbf
bool do_tb(const Enc& e, const int32_t* src, int32_t* rec, int stride,
           int pw, int ph, int x0, int y0, long cur_key, int scale,
           bool luma, int qp, int32_t lev[4][4]) {
  int32_t pred[4][4];
  dc_predict(e, rec, stride, pw, ph, x0, y0, cur_key, scale, luma, pred);
  int32_t res[4][4];
  for (int i = 0; i < 4; i++)
    for (int j = 0; j < 4; j++)
      res[i][j] = src[(long)(y0 + i) * stride + (x0 + j)] - pred[i][j];
  const int(*mat)[4] = luma ? kDst4 : kDct4;
  int64_t coef[4][4];
  fwd_xform(res, mat, coef);
  bool cbf = quantize(coef, qp, lev);
  if (cbf) {
    int32_t r[4][4];
    inv_xform(lev, mat, qp, r);
    for (int i = 0; i < 4; i++)
      for (int j = 0; j < 4; j++) {
        int32_t v = pred[i][j] + r[i][j];
        rec[(long)(y0 + i) * stride + (x0 + j)] =
            v < 0 ? 0 : (v > 255 ? 255 : v);
      }
  } else {
    for (int i = 0; i < 4; i++)
      for (int j = 0; j < 4; j++)
        rec[(long)(y0 + i) * stride + (x0 + j)] = pred[i][j];
  }
  return cbf;
}

void load_planes(Enc& e, const uint8_t* i420) {
  const int w = e.w, h = e.h, pw = e.pw, ph = e.ph;
  auto fill = [](std::vector<int32_t>& dst, const uint8_t* src, int sw,
                 int sh, int dw, int dh) {
    for (int y = 0; y < dh; y++) {
      int sy = y < sh ? y : sh - 1;
      int32_t* row = dst.data() + (long)y * dw;
      const uint8_t* srow = src + (long)sy * sw;
      int x = 0;
      for (; x < sw; x++) row[x] = srow[x];
      for (; x < dw; x++) row[x] = srow[sw - 1];
    }
  };
  fill(e.ysrc, i420, w, h, pw, ph);
  fill(e.usrc, i420 + (long)w * h, w / 2, h / 2, pw / 2, ph / 2);
  fill(e.vsrc, i420 + (long)w * h + (long)(w / 2) * (h / 2), w / 2,
       h / 2, pw / 2, ph / 2);
}

void write_slice(Writer& b, Enc& e, const uint8_t* i420) {
  load_planes(e, i420);
  b.nal_start(19);                    // IDR_W_RADL
  b.bits(1, 1);                       // first_slice_segment_in_pic
  b.bits(0, 1);                       // no_output_of_prior_pics
  b.ue(0);                            // slice_pic_parameter_set_id
  b.ue(2);                            // slice_type I
  b.se(e.qp - 26);                    // slice_qp_delta
  b.bits(1, 1);                       // alignment_bit_equal_to_1
  b.align_zero();

  Cabac cab(b);
  Ctx ctx(e.qp);
  const int n_ctb_x = e.pw / CTB, n_ctb_y = e.ph / CTB;
  const int n_ctb = n_ctb_x * n_ctb_y;
  const int cpw = e.pw / 2, cph = e.ph / 2;

  int32_t luma_lv[16][4][4];
  bool luma_cbf[16];
  int32_t cb_lv[4][4][4], cr_lv[4][4][4];
  bool cb_cbf[4], cr_cbf[4];

  for (int ci = 0; ci < n_ctb; ci++) {
    const int cx = (ci % n_ctb_x) * CTB;
    const int cy = (ci / n_ctb_x) * CTB;
    for (int q = 0; q < 4; q++) {
      const int qx = cx + (q & 1) * 8, qy = cy + (q >> 1) * 8;
      for (int s = 0; s < 4; s++) {
        const int x0 = qx + (s & 1) * 4, y0 = qy + (s >> 1) * 4;
        luma_cbf[q * 4 + s] =
            do_tb(e, e.ysrc.data(), e.yrec.data(), e.pw, e.pw, e.ph, x0,
                  y0, zkey(e, x0, y0), 1, true, e.qp,
                  luma_lv[q * 4 + s]);
      }
      const long ck = zkey(e, qx, qy);
      cb_cbf[q] = do_tb(e, e.usrc.data(), e.urec.data(), cpw, cpw, cph,
                        qx / 2, qy / 2, ck, 2, false, e.qpc, cb_lv[q]);
      cr_cbf[q] = do_tb(e, e.vsrc.data(), e.vrec.data(), cpw, cpw, cph,
                        qx / 2, qy / 2, ck, 2, false, e.qpc, cr_lv[q]);
    }
    const bool any_cb = cb_cbf[0] || cb_cbf[1] || cb_cbf[2] || cb_cbf[3];
    const bool any_cr = cr_cbf[0] || cr_cbf[1] || cr_cbf[2] || cr_cbf[3];
    // coding_unit syntax (no split_cu: CTB == MinCb)
    cab.bin(ctx.part_mode, 1);        // PART_2Nx2N
    cab.bin(ctx.prev_intra, 1);       // DC in the MPM list
    cab.bypass(1);                    // mpm_idx = 1 ("10")
    cab.bypass(0);
    cab.bin(ctx.chroma_mode, 0);      // derived-from-luma
    cab.bin(ctx.cbf_cbcr[0], any_cb ? 1 : 0);
    cab.bin(ctx.cbf_cbcr[0], any_cr ? 1 : 0);
    for (int q = 0; q < 4; q++) {
      if (any_cb) cab.bin(ctx.cbf_cbcr[1], cb_cbf[q] ? 1 : 0);
      if (any_cr) cab.bin(ctx.cbf_cbcr[1], cr_cbf[q] ? 1 : 0);
      for (int s = 0; s < 4; s++) {
        const bool cbf = luma_cbf[q * 4 + s];
        cab.bin(ctx.cbf_luma[0], cbf ? 1 : 0);
        if (cbf) code_residual(cab, ctx, luma_lv[q * 4 + s], false);
        if (s == 3) {
          if (cb_cbf[q]) code_residual(cab, ctx, cb_lv[q], true);
          if (cr_cbf[q]) code_residual(cab, ctx, cr_lv[q], true);
        }
      }
    }
    cab.term(ci == n_ctb - 1 ? 1 : 0);
  }
  b.align_zero();
}

}  // namespace

extern "C" {

void* hevcintra_create(int w, int h, int qp) {
  if (w <= 0 || h <= 0 || (w | h) & 1 || qp < 0 || qp > 51)
    return nullptr;
  Enc* e = new Enc();
  e->w = w;
  e->h = h;
  e->qp = qp;
  e->qpc = chroma_qp(qp);
  e->pw = (w + CTB - 1) / CTB * CTB;
  e->ph = (h + CTB - 1) / CTB * CTB;
  const long lsz = (long)e->pw * e->ph;
  const long csz = lsz / 4;
  e->ysrc.resize(lsz); e->yrec.resize(lsz);
  e->usrc.resize(csz); e->urec.resize(csz);
  e->vsrc.resize(csz); e->vrec.resize(csz);
  // headers
  std::vector<uint8_t> buf(4096);
  Writer wr{buf.data(), (long)buf.size()};
  write_vps(wr);
  write_sps(wr, *e);
  write_pps(wr);
  if (wr.overflow) { delete e; return nullptr; }
  e->headers.assign(buf.data(), buf.data() + wr.n);
  return e;
}

long hevcintra_max_size(void* enc) {
  Enc* e = static_cast<Enc*>(enc);
  // worst case ~ everything escapes + headroom; PCM-level bound is safe
  return (long)e->pw * e->ph * 3 + 65536;
}

long hevcintra_encode(void* enc, const uint8_t* i420, uint8_t* out,
                      long cap) {
  Enc* e = static_cast<Enc*>(enc);
  Writer wr{out, cap};
  const bool lead_headers = !e->sent_headers;
  if (lead_headers) {
    if ((long)e->headers.size() > cap) return -1;
    std::memcpy(out, e->headers.data(), e->headers.size());
    wr.n = (long)e->headers.size();
  }
  write_slice(wr, *e, i420);
  if (wr.overflow) return -1;     // headers NOT latched on failure: a
                                  // caller that drops this frame and
                                  // keeps encoding must still emit a
                                  // VPS/SPS/PPS-led decodable stream
  if (lead_headers) e->sent_headers = true;
  return wr.n;
}

void hevcintra_destroy(void* enc) { delete static_cast<Enc*>(enc); }

}  // extern "C"
