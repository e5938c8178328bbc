// Built-in HEVC encoder, native twin of io_plane/hevc_pcm.py: Main
// profile, all-intra, every 32x32 CTU coded I_PCM (raw samples, loop
// filters off) — a spec-compliant lossless bitstream produced at memcpy
// speed. The reference links kvazaar for its player egress
// (360_stitcher/timed.cpp:198-352); this is the self-contained fallback
// when no encoder binary/library exists in the image. Bit-level
// references: ITU-T H.265 (02/2018) — NAL 7.3.1.2, VPS/SPS/PPS 7.3.2,
// slice 7.3.6.1, coding unit / pcm_sample 7.3.8.5/7.3.8.7, CABAC 9.3.
//
// The Python module is the reference implementation (tested bit-exact
// against FFmpeg's independent hevc decoder); this twin exists because
// egress encodes full panoramas per frame on the live path. Emulation
// prevention (7.4.2) is applied on the fly as bytes are emitted.
//
// C ABI (ctypes, mirrors stitchio.cpp conventions):
//   void* hevcpcm_create(int w, int h)
//   long  hevcpcm_max_size(void* enc)       // worst-case encode() bytes
//   long  hevcpcm_encode(void* e, const uint8_t* i420, uint8_t* out,
//                        long cap)          // -> bytes written, -1 err
//   void  hevcpcm_destroy(void* enc)
//
// Build: make libhevcpcm.so (invoked on demand by io_plane/hevc_pcm.py).

#include <cstdint>
#include <cstring>

#include "cabac_tables.h"
#include <vector>

namespace {

constexpr int CTB = 32;     // CTB = MinCb = PCM size: no split flags
using hevc_cabac_tables::kRangeLps;
using hevc_cabac_tables::kTransLps;

// MSB-first bit sink writing into a caller buffer, with emulation
// prevention (7.4.2) applied on the fly while inside an RBSP.
struct Writer {
  uint8_t* out;
  long cap, n = 0;
  uint64_t acc = 0;   // 64-bit: width-32 writes on a 7-bit residue need 39
  int nbits = 0;
  int zrun = 0;
  bool in_rbsp = false;
  bool overflow = false;

  void raw(uint8_t b) {               // start codes + NAL header
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
  // Bulk byte-aligned append (PCM samples): memcpy between escape
  // points. An escape is needed before position j iff the two previous
  // emitted bytes were 00 00 and s[j] <= 3; zeros are rare in video
  // payloads (BT.601 black is Y=16), so the scan is memchr-paced.
  void bulk(const uint8_t* s, long len) {
    if (overflow || len <= 0) return;
    long i = 0;
    while (i < len && zrun >= 2) byte(s[i++]);    // settle carry-in run
    while (i < len) {
      long p = i, found = -1;
      int zr = zrun;
      while (p < len) {
        if (s[p] != 0) {
          const uint8_t* z =
              static_cast<const uint8_t*>(memchr(s + p, 0, len - p));
          if (!z) { p = len; zr = 0; break; }
          p = z - s;
          zr = 0;
        }
        ++zr;                        // s[p] == 0
        ++p;
        if (zr >= 2 && p < len && s[p] <= 3) { found = p; break; }
      }
      long j = found >= 0 ? found : len;
      if (n + (j - i) > cap) { overflow = true; return; }
      std::memcpy(out + n, s + i, j - i);
      n += j - i;
      if (found >= 0) {
        if (n >= cap) { overflow = true; return; }
        out[n++] = 3;
        zrun = 0;
        i = j;
      } else {
        zrun = zr;                   // trailing zero run carries over
        i = len;
      }
    }
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
  void ue(uint32_t v) {               // Exp-Golomb, 9.2
    ++v;
    int len = 32 - __builtin_clz(v);
    bits(0, len - 1);
    bits(v, len);
  }
  void se(int v) { ue(v > 0 ? 2 * v - 1 : -2 * v); }
  void align_zero() {
    if (nbits) bits(0, 8 - nbits);
  }
  void nal_start(int nal_type) {      // Annex B start code + header
    in_rbsp = false;
    raw(0); raw(0); raw(0); raw(1);
    raw(uint8_t(nal_type << 1));
    raw(1);                           // nuh_layer_id 0, tid_plus1 1
    zrun = 0;
    in_rbsp = true;
  }
};

// Arithmetic encoder, H.265 9.3.4.3 (EncodeDecision / EncodeTerminate /
// EncodeFlush / PutBit). Only what an all-PCM slice exercises.
struct Cabac {
  Writer& w;
  uint32_t low = 0, range = 510;
  int outstanding = 0;
  bool first = true;

  explicit Cabac(Writer& wr) : w(wr) {}

  void putbit(int v) {
    if (first) {
      first = false;                  // the very first bit is discarded
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
  void bin(int* state, int* mps, int v) {
    uint32_t lps = kRangeLps[*state][(range >> 6) & 3];
    range -= lps;
    if (v != *mps) {
      low += range;
      range = lps;
      if (*state == 0) *mps = 1 - *mps;
      *state = kTransLps[*state];
    } else {
      *state = *state < 62 ? *state + 1 : 62;
    }
    renorm();
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
    w.bits(((low >> 7) & 3) | 1, 2);  // last bit doubles as the stop bit
  }
  void restart() {                    // after pcm_sample, 9.3.1
    low = 0;
    range = 510;
    outstanding = 0;
    first = true;
  }
};

void profile_tier_level(Writer& b) {
  b.bits(0, 2);                       // general_profile_space
  b.bits(0, 1);                       // general_tier_flag
  b.bits(1, 5);                       // general_profile_idc = Main
  b.bits(0x60000000u, 32);            // compatibility: Main + Main10
  b.bits(0b1001, 4);                  // progressive, frame_only
  b.bits(0, 32);                      // reserved 43 bits + inbld ...
  b.bits(0, 12);
  b.bits(180, 8);                     // general_level_idc = 6.0
}

struct Enc {
  int w, h, pw, ph;
  std::vector<uint8_t> headers;       // escaped Annex-B VPS+SPS+PPS
  bool sent_headers = false;
  std::vector<uint8_t> padrow;        // scratch for edge padding
};

void write_vps(Writer& b) {
  b.nal_start(32);
  b.bits(0, 4);                       // vps_video_parameter_set_id
  b.bits(1, 1);                       // vps_base_layer_internal_flag
  b.bits(1, 1);                       // vps_base_layer_available_flag
  b.bits(0, 6);                       // vps_max_layers_minus1
  b.bits(0, 3);                       // vps_max_sub_layers_minus1
  b.bits(1, 1);                       // vps_temporal_id_nesting_flag
  b.bits(0xFFFF, 16);                 // vps_reserved_0xffff_16bits
  profile_tier_level(b);
  b.bits(0, 1);                       // sub_layer_ordering_info_present
  b.ue(0); b.ue(0); b.ue(0);          // dec_pic_buffering/reorder/latency
  b.bits(0, 6);                       // vps_max_layer_id
  b.ue(0);                            // vps_num_layer_sets_minus1
  b.bits(0, 1);                       // vps_timing_info_present_flag
  b.bits(0, 1);                       // vps_extension_flag
  b.bits(1, 1);                       // rbsp_stop_one_bit
  b.align_zero();
}

void write_sps(Writer& b, const Enc& e) {
  b.nal_start(33);
  b.bits(0, 4);                       // sps_video_parameter_set_id
  b.bits(0, 3);                       // sps_max_sub_layers_minus1
  b.bits(1, 1);                       // sps_temporal_id_nesting_flag
  profile_tier_level(b);
  b.ue(0);                            // sps_seq_parameter_set_id
  b.ue(1);                            // chroma_format_idc = 4:2:0
  b.ue(e.pw);                         // pic_width (CTB-padded)
  b.ue(e.ph);
  bool pad = e.pw != e.w || e.ph != e.h;
  b.bits(pad, 1);                     // conformance_window_flag
  if (pad) {                          // offsets in chroma units
    b.ue(0); b.ue((e.pw - e.w) / 2);
    b.ue(0); b.ue((e.ph - e.h) / 2);
  }
  b.ue(0); b.ue(0);                   // bit depths (8-bit)
  b.ue(0);                            // log2_max_poc_lsb_minus4
  b.bits(0, 1);                       // sub_layer_ordering_info_present
  b.ue(0); b.ue(0); b.ue(0);
  b.ue(2);                            // log2_min_cb_minus3: MinCb = 32
  b.ue(0);                            // diff max/min: CTB = 32
  b.ue(0);                            // log2_min_tb_minus2 = 4
  b.ue(3);                            // max TB = 32
  b.ue(0); b.ue(0);                   // transform hierarchy depths
  b.bits(0, 1);                       // scaling_list_enabled_flag
  b.bits(0, 1);                       // amp_enabled_flag
  b.bits(0, 1);                       // sample_adaptive_offset_enabled
  b.bits(1, 1);                       // pcm_enabled_flag
  b.bits(7, 4);                       // pcm_sample_bit_depth_luma_minus1
  b.bits(7, 4);                       // pcm_sample_bit_depth_chroma_m1
  b.ue(2);                            // log2_min_pcm_cb_minus3 = 32
  b.ue(0);                            // log2_diff_max_min_pcm
  b.bits(1, 1);                       // pcm_loop_filter_disabled_flag
  b.ue(0);                            // num_short_term_ref_pic_sets
  b.bits(0, 1);                       // long_term_ref_pics_present
  b.bits(0, 1);                       // sps_temporal_mvp_enabled_flag
  b.bits(0, 1);                       // strong_intra_smoothing_enabled
  b.bits(0, 1);                       // vui_parameters_present_flag
  b.bits(0, 1);                       // sps_extension_present_flag
  b.bits(1, 1);
  b.align_zero();
}

void write_pps(Writer& b) {
  b.nal_start(34);
  b.ue(0);                            // pps_pic_parameter_set_id
  b.ue(0);                            // pps_seq_parameter_set_id
  b.bits(0, 1);                       // dependent_slice_segments_enabled
  b.bits(0, 1);                       // output_flag_present_flag
  b.bits(0, 3);                       // num_extra_slice_header_bits
  b.bits(0, 1);                       // sign_data_hiding_enabled_flag
  b.bits(0, 1);                       // cabac_init_present_flag
  b.ue(0); b.ue(0);                   // num_ref_idx_l0/l1_default
  b.se(0);                            // init_qp_minus26 (SliceQpY = 26)
  b.bits(0, 1);                       // constrained_intra_pred_flag
  b.bits(0, 1);                       // transform_skip_enabled_flag
  b.bits(0, 1);                       // cu_qp_delta_enabled_flag
  b.se(0); b.se(0);                   // cb/cr qp offsets
  b.bits(0, 1);                       // slice_chroma_qp_offsets_present
  b.bits(0, 1);                       // weighted_pred_flag
  b.bits(0, 1);                       // weighted_bipred_flag
  b.bits(0, 1);                       // transquant_bypass_enabled_flag
  b.bits(0, 1);                       // tiles_enabled_flag
  b.bits(0, 1);                       // entropy_coding_sync_enabled
  b.bits(0, 1);                       // loop_filter_across_slices
  b.bits(1, 1);                       // deblocking_filter_control_present
  b.bits(0, 1);                       // deblocking_filter_override
  b.bits(1, 1);                       // pps_deblocking_filter_disabled
  b.bits(0, 1);                       // pps_scaling_list_data_present
  b.bits(0, 1);                       // lists_modification_present_flag
  b.ue(0);                            // log2_parallel_merge_level_minus2
  b.bits(0, 1);                       // slice_header_extension_present
  b.bits(0, 1);                       // pps_extension_present_flag
  b.bits(1, 1);
  b.align_zero();
}

// Append one PCM plane tile: tsz x tsz starting at (x0, y0) in a plane of
// pw x ph (padded dims), reading from src (w x h real dims) with edge
// replication. Bytes go through the writer for emulation prevention.
void pcm_tile(Writer& b, const uint8_t* src, int w, int h, int x0, int y0,
              int tsz) {
  for (int r = 0; r < tsz; ++r) {
    int sy = y0 + r < h ? y0 + r : h - 1;
    const uint8_t* row = src + (long)sy * w;
    int real = w - x0;
    if (real >= tsz) {
      b.bulk(row + x0, tsz);
    } else {
      b.bulk(row + x0, real);
      uint8_t edge = row[w - 1];
      for (int c = real; c < tsz; ++c) b.byte(edge);
    }
  }
}

void write_slice(Writer& b, const Enc& e, const uint8_t* i420) {
  const uint8_t* y = i420;
  const uint8_t* u = y + (long)e.w * e.h;
  const uint8_t* v = u + (long)(e.w / 2) * (e.h / 2);
  b.nal_start(19);                    // IDR_W_RADL
  b.bits(1, 1);                       // first_slice_segment_in_pic_flag
  b.bits(0, 1);                       // no_output_of_prior_pics (IRAP)
  b.ue(0);                            // slice_pic_parameter_set_id
  b.ue(2);                            // slice_type = I
  b.se(0);                            // slice_qp_delta -> SliceQpY 26
  b.bits(1, 1);                       // byte_alignment
  b.align_zero();
  Cabac cab(b);
  // part_mode context init (9.3.2.2): initValue 184, SliceQpY 26 ->
  // preCtxState 64 -> pStateIdx 0, valMps 1
  int state = 0, mps = 1;
  int nr = e.ph / CTB, nc = e.pw / CTB;
  for (int ty = 0; ty < nr; ++ty) {
    for (int tx = 0; tx < nc; ++tx) {
      // split_cu_flag inferred 0 (CTB == MinCb); intra inferred (I
      // slice); size == MinCb -> part_mode signaled; PART_2Nx2N
      // enables pcm_flag.
      cab.bin(&state, &mps, 1);       // part_mode = PART_2Nx2N
      cab.term(1);                    // pcm_flag (terminate + flush)
      b.align_zero();                 // pcm_alignment_zero_bit
      pcm_tile(b, y, e.w, e.h, tx * CTB, ty * CTB, CTB);
      pcm_tile(b, u, e.w / 2, e.h / 2, tx * CTB / 2, ty * CTB / 2,
               CTB / 2);
      pcm_tile(b, v, e.w / 2, e.h / 2, tx * CTB / 2, ty * CTB / 2,
               CTB / 2);
      cab.restart();                  // 9.3.1: engine re-init after PCM
      cab.term(ty == nr - 1 && tx == nc - 1);   // end_of_slice_segment
    }
  }
  b.align_zero();                     // rbsp trailing (stop bit = flush's)
}

}  // namespace

extern "C" {

void* hevcpcm_create(int w, int h) {
  if (w <= 0 || h <= 0 || w % 2 || h % 2) return nullptr;
  Enc* e = new Enc;
  e->w = w;
  e->h = h;
  e->pw = (w + CTB - 1) / CTB * CTB;
  e->ph = (h + CTB - 1) / CTB * CTB;
  std::vector<uint8_t> buf(4096);
  Writer b{buf.data(), (long)buf.size()};
  write_vps(b);
  write_sps(b, *e);
  write_pps(b);
  if (b.overflow) {
    delete e;
    return nullptr;
  }
  e->headers.assign(buf.data(), buf.data() + b.n);
  return e;
}

long hevcpcm_max_size(void* enc) {
  Enc* e = static_cast<Enc*>(enc);
  long nctu = (long)(e->pw / CTB) * (e->ph / CTB);
  // per CTU: 1536 PCM bytes + <=8 glue bytes, worst-case escape 3/2,
  // plus headers + slice header slack
  return (nctu * 1544 * 3) / 2 + (long)e->headers.size() + 256;
}

long hevcpcm_encode(void* enc, const uint8_t* i420, uint8_t* out,
                    long cap) {
  Enc* e = static_cast<Enc*>(enc);
  Writer b{out, cap};
  if (!e->sent_headers) {
    if ((long)e->headers.size() > cap) return -1;
    std::memcpy(out, e->headers.data(), e->headers.size());
    b.n = e->headers.size();
    e->sent_headers = true;
  }
  write_slice(b, *e, i420);
  return b.overflow ? -1 : b.n;
}

void hevcpcm_destroy(void* enc) { delete static_cast<Enc*>(enc); }

}  // extern "C"
