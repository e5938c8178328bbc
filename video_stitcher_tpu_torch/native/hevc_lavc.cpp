// In-process HEVC encoder via the system libavcodec (libx265 backend).
//
// The reference links kvazaar in-process and streams compressed HEVC to
// the player (360_stitcher/timed.cpp:198-229,320-350). This shim is the
// TPU port's equivalent: a real software HEVC encoder (x265 — the same
// ultravideo-adjacent lineage), linked in-process through libavcodec's
// stable C API, no subprocess, producing player-consumable Annex-B at
// configurable bitrate/CRF. Falls back cleanly at load time when the
// library lacks libx265 (the loader then uses the built-in I_PCM codec,
// io_plane/hevc_pcm.py).
//
// C ABI (ctypes-consumed by io_plane/hevc_lavc.py):
//   hevclavc_create(w, h, fps, bitrate_kbps, crf, gop) -> handle | NULL
//   hevclavc_encode(h, i420, out, cap) -> bytes written (>=0) | -1 error
//   hevclavc_flush(h, out, cap)       -> drained bytes | -1
//   hevclavc_destroy(h)
//
// Encoder config mirrors the reference's kvazaar setup (timed.cpp:198-
// 229): all-intra-leaning low-latency (zerolatency tune, no B-frames,
// short GOP), ultrafast preset for live 1-core operation.

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavutil/imgutils.h>
#include <libavutil/opt.h>
}

#include <cstring>
#include <deque>
#include <string>

namespace {

struct Enc {
    const AVCodec *codec = nullptr;
    AVCodecContext *ctx = nullptr;
    AVFrame *frame = nullptr;
    AVPacket *pkt = nullptr;
    int w = 0, h = 0;
    long pts = 0;
};

long drain(Enc *e, uint8_t *out, long cap, long n) {
    for (;;) {
        int r = avcodec_receive_packet(e->ctx, e->pkt);
        if (r == AVERROR(EAGAIN) || r == AVERROR_EOF) break;
        if (r < 0) return -1;
        if (n + e->pkt->size > cap) { av_packet_unref(e->pkt); return -1; }
        std::memcpy(out + n, e->pkt->data, e->pkt->size);
        n += e->pkt->size;
        av_packet_unref(e->pkt);
    }
    return n;
}

}  // namespace

extern "C" {

void *hevclavc_create(int w, int h, int fps, int bitrate_kbps, int crf,
                      int gop) {
    if (w <= 0 || h <= 0 || (w | h) & 1) return nullptr;
    Enc *e = new Enc();
    e->w = w; e->h = h;
    e->codec = avcodec_find_encoder_by_name("libx265");
    if (!e->codec) { delete e; return nullptr; }
    e->ctx = avcodec_alloc_context3(e->codec);
    if (!e->ctx) { delete e; return nullptr; }
    e->ctx->width = w;
    e->ctx->height = h;
    e->ctx->time_base = AVRational{1, fps > 0 ? fps : 30};
    e->ctx->framerate = AVRational{fps > 0 ? fps : 30, 1};
    e->ctx->pix_fmt = AV_PIX_FMT_YUV420P;
    e->ctx->max_b_frames = 0;
    e->ctx->gop_size = gop > 0 ? gop : 30;
    if (bitrate_kbps > 0) e->ctx->bit_rate = 1000L * bitrate_kbps;
    av_opt_set(e->ctx->priv_data, "preset", "ultrafast", 0);
    av_opt_set(e->ctx->priv_data, "tune", "zerolatency", 0);
    // Annex-B with headers repeated at every keyframe, so a player that
    // connects mid-stream (or after the egress reconnect reopens the
    // encoder) always starts VPS/SPS/PPS-led like the reference's
    // (timed.cpp:331-348). log disabled: x265's banner goes to stderr.
    std::string params = "repeat-headers=1:log-level=none:annexb=1";
    if (bitrate_kbps <= 0)
        params += ":crf=" + std::to_string(crf > 0 ? crf : 23);
    av_opt_set(e->ctx->priv_data, "x265-params", params.c_str(), 0);
    if (avcodec_open2(e->ctx, e->codec, nullptr) < 0) {
        avcodec_free_context(&e->ctx);
        delete e;
        return nullptr;
    }
    e->frame = av_frame_alloc();
    e->pkt = av_packet_alloc();
    if (!e->frame || !e->pkt) {          // alloc failure: fall back to
        if (e->frame) av_frame_free(&e->frame);   // the I_PCM encoder
        if (e->pkt) av_packet_free(&e->pkt);      // instead of a segfault
        avcodec_free_context(&e->ctx);
        delete e;
        return nullptr;
    }
    e->frame->format = AV_PIX_FMT_YUV420P;
    e->frame->width = w;
    e->frame->height = h;
    if (av_frame_get_buffer(e->frame, 0) < 0) {
        av_frame_free(&e->frame);
        av_packet_free(&e->pkt);
        avcodec_free_context(&e->ctx);
        delete e;
        return nullptr;
    }
    return e;
}

long hevclavc_encode(void *h, const uint8_t *i420, uint8_t *out, long cap) {
    Enc *e = static_cast<Enc *>(h);
    if (av_frame_make_writable(e->frame) < 0) return -1;
    const int w = e->w, hh = e->h;
    const uint8_t *src = i420;
    for (int r = 0; r < hh; r++)                       // Y
        std::memcpy(e->frame->data[0] + r * e->frame->linesize[0],
                    src + (long)r * w, w);
    src += (long)w * hh;
    for (int r = 0; r < hh / 2; r++)                   // U
        std::memcpy(e->frame->data[1] + r * e->frame->linesize[1],
                    src + (long)r * (w / 2), w / 2);
    src += (long)(w / 2) * (hh / 2);
    for (int r = 0; r < hh / 2; r++)                   // V
        std::memcpy(e->frame->data[2] + r * e->frame->linesize[2],
                    src + (long)r * (w / 2), w / 2);
    e->frame->pts = e->pts++;
    if (avcodec_send_frame(e->ctx, e->frame) < 0) return -1;
    return drain(e, out, cap, 0);
}

long hevclavc_flush(void *h, uint8_t *out, long cap) {
    Enc *e = static_cast<Enc *>(h);
    if (avcodec_send_frame(e->ctx, nullptr) < 0) return -1;
    return drain(e, out, cap, 0);
}

void hevclavc_destroy(void *h) {
    Enc *e = static_cast<Enc *>(h);
    if (!e) return;
    if (e->frame) av_frame_free(&e->frame);
    if (e->pkt) av_packet_free(&e->pkt);
    if (e->ctx) avcodec_free_context(&e->ctx);
    delete e;
}

// ------------------------------------------------------------------
// Matching in-process DECODER (validation loops + player-side tooling).
// Protocol: feed Annex-B bytes, poll frames, flush at end of stream —
//   hevclavc_dec_create() -> handle
//   hevclavc_dec_feed(h, data, n) -> bytes consumed (re-feed the rest
//       after polling frames) | -1 error
//   hevclavc_dec_frame(h, out, cap, &w, &h) -> I420 bytes | 0 none | -1
//   hevclavc_dec_flush(h) -> 0/-1 (send EOF; then poll frames to drain)
//   hevclavc_dec_destroy(h)

struct Dec {
    const AVCodec *codec = nullptr;
    AVCodecContext *ctx = nullptr;
    AVCodecParserContext *parser = nullptr;
    AVFrame *frame = nullptr;
    AVPacket *pkt = nullptr;
    std::deque<AVFrame *> q;    // frames drained by feed() backpressure
    bool draining = false;
};

namespace {
long copy_out(AVFrame *f, uint8_t *out, long cap, int *ow, int *oh) {
    const int w = f->width, hh = f->height;
    const long need = (long)w * hh * 3 / 2;
    if (need > cap) return -1;
    *ow = w; *oh = hh;
    uint8_t *q = out;
    for (int rr = 0; rr < hh; rr++, q += w)
        std::memcpy(q, f->data[0] + (long)rr * f->linesize[0], w);
    for (int rr = 0; rr < hh / 2; rr++, q += w / 2)
        std::memcpy(q, f->data[1] + (long)rr * f->linesize[1], w / 2);
    for (int rr = 0; rr < hh / 2; rr++, q += w / 2)
        std::memcpy(q, f->data[2] + (long)rr * f->linesize[2], w / 2);
    return need;
}

long emit_frame(Dec *d, uint8_t *out, long cap, int *ow, int *oh) {
    long n = copy_out(d->frame, out, cap, ow, oh);
    if (n < 0) {
        // cap too small: park the frame in the queue so a retry with a
        // bigger buffer gets THIS frame instead of silently skipping it
        AVFrame *g = av_frame_alloc();
        if (g) {
            av_frame_move_ref(g, d->frame);
            d->q.push_back(g);
        }
        return n;
    }
    av_frame_unref(d->frame);
    return n;
}
}  // namespace

void *hevclavc_dec_create() {
    Dec *d = new Dec();
    d->codec = avcodec_find_decoder(AV_CODEC_ID_HEVC);
    if (!d->codec) { delete d; return nullptr; }
    d->ctx = avcodec_alloc_context3(d->codec);
    d->parser = av_parser_init(d->codec->id);
    // single-threaded: frame threading adds N frames of decoder delay
    // and lets send_packet AND receive_frame both report EAGAIN, which
    // breaks the feed/poll backpressure contract below
    if (d->ctx) d->ctx->thread_count = 1;
    if (!d->ctx || !d->parser ||
        avcodec_open2(d->ctx, d->codec, nullptr) < 0) {
        if (d->parser) av_parser_close(d->parser);
        if (d->ctx) avcodec_free_context(&d->ctx);
        delete d;
        return nullptr;
    }
    d->frame = av_frame_alloc();
    d->pkt = av_packet_alloc();
    return d;
}

long hevclavc_dec_feed(void *h, const uint8_t *data, long n) {
    Dec *d = static_cast<Dec *>(h);
    const uint8_t *p = data;
    long left = n;
    while (left > 0) {
        uint8_t *pdata = nullptr;
        int psize = 0;
        int used = av_parser_parse2(d->parser, d->ctx, &pdata, &psize,
                                    p, (int)left, AV_NOPTS_VALUE,
                                    AV_NOPTS_VALUE, 0);
        if (used < 0) return -1;
        p += used;
        left -= used;
        if (psize > 0) {
            d->pkt->data = pdata;
            d->pkt->size = psize;
            for (;;) {
                int r = avcodec_send_packet(d->ctx, d->pkt);
                if (r == 0) break;
                if (r != AVERROR(EAGAIN)) return -1;
                // decoder full: drain its output into the frame queue
                // (the parser already consumed these bytes, so the
                // packet must not be dropped; the decoder may buffer
                // SEVERAL output frames before accepting more input)
                AVFrame *g = av_frame_alloc();
                if (!g || avcodec_receive_frame(d->ctx, g) < 0) {
                    if (g) av_frame_free(&g);
                    return -1;
                }
                d->q.push_back(g);
            }
        }
    }
    return n;
}

long hevclavc_dec_frame(void *h, uint8_t *out, long cap, int *ow, int *oh) {
    Dec *d = static_cast<Dec *>(h);
    if (!d->q.empty()) {
        AVFrame *g = d->q.front();
        long n = copy_out(g, out, cap, ow, oh);
        if (n < 0) return n;   // cap too small: keep the frame queued so
                               // a retry with a bigger buffer gets it
        av_frame_free(&g);
        d->q.pop_front();
        return n;
    }
    int r = avcodec_receive_frame(d->ctx, d->frame);
    if (r == 0) return emit_frame(d, out, cap, ow, oh);
    return (r == AVERROR(EAGAIN) || r == AVERROR_EOF) ? 0 : -1;
}

long hevclavc_dec_flush(void *h) {
    Dec *d = static_cast<Dec *>(h);
    if (d->draining) return 0;
    // flush the parser (it may hold the final access unit)
    uint8_t *pdata = nullptr;
    int psize = 0;
    av_parser_parse2(d->parser, d->ctx, &pdata, &psize,
                     nullptr, 0, AV_NOPTS_VALUE, AV_NOPTS_VALUE, 0);
    if (psize > 0) {
        d->pkt->data = pdata;
        d->pkt->size = psize;
        for (;;) {
            int r = avcodec_send_packet(d->ctx, d->pkt);
            if (r == 0) break;
            if (r != AVERROR(EAGAIN)) return -1;
            // decoder full (pending undrained frames — the documented
            // feed-then-flush-then-poll order): drain into the queue
            // like dec_feed, don't report the final AU as an error
            AVFrame *g = av_frame_alloc();
            if (!g || avcodec_receive_frame(d->ctx, g) < 0) {
                if (g) av_frame_free(&g);
                return -1;
            }
            d->q.push_back(g);
        }
    }
    for (;;) {
        int r = avcodec_send_packet(d->ctx, nullptr);
        if (r == 0) break;
        if (r != AVERROR(EAGAIN)) return -1;
        AVFrame *g = av_frame_alloc();
        if (!g || avcodec_receive_frame(d->ctx, g) < 0) {
            if (g) av_frame_free(&g);
            return -1;
        }
        d->q.push_back(g);
    }
    d->draining = true;
    return 0;
}

void hevclavc_dec_destroy(void *h) {
    Dec *d = static_cast<Dec *>(h);
    if (!d) return;
    for (AVFrame *g : d->q) av_frame_free(&g);
    d->q.clear();
    if (d->parser) av_parser_close(d->parser);
    if (d->frame) av_frame_free(&d->frame);
    if (d->pkt) { d->pkt->data = nullptr; d->pkt->size = 0;
                  av_packet_free(&d->pkt); }
    if (d->ctx) avcodec_free_context(&d->ctx);
    delete d;
}

}  // extern "C"
