/* Decoder: libavcodec software decode with a reference-shaped session
 * contract: feed one packet / drain one frame, EOS flush, buffer-flush
 * without EOS (seek support), error → reset semantics, motion-vector side
 * data export.
 *
 * Parity target: the reference's NvDecoder session behavior
 * (src/TC/src/NvDecoder.cpp:703-807 DecodeLockSurface, 160-314 sequence
 * handling) and FfmpegDecodeFrame (src/TC/src/FfmpegSwDecoder.cpp), built
 * independently on the public libavcodec API.
 *
 * Output frames are packed into caller-provided buffers in a requested
 * VpfPixelFormat layout; 8-bit 4:2:0 material packs as NV12 (interleaving
 * chroma on copy-out) or as planar YUV420 (cheaper; preferred by the TPU
 * upload path, which wants separate planes anyway).
 */

#include "common.hpp"

#include <algorithm>
#include <deque>
#include <vector>

/* ffmpeg 6.1 replaced AVFrame.key_frame / pkt_duration with flags/duration;
 * support both (this box has avutil 57 / ffmpeg 5.1). */
#if LIBAVUTIL_VERSION_MAJOR >= 58
#define VPF_FRAME_IS_KEY(f) (((f)->flags & AV_FRAME_FLAG_KEY) ? 1 : 0)
#define VPF_FRAME_DURATION(f) ((f)->duration)
#else
#define VPF_FRAME_IS_KEY(f) ((f)->key_frame ? 1 : 0)
#define VPF_FRAME_DURATION(f) ((f)->pkt_duration)
#endif

namespace {

struct Decoder {
  const AVCodec* codec = nullptr;
  AVCodecContext* avctx = nullptr;
  std::deque<AVFrame*> ready;   // decoded frames awaiting pickup
  AVFrame* current = nullptr;   // last frame handed to the caller
  std::vector<VpfMotionVector> mvs;
  bool eos_sent = false;
  int held_error = 0;  // a libav error held back while frames remain
  const char* held_what = nullptr;
  bool export_mvs = false;
  int threads = 0;
  std::vector<uint8_t> extradata;
  AVCodecID codec_id = AV_CODEC_ID_NONE;

  ~Decoder() { teardown(); }

  void teardown() {
    for (auto* f : ready) av_frame_free(&f);
    ready.clear();
    if (current) av_frame_free(&current);
    if (avctx) avcodec_free_context(&avctx);
  }

  int open(AVCodecID cid, const uint8_t* extra, size_t extra_size,
           int n_threads, bool want_mvs) {
    codec_id = cid;
    threads = n_threads;
    export_mvs = want_mvs;
    extradata.assign(extra, extra + extra_size);
    return reopen();
  }

  /* (Re)create the codec context. Called at open and on error recovery —
   * the host analog of the reference's decoder re-creation on HW error
   * (PyNvDecoder.cpp:590-615). */
  int reopen() {
    teardown();
    codec = avcodec_find_decoder(codec_id);
    if (!codec) return vpf_set_error(VPF_ERR, "no decoder for codec id %d", codec_id);
    avctx = avcodec_alloc_context3(codec);
    if (!avctx) return vpf_set_error(VPF_ERR, "avcodec_alloc_context3 failed");
    if (!extradata.empty()) {
      avctx->extradata =
          (uint8_t*)av_mallocz(extradata.size() + AV_INPUT_BUFFER_PADDING_SIZE);
      memcpy(avctx->extradata, extradata.data(), extradata.size());
      avctx->extradata_size = (int)extradata.size();
    }
    avctx->thread_count = threads;  // 0 = auto
    avctx->thread_type = FF_THREAD_FRAME | FF_THREAD_SLICE;
    if (export_mvs) avctx->flags2 |= AV_CODEC_FLAG2_EXPORT_MVS;
    int ret;
    {
      VpfSchedPolicyGuard sched_guard;  // SVT-AV1 et al. leak SCHED_FIFO
      ret = avcodec_open2(avctx, codec, nullptr);
    }
    if (ret < 0) return vpf_set_av_error(VPF_ERR, "avcodec_open2", ret);
    eos_sent = false;
    held_error = 0;
    return VPF_OK;
  }

  void hold_error(const char* what, int ret) {
    if (held_error) return;
    held_error = ret;
    held_what = what;
  }

  int drain_ready() {
    for (;;) {
      AVFrame* f = av_frame_alloc();
      int ret = avcodec_receive_frame(avctx, f);
      if (ret == AVERROR(EAGAIN) || ret == AVERROR_EOF) {
        av_frame_free(&f);
        return ret == AVERROR_EOF ? VPF_ERR_EOF : VPF_NEED_MORE;
      }
      if (ret < 0) {
        av_frame_free(&f);
        hold_error("avcodec_receive_frame", ret);
        return VPF_ERR_DECODE;
      }
      ready.push_back(f);
    }
  }

  /* Feed one packet (data==nullptr → begin EOS flush); returns VPF_OK if a
   * frame is available for pickup.
   *
   * With frame threading libav reports a bad packet's error late, at the
   * EOS send, while frames of the clean packets decoded after it are still
   * queued in the worker threads. A failed EOS send or receive is therefore
   * held back: the frames still in the session come out first, and the
   * error is reported (VPF_ERR_DECODE) only by a call that finds none, so
   * the caller's recovery (a re-create) drops no frame. */
  int decode(const uint8_t* data, size_t size, const VpfPacketData* in_pkt) {
    int ret;
    if (!data || !size) {
      if (!eos_sent) {
        ret = avcodec_send_packet(avctx, nullptr);
        eos_sent = true;
        if (ret < 0 && ret != AVERROR_EOF) hold_error("send EOS", ret);
      }
    } else {
      AVPacket* pkt = av_packet_alloc();
      // decoder does not modify input; wrap without copy
      av_packet_from_data(pkt, (uint8_t*)av_malloc(size + AV_INPUT_BUFFER_PADDING_SIZE), (int)size);
      memcpy(pkt->data, data, size);
      memset(pkt->data + size, 0, AV_INPUT_BUFFER_PADDING_SIZE);
      if (in_pkt) {
        pkt->pts = in_pkt->pts;
        pkt->dts = in_pkt->dts;
        pkt->pos = (int64_t)in_pkt->pos;
        pkt->duration = (int64_t)in_pkt->duration;
        if (in_pkt->key) pkt->flags |= AV_PKT_FLAG_KEY;
      }
      ret = avcodec_send_packet(avctx, pkt);
      if (ret == AVERROR(EAGAIN)) {
        // internal queue full: drain pending frames, then retry the send
        drain_ready();
        ret = avcodec_send_packet(avctx, pkt);
      }
      av_packet_free(&pkt);
      if (ret == AVERROR_INVALIDDATA)
        return vpf_set_av_error(VPF_ERR_PARSE, "avcodec_send_packet", ret);
      if (ret < 0 && ret != AVERROR(EAGAIN) && ret != AVERROR_EOF)
        return vpf_set_av_error(VPF_ERR_DECODE, "avcodec_send_packet", ret);
    }
    int r = drain_ready();
    if (!ready.empty()) return take_frame();
    if (held_error) {
      ret = held_error;
      held_error = 0;
      return vpf_set_av_error(VPF_ERR_DECODE, held_what, ret);
    }
    return r == VPF_ERR_EOF ? VPF_ERR_EOF : VPF_NEED_MORE;
  }

  int take_frame() {
    if (ready.empty()) return VPF_NEED_MORE;
    if (current) av_frame_free(&current);
    current = ready.front();
    ready.pop_front();
    collect_mvs();
    return VPF_OK;
  }

  void collect_mvs() {
    mvs.clear();
    if (!export_mvs || !current) return;
    AVFrameSideData* sd =
        av_frame_get_side_data(current, AV_FRAME_DATA_MOTION_VECTORS);
    if (!sd) return;
    size_t n = sd->size / sizeof(AVMotionVector);
    const AVMotionVector* src = (const AVMotionVector*)sd->data;
    mvs.resize(n);
    for (size_t i = 0; i < n; i++) {
      mvs[i] = {src[i].source, src[i].w,        src[i].h,
                src[i].src_x,  src[i].src_y,    src[i].dst_x,
                src[i].dst_y,  src[i].flags,    src[i].motion_x,
                src[i].motion_y, src[i].motion_scale};
    }
  }

  void describe(VpfFrameDesc* out) const {
    memset(out, 0, sizeof(*out));
    if (!current) return;
    out->width = current->width;
    out->height = current->height;
    out->pixel_format = vpf_fmt_from_av((AVPixelFormat)current->format);
    out->color_space = vpf_cs_from_av(current->colorspace);
    out->color_range = vpf_cr_from_av(current->color_range);
    out->pkt.pts = current->pts;
    out->pkt.dts = current->pkt_dts;
    out->pkt.key = VPF_FRAME_IS_KEY(current);
    out->pkt.duration = (uint64_t)VPF_FRAME_DURATION(current);
    out->pkt.pos = 0;
    out->pkt.bsl = 0;
    out->frame_size = packed_size(out->pixel_format);
  }

  uint64_t packed_size(int fmt) const {
    uint64_t w = current->width, h = current->height;
    switch (fmt) {
      case VPF_FMT_NV12:
      case VPF_FMT_YUV420: return w * h * 3 / 2;
      case VPF_FMT_YUV422: return w * h * 2;
      case VPF_FMT_YUV444: return w * h * 3;
      case VPF_FMT_Y: return w * h;
      case VPF_FMT_GRAY12: return w * h * 2;
      case VPF_FMT_P10:
      case VPF_FMT_P12:
      case VPF_FMT_YUV420_10BIT: return w * h * 3;  // 16-bit container
      case VPF_FMT_YUV444_10BIT: return w * h * 6;
      default: return 0;
    }
  }

  /* Pack `current` into dst in the requested layout. */
  /* YUV420 frame → three caller-provided plane buffers (used by the
   * plane-major pool ring so batched y/u/v regions stay contiguous
   * across frames — the consumer can hand them to the device runtime
   * with ZERO host re-copies; strided per-frame views would each cost a
   * full staging copy). expected_luma_bytes validates slot geometry the
   * same way copy_packed's dst_size does. */
  int copy_planar3(uint8_t* dy, uint8_t* du, uint8_t* dv,
                   size_t expected_luma_bytes) {
    if (!current) return vpf_set_error(VPF_ERR, "no decoded frame to copy");
    const AVPixelFormat src_fmt = (AVPixelFormat)current->format;
    if (src_fmt != AV_PIX_FMT_YUV420P && src_fmt != AV_PIX_FMT_YUVJ420P)
      return vpf_set_error(VPF_ERR, "planar3 pack needs yuv420p, got %d",
                           (int)src_fmt);
    const int w = current->width, h = current->height;
    if ((size_t)w * h != expected_luma_bytes)
      return vpf_set_error(VPF_ERR, "planar3 geometry mismatch: %dx%d", w, h);
    if ((w | h) & 1)
      /* ffmpeg ceil-divides chroma dims for odd yuv420p frames; the
       * truncating cw/ch below would silently copy a misaligned chroma
       * grid, so reject odd geometry outright. */
      return vpf_set_error(VPF_ERR,
                           "planar3 pack needs even dimensions, got %dx%d", w,
                           h);
    const int cw = w / 2, ch = h / 2;
    auto copy_plane = [&](const uint8_t* src, int pitch, int rows,
                          int row_bytes, uint8_t* out) {
      for (int r = 0; r < rows; r++)
        memcpy(out + (size_t)r * row_bytes, src + (size_t)r * pitch,
               row_bytes);
    };
    copy_plane(current->data[0], current->linesize[0], h, w, dy);
    copy_plane(current->data[1], current->linesize[1], ch, cw, du);
    copy_plane(current->data[2], current->linesize[2], ch, cw, dv);
    return VPF_OK;
  }

  int copy_packed(int fmt, uint8_t* dst, size_t dst_size) {
    if (!current) return vpf_set_error(VPF_ERR, "no decoded frame to copy");
    const uint64_t need = packed_size(fmt);
    if (!need) return vpf_set_error(VPF_ERR, "unsupported pack format %d", fmt);
    if (dst_size < need)
      return vpf_set_error(VPF_ERR, "dst too small: %zu < %llu", dst_size,
                           (unsigned long long)need);
    const int w = current->width, h = current->height;
    const AVPixelFormat src_fmt = (AVPixelFormat)current->format;
    const int cw = w / 2, ch = h / 2;

    auto copy_plane = [&](const uint8_t* src, int pitch, int rows,
                          int row_bytes, uint8_t* out) {
      for (int r = 0; r < rows; r++)
        memcpy(out + (size_t)r * row_bytes, src + (size_t)r * pitch,
               row_bytes);
    };

    bool src420_8 =
        src_fmt == AV_PIX_FMT_YUV420P || src_fmt == AV_PIX_FMT_YUVJ420P;

    if (fmt == VPF_FMT_NV12 && src420_8) {
      copy_plane(current->data[0], current->linesize[0], h, w, dst);
      uint8_t* uv = dst + (size_t)w * h;
      const uint8_t* up = current->data[1];
      const uint8_t* vp = current->data[2];
      const int lu = current->linesize[1], lv = current->linesize[2];
      for (int r = 0; r < ch; r++) {
        const uint8_t* urow = up + (size_t)r * lu;
        const uint8_t* vrow = vp + (size_t)r * lv;
        uint8_t* orow = uv + (size_t)r * w;
        for (int c = 0; c < cw; c++) {
          orow[2 * c] = urow[c];
          orow[2 * c + 1] = vrow[c];
        }
      }
      return VPF_OK;
    }
    if (fmt == VPF_FMT_NV12 && src_fmt == AV_PIX_FMT_NV12) {
      copy_plane(current->data[0], current->linesize[0], h, w, dst);
      copy_plane(current->data[1], current->linesize[1], ch, w,
                 dst + (size_t)w * h);
      return VPF_OK;
    }
    if (fmt == VPF_FMT_YUV420 && src420_8) {
      copy_plane(current->data[0], current->linesize[0], h, w, dst);
      copy_plane(current->data[1], current->linesize[1], ch, cw,
                 dst + (size_t)w * h);
      copy_plane(current->data[2], current->linesize[2], ch, cw,
                 dst + (size_t)w * h + (size_t)cw * ch);
      return VPF_OK;
    }
    if (fmt == VPF_FMT_Y) {
      copy_plane(current->data[0], current->linesize[0], h, w, dst);
      return VPF_OK;
    }
    if (fmt == VPF_FMT_GRAY12 && src_fmt == AV_PIX_FMT_GRAY12) {
      // gray12le (LSB) → MSB-aligned 16-bit, mirroring the P1x convention
      uint16_t* out = (uint16_t*)dst;
      for (int r = 0; r < h; r++) {
        const uint16_t* srow =
            (const uint16_t*)(current->data[0] + (size_t)r * current->linesize[0]);
        for (int c = 0; c < w; c++) out[(size_t)r * w + c] = srow[c] << 4;
      }
      return VPF_OK;
    }
    if (fmt == VPF_FMT_YUV422 &&
        (src_fmt == AV_PIX_FMT_YUV422P || src_fmt == AV_PIX_FMT_YUVJ422P)) {
      copy_plane(current->data[0], current->linesize[0], h, w, dst);
      copy_plane(current->data[1], current->linesize[1], h, cw,
                 dst + (size_t)w * h);
      copy_plane(current->data[2], current->linesize[2], h, cw,
                 dst + (size_t)w * h + (size_t)cw * h);
      return VPF_OK;
    }
    if (fmt == VPF_FMT_YUV444 &&
        (src_fmt == AV_PIX_FMT_YUV444P || src_fmt == AV_PIX_FMT_YUVJ444P)) {
      for (int p = 0; p < 3; p++)
        copy_plane(current->data[p], current->linesize[p], h, w,
                   dst + (size_t)p * w * h);
      return VPF_OK;
    }
    if (fmt == VPF_FMT_YUV444_10BIT &&
        (src_fmt == AV_PIX_FMT_YUV444P10 || src_fmt == AV_PIX_FMT_YUV444P12)) {
      // 10/12-bit planar 4:4:4 -> MSB-aligned 16-bit planar (P1x convention)
      const int shift = src_fmt == AV_PIX_FMT_YUV444P10 ? 6 : 4;
      for (int p = 0; p < 3; p++) {
        uint16_t* out = (uint16_t*)dst + (size_t)p * w * h;
        for (int r = 0; r < h; r++) {
          const uint16_t* srow =
              (const uint16_t*)(current->data[p] +
                                (size_t)r * current->linesize[p]);
          for (int c = 0; c < w; c++) out[(size_t)r * w + c] = srow[c] << shift;
        }
      }
      return VPF_OK;
    }
    if ((fmt == VPF_FMT_P10 || fmt == VPF_FMT_P12)) {
      // 10/12-bit planar 4:2:0 → MSB-aligned 16-bit NV12-layout (P010/P012)
      int depth = src_fmt == AV_PIX_FMT_YUV420P10 ? 10
                  : src_fmt == AV_PIX_FMT_YUV420P12 ? 12
                                                    : 0;
      if (src_fmt == AV_PIX_FMT_P010) {
        copy_plane(current->data[0], current->linesize[0], h, w * 2, dst);
        copy_plane(current->data[1], current->linesize[1], ch, w * 2,
                   dst + (size_t)w * h * 2);
        return VPF_OK;
      }
      if (!depth)
        return vpf_set_error(VPF_ERR, "can't pack %s as P1x",
                             av_get_pix_fmt_name(src_fmt));
      const int shift = 16 - depth;
      uint16_t* out_y = (uint16_t*)dst;
      for (int r = 0; r < h; r++) {
        const uint16_t* srow =
            (const uint16_t*)(current->data[0] + (size_t)r * current->linesize[0]);
        for (int c = 0; c < w; c++) out_y[(size_t)r * w + c] = srow[c] << shift;
      }
      uint16_t* out_uv = (uint16_t*)(dst + (size_t)w * h * 2);
      for (int r = 0; r < ch; r++) {
        const uint16_t* urow =
            (const uint16_t*)(current->data[1] + (size_t)r * current->linesize[1]);
        const uint16_t* vrow =
            (const uint16_t*)(current->data[2] + (size_t)r * current->linesize[2]);
        for (int c = 0; c < cw; c++) {
          out_uv[(size_t)r * w + 2 * c] = urow[c] << shift;
          out_uv[(size_t)r * w + 2 * c + 1] = vrow[c] << shift;
        }
      }
      return VPF_OK;
    }
    return vpf_set_error(VPF_ERR, "unsupported pack: %s -> fmt %d",
                         av_get_pix_fmt_name(src_fmt), fmt);
  }
};

}  // namespace

VPF_API void* vpf_decoder_create(int codec_id, const uint8_t* extradata,
                                 size_t extradata_size, int n_threads,
                                 int export_mvs) {
  auto* d = new Decoder();
  AVCodecID cid = vpf_codec_to_av(codec_id);
  if (cid == AV_CODEC_ID_NONE) {
    vpf_set_error(VPF_ERR, "unknown codec id %d", codec_id);
    delete d;
    return nullptr;
  }
  if (d->open(cid, extradata ? extradata : (const uint8_t*)"",
              extradata ? extradata_size : 0, n_threads,
              export_mvs != 0) != VPF_OK) {
    delete d;
    return nullptr;
  }
  return d;
}

VPF_API void vpf_decoder_destroy(void* h) { delete static_cast<Decoder*>(h); }

VPF_API int vpf_decoder_decode(void* h, const uint8_t* data, size_t size,
                               const VpfPacketData* pkt) {
  return static_cast<Decoder*>(h)->decode(data, size, pkt);
}

/* Drain one frame during EOS flush. VPF_OK = got frame, VPF_NEED_MORE /
 * VPF_ERR_EOF = empty. */
VPF_API int vpf_decoder_flush_frame(void* h) {
  auto* d = static_cast<Decoder*>(h);
  if (!d->ready.empty()) return d->take_frame();
  int r = d->decode(nullptr, 0, nullptr);
  return r;
}

/* Discard codec state without EOS — the reference's `no_eos` flush used by
 * seek (NvDecoder.h:31-33, PyNvDecoder.cpp:506-518). */
VPF_API void vpf_decoder_reset(void* h) {
  auto* d = static_cast<Decoder*>(h);
  for (auto* f : d->ready) av_frame_free(&f);
  d->ready.clear();
  avcodec_flush_buffers(d->avctx);
  d->eos_sent = false;
  d->held_error = 0;
}

/* Full re-create after VPF_ERR_DECODE (HwReset analog). */
VPF_API int vpf_decoder_recreate(void* h) {
  return static_cast<Decoder*>(h)->reopen();
}

VPF_API int vpf_decoder_frame_desc(void* h, VpfFrameDesc* out) {
  auto* d = static_cast<Decoder*>(h);
  if (!d->current) return vpf_set_error(VPF_ERR, "no decoded frame");
  d->describe(out);
  return VPF_OK;
}

VPF_API int vpf_decoder_copy_frame(void* h, int fmt, uint8_t* dst,
                                   size_t dst_size) {
  return static_cast<Decoder*>(h)->copy_packed(fmt, dst, dst_size);
}

VPF_API int vpf_decoder_copy_frame_planar3(void* h, uint8_t* dy,
                                           uint8_t* du, uint8_t* dv,
                                           size_t expected_luma_bytes) {
  return static_cast<Decoder*>(h)->copy_planar3(dy, du, dv,
                                                expected_luma_bytes);
}

VPF_API int vpf_decoder_motion_vectors(void* h, VpfMotionVector* dst,
                                       size_t max_count, size_t* count) {
  auto* d = static_cast<Decoder*>(h);
  *count = d->mvs.size();
  if (!dst || !max_count) return VPF_OK;  // size query
  size_t n = std::min(max_count, d->mvs.size());
  memcpy(dst, d->mvs.data(), n * sizeof(VpfMotionVector));
  return VPF_OK;
}

/* ---- real codec capability query (see VpfCodecCaps in common.hpp) ---- */

namespace {

/* Spec-level dimension limits per codec (the SW analog of the cuvid
 * nMaxWidth/nMaxHeight caps; H.264 L6.2 / HEVC L6.2 / VP8 / VP9 / AV1 /
 * MPEG-2 / MPEG-4 / MJPEG spec maxima). */
void spec_dims(AVCodecID id, VpfCodecCaps* c) {
  switch (id) {
    case AV_CODEC_ID_H264: c->max_width = 8192; c->max_height = 4320; break;
    case AV_CODEC_ID_HEVC: c->max_width = 8444; c->max_height = 4802; break;
    case AV_CODEC_ID_VP8: c->max_width = 16383; c->max_height = 16383; break;
    case AV_CODEC_ID_VP9: c->max_width = 65536; c->max_height = 65536; break;
    case AV_CODEC_ID_AV1: c->max_width = 65536; c->max_height = 36864; break;
    case AV_CODEC_ID_MPEG2VIDEO: c->max_width = 4096; c->max_height = 4096; break;
    case AV_CODEC_ID_MPEG4: c->max_width = 8192; c->max_height = 8192; break;
    default: c->max_width = 16384; c->max_height = 16384; break;
  }
  c->min_width = 16;
  c->min_height = 16;
}

int pix_fmt_luma_depth(AVPixelFormat f) {
  const AVPixFmtDescriptor* d = av_pix_fmt_desc_get(f);
  return d ? d->comp[0].depth : 0;
}

}  // namespace

VPF_API int vpf_codec_caps(int codec_id, int is_encoder, VpfCodecCaps* out) {
  memset(out, 0, sizeof(*out));
  AVCodecID cid = vpf_codec_to_av(codec_id);
  if (cid == AV_CODEC_ID_NONE)
    return vpf_set_error(VPF_ERR, "unknown codec id %d", codec_id);
  const AVCodec* c =
      is_encoder ? avcodec_find_encoder(cid) : avcodec_find_decoder(cid);
  if (!c) {
    out->is_supported = 0;
    return VPF_OK;
  }
  out->is_supported = 1;
  spec_dims(cid, out);
  out->supports_reordered_output =
      (c->capabilities & AV_CODEC_CAP_DELAY) ? 1 : 0;

  if (is_encoder) {
    // bit depth from the encoder's actual pix_fmt list (e.g. libx265
    // only lists yuv420p10 when built HIGH_BIT_DEPTH)
    int maxd = 0;
    if (c->pix_fmts)
      for (const AVPixelFormat* p = c->pix_fmts; *p != AV_PIX_FMT_NONE; p++)
        maxd = std::max(maxd, pix_fmt_luma_depth(*p));
    if (!maxd) maxd = 8;
    out->max_bit_depth = maxd;
    out->supports_10bit = maxd >= 10 ? 1 : 0;
    // lookahead: does the encoder expose an rc-lookahead private option?
    if (c->priv_class) {
      void* fake = (void*)&c->priv_class;  // FAKE_OBJ: ptr-to-class, unmodified
      if (av_opt_find(fake, "rc-lookahead", nullptr, 0,
                      AV_OPT_SEARCH_FAKE_OBJ) ||
          av_opt_find(fake, "lag-in-frames", nullptr, 0,
                      AV_OPT_SEARCH_FAKE_OBJ))
        out->supports_lookahead = 1;
    }
    // B-frames: spec property of the codec, via its descriptor
    const AVCodecDescriptor* desc = avcodec_descriptor_get(cid);
    bool reorder = desc && (desc->props & AV_CODEC_PROP_REORDER);
    out->max_bframes =
        reorder && cid != AV_CODEC_ID_VP9 && cid != AV_CODEC_ID_VP8 ? 16 : 0;
  } else {
    // decoder depth support per codec spec (SW decode has no HW caps
    // table; these are the profiles libav's decoders implement)
    switch (cid) {
      case AV_CODEC_ID_HEVC: out->max_bit_depth = 12; break;
      case AV_CODEC_ID_VP9: out->max_bit_depth = 12; break;
      case AV_CODEC_ID_AV1: out->max_bit_depth = 10; break;
      case AV_CODEC_ID_H264: out->max_bit_depth = 10; break;
      case AV_CODEC_ID_MJPEG: out->max_bit_depth = 12; break;
      default: out->max_bit_depth = 8; break;
    }
    out->supports_10bit = out->max_bit_depth >= 10 ? 1 : 0;
  }
  return VPF_OK;
}

/* Sequential clip read, fully native: demux → decode → pack `n_want`
 * frames into dst (stride-aware) without a Python round trip per frame.
 * The per-frame ctypes path costs ~1.7 ms/frame of pure interpreter
 * overhead at 1080p (measured r5: VideoClipLoader decode stage
 * 4.1 ms/frame vs the C++ pool's 2.4); clip loaders call this for the
 * sequential body of every clip.
 *
 * `skip_first` frames are decoded and discarded before the first kept
 * frame; after each kept frame, (stride-1) more are discarded. Uses the
 * same Decoder/Demuxer handles and primitives as the Python path, so
 * interleaving with per-frame Python calls (e.g. the seek priming loop)
 * stays consistent. Returns frames KEPT (>= 0; < n_want means EOF), or
 * a negative VPF_ERR_* code. */
extern "C" VPF_API int vpf_demuxer_demux(void*, const uint8_t**, size_t*,
                                         VpfPacketData*, const uint8_t**,
                                         size_t*);

VPF_API long vpf_read_frames_seq(void* dmx_h, void* dec_h, int fmt,
                                 uint8_t* dst, size_t frame_bytes,
                                 long n_want, long stride,
                                 long skip_first) {
  auto* d = static_cast<Decoder*>(dec_h);
  if (!dmx_h || !d || !dst || n_want < 0 || stride < 1 || skip_first < 0)
    return (long)vpf_set_error(VPF_ERR, "vpf_read_frames_seq: bad args");
  long kept = 0;
  long until_keep = skip_first;  // frames to discard before next keep
  bool demux_eof = false;
  while (kept < n_want) {
    if (!d->ready.empty()) {
      d->take_frame();  // buffered frame from an earlier packet
    } else {
      int r;
      if (!demux_eof) {
        const uint8_t* data = nullptr;
        size_t size = 0;
        VpfPacketData pkt{};
        r = vpf_demuxer_demux(dmx_h, &data, &size, &pkt, nullptr, nullptr);
        if (r == VPF_NEED_MORE || r == VPF_ERR_EOF) {
          // the demuxer signals EOF as NEED_MORE (demuxer.py returns
          // None on it) — switch to the decoder EOS drain
          demux_eof = true;
          continue;
        }
        if (r != VPF_OK) return (long)r;
        r = d->decode(data, size, &pkt);
      } else {
        r = d->decode(nullptr, 0, nullptr);  // EOS drain
      }
      if (r == VPF_NEED_MORE) continue;
      if (r == VPF_ERR_EOF) break;  // fully drained before n_want
      if (r != VPF_OK) return (long)r;
    }
    if (until_keep > 0) {
      until_keep--;
      continue;
    }
    int cr = d->copy_packed(fmt, dst + (size_t)kept * frame_bytes,
                            frame_bytes);
    if (cr != VPF_OK) return (long)cr;
    kept++;
    until_keep = stride - 1;
  }
  return kept;
}
