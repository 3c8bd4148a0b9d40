/* Demuxer: libavformat-backed container demux with Annex.B + SEI bitstream
 * filtering and frame/timestamp seek.
 *
 * Behavioral parity target: the reference's FFmpegDemuxer
 * (src/TC/src/FFmpegDemuxer.cpp:101-233 demux, 259-388 seek, 470-588 props).
 * Independent implementation over the public libav API.
 *
 * Threading: one handle = one stream; handles are independent. All calls on
 * a handle must come from one thread at a time (same contract as the
 * reference). Python drives this via ctypes, which releases the GIL, so
 * N demuxers on N threads scale.
 */

#include "common.hpp"

#include <algorithm>
#include <cmath>
#include <vector>

VPF_API const char* vpf_last_error(void) { return vpf_error_slot().c_str(); }

VPF_API void vpf_set_av_log_level(int level) { av_log_set_level(level); }

namespace {
/* Default to errors-only so per-session encoder/decoder info chatter stays
 * out of pipeline stdout; override with vpf_set_av_log_level(). */
struct LogInit {
  LogInit() { av_log_set_level(AV_LOG_ERROR); }
} log_init;
}  // namespace

namespace {

struct Demuxer {
  AVFormatContext* fmtc = nullptr;
  AVIOContext* avio = nullptr;  // owned when reading via callback
  int video_stream = -1;
  AVBSFContext* bsf_annexb = nullptr;  // h264/hevc mp4->annexb
  AVBSFContext* bsf_sei = nullptr;     // lazy: filter_units pass SEI NALs
  AVPacket* pkt_src = nullptr;
  AVPacket* pkt_flt = nullptr;
  AVPacket* pkt_sei = nullptr;
  std::vector<uint8_t> annexb_bytes;
  std::vector<uint8_t> sei_bytes;
  VpfPacketData last_pkt = {};
  bool is_h264 = false, is_hevc = false;
  bool is_seekable = false;

  // user read callback plumbing
  int (*read_cb)(void*, uint8_t*, int) = nullptr;
  void* read_opaque = nullptr;

  ~Demuxer() {
    if (bsf_annexb) av_bsf_free(&bsf_annexb);
    if (bsf_sei) av_bsf_free(&bsf_sei);
    if (pkt_src) av_packet_free(&pkt_src);
    if (pkt_flt) av_packet_free(&pkt_flt);
    if (pkt_sei) av_packet_free(&pkt_sei);
    if (fmtc) avformat_close_input(&fmtc);
    if (avio) {
      av_freep(&avio->buffer);
      avio_context_free(&avio);
    }
  }

  AVStream* vs() const { return fmtc->streams[video_stream]; }

  double framerate() const {
    auto r = vs()->r_frame_rate;
    return r.den ? (double)r.num / r.den : 0.0;
  }
  double avg_framerate() const {
    auto r = vs()->avg_frame_rate;
    return r.den ? (double)r.num / r.den : 0.0;
  }
  double timebase() const {
    auto r = vs()->time_base;
    return r.den ? (double)r.num / r.den : 0.0;
  }

  int64_t ts_from_time(double sec) const {
    int64_t tbu = llround(sec * AV_TIME_BASE);
    AVRational q{1, AV_TIME_BASE};
    return av_rescale_q(tbu, q, vs()->time_base);
  }
  int64_t ts_from_frame(int64_t n) const {
    return ts_from_time((double)n / framerate());
  }

  int init(AVFormatContext* ctx) {
    fmtc = ctx;
    int ret = avformat_find_stream_info(fmtc, nullptr);
    if (ret < 0) return vpf_set_av_error(VPF_ERR, "find_stream_info", ret);
    video_stream =
        av_find_best_stream(fmtc, AVMEDIA_TYPE_VIDEO, -1, -1, nullptr, 0);
    if (video_stream < 0)
      return vpf_set_error(VPF_ERR, "no video stream in input");

    AVCodecID cid = vs()->codecpar->codec_id;
    is_h264 = cid == AV_CODEC_ID_H264;
    is_hevc = cid == AV_CODEC_ID_HEVC;

    pkt_src = av_packet_alloc();
    pkt_flt = av_packet_alloc();
    pkt_sei = av_packet_alloc();

    if (is_h264 || is_hevc) {
      const char* name = is_h264 ? "h264_mp4toannexb" : "hevc_mp4toannexb";
      const AVBitStreamFilter* f = av_bsf_get_by_name(name);
      if (!f) return vpf_set_error(VPF_ERR, "bsf %s unavailable", name);
      ret = av_bsf_alloc(f, &bsf_annexb);
      if (ret < 0) return vpf_set_av_error(VPF_ERR, "bsf_alloc", ret);
      ret = avcodec_parameters_copy(bsf_annexb->par_in, vs()->codecpar);
      if (ret < 0) return vpf_set_av_error(VPF_ERR, "parameters_copy", ret);
      bsf_annexb->time_base_in = vs()->time_base;
      ret = av_bsf_init(bsf_annexb);
      if (ret < 0) return vpf_set_av_error(VPF_ERR, "bsf_init annexb", ret);
    }

    is_seekable = fmtc->iformat &&
                  (fmtc->iformat->read_seek || fmtc->iformat->read_seek2);
    return VPF_OK;
  }

  int ensure_sei_bsf() {
    if (bsf_sei) return VPF_OK;
    /* SEI NAL types: 6 for H.264, 39-40 for H.265
     * (same filter_units recipe as the reference). */
    const char* spec = is_h264   ? "filter_units=pass_types=6"
                       : is_hevc ? "filter_units=pass_types=39-40"
                                 : nullptr;
    if (!spec)
      return vpf_set_error(VPF_ERR, "SEI extraction unsupported for codec");
    int ret = av_bsf_list_parse_str(spec, &bsf_sei);
    if (ret < 0) return vpf_set_av_error(VPF_ERR, "sei bsf parse", ret);
    ret = avcodec_parameters_copy(bsf_sei->par_in, vs()->codecpar);
    if (ret < 0) return vpf_set_av_error(VPF_ERR, "parameters_copy", ret);
    bsf_sei->time_base_in = vs()->time_base;
    ret = av_bsf_init(bsf_sei);
    if (ret < 0) return vpf_set_av_error(VPF_ERR, "sei bsf init", ret);
    return VPF_OK;
  }

  /* Read the next video packet; apply annexb (and optionally SEI) BSFs.
   * Returns VPF_OK, VPF_NEED_MORE on EOF, or error. */
  int demux(bool want_sei) {
    annexb_bytes.clear();
    sei_bytes.clear();
    av_packet_unref(pkt_src);

    int ret;
    for (;;) {
      ret = av_read_frame(fmtc, pkt_src);
      if (ret < 0) {
        if (ret == AVERROR_EOF) return VPF_NEED_MORE;
        return vpf_set_av_error(VPF_ERR, "av_read_frame", ret);
      }
      if (pkt_src->stream_index == video_stream) break;
      av_packet_unref(pkt_src);
    }

    if (want_sei) {
      int r = ensure_sei_bsf();
      if (r != VPF_OK) return r;
      AVPacket* copy = av_packet_clone(pkt_src);
      if (copy) {
        av_packet_unref(pkt_sei);
        if (av_bsf_send_packet(bsf_sei, copy) >= 0) {
          if (av_bsf_receive_packet(bsf_sei, pkt_sei) >= 0 && pkt_sei->size)
            sei_bytes.assign(pkt_sei->data, pkt_sei->data + pkt_sei->size);
        }
        av_packet_free(&copy);
      }
    }

    const AVPacket* out = pkt_src;
    if (bsf_annexb) {
      av_packet_unref(pkt_flt);
      // send_packet moves the reference out of pkt_src; that's fine, we're
      // done with the raw packet once the filtered one exists.
      ret = av_bsf_send_packet(bsf_annexb, pkt_src);
      if (ret < 0) return vpf_set_av_error(VPF_ERR_PARSE, "annexb send", ret);
      ret = av_bsf_receive_packet(bsf_annexb, pkt_flt);
      if (ret < 0) return vpf_set_av_error(VPF_ERR_PARSE, "annexb recv", ret);
      out = pkt_flt;
    }

    annexb_bytes.assign(out->data, out->data + out->size);
    last_pkt.key = (out->flags & AV_PKT_FLAG_KEY) ? 1 : 0;
    last_pkt.pts = out->pts;
    last_pkt.dts = out->dts;
    last_pkt.pos = (uint64_t)out->pos;
    last_pkt.bsl = annexb_bytes.size();
    last_pkt.duration = (uint64_t)out->duration;
    return VPF_OK;
  }

  int seek_raw(int64_t target_ts, int flags) {
    bool backward = last_pkt.dts > target_ts;
    int ret = av_seek_frame(fmtc, video_stream, target_ts,
                            backward ? (AVSEEK_FLAG_BACKWARD | flags) : flags);
    if (ret < 0) return vpf_set_av_error(VPF_ERR, "av_seek_frame", ret);
    return VPF_OK;
  }

  /* Reference seek contract (FFmpegDemuxer.cpp:259-388): DTS-based compare,
   * EXACT_FRAME = iterative re-seek until the target packet, PREV_KEY_FRAME
   * = one backward key-frame seek + demux. */
  int seek(int64_t frame_num, double tssec, int criteria, int mode,
           bool want_sei, int64_t* out_pts, int64_t* out_duration) {
    if (!is_seekable)
      return vpf_set_error(VPF_ERR, "Seek isn't supported for this input.");
    bool by_number = criteria == VPF_SEEK_BY_NUMBER;
    if (by_number && framerate() != avg_framerate())
      return vpf_set_error(
          VPF_ERR, "Can't seek by frame number in VFR sequences. Seek by "
                   "timestamp instead.");

    int64_t target_ts =
        by_number ? ts_from_frame(frame_num) : ts_from_time(tssec);

    if (mode == VPF_SEEK_PREV_KEY_FRAME) {
      int r = seek_raw(target_ts, AVSEEK_FLAG_BACKWARD);
      if (r != VPF_OK) return r;
      r = demux(want_sei);
      if (r != VPF_OK) return r == VPF_NEED_MORE ? VPF_ERR_EOF : r;
      // An index can call every sample a sync sample (an mp4 muxed without
      // key flags has no stss), so the backward seek lands on a packet the
      // decoder cannot start from, and past the last real keyframe nothing
      // decodes at all. The packet's own key flag (from the parser) tells:
      // step back one packet at a time to the key packet before it. With
      // no key packet before it, land where the index said.
      while (!last_pkt.key && last_pkt.dts != AV_NOPTS_VALUE) {
        int64_t landed = last_pkt.dts;
        r = seek_raw(landed - 1, AVSEEK_FLAG_BACKWARD);
        if (r != VPF_OK) return r;
        r = demux(want_sei);
        if (r != VPF_OK) return r == VPF_NEED_MORE ? VPF_ERR_EOF : r;
        if (last_pkt.dts == AV_NOPTS_VALUE || last_pkt.dts >= landed) {
          r = seek_raw(target_ts, AVSEEK_FLAG_BACKWARD);
          if (r != VPF_OK) return r;
          r = demux(want_sei);
          if (r != VPF_OK) return r == VPF_NEED_MORE ? VPF_ERR_EOF : r;
          break;
        }
      }
    } else {
      // EXACT_FRAME: seek (ANY) then demux forward comparing DTS; on
      // overshoot step the target back and re-seek.
      int64_t cur_frame = frame_num;
      double cur_sec = tssec;
      int r = seek_raw(target_ts, AVSEEK_FLAG_ANY);
      if (r != VPF_OK) return r;
      for (;;) {
        r = demux(want_sei);
        if (r == VPF_NEED_MORE) break;  // EOF: give up with last packet
        if (r != VPF_OK) return r;
        if (last_pkt.dts == target_ts) break;
        if (last_pkt.dts > target_ts) {
          if (by_number)
            cur_frame--;
          else
            cur_sec = std::max(0.0, cur_sec - timebase());
          int64_t ts = by_number ? ts_from_frame(cur_frame)
                                 : ts_from_time(cur_sec);
          r = seek_raw(ts, AVSEEK_FLAG_ANY);
          if (r != VPF_OK) return r;
        }
        // dts < target: keep demuxing forward
      }
    }
    if (out_pts) *out_pts = last_pkt.pts;
    if (out_duration) *out_duration = (int64_t)last_pkt.duration;
    return VPF_OK;
  }
};

int demuxer_read_shim(void* opaque, uint8_t* buf, int n) {
  auto* d = static_cast<Demuxer*>(opaque);
  int got = d->read_cb(d->read_opaque, buf, n);
  return got <= 0 ? AVERROR_EOF : got;
}

}  // namespace

VPF_API void* vpf_demuxer_open(const char* url, const char* const* opt_keys,
                               const char* const* opt_vals, int n_opts) {
  AVDictionary* opts = nullptr;
  for (int i = 0; i < n_opts; i++)
    av_dict_set(&opts, opt_keys[i], opt_vals[i], 0);

  AVFormatContext* ctx = nullptr;
  int ret = avformat_open_input(&ctx, url, nullptr, &opts);
  av_dict_free(&opts);
  if (ret < 0 || !ctx) {
    vpf_set_av_error(VPF_ERR, "avformat_open_input", ret);
    return nullptr;
  }
  auto* d = new Demuxer();
  if (d->init(ctx) != VPF_OK) {
    delete d;
    return nullptr;
  }
  return d;
}

/* Open from a user read callback (DataProvider / istream analog,
 * reference: FFmpegDemuxer.cpp:430-444, 8 MB AVIO buffer). */
VPF_API void* vpf_demuxer_open_reader(int (*cb)(void*, uint8_t*, int),
                                      void* opaque) {
  auto* d = new Demuxer();
  d->read_cb = cb;
  d->read_opaque = opaque;

  constexpr size_t kBufSize = 8 * 1024 * 1024;
  uint8_t* buf = (uint8_t*)av_malloc(kBufSize);
  d->avio = avio_alloc_context(buf, kBufSize, 0, d, demuxer_read_shim,
                               nullptr, nullptr);
  AVFormatContext* ctx = avformat_alloc_context();
  ctx->pb = d->avio;
  int ret = avformat_open_input(&ctx, nullptr, nullptr, nullptr);
  if (ret < 0) {
    vpf_set_av_error(VPF_ERR, "avformat_open_input(reader)", ret);
    delete d;
    return nullptr;
  }
  if (d->init(ctx) != VPF_OK) {
    delete d;
    return nullptr;
  }
  return d;
}

VPF_API void vpf_demuxer_close(void* h) { delete static_cast<Demuxer*>(h); }

VPF_API int vpf_demuxer_get_props(void* h, VpfStreamProps* out) {
  auto* d = static_cast<Demuxer*>(h);
  AVStream* st = d->vs();
  const AVCodecParameters* par = st->codecpar;
  memset(out, 0, sizeof(*out));
  out->width = par->width;
  out->height = par->height;
  out->num_frames = st->nb_frames;
  out->frame_rate = d->framerate();
  out->avg_frame_rate = d->avg_framerate();
  out->is_vfr = out->frame_rate != out->avg_frame_rate;
  out->time_base = d->timebase();
  out->stream_index = d->video_stream;
  out->codec = vpf_codec_from_av(par->codec_id);
  out->pixel_format = vpf_fmt_from_av((AVPixelFormat)par->format);
  out->color_space = vpf_cs_from_av(par->color_space);
  out->color_range = vpf_cr_from_av(par->color_range);
  out->start_time = st->start_time;
  const AVPixFmtDescriptor* desc =
      av_pix_fmt_desc_get((AVPixelFormat)par->format);
  out->bit_depth = desc ? desc->comp[0].depth : 8;
  return VPF_OK;
}

VPF_API int vpf_demuxer_demux(void* h, const uint8_t** data, size_t* size,
                              VpfPacketData* pkt, const uint8_t** sei,
                              size_t* sei_size) {
  auto* d = static_cast<Demuxer*>(h);
  int r = d->demux(sei != nullptr);
  if (r != VPF_OK) return r;
  *data = d->annexb_bytes.data();
  *size = d->annexb_bytes.size();
  if (pkt) *pkt = d->last_pkt;
  if (sei) {
    *sei = d->sei_bytes.data();
    *sei_size = d->sei_bytes.size();
  }
  return VPF_OK;
}

VPF_API int vpf_demuxer_seek(void* h, int64_t frame_num, double tssec,
                             int criteria, int mode, const uint8_t** data,
                             size_t* size, VpfPacketData* pkt,
                             int64_t* out_pts, int64_t* out_duration) {
  auto* d = static_cast<Demuxer*>(h);
  int r = d->seek(frame_num, tssec, criteria, mode, false, out_pts,
                  out_duration);
  if (r != VPF_OK) return r;
  *data = d->annexb_bytes.data();
  *size = d->annexb_bytes.size();
  if (pkt) *pkt = d->last_pkt;
  return VPF_OK;
}

VPF_API void vpf_demuxer_flush(void* h) {
  auto* d = static_cast<Demuxer*>(h);
  if (d->fmtc->pb) avio_flush(d->fmtc->pb);
  avformat_flush(d->fmtc);
}

VPF_API int vpf_demuxer_codec_id(void* h) {
  auto* d = static_cast<Demuxer*>(h);
  return vpf_codec_from_av(d->vs()->codecpar->codec_id);
}

/* Exact stream-timebase conversions (used by the decode-side seek loop so
 * Python compares pts against the same rounding the demuxer seeks with). */
VPF_API int64_t vpf_demuxer_ts_from_time(void* h, double sec) {
  return static_cast<Demuxer*>(h)->ts_from_time(sec);
}
VPF_API int64_t vpf_demuxer_ts_from_frame(void* h, int64_t frame) {
  return static_cast<Demuxer*>(h)->ts_from_frame(frame);
}

VPF_API int vpf_demuxer_extradata(void* h, const uint8_t** data,
                                  size_t* size) {
  auto* d = static_cast<Demuxer*>(h);
  *data = d->vs()->codecpar->extradata;
  *size = (size_t)d->vs()->codecpar->extradata_size;
  return VPF_OK;
}

/* Extradata matching the ANNEX.B packets this demuxer emits: the
 * mp4toannexb BSF's par_out (start-code SPS/PPS), falling back to the
 * container extradata when no BSF is active (raw annexb inputs carry
 * parameter sets in-band). Handing this to the decoder at open means
 * the SPS is known BEFORE the first access unit's SEI — without it a
 * buffering-period SEI precedes the in-band SPS in BSF output order
 * and libav logs "non-existing SPS 0 referenced in buffering period"
 * per stream open. */
VPF_API int vpf_demuxer_annexb_extradata(void* h, const uint8_t** data,
                                         size_t* size) {
  auto* d = static_cast<Demuxer*>(h);
  const AVCodecParameters* par =
      d->bsf_annexb ? d->bsf_annexb->par_out : d->vs()->codecpar;
  *data = par->extradata;
  *size = (size_t)par->extradata_size;
  return VPF_OK;
}
