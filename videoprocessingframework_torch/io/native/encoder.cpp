/* Encoder: libavcodec (libx264/libx265/…) encode session with the
 * reference's option vocabulary and session semantics: dict-validated
 * options, deferred first-frame setup, delayed-output packet FIFO, sync
 * (zero-delay) mode, EOS flush, Reconfigure(force_idr, reset), per-frame
 * unregistered-user-data SEI injection.
 *
 * Parity target: the reference's NvEncoder + NvEncoderClInterface behavior
 * (src/TC/src/NvEncoder.cpp, NvCodecCliOptions.cpp:46-107) re-mapped onto
 * software encoders. Preset names P1…P7 map onto the encoder's native
 * speed/quality ladder.
 */

#include "common.hpp"

#include <algorithm>
#include <deque>
#include <map>
#include <string>
#include <vector>

namespace {

/* The reference's option vocabulary (NvCodecCliOptions.cpp:46-83). Keys are
 * validated exactly like the reference: unknown key → hard error. */
const std::map<std::string, std::string>& vocabulary() {
  static const std::map<std::string, std::string> v = {
      {"codec", "video codec: {'codec' : 'h264'}"},
      {"preset", "encode preset: {'preset' : 'P4'}"},
      {"tuning_info", "how to tune the encoder: {'tuning_info' : 'high_quality'}"},
      {"profile", "h.264 profile: {'profile' : 'high'}"},
      {"max_res", "max resolution: {'max_res' : '3840x2160'}"},
      {"s", "video frame size: {'s' : '1920x1080'}"},
      {"fps", "video fps: {'fps' : '30'}"},
      {"bf", "number of b frames: {'bf' : '3'}"},
      {"gop", "gop size: {'gop' : '30'}"},
      {"bitrate", "bitrate: {'bitrate' : '10M'}"},
      {"multipass", "multi-pass encoding: {'multipass' : 'fullres'}"},
      {"ldkfs", "low-delay key frame scale: {'ldkfs' : ''}"},
      {"maxbitrate", "max bitrate: {'maxbitrate' : '20M'}"},
      {"vbvbufsize", "vbv buffer size: {'vbvbufsize' : '10M'}"},
      {"vbvinit", "init vbv buffer size: {'vbvinit' : '10M'}"},
      {"cq", "cq parameter: {'cq' : ''}"},
      {"rc", "rc mode: {'rc' : 'cbr'}"},
      {"initqp", "initial qp parameter value: {'initqp' : '32'}"},
      {"qmin", "minimum qp: {'qmin' : '28'}"},
      {"qmax", "maximum qp: {'qmax' : '36'}"},
      {"constqp", "const qp mode: {'constqp' : ''}"},
      {"temporalaq", "temporal adaptive quantization: {'temporalaq' : ''}"},
      {"lookahead", "look ahead encoding: {'lookahead' : '8'}"},
      {"aq", "adaptive quantization: {'aq' : ''}"},
      {"fmt", "pixel format: {'fmt' : 'YUV444'}"},
      {"idrperiod", "distance between I frames: {'idrperiod' : '256'}"},
      {"numrefl0", "number of ref frames in l0 list: {'numrefl0' : '4'}"},
      {"numrefl1", "number of ref frames in l1 list: {'numrefl1' : '4'}"},
      {"repeatspspps", "write SPS/PPS for every IDR frame: {'repeatspspps' : '0'}"},
  };
  return v;
}

int64_t parse_bitrate(const std::string& s) {
  if (s.empty()) return 0;
  char suffix = s.back();
  int64_t mult = 1;
  std::string digits = s;
  if (suffix == 'M' || suffix == 'm') {
    mult = 1000000;
    digits.pop_back();
  } else if (suffix == 'K' || suffix == 'k') {
    mult = 1000;
    digits.pop_back();
  }
  return (int64_t)(atof(digits.c_str()) * mult);
}

const char* x264_preset_for(const std::string& p) {
  // NVENC P1 = fastest … P7 = slowest/best; legacy names accepted too.
  static const std::map<std::string, const char*> m = {
      {"P1", "ultrafast"}, {"P2", "superfast"}, {"P3", "veryfast"},
      {"P4", "medium"},    {"P5", "slow"},      {"P6", "slower"},
      {"P7", "veryslow"},  {"default", "medium"}, {"hp", "veryfast"},
      {"hq", "slow"},      {"bd", "slow"},      {"ll", "veryfast"},
      {"ll_hp", "superfast"}, {"ll_hq", "fast"}, {"lossless", "medium"},
      {"lossless_hp", "ultrafast"},
  };
  auto it = m.find(p);
  return it == m.end() ? "medium" : it->second;
}

struct Encoder {
  AVCodecContext* avctx = nullptr;
  const AVCodec* codec = nullptr;
  std::map<std::string, std::string> opts;
  int width = 0, height = 0;
  int in_fmt = VPF_FMT_NV12;  // packed input layout from the caller
  bool sync_mode = false;
  bool force_idr_next = false;
  bool flushing = false;
  int64_t frame_index = 0;
  std::deque<std::vector<uint8_t>> ready;     // encoded packets FIFO
  std::deque<VpfPacketData> ready_meta;
  std::vector<uint8_t> out_hold;              // last packet handed out
  VpfPacketData out_meta = {};
  AVFrame* frame = nullptr;

  ~Encoder() { teardown(); }

  void teardown() {
    if (avctx) avcodec_free_context(&avctx);
    if (frame) av_frame_free(&frame);
    ready.clear();
    ready_meta.clear();
  }

  std::string opt(const std::string& k, const std::string& dflt = "") const {
    auto it = opts.find(k);
    return it == opts.end() ? dflt : it->second;
  }
  bool has(const std::string& k) const { return opts.count(k) != 0; }

  int validate() {
    for (auto& kv : opts) {
      if (!vocabulary().count(kv.first))
        return vpf_set_error(
            VPF_ERR, "Invalid parameter name\"%s\" for NvEncoderClInterface",
            kv.first.c_str());
    }
    return VPF_OK;
  }

  int setup() {
    // frame size: either explicit width/height (from wrapper) or 's'
    std::string s = opt("s");
    if (!s.empty()) {
      if (sscanf(s.c_str(), "%dx%d", &width, &height) != 2)
        return vpf_set_error(VPF_ERR, "bad 's' option: %s", s.c_str());
    }
    if (width <= 0 || height <= 0)
      return vpf_set_error(VPF_ERR, "encoder needs a frame size ('s')");

    std::string codec_name = opt("codec", "h264");
    const char* enc_name = nullptr;
    if (codec_name == "h264" || codec_name == "H264")
      enc_name = "libx264";
    else if (codec_name == "hevc" || codec_name == "h265")
      enc_name = "libx265";
    else if (codec_name == "vp9")
      enc_name = "libvpx-vp9";
    else if (codec_name == "vp8")
      enc_name = "libvpx";
    else if (codec_name == "av1")
      enc_name = "libsvtav1";
    else if (codec_name == "mpeg4")
      enc_name = "mpeg4";
    else if (codec_name == "mjpeg")
      enc_name = "mjpeg";
    else
      return vpf_set_error(VPF_ERR, "unsupported codec: %s",
                           codec_name.c_str());
    codec = avcodec_find_encoder_by_name(enc_name);
    if (!codec)
      return vpf_set_error(VPF_ERR, "encoder %s not available", enc_name);

    avctx = avcodec_alloc_context3(codec);
    avctx->width = width;
    avctx->height = height;

    std::string fmt = opt("fmt", "NV12");
    AVPixelFormat pix = AV_PIX_FMT_YUV420P;
    if (fmt == "NV12" || fmt == "YUV420") {
      pix = AV_PIX_FMT_YUV420P;
      in_fmt = fmt == "NV12" ? VPF_FMT_NV12 : VPF_FMT_YUV420;
    } else if (fmt == "YUV444") {
      pix = AV_PIX_FMT_YUV444P;
      in_fmt = VPF_FMT_YUV444;
    } else if (fmt == "YUV422") {
      pix = AV_PIX_FMT_YUV422P;
      in_fmt = VPF_FMT_YUV422;
    } else if (fmt == "P10" || fmt == "YUV420_10bit" || fmt == "P12") {
      // 10-bit 4:2:0: packed 16-bit MSB-aligned input (P010-style), encoded
      // as yuv420p10 (requires a 10-bit capable encoder — hevc here).
      if (codec_name == "h264" || codec_name == "H264")
        return vpf_set_error(
            VPF_ERR, "10-bit input requires the hevc encoder");
      pix = AV_PIX_FMT_YUV420P10;
      in_fmt = VPF_FMT_P10;
    } else if (fmt == "YUV444_10bit" || fmt == "YUV444_10BIT") {
      // 10-bit 4:4:4: MSB-aligned 16-bit planar input, encoded as
      // yuv444p10 (reference input set: PyNvEncoder.cpp:204-221).
      if (codec_name == "h264" || codec_name == "H264")
        return vpf_set_error(
            VPF_ERR, "10-bit input requires the hevc encoder");
      pix = AV_PIX_FMT_YUV444P10;
      in_fmt = VPF_FMT_YUV444_10BIT;
    } else if (fmt == "GRAY12") {
      // 12-bit grayscale: packed 16-bit MSB-aligned input, encoded as
      // gray12le (hevc/libx265 supports it; reference analog is the
      // GRAY12LE path in FfmpegSwDecoder.cpp:141-252).
      if (codec_name != "hevc" && codec_name != "HEVC")
        return vpf_set_error(
            VPF_ERR, "GRAY12 input requires the hevc encoder");
      pix = AV_PIX_FMT_GRAY12;
      in_fmt = VPF_FMT_GRAY12;
    } else {
      return vpf_set_error(VPF_ERR, "unsupported input fmt: %s", fmt.c_str());
    }
    avctx->pix_fmt = pix;

    int fps = atoi(opt("fps", "30").c_str());
    if (fps <= 0) fps = 30;
    avctx->time_base = {1, fps};
    avctx->framerate = {fps, 1};

    avctx->gop_size = atoi(opt("gop", opt("idrperiod", "250")).c_str());
    // B-frames: explicit 'bf' wins; otherwise -1 lets the encoder's own
    // preset ladder decide (x264 ultrafast natively runs bframes=0 —
    // forcing the old fixed default of 3 cost P1 ~30% fps, measured;
    // NVENC's frameIntervalP is likewise preset-derived).
    avctx->max_b_frames = has("bf") ? atoi(opt("bf").c_str()) : -1;
    if (has("qmin")) avctx->qmin = atoi(opt("qmin").c_str());
    if (has("qmax")) avctx->qmax = atoi(opt("qmax").c_str());
    if (has("numrefl0")) avctx->refs = atoi(opt("numrefl0").c_str());

    std::string rc = opt("rc", "");
    int64_t bitrate = parse_bitrate(opt("bitrate", "0"));
    int64_t maxbitrate = parse_bitrate(opt("maxbitrate", "0"));
    int64_t vbvbuf = parse_bitrate(opt("vbvbufsize", "0"));
    if (has("constqp") || rc == "constqp") {
      int qp = atoi(opt("initqp", opt("constqp", "28")).c_str());
      av_opt_set_int(avctx->priv_data, "qp", qp, 0);
    } else if (bitrate > 0) {
      avctx->bit_rate = bitrate;
      if (rc == "cbr") {
        avctx->rc_max_rate = bitrate;
        avctx->rc_min_rate = bitrate;
        avctx->rc_buffer_size = vbvbuf > 0 ? (int)vbvbuf : (int)bitrate;
      } else {  // vbr and default
        if (maxbitrate > 0) avctx->rc_max_rate = maxbitrate;
        if (vbvbuf > 0) avctx->rc_buffer_size = (int)vbvbuf;
      }
    } else if (has("cq")) {
      av_opt_set(avctx->priv_data, "crf", opt("cq").c_str(), 0);
    }

    std::string tuning = opt("tuning_info", "");
    bool zero_latency = sync_mode || tuning == "low_latency" ||
                        tuning == "ultra_low_latency";
    if (tuning == "lossless")
      av_opt_set_int(avctx->priv_data, "qp", 0, 0);

    if (strcmp(codec->name, "libx264") == 0) {
      av_opt_set(avctx->priv_data, "preset",
                 x264_preset_for(opt("preset", "P4")), 0);
      if (zero_latency) {
        av_opt_set(avctx->priv_data, "tune", "zerolatency", 0);
        avctx->max_b_frames = 0;
      }
      if (has("profile")) {
        std::string prof = opt("profile");
        std::transform(prof.begin(), prof.end(), prof.begin(), ::tolower);
        av_opt_set(avctx->priv_data, "profile", prof.c_str(), 0);
      }
      if (has("lookahead"))
        av_opt_set(avctx->priv_data, "rc-lookahead", opt("lookahead").c_str(),
                   0);
      if (has("aq")) av_opt_set(avctx->priv_data, "aq-mode", "1", 0);
      // per-frame unregistered user data SEI passthrough
      av_opt_set_int(avctx->priv_data, "udu_sei", 1, 0);
      // annex.b elementary stream with in-band SPS/PPS (no global header)
      if (opt("repeatspspps", "0") != "0")
        av_opt_set(avctx->priv_data, "x264-params", "repeat-headers=1", 0);
    } else if (strcmp(codec->name, "libx265") == 0) {
      const char* p = x264_preset_for(opt("preset", "P4"));
      av_opt_set(avctx->priv_data, "preset", p, 0);
      if (zero_latency) {
        av_opt_set(avctx->priv_data, "tune", "zerolatency", 0);
        avctx->max_b_frames = 0;  // zerolatency forbids B-frames
      }
      av_opt_set_int(avctx->priv_data, "udu_sei", 1, 0);
      // Cap output latency to NVENC-like delay (first packets within ~8
      // frames): small lookahead (must exceed bframes), single frame
      // thread (frame threading adds 2-3 frames of delay). x265 tuning
      // goes through the x265-params string.
      if (avctx->max_b_frames < 0) avctx->max_b_frames = 2;
      int la = has("lookahead") ? atoi(opt("lookahead").c_str())
                                : avctx->max_b_frames + 1;
      if (la <= avctx->max_b_frames) la = avctx->max_b_frames + 1;
      std::string xp =
          "rc-lookahead=" + std::to_string(la) + ":frame-threads=1";
      av_opt_set(avctx->priv_data, "x265-params", xp.c_str(), 0);
    }

    if (strcmp(codec->name, "libvpx-vp9") == 0 ||
        strcmp(codec->name, "libvpx") == 0) {
      // vpx: realtime deadline keeps the session contract's low delay
      av_opt_set(avctx->priv_data, "deadline", "realtime", 0);
      av_opt_set_int(avctx->priv_data, "cpu-used", 8, 0);
      avctx->max_b_frames = 0;  // vpx has no B-frames
      if (avctx->bit_rate == 0) avctx->bit_rate = 2000000;
    } else if (strcmp(codec->name, "libsvtav1") == 0) {
      av_opt_set(avctx->priv_data, "preset", "12", 0);
      avctx->max_b_frames = 0;
      if (avctx->bit_rate == 0) avctx->bit_rate = 2000000;
    } else if (strcmp(codec->name, "mjpeg") == 0) {
      // mjpeg wants full-range yuvj420p and per-frame quality scale
      if (avctx->pix_fmt == AV_PIX_FMT_YUV420P)
        avctx->pix_fmt = AV_PIX_FMT_YUVJ420P;
      avctx->max_b_frames = 0;
      avctx->flags |= AV_CODEC_FLAG_QSCALE;
      // initqp/constqp (NVENC vocabulary) maps to the mjpeg qscale
      // (2..31, lower = better); default 4 ≈ visually lossless
      int qs = atoi(opt("initqp", opt("constqp", "4")).c_str());
      if (qs < 1) qs = 4;
      if (qs > 31) qs = 31;
      avctx->global_quality = FF_QP2LAMBDA * qs;
    } else if (strcmp(codec->name, "mpeg4") == 0) {
      if (avctx->bit_rate == 0) avctx->bit_rate = 2000000;
      if (avctx->max_b_frames < 0) avctx->max_b_frames = 0;
    }

    // zero-latency sessions stay single-threaded (threading adds frame
    // delay); everything else gets libav auto threads — neutral on
    // 1-core hosts, linear encode scaling on real TPU-VM hosts.
    avctx->thread_count = zero_latency ? 1 : 0;

    int ret;
    {
      VpfSchedPolicyGuard sched_guard;  // SVT-AV1 et al. leak SCHED_FIFO
      ret = avcodec_open2(avctx, codec, nullptr);
    }
    if (ret < 0) return vpf_set_av_error(VPF_ERR, "avcodec_open2(enc)", ret);

    frame = av_frame_alloc();
    frame->format = avctx->pix_fmt;
    frame->width = width;
    frame->height = height;
    ret = av_frame_get_buffer(frame, 32);
    if (ret < 0) return vpf_set_av_error(VPF_ERR, "frame_get_buffer", ret);
    flushing = false;
    return VPF_OK;
  }

  int fill_frame(const uint8_t* src, size_t size) {
    av_frame_make_writable(frame);
    const int w = width, h = height, cw = w / 2, ch = h / 2;
    auto need = (uint64_t)w * h;
    switch (in_fmt) {
      case VPF_FMT_NV12: {
        if (size < need * 3 / 2)
          return vpf_set_error(VPF_ERR, "NV12 frame too small");
        for (int r = 0; r < h; r++)
          memcpy(frame->data[0] + (size_t)r * frame->linesize[0],
                 src + (size_t)r * w, w);
        const uint8_t* uv = src + need;
        for (int r = 0; r < ch; r++) {
          uint8_t* urow = frame->data[1] + (size_t)r * frame->linesize[1];
          uint8_t* vrow = frame->data[2] + (size_t)r * frame->linesize[2];
          const uint8_t* srow = uv + (size_t)r * w;
          for (int c = 0; c < cw; c++) {
            urow[c] = srow[2 * c];
            vrow[c] = srow[2 * c + 1];
          }
        }
        return VPF_OK;
      }
      case VPF_FMT_YUV420: {
        if (size < need * 3 / 2)
          return vpf_set_error(VPF_ERR, "YUV420 frame too small");
        for (int r = 0; r < h; r++)
          memcpy(frame->data[0] + (size_t)r * frame->linesize[0],
                 src + (size_t)r * w, w);
        const uint8_t* up = src + need;
        const uint8_t* vp = up + (size_t)cw * ch;
        for (int r = 0; r < ch; r++) {
          memcpy(frame->data[1] + (size_t)r * frame->linesize[1],
                 up + (size_t)r * cw, cw);
          memcpy(frame->data[2] + (size_t)r * frame->linesize[2],
                 vp + (size_t)r * cw, cw);
        }
        return VPF_OK;
      }
      case VPF_FMT_YUV444: {
        if (size < need * 3)
          return vpf_set_error(VPF_ERR, "YUV444 frame too small");
        for (int p = 0; p < 3; p++)
          for (int r = 0; r < h; r++)
            memcpy(frame->data[p] + (size_t)r * frame->linesize[p],
                   src + (size_t)p * need + (size_t)r * w, w);
        return VPF_OK;
      }
      case VPF_FMT_YUV422: {
        if (size < need * 2)
          return vpf_set_error(VPF_ERR, "YUV422 frame too small");
        for (int r = 0; r < h; r++)
          memcpy(frame->data[0] + (size_t)r * frame->linesize[0],
                 src + (size_t)r * w, w);
        const uint8_t* up = src + need;
        const uint8_t* vp = up + (size_t)cw * h;
        for (int r = 0; r < h; r++) {
          memcpy(frame->data[1] + (size_t)r * frame->linesize[1],
                 up + (size_t)r * cw, cw);
          memcpy(frame->data[2] + (size_t)r * frame->linesize[2],
                 vp + (size_t)r * cw, cw);
        }
        return VPF_OK;
      }
      case VPF_FMT_YUV444_10BIT: {
        // MSB-aligned 16-bit planar 4:4:4 input -> yuv444p10 (LSB)
        if (size < need * 6)
          return vpf_set_error(VPF_ERR, "YUV444_10bit frame too small");
        const uint16_t* sp = (const uint16_t*)src;
        for (int p = 0; p < 3; p++) {
          const uint16_t* plane = sp + (size_t)p * need;
          for (int r = 0; r < h; r++) {
            uint16_t* drow =
                (uint16_t*)(frame->data[p] + (size_t)r * frame->linesize[p]);
            const uint16_t* srow = plane + (size_t)r * w;
            for (int c = 0; c < w; c++) drow[c] = srow[c] >> 6;
          }
        }
        return VPF_OK;
      }
      case VPF_FMT_GRAY12: {
        // MSB-aligned 16-bit packed input → gray12le (LSB-aligned)
        if (size < need * 2)
          return vpf_set_error(VPF_ERR, "GRAY12 frame too small");
        const uint16_t* sy = (const uint16_t*)src;
        for (int r = 0; r < h; r++) {
          uint16_t* drow =
              (uint16_t*)(frame->data[0] + (size_t)r * frame->linesize[0]);
          const uint16_t* srow = sy + (size_t)r * w;
          for (int c = 0; c < w; c++) drow[c] = srow[c] >> 4;
        }
        return VPF_OK;
      }
      case VPF_FMT_P10: {
        // MSB-aligned 16-bit P010-style packed input → yuv420p10 (LSB)
        if (size < need * 3)
          return vpf_set_error(VPF_ERR, "P10 frame too small");
        const uint16_t* sy = (const uint16_t*)src;
        for (int r = 0; r < h; r++) {
          uint16_t* drow =
              (uint16_t*)(frame->data[0] + (size_t)r * frame->linesize[0]);
          const uint16_t* srow = sy + (size_t)r * w;
          for (int c = 0; c < w; c++) drow[c] = srow[c] >> 6;
        }
        const uint16_t* suv = sy + need;
        for (int r = 0; r < ch; r++) {
          uint16_t* urow =
              (uint16_t*)(frame->data[1] + (size_t)r * frame->linesize[1]);
          uint16_t* vrow =
              (uint16_t*)(frame->data[2] + (size_t)r * frame->linesize[2]);
          const uint16_t* srow = suv + (size_t)r * w;
          for (int c = 0; c < cw; c++) {
            urow[c] = srow[2 * c] >> 6;
            vrow[c] = srow[2 * c + 1] >> 6;
          }
        }
        return VPF_OK;
      }
      default:
        return vpf_set_error(VPF_ERR, "unsupported encoder input layout");
    }
  }

  /* Drain ready packets into the FIFO. VPF_OK normally; a genuine
   * avcodec_receive_packet failure (not EAGAIN/EOF) is recorded and
   * returned so a mid-stream encode failure surfaces as an error instead
   * of silently missing packets. */
  int collect_packets() {
    for (;;) {
      AVPacket* pkt = av_packet_alloc();
      int ret = avcodec_receive_packet(avctx, pkt);
      if (ret == AVERROR(EAGAIN) || ret == AVERROR_EOF) {
        av_packet_free(&pkt);
        break;
      }
      if (ret < 0) {
        av_packet_free(&pkt);
        return vpf_set_av_error(VPF_ERR, "avcodec_receive_packet", ret);
      }
      ready.emplace_back(pkt->data, pkt->data + pkt->size);
      VpfPacketData meta = {};
      meta.key = (pkt->flags & AV_PKT_FLAG_KEY) ? 1 : 0;
      meta.pts = pkt->pts;
      meta.dts = pkt->dts;
      meta.bsl = (uint64_t)pkt->size;
      meta.duration = (uint64_t)pkt->duration;
      ready_meta.push_back(meta);
      av_packet_free(&pkt);
    }
    return VPF_OK;
  }

  int encode(const uint8_t* data, size_t size, const uint8_t* sei,
             size_t sei_size, int64_t pts) {
    if (!avctx) {
      int r = setup();
      if (r != VPF_OK) return r;
    }
    if (!data) {  // EOS flush request
      if (!flushing) {
        avcodec_send_frame(avctx, nullptr);
        flushing = true;
      }
      int cr = collect_packets();
      if (cr != VPF_OK) return cr;
      return pop_packet();
    }
    int r = fill_frame(data, size);
    if (r != VPF_OK) return r;
    frame->pts = pts >= 0 ? pts : frame_index;
    frame_index++;
    if (avctx->flags & AV_CODEC_FLAG_QSCALE)
      frame->quality = avctx->global_quality;  // mjpeg per-frame qscale
    frame->pict_type = force_idr_next ? AV_PICTURE_TYPE_I : AV_PICTURE_TYPE_NONE;
    force_idr_next = false;

    av_frame_remove_side_data(frame, AV_FRAME_DATA_SEI_UNREGISTERED);
    if (sei && sei_size) {
      // libx264's udu_sei path wants UUID(16) + payload
      static const uint8_t kUuid[16] = {0x56, 0x50, 0x46, 0x54, 0x50, 0x55,
                                        0x4e, 0x41, 0x54, 0x49, 0x56, 0x45,
                                        0x30, 0x30, 0x30, 0x31};
      AVFrameSideData* sd = av_frame_new_side_data(
          frame, AV_FRAME_DATA_SEI_UNREGISTERED, sei_size + 16);
      if (sd) {
        memcpy(sd->data, kUuid, 16);
        memcpy(sd->data + 16, sei, sei_size);
      }
    }

    int ret = avcodec_send_frame(avctx, frame);
    if (ret < 0) return vpf_set_av_error(VPF_ERR, "avcodec_send_frame", ret);
    int cr = collect_packets();
    if (cr != VPF_OK) return cr;
    return pop_packet();
  }

  int pop_packet() {
    if (ready.empty()) return flushing ? VPF_ERR_EOF : VPF_NEED_MORE;
    out_hold = std::move(ready.front());
    ready.pop_front();
    out_meta = ready_meta.front();
    ready_meta.pop_front();
    return VPF_OK;
  }

  /* Reconfigure (reference: Tasks.cpp:146-158, NvEncoder.cpp:436-456):
   * merge new options; optionally recreate the session and/or force the
   * next frame to be an IDR. A software session always recreates when the
   * codec context already exists and reset is requested. */
  int reconfigure(std::map<std::string, std::string> new_opts, int force_idr,
                  int reset) {
    for (auto& kv : new_opts) opts[kv.first] = kv.second;
    int r = validate();
    if (r != VPF_OK) return r;
    if (force_idr) force_idr_next = true;
    if (reset && avctx) {
      std::string s = opt("s");
      if (!s.empty()) sscanf(s.c_str(), "%dx%d", &width, &height);
      teardown();
      frame_index = 0;
      return setup();
    }
    return VPF_OK;
  }
};

}  // namespace

VPF_API void* vpf_encoder_create(const char* const* keys,
                                 const char* const* vals, int n,
                                 int sync_mode) {
  auto* e = new Encoder();
  for (int i = 0; i < n; i++) e->opts[keys[i]] = vals[i];
  e->sync_mode = sync_mode != 0;
  if (e->validate() != VPF_OK) {
    delete e;
    return nullptr;
  }
  return e;
}

VPF_API void vpf_encoder_destroy(void* h) { delete static_cast<Encoder*>(h); }

/* Feed one packed frame (or data==NULL to flush). VPF_OK → a packet is
 * available via vpf_encoder_packet(). */
VPF_API int vpf_encoder_encode(void* h, const uint8_t* data, size_t size,
                               const uint8_t* sei, size_t sei_size,
                               int64_t pts) {
  return static_cast<Encoder*>(h)->encode(data, size, sei, sei_size, pts);
}

VPF_API int vpf_encoder_packet(void* h, const uint8_t** data, size_t* size,
                               VpfPacketData* meta) {
  auto* e = static_cast<Encoder*>(h);
  *data = e->out_hold.data();
  *size = e->out_hold.size();
  if (meta) *meta = e->out_meta;
  return VPF_OK;
}

VPF_API int vpf_encoder_reconfigure(void* h, const char* const* keys,
                                    const char* const* vals, int n,
                                    int force_idr, int reset) {
  auto* e = static_cast<Encoder*>(h);
  std::map<std::string, std::string> o;
  for (int i = 0; i < n; i++) o[keys[i]] = vals[i];
  return e->reconfigure(std::move(o), force_idr, reset);
}

VPF_API int vpf_encoder_width(void* h) {
  return static_cast<Encoder*>(h)->width;
}
VPF_API int vpf_encoder_height(void* h) {
  return static_cast<Encoder*>(h)->height;
}

/* Validate an options map without creating a session (used by the Python
 * wrapper to surface the reference's error contract eagerly). */
VPF_API int vpf_encoder_validate_options(const char* const* keys, int n) {
  for (int i = 0; i < n; i++) {
    if (!vocabulary().count(keys[i]))
      return vpf_set_error(
          VPF_ERR, "Invalid parameter name\"%s\" for NvEncoderClInterface",
          keys[i]);
  }
  return VPF_OK;
}
