/* Muxer: write encoded packets into a container (mp4/mkv/ts/…).
 *
 * Beyond-parity addition: the reference's encoder writes raw elementary
 * streams only (samples append Annex.B packets to a file); this closes the
 * transcode loop container-to-container. Built on libavformat's muxing
 * API; the format is inferred from the filename (or forced).
 */

#include "common.hpp"

namespace {

struct Muxer {
  AVFormatContext* fmtc = nullptr;
  AVStream* stream = nullptr;
  AVRational in_tb{1, 30};  // timebase of incoming pts/dts (1/fps)
  bool header_written = false;
  bool finalized = false;

  ~Muxer() { close(); }

  int open(const char* url, const char* format, int codec_id, int width,
           int height, int fps_num, int fps_den,
           const uint8_t* extradata, size_t extradata_size) {
    int ret = avformat_alloc_output_context2(
        &fmtc, nullptr, format && format[0] ? format : nullptr, url);
    if (ret < 0 || !fmtc)
      return vpf_set_av_error(VPF_ERR, "alloc_output_context", ret);
    stream = avformat_new_stream(fmtc, nullptr);
    if (!stream) return vpf_set_error(VPF_ERR, "avformat_new_stream failed");
    AVCodecParameters* par = stream->codecpar;
    par->codec_type = AVMEDIA_TYPE_VIDEO;
    par->codec_id = vpf_codec_to_av(codec_id);
    par->codec_tag = 0;  // let the container pick its own fourcc
    par->width = width;
    par->height = height;
    if (extradata && extradata_size) {
      par->extradata = (uint8_t*)av_mallocz(extradata_size +
                                            AV_INPUT_BUFFER_PADDING_SIZE);
      memcpy(par->extradata, extradata, extradata_size);
      par->extradata_size = (int)extradata_size;
    }
    in_tb = {fps_den, fps_num};
    stream->time_base = in_tb;
    stream->avg_frame_rate = {fps_num, fps_den};

    if (!(fmtc->oformat->flags & AVFMT_NOFILE)) {
      ret = avio_open(&fmtc->pb, url, AVIO_FLAG_WRITE);
      if (ret < 0) return vpf_set_av_error(VPF_ERR, "avio_open", ret);
    }
    ret = avformat_write_header(fmtc, nullptr);
    if (ret < 0) return vpf_set_av_error(VPF_ERR, "write_header", ret);
    header_written = true;
    return VPF_OK;
  }

  int write(const uint8_t* data, size_t size, int64_t pts, int64_t dts,
            int key) {
    AVPacket* pkt = av_packet_alloc();
    av_packet_from_data(
        pkt, (uint8_t*)av_malloc(size + AV_INPUT_BUFFER_PADDING_SIZE),
        (int)size);
    memcpy(pkt->data, data, size);
    memset(pkt->data + size, 0, AV_INPUT_BUFFER_PADDING_SIZE);
    pkt->stream_index = stream->index;
    pkt->pts = av_rescale_q(pts, in_tb, stream->time_base);
    pkt->dts = dts == INT64_MIN ? AV_NOPTS_VALUE
                                : av_rescale_q(dts, in_tb, stream->time_base);
    if (key) pkt->flags |= AV_PKT_FLAG_KEY;
    int ret = av_interleaved_write_frame(fmtc, pkt);
    av_packet_free(&pkt);
    if (ret < 0) return vpf_set_av_error(VPF_ERR, "write_frame", ret);
    return VPF_OK;
  }

  int close() {
    if (!fmtc) return VPF_OK;
    if (header_written && !finalized) {
      av_write_trailer(fmtc);
      finalized = true;
    }
    if (fmtc->pb && !(fmtc->oformat->flags & AVFMT_NOFILE))
      avio_closep(&fmtc->pb);
    avformat_free_context(fmtc);
    fmtc = nullptr;
    return VPF_OK;
  }
};

}  // namespace

VPF_API void* vpf_muxer_open(const char* url, const char* format,
                             int codec_id, int width, int height,
                             int fps_num, int fps_den,
                             const uint8_t* extradata,
                             size_t extradata_size) {
  auto* m = new Muxer();
  if (m->open(url, format, codec_id, width, height, fps_num, fps_den,
              extradata, extradata_size) != VPF_OK) {
    delete m;
    return nullptr;
  }
  return m;
}

VPF_API int vpf_muxer_write(void* h, const uint8_t* data, size_t size,
                            int64_t pts, int64_t dts, int key) {
  return static_cast<Muxer*>(h)->write(data, size, pts, dts, key);
}

VPF_API int vpf_muxer_close(void* h) {
  int r = static_cast<Muxer*>(h)->close();
  delete static_cast<Muxer*>(h);
  return r;
}
