/* Common C-ABI types and helpers for the host runtime.
 *
 * TPU-native host runtime for videoprocessingframework_tpu: libav-backed
 * demux / software decode / encode running on the TPU-VM CPUs. Plays the
 * role the reference's NVDEC/NVENC/FFmpegDemuxer engine layer plays on GPU
 * (reference: src/TC/src/FFmpegDemuxer.cpp, NvDecoder.cpp, NvEncoder.cpp),
 * but is an independent implementation over the public libav API.
 */
#pragma once

#include "status.hpp"

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavcodec/bsf.h>
#include <libavformat/avformat.h>
#include <libavutil/dict.h>
#include <libavutil/error.h>
#include <libavutil/imgutils.h>
#include <libavutil/motion_vector.h>
#include <libavutil/opt.h>
#include <libavutil/pixdesc.h>
#include <libavutil/rational.h>
}

/* ---- enums shared with Python (values match core/enums.py) ---- */

enum VpfPixelFormat {
  VPF_FMT_UNDEFINED = 0,
  VPF_FMT_Y = 1,
  VPF_FMT_RGB = 2,
  VPF_FMT_NV12 = 3,
  VPF_FMT_YUV420 = 4,
  VPF_FMT_RGB_PLANAR = 5,
  VPF_FMT_BGR = 6,
  VPF_FMT_YCBCR = 7,
  VPF_FMT_YUV444 = 8,
  VPF_FMT_RGB_32F = 9,
  VPF_FMT_RGB_32F_PLANAR = 10,
  VPF_FMT_YUV422 = 11,
  VPF_FMT_P10 = 12,
  VPF_FMT_P12 = 13,
  VPF_FMT_YUV444_10BIT = 14,
  VPF_FMT_YUV420_10BIT = 15,
  VPF_FMT_NV12_PLANAR = 16,
  VPF_FMT_GRAY12 = 17,
};

enum VpfColorSpace { VPF_CS_BT601 = 0, VPF_CS_BT709 = 1, VPF_CS_UNSPEC = 2 };
enum VpfColorRange { VPF_CR_MPEG = 0, VPF_CR_JPEG = 1, VPF_CR_UDEF = 2 };
enum VpfSeekMode { VPF_SEEK_EXACT_FRAME = 0, VPF_SEEK_PREV_KEY_FRAME = 1 };
enum VpfSeekCriteria { VPF_SEEK_BY_NUMBER = 0, VPF_SEEK_BY_TIMESTAMP = 1 };

enum VpfCodecId {
  VPF_CODEC_UNDEFINED = 0,
  VPF_CODEC_H264 = 1,
  VPF_CODEC_HEVC = 2,
  VPF_CODEC_VP8 = 3,
  VPF_CODEC_VP9 = 4,
  VPF_CODEC_MPEG4 = 5,
  VPF_CODEC_MPEG2 = 6,
  VPF_CODEC_MJPEG = 7,
  VPF_CODEC_AV1 = 8,
};

/* ---- PODs mirrored in Python via ctypes ---- */

typedef struct VpfPacketData {
  int32_t key;
  int64_t pts;
  int64_t dts;
  uint64_t pos;
  uint64_t bsl;
  uint64_t duration;
} VpfPacketData;

typedef struct VpfStreamProps {
  uint32_t width;
  uint32_t height;
  uint32_t gop_size;
  int64_t num_frames;
  uint32_t is_vfr;
  double frame_rate;
  double avg_frame_rate;
  double time_base;
  uint32_t stream_index;
  int32_t codec;        /* VpfCodecId */
  int32_t pixel_format; /* VpfPixelFormat as the *decoder* will emit it */
  int32_t color_space;  /* VpfColorSpace */
  int32_t color_range;  /* VpfColorRange */
  int64_t start_time;
  uint32_t bit_depth;
} VpfStreamProps;

typedef struct VpfFrameDesc {
  uint32_t width;
  uint32_t height;
  int32_t pixel_format; /* VpfPixelFormat */
  int32_t color_space;
  int32_t color_range;
  VpfPacketData pkt;
  uint64_t frame_size; /* packed byte size in pixel_format layout */
} VpfFrameDesc;

/* Real codec capabilities, queried from libav (analog of the reference's
 * cuvidGetDecoderCaps validation, NvDecoder.cpp:183-210, and the NVENC caps
 * queries in NvCodecCliOptions.cpp): bit depth from the codec's actual
 * supported pixel formats, reorder/delay from AVCodec capability flags,
 * lookahead from the encoder's private option table, dimension limits from
 * the codec spec level tables (SW codecs have no HW surface limit). */
typedef struct VpfCodecCaps {
  int32_t is_supported;    /* codec available in this libav build */
  int32_t max_bit_depth;   /* highest luma depth the codec supports */
  int32_t supports_10bit;  /* encoder: a 10-bit input pix_fmt exists */
  int32_t max_width;
  int32_t max_height;
  int32_t min_width;
  int32_t min_height;
  int32_t max_bframes;     /* 0 when the codec has no B-frames */
  int32_t supports_lookahead;        /* encoder rc-lookahead option */
  int32_t supports_reordered_output; /* AV_CODEC_CAP_DELAY */
} VpfCodecCaps;

typedef struct VpfMotionVector {
  int32_t source;
  uint8_t w, h;
  int16_t src_x, src_y, dst_x, dst_y;
  uint64_t flags;
  int32_t motion_x, motion_y;
  uint16_t motion_scale;
} VpfMotionVector;

/* ---- libav error reporting ---- */

inline int vpf_set_av_error(int code, const char* what, int averr) {
  char ebuf[AV_ERROR_MAX_STRING_SIZE] = {0};
  av_strerror(averr, ebuf, sizeof(ebuf));
  return vpf_set_error(code, "%s: %s (%d)", what, ebuf, averr);
}

/* ---- mapping helpers ---- */

inline int vpf_codec_from_av(AVCodecID id) {
  switch (id) {
    case AV_CODEC_ID_H264: return VPF_CODEC_H264;
    case AV_CODEC_ID_HEVC: return VPF_CODEC_HEVC;
    case AV_CODEC_ID_VP8: return VPF_CODEC_VP8;
    case AV_CODEC_ID_VP9: return VPF_CODEC_VP9;
    case AV_CODEC_ID_MPEG4: return VPF_CODEC_MPEG4;
    case AV_CODEC_ID_MPEG2VIDEO: return VPF_CODEC_MPEG2;
    case AV_CODEC_ID_MJPEG: return VPF_CODEC_MJPEG;
    case AV_CODEC_ID_AV1: return VPF_CODEC_AV1;
    default: return VPF_CODEC_UNDEFINED;
  }
}

inline AVCodecID vpf_codec_to_av(int id) {
  switch (id) {
    case VPF_CODEC_H264: return AV_CODEC_ID_H264;
    case VPF_CODEC_HEVC: return AV_CODEC_ID_HEVC;
    case VPF_CODEC_VP8: return AV_CODEC_ID_VP8;
    case VPF_CODEC_VP9: return AV_CODEC_ID_VP9;
    case VPF_CODEC_MPEG4: return AV_CODEC_ID_MPEG4;
    case VPF_CODEC_MPEG2: return AV_CODEC_ID_MPEG2VIDEO;
    case VPF_CODEC_MJPEG: return AV_CODEC_ID_MJPEG;
    case VPF_CODEC_AV1: return AV_CODEC_ID_AV1;
    default: return AV_CODEC_ID_NONE;
  }
}

/* Decoder-output pixel format a given AV pixel format maps to. 8-bit 4:2:0
 * material is reported as NV12 (matching the reference's decoder output
 * convention); the packer interleaves chroma on copy-out. */
inline int vpf_fmt_from_av(AVPixelFormat f) {
  switch (f) {
    case AV_PIX_FMT_YUV420P:
    case AV_PIX_FMT_YUVJ420P:
    case AV_PIX_FMT_NV12: return VPF_FMT_NV12;
    case AV_PIX_FMT_P010:
    case AV_PIX_FMT_YUV420P10: return VPF_FMT_P10;
    case AV_PIX_FMT_YUV420P12: return VPF_FMT_P12;
    case AV_PIX_FMT_YUV422P:
    case AV_PIX_FMT_YUVJ422P: return VPF_FMT_YUV422;
    case AV_PIX_FMT_YUV444P:
    case AV_PIX_FMT_YUVJ444P: return VPF_FMT_YUV444;
    case AV_PIX_FMT_YUV444P10: return VPF_FMT_YUV444_10BIT;
    case AV_PIX_FMT_GRAY8: return VPF_FMT_Y;
    case AV_PIX_FMT_GRAY12: return VPF_FMT_GRAY12;
    default: return VPF_FMT_UNDEFINED;
  }
}

inline int vpf_cs_from_av(AVColorSpace cs) {
  switch (cs) {
    case AVCOL_SPC_BT709: return VPF_CS_BT709;
    case AVCOL_SPC_BT470BG:
    case AVCOL_SPC_SMPTE170M: return VPF_CS_BT601;
    default: return VPF_CS_UNSPEC;
  }
}

inline int vpf_cr_from_av(AVColorRange cr) {
  switch (cr) {
    case AVCOL_RANGE_MPEG: return VPF_CR_MPEG;
    case AVCOL_RANGE_JPEG: return VPF_CR_JPEG;
    default: return VPF_CR_UDEF;
  }
}

// Some codec libraries (notably SVT-AV1) promote the CALLING THREAD to
// SCHED_FIFO during init and never restore it. On a shared host that
// silently turns the whole embedding process realtime: child processes
// starve (RT throttling leaves them ~5% CPU) and even process exit can
// livelock in the kernel at RT priority. Scope-guard any avcodec call
// that may hand control to such a library so the caller's scheduling
// policy survives.
#include <pthread.h>

class VpfSchedPolicyGuard {
 public:
  VpfSchedPolicyGuard() {
    ok_ = pthread_getschedparam(pthread_self(), &policy_, &param_) == 0;
  }
  ~VpfSchedPolicyGuard() {
    if (ok_) pthread_setschedparam(pthread_self(), policy_, &param_);
  }
  VpfSchedPolicyGuard(const VpfSchedPolicyGuard&) = delete;
  VpfSchedPolicyGuard& operator=(const VpfSchedPolicyGuard&) = delete;

 private:
  int policy_ = 0;
  sched_param param_{};
  bool ok_ = false;
};
