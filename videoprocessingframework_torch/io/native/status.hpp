/* Return codes and thread-local error reporting of the native runtime,
 * free of libav: the JPEG entropy coder (jpeg.cpp, built alone into
 * libvpf_jpeg) includes only this header; common.hpp includes it for the
 * libav runtime (libvpf_host). Each library keeps its own error slot and
 * exports its own vpf_last_error. */
#pragma once

#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>

#define VPF_API extern "C" __attribute__((visibility("default")))

/* ---- return codes ---- */
enum VpfStatus {
  VPF_OK = 1,          /* produced output */
  VPF_NEED_MORE = 0,   /* no output yet / EOF-drained */
  VPF_ERR = -1,        /* generic error; see vpf_last_error() */
  VPF_ERR_DECODE = -2, /* decode error: caller should reset (HwReset analog) */
  VPF_ERR_PARSE = -3,  /* bitstream parse error (parser-exception analog) */
  VPF_ERR_EOF = -4,    /* end of stream */
};

/* ---- thread-local error reporting ---- */

inline std::string& vpf_error_slot() {
  thread_local std::string err;
  return err;
}

inline int vpf_set_error(int code, const char* fmt, ...) {
  char buf[1024];
  va_list ap;
  va_start(ap, fmt);
  vsnprintf(buf, sizeof(buf), fmt, ap);
  va_end(ap);
  vpf_error_slot() = buf;
  return code;
}

VPF_API const char* vpf_last_error(void);
