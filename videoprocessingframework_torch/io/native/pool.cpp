/* DecodePool: native multi-stream decode scheduler.
 *
 * N worker threads each own a demuxer+decoder session and pack decoded
 * frames straight into slots of a ring of packed batch buffers; the
 * consumer acquires full batches in order and releases them after upload.
 * This is the native equivalent of the reference's stream-per-thread
 * concurrency (samples/SampleDecodeMultiThread.py + the GIL-released
 * per-frame calls), with the batching/ring logic itself in C++ so the
 * Python process only sees whole batches — no interpreter work per frame.
 *
 * Built on the exported demuxer/decoder C API (demuxer.cpp, decoder.cpp).
 */

#include "common.hpp"

#include <atomic>
#include <condition_variable>
#include <cstring>
#include <cstdlib>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#ifdef __linux__
#include <pthread.h>
#include <sched.h>
#endif

/* C API from demuxer.cpp / decoder.cpp */
extern "C" {
void* vpf_demuxer_open(const char*, const char* const*, const char* const*, int);
void vpf_demuxer_close(void*);
int vpf_demuxer_get_props(void*, VpfStreamProps*);
int vpf_demuxer_demux(void*, const uint8_t**, size_t*, VpfPacketData*,
                      const uint8_t**, size_t*);
int vpf_demuxer_codec_id(void*);
void* vpf_decoder_create(int, const uint8_t*, size_t, int, int);
int vpf_demuxer_annexb_extradata(void*, const uint8_t**, size_t*);
void vpf_decoder_destroy(void*);
int vpf_decoder_decode(void*, const uint8_t*, size_t, const VpfPacketData*);
int vpf_decoder_flush_frame(void*);
int vpf_decoder_copy_frame(void*, int, uint8_t*, size_t);
int vpf_decoder_copy_frame_planar3(void*, uint8_t*, uint8_t*, uint8_t*,
                                   size_t);
int vpf_decoder_frame_desc(void*, VpfFrameDesc*);
}

namespace {

struct Batch {
  std::vector<uint8_t> data;  // batch * frame_bytes
  int filled = 0;
  int issued = 0;  // slots handed to workers
};

struct Pool {
  std::vector<std::string> urls;
  int batch = 8;
  size_t frame_bytes = 0;
  int out_fmt = VPF_FMT_NV12;
  int n_buffers = 4;
  int64_t max_frames_per_stream = 0;  // 0 = until EOF
  bool loop = false;
  // plane-major batch layout (YUV420 only): each buffer holds
  // [Y×batch | U×batch | V×batch] so the consumer's per-plane batch
  // views are CONTIGUOUS — the device runtime stages them without any
  // host re-copy (per-frame-interleaved views are strided and cost a
  // full copy per dispatch).
  bool plane_major = false;

  std::vector<Batch> ring;
  std::deque<int> fill_order;   // buffers accepting slots (front = oldest)
  std::deque<int> ready_order;  // full buffers awaiting the consumer
  std::deque<int> held_order;   // buffers held by the consumer (FIFO);
                                // several may be held at once so uploads
                                // to different devices can overlap
  std::mutex mu;
  std::condition_variable cv;
  std::atomic<bool> stop{false};
  // transfer-priority handshake: while paused, workers finish their
  // current frame then sleep — host→device transfers on 1-core hosts
  // are starved 15-100x by a concurrently-decoding worker (measured;
  // see pool.py _RingFeed.batches)
  std::atomic<bool> paused{false};
  std::atomic<long> frames{0};
  std::atomic<long> dropped{0};  // zero-filled slots (copy_frame failures)
  std::vector<std::thread> workers;
#ifdef __linux__
  std::vector<pthread_t> worker_handles;  // for live priority flips
#endif
  std::string error;
  std::string drop_reason;  // first copy_frame failure, for diagnostics
  uint32_t expect_w = 0, expect_h = 0;  // pinned from the first frame
  int live_workers = 0;

  ~Pool() { shutdown(); }

  void shutdown() {
    stop.store(true);
    cv.notify_all();
    for (auto& t : workers)
      if (t.joinable()) t.join();
    workers.clear();
  }

  /* Claim one (buffer, slot); returns false at shutdown. */
  bool claim(int& b, int& s) {
    std::unique_lock<std::mutex> lk(mu);
    for (;;) {
      if (stop.load()) return false;
      if (paused.load()) {
        cv.wait_for(lk, std::chrono::milliseconds(50));
        continue;
      }
      if (!fill_order.empty()) {
        b = fill_order.front();
        s = ring[b].issued++;
        if (ring[b].issued == batch) fill_order.pop_front();
        return true;
      }
      cv.wait_for(lk, std::chrono::milliseconds(50));
    }
  }

  void complete(int b) {
    std::lock_guard<std::mutex> lk(mu);
    if (++ring[b].filled == batch) {
      ready_order.push_back(b);
      cv.notify_all();
    }
  }

  /* One stream's demux+decode session owned by a worker. */
  struct StreamSession {
    int sid = 0;
    void* dmx = nullptr;
    void* dec = nullptr;
    long frames = 0;   // produced so far (caps at max_frames_per_stream)
    bool done = false; // finished for good (EOF and not looping, or cap)

    bool open(Pool& p) {
      dmx = vpf_demuxer_open(p.urls[sid % p.urls.size()].c_str(), nullptr,
                             nullptr, 0);
      if (!dmx) return false;
      /* Annex.B-form parameter sets at open: without them the first
       * access unit's SEI precedes the in-band SPS (BSF output order)
       * and libav warns "non-existing SPS referenced" per stream. */
      const uint8_t* extra = nullptr;
      size_t extra_size = 0;
      vpf_demuxer_annexb_extradata(dmx, &extra, &extra_size);
      dec = vpf_decoder_create(vpf_demuxer_codec_id(dmx), extra, extra_size,
                               0, 0);
      if (!dec) {
        vpf_demuxer_close(dmx);
        dmx = nullptr;
        return false;
      }
      return true;
    }
    void close() {
      if (dec) vpf_decoder_destroy(dec);
      if (dmx) vpf_demuxer_close(dmx);
      dec = dmx = nullptr;
    }
  };

  /* Worker main: each worker owns a GROUP of streams (round-robin within
   * the group) so workers ≈ cores even when streams ≫ cores — 16
   * thread-per-stream sessions on a small host thrash caches/scheduler
   * (the reference's thread-per-stream maps 1:1 onto big GPU hosts; the
   * pool serves any streams:cores ratio). Exactly one live_workers
   * decrement, on exit. */
  void worker_main(int wid) {
    set_idle_priority();
#ifdef __linux__
    {
      std::lock_guard<std::mutex> lk(mu);
      worker_handles.push_back(pthread_self());
    }
#endif
    worker_body(wid);
    std::lock_guard<std::mutex> lk(mu);
    live_workers--;
    cv.notify_all();
  }

  /* Decode workers run at SCHED_IDLE: decode is pure THROUGHPUT work,
   * while the host→device transfer client is LATENCY-sensitive — on a
   * 1-core host a normal-priority decode thread starves it 50-100x
   * (measured r5: uploads of the same buffer ran 1300-1500 MB/s with
   * the worker idle and 9-38 MB/s with it decoding; most of what the
   * bench history called "tunnel weather" was THIS). At SCHED_IDLE the
   * transfer thread preempts instantly whenever it is runnable and the
   * decoder soaks up every remaining cycle — decode throughput with an
   * otherwise-idle host is unchanged (it still gets the whole core).
   * Opt-out: VPF_POOL_NORMAL_PRIORITY=1 (multi-core hosts where decode
   * deserves fair scheduling against unrelated tenants). */
  static void set_idle_priority() {
#ifdef __linux__
    if (getenv("VPF_POOL_NORMAL_PRIORITY")) return;
    struct sched_param sp = {};
    pthread_setschedparam(pthread_self(), SCHED_IDLE, &sp);
#endif
  }

  /* Produce ONE decoded frame from session `ss` into a claimed slot.
   * Returns false when the session finished (EOF without loop / cap /
   * shutdown). */
  bool produce_one(StreamSession& ss) {
    for (;;) {  // may reopen on loop
      if (stop.load()) return false;
      if (max_frames_per_stream && ss.frames >= max_frames_per_stream)
        return false;
      if (!ss.dmx && !ss.open(*this)) {
        fail("stream session open failed");
        return false;
      }
      int r;
      bool eof = false;
      for (;;) {
        const uint8_t* data;
        size_t size;
        VpfPacketData pkt;
        int dr = vpf_demuxer_demux(ss.dmx, &data, &size, &pkt, nullptr,
                                   nullptr);
        if (dr == VPF_OK) {
          r = vpf_decoder_decode(ss.dec, data, size, &pkt);
        } else {
          r = vpf_decoder_flush_frame(ss.dec);
          if (r != VPF_OK) {
            eof = true;
            break;
          }
        }
        if (r == VPF_OK) break;
        if (r < 0 && r != VPF_ERR_EOF) {
          eof = true;
          break;
        }
      }
      if (eof) {
        ss.close();
        if (loop && !stop.load()) continue;  // reopen next iteration
        return false;
      }
      int b, s;
      if (!claim(b, s)) return false;
      uint8_t* base = ring[b].data.data();
      uint8_t* dst = base + (size_t)s * frame_bytes;
      const size_t ysz = frame_bytes * 2 / 3, csz = frame_bytes / 6;
      uint8_t* dy = base + (size_t)s * ysz;
      uint8_t* du = base + (size_t)batch * ysz + (size_t)s * csz;
      uint8_t* dv = du + (size_t)batch * csz;
      // Batch slots have fixed geometry: a mid-stream resolution change
      // (even a shrink, which would still *fit* byte-wise) must be
      // dropped, not silently packed at the wrong layout.
      VpfFrameDesc fd;
      bool geom_ok = vpf_decoder_frame_desc(ss.dec, &fd) == VPF_OK;
      if (geom_ok) {
        std::lock_guard<std::mutex> lk(mu);
        if (expect_w == 0) {
          expect_w = fd.width;
          expect_h = fd.height;
        } else if (fd.width != expect_w || fd.height != expect_h) {
          geom_ok = false;
          vpf_set_error(VPF_ERR, "resolution change %ux%u -> %ux%u",
                        expect_w, expect_h, fd.width, fd.height);
        }
      }
      bool packed_ok =
          geom_ok &&
          (plane_major
               ? vpf_decoder_copy_frame_planar3(ss.dec, dy, du, dv, ysz) ==
                     VPF_OK
               : vpf_decoder_copy_frame(ss.dec, out_fmt, dst, frame_bytes) ==
                     VPF_OK);
      if (!packed_ok) {
        // geometry mismatch (e.g. resolution change): drop the slot by
        // zero-filling so the batch still completes, but COUNT it and
        // keep the first reason so callers can tell corruption from
        // content (vpf_pool_frames_dropped / vpf_pool_drop_reason).
        if (plane_major) {
          memset(dy, 0, ysz);
          memset(du, 0, csz);
          memset(dv, 0, csz);
        } else {
          memset(dst, 0, frame_bytes);
        }
        dropped.fetch_add(1);
        std::lock_guard<std::mutex> lk(mu);
        if (drop_reason.empty()) drop_reason = vpf_error_slot();
      }
      complete(b);
      ss.frames++;
      frames.fetch_add(1);
      return true;
    }
  }

  int n_streams_total = 0;
  int n_workers = 0;

  void worker_body(int wid) {
    std::vector<StreamSession> group;
    for (int sid = wid; sid < n_streams_total; sid += n_workers) {
      StreamSession ss;
      ss.sid = sid;
      group.push_back(ss);
    }
    size_t live = group.size();
    // Chunked round-robin: `batch` consecutive frames per stream turn.
    // One-frame granularity alternates decoder contexts every frame —
    // measured to halve 1080p throughput on a shared core (cache/context
    // thrash); a batch-sized chunk keeps one session hot per turn at the
    // cost of per-stream latency (this pool is the aggregate-throughput
    // path; the Python MultiStreamPipeline serves latency-shaped loads).
    while (live && !stop.load()) {
      for (auto& ss : group) {
        if (ss.done) continue;
        for (int k = 0; k < batch; k++) {
          if (!produce_one(ss)) {
            ss.done = true;
            ss.close();
            live--;
            break;
          }
        }
      }
    }
    for (auto& ss : group) ss.close();
  }

  void fail(const char* what) {
    std::lock_guard<std::mutex> lk(mu);
    if (error.empty()) error = what;
    cv.notify_all();
  }

  /* Consumer: acquire the oldest full batch (or a partial one at end).
   * Multiple batches may be held concurrently (each later released in
   * FIFO order by release()/release_id()). */
  int acquire(const uint8_t** data, int* count) {
    std::unique_lock<std::mutex> lk(mu);
    for (;;) {
      if (!error.empty()) {
        vpf_set_error(VPF_ERR, "%s", error.c_str());
        return VPF_ERR;
      }
      if (!ready_order.empty()) {
        int b = ready_order.front();
        ready_order.pop_front();
        held_order.push_back(b);
        *data = ring[b].data.data();
        *count = ring[b].filled;
        return VPF_OK;
      }
      if (live_workers == 0) {
        // drain a partial buffer if any slots were filled
        for (auto it = fill_order.begin(); it != fill_order.end(); ++it) {
          int b = *it;
          if (ring[b].filled > 0 && ring[b].filled == ring[b].issued) {
            fill_order.erase(it);
            held_order.push_back(b);
            *data = ring[b].data.data();
            *count = ring[b].filled;
            return VPF_OK;
          }
        }
        return VPF_NEED_MORE;  // fully drained
      }
      cv.wait_for(lk, std::chrono::milliseconds(50));
    }
  }

  /* Release the OLDEST held batch (FIFO — matches acquire order). */
  void release() {
    std::lock_guard<std::mutex> lk(mu);
    if (held_order.empty()) return;
    int b = held_order.front();
    held_order.pop_front();
    ring[b].filled = 0;
    ring[b].issued = 0;
    fill_order.push_back(b);
    cv.notify_all();
  }
};

}  // namespace

VPF_API void* vpf_pool_create(const char* const* urls, int n_streams,
                              int batch, size_t frame_bytes, int out_fmt,
                              int loop, int64_t max_frames_per_stream,
                              int n_buffers, int plane_major) {
  if (plane_major && out_fmt != VPF_FMT_YUV420) {
    vpf_set_error(VPF_ERR, "plane_major pool requires YUV420 output");
    return nullptr;
  }
  auto* p = new Pool();
  for (int i = 0; i < n_streams; i++) p->urls.emplace_back(urls[i]);
  p->batch = batch;
  p->frame_bytes = frame_bytes;
  p->out_fmt = out_fmt;
  p->plane_major = plane_major != 0;
  p->loop = loop != 0;
  p->max_frames_per_stream = max_frames_per_stream;
  p->n_buffers = n_buffers > 0 ? n_buffers : 4;
  p->ring.resize(p->n_buffers);
  for (int b = 0; b < p->n_buffers; b++) {
    p->ring[b].data.resize((size_t)batch * frame_bytes);
    p->fill_order.push_back(b);
  }
  // workers ≈ min(streams, cores) — overridable via VPF_POOL_WORKERS.
  // Thread-per-stream beyond the core count was measured to LOSE (cache
  // + scheduler thrash); each worker round-robins its stream group.
  int hw = (int)std::thread::hardware_concurrency();
  if (hw <= 0) hw = 1;
  const char* ov = getenv("VPF_POOL_WORKERS");
  int nworkers = ov ? atoi(ov) : hw;
  if (nworkers <= 0) nworkers = 1;
  if (nworkers > n_streams) nworkers = n_streams;
  p->n_streams_total = n_streams;
  p->n_workers = nworkers;
  p->live_workers = nworkers;
  for (int i = 0; i < nworkers; i++)
    p->workers.emplace_back(&Pool::worker_main, p, i);
  return p;
}

VPF_API int vpf_pool_acquire_batch(void* h, const uint8_t** data,
                                   int* count) {
  return static_cast<Pool*>(h)->acquire(data, count);
}

VPF_API void vpf_pool_release_batch(void* h) {
  static_cast<Pool*>(h)->release();
}

VPF_API long vpf_pool_frames_decoded(void* h) {
  return static_cast<Pool*>(h)->frames.load();
}

VPF_API long vpf_pool_frames_dropped(void* h) {
  return static_cast<Pool*>(h)->dropped.load();
}

/* First copy-failure reason ("" if none). Valid until pool destroy. */
VPF_API const char* vpf_pool_drop_reason(void* h) {
  auto* p = static_cast<Pool*>(h);
  std::lock_guard<std::mutex> lk(p->mu);
  return p->drop_reason.c_str();
}

/* Transfer-priority handshake: paused != 0 puts every worker to sleep
 * after its current frame; 0 wakes them. Used by pool.py batches() to
 * keep decode off the core while a host→device transfer is in flight
 * (1-core hosts: a decoding worker starves the transfer client 15-100x,
 * measured r5). */
VPF_API void vpf_pool_pause(void* h, int paused) {
  auto* p = static_cast<Pool*>(h);
  p->paused.store(paused != 0);
  if (!paused) p->cv.notify_all();
}

/* Flip the decode workers between SCHED_IDLE (the default — yields the
 * core to the latency-sensitive transfer client, right for the paused/
 * serialized transfer_priority mode) and SCHED_OTHER (fair scheduling —
 * right for the OVERLAPPED mode, where SCHED_IDLE starves decode
 * instead: the consumer thread rarely blocks, measured r5 acquire
 * 90 ms/batch vs 4 ms at normal priority). No-op off Linux. */
VPF_API void vpf_pool_worker_priority(void* h, int idle) {
#ifdef __linux__
  auto* p = static_cast<Pool*>(h);
  std::lock_guard<std::mutex> lk(p->mu);
  struct sched_param sp = {};
  for (pthread_t t : p->worker_handles)
    pthread_setschedparam(t, idle ? SCHED_IDLE : SCHED_OTHER, &sp);
#else
  (void)h;
  (void)idle;
#endif
}

VPF_API void vpf_pool_destroy(void* h) { delete static_cast<Pool*>(h); }
