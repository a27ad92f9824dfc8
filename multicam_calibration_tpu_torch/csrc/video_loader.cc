// mccvideo: native video decode runtime (the PyTorch port's copy of
// native/src/video_loader.cc, built by ops/_build.load_host_library).
//
// Replaces the reference's host-side frame pipeline (OpenCV VideoCapture via
// vidio + a multiprocessing worker pool that PICKLES raw frames between
// processes, reference detection.py:32-144) with a zero-copy C++ loader:
// libavformat/libavcodec demux+decode on a background thread per video,
// swscale conversion to GRAY8 (or BGR24), frames landing in a bounded ring
// buffer that the Python side drains directly into numpy arrays. Decode
// overlaps device compute; no serialization anywhere.
//
// C API (ctypes-friendly, all plain C types):
//   void*  mccv_open(const char* path, int gray, int prefetch_frames)
//   int    mccv_info(void*, int* w, int* h, long long* n_frames, double* fps)
//   long long mccv_read(void*, unsigned char* buf, long long max_frames)
//   int    mccv_seek_frame(void*, long long frame_index)
//   void   mccv_close(void*)
//   const char* mccv_last_error(void*)
//
// n_frames is best-effort (containers like y4m don't store it): -1 when
// unknown — callers read until mccv_read returns 0.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libswscale/swscale.h>
}

namespace {

struct Frame {
  std::vector<uint8_t> data;
  int64_t index;
};

class VideoLoader {
 public:
  bool failed = false;

  VideoLoader(const char* path, bool gray, int prefetch_frames)
      : path_(path), gray_(gray), prefetch_(prefetch_frames > 0 ? prefetch_frames : 64) {}

  ~VideoLoader() {
    stop();
    if (sws_) sws_freeContext(sws_);
    if (ctx_) avcodec_free_context(&ctx_);
    if (fmt_) avformat_close_input(&fmt_);
  }

  bool open() {
    if (avformat_open_input(&fmt_, path_.c_str(), nullptr, nullptr) < 0) {
      err_ = "could not open " + path_;
      return false;
    }
    if (avformat_find_stream_info(fmt_, nullptr) < 0) {
      err_ = "no stream info in " + path_;
      return false;
    }
    stream_idx_ = av_find_best_stream(fmt_, AVMEDIA_TYPE_VIDEO, -1, -1, &codec_, 0);
    if (stream_idx_ < 0 || !codec_) {
      err_ = "no video stream in " + path_;
      return false;
    }
    AVStream* st = fmt_->streams[stream_idx_];
    ctx_ = avcodec_alloc_context3(codec_);
    if (!ctx_ || avcodec_parameters_to_context(ctx_, st->codecpar) < 0) {
      err_ = "codec context failure";
      return false;
    }
    // In-codec threading for heavy codecs (h264 etc).
    ctx_->thread_count = 0;  // auto
    ctx_->thread_type = FF_THREAD_FRAME | FF_THREAD_SLICE;
    if (avcodec_open2(ctx_, codec_, nullptr) < 0) {
      err_ = "could not open codec";
      return false;
    }
    width_ = ctx_->width;
    height_ = ctx_->height;
    if (width_ <= 0 || height_ <= 0) {
      err_ = "bad dimensions";
      return false;
    }
    // Best-effort frame count.
    n_frames_ = st->nb_frames;
    if (n_frames_ <= 0 && st->duration > 0 && st->avg_frame_rate.num > 0) {
      n_frames_ = av_rescale_q(st->duration, st->time_base,
                               av_inv_q(st->avg_frame_rate));
    }
    if (n_frames_ <= 0) n_frames_ = -1;
    fps_ = st->avg_frame_rate.num > 0 ? av_q2d(st->avg_frame_rate) : 30.0;

    AVPixelFormat dst = gray_ ? AV_PIX_FMT_GRAY8 : AV_PIX_FMT_BGR24;
    sws_ = sws_getContext(width_, height_, ctx_->pix_fmt, width_, height_, dst,
                          SWS_BILINEAR, nullptr, nullptr, nullptr);
    if (!sws_) {
      err_ = "swscale init failure";
      return false;
    }
    // Honor the stream's YUV range (e.g. y4m C420jpeg = full range) —
    // swscale otherwise assumes limited range and silently rescales Y.
    int src_range = ctx_->color_range == AVCOL_RANGE_JPEG ? 1 : 0;
    const int* tbl = sws_getCoefficients(SWS_CS_ITU601);
    sws_setColorspaceDetails(sws_, tbl, src_range, tbl, /*dstRange=*/1, 0,
                             1 << 16, 1 << 16);
    frame_bytes_ = static_cast<size_t>(width_) * height_ * (gray_ ? 1 : 3);
    start();
    return true;
  }

  int width() const { return width_; }
  int height() const { return height_; }
  int64_t n_frames() const { return n_frames_; }
  double fps() const { return fps_; }
  const char* last_error() const { return err_.c_str(); }

  // Pop up to max_frames decoded frames into buf (contiguous HxW[x3] each).
  int64_t read(uint8_t* buf, int64_t max_frames) {
    int64_t got = 0;
    std::unique_lock<std::mutex> lk(mu_);
    while (got < max_frames) {
      cv_pop_.wait(lk, [&] { return !queue_.empty() || done_; });
      if (queue_.empty()) break;  // done_ and drained
      Frame& f = queue_.front();
      std::memcpy(buf + got * frame_bytes_, f.data.data(), frame_bytes_);
      queue_.pop_front();
      ++got;
      cv_push_.notify_one();
    }
    return got;
  }

  // Restart decoding from an absolute frame index (stops + reseeks + refills).
  bool seek(int64_t frame_index) {
    stop();
    {
      std::lock_guard<std::mutex> lk(mu_);
      queue_.clear();
      done_ = false;
    }
    AVStream* st = fmt_->streams[stream_idx_];
    int64_t ts = 0;
    // Without reliable pts, frame indices come from a running counter — the
    // only way to label frames correctly after a seek is to restart from
    // frame 0 and drop forward (BACKWARD seeks land on an unknown earlier
    // keyframe, which the counter cannot account for).
    bool indexable = pts_reliable_ && st->avg_frame_rate.num > 0;
    if (indexable) {
      ts = av_rescale_q(frame_index, av_inv_q(st->avg_frame_rate), st->time_base);
    }
    if (av_seek_frame(fmt_, stream_idx_, indexable ? ts : 0,
                      AVSEEK_FLAG_BACKWARD) < 0) {
      err_ = "seek failed";
      return false;
    }
    avcodec_flush_buffers(ctx_);
    skip_until_ = frame_index;
    counter_base_ = indexable ? frame_index : 0;
    start();
    return true;
  }

 private:
  void start() {
    stop_requested_ = false;
    worker_ = std::thread([this] { decode_loop(); });
  }

  void stop() {
    stop_requested_ = true;
    cv_push_.notify_all();
    if (worker_.joinable()) worker_.join();
  }

  void push(Frame&& f) {
    std::unique_lock<std::mutex> lk(mu_);
    cv_push_.wait(lk, [&] {
      return queue_.size() < static_cast<size_t>(prefetch_) || stop_requested_;
    });
    if (stop_requested_) return;
    queue_.push_back(std::move(f));
    cv_pop_.notify_one();
  }

  void finish() {
    std::lock_guard<std::mutex> lk(mu_);
    done_ = true;
    cv_pop_.notify_all();
  }

  // Frame index from pts (exact across seeks for containers with pts);
  // falls back to a running counter for streams without timestamps.
  int64_t frame_index_of(const AVFrame* frm, int64_t counter) {
    if (frm->pts == AV_NOPTS_VALUE) return counter;
    AVStream* st = fmt_->streams[stream_idx_];
    if (st->avg_frame_rate.num <= 0) return counter;
    pts_reliable_ = true;
    int64_t pts = frm->pts;
    if (st->start_time != AV_NOPTS_VALUE) pts -= st->start_time;
    return av_rescale_q(pts, st->time_base, av_inv_q(st->avg_frame_rate));
  }

  void decode_loop() {
    AVPacket* pkt = av_packet_alloc();
    AVFrame* frm = av_frame_alloc();
    int64_t counter = counter_base_;
    bool flushing = false;
    int flush_spins = 0;
    while (!stop_requested_) {
      if (!flushing) {
        int r = av_read_frame(fmt_, pkt);
        if (r < 0) {
          flushing = true;
          avcodec_send_packet(ctx_, nullptr);  // drain
        } else if (pkt->stream_index != stream_idx_) {
          av_packet_unref(pkt);
          continue;
        } else {
          avcodec_send_packet(ctx_, pkt);
          av_packet_unref(pkt);
        }
      }
      while (!stop_requested_) {
        int r = avcodec_receive_frame(ctx_, frm);
        if (r == AVERROR(EAGAIN)) break;
        if (r == AVERROR_EOF) {
          finish();
          av_frame_free(&frm);
          av_packet_free(&pkt);
          return;
        }
        if (r < 0) break;
        int64_t idx = frame_index_of(frm, counter);
        counter = idx + 1;
        if (idx < skip_until_) {  // post-seek: drop frames before target
          av_frame_unref(frm);
          continue;
        }
        Frame out;
        out.index = idx;
        out.data.resize(frame_bytes_);
        uint8_t* dst_data[4] = {out.data.data(), nullptr, nullptr, nullptr};
        int dst_lines[4] = {gray_ ? width_ : width_ * 3, 0, 0, 0};
        sws_scale(sws_, frm->data, frm->linesize, 0, height_, dst_data, dst_lines);
        av_frame_unref(frm);
        push(std::move(out));
      }
      if (flushing) {
        // receive loop exits only via EOF above or EAGAIN (won't happen when
        // flushing); guard against codecs that return EAGAIN while draining,
        // and bound the spin so a misbehaving codec can't busy-loop forever.
        if (++flush_spins > 10000) break;
        std::this_thread::yield();
      }
    }
    av_frame_free(&frm);
    av_packet_free(&pkt);
    finish();
  }

  std::string path_;
  bool gray_;
  int prefetch_;
  AVFormatContext* fmt_ = nullptr;
  AVCodecContext* ctx_ = nullptr;
  const AVCodec* codec_ = nullptr;
  SwsContext* sws_ = nullptr;
  int stream_idx_ = -1;
  int width_ = 0, height_ = 0;
  int64_t n_frames_ = -1;
  double fps_ = 30.0;
  size_t frame_bytes_ = 0;
  int64_t skip_until_ = 0;
  int64_t counter_base_ = 0;
  // Written by the decode thread, read by the caller thread in seek()
  // (after stop() joins the worker, but atomic so a future read path
  // without the join stays race-free).
  std::atomic<bool> pts_reliable_{false};

  std::thread worker_;
  std::mutex mu_;
  std::condition_variable cv_pop_, cv_push_;
  std::deque<Frame> queue_;
  bool done_ = false;
  std::atomic<bool> stop_requested_{false};
  std::string err_;
};

}  // namespace

extern "C" {

void* mccv_open(const char* path, int gray, int prefetch_frames) {
  auto* v = new VideoLoader(path, gray != 0, prefetch_frames);
  if (!v->open()) {
    // Return the handle anyway so the caller can read the error, flagged by
    // mccv_info returning nonzero.
    v->failed = true;
  }
  return v;
}

int mccv_info(void* h, int* w, int* hgt, long long* n_frames, double* fps) {
  auto* v = static_cast<VideoLoader*>(h);
  if (v->failed) return 1;
  *w = v->width();
  *hgt = v->height();
  *n_frames = v->n_frames();
  *fps = v->fps();
  return 0;
}

long long mccv_read(void* h, unsigned char* buf, long long max_frames) {
  auto* v = static_cast<VideoLoader*>(h);
  if (v->failed) return -1;
  return v->read(buf, max_frames);
}

int mccv_seek_frame(void* h, long long frame_index) {
  auto* v = static_cast<VideoLoader*>(h);
  if (v->failed) return 1;
  return v->seek(frame_index) ? 0 : 1;
}

const char* mccv_last_error(void* h) {
  return static_cast<VideoLoader*>(h)->last_error();
}

void mccv_close(void* h) { delete static_cast<VideoLoader*>(h); }

}  // extern "C"
