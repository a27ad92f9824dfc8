// mccvideo writer: native encode runtime (the PyTorch port's copy of
// native/src/video_writer.cc, built by ops/_build.load_host_library), the
// counterpart of video_loader.cc. The reference encodes QC overlay videos through
// imageio's ffmpeg subprocess (reference viz.py:296-298); here the mux +
// encode runs in-process: libavformat chooses the container from the path,
// the first working encoder among {container default, mpeg4, ffv1, rawvideo}
// is used, and swscale converts incoming BGR24/GRAY8 frames to the encoder's
// pixel format.
//
// C API:
//   void* mccw_open(const char* path, int w, int h, double fps, int gray)
//   int   mccw_write(void*, const unsigned char* frame)   // one frame
//   int   mccw_close(void*)                                // flush + trailer
//   const char* mccw_last_error(void*)

#include <cstdint>
#include <cstring>
#include <string>

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libavutil/opt.h>
#include <libswscale/swscale.h>
}

namespace {

class VideoWriter {
 public:
  bool failed = false;

  VideoWriter(const char* path, int w, int h, double fps, bool gray,
              int64_t bit_rate = 0)
      : path_(path), w_(w), h_(h), fps_(fps), gray_(gray),
        bit_rate_(bit_rate) {}

  ~VideoWriter() { close(); }

  bool open() {
    av_log_set_level(AV_LOG_ERROR);  // keep encoder chatter out of pipelines
    avformat_alloc_output_context2(&fmt_, nullptr, nullptr, path_.c_str());
    if (!fmt_) {
      err_ = "could not infer container from path " + path_;
      return false;
    }
    // Encoder preference: MPEG4 first — this image's libx264 emits a
    // trailing packet neither libavcodec nor cv2 decodes (measured: 10
    // frames in, 9 out, on .mp4 even with bf=0), and a calibration/QC
    // video that silently loses its last frame is worse than a bigger
    // one. Container default and portable fallbacks after.
    const AVCodec* enc = nullptr;
    AVCodecID cands[] = {AV_CODEC_ID_MPEG4, fmt_->oformat->video_codec,
                         AV_CODEC_ID_FFV1, AV_CODEC_ID_RAWVIDEO};
    for (AVCodecID id : cands) {
      if (id == AV_CODEC_ID_NONE) continue;
      // Only codecs the container can actually mux (y4m takes rawvideo
      // only — an encoder that opens but fails at write_header is useless).
      if (avformat_query_codec(fmt_->oformat, id, FF_COMPLIANCE_NORMAL) <= 0) {
        continue;
      }
      enc = avcodec_find_encoder(id);
      if (enc && try_open_encoder(enc)) break;
      enc = nullptr;
    }
    if (!enc) {
      err_ = "no usable encoder for " + path_;
      return false;
    }
    stream_ = avformat_new_stream(fmt_, enc);
    if (!stream_) {
      err_ = "could not create stream";
      return false;
    }
    stream_->time_base = ctx_->time_base;
    avcodec_parameters_from_context(stream_->codecpar, ctx_);

    if (!(fmt_->oformat->flags & AVFMT_NOFILE)) {
      if (avio_open(&fmt_->pb, path_.c_str(), AVIO_FLAG_WRITE) < 0) {
        err_ = "could not open " + path_ + " for writing";
        return false;
      }
    }
    if (avformat_write_header(fmt_, nullptr) < 0) {
      err_ = "could not write header";
      return false;
    }
    header_written_ = true;

    sws_ = sws_getContext(w_, h_, gray_ ? AV_PIX_FMT_GRAY8 : AV_PIX_FMT_BGR24,
                          w_, h_, ctx_->pix_fmt, SWS_BILINEAR, nullptr,
                          nullptr, nullptr);
    // Incoming frames are full-range; encode with matching coefficients.
    const int* tbl = sws_getCoefficients(SWS_CS_ITU601);
    sws_setColorspaceDetails(sws_, tbl, 1, tbl,
                             ctx_->color_range == AVCOL_RANGE_JPEG ? 1 : 0, 0,
                             1 << 16, 1 << 16);
    frame_ = av_frame_alloc();
    frame_->format = ctx_->pix_fmt;
    frame_->width = w_;
    frame_->height = h_;
    if (av_frame_get_buffer(frame_, 0) < 0) {
      err_ = "frame alloc failed";
      return false;
    }
    pkt_ = av_packet_alloc();
    return sws_ != nullptr;
  }

  bool write(const uint8_t* data) {
    if (av_frame_make_writable(frame_) < 0) return fail("frame not writable");
    const uint8_t* src[4] = {data, nullptr, nullptr, nullptr};
    int src_lines[4] = {gray_ ? w_ : w_ * 3, 0, 0, 0};
    sws_scale(sws_, src, src_lines, 0, h_, frame_->data, frame_->linesize);
    frame_->pts = pts_++;
    if (avcodec_send_frame(ctx_, frame_) < 0) return fail("encode failed");
    return drain(false);
  }

  bool close() {
    if (closed_) return true;
    closed_ = true;
    bool ok = true;
    if (ctx_ && header_written_) {
      avcodec_send_frame(ctx_, nullptr);
      ok = drain(true);
      av_write_trailer(fmt_);
    }
    if (frame_) av_frame_free(&frame_);
    if (pkt_) av_packet_free(&pkt_);
    if (sws_) sws_freeContext(sws_);
    if (ctx_) avcodec_free_context(&ctx_);
    if (fmt_) {
      if (!(fmt_->oformat->flags & AVFMT_NOFILE) && fmt_->pb) {
        avio_closep(&fmt_->pb);
      }
      avformat_free_context(fmt_);
      fmt_ = nullptr;
    }
    return ok;
  }

  const char* last_error() const { return err_.c_str(); }

 private:
  bool try_open_encoder(const AVCodec* enc) {
    if (ctx_) avcodec_free_context(&ctx_);
    ctx_ = avcodec_alloc_context3(enc);
    if (!ctx_) return false;
    ctx_->width = w_;
    ctx_->height = h_;
    int fps_num = static_cast<int>(fps_ * 1000 + 0.5);
    ctx_->time_base = AVRational{1000, fps_num};
    ctx_->framerate = AVRational{fps_num, 1000};
    ctx_->pix_fmt = enc->pix_fmts ? enc->pix_fmts[0] : AV_PIX_FMT_YUV420P;
    ctx_->gop_size = 12;
    // No B-frames: decode order == display order, so every written frame
    // round-trips (x264's trailing B at stream end is dropped by
    // libavcodec AND cv2's decoder — measured: 10 in, 9 out on .mp4), and
    // frame indices stay monotonic for the loader's random access.
    ctx_->max_b_frames = 0;
    av_opt_set(ctx_->priv_data, "bf", "0", 0);
    // Default: generous rate (QC overlays value fidelity over size), CRF
    // for codecs that honor it (x264), bitrate fallback for the rest. A
    // caller-supplied bit_rate overrides both — used by the codec
    // round-trip robustness suite to encode at realistic lossy rates.
    if (bit_rate_ > 0) {
      ctx_->bit_rate = bit_rate_;
    } else {
      ctx_->bit_rate = static_cast<int64_t>(w_) * h_ * fps_;
      av_opt_set(ctx_->priv_data, "crf", "18", 0);
    }
    if (fmt_->oformat->flags & AVFMT_GLOBALHEADER) {
      ctx_->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
    }
    return avcodec_open2(ctx_, enc, nullptr) >= 0;
  }

  bool drain(bool flush) {
    while (true) {
      int r = avcodec_receive_packet(ctx_, pkt_);
      if (r == AVERROR(EAGAIN)) return true;
      if (r == AVERROR_EOF) return true;
      if (r < 0) return fail("packet receive failed");
      av_packet_rescale_ts(pkt_, ctx_->time_base, stream_->time_base);
      pkt_->stream_index = stream_->index;
      // The mp4 muxer DROPS the final sample when packet durations are 0
      // (measured: encoder emits N, file demuxes N-1); stamp one frame
      // interval so every written frame survives the container.
      if (pkt_->duration == 0) {
        pkt_->duration =
            av_rescale_q(1, ctx_->time_base, stream_->time_base);
      }
      if (av_interleaved_write_frame(fmt_, pkt_) < 0) {
        return fail("write frame failed");
      }
    }
    (void)flush;
  }

  bool fail(const char* msg) {
    err_ = msg;
    return false;
  }

  std::string path_;
  int w_, h_;
  double fps_;
  bool gray_;
  int64_t bit_rate_ = 0;
  AVFormatContext* fmt_ = nullptr;
  AVCodecContext* ctx_ = nullptr;
  AVStream* stream_ = nullptr;
  SwsContext* sws_ = nullptr;
  AVFrame* frame_ = nullptr;
  AVPacket* pkt_ = nullptr;
  int64_t pts_ = 0;
  bool header_written_ = false;
  bool closed_ = false;
  std::string err_;
};

}  // namespace

extern "C" {

void* mccw_open(const char* path, int w, int h, double fps, int gray) {
  auto* v = new VideoWriter(path, w, h, fps, gray != 0);
  if (!v->open()) v->failed = true;
  return v;
}

// Extended open with an explicit encoder bitrate (bits/s; 0 = the default
// generous-rate policy).
void* mccw_open_ex(const char* path, int w, int h, double fps, int gray,
                   int64_t bit_rate) {
  auto* v = new VideoWriter(path, w, h, fps, gray != 0, bit_rate);
  if (!v->open()) v->failed = true;
  return v;
}

int mccw_write(void* hd, const unsigned char* frame) {
  auto* v = static_cast<VideoWriter*>(hd);
  if (v->failed) return 1;
  return v->write(frame) ? 0 : 1;
}

int mccw_close(void* hd) {
  auto* v = static_cast<VideoWriter*>(hd);
  int rc = v->failed ? 1 : (v->close() ? 0 : 1);
  delete v;
  return rc;
}

const char* mccw_last_error(void* hd) {
  return static_cast<VideoWriter*>(hd)->last_error();
}

}  // extern "C"
