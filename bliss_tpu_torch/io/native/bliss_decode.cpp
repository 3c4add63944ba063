// bliss_tpu native audio decoder.
//
// Decodes any audio container/codec supported by libav* into the canonical
// bliss PCM format: f32le, mono, 22050 Hz — the exact output of
// `ffmpeg -i X -ar 22050 -ac 1 -c:a pcm_f32le` (bit-identical, verified by
// adler32 golden hashes; see reference bliss-rs src/song/decoder/ffmpeg.rs:379-527).
//
// Behavioral contract mirrors the reference FFmpegDecoder
// (reference src/song/decoder/ffmpeg.rs:134-362):
//   * best audio stream selection
//   * frame-threaded codec (auto thread count)
//   * swresample with default options to f32/mono/22050
//   * decoder flush + resampler drain at EOF
//   * format-level metadata extraction (title/artist/album/album_artist/
//     genre/track/disc)
//   * empty channel-layout fallback to the default layout for the channel
//     count (ffmpeg.rs:249-261)
//
// Exposed as a tiny C ABI consumed from Python via ctypes.

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/channel_layout.h>
#include <libavutil/dict.h>
#include <libavutil/log.h>
#include <libavutil/opt.h>
#include <libswresample/swresample.h>
}

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr int kTargetRate = 22050;

struct DecodeResult {
  float* samples = nullptr;
  int64_t n_samples = 0;
  // metadata (UTF-8, strdup'ed; nullptr if missing/empty)
  char* title = nullptr;
  char* artist = nullptr;
  char* album = nullptr;
  char* album_artist = nullptr;
  char* genre = nullptr;
  char* track = nullptr;
  char* disc = nullptr;
  char* error = nullptr;  // nullptr on success
};

char* dup_tag(AVDictionary* meta, const char* key) {
  AVDictionaryEntry* e = av_dict_get(meta, key, nullptr, 0);
  if (!e || !e->value || e->value[0] == '\0') return nullptr;
  return strdup(e->value);
}

void set_error(DecodeResult* res, const std::string& msg) {
  res->error = strdup(msg.c_str());
}

std::string av_err_str(int err) {
  char buf[AV_ERROR_MAX_STRING_SIZE] = {0};
  av_strerror(err, buf, sizeof(buf));
  return std::string(buf);
}

class Resampler {
 public:
  int init(const AVCodecContext* dec, DecodeResult* res) {
    AVChannelLayout out_layout = AV_CHANNEL_LAYOUT_MONO;
    // zero-init: av_channel_layout_copy uninits dst before copying
    AVChannelLayout in_layout = {};
    if (dec->ch_layout.order == AV_CHANNEL_ORDER_UNSPEC) {
      // Fallback matching reference ffmpeg.rs:249-261.
      av_channel_layout_default(&in_layout, dec->ch_layout.nb_channels);
    } else {
      av_channel_layout_copy(&in_layout, &dec->ch_layout);
    }
    int ret = swr_alloc_set_opts2(&swr_, &out_layout, AV_SAMPLE_FMT_FLT,
                                  kTargetRate, &in_layout, dec->sample_fmt,
                                  dec->sample_rate, 0, nullptr);
    if (ret < 0 || !swr_) {
      set_error(res, "while trying to allocate resampling context: " +
                         av_err_str(ret));
      return -1;
    }
    ret = swr_init(swr_);
    if (ret < 0) {
      set_error(res, "while initializing resampling context: " +
                         av_err_str(ret));
      return -1;
    }
    in_rate_ = dec->sample_rate;
    return 0;
  }

  // Convert one decoded frame (or drain with frame == nullptr) into `out`.
  int convert(const AVFrame* frame, std::vector<float>* out,
              DecodeResult* res) {
    int in_count = frame ? frame->nb_samples : 0;
    int64_t out_bound =
        av_rescale_rnd(swr_get_delay(swr_, in_rate_) + in_count, kTargetRate,
                       in_rate_, AV_ROUND_UP) +
        64;
    if (buf_.size() < static_cast<size_t>(out_bound)) buf_.resize(out_bound);
    uint8_t* out_planes[1] = {reinterpret_cast<uint8_t*>(buf_.data())};
    int got = swr_convert(swr_, out_planes, static_cast<int>(out_bound),
                          frame ? const_cast<const uint8_t**>(
                                      const_cast<uint8_t**>(frame->data))
                                : nullptr,
                          in_count);
    if (got < 0) {
      set_error(res, "while trying to resample song: " + av_err_str(got));
      return -1;
    }
    out->insert(out->end(), buf_.data(), buf_.data() + got);
    return got;
  }

  ~Resampler() {
    if (swr_) swr_free(&swr_);
  }

 private:
  SwrContext* swr_ = nullptr;
  int in_rate_ = 0;
  std::vector<float> buf_;
};

}  // namespace

extern "C" {

// Decode `path` to f32/mono/22050. Returns a heap-allocated DecodeResult;
// caller must free it with bliss_decode_free(). On failure, `error` is set
// and `samples` is nullptr.
DecodeResult* bliss_decode(const char* path) {
  av_log_set_level(AV_LOG_QUIET);
  auto* res = new DecodeResult();

  AVFormatContext* fmt = nullptr;
  int ret = avformat_open_input(&fmt, path, nullptr, nullptr);
  if (ret < 0) {
    set_error(res, std::string("while opening format for file '") + path +
                       "': " + av_err_str(ret) + ".");
    return res;
  }
  ret = avformat_find_stream_info(fmt, nullptr);
  if (ret < 0) {
    set_error(res, std::string("could not find stream info for file '") +
                       path + "': " + av_err_str(ret) + ".");
    avformat_close_input(&fmt);
    return res;
  }

  const AVCodec* codec = nullptr;
  int stream_idx =
      av_find_best_stream(fmt, AVMEDIA_TYPE_AUDIO, -1, -1, &codec, 0);
  if (stream_idx < 0 || !codec) {
    set_error(res, std::string("No audio stream found for file '") + path +
                       "'.");
    avformat_close_input(&fmt);
    return res;
  }
  AVStream* stream = fmt->streams[stream_idx];

  AVCodecContext* dec = avcodec_alloc_context3(codec);
  if (!dec ||
      avcodec_parameters_to_context(dec, stream->codecpar) < 0) {
    set_error(res, std::string("Could not load the codec context for file '") +
                       path + "'.");
    if (dec) avcodec_free_context(&dec);
    avformat_close_input(&fmt);
    return res;
  }
  // Frame threading with auto thread count (reference ffmpeg.rs:172-177).
  dec->thread_type = FF_THREAD_FRAME;
  dec->thread_count = 0;
  ret = avcodec_open2(dec, codec, nullptr);
  if (ret < 0) {
    set_error(res, std::string("when finding decoder for file '") + path +
                       "': " + av_err_str(ret) + ".");
    avcodec_free_context(&dec);
    avformat_close_input(&fmt);
    return res;
  }

  // Format-level metadata (reference ffmpeg.rs:200-247).
  res->title = dup_tag(fmt->metadata, "title");
  res->artist = dup_tag(fmt->metadata, "artist");
  res->album = dup_tag(fmt->metadata, "album");
  res->album_artist = dup_tag(fmt->metadata, "album_artist");
  res->genre = dup_tag(fmt->metadata, "genre");
  res->track = dup_tag(fmt->metadata, "track");
  res->disc = dup_tag(fmt->metadata, "disc");

  std::vector<float> samples;
  if (stream->duration > 0 && stream->time_base.den > 0) {
    double secs = static_cast<double>(stream->duration) *
                  stream->time_base.num / stream->time_base.den;
    samples.reserve(static_cast<size_t>((secs + 1.0) * kTargetRate));
  }

  Resampler resampler;
  bool resampler_ready = false;

  AVPacket* pkt = av_packet_alloc();
  AVFrame* frame = av_frame_alloc();

  auto cleanup = [&]() {
    av_frame_free(&frame);
    av_packet_free(&pkt);
    avcodec_free_context(&dec);
    avformat_close_input(&fmt);
  };

  auto drain_decoder = [&](bool flushing) -> int {
    while (true) {
      int r = avcodec_receive_frame(dec, frame);
      if (r == AVERROR(EAGAIN) || r == AVERROR_EOF) return 0;
      if (r < 0) return 0;  // skip corrupt frames, like the reference warns
      if (!resampler_ready) {
        if (resampler.init(dec, res) < 0) return -1;
        resampler_ready = true;
      }
      if (resampler.convert(frame, &samples, res) < 0) return -1;
      av_frame_unref(frame);
    }
    (void)flushing;
  };

  bool failed = false;
  while (av_read_frame(fmt, pkt) >= 0) {
    if (pkt->stream_index != stream_idx) {
      av_packet_unref(pkt);
      continue;
    }
    ret = avcodec_send_packet(dec, pkt);
    av_packet_unref(pkt);
    if (ret == AVERROR(EINVAL)) {
      set_error(res, std::string("wrong codec opened for file '") + path +
                         "'.");
      failed = true;
      break;
    }
    // Other send errors: skip packet with a shrug (reference warns + continues).
    if (drain_decoder(false) < 0) {
      failed = true;
      break;
    }
  }

  if (!failed) {
    // Flush decoder.
    avcodec_send_packet(dec, nullptr);
    if (drain_decoder(true) < 0) failed = true;
  }
  if (!failed && resampler_ready) {
    // Drain swresample (reference ffmpeg.rs:93-107).
    while (true) {
      int got = resampler.convert(nullptr, &samples, res);
      if (got < 0) {
        failed = true;
        break;
      }
      if (got == 0) break;
    }
  }

  cleanup();

  if (failed) {
    // keep error, no samples
    return res;
  }

  res->n_samples = static_cast<int64_t>(samples.size());
  if (res->n_samples > 0) {
    res->samples =
        static_cast<float*>(malloc(sizeof(float) * samples.size()));
    memcpy(res->samples, samples.data(), sizeof(float) * samples.size());
  }
  return res;
}

void bliss_decode_free(DecodeResult* res) {
  if (!res) return;
  free(res->samples);
  free(res->title);
  free(res->artist);
  free(res->album);
  free(res->album_artist);
  free(res->genre);
  free(res->track);
  free(res->disc);
  free(res->error);
  delete res;
}

}  // extern "C"
