// bliss_encode: raw f32le interleaved PCM -> encoded audio file.
//
// Fixture/bench generator for the TPU rebuild: the reference repo ships
// pre-encoded test audio (bliss-rs data/*.flac|mp3|ogg) but provides no
// way to build NEW full-length bench fixtures or the AAC/ALAC/M4A files
// its symphonia-all feature matrix covers (bliss-rs Cargo.toml:55-66).
// This tool encodes synthetic or tiled PCM through the SAME libav the
// production decoder links, so cross-decoder tests compare our
// pure-Python decoders against bit-identical ground truth.
//
// Usage:
//   bliss_encode <in.f32le> <out.{flac,mp3,ogg,m4a,wav,...}>
//                <sample_rate> <channels> [codec_name] [bit_rate]
//                [key=value ...codec private options]
//
// The container is inferred from the output extension; the codec
// defaults to the container's default audio codec (pass e.g. "alac" to
// put ALAC instead of AAC inside m4a).

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/channel_layout.h>
#include <libavutil/opt.h>
#include <libswresample/swresample.h>
}

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

static int die(const char *msg, int err = 0) {
  char buf[256] = {0};
  if (err) av_strerror(err, buf, sizeof(buf));
  fprintf(stderr, "bliss_encode: %s %s\n", msg, buf);
  return 1;
}

static AVSampleFormat pick_sample_fmt(const AVCodec *codec) {
  if (!codec->sample_fmts) return AV_SAMPLE_FMT_FLTP;
  for (const AVSampleFormat *f = codec->sample_fmts;
       *f != AV_SAMPLE_FMT_NONE; f++)
    if (*f == AV_SAMPLE_FMT_FLTP) return AV_SAMPLE_FMT_FLTP;
  return codec->sample_fmts[0];
}

static int write_frames(AVFormatContext *fmt, AVCodecContext *enc,
                        AVStream *st, AVFrame *frame, AVPacket *pkt) {
  int ret = avcodec_send_frame(enc, frame);
  if (ret < 0) return ret;
  while (ret >= 0) {
    ret = avcodec_receive_packet(enc, pkt);
    if (ret == AVERROR(EAGAIN) || ret == AVERROR_EOF) return 0;
    if (ret < 0) return ret;
    av_packet_rescale_ts(pkt, enc->time_base, st->time_base);
    pkt->stream_index = st->index;
    ret = av_interleaved_write_frame(fmt, pkt);
    if (ret < 0) return ret;
  }
  return 0;
}

int main(int argc, char **argv) {
  if (argc < 5)
    return die("usage: bliss_encode <in.f32le> <out.ext> <rate> <channels> "
               "[codec] [bit_rate]");
  const char *in_path = argv[1], *out_path = argv[2];
  int rate = atoi(argv[3]), channels = atoi(argv[4]);
  const char *codec_name = argc > 5 ? argv[5] : nullptr;
  int64_t bit_rate = argc > 6 ? atoll(argv[6]) : 0;
  if (rate <= 0 || channels <= 0) return die("bad rate/channels");

  av_log_set_level(AV_LOG_ERROR);

  AVFormatContext *fmt = nullptr;
  int ret = avformat_alloc_output_context2(&fmt, nullptr, nullptr, out_path);
  if (ret < 0 || !fmt) return die("cannot infer output format", ret);

  const AVCodec *codec =
      codec_name ? avcodec_find_encoder_by_name(codec_name)
                 : avcodec_find_encoder(fmt->oformat->audio_codec);
  if (!codec) return die("encoder not found");

  AVCodecContext *enc = avcodec_alloc_context3(codec);
  if (!enc) return die("alloc codec ctx");
  enc->sample_rate = rate;
  av_channel_layout_default(&enc->ch_layout, channels);
  enc->sample_fmt = pick_sample_fmt(codec);
  enc->time_base = AVRational{1, rate};
  if (bit_rate > 0) enc->bit_rate = bit_rate;
  if (fmt->oformat->flags & AVFMT_GLOBALHEADER)
    enc->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;

  AVDictionary *opts = nullptr;
  for (int i = 7; i < argc; i++) {
    const char *eq = strchr(argv[i], '=');
    if (!eq) return die("codec option must be key=value");
    std::string key(argv[i], eq - argv[i]);
    av_dict_set(&opts, key.c_str(), eq + 1, 0);
  }
  ret = avcodec_open2(enc, codec, &opts);
  if (ret < 0) return die("cannot open encoder", ret);
  const AVDictionaryEntry *left = nullptr;
  while ((left = av_dict_get(opts, "", left, AV_DICT_IGNORE_SUFFIX)))
    fprintf(stderr, "bliss_encode: unrecognized option '%s'\n", left->key);
  av_dict_free(&opts);

  AVStream *st = avformat_new_stream(fmt, nullptr);
  if (!st) return die("new stream");
  st->time_base = enc->time_base;
  ret = avcodec_parameters_from_context(st->codecpar, enc);
  if (ret < 0) return die("stream params", ret);

  if (!(fmt->oformat->flags & AVFMT_NOFILE)) {
    ret = avio_open(&fmt->pb, out_path, AVIO_FLAG_WRITE);
    if (ret < 0) return die("cannot open output file", ret);
  }
  ret = avformat_write_header(fmt, nullptr);
  if (ret < 0) return die("write header", ret);

  // f32 interleaved (the canonical PCM this framework works in,
  // bliss-rs src/lib.rs:135-140) -> whatever the encoder wants
  SwrContext *swr = nullptr;
  AVChannelLayout layout;
  av_channel_layout_default(&layout, channels);
  ret = swr_alloc_set_opts2(&swr, &layout, enc->sample_fmt, rate, &layout,
                            AV_SAMPLE_FMT_FLT, rate, 0, nullptr);
  if (ret < 0 || swr_init(swr) < 0) return die("swr init", ret);

  int frame_size = enc->frame_size > 0 ? enc->frame_size : 4096;
  AVFrame *frame = av_frame_alloc();
  frame->format = enc->sample_fmt;
  av_channel_layout_copy(&frame->ch_layout, &enc->ch_layout);
  frame->sample_rate = rate;
  frame->nb_samples = frame_size;
  if (av_frame_get_buffer(frame, 0) < 0) return die("frame buffer");
  AVPacket *pkt = av_packet_alloc();

  FILE *in = strcmp(in_path, "-") == 0 ? stdin : fopen(in_path, "rb");
  if (!in) return die("cannot open input");
  std::vector<float> buf((size_t)frame_size * channels);
  int64_t pts = 0;
  for (;;) {
    size_t got =
        fread(buf.data(), sizeof(float) * channels, frame_size, in);
    if (got == 0) break;
    if (av_frame_make_writable(frame) < 0) return die("frame writable");
    frame->nb_samples = (int)got;
    const uint8_t *in_data[1] = {
        reinterpret_cast<const uint8_t *>(buf.data())};
    int out_n = swr_convert(swr, frame->data, (int)got, in_data, (int)got);
    if (out_n < 0) return die("swr convert", out_n);
    frame->pts = pts;
    pts += frame->nb_samples;
    ret = write_frames(fmt, enc, st, frame, pkt);
    if (ret < 0) return die("encode", ret);
    if (got < (size_t)frame_size) break;
  }
  if (in != stdin) fclose(in);
  ret = write_frames(fmt, enc, st, nullptr, pkt);  // flush
  if (ret < 0) return die("flush", ret);
  ret = av_write_trailer(fmt);
  if (ret < 0) return die("trailer", ret);

  if (!(fmt->oformat->flags & AVFMT_NOFILE)) avio_closep(&fmt->pb);
  av_packet_free(&pkt);
  av_frame_free(&frame);
  swr_free(&swr);
  av_channel_layout_uninit(&layout);
  avcodec_free_context(&enc);
  avformat_free_context(fmt);
  return 0;
}
