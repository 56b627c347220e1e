/* In-memory audio decode via the system ffmpeg libraries (libavformat /
 * libavcodec / libswresample): the port's copy of the JAX package's
 * fish_speech_tpu/native/av_decode.c.
 *
 * Two jobs:
 *   1. Input-format parity: the reference loads reference/prompt audio with
 *      torchaudio/soundfile, which accept mp3/ogg/flac/... beyond WAV
 *      (reference fish_speech/utils/file.py audio extensions, served via
 *      tools/server inputs). `load_audio` falls back to this decoder for
 *      anything the self-contained WAV/FLAC readers don't handle.
 *   2. Cross-validation oracle: ffmpeg's independent FLAC/mp3/opus decoders
 *      verify the from-scratch FLAC encoder (audio/transcode.py) and the
 *      from-scratch Ogg container (audio/libcodec.py) in tests.
 *
 * API (ctypes; see fish_speech_tpu_torch/audio/libav.py):
 *   fsav_decode(data, size, out, out_cap, &nwritten, &sr, &ch) -> rc
 *     rc  0: success; out holds nwritten floats (interleaved, ch channels)
 *     rc -3: out_cap too small; *nwritten = floats produced so far (caller
 *            grows the buffer and retries; decode length of a compressed
 *            stream is not knowable up front)
 *     rc -1: open/demux error   rc -2: no audio stream / no decoder
 *     rc -4: decode error       rc -5: resampler error
 *     rc -6: mid-stream channel-layout change, or the stream demuxed but
 *            produced zero audio samples
 *
 * Build: fish_speech_tpu_torch/native/__init__.py:build_av, at first use
 * (gcc -lavformat -lavcodec -lavutil -lswresample) into build/native/.
 * Loads lazily; absence of the libraries just
 * disables the fallback (TranscodeUnavailable), matching the libcodec.py
 * policy.
 */

#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/opt.h>
#include <libswresample/swresample.h>
#include <stdint.h>
#include <string.h>

typedef struct {
  const uint8_t *data;
  int64_t size;
  int64_t pos;
} MemCtx;

static int mem_read(void *opaque, uint8_t *buf, int buf_size) {
  MemCtx *m = (MemCtx *)opaque;
  int64_t rem = m->size - m->pos;
  if (rem <= 0) return AVERROR_EOF;
  int n = buf_size < rem ? buf_size : (int)rem;
  memcpy(buf, m->data + m->pos, (size_t)n);
  m->pos += n;
  return n;
}

static int64_t mem_seek(void *opaque, int64_t offset, int whence) {
  MemCtx *m = (MemCtx *)opaque;
  if (whence == AVSEEK_SIZE) return m->size;
  int64_t np;
  switch (whence & ~AVSEEK_FORCE) {
    case SEEK_SET: np = offset; break;
    case SEEK_CUR: np = m->pos + offset; break;
    case SEEK_END: np = m->size + offset; break;
    default: return -1;
  }
  if (np < 0 || np > m->size) return -1;
  m->pos = np;
  return np;
}

typedef struct {
  float *out;
  int64_t cap;      /* floats */
  int64_t written;  /* floats */
  int overflow;
} Sink;

/* Convert one decoded frame to interleaved float and append. */
static int sink_frame(Sink *s, SwrContext *swr, const AVFrame *fr, int ch) {
  /* swr output: interleaved FLT at the input rate; nb_samples out == in
   * (no rate conversion), plus possible swr buffering for some layouts —
   * use av_rescale bound. */
  int max_out = fr ? fr->nb_samples + 256 : 4096;
  int64_t need = s->written + (int64_t)max_out * ch;
  float *dst;
  float *tmp = NULL;
  if (need > s->cap) {
    /* Decode into a scratch frame just to count; simpler: flag overflow and
     * keep counting via a temp buffer so the caller learns a lower bound. */
    tmp = (float *)av_malloc((size_t)max_out * ch * sizeof(float));
    if (!tmp) return -4;
    dst = tmp;
  } else {
    dst = s->out + s->written;
  }
  uint8_t *outp[1] = {(uint8_t *)dst};
  int got = swr_convert(swr, outp, max_out,
                        fr ? (const uint8_t **)fr->extended_data : NULL,
                        fr ? fr->nb_samples : 0);
  if (got < 0) {
    if (tmp) av_free(tmp);
    return -5;
  }
  if (tmp) {
    av_free(tmp);
    s->overflow = 1;
  }
  s->written += (int64_t)got * ch;
  return 0;
}

int32_t fsav_decode(const uint8_t *data, int64_t size, float *out,
                    int64_t out_cap, int64_t *nwritten, int32_t *sample_rate,
                    int32_t *channels) {
  AVFormatContext *fmt = NULL;
  AVIOContext *avio = NULL;
  AVCodecContext *cctx = NULL;
  SwrContext *swr = NULL;
  AVPacket *pkt = NULL;
  AVFrame *fr = NULL;
  uint8_t *iobuf = NULL;
  MemCtx mem = {data, size, 0};
  Sink sink = {out, out_cap, 0, 0};
  int rc = 0;

  *nwritten = 0;
  *sample_rate = 0;
  *channels = 0;

  fmt = avformat_alloc_context();
  iobuf = (uint8_t *)av_malloc(1 << 16);
  if (!fmt || !iobuf) { rc = -1; goto done; }
  avio = avio_alloc_context(iobuf, 1 << 16, 0, &mem, mem_read, NULL, mem_seek);
  if (!avio) { rc = -1; goto done; }
  iobuf = NULL; /* owned by avio now */
  fmt->pb = avio;
  if (avformat_open_input(&fmt, NULL, NULL, NULL) < 0) { rc = -1; goto done; }
  if (avformat_find_stream_info(fmt, NULL) < 0) { rc = -1; goto done; }

  const AVCodec *dec = NULL;
  int sidx = av_find_best_stream(fmt, AVMEDIA_TYPE_AUDIO, -1, -1, &dec, 0);
  if (sidx < 0 || !dec) { rc = -2; goto done; }
  AVStream *st = fmt->streams[sidx];

  cctx = avcodec_alloc_context3(dec);
  if (!cctx || avcodec_parameters_to_context(cctx, st->codecpar) < 0 ||
      avcodec_open2(cctx, dec, NULL) < 0) { rc = -2; goto done; }

  int ch = cctx->ch_layout.nb_channels;
  if (ch <= 0) { rc = -2; goto done; }
  *channels = ch;
  *sample_rate = cctx->sample_rate;

  AVChannelLayout out_layout;
  av_channel_layout_default(&out_layout, ch);
  if (swr_alloc_set_opts2(&swr, &out_layout, AV_SAMPLE_FMT_FLT,
                          cctx->sample_rate, &cctx->ch_layout,
                          cctx->sample_fmt, cctx->sample_rate, 0, NULL) < 0 ||
      swr_init(swr) < 0) { rc = -5; goto done; }

  pkt = av_packet_alloc();
  fr = av_frame_alloc();
  if (!pkt || !fr) { rc = -4; goto done; }

  int eof = 0;
  while (!eof) {
    int r = av_read_frame(fmt, pkt);
    if (r == AVERROR_EOF) {
      eof = 1;
    } else if (r < 0) {
      rc = -4; goto done;
    } else if (pkt->stream_index != sidx) {
      av_packet_unref(pkt);
      continue;
    }
    r = avcodec_send_packet(cctx, eof ? NULL : pkt);
    av_packet_unref(pkt);
    if (r < 0 && r != AVERROR_EOF) { rc = -4; goto done; }
    for (;;) {
      r = avcodec_receive_frame(cctx, fr);
      if (r == AVERROR(EAGAIN) || r == AVERROR_EOF) break;
      if (r < 0) { rc = -4; goto done; }
      /* Some decoders only learn the real layout at the first frame: if
         nothing has been written yet, adopt the frame's layout and
         reconfigure the resampler. A LATER change (mid-stream layout
         switch, broken encoder) is an ERROR, not a silent skip — skipping
         every frame would return rc=0 with zero samples and the caller
         would treat an empty waveform as valid. */
      if (fr->ch_layout.nb_channels != ch) {
        if (sink.written != 0 || fr->ch_layout.nb_channels <= 0) {
          rc = -6; goto done;
        }
        ch = fr->ch_layout.nb_channels;
        *channels = ch;
        swr_free(&swr);
        AVChannelLayout lay2;
        av_channel_layout_default(&lay2, ch);
        if (swr_alloc_set_opts2(&swr, &lay2, AV_SAMPLE_FMT_FLT,
                                cctx->sample_rate, &fr->ch_layout,
                                (enum AVSampleFormat)fr->format,
                                fr->sample_rate, 0, NULL) < 0 ||
            swr_init(swr) < 0) { rc = -5; goto done; }
      }
      r = sink_frame(&sink, swr, fr, ch);
      if (r < 0) { rc = r; goto done; }
      av_frame_unref(fr);
    }
  }
  /* Flush the resampler's internal buffer. */
  if (sink_frame(&sink, swr, NULL, ch) < 0) { rc = -5; goto done; }

  /* A stream that demuxed but produced no audio at all is an error. */
  rc = sink.overflow ? -3 : (sink.written == 0 ? -6 : 0);

done:
  *nwritten = sink.written;
  if (fr) av_frame_free(&fr);
  if (pkt) av_packet_free(&pkt);
  if (swr) swr_free(&swr);
  if (cctx) avcodec_free_context(&cctx);
  if (fmt) avformat_close_input(&fmt);
  if (avio) {
    av_free(avio->buffer);
    avio_context_free(&avio);
  }
  if (iobuf) av_free(iobuf);
  return rc;
}
