// Native host-runtime components for asr-study-tpu.
//
// The reference delegated all native work to its dependencies (TF kernels,
// librosa C); this rebuild keeps device compute in XLA and puts
// the *host* hot loops here instead: WAV decode, padded-batch assembly, and
// host-side Levenshtein for corpus-scale WER.  Exposed as a plain C ABI for
// ctypes (no pybind11 in this environment).
//
// Build: `make -C native` -> libasrnative.so

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <algorithm>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// WAV (RIFF PCM16/PCM32/float32) decode
// ---------------------------------------------------------------------------

// Reads the PCM payload of `path` into out[0..max_samples), converting to
// float32 in [-1, 1] and downmixing channels.  Returns the number of
// samples written, or a negative error code:
//   -1 cannot open, -2 not RIFF/WAVE, -3 no fmt/data chunk,
//   -4 unsupported encoding, -5 buffer too small.
// *sr_out receives the sample rate.
long asr_read_wav(const char* path, float* out, long max_samples,
                  int* sr_out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  unsigned char hdr[12];
  if (std::fread(hdr, 1, 12, f) != 12 || std::memcmp(hdr, "RIFF", 4) ||
      std::memcmp(hdr + 8, "WAVE", 4)) {
    std::fclose(f);
    return -2;
  }
  uint16_t audio_format = 0, n_channels = 0, bits = 0;
  uint32_t sample_rate = 0;
  long n_out = -3;
  // chunk walk
  for (;;) {
    unsigned char ch[8];
    if (std::fread(ch, 1, 8, f) != 8) break;
    uint32_t size = ch[4] | (ch[5] << 8) | (ch[6] << 16) |
                    ((uint32_t)ch[7] << 24);
    if (!std::memcmp(ch, "fmt ", 4)) {
      // a PCM fmt chunk is >= 16 bytes; anything smaller is malformed and
      // reading fmt[14]/fmt[15] below would be out of bounds
      if (size < 16 || size > 1 << 20) { n_out = -3; break; }
      std::vector<unsigned char> fmt(size);
      if (std::fread(fmt.data(), 1, size, f) != size) break;
      audio_format = fmt[0] | (fmt[1] << 8);
      n_channels = fmt[2] | (fmt[3] << 8);
      sample_rate = fmt[4] | (fmt[5] << 8) | (fmt[6] << 16) |
                    ((uint32_t)fmt[7] << 24);
      bits = fmt[14] | (fmt[15] << 8);
    } else if (!std::memcmp(ch, "data", 4)) {
      if (audio_format == 0) { n_out = -3; break; }
      bool pcm = audio_format == 1;
      bool flt = audio_format == 3;
      if (!pcm && !flt) { n_out = -4; break; }
      if (bits != 16 && bits != 32) { n_out = -4; break; }
      if (n_channels == 0 || n_channels > 64) { n_out = -4; break; }
      long bytes_per = bits / 8;
      long n_frames = size / (bytes_per * n_channels);
      if (n_frames > max_samples) { n_out = -5; break; }
      // bound the allocation by what the caller can accept — `size` is an
      // untrusted field that could otherwise demand up to 4 GB
      uint64_t need = (uint64_t)n_frames * bytes_per * n_channels;
      std::vector<unsigned char> data((size_t)need);
      size_t got = std::fread(data.data(), 1, (size_t)need, f);
      n_frames = (long)(got / (bytes_per * n_channels));
      const float inv16 = 1.0f / 32768.0f;
      const double inv32 = 1.0 / 2147483648.0;
      for (long i = 0; i < n_frames; ++i) {
        double acc = 0.0;
        for (int c = 0; c < n_channels; ++c) {
          const unsigned char* p =
              data.data() + (i * n_channels + c) * bytes_per;
          if (bits == 16) {
            int16_t v = (int16_t)(p[0] | (p[1] << 8));
            acc += v * inv16;
          } else if (pcm) {
            int32_t v = (int32_t)(p[0] | (p[1] << 8) | (p[2] << 16) |
                                  ((uint32_t)p[3] << 24));
            acc += v * inv32;
          } else {
            float v;
            std::memcpy(&v, p, 4);
            acc += v;
          }
        }
        out[i] = (float)(acc / n_channels);
      }
      n_out = n_frames;
      break;
    } else {
      std::fseek(f, (long)((size + 1) & ~1u), SEEK_CUR);
      continue;
    }
  }
  if (sr_out) *sr_out = (int)sample_rate;
  std::fclose(f);
  return n_out;
}

// ---------------------------------------------------------------------------
// Padded batch assembly
// ---------------------------------------------------------------------------

// Packs `n_rows` variable-length [len_i, feat_dim] rows (concatenated in
// `src`, row i starting at element offsets[i]*feat_dim) into the
// zero-initialized dense [n_rows, t_pad, feat_dim] buffer `out`.
void asr_pack_batch(const float* src, const int64_t* offsets,
                    const int64_t* lens, int64_t n_rows, int64_t t_pad,
                    int64_t feat_dim, float* out) {
  for (int64_t i = 0; i < n_rows; ++i) {
    int64_t t = std::min(lens[i], t_pad);
    std::memcpy(out + i * t_pad * feat_dim,
                src + offsets[i] * feat_dim,
                (size_t)(t * feat_dim) * sizeof(float));
  }
}

// Like asr_pack_batch, but fully defines `out` [out_rows, t_pad, feat_dim]:
// each row's padded tail and every row beyond n_rows are zeroed, so the
// caller can pass an uninitialized buffer (saves a full-buffer zero + copy
// per batch on the streaming path).
void asr_pack_batch_full(const float* src, const int64_t* offsets,
                         const int64_t* lens, int64_t n_rows,
                         int64_t out_rows, int64_t t_pad, int64_t feat_dim,
                         float* out) {
  for (int64_t i = 0; i < n_rows; ++i) {
    int64_t t = std::min(lens[i], t_pad);
    float* row = out + i * t_pad * feat_dim;
    std::memcpy(row, src + offsets[i] * feat_dim,
                (size_t)(t * feat_dim) * sizeof(float));
    std::memset(row + t * feat_dim, 0,
                (size_t)((t_pad - t) * feat_dim) * sizeof(float));
  }
  if (out_rows > n_rows) {
    std::memset(out + n_rows * t_pad * feat_dim, 0,
                (size_t)((out_rows - n_rows) * t_pad * feat_dim) *
                    sizeof(float));
  }
}

// ---------------------------------------------------------------------------
// dpack wire codec: lossless delta + per-block bit-packing (encode side)
// ---------------------------------------------------------------------------

// Transposes a 16x16 bit matrix in place (Hacker's Delight transpose32
// specialized to 16 lanes): out word p bit i = in word i bit p.
static inline void transpose16x16(uint16_t x[16]) {
  uint32_t m = 0x00FF;
  for (int j = 8; j != 0; j >>= 1, m ^= (m << j)) {
    for (int k = 0; k < 16; k = (k + j + 1) & ~j) {
      uint32_t t = (x[k] ^ (x[k + j] >> j)) & m;
      x[k] = (uint16_t)(x[k] ^ t);
      x[k + j] = (uint16_t)(x[k + j] ^ (t << j));
    }
  }
}

// Encodes a concatenated int16 sample stream for the dpack wire codec
// (data/wire.py): per 4096-sample block, int16-wraparound deltas are
// zigzagged and stored as w BIT PLANES of 256 words each (v2 layout:
// plane p, word m, bit i = bit p of sample 256*i + m), w = the block
// max's bit-length.  The v2 orientation makes the decoded [16, 256]
// block land in flat sample order row-major, where v1's 16m+i order
// needed a transpose in the device decode.  The symbol carries the layout version so a
// stale libasrnative.so predating v2 triggers a rebuild instead of
// silently emitting the old bit order (utils/native.py).
// `widths` receives ceil(n/4096) entries; `payload` must hold
// ceil(n/4096)*4096 uint16 words (worst case w=16, partial final block
// included).  Returns the payload word count.  Byte-identical to the
// NumPy reference encoder (tests/test_wire.py).  The plane transpose of
// each 16-sample group is one 16x16 bit-matrix transpose (log-depth
// swap network), not a per-bit loop.
long asr_dpack_encode_v2(const int16_t* s, long n, uint8_t* widths,
                         uint16_t* payload) {
  const long kBlock = 4096;
  const long kWords = kBlock / 16;   // 256 words per plane
  long nb = (n + kBlock - 1) / kBlock;
  long out = 0;
  int16_t prev = 0;
  for (long b = 0; b < nb; ++b) {
    long lo = b * kBlock;
    long hi = std::min(n, lo + kBlock);
    uint16_t u[4096];
    uint32_t mx = 0;
    for (long i = lo; i < hi; ++i) {
      int32_t d = (int16_t)(uint16_t)((uint16_t)s[i] - (uint16_t)prev);
      prev = s[i];
      uint32_t z = (uint32_t)((d << 1) ^ (d >> 31));
      u[i - lo] = (uint16_t)z;
      mx |= z;  // same highest set bit as the max
    }
    for (long i = hi - lo; i < kBlock; ++i) u[i] = 0;
    int w = 0;
    while (mx >> w) ++w;
    widths[b] = (uint8_t)w;
    if (w == 0) continue;
    uint16_t* dst = payload + out;
    for (long m = 0; m < kWords; ++m) {
      // out word p bit i must be bit p of group sample i (= block
      // sample 256*i + m).  The swap network above computes the
      // MSB-oriented (anti-)transpose — out[k] bit j = in[15-j] bit
      // [15-k] — so loading samples reversed and reading planes
      // reversed yields the straight LSB transpose.
      uint16_t g[16];
      for (int i = 0; i < 16; ++i) g[i] = u[kWords * (15 - i) + m];
      transpose16x16(g);
      for (int p = 0; p < w; ++p) dst[(long)p * kWords + m] = g[15 - p];
    }
    out += (long)w * kWords;
  }
  return out;
}

// ---------------------------------------------------------------------------
// Levenshtein distance (host WER/CER at corpus scale)
// ---------------------------------------------------------------------------

long asr_levenshtein(const int32_t* a, long la, const int32_t* b, long lb) {
  if (la == 0) return lb;
  if (lb == 0) return la;
  std::vector<long> row(lb + 1);
  for (long j = 0; j <= lb; ++j) row[j] = j;
  for (long i = 0; i < la; ++i) {
    long prev = row[0];
    row[0] = i + 1;
    for (long j = 0; j < lb; ++j) {
      long cur = row[j + 1];
      row[j + 1] = std::min({cur + 1, row[j] + 1,
                             prev + (a[i] != b[j] ? 1 : 0)});
      prev = cur;
    }
  }
  return row[lb];
}

}  // extern "C"
