// Native host runtime for the modem: byte-level framing hot path.
//
// The reference implements its entire host pipeline in C++ (encode.cc /
// decode.cc); in this framework the device math lives in XLA and the
// host-side byte plumbing lives here: WAV sample (de)quantisation, the
// xorshift32 payload scrambler, reflected CRCs and LSB/MSB bit packing.
// Exposed as a plain C ABI consumed via ctypes (modem/native.py),
// with pure-numpy fallbacks when the library is not built.
//
// Semantics mirror modem/bits.py exactly (property-tested against
// it in tests/test_native.py):
//   * xorshift32: Marsaglia triplet (13, 17, 5), seed 2463534242,
//     low byte of each state XORed onto the payload (encode.cc:417-419).
//   * CRC: reflected, init 0, no xorout (crc.hh semantics pinned by
//     decode.cc:533-541).
//   * bits: LSB-first per byte for payload, MSB-first for headers
//     (bitman.hh call sites).

#include <cstdint>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------------
// xorshift32 scrambler (self-inverse XOR keystream)
// ---------------------------------------------------------------------------

void modem_scramble(uint8_t *data, int64_t len, uint32_t seed) {
  uint32_t y = seed;
  for (int64_t i = 0; i < len; ++i) {
    y ^= y << 13;
    y ^= y >> 17;
    y ^= y << 5;
    data[i] ^= static_cast<uint8_t>(y);
  }
}

// ---------------------------------------------------------------------------
// reflected CRC (byte-wise table, built per call-site once host-side)
// ---------------------------------------------------------------------------

void modem_crc_table(uint32_t poly, uint32_t *table256) {
  for (uint32_t byte = 0; byte < 256; ++byte) {
    uint32_t reg = byte;
    for (int k = 0; k < 8; ++k) reg = (reg >> 1) ^ ((reg & 1) ? poly : 0);
    table256[byte] = reg;
  }
}

uint32_t modem_crc_bytes(const uint32_t *table256, const uint8_t *data,
                         int64_t len, uint32_t reg) {
  for (int64_t i = 0; i < len; ++i)
    reg = table256[(reg ^ data[i]) & 0xFF] ^ (reg >> 8);
  return reg;
}

// ---------------------------------------------------------------------------
// bit packing (bitman.hh): LE = LSB-first within each byte, BE = MSB-first
// ---------------------------------------------------------------------------

void modem_bytes_to_bits_le(const uint8_t *bytes, int64_t nbytes,
                            uint8_t *bits) {
  for (int64_t i = 0; i < nbytes; ++i)
    for (int b = 0; b < 8; ++b) bits[8 * i + b] = (bytes[i] >> b) & 1;
}

void modem_bits_to_bytes_le(const uint8_t *bits, int64_t nbits,
                            uint8_t *bytes) {
  std::memset(bytes, 0, (nbits + 7) / 8);
  for (int64_t i = 0; i < nbits; ++i)
    if (bits[i]) bytes[i / 8] |= static_cast<uint8_t>(1u << (i % 8));
}

void modem_bytes_to_bits_be(const uint8_t *bytes, int64_t nbytes,
                            uint8_t *bits) {
  for (int64_t i = 0; i < nbytes; ++i)
    for (int b = 0; b < 8; ++b) bits[8 * i + b] = (bytes[i] >> (7 - b)) & 1;
}

// ---------------------------------------------------------------------------
// WAV sample quantisation (wav.hh value semantics)
// ---------------------------------------------------------------------------

void modem_quantize_i16(const float *samples, int64_t n, int16_t *out) {
  for (int64_t i = 0; i < n; ++i) {
    float v = samples[i] * 32767.0f;
    v = v > 32767.0f ? 32767.0f : (v < -32768.0f ? -32768.0f : v);
    out[i] = static_cast<int16_t>(v >= 0 ? v + 0.5f : v - 0.5f);
  }
}

void modem_dequantize_i16(const int16_t *in, int64_t n, float *samples) {
  const float s = 1.0f / 32767.0f;
  for (int64_t i = 0; i < n; ++i) samples[i] = in[i] * s;
}

void modem_quantize_u8(const float *samples, int64_t n, uint8_t *out) {
  for (int64_t i = 0; i < n; ++i) {
    float v = samples[i] * 127.0f;
    v = v > 127.0f ? 127.0f : (v < -128.0f ? -128.0f : v);
    int q = static_cast<int>(v >= 0 ? v + 0.5f : v - 0.5f);
    out[i] = static_cast<uint8_t>(q + 128);
  }
}

void modem_dequantize_u8(const uint8_t *in, int64_t n, float *samples) {
  const float s = 1.0f / 127.0f;
  for (int64_t i = 0; i < n; ++i) samples[i] = (in[i] - 128.0f) * s;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// RIFF WAV codec (DSP::ReadWAV/WriteWAV equivalent): PCM 8-bit unsigned
// or 16-bit signed little-endian, any channel count; native file IO so
// the host data path needs no Python in the loop.
// ---------------------------------------------------------------------------

#include <cstdio>
#include <vector>

namespace {

struct WavInfo {
  int32_t rate, channels, bits;
  int64_t data_off, data_len;  // bytes
};

bool wav_parse(std::FILE *f, WavInfo *info) {
  uint8_t hdr[12];
  if (std::fread(hdr, 1, 12, f) != 12) return false;
  if (std::memcmp(hdr, "RIFF", 4) || std::memcmp(hdr + 8, "WAVE", 4))
    return false;
  bool have_fmt = false, have_data = false;
  for (;;) {
    uint8_t ch[8];
    if (std::fread(ch, 1, 8, f) != 8) break;
    uint32_t size;
    std::memcpy(&size, ch + 4, 4);
    if (!std::memcmp(ch, "fmt ", 4) && size >= 16) {
      uint8_t body[16];
      if (std::fread(body, 1, 16, f) != 16) return false;
      uint16_t audio_fmt, channels, block, bits;
      uint32_t rate;
      std::memcpy(&audio_fmt, body + 0, 2);
      std::memcpy(&channels, body + 2, 2);
      std::memcpy(&rate, body + 4, 4);
      std::memcpy(&block, body + 12, 2);
      std::memcpy(&bits, body + 14, 2);
      if (audio_fmt != 1) return false;  // PCM only
      info->rate = rate;
      info->channels = channels;
      info->bits = bits;
      have_fmt = true;
      if (std::fseek(f, static_cast<long>(size - 16 + (size & 1)),
                     SEEK_CUR))
        return false;
    } else if (!std::memcmp(ch, "data", 4)) {
      info->data_off = std::ftell(f);
      info->data_len = size;
      have_data = true;
      if (std::fseek(f, static_cast<long>(size + (size & 1)), SEEK_CUR))
        break;
    } else {
      if (std::fseek(f, static_cast<long>(size + (size & 1)), SEEK_CUR))
        break;
    }
  }
  return have_fmt && have_data;
}

}  // namespace

extern "C" {

// Returns number of sample values (frames * channels), or -1 on error.
int64_t modem_wav_info(const char *path, int32_t *rate,
                       int32_t *channels, int32_t *bits) {
  std::FILE *f = std::fopen(path, "rb");
  if (!f) return -1;
  WavInfo info{};
  bool ok = wav_parse(f, &info);
  std::fclose(f);
  if (!ok || (info.bits != 8 && info.bits != 16)) return -1;
  *rate = info.rate;
  *channels = info.channels;
  *bits = info.bits;
  return info.data_len / (info.bits / 8);
}

// Fills `out` with n dequantized float values; returns n or -1.
int64_t modem_wav_read(const char *path, float *out, int64_t n) {
  std::FILE *f = std::fopen(path, "rb");
  if (!f) return -1;
  WavInfo info{};
  if (!wav_parse(f, &info)) {
    std::fclose(f);
    return -1;
  }
  std::fseek(f, static_cast<long>(info.data_off), SEEK_SET);
  const int bytes = info.bits / 8;
  std::vector<uint8_t> raw(static_cast<size_t>(n) * bytes);
  int64_t got = static_cast<int64_t>(
      std::fread(raw.data(), bytes, static_cast<size_t>(n), f));
  std::fclose(f);
  if (info.bits == 8)
    modem_dequantize_u8(raw.data(), got, out);
  else
    modem_dequantize_i16(reinterpret_cast<const int16_t *>(raw.data()),
                         got, out);
  return got;
}

// Quantizes and writes n float values; returns 0 on success.
int64_t modem_wav_write(const char *path, const float *samples,
                        int64_t n, int32_t rate, int32_t channels,
                        int32_t bits) {
  if (bits != 8 && bits != 16) return -1;
  const int bytes = bits / 8;
  std::vector<uint8_t> raw(static_cast<size_t>(n) * bytes);
  if (bits == 8)
    modem_quantize_u8(samples, n, raw.data());
  else
    modem_quantize_i16(samples, n,
                       reinterpret_cast<int16_t *>(raw.data()));
  std::FILE *f = std::fopen(path, "wb");
  if (!f) return -1;
  const uint32_t data_len = static_cast<uint32_t>(raw.size());
  const uint32_t riff_len = 36 + data_len;
  const uint16_t audio_fmt = 1, nch = static_cast<uint16_t>(channels);
  const uint32_t srate = rate;
  const uint16_t block = static_cast<uint16_t>(channels * bytes);
  const uint32_t byte_rate = srate * block;
  const uint16_t wbits = static_cast<uint16_t>(bits);
  const uint32_t fmt_len = 16;
  std::fwrite("RIFF", 1, 4, f);
  std::fwrite(&riff_len, 4, 1, f);
  std::fwrite("WAVE", 1, 4, f);
  std::fwrite("fmt ", 1, 4, f);
  std::fwrite(&fmt_len, 4, 1, f);
  std::fwrite(&audio_fmt, 2, 1, f);
  std::fwrite(&nch, 2, 1, f);
  std::fwrite(&srate, 4, 1, f);
  std::fwrite(&byte_rate, 4, 1, f);
  std::fwrite(&block, 2, 1, f);
  std::fwrite(&wbits, 2, 1, f);
  std::fwrite("data", 1, 4, f);
  std::fwrite(&data_len, 4, 1, f);
  std::fwrite(raw.data(), 1, raw.size(), f);
  std::fclose(f);
  return 0;
}

}  // extern "C"
