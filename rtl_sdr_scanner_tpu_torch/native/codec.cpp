// Native host hot paths for the SDR scanner runtime.
//
// The reference implements its whole runtime in C++; here the Python host
// runtime keeps its hot byte-level loops native:
//  - wire-codec offset-binary conversion (reference
//    sources/network/data_controller.cpp:38-40: payload[i] ^= 0x80)
//  - cs8/cu8 -> cf32 IQ conversion for the replay data loader (reference
//    scripts/converter.py:30-39 conventions)
//  - interleave/deinterleave helpers for pinned host staging buffers
//
// Built as a plain shared library, loaded via ctypes (native/__init__.py).

#include <cstddef>
#include <cstdint>
#include <cstring>

extern "C" {

// In-place XOR 0x80: signed int8 IQ -> offset-binary uint8 (and back).
void sdr_xor80(uint8_t* data, size_t n) {
  size_t i = 0;
  // bulk 8-byte XOR
  uint64_t* wide = reinterpret_cast<uint64_t*>(data);
  const uint64_t mask = 0x8080808080808080ULL;
  const size_t nw = n / 8;
  for (size_t w = 0; w < nw; ++w) {
    wide[w] ^= mask;
  }
  for (i = nw * 8; i < n; ++i) {
    data[i] ^= 0x80;
  }
}

// Interleaved int8 IQ -> interleaved float32 IQ, out[i] = in[i] / 127.5f.
void sdr_cs8_to_f32(const int8_t* in, float* out, size_t n) {
  const float scale = 1.0f / 127.5f;
  for (size_t i = 0; i < n; ++i) {
    out[i] = static_cast<float>(in[i]) * scale;
  }
}

// Interleaved uint8 offset-binary IQ -> float32, out[i] = (in[i]-127.5)/127.5.
void sdr_cu8_to_f32(const uint8_t* in, float* out, size_t n) {
  const float scale = 1.0f / 127.5f;
  for (size_t i = 0; i < n; ++i) {
    out[i] = (static_cast<float>(in[i]) - 127.5f) * scale;
  }
}

// Interleaved float32 IQ -> int8 with round+saturate at the given scale
// (gr::blocks::complex_to_interleaved_char semantics, recorder.cpp:36).
void sdr_f32_to_cs8(const float* in, int8_t* out, size_t n, float scale) {
  for (size_t i = 0; i < n; ++i) {
    float v = in[i] * scale;
    v = v < -128.0f ? -128.0f : (v > 127.0f ? 127.0f : v);
    out[i] = static_cast<int8_t>(v >= 0.0f ? v + 0.5f : v - 0.5f);
  }
}

}  // extern "C"
