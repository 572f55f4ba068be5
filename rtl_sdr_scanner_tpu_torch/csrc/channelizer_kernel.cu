// The critically sampled analysis bank of the wideband channelizer on
// Hopper: one wideband stream (int8 cs8, or f32 given by element strides)
// split into B channels of rate R/B,
//   ext    = [carried tail ((T - 1) * B samples), x],
//   v_p[m] = sum_{t < T} k[p, t] * ext[(m + t) * B + p]      (branch FIRs)
//   y_b[m] = sum_{p < B} e^{-2 pi i b p / B} * v_p[m]         (a B-point FFT)
// written once as channels [B, n / B, 2] f32 (re, im); the new tail (ext's
// last (T - 1) * B samples) is written by the same launch to its own buffer.
//
// Replaces no TPU kernel: the JAX package leaves the bank to XLA's
// dot_general (rtl_sdr_scanner_tpu/ops/channelizer.py: the modulated-taps
// product G[b, t * B + p] = W[b, p] k[p, t] over the raw stream). The port
// ran that form as a [.., 512] @ [512, 2048] f32 bmm, 1.160 TFLOP a
// 163.84 Msps block (141,557,760 samples into 8 channels) where the bank
// needs 12.3 GFLOP (94x), plus copies of its operands (the int8 widening,
// cat, pad, lag sums, the final stack): 36 ms of a 55 ms block.
//
// Bound: bytes. A block reads 2 B a sample (int8) and writes 8 B a channel
// sample (as many as input samples): 1.416 GB, 0.4226 ms at 3.35 TB/s; its
// 12.3 GFLOP are 0.18 ms at the 67 TFLOP/s f32 peak. So the kernel streams,
// and keeps everything between the input and the channels on chip:
//   - a thread block takes a run of kRun(B) = 1536 / B consecutive output
//     times (192 at B = 8). It reads its input span and the (T - 1) * B
//     sample halo (from the carried tail for the first run) once,
//     dequantizes on load exactly as the plain path ((float)v * (1 / 127.5f)),
//     and stores it in shared memory by branch, s_x[p][j] = ext[(m0 + j) * B
//     + p]: consecutive threads read consecutive 16-byte runs of 8 cs8
//     samples (aligned contiguous int8 from B = 8 up; a sample a thread
//     otherwise), and the row stride puts their stores on distinct banks;
//   - branch FIRs: a thread takes items of (branch p, 3 consecutive m) and
//     slides a register window over its branch row in chunks of 3 taps (T
//     padded with zero taps to a multiple of 3), so that each sample read
//     from shared memory serves 3 outputs; f32 FMAs in ascending t; lanes
//     3 samples apart hit distinct banks. The branch sums stay in shared
//     memory, s_v[p][m];
//   - the FFT: a thread takes an m, loads its B branch sums and runs a
//     radix-2 decimation-in-frequency FFT in registers (every index a
//     compile-time constant; twiddles e^{-2 pi i k / B}, the table's k <
//     B / 2, from f64 cos / sin cast to f32 on the host), then writes channel b's
//     sample as one float2: consecutive threads take consecutive m, so each
//     channel row's stores coalesce;
//   - one launch a block: at B = 8, 8 runs of 26 KB of shared memory and
//     32 registers a thread fill an SM and keep loads, FMAs and stores of
//     different runs in flight together (measured on an H100: 0.645 ms a
//     163.84 Msps block, 65% of the bound; runs of 384, 4 an SM, took 0.718).
// A template over B (powers of two, 2-64) and the input's type; T <= 32 at
// run time (every plan has 10-18).
//
// Any other B (3, 12, 128, ... up to kMaxChannels; off every benchmark cell)
// takes the direct-DFT form, analysis_bank_dft_kernel: a thread block takes
// kDftPoints / B output times (one from B = 2048 up), sums its branch FIRs
// from global memory (consecutive threads read consecutive samples; L1 and
// L2 serve each sample's T reads), keeps them in shared memory and writes
// y_b[m] = sum_p W^{(b p) mod B} v_p[m] in ascending p with f32 FMAs, the
// twiddle table's B entries in shared memory, consecutive threads taking
// consecutive m of a channel. B^2 operations a channel sample time: the
// sums, not the bytes, bound it from B of a few hundred up.
//
// The attributes are set once per device, under a mutex (two sessions'
// threads may launch on one card).

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 512;   // (branch, kU outputs) items a thread block
constexpr int kU = 3;         // outputs a branch-FIR item; taps a chunk
constexpr int kMaxTaps = 32;
constexpr int kMaxChannels = 4096;  // the direct-DFT form's largest B
constexpr int kDftPoints = 2048;    // branch sums a direct-DFT thread block keeps (B x run)
constexpr int kChunk = 8;  // cs8 samples a 16-byte load
constexpr int kMaxDevices = 64;
constexpr float kCs8Scale = 1.0f / 127.5f;  // as the plain path's x.to(float32) * (1 / 127.5)

template <int B>
constexpr int kRun = kU * kItems / B;  // output times a thread block

__host__ __device__ constexpr int padded_taps(int taps) { return (taps + kU - 1) / kU * kU; }

// Branch row stride in float2: >= run + padded taps, and 16 / B (mod 16)
// for B < 16, odd from 16 up: a half-warp's 8-byte stores of consecutive
// samples (B branches by 16 / B rows) and its loads along a row 3 apart
// each land on 16 distinct bank pairs.
__host__ __device__ constexpr int row_stride(int b, int run, int taps_pad) {
  const int need = run + taps_pad;
  const int want = b < 16 ? 16 / b : 1;
  return need + ((want - need % 16) + 16) % 16;
}

__host__ __device__ constexpr size_t smem_bytes(int b, int run, int taps_pad) {
  return sizeof(float2) * ((size_t)b * row_stride(b, run, taps_pad) + (size_t)b * run + b / 2) +
         sizeof(float) * (size_t)b * taps_pad;
}

// The direct-DFT form's output times a thread block, and its branch-sum row
// stride (odd: a warp's stores of consecutive branches land on distinct
// banks). B x stride <= 4096 for every B <= kMaxChannels, so the largest
// shared memory is kMaxChannels' (64 KB).
__host__ __device__ constexpr int dft_run(int b) { return b >= kDftPoints ? 1 : kDftPoints / b; }
__host__ __device__ constexpr int dft_stride(int b) { return dft_run(b) | 1; }
__host__ __device__ constexpr size_t dft_smem_bytes(int b) {
  return sizeof(float2) * ((size_t)b * dft_stride(b) + (size_t)b);
}

template <int B>
__host__ __device__ constexpr int bit_reverse(int i) {
  int r = 0;
  for (int bit = 1; bit < B; bit <<= 1) {
    r = (r << 1) | (i & 1);
    i >>= 1;
  }
  return r;
}

template <typename In>
__device__ __forceinline__ float2 load_sample(const In* __restrict__ x, long long s, long long s_sample,
                                              long long s_comp);

template <>
__device__ __forceinline__ float2 load_sample<int8_t>(const int8_t* __restrict__ x, long long s,
                                                      long long s_sample, long long s_comp) {
  const int8_t* p = x + s * s_sample;
  return make_float2((float)__ldg(p) * kCs8Scale, (float)__ldg(p + s_comp) * kCs8Scale);
}

template <>
__device__ __forceinline__ float2 load_sample<float>(const float* __restrict__ x, long long s,
                                                     long long s_sample, long long s_comp) {
  const float* p = x + s * s_sample;
  return make_float2(__ldg(p), __ldg(p + s_comp));
}

__device__ __forceinline__ float2 fma2(float k, float2 x, float2 acc) {
  return make_float2(fmaf(k, x.x, acc.x), fmaf(k, x.y, acc.y));
}

__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
  return make_float2(a.x * w.x - a.y * w.y, a.x * w.y + a.y * w.x);
}

// The new tail, ext[n : n + tail_len]; thread block 0 writes it.
template <typename In>
__device__ __forceinline__ void write_tail(const In* __restrict__ x, long long s_sample, long long s_comp,
                                           long long n, const float2* __restrict__ tail, long long tail_len,
                                           float2* __restrict__ new_tail) {
  for (int i = threadIdx.x; i < tail_len; i += kThreads) {
    const long long e = n + i;
    new_tail[i] = e < tail_len ? tail[e] : load_sample<In>(x, e - tail_len, s_sample, s_comp);
  }
}

// In place: a[i] becomes y[bit_reverse<B>(i)] of y_b = sum_p W^{b p} a[p],
// W = e^{-2 pi i / B}, tw[k] = W^k (k < B / 2).
template <int B>
__device__ __forceinline__ void fft_dif(float2 (&a)[B], const float2* __restrict__ tw) {
#pragma unroll
  for (int half = B / 2; half >= 1; half /= 2) {
#pragma unroll
    for (int k = 0; k < B; k += 2 * half) {
#pragma unroll
      for (int j = 0; j < half; ++j) {
        const float2 u = a[k + j];
        const float2 v = a[k + j + half];
        a[k + j] = make_float2(u.x + v.x, u.y + v.y);
        const float2 d = make_float2(u.x - v.x, u.y - v.y);
        a[k + j + half] = j == 0 ? d : cmul(d, tw[j * (B / (2 * half))]);
      }
    }
  }
}

template <int B, typename In>
__global__ void __launch_bounds__(kThreads)
    analysis_bank_kernel(const In* __restrict__ x, long long s_sample, long long s_comp, long long n,
                         const float2* __restrict__ tail, const float* __restrict__ taps,
                         const float2* __restrict__ twiddles, float2* __restrict__ out,
                         float2* __restrict__ new_tail, int n_taps) {
  constexpr int R = kRun<B>;
  constexpr int G = kItems / B;  // items a branch
  const int tp = padded_taps(n_taps);
  const int L = row_stride(B, R, tp);
  const long long tail_len = (long long)(n_taps - 1) * B;
  const long long M = n / B;
  const long long m0 = (long long)blockIdx.x * R;

  extern __shared__ float2 smem[];
  float2* s_x = smem;          // [B][L]: s_x[p][j] = ext[(m0 + j) * B + p]
  float2* s_v = s_x + B * L;   // [B][R]: branch sums
  float2* s_w = s_v + B * R;   // [B / 2] twiddles
  float* s_k = reinterpret_cast<float*>(s_w + B / 2);  // [B][tp] taps, zero past T

  for (int i = threadIdx.x; i < B * tp; i += kThreads) s_k[i] = __ldg(taps + i);
  if (threadIdx.x < B / 2) s_w[threadIdx.x] = twiddles[threadIdx.x];

  // the run's span of ext (j < R + T - 1), zeros past it and past the stream
  const long long e0 = m0 * B;
  const long long span = min((long long)(R + n_taps - 1) * B, tail_len + n - e0);
  bool chunked = false;
  if constexpr (std::is_same<In, int8_t>::value && B >= kChunk) {
    // contiguous aligned cs8: 16-byte loads of kChunk samples. From B = 8 up
    // e0, tail_len, span and n are multiples of kChunk, so a chunk lies
    // wholly in the tail, in x or past the span.
    chunked = s_sample == 2 && s_comp == 1 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
    if (chunked) {
#pragma unroll 2
      for (int c = threadIdx.x; c < L * B / kChunk; c += kThreads) {
        const int i0 = kChunk * c;
        const long long e = e0 + i0;
        float2 v[kChunk];
        if (i0 >= span) {
#pragma unroll
          for (int q = 0; q < kChunk; ++q) v[q] = make_float2(0.f, 0.f);
        } else if (e < tail_len) {
#pragma unroll
          for (int q = 0; q < kChunk; ++q) v[q] = tail[e + q];
        } else {
          const uint4 raw = __ldg(reinterpret_cast<const uint4*>(x + 2 * (e - tail_len)));
          const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
          for (int q = 0; q < kChunk; ++q) {  // sample q: bytes 2q (re) and 2q + 1 (im), sign-extended
            const unsigned word = w[q / 2];
            const int shift = 16 * (q % 2);
            v[q] = make_float2((float)((int)(word << (24 - shift)) >> 24) * kCs8Scale,
                               (float)((int)(word << (16 - shift)) >> 24) * kCs8Scale);
          }
        }
#pragma unroll
        for (int q = 0; q < kChunk; ++q) s_x[((i0 + q) % B) * L + (i0 + q) / B] = v[q];
      }
    }
  }
  if (!chunked) {
#pragma unroll 4
    for (int idx = threadIdx.x; idx < L * B; idx += kThreads) {
      const int j = idx / B;
      const int p = idx % B;
      float2 v = make_float2(0.f, 0.f);
      if (idx < span) {
        const long long e = e0 + idx;
        v = e < tail_len ? tail[e] : load_sample<In>(x, e - tail_len, s_sample, s_comp);
      }
      s_x[p * L + j] = v;
    }
  }
  if (blockIdx.x == 0) write_tail<In>(x, s_sample, s_comp, n, tail, tail_len, new_tail);
  __syncthreads();

  // branch FIRs: item (p, g) sums outputs 3g .. 3g + 2 of branch p
  for (int it = threadIdx.x; it < kItems; it += kThreads) {
    const int p = it / G;
    const int g = it % G;
    const float2* row = s_x + p * L + kU * g;
    const float* k = s_k + p * tp;
    float2 w0 = row[0], w1 = row[1], w2 = row[2];
    float2 a0 = make_float2(0.f, 0.f), a1 = a0, a2 = a0;
    for (int c = 0; c < tp; c += kU) {
      const float2 n0 = row[c + 3], n1 = row[c + 4], n2 = row[c + 5];
      const float k0 = k[c], k1 = k[c + 1], k2 = k[c + 2];
      a0 = fma2(k0, w0, a0);
      a1 = fma2(k0, w1, a1);
      a2 = fma2(k0, w2, a2);
      a0 = fma2(k1, w1, a0);
      a1 = fma2(k1, w2, a1);
      a2 = fma2(k1, n0, a2);
      a0 = fma2(k2, w2, a0);
      a1 = fma2(k2, n0, a1);
      a2 = fma2(k2, n1, a2);
      w0 = n0;
      w1 = n1;
      w2 = n2;
    }
    float2* v = s_v + p * R + kU * g;
    v[0] = a0;
    v[1] = a1;
    v[2] = a2;
  }
  __syncthreads();

  // the FFT across branches, a thread an output time
  const int valid = (int)min((long long)R, M - m0);
  for (int m = threadIdx.x; m < valid; m += kThreads) {
    float2 a[B];
#pragma unroll
    for (int p = 0; p < B; ++p) a[p] = s_v[p * R + m];
    fft_dif<B>(a, s_w);
#pragma unroll
    for (int i = 0; i < B; ++i) out[(long long)bit_reverse<B>(i) * M + m0 + m] = a[i];
  }
}

template <typename In>
__global__ void __launch_bounds__(kThreads)
    analysis_bank_dft_kernel(const In* __restrict__ x, long long s_sample, long long s_comp, long long n,
                             const float2* __restrict__ tail, const float* __restrict__ taps,
                             const float2* __restrict__ twiddles, float2* __restrict__ out,
                             float2* __restrict__ new_tail, int b, int n_taps) {
  const int run = dft_run(b);
  const int L = dft_stride(b);
  const int tp = padded_taps(n_taps);
  const long long tail_len = (long long)(n_taps - 1) * b;
  const long long M = n / b;
  const long long m0 = (long long)blockIdx.x * run;
  const int valid = (int)min((long long)run, M - m0);

  extern __shared__ float2 smem[];
  float2* s_v = smem;         // [B][L]: branch sums
  float2* s_w = s_v + b * L;  // [B]: W^k
  for (int k = threadIdx.x; k < b; k += kThreads) s_w[k] = twiddles[k];

  // branch FIRs, a thread a (m, p), p fastest; f32 FMAs in ascending t
  for (int idx = threadIdx.x; idx < b * valid; idx += kThreads) {
    const int j = idx / b;
    const int p = idx - j * b;
    const float* k = taps + (long long)p * tp;
    long long e = (m0 + j) * b + p;
    float2 acc = make_float2(0.f, 0.f);
    for (int t = 0; t < n_taps; ++t, e += b) {
      const float2 v = e < tail_len ? tail[e] : load_sample<In>(x, e - tail_len, s_sample, s_comp);
      acc = fma2(__ldg(k + t), v, acc);
    }
    s_v[p * L + j] = acc;
  }
  if (blockIdx.x == 0) write_tail<In>(x, s_sample, s_comp, n, tail, tail_len, new_tail);
  __syncthreads();

  // the direct DFT, a thread a (channel c, m), m fastest; ascending p
  for (int idx = threadIdx.x; idx < b * valid; idx += kThreads) {
    const int c = idx / valid;
    const int j = idx - c * valid;
    float2 acc = make_float2(0.f, 0.f);
    int k = 0;  // (c * p) mod B
    for (int p = 0; p < b; ++p) {
      const float2 v = s_v[p * L + j];
      const float2 w = s_w[k];
      acc.x = fmaf(v.x, w.x, fmaf(-v.y, w.y, acc.x));
      acc.y = fmaf(v.x, w.y, fmaf(v.y, w.x, acc.y));
      k += c;
      if (k >= b) k -= b;
    }
    out[(long long)c * M + m0 + j] = acc;
  }
}

template <int B, typename In>
int set_smem() {
  const size_t smem = smem_bytes(B, kRun<B>, padded_taps(kMaxTaps));
  return (int)cudaFuncSetAttribute(analysis_bank_kernel<B, In>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

template <typename In>
int set_all() {
  int err = set_smem<2, In>();
  if (err == 0) err = set_smem<4, In>();
  if (err == 0) err = set_smem<8, In>();
  if (err == 0) err = set_smem<16, In>();
  if (err == 0) err = set_smem<32, In>();
  if (err == 0) err = set_smem<64, In>();
  if (err == 0) {
    err = (int)cudaFuncSetAttribute(analysis_bank_dft_kernel<In>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)dft_smem_bytes(kMaxChannels));
  }
  return err;
}

// The attributes, once per device, under a mutex shared by every host
// thread that launches.
std::mutex g_mutex;
bool g_ready[kMaxDevices];

int setup(int dev) {
  std::lock_guard<std::mutex> lock(g_mutex);
  if (!g_ready[dev]) {
    int err = set_all<int8_t>();
    if (err == 0) err = set_all<float>();
    if (err != 0) return err;
    g_ready[dev] = true;
  }
  return 0;
}

template <int B, typename In>
int launch(const void* x, long long s_sample, long long s_comp, long long n, const void* tail,
           const void* taps, const void* twiddles, void* out, void* new_tail, int n_taps, cudaStream_t stream) {
  constexpr int R = kRun<B>;
  const long long blocks = (n / B + R - 1) / R;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  analysis_bank_kernel<B, In><<<(unsigned)blocks, kThreads, smem_bytes(B, R, padded_taps(n_taps)), stream>>>(
      static_cast<const In*>(x), s_sample, s_comp, n, static_cast<const float2*>(tail),
      static_cast<const float*>(taps), static_cast<const float2*>(twiddles), static_cast<float2*>(out),
      static_cast<float2*>(new_tail), n_taps);
  return (int)cudaGetLastError();
}

template <typename In>
int dispatch(int b, const void* x, long long s_sample, long long s_comp, long long n, const void* tail,
             const void* taps, const void* twiddles, void* out, void* new_tail, int n_taps, cudaStream_t s) {
  switch (b) {
    case 2: return launch<2, In>(x, s_sample, s_comp, n, tail, taps, twiddles, out, new_tail, n_taps, s);
    case 4: return launch<4, In>(x, s_sample, s_comp, n, tail, taps, twiddles, out, new_tail, n_taps, s);
    case 8: return launch<8, In>(x, s_sample, s_comp, n, tail, taps, twiddles, out, new_tail, n_taps, s);
    case 16: return launch<16, In>(x, s_sample, s_comp, n, tail, taps, twiddles, out, new_tail, n_taps, s);
    case 32: return launch<32, In>(x, s_sample, s_comp, n, tail, taps, twiddles, out, new_tail, n_taps, s);
    case 64: return launch<64, In>(x, s_sample, s_comp, n, tail, taps, twiddles, out, new_tail, n_taps, s);
    default: break;
  }
  const int run = dft_run(b);
  const long long blocks = (n / b + run - 1) / run;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  analysis_bank_dft_kernel<In><<<(unsigned)blocks, kThreads, dft_smem_bytes(b), s>>>(
      static_cast<const In*>(x), s_sample, s_comp, n, static_cast<const float2*>(tail),
      static_cast<const float*>(taps), static_cast<const float2*>(twiddles), static_cast<float2*>(out),
      static_cast<float2*>(new_tail), b, n_taps);
  return (int)cudaGetLastError();
}

}  // namespace

// x: the stream, int8 (x_int8 = 1) or f32, sample s's (re, im) at
// x[s * x_sample], x[s * x_sample + x_comp] (elements); n samples, a
// multiple of b. tail: [(n_taps - 1) * b, 2] f32; taps: [b, 3 * ceil(n_taps
// / 3)] f32, the branch kernels (conv-ready) zero-padded; twiddles: [b, 2]
// f32, e^{-2 pi i k / b}; out: [b, n / b, 2] f32; new_tail: like tail. 2 <=
// b <= 4096 (powers of two to 64 the FFT form, the rest the direct-DFT
// form), 1 <= n_taps <= 32. Returns cudaGetLastError() after the launch (or
// the error that kept it from launching).
extern "C" int analysis_bank(const void* x, int x_int8, long long x_sample, long long x_comp, long long n,
                             const void* tail, const void* taps, const void* twiddles, void* out,
                             void* new_tail, int b, int n_taps, void* stream) {
  if (n <= 0 || b < 2 || b > kMaxChannels || n % b != 0 || n_taps < 1 || n_taps > kMaxTaps) {
    return (int)cudaErrorInvalidValue;
  }
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  const int rc = setup(dev);
  if (rc != 0) return rc;
  cudaStream_t s = (cudaStream_t)stream;
  if (x_int8) return dispatch<int8_t>(b, x, x_sample, x_comp, n, tail, taps, twiddles, out, new_tail, n_taps, s);
  return dispatch<float>(b, x, x_sample, x_comp, n, tail, taps, twiddles, out, new_tail, n_taps, s);
}
