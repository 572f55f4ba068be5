// PSD of int8 IQ frames on Hopper: frame-select -> x/127.5 -> window with the
// fftshift folded in as (-1)^n -> N-point FFT -> 10*log10(max(|X|^2,1e-30)/rate).
//
// Replaces the TPU kernel psd_frames_int8_pallas / _psd_kernel
// (rtl_sdr_scanner_tpu/ops/pallas/psd_kernel.py), which ran the DFT as a
// four-step matmul on the MXU. A matmul DFT does ~30x the operations of a
// radix FFT; on this card the function is bound by memory instead. At the
// main-path shape (fft 131072, decim 3) one frame must read 262,144 B of int8
// and write 524,288 B of f32: 1080 frames per block (24 bands x 45) move
// 0.85 GB, 0.25 ms at 3.35 TB/s.
//
// Design: the four-step split N = N1*N2 (N1 >= N2, as _split_n) done as two
// passes of radix-2 FFTs in shared memory, with a complex f32 scratch in
// global memory between them:
//   pass 1: one block per (frame, 16 columns n2) loads its int8 pairs (rows of
//           16 consecutive pairs), dequantizes and windows them, runs sixteen
//           N1-point FFTs, multiplies by exp(-2 pi i k1 n2 / N) and writes
//           C[k1][n2] to the scratch;
//   pass 2: one block per (frame, 16 rows k1) loads C[k1][:], runs sixteen
//           N2-point FFTs and writes the dB of X[k2*N1 + k1].
// The scratch round trip costs 2 MiB of traffic per 131072-point frame, on
// top of the 0.75 MiB the function must move; a cluster / distributed shared
// memory form that keeps the intermediate on chip is later work. Twiddles
// come from sincospif, whose arguments are exact in f32 (integer over a
// power of two), so no table is read from memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 16;  // pass 1: n2 columns per block
constexpr int kRows = 16;  // pass 2: k1 rows per block

__device__ __forceinline__ unsigned bitrev(unsigned x, int bits) {
  return __brev(x) >> (32 - bits);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// tw[p] = exp(-2 pi i p / n) for p < n/2
__device__ void fill_twiddles(float2* tw, int n) {
  for (int p = threadIdx.x; p < n / 2; p += blockDim.x) {
    float s, c;
    sincospif(-2.0f * (float)p / (float)n, &s, &c);
    tw[p] = make_float2(c, s);
  }
}

// In-place radix-2 decimation-in-time FFTs of `batch` sequences of length
// 2^log_n whose input sits in bit-reversed order. Element i of sequence col
// lives at s[i * i_stride + col * c_stride]. col_fast: neighbouring threads
// take neighbouring sequences (pass 1's layout), else neighbouring
// butterflies of one sequence (pass 2's).
__device__ void fft_batch(float2* s, const float2* tw, int log_n, int log_batch,
                          int i_stride, int c_stride, bool col_fast) {
  const int log_half = log_n - 1;
  const int total = 1 << (log_batch + log_half);
  for (int st = 1; st <= log_n; ++st) {
    const int h = 1 << (st - 1);
    const int tw_shift = log_n - st;  // tw index = pos * (n / 2^st)
    for (int j = threadIdx.x; j < total; j += blockDim.x) {
      int col, b;
      if (col_fast) {
        col = j & ((1 << log_batch) - 1);
        b = j >> log_batch;
      } else {
        col = j >> log_half;
        b = j & ((1 << log_half) - 1);
      }
      const int pos = b & (h - 1);
      const int i0 = ((b >> (st - 1)) << st) + pos;
      const int i1 = i0 + h;
      float2* p0 = s + i0 * i_stride + col * c_stride;
      float2* p1 = s + i1 * i_stride + col * c_stride;
      const float2 t = cmul(tw[pos << tw_shift], *p1);
      const float2 u = *p0;
      *p0 = make_float2(u.x + t.x, u.y + t.y);
      *p1 = make_float2(u.x - t.x, u.y - t.y);
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
psd_pass1(const char2* __restrict__ iq, const float* __restrict__ win,
          float2* __restrict__ scratch, int log_n1, int log_n2, int decim) {
  extern __shared__ float2 smem[];
  const int n1 = 1 << log_n1, n2 = 1 << log_n2;
  const long long n = (long long)n1 * n2;
  float2* tw = smem;            // [n1/2]
  float2* a = smem + n1 / 2;    // [n1][kCols]
  const long long frame = blockIdx.y;
  const int c0 = blockIdx.x * kCols;
  // Decimator frame select: only the first fft pairs of each fft*decim group
  const char2* x = iq + frame * n * decim;
  fill_twiddles(tw, n1);
  for (int e = threadIdx.x; e < n1 * kCols; e += blockDim.x) {
    const int g = e % kCols, r = e / kCols;  // row n1 = r, column n2 = c0 + g
    const int idx = r * n2 + c0 + g;
    const char2 v = x[idx];
    const float w = win[idx];
    a[bitrev(r, log_n1) * kCols + g] =
        make_float2((float)v.x / 127.5f * w, (float)v.y / 127.5f * w);
  }
  __syncthreads();
  fft_batch(a, tw, log_n1, 4, kCols, 1, true);  // kCols = 2^4
  float2* c = scratch + frame * n;
  for (int e = threadIdx.x; e < n1 * kCols; e += blockDim.x) {
    const int g = e % kCols, k1 = e / kCols;
    const int col = c0 + g;
    float s, co;
    sincospif(-2.0f * (float)(k1 * col) / (float)n, &s, &co);
    c[(long long)k1 * n2 + col] = cmul(a[k1 * kCols + g], make_float2(co, s));
  }
}

__global__ void __launch_bounds__(kThreads)
psd_pass2(const float2* __restrict__ scratch, float* __restrict__ out,
          int log_n1, int log_n2, float rate) {
  extern __shared__ float2 smem[];
  const int n1 = 1 << log_n1, n2 = 1 << log_n2;
  const long long n = (long long)n1 * n2;
  float2* tw = smem;            // [n2/2]
  float2* d = smem + n2 / 2;    // [kRows][n2]
  const long long frame = blockIdx.y;
  const int r0 = blockIdx.x * kRows;
  const float2* c = scratch + frame * n + (long long)r0 * n2;
  fill_twiddles(tw, n2);
  for (int e = threadIdx.x; e < kRows * n2; e += blockDim.x) {
    const int r = e >> log_n2, i = e & (n2 - 1);
    d[r * n2 + bitrev(i, log_n2)] = c[e];
  }
  __syncthreads();
  fft_batch(d, tw, log_n2, 4, 1, n2, false);  // kRows = 2^4
  float* o = out + frame * n;
  for (int e = threadIdx.x; e < kRows * n2; e += blockDim.x) {
    const int r = e % kRows, k2 = e / kRows;
    const float2 v = d[r * n2 + k2];
    const float p = v.x * v.x + v.y * v.y;
    o[(long long)k2 * n1 + r0 + r] = 10.0f * log10f(fmaxf(p, 1e-30f) / rate);
  }
}

}  // namespace

// iq: [frames, fft*decim, 2] int8; win: [fft] f32 (Hamming * (-1)^n);
// scratch: [frames, fft] complex f32; out: [frames, fft] f32.
// fft = 2^(log_n1 + log_n2) with 16 <= 2^log_n2 <= 2^log_n1.
extern "C" int psd_frames_int8(const void* iq, const void* win, void* scratch, void* out,
                               int frames, int log_n1, int log_n2, int decim, float rate,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int n1 = 1 << log_n1, n2 = 1 << log_n2;
  const int sm1 = (int)((n1 / 2 + (size_t)n1 * kCols) * sizeof(float2));
  const int sm2 = (int)((n2 / 2 + (size_t)kRows * n2) * sizeof(float2));
  cudaError_t err = cudaFuncSetAttribute(psd_pass1, cudaFuncAttributeMaxDynamicSharedMemorySize, sm1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(psd_pass2, cudaFuncAttributeMaxDynamicSharedMemorySize, sm2);
  if (err != cudaSuccess) return (int)err;
  psd_pass1<<<dim3(n2 / kCols, frames), kThreads, sm1, s>>>(
      (const char2*)iq, (const float*)win, (float2*)scratch, log_n1, log_n2, decim);
  psd_pass2<<<dim3(n1 / kRows, frames), kThreads, sm2, s>>>(
      (const float2*)scratch, (float*)out, log_n1, log_n2, rate);
  return (int)cudaGetLastError();
}
