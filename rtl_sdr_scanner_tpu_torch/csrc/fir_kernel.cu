// Decimating FIR stage of the DDC's resampler cascade on Hopper: one
// decimation-only stage (interp 1, decim M) over rows of f32 samples with an
// overlap-save tail,
//   y[b, p] = sum_{j < R*M} full[b, p*M + j] * h_rev[j],
//   full = tail ++ x ++ zeros,   h_rev[q*M + r] = W[r][q],
// W the [M, R] reversed-tap polyphase matrix of plan_stage.
//
// Replaces the TPU kernel stage_apply_pallas / _decim_fir_rows
// (rtl_sdr_scanner_tpu/ops/pallas/fir_kernel.py). That kernel ran each tile
// as one MXU product Z = rows @ W followed by R diagonal slices, and needed
// M % 128 == 0, B % 8 == 0 and a tile width >= 64 (Mosaic rules). Here the
// FIR is computed directly, for any M a real chain produces (8 ... 125).
//
// Bound: at the v1 path's shape (2.4 Msps -> 32 kHz, stage (1, 75), 96 rows
// of 1,228,800 samples, R = 34) one launch must read 472.8 MB and write
// 6.3 MB: 0.143 ms at 3.35 TB/s. It does 2 * 96 * 16384 * 2550 = 8.0 GFLOP:
// 0.120 ms at 67 TFLOP/s f32. Bound by bytes, the arithmetic close behind,
// so the design has to keep the FMA units fed from shared memory and read
// device memory once:
//   - one block per (row, tile of kTO outputs) stages the input window
//     full[p0*M : (p0 + kTO + Rp - 1)*M] in shared memory with coalesced
//     asynchronous copies (cp.async, all in flight at once; tail and x are
//     read in place: the wrapper never materialises `full`), and
//     the [M, Rp] weights beside it; consecutive tiles overlap by Rp - 1 rows,
//     which come mostly from L2;
//   - the window is stored as rows of Mp = M | 1 floats: a lane's outputs are
//     kU consecutive outputs, so lanes read kU*Mp floats apart, an odd stride,
//     which keeps every shared-memory read free of bank conflicts, also for
//     even M (a stride of M = 32 would be a 32-way conflict);
//   - register tiles: per (phase r, kQB tap rows) a lane loads kU + kQB - 1
//     window values and kQB weights (two broadcast float4 loads) and does
//     kU * kQB = 72 FMAs, so shared-memory bandwidth matches the FMA rate;
//   - the M phases are split over the block's 8 warps; their partial sums
//     are added in a fixed order at the end (deterministic).
// R is padded up to Rp, a multiple of kQB, with zero taps (34 -> 40 rows:
// 18% more FMAs than the bound counts).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kU = 9;          // outputs per lane; odd, see the note above
constexpr int kQB = 8;         // tap rows per register tile; Rp % kQB == 0
constexpr int kTO = 32 * kU;   // outputs per block
constexpr int kMaxSmem = 232448;  // 227 KB, what one block may use

__host__ __device__ inline int window_floats(int rp, int mp) {
  return ((kTO + rp - 1) * mp + 3) / 4 * 4;  // 16-byte aligned end
}

__host__ inline size_t smem_bytes(int m, int rp) {
  const int mp = m | 1;
  int floats = window_floats(rp, mp) + m * rp;
  if (floats < kWarps * kTO) floats = kWarps * kTO;  // the partial-sum table
  return (size_t)floats * sizeof(float);
}

// 4-byte global -> shared copy that bypasses registers; !valid writes 0
__device__ __forceinline__ void copy_async(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}

__global__ void __launch_bounds__(kThreads)
fir_decimate_kernel(const float* __restrict__ x, const float* __restrict__ tail,
                    const float* __restrict__ w, float* __restrict__ y, int n,
                    int tail_len, int m, int rp, int out_len) {
  extern __shared__ __align__(16) float smem[];
  const int mp = m | 1;
  const int rows_tile = kTO + rp - 1;
  float* win = smem;                           // [rows_tile][mp]
  float* hw = smem + window_floats(rp, mp);    // [m][rp]
  const int row = blockIdx.y;
  const int p0 = blockIdx.x * kTO;
  const float* xr = x + (size_t)row * n;
  const float* tr = tail + (size_t)row * tail_len;
  const long long total = (long long)tail_len + n;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // asynchronous copies: every load of the window is in flight at once
  // (a load-then-store loop left ~100 dependent round trips per thread)
  for (int i = threadIdx.x; i < m * rp; i += kThreads) copy_async(hw + i, w + i, true);
  for (int rr = warp; rr < rows_tile; rr += kWarps) {
    const long long base = (long long)(p0 + rr) * m;
    for (int r = lane; r < m; r += 32) {
      const long long j = base + r;
      const float* src = j < tail_len ? tr + j : xr + (j - tail_len);
      copy_async(win + rr * mp + r, j < total ? src : xr, j < total);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  float acc[kU];
#pragma unroll
  for (int u = 0; u < kU; ++u) acc[u] = 0.f;
  const float* wl = win + lane * kU * mp;
  for (int r = warp; r < m; r += kWarps) {
    const float* wr = wl + r;
    const float* hr = hw + r * rp;
    for (int qb = 0; qb < rp; qb += kQB) {
      float h[kQB];
#pragma unroll
      for (int q = 0; q < kQB; q += 4) {
        const float4 t = *reinterpret_cast<const float4*>(hr + qb + q);
        h[q] = t.x;
        h[q + 1] = t.y;
        h[q + 2] = t.z;
        h[q + 3] = t.w;
      }
      float v[kU + kQB - 1];
#pragma unroll
      for (int s = 0; s < kU + kQB - 1; ++s) v[s] = wr[(qb + s) * mp];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
#pragma unroll
        for (int q = 0; q < kQB; ++q) acc[u] = fmaf(v[u + q], h[q], acc[u]);
      }
    }
  }

  __syncthreads();  // the window is dead: reuse it for the partial sums
  float* red = smem;  // [kWarps][kTO]
#pragma unroll
  for (int u = 0; u < kU; ++u) red[warp * kTO + lane * kU + u] = acc[u];
  __syncthreads();
  for (int o = threadIdx.x; o < kTO; o += kThreads) {
    if (p0 + o < out_len) {
      float s = red[o];
#pragma unroll
      for (int k = 1; k < kWarps; ++k) s += red[k * kTO + o];
      y[(size_t)row * out_len + p0 + o] = s;
    }
  }
}

}  // namespace

// x: [rows, n] f32; tail: [rows, tail_len] f32; w: [m, rp] f32 (W[r][q],
// zero for q >= R, rp % 8 == 0); y: [rows, out_len] f32, out_len = n / m.
// Returns cudaGetLastError() after the launch (or the error that kept it
// from launching).
extern "C" int fir_decimate(const void* x, const void* tail, const void* w, void* y, int rows,
                            int n, int tail_len, int m, int rp, int out_len, void* stream) {
  if (rows <= 0 || rows > 65535 || m <= 0 || rp <= 0 || rp % kQB != 0 || out_len <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = smem_bytes(m, rp);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(fir_decimate_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(fir_decimate_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((out_len + kTO - 1) / kTO, rows);
  fir_decimate_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)tail, (const float*)w, (float*)y, n, tail_len, m, rp,
      out_len);
  return (int)cudaGetLastError();
}
