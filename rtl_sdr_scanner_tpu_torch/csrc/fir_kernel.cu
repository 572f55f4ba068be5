// Decimating FIR stage of the DDC's resampler cascade on Hopper tensor
// cores: one decimation-only stage (interp 1, decim M) over rows of f32
// samples with an overlap-save tail,
//   y[b, p] = sum_{q < R} sum_{r < M} full[b, (p + q)*M + r] * W[r][q],
//   full = tail ++ x ++ zeros,
// W the [M, R] reversed-tap polyphase matrix of plan_stage; the new tail
// (full[n : n + tail_len]) is written by the same launch.
//
// Replaces the TPU kernel stage_apply_pallas / _decim_fir_rows
// (rtl_sdr_scanner_tpu/ops/pallas/fir_kernel.py) and keeps its form: per
// tile the product Z = rows @ W (rows = the window viewed as [T, M]), then
// the lag-diagonal sum y[p] = sum_q Z[p + q][q]. That kernel needed
// M % 128 == 0 (a Mosaic DMA rule); this one takes any M whose tile fits
// shared memory (every M of a real chain, 2 ... 125), so it is the only form.
//
// Bound: at the v1 path's shape (2.4 Msps -> 32 kHz, stage (1, 75), 96 rows
// of 1,228,800 samples, R = 34) a launch must read 472.8 MB and write
// 6.3 MB: 0.143 ms at 3.35 TB/s. On the CUDA cores its 8.0 GFLOP are
// 0.120 ms at the 67 TFLOP/s f32 peak, too close to the byte bound to
// hide; on the tensor cores the three TF32 passes are ~0.06 ms of the
// 495 TFLOP/s dense rate, so the kernel can be bound by its bytes:
//   - the product runs on mma.sync.m16n8k8 TF32. A is the window as
//     [T, Mp] (M padded to Mp = 8*ceil(M/8) by a guard that reads 0 past
//     column M), B is W as [Mp, 40] (R <= 34 for every M, zero-padded).
//     TF32 keeps ~3 decimal digits, so every product is split in three:
//     x_hi*W_hi + x_lo*W_hi + x_hi*W_lo, with W_hi = tf32(W) and W_lo =
//     tf32(W - W_hi) split on the host (in the fragment order of B) and x
//     split in registers as it is loaded; f32-class error, ~1e-6 of max|y|;
//   - a persistent block walks a run of consecutive (row, tile) pairs. A
//     tile is T = 256 new rows of Z (128 for a large M); the block carries
//     the last R - 1 rows of Z from one tile to the next, so no halo is
//     copied or multiplied twice (a run that starts inside a row first
//     computes the tile before it). Each window is copied by 16-byte
//     cp.async into a two-stage ring while the previous tile's products
//     run. The window is the contiguous span full[t*T*M : (t + 1)*T*M],
//     placed at a shift of 0-3 floats in shared memory so that x's 16-byte
//     chunks land aligned;
//     chunks at the ends of x, zeros past it, and tail chunks whose
//     alignment differs from x's (a row's first tile only) are copied or
//     written per float;
//   - the eight warps each own 2 m-tiles (32 window rows, or 1 m-tile when
//     two windows of a large M would not fit), two warps a scheduler
//     to hide each other's shared-memory latency: B fragments are loaded
//     once per k-step and reused over the m-tiles and the three passes,
//     run pass by pass so that consecutive products go to different
//     accumulators. An m-tile's 8-row halves are window rows 2*MT apart,
//     not consecutive, so that for odd M (4 rows apart) the A loads of a
//     warp hit 32 distinct banks;
//   - Z goes to shared memory, never to device memory; each output's lags
//     are summed in ascending q, the order of the plain version;
//   - the kernel's attributes are set once per device, not per launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kNT = 5;           // n-tiles of 8 taps
constexpr int kRp = kNT * 8;     // R padded: 40 >= 34
constexpr int kZS = kRp + 1;     // Z row stride in shared memory, odd: conflict-free lag sums
constexpr int kZC = kRp;         // Z rows carried from a tile to the next (>= R - 1)
constexpr int kFrag = kNT * 32 * 4;  // floats of B fragments per k-step (hi, hi, lo, lo per lane)
constexpr int kMaxSmem = 232448;     // 227 KB, what one block may use
constexpr int kMaxDevices = 64;

__host__ __device__ constexpr int tile_rows(int mt) { return kWarps * mt * 16; }

// floats of one ring stage: the window at a shift of up to 3
__host__ __device__ inline int stage_floats(int m, int tr) { return (tr * m + 3 + 3) / 4 * 4; }

// B fragments, two window stages, Z with the rows carried in front
__host__ inline size_t smem_bytes(int m, int mt) {
  const int ks = (m + 7) / 8, tr = tile_rows(mt);
  return (size_t)(ks * kFrag + 2 * stage_floats(m, tr) + (kZC + tr) * kZS) * sizeof(float);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ int float_misalign(const float* p) {
  return (int)((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// One 16-byte chunk of a window whose floats come from the tail, from x
// or from nowhere (zeros): 16 bytes at once where its source allows it.
__device__ void load_chunk(float* dst, int j0, const float* tr, const float* xg, int jt, int jx,
                           bool tail_aligned) {
  if (j0 >= jx) {
    *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
  } else if (j0 >= jt) {  // x runs out inside the chunk: copy what is left, zero the rest
    cp_async16(dst, xg + j0, 4 * min(jx - j0, 4));
  } else if (j0 >= 0 && j0 + 3 < jt && tail_aligned) {
    cp_async16(dst, tr + j0, 16);
  } else {
    for (int e = 0; e < 4; ++e) {
      const int j = j0 + e;
      if (j < 0 || j >= jx) {
        dst[e] = 0.f;
      } else {
        cp_async4(dst + e, j < jt ? tr + j : xg + j);
      }
    }
  }
}

// Start the copies of one tile's window full[g0 : g0 + len] into `stage`
// at the returned shift (cp.async for data, plain stores for zeros).
__device__ int load_window(float* stage, const float* xr, const float* tr, long long g0, int len,
                           int tail_len, long long total) {
  const long long jt_ll = tail_len - g0;
  const int jt = (int)(jt_ll < 0 ? 0 : (jt_ll > len ? len : jt_ll));  // tail: [0, jt)
  const long long jx_ll = total - g0;
  const int jx = (int)(jx_ll < jt ? jt : (jx_ll > len ? len : jx_ll));  // x: [jt, jx)
  const float* xw = xr - tail_len + g0;  // xw[j] = x[g0 + j - tail_len]
  const float* tw = tr + g0;             // tw[j] = tail[g0 + j]
  const int shift = jx > jt ? (float_misalign(xw + jt) - jt) & 3 : float_misalign(tw);
  const bool tail_aligned = jt == 0 || ((float_misalign(tw) - shift) & 3) == 0;
  const int chunks = (shift + len + 3) / 4;
  // chunk c holds window floats j0 = 4c - shift ... j0 + 3; those of
  // [cx0, cx1) all come from x, 16 aligned bytes each: the bulk of a tile
  const int cx0 = min((jt + shift + 3) / 4, chunks);
  const int cx1 = max((jx + shift) / 4, cx0);
  for (int c = cx0 + threadIdx.x; c < cx1; c += kThreads) {
    cp_async16(stage + 4 * c, xw + (4 * c - shift), 16);
  }
  for (int c = threadIdx.x; c < cx0; c += kThreads) {
    load_chunk(stage + 4 * c, 4 * c - shift, tw, xw, jt, jx, tail_aligned);
  }
  for (int c = cx1 + threadIdx.x; c < chunks; c += kThreads) {
    load_chunk(stage + 4 * c, 4 * c - shift, tw, xw, jt, jx, tail_aligned);
  }
  return shift;
}

template <int MT>
__global__ void __launch_bounds__(kThreads, 1)
fir_decimate_kernel(const float* __restrict__ x, const float* __restrict__ tail,
                    const float* __restrict__ wfrag, float* __restrict__ y,
                    float* __restrict__ new_tail, int n, int tail_len, int m, int r_rows,
                    int out_len, int tiles_per_row, int total_tiles) {
  constexpr int TR = tile_rows(MT);
  extern __shared__ __align__(16) float smem[];
  const int ks = (m + 7) / 8;
  float* bfrag = smem;  // [ks][kNT][32][4]
  const int sf = stage_floats(m, TR);
  float* const ring = smem + ks * kFrag;  // two stages of sf floats
  float* const z = ring + 2 * sf;         // [kZC + TR][kZS]: carried rows, then the tile's
  const long long total = (long long)tail_len + n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;

  // the new tail, full[n : n + tail_len], spread over the grid
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
       i < (long long)(total_tiles / tiles_per_row) * tail_len; i += (long long)gridDim.x * kThreads) {
    const long long row = i / tail_len;
    const int k = (int)(i - row * tail_len);
    const long long g = (long long)n + k;
    new_tail[i] = g < tail_len ? tail[row * tail_len + g] : x[row * n + (g - tail_len)];
  }

  // B fragments, once; they travel with the first tile's copy group
  for (int i = threadIdx.x; i < ks * kFrag / 4; i += kThreads) {
    cp_async16(bfrag + 4 * i, wfrag + 4 * i, 16);
  }
  // this block's run of consecutive tiles; a run that starts inside a row
  // first computes the tile before it, for the Z rows it carries
  const int start = (int)((long long)total_tiles * blockIdx.x / gridDim.x);
  const int end = (int)((long long)total_tiles * (blockIdx.x + 1) / gridDim.x);
  int item = start > 0 && start < end && start % tiles_per_row != 0 ? start - 1 : start;
  int shift0 = 0, shift1 = 0;
  if (item < end) {
    const int row = item / tiles_per_row, t = item - row * tiles_per_row;
    shift0 = load_window(ring, x + (size_t)row * n, tail + (size_t)row * tail_len,
                         (long long)t * TR * m, TR * m, tail_len, total);
  }
  asm volatile("cp.async.commit_group;\n" ::);

  // window rows of this lane's A fragments: m-tile j, MMA rows gid and
  // gid + 8 are rows base + 2*MT*gid + 2*j and the next one
  int row0[MT], off0[MT], off1[MT];
#pragma unroll
  for (int j = 0; j < MT; ++j) {
    row0[j] = warp * MT * 16 + 2 * MT * gid + 2 * j;
    off0[j] = row0[j] * m;
    off1[j] = (row0[j] + 1) * m;
  }

  for (int it = 0; item < end; ++it, ++item) {
    const int s = it & 1;
    asm volatile("cp.async.wait_all;\n" ::);
    __syncthreads();  // this tile has landed; the last tile's lag sums are done
    // carry the last tile's final R - 1 Z rows in front of this tile's
    for (int i = threadIdx.x; i < (r_rows - 1) * kZS; i += kThreads) {
      z[(kZC - r_rows + 1) * kZS + i] = z[(kZC + TR - r_rows + 1) * kZS + i];
    }
    const int next = item + 1;
    if (next < end) {
      const int row = next / tiles_per_row, t = next - row * tiles_per_row;
      const int sh = load_window(ring + (s ^ 1) * sf, x + (size_t)row * n, tail + (size_t)row * tail_len,
                                 (long long)t * TR * m, TR * m, tail_len, total);
      if (s) shift0 = sh; else shift1 = sh;
    }
    asm volatile("cp.async.commit_group;\n" ::);

    float* stage = ring + s * sf;
    const float* win = stage + (s ? shift1 : shift0);
    float acc[MT][kNT][4];
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][nt][e] = 0.f;

#pragma unroll 2
    for (int kk = 0; kk < ks; ++kk) {
      float4 b[kNT];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        b[nt] = reinterpret_cast<const float4*>(bfrag)[(kk * kNT + nt) * 32 + lane];
      }
      const int c0 = kk * 8 + tig, c1 = c0 + 4;
      const bool v0 = c0 < m, v1 = c1 < m;
      uint32_t hi[MT][4], lo[MT][4];
#pragma unroll
      for (int j = 0; j < MT; ++j) {
        const float a[4] = {v0 ? win[off0[j] + c0] : 0.f, v0 ? win[off1[j] + c0] : 0.f,
                            v1 ? win[off0[j] + c1] : 0.f, v1 ? win[off1[j] + c1] : 0.f};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          hi[j][e] = to_tf32(a[e]);
          lo[j][e] = to_tf32(a[e] - __uint_as_float(hi[j][e]));
        }
      }
      // pass-major: consecutive products go to different accumulators
#pragma unroll
      for (int j = 0; j < MT; ++j)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
          mma_tf32(acc[j][nt], lo[j], __float_as_uint(b[nt].x), __float_as_uint(b[nt].y));
#pragma unroll
      for (int j = 0; j < MT; ++j)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
          mma_tf32(acc[j][nt], hi[j], __float_as_uint(b[nt].z), __float_as_uint(b[nt].w));
#pragma unroll
      for (int j = 0; j < MT; ++j)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
          mma_tf32(acc[j][nt], hi[j], __float_as_uint(b[nt].x), __float_as_uint(b[nt].y));
    }

    __syncthreads();  // the carried rows are copied: this tile's Z goes behind them
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      const int r0 = kZC + row0[j], r1 = r0 + 1;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int col = nt * 8 + 2 * tig;
        z[r0 * kZS + col] = acc[j][nt][0];
        z[r0 * kZS + col + 1] = acc[j][nt][1];
        z[r1 * kZS + col] = acc[j][nt][2];
        z[r1 * kZS + col + 1] = acc[j][nt][3];
      }
    }
    __syncthreads();
    if (item < start) continue;  // the run's lead-in tile: its Z rows are carried only
    // outputs whose last lag row is in this tile: p = t*TR - (R - 1) + v
    const int row = item / tiles_per_row;
    float* yr = y + (size_t)row * out_len;
    const int p_first = (item - row * tiles_per_row) * TR - r_rows + 1;
    for (int v = threadIdx.x; v < TR; v += kThreads) {
      const int p = p_first + v;
      if (p < 0 || p >= out_len) continue;
      const float* zp = z + (kZC - r_rows + 1 + v) * kZS;  // Z row p
      float acc_y = zp[0];
#pragma unroll
      for (int q = 1; q < kRp; ++q) {
        if (q < r_rows) acc_y += zp[q * kZS + q];
      }
      yr[p] = acc_y;
    }
  }
}

struct LaunchInfo {
  bool ready;
  int sms;
  int blocks_per_sm[2];  // MT = 2, 1 at the last size asked
  int smem[2];
};
LaunchInfo g_info[kMaxDevices];

template <int MT>
int launch(int dev, int slot, size_t smem, int total_tiles, const float* x, const float* tail,
           const float* w, float* y, float* new_tail, int n, int tail_len, int m, int r_rows,
           int out_len, int tiles_per_row, cudaStream_t stream) {
  LaunchInfo& info = g_info[dev];
  if (info.smem[slot] != (int)smem) {  // once per device and shared-memory size
    int nb = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, fir_decimate_kernel<MT>,
                                                                    kThreads, smem);
    if (err != cudaSuccess) return (int)err;
    if (nb < 1) return (int)cudaErrorInvalidConfiguration;
    info.blocks_per_sm[slot] = nb;
    info.smem[slot] = (int)smem;
  }
  int grid = info.sms * info.blocks_per_sm[slot];
  if (grid > total_tiles) grid = total_tiles;  // every block gets a run of >= 1 tile
  fir_decimate_kernel<MT><<<grid, kThreads, smem, stream>>>(
      x, tail, w, y, new_tail, n, tail_len, m, r_rows, out_len, tiles_per_row, total_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// x: [rows, n] f32; tail: [rows, tail_len] f32; w: B fragments of
// W_hi/W_lo, [ceil(m/8)][5][32][4] f32 (ops/cuda/fir_kernel.py packs them);
// y: [rows, out_len] f32, out_len = n / m; new_tail: [rows, tail_len] f32.
// Any pointer may sit at any 4-byte offset. Returns cudaGetLastError()
// after the launch (or the error that kept it from launching).
extern "C" int fir_decimate(const void* x, const void* tail, const void* w, void* y,
                            void* new_tail, int rows, int n, int tail_len, int m, int r_rows,
                            int out_len, void* stream) {
  if (rows <= 0 || m <= 0 || r_rows <= 0 || r_rows > kRp || out_len <= 0 || tail_len <= 0 ||
      (long long)out_len * m != n) {
    return (int)cudaErrorInvalidValue;
  }
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  LaunchInfo& info = g_info[dev];
  if (!info.ready) {  // once per device: no launch sets an attribute
    err = cudaDeviceGetAttribute(&info.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(fir_decimate_kernel<2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(fir_decimate_kernel<1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    info.smem[0] = info.smem[1] = -1;
    info.ready = true;
  }
  const int mt = smem_bytes(m, 2) <= (size_t)kMaxSmem ? 2 : 1;
  const size_t smem = smem_bytes(m, mt);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  // a tile is TR rows of Z; a row has out_len + R - 1 of them
  const int tiles_per_row = (out_len + r_rows - 1 + tile_rows(mt) - 1) / tile_rows(mt);
  const long long total = (long long)tiles_per_row * rows;
  if (total > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float *xf = (const float*)x, *tf = (const float*)tail, *wf = (const float*)w;
  if (mt == 2) {
    return launch<2>(dev, 0, smem, (int)total, xf, tf, wf, (float*)y, (float*)new_tail, n,
                     tail_len, m, r_rows, out_len, tiles_per_row, s);
  }
  return launch<1>(dev, 1, smem, (int)total, xf, tf, wf, (float*)y, (float*)new_tail, n,
                   tail_len, m, r_rows, out_len, tiles_per_row, s);
}
