// Stage 1 of the modulated-taps DDC on Hopper tensor cores, with its
// decimated-rate rotation: for each band b and slot k (decimation M, R lags),
//   y1[p]  = sum_{q < R} sum_{r < M} full[(p + q)*M + r] * G_k[r][q],
//   y[p]   = y1[p] * e^{i(phase_k + angle_k(p))},
//   full   = tail ++ x ++ zeros (complex samples),
// G_k[r][q] = g_k[q*M + r] the reversed modulated taps h[j] e^{-i inc_k j}
// (ops/ddc.make_mod_tables), y written as [NB*K, 2, n / M] f32 (row
// band*K + k, re then im) and the new raw tail (full[n : n + tail_len]) by
// the same launch.
//
// Replaces no TPU kernel: the JAX package leaves stage 1 to XLA's
// dot_general (rtl_sdr_scanner_tpu/ops/ddc.py, _modtap_stage1: the chunked
// product against a banded Toeplitz matrix, then the lag sums and the
// rotation as separate ops). The port's matmul form of it widened the int8
// chunk to f32, padded it, multiplied every 1280-sample row against a
// [1280, 512] Toeplitz matrix (3.9x the stage's multiply-adds, f32 on the
// CUDA cores), then summed lags, combined re and im and rotated in eight
// more passes over the outputs.
//
// Bound: at hf20m48's chunk (24 bands, 2 slots, M = 20, R = 34, 1,105,920
// int8 samples a band) a launch must read 53.1 MB and write 21.2 MB: 0.022
// ms at 3.35 TB/s. Its useful work is 13.9 GFLOP (8 a complex tap and
// output), 0.208 ms at the 67 TFLOP/s f32 peak: the stage is bound by its
// operations, so the product runs on the tensor cores, in one of two forms
// (the caller picks one from M, R and K: ops/cuda/ddc_kernel.folds).
//
// The lag form (modtap_stage1_kernel, entry modtap_stage1):
//   - the complex product is one real product. A window row is the 2M
//     interleaved floats (re, im) of M consecutive samples, and B is
//     [2M, 4R] a column group: for each of its two slots the columns of
//     y_re (rows re: G_re, rows im: -G_im) and of y_im (G_im, G_re), R
//     lags each. Z = rows @ B holds y_re's and y_im's lag terms at once.
//   - mma.sync.m16n8k8 TF32 in split form: B = B_hi + B_lo split on the
//     host (ops/cuda/ddc_kernel.mod_fragments, in fragment order). An int8
//     window holds integers, exact in TF32, so it takes two passes
//     (x*B_lo + x*B_hi) and the 1/127.5 scale after the lag sum. A window
//     that reaches into the carried tail holds that tail's f32 values (x
//     127.5 on the int8 route) and, like every f32 window (f32 pairs in),
//     takes three (x_lo*B_hi + x_hi*B_lo + x_hi*B_hi, x split in
//     registers): f32-class error, ~1e-6 of max|y|;
//   - a persistent block walks a run of consecutive (band, column group,
//     tile) items. A tile is T = 128 new rows of Z (64 where the window
//     does not fit; T >= R - 1); the block carries the last R - 1 rows of Z from one
//     tile to the next. An int8 window comes in raw by 16-byte cp.async
//     into a two-stage ring while the previous tile's products run, from the
//     stream's own band stride, and is staged once into an f32 tile of
//     padded rows (stride = 4 mod 8 words: the A loads hit 32 banks), with
//     the tail's values and the zeros past x written there, and zero columns
//     up to the k-steps' width, so the product loop has no guard. f32 pairs
//     need no conversion: their copies land in the rows of two such tiles
//     (a tile at either end of a row is staged from the stream itself);
//   - eight warps: 2 along the rows (4 m-tiles each) by 4 along the columns
//     (n-tiles w, w + 4, ..., 5 a warp; a group is 20 n-tiles, 160 columns
//     >= 4R for R <= 40; a warp multiplies only its n-tiles below 4R, by a
//     product loop instantiated for each count, so that no branch splits the
//     products). B fragments sit in
//     shared memory once per (band, group) where they fit (M = 20: 51 KB),
//     or are read from device memory through L1 (M = 64);
//   - Z goes to shared memory, never to device memory; each output's lags
//     are summed in ascending q, the order of the FIR kernel's plain
//     version; the rotation is formed as ops/ddc._rotation forms it, every
//     product and sum rounded alone ((cos, sin) of the phase x coarse, then
//     x fine, then y x that), never fused;
//   - no atomics and no split of a band: a band's outputs depend only on
//     its own rows, whatever else the launch holds;
//   - the kernel's attributes are set once per device, not per launch,
//     under a mutex shared with the occupancy cache.
// On an H100 it takes 0.343 ms for that chunk, 17% of its bound (0.058 ms:
// the passes' 28.9 GFLOP at the 495 TFLOP/s TF32 rate): mma.sync peaks near
// half that rate, and the staging, Z stores and lag sums run a barrier apart
// from the products (PERF.md §6).
//
// The folded form (modtap_fold_kernel, entry modtap_fold), for small M and
// many slots (ds491m52: M = 8, K = 16, a 16-deep lag product, where the lag
// form's Z stores, 34 lag sums an output and 8 stagings of each window for 8
// column groups outweighed its product): the lags go into the product's depth,
//   y[p] = sum over (q, 2r + c) of window[p + q][2r + c] * B_fold[(q, 2r + c)][(slot, re / im)],
// A a Hankel read of the staged window tile (row p + q, at the same 4 mod 8
// stride), B_fold [R 8 ceil(2M / 8), 8 ceil(2K / 8)] with a slot's y_re and
// y_im in adjacent columns, so that a lane's accumulator pair holds one
// output (ops/cuda/ddc_kernel.mod_b_fold, split and packed as above):
//   - the same split TF32 passes, two on integers and three where f32
//     values are in the window; the accumulators take one lag's k-steps,
//     as the lag form's Z does, and the lags are added in f32 in ascending
//     q (8 k-steps a register doubled the error against float64: the
//     tensor cores' sums truncate);
//   - eight warps along a tile's rows (4 m-tiles each: T = 512 outputs; 2
//     where the window does not fit), every warp over all 2K columns, so
//     that all K slots come from one staging of the window's T + R - 1
//     rows; B_fold sits in shared memory once per band (139 KB at M = 8,
//     K = 16), its copies issued with the first window's;
//   - a block walks a run of consecutive outputs, as even as the grid
//     makes them, in tiles within a band; a tile carries nothing to the
//     next: no Z, no carried rows, no lag sums. The ring and the interior
//     staging are the lag form's; a window at the tail or past x is staged
//     an element at a time over the whole block;
//   - the scale and the rotation straight from the accumulators, the
//     rotation formed as the lag form forms it; each pair of m-tiles' table
//     entries are loaded together before any is used (the epilogue is
//     bound by those loads' latency);
//   - its product has the lag form's multiply-adds where 2K is a multiple
//     of 8 (ds491m52: 17.1 GFLOP of passes a chunk, 0.035 ms at 495 TFLOP/s,
//     0.063 at mma.sync's 266-273), and the caller takes it only where they
//     are no more (and B_fold fits beside an f32 window).
// On an H100 it takes 0.141 ms for ds491m52's chunk (the lag form 0.400):
// 45% of mma.sync's ceiling; of a block's cycles the products take about
// 65% (at 86% of the instruction's rate), the epilogue 24%, the staging 6%
// (PERF.md §6).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <map>
#include <mutex>
#include <tuple>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kWM = 2;                  // warps along a tile's rows
constexpr int kWN = 4;                  // warps along a group's columns
constexpr int kNW = 5;                  // n-tiles a warp
constexpr int kNTG = kWN * kNW;         // n-tiles a column group: 160 columns
constexpr int kGroupSlots = 2;          // slots a column group: 4 outputs of R lags
constexpr int kMaxR = 40;               // R <= 40 (34 for every decimation)
constexpr int kZC = kMaxR;              // Z rows carried in front of a tile's (>= R - 1)
constexpr int kFrag = kNTG * 32 * 4;    // floats of B fragments a k-step (hi, hi, lo, lo a lane)
constexpr int kMaxSmem = 232448;        // 227 KB, what one block may use
constexpr int kMaxDevices = 64;
constexpr float kCs8Scale = (float)(1.0 / 127.5);
constexpr int kFoldMaxNT = 4;           // folded form: n-tiles of (slot, re / im) columns, 2K <= 32

__host__ __device__ constexpr int tile_rows(int mt) { return kWM * mt * 16; }

__host__ __device__ inline int k_steps(int m) { return (2 * m + 7) / 8; }

// f32 tile row stride: the k-steps' width plus 4, so that 8 rows start in 8
// distinct 4-bank groups
__host__ __device__ inline int win_stride(int m) { return k_steps(m) * 8 + 4; }

// bytes of one ring stage: the raw window at a shift of up to 15 bytes
__host__ __device__ inline int ring_bytes(int m, int tr, int esize) {
  return (tr * 2 * m * esize + 16 + 15) / 16 * 16;
}

// B fragments (where they sit in shared memory); int8: two raw ring stages
// and the f32 tile, f32: two f32 tiles (the copies land there); Z with the
// carried rows in front
__host__ __device__ inline size_t smem_bytes(int m, int nt_live, int mt, int esize, bool b_smem) {
  const int tr = tile_rows(mt);
  const size_t tile = (size_t)tr * win_stride(m) * 4;
  return (size_t)(b_smem ? k_steps(m) * kFrag * 4 : 0) +
         (esize == 1 ? 2 * (size_t)ring_bytes(m, tr, esize) + tile : 2 * tile) +
         (size_t)(kZC + tr) * (8 * nt_live + 1) * 4;
}

// folded form: a tile's outputs, every warp along the rows (mt m-tiles each)
__host__ __device__ constexpr int fold_tile_rows(int mt) { return kWarps * mt * 16; }

// folded form: B_fold's split fragments, then (int8) two raw ring stages and
// the f32 tile, (f32) two f32 tiles, each of the R - 1 + TR window rows a tile reads
__host__ __device__ inline size_t fold_smem_bytes(int m, int r_rows, int nt, int mt, int esize) {
  const int wr = fold_tile_rows(mt) + r_rows - 1;
  const size_t tile = (size_t)wr * win_stride(m) * 4;
  return (size_t)r_rows * k_steps(m) * nt * 512 +
         (esize == 1 ? 2 * (size_t)ring_bytes(m, wr, esize) + tile : 2 * tile);
}

struct Geometry {
  long long band_stride;  // elements from one band's stream to the next
  int n;                  // samples a band
  int nb, k, groups;      // bands, slots, column groups (ceil(k / 2))
  int t0, m, r_rows;      // tail samples, decimation, lags
  int nt_live;            // n-tiles holding columns: ceil(4R / 8)
  int out_len, log2q, coarse_len;  // outputs a slot; the rotation tables' fine length (2^log2q) and coarse
  int tiles_per_row, total_tiles;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
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

// a stream element in the plain version's units: int8 cs8 at 1/127.5
__device__ __forceinline__ float scaled(int8_t v) { return (float)v * kCs8Scale; }
__device__ __forceinline__ float scaled(float v) { return v; }

// Start the copies of x elements [e0, e0 + len) of one band's stream
// (element 2s + c is sample s's component c) into `stage` at the returned
// shift: 16-byte cp.async where a chunk lies inside [0, n2), the chunks at
// the ends element by element; elements outside [0, n2) are left as they
// are (the staging reads none).
template <typename T>
__device__ int load_ring(T* stage, const T* xrow, long long e0, int len, long long n2) {
  constexpr int kE = 16 / (int)sizeof(T);
  const int shift = (int)((((uintptr_t)xrow + (uintptr_t)(e0 * (long long)sizeof(T))) & 15) / sizeof(T));
  const int chunks = (shift + len + kE - 1) / kE;
  for (int c = threadIdx.x; c < chunks; c += kThreads) {
    const long long j0 = e0 - shift + (long long)c * kE;
    if (j0 >= 0 && j0 + kE <= n2) {
      cp_async16(stage + c * kE, xrow + j0);
    } else if (j0 + kE > 0 && j0 < n2) {
      for (int e = 0; e < kE; ++e) {
        const long long j = j0 + e;
        if (j >= 0 && j < n2) stage[c * kE + e] = xrow[j];
      }
    }
  }
  return shift;
}

// Four consecutive int8 ring elements from element e on, as floats
__device__ __forceinline__ float4 ring4(const int8_t* ring, int e) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(ring) + (e >> 2);
  const uint32_t v = (e & 3) ? __funnelshift_r(w[0], w[1], 8 * (e & 3)) : w[0];
  return make_float4((float)(int8_t)(v & 0xff), (float)(int8_t)((v >> 8) & 0xff),
                     (float)(int8_t)((v >> 16) & 0xff), (float)(int8_t)(v >> 24));
}

// A tile whose window lies inside x, for even M (all but a row's first and last)
__device__ __forceinline__ bool interior(long long s0, int tr, int m, int t0, long long n) {
  return s0 >= t0 && s0 - t0 + (long long)tr * m <= n && (m & 1) == 0;
}

// f32 pairs: start the copies of an interior tile's window straight into
// the f32 tile `win` (16 bytes a chunk, M / 2 a row) where x's part of it
// starts 16-byte aligned; false (nothing copied) otherwise.
__device__ bool copy_tile(float* win, const float* xrow, long long s0, int tr, int m, int ws, int t0,
                          long long n) {
  if (!interior(s0, tr, m, t0, n)) return false;
  const float* src = xrow + 2 * (s0 - t0);
  if ((reinterpret_cast<uintptr_t>(src) & 15) != 0) return false;
  const int q = m / 2;  // 16-byte chunks a row
  int r = threadIdx.x / q, cc = threadIdx.x - r * q;  // chunk c's row and place in it, stepped along
  const int dr = kThreads / q, dc = kThreads - dr * q;
  for (int c = threadIdx.x; c < tr * q; c += kThreads) {
    cp_async16(win + r * ws + 4 * cc, src + 4 * c);
    r += dr;
    cc += dc;
    if (cc >= q) {
      cc -= q;
      ++r;
    }
  }
  return true;
}

// The f32 tile of window rows [0, TR): row r, column c < 2M is full sample
// s0 + r*M + c/2, component c % 2 (the tail x tail_scale; x element
// 2(s0 - t0) + r*2M + c at src[shift + r*2M + c], from the int8 ring or, f32,
// the stream itself; zeros past x); columns 2M ... ws - 1 stay zero. An
// interior int8 tile takes four elements a step.
template <typename T>
__device__ void stage_tile(float* win, const T* src, int shift, const float* tail_row, long long s0, int tr,
                           int m, int ws, int t0, long long n, float tail_scale) {
  const int w2 = 2 * m;
  if constexpr (sizeof(T) == 1) {
    if (interior(s0, tr, m, t0, n)) {
      const int q = w2 / 4;  // four elements a step, q steps a row
      int r = threadIdx.x / q, cc = threadIdx.x - r * q;
      const int dr = kThreads / q, dc = kThreads - dr * q;
#pragma unroll 4
      for (int i = threadIdx.x; i < tr * q; i += kThreads) {
        *reinterpret_cast<float4*>(win + r * ws + 4 * cc) = ring4(src, shift + 4 * i);
        r += dr;
        cc += dc;
        if (cc >= q) {
          cc -= q;
          ++r;
        }
      }
      return;
    }
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < tr; r += kWarps) {
    const long long srow = s0 + (long long)r * m;
    for (int c = lane; c < w2; c += 32) {
      const long long s = srow + (c >> 1);
      float v = 0.f;
      if (s < t0) {
        v = tail_row[(c & 1) * t0 + s] * tail_scale;
      } else if (s - t0 < n) {
        v = (float)src[shift + r * w2 + c];
      }
      win[r * ws + c] = v;
    }
  }
}

// A tile's product into acc over NL n-tiles of the warp (B fragments of
// n-tile w + kWN jj, k-step kk at bw[(kk kNTG + kWN jj) 32]): Z = rows @ B in
// split TF32, two passes on integers (x B_lo, x B_hi), three when `three`
// (x_lo B_hi first); pass-major, smallest terms first, so that consecutive
// products go to different accumulators.
template <int NL, int MT>
__device__ __forceinline__ void tile_product(float (&acc)[MT][kNW][4], const float4* bw, const float* wt,
                                             const int (&arow)[MT], int ws, int ks, int tig, bool three,
                                             bool b_smem) {
#pragma unroll 1
  for (int kk = 0; kk < ks; ++kk) {
    float4 b[NL];
#pragma unroll
    for (int jj = 0; jj < NL; ++jj) {
      const float4* src = bw + (kk * kNTG + kWN * jj) * 32;
      b[jj] = b_smem ? *src : __ldg(src);
    }
    const int c0 = kk * 8 + tig, c1 = c0 + 4;
    float a[MT][4];
    uint32_t hi[MT][4];
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      a[j][0] = wt[arow[j] * ws + c0];
      a[j][1] = wt[(arow[j] + 8) * ws + c0];
      a[j][2] = wt[arow[j] * ws + c1];
      a[j][3] = wt[(arow[j] + 8) * ws + c1];
    }
    if (three) {
#pragma unroll
      for (int j = 0; j < MT; ++j) {
        uint32_t lo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          hi[j][e] = to_tf32(a[j][e]);
          lo[e] = to_tf32(a[j][e] - __uint_as_float(hi[j][e]));
        }
#pragma unroll
        for (int jj = 0; jj < NL; ++jj)
          mma_tf32(acc[j][jj], lo, __float_as_uint(b[jj].x), __float_as_uint(b[jj].y));
      }
    } else {  // integers: exact in TF32
#pragma unroll
      for (int j = 0; j < MT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) hi[j][e] = __float_as_uint(a[j][e]);
    }
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int jj = 0; jj < NL; ++jj)
        mma_tf32(acc[j][jj], hi[j], __float_as_uint(b[jj].z), __float_as_uint(b[jj].w));
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int jj = 0; jj < NL; ++jj)
        mma_tf32(acc[j][jj], hi[j], __float_as_uint(b[jj].x), __float_as_uint(b[jj].y));
  }
}

template <typename T, int MT, bool kBSmem>
__global__ void __launch_bounds__(kThreads, 1)
modtap_stage1_kernel(const T* __restrict__ x, const float* __restrict__ tail, const float* __restrict__ frag,
                     const float* __restrict__ phase, const float* __restrict__ coarse_re,
                     const float* __restrict__ coarse_im, const float* __restrict__ fine_re,
                     const float* __restrict__ fine_im, float* __restrict__ y, float* __restrict__ new_tail,
                     Geometry g) {
  constexpr bool kInt8 = sizeof(T) == 1;
  constexpr int TR = tile_rows(MT);
  // the carried rows come from the one tile before: a run's lead-in is one tile
  static_assert(TR >= kMaxR - 1, "a tile must hold the R - 1 rows the next one carries");
  extern __shared__ __align__(16) unsigned char smem[];
  const int zs = 8 * g.nt_live + 1;
  const int ks = k_steps(g.m), ws = win_stride(g.m), r_rows = g.r_rows;
  const int sb = ring_bytes(g.m, TR, (int)sizeof(T));
  float* const bfrag = reinterpret_cast<float*>(smem);  // [ks][kNTG][32][4], where kBSmem
  unsigned char* const ring = smem + (kBSmem ? (size_t)ks * kFrag * 4 : 0);  // int8: [2][sb] bytes
  float* const win = reinterpret_cast<float*>(ring + (kInt8 ? 2 * sb : 0));  // int8 [TR][ws], f32 [2][TR][ws]
  float* const z = win + (kInt8 ? 1 : 2) * TR * ws;                           // [kZC + TR][zs]
  const long long n = g.n, n2 = 2 * n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = warp % kWM, wn = warp / kWM;

  // the new tail, full[n : n + t0], spread over the grid
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < (long long)g.nb * 2 * g.t0;
       i += (long long)gridDim.x * kThreads) {
    const long long row = i / g.t0;  // band * 2 + component
    const long long s = n + (i - row * g.t0);
    new_tail[i] = s < g.t0 ? tail[row * g.t0 + s]
                           : scaled(x[(row >> 1) * g.band_stride + 2 * (s - g.t0) + (row & 1)]);
  }

  // this block's run of consecutive items; a run that starts inside a row
  // first computes the tile before it, for the Z rows it carries
  const int start = (int)((long long)g.total_tiles * blockIdx.x / gridDim.x);
  const int end = (int)((long long)g.total_tiles * (blockIdx.x + 1) / gridDim.x);
  int item = start > 0 && start < end && start % g.tiles_per_row != 0 ? start - 1 : start;
  const long long span = (long long)TR * g.m;  // samples a tile's window spans
  // int8: the ring stage's shift; f32: whether the tile's copies are in flight
  int shift0 = 0, shift1 = 0;
  if (item < end) {
    const int row = item / g.tiles_per_row, t = item - row * g.tiles_per_row;
    const T* xrow = x + (long long)(row / g.groups) * g.band_stride;
    if (kInt8) {
      shift0 = load_ring(reinterpret_cast<T*>(ring), xrow, 2 * (t * span - g.t0), TR * 2 * g.m, n2);
    } else {
      shift0 = copy_tile(win, reinterpret_cast<const float*>(xrow), t * span, TR, g.m, ws, g.t0, n);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);

  // the tiles' columns past 2M, zero for good
  for (int i = threadIdx.x; i < (kInt8 ? 1 : 2) * TR * (ws - 2 * g.m); i += kThreads) {
    const int r = i / (ws - 2 * g.m);
    win[r * ws + 2 * g.m + (i - r * (ws - 2 * g.m))] = 0.f;
  }

  // this thread's output in the epilogue: slot sl of the group, row v of the tile
  const int sl = threadIdx.x / TR, v = threadIdx.x - sl * TR;
  float ph_re = 0.f, ph_im = 0.f;
  int cur_row = -1;

  // window rows of this lane's A fragments (MMA rows gid and gid + 8)
  int arow[MT];
#pragma unroll
  for (int j = 0; j < MT; ++j) arow[j] = (wm * MT + j) * 16 + gid;

  for (int it = 0; item < end; ++it, ++item) {
    const int s = it & 1;
    const int row = item / g.tiles_per_row, t = item - row * g.tiles_per_row;
    const int band = row / g.groups, grp = row - band * g.groups;
    const int slot = grp * kGroupSlots + sl;
    asm volatile("cp.async.wait_all;\n" ::);
    __syncthreads();  // this tile's window has landed; the last tile's lag sums are done
    if (row != cur_row) {  // a new (band, group): its B fragments and the slot's phase
      cur_row = row;
      const float* src = frag + (size_t)row * ks * kFrag;
      if (kBSmem) {
        for (int i = threadIdx.x; i < ks * kFrag / 4; i += kThreads) cp_async16(bfrag + 4 * i, src + 4 * i);
      }
      asm volatile("cp.async.commit_group;\n" ::);
      if (sl < kGroupSlots && slot < g.k) {
        const float ph = phase[band * g.k + slot];
        ph_re = cosf(ph);
        ph_im = sinf(ph);
      }
    }
    // carry the last tile's final R - 1 Z rows in front of this tile's: one
    // run of (R - 1) zs floats, TR zs apart (a multiple of 4), so 16 bytes a
    // step past its first few
    {
      float* const dst = z + (kZC - r_rows + 1) * zs;
      const float* const src = dst + TR * zs;
      const int len = (r_rows - 1) * zs, head = (4 - (kZC - r_rows + 1) * zs % 4) % 4;
      if (threadIdx.x < head) dst[threadIdx.x] = src[threadIdx.x];
      const int quads = (len - head) / 4;
#pragma unroll 4
      for (int i = threadIdx.x; i < quads; i += kThreads) {
        reinterpret_cast<float4*>(dst + head)[i] = reinterpret_cast<const float4*>(src + head)[i];
      }
      for (int i = head + 4 * quads + threadIdx.x; i < len; i += kThreads) dst[i] = src[i];
    }
    const long long s0 = (long long)t * span;
    const T* const xrow = x + (long long)band * g.band_stride;
    float* const wt = kInt8 ? win : win + s * TR * ws;  // this tile's f32 window
    if (kInt8) {
      stage_tile(win, reinterpret_cast<const T*>(ring + s * sb), s ? shift1 : shift0,
                 tail + (size_t)band * 2 * g.t0, s0, TR, g.m, ws, g.t0, n, 127.5f);
    } else if (!(s ? shift1 : shift0)) {  // not copied: staged from the stream itself, element by element
      stage_tile(wt, xrow + 2 * (s0 - g.t0), 0, tail + (size_t)band * 2 * g.t0, s0, TR, g.m, ws, g.t0, n, 1.f);
    }
    const int next = item + 1;
    if (next < end) {
      const int nrow = next / g.tiles_per_row, nt = next - nrow * g.tiles_per_row;
      const T* nxrow = x + (long long)(nrow / g.groups) * g.band_stride;
      const int sh = kInt8 ? load_ring(reinterpret_cast<T*>(ring + (s ^ 1) * sb), nxrow, 2 * (nt * span - g.t0),
                                       TR * 2 * g.m, n2)
                           : copy_tile(win + (s ^ 1) * TR * ws, reinterpret_cast<const float*>(nxrow), nt * span,
                                       TR, g.m, ws, g.t0, n);
      if (s) shift0 = sh; else shift1 = sh;
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::);  // B fragments in; the next window may fly
    __syncthreads();  // the tile is staged

    // this thread's output of the tile and its rotation table entries,
    // loaded before the product so that they land during it
    const int p = t * TR - r_rows + 1 + v;
    const bool out_ok = item >= start && sl < kGroupSlots && slot < g.k && p >= 0 && p < g.out_len;
    const size_t tab = (size_t)band * g.k + slot;
    float co_re = 0.f, co_im = 0.f, f_re = 0.f, f_im = 0.f;
    if (out_ok) {
      const int ci = p >> g.log2q, fi = p & ((1 << g.log2q) - 1);
      co_re = coarse_re[tab * g.coarse_len + ci];
      co_im = coarse_im[tab * g.coarse_len + ci];
      f_re = fine_re[(tab << g.log2q) + fi];
      f_im = fine_im[(tab << g.log2q) + fi];
    }
    const float4* bsrc = kBSmem ? reinterpret_cast<const float4*>(bfrag)
                                : reinterpret_cast<const float4*>(frag + (size_t)row * ks * kFrag);
    const bool three = !kInt8 || s0 < g.t0;  // f32 values in the window: split x too
    float acc[MT][kNW][4];
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int jj = 0; jj < kNW; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][jj][e] = 0.f;

    // this warp's n-tiles holding columns (w, w + 4, ... below 8 nt_live):
    // the product loop is instantiated for each count, so that the one
    // branch is outside it
    const int nl = min(kNW, max(0, (g.nt_live - wn + kWN - 1) / kWN));
    const float4* const bw = bsrc + wn * 32 + lane;
    switch (nl) {
      case 5: tile_product<5>(acc, bw, wt, arow, ws, ks, tig, three, kBSmem); break;
      case 4: tile_product<4>(acc, bw, wt, arow, ws, ks, tig, three, kBSmem); break;
      case 3: tile_product<3>(acc, bw, wt, arow, ws, ks, tig, three, kBSmem); break;
      case 2: tile_product<2>(acc, bw, wt, arow, ws, ks, tig, three, kBSmem); break;
      case 1: tile_product<1>(acc, bw, wt, arow, ws, ks, tig, three, kBSmem); break;
      default: break;
    }

    // Z behind the carried rows (copied before the last barrier)
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      const int r0 = kZC + arow[j], r1 = r0 + 8;
#pragma unroll
      for (int jj = 0; jj < kNW; ++jj) {
        const int ntile = wn + kWN * jj;
        if (ntile < g.nt_live) {
          const int col = ntile * 8 + 2 * tig;
          z[r0 * zs + col] = acc[j][jj][0];
          z[r0 * zs + col + 1] = acc[j][jj][1];
          z[r1 * zs + col] = acc[j][jj][2];
          z[r1 * zs + col + 1] = acc[j][jj][3];
        }
      }
    }
    __syncthreads();
    // outputs whose last lag row is in this tile, p = t*TR - (R - 1) + v (none
    // in the run's lead-in tile: its Z rows are carried only)
    if (out_ok) {
      const float* zp = z + (kZC - r_rows + 1 + v) * zs + 2 * sl * r_rows;
      float re = zp[0], im = zp[r_rows];
#pragma unroll
      for (int q = 1; q < kMaxR; ++q) {
        if (q < r_rows) {
          re += zp[q * zs + q];
          im += zp[q * zs + r_rows + q];
        }
      }
      if (kInt8) {
        re *= kCs8Scale;
        im *= kCs8Scale;
      }
      // e^{i(phase + angle(p))}: (cos, sin)(phase) x coarse[p / Q], then x fine[p % Q]
      const float c_re = __fsub_rn(__fmul_rn(ph_re, co_re), __fmul_rn(ph_im, co_im));
      const float c_im = __fadd_rn(__fmul_rn(ph_re, co_im), __fmul_rn(ph_im, co_re));
      const float rot_re = __fsub_rn(__fmul_rn(c_re, f_re), __fmul_rn(c_im, f_im));
      const float rot_im = __fadd_rn(__fmul_rn(c_re, f_im), __fmul_rn(c_im, f_re));
      float* yr = y + tab * 2 * g.out_len;
      yr[p] = __fsub_rn(__fmul_rn(re, rot_re), __fmul_rn(im, rot_im));
      yr[g.out_len + p] = __fadd_rn(__fmul_rn(re, rot_im), __fmul_rn(im, rot_re));
    }
  }
}

// The folded form's product over a tile's rows: y = A @ B_fold, A[p][(q, c)]
// = the staged window's row p + q, column c (a Hankel read of the tile), B_fold
// k-step q ks + kk and n-tile jj at bw[((q ks + kk) NT + jj) 32]. Split TF32
// as tile_product has it (two passes on integers, three when `three`, x_lo
// B_hi first); the accumulators take one lag's k-steps, as the lag form's Z
// does, and the lags are added to sum in f32 in ascending q (tensor-core
// sums truncate: 8 k-steps a register doubled the error against float64).
template <int NT, int MT>
__device__ __forceinline__ void fold_product(float (&sum)[MT][NT][4], const float4* bw, const float* wa, int ws,
                                             int ks, int r_rows, bool three) {
#pragma unroll 1
  for (int q = 0; q < r_rows; ++q) {
    float acc[MT][NT][4];
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int jj = 0; jj < NT; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][jj][e] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < ks; ++kk) {
      float4 b[NT];
#pragma unroll
      for (int jj = 0; jj < NT; ++jj) b[jj] = bw[((q * ks + kk) * NT + jj) * 32];
      const float* ap = wa + q * ws + kk * 8;
      float a[MT][4];
      uint32_t hi[MT][4];
#pragma unroll
      for (int j = 0; j < MT; ++j) {
        a[j][0] = ap[j * 16 * ws];
        a[j][1] = ap[(j * 16 + 8) * ws];
        a[j][2] = ap[j * 16 * ws + 4];
        a[j][3] = ap[(j * 16 + 8) * ws + 4];
      }
      if (three) {
#pragma unroll
        for (int j = 0; j < MT; ++j) {
          uint32_t lo[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            hi[j][e] = to_tf32(a[j][e]);
            lo[e] = to_tf32(a[j][e] - __uint_as_float(hi[j][e]));
          }
#pragma unroll
          for (int jj = 0; jj < NT; ++jj)
            mma_tf32(acc[j][jj], lo, __float_as_uint(b[jj].x), __float_as_uint(b[jj].y));
        }
      } else {  // integers: exact in TF32
#pragma unroll
        for (int j = 0; j < MT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) hi[j][e] = __float_as_uint(a[j][e]);
      }
#pragma unroll
      for (int j = 0; j < MT; ++j)
#pragma unroll
        for (int jj = 0; jj < NT; ++jj)
          mma_tf32(acc[j][jj], hi[j], __float_as_uint(b[jj].z), __float_as_uint(b[jj].w));
#pragma unroll
      for (int j = 0; j < MT; ++j)
#pragma unroll
        for (int jj = 0; jj < NT; ++jj)
          mma_tf32(acc[j][jj], hi[j], __float_as_uint(b[jj].x), __float_as_uint(b[jj].y));
    }
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int jj = 0; jj < NT; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) sum[j][jj][e] = __fadd_rn(sum[j][jj][e], acc[j][jj][e]);
  }
}

// A folded tile's window where it reaches the tail or past x: stage_tile's
// values, an element at a time over the whole block (a fold window is TR +
// R - 1 = 545 rows, where stage_tile's edge path takes a warp a row).
template <typename T>
__device__ void stage_edge(float* win, const T* src, int shift, const float* tail_row, long long s0, int wr, int m,
                           int ws, int t0, long long n, float tail_scale) {
  const int w2 = 2 * m;
#pragma unroll 4
  for (int e = threadIdx.x; e < wr * w2; e += kThreads) {
    const int r = e / w2, c = e - r * w2;
    const long long s = s0 + (long long)r * m + (c >> 1);
    float v = 0.f;
    if (s < t0) {
      v = tail_row[(c & 1) * t0 + s] * tail_scale;
    } else if (s - t0 < n) {
      v = (float)src[shift + e];
    }
    win[r * ws + c] = v;
  }
}

// A tile of the folded form: outputs [p0, p0 + rows) of one band, rows <= TR
__device__ __forceinline__ void fold_tile(long long at, long long end, int out_len, int tr, int& band, int& p0,
                                          int& rows) {
  band = (int)(at / out_len);
  p0 = (int)(at - (long long)band * out_len);
  rows = (int)min((long long)min(tr, out_len - p0), end - at);
}

template <typename T, int NT, int MT>
__global__ void __launch_bounds__(kThreads, 1)
modtap_fold_kernel(const T* __restrict__ x, const float* __restrict__ tail, const float* __restrict__ frag,
                   const float* __restrict__ phase, const float* __restrict__ coarse_re,
                   const float* __restrict__ coarse_im, const float* __restrict__ fine_re,
                   const float* __restrict__ fine_im, float* __restrict__ y, float* __restrict__ new_tail,
                   Geometry g) {
  constexpr bool kInt8 = sizeof(T) == 1;
  constexpr int TR = fold_tile_rows(MT);
  extern __shared__ __align__(16) unsigned char smem[];
  const int ks = k_steps(g.m), ws = win_stride(g.m), r_rows = g.r_rows;
  const int wr = TR + r_rows - 1;  // window rows a tile reads
  const int steps = r_rows * ks;   // k-steps of the folded depth
  const int sb = ring_bytes(g.m, wr, (int)sizeof(T));
  float* const bfrag = reinterpret_cast<float*>(smem);                       // [steps][NT][32][4]
  unsigned char* const ring = smem + (size_t)steps * NT * 512;               // int8: [2][sb] bytes
  float* const win = reinterpret_cast<float*>(ring + (kInt8 ? 2 * sb : 0));  // int8 [wr][ws], f32 [2][wr][ws]
  const long long n = g.n, n2 = 2 * n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int wrow = warp * MT * 16;  // this warp's first row of a tile

  // a band's B_fold into shared memory (cp.async, committed by the caller)
  // and the phases of this lane's slots (n-tile jj: slot 4 jj + tig)
  float ph_re[NT], ph_im[NT];
  int cur_band = -1;
  auto load_band = [&](int band) {
    cur_band = band;
    const float* src = frag + (size_t)band * steps * NT * 128;
    for (int i = threadIdx.x; i < steps * NT * 32; i += kThreads) cp_async16(bfrag + 4 * i, src + 4 * i);
#pragma unroll
    for (int jj = 0; jj < NT; ++jj) {
      const int slot = jj * 4 + tig;
      const float ph = slot < g.k ? phase[band * g.k + slot] : 0.f;
      ph_re[jj] = cosf(ph);
      ph_im[jj] = sinf(ph);
    }
  };

  // this block's run: outputs [at, end) of the bands' outputs laid end to
  // end, in tiles of up to TR within a band; a tile carries nothing to the
  // next. The first band's B_fold and the first window come in together.
  const long long total = (long long)g.nb * g.out_len;
  long long at = total * blockIdx.x / gridDim.x;
  const long long end = total * (blockIdx.x + 1) / gridDim.x;
  // int8: the ring stage's shift; f32: whether the tile's copies are in flight
  int shift0 = 0, shift1 = 0;
  if (at < end) {
    int band, p0, rows;
    fold_tile(at, end, g.out_len, TR, band, p0, rows);
    load_band(band);
    const T* xrow = x + (long long)band * g.band_stride;
    const long long s0 = (long long)p0 * g.m;
    if (kInt8) {
      shift0 = load_ring(reinterpret_cast<T*>(ring), xrow, 2 * (s0 - g.t0), wr * 2 * g.m, n2);
    } else {
      shift0 = copy_tile(win, reinterpret_cast<const float*>(xrow), s0, wr, g.m, ws, g.t0, n);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);

  // the new tail, full[n : n + t0], spread over the grid, while the copies fly
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < (long long)g.nb * 2 * g.t0;
       i += (long long)gridDim.x * kThreads) {
    const long long row = i / g.t0;  // band * 2 + component
    const long long s = n + (i - row * g.t0);
    new_tail[i] = s < g.t0 ? tail[row * g.t0 + s]
                           : scaled(x[(row >> 1) * g.band_stride + 2 * (s - g.t0) + (row & 1)]);
  }

  // the tiles' columns past 2M, zero for good
  for (int i = threadIdx.x; i < (kInt8 ? 1 : 2) * wr * (ws - 2 * g.m); i += kThreads) {
    const int r = i / (ws - 2 * g.m);
    win[r * ws + 2 * g.m + (i - r * (ws - 2 * g.m))] = 0.f;
  }

  for (int it = 0; at < end; ++it) {
    const int s = it & 1;
    int band, p0, rows;
    fold_tile(at, end, g.out_len, TR, band, p0, rows);
    asm volatile("cp.async.wait_all;\n" ::);
    __syncthreads();  // this tile's window has landed; the last tile's products are done
    if (band != cur_band) {  // a new band (the last one's products are done)
      load_band(band);
      asm volatile("cp.async.commit_group;\n" ::);
    }
    const long long s0 = (long long)p0 * g.m;
    const T* const xrow = x + (long long)band * g.band_stride;
    float* const wt = kInt8 ? win : win + s * wr * ws;  // this tile's f32 window
    const float* const tail_row = tail + (size_t)band * 2 * g.t0;
    if (kInt8 && interior(s0, wr, g.m, g.t0, n)) {
      stage_tile(win, reinterpret_cast<const T*>(ring + s * sb), s ? shift1 : shift0, tail_row, s0, wr, g.m, ws, g.t0,
                 n, 127.5f);
    } else if (kInt8) {
      stage_edge(win, reinterpret_cast<const T*>(ring + s * sb), s ? shift1 : shift0, tail_row, s0, wr, g.m, ws, g.t0,
                 n, 127.5f);
    } else if (!(s ? shift1 : shift0)) {  // not copied: staged from the stream itself
      stage_edge(wt, xrow + 2 * (s0 - g.t0), 0, tail_row, s0, wr, g.m, ws, g.t0, n, 1.f);
    }
    if (at + rows < end) {
      int nband, np0, nrows;
      fold_tile(at + rows, end, g.out_len, TR, nband, np0, nrows);
      const T* nxrow = x + (long long)nband * g.band_stride;
      const long long ns0 = (long long)np0 * g.m;
      const int sh = kInt8 ? load_ring(reinterpret_cast<T*>(ring + (s ^ 1) * sb), nxrow, 2 * (ns0 - g.t0),
                                       wr * 2 * g.m, n2)
                           : copy_tile(win + (s ^ 1) * wr * ws, reinterpret_cast<const float*>(nxrow), ns0, wr,
                                       g.m, ws, g.t0, n);
      if (s) shift0 = sh; else shift1 = sh;
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::);  // B_fold in; the next window may fly
    __syncthreads();  // the tile is staged

    float sum[MT][NT][4];
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int jj = 0; jj < NT; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) sum[j][jj][e] = 0.f;
    if (wrow < rows) {
      const bool three = !kInt8 || s0 < g.t0;  // f32 values in the window: split x too
      fold_product<NT, MT>(sum, reinterpret_cast<const float4*>(bfrag) + lane, wt + (wrow + gid) * ws + tig, ws,
                           ks, r_rows, three);
    }

    // the epilogue from the accumulators: lane (gid, tig) holds rows gid and
    // gid + 8 of each m-tile, slot 4 jj + tig of each n-tile, (re, im) in a
    // pair. Two m-tiles at a time, every lane first loads all their table
    // entries (at a row and slot in range), so that the loads are in flight
    // together, then rotates and stores what is in range.
    static_assert(MT % 2 == 0, "the epilogue takes m-tiles in pairs");
#pragma unroll
    for (int j0 = 0; j0 < MT; j0 += 2) {
      float co_re[2][2][NT], co_im[2][2][NT], f_re[2][2][NT], f_im[2][2][NT];  // [m-tile][h][n-tile]
#pragma unroll
      for (int jb = 0; jb < 2; ++jb) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = p0 + min(wrow + (j0 + jb) * 16 + gid + 8 * h, rows - 1);
          const int ci = p >> g.log2q, fi = p & ((1 << g.log2q) - 1);
#pragma unroll
          for (int jj = 0; jj < NT; ++jj) {
            const size_t tab = (size_t)band * g.k + min(jj * 4 + tig, g.k - 1);
            co_re[jb][h][jj] = coarse_re[tab * g.coarse_len + ci];
            co_im[jb][h][jj] = coarse_im[tab * g.coarse_len + ci];
            f_re[jb][h][jj] = fine_re[(tab << g.log2q) + fi];
            f_im[jb][h][jj] = fine_im[(tab << g.log2q) + fi];
          }
        }
      }
#pragma unroll
      for (int jb = 0; jb < 2; ++jb) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wrow + (j0 + jb) * 16 + gid + 8 * h;
#pragma unroll
          for (int jj = 0; jj < NT; ++jj) {
            const int slot = jj * 4 + tig;
            if (r >= rows || slot >= g.k) continue;
            float re = sum[j0 + jb][jj][2 * h], im = sum[j0 + jb][jj][2 * h + 1];
            if (kInt8) {
              re *= kCs8Scale;
              im *= kCs8Scale;
            }
            // e^{i(phase + angle(p))}: (cos, sin)(phase) x coarse[p / Q], then x fine[p % Q]
            const float cr = co_re[jb][h][jj], cm = co_im[jb][h][jj], fr = f_re[jb][h][jj], fm = f_im[jb][h][jj];
            const float c_re = __fsub_rn(__fmul_rn(ph_re[jj], cr), __fmul_rn(ph_im[jj], cm));
            const float c_im = __fadd_rn(__fmul_rn(ph_re[jj], cm), __fmul_rn(ph_im[jj], cr));
            const float rot_re = __fsub_rn(__fmul_rn(c_re, fr), __fmul_rn(c_im, fm));
            const float rot_im = __fadd_rn(__fmul_rn(c_re, fm), __fmul_rn(c_im, fr));
            float* yr = y + ((size_t)band * g.k + slot) * 2 * g.out_len;
            yr[p0 + r] = __fsub_rn(__fmul_rn(re, rot_re), __fmul_rn(im, rot_im));
            yr[g.out_len + p0 + r] = __fadd_rn(__fmul_rn(re, rot_im), __fmul_rn(im, rot_re));
          }
        }
      }
    }
    at += rows;
  }
}

// The forms, in the order the launcher tries them: (element, m-tiles a
// warp, B fragments in shared memory)
using Launch = void (*)(int, size_t, cudaStream_t, const void*, const float*, const float*, const float*,
                        const float*, const float*, const float*, const float*, float*, float*, const Geometry&);

template <typename T, int MT, bool B>
void launch_form(int grid, size_t smem, cudaStream_t stream, const void* x, const float* tail, const float* frag,
                 const float* phase, const float* coarse_re, const float* coarse_im, const float* fine_re,
                 const float* fine_im, float* y, float* new_tail, const Geometry& g) {
  modtap_stage1_kernel<T, MT, B><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), tail, frag, phase, coarse_re, coarse_im, fine_re, fine_im, y, new_tail, g);
}

struct Form {
  const void* kernel;
  Launch launch;
  int esize, mt;
  bool b_smem;
};

template <typename T, int MT, bool B>
Form form() {
  return Form{reinterpret_cast<const void*>(modtap_stage1_kernel<T, MT, B>), launch_form<T, MT, B>,
              (int)sizeof(T), MT, B};
}

constexpr int kForms = 6;
const Form* forms() {
  static const Form table[kForms] = {form<int8_t, 4, true>(), form<int8_t, 4, false>(), form<int8_t, 2, false>(),
                                     form<float, 4, true>(),  form<float, 4, false>(),  form<float, 2, false>()};
  return table;
}

// The folded forms, in the order the launcher tries them for an (element,
// n-tiles): m-tiles a warp 4 (512-row tiles), then 2 where the window does not fit
struct FoldForm {
  const void* kernel;
  Launch launch;
  int esize, nt, mt;
};

template <typename T, int NT, int MT>
void launch_fold(int grid, size_t smem, cudaStream_t stream, const void* x, const float* tail, const float* frag,
                 const float* phase, const float* coarse_re, const float* coarse_im, const float* fine_re,
                 const float* fine_im, float* y, float* new_tail, const Geometry& g) {
  modtap_fold_kernel<T, NT, MT><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), tail, frag, phase, coarse_re, coarse_im, fine_re, fine_im, y, new_tail, g);
}

template <typename T, int NT, int MT>
FoldForm folded() {
  return FoldForm{reinterpret_cast<const void*>(modtap_fold_kernel<T, NT, MT>), launch_fold<T, NT, MT>,
                  (int)sizeof(T), NT, MT};
}

constexpr int kFoldForms = 16;
const FoldForm* fold_forms() {
  static const FoldForm table[kFoldForms] = {
      folded<int8_t, 1, 4>(), folded<int8_t, 1, 2>(), folded<int8_t, 2, 4>(), folded<int8_t, 2, 2>(),
      folded<int8_t, 3, 4>(), folded<int8_t, 3, 2>(), folded<int8_t, 4, 4>(), folded<int8_t, 4, 2>(),
      folded<float, 1, 4>(),  folded<float, 1, 2>(),  folded<float, 2, 4>(),  folded<float, 2, 2>(),
      folded<float, 3, 4>(),  folded<float, 3, 2>(),  folded<float, 4, 4>(),  folded<float, 4, 2>()};
  return table;
}

// Launch state, shared by every host thread that launches on a card: the
// SM count and the attributes once per device, blocks per SM once per
// (device, form, shared-memory size); all under one mutex.
std::mutex g_mutex;
bool g_ready[kMaxDevices];
int g_sms[kMaxDevices];
std::map<std::tuple<int, int, int>, int> g_blocks_per_sm;

int setup(int dev, int& sms) {
  std::lock_guard<std::mutex> lock(g_mutex);
  if (!g_ready[dev]) {
    cudaError_t err = cudaDeviceGetAttribute(&g_sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    for (int i = 0; i < kForms + kFoldForms; ++i) {
      const void* kernel = i < kForms ? forms()[i].kernel : fold_forms()[i - kForms].kernel;
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
      if (err != cudaSuccess) return (int)err;
    }
    g_ready[dev] = true;
  }
  sms = g_sms[dev];
  return 0;
}

// form f: a lag form below kForms, folded form f - kForms above
int blocks_per_sm(int dev, int f, size_t smem, int& nb) {
  std::lock_guard<std::mutex> lock(g_mutex);
  const auto key = std::make_tuple(dev, f, (int)smem);
  const auto found = g_blocks_per_sm.find(key);
  if (found != g_blocks_per_sm.end()) {
    nb = found->second;
    return 0;
  }
  const void* kernel = f < kForms ? forms()[f].kernel : fold_forms()[f - kForms].kernel;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (nb < 1) return (int)cudaErrorInvalidConfiguration;
  g_blocks_per_sm[key] = nb;
  return 0;
}

}  // namespace

// x: the chunk's stream, [nb][n][2] int8 cs8 (x_int8 = 1) or f32 pairs,
// each band's pairs contiguous, bands band_stride elements apart; tail:
// [nb, 2, t0] f32 (planar, the plain version's units); frag: B fragments
// [nb][ceil(k / 2)][ceil(2m / 8)][20][32][4] f32 (ops/cuda/ddc_kernel.py
// packs them); phase: [nb, k] f32; coarse_re/im: [nb, k, coarse_len],
// fine_re/im: [nb, k, q_len] f32 (q_len a power of two, coarse_len *
// q_len = out_len); y: [nb * k, 2, out_len] f32, out_len = n / m;
// new_tail: [nb, 2, t0] f32. Returns cudaGetLastError() after the launch
// (or the error that kept it from launching).
extern "C" int modtap_stage1(const void* x, int x_int8, long long band_stride, int n, const void* tail,
                             const void* frag, const void* phase, const void* coarse_re, const void* coarse_im,
                             const void* fine_re, const void* fine_im, void* y, void* new_tail, int nb, int k,
                             int t0, int m, int r_rows, int out_len, int q_len, int coarse_len, void* stream) {
  if (nb <= 0 || k <= 0 || m <= 0 || t0 <= 0 || r_rows <= 0 || r_rows > kMaxR || out_len <= 0 ||
      (long long)out_len * m != n || band_stride < 0 || q_len <= 0 || (q_len & (q_len - 1)) != 0 ||
      (long long)coarse_len * q_len != out_len) {
    return (int)cudaErrorInvalidValue;
  }
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  int sms = 0;
  const int rc = setup(dev, sms);
  if (rc != 0) return rc;

  Geometry g;
  g.band_stride = band_stride;
  g.n = n;
  g.nb = nb;
  g.k = k;
  g.groups = (k + kGroupSlots - 1) / kGroupSlots;
  g.t0 = t0;
  g.m = m;
  g.r_rows = r_rows;
  g.nt_live = (2 * kGroupSlots * r_rows + 7) / 8;
  g.out_len = out_len;
  g.log2q = 0;
  while ((1 << g.log2q) < q_len) ++g.log2q;
  g.coarse_len = coarse_len;

  const int esize = x_int8 ? 1 : 4;
  int f = -1;
  for (int i = 0; i < kForms && f < 0; ++i) {
    const Form& c = forms()[i];
    if (c.esize == esize && smem_bytes(m, g.nt_live, c.mt, esize, c.b_smem) <= (size_t)kMaxSmem) f = i;
  }
  if (f < 0) return (int)cudaErrorInvalidValue;  // the window does not fit: M too large
  const Form& c = forms()[f];
  const size_t smem = smem_bytes(m, g.nt_live, c.mt, esize, c.b_smem);
  // a tile is TR rows of Z; a row (band, group) has out_len + R - 1 of them
  const int tr = tile_rows(c.mt);
  g.tiles_per_row = (out_len + r_rows - 1 + tr - 1) / tr;
  const long long total = (long long)g.tiles_per_row * nb * g.groups;
  if (total > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  g.total_tiles = (int)total;
  int per_sm = 0;
  const int e = blocks_per_sm(dev, f, smem, per_sm);
  if (e != 0) return e;
  int grid = sms * per_sm;
  if (grid > g.total_tiles) grid = g.total_tiles;  // every block gets a run of >= 1 tile
  c.launch(grid, smem, (cudaStream_t)stream, x, (const float*)tail, (const float*)frag, (const float*)phase,
           (const float*)coarse_re, (const float*)coarse_im, (const float*)fine_re, (const float*)fine_im, (float*)y,
           (float*)new_tail, g);
  return (int)cudaGetLastError();
}

// The folded form (the same arguments as modtap_stage1; frag: B_fold
// [nb][R ceil(2m / 8)][ceil(2k / 8)][32][4] f32, ops/cuda/ddc_kernel.py
// packs it). The caller chooses the form (ddc_kernel.folds); this launcher
// takes any 2k <= 32 whose table and window fit a thread block.
extern "C" int modtap_fold(const void* x, int x_int8, long long band_stride, int n, const void* tail,
                           const void* frag, const void* phase, const void* coarse_re, const void* coarse_im,
                           const void* fine_re, const void* fine_im, void* y, void* new_tail, int nb, int k, int t0,
                           int m, int r_rows, int out_len, int q_len, int coarse_len, void* stream) {
  const int nt = (2 * k + 7) / 8;
  if (nb <= 0 || k <= 0 || nt > kFoldMaxNT || m <= 0 || t0 <= 0 || r_rows <= 0 || out_len <= 0 ||
      (long long)out_len * m != n || band_stride < 0 || q_len <= 0 || (q_len & (q_len - 1)) != 0 ||
      (long long)coarse_len * q_len != out_len) {
    return (int)cudaErrorInvalidValue;
  }
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  int sms = 0;
  const int rc = setup(dev, sms);
  if (rc != 0) return rc;

  Geometry g = {};
  g.band_stride = band_stride;
  g.n = n;
  g.nb = nb;
  g.k = k;
  g.t0 = t0;
  g.m = m;
  g.r_rows = r_rows;
  g.nt_live = nt;
  g.out_len = out_len;
  while ((1 << g.log2q) < q_len) ++g.log2q;
  g.coarse_len = coarse_len;

  const int esize = x_int8 ? 1 : 4;
  int f = -1;
  for (int i = 0; i < kFoldForms && f < 0; ++i) {
    const FoldForm& c = fold_forms()[i];
    if (c.esize == esize && c.nt == nt && fold_smem_bytes(m, r_rows, nt, c.mt, esize) <= (size_t)kMaxSmem) f = i;
  }
  if (f < 0) return (int)cudaErrorInvalidValue;  // B_fold and the window do not fit
  const FoldForm& c = fold_forms()[f];
  const size_t smem = fold_smem_bytes(m, r_rows, nt, c.mt, esize);
  int per_sm = 0;
  const int e = blocks_per_sm(dev, kForms + f, smem, per_sm);
  if (e != 0) return e;
  // runs of consecutive outputs, as even as the grid makes them, no more
  // blocks than tiles
  const long long tiles = ((long long)nb * out_len + fold_tile_rows(c.mt) - 1) / fold_tile_rows(c.mt);
  const int grid = (int)std::min<long long>((long long)sms * per_sm, tiles);
  c.launch(grid, smem, (cudaStream_t)stream, x, (const float*)tail, (const float*)frag, (const float*)phase,
           (const float*)coarse_re, (const float*)coarse_im, (const float*)fine_re, (const float*)fine_im, (float*)y,
           (float*)new_tail, g);
  return (int)cudaGetLastError();
}
