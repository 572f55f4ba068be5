// Fused candidate selection on Hopper: per row of the masked smoothed
// spectrum, the exact top-K bins (value descending, first-occurrence ties),
// K_SEP greedy margin-separated winners (+-submargin zone suppression) and
// the count of bins >= level (level cast to the row dtype).
//
// Replaces the TPU kernel fused_selection / _selection_kernel
// (rtl_sdr_scanner_tpu/ops/pallas/select_kernel.py). That kernel copied the
// whole row into VMEM; a 131072-bin row is 512 KB in f32 and 256 KB in bf16,
// over the 227 KB of shared memory a block can use. So the row stays in
// global memory / L2 and only the selection state lives in shared memory:
//   - a 1024-bin segment table (max, first argmax), n_seg = fft/1024 entries,
//     plus its pristine copy for the second phase;
//   - the suppression state as a bitmask of fft bits (16 KB at 131072).
// One block per (band, frame) row. The row is read once to build the table
// and the count; each of the top_k + k_sep winners is then the argmax over
// the table (one warp), after which only the <= 2 segments its suppression
// touched are re-reduced (1024 bins each, mostly L2 hits).
//
// Bound: the function must read each row once (262,144 B in bf16 at fft
// 131072) and write 80 values + 80 indices + 1 count: 1080 rows per block
// move 0.28 GB, 0.085 ms at 3.35 TB/s. The sequential winner loop (80 steps
// of ~3 block barriers each) is latency, not bandwidth; enough rows run at
// once (up to 8 blocks per SM) to hide part of it.
//
// Tie and sentinel rules are the TPU kernel's, bit for bit: the earliest
// segment, then the earliest lane, wins; a suppressed bin compares as the
// sentinel -3.3e38 cast to the row dtype (passed in as `neg`), including the
// all-suppressed corner and rows holding the -3.0e38 mask value.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSegW = 1024;

__device__ __forceinline__ float load(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
// v always came from a value of the row dtype, so the store is exact
__device__ __forceinline__ void store(float* p, long long i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, long long i, float v) {
  p[i] = __float2bfloat16_rn(v);
}
__device__ __forceinline__ float to_row_dtype(float v, const float*) { return v; }
__device__ __forceinline__ float to_row_dtype(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// larger value first, then the smaller index (first occurrence)
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

__device__ __forceinline__ bool suppressed(const uint32_t* mask, int b) {
  return (mask[b >> 5] >> (b & 31)) & 1u;
}

// Whole block: (max, first argmax lane) of segment s with suppression,
// written to the table. Ends with a barrier.
template <typename T>
__device__ void reduce_segment(const T* row, const uint32_t* mask, int s, float neg,
                               float* seg_max, int* seg_arg, float* red_v, int* red_i) {
  float bv = -INFINITY;
  int bi = INT_MAX;
  for (int l = threadIdx.x; l < kSegW; l += kThreads) {
    const int b = s * kSegW + l;
    const float v = suppressed(mask, b) ? neg : load(row, b);
    if (better(v, l, bv, bi)) {
      bv = v;
      bi = l;
    }
  }
  warp_argmax(bv, bi);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    red_v[warp] = bv;
    red_i[warp] = bi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float v = red_v[0];
    int i = red_i[0];
    for (int w = 1; w < kWarps; ++w) {
      if (better(red_v[w], red_i[w], v, i)) {
        v = red_v[w];
        i = red_i[w];
      }
    }
    seg_max[s] = v;
    seg_arg[s] = i;
  }
  __syncthreads();
}

// Warp 0 only: global first-occurrence argmax over the table; lane 0 gets it.
__device__ void table_argmax(const float* seg_max, const int* seg_arg, int n_seg,
                             float* v_out, int* idx_out) {
  const int lane = threadIdx.x & 31;
  float bv = -INFINITY;
  int bs = INT_MAX;
  for (int s = lane; s < n_seg; s += 32) {
    if (better(seg_max[s], s, bv, bs)) {
      bv = seg_max[s];
      bs = s;
    }
  }
  warp_argmax(bv, bs);
  if (lane == 0) {
    *v_out = bv;
    *idx_out = bs * kSegW + seg_arg[bs];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
selection_kernel(const T* __restrict__ rows, const float* __restrict__ level,
                 T* __restrict__ top_val, int* __restrict__ top_idx,
                 T* __restrict__ sep_val, int* __restrict__ sep_idx,
                 int* __restrict__ count, int fft, int top_k, int k_sep, int submargin,
                 float neg) {
  extern __shared__ uint32_t smem[];
  const int n_seg = fft / kSegW;
  const int n_words = fft / 32;
  uint32_t* mask = smem;                          // [n_words]
  float* seg_max = (float*)(mask + n_words);      // [n_seg]
  int* seg_arg = (int*)(seg_max + n_seg);         // [n_seg]
  float* init_max = (float*)(seg_arg + n_seg);    // [n_seg] pristine table
  int* init_arg = (int*)(init_max + n_seg);       // [n_seg]
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ int red_c[kWarps];
  __shared__ int win_idx;

  const long long r = blockIdx.x;
  const T* row = rows + r * fft;
  const float lev = to_row_dtype(*level, rows);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int w = threadIdx.x; w < n_words; w += kThreads) mask[w] = 0u;

  // the pristine table and the count: one warp per segment, one row read
  int cnt = 0;
  for (int s = warp; s < n_seg; s += kWarps) {
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int l = lane; l < kSegW; l += 32) {
      const float v = load(row, s * kSegW + l);
      cnt += v >= lev;
      if (better(v, l, bv, bi)) {
        bv = v;
        bi = l;
      }
    }
    warp_argmax(bv, bi);
    if (lane == 0) {
      init_max[s] = seg_max[s] = bv;
      init_arg[s] = seg_arg[s] = bi;
    }
  }
  for (int off = 16; off > 0; off >>= 1) cnt += __shfl_down_sync(0xffffffffu, cnt, off);
  if (lane == 0) red_c[warp] = cnt;
  __syncthreads();
  if (threadIdx.x == 0) {
    int c = 0;
    for (int w = 0; w < kWarps; ++w) c += red_c[w];
    count[r] = c;
  }

  // phase 1: exact top-K, single-bin suppression
  for (int i = 0; i < top_k; ++i) {
    if (warp == 0) {
      float v;
      int idx;
      table_argmax(seg_max, seg_arg, n_seg, &v, &idx);
      if (lane == 0) {
        store(top_val, r * top_k + i, v);
        top_idx[r * top_k + i] = idx;
        mask[idx >> 5] |= 1u << (idx & 31);
        win_idx = idx;
      }
    }
    __syncthreads();
    reduce_segment(row, mask, win_idx / kSegW, neg, seg_max, seg_arg, red_v, red_i);
  }

  // phase 2: margin-separated greedy, +-submargin zone suppression
  for (int w = threadIdx.x; w < n_words; w += kThreads) mask[w] = 0u;
  for (int s = threadIdx.x; s < n_seg; s += kThreads) {
    seg_max[s] = init_max[s];
    seg_arg[s] = init_arg[s];
  }
  __syncthreads();
  for (int i = 0; i < k_sep; ++i) {
    if (warp == 0) {
      float v;
      int idx;
      table_argmax(seg_max, seg_arg, n_seg, &v, &idx);
      if (lane == 0) {
        store(sep_val, r * k_sep + i, v);
        sep_idx[r * k_sep + i] = idx;
        win_idx = idx;
      }
    }
    __syncthreads();
    const int idx = win_idx;
    const int lo = max(idx - submargin, 0);
    const int hi = min(idx + submargin, fft - 1);
    for (int b = lo + threadIdx.x; b <= hi; b += kThreads) {
      atomicOr(&mask[b >> 5], 1u << (b & 31));
    }
    __syncthreads();
    // the zone spans <= 2 segments (2*submargin + 1 <= 1024)
    const int t0 = lo / kSegW, t1 = hi / kSegW;
    reduce_segment(row, mask, t0, neg, seg_max, seg_arg, red_v, red_i);
    if (t1 != t0) reduce_segment(row, mask, t1, neg, seg_max, seg_arg, red_v, red_i);
  }
}

template <typename T>
int launch(const void* rows, const void* level, void* top_val, void* top_idx, void* sep_val,
           void* sep_idx, void* count, int n_rows, int fft, int top_k, int k_sep,
           int submargin, float neg, cudaStream_t s) {
  const int n_seg = fft / kSegW;
  const int smem = (fft / 32 + 4 * n_seg) * 4;
  cudaError_t err = cudaFuncSetAttribute(selection_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  selection_kernel<T><<<n_rows, kThreads, smem, s>>>(
      (const T*)rows, (const float*)level, (T*)top_val, (int*)top_idx, (T*)sep_val,
      (int*)sep_idx, (int*)count, fft, top_k, k_sep, submargin, neg);
  return (int)cudaGetLastError();
}

}  // namespace

// rows: [n_rows, fft] f32 (is_bf16 = 0) or bf16 (1), fft % 1024 == 0;
// level: one f32 on the device; outputs top_val/sep_val in the row dtype,
// top_idx/sep_idx/count int32. neg: -3.3e38 cast to the row dtype.
extern "C" int fused_selection(const void* rows, int is_bf16, const void* level, void* top_val,
                               void* top_idx, void* sep_val, void* sep_idx, void* count,
                               int n_rows, int fft, int top_k, int k_sep, int submargin,
                               float neg, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    return launch<__nv_bfloat16>(rows, level, top_val, top_idx, sep_val, sep_idx, count, n_rows,
                                 fft, top_k, k_sep, submargin, neg, s);
  }
  return launch<float>(rows, level, top_val, top_idx, sep_val, sep_idx, count, n_rows, fft,
                       top_k, k_sep, submargin, neg, s);
}
