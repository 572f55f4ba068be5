// The history vote of compact detection on Hopper: for each candidate c of
// frame k (band b), the first-occurrence argmax of each history row k+h
// (h < H, the rows of prev_tail ++ raw) over the window [c-half, c+half]
// clamped to the row, a vote where the window max (promoted to f32) is >=
// level (f32); then the reference's mostFrequentValue over the valid votes
// with the median-of-ties rule (collection_utils.h:29-50), or c itself
// where no vote is valid.
//
// Replaces no TPU kernel: the JAX package leaves the vote to XLA
// (rtl_sdr_scanner_tpu/ops/detect.py, a sliding-window table over every bin
// of every history row, read at the candidates). The port's plain version
// (ops/detect.history_vote_plain) is that table; on the card its
// elementwise passes over the 1,320 history rows of a 24-band block of fft
// 131072 (205-bin windows) took half of the block's card time, for a
// result read at 0.5% of its positions.
//
// Bound: bytes. The vote needs each history row once: 24 bands x 55 rows x
// 131072 bins x 4 B = 0.69 GB at the wideband receiver's shape, 0.21 ms at
// 3.35 TB/s; its arithmetic is a compare a window cell (195 M cells there).
// The design keeps the reads near the rows once:
//   - nothing is built: the kernel reads prev_tail and raw in place (each
//     with its own band and row strides, bin stride 1), converting each
//     value on load exactly as cat(prev.to(raw dtype), raw).to(bf16) does
//     (round to nearest even where the history is voted in bf16), so the
//     0.69 GB concatenation and its bf16 copy are gone;
//   - a warp takes a candidate: its lanes stride the window with coalesced
//     loads, kUnroll in flight a lane, keep a (key, bin) best each (bins
//     visited in increasing order, a strict compare: the first occurrence),
//     and two redux.sync reduce them (the largest order-preserving key,
//     -0.0 folded onto 0.0 as the float compare has them, then the least bin
//     holding it). The warp walks its H rows; lane 0 writes each vote to
//     the warp's shared slots, and the mode runs inside the warp on them;
//   - a block takes kWarps candidates of one (band, frame), blocks in band,
//     frame order: the frames in flight share 10 of their 11 rows and a
//     band's rows (29 MB in f32) meet in the 50 MB L2, so the window cells
//     (1.1 reads of each history value at that shape, 3.4 at 615-bin
//     windows) are served from L2 and device memory sees about the rows
//     once.
// One launch a block step covers every band, at any window width and any
// history depth up to kMaxDepth (its shared slots).

#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // candidates a block, a warp each
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 4;  // loads in flight a lane
constexpr int kMaxDepth = 512;  // history rows a vote: 2 x kWarps x kMaxDepth ints of shared memory (32 KB)
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__device__ __forceinline__ float load_value(const T* p);

template <>
__device__ __forceinline__ float load_value<float>(const float* p) {
  return __ldg(p);
}

template <>
__device__ __forceinline__ float load_value<__nv_bfloat16>(const __nv_bfloat16* p) {
  // bf16 to f32 is exact: the 16 bits above 16 zero bits
  return __uint_as_float(static_cast<unsigned>(__ldg(reinterpret_cast<const unsigned short*>(p))) << 16);
}

// The value as the history holds it: rounded to nearest even bf16 where the
// vote runs in bf16 (exact for a bf16 input).
template <bool kRound>
__device__ __forceinline__ float vote_value(float x) {
  if constexpr (kRound) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else {
    return x;
  }
}

// Order-preserving key of a float (0 is below every value, -inf included).
__device__ __forceinline__ unsigned order_key(float x) {
  unsigned u = __float_as_uint(x);
  if (u == 0x80000000u) u = 0u;  // -0.0 equals 0.0 in the float compare
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// A lane's (key, first bin) best over its bins of [lo, hi] of one row.
template <typename T, bool kRound>
__device__ __forceinline__ void window_best(const T* __restrict__ row, int lo, int hi, int lane,
                                            unsigned& best, int& at) {
  for (int base = lo + lane; base <= hi; base += 32 * kUnroll) {
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int bin = base + 32 * u;
      v[u] = bin <= hi ? load_value(row + bin) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int bin = base + 32 * u;
      const unsigned key = bin <= hi ? order_key(vote_value<kRound>(v[u])) : 0u;
      if (key > best) {
        best = key;
        at = bin;
      }
    }
  }
}

template <typename TP, typename TR, bool kRound>
__global__ void __launch_bounds__(kThreads)
    history_vote_kernel(const TP* __restrict__ prev, long long prev_band, long long prev_row,
                        const TR* __restrict__ raw, long long raw_band, long long raw_row,
                        const int* __restrict__ cand, const float* __restrict__ level,
                        int* __restrict__ out, int n_tasks, int frames, int n_cand, int depth,
                        int fft, int half) {
  extern __shared__ int slots[];  // a warp's depth votes, then its depth tie counts
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int task = blockIdx.x * kWarps + warp;  // (band, frame, candidate), candidate fastest
  if (task >= n_tasks) return;  // a whole warp: no block barrier follows
  int* votes = slots + 2 * depth * warp;
  int* counts = votes + depth;
  const int band = task / (frames * n_cand);
  const int frame = task / n_cand % frames;
  const int c = __ldg(cand + task);
  const int lo = max(c - half, 0);
  const int hi = min(c + half, fft - 1);
  const float lvl = __ldg(level);
  const int n_prev = depth - 1;

  for (int h = 0; h < depth; ++h) {
    const int r = frame + h;  // row of prev_tail ++ raw
    unsigned best = 0u;
    int at = INT_MAX;
    if (r < n_prev) {
      window_best<TP, kRound>(prev + band * prev_band + r * prev_row, lo, hi, lane, best, at);
    } else {
      window_best<TR, kRound>(raw + band * raw_band + (r - n_prev) * raw_row, lo, hi, lane, best, at);
    }
    const unsigned top = __reduce_max_sync(kFull, best);
    const int first = __reduce_min_sync(kFull, best == top ? at : INT_MAX);
    if (lane == 0) votes[h] = key_value(top) >= lvl ? first : -1;  // bins are >= 0: -1 is no vote
  }
  __syncwarp();

  // mostFrequentValue: each distinct valid vote (at its first occurrence)
  // with its count; the others count 0
  int most = 0;
  for (int i = lane; i < depth; i += 32) {
    const int v = votes[i];
    int n = 0;
    bool first = v >= 0;
    for (int j = 0; j < depth; ++j) {
      const int w = votes[j];
      n += w == v;
      first = first && !(j < i && w == v);
    }
    counts[i] = first ? n : 0;
    most = max(most, first ? n : 0);
  }
  most = __reduce_max_sync(kFull, most);
  __syncwarp();
  int result = c;  // no valid vote: the candidate itself
  if (most > 0) {
    // the values tied at the top count, sorted: the one at [n_tied / 2]
    int n_tied = 0;
    for (int j = 0; j < depth; ++j) n_tied += counts[j] == most;
    int pick = INT_MAX;
    for (int i = lane; i < depth; i += 32) {
      if (counts[i] != most) continue;
      const int v = votes[i];
      int rank = 0;
      for (int j = 0; j < depth; ++j) rank += counts[j] == most && votes[j] < v;
      if (rank == n_tied / 2) pick = v;
    }
    result = __reduce_min_sync(kFull, pick);
  }
  if (lane == 0) out[task] = result;
}

template <typename TP, typename TR, bool kRound>
int launch(const void* prev, long long prev_band, long long prev_row, const void* raw,
           long long raw_band, long long raw_row, const void* cand, const void* level, void* out,
           int n_tasks, int frames, int n_cand, int depth, int fft, int half, cudaStream_t s) {
  const int blocks = (n_tasks + kWarps - 1) / kWarps;
  const size_t smem = sizeof(int) * 2 * depth * kWarps;
  history_vote_kernel<TP, TR, kRound><<<blocks, kThreads, smem, s>>>(
      (const TP*)prev, prev_band, prev_row, (const TR*)raw, raw_band, raw_row, (const int*)cand,
      (const float*)level, (int*)out, n_tasks, frames, n_cand, depth, fft, half);
  return (int)cudaGetLastError();
}

template <typename TP, typename TR>
int launch_rounded(int round_bf16, const void* prev, long long prev_band, long long prev_row,
                   const void* raw, long long raw_band, long long raw_row, const void* cand,
                   const void* level, void* out, int n_tasks, int frames, int n_cand, int depth,
                   int fft, int half, cudaStream_t s) {
  if (round_bf16) {
    return launch<TP, TR, true>(prev, prev_band, prev_row, raw, raw_band, raw_row, cand, level, out,
                                n_tasks, frames, n_cand, depth, fft, half, s);
  }
  return launch<TP, TR, false>(prev, prev_band, prev_row, raw, raw_band, raw_row, cand, level, out,
                               n_tasks, frames, n_cand, depth, fft, half, s);
}

}  // namespace

// prev [n_bands, depth - 1, fft] and raw [n_bands, frames, fft], f32 or bf16
// (is_bf16 flags), strides in elements, bin stride 1; cand and out
// [n_bands, frames, n_cand] int32, contiguous; level one f32 on the card;
// round_bf16: the history is voted in bf16. Launches on `stream`; returns
// cudaGetLastError (cudaErrorInvalidValue on arguments it does not take).
extern "C" int history_vote(const void* prev, int prev_bf16, long long prev_band, long long prev_row,
                            const void* raw, int raw_bf16, long long raw_band, long long raw_row,
                            const void* cand, const void* level, void* out, int n_bands, int frames,
                            int n_cand, int depth, int fft, int half, int round_bf16, void* stream) {
  const long long tasks = (long long)n_bands * frames * n_cand;
  if (n_bands < 1 || frames < 1 || n_cand < 1 || depth < 1 || depth > kMaxDepth || fft < 1 ||
      half < 0 || tasks > INT_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  const int n = (int)tasks;
  cudaStream_t s = (cudaStream_t)stream;
  if (prev_bf16 && raw_bf16) {
    return launch_rounded<__nv_bfloat16, __nv_bfloat16>(round_bf16, prev, prev_band, prev_row, raw, raw_band,
                                                        raw_row, cand, level, out, n, frames, n_cand, depth,
                                                        fft, half, s);
  }
  if (prev_bf16) {
    return launch_rounded<__nv_bfloat16, float>(round_bf16, prev, prev_band, prev_row, raw, raw_band, raw_row,
                                                cand, level, out, n, frames, n_cand, depth, fft, half, s);
  }
  if (raw_bf16) {
    return launch_rounded<float, __nv_bfloat16>(round_bf16, prev, prev_band, prev_row, raw, raw_band, raw_row,
                                                cand, level, out, n, frames, n_cand, depth, fft, half, s);
  }
  return launch_rounded<float, float>(round_bf16, prev, prev_band, prev_row, raw, raw_band, raw_row, cand,
                                      level, out, n, frames, n_cand, depth, fft, half, s);
}
