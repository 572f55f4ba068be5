// PSD of int8 IQ frames on Hopper: frame-select -> x/127.5 -> window with the
// fftshift folded in as (-1)^n -> N-point FFT -> 10*log10(max(|X|^2,1e-30)/rate).
//
// Replaces the TPU kernel psd_frames_int8_pallas / _psd_kernel
// (rtl_sdr_scanner_tpu/ops/pallas/psd_kernel.py), which ran the DFT as a
// four-step matmul on the MXU. A matmul DFT does ~30x the operations of a
// radix FFT; on this card the function is bound by memory instead. At the
// main-path shape (fft 131072, decim 3) one frame must read 262,144 B of int8
// and write 524,288 B of f32: 1080 frames per block (24 bands x 45) move
// 0.85 GB, 0.25 ms at 3.35 TB/s; a radix FFT's 5 N log2 N operations take
// 0.18 ms at the f32 peak, so the operations are close behind.
//
// Every form runs the four-step split N = N1*N2 (N1 >= N2, as _split_n):
// column FFTs of length N1 over n1 for each n2, the twiddle
// exp(-2 pi i k1 n2 / N), row FFTs of length N2 over n2 for each k1, and
// X[k1 + N1*k2] out. Which form runs is fixed by the fft size alone:
//
// * On-chip forms, fft <= 2^17 (psd_onchip). A frame never leaves the chip
//   between the two halves of its DFT, so device memory sees only the
//   compulsory int8 in and f32 out (and the window, which stays in L2).
//   - fft <= 2^14: one block per frame; the whole frame (<= 128 KB of
//     complex f32) sits in its shared memory. This is the RTL-SDR path
//     (fft 16384).
//   - 2^15 <= fft <= 2^17: one thread-block cluster per frame, of N/8192
//     blocks (16 at fft 131072: above the portable 8, so the launch asks for
//     it), 8192 points and 64 KB a block. Each block runs the column FFTs of
//     its N2/C columns; after cluster.sync() each block reads its N1/C rows
//     from the other blocks' shared memory (distributed shared memory) with
//     the twiddle, as the first pass of its row FFTs, syncs the cluster again
//     (nobody overwrites what another may still read) and runs the rest of
//     the row FFTs. dB rows go out with k1 contiguous.
//   Each FFT is two Stockham (self-sorting) passes of radix 32, 16 or 8 for
//   128-512 points, not radix-2 stages: a thread holds 32 points in
//   registers, does its butterflies there, and shared memory is touched only
//   between passes. The first column pass reads device memory and the last
//   row pass writes it, so a frame crosses shared memory three times. The
//   sequences of a block are interleaved (element i of sequence b at
//   i*stride + b), so passes run lanes along b, contiguous; the exchange
//   runs lanes along n2 (distributed shared memory moves whole sectors), and
//   its writes stay conflict-free through an xor swizzle of the row layout.
//   No bit-reversed scatter remains.
//   Twiddles: sincospif on exact arguments (an integer over a power of two)
//   once per butterfly, its powers by a running complex product (<= 30
//   roundings, ~1e-6 relative: ~1e-3 dB at bins 60 dB below a frame's peak);
//   no table is read from memory. f32 on the CUDA cores: a TF32 tensor-core
//   DFT would not hold 0.02 dB at deep nulls.
//   What bounds it: a block loads, transforms and stores in turn, so an SM
//   overlaps one frame's memory phases with another's FFT only where two
//   blocks fit it (8192 points, 64 KB and <= 128 registers a thread: the
//   cluster form). Past that, the exchange's distributed-shared-memory reads,
//   the shared-memory passes' bandwidth and the instruction count (the FFT's
//   operations are ~70% of the byte bound's time at fft 131072) keep it
//   above the byte bound; PERF.md has the split.
//
// * Scratch form, fft > 2^17 (2^18..2^24: wideband front ends at the 250 Hz
//   step, up to a 4.096 Gsps direct-sampling band). The cluster form stops
//   at 2^17 = 16 blocks of 8192 points (a cluster holds at most 16 blocks;
//   2^19 would not fit 16 blocks' shared memory at all), so two passes pass
//   a complex f32 scratch in device memory between them:
//     pass 1 (psd_scratch1): one block per (frame, S1 columns n2) runs
//             their N1-point FFTs, its first Stockham pass reading the int8
//             pairs and computing the window (HammingFrameIn), its last
//             writing C[k1][n2];
//     pass 2 (psd_scratch2): one block per (frame, S2 rows k1) reads
//             C[k1][:] along n2 times the four-step twiddle (ExchangeIn over
//             the scratch), runs their N2-point FFTs and writes the dB of
//             X[k1 + N1 k2] (DbOut).
//   The same register Stockham passes as the on-chip forms (1024 points: two
//   passes of radix 32; 2048: radix 8, 16, 16; 4096: 8, 32, 16): two or
//   three barriers a sequence, twiddles once per butterfly with running
//   products, no bit-reversed scatter. A block holds 8 or more sequences, so
//   that pass 1's int8 reads run 16 B and its scratch writes and pass 2's dB
//   writes 32 B or more: 8192 points (64 KB, two blocks an SM, one's loads
//   overlap the other's passes) up to 1024-point sequences, 16384 (128 KB,
//   one an SM) for 2048. The shared-memory layouts pad after every
//   first-pass radix's worth of elements (SmemPad), so that the first pass's
//   strided writes spread over the banks.
//   Its scratch round trip costs 2 x 8 B per point on top of the 6 B the
//   function must move: 22 B a point. Bound (bytes, the larger): 16 frames
//   of 2^21 (the 491.52 Msps block) must move 0.201 GB, 0.060 ms at 3.35
//   TB/s (their 5 N log2 N operations: 0.053 ms at the f32 peak); with the
//   scratch, 0.738 GB and 0.220 ms: this design's own floor. The scratch
//   stays in device memory: running the passes over groups of frames whose
//   scratch fits L2 was slower (a launch pair a frame at 2^21, each under
//   one wave; PERF.md has the split). The wrapper asks psd_scratch_bytes()
//   whether a size needs the scratch; the on-chip forms take none.
//
// * Cluster scratch form, fft 2^23..2^24 (direct-sampling front ends of
//   1.966-4.096 Gsps at the 250 Hz step): the scratch form's two passes
//   where a pass's sequences have 4096 points (N1 = 4096 at both sizes, N2
//   = 4096 at 2^24). Eight 4096-point sequences (256 KB of complex f32) do
//   not fit the 227 KB one block may use, and fewer would cut pass 1's int8
//   runs below 16 B and pass 2's dB runs below 32 B. So a thread-block
//   cluster of 2^kScratchClusterLog = 2 blocks holds the 8 (4 a block, 144
//   KB with the pad, one block an SM):
//     pass 1: each block of a cluster reads its 8 B of every 16 B run of
//             pairs while its peer, on a neighbouring SM at the same time,
//             reads the other 8 (one sector a row, read from device memory
//             once), and writes its 4 columns (32 B runs of scratch);
//     pass 2 (2^24): each block runs all but the last Stockham pass on its
//             own 4 rows; after the cluster's barrier, block rank c runs the
//             last pass's butterflies [c Q / 2, (c + 1) Q / 2) of all 8 rows
//             (Q = 4096 / 16), reading the other block's rows through
//             distributed shared memory (ClusterPad), so that the dB writes
//             run 32 B. At 2^23 pass 2's rows have 2048 points: the scratch
//             form's 8 rows of one block.
//   Every offset into the input, the scratch and the output is 64-bit (16
//   frames of 2^24 at decim 4 are 2^31 B of int8). It replaces the TPU
//   kernel psd_frames_int8_pallas / _psd_kernel as the other forms do, and
//   is bound by the bytes: 16 frames of 2^23 must move 0.805 GB, 0.2404 ms
//   at 3.35 TB/s (their operations: 0.23 ms at the f32 peak); with the one
//   scratch round trip, 22 B a point, 2.95 GB and 0.88 ms, this design's
//   own floor (2^24: twice each); three passes over N = 64 x 64 x 2048, in
//   blocks of 8 sequences of at most 2048 points, would move 38 B a point
//   (1.52 ms). Measured on the H100 (PERF.md has the split): writes of less
//   than a sector cost most (a cluster of 4 blocks, 16 B of scratch a row;
//   pass 2 without the cluster's last pass, 16 B runs of dB), and pass 1's
//   last pass across the cluster (64 B runs of scratch, half of it read
//   through distributed shared memory) cost more than it saved.
//
// * Small-frame form, fft <= 128 (a band of 32 kHz or less at 250 Hz bins).
//   The one-block form's passes hold 32 points a thread and need N2 >= 16,
//   and a 128-point frame is 4 threads' work, so a block takes 4096 / N
//   frames (32 at fft 128, 256 at fft 16): it loads their int8 pairs in
//   bit-reversed order into shared memory (32 KB), runs their radix-2 FFTs
//   side by side (neighbouring threads on neighbouring butterflies) and
//   writes the dB rows, contiguous across the block's frames. Bound (bytes,
//   the larger): 6 B a point, 1.38 MB and 0.41 us for 1800 frames of fft
//   128 at 3.35 TB/s; at these sizes the launch sets its time.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

// ---- on-chip forms
constexpr int kLogPerThread = 5;  // a thread holds 32 complex points
constexpr int kPerThread = 1 << kLogPerThread;
constexpr int kSingleMaxLog = 14;  // one block per frame up to fft 16384
constexpr int kClusterBlockLog = 13;  // above: 8192 points a block, two blocks an SM
constexpr int kOnChipMaxLog = 17;  // a cluster of 16 blocks, the most the card places

// ---- scratch form
constexpr int kScratchBlockLog = 13;  // 8192 points a block, two blocks an SM,
constexpr int kScratchNarrowLog = 10;  // for sequences up to 1024 points; 2048 take 16384 a block
constexpr int kScratchMaxLog = 22;  // 8 sequences of 2048 points a block
// ---- cluster scratch form
constexpr int kScratchWideLog = 11;  // above: 4096-point sequences, 8 over a cluster
constexpr int kScratchClusterLog = 1;  // of 2 blocks (4 sequences, 16384 points a block, one an SM)
constexpr int kMaxLog = 24;  // the largest fft instantiated (4.096 Gsps at 250 Hz bins)

// ---- small-frame form
constexpr int kThreads = 256;

constexpr int kSmallMaxLog = 7;  // fft <= 128
constexpr int kSmallPointsLog = 12;  // 4096 points a block: 4096 / N frames

// The forms as psd_form() numbers them (ops/cuda/psd_kernel.FORMS names
// them); the dispatcher and the queries below all decide by form_of().
enum Form { kSmall = 0, kBlock = 1, kCluster = 2, kScratch = 3, kClusterScratch = 4 };

Form form_of(int log_n) {
  if (log_n <= kSmallMaxLog) return kSmall;
  if (log_n <= kSingleMaxLog) return kBlock;
  if (log_n <= kOnChipMaxLog) return kCluster;
  if (log_n <= kScratchMaxLog) return kScratch;
  return kClusterScratch;
}

__device__ __forceinline__ unsigned bitrev(unsigned x, int bits) {
  return __brev(x) >> (32 - bits);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 csub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }

__host__ __device__ constexpr int bitrev_c(int x, int bits) {
  return bits == 0 ? 0 : ((x & 1) << (bits - 1)) | bitrev_c(x >> 1, bits - 1);
}

__host__ __device__ constexpr int log2_c(int x) { return x <= 1 ? 0 : 1 + log2_c(x / 2); }

// cos(pi k / 16) for k in [0, 8]
__host__ __device__ constexpr float cos_pi16(int k) {
  return k == 0 ? 1.0f
       : k == 1 ? 0.98078528040323043f
       : k == 2 ? 0.92387953251128674f
       : k == 3 ? 0.83146961230254524f
       : k == 4 ? 0.70710678118654752f
       : k == 5 ? 0.55557023301960218f
       : k == 6 ? 0.38268343236508978f
       : k == 7 ? 0.19509032201612825f
                : 0.0f;
}

// x * exp(-2 pi i M / 32), M in [0, 16).
template <int M>
__device__ __forceinline__ float2 rot32(float2 x) {
  constexpr float h = 0.70710678118654752f;
  if constexpr (M == 0) {
    return x;
  } else if constexpr (M == 8) {
    return make_float2(x.y, -x.x);
  } else if constexpr (M == 4) {
    return make_float2((x.x + x.y) * h, (x.y - x.x) * h);
  } else if constexpr (M == 12) {
    return make_float2((x.y - x.x) * h, -(x.x + x.y) * h);
  } else {
    constexpr float c = M <= 8 ? cos_pi16(M) : -cos_pi16(16 - M);
    constexpr float s = M <= 8 ? cos_pi16(8 - M) : cos_pi16(M - 8);
    return cmul(x, make_float2(c, -s));
  }
}

// Radix-2 decimation-in-frequency stages of an R-point DFT in registers,
// butterfly I of the stage whose pairs lie H apart, then the next; all
// indices are template constants, so v never leaves registers.
template <int R, int H, int I = 0>
__device__ __forceinline__ void dif_stages(float2* v) {
  if constexpr (I < R / 2) {
    constexpr int s = (I / H) * 2 * H, p = I % H;
    const float2 a = v[s + p], b = v[s + p + H];
    v[s + p] = cadd(a, b);
    v[s + p + H] = rot32<p * (16 / H)>(csub(a, b));  // W_{2H}^p
    dif_stages<R, H, I + 1>(v);
  } else if constexpr (H > 1) {
    dif_stages<R, H / 2, 0>(v);
  }
}

// t[K] = v[bitrev(K)] for K < R, the index a template constant.
template <int R, int K = 0>
__device__ __forceinline__ void bitrev_copy(const float2* v, float2* t) {
  if constexpr (K < R) {
    constexpr int src = bitrev_c(K, log2_c(R));
    t[K] = v[src];
    bitrev_copy<R, K + 1>(v, t);
  }
}

// In-register R-point DFT (R = 4, 8, 16 or 32), natural order in and out: the
// DIF stages leave X[k] at v[bitrev(k)], undone as a renaming.
template <int R>
__device__ __forceinline__ void dft_regs(float2* v) {
  dif_stages<R, R / 2>(v);
  float2 t[R];
  bitrev_copy<R>(v, t);
#pragma unroll
  for (int k = 0; k < R; ++k) v[k] = t[k];
}

// log2 of the radix of the next Stockham pass when 2^rem of the length is
// left: 16 -> 16; 32 -> 32; 64 -> 8, 8; 128 -> 16, 8; 256 -> 16, 16;
// 512 -> 32, 16; 1024 -> 32, 32; 2048 -> 8, 16, 16; 4096 -> 8, 32, 16.
__host__ __device__ constexpr int next_radix_log(int rem) {
  return (rem == 4 || rem == 7 || rem == 8) ? 4 : (rem == 5 || rem == 9 || rem == 10) ? 5 : (rem == 2 ? 2 : 3);
}

// log2 of the radix of the last of those passes.
__host__ __device__ constexpr int last_radix_log(int rem) {
  return next_radix_log(rem) == rem ? rem : last_radix_log(rem - next_radix_log(rem));
}

// Item k of thread t in a phase of NT threads over 2^LOG_B interleaved
// sequences: w = t + k*NT, sequence w mod B, position w / B. Where B divides
// NT the sequence is the thread's own and the position steps by NT/B, so
// every address below is a per-thread base plus a constant.
template <int LOG_B, int NT>
__device__ __forceinline__ int seq_of(int t, int k) {
  if constexpr (NT % (1 << LOG_B) == 0) return t & ((1 << LOG_B) - 1);
  else return (t + k * NT) & ((1 << LOG_B) - 1);
}
template <int LOG_B, int NT>
__device__ __forceinline__ int pos_of(int t, int k) {
  if constexpr (NT % (1 << LOG_B) == 0) return (t >> LOG_B) + k * (NT >> LOG_B);
  else return (t + k * NT) >> LOG_B;
}

// exp(-2 pi i m / 2^LOG_N) for 0 <= m < 2^LOG_N: an exact sincospif argument.
template <int LOG_N>
__device__ __forceinline__ float2 twiddle(int m) {
  float2 w;
  sincospif(-2.0f * (float)m / (float)(1 << LOG_N), &w.y, &w.x);
  return w;
}

// Where a Stockham pass reads its points (load<R, Q>(j, b, v): the R points
// i = j + r Q of sequence b) and writes its results (store(i, b, x)).
// kShared: the pass must sync() between reading and writing (the source is
// shared memory the pass overwrites), or after writing (the next pass reads).
// kAlongJ: neighbouring lanes take neighbouring butterflies j of a sequence
// (else neighbouring sequences b).

// Shared memory, element i of sequence b at s[i * STRIDE + b'], where
// b' = b xor ((i >> LOG_SW) mod 16) if LOG_SW >= 0 (else b' = b): the swizzle
// that lets lanes along j write i = j R + r (LOG_SW = log2 R) without bank
// conflicts, while lanes along b stay conflict-free.
template <int STRIDE, int LOG_SW = -1>
struct Smem {
  enum : bool { kShared = true, kAlongJ = false, kFetch = false };
  float2* s;
  __device__ __forceinline__ int at(int i, int b) const {
    if constexpr (LOG_SW >= 0) return i * STRIDE + (b ^ ((i >> LOG_SW) & 15));
    else return i * STRIDE + b;
  }
  template <int R, int Q>
  __device__ __forceinline__ void load(int j, int b, float2* v) const {
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = s[at(j + r * Q, b)];
  }
  __device__ __forceinline__ void store(int i, int b, float2 x) const { s[at(i, b)] = x; }
  __device__ __forceinline__ void sync() const { __syncthreads(); }
};

// The column FFTs' input straight from device memory: element n1 of column
// b is the frame's pair n1*N2 + b, over 127.5, times the window (which stays
// in L2). x and w point at the block's first column. A pass that reads it
// first fetch()es all its points (every load in flight at once: nothing
// else runs on the SM meanwhile), then converts them.
template <int N2>
struct FrameIn {
  enum : bool { kShared = false, kAlongJ = false, kFetch = true };
  const char2* x;
  const float* w;
  template <int R, int Q>
  __device__ __forceinline__ void fetch(int j, int b, char2* iq, float* win) const {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      iq[r] = x[(j + r * Q) * N2 + b];
      win[r] = w[(j + r * Q) * N2 + b];
    }
  }
  __device__ __forceinline__ static float2 convert(char2 iq, float win) {
    const float sc = win * (1.0f / 127.5f);
    return make_float2((float)iq.x * sc, (float)iq.y * sc);
  }
};

// The row FFTs' input: element n2 of row b (k1 = k1_0 + b) is Y[k1][n2],
// which the block of rank n2 / BA holds at k1*SA + n2 mod BA, times the
// four-step twiddle exp(-2 pi i k1 n2 / N): for the R points of a butterfly
// exp(-2 pi i k1 j / N) times the r-th power of exp(-2 pi i k1 Q / N), a
// running product. Lanes run along n2, so that a warp reads runs of
// consecutive columns from one block (distributed shared memory moves whole
// sectors; lanes along k1 would each fetch their own). sync() waits until
// every block of the cluster has read.
template <int LOG_N, int LOG_BA, int SA, bool kClustered>
struct ExchangeIn {
  enum : bool { kShared = true, kAlongJ = true, kFetch = false };
  float2* s;
  int k1_0;
  template <int R, int Q>
  __device__ __forceinline__ void load(int j, int b, float2* v) const {
    const int k1 = k1_0 + b;
    const float2 step = twiddle<LOG_N>(k1 * Q);
    float2 tw = twiddle<LOG_N>(k1 * j);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int n2 = j + r * Q;
      const float2* src = s + k1 * SA + (n2 & ((1 << LOG_BA) - 1));
      if constexpr (kClustered) src = cg::this_cluster().map_shared_rank(src, (unsigned)(n2 >> LOG_BA));
      v[r] = cmul(*src, tw);
      tw = cmul(tw, step);
    }
  }
  __device__ __forceinline__ void sync() const {
    if constexpr (kClustered) {
      cg::this_cluster().sync();
    } else {
      __syncthreads();
    }
  }
};

// The row FFTs' output: element k2 of row b is X[k1 + N1 k2] (k1 = k1_0 + b),
// written as 10 log10(max(|X|^2, 1e-30) / rate); o points at X[k1_0].
// (inv_rate = 1/rate: a product, not a division per bin.)
template <int N1>
struct DbOut {
  enum : bool { kShared = false, kAlongJ = false, kFetch = false };
  float* o;
  float inv_rate;
  __device__ __forceinline__ void store(int k2, int b, float2 y) const {
    const float p = y.x * y.x + y.y * y.y;
    o[k2 * N1 + b] = 10.0f * log10f(fmaxf(p, 1e-30f) * inv_rate);
  }
};

// One radix-R Stockham pass over the block's 2^LOG_B sequences of length
// 2^LOG_L, after passes whose radices multiply to NS = 2^LOG_NS. Butterfly
// (b, j) reads i = j + r L/R, multiplies by exp(-2 pi i (j mod NS) r / (NS R)),
// and writes i = (j / NS) NS R + (j mod NS) + r NS. A thread takes 32/R
// butterflies, all read before it writes any; the block takes the pass's
// butterflies from j0 on (a cluster's blocks split a pass's butterflies).
template <int R, int LOG_L, int LOG_B, int LOG_NS, int NT, class In, class Out>
__device__ __forceinline__ void stockham_pass(const In& in, const Out& out, int j0 = 0) {
  constexpr int K = kPerThread / R, LOG_Q = LOG_L - log2_c(R), Q = 1 << LOG_Q, NS = 1 << LOG_NS;
  const int t = threadIdx.x;
  // butterfly j of sequence b for item k
  const auto bj = [t, j0](int k, int& b, int& j) {
    if constexpr (In::kAlongJ) {
      j = seq_of<LOG_Q, NT>(t, k) + j0;
      b = pos_of<LOG_Q, NT>(t, k);
    } else {
      b = seq_of<LOG_B, NT>(t, k);
      j = pos_of<LOG_B, NT>(t, k) + j0;
    }
  };
  float2 v[kPerThread];
  if constexpr (In::kFetch) {
    char2 iq[kPerThread];
    float win[kPerThread];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      int b, j;
      bj(k, b, j);
      in.template fetch<R, Q>(j, b, iq + k * R, win + k * R);
    }
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) v[i] = In::convert(iq[i], win[i]);
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      int b, j;
      bj(k, b, j);
      in.template load<R, Q>(j, b, v + k * R);
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if constexpr (NS > 1) {  // powers of w1 by a running product: <= R-2 roundings
      // (no branch on jn == 0, where w1 = 1 exactly: a branch around the
      // loop sends v to local memory)
      int b, j;
      bj(k, b, j);
      const int jn = j & (NS - 1);
      float2 w1, w;
      sincospif(-2.0f * (float)jn / (float)(NS * R), &w1.y, &w1.x);
      w = w1;
#pragma unroll
      for (int r = 1; r < R; ++r) {
        v[k * R + r] = cmul(v[k * R + r], w);
        w = cmul(w, w1);
      }
    }
    dft_regs<R>(v + k * R);
  }
  if constexpr (In::kShared) in.sync();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    int b, j;
    bj(k, b, j);
    const int jn = j & (NS - 1);
    const int d = (j - jn) * R + jn;
#pragma unroll
    for (int r = 0; r < R; ++r) out.store(d + r * NS, b, v[k * R + r]);
  }
  if constexpr (Out::kShared) __syncthreads();
}

// FFTs of the block's 2^LOG_B sequences of length 2^LOG_L (16 <= L <= 4096
// here), natural order in and out: the first pass reads from `first`, the
// last writes to `last`, the others go through `mid` (next_radix_log). The
// passes from radix product 2^LOG_NS to 2^LOG_END (a part of the FFT: the
// cluster scratch form runs its first or last pass across the cluster).
template <int LOG_L, int LOG_B, int NT, int LOG_NS = 0, int LOG_END = LOG_L, class First, class Mid, class Last>
__device__ __forceinline__ void stockham_fft(const First& first, const Mid& mid, const Last& last) {
  if constexpr (LOG_NS < LOG_END) {
    constexpr int rem = LOG_L - LOG_NS;
    constexpr int lr = next_radix_log(rem);
    static_assert(rem >= 2, "no radix-2 pass");
    constexpr bool is_first = LOG_NS == 0, is_last = LOG_NS + lr == LOG_END;
    if constexpr (is_first && is_last) {
      stockham_pass<1 << lr, LOG_L, LOG_B, LOG_NS, NT>(first, last);
    } else if constexpr (is_first) {
      stockham_pass<1 << lr, LOG_L, LOG_B, LOG_NS, NT>(first, mid);
    } else if constexpr (is_last) {
      stockham_pass<1 << lr, LOG_L, LOG_B, LOG_NS, NT>(mid, last);
    } else {
      stockham_pass<1 << lr, LOG_L, LOG_B, LOG_NS, NT>(mid, mid);
    }
    stockham_fft<LOG_L, LOG_B, NT, LOG_NS + lr, LOG_END>(first, mid, last);
  }
}

// The on-chip geometry of fft 2^LOG_N: C = 2^LOG_C blocks a frame, the
// four-step split N1 x N2, the column phase's BA = N2/C columns at stride SA
// and the row phase's BC = N1/C rows at stride BC (swizzled by the row
// FFT's first radix R1); NT threads. The exchange reads runs of Q1 = N2/R1
// columns from BC rows; where a run is shorter than a half-warp's 16 lanes,
// SA = BA + 8 keeps two rows of a half-warp on other banks.
template <int LOG_N>
struct OnChip {
  static constexpr int LOG_C = LOG_N > kSingleMaxLog ? LOG_N - kClusterBlockLog : 0;
  static constexpr int LOG_N1 = (LOG_N + 1) / 2, LOG_N2 = LOG_N / 2;
  static constexpr int N1 = 1 << LOG_N1, N2 = 1 << LOG_N2;
  static constexpr int LOG_BA = LOG_N2 - LOG_C, LOG_BC = LOG_N1 - LOG_C;
  static constexpr int LOG_R1 = next_radix_log(LOG_N2), Q1 = N2 >> LOG_R1;
  static constexpr int BA = 1 << LOG_BA, BC = 1 << LOG_BC, SA = BA + (Q1 < 16 ? 8 : 0);
  static constexpr int NT = 1 << (LOG_N - LOG_C - kLogPerThread);
  static constexpr int MIN_BLOCKS = LOG_N - LOG_C <= kClusterBlockLog ? 2 : 1;  // a SM
  static constexpr size_t SMEM = sizeof(float2) * (N1 * SA > N2 * BC ? N1 * SA : N2 * BC);
  static_assert(BC >= 16, "the row swizzle needs 16 rows");
};

// One frame per block (fft <= 2^14) or per cluster of C blocks along x
// (block rank c); gridDim.y = frames, blockDim.x = NT.
//   column phase: FFTs over n1 of the block's columns n2 in [c*BA, (c+1)*BA),
//     the first pass reading the int8 pairs from device memory, the result
//     Y[k1][n2] left at smem[k1*SA + n2 - c*BA];
//   row phase: FFTs over n2 of the block's rows k1 in [c*BC, (c+1)*BC), the
//     first pass reading Y from the cluster's blocks (distributed shared
//     memory) with the twiddle, the last writing dB to device memory.
template <int LOG_N>
__global__ void __launch_bounds__(OnChip<LOG_N>::NT, OnChip<LOG_N>::MIN_BLOCKS)
psd_onchip(const char2* __restrict__ iq, const float* __restrict__ win, float* __restrict__ out,
           int decim, float rate) {
  using G = OnChip<LOG_N>;
  constexpr bool kClustered = G::LOG_C > 0;
  extern __shared__ float2 smem[];
  const long long frame = blockIdx.y;
  int c = 0;
  if constexpr (kClustered) c = (int)cg::this_cluster().block_rank();

  // the Decimator keeps the first N pairs of each N*decim group
  const FrameIn<G::N2> in{iq + ((frame * decim) << LOG_N) + c * G::BA, win + c * G::BA};
  stockham_fft<G::LOG_N1, G::LOG_BA, G::NT>(in, Smem<G::SA>{smem}, Smem<G::SA>{smem});
  if constexpr (kClustered) cg::this_cluster().sync();  // every block's columns are done

  const ExchangeIn<LOG_N, G::LOG_BA, G::SA, kClustered> ex{smem, c * G::BC};
  const DbOut<G::N1> db{out + (frame << LOG_N) + c * G::BC, 1.0f / rate};
  stockham_fft<G::LOG_N2, G::LOG_BC, G::NT>(ex, Smem<G::BC, G::LOG_R1>{smem}, db);
}

using OnChipKernel = void (*)(const char2*, const float*, float*, int, float);

// The kernel of fft 2^LOG_N and what its launch needs from OnChip.
struct OnChipLaunch {
  OnChipKernel fn;
  size_t smem;
  int log_c, threads;
};

template <int LOG_N>
OnChipLaunch onchip_launch() {
  using G = OnChip<LOG_N>;
  return {psd_onchip<LOG_N>, G::SMEM, G::LOG_C, G::NT};
}

OnChipLaunch onchip_launch(int log_n) {
  switch (log_n) {
    case 8: return onchip_launch<8>();
    case 9: return onchip_launch<9>();
    case 10: return onchip_launch<10>();
    case 11: return onchip_launch<11>();
    case 12: return onchip_launch<12>();
    case 13: return onchip_launch<13>();
    case 14: return onchip_launch<14>();
    case 15: return onchip_launch<15>();
    case 16: return onchip_launch<16>();
    case 17: return onchip_launch<17>();
    default: return {nullptr, 0, 0, 0};
  }
}

// Launch configuration of an on-chip form: dynamic shared memory set, and
// for fft > 2^14 the cluster dimension (attr must outlive cfg's use) and,
// for 16 blocks, leave to exceed the portable cluster size.
cudaError_t onchip_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, OnChipKernel* fn,
                          int frames, int log_n, cudaStream_t s) {
  const OnChipLaunch l = onchip_launch(log_n);
  *fn = l.fn;
  if (*fn == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(*fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.smem);
  if (err != cudaSuccess) return err;
  if (l.log_c > 3) {  // 16 blocks: above the portable 8
    err = cudaFuncSetAttribute(*fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(1u << l.log_c, (unsigned)frames, 1);
  cfg->blockDim = dim3((unsigned)l.threads, 1, 1);
  cfg->dynamicSmemBytes = l.smem;
  cfg->stream = s;
  if (l.log_c > 0) {
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = 1u << l.log_c;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    cfg->attrs = attr;
    cfg->numAttrs = 1;
  }
  return cudaSuccess;
}

// ---- scratch forms (2^17 < fft <= 2^24)

// One scratch pass over sequences of 2^LOG_L points: 2^LOG_S of them a block,
// 2^LOG_G = 2^(LOG_S + LOG_C) over a cluster of 2^LOG_C blocks, so that a
// cluster (a lone block below 4096 points) holds at least 8. A block holds
// 2^LOG_P points: 8192 (64 KB, 256 threads, two blocks an SM) for sequences
// of up to 1024 points, 16384 (128 KB, 512 threads, one an SM) for 2048;
// 4096-point sequences take a cluster of 2^kScratchClusterLog blocks that
// holds 8 of them. LOG_R / LOG_RL: the first / last Stockham radix.
template <int LOG_L>
struct ScratchPass {
  static constexpr int LOG_C = LOG_L > kScratchWideLog ? kScratchClusterLog : 0;
  static constexpr int LOG_P = LOG_C > 0 ? LOG_L + 3 - LOG_C
                               : LOG_L > kScratchNarrowLog ? kScratchBlockLog + 1 : kScratchBlockLog;
  static constexpr int LOG_S = LOG_P - LOG_L, LOG_G = LOG_S + LOG_C, S = 1 << LOG_S;
  static constexpr int NT = 1 << (LOG_P - kLogPerThread);
  static constexpr int MIN_BLOCKS = LOG_P <= kScratchBlockLog ? 2 : 1;  // a SM
  static constexpr int LOG_R = next_radix_log(LOG_L), LOG_RL = last_radix_log(LOG_L);
  static_assert(LOG_G >= 3, "at least 8 sequences a cluster: 16-byte runs in, 32-byte runs out");
};

// The scratch forms' geometry at fft 2^LOG_N: the four-step split N1 x N2,
// pass 1 over the N2 columns (P1), pass 2 over the N1 rows (P2), and each
// pass's shared memory (its sequences and SmemPad's pad after every first
// radix: S slots a pad in pass 1, one in pass 2).
template <int LOG_N>
struct Scratch {
  static constexpr int LOG_N1 = (LOG_N + 1) / 2, LOG_N2 = LOG_N / 2;
  static constexpr int N1 = 1 << LOG_N1, N2 = 1 << LOG_N2;
  using P1 = ScratchPass<LOG_N1>;
  using P2 = ScratchPass<LOG_N2>;
  static constexpr size_t SMEM1 = sizeof(float2) * ((size_t)N1 + (N1 >> P1::LOG_R)) * P1::S;
  static constexpr size_t SMEM2 = sizeof(float2) * ((size_t)N2 * P2::S + (N2 >> P2::LOG_R));
  static_assert(SMEM1 <= 232448 && SMEM2 <= 232448, "a block's 227 KB of shared memory");
};

// Shared memory for the scratch passes: element i of sequence b at
// s[i * S + (i >> LOG_P) * PAD + b], a pad of PAD slots after every 2^LOG_P
// elements, so that a first pass's writes (i = j R + r, LOG_P = log2 R) spread
// over the banks: PAD = S where lanes run along b (pass 1), PAD = 1 where
// they run along j (pass 2's first pass).
template <int S, int LOG_P, int PAD>
struct SmemPad {
  enum : bool { kShared = true, kAlongJ = false, kFetch = false };
  float2* s;
  __device__ __forceinline__ int at(int i, int b) const { return i * S + (i >> LOG_P) * PAD + b; }
  template <int R, int Q>
  __device__ __forceinline__ void load(int j, int b, float2* v) const {
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = s[at(j + r * Q, b)];
  }
  __device__ __forceinline__ void store(int i, int b, float2 x) const { s[at(i, b)] = x; }
  __device__ __forceinline__ void sync() const { __syncthreads(); }
};

// A cluster's sequences in its blocks' shared memory, read as the input of
// a pass: sequence b lives in the block of rank b >> LOG_S as that block's
// sequence b mod 2^LOG_S, in SmemPad's layout, reached through distributed
// shared memory. sync() is the cluster's barrier: no block leaves while
// another may still read its shared memory.
template <int LOG_S, int LOG_P, int PAD>
struct ClusterPad {
  enum : bool { kShared = true, kAlongJ = false, kFetch = false };
  float2* s;
  template <int R, int Q>
  __device__ __forceinline__ void load(int j, int b, float2* v) const {
    const SmemPad<1 << LOG_S, LOG_P, PAD> block{cg::this_cluster().map_shared_rank(s, (unsigned)(b >> LOG_S))};
    block.template load<R, Q>(j, b & ((1 << LOG_S) - 1), v);
  }
  __device__ __forceinline__ void sync() const { cg::this_cluster().sync(); }
};

// Pass 1's input: FrameIn's int8 pairs (element n1 of column b is the
// frame's pair n1 N2 + b; x points at the first column, n2 = c0), with the
// window computed, not read: reading it (4 B a point, in half sectors) cost
// pass 1 more than its pairs. Hamming 0.54 - 0.46 cos(2 pi n / (N - 1))
// times (-1)^n at n = n1 N2 + n2, which is the table the wrapper passes the
// other forms (its sign is (-1)^n2: N2 is even); a butterfly's cosines from
// one double sincospi at its first point, then a rotation by 2 pi Q N2 /
// (N - 1) a point (<= 31 roundings, ~2e-6 of the window).
template <int LOG_N>
struct HammingFrameIn {
  enum : bool { kShared = false, kAlongJ = false, kFetch = true };
  static constexpr int N2 = 1 << (LOG_N / 2);
  const char2* x;
  int c0;
  template <int R, int Q>
  __device__ __forceinline__ void fetch(int j, int b, char2* iq, float* win) const {
#pragma unroll
    for (int r = 0; r < R; ++r) iq[r] = x[(j + r * Q) * N2 + b];
    constexpr double kPerN = 2.0 / (double)((1 << LOG_N) - 1);  // sincospi's argument a step of n
    double sn, cs;
    sincospi((double)(j * N2 + c0 + b) * kPerN, &sn, &cs);
    float2 z = make_float2((float)cs, (float)sn);
    sincospi((double)(Q * N2) * kPerN, &sn, &cs);
    const float2 step = make_float2((float)cs, (float)sn);
    const float sign = ((c0 + b) & 1) ? -1.0f : 1.0f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      win[r] = (0.54f - 0.46f * z.x) * sign;
      z = cmul(z, step);
    }
  }
  __device__ __forceinline__ static float2 convert(char2 iq, float win) { return FrameIn<N2>::convert(iq, win); }
};

// Pass 1's output: element k1 of column b is C[k1][n2] (n2 = the block's
// first column + b) in the frame's complex f32 scratch, row-major [N1][N2];
// c points at the block's first column of row 0. The four-step twiddle is
// pass 2's (ExchangeIn, read along n2).
template <int N2>
struct ScratchOut {
  enum : bool { kShared = false, kAlongJ = false, kFetch = false };
  float2* c;
  __device__ __forceinline__ void store(int i, int b, float2 x) const { c[(long long)i * N2 + b] = x; }
};

// Pass 1: the N1-point FFTs of the block's S columns n2 (one block per (S
// columns, frame)), the first Stockham pass reading the int8 pairs from
// device memory, the last writing C[k1][n2] to the scratch. Where the
// columns have 4096 points, a cluster per (8 columns, frame): each block
// reads its S pairs of every 16-byte run while the cluster's other block
// reads the rest (one sector a row, read from device memory once).
template <int LOG_N>
__global__ void __launch_bounds__(Scratch<LOG_N>::P1::NT, Scratch<LOG_N>::P1::MIN_BLOCKS)
psd_scratch1(const char2* __restrict__ iq, float2* __restrict__ scratch, int decim) {
  using G = Scratch<LOG_N>;
  using P = typename G::P1;
  extern __shared__ float2 smem[];
  const long long frame = blockIdx.y;
  const int c0 = blockIdx.x << P::LOG_S;  // the block's first column
  // the Decimator keeps the first N pairs of each N*decim group
  const HammingFrameIn<LOG_N> in{iq + ((frame * decim) << LOG_N) + c0, c0};
  const ScratchOut<G::N2> out{scratch + (frame << LOG_N) + c0};
  stockham_fft<G::LOG_N1, P::LOG_S, P::NT>(in, SmemPad<P::S, P::LOG_R, P::S>{smem}, out);
}

// Pass 2: the N2-point FFTs of the block's S rows k1 (one block per (S rows,
// frame)), the first pass reading C[k1][:] along n2 with the twiddle
// exp(-2 pi i k1 n2 / N) (ExchangeIn over the scratch: a running product a
// butterfly), the last writing the dB of X[k1 + N1 k2]. Where the rows have
// 4096 points, a cluster per (8 rows, frame): each block runs all but the
// last pass on its own S rows, then, after the cluster's barrier, block
// rank c the last pass's butterflies [c Q / C, (c + 1) Q / C) of all 8
// rows, the others' read through distributed shared memory (32-byte runs
// of dB).
template <int LOG_N>
__global__ void __launch_bounds__(Scratch<LOG_N>::P2::NT, Scratch<LOG_N>::P2::MIN_BLOCKS)
psd_scratch2(float2* __restrict__ scratch, float* __restrict__ out, float rate) {
  using G = Scratch<LOG_N>;
  using P = typename G::P2;
  extern __shared__ float2 smem[];
  const long long frame = blockIdx.y;
  const int r0 = blockIdx.x << P::LOG_S;  // the block's first row
  const ExchangeIn<LOG_N, G::LOG_N2, G::N2, false> ex{scratch + (frame << LOG_N), r0};
  const SmemPad<P::S, P::LOG_R, 1> mine{smem};
  if constexpr (P::LOG_C == 0) {
    stockham_fft<G::LOG_N2, P::LOG_S, P::NT>(ex, mine, DbOut<G::N1>{out + (frame << LOG_N) + r0, 1.0f / rate});
  } else {
    const int rank = (int)cg::this_cluster().block_rank();
    const int g0 = r0 - rank * P::S;  // the cluster's first row
    constexpr int kLogQ = G::LOG_N2 - P::LOG_RL;  // the last pass's butterflies a row
    stockham_fft<G::LOG_N2, P::LOG_S, P::NT, 0, kLogQ>(ex, mine, mine);
    cg::this_cluster().sync();  // every block's rows are ready
    stockham_pass<1 << P::LOG_RL, G::LOG_N2, P::LOG_G, kLogQ, P::NT>(
        ClusterPad<P::LOG_S, P::LOG_R, 1>{smem}, DbOut<G::N1>{out + (frame << LOG_N) + g0, 1.0f / rate},
        rank << (kLogQ - P::LOG_C));
  }
}

// Launches one scratch pass of `blocks` blocks a frame, in clusters of
// 2^P::LOG_C blocks where its sequences have 4096 points.
template <class P, class... Params, class... Args>
cudaError_t launch_pass(void (*fn)(Params...), size_t smem, int blocks, int frames, cudaStream_t s,
                        Args... args) {
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3((unsigned)blocks, (unsigned)frames, 1);
  cfg.blockDim = dim3(P::NT, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr;
  if constexpr (P::LOG_C > 0) {
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = 1u << P::LOG_C;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
  }
  return cudaLaunchKernelEx(&cfg, fn, args...);
}

template <int LOG_N>
int launch_scratch(const void* iq, void* scratch, void* out, int frames, int decim, float rate,
                   cudaStream_t s) {
  using G = Scratch<LOG_N>;
  cudaError_t err = launch_pass<typename G::P1>(psd_scratch1<LOG_N>, G::SMEM1, G::N2 >> G::P1::LOG_S, frames,
                                                s, (const char2*)iq, (float2*)scratch, decim);
  if (err == cudaSuccess) err = launch_pass<typename G::P2>(psd_scratch2<LOG_N>, G::SMEM2, G::N1 >> G::P2::LOG_S,
                                                            frames, s, (float2*)scratch, (float*)out, rate);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

int launch_scratch(const void* iq, void* scratch, void* out, int frames, int log_n, int decim, float rate,
                   cudaStream_t s) {
  switch (log_n) {
    case 18: return launch_scratch<18>(iq, scratch, out, frames, decim, rate, s);
    case 19: return launch_scratch<19>(iq, scratch, out, frames, decim, rate, s);
    case 20: return launch_scratch<20>(iq, scratch, out, frames, decim, rate, s);
    case 21: return launch_scratch<21>(iq, scratch, out, frames, decim, rate, s);
    case 22: return launch_scratch<22>(iq, scratch, out, frames, decim, rate, s);
    case 23: return launch_scratch<23>(iq, scratch, out, frames, decim, rate, s);
    case 24: return launch_scratch<24>(iq, scratch, out, frames, decim, rate, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---- small-frame form (fft <= 128)

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
// lives at s[i * i_stride + col * c_stride]; neighbouring threads take
// neighbouring butterflies of one sequence.
__device__ void fft_batch(float2* s, const float2* tw, int log_n, int log_batch,
                          int i_stride, int c_stride) {
  const int log_half = log_n - 1;
  const int total = 1 << (log_batch + log_half);
  for (int st = 1; st <= log_n; ++st) {
    const int h = 1 << (st - 1);
    const int tw_shift = log_n - st;  // tw index = pos * (n / 2^st)
    for (int j = threadIdx.x; j < total; j += blockDim.x) {
      const int col = j >> log_half, b = j & ((1 << log_half) - 1);
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

// A block's 4096 / N frames of N = 2^log_n points: frame f of the block at
// a[f*N ...], loaded bit-reversed, transformed in place by fft_batch (lanes
// along the butterflies of a frame), written out as dB rows. Slots past the
// last frame transform zeros and write nothing.
__global__ void __launch_bounds__(kThreads)
psd_small(const char2* __restrict__ iq, const float* __restrict__ win, float* __restrict__ out,
          int frames, int log_n, int decim, float rate) {
  extern __shared__ float2 smem[];
  const int n = 1 << log_n;
  const int log_f = kSmallPointsLog - log_n;  // frames a block, log2
  float2* tw = smem;          // [n/2]
  float2* a = smem + n / 2;  // [4096]
  const long long f0 = (long long)blockIdx.x << log_f;
  fill_twiddles(tw, n);
  for (int e = threadIdx.x; e < (1 << kSmallPointsLog); e += blockDim.x) {
    const int f = e >> log_n, i = e & (n - 1);
    const long long frame = f0 + f;
    float2 x = make_float2(0.0f, 0.0f);
    if (frame < frames) {  // the Decimator keeps the first N pairs of each N*decim group
      const char2 v = iq[frame * n * decim + i];
      const float w = win[i];
      x = make_float2((float)v.x / 127.5f * w, (float)v.y / 127.5f * w);
    }
    a[(f << log_n) + (int)bitrev(i, log_n)] = x;
  }
  __syncthreads();
  fft_batch(a, tw, log_n, log_f, 1, n);
  const long long valid = ((long long)frames - f0) << log_n;  // points of real frames here
  float* o = out + (f0 << log_n);
  for (int e = threadIdx.x; e < (1 << kSmallPointsLog) && e < valid; e += blockDim.x) {
    const float2 v = a[e];
    const float p = v.x * v.x + v.y * v.y;
    o[e] = 10.0f * log10f(fmaxf(p, 1e-30f) / rate);
  }
}

int launch_small(const void* iq, const void* win, void* out, int frames, int log_n, int decim,
                 float rate, cudaStream_t s) {
  const int n = 1 << log_n;
  const int sm = (int)((n / 2 + (1 << kSmallPointsLog)) * sizeof(float2));
  const int log_f = kSmallPointsLog - log_n;
  const int blocks = (int)(((long long)frames + (1 << log_f) - 1) >> log_f);
  psd_small<<<blocks, kThreads, sm, s>>>((const char2*)iq, (const float*)win, (float*)out, frames,
                                         log_n, decim, rate);
  return (int)cudaGetLastError();
}

}  // namespace

// The form that takes fft = 2^log_n (enum Form), or -1 outside [2, 2^24].
extern "C" int psd_form(int log_n) {
  return log_n < 1 || log_n > kMaxLog ? -1 : (int)form_of(log_n);
}

// Bytes of global scratch one frame needs: 0 for the on-chip and
// small-frame forms (fft <= 2^17), a complex f32 frame for both scratch
// forms.
extern "C" long long psd_scratch_bytes(int log_n1, int log_n2) {
  const Form f = form_of(log_n1 + log_n2);
  return f == kScratch || f == kClusterScratch ? (long long)sizeof(float2) << (log_n1 + log_n2) : 0;
}

// Clusters of the cluster form that the card holds at once
// (cudaOccupancyMaxActiveClusters); 0 where the size takes another form, a
// negative CUDA error code on failure.
extern "C" int psd_max_active_clusters(int log_n1, int log_n2) {
  const int log_n = log_n1 + log_n2;
  if (form_of(log_n) != kCluster) return 0;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  OnChipKernel fn;
  cudaError_t err = onchip_config(&cfg, &attr, &fn, 1, log_n, 0);
  int clusters = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg);
  return err == cudaSuccess ? clusters : -(int)err;
}

// iq: [frames, fft*decim, 2] int8; win: [fft] f32 (Hamming * (-1)^n), or
// null where psd_scratch_bytes() is not 0 (the scratch form computes it:
// HammingFrameIn); scratch: psd_scratch_bytes() per frame, or null where
// that is 0;
// out: [frames, fft] f32. fft = 2^(log_n1 + log_n2), 2 <= fft <= 2^24, with
// log_n1 = ceil(log2(fft) / 2) (_split_n); fft <= 128 takes the small-frame
// form, which splits nothing.
// Returns cudaGetLastError(); a launch the card refuses (a cluster it cannot
// place) is returned, never rerouted.
extern "C" int psd_frames_int8(const void* iq, const void* win, void* scratch, void* out,
                               int frames, int log_n1, int log_n2, int decim, float rate,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int log_n = log_n1 + log_n2;
  if (frames <= 0 || decim <= 0 || log_n < 1 || log_n1 != (log_n + 1) / 2 || log_n > kMaxLog) {
    return (int)cudaErrorInvalidValue;
  }
  const Form form = form_of(log_n);
  if (form == kSmall) return launch_small(iq, win, out, frames, log_n, decim, rate, s);
  if (form == kScratch || form == kClusterScratch) {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    return launch_scratch(iq, scratch, out, frames, log_n, decim, rate, s);
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  OnChipKernel fn;
  cudaError_t err = onchip_config(&cfg, &attr, &fn, frames, log_n, s);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, fn, (const char2*)iq, (const float*)win, (float*)out, decim, rate);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
