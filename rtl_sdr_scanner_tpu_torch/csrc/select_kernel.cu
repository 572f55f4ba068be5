// Fused candidate selection on Hopper: per row of the masked smoothed
// spectrum, the exact top-K bins (value descending, first-occurrence ties),
// K_SEP greedy margin-separated winners (+-submargin zone suppression) and
// the count of bins >= level (level cast to the row dtype).
//
// Replaces the TPU kernel fused_selection / _selection_kernel
// (rtl_sdr_scanner_tpu/ops/pallas/select_kernel.py). That kernel copied the
// whole row into VMEM; a 131072-bin row is 256 KB in bf16, over the 227 KB
// of shared memory a block can use, so the row stays in device memory / L2
// and only the selection state lives in shared memory.
//
// Bound: the function must read each row once (262,144 B in bf16 at fft
// 131072) and write 80 values + 80 indices + 1 count: 1080 rows move
// 0.28 GB, 0.085 ms at 3.35 TB/s. The 80 winners of a row are a sequential
// chain, so what costs is each winner's latency, not bytes. The design:
//   - one warp owns a row, four rows a block, and no block barrier exists:
//     every step is warp-synchronous (shuffles, redux.sync, __syncwarp).
//     At most 8.9 KB of shared memory a row, so every row of both paths
//     (1080 and 1800) is resident at once: one wave;
//   - an argmax is two redux.sync instructions on 32-bit keys: the value
//     as an order-preserving key (-0.0 folded onto 0.0, as the float compare
//     has them), then the least index among the lanes holding the maximum;
//   - a two-level table: leaves of L bins (32 up to fft 32768, then L =
//     fft/1024) hold (key, index) in shared memory, 32 groups of leaves
//     hold theirs in one register a lane (a row of fewer than 32 leaves,
//     fft 256-512, has a group a leaf and lanes without one). A winner is
//     one argmax over the groups; a single-bin suppression re-reduces one
//     leaf (L/32 loads a lane) and one group (one shared load a lane);
//   - the table is built by one pass over the row with 16-byte loads, the
//     next 4 a lane in flight while the last 4 are reduced; a load takes 64
//     contiguous bytes of each of 8 leaves, so a leaf costs 2 shuffles. The
//     same pass counts the bins >= level;
//   - top-K needs no suppression state: after winner w, the rest of a leaf
//     is exactly its bins ordered after w (value desc, index asc). Its
//     changes are logged and undone for the second phase;
//   - the margin phase keeps its zone centres in shared memory: leaves a
//     new zone covers whole become (sentinel, first bin); the <= 2 it cuts
//     are re-reduced together, every bin tested against the zones so far.
//
// Tie and sentinel rules are the TPU kernel's, bit for bit: (value desc,
// index asc) at every level; a suppressed bin compares as the sentinel
// -3.3e38 cast to the row dtype (passed in as `neg`), including the
// all-suppressed corner and rows holding the -3.0e38 mask value.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kRowsPerBlock = 4;
constexpr int kThreads = kRowsPerBlock * 32;
constexpr int kGroups = 32;     // groups of leaves: at most one a lane
constexpr int kLeavesALoad = 8;  // one warp load spans 8 leaves
constexpr int kUnroll = 4;      // 16-byte loads a lane in flight while the last 4 are reduced
constexpr uint32_t kNone = 0u;  // key below every value's: an exhausted leaf
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;
constexpr size_t kMaxSmem = 232448;  // 227 KB, what one block may use

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

// order-preserving 32-bit key of a float; -0.0 and 0.0 get the same key
__device__ __forceinline__ uint32_t key_of(float v) {
  uint32_t u = __float_as_uint(v);
  if ((u << 1) == 0u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// (larger key, then smaller index) is better
__device__ __forceinline__ bool better(uint32_t k, uint32_t i, uint32_t bk, uint32_t bi) {
  return k > bk || (k == bk && i < bi);
}

// whole warp: the best (key, index) of the lanes, in every lane
__device__ __forceinline__ void warp_best(uint32_t& key, uint32_t& idx) {
  const uint32_t k = __reduce_max_sync(kFull, key);
  idx = __reduce_min_sync(kFull, key == k ? idx : 0xffffffffu);
  key = k;
}

// 16 bytes of the row as floats
__device__ __forceinline__ void unpack(const uint4& v, float* out, const float*) {
  out[0] = __uint_as_float(v.x);
  out[1] = __uint_as_float(v.y);
  out[2] = __uint_as_float(v.z);
  out[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void unpack(const uint4& v, float* out, const __nv_bfloat16*) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    out[2 * e] = __uint_as_float(w[e] << 16);
    out[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
  }
}

struct RowSmem {
  uint2* leaf;      // [n_leaf] (key, bin)
  uint3* log;       // [top_k] (winner, leaf's key and bin before it)
  int* zone;        // [k_sep] margin winners, the zones' centres
};

__host__ __device__ inline size_t row_smem_bytes(int n_leaf, int top_k, int k_sep) {
  return ((size_t)n_leaf * 8 + (size_t)top_k * 12 + (size_t)k_sep * 4 + 15) / 16 * 16;
}

// Phase 1: the best (key, bin) of leaf l among its bins ordered after the
// winner (ak, aw), in every lane.
template <typename T>
__device__ __forceinline__ void leaf_after(const T* row, int leaf_w, int l, uint32_t ak,
                                           uint32_t aw, uint32_t& bk, uint32_t& bi) {
  const int per = leaf_w >> 5;
  const uint32_t b0 = (uint32_t)(l * leaf_w + (threadIdx.x & 31) * per);
  bk = kNone;
  bi = 0xffffffffu;
#pragma unroll 4
  for (int e = 0; e < per; ++e) {
    const uint32_t b = b0 + e;
    const uint32_t k = key_of(load(row, b));
    if (better(ak, aw, k, b) && better(k, b, bk, bi)) {
      bk = k;
      bi = b;
    }
  }
  warp_best(bk, bi);
}

// the zones of zone[0 .. nz) (nz <= 32) that reach bins [lo, hi], a lane a zone
__device__ __forceinline__ uint32_t zones_reaching(const int* zone, int nz, int submargin, int lo,
                                                  int hi) {
  const int z = threadIdx.x & 31;
  return __ballot_sync(kFull, z < nz && zone[z] + submargin >= lo && zone[z] - submargin <= hi);
}

// Phase 2: the best (key, bin) of leaves la and lb (the two a zone cuts;
// lb < 0: la alone) with every bin within submargin of zone[0 .. nz)
// compared as the sentinel's key nk, in every lane. Only the zones that
// reach a leaf are tested; both leaves' loads fly together.
template <typename T>
__device__ __forceinline__ void leaves_zoned(const T* row, int leaf_w, int la, int lb,
                                             const int* zone, int nz, int submargin, uint32_t nk,
                                             uint2& ea, uint2& eb) {
  const int per = leaf_w >> 5;
  const int la0 = la * leaf_w, lb0 = (lb < 0 ? la : lb) * leaf_w;
  const uint32_t za = zones_reaching(zone, nz, submargin, la0, la0 + leaf_w - 1);
  const uint32_t zb = zones_reaching(zone, nz, submargin, lb0, lb0 + leaf_w - 1);
  const int off = (threadIdx.x & 31) * per;
  uint32_t ka = kNone, ia = 0xffffffffu, kb = kNone, ib = 0xffffffffu;
#pragma unroll 4
  for (int e = 0; e < per; ++e) {
    const int ba = la0 + off + e, bb = lb0 + off + e;
    const float va = load(row, ba), vb = load(row, bb);
    bool sa = false, sb = false;
    for (uint32_t m = za; m; m &= m - 1) sa |= abs(ba - zone[__ffs(m) - 1]) <= submargin;
    for (uint32_t m = zb; m; m &= m - 1) sb |= abs(bb - zone[__ffs(m) - 1]) <= submargin;
    const uint32_t kva = sa ? nk : key_of(va), kvb = sb ? nk : key_of(vb);
    if (better(kva, (uint32_t)ba, ka, ia)) {
      ka = kva;
      ia = (uint32_t)ba;
    }
    if (better(kvb, (uint32_t)bb, kb, ib)) {
      kb = kvb;
      ib = (uint32_t)bb;
    }
  }
  warp_best(ka, ia);
  warp_best(kb, ib);
  ea = make_uint2(ka, ia);
  eb = make_uint2(kb, ib);
}

// best (key, bin) over the leaves of group g (G leaves), every lane gets it
__device__ __forceinline__ void reduce_group(const uint2* leaf, int g, int G, uint32_t& bk,
                                             uint32_t& bi) {
  const int lane = threadIdx.x & 31;
  bk = kNone;
  bi = 0xffffffffu;
  for (int j = lane; j < G; j += 32) {
    const uint2 e = leaf[g * G + j];
    if (better(e.x, e.y, bk, bi)) {
      bk = e.x;
      bi = e.y;
    }
  }
  warp_best(bk, bi);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
selection_kernel(const T* __restrict__ rows, const float* __restrict__ level,
                 T* __restrict__ top_val, int* __restrict__ top_idx, T* __restrict__ sep_val,
                 int* __restrict__ sep_idx, int* __restrict__ count, int n_rows, int fft,
                 int leaf_w, int top_k, int k_sep, int submargin, float neg) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * kRowsPerBlock + warp;
  if (r >= n_rows) return;  // whole warps only: nothing below synchronises the block
  const int n_leaf = fft / leaf_w;
  const int n_groups = n_leaf < kGroups ? n_leaf : kGroups;  // fewer leaves: a group a leaf
  const int G = n_leaf / n_groups;  // leaves a group
  RowSmem s;
  {
    unsigned char* base = smem + (size_t)warp * row_smem_bytes(n_leaf, top_k, k_sep);
    s.leaf = reinterpret_cast<uint2*>(base);
    s.log = reinterpret_cast<uint3*>(base + (size_t)n_leaf * 8);
    s.zone = reinterpret_cast<int*>(base + (size_t)n_leaf * 8 + (size_t)top_k * 12);
  }
  const T* row = rows + r * fft;
  const float lev = to_row_dtype(*level, rows);
  const uint32_t nk = key_of(neg);

  // ---- the leaf table and the count: one pass, 16-byte loads. A leaf is
  // P = leaf_w / kVec 16-byte pieces; one warp load takes 4 pieces (64
  // contiguous bytes) of each of 8 leaves, so a leaf is reduced after
  // P / 4 loads, by 2 shuffles among its 4 lanes
  constexpr int kVec = 16 / sizeof(T);
  const int pieces = leaf_w / kVec;
  const int steps = pieces / 4;                // loads a leaf takes, a power of 2
  const int log_steps = __ffs(steps) - 1;
  const int n_loads = fft / (32 * kVec);       // loads a lane
  const uint4* src = reinterpret_cast<const uint4*>(row) + (lane >> 2) * pieces + (lane & 3);
  uint32_t cnt = 0, rk = kNone, ri = 0xffffffffu;
  uint4 cur[kUnroll], nxt[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    if (u < n_loads) cur[u] = __ldg(src + (size_t)(u >> log_steps) * 8 * pieces + (u & (steps - 1)) * 4);
  }
  for (int q0 = 0; q0 < n_loads; q0 += kUnroll) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {  // the next loads fly while these are reduced
      const int q = q0 + kUnroll + u;
      if (q < n_loads) nxt[u] = __ldg(src + (size_t)(q >> log_steps) * 8 * pieces + (q & (steps - 1)) * 4);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int q = q0 + u;
      if (q >= n_loads) break;
      float f[kVec];
      unpack(cur[u], f, row);
      float mx = f[0];
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        cnt += f[e] >= lev;
        mx = fmaxf(mx, f[e]);
      }
      int first = kVec - 1;
#pragma unroll
      for (int e = kVec - 2; e >= 0; --e) first = f[e] == mx ? e : first;
      const int leaf = (q >> log_steps) * 8 + (lane >> 2);
      const uint32_t b = (uint32_t)((leaf * pieces + (q & (steps - 1)) * 4 + (lane & 3)) * kVec + first);
      const uint32_t k = key_of(mx);
      if (better(k, b, rk, ri)) {
        rk = k;
        ri = b;
      }
      if ((q & (steps - 1)) == steps - 1) {  // the leaf's last load: reduce its 4 lanes
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          const uint32_t ok = __shfl_xor_sync(kFull, rk, off);
          const uint32_t oi = __shfl_xor_sync(kFull, ri, off);
          if (better(ok, oi, rk, ri)) {
            rk = ok;
            ri = oi;
          }
        }
        if ((lane & 3) == 0) s.leaf[leaf] = make_uint2(rk, ri);
        rk = kNone;
        ri = 0xffffffffu;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) cur[u] = nxt[u];
  }
  cnt = __reduce_add_sync(kFull, cnt);
  if (lane == 0) count[r] = (int)cnt;
  __syncwarp();

  // ---- the group table: lane g holds group g (leaves read staggered: no
  // bank conflicts); a lane without a group holds the key no bin has
  uint32_t gk = kNone, gi = 0xffffffffu;
  for (int j = 0; j < (lane < n_groups ? G : 0); ++j) {
    const uint2 e = s.leaf[lane * G + (j + lane) % G];
    if (better(e.x, e.y, gk, gi)) {
      gk = e.x;
      gi = e.y;
    }
  }
  const uint32_t pk = gk, pi = gi;  // pristine, for the second phase

  // ---- phase 1: exact top-K
  const int log_leaf = __ffs(leaf_w) - 1;
  for (int i = 0; i < top_k; ++i) {
    uint32_t wk = gk, w = gi;
    warp_best(wk, w);
    const int l = (int)(w >> log_leaf);
    if (lane == 0) {
      const uint2 old = s.leaf[l];
      s.log[i] = make_uint3(w, old.x, old.y);
    }
    uint32_t lk, li;
    leaf_after(row, leaf_w, l, wk, w, lk, li);
    if (lane == 0) s.leaf[l] = make_uint2(lk, li);
    __syncwarp();  // the group's lanes read the new leaf
    const int g = l / G;
    uint32_t bk, bi;
    reduce_group(s.leaf, g, G, bk, bi);
    if (lane == g) {
      gk = bk;
      gi = bi;
    }
  }
  __syncwarp();
  for (int i = lane; i < top_k; i += 32) {
    const int w = (int)s.log[i].x;
    store(top_val, r * top_k + i, load(row, w));
    top_idx[r * top_k + i] = w;
  }
  if (lane == 0) {  // undo phase 1's leaf changes, last first
    for (int i = top_k - 1; i >= 0; --i) {
      const uint3 e = s.log[i];
      s.leaf[e.x >> log_leaf] = make_uint2(e.y, e.z);
    }
  }
  gk = pk;
  gi = pi;
  __syncwarp();

  // ---- phase 2: margin-separated greedy, +-submargin zones
  for (int i = 0; i < k_sep; ++i) {
    uint32_t wk = gk, w = gi;
    warp_best(wk, w);
    if (lane == 0) s.zone[i] = (int)w;
    const int lo = max((int)w - submargin, 0), hi = min((int)w + submargin, fft - 1);
    const int l_lo = lo / leaf_w, l_hi = hi / leaf_w;
    for (int l = l_lo + lane; l <= l_hi; l += 32) {  // leaves the zone covers whole
      if (l * leaf_w >= lo && l * leaf_w + leaf_w - 1 <= hi) {
        s.leaf[l] = make_uint2(nk, (uint32_t)(l * leaf_w));
      }
    }
    __syncwarp();  // the zone list
    // the leaves the zone cuts (at most its two ends): every bin against every zone so far
    const bool cut_lo = l_lo * leaf_w < lo || l_lo * leaf_w + leaf_w - 1 > hi;
    const bool cut_hi = l_hi != l_lo && l_hi * leaf_w + leaf_w - 1 > hi;
    if (cut_lo || cut_hi) {
      const int la = cut_lo ? l_lo : l_hi, lb = cut_lo && cut_hi ? l_hi : -1;
      uint2 ea, eb;
      leaves_zoned(row, leaf_w, la, lb, s.zone, i + 1, submargin, nk, ea, eb);
      if (lane == 0) {
        s.leaf[la] = ea;
        if (lb >= 0) s.leaf[lb] = eb;
      }
    }
    __syncwarp();
    for (int g = l_lo / G; g <= l_hi / G; ++g) {
      uint32_t bk, bi;
      reduce_group(s.leaf, g, G, bk, bi);
      if (lane == g) {
        gk = bk;
        gi = bi;
      }
    }
  }
  __syncwarp();
  for (int i = lane; i < k_sep; i += 32) {
    const int w = s.zone[i];
    bool supp = false;
    for (int z = 0; z < i; ++z) supp |= abs(w - s.zone[z]) <= submargin;
    store(sep_val, r * k_sep + i, supp ? neg : load(row, w));
    sep_idx[r * k_sep + i] = w;
  }
}

bool g_ready[kMaxDevices][2];
std::mutex g_ready_mutex;  // sessions on several host threads may share a card

template <typename T>
int launch(int slot, const void* rows, const void* level, void* top_val, void* top_idx,
           void* sep_val, void* sep_idx, void* count, int n_rows, int fft, int leaf_w, int top_k,
           int k_sep, int submargin, float neg, cudaStream_t s) {
  const size_t smem = kRowsPerBlock * row_smem_bytes(fft / leaf_w, top_k, k_sep);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  {
    std::lock_guard<std::mutex> lock(g_ready_mutex);
    if (!g_ready[dev][slot]) {  // once per device: no launch sets an attribute
      err = cudaFuncSetAttribute(selection_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)kMaxSmem);
      if (err != cudaSuccess) return (int)err;
      g_ready[dev][slot] = true;
    }
  }
  const int blocks = (n_rows + kRowsPerBlock - 1) / kRowsPerBlock;
  selection_kernel<T><<<blocks, kThreads, smem, s>>>(
      (const T*)rows, (const float*)level, (T*)top_val, (int*)top_idx, (T*)sep_val,
      (int*)sep_idx, (int*)count, n_rows, fft, leaf_w, top_k, k_sep, submargin, neg);
  return (int)cudaGetLastError();
}

}  // namespace

// rows: [n_rows, fft] f32 (is_bf16 = 0) or bf16 (1), 16-byte aligned;
// leaf_w: bins a leaf (ops/cuda/select_kernel.leaf_width: a power of 2 >= 32
// dividing fft into a multiple of 8 leaves, and of 32 above 32 leaves);
// k_sep <= 32 (a lane a zone);
// level: one f32 on the
// device; outputs top_val/sep_val in the row dtype, top_idx/sep_idx/count
// int32. neg: -3.3e38 cast to the row dtype.
extern "C" int fused_selection(const void* rows, int is_bf16, const void* level, void* top_val,
                               void* top_idx, void* sep_val, void* sep_idx, void* count,
                               int n_rows, int fft, int leaf_w, int top_k, int k_sep,
                               int submargin, float neg, void* stream) {
  const int n_leaf = leaf_w > 0 ? fft / leaf_w : 0;
  if (n_rows <= 0 || leaf_w < 32 || (leaf_w & (leaf_w - 1)) != 0 || fft % leaf_w != 0 ||
      n_leaf % kLeavesALoad != 0 || (n_leaf > kGroups && n_leaf % kGroups != 0) ||
      top_k < 1 || top_k > fft || k_sep < 1 || k_sep > 32 ||
      submargin < 0 ||
      ((uintptr_t)rows & 15) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    return launch<__nv_bfloat16>(1, rows, level, top_val, top_idx, sep_val, sep_idx, count,
                                 n_rows, fft, leaf_w, top_k, k_sep, submargin, neg, s);
  }
  return launch<float>(0, rows, level, top_val, top_idx, sep_val, sep_idx, count, n_rows, fft,
                       leaf_w, top_k, k_sep, submargin, neg, s);
}
