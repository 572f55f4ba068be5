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
// chain, so what costs is each winner's latency, not bytes. The design
// (the warp-a-row form, selection_kernel; the row-split form below shares
// its table pass, leaf_table, and its chains):
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
// Rows of at most 128 bins (fft 1-128: narrow channels and bands, 32 kHz
// and less at 250 Hz bins) take a second form, selection_small: a table of
// whole leaves does not fit them (fft 128 is 4 leaves, fft 16 half a lane
// set). A warp owns a row and holds it in registers, bin b in lane b mod 32
// at slot b / 32 (4 slots), so no shared memory is used. A winner is one
// argmax over the lanes' bests (2 redux.sync); top-K takes the winner out
// of the race (a taken bit a slot), the margin phase sets every bin within
// +-submargin of it to the sentinel's key (a zone may cover the whole row,
// and the suppressed bins stay in the race, as the TPU kernel has them).
// Its bound is its latency too: K + K_SEP winners a row, each a few
// register compares and two reductions.
//
// Rows too few to fill the card with a warp each (at most 384 rows of fft
// >= 2^17: the 491.52 Msps block's 16 rows of 2^21 bins, a time shard's 45
// of 131072, a band shard's 180, the wideband step's 360; from 512 rows
// the chain kernel's blocks, ~3 an SM, take two waves and a warp a row
// wins: select_kernel.SPLIT_MAX_ROWS) take the row-split form, two kernels a
// call: selection_table spreads a row's table pass over `slices` warps
// (select_kernel.row_slices: rows x slices ~ 2048 warps, 16 an SM, each
// with 8 16-byte loads in flight, enough to approach 3.35 TB/s), each
// writing its run of leaves to a table in device memory and its partial
// count; selection_chain gives a row a block, whose 8 warps copy the table
// into shared memory and reduce its 32 groups, and whose first warp sums the
// partial counts (integers: exact) and runs the same chains. Its leaves are
// narrow (select_kernel.SPLIT_LEAF_WIDTH: 256 bins, one or two 16-byte
// pieces a lane), so a winner's re-reduction is one round trip with every
// piece in flight where the warp-a-row form's 2048-bin leaves at 2^21 cost
// 64 dependent loads a lane; the table is 64 KB of shared memory at 2^21
// (8192 leaves, 256 a group: 8 shared loads a lane re-reduce a group).
// Above 2^22 (16384 leaves, 128 KB) the leaves widen instead
// (select_kernel.split_leaf_width: 512 bins at 2^23, 1024 at 2^24), since
// 32768 leaves (256 KB) would not fit a block. A leaf is then up to 8
// pieces a lane (f32 rows at 2^24 only): the chains are instantiated for
// kMaxPieces and for twice that, so that the narrow leaves of every other
// shape keep their registers.
// Bound: 16 rows of 2^21 bf16 move 67 MB, 0.020 ms; the chains' 80 winners
// a row are 80 round trips to L2 or device memory (~1 us each), so the
// form's own floor is the chain's latency, ~0.1 ms.
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
constexpr int kSmallMaxFft = 128;  // the register form's rows: 4 slots of 32 lanes
constexpr int kSmallSlots = kSmallMaxFft / 32;
constexpr int kSplitThreads = 256;  // the row-split form's blocks: 8 warps
constexpr int kMaxPieces = 4;  // 16-byte pieces a lane of a row-split leaf (<= 2 KB; twice that in the wide chains)
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

__device__ __forceinline__ RowSmem row_smem(unsigned char* base, int n_leaf, int top_k) {
  RowSmem s;
  s.leaf = reinterpret_cast<uint2*>(base);
  s.log = reinterpret_cast<uint3*>(base + (size_t)n_leaf * 8);
  s.zone = reinterpret_cast<int*>(base + (size_t)n_leaf * 8 + (size_t)top_k * 12);
  return s;
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

// The P = leaf_w / (32 kVec) <= kPieces 16-byte pieces of leaf l that lane
// holds (contiguous: bins l leaf_w + lane P kVec ...), all loads in flight;
// slots past P are left as they are.
template <typename T, int kPieces>
__device__ __forceinline__ void leaf_pieces(const T* row, int leaf_w, int l, uint4* v) {
  constexpr int kVec = 16 / sizeof(T);
  const int P = leaf_w / (32 * kVec);
  const uint4* src = reinterpret_cast<const uint4*>(row + (size_t)l * leaf_w) + (threadIdx.x & 31) * P;
#pragma unroll
  for (int p = 0; p < kPieces; ++p) {
    if (p < P) v[p] = __ldg(src + p);
  }
}

// leaf_after for leaves of whole pieces a lane: one round trip.
template <typename T, int kPieces>
__device__ __forceinline__ void leaf_after_vec(const T* row, int leaf_w, int l, uint32_t ak, uint32_t aw,
                                               uint32_t& bk, uint32_t& bi) {
  constexpr int kVec = 16 / sizeof(T);
  const int P = leaf_w / (32 * kVec);
  const uint32_t b0 = (uint32_t)(l * leaf_w + (threadIdx.x & 31) * P * kVec);
  uint4 v[kPieces];
  leaf_pieces<T, kPieces>(row, leaf_w, l, v);
  bk = kNone;
  bi = 0xffffffffu;
#pragma unroll
  for (int p = 0; p < kPieces; ++p) {
    if (p < P) {
      float f[kVec];
      unpack(v[p], f, row);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const uint32_t b = b0 + p * kVec + e, k = key_of(f[e]);
        if (better(ak, aw, k, b) && better(k, b, bk, bi)) {
          bk = k;
          bi = b;
        }
      }
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

// leaves_zoned for leaves of whole pieces a lane: both leaves' pieces in
// flight together.
template <typename T, int kPieces>
__device__ __forceinline__ void leaves_zoned_vec(const T* row, int leaf_w, int la, int lb, const int* zone, int nz,
                                                 int submargin, uint32_t nk, uint2& ea, uint2& eb) {
  constexpr int kVec = 16 / sizeof(T);
  const int P = leaf_w / (32 * kVec);
  const int la0 = la * leaf_w, lb0 = (lb < 0 ? la : lb) * leaf_w;
  const uint32_t za = zones_reaching(zone, nz, submargin, la0, la0 + leaf_w - 1);
  const uint32_t zb = zones_reaching(zone, nz, submargin, lb0, lb0 + leaf_w - 1);
  const int off = (threadIdx.x & 31) * P * kVec;
  uint4 va[kPieces], vb[kPieces];
  leaf_pieces<T, kPieces>(row, leaf_w, la, va);
  leaf_pieces<T, kPieces>(row, leaf_w, lb < 0 ? la : lb, vb);
  uint32_t ka = kNone, ia = 0xffffffffu, kb = kNone, ib = 0xffffffffu;
#pragma unroll
  for (int p = 0; p < kPieces; ++p) {
    if (p < P) {
      float fa[kVec], fb[kVec];
      unpack(va[p], fa, row);
      unpack(vb[p], fb, row);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const int ba = la0 + off + p * kVec + e, bb = lb0 + off + p * kVec + e;
        bool sa = false, sb = false;
        for (uint32_t m = za; m; m &= m - 1) sa |= abs(ba - zone[__ffs(m) - 1]) <= submargin;
        for (uint32_t m = zb; m; m &= m - 1) sb |= abs(bb - zone[__ffs(m) - 1]) <= submargin;
        const uint32_t kva = sa ? nk : key_of(fa[e]), kvb = sb ? nk : key_of(fb[e]);
        if (better(kva, (uint32_t)ba, ka, ia)) {
          ka = kva;
          ia = (uint32_t)ba;
        }
        if (better(kvb, (uint32_t)bb, kb, ib)) {
          kb = kvb;
          ib = (uint32_t)bb;
        }
      }
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

// The leaf table of leaves [l0, l0 + n) of a row (n a multiple of 8) and
// the lane's count of bins >= lev over them: one pass, 16-byte loads. A leaf
// is P = leaf_w / kVec 16-byte pieces; one warp load takes 4 pieces (64
// contiguous bytes) of each of 8 leaves, so a leaf is reduced after P / 4
// loads, by 2 shuffles among its 4 lanes. Leaf l's (key, bin) goes to
// leaf[l]; bins are the row's.
template <typename T>
__device__ __forceinline__ uint32_t leaf_table(const T* row, int leaf_w, int l0, int n, float lev, uint2* leaf) {
  const int lane = threadIdx.x & 31;
  constexpr int kVec = 16 / sizeof(T);
  const int pieces = leaf_w / kVec;
  const int steps = pieces / 4;                // loads a leaf takes, a power of 2
  const int log_steps = __ffs(steps) - 1;
  const int n_loads = n / kLeavesALoad * steps;  // loads a lane
  const uint4* src = reinterpret_cast<const uint4*>(row) + (size_t)(l0 + (lane >> 2)) * pieces + (lane & 3);
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
      const int l = l0 + (q >> log_steps) * 8 + (lane >> 2);
      const uint32_t b = (uint32_t)(((size_t)l * pieces + (q & (steps - 1)) * 4 + (lane & 3)) * kVec + first);
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
        if ((lane & 3) == 0) leaf[l] = make_uint2(rk, ri);
        rk = kNone;
        ri = 0xffffffffu;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) cur[u] = nxt[u];
  }
  return cnt;
}

// The two chains of one row, run by one warp on its table: the exact top-K,
// then the margin-separated greedy, and their outputs. gk, gi: lane g's
// group g (G leaves a group; the key no bin has where the lane has none).
// kVecLeaves: a leaf's re-reduction reads whole 16-byte pieces, all in flight
// (the row-split form's leaves, >= 32 pieces, at most kPieces a lane); else
// a bin a load.
template <typename T, bool kVecLeaves, int kPieces = kMaxPieces>
__device__ __forceinline__ void chains(const T* row, const RowSmem& s, long long r, int fft, int leaf_w, int G,
                                       uint32_t gk, uint32_t gi, int top_k, int k_sep, int submargin, float neg,
                                       T* __restrict__ top_val, int* __restrict__ top_idx, T* __restrict__ sep_val,
                                       int* __restrict__ sep_idx) {
  const int lane = threadIdx.x & 31;
  const uint32_t nk = key_of(neg);
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
    if constexpr (kVecLeaves) {
      leaf_after_vec<T, kPieces>(row, leaf_w, l, wk, w, lk, li);
    } else {
      leaf_after(row, leaf_w, l, wk, w, lk, li);
    }
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
      if constexpr (kVecLeaves) {
        leaves_zoned_vec<T, kPieces>(row, leaf_w, la, lb, s.zone, i + 1, submargin, nk, ea, eb);
      } else {
        leaves_zoned(row, leaf_w, la, lb, s.zone, i + 1, submargin, nk, ea, eb);
      }
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

// The warp-a-row form: one warp builds its row's table in its shared memory
// and runs the chains; kRowsPerBlock rows a block.
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
  const RowSmem s = row_smem(smem + (size_t)warp * row_smem_bytes(n_leaf, top_k, k_sep), n_leaf, top_k);
  const T* row = rows + r * fft;
  const uint32_t cnt = __reduce_add_sync(kFull, leaf_table(row, leaf_w, 0, n_leaf, to_row_dtype(*level, rows),
                                                           s.leaf));
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
  chains<T, false>(row, s, r, fft, leaf_w, G, gk, gi, top_k, k_sep, submargin, neg, top_val, top_idx, sep_val,
                   sep_idx);
}

// The row-split form, kernel 1: block (x, r) of 32 * (warps a block) threads;
// warp w of row r (w = x * warps a block + warp, of `slices`) builds the
// leaves [w n, (w + 1) n) of its row (n = n_leaf / slices) into
// table[r][...] and writes its count of bins >= level to part_count[r][w].
template <typename T>
__global__ void __launch_bounds__(kSplitThreads)
selection_table(const T* __restrict__ rows, const float* __restrict__ level, uint2* __restrict__ table,
                int* __restrict__ part_count, int fft, int leaf_w, int slices) {
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const long long r = blockIdx.y;
  const int n_leaf = fft / leaf_w, n = n_leaf / slices;
  const float lev = to_row_dtype(*level, rows);
  const uint32_t cnt = leaf_table(rows + r * fft, leaf_w, w * n, n, lev, table + r * n_leaf);
  const uint32_t total = __reduce_add_sync(kFull, cnt);
  if (lane == 0) part_count[r * slices + w] = (int)total;
}

// The row-split form, kernel 2: one block of kSplitThreads a row. Its warps
// copy the row's table into shared memory and reduce its 32 groups; warp 0
// sums the partial counts and runs the chains (leaves of at most kPieces
// pieces a lane).
template <typename T, int kPieces>
__global__ void __launch_bounds__(kSplitThreads)
selection_chain(const T* __restrict__ rows, const uint2* __restrict__ table, const int* __restrict__ part_count,
                T* __restrict__ top_val, int* __restrict__ top_idx, T* __restrict__ sep_val,
                int* __restrict__ sep_idx, int* __restrict__ count, int fft, int leaf_w, int slices, int top_k,
                int k_sep, int submargin, float neg) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long r = blockIdx.x;
  const int n_leaf = fft / leaf_w, G = n_leaf / kGroups;  // the form takes whole groups
  const RowSmem s = row_smem(smem, n_leaf, top_k);
  uint2* group = reinterpret_cast<uint2*>(smem + row_smem_bytes(n_leaf, top_k, k_sep));  // [kGroups]
  for (int l = threadIdx.x; l < n_leaf; l += blockDim.x) s.leaf[l] = table[r * n_leaf + l];
  __syncthreads();
  for (int g = warp; g < kGroups; g += blockDim.x >> 5) {
    uint32_t bk, bi;
    reduce_group(s.leaf, g, G, bk, bi);
    if (lane == 0) group[g] = make_uint2(bk, bi);
  }
  __syncthreads();
  if (warp != 0) return;  // the chains are one warp's: nothing below synchronises the block
  uint32_t cnt = 0;
  for (int i = lane; i < slices; i += 32) cnt += (uint32_t)part_count[r * slices + i];
  cnt = __reduce_add_sync(kFull, cnt);
  if (lane == 0) count[r] = (int)cnt;
  const uint2 e = group[lane];
  chains<T, true, kPieces>(rows + r * fft, s, r, fft, leaf_w, G, e.x, e.y, top_k, k_sep, submargin, neg, top_val,
                           top_idx, sep_val, sep_idx);
}

// The register form, rows of fft <= 128 bins: lane l holds bins l + 32 e
// (e < kSmallSlots) of its warp's row; a bin past the row is out of both
// races. Slots are indexed by unrolled loops only (register arrays).
template <typename T>
__global__ void __launch_bounds__(kThreads)
selection_small(const T* __restrict__ rows, const float* __restrict__ level,
                T* __restrict__ top_val, int* __restrict__ top_idx, T* __restrict__ sep_val,
                int* __restrict__ sep_idx, int* __restrict__ count, int n_rows, int fft, int top_k,
                int k_sep, int submargin, float neg) {
  const int lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (r >= n_rows) return;  // whole warps only
  const T* row = rows + r * fft;
  const float lev = to_row_dtype(*level, rows);
  const uint32_t nk = key_of(neg);
  float v[kSmallSlots];
  uint32_t key[kSmallSlots];
  uint32_t live = 0, cnt = 0;  // live: a bit a slot inside the row
#pragma unroll
  for (int e = 0; e < kSmallSlots; ++e) {
    const int b = lane + 32 * e;
    v[e] = b < fft ? load(row, b) : 0.0f;
    key[e] = key_of(v[e]);
    if (b < fft) {
      live |= 1u << e;
      cnt += v[e] >= lev;
    }
  }
  cnt = __reduce_add_sync(kFull, cnt);
  if (lane == 0) count[r] = (int)cnt;

  // ---- phase 1: exact top-K; a winner leaves the race (K <= fft: a bin is left)
  uint32_t racing = live;
  for (int i = 0; i < top_k; ++i) {
    uint32_t bk = kNone, bi = 0xffffffffu;
#pragma unroll
    for (int e = 0; e < kSmallSlots; ++e) {
      const uint32_t b = (uint32_t)(lane + 32 * e);
      if (((racing >> e) & 1u) && better(key[e], b, bk, bi)) {
        bk = key[e];
        bi = b;
      }
    }
    warp_best(bk, bi);
    if ((int)(bi & 31u) == lane) {
#pragma unroll
      for (int e = 0; e < kSmallSlots; ++e) {
        if ((int)(bi >> 5) == e) {
          racing &= ~(1u << e);
          store(top_val, r * top_k + i, v[e]);
        }
      }
      top_idx[r * top_k + i] = (int)bi;
    }
  }

  // ---- phase 2: margin-separated greedy; a zone's bins compare as the sentinel
  uint32_t supp = 0;
  for (int i = 0; i < k_sep; ++i) {
    uint32_t bk = kNone, bi = 0xffffffffu;
#pragma unroll
    for (int e = 0; e < kSmallSlots; ++e) {
      const uint32_t b = (uint32_t)(lane + 32 * e);
      const uint32_t k = ((supp >> e) & 1u) ? nk : key[e];
      if (((live >> e) & 1u) && better(k, b, bk, bi)) {
        bk = k;
        bi = b;
      }
    }
    warp_best(bk, bi);
    if ((int)(bi & 31u) == lane) {
#pragma unroll
      for (int e = 0; e < kSmallSlots; ++e) {
        if ((int)(bi >> 5) == e) store(sep_val, r * k_sep + i, ((supp >> e) & 1u) ? neg : v[e]);
      }
      sep_idx[r * k_sep + i] = (int)bi;
    }
#pragma unroll
    for (int e = 0; e < kSmallSlots; ++e) {
      if (abs(lane + 32 * e - (int)bi) <= submargin) supp |= 1u << e;
    }
  }
}

bool g_ready[kMaxDevices][6];  // [device][slot]: (warp-a-row, row-split chains, wide chains) x (f32, bf16)
std::mutex g_ready_mutex;  // sessions on several host threads may share a card

// Once per device, under the mutex: kernel fn may take all of a block's
// shared memory (no launch sets an attribute).
cudaError_t ready(int slot, const void* fn) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(g_ready_mutex);
  if (!g_ready[dev][slot]) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
    if (err != cudaSuccess) return err;
    g_ready[dev][slot] = true;
  }
  return cudaSuccess;
}

template <typename T>
int launch(int slot, const void* rows, const void* level, void* top_val, void* top_idx,
           void* sep_val, void* sep_idx, void* count, int n_rows, int fft, int leaf_w, int top_k,
           int k_sep, int submargin, float neg, cudaStream_t s) {
  const size_t smem = kRowsPerBlock * row_smem_bytes(fft / leaf_w, top_k, k_sep);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const cudaError_t err = ready(slot, reinterpret_cast<const void*>(selection_kernel<T>));
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n_rows + kRowsPerBlock - 1) / kRowsPerBlock;
  selection_kernel<T><<<blocks, kThreads, smem, s>>>(
      (const T*)rows, (const float*)level, (T*)top_val, (int*)top_idx, (T*)sep_val,
      (int*)sep_idx, (int*)count, n_rows, fft, leaf_w, top_k, k_sep, submargin, neg);
  return (int)cudaGetLastError();
}

// The row-split form: its two kernels, back to back on the stream.
template <typename T>
int launch_split(int slot, const void* rows, const void* level, void* top_val, void* top_idx,
                 void* sep_val, void* sep_idx, void* count, int n_rows, int fft, int leaf_w, int top_k,
                 int k_sep, int submargin, float neg, int slices, void* table, void* part_count,
                 cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const int n_leaf = fft / leaf_w, pieces = leaf_w / (32 * kVec);
  const size_t smem = row_smem_bytes(n_leaf, top_k, k_sep) + kGroups * sizeof(uint2);
  if (n_leaf % kGroups != 0 || pieces < 1 || pieces > 2 * kMaxPieces || pieces * 32 * kVec != leaf_w ||
      (n_leaf / kLeavesALoad) % slices != 0 || smem > kMaxSmem || n_rows > 65535 || table == nullptr ||
      part_count == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const bool wide = pieces > kMaxPieces;  // f32 rows of 2^24: 1024-bin leaves, 8 pieces a lane
  const cudaError_t err = wide ? ready(4 + slot, reinterpret_cast<const void*>(selection_chain<T, 2 * kMaxPieces>))
                               : ready(2 + slot, reinterpret_cast<const void*>(selection_chain<T, kMaxPieces>));
  if (err != cudaSuccess) return (int)err;
  const int warps = slices < kSplitThreads / 32 ? slices : kSplitThreads / 32;  // a block
  selection_table<T><<<dim3(slices / warps, n_rows), 32 * warps, 0, s>>>(
      (const T*)rows, (const float*)level, (uint2*)table, (int*)part_count, fft, leaf_w, slices);
  if (wide) {
    selection_chain<T, 2 * kMaxPieces><<<n_rows, kSplitThreads, smem, s>>>(
        (const T*)rows, (const uint2*)table, (const int*)part_count, (T*)top_val, (int*)top_idx, (T*)sep_val,
        (int*)sep_idx, (int*)count, fft, leaf_w, slices, top_k, k_sep, submargin, neg);
  } else {
    selection_chain<T, kMaxPieces><<<n_rows, kSplitThreads, smem, s>>>(
        (const T*)rows, (const uint2*)table, (const int*)part_count, (T*)top_val, (int*)top_idx, (T*)sep_val,
        (int*)sep_idx, (int*)count, fft, leaf_w, slices, top_k, k_sep, submargin, neg);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// rows: [n_rows, fft] f32 (is_bf16 = 0) or bf16 (1), 16-byte aligned;
// fft <= 128 takes the register form (leaf_w unused); above, slices = 0
// takes the warp-a-row form, leaf_w bins a leaf
// (ops/cuda/select_kernel.leaf_width: a power of 2 >= 32 dividing fft into a
// multiple of 8 leaves, and of 32 above 32 leaves); slices > 0 (a power of
// 2; select_kernel.row_slices, from the rows and the fft) the row-split form:
// slices warps build a row's table, leaf_w = select_kernel.split_leaf_width
// (whole 16-byte pieces a lane, whole groups), table [n_rows, fft / leaf_w]
// of 8 bytes and part_count [n_rows, slices] int32 its scratch;
// k_sep <= 32 (a lane a zone);
// level: one f32 on the
// device; outputs top_val/sep_val in the row dtype, top_idx/sep_idx/count
// int32. neg: -3.3e38 cast to the row dtype.
extern "C" int fused_selection(const void* rows, int is_bf16, const void* level, void* top_val,
                               void* top_idx, void* sep_val, void* sep_idx, void* count,
                               int n_rows, int fft, int leaf_w, int top_k, int k_sep,
                               int submargin, float neg, int slices, void* table, void* part_count,
                               void* stream) {
  if (n_rows <= 0 || fft < 1 || top_k < 1 || top_k > fft || k_sep < 1 || k_sep > 32 ||
      submargin < 0 || ((uintptr_t)rows & 15) != 0 || slices < 0 || (slices & (slices - 1)) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (fft <= kSmallMaxFft) {
    const int blocks = (n_rows + kRowsPerBlock - 1) / kRowsPerBlock;
    if (is_bf16) {
      selection_small<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
          (const __nv_bfloat16*)rows, (const float*)level, (__nv_bfloat16*)top_val, (int*)top_idx,
          (__nv_bfloat16*)sep_val, (int*)sep_idx, (int*)count, n_rows, fft, top_k, k_sep, submargin,
          neg);
    } else {
      selection_small<float><<<blocks, kThreads, 0, s>>>(
          (const float*)rows, (const float*)level, (float*)top_val, (int*)top_idx, (float*)sep_val,
          (int*)sep_idx, (int*)count, n_rows, fft, top_k, k_sep, submargin, neg);
    }
    return (int)cudaGetLastError();
  }
  const int n_leaf = leaf_w > 0 ? fft / leaf_w : 0;
  if (leaf_w < 32 || (leaf_w & (leaf_w - 1)) != 0 || fft % leaf_w != 0 ||
      n_leaf % kLeavesALoad != 0 || (n_leaf > kGroups && n_leaf % kGroups != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  if (slices > 0 && is_bf16) {
    return launch_split<__nv_bfloat16>(1, rows, level, top_val, top_idx, sep_val, sep_idx, count, n_rows, fft,
                                       leaf_w, top_k, k_sep, submargin, neg, slices, table, part_count, s);
  }
  if (slices > 0) {
    return launch_split<float>(0, rows, level, top_val, top_idx, sep_val, sep_idx, count, n_rows, fft, leaf_w,
                               top_k, k_sep, submargin, neg, slices, table, part_count, s);
  }
  if (is_bf16) {
    return launch<__nv_bfloat16>(1, rows, level, top_val, top_idx, sep_val, sep_idx, count,
                                 n_rows, fft, leaf_w, top_k, k_sep, submargin, neg, s);
  }
  return launch<float>(0, rows, level, top_val, top_idx, sep_val, sep_idx, count, n_rows, fft,
                       leaf_w, top_k, k_sep, submargin, neg, s);
}
