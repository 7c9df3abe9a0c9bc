// Per-row t-digest quantiles: sort, prefix sum, midpoint interpolation.
//
// Replaces the Pallas kernel veneur_tpu/ops/pallas_digest.py
// quantiles_rows (_quantile_kernel, _bitonic_sort_pairs,
// _prefix_sum_last). For each digest row of C (mean, weight) cells:
// sort live cells by mean (an empty cell gets key +inf and weight 0),
// take the inclusive prefix sum of the weights, and interpolate each
// requested quantile between centroid-mass midpoints with the row's
// min/max as endpoints. Empty cells collapse onto (total, max); t >= total
// gives max; an empty row gives NaN.
//
// What bounds it on an H100: bytes. A row is 8 bytes a cell read once
// (472 cells at the production layout, ~3.8 KB), so 131,072 rows are
// ~0.5 GB, ~0.15 ms of HBM time. The rows a flush really hands over are
// nearly empty (most keys hold a few samples in 472 cells), so the sort
// must cost what the live cells need, not what C needs. Rows of more
// than ~64 live cells make the sort the larger term: it is then bound by
// the integer pipe (a 64-bit compare-exchange is two ISETP and two to
// four SEL, at half the FP32 issue rate), ~0.9 ms for 131,072 rows of
// 257-512 live cells (PERF.md).
//
// Design: one warp per row, four rows to a 128-thread block, no block
// barrier anywhere.
// - Load: 16-byte loads of mean and weight (scalar loads when C is not a
//   multiple of 4 or a base is not 16-byte aligned), four chunks in flight
//   before any is used. `weight > 0` marks a live cell; __ballot_sync and
//   __popc compact the live cells in position order into the warp's slice
//   of shared memory: one 64-bit key per live cell (order-preserving bits
//   of the mean high, the live cell's rank low) and its weight beside it.
//   The rank is monotone in the cell index, so sorting the keys is the
//   plain version's stable sort with ties broken by cell index.
// - Sort n live keys, not C cells: n <= 32 is one key a lane, bitonic by
//   __shfl_xor_sync over the next power of two only (a 4-cell row is three
//   shuffle stages); n <= 512 is n_pad/32 keys a lane in registers, in a
//   blocked order (lane L holds ranks L*KPL..), so the stages below KPL are
//   register compare-exchanges and only the others shuffle; larger rows
//   (C > 512) sort in the warp's shared slice under __syncwarp.
// - Prefix sum: each lane adds its contiguous keys' weights, a
//   __shfl_up_sync scan finishes it. Breakpoints (xs = mid-mass, ys = mean)
//   go to shared memory, swizzled so the blocked stores do not conflict.
// - Quantiles: xs is non-decreasing, so searchsorted(xs, t, right=True) is
//   the count of xs <= t: one __reduce_add_sync over the lanes' counts.
// - A live mean of +inf or NaN ties with (or sorts past) the empty cells,
//   and the plain version's xs is then not monotone, so its binary search's
//   answer depends on where the empties sit. Such a row is re-staged in the
//   plain version's all-cells order (every cell, empties keyed +inf) and
//   searched with the same upper_bound loop as torch.searchsorted.
// - Rows wider than 2,048 cells (compression past ~1,278) take a second
//   kernel. A warp's staging is 12 bytes a cell, so four warps of a
//   2,056-cell row already need 160 KB of shared memory, and one warp of
//   a 3,928-cell row 48 KB: at most four warps an SM, too few to cover
//   the loads' latency, and nothing past ~16,000 cells. So every wide row
//   stages in global scratch instead, one slab a warp (cp * 8 + C * 4
//   bytes, which the wrapper allocates), through the same code: the
//   slab is in L1/L2 while the warp works on it. A fixed grid of 2,112
//   warps (fewer if the slabs would pass 256 MB) walks the rows, so the
//   scratch does not grow with the row count. One path serves every
//   width up to 2^30 cells, where the key slots stop fitting an int.
// The TPU's row tiles and its full-width bitonic network are not carried
// over: they exist for the TPU's static vector addressing.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 4;          // rows (warps) per block
constexpr int REG_MAX = 512;      // largest sort kept in registers
constexpr u64 PAD = ~0ull;        // sorts after every real key
constexpr int SMEM_CELLS = 2048;  // widest row staged in shared memory
constexpr int MAX_CELLS = 1 << 30;        // key slots stay a 32-bit int
constexpr long long kWideWarps = 132 * 16;  // the wide kernel's grid
constexpr long long kScratchBytes = 256LL << 20;  // and its slabs' cap

// order-preserving bits of a mean: every NaN is one value above +inf (as
// torch.sort orders them), -0 equals +0
__device__ __forceinline__ unsigned mean_bits(float m) {
  unsigned b = __float_as_uint(m);
  if (m != m) b = 0x7fc00000u;
  if (b == 0x80000000u) b = 0u;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float bits_mean(unsigned h) {
  return __uint_as_float((h & 0x80000000u) ? (h & 0x7fffffffu) : ~h);
}

// Stage one row into the warp's slice. ALL=false: live cells compacted in
// position order, low word = live rank; returns n, sets *special when a
// live mean is +inf or NaN. ALL=true: every cell at its own index, empties
// keyed +inf with weight 0; returns C.
template <int V, bool ALL>
__device__ int stage_row(const float* __restrict__ mrow,
                         const float* __restrict__ wrow, int C, int lane,
                         u64* keys, float* wst, bool* special) {
  constexpr int G = V == 4 ? 4 : 8;   // chunks loaded before any is used
  const unsigned lt = (1u << lane) - 1u;
  int n = 0;
  bool spec = false;
  for (int b = 0; b < C; b += 32 * V * G) {
    float m[G][V], w[G][V];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int c0 = b + (g * 32 + lane) * V;
      if constexpr (V == 4) {
        float4 mv = make_float4(0.f, 0.f, 0.f, 0.f), wv = mv;
        if (c0 < C) {
          mv = *reinterpret_cast<const float4*>(mrow + c0);
          wv = *reinterpret_cast<const float4*>(wrow + c0);
        }
        m[g][0] = mv.x; m[g][1] = mv.y; m[g][2] = mv.z; m[g][3] = mv.w;
        w[g][0] = wv.x; w[g][1] = wv.y; w[g][2] = wv.z; w[g][3] = wv.w;
      } else {
        m[g][0] = c0 < C ? mrow[c0] : 0.f;
        w[g][0] = c0 < C ? wrow[c0] : 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int c0 = b + (g * 32 + lane) * V;
      bool live[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        live[v] = c0 + v < C && w[g][v] > 0.f;
        spec |= live[v] && !(m[g][v] < INFINITY);
      }
      if constexpr (ALL) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const int c = c0 + v;
          if (c < C) {
            const unsigned hi = mean_bits(live[v] ? m[g][v] : INFINITY);
            keys[c] = ((u64)hi << 32) | (unsigned)c;
            wst[c] = live[v] ? w[g][v] : 0.f;
          }
        }
      } else {
        unsigned bal[V];
        int pos = n;
#pragma unroll
        for (int v = 0; v < V; ++v) {
          bal[v] = __ballot_sync(FULL, live[v]);
          pos += __popc(bal[v] & lt);
        }
#pragma unroll
        for (int v = 0; v < V; ++v) {
          if (live[v]) {
            keys[pos] = ((u64)mean_bits(m[g][v]) << 32) | (unsigned)pos;
            wst[pos] = w[g][v];
            ++pos;
          }
          n += __popc(bal[v]);
        }
      }
    }
  }
  *special = __any_sync(FULL, spec);
  return ALL ? C : n;
}

// physical slot of breakpoint p: blocks of `per` (a power of two) ranks
// are XOR-swizzled so that lane L's stores of rank L*per + r spread over
// the banks
__device__ __forceinline__ int slot(int p, int per) {
  return p ^ ((p / per) & (per - 1));
}

// torch.searchsorted(xs, t, right=True) as ATen writes it, over n entries
__device__ int upper_bound_xs(const float2* xy, int n, int per, float t) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (!(xy[slot(mid, per)].x > t)) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// the plain version's interpolation, op for op (no contraction): X = [0,
// xs..., tot], Y = [min, ys..., max], k = searchsorted index into xs
__device__ __forceinline__ float interp(const float2* xy, int n, int per,
                                        int k, float t, float tot, float mnv,
                                        float mxv) {
  float x0 = 0.f, y0 = mnv, x1 = tot, y1 = mxv;
  if (k > 0) {
    const float2 a = xy[slot(k - 1, per)];
    x0 = a.x;
    y0 = a.y;
  }
  if (k < n) {
    const float2 a = xy[slot(k, per)];
    x1 = a.x;
    y1 = a.y;
  }
  float dx = __fsub_rn(x1, x0);
  dx = dx < 1e-30f ? 1e-30f : dx;
  const float slope = __fdiv_rn(__fsub_rn(y1, y0), dx);
  return __fadd_rn(y0, __fmul_rn(__fsub_rn(t, x0), slope));
}

// Every quantile of the row: all lanes find each quantile's interval
// together (count_le: the warp's count of xs <= t, or < 0 for the binary
// search), lane q % 32 keeps the result, and up to 32 results are stored
// at once.
template <class CountLe>
__device__ void emit(CountLe count_le, const float2* xy, int n, int per,
                     float tot, float mnv, float mxv,
                     const float* __restrict__ qs, float* orow, int Q,
                     int lane) {
  for (int q0 = 0; q0 < Q; q0 += 32) {
    const int qn = min(32, Q - q0);
    float mine = 0.f;
    for (int qq = 0; qq < qn; ++qq) {
      const float t = __fmul_rn(qs[q0 + qq], tot);
      float res;
      if (!(tot > 0.f)) {
        res = NAN;
      } else if (!(t < tot)) {
        res = mxv;
      } else {
        int k = count_le(t);
        if (k < 0) k = upper_bound_xs(xy, n, per, t);
        res = interp(xy, n, per, k, t, tot, mnv, mxv);
      }
      if (lane == qq) mine = res;
    }
    if (lane < qn) orow[q0 + lane] = mine;
  }
}

// Inclusive warp scan of one value a lane.
__device__ __forceinline__ float warp_scan(float s, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float up = __shfl_up_sync(FULL, s, d);
    if (lane >= d) s += up;
  }
  return s;
}

// One stage (k, j) of an ascending bitonic sort over ranks L*KPL + r:
// pairs j >= KPL apart are in other lanes (register r to r), closer ones
// inside the lane.
template <int KPL>
__device__ __forceinline__ void bitonic_stage(u64 (&a)[KPL], int k, int j,
                                              int lane) {
  // one 64-bit compare and two selects a key or pair
  if (KPL == 1 || j >= KPL) {
    const int lj = j / KPL;
    const bool keep_min = ((lane & lj) == 0) == (((lane * KPL) & k) == 0);
#pragma unroll
    for (int r = 0; r < KPL; ++r) {
      const u64 o = __shfl_xor_sync(FULL, a[r], lj);
      a[r] = (o < a[r]) == keep_min ? o : a[r];
    }
  } else {
#pragma unroll
    for (int r = 0; r < KPL; ++r) {
      if ((r & j) == 0) {
        const bool asc = ((lane * KPL + r) & k) == 0;
        const u64 x = a[r], y = a[r | j];
        const bool swap = (y < x) == asc;
        a[r] = swap ? y : x;
        a[r | j] = swap ? x : y;
      }
    }
  }
}

// Rows of n <= 32 * KPL keys, sorted in registers. KPL == 1 sorts over
// the next power of two >= n only; lanes past it hold PAD.
template <int KPL>
__device__ void row_in_registers(u64* keys, const float* wst, int n,
                                 bool special, float mnv, float mxv,
                                 const float* __restrict__ qs, float* orow,
                                 int Q, int lane) {
  u64 a[KPL];
  // any assignment of keys to ranks will do before the sort: read them
  // conflict-free, rank L*KPL + r sorts into lane L's register r
#pragma unroll
  for (int r = 0; r < KPL; ++r) {
    const int i = r * 32 + lane;
    a[r] = i < n ? keys[i] : PAD;
  }
  __syncwarp();                      // the slice is rewritten below
  if constexpr (KPL == 1) {
    int np = 1;
    while (np < n) np <<= 1;
    for (int k = 2; k <= np; k <<= 1)
      for (int j = k >> 1; j > 0; j >>= 1) bitonic_stage<1>(a, k, j, lane);
  } else {
    // unrolled, so that every register index is a constant
    constexpr int LOG_NP = KPL == 2 ? 6 : KPL == 4 ? 7 : KPL == 8 ? 8 : 9;
#pragma unroll
    for (int lk = 1; lk <= LOG_NP; ++lk)
#pragma unroll
      for (int lj = lk - 1; lj >= 0; --lj)
        bitonic_stage<KPL>(a, 1 << lk, 1 << lj, lane);
  }
  // prefix sum over the lane's contiguous ranks, then across lanes
  float w[KPL];
  float s = 0.f;
#pragma unroll
  for (int r = 0; r < KPL; ++r) {
    w[r] = a[r] == PAD ? 0.f : wst[(unsigned)a[r]];
    s += w[r];
  }
  const float incl = warp_scan(s, lane);
  const float tot = __shfl_sync(FULL, incl, 31);
  float cum = __shfl_up_sync(FULL, incl, 1);
  if (lane == 0) cum = 0.f;
  float2* xy = reinterpret_cast<float2*>(keys);
  float xs[KPL];
#pragma unroll
  for (int r = 0; r < KPL; ++r) {
    cum += w[r];
    const bool occ = w[r] > 0.f;
    xs[r] = occ ? cum - 0.5f * w[r] : tot;
    const float ys = occ ? bits_mean((unsigned)(a[r] >> 32)) : mxv;
    xy[slot(lane * KPL + r, KPL)] = make_float2(xs[r], ys);
  }
  __syncwarp();
  auto count_le = [&](float t) {
    if (special) return -1;
    int c = 0;
#pragma unroll
    for (int r = 0; r < KPL; ++r) c += xs[r] <= t;
    return (int)__reduce_add_sync(FULL, (unsigned)c);
  };
  emit(count_le, xy, n, KPL, tot, mnv, mxv, qs, orow, Q, lane);
}

// Rows of more than 512 keys (C > 512): bitonic over the warp's staging
// slice (shared memory, or the wide kernel's slab), n_pad/2 pairs a
// stage, __syncwarp between stages.
__device__ void row_in_shared(u64* keys, const float* wst, int n,
                              float mnv, float mxv,
                              const float* __restrict__ qs, float* orow,
                              int Q, int lane) {
  int np = 32;
  while (np < n) np <<= 1;
  for (int i = n + lane; i < np; i += 32) keys[i] = PAD;
  __syncwarp();
  for (int k = 2; k <= np; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = lane; i < np / 2; i += 32) {
        const int lo = ((i & ~(j - 1)) << 1) | (i & (j - 1));
        const u64 x = keys[lo], y = keys[lo + j];
        if ((x > y) == ((lo & k) == 0)) {
          keys[lo] = y;
          keys[lo + j] = x;
        }
      }
      __syncwarp();
    }
  }
  const int per = np / 32;
  const int p0 = lane * per;
  float s = 0.f;
  for (int e = 0; e < per; ++e) {
    const u64 key = keys[p0 + e];
    s += key == PAD ? 0.f : wst[(unsigned)key];
  }
  const float incl = warp_scan(s, lane);
  const float tot = __shfl_sync(FULL, incl, 31);
  float cum = __shfl_up_sync(FULL, incl, 1);
  if (lane == 0) cum = 0.f;
  float2* xy = reinterpret_cast<float2*>(keys);
  for (int e = 0; e < per; ++e) {    // in place: rank p0 + e is this lane's
    const u64 key = keys[p0 + e];
    const float w = key == PAD ? 0.f : wst[(unsigned)key];
    cum += w;
    const bool occ = w > 0.f;
    xy[p0 + e] = make_float2(occ ? cum - 0.5f * w : tot,
                             occ ? bits_mean((unsigned)(key >> 32)) : mxv);
  }
  __syncwarp();
  emit([](float) { return -1; }, xy, n, 1, tot, mnv, mxv, qs, orow, Q, lane);
}

// One row, by one warp, staged in keys/wst (shared memory in the fast
// kernel, the warp's global slab in the wide one).
template <int V>
__device__ __forceinline__ void quantile_row(
    const float* __restrict__ mrow, const float* __restrict__ wrow, int C,
    float mnv, float mxv, const float* __restrict__ qs, float* orow, int Q,
    int lane, u64* keys, float* wst) {
  bool special;
  int n = stage_row<V, false>(mrow, wrow, C, lane, keys, wst, &special);
  if (special) {
    __syncwarp();
    n = stage_row<V, true>(mrow, wrow, C, lane, keys, wst, &special);
  }
  __syncwarp();
  if (n == 0) {
    for (int q = lane; q < Q; q += 32) orow[q] = NAN;
    return;
  }
  if (n <= 32)
    row_in_registers<1>(keys, wst, n, special, mnv, mxv, qs, orow, Q, lane);
  else if (n <= 64)
    row_in_registers<2>(keys, wst, n, special, mnv, mxv, qs, orow, Q, lane);
  else if (n <= 128)
    row_in_registers<4>(keys, wst, n, special, mnv, mxv, qs, orow, Q, lane);
  else if (n <= 256)
    row_in_registers<8>(keys, wst, n, special, mnv, mxv, qs, orow, Q, lane);
  else if (n <= REG_MAX)
    row_in_registers<16>(keys, wst, n, special, mnv, mxv, qs, orow, Q, lane);
  else
    row_in_shared(keys, wst, n, mnv, mxv, qs, orow, Q, lane);
}

// Bytes of one warp's staging: cp 64-bit key slots (a power of two >= C),
// then C weights rounded up to an even count.
__host__ __device__ inline size_t warp_bytes(int C, int cp) {
  return (size_t)cp * 8 + (size_t)((C + 1) & ~1) * 4;
}

template <int V>
__global__ void __launch_bounds__(32 * WARPS)
digest_quantiles_kernel(const float* __restrict__ mean,
                        const float* __restrict__ weight,
                        const float* __restrict__ mn,
                        const float* __restrict__ mx,
                        const float* __restrict__ qs,
                        float* __restrict__ out, long long rows, int C,
                        int cp, int Q) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long r = (long long)blockIdx.x * WARPS + warp;
  if (r >= rows) return;
  u64* keys = reinterpret_cast<u64*>(smem + (size_t)warp * warp_bytes(C, cp));
  float* wst = reinterpret_cast<float*>(keys + cp);
  quantile_row<V>(mean + r * C, weight + r * C, C, mn[r], mx[r], qs,
                  out + r * Q, Q, lane, keys, wst);
}

// Rows wider than SMEM_CELLS: a fixed grid of warps, each staging in its
// own slab of `scratch` (generic loads and stores, which __syncwarp orders
// within the warp as it orders shared memory), walks rows gw, gw + warps,
// ...
template <int V>
__global__ void __launch_bounds__(32 * WARPS)
digest_quantiles_wide_kernel(const float* __restrict__ mean,
                             const float* __restrict__ weight,
                             const float* __restrict__ mn,
                             const float* __restrict__ mx,
                             const float* __restrict__ qs,
                             float* __restrict__ out, long long rows, int C,
                             int cp, int Q, unsigned char* scratch) {
  const int lane = threadIdx.x & 31;
  const long long gw = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const long long warps = (long long)gridDim.x * WARPS;
  u64* keys = reinterpret_cast<u64*>(scratch + gw * warp_bytes(C, cp));
  float* wst = reinterpret_cast<float*>(keys + cp);
  for (long long r = gw; r < rows; r += warps) {
    quantile_row<V>(mean + r * C, weight + r * C, C, mn[r], mx[r], qs,
                    out + r * Q, Q, lane, keys, wst);
    __syncwarp();  // the slab is restaged by the next row
  }
}

int key_slots(int C) {  // a warp's key slots: a power of two >= C, >= 32
  int cp = 32;
  while (cp < C) cp <<= 1;
  return cp;
}

// The wide kernel's warps: enough to fill the card, no more than the rows
// need, and their slabs within kScratchBytes (but at least one block).
long long wide_warps(long long rows, int C) {
  const long long slab = (long long)warp_bytes(C, key_slots(C));
  long long w = kScratchBytes / slab;
  if (w > kWideWarps) w = kWideWarps;
  if (w > rows) w = rows;
  w = (w + WARPS - 1) / WARPS * WARPS;
  return w < WARPS ? WARPS : w;
}

template <int V>
int launch(const void* mean, const void* weight, const void* mn,
           const void* mx, const void* qs, void* out, long long rows, int C,
           int Q, void* scratch, cudaStream_t stream) {
  const int cp = key_slots(C);
  if (C > SMEM_CELLS) {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    const long long blocks = wide_warps(rows, C) / WARPS;
    digest_quantiles_wide_kernel<V><<<(unsigned)blocks, 32 * WARPS, 0,
                                      stream>>>(
        (const float*)mean, (const float*)weight, (const float*)mn,
        (const float*)mx, (const float*)qs, (float*)out, rows, C, cp, Q,
        (unsigned char*)scratch);
    return (int)cudaGetLastError();
  }
  const size_t smem = (size_t)WARPS * warp_bytes(C, cp);
  static size_t granted = 48 * 1024;   // raised once per larger width
  if (smem > granted) {
    const cudaError_t e = cudaFuncSetAttribute(
        digest_quantiles_kernel<V>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    granted = smem;
  }
  const long long blocks = (rows + WARPS - 1) / WARPS;
  digest_quantiles_kernel<V><<<(unsigned)blocks, 32 * WARPS, smem, stream>>>(
      (const float*)mean, (const float*)weight, (const float*)mn,
      (const float*)mx, (const float*)qs, (float*)out, rows, C, cp, Q);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of global scratch a call over `rows` rows of C cells needs: none
// up to SMEM_CELLS cells, else one slab a warp of the wide kernel.
extern "C" long long vt_digest_quantiles_scratch(long long rows, int C) {
  if (rows <= 0 || C <= SMEM_CELLS || C > MAX_CELLS) return 0;
  return wide_warps(rows, C) * (long long)warp_bytes(C, key_slots(C));
}

extern "C" int vt_digest_quantiles(const void* mean, const void* weight,
                                   const void* mn, const void* mx,
                                   const void* qs, void* out, long long rows,
                                   int C, int Q, void* scratch,
                                   void* stream) {
  if (C <= 0 || C > MAX_CELLS) return (int)cudaErrorInvalidValue;
  if (rows <= 0) return (int)cudaGetLastError();
  const bool vec = C % 4 == 0 && ((uintptr_t)mean & 15) == 0 &&
                   ((uintptr_t)weight & 15) == 0;
  cudaStream_t s = (cudaStream_t)stream;
  return vec ? launch<4>(mean, weight, mn, mx, qs, out, rows, C, Q, scratch,
                         s)
             : launch<1>(mean, weight, mn, mx, qs, out, rows, C, Q, scratch,
                         s);
}
