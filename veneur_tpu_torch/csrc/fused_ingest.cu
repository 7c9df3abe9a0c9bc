// Fused ingest (kernel K1): one launch applies a whole batch to the 14
// state leaves in place.
//
// Replaces the Pallas kernel veneur_tpu/ops/pallas_ingest.py
// fused_ingest_core (body `kernel`). The five lanes of a batch arrive as
// streams sorted by (slot, batch index) -- the histogram lane by
// (slot, value) from the t-digest cell plan -- with invalid rows at the
// sentinel slot 2^30 (aggregation/step.py build_streams). The kernel
// applies:
//   counter   counter_acc[s] += inc
//   gauge     gauge[s] = last value of the run, gauge_stamp[s] = 1
//   status    the same on status / status_stamp
//   set       6-bit packed HLL register max
//   histogram h_w/h_wm[s, cell] +=, h_temp_n +=, min/max, and the
//             count/sum/reciprocal accumulators
//
// Byte parity with the JAX package: every f32 sum is an ordered chain --
// counter_acc[s], h_w/h_wm[s, cell], and the per-slot count, sum and
// reciprocal -- added one entry after another in stream order from the
// resident value, as the scatter chain does. f32 addition does not
// associate, so no chain is split, reduced as a tree or added with
// atomics. What is free of order runs in parallel: the register max, the
// temp-cell count (an int), the gauge/status last write.
//
// What bounds it on an H100: a batch moves a few hundred KB (well under
// a microsecond of HBM time), so the bound is the longest ordered chain:
// a Zipf-hot key's run, one dependent FADD (4 cycles) per entry. The
// design keeps each chain in registers with one owner, feeds it from
// coalesced loads, and needs no host-side plan:
//   - each warp owns 32 stream positions and loads them coalesced. A run
//     that ends inside them belongs to the thread at its head, which
//     takes the run's values from its neighbours by __shfl_sync, in lane
//     order. The one run that continues past them belongs to the warp,
//     which finds its end by a galloping search of the sorted slots and
//     walks it in 256-entry steps, copied into shared memory with 16-byte
//     cp.async several steps ahead of the fold;
//   - a long counter run: lane 0 folds each staged step in stream order
//     and stores once;
//   - a long histogram slot run: lane L folds row L of each step in stream
//     order (count, sum, reciprocal, min, max), four entries a shared-
//     memory load, so the five chains advance side by side;
//   - per-(slot, cell) chains: in a short run, __match_any_sync groups the
//     32 entries by cell and the group's lowest lane adds it in lane
//     order. A long run works on the slot's row staged in shared memory,
//     cut into 512-entry windows of segments of equal cells, one lane per
//     segment; segments of one cell take turns, earliest first (an int
//     atomicMin on a shared tag picks the lane). The cells of a run are
//     neither contiguous nor monotone (temp cells interleave), and nothing
//     here assumes they are; a value-sorted run's cells mostly are, which
//     keeps the segments long and many lanes busy;
//   - sets: one owner per 16-register group (3 words; the fields at bits
//     30 and 60 of a group straddle into its next word only), so no
//     atomics touch the words. A short run groups by __match_any_sync; a
//     long run stages the slot's packed row in shared memory and applies
//     32 entries a round, the lanes of one group taking turns by a shared
//     tag (any order gives the same bytes);
//   - gauge/status: each thread stores if its entry is the last of its run.
// __match_any_sync is slow on 32 mostly distinct values, which is why the
// long walks, where it would run every step, use shared tags instead.
// One launch covers all lanes: the grid is split by lane.
//
// Wide rows (hll_precision 16, or more than 3,630 digest cells, whose
// staged rows pass the 227 KB a block may have) launch the same kernel
// with kInPlace set. A long run's walk then reads and writes the slot's
// row where it lies in global memory: the run's warp is the only one
// that touches that slot, and __syncwarp orders one lane's store before
// another's load. The shared tags that pick a cell's or a group's turn
// become __match_any_sync (lowest lane first, as before); the stages stay
// in shared memory. Every chain keeps its one owner and its stream order,
// so the bytes are those of the staged walk. This is the slow path of
// C-1: each segment's first load goes to L2 or HBM, not shared memory.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int32_t kBig = 1 << 30;  // sentinel slot of dropped rows
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
// counter, gauge, status, set, histogram slots, histogram cells
constexpr int kLanes = 6;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSlotUnroll = 8;        // entries per lane per step of a
constexpr int kSlotStep = 32 * kSlotUnroll;  // long run's staged walk
constexpr int kStages = 2;            // steps of a walk in flight
constexpr int kCellStages = 4;        // the cell walk's: two windows of two
constexpr int kMaxDevices = 64;       // devices whose grant is remembered
constexpr size_t kMaxSmem = 227 * 1024;  // the most an sm_90 block has
constexpr int kRow = kSlotStep + 4;   // a staged stream's row: 16-byte
                                      // aligned, and rows 0-4 start in
                                      // five different banks

struct IngestArgs {
  // state leaves, updated in place
  float* counter;
  float* gauge;
  uint8_t* gauge_stamp;
  float* status;
  uint8_t* status_stamp;
  uint32_t* hll;
  float* h_w;
  float* h_wm;
  int32_t* h_temp_n;
  float* h_min;
  float* h_max;
  float* h_count;
  float* h_sum;
  float* h_recip;
  // sorted streams
  const int32_t* c_slot;
  const float* c_inc;
  const int32_t* g_slot;
  const float* g_val;
  const int32_t* st_slot;
  const float* st_val;
  const int32_t* s_slot;
  const int32_t* s_reg;
  const int32_t* s_rho;
  const int32_t* h_slot;
  const int32_t* h_cell;
  const float* h_v;
  const float* h_wt;
  const float* h_wv;
  const float* h_rcp;
  const int32_t* h_tadd;
  long long n[kLanes];
  int block_start[kLanes + 1];
  long long hll_words;
  long long cells;
  int warp_floats;  // dynamic shared memory per warp, in floats
};

// The runs seen by one warp's 32 stream positions [base, base + 32).
struct Runs {
  int32_t key;    // this lane's slot
  bool last;      // this lane's entry ends a run of a valid slot
  bool own;       // this lane's entry is in a run headed in the chunk that
                  // also ends in it (a short run)
  int len;        // the short run's length, at its head lane; else 0
  int long_lane;  // the lane heading the run that continues past the
                  // chunk, or -1
};

__device__ __forceinline__ Runs scan_runs(const int32_t* __restrict__ slot,
                                          long long base, long long n,
                                          int lane) {
  Runs r;
  const long long i = base + lane;
  r.key = i < n ? slot[i] : -1;
  int32_t prev = __shfl_up_sync(kFull, r.key, 1);
  int32_t next = __shfl_down_sync(kFull, r.key, 1);
  if (lane == 0) prev = base > 0 ? slot[base - 1] : -1;
  if (lane == 31) next = i + 1 < n ? slot[i + 1] : -1;
  const bool ok = i < n && r.key >= 0 && r.key < kBig;
  const bool head = ok && prev != r.key;
  r.last = ok && next != r.key;
  const unsigned heads = __ballot_sync(kFull, head);
  const unsigned lasts = __ballot_sync(kFull, r.last);
  const unsigned after = lasts >> lane;
  r.len = head && after ? __ffs(after) : 0;
  const unsigned upto = heads & (kFull >> (31 - lane));  // heads <= lane
  r.own = false;
  if (upto) {
    const int h = 31 - __clz(upto);
    const unsigned from = lasts >> h;
    r.own = from != 0u && lane <= h + __ffs(from) - 1;
  }
  const int top = heads ? 31 - __clz(heads) : -1;
  r.long_lane = top >= 0 && (lasts >> top) == 0u ? top : -1;
  return r;
}

// Every lane passes its own entry's x; the head of a short run of `len`
// entries gets acc plus its run's values, added in lane (= stream) order.
__device__ __forceinline__ float fold_short(float acc, float x, int lane,
                                            int len) {
#pragma unroll
  for (int t = 0; t < 32; ++t) {
    const float y = __shfl_sync(kFull, x, t);
    if (t >= lane && t < lane + len) acc += y;
  }
  return acc;
}

// -- staging for a long run's walk ---------------------------------------------

// cp.async: 16-byte copies from global into shared memory, tracked as
// commit groups; a copy whose source runs past a stream's end zero-fills.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One commit group: entries [b, b + 256) of K 4-byte streams (b a multiple
// of 4; the streams 16-byte aligned), stream k's entry e landing at
// buf[k * kRow + e]; entries at or past n are zero.
template <int K>
__device__ __forceinline__ void stage_async(float* buf,
                                            const void* const (&src)[K],
                                            long long b, long long n,
                                            int lane) {
#pragma unroll
  for (int q = 0; q < kSlotStep / 128; ++q) {
    const int e = 4 * (q * 32 + lane);
    const long long left = n - (b + e);
    const int bytes = left >= 4 ? 16 : left > 0 ? 4 * (int)left : 0;
    const long long j = bytes ? b + e : 0;
#pragma unroll
    for (int k = 0; k < K; ++k)
      cp_async16(buf + k * kRow + e, (const char*)src[k] + 4 * j, bytes);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// Issues the first kStages - 1 steps of a walk from `first`, stage k at
// stages + k * kStride.
template <int K, int kStride = K * kRow>
__device__ __forceinline__ void stage_first(float* stages,
                                            const void* const (&src)[K],
                                            long long first, long long n,
                                            int lane) {
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k)
    stage_async<K>(stages + k * kStride, src, first + k * kSlotStep, n,
                   lane);
}

// Step `step` of a walk from `first`: issues step + kStages - 1, waits for
// this step's copies and returns its stage.
template <int K, int kStride = K * kRow>
__device__ __forceinline__ float* stage_next(float* stages,
                                             const void* const (&src)[K],
                                             long long first, int step,
                                             long long n, int lane) {
  const int ahead = step + kStages - 1;
  stage_async<K>(stages + (ahead % kStages) * kStride, src,
                 first + (long long)ahead * kSlotStep, n, lane);
  cp_async_wait<kStages - 1>();
  __syncwarp();
  return stages + (step % kStages) * kStride;
}

// The end of slot s's run that starts at `start` (its first position
// past the run, or n): a galloping search of the sorted slot stream, 32
// probes a round. Every position below lo is in the run.
__device__ __forceinline__ long long run_end(const int32_t* __restrict__ slot,
                                             long long start, long long n,
                                             int32_t s, int lane) {
  long long lo = start + 1, stride = 8;
  while (true) {
    const long long q = lo + (long long)(lane + 1) * stride - 1;
    const int k = __popc(__ballot_sync(kFull, q < n && slot[q] == s));
    lo += k * stride;
    if (k == 32) {
      stride *= 32;
    } else if (stride == 1) {
      return lo;
    } else {
      stride = (stride + 31) / 32;
    }
  }
}

// Shared memory per warp, in floats (multiples of 4, so every stage is
// 16-byte aligned), of each long walk: the slot chain's stages of five
// streams and two derived rows (the counter walk's one stream fits in
// them); the cell walk's row (h_w, h_wm), an owner tag per cell, stages
// of three streams and its segment starts; the set walk's 64 staging
// words, stages of two streams, its row and an owner tag per 16-register
// group. Every warp reserves the largest, so a block needs
// block_smem_bytes: 83 KB at the default widths (p = 14, 472 cells), which
// allows 2 blocks an SM. Past the 227 KB a block may have (p = 16, or
// more than 3,630 cells) the rows stay in place (kInPlace): the walks
// read and write them in global memory, pick a cell's or a group's turn
// by __match_any_sync in place of the shared tags, and a block needs the
// stages alone (57 KB).
__host__ __device__ inline long long up4(long long x) { return (x + 3) & ~3LL; }
__host__ __device__ inline long long slot_warp_floats() {
  return 7 * kStages * kRow;
}
__host__ __device__ inline long long cell_warp_floats(long long cells,
                                                      bool in_place) {
  return (in_place ? 0 : up4(3 * cells)) + 3 * kCellStages * kRow +
         up4(2 * kSlotStep + 1);
}
__host__ __device__ inline long long set_warp_floats(long long words,
                                                     bool in_place) {
  return 64 + 2 * kStages * kRow +
         (in_place ? 0 : up4(words) + up4(words / 3));
}
inline long long warp_smem_floats(long long words, long long cells,
                                  bool in_place) {
  long long wf = slot_warp_floats();
  if (cell_warp_floats(cells, in_place) > wf)
    wf = cell_warp_floats(cells, in_place);
  if (set_warp_floats(words, in_place) > wf)
    wf = set_warp_floats(words, in_place);
  return wf;
}
inline long long block_smem_bytes(long long words, long long cells,
                                  bool in_place) {
  return warp_smem_floats(words, cells, in_place) * kWarps *
         (long long)sizeof(float);
}

// -- counter: ordered sums per slot -------------------------------------------

// The warp walks slot s's run [start, end) 256 entries a step, staged in
// shared memory as the slot chains are; lane 0 adds them in stream order.
__device__ __forceinline__ void warp_counter_run(const IngestArgs& a,
                                                 float* sm, long long start,
                                                 long long n, int32_t s,
                                                 int lane) {
  const void* src[1] = {a.c_inc};
  float acc = lane == 0 ? a.counter[s] : 0.f;
  const long long first = start & ~3LL;  // steps start 16-byte aligned
  stage_first<1>(sm, src, first, n, lane);
  const long long end = run_end(a.c_slot, start, n, s, lane);
  for (int step = 0;; ++step) {
    const long long b = first + (long long)step * kSlotStep;
    const float* buf = stage_next<1>(sm, src, first, step, n, lane);
    const int e0 = start > b ? (int)(start - b) : 0;
    const int e1 = end - b < kSlotStep ? (int)(end - b) : kSlotStep;
    if (lane == 0)
      for (int t = e0; t < e1; ++t) acc += buf[t];
    __syncwarp();
    if (end <= b + kSlotStep) break;
  }
  cp_async_wait<0>();
  if (lane == 0) a.counter[s] = acc;
}

__device__ __forceinline__ void counter_lane(const IngestArgs& a, float* sm,
                                             long long base, int lane) {
  const long long n = a.n[0];
  const Runs r = scan_runs(a.c_slot, base, n, lane);
  const long long i = base + lane;
  const float x = a.c_inc[i < n ? i : n - 1];
  if (__any_sync(kFull, r.len > 0)) {
    float acc = r.len ? a.counter[r.key] : 0.f;
    acc = fold_short(acc, x, lane, r.len);
    if (r.len) a.counter[r.key] = acc;
  }
  if (r.long_lane >= 0)
    warp_counter_run(a, sm, base + r.long_lane, n,
                     __shfl_sync(kFull, r.key, r.long_lane), lane);
}

// -- gauge, status: last write --------------------------------------------------

__device__ __forceinline__ void last_lane(const int32_t* __restrict__ slot,
                                          const float* __restrict__ val,
                                          float* __restrict__ tgt,
                                          uint8_t* __restrict__ stamp,
                                          long long base, long long n,
                                          int lane) {
  const Runs r = scan_runs(slot, base, n, lane);
  if (r.last) {
    tgt[r.key] = val[base + lane];
    stamp[r.key] = 1;
  }
}

// -- set: register max by 16-register group (3 packed words) -------------------

// Field q (6 bits at bit 6q of the 96-bit group); q = 5 and q = 10 straddle
// a word boundary.
__device__ __forceinline__ uint32_t get_field(uint32_t a0, uint32_t a1,
                                              uint32_t a2, int q) {
  const int b = 6 * q;
  const unsigned long long lo = a0 | ((unsigned long long)a1 << 32);
  const unsigned long long hi = a1 | ((unsigned long long)a2 << 32);
  return (uint32_t)((b < 32 ? lo >> b : hi >> (b - 32)) & 0x3Full);
}

__device__ __forceinline__ void set_field(uint32_t& a0, uint32_t& a1,
                                          uint32_t& a2, int q, uint32_t f) {
  const int b = 6 * q;
  unsigned long long lo = a0 | ((unsigned long long)a1 << 32);
  uint32_t hi = a2;
  if (b <= 58) {
    lo = (lo & ~(0x3Full << b)) | ((unsigned long long)f << b);
  } else if (b >= 64) {
    hi = (hi & ~(0x3Fu << (b - 64))) | (f << (b - 64));
  } else {  // b == 60: 4 bits in word 1, 2 in word 2
    lo = (lo & ~(0xFull << 60)) | ((unsigned long long)(f & 0xFu) << 60);
    hi = (hi & ~0x3u) | (f >> 4);
  }
  a0 = (uint32_t)lo;
  a1 = (uint32_t)(lo >> 32);
  a2 = hi;
}

// rho in [0, 63] (the hash split gives at most 64 - p + 1): the field
// becomes the max, so any order of a group's entries gives the same bytes.
__device__ __forceinline__ void hll_max(uint32_t& a0, uint32_t& a1,
                                        uint32_t& a2, int32_t reg,
                                        int32_t rho) {
  const int q = reg & 15;
  if (rho > (int32_t)get_field(a0, a1, a2, q))
    set_field(a0, a1, a2, q, (uint32_t)rho & 0x3Fu);
}

// Lanes with `in` set hold one step's entries: the group at word `key` of
// `words` (a 64-bit offset: rows x words passes 2^31 at p = 14 past
// 699,050 set rows), registers and rhos at sreg[lane] / srho[lane] in
// shared memory. The peers of a group meet at its lowest lane, which
// applies them all to the group's three words.
__device__ __forceinline__ void apply_groups(uint32_t* __restrict__ words,
                                             const int32_t* sreg,
                                             const int32_t* srho, bool in,
                                             long long key, int lane) {
  const unsigned peers =
      __match_any_sync(kFull, in ? key : (long long)(-lane - 1));
  if (in && __ffs(peers) - 1 == lane) {
    uint32_t* g = words + key;
    uint32_t a0 = g[0], a1 = g[1], a2 = g[2];
    for (unsigned m = peers; m; m &= m - 1) {
      const int t = __ffs(m) - 1;
      hll_max(a0, a1, a2, sreg[t], srho[t]);
    }
    g[0] = a0;
    g[1] = a1;
    g[2] = a2;
  }
  __syncwarp();
}

template <bool kInPlace>
__device__ __forceinline__ void set_lane(const IngestArgs& a, float* sm,
                                         long long base, int lane) {
  const long long n = a.n[3];
  const Runs r = scan_runs(a.s_slot, base, n, lane);
  const long long i = base + lane;
  const long long ic = i < n ? i : n - 1;
  int32_t* sg = (int32_t*)sm;
  if (__any_sync(kFull, r.own)) {
    const int32_t reg = a.s_reg[ic];
    sg[lane] = reg;
    sg[32 + lane] = a.s_rho[ic];
    __syncwarp();
    apply_groups(a.hll, sg, sg + 32, r.own,
                 (long long)r.key * a.hll_words + 3 * (reg >> 4), lane);
  }
  if (r.long_lane < 0) return;
  // the long run: the slot's row staged in shared memory (or, in place,
  // its words in global memory: no other warp touches the slot), 256
  // entries a step (the next steps copying in meanwhile), applied 32 at a
  // time; a group met again later is read after the earlier store
  // (__syncwarp orders them)
  const int32_t s = __shfl_sync(kFull, r.key, r.long_lane);
  const long long start = base + r.long_lane;
  const long long first = start & ~3LL;  // steps start 16-byte aligned
  constexpr int kStage = 2 * kRow;       // register, rho
  float* stages = sm + 64;
  uint32_t* grow = a.hll + (long long)s * a.hll_words;
  uint32_t* staged = (uint32_t*)(stages + kStages * kStage);
  uint32_t* row = kInPlace ? grow : staged;
  int32_t* tag = (int32_t*)(staged + up4(a.hll_words));  // staged only
  const void* src[2] = {a.s_reg, a.s_rho};
  stage_first<2>(stages, src, first, n, lane);
  if (!kInPlace)
    for (long long w = lane; w < a.hll_words; w += 32) row[w] = grow[w];
  const long long end = run_end(a.s_slot, start, n, s, lane);
  for (int step = 0;; ++step) {
    const long long b = first + (long long)step * kSlotStep;
    const int32_t* buf =
        (const int32_t*)stage_next<2>(stages, src, first, step, n, lane);
    const int e0 = start > b ? (int)(start - b) : 0;
    const int e1 = end - b < kSlotStep ? (int)(end - b) : kSlotStep;
#pragma unroll
    for (int u = 0; u < kSlotUnroll; ++u) {
      if (u * 32 + 32 <= e0 || u * 32 >= e1) continue;
      // the lanes of one group take turns: each round, the lane whose tag
      // write landed applies its entry (free of order)
      const int e = u * 32 + lane;
      const int32_t reg = buf[e], rho = buf[kRow + e];
      const int g = reg >> 4;
      bool pending = e >= e0 && e < e1;
      while (__any_sync(kFull, pending)) {
        bool mine;
        if constexpr (kInPlace) {
          const unsigned peers =
              __match_any_sync(kFull, pending ? g : -lane - 1);
          mine = pending && __ffs(peers) - 1 == lane;
        } else {
          if (pending) tag[g] = lane;
          __syncwarp();
          mine = pending && tag[g] == lane;
        }
        if (mine) {
          uint32_t* w = row + 3 * g;
          uint32_t a0 = w[0], a1 = w[1], a2 = w[2];
          hll_max(a0, a1, a2, reg, rho);
          w[0] = a0;
          w[1] = a1;
          w[2] = a2;
          pending = false;
        }
        __syncwarp();
      }
    }
    if (end <= b + kSlotStep) break;
  }
  cp_async_wait<0>();
  if (!kInPlace)
    for (long long w = lane; w < a.hll_words; w += 32) grow[w] = row[w];
}

// -- histogram: the per-slot scalar chains --------------------------------------

// The warp walks slot s's run [start, end) 256 entries a step, each step
// copied into shared memory while earlier ones fold. A pass over the step
// derives the min/max inputs (v where w > 0, else +inf / -inf) and adds
// the temp-cell count (an int, free of order); then lane L folds row L in
// stream order, four entries a shared-memory load: lanes 0-2 add w, w * v
// and w / v (count, sum, reciprocal), lanes 3 and 4 take the min and max.
// Every lane runs the same instructions on its own row, so the five
// chains advance together.
__device__ __forceinline__ void warp_slot_chain(const IngestArgs& a,
                                                float* sm, long long start,
                                                long long n, int32_t s,
                                                int lane) {
  // rows: w, w * v, w / v, v, tadd (copied), then the min and max inputs
  constexpr int kStage = 7 * kRow;
  const void* src[5] = {a.h_wt, a.h_wv, a.h_rcp, a.h_v, a.h_tadd};
  const int row = lane < 3 ? lane : lane < 5 ? lane + 2 : 6;
  float add = lane == 0 ? a.h_count[s]
              : lane == 1 ? a.h_sum[s]
              : lane == 2 ? a.h_recip[s]
                          : 0.f;
  float mn = lane == 3 ? a.h_min[s] : INFINITY;
  float mx = lane == 4 ? a.h_max[s] : -INFINITY;
  int tn = 0;
  const long long first = start & ~3LL;  // steps start 16-byte aligned
  stage_first<5, kStage>(sm, src, first, n, lane);
  const long long end = run_end(a.h_slot, start, n, s, lane);
  for (int step = 0;; ++step) {
    const long long b = first + (long long)step * kSlotStep;
    float* buf = stage_next<5, kStage>(sm, src, first, step, n, lane);
    const int e0 = start > b ? (int)(start - b) : 0;
    const int e1 = end - b < kSlotStep ? (int)(end - b) : kSlotStep;
    float w[kSlotUnroll], v[kSlotUnroll];
#pragma unroll
    for (int u = 0; u < kSlotUnroll; ++u) {  // every load before any store
      const int e = u * 32 + lane;
      w[u] = buf[e];
      v[u] = buf[3 * kRow + e];
      if (e >= e0 && e < e1) tn += __float_as_int(buf[4 * kRow + e]);
    }
#pragma unroll
    for (int u = 0; u < kSlotUnroll; ++u) {
      const int e = u * 32 + lane;
      buf[5 * kRow + e] = w[u] > 0.f ? v[u] : INFINITY;
      buf[6 * kRow + e] = w[u] > 0.f ? v[u] : -INFINITY;
    }
    __syncwarp();
    const float* __restrict__ r = buf + row * kRow;
    if (e0 == 0 && e1 == kSlotStep) {
      const float4* __restrict__ r4 = (const float4*)r;
#pragma unroll 8
      for (int t = 0; t < kSlotStep / 4; ++t) {
        const float4 x = r4[t];
        add += x.x;
        mn = fminf(mn, x.x);
        mx = fmaxf(mx, x.x);
        add += x.y;
        mn = fminf(mn, x.y);
        mx = fmaxf(mx, x.y);
        add += x.z;
        mn = fminf(mn, x.z);
        mx = fmaxf(mx, x.z);
        add += x.w;
        mn = fminf(mn, x.w);
        mx = fmaxf(mx, x.w);
      }
    } else {
      for (int t = e0; t < e1; ++t) {
        const float x = r[t];
        add += x;
        mn = fminf(mn, x);
        mx = fmaxf(mx, x);
      }
    }
    __syncwarp();
    if (end <= b + kSlotStep) break;
  }
  cp_async_wait<0>();
  tn = __reduce_add_sync(kFull, tn);
  if (lane == 0) a.h_count[s] = add;
  if (lane == 1) a.h_sum[s] = add;
  if (lane == 2) a.h_recip[s] = add;
  if (lane == 3) a.h_min[s] = mn;
  if (lane == 4) a.h_max[s] = mx;
  if (lane == 5) a.h_temp_n[s] += tn;
}

__device__ __forceinline__ void histo_slot_lane(const IngestArgs& a,
                                                float* __restrict__ stage,
                                                long long base, int lane) {
  const long long n = a.n[4];
  const Runs r = scan_runs(a.h_slot, base, n, lane);
  const long long i = base + lane;
  const long long ic = i < n ? i : n - 1;
  if (__any_sync(kFull, r.len > 0)) {
    const float w = a.h_wt[ic], v = a.h_v[ic], wv = a.h_wv[ic];
    const float rc = a.h_rcp[ic];
    const int ta = a.h_tadd[ic];
    const int32_t s = r.len ? r.key : 0;
    int32_t tn = 0;
    float mn = 0.f, mx = 0.f, cnt = 0.f, sum = 0.f, rcp = 0.f;
    if (r.len) {
      tn = a.h_temp_n[s];
      mn = a.h_min[s];
      mx = a.h_max[s];
      cnt = a.h_count[s];
      sum = a.h_sum[s];
      rcp = a.h_recip[s];
    }
#pragma unroll
    for (int t = 0; t < 32; ++t) {
      const float yw = __shfl_sync(kFull, w, t);
      const float yv = __shfl_sync(kFull, v, t);
      const float ywv = __shfl_sync(kFull, wv, t);
      const float yrc = __shfl_sync(kFull, rc, t);
      const int yta = __shfl_sync(kFull, ta, t);
      if (t >= lane && t < lane + r.len) {
        tn += yta;
        mn = fminf(mn, yw > 0.f ? yv : INFINITY);
        mx = fmaxf(mx, yw > 0.f ? yv : -INFINITY);
        cnt += yw;
        sum += ywv;
        rcp += yrc;
      }
    }
    if (r.len) {
      a.h_temp_n[s] = tn;
      a.h_min[s] = mn;
      a.h_max[s] = mx;
      a.h_count[s] = cnt;
      a.h_sum[s] = sum;
      a.h_recip[s] = rcp;
    }
  }
  if (r.long_lane >= 0) {
    const int32_t s = __shfl_sync(kFull, r.key, r.long_lane);
    warp_slot_chain(a, stage, base + r.long_lane, n, s, lane);
  }
}

// -- histogram: the per-(slot, cell) chains -------------------------------------

// A short run's entries: lanes with `in` set hold (target index key, a
// 64-bit offset: rows x cells passes 2^31 at 472 cells past 4,549,752
// digest rows, w, wv); the peers of a key meet at its lowest lane, which
// adds their values in lane order to h_w[key] / h_wm[key].
__device__ __forceinline__ void add_groups(float* __restrict__ tw,
                                           float* __restrict__ tm, bool in,
                                           long long key, float w, float wv,
                                           int lane) {
  const unsigned peers =
      __match_any_sync(kFull, in ? key : (long long)(-lane - 1));
  if (__all_sync(kFull, !in || peers == (1u << lane))) {  // no repeats
    if (in) {
      tw[key] += w;
      tm[key] += wv;
    }
    return;
  }
  const bool leader = in && __ffs(peers) - 1 == lane;
  float aw = leader ? tw[key] : 0.f, am = leader ? tm[key] : 0.f;
#pragma unroll
  for (int t = 0; t < 32; ++t) {
    const float yw = __shfl_sync(kFull, w, t);
    const float ym = __shfl_sync(kFull, wv, t);
    if (leader && ((peers >> t) & 1u)) {
      aw += yw;
      am += ym;
    }
  }
  if (leader) {
    tw[key] = aw;
    tm[key] = am;
  }
}

// The warp walks slot s's run [start, end) over the row staged in shared
// memory, 512 entries (two steps) a window, the next window copying in
// meanwhile. A window is cut into segments of equal cells; lane L takes
// segment L (and L + 32, ... in later rounds) and adds it in stream order.
// Segments of one cell in one round take turns, earliest first, so each
// (slot, cell) chain keeps one owner at a time and its stream order.
template <bool kInPlace>
__device__ __forceinline__ void warp_cells_run(const IngestArgs& a,
                                               float* sm, long long start,
                                               long long n, int32_t s,
                                               int lane) {
  constexpr int kWin = 2 * kSlotStep;
  const long long cells = a.cells;
  constexpr int kStage = 3 * kRow;  // cell, w, w * v
  float* gw = a.h_w + (long long)s * cells;
  float* gm = a.h_wm + (long long)s * cells;
  // in place, the row is the slot's own (no other warp touches it)
  float* rw = kInPlace ? gw : sm;
  float* rm = kInPlace ? gm : sm + cells;
  int32_t* tag = (int32_t*)(sm + 2 * cells);  // staged only
  float* stages = kInPlace ? sm : sm + up4(3 * cells);
  int32_t* seg = (int32_t*)(stages + kCellStages * kStage);
  const void* src[3] = {a.h_cell, a.h_wt, a.h_wv};
  const long long first = start & ~3LL;  // steps start 16-byte aligned
  stage_async<3>(stages, src, first, n, lane);
  stage_async<3>(stages + kStage, src, first + kSlotStep, n, lane);
  if (!kInPlace)
    for (long long c = lane; c < cells; c += 32) {
      rw[c] = gw[c];
      rm[c] = gm[c];
    }
  const long long end = run_end(a.h_slot, start, n, s, lane);
  const unsigned below = (1u << lane) - 1u;
  for (int win = 0;; ++win) {
    const int s0 = 2 * win;  // the window's first step
    const long long b = first + (long long)s0 * kSlotStep;
    stage_async<3>(stages + ((s0 + 2) % kCellStages) * kStage, src,
                   b + 2 * kSlotStep, n, lane);
    stage_async<3>(stages + ((s0 + 3) % kCellStages) * kStage, src,
                   b + 3 * kSlotStep, n, lane);
    cp_async_wait<2>();
    __syncwarp();
    const float* buf0 = stages + (s0 % kCellStages) * kStage;
    const float* buf1 = stages + ((s0 + 1) % kCellStages) * kStage;
    const int e0 = start > b ? (int)(start - b) : 0;
    const int e1 = end - b < kWin ? (int)(end - b) : kWin;
    int cur[2 * kSlotUnroll], prv[2 * kSlotUnroll];
#pragma unroll
    for (int u = 0; u < 2 * kSlotUnroll; ++u) {  // every load before the
      const int e = u * 32 + lane;                 // segment stores
      const float* p = (e < kSlotStep ? buf0 : buf1) + (e & (kSlotStep - 1));
      const float* q =
          (e - 1 < kSlotStep ? buf0 : buf1) + ((e - 1) & (kSlotStep - 1));
      cur[u] = __float_as_int(*p);
      prv[u] = e > 0 ? __float_as_int(*q) : -1;
    }
    int nseg = 0;
#pragma unroll
    for (int u = 0; u < 2 * kSlotUnroll; ++u) {
      const int e = u * 32 + lane;
      const bool head = e >= e0 && e < e1 && (e == e0 || cur[u] != prv[u]);
      const unsigned bal = __ballot_sync(kFull, head);
      if (head) seg[nseg + __popc(bal & below)] = e;
      nseg += __popc(bal);
    }
    if (lane == 0) seg[nseg] = e1;
    __syncwarp();
    for (int r0 = 0; r0 < nseg; r0 += 32) {
      // lane L folds segment r0 + L; segments of one cell take turns,
      // earliest first (the lowest lane wins each turn)
      const int k = r0 + lane;
      bool pending = k < nseg;
      const int lo = pending ? seg[k] : 0, hi = pending ? seg[k + 1] : 0;
      const int c = pending
          ? __float_as_int((lo < kSlotStep ? buf0 : buf1)[lo & (kSlotStep - 1)])
          : 0;
      while (__any_sync(kFull, pending)) {
        bool mine;
        if constexpr (kInPlace) {
          const unsigned peers =
              __match_any_sync(kFull, pending ? c : -lane - 1);
          mine = pending && __ffs(peers) - 1 == lane;
        } else {
          if (pending) tag[c] = 32;
          __syncwarp();
          if (pending) atomicMin(&tag[c], lane);
          __syncwarp();
          mine = pending && tag[c] == lane;
        }
        if (mine) {
          float aw = rw[c], am = rm[c];
#pragma unroll 4
          for (int e = lo; e < hi; ++e) {
            const float* p =
                (e < kSlotStep ? buf0 : buf1) + (e & (kSlotStep - 1));
            aw += p[kRow];
            am += p[2 * kRow];
          }
          rw[c] = aw;
          rm[c] = am;
          pending = false;
        }
        __syncwarp();
      }
    }
    if (end <= b + kWin) break;
  }
  cp_async_wait<0>();
  if (!kInPlace)
    for (long long c = lane; c < cells; c += 32) {
      gw[c] = rw[c];
      gm[c] = rm[c];
    }
}

template <bool kInPlace>
__device__ __forceinline__ void cell_lane(const IngestArgs& a,
                                          float* __restrict__ sm,
                                          long long base, int lane) {
  const long long n = a.n[5];
  const Runs r = scan_runs(a.h_slot, base, n, lane);
  const long long i = base + lane;
  const long long ic = i < n ? i : n - 1;
  if (__any_sync(kFull, r.own))
    add_groups(a.h_w, a.h_wm, r.own,
               (long long)r.key * a.cells + a.h_cell[ic], a.h_wt[ic],
               a.h_wv[ic], lane);
  if (r.long_lane >= 0)
    warp_cells_run<kInPlace>(a, sm, base + r.long_lane, n,
                   __shfl_sync(kFull, r.key, r.long_lane), lane);
}

template <bool kInPlace>
__global__ void __launch_bounds__(kThreads)
fused_ingest_kernel(IngestArgs a) {
  extern __shared__ float smem[];
  int ln = 0;
  while (ln < kLanes - 1 && (int)blockIdx.x >= a.block_start[ln + 1]) ++ln;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long base =
      ((long long)(blockIdx.x - a.block_start[ln]) * kWarps + warp) * 32;
  if (base >= a.n[ln]) return;  // the whole warp
  float* mine = smem + (long long)warp * a.warp_floats;
  switch (ln) {
    case 0:
      counter_lane(a, mine, base, lane);
      return;
    case 1:
      last_lane(a.g_slot, a.g_val, a.gauge, a.gauge_stamp, base, a.n[1],
                lane);
      return;
    case 2:
      last_lane(a.st_slot, a.st_val, a.status, a.status_stamp, base, a.n[2],
                lane);
      return;
    case 3:
      set_lane<kInPlace>(a, mine, base, lane);
      return;
    case 4:
      histo_slot_lane(a, mine, base, lane);
      return;
    default:
      cell_lane<kInPlace>(a, mine, base, lane);
      return;
  }
}

}  // namespace

// p: 30 device pointers (14 state leaves, then 16 streams, in the
// IngestArgs order); d: the five lane lengths (counter, gauge, status,
// set, histogram), hll words per row, digest cells per row, and 1 to
// keep the rows in place (0 to stage them, which must fit the 227 KB a
// block may have).
extern "C" int vt_fused_ingest(void* const* p, const long long* d,
                               void* stream) {
  IngestArgs a;
  a.counter = (float*)p[0];
  a.gauge = (float*)p[1];
  a.gauge_stamp = (uint8_t*)p[2];
  a.status = (float*)p[3];
  a.status_stamp = (uint8_t*)p[4];
  a.hll = (uint32_t*)p[5];
  a.h_w = (float*)p[6];
  a.h_wm = (float*)p[7];
  a.h_temp_n = (int32_t*)p[8];
  a.h_min = (float*)p[9];
  a.h_max = (float*)p[10];
  a.h_count = (float*)p[11];
  a.h_sum = (float*)p[12];
  a.h_recip = (float*)p[13];
  a.c_slot = (const int32_t*)p[14];
  a.c_inc = (const float*)p[15];
  a.g_slot = (const int32_t*)p[16];
  a.g_val = (const float*)p[17];
  a.st_slot = (const int32_t*)p[18];
  a.st_val = (const float*)p[19];
  a.s_slot = (const int32_t*)p[20];
  a.s_reg = (const int32_t*)p[21];
  a.s_rho = (const int32_t*)p[22];
  a.h_slot = (const int32_t*)p[23];
  a.h_cell = (const int32_t*)p[24];
  a.h_v = (const float*)p[25];
  a.h_wt = (const float*)p[26];
  a.h_wv = (const float*)p[27];
  a.h_rcp = (const float*)p[28];
  a.h_tadd = (const int32_t*)p[29];
  const long long lens[kLanes] = {d[0], d[1], d[2], d[3], d[4], d[4]};
  int blocks = 0;
  for (int k = 0; k < kLanes; ++k) {
    a.n[k] = lens[k];
    a.block_start[k] = blocks;
    blocks += (int)((lens[k] + kThreads - 1) / kThreads);
  }
  a.block_start[kLanes] = blocks;
  a.hll_words = d[5];
  a.cells = d[6];
  const bool in_place = d[7] != 0;
  a.warp_floats = (int)warp_smem_floats(a.hll_words, a.cells, in_place);
  const size_t smem =
      (size_t)block_smem_bytes(a.hll_words, a.cells, in_place);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (blocks == 0) return (int)cudaGetLastError();
  // past 48 KB a kernel must be granted its dynamic shared memory, once
  // per device and kernel for the largest size asked so far
  static size_t granted[2][kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const auto kernel =
      in_place ? fused_ingest_kernel<true> : fused_ingest_kernel<false>;
  if (smem > 48 * 1024 &&
      (dev >= kMaxDevices || smem > granted[in_place][dev])) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    if (dev < kMaxDevices) granted[in_place][dev] = smem;
  }
  kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// Dynamic shared memory, in bytes, that a launch with these widths asks
// of each block, rows staged (in_place 0) or in place (1).
extern "C" long long vt_fused_ingest_smem(long long hll_words,
                                          long long cells, int in_place) {
  return block_smem_bytes(hll_words, cells, in_place != 0);
}
