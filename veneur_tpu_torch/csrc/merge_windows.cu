// Masked window merge of 6-bit packed HLL rows (the history tier's set
// range query), reading the ring's rows in place through a row index.
//
// Replaces the Pallas kernel veneur_tpu/ops/pallas_history.py
// merge_windows_packed (_merge_kernel). rows i32[R, W, nw] hold one
// packed HLL row per (ring row, ring column); idx i32[N] picks the rows
// to merge (clamped into [0, R), as the range program's _take clamps;
// no idx means rows 0..N-1); sel f32[S, W] selects, per range step, the
// ring columns that cover it. For every n and step s: out[n, s] =
// pack(max over w with sel[s, w] > 0 of unpack(rows[idx[n], w])). A step
// that selects nothing gives all-zero words (zero is the register-max
// identity) and reads nothing.
//
// What bounds it on an H100: bytes, with the integer pipe close behind.
// Per selected column it reads nw words of each picked row and maxes 16
// fields per 3 words. At the range batch (256 set rows, 29 of 360
// columns selected, 32 steps, p = 14) it reads 91 MB and writes 100 MB:
// 0.057 ms at 3.35 TB/s.
// Design:
// - No gather. The TPU kernel needed a dense [N, W, nw] block for its
//   BlockSpec tiles, so the range program copied every set row (1.13 GB
//   each way at the default ring) to read 29 of its 360 columns. Here a
//   thread computes its row's address from idx and reads the ring.
// - A thread owns 4 groups of 16 registers (12 words: three 16-byte
//   loads and stores) of one row, and keeps their 64 registers in
//   registers; 16 registers fill exactly 3 words, so no field of a group
//   leaves it and no atomics are needed. At ~4 integer ops a byte read,
//   the unpacking alone would take about as long as the reads (64 INT32
//   lanes an SM), so a field that lies inside a word is maxed in place
//   (mask, max: two ops) and only the two fields that straddle words are
//   shifted out. Rows whose pitch is not a multiple of 16 bytes (p < 6)
//   or bases that are not 16-byte aligned take a scalar path, one group
//   (3 words) a thread.
// - The grid is cut by thread: thread t owns row t / T and slice t % T,
//   T = its row's threads (256 at p = 14), 128 threads a block, so the
//   range batch is 512 blocks: all of them resident at once on 132 SMs
//   (at most 128 registers a thread, 4 blocks an SM), ~15 warps an SM.
// - A block builds every step's column list once and reuses it for all
//   its rows and steps: warp k compacts steps k, k + 4, ... by ballot
//   into shared memory (u16 offsets; `> 0`, so NaN and negative masks
//   never select). Columns are taken in chunks of 512 and steps in groups
//   of 32; past one chunk a step's registers are carried in the output
//   (read back by the thread that wrote them).
// - A thread walks all of its (step, column) pairs as one sequence, two
//   columns' loads in flight, across step boundaries: most steps select
//   1-4 columns, so walking step by step would wait on DRAM once a step.
//   A column that several steps select is read again from L2. More
//   columns in flight did not help on an H100: a cp.async ring in shared
//   memory with four a thread, or L2 prefetches two to four columns
//   ahead, made both shapes slower (PERF.md section 6).
// The TPU kernel's accumulator carried across its column grid axis
// (legal only because the TPU grid runs in order) becomes this walk
// inside the thread; its row/column tiles and padding are not carried
// over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 512;   // columns a list build covers
constexpr int kGroup = 32;    // steps a list build covers
constexpr int kInFlight = 2;  // columns whose loads are issued together
constexpr unsigned kFull = 0xffffffffu;

// The register max of one group (3 words, 16 fields) into acc. A field
// that lies inside a word is compared where it lies (masked, not shifted:
// two integer ops a field, where extracting it would take three), so
// acc[k] holds field k at its own bit offset; the two fields that
// straddle words (5: bits 30-35, 10: bits 60-65) are extracted.
__device__ __forceinline__ void max16(uint32_t w0, uint32_t w1, uint32_t w2,
                                      uint32_t* acc) {
  acc[0] = max(acc[0], w0 & (63u << 0));
  acc[1] = max(acc[1], w0 & (63u << 6));
  acc[2] = max(acc[2], w0 & (63u << 12));
  acc[3] = max(acc[3], w0 & (63u << 18));
  acc[4] = max(acc[4], w0 & (63u << 24));
  acc[5] = max(acc[5], __funnelshift_r(w0, w1, 30) & 63u);
  acc[6] = max(acc[6], w1 & (63u << 4));
  acc[7] = max(acc[7], w1 & (63u << 10));
  acc[8] = max(acc[8], w1 & (63u << 16));
  acc[9] = max(acc[9], w1 & (63u << 22));
  acc[10] = max(acc[10], __funnelshift_r(w1, w2, 28) & 63u);
  acc[11] = max(acc[11], w2 & (63u << 2));
  acc[12] = max(acc[12], w2 & (63u << 8));
  acc[13] = max(acc[13], w2 & (63u << 14));
  acc[14] = max(acc[14], w2 & (63u << 20));
  acc[15] = max(acc[15], w2 & (63u << 26));
}

__device__ __forceinline__ void pack16(const uint32_t* a, uint32_t* o) {
  o[0] = a[0] | a[1] | a[2] | a[3] | a[4] | (a[5] << 30);
  o[1] = (a[5] >> 2) | a[6] | a[7] | a[8] | a[9] | (a[10] << 28);
  o[2] = (a[10] >> 4) | a[11] | a[12] | a[13] | a[14] | a[15];
}

// G groups (3G words) of one row at p: 16-byte vectors when G == 4.
template <int G>
struct Words {
  uint32_t w[3 * G];
  __device__ __forceinline__ void load(const uint32_t* p) {
    if constexpr (G == 4) {
#pragma unroll
      for (int v = 0; v < 3; ++v) {
        const uint4 x = reinterpret_cast<const uint4*>(p)[v];
        w[4 * v] = x.x;
        w[4 * v + 1] = x.y;
        w[4 * v + 2] = x.z;
        w[4 * v + 3] = x.w;
      }
    } else {
#pragma unroll
      for (int k = 0; k < 3 * G; ++k) w[k] = p[k];
    }
  }
  __device__ __forceinline__ void store(uint32_t* p) const {
    if constexpr (G == 4) {
#pragma unroll
      for (int v = 0; v < 3; ++v)
        reinterpret_cast<uint4*>(p)[v] =
            make_uint4(w[4 * v], w[4 * v + 1], w[4 * v + 2], w[4 * v + 3]);
    } else {
#pragma unroll
      for (int k = 0; k < 3 * G; ++k) p[k] = w[k];
    }
  }
};

template <int G>
__global__ void __launch_bounds__(kThreads, 4)
merge_windows_kernel(const uint32_t* __restrict__ rows,
                     const int32_t* __restrict__ idx, long long ring_rows,
                     const float* __restrict__ sel,
                     uint32_t* __restrict__ out, long long N, int W, int nw,
                     int S, int tpr, int chunk, int group) {
  extern __shared__ uint16_t lists[];  // [group][chunk] column offsets
  __shared__ int cnt[kGroup];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long t = (long long)blockIdx.x * kThreads + tid;
  const long long n = t / tpr;
  const bool active = n < N;
  const long long word0 = 3LL * G * (t % tpr);
  const uint32_t* src = rows;
  uint32_t* dst = out;
  if (active) {
    long long r = idx ? (long long)idx[n] : n;
    r = r < 0 ? 0 : r >= ring_rows ? ring_rows - 1 : r;
    src = rows + r * W * (long long)nw + word0;
    dst = out + n * S * (long long)nw + word0;
  }
  const unsigned below = (1u << lane) - 1u;
  int w0 = 0;
  do {  // column chunks (one when W <= chunk; W == 0 still writes zeros)
    const int wn = min(chunk, W - w0);
    for (int s0 = 0; s0 < S; s0 += group) {  // step groups
      const int sn = min(group, S - s0);
      __syncthreads();  // the previous build's lists are read
      for (int j = warp; j < sn; j += kWarps) {
        const float* srow = sel + (long long)(s0 + j) * W + w0;
        int c = 0;
        for (int b = 0; b < wn; b += 32) {
          const bool pick = b + lane < wn && srow[b + lane] > 0.f;
          const unsigned bal = __ballot_sync(kFull, pick);
          if (pick) lists[j * chunk + c + __popc(bal & below)] =
              (uint16_t)(b + lane);
          c += __popc(bal);
        }
        if (lane == 0) cnt[j] = c;
      }
      __syncthreads();
      if (!active) continue;

      uint32_t acc[G][16];
      int cur = -1;           // the step whose registers acc holds
      int j = 0, i = 0;       // the walk's next (step, list position)
      auto finish = [&](int upto) {
        // store step cur, then zeros for the empty steps before `upto`
        if (cur >= 0) {
          Words<G> o;
#pragma unroll
          for (int g = 0; g < G; ++g) pack16(acc[g], o.w + 3 * g);
          o.store(dst + (long long)(s0 + cur) * nw);
        }
        if (w0 == 0) {
          Words<G> z;
#pragma unroll
          for (int k = 0; k < 3 * G; ++k) z.w[k] = 0u;
          for (int e = cur + 1; e < upto; ++e)
            z.store(dst + (long long)(s0 + e) * nw);
        }
      };
      while (true) {
        int js[kInFlight], cs[kInFlight];
        Words<G> d[kInFlight];
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          while (j < sn && i >= cnt[j]) {
            ++j;
            i = 0;
          }
          js[u] = j;
          cs[u] = 0;
          if (j < sn) {
            cs[u] = w0 + lists[j * chunk + i];
            ++i;
            d[u].load(src + (long long)cs[u] * nw);
          }
        }
        if (js[0] >= sn) break;
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          if (js[u] >= sn) break;
          if (js[u] != cur) {
            finish(js[u]);
            cur = js[u];
            if (w0 == 0) {
#pragma unroll
              for (int g = 0; g < G; ++g)
#pragma unroll
                for (int k = 0; k < 16; ++k) acc[g][k] = 0u;
            } else {  // a later chunk: start from the step's registers
              Words<G> o;
              o.load(dst + (long long)(s0 + cur) * nw);
#pragma unroll
              for (int g = 0; g < G; ++g) {
#pragma unroll
                for (int k = 0; k < 16; ++k) acc[g][k] = 0u;
                max16(o.w[3 * g], o.w[3 * g + 1], o.w[3 * g + 2], acc[g]);
              }
            }
          }
#pragma unroll
          for (int g = 0; g < G; ++g)
            max16(d[u].w[3 * g], d[u].w[3 * g + 1], d[u].w[3 * g + 2],
                  acc[g]);
        }
      }
      finish(sn);
    }
    w0 += chunk;
  } while (w0 < W);
}

template <int G>
int launch(const void* rows, const void* idx, long long ring_rows,
           const void* sel, void* out, long long n, int w, int nw, int s,
           cudaStream_t stream) {
  const int tpr = nw / (3 * G);
  const int chunk = w < kChunk ? (w > 0 ? w : 1) : kChunk;
  const int group = s < kGroup ? s : kGroup;
  const long long blocks = (n * tpr + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)group * chunk * sizeof(uint16_t);
  merge_windows_kernel<G><<<(unsigned)blocks, kThreads, smem, stream>>>(
      (const uint32_t*)rows, (const int32_t*)idx, ring_rows,
      (const float*)sel, (uint32_t*)out, n, w, nw, s, tpr, chunk, group);
  return (int)cudaGetLastError();
}

}  // namespace

// rows i32[ring_rows, w, nw]; idx i32[n] or null (then ring_rows == n);
// sel f32[s, w]; out i32[n, s, nw].
extern "C" int vt_merge_windows(const void* rows, const void* idx,
                                const void* sel, void* out,
                                long long ring_rows, long long n, long long w,
                                long long nw, long long s, int precision,
                                void* stream) {
  if (precision < 4 || precision > 18 || nw != (3LL << precision) / 16 ||
      w < 0 || w > 0x7fffffffLL || s > 0x7fffffffLL || ring_rows <= 0 ||
      (idx == nullptr && ring_rows != n))
    return (int)cudaErrorInvalidValue;
  if (n <= 0 || s <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const bool vec = precision >= 6 && ((uintptr_t)rows & 15) == 0 &&
                   ((uintptr_t)out & 15) == 0;
  return vec ? launch<4>(rows, idx, ring_rows, sel, out, n, (int)w, (int)nw,
                         (int)s, st)
             : launch<1>(rows, idx, ring_rows, sel, out, n, (int)w, (int)nw,
                         (int)s, st);
}
