// Masked window merge of 6-bit packed HLL rows (the history tier's set
// range query).
//
// Replaces the Pallas kernel veneur_tpu/ops/pallas_history.py
// merge_windows_packed (_merge_kernel). rows i32[N, W, nw] hold one
// packed HLL row per (key, ring column); sel f32[S, W] selects, per
// range step, the ring columns that cover it. For every row n and step
// s: out[n, s] = pack(max over w with sel[s, w] > 0 of unpack(rows[n,
// w])). A step that selects nothing gives all-zero words (zero is the
// register-max identity), so zero padding never changes a result.
//
// What bounds it on an H100: bytes. Per selected column it reads nw
// words of each row and does 16 shift/mask/max per 3 words, far below
// the fp32 rate; at N = 256, nw = 3072 one column is 3 MB, so a step
// over all 360 columns of the default ring streams 1.13 GB.
// Design: one thread per (row, 3-word group). 16 registers fill exactly
// 3 words, so a thread unpacks its group with uint32 shifts (the fields
// at in-word bits 30 and 28 straddle into the next word of the same
// group, never into another thread's), keeps the 16 lanes in registers
// and needs no atomics. Neighbouring threads read neighbouring 12-byte
// groups, so a warp's loads cover 384 contiguous bytes. Each block
// serves one (row, step, group block): it compacts the step's mask row
// into a column list in shared memory (a warp ballot per 32 columns,
// keeping the `> 0` test, so a NaN never selects), then reads only the
// selected columns -- a planned step selects O(tiers + log W) of them.
// The step is the fastest-varying block index, so the blocks of one
// (row, group block) run together and a column shared by several steps
// is read from DRAM once and from L2 after. The TPU kernel's
// accumulator carried across its column grid axis (legal only because
// the TPU grid runs in order) becomes the column loop inside the
// thread; its row/column tiles and padding are not carried over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kUnroll = 4;

__device__ __forceinline__ void unpack16(uint32_t w0, uint32_t w1,
                                         uint32_t w2, uint32_t* r) {
  r[0] = w0 & 63u;
  r[1] = (w0 >> 6) & 63u;
  r[2] = (w0 >> 12) & 63u;
  r[3] = (w0 >> 18) & 63u;
  r[4] = (w0 >> 24) & 63u;
  r[5] = (w0 >> 30) | ((w1 & 0xFu) << 2);
  r[6] = (w1 >> 4) & 63u;
  r[7] = (w1 >> 10) & 63u;
  r[8] = (w1 >> 16) & 63u;
  r[9] = (w1 >> 22) & 63u;
  r[10] = (w1 >> 28) | ((w2 & 0x3u) << 4);
  r[11] = (w2 >> 2) & 63u;
  r[12] = (w2 >> 8) & 63u;
  r[13] = (w2 >> 14) & 63u;
  r[14] = (w2 >> 20) & 63u;
  r[15] = w2 >> 26;
}

__global__ void merge_windows_kernel(const uint32_t* __restrict__ rows,
                                     const float* __restrict__ sel,
                                     uint32_t* __restrict__ out, int W,
                                     int nw, int S, int groups,
                                     int group_blocks) {
  extern __shared__ int cols[];  // the step's selected columns, ascending
  __shared__ int warp_cnt[kMaxThreads / 32];

  const long long b = blockIdx.x;
  const int s = (int)(b % S);
  const long long rest = b / S;
  const int gb = (int)(rest % group_blocks);
  const long long n = rest / group_blocks;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;  // blockDim.x is a multiple of 32

  const float* srow = sel + (long long)s * W;
  int total = 0;
  for (int base = 0; base < W; base += blockDim.x) {
    const int w = base + tid;
    const bool pick = w < W && srow[w] > 0.f;
    const unsigned ballot = __ballot_sync(0xffffffffu, pick);
    if (lane == 0) warp_cnt[warp] = __popc(ballot);
    __syncthreads();
    int off = total;
    for (int i = 0; i < warp; ++i) off += warp_cnt[i];
    if (pick) cols[off + __popc(ballot & ((1u << lane) - 1u))] = w;
    for (int i = 0; i < n_warps; ++i) total += warp_cnt[i];
    __syncthreads();  // warp_cnt is rewritten by the next chunk
  }

  const int g = gb * blockDim.x + tid;
  if (g >= groups) return;
  uint32_t acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0u;
  const uint32_t* grp = rows + n * (long long)W * nw + 3LL * g;
  // kUnroll columns' loads are issued before any of them is unpacked, so
  // a step over many columns keeps several loads in flight per thread
  int i = 0;
  for (; i + kUnroll <= total; i += kUnroll) {
    uint32_t wd[kUnroll][3];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint32_t* p = grp + (long long)cols[i + u] * nw;
      wd[u][0] = p[0];
      wd[u][1] = p[1];
      wd[u][2] = p[2];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      uint32_t r[16];
      unpack16(wd[u][0], wd[u][1], wd[u][2], r);
#pragma unroll
      for (int k = 0; k < 16; ++k) acc[k] = max(acc[k], r[k]);
    }
  }
  for (; i < total; ++i) {
    const uint32_t* p = grp + (long long)cols[i] * nw;
    uint32_t r[16];
    unpack16(p[0], p[1], p[2], r);
#pragma unroll
    for (int k = 0; k < 16; ++k) acc[k] = max(acc[k], r[k]);
  }
  uint32_t* o = out + (n * S + s) * (long long)nw + 3LL * g;
  o[0] = acc[0] | (acc[1] << 6) | (acc[2] << 12) | (acc[3] << 18) |
         (acc[4] << 24) | ((acc[5] & 0x3u) << 30);
  o[1] = (acc[5] >> 2) | (acc[6] << 4) | (acc[7] << 10) | (acc[8] << 16) |
         (acc[9] << 22) | ((acc[10] & 0xFu) << 28);
  o[2] = (acc[10] >> 4) | (acc[11] << 2) | (acc[12] << 8) |
         (acc[13] << 14) | (acc[14] << 20) | (acc[15] << 26);
}

}  // namespace

extern "C" int vt_merge_windows(const void* rows, const void* sel, void* out,
                                long long n, long long w, long long nw,
                                long long s, int precision, void* stream) {
  if (precision < 4 || precision > 18 || nw != (3LL << precision) / 16 ||
      w < 0 || w * (long long)sizeof(int) > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  if (n <= 0 || s <= 0) return (int)cudaGetLastError();
  const long long groups = nw / 3;
  int threads = 32;
  while (threads < kMaxThreads && threads < groups) threads <<= 1;
  const long long group_blocks = (groups + threads - 1) / threads;
  const long long blocks = n * s * group_blocks;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  merge_windows_kernel<<<(unsigned)blocks, threads,
                         (size_t)w * sizeof(int), (cudaStream_t)stream>>>(
      (const uint32_t*)rows, (const float*)sel, (uint32_t*)out, (int)w,
      (int)nw, (int)s, (int)groups, (int)group_blocks);
  return (int)cudaGetLastError();
}
