// One-token GQA decode attention through a page table.
//
// Replaces the TPU kernel
// src/repro/kernels/paged_attention/paged_attention.py
// (paged_attention, the pallas_call at line 108), reached through
// kernels/paged_attention/ops.py:decode_paged; the wrapper is
// src/repro_torch/kernels/paged_attention.py:decode_paged.
//
// What it computes: for each sequence b and query head h, softmax of
// q[b, h] . k[t] / sqrt(hd) over the tokens t < lens[b] of the pages
// page_tbl[b, :], times v, in fp32 with an online softmax; the output
// has q's dtype and is zero where lens[b] == 0.  k and v are read
// through a page stride, so the serving pool passes zero-copy views of
// its int32 payload lanes.
//
// What bounds it on the H100: bytes.  Each k/v element of a valid
// token is read once (16 MiB at the serving shapes with full 256-token
// windows: about 5 us at 3.35 TB/s); the arithmetic is 4 flops per k/v
// element pair per query head, far below the card's rate.  The TPU
// kernel walked a (B, max_pages) grid in order, keeping its softmax
// accumulators in VMEM across pages.  Here one block per (b, kv head)
// owns the whole window.  Its warps are (query head of the group) x
// (slice of the window): with Hq/Hkv = 2, eight warps per head take
// every eighth CHUNK of tokens each, so the serial chain of dependent
// loads is an eighth of the window.  Each warp keeps its fp32 online
// softmax state in registers (lanes across hd/32 contiguous dims),
// loads a chunk's k rows (then v rows) all at once, and at the end the
// slices of a head merge their (max, sum, acc) states through shared
// memory.  The block reads only the table entries of its
// ceil(lens[b]/page) valid pages — entries past them may be -1.  The
// warps of a group read the same k/v rows; the second read comes from
// L1.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int CHUNK = 16;            // tokens in flight per warp
constexpr int MAX_WARPS = 32;        // 1024 threads: Hq/Hkv <= 32
constexpr int TARGET_WARPS = 16;     // warps per block when the group allows
constexpr float NEG_INIT = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_f(float x, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename QT, typename KT, int EPL>
__global__ void paged_attention_kernel(
    const QT* __restrict__ q, const KT* __restrict__ k,
    const KT* __restrict__ v, long long page_stride,
    const int32_t* __restrict__ page_tbl, const int32_t* __restrict__ lens,
    QT* __restrict__ out, int hq, int hkv, int page, int max_pages,
    int n_pool, float scale, int n_split) {
  constexpr int HD = EPL * 32;
  __shared__ float s_m[MAX_WARPS], s_l[MAX_WARPS];
  __shared__ float s_acc[MAX_WARPS][HD];
  const int b = blockIdx.x;
  const int kh = blockIdx.y;
  const int group = hq / hkv;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int j = warp % group;             // query head within the group
  const int split = warp / group;         // slice of the window
  const int h = kh * group + j;
  const int d0 = lane * EPL;

  float qv[EPL], acc[EPL];
  const QT* qrow = q + (static_cast<long long>(b) * hq + h) * HD + d0;
#pragma unroll
  for (int e = 0; e < EPL; ++e) {
    qv[e] = to_f(qrow[e]);
    acc[e] = 0.f;
  }
  float m = NEG_INIT, l = 0.f;
  int len = lens[b];
  if (len > max_pages * page) len = max_pages * page;
  const int32_t* tbl = page_tbl + static_cast<long long>(b) * max_pages;
  const long long tok_stride = static_cast<long long>(hkv) * HD;

  for (int t0 = split * CHUNK; t0 < len; t0 += n_split * CHUNK) {
    float s[CHUNK];
    long long off[CHUNK];
    bool ok[CHUNK];
#pragma unroll
    for (int c = 0; c < CHUNK; ++c) {
      const int t = t0 + c;
      ok[c] = false;
      off[c] = 0;
      if (t < len) {
        const int pg = tbl[t / page];
        ok[c] = pg >= 0 && pg < n_pool;
        off[c] = static_cast<long long>(pg) * page_stride +
                 (t % page) * tok_stride + static_cast<long long>(kh) * HD +
                 d0;
      }
    }
#pragma unroll
    for (int c = 0; c < CHUNK; ++c) {
      float part = 0.f;
      if (ok[c]) {
#pragma unroll
        for (int e = 0; e < EPL; ++e) part += qv[e] * to_f(k[off[c] + e]);
      }
      s[c] = warp_sum(part) * scale;
    }
    float m_new = m;
#pragma unroll
    for (int c = 0; c < CHUNK; ++c)
      if (ok[c]) m_new = fmaxf(m_new, s[c]);
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[e] *= corr;
#pragma unroll
    for (int c = 0; c < CHUNK; ++c) {
      if (ok[c]) {
        const float p = expf(s[c] - m_new);
        l += p;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[e] += p * to_f(v[off[c] + e]);
      }
    }
    m = m_new;
  }

  // merge the slices of each head: rescale to the largest max, sum
  if (lane == 0) {
    s_m[warp] = m;
    s_l[warp] = l;
  }
#pragma unroll
  for (int e = 0; e < EPL; ++e) s_acc[warp][d0 + e] = acc[e];
  __syncthreads();
  if (split != 0) return;
  float mx = NEG_INIT;
  for (int sp = 0; sp < n_split; ++sp) mx = fmaxf(mx, s_m[sp * group + j]);
  float total = 0.f, o[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) o[e] = 0.f;
  for (int sp = 0; sp < n_split; ++sp) {
    const int w = sp * group + j;
    const float f = expf(s_m[w] - mx);
    total += s_l[w] * f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) o[e] += s_acc[w][d0 + e] * f;
  }
  const float denom = fmaxf(total, 1e-30f);
  QT* orow = out + (static_cast<long long>(b) * hq + h) * HD + d0;
#pragma unroll
  for (int e = 0; e < EPL; ++e) from_f(o[e] / denom, &orow[e]);
}

template <typename QT, typename KT>
int launch_typed(const void* q, const void* k, const void* v,
                 long long page_stride, const void* tbl, const void* lens,
                 void* out, int b, int hq, int hkv, int hd, int page,
                 int max_pages, int n_pool, float scale, cudaStream_t s) {
  const int group = hq / hkv;
  const int n_split = group >= TARGET_WARPS ? 1 : TARGET_WARPS / group;
  dim3 grid(b, hkv);
  dim3 block(32 * group * n_split);
#define REPRO_PA_LAUNCH(EPL)                                                \
  paged_attention_kernel<QT, KT, EPL><<<grid, block, 0, s>>>(              \
      static_cast<const QT*>(q), static_cast<const KT*>(k),                 \
      static_cast<const KT*>(v), page_stride,                               \
      static_cast<const int32_t*>(tbl), static_cast<const int32_t*>(lens),  \
      static_cast<QT*>(out), hq, hkv, page, max_pages, n_pool, scale,     \
      n_split)
  switch (hd) {
    case 64: REPRO_PA_LAUNCH(2); break;
    case 128: REPRO_PA_LAUNCH(4); break;
    case 256: REPRO_PA_LAUNCH(8); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_PA_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q_bf16 / kv_bf16: 1 = bfloat16, 0 = float32.  Returns a CUDA error
// code (0 = none); hd outside {64, 128, 256} is cudaErrorInvalidValue.
extern "C" int paged_attention_launch(
    const void* q, const void* k, const void* v, long long page_stride,
    const void* tbl, const void* lens, void* out, int b, int hq, int hkv,
    int hd, int page, int max_pages, int n_pool, float scale, int q_bf16,
    int kv_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b == 0) return 0;
  if (q_bf16 && kv_bf16)
    return launch_typed<__nv_bfloat16, __nv_bfloat16>(
        q, k, v, page_stride, tbl, lens, out, b, hq, hkv, hd, page,
        max_pages, n_pool, scale, s);
  if (q_bf16)
    return launch_typed<__nv_bfloat16, float>(
        q, k, v, page_stride, tbl, lens, out, b, hq, hkv, hd, page,
        max_pages, n_pool, scale, s);
  if (kv_bf16)
    return launch_typed<float, __nv_bfloat16>(
        q, k, v, page_stride, tbl, lens, out, b, hq, hkv, hd, page,
        max_pages, n_pool, scale, s);
  return launch_typed<float, float>(q, k, v, page_stride, tbl, lens, out,
                                    b, hq, hkv, hd, page, max_pages, n_pool,
                                    scale, s);
}
