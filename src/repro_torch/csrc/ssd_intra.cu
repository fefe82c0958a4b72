// Mamba-2 SSD intra-chunk dual form: a causal, decay-weighted product.
//
// Replaces the TPU kernel src/repro/kernels/ssd_intra/ssd_intra.py
// (ssd_intra, the pallas_call at line 52); the wrapper is
// src/repro_torch/kernels/ssd_intra.py:ssd_intra, which the port's
// models/ssm.py:ssd_chunked calls for the intra-chunk term of every
// prefill layer on the card.
//
// What it computes, per chunk c (batch x chunks folded) and head h:
//   Y[c, q, h, :] = sum_{k <= q} CB[c, q, k] * exp(cs[c, q, h] - cs[c, k, h])
//                   * Win[c, k, h, :]
// with fp32 arithmetic and Y in Win's dtype.  cs is a decreasing cumsum,
// so above the diagonal exp(cs[q] - cs[k]) overflows to inf; the kernel
// selects 0 there before any product (inf * 0 would be NaN), as the
// reference's jnp.where does.
//
// What bounds it on the H100: operations.  At the Mamba2-2.7B prefill
// shape (8 chunks of Q 256, 80 heads, P 64, fp32) the causal triangle
// is 2.7 GFLOP against 87 MB of traffic: 40 us at the card's 67 TFLOP/s
// fp32 rate against 26 us of bytes.  The TPU kernel took one (chunk,
// head) per grid step with the whole [Q, Q] tile in VMEM and one MXU
// dot.  A Hopper block has 227 KB of shared memory, so one block of 256
// threads per (chunk, head) keeps its chunk's cs column in shared
// memory and walks the keys in tiles of 32: each tile stages the
// decay-masked scores S[q, k] (computed once, exp in fp32, masked by
// select) and the [32, P] slice of Win, then every thread accumulates
// its 8 rows x P/8 columns of Y in fp32 registers.  A thread's rows are
// strided (ty, ty + 32, ...) so the causal triangle spreads evenly, and
// rows above a tile's first key skip it.  The [Q, Q] CB tile of a chunk
// is read once per head, from L2 after the first.  Tensor cores are left
// for a later version.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TK = 32;               // keys per tile
constexpr int TY = 32;               // threads across rows
constexpr int TX = 8;                // threads across head dims
constexpr int NT = TY * TX;          // 256 threads
constexpr int RPT = 8;               // rows per thread: Q <= TY * RPT
constexpr int MAX_Q = TY * RPT;      // 256
constexpr int SS = TK + 1;           // padded row stride of the S tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_f(float x, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(x);
}

inline int smem_bytes(int q, int p) { return (q + q * SS + TK * p) * 4; }

template <typename T, int CPT>
__global__ void __launch_bounds__(NT) ssd_intra_kernel(
    const T* __restrict__ cb, const T* __restrict__ cs,
    const T* __restrict__ win, T* __restrict__ out, int q, int h, int p) {
  extern __shared__ float smem[];
  float* scs = smem;                 // [Q]       cs[c, :, h]
  float* s_s = scs + q;              // [Q][SS]   masked decayed scores
  float* s_w = s_s + q * SS;         // [TK][P]   Win[c, k0:k0+TK, h, :]

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int hh = blockIdx.x;
  const long long c = blockIdx.y;
  const T* cbc = cb + c * q * q;

  for (int i = tid; i < q; i += NT) scs[i] = to_f(cs[(c * q + i) * h + hh]);

  float acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < q; k0 += TK) {
    __syncthreads();                 // cs staged / last tile consumed
    const int tk = min(TK, q - k0);
    // scores of rows >= k0 only: rows above the tile take nothing from it
    for (int i = tid; i < (q - k0) * TK; i += NT) {
      const int r = k0 + i / TK, kk = i % TK, kp = k0 + kk;
      float sv = 0.f;
      if (kk < tk && kp <= r)
        sv = to_f(cbc[r * q + kp]) * expf(scs[r] - scs[kp]);
      s_s[r * SS + kk] = sv;
    }
    for (int i = tid; i < tk * p; i += NT) {
      const int kk = i / p, d = i % p;
      s_w[kk * p + d] = to_f(win[((c * q + k0 + kk) * h + hh) * p + d]);
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = ty + TY * i;
      if (r >= q || r < k0) continue;
      const int kmax = min(tk, r - k0 + 1);
      for (int kk = 0; kk < kmax; ++kk) {
        const float sv = s_s[r * SS + kk];
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const int d = tx + TX * j;
          if (d < p) acc[i][j] += sv * s_w[kk * p + d];
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = ty + TY * i;
    if (r >= q) continue;
    T* orow = out + ((c * q + r) * h + hh) * p;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int d = tx + TX * j;
      if (d < p) from_f(acc[i][j], &orow[d]);
    }
  }
}

template <typename T, int CPT>
int launch_typed(const void* cb, const void* cs, const void* win, void* out,
                 int bc, int q, int h, int p, cudaStream_t stream) {
  const int bytes = smem_bytes(q, p);
  static int configured = 0;         // largest size the attribute allows
  if (bytes > configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_intra_kernel<T, CPT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = bytes;
  }
  dim3 grid(h, bc);
  ssd_intra_kernel<T, CPT><<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(cb), static_cast<const T*>(cs),
      static_cast<const T*>(win), static_cast<T*>(out), q, h, p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_p(const void* cb, const void* cs, const void* win, void* out,
             int bc, int q, int h, int p, cudaStream_t stream) {
  if (p <= 2 * TX)
    return launch_typed<T, 2>(cb, cs, win, out, bc, q, h, p, stream);
  if (p <= 4 * TX)
    return launch_typed<T, 4>(cb, cs, win, out, bc, q, h, p, stream);
  if (p <= 8 * TX)
    return launch_typed<T, 8>(cb, cs, win, out, bc, q, h, p, stream);
  if (p <= 16 * TX)
    return launch_typed<T, 16>(cb, cs, win, out, bc, q, h, p, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// cb [bc, q, q], cs [bc, q, h], win and out [bc, q, h, p], all contiguous
// and of one dtype (bf16: 1 = bfloat16, 0 = float32).  Returns a CUDA
// error code (0 = none); q > 256 or p > 128 is cudaErrorInvalidValue.
extern "C" int ssd_intra_launch(const void* cb, const void* cs,
                                const void* win, void* out, int bc, int q,
                                int h, int p, int bf16, void* stream) {
  if (bc == 0 || q == 0 || h == 0 || p == 0) return 0;
  if (q > MAX_Q || p > 16 * TX) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_p<__nv_bfloat16>(cb, cs, win, out, bc, q, h, p, st);
  return launch_p<float>(cb, cs, win, out, bc, q, h, p, st);
}
