// Forward GQA flash attention with an online fp32 softmax.
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py
// (flash_attention, the pallas_call at line 90); the wrapper is
// src/repro_torch/kernels/flash_attention.py:flash_attention, which the
// model's attention() (src/repro_torch/models/attention.py) calls for
// every prefill self-attention on the card.
//
// What it computes: for each batch b, query head h and query row i,
// softmax_j(q[b,h,i] . k[b,h/G,j] / sqrt(hd)) over the keys j < S (and
// j <= i when causal), times v, in fp32; the output has q's dtype.  Any
// S: the ragged last tile is masked.  q, k, v and out are read and
// written through (batch, head, sequence) strides with a contiguous last
// dimension, so the model passes its [B, S, H, hd] tensors as
// transposed views and nothing is copied.
//
// What bounds it on the H100: bytes, for a kernel on the tensor cores.
// At the Qwen3-1.7B prefill shape (B 4, S 512, 16 q heads, 8 kv heads,
// hd 128, causal) the causal half is 4.3 GFLOP of products against
// 25 MB of traffic: 4.4 us at the bf16 tensor-core rate against 7.5 us
// of bytes at 3.35 TB/s.  This version runs its products as fp32 FMAs
// on the CUDA cores, so its own limit is the FMA rate and the shared-
// memory reads that feed it.
// The TPU kernel kept the running max, sum and accumulator in VMEM
// scratch across a sequential k-block grid axis.  Here one block of 256
// threads owns a 64-row q tile of one (batch, q head) and loops over
// 32-key tiles itself; the state stays in registers: thread (ty, tx)
// owns rows 4ty..4ty+3, score columns tx and tx+16 of each key tile,
// and output dims tx + 16n.  A row's max and sum reduce over the 16
// lanes that share it with shuffles.  The q tile and each k/v tile are
// staged in shared memory as fp32 (k and q rows padded to hd+1 floats
// so the 16 lanes of a row read 16 banks); the probabilities go through
// shared memory to the P.V product.  Key tiles wholly above the causal
// diagonal are never visited (the loop stops at the tile's last row),
// like the Pallas kernel's pl.when skip.  GQA is an index: the kv head
// is h / G, K/V are never expanded.  Tensor cores (mma.sync / wgmma),
// TMA and split-K are left for a later version.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;               // q rows per block
constexpr int BK = 32;               // keys per tile
constexpr int NT = 256;              // threads per block (16 x 16)
constexpr int PS = BK + 1;           // padded row stride of the P tile
constexpr float NEG = -1e30f;        // the JAX kernel's NEG_INF

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_f(float x, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(x);
}

// reductions over the 16 lanes (tx) that share a row
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

struct Strides {
  long long b, h, s;
};

template <int HD>
constexpr int smem_bytes() {
  return (BQ * (HD + 1) + BK * (HD + 1) + BK * HD + BQ * PS) * 4;
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, Strides qs, Strides ks,
    Strides vs, Strides os, int hq, int hkv, int s, float scale,
    int causal) {
  constexpr int QS = HD + 1;         // padded row stride of q and k tiles
  constexpr int DPT = HD / 16;       // output dims per thread
  extern __shared__ float smem[];
  float* sq = smem;                  // [BQ][QS]
  float* sk = sq + BQ * QS;          // [BK][QS]
  float* sv = sk + BK * QS;          // [BK][HD]
  float* sp = sv + BK * HD;          // [BQ][PS]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.y;
  const int b = bh / hq;
  const int h = bh % hq;
  const int kh = h / (hq / hkv);
  const int q0 = blockIdx.x * BQ;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + kh * ks.h;
  const T* vb = v + b * vs.b + kh * vs.h;

  for (int i = tid; i < BQ * HD; i += NT) {
    const int r = i / HD, d = i % HD;
    const int pos = q0 + r;
    sq[r * QS + d] = pos < s ? to_f(qb[pos * qs.s + d]) : 0.f;
  }

  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DPT; ++e) acc[i][e] = 0.f;
  }

  const int k_end = causal ? min(s, q0 + BQ) : s;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();                 // q tile staged / last tile consumed
    for (int i = tid; i < BK * HD; i += NT) {
      const int r = i / HD, d = i % HD;
      const int pos = k0 + r;
      float kf = 0.f, vf = 0.f;
      if (pos < s) {
        kf = to_f(kb[pos * ks.s + d]);
        vf = to_f(vb[pos * vs.s + d]);
      }
      sk[r * QS + d] = kf;
      sv[r * HD + d] = vf;
    }
    __syncthreads();

    float sc[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) sc[i][0] = sc[i][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      const float k0f = sk[tx * QS + d];
      const float k1f = sk[(tx + 16) * QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float qf = sq[(ty * 4 + i) * QS + d];
        sc[i][0] += qf * k0f;
        sc[i][1] += qf * k1f;
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      bool ok[2];
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kpos = k0 + tx + 16 * j;
        ok[j] = kpos < s && (!causal || kpos <= qpos);
        sc[i][j] = ok[j] ? sc[i][j] * scale : NEG;
        mx = fmaxf(mx, sc[i][j]);
      }
      mx = row_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        // select, never multiply a masked score: exp(NEG - NEG) is 1
        const float p = ok[j] ? expf(sc[i][j] - m_new) : 0.f;
        sp[(ty * 4 + i) * PS + tx + 16 * j] = p;
        ps += p;
      }
      l[i] = l[i] * corr + row_sum(ps);
#pragma unroll
      for (int e = 0; e < DPT; ++e) acc[i][e] *= corr;
      m[i] = m_new;
    }
    __syncthreads();

    const int j_end = min(BK, k_end - k0);
    for (int j = 0; j < j_end; ++j) {
      float vf[DPT];
#pragma unroll
      for (int e = 0; e < DPT; ++e) vf[e] = sv[j * HD + tx + 16 * e];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = sp[(ty * 4 + i) * PS + j];
#pragma unroll
        for (int e = 0; e < DPT; ++e) acc[i][e] += p * vf[e];
      }
    }
  }

  T* ob = out + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int pos = q0 + ty * 4 + i;
    if (pos >= s) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int e = 0; e < DPT; ++e)
      from_f(acc[i][e] * inv, &ob[pos * os.s + tx + 16 * e]);
  }
}

template <typename T, int HD>
int launch_typed(const void* q, const void* k, const void* v, void* out,
                 Strides qs, Strides ks, Strides vs, Strides os, int b,
                 int hq, int hkv, int s, float scale, int causal,
                 cudaStream_t stream) {
  constexpr int bytes = smem_bytes<HD>();
  static bool configured = false;    // the attribute is per function
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel<T, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  dim3 grid((s + BQ - 1) / BQ, b * hq);
  flash_attention_kernel<T, HD><<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), qs, ks, vs, os, hq,
      hkv, s, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v,
              void* out, Strides qs, Strides ks, Strides vs, Strides os,
              int b, int hq, int hkv, int s, float scale, int causal,
              cudaStream_t stream) {
  switch (hd) {
    case 64:
      return launch_typed<T, 64>(q, k, v, out, qs, ks, vs, os, b, hq, hkv,
                                 s, scale, causal, stream);
    case 128:
      return launch_typed<T, 128>(q, k, v, out, qs, ks, vs, os, b, hq,
                                  hkv, s, scale, causal, stream);
    case 256:
      return launch_typed<T, 256>(q, k, v, out, qs, ks, vs, os, b, hq,
                                  hkv, s, scale, causal, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// strides: 12 element strides, (batch, head, sequence) for q, k, v, out
// in that order.  bf16: 1 = all four tensors bfloat16, 0 = float32.
// Returns a CUDA error code (0 = none); hd outside {64, 128, 256} is
// cudaErrorInvalidValue.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out,
    const long long* strides, int b, int hq, int hkv, int s, int hd,
    float scale, int causal, int bf16, void* stream) {
  if (b == 0 || s == 0) return 0;
  const Strides qs{strides[0], strides[1], strides[2]};
  const Strides ks{strides[3], strides[4], strides[5]};
  const Strides vs{strides[6], strides[7], strides[8]};
  const Strides os{strides[9], strides[10], strides[11]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_hd<__nv_bfloat16>(hd, q, k, v, out, qs, ks, vs, os, b, hq,
                                    hkv, s, scale, causal, st);
  return launch_hd<float>(hd, q, k, v, out, qs, ks, vs, os, b, hq, hkv, s,
                          scale, causal, st);
}
