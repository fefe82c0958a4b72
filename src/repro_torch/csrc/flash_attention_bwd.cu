// Backward of the GQA flash attention K4 (flash_attention.cu).
//
// The TPU kernel src/repro/kernels/flash_attention/flash_attention.py
// (flash_attention, the pallas_call at line 90) is forward-only: JAX
// differentiates its model through the jnp attention
// (src/repro/models/attention.py).  The port runs K4 in the forward pass
// on the card, so its autograd Function
// (src/repro_torch/kernels/flash_attention.py) needs this backward; the
// wrapper is flash_attention_bwd there, beside its plain version
// flash_attention_bwd_plain.
//
// What it computes: FlashAttention-2's recurrence.  With s = scale q.k
// over the visible keys (the forward's mask: causal, window, Sq != Sk,
// q_offset), P = exp(s - lse) from the forward's saved log-sum-exp,
// D = rowsum(dO o O),
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - D),
//   dK = scale dS^T Q,  dQ = scale dS K,
// summed over the G = Hq / Hkv query heads of each kv head for dK and
// dV.  No atomics: two launches, each output written by one block, so
// the gradients are the same from run to run.
//   1. flash_attention_bwd_dq_kernel: a block owns a 64-row q tile of one
//      (batch, q head) and walks its visible key tiles, as the forward
//      does; before the walk it computes D for its rows and stores it
//      (delta, fp32 [B, Hq, Sq]).
//   2. flash_attention_bwd_dkdv_kernel: a block owns a 64-key tile of one
//      (batch, kv head) and walks the q tiles of 32 rows that see it, for
//      each of the group's q heads, reading the D the first launch wrote.
// Masked pairs are selected to 0 before any product (exp of a masked
// score is never taken), with the same predicates as the forward; only
// the tiles that cross a mask edge evaluate them.
//
// bf16 inputs (the model's card path): mma.sync.m16n8k16 bf16 products
// with fp32 sums, fragments by ldmatrix from XOR-swizzled shared tiles
// fed by cp.async (two-stage rings), as in the forward.  P is rounded to
// bf16 before dV = P^T dO and dS before dK and dQ, as the forward rounds
// P before P.V; dP, D and the softmax are fp32.  Four warps; in kernel 1
// each warp owns 16 q rows (Q fragments kept in registers, dO re-read
// from shared memory), in kernel 2 each warp owns 16 keys and keeps its
// dK and dV accumulators (16 x hd fp32 each) in registers.  Head dims 64
// and 128; hd 256 (recurrentgemma-2b) is refused.
//
// fp32 inputs: flash_attention_bwd_f32_kernel, scalar FMAs on the CUDA
// cores from fp32 shared tiles of 32 rows and 32 keys (256 threads; rows
// padded to hd + 1 floats), in the two roles above (DKDV false: dQ and
// D; true: dK and dV).  TF32 would lose digits that the fp32 tolerance
// holds.
//
// What bounds it on the H100: at the Qwen3-1.7B training shape (B 4,
// S 512, Hq 16, Hkv 8, hd 128, causal) bytes: q, out, dout and dq (8.4 MB
// each), k, v, dk and dv (4.2 MB each) and lse, 50.5 MB, 15.1 us at 3.35
// TB/s, against five products of 2 pairs hd operations, 10.8 GFLOP, 10.9
// us at the bf16 tensor-core peak.  At llava's offset shape (512 rows
// over 1664 keys, 32 q heads) operations bound it.  Left for later:
// wgmma, TMA, a deeper ring, K/V fragments kept in registers in kernel 2.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_bf16.cuh"

namespace {

using namespace mma_bf16;

constexpr float LOG2E = 1.4426950408889634f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;      // [B, Hq, Sq]
  float* delta;          // [B, Hq, Sq], written by the dQ pass
  void* dq;
  void* dk;
  void* dv;
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
  int hq, hkv, sq, sk, q_offset, causal, window;
  float scale;
};

// key `key` visible to query row i (at position q_offset + i)
__device__ __forceinline__ bool visible(const Args& a, int i, int key) {
  const int pos = a.q_offset + i;
  return (i < a.sq) & (key < a.sk) & (!a.causal | (key <= pos)) &
         ((a.window == 0) | (key > pos - a.window));
}

// the key tiles of size bk that the q rows [i0, i0 + rows) see: [kb, ke)
__device__ __forceinline__ void key_range(const Args& a, int i0, int rows,
                                          int bk, int& kb, int& ke) {
  const int p0 = a.q_offset + i0;
  ke = a.causal ? min(a.sk, p0 + min(rows, a.sq - i0)) : a.sk;
  kb = a.window > 0 ? max(0, p0 - a.window + 1) / bk * bk : 0;
}

// the q rows (in tiles of bq) that see a key of [k0, k0 + cols): [ib, ie)
__device__ __forceinline__ void query_range(const Args& a, int k0, int cols,
                                            int bq, int& ib, int& ie) {
  ib = a.causal ? max(0, k0 - a.q_offset) / bq * bq : 0;
  ie = a.window > 0 ? min(a.sq, k0 + cols - 1 + a.window - a.q_offset)
                    : a.sq;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ------------------------------------------------- bf16: tensor cores

namespace tc {

constexpr int NW = 4;                // warps a block
constexpr int NT = NW * 32;
constexpr int BQ = 64;               // q rows a dQ block (16 a warp)
constexpr int BK = 64;               // keys a tile (16 a warp in dK/dV)
constexpr int BQ2 = 32;              // q rows a step of the dK/dV walk
constexpr int STAGES = 2;

template <int HD>
constexpr int dq_smem() {
  return (2 * BQ + 2 * STAGES * BK) * HD * 2 + BQ * 4;
}
template <int HD>
constexpr int dkdv_smem() {
  return (2 * BK + 2 * STAGES * BQ2) * HD * 2 + 2 * STAGES * BQ2 * 4;
}

// the bf16 16x16 A fragment of k-step t from the C fragments of two
// adjacent 8-column tiles
template <int NN>
__device__ __forceinline__ void a_frag(const float (&c)[NN][4], int t,
                                       uint32_t (&a)[4]) {
  a[0] = pack_bf16(c[2 * t][0], c[2 * t][1]);
  a[1] = pack_bf16(c[2 * t][2], c[2 * t][3]);
  a[2] = pack_bf16(c[2 * t + 1][0], c[2 * t + 1][1]);
  a[3] = pack_bf16(c[2 * t + 1][2], c[2 * t + 1][3]);
}

// acc[NN][4] += A . B^T over HD: A the warp's 16 rows of a tile at
// a_addr (row a_row0), B the first 8 * NN rows of a tile at b_addr
template <int HD, int NN>
__device__ __forceinline__ void rows_dot_rows(float (&acc)[NN][4],
                                              uint32_t a_addr, int a_row0,
                                              uint32_t b_addr, int lane) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a_addr + swz<HD>(a_row0 + (lane & 15), 2 * kk + (lane >> 4)),
            a[0], a[1], a[2], a[3]);
#pragma unroll
    for (int n2 = 0; n2 < NN / 2; ++n2) {
      uint32_t b0, b1, b2, b3;
      ldsm_x4(b_addr + swz<HD>(n2 * 16 + (lane & 7) + ((lane >> 4) << 3),
                               2 * kk + ((lane >> 3) & 1)),
              b0, b1, b2, b3);
      mma(acc[2 * n2], a, b0, b1);
      mma(acc[2 * n2 + 1], a, b2, b3);
    }
  }
}

// out[HD/8][4] += C . B over the 8 * NN columns of c (bf16-rounded): B the
// first 8 * NN rows of a [rows][HD] tile at b_addr, read transposed
template <int HD, int NN>
__device__ __forceinline__ void cols_times_tile(float (&out)[HD / 8][4],
                                                const float (&c)[NN][4],
                                                uint32_t b_addr, int lane) {
#pragma unroll
  for (int t = 0; t < NN / 2; ++t) {
    uint32_t a[4];
    a_frag(c, t, a);
#pragma unroll
    for (int d2 = 0; d2 < HD / 16; ++d2) {
      uint32_t b0, b1, b2, b3;
      ldsm_x4_t(b_addr + swz<HD>(t * 16 + (lane & 7) +
                                     (((lane >> 3) & 1) << 3),
                                 2 * d2 + (lane >> 4)),
                b0, b1, b2, b3);
      mma(out[2 * d2], a, b0, b1);
      mma(out[2 * d2 + 1], a, b2, b3);
    }
  }
}

// a warp's 16 rows of fp32 C fragments (times mul) to bf16 rows row0..
// of the global tensor (rows at or past n are not stored), staged in the
// warp's own 16 rows of the swizzled tile at stage
template <int HD>
__device__ __forceinline__ void store_rows(const float (&acc)[HD / 8][4],
                                           float mul, unsigned char* stage,
                                           int wrow, bf16* dst,
                                           long long stride, int row0, int n,
                                           int lane) {
  constexpr int KC = HD / 8;
  const int r0 = wrow + (lane >> 2);
#pragma unroll
  for (int c = 0; c < HD / 8; ++c) {
    *reinterpret_cast<uint32_t*>(stage + swz<HD>(r0, c) + (lane & 3) * 4) =
        pack_bf16(acc[c][0] * mul, acc[c][1] * mul);
    *reinterpret_cast<uint32_t*>(stage + swz<HD>(r0 + 8, c) +
                                 (lane & 3) * 4) =
        pack_bf16(acc[c][2] * mul, acc[c][3] * mul);
  }
  __syncwarp();
#pragma unroll
  for (int i = lane; i < 16 * KC; i += 32) {
    const int r = wrow + i / KC, c = i % KC;
    const int pos = row0 + r;
    if (pos < n)
      *reinterpret_cast<uint4*>(dst + pos * stride + c * 8) =
          *reinterpret_cast<const uint4*>(stage + swz<HD>(r, c));
  }
}

template <int HD>
__global__ void __launch_bounds__(NT) flash_attention_bwd_dq_kernel(Args a) {
  constexpr int KS = HD / 16;
  constexpr int NN = BK / 8;
  constexpr int ND = HD / 8;
  extern __shared__ __align__(128) unsigned char dq_smem_buf[];
  unsigned char* sq = dq_smem_buf;                   // [BQ][HD]
  unsigned char* sdo = sq + BQ * HD * 2;             // [BQ][HD]
  unsigned char* sk = sdo + BQ * HD * 2;             // [STAGES][BK][HD]
  unsigned char* sv = sk + STAGES * BK * HD * 2;     // [STAGES][BK][HD]
  float* sd = reinterpret_cast<float*>(sv + STAGES * BK * HD * 2);  // [BQ]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int bh = blockIdx.x;
  const int b = bh / a.hq;
  const int h = bh % a.hq;
  const int kh = h / (a.hq / a.hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // most work first
  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.qs.b + h * a.qs.h;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.ks.b + kh * a.ks.h;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.vs.b + kh * a.vs.h;
  const bf16* ob = static_cast<const bf16*>(a.o) + b * a.os.b + h * a.os.h;
  const bf16* dob =
      static_cast<const bf16*>(a.dout) + b * a.dos.b + h * a.dos.h;
  int k_begin, k_end;
  key_range(a, q0, BQ, BK, k_begin, k_end);
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  load_tile<HD, BQ, NT>(sq, qb, a.qs.s, q0, a.sq, tid);
  load_tile<HD, BQ, NT>(sdo, dob, a.dos.s, q0, a.sq, tid);
#pragma unroll
  for (int t = 0; t < STAGES; ++t) {
    if (t < n_tiles) {
      const int kt = k_begin + t * BK;
      load_tile<HD, BK, NT>(sk + t * BK * HD * 2, kb, a.ks.s, kt, a.sk, tid);
      load_tile<HD, BK, NT>(sv + t * BK * HD * 2, vb, a.vs.s, kt, a.sk, tid);
    }
    cp_commit();
  }

  // D = rowsum(dO o O) for the warp's 16 rows, from global memory while
  // the copies fly; stored for the dK/dV pass
  const int wrow = warp * 16;
  for (int r = 0; r < 16; ++r) {
    const int i = q0 + wrow + r;
    float d = 0.f;
    if (i < a.sq) {
      const __nv_bfloat162* orow =
          reinterpret_cast<const __nv_bfloat162*>(ob + i * a.os.s);
      const __nv_bfloat162* drow =
          reinterpret_cast<const __nv_bfloat162*>(dob + i * a.dos.s);
#pragma unroll
      for (int c = lane; c < HD / 2; c += 32) {
        const float2 x = __bfloat1622float2(orow[c]);
        const float2 y = __bfloat1622float2(drow[c]);
        d += x.x * y.x + x.y * y.y;
      }
    }
    d = warp_sum(d);
    if (lane == 0) {
      sd[wrow + r] = d;
      if (i < a.sq) a.delta[static_cast<long long>(bh) * a.sq + i] = d;
    }
  }
  __syncwarp();

  const int r0 = wrow + (lane >> 2);
  float dr[2], l2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    dr[r] = sd[r0 + 8 * r];
    const int i = min(q0 + r0 + 8 * r, a.sq - 1);
    l2[r] = a.lse[static_cast<long long>(bh) * a.sq + i] * LOG2E;
  }
  const int pw = a.q_offset + q0 + wrow;          // the warp's first row
  const int qrow0 = pw + (lane >> 2);             // positions of c0,c1
  const int qrow1 = qrow0 + 8;                    // and of c2,c3
  const float scale_log2 = a.scale * LOG2E;
  const uint32_t q_addr = smem_u32(sq);
  const uint32_t do_addr = smem_u32(sdo);

  uint32_t qf[KS][4];
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    cp_wait<STAGES - 1>();
    __syncthreads();
    const int k0 = k_begin + j * BK;
    const int st = j % STAGES;
    const uint32_t k_addr = smem_u32(sk + st * BK * HD * 2);
    const uint32_t v_addr = smem_u32(sv + st * BK * HD * 2);
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        ldsm_x4(q_addr + swz<HD>(wrow + (lane & 15), 2 * kk + (lane >> 4)),
                qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3]);
    }

    // S = Q K^T
    float sc[NN][4];
#pragma unroll
    for (int n = 0; n < NN; ++n)
      sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int n2 = 0; n2 < NN / 2; ++n2) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4(k_addr + swz<HD>(n2 * 16 + (lane & 7) + ((lane >> 4) << 3),
                                 2 * kk + ((lane >> 3) & 1)),
                b0, b1, b2, b3);
        mma(sc[2 * n2], qf[kk], b0, b1);
        mma(sc[2 * n2 + 1], qf[kk], b2, b3);
      }
    }
    // P = exp(s - lse), masked pairs selected to 0
    const bool edge = k0 + BK > a.sk || (a.causal && k0 + BK - 1 > pw) ||
                      (a.window > 0 && k0 <= pw + 15 - a.window);
#pragma unroll
    for (int n = 0; n < NN; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * n + 2 * (lane & 3) + (e & 1);
        const int row = (e < 2 ? qrow0 : qrow1) - a.q_offset;
        const bool ok = !edge || visible(a, row, key);
        sc[n][e] = ok ? ex2(sc[n][e] * scale_log2 - l2[e >> 1]) : 0.f;
      }
    }
    // dP = dO V^T
    float dp[NN][4];
#pragma unroll
    for (int n = 0; n < NN; ++n)
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
    rows_dot_rows<HD, NN>(dp, do_addr, wrow, v_addr, lane);
    // dS = P o (dP - D);  dQ += dS K
#pragma unroll
    for (int n = 0; n < NN; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] *= dp[n][e] - dr[e >> 1];
    }
    cols_times_tile<HD, NN>(acc, sc, k_addr, lane);

    __syncthreads();                  // every warp is done with stage st
    if (j + STAGES < n_tiles) {
      const int k1 = k0 + STAGES * BK;
      load_tile<HD, BK, NT>(sk + st * BK * HD * 2, kb, a.ks.s, k1, a.sk, tid);
      load_tile<HD, BK, NT>(sv + st * BK * HD * 2, vb, a.vs.s, k1, a.sk, tid);
    }
    cp_commit();
  }
  cp_wait<0>();
  __syncthreads();                    // no warp still reads sq (j == 0)
  bf16* dqb = static_cast<bf16*>(a.dq) + b * a.dqs.b + h * a.dqs.h;
  store_rows<HD>(acc, a.scale, sq, wrow, dqb, a.dqs.s, q0, a.sq, lane);
}

template <int HD>
__global__ void __launch_bounds__(NT)
    flash_attention_bwd_dkdv_kernel(Args a) {
  constexpr int NN = BQ2 / 8;
  constexpr int ND = HD / 8;
  extern __shared__ __align__(128) unsigned char dkdv_smem_buf[];
  unsigned char* sk = dkdv_smem_buf;                 // [BK][HD]
  unsigned char* sv = sk + BK * HD * 2;              // [BK][HD]
  unsigned char* sq = sv + BK * HD * 2;              // [STAGES][BQ2][HD]
  unsigned char* sdo = sq + STAGES * BQ2 * HD * 2;   // [STAGES][BQ2][HD]
  float* sl = reinterpret_cast<float*>(sdo + STAGES * BQ2 * HD * 2);
  float* sdl = sl + STAGES * BQ2;                    // [STAGES][BQ2] each

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g_size = a.hq / a.hkv;
  const int b = blockIdx.x / a.hkv;
  const int kh = blockIdx.x % a.hkv;
  const int k0 = blockIdx.y * BK;     // causal: the first keys, most work
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.ks.b + kh * a.ks.h;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.vs.b + kh * a.vs.h;
  int ib, ie;
  query_range(a, k0, BK, BQ2, ib, ie);
  const int n_qt = ie > ib ? (ie - ib + BQ2 - 1) / BQ2 : 0;
  const int n_steps = g_size * n_qt;

  // step -> (q head, q tile): Q and dO rows by cp.async, lse (log2
  // domain) and D by plain loads (seen after the next barrier)
  auto issue = [&](int step, int st) {
    const int h = kh * g_size + step / n_qt;
    const int i0 = ib + (step % n_qt) * BQ2;
    const bf16* qb = static_cast<const bf16*>(a.q) + b * a.qs.b + h * a.qs.h;
    const bf16* dob =
        static_cast<const bf16*>(a.dout) + b * a.dos.b + h * a.dos.h;
    load_tile<HD, BQ2, NT>(sq + st * BQ2 * HD * 2, qb, a.qs.s, i0, a.sq, tid);
    load_tile<HD, BQ2, NT>(sdo + st * BQ2 * HD * 2, dob, a.dos.s, i0, a.sq,
                           tid);
    const long long row0 = (static_cast<long long>(b) * a.hq + h) * a.sq;
    if (tid < BQ2) {
      const int i = i0 + tid;
      sl[st * BQ2 + tid] = i < a.sq ? a.lse[row0 + i] * LOG2E : 0.f;
    } else if (tid < 2 * BQ2) {
      const int i = i0 + tid - BQ2;
      sdl[st * BQ2 + tid - BQ2] = i < a.sq ? a.delta[row0 + i] : 0.f;
    }
  };

  load_tile<HD, BK, NT>(sk, kb, a.ks.s, k0, a.sk, tid);
  load_tile<HD, BK, NT>(sv, vb, a.vs.s, k0, a.sk, tid);
#pragma unroll
  for (int t = 0; t < STAGES; ++t) {
    if (t < n_steps) issue(t, t);
    cp_commit();
  }

  const int wrow = warp * 16;
  const int kw = k0 + wrow;                       // the warp's first key
  const float scale_log2 = a.scale * LOG2E;
  const uint32_t k_addr = smem_u32(sk);
  const uint32_t v_addr = smem_u32(sv);
  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
    dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
  }

  for (int j = 0; j < n_steps; ++j) {
    cp_wait<STAGES - 1>();
    __syncthreads();
    const int st = j % STAGES;
    const int i0 = ib + (j % n_qt) * BQ2;
    const int p0 = a.q_offset + i0;
    const uint32_t q_addr = smem_u32(sq + st * BQ2 * HD * 2);
    const uint32_t do_addr = smem_u32(sdo + st * BQ2 * HD * 2);
    const float* lrow = sl + st * BQ2;
    const float* drow = sdl + st * BQ2;

    // S^T = K Q^T: rows the warp's 16 keys, columns the step's 32 rows
    float sc[NN][4];
#pragma unroll
    for (int n = 0; n < NN; ++n)
      sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
    rows_dot_rows<HD, NN>(sc, k_addr, wrow, q_addr, lane);
    const bool edge = i0 + BQ2 > a.sq || kw + 16 > a.sk ||
                      (a.causal && kw + 15 > p0) ||
                      (a.window > 0 && kw <= p0 + BQ2 - 1 - a.window);
#pragma unroll
    for (int n = 0; n < NN; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * n + 2 * (lane & 3) + (e & 1);
        const int key = kw + (lane >> 2) + 8 * (e >> 1);
        const bool ok = !edge || visible(a, i0 + c, key);
        sc[n][e] = ok ? ex2(sc[n][e] * scale_log2 - lrow[c]) : 0.f;
      }
    }
    // dP^T = V dO^T
    float dp[NN][4];
#pragma unroll
    for (int n = 0; n < NN; ++n)
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
    rows_dot_rows<HD, NN>(dp, v_addr, wrow, do_addr, lane);
    // dV += P^T dO
    cols_times_tile<HD, NN>(dv, sc, do_addr, lane);
    // dS^T = P^T o (dP^T - D);  dK += dS^T Q
#pragma unroll
    for (int n = 0; n < NN; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sc[n][e] *= dp[n][e] - drow[8 * n + 2 * (lane & 3) + (e & 1)];
    }
    cols_times_tile<HD, NN>(dk, sc, q_addr, lane);

    __syncthreads();                  // every warp is done with stage st
    if (j + STAGES < n_steps) issue(j + STAGES, st);
    cp_commit();
  }
  cp_wait<0>();
  // each warp reads only its own 16 rows of sk and sv: stage there
  bf16* dkb = static_cast<bf16*>(a.dk) + b * a.dks.b + kh * a.dks.h;
  bf16* dvb = static_cast<bf16*>(a.dv) + b * a.dvs.b + kh * a.dvs.h;
  store_rows<HD>(dk, a.scale, sk, wrow, dkb, a.dks.s, k0, a.sk, lane);
  store_rows<HD>(dv, 1.f, sv, wrow, dvb, a.dvs.s, k0, a.sk, lane);
}

template <int HD>
int launch(const Args& a, int b, cudaStream_t stream) {
  static bool configured = false;    // the attribute is per function
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_attention_bwd_dq_kernel<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem<HD>());
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(flash_attention_bwd_dkdv_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               dkdv_smem<HD>());
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  flash_attention_bwd_dq_kernel<HD>
      <<<dim3(b * a.hq, (a.sq + BQ - 1) / BQ), NT, dq_smem<HD>(), stream>>>(
          a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_attention_bwd_dkdv_kernel<HD>
      <<<dim3(b * a.hkv, (a.sk + BK - 1) / BK), NT, dkdv_smem<HD>(),
         stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// ------------------------------------------------- fp32: FMA kernel

namespace f32 {

constexpr int T = 32;                // q rows and keys a tile
constexpr int NT = 256;              // 16 x 16 threads
constexpr int PS = T + 1;            // padded row of the P and dS tiles

template <int HD>
constexpr int smem_bytes() {
  return (4 * T * (HD + 1) + 2 * T * PS + 2 * T) * 4;
}

// rows [row0, row0 + T) of a [.., HD] fp32 tensor into a [T][HD + 1] tile
// (zeros at or past n)
template <int HD>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long stride, int row0, int n,
                                          int tid) {
  for (int i = tid; i < T * HD; i += NT) {
    const int r = i / HD, d = i % HD;
    const int pos = row0 + r;
    dst[r * (HD + 1) + d] = pos < n ? src[pos * stride + d] : 0.f;
  }
}

// DKDV false: a block owns T q rows of one (batch, q head) and walks its
// key tiles for dQ (and D first); true: a block owns T keys of one
// (batch, kv head) and walks the group's q tiles for dK and dV.
template <int HD, bool DKDV>
__global__ void __launch_bounds__(NT) flash_attention_bwd_f32_kernel(Args a) {
  constexpr int QS = HD + 1;
  constexpr int DPT = HD / 16;       // output dims a thread
  extern __shared__ float fsm[];
  float* s_q = fsm;                  // [T][QS]
  float* s_k = s_q + T * QS;         // [T][QS]
  float* s_v = s_k + T * QS;         // [T][QS]
  float* s_do = s_v + T * QS;        // [T][QS]
  float* s_p = s_do + T * QS;        // [T][PS] P, row = q row, col = key
  float* s_ds = s_p + T * PS;        // [T][PS] dS
  float* s_l = s_ds + T * PS;        // [T] lse of the q rows
  float* s_d = s_l + T;              // [T] D of the q rows

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int g_size = a.hq / a.hkv;
  float acc0[2][DPT], acc1[2][DPT];  // dQ rows | dK and dV keys
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int e = 0; e < DPT; ++e) acc0[r][e] = acc1[r][e] = 0.f;

  // one (q tile i0, key tile k0) pair: P and dS into s_p, s_ds
  auto pair = [&](int i0, int k0) {
    float s[2][2] = {}, dp[2][2] = {};
    for (int d = 0; d < HD; ++d) {
      const float k0f = s_k[tx * QS + d], k1f = s_k[(tx + 16) * QS + d];
      const float v0f = s_v[tx * QS + d], v1f = s_v[(tx + 16) * QS + d];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float qf = s_q[(2 * ty + r) * QS + d];
        const float of = s_do[(2 * ty + r) * QS + d];
        s[r][0] += qf * k0f;
        s[r][1] += qf * k1f;
        dp[r][0] += of * v0f;
        dp[r][1] += of * v1f;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 2 * ty + r;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = tx + 16 * c;
        const float p = visible(a, i0 + row, k0 + col)
                            ? expf(s[r][c] * a.scale - s_l[row])
                            : 0.f;
        s_p[row * PS + col] = p;
        s_ds[row * PS + col] = p * (dp[r][c] - s_d[row]);
      }
    }
  };

  if (!DKDV) {
    const int bh = blockIdx.y;
    const int b = bh / a.hq, h = bh % a.hq, kh = h / g_size;
    const int i0 = blockIdx.x * T;
    const float* qb = static_cast<const float*>(a.q) + b * a.qs.b +
                      h * a.qs.h;
    const float* ob = static_cast<const float*>(a.o) + b * a.os.b +
                      h * a.os.h;
    const float* dob = static_cast<const float*>(a.dout) + b * a.dos.b +
                       h * a.dos.h;
    const float* kb = static_cast<const float*>(a.k) + b * a.ks.b +
                      kh * a.ks.h;
    const float* vb = static_cast<const float*>(a.v) + b * a.vs.b +
                      kh * a.vs.h;
    const long long row0 = static_cast<long long>(bh) * a.sq;
    {  // D: 8 threads a row
      const int r = tid >> 3, part = tid & 7, i = i0 + r;
      float d = 0.f;
      if (i < a.sq)
        for (int c = part; c < HD; c += 8)
          d += ob[i * a.os.s + c] * dob[i * a.dos.s + c];
#pragma unroll
      for (int o = 4; o > 0; o >>= 1)
        d += __shfl_xor_sync(0xffffffffu, d, o);
      if (part == 0) {
        s_d[r] = d;
        if (i < a.sq) a.delta[row0 + i] = d;
      }
    }
    if (tid < T) s_l[tid] = i0 + tid < a.sq ? a.lse[row0 + i0 + tid] : 0.f;
    load_rows<HD>(s_q, qb, a.qs.s, i0, a.sq, tid);
    load_rows<HD>(s_do, dob, a.dos.s, i0, a.sq, tid);
    int kbeg, kend;
    key_range(a, i0, T, T, kbeg, kend);
    for (int k0 = kbeg; k0 < kend; k0 += T) {
      __syncthreads();
      load_rows<HD>(s_k, kb, a.ks.s, k0, a.sk, tid);
      load_rows<HD>(s_v, vb, a.vs.s, k0, a.sk, tid);
      __syncthreads();
      pair(i0, k0);
      __syncthreads();
      for (int j = 0; j < T; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float ds = s_ds[(2 * ty + r) * PS + j];
#pragma unroll
          for (int e = 0; e < DPT; ++e)
            acc0[r][e] += ds * s_k[j * QS + tx + 16 * e];
        }
      }
    }
    float* dqb = static_cast<float*>(a.dq) + b * a.dqs.b + h * a.dqs.h;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = i0 + 2 * ty + r;
      if (i < a.sq)
#pragma unroll
        for (int e = 0; e < DPT; ++e)
          dqb[i * a.dqs.s + tx + 16 * e] = acc0[r][e] * a.scale;
    }
  } else {
    const int b = blockIdx.y / a.hkv, kh = blockIdx.y % a.hkv;
    const int k0 = blockIdx.x * T;
    const float* kb = static_cast<const float*>(a.k) + b * a.ks.b +
                      kh * a.ks.h;
    const float* vb = static_cast<const float*>(a.v) + b * a.vs.b +
                      kh * a.vs.h;
    load_rows<HD>(s_k, kb, a.ks.s, k0, a.sk, tid);
    load_rows<HD>(s_v, vb, a.vs.s, k0, a.sk, tid);
    int ib, ie;
    query_range(a, k0, T, T, ib, ie);
    for (int g = 0; g < g_size; ++g) {
      const int h = kh * g_size + g;
      const float* qb = static_cast<const float*>(a.q) + b * a.qs.b +
                        h * a.qs.h;
      const float* dob = static_cast<const float*>(a.dout) + b * a.dos.b +
                         h * a.dos.h;
      const long long row0 = (static_cast<long long>(b) * a.hq + h) * a.sq;
      for (int i0 = ib; i0 < ie; i0 += T) {
        __syncthreads();
        load_rows<HD>(s_q, qb, a.qs.s, i0, a.sq, tid);
        load_rows<HD>(s_do, dob, a.dos.s, i0, a.sq, tid);
        if (tid < T) {
          const bool in = i0 + tid < a.sq;
          s_l[tid] = in ? a.lse[row0 + i0 + tid] : 0.f;
          s_d[tid] = in ? a.delta[row0 + i0 + tid] : 0.f;
        }
        __syncthreads();
        pair(i0, k0);
        __syncthreads();
        for (int i = 0; i < T; ++i) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float p = s_p[i * PS + 2 * ty + c];
            const float ds = s_ds[i * PS + 2 * ty + c];
#pragma unroll
            for (int e = 0; e < DPT; ++e) {
              acc1[c][e] += p * s_do[i * QS + tx + 16 * e];
              acc0[c][e] += ds * s_q[i * QS + tx + 16 * e];
            }
          }
        }
      }
    }
    float* dkb = static_cast<float*>(a.dk) + b * a.dks.b + kh * a.dks.h;
    float* dvb = static_cast<float*>(a.dv) + b * a.dvs.b + kh * a.dvs.h;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int key = k0 + 2 * ty + c;
      if (key < a.sk)
#pragma unroll
        for (int e = 0; e < DPT; ++e) {
          dkb[key * a.dks.s + tx + 16 * e] = acc0[c][e] * a.scale;
          dvb[key * a.dvs.s + tx + 16 * e] = acc1[c][e];
        }
    }
  }
}

template <int HD>
int launch(const Args& a, int b, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<HD>();
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_attention_bwd_f32_kernel<HD, false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(flash_attention_bwd_f32_kernel<HD, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  flash_attention_bwd_f32_kernel<HD, false>
      <<<dim3((a.sq + T - 1) / T, b * a.hq), NT, bytes, stream>>>(a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_attention_bwd_f32_kernel<HD, true>
      <<<dim3((a.sk + T - 1) / T, b * a.hkv), NT, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32

}  // namespace

// strides: 24 element strides, (batch, head, sequence) for q, k, v, out,
// dout, dq, dk, dv in that order, each with a contiguous last dimension.
// lse: the forward's fp32 [B, Hq, Sq] (flash_attention_lse_launch);
// delta: fp32 [B, Hq, Sq] scratch, written then read.  The mask
// arguments are the forward's.  bf16: 1 = every tensor but lse and
// delta bfloat16 (tensor cores; strides multiples of 8, bases 16-byte
// aligned), 0 = float32 (FMA kernel).  Launches the dQ pass, then the
// dK/dV pass, on the stream.  Returns a CUDA error code (0 = none); hd
// outside {64, 128}, or the forward's refused masks, is
// cudaErrorInvalidValue.  b == 0 or sq == 0 launches nothing (the caller
// zero-fills dk and dv).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, const long long* strides, int b, int hq, int hkv, int sq,
    int sk, int q_offset, int hd, float scale, int causal, int window,
    int bf16, void* stream) {
  if (b == 0 || sq == 0) return 0;
  if (sk < 1 || q_offset < 0 || window < 0 || window > q_offset + sq ||
      (window > 0 && q_offset + sq - window >= sk) || hkv < 1 || hq % hkv)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = out;
  a.dout = dout;
  a.lse = lse;
  a.delta = delta;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  Strides* st[8] = {&a.qs, &a.ks, &a.vs, &a.os, &a.dos, &a.dqs, &a.dks,
                    &a.dvs};
  for (int i = 0; i < 8; ++i)
    *st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  a.hq = hq;
  a.hkv = hkv;
  a.sq = sq;
  a.sk = sk;
  a.q_offset = q_offset;
  a.causal = causal;
  a.window = window;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64:
      return bf16 ? tc::launch<64>(a, b, s) : f32::launch<64>(a, b, s);
    case 128:
      return bf16 ? tc::launch<128>(a, b, s) : f32::launch<128>(a, b, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
