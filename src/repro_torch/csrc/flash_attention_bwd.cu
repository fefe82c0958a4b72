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
// the gradients are the same bits from run to run.
//   1. flash_attention_bwd_dq_kernel: a block owns a 64-row q tile of one
//      (batch, q head) and walks its visible key tiles, as the forward
//      does; first it computes D for its rows and stores it, and the
//      rows' lse * log2 e, in a scratch padded to whole 64-row tiles.
//   2. flash_attention_bwd_dkdv_kernel: a block owns 128 keys of one
//      (batch, kv head) and walks the 64-row q tiles that see them, for
//      each of the group's q heads in order, reading the scratch.
// Masked pairs are selected to 0 before any product (exp of a masked
// score is never taken), with the same predicates as the forward; only
// the tiles that cross a mask edge evaluate them.
//
// bf16 inputs (the model's card path), on Hopper's asynchronous units
// (hopper.cuh): each block is one or two consumer warpgroups of 64 rows, which
// issue wgmma (bf16 operands, fp32 sums), and a producer warp (in pass 2 a
// whole producer warpgroup, whose registers the consumers take by setmaxnreg),
// which keeps the tiles the walk needs in flight by TMA (4-D tensor maps over
// the [B, S, H, hd] tensors, 128-byte swizzle, rows past S read as zeros) into
// a ring of shared-memory stages guarded by mbarriers (full: the tile's bytes
// have landed; empty: every consumer warp is done with it).  Pass 1 (one
// consumer warpgroup, 2 K/V stages): S = Q K^T and dP = dO V^T from shared
// memory, then dS in registers as the A operand of dQ += dS K.  Pass 2 (two
// consumer warpgroups of 64 keys, 3 Q/dO/lse/D stages, K and V loaded once):
// S^T = K Q^T and dP^T = V dO^T, then P^T and dS^T in registers as the A
// operands of dV += P^T dO and dK += dS^T Q.  P is rounded to bf16 before dV =
// P^T dO and dS before dK and dQ, as the forward rounds P before P.V; dP, D and
// the softmax are fp32.  The recomputed S and dP make 7 products where the
// function has 5; one pass with dQ added across key tiles would need an fp32
// buffer summed in a fixed order (FlashAttention-3's deterministic mode).  Head
// dims 64 and 128; hd 256 (recurrentgemma-2b) is refused (see pass 2).
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
// us at the bf16 tensor-core peak (the 7 products run, 15.3 us).  At
// llava's offset shape (512 rows over 1664 keys, 32 q heads) operations
// bound it.  What holds it above that (PERF.md): causal dK/dV blocks are
// uneven (the first 128 keys walk 16 q tiles, the last 4, one block an
// SM), and the dQ pass recomputes S and dP and overlaps its steps only
// across its two blocks an SM.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include "hopper.cuh"
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
  float* delta;          // scratch written by the dQ pass (see below)
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

// ------------------------------------------------- bf16: wgmma and TMA

namespace tc {

using namespace hopper;

constexpr int BM = 64;               // rows of a warpgroup's wgmma tile
constexpr int WG = 128;              // threads of a warpgroup
constexpr int KV_WGS = 2;            // consumer warpgroups of a dK/dV block
constexpr int BKV = BM * KV_WGS;     // keys of a dK/dV block
constexpr int DQ_STAGES = 2;         // K/V tiles in flight (dQ pass)
constexpr int KV_STAGES = 3;         // Q/dO tiles in flight (dK/dV pass)
constexpr int DQ_THREADS = WG + 32;  // a consumer warpgroup, a producer warp
// two consumer warpgroups and a producer warpgroup, of which one warp
// issues the copies: setmaxnreg moves registers only between the warps of
// one block, and the producer group's 128 x (168 - 24) are what the
// consumers' 256 x (240 - 168) take
constexpr int KV_THREADS = (KV_WGS + 1) * WG;
constexpr int PANEL = BM * 128;      // bytes of a 64-row, 64-column panel

struct TcArgs {
  CUtensorMap q, k, v, dout;         // 4-D (hd, s, h, b), 64 x 64 boxes
  Args a;
  float* lse2;                       // [B * Hq][sqp] lse * log2 e
  float* dsum;                       // [B * Hq][sqp] D
  int sqp;                           // sq rounded up to BM
};

template <int HD>
__host__ __device__ constexpr int tile_bytes(int rows) {
  return rows * HD * 2;
}
template <int HD>
__host__ __device__ constexpr int dq_smem() {
  return (2 + 2 * DQ_STAGES) * tile_bytes<HD>(BM) + 1024;
}
template <int HD>
__host__ __device__ constexpr int kv_smem() {
  return 2 * tile_bytes<HD>(BKV) + 2 * KV_STAGES * tile_bytes<HD>(BM) +
         2 * KV_STAGES * BM * 4 + 1024;
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

template <int HD>
__device__ __forceinline__ void wgmma_rs(float (&d)[HD / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (HD == 64)
    wgmma_rs_n64(d, a, db);
  else
    wgmma_rs_n128(d, a, db);
}

// the bf16 A fragments of the four 16-column k-steps of an m64n64
// accumulator (blocks 2t and 2t + 1 packed pairwise)
__device__ __forceinline__ void a_frags(const float (&c)[32],
                                        uint32_t (&a)[4][4]) {
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    a[t][0] = pack_bf16(c[8 * t], c[8 * t + 1]);
    a[t][1] = pack_bf16(c[8 * t + 2], c[8 * t + 3]);
    a[t][2] = pack_bf16(c[8 * t + 4], c[8 * t + 5]);
    a[t][3] = pack_bf16(c[8 * t + 6], c[8 * t + 7]);
  }
}

// acc = A . B^T over HD for two 64-row tiles, both K-major: A at a_addr
// in panels a_panel bytes apart, B (64 rows) at b_addr in 64-row panels
template <int HD>
__device__ __forceinline__ void tile_dot(float (&acc)[32], uint32_t a_addr,
                                         uint32_t a_panel, uint32_t b_addr) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t col = (kk % 4) * 32;
    wgmma_ss_n64(acc, desc_k(a_addr + (kk / 4) * a_panel + col),
                 desc_k(b_addr + (kk / 4) * PANEL + col), kk > 0);
  }
}

// a warpgroup's m64nHD accumulator times mul, as bf16, to rows row0.. of
// a [., HD] tensor (rows at or past n are not stored)
template <int HD>
__device__ __forceinline__ void store_acc(const float (&acc)[HD / 2],
                                          float mul, bf16* dst,
                                          long long stride, int row0, int n,
                                          int warp, int lane) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 16 * warp + (lane >> 2) + 8 * half;
    if (row >= n) continue;
    bf16* out = dst + row * stride + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<uint32_t*>(out + 8 * j) =
          pack_bf16(acc[4 * j + 2 * half] * mul,
                    acc[4 * j + 2 * half + 1] * mul);
  }
}

// Pass 1: dQ.  A block owns a 64-row q tile of one (batch, q head): one
// consumer warpgroup and a producer warp, which brings the tile's Q and
// dO once and the visible K/V tiles through a DQ_STAGES ring by TMA.
// Before the walk the consumers compute D for their rows and store it,
// and the rows' lse * log2 e, in the padded scratch of pass 2.
template <int HD>
__global__ void __launch_bounds__(DQ_THREADS, 2)
    flash_attention_bwd_dq_kernel(__grid_constant__ const TcArgs t) {
  constexpr int TILE = tile_bytes<HD>(BM);
  const Args& a = t.a;
  extern __shared__ unsigned char dq_raw[];
  unsigned char* sq = align1024(dq_raw);          // Q tile
  unsigned char* sdo = sq + TILE;                 // dO tile
  unsigned char* sk = sdo + TILE;                 // [DQ_STAGES] K tiles
  unsigned char* sv = sk + DQ_STAGES * TILE;      // [DQ_STAGES] V tiles
  __shared__ __align__(8) uint64_t bar_qd, full[DQ_STAGES], empty[DQ_STAGES];
  __shared__ float s_d[BM];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int bh = blockIdx.x;
  const int b = bh / a.hq;
  const int h = bh % a.hq;
  const int kh = h / (a.hq / a.hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;  // most work first
  int k_begin, k_end;
  key_range(a, q0, BM, BM, k_begin, k_end);
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BM - 1) / BM : 0;
  if (tid == 0) {
    mbar_init(&bar_qd, 1);
    for (int s = 0; s < DQ_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);         // the consumer warps
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4) {                     // the producer
    if (lane == 0) {
      mbar_expect_tx(&bar_qd, 2 * TILE);
      for (int p = 0; p < HD / 64; ++p) {
        tma_load_4d(sq + p * PANEL, &t.q, &bar_qd, 64 * p, q0, h, b);
        tma_load_4d(sdo + p * PANEL, &t.dout, &bar_qd, 64 * p, q0, h, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % DQ_STAGES;
        if (j >= DQ_STAGES) mbar_wait(&empty[s], (j / DQ_STAGES + 1) & 1);
        const int kt = k_begin + j * BM;
        mbar_expect_tx(&full[s], 2 * TILE);
        for (int p = 0; p < HD / 64; ++p) {
          tma_load_4d(sk + s * TILE + p * PANEL, &t.k, &full[s], 64 * p, kt,
                      kh, b);
          tma_load_4d(sv + s * TILE + p * PANEL, &t.v, &full[s], 64 * p, kt,
                      kh, b);
        }
      }
    }
    return;
  }

  // D = rowsum(dO o O) for the warp's 16 rows from global memory while
  // the tiles fly (a row's 16-byte chunks over HD / 8 lanes, every load of
  // the warp in flight at once); D and lse * log2 e to the padded scratch
  // (zeros past Sq), for pass 2
  constexpr int CPR = HD / 8;                     // chunks of a row
  constexpr int RPP = 32 / CPR;                   // rows of a warp pass
  const int wrow = warp * 16;
  const bf16* ob = static_cast<const bf16*>(a.o) + b * a.os.b + h * a.os.h;
  const bf16* dob =
      static_cast<const bf16*>(a.dout) + b * a.dos.b + h * a.dos.h;
  const long long srow = static_cast<long long>(bh) * t.sqp;
  float dpart[16 / RPP];
#pragma unroll
  for (int it = 0; it < 16 / RPP; ++it) {
    const int i = q0 + wrow + it * RPP + lane / CPR;
    const int cc = (lane % CPR) * 8;
    float d = 0.f;
    if (i < a.sq) {
      const uint4 x = *reinterpret_cast<const uint4*>(ob + i * a.os.s + cc);
      const uint4 y =
          *reinterpret_cast<const uint4*>(dob + i * a.dos.s + cc);
      const auto* xp = reinterpret_cast<const __nv_bfloat162*>(&x);
      const auto* yp = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 xf = __bfloat1622float2(xp[e]);
        const float2 yf = __bfloat1622float2(yp[e]);
        d += xf.x * yf.x + xf.y * yf.y;
      }
    }
    dpart[it] = d;
  }
#pragma unroll
  for (int it = 0; it < 16 / RPP; ++it) {
#pragma unroll
    for (int o = CPR / 2; o > 0; o >>= 1)
      dpart[it] += __shfl_xor_sync(0xffffffffu, dpart[it], o);
    const int r = wrow + it * RPP + lane / CPR;
    const int i = q0 + r;
    if (lane % CPR == 0) {
      s_d[r] = dpart[it];
      t.dsum[srow + i] = dpart[it];
      t.lse2[srow + i] =
          i < a.sq ? a.lse[static_cast<long long>(bh) * a.sq + i] * LOG2E
                   : 0.f;
    }
  }
  __syncwarp();
  const int r0 = wrow + (lane >> 2);
  float dr[2], l2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    dr[r] = s_d[r0 + 8 * r];
    const int i = min(q0 + r0 + 8 * r, a.sq - 1);
    l2[r] = a.lse[static_cast<long long>(bh) * a.sq + i] * LOG2E;
  }
  const int pw = a.q_offset + q0 + wrow;          // the warp's first row
  const float scale_log2 = a.scale * LOG2E;
  const uint32_t q_addr = smem_u32(sq);
  const uint32_t do_addr = smem_u32(sdo);

  float dq[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dq[i] = 0.f;
  mbar_wait(&bar_qd, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % DQ_STAGES;
    mbar_wait(&full[s], (j / DQ_STAGES) & 1);
    const int k0 = k_begin + j * BM;
    const uint32_t k_addr = smem_u32(sk + s * TILE);
    const uint32_t v_addr = smem_u32(sv + s * TILE);

    // S = Q K^T and dP = dO V^T, two commit groups
    float sc[32], dp[32];
    wg_fence();
    tile_dot<HD>(sc, q_addr, PANEL, k_addr);
    wg_commit();
    tile_dot<HD>(dp, do_addr, PANEL, v_addr);
    wg_commit();
    fence_regs(sc);
    fence_regs(dp);
    wg_wait<1>();
    fence_regs(sc);

    // P = exp(s - lse), masked pairs selected to 0, while dP runs
    const bool edge = k0 + BM > a.sk || (a.causal && k0 + BM - 1 > pw) ||
                      (a.window > 0 && k0 <= pw + 15 - a.window);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * n + 2 * (lane & 3) + (e & 1);
        const int row = q0 + r0 + 8 * (e >> 1);
        const bool ok = !edge || visible(a, row, key);
        sc[4 * n + e] =
            ok ? ex2(sc[4 * n + e] * scale_log2 - l2[e >> 1]) : 0.f;
      }
    }
    // dS = P o (dP - D)
    wg_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] *= dp[i] - dr[(i >> 1) & 1];
    // dQ += dS K (K read MN-major: the reduction runs along its rows)
    uint32_t af[4][4];
    a_frags(sc, af);
    wg_fence();
    fence_regs(dq);
#pragma unroll
    for (int k16 = 0; k16 < 4; ++k16)
      wgmma_rs<HD>(dq, af[k16], desc_mn(k_addr + k16 * 2048, PANEL));
    wg_commit();
    fence_regs(dq);
    wg_wait<0>();
    fence_regs(dq);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
  bf16* dqb = static_cast<bf16*>(a.dq) + b * a.dqs.b + h * a.dqs.h;
  store_acc<HD>(dq, a.scale, dqb, a.dqs.s, q0, a.sq, warp, lane);
}

// Pass 2: dK and dV.  A block owns BKV = 128 keys of one (batch, kv
// head), 64 a consumer warpgroup, whose K and V come in once by TMA; a
// producer warp brings the Q, dO, lse and D tiles of 64 rows that see
// them, for each q head of the group in order, through a KV_STAGES ring.
// S^T = K Q^T and dP^T = V dO^T run with K and V as A from shared
// memory; P^T and dS^T stay in registers as the A operands of dV += P^T
// dO and dK += dS^T Q; dK and dV are fp32 accumulators in registers.  A
// warpgroup none of whose keys a tile's rows see skips its products.
//
// At hd 128 the consumers take 240 registers a thread from the producer
// group (setmaxnreg).  hd 256 would not fit: dK and dV alone would take
// 256 registers a thread.  It would come as a block of four consumer
// warpgroups, two a 64-key slice, each of the pair owning one half of hd
// for dK and dV and both computing S^T and dP^T over the whole hd (or one
// computing them and handing P^T and dS^T to the other through shared
// memory).
template <int HD>
__global__ void __launch_bounds__(KV_THREADS, 1)
    flash_attention_bwd_dkdv_kernel(__grid_constant__ const TcArgs t) {
  constexpr int TILE = tile_bytes<HD>(BM);
  constexpr int KTILE = tile_bytes<HD>(BKV);
  constexpr int KPANEL = BKV * 128;
  const Args& a = t.a;
  extern __shared__ unsigned char kv_raw[];
  unsigned char* sk = align1024(kv_raw);          // K [HD/64][128][128 B]
  unsigned char* sv = sk + KTILE;                 // V
  unsigned char* sq = sv + KTILE;                 // [KV_STAGES] Q tiles
  unsigned char* sdo = sq + KV_STAGES * TILE;     // [KV_STAGES] dO tiles
  float* sl = reinterpret_cast<float*>(sdo + KV_STAGES * TILE);
  float* sdl = sl + KV_STAGES * BM;               // [KV_STAGES][64] each
  __shared__ __align__(8) uint64_t bar_kv, full[KV_STAGES], empty[KV_STAGES];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g_size = a.hq / a.hkv;
  const int b = blockIdx.y / a.hkv;
  const int kh = blockIdx.y % a.hkv;
  const int k0 = blockIdx.x * BKV;    // causal: the first keys, most work
  int ib, ie;
  query_range(a, k0, BKV, BM, ib, ie);
  const int n_qt = ie > ib ? (ie - ib + BM - 1) / BM : 0;
  const int n_steps = g_size * n_qt;
  if (tid == 0) {
    mbar_init(&bar_kv, 1);
    for (int s = 0; s < KV_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * KV_WGS);   // the consumer warps
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 4 * KV_WGS) {            // the producer warpgroup
    setmaxnreg_dec<24>();
    if (warp == 4 * KV_WGS && lane == 0) {
      mbar_expect_tx(&bar_kv, 2 * KTILE);
      for (int p = 0; p < HD / 64; ++p) {
        for (int r = 0; r < KV_WGS; ++r) {
          tma_load_4d(sk + p * KPANEL + r * PANEL, &t.k, &bar_kv, 64 * p,
                      k0 + BM * r, kh, b);
          tma_load_4d(sv + p * KPANEL + r * PANEL, &t.v, &bar_kv, 64 * p,
                      k0 + BM * r, kh, b);
        }
      }
      for (int j = 0; j < n_steps; ++j) {
        const int s = j % KV_STAGES;
        if (j >= KV_STAGES) mbar_wait(&empty[s], (j / KV_STAGES + 1) & 1);
        const int h = kh * g_size + j / n_qt;
        const int i0 = ib + (j % n_qt) * BM;
        mbar_expect_tx(&full[s], 2 * TILE + 2 * BM * 4);
        for (int p = 0; p < HD / 64; ++p) {
          tma_load_4d(sq + s * TILE + p * PANEL, &t.q, &full[s], 64 * p, i0,
                      h, b);
          tma_load_4d(sdo + s * TILE + p * PANEL, &t.dout, &full[s], 64 * p,
                      i0, h, b);
        }
        const long long row = (static_cast<long long>(b) * a.hq + h) * t.sqp
                              + i0;
        bulk_load(sl + s * BM, t.lse2 + row, BM * 4, &full[s]);
        bulk_load(sdl + s * BM, t.dsum + row, BM * 4, &full[s]);
      }
    }
    return;
  }

  // the producer's registers to the consumers: dK, dV, S^T and dP^T
  // alone take 192 a thread at hd 128
  setmaxnreg_inc<240>();
  const int wg = warp / 4;             // consumer warpgroup
  const int wq = warp % 4;             // warp within it
  const int kg = k0 + BM * wg;         // the warpgroup's first key
  const int kw = kg + 16 * wq;         // the warp's first key
  const float scale_log2 = a.scale * LOG2E;
  const uint32_t k_addr = smem_u32(sk) + wg * PANEL;
  const uint32_t v_addr = smem_u32(sv) + wg * PANEL;
  float dk[HD / 2], dv[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dk[i] = dv[i] = 0.f;
  mbar_wait(&bar_kv, 0);

  for (int j = 0; j < n_steps; ++j) {
    const int s = j % KV_STAGES;
    mbar_wait(&full[s], (j / KV_STAGES) & 1);
    const int i0 = ib + (j % n_qt) * BM;
    const int p0 = a.q_offset + i0;
    const int p_last = p0 + min(BM, a.sq - i0) - 1;
    const bool skip = kg >= a.sk || (a.causal && kg > p_last) ||
                      (a.window > 0 && kg + BM - 1 <= p0 - a.window);
    if (!skip) {
      const uint32_t q_addr = smem_u32(sq + s * TILE);
      const uint32_t do_addr = smem_u32(sdo + s * TILE);
      // S^T = K Q^T, dP^T = V dO^T: rows the warpgroup's 64 keys,
      // columns the tile's 64 q rows
      float st[32], dpt[32];
      wg_fence();
      tile_dot<HD>(st, k_addr, KPANEL, q_addr);
      wg_commit();
      tile_dot<HD>(dpt, v_addr, KPANEL, do_addr);
      wg_commit();
      fence_regs(st);
      fence_regs(dpt);
      wg_wait<1>();
      fence_regs(st);

      // P^T = exp(s - lse), masked pairs selected to 0, while dP^T runs
      const bool edge = i0 + BM > a.sq || kw + 16 > a.sk ||
                        (a.causal && kw + 15 > p0) ||
                        (a.window > 0 && kw <= p0 + BM - 1 - a.window);
      const float* lrow = sl + s * BM;
      const float* drow = sdl + s * BM;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int c = 8 * n + 2 * (lane & 3);
        const float2 l2 = *reinterpret_cast<const float2*>(lrow + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kw + (lane >> 2) + 8 * (e >> 1);
          const bool ok = !edge || visible(a, i0 + c + (e & 1), key);
          st[4 * n + e] = ok ? ex2(st[4 * n + e] * scale_log2 -
                                   (e & 1 ? l2.y : l2.x))
                             : 0.f;
        }
      }
      // dS^T = P^T o (dP^T - D)
      wg_wait<0>();
      fence_regs(dpt);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 dd = *reinterpret_cast<const float2*>(
            drow + 8 * n + 2 * (lane & 3));
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dpt[4 * n + e] =
              st[4 * n + e] * (dpt[4 * n + e] - (e & 1 ? dd.y : dd.x));
      }
      // dV += P^T dO, dK += dS^T Q (dO and Q read MN-major)
      uint32_t pa[4][4], da[4][4];
      a_frags(st, pa);
      a_frags(dpt, da);
      wg_fence();
      fence_regs(dv);
      fence_regs(dk);
#pragma unroll
      for (int k16 = 0; k16 < 4; ++k16)
        wgmma_rs<HD>(dv, pa[k16], desc_mn(do_addr + k16 * 2048, PANEL));
#pragma unroll
      for (int k16 = 0; k16 < 4; ++k16)
        wgmma_rs<HD>(dk, da[k16], desc_mn(q_addr + k16 * 2048, PANEL));
      wg_commit();
      fence_regs(dv);
      fence_regs(dk);
      wg_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
  bf16* dkb = static_cast<bf16*>(a.dk) + b * a.dks.b + kh * a.dks.h;
  bf16* dvb = static_cast<bf16*>(a.dv) + b * a.dvs.b + kh * a.dvs.h;
  store_acc<HD>(dk, a.scale, dkb, a.dks.s, kg, a.sk, wq, lane);
  store_acc<HD>(dv, 1.f, dvb, a.dvs.s, kg, a.sk, wq, lane);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, from the libcuda.so.1 that the CUDA
// runtime has loaded (so the library is not linked against libcuda)
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!lib) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib ? reinterpret_cast<EncodeTiled>(
                     dlsym(lib, "cuTensorMapEncodeTiled"))
               : nullptr;
  }();
  return fn;
}

// the 4-D map (hd, s, h, b) of a bf16 tensor with 64 x 64 boxes, swizzled
// by 128 bytes; rows at or past s read as zeros
bool make_map(CUtensorMap* map, const void* base, int hd, int s, int h,
              int b, const Strides& st) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st.s) * 2,
                                 static_cast<cuuint64_t>(st.h) * 2,
                                 static_cast<cuuint64_t>(st.b) * 2};
  const cuuint32_t box[4] = {64, BM, 1, 1};
  const cuuint32_t one[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
            const_cast<void*>(base), dims, strides, box, one,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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
                               kv_smem<HD>());
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  TcArgs t;
  t.a = a;
  t.sqp = (a.sq + BM - 1) / BM * BM;
  t.lse2 = a.delta;
  t.dsum = a.delta + static_cast<long long>(b) * a.hq * t.sqp;
  if (!make_map(&t.q, a.q, HD, a.sq, a.hq, b, a.qs) ||
      !make_map(&t.dout, a.dout, HD, a.sq, a.hq, b, a.dos) ||
      !make_map(&t.k, a.k, HD, a.sk, a.hkv, b, a.ks) ||
      !make_map(&t.v, a.v, HD, a.sk, a.hkv, b, a.vs))
    return static_cast<int>(cudaErrorInvalidValue);
  flash_attention_bwd_dq_kernel<HD>
      <<<dim3(b * a.hq, t.sqp / BM), DQ_THREADS, dq_smem<HD>(), stream>>>(
          t);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_attention_bwd_dkdv_kernel<HD>
      <<<dim3((a.sk + BKV - 1) / BKV, b * a.hkv), KV_THREADS, kv_smem<HD>(),
         stream>>>(t);
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
// delta: fp32 scratch of 2 * B * Hq * sqp floats, sqp = Sq rounded up to
// a multiple of 64 (bf16: lse * log2 e, then D, each [B * Hq][sqp];
// fp32: D as [B, Hq, Sq]), written by the first launch and read by the
// second.  The mask arguments are the forward's.  bf16: 1 = every tensor
// but lse and delta bfloat16 (wgmma and TMA; strides multiples of 8,
// bases 16-byte aligned), 0 = float32 (FMA kernel).  Launches the dQ
// pass, then the dK/dV pass, on the stream.  Returns a CUDA error code
// (0 = none); hd outside {64, 128}, the forward's refused masks, or a
// tensor map libcuda refuses, is cudaErrorInvalidValue.  b == 0 or
// sq == 0 launches nothing (the caller zero-fills dk and dv).
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
