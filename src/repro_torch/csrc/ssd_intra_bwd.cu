// Backward of the Mamba-2 SSD intra-chunk product K5 (ssd_intra.cu).
//
// The TPU kernel src/repro/kernels/ssd_intra/ssd_intra.py (ssd_intra, the
// pallas_call at line 52) is forward-only: JAX differentiates its model
// through the einsum of src/repro/models/ssm.py.  The port runs K5 in the
// forward pass on the card, so its autograd Function
// (src/repro_torch/kernels/ssd_intra.py) needs this backward; the wrapper
// is ssd_intra_bwd there, beside its plain version ssd_intra_bwd_plain.
//
// What it computes, per chunk c, from the forward's inputs and output Y
// and the output's gradient dY, with L[q,k,h] = exp(cs[q,h] - cs[k,h])
// for k <= q, else 0:
//   G[q,k,h]   = sum_p dY[q,h,p] Win[k,h,p]
//   dWin[k,h,:] = sum_{q >= k} CB[q,k] L[q,k,h] dY[q,h,:]
//   dCB[q,k]   = sum_h L[q,k,h] G[q,k,h]
//   dS = CB o L o G:  dcs[q,h] = sum_k dS[q,k,h] - sum_q' dS[q',q,h]
// The first sum of dcs is sum_p dY[q,h,p] Y[q,h,p] (Y = sum_k CB L Win),
// so it is read from the forward's output and needs no pass over k.
// fp32 only (the model calls K5 on fp32 tensors).  L is selected to 0
// above the diagonal before any product: exp there is inf, inf * 0 NaN.
//
// Design: the transposed problem, as FlashAttention-2's dK/dV pass is
// to its forward.  A block of 8 warps owns a 64-key tile of one chunk
// and a group of HPB = 8 heads, and walks its heads in order; for each
// head it walks the query rows at or below its keys in steps of 64.  The
// warps are two halves of 4, each warp with 16 keys; a half takes 32 of
// a step's rows, and at a head's end the second half's dWin and column
// sums are added to the first's, in that order (staged in the head's Win
// buffer, between two barriers).  The products run on the tensor cores
// in 3xTF32 (mma.sync.m16n8k8), with the forward's split (ssd_intra.cu):
// each operand x is big = tf32(x), small = tf32(x - big), and a product
// adds small.big, big.small, then big.big into fp32 sums.  A step of a warp:
//   G^T = Win dY^T over P: A the warp's 16 Win rows (a [64, P] tile of
//     the head), B the half's 32 dY rows, 16 x 32 in fp32 C fragments;
//   L^T = exp(cs[q] - cs[k]), selected to 0 above the diagonal before
//     any product, and (CB o L)^T, built at the C fragments' own (key,
//     row) positions, as the forward builds its A operand;
//   dS^T = (CB o L)^T o G^T gives each key's sum over rows (the second
//     term of dcs) in registers;
//   dWin += (CB o L)^T dY over the half's 32 rows: the C fragment of
//     each 8-row block is repacked as the A fragment of a k-step without
//     a shuffle, by taking the step's rows in the order (2t, 2t + 1) that
//     a thread holds them, and reading dY's B fragment in that order;
//   the dCB strip [64 keys, Q rows] in shared memory += L o G^T, each
//     entry owned by one thread for every head (no barrier), so it sums
//     the group's heads in head order.
// dY tiles come through a two-stage cp.async ring (one barrier a step),
// with the next head's Win tile and cs column into the other half of
// double buffers on its first step.  Row strides are P + 4 floats (4 mod
// 32 words), so every fragment read is free of bank conflicts; the dCB
// strip's rows are padded to 8 mod 32 words for its pairs.  CB is read at
// the fragment positions from global memory (2 MB, L2-resident).
//   The first sum of dcs, sum_k dS[q, k, h], is sum_p dY[q, h, p] Y[q, h,
// p]: a block takes it for its own keys' rows, which are its first
// step's dY rows, with Y read from global memory (so the kernel reads Y,
// 42 MB at the Mamba2 shape, which the bound does not count; dropping it
// would need every key tile's row sums of dS).
//   The strips of a key tile's head groups are summed by the last of its
// blocks to finish (an atomic counter per key tile, after a memory
// fence), in group order, whichever block that is; that block resets the
// counter to 0 for the next call.  No atomics touch a value, and every
// sum is the same bits from run to run.
//
// What bounds it on the H100: bytes.  At the Mamba2-2.7B training shape
// (8 chunks of Q 256, 80 heads, P 64) the function's bytes (CB, cs, Win,
// dY in; dCB, dcs, dWin out) are 131 MB, 39.2 us at 3.35 TB/s; the
// triangle is 2 products of 2 P operations per (q, k, h) pair, 5.4
// GFLOP, 11 us at the TF32 peak and 33 us tripled.  The grid is 10 head
// groups x 8 chunks x 4 key tiles, 320 blocks of 256 threads (one an SM:
// the dCB strip takes 66 KB of shared memory), the key tiles with the
// most rows issued first.  What holds it above its bound (PERF.md): the
// issue of each step's copies, a barrier a step whose diagonal steps
// leave warps idle, two more at a head's end, and one block an SM.

#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

namespace {

constexpr int KT = 64;               // keys a block (16 a warp)
constexpr int QT = 64;               // query rows a step
constexpr int NT = 256;            // two halves of 4 warps
constexpr int MAX_Q = 256;
constexpr int HPB = 8;               // heads a block
constexpr float LOG2E = 1.4426950408889634f;

// fp32 -> TF32 bits as cvt.rna.tf32.f32 rounds (ssd_intra.cu)
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = tf32(x);
  small = tf32(x - __uint_as_float(big));
}

// d += a . b for one m16n8k8 tile: TF32 operands, fp32 sums
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 3xTF32: d += a . b, a given split, b (b0, b1) split here; the small
// terms first
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], float b0,
                                     float b1) {
  uint32_t bb0, bs0, bb1, bs1;
  split(b0, bb0, bs0);
  split(b1, bb1, bs1);
  mma(d, as, bb0, bb1);
  mma(d, ab, bs0, bs1);
  mma(d, ab, bb0, bb1);
}

// 2^x on the MUFU unit (denormal results flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes, or 16 zero bytes when !ok
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait0() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// floats of the dynamic shared memory: the dCB strip [KT][sd], two Win
// tiles [KT][P + 4], two dY stages [QT][P + 4], two cs columns [q]
template <int P>
__host__ __device__ constexpr int smem_floats(int q, int sd) {
  return KT * sd + 4 * KT * (P + 4) + 2 * q;
}
__host__ __device__ constexpr int strip_stride(int q) {
  return (q + QT - 1) / QT * QT + 8;
}

template <int P>
__global__ void __launch_bounds__(NT, 1) ssd_intra_bwd_kernel(
    const float* __restrict__ cb, const float* __restrict__ cs,
    const float* __restrict__ win, const float* __restrict__ y,
    const float* __restrict__ dy, float* __restrict__ dcb,
    float* __restrict__ dcs, float* __restrict__ dwin,
    float* __restrict__ part, int* __restrict__ done, int q, int h) {
  constexpr int DS = P + 4;          // row stride of the Win and dY tiles
  constexpr int NP = P / 8;          // 8-column blocks of P
  constexpr int CH = P / 4;          // 16-byte chunks of a row
  extern __shared__ __align__(16) float sm[];
  const int groups = gridDim.x;
  const int grp = blockIdx.x;
  const int c = blockIdx.y;
  const int kt = blockIdx.z;         // the key tiles with most rows first
  const int k0 = kt * KT;
  const int h_begin = grp * HPB;
  const int nh = min(h, h_begin + HPB) - h_begin;
  const int nq = q - k0;             // rows k0 .. q-1 see these keys
  const int n_steps = (nq + QT - 1) / QT;
  const int n_tiles = nh * n_steps;
  const int sd = strip_stride(q);
  float* s_dcb = sm;                 // [KT][sd] dCB[k0 + r, k0 + j] at j, r
  float* s_w = s_dcb + KT * sd;      // [2][KT][DS] Win rows of a head
  float* s_dy = s_w + 2 * KT * DS;   // [2][QT][DS] dY rows of a step
  float* s_cs = s_dy + 2 * QT * DS;  // [2][q] cs column of a head

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;           // fragment row group
  const int tq = lane & 3;           // thread in the group
  const int half = warp >> 2;        // the step's rows 32 half .. + 31
  // the warp's 16 keys, 16 wk ..: mirrored in the second half, so that
  // the two warps of a scheduler (warp % 4) share a diagonal step's work
  const int wk = half ? 3 - (warp & 3) : warp & 3;
  const int hp = h * P;              // offsets inside a chunk fit in int
  const float* cbc = cb + static_cast<long long>(c) * q * q;
  const float* csc = cs + static_cast<long long>(c) * q * h;
  const float* winc = win + static_cast<long long>(c) * q * hp;
  const float* yc = y + static_cast<long long>(c) * q * hp;
  const float* dyc = dy + static_cast<long long>(c) * q * hp;
  float* dwinc = dwin + static_cast<long long>(c) * q * hp;
  float* dcsc = dcs + static_cast<long long>(c) * q * h;
  __shared__ float s_col[KT];        // the second half's column sums
  for (int i = tid; i < KT * sd; i += NT) s_dcb[i] = 0.f;

  // tile t = (head hi, step si): its dY rows, and on a head's first step
  // the head's Win rows and cs column
  auto issue = [&](int t) {
    const int hi = t / n_steps, si = t % n_steps, hh = h_begin + hi;
    float* dst = s_dy + (t & 1) * QT * DS;
#pragma unroll
    for (int it = 0; it < QT * CH / NT; ++it) {
      const int i = tid + it * NT;
      const int r = i / CH, cc = i % CH, row = k0 + si * QT + r;
      const bool ok = row < q;
      cp_async16(dst + r * DS + 4 * cc,
                 ok ? dyc + row * hp + hh * P + 4 * cc : dy, ok);
    }
    if (si == 0) {
      float* w = s_w + (hi & 1) * KT * DS;
#pragma unroll
      for (int it = 0; it < KT * CH / NT; ++it) {
        const int i = tid + it * NT;
        const int r = i / CH, cc = i % CH, key = k0 + r;
        const bool ok = key < q;
        cp_async16(w + r * DS + 4 * cc,
                   ok ? winc + key * hp + hh * P + 4 * cc : win, ok);
      }
      float* col = s_cs + (hi & 1) * q;
      for (int i = k0 + tid; i < q; i += NT)
        cp_async4(col + i, csc + i * h + hh);
    }
  };

  const int kw = k0 + 16 * wk;       // the warp's first key
  const int key0 = kw + g;           // keys of c0, c1 and of c2, c3
  const int key1 = key0 + 8;
  float dw[NP][4];                   // dWin of the keys over the half's rows
  constexpr bool HOLD_W = P <= 64;
  uint32_t wab[HOLD_W ? NP : 1][4], was[HOLD_W ? NP : 1][4];
  float colsum[2], rowsum[2];        // sum_q dS[q, key]; sum_p dY Y
  float2 yv[2][NP];                  // Y of a head's keys, a step ahead
  auto load_y = [&](int hh) {
    if (half) return;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float* yr = yc + min(r ? key1 : key0, q - 1) * hp + hh * P + 2 * tq;
#pragma unroll
      for (int m = 0; m < NP; ++m)
        yv[r][m] = __ldg(reinterpret_cast<const float2*>(yr + 8 * m));
    }
  };
  issue(0);
  cp_commit();
  load_y(h_begin);
  for (int t = 0; t < n_tiles; ++t) {
    cp_wait0();
    __syncthreads();                 // tile t landed; tile t - 1 consumed
    if (t + 1 < n_tiles) issue(t + 1);
    cp_commit();
    const int hi = t / n_steps, si = t % n_steps, hh = h_begin + hi;
    const int r0 = k0 + si * QT;     // the step's first row
    const int rh = r0 + 32 * half;   // the half's first row
    const float* sdy = s_dy + (t & 1) * QT * DS;
    const float* sw = s_w + (hi & 1) * KT * DS + 16 * wk * DS;
    const float* scs = s_cs + (hi & 1) * q;
    if (si == 0) {
#pragma unroll
      for (int m = 0; m < NP; ++m)
        dw[m][0] = dw[m][1] = dw[m][2] = dw[m][3] = 0.f;
      colsum[0] = colsum[1] = rowsum[0] = rowsum[1] = 0.f;
      // sum_p dY Y of the keys' own rows (the step's first 64 rows), in
      // the first half's warps, with the Y loaded a step ahead
      if (!half) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float* dr =
              sdy + (min(r ? key1 : key0, q - 1) - k0) * DS + 2 * tq;
#pragma unroll
          for (int m = 0; m < NP; ++m) {
            const float2 b = *reinterpret_cast<const float2*>(dr + 8 * m);
            rowsum[r] += yv[r][m].x * b.x + yv[r][m].y * b.y;
          }
        }
      }
    }
    // Win's split A fragments of the G^T product below, kept for the
    // head's steps where registers allow (P <= 64), else split again at
    // each step
    auto w_frag = [&](int kk, uint32_t(&ab)[4], uint32_t(&as)[4]) {
      const float* wp = sw + g * DS + 8 * kk + tq;
      split(wp[0], ab[0], as[0]);
      split(wp[8 * DS], ab[1], as[1]);
      split(wp[4], ab[2], as[2]);
      split(wp[8 * DS + 4], ab[3], as[3]);
    };
    if constexpr (HOLD_W) {
      if (si == 0) {
#pragma unroll
        for (int kk = 0; kk < NP; ++kk) w_frag(kk, wab[kk], was[kk]);
      }
    }
    // a warp none of whose keys the half's rows reach (on the diagonal
    // tile) or whose rows all lie past Q skips the step's products
    const bool idle = rh >= q || rh + 31 < kw;
    if (!idle) {
      // CB at the C fragments' (row, key) positions (clamped in range; the
      // select below zeroes what lies outside), in flight during G^T
      float cbv[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = min(rh + 8 * n + 2 * tq + (e & 1), q - 1);
          const int key = min(e < 2 ? key0 : key1, q - 1);
          cbv[n][e] = __ldg(cbc + row * q + key);
        }
      }

      // G^T = Win dY^T: rows the warp's 16 keys, columns the half's rows
      float gt[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
        gt[n][0] = gt[n][1] = gt[n][2] = gt[n][3] = 0.f;
      // an 8-row block n is worked if a row of it lies at or below a key
      // of the warp and above Q: every block below the diagonal tile, so
      // the loop runs there without a test
      auto live = [&](int n) {
        return rh + 8 * n < q && rh + 8 * n + 7 >= kw;
      };
      auto g_product = [&](auto all_live) {
#pragma unroll
        for (int kk = 0; kk < NP; ++kk) {
          uint32_t ab[4], as[4];
          if constexpr (HOLD_W) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              ab[i] = wab[kk][i];
              as[i] = was[kk][i];
            }
          } else {
            w_frag(kk, ab, as);
          }
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            if (!decltype(all_live)::value && !live(n)) continue;
            const float* bp =
                sdy + (32 * half + 8 * n + g) * DS + 8 * kk + tq;
            mma3(gt[n], ab, as, bp[0], bp[4]);
          }
        }
      };
      if (live(0) && live(3))
        g_product(std::true_type());
      else
        g_product(std::false_type());

      const float csk[2] = {scs[min(key0, q - 1)], scs[min(key1, q - 1)]};
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        if (!live(n)) continue;
        const int rb = rh + 8 * n + 2 * tq;     // rows of (c0, c2), (c1, c3)
        float cl[4], lg[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = rb + (e & 1);
          const int key = e < 2 ? key0 : key1;
          const bool ok = row < q && key <= row;  // select before the exp
          const float l =
              ok ? ex2((scs[min(row, q - 1)] - csk[e >> 1]) * LOG2E) : 0.f;
          lg[e] = l * gt[n][e];
          cl[e] = ok ? cbv[n][e] * l : 0.f;
          colsum[e >> 1] += cl[e] * gt[n][e];
        }
        // the dCB strip += L o G (entries of this thread's alone)
        float2* s0 = reinterpret_cast<float2*>(s_dcb + (key0 - k0) * sd +
                                               rb - k0);
        float2* s1 = reinterpret_cast<float2*>(s_dcb + (key1 - k0) * sd +
                                               rb - k0);
        float2 v0 = *s0, v1 = *s1;
        v0.x += lg[0];
        v0.y += lg[1];
        v1.x += lg[2];
        v1.y += lg[3];
        *s0 = v0;
        *s1 = v1;
        // dWin += (CB o L)^T dY over the block's 8 rows, in the order
        // (2tq, 2tq + 1) of the C fragment: a0 = c0, a1 = c2, a2 = c1,
        // a3 = c3, and dY's B rows rb and rb + 1
        uint32_t ab[4], as[4];
        split(cl[0], ab[0], as[0]);
        split(cl[2], ab[1], as[1]);
        split(cl[1], ab[2], as[2]);
        split(cl[3], ab[3], as[3]);
        const float* bp = sdy + (rb - r0) * DS + g;
#pragma unroll
        for (int m = 0; m < NP; ++m)
          mma3(dw[m], ab, as, bp[8 * m], bp[DS + 8 * m]);
      }
    }

    if (si == n_steps - 1) {
      // the head's dWin and dcs: the second half's partial sums, staged in
      // the head's Win buffer (free once every warp is past this step's
      // G^T), then the first half's added to them, in that order
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {
          colsum[r] += __shfl_xor_sync(0xffffffffu, colsum[r], o);
          rowsum[r] += __shfl_xor_sync(0xffffffffu, rowsum[r], o);
        }
      }
      float* sx = s_w + (hi & 1) * KT * DS;     // [KT][DS]
      __syncthreads();
      if (half) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int j = (r ? key1 : key0) - k0;
          if (tq == 0) s_col[j] = colsum[r];
#pragma unroll
          for (int m = 0; m < NP; ++m)
            *reinterpret_cast<float2*>(sx + j * DS + 8 * m + 2 * tq) =
                make_float2(dw[m][2 * r], dw[m][2 * r + 1]);
        }
      }
      __syncthreads();
      if (!half) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int key = r ? key1 : key0;
          if (key >= q) continue;
          const float* xr = sx + (key - k0) * DS + 2 * tq;
          float* out = dwinc + key * hp + hh * P + 2 * tq;
#pragma unroll
          for (int m = 0; m < NP; ++m) {
            float2 v = *reinterpret_cast<const float2*>(xr + 8 * m);
            v.x += dw[m][2 * r];
            v.y += dw[m][2 * r + 1];
            *reinterpret_cast<float2*>(out + 8 * m) = v;
          }
          if (tq == 0)
            dcsc[key * h + hh] =
                rowsum[r] - (s_col[key - k0] + colsum[r]);
        }
      }
      if (t + 1 < n_tiles) load_y(hh + 1);
    }
  }

  // this group's dCB strip to the partials ([row][key]); the key tile's
  // last block to finish sums the groups' strips in group order
  const long long tile = static_cast<long long>(c) * gridDim.z + kt;
  const long long strip = static_cast<long long>(q) * KT;
  float* mine = part + (tile * groups + grp) * strip;
  __syncthreads();
  for (int i = tid; i < nq * KT; i += NT)
    mine[i] = s_dcb[(i % KT) * sd + i / KT];
  __threadfence();
  __syncthreads();
  __shared__ int last;
  if (tid == 0) {
    last = atomicAdd(done + tile, 1) == groups - 1;
    if (last) done[tile] = 0;        // every group has come: reset
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // four keys of up to PER rows a thread, summed over the groups in
  // order, a group's loads all in flight at once
  constexpr int PER = MAX_Q * (KT / 4) / NT;
  const float* all = part + tile * groups * strip;
  float4 acc[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u) acc[u] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int gi = 0; gi < groups; ++gi) {
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int i = tid + u * NT;
      const int row = i / (KT / 4), j = (i % (KT / 4)) * 4;
      if (row < k0 || row >= q) continue;
      const float4 v = __ldcg(reinterpret_cast<const float4*>(
          all + gi * strip + (row - k0) * KT + j));
      acc[u].x += v.x;
      acc[u].y += v.y;
      acc[u].z += v.z;
      acc[u].w += v.w;
    }
  }
  float* dcbc = dcb + static_cast<long long>(c) * q * q;
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int i = tid + u * NT;
    const int row = i / (KT / 4), j = (i % (KT / 4)) * 4;
    if (row >= q) continue;
    const float o[4] = {acc[u].x, acc[u].y, acc[u].z, acc[u].w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (k0 + j + e < q) dcbc[row * q + k0 + j + e] = o[e];
  }
}

template <int P>
int launch(const float* cb, const float* cs, const float* win,
           const float* y, const float* dy, float* dcb, float* dcs,
           float* dwin, float* part, int* done, int bc, int q, int h,
           cudaStream_t stream) {
  const int bytes = smem_floats<P>(q, strip_stride(q)) * 4;
  static bool configured = false;    // the attribute is per function
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_intra_bwd_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_floats<P>(MAX_Q, strip_stride(MAX_Q)) * 4);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  ssd_intra_bwd_kernel<P>
      <<<dim3((h + HPB - 1) / HPB, bc, (q + KT - 1) / KT), NT, bytes,
         stream>>>(cb, cs, win, y, dy, dcb, dcs, dwin, part, done, q, h);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// All tensors contiguous fp32: cb [bc, q, q], cs [bc, q, h], win, y, dy
// [bc, q, h, p] (y the forward's output, dy its gradient) in; dcb, dcs,
// dwin of the inputs' shapes out, every element written.  Scratch: part,
// bc * ceil(q / 64) * ceil(h / 8) * q * 64 floats (a dCB strip a block);
// done, bc * ceil(q / 64) ints, zero on entry and left zero.  Returns a
// CUDA error code (0 = none); q above 256 or p outside {16, 32, 64, 128}
// is cudaErrorInvalidValue.
extern "C" int ssd_intra_bwd_launch(const float* cb, const float* cs,
                                    const float* win, const float* y,
                                    const float* dy, float* dcb, float* dcs,
                                    float* dwin, float* part, int* done,
                                    int bc, int q, int h, int p,
                                    void* stream) {
  if (bc == 0 || q == 0 || h == 0) return 0;
  if (q > MAX_Q || static_cast<long long>(q) * h * p >= 1LL << 31)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (p) {
    case 16:
      return launch<16>(cb, cs, win, y, dy, dcb, dcs, dwin, part, done, bc,
                        q, h, st);
    case 32:
      return launch<32>(cb, cs, win, y, dy, dcb, dcs, dwin, part, done, bc,
                        q, h, st);
    case 64:
      return launch<64>(cb, cs, win, y, dy, dcb, dcs, dwin, part, done, bc,
                        q, h, st);
    case 128:
      return launch<128>(cb, cs, win, y, dy, dcb, dcs, dwin, part, done, bc,
                        q, h, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
