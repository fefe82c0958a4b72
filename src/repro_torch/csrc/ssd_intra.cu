// Mamba-2 SSD intra-chunk dual form: a causal, decay-weighted product,
// on the tensor cores in 3xTF32.
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
// What bounds it on the H100: bytes.  At the Mamba2-2.7B prefill shape
// (8 chunks of Q 256, 80 heads, P 64, fp32) it must read cb, cs and Win
// and write Y: 86.6 MB, 25.9 us at 3.35 TB/s.  The causal triangle is
// 2.76 GFLOP, 5.6 us at the TF32 tensor-core peak of 494.7 TFLOP/s, and
// still 16.7 us tripled for 3xTF32.  (On fp32 FMAs, the first port's
// design, operations bound it: 41 us at 67 TFLOP/s.)
//
// Precision.  The path is fp32 end to end and the kernel is held to
// 2e-4 of the output's scale.  One TF32 product (10-bit mantissas) errs
// by 3.1e-4 to 5.8e-4 of the scale at this shape (numpy emulation), so
// each operand x is split as big = tf32(x), small = tf32(x - big), with
// tf32() rounding as cvt.rna.tf32.f32 does, and the product is the three
// terms small.big + big.small + big.big, the small ones added first;
// emulated, that errs by 0.9e-7 to 2.1e-7 of the scale
// (tests/test_torch_kernel_design.py emulates this design on the CPU).
// bf16 inputs take the same kernel, widened to fp32 on load (exact):
// Win's small part is then 0 and its term is skipped.
//
// Design.  One block of 4 warps owns (chunk, 64-row query tile, G
// heads); each warp owns 16 query rows, one m16n8k8 m-tile.  The block
// walks key tiles of 32 up to its diagonal through a two-stage cp.async
// ring in dynamic shared memory: a stage holds the [64, 32] CB tile,
// shared by the G heads (so CB is read once per block), and the [32, P]
// Win slices of the G heads.  The chunk's cs column of the G heads is
// staged once.  A warp's key loop stops at its own diagonal, 8 keys a
// step (mma.sync.m16n8k8 tf32, fp32 accumulators in registers); the
// mask (key <= row, a select before the multiply) only cuts on the
// steps that cross the diagonal.  The A operand, S[q, k] = CB[q, k] *
// exp(cs[q] - cs[k]), is built in registers from the fragment elements
// each thread owns (exp as one MUFU ex2 of the difference times log2 e)
// and never staged as a scores tile; B is read from the Win slice and
// split into big and small in registers.  Row strides are padded so
// that both fragment reads are free of bank conflicts: CB rows by 4
// words (fp32; 40 halves for bf16), Win rows to 8 words past a multiple
// of 64.  G = 2 heads at P <= 64: 64 accumulator registers a thread, and
// 3 blocks of 56 KB an SM at P 64 (launch bounds hold the kernel to 168
// registers for that); 1280 blocks at the Mamba2 shape.  At P 128 the
// accumulator alone is 64 registers a head, so G = 1.  Head counts that
// G does not divide, ragged Q (keys and rows past Q come in as zeros
// and are not stored) and P (columns up to the next multiple of 8 come
// in as zeros) are masked.  The grid issues the query tiles with the
// most keys first, so the triangle leaves no tail.  Rows or columns that
// are not 16-byte aligned (Q or P not a multiple of 16 bytes) are loaded
// element by element instead of by cp.async.
//
// What holds it above its bound (PERF.md): instruction issue.  Around
// its 24 mma.sync, a warp's step of one head issues several times as
// many instructions for the A operand's exp, select and split and for
// B's split, and 12 warps an SM do not hide the stalls of the ring's
// cp.async issue and of the block barriers.  Splitting the Win tile once
// per block into shared memory, two m-tiles a warp (register spills) and
// row-by-row bulk copies (TMA) were each slower.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;               // query rows per block
constexpr int NW = 4;                // warps, 16 query rows each
constexpr int NT = NW * 32;
constexpr int MIN_BLOCKS = 3;        // blocks an SM: at most 170 registers
constexpr int KT = 32;               // keys per tile
constexpr int MAX_Q = 256;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// heads per block, the padded row strides of a stage's CB and Win tiles
// (elements of T), and the shared-memory layout in bytes: the cs column,
// then two stages of (CB tile, Win tiles of the G heads)
template <int NP>
__host__ __device__ constexpr int heads_per_block() {
  return NP <= 8 ? 2 : 1;
}
template <typename T>
__host__ __device__ constexpr int cb_stride() {
  return sizeof(T) == 4 ? KT + 4 : KT + 8;
}
template <int NP>
__host__ __device__ constexpr int win_stride() {
  return (8 * NP + 63) / 64 * 64 + 8;
}
template <typename T, int NP>
__host__ __device__ constexpr int stage_bytes() {
  return (BQ * cb_stride<T>() + heads_per_block<NP>() * KT * win_stride<NP>()) *
         static_cast<int>(sizeof(T));
}
__host__ __device__ constexpr int cs_bytes(int n_qt, int g) {
  return (n_qt * BQ * g * 4 + 15) / 16 * 16;
}
template <typename T, int NP>
int smem_bytes(int n_qt) {
  return cs_bytes(n_qt, heads_per_block<NP>()) + 2 * stage_bytes<T, NP>();
}

__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* dst, float a,
                                       float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  // bytes past src_bytes are written as zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// 16 bytes of T at dst from the first n valid elements at src, zeros
// after them; by cp.async when rows are 16-byte aligned (vec)
template <typename T>
__device__ __forceinline__ void copy_chunk(T* dst, const T* src,
                                           const T* base, int n, bool vec) {
  constexpr int E = 16 / sizeof(T);
  n = max(0, min(n, E));
  if (vec) {
    cp_async16(dst, n ? src : base, n * static_cast<int>(sizeof(T)));
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) dst[e] = e < n ? src[e] : from_f<T>(0.f);
  }
}

// fp32 -> TF32 bits as cvt.rna.tf32.f32 rounds (half away from zero on
// the 13 dropped bits), in two integer operations
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// d += a . b for one m16n8k8 tile: TF32 operands, fp32 sums
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the MUFU unit (denormal results flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// key tile k0 of the block into one stage: CB[q0:q0+64, k0:k0+KT] (rows
// padded to cb_stride) and Win[k0:k0+KT, h0+g, 0:8NP] for each head g
// of the group.  cbb points at CB[c, q0, 0] and winb at Win[c, 0, h0, 0];
// offsets from them fit in 32 bits (the launcher checks q * h * p).
template <typename T, int NP>
__device__ __forceinline__ void load_tile(T* stage, const T* cbb,
                                          const T* winb, const T* base,
                                          int q, int h, int p, int q0,
                                          int h0, int k0, int tid, bool vec) {
  constexpr int G = heads_per_block<NP>();
  constexpr int E = 16 / sizeof(T);
  constexpr int CBS = cb_stride<T>();
  constexpr int WS = win_stride<NP>();
  constexpr int CB_CH = KT / E;                  // chunks of a CB tile row
  constexpr int W_CH = 8 * NP / E;               // chunks of a Win row
  static_assert(BQ * CB_CH % NT == 0 && G * KT * W_CH % NT == 0,
                "whole passes over the tile");
  T* scb = stage;
  T* sw = stage + BQ * CBS;
#pragma unroll
  for (int it = 0; it < BQ * CB_CH / NT; ++it) {
    const int i = tid + it * NT;
    const int r = i / CB_CH, kk = (i % CB_CH) * E;
    const int key = k0 + kk;
    copy_chunk(scb + r * CBS + kk, cbb + r * q + key, base,
               q0 + r < q ? q - key : 0, vec);
  }
#pragma unroll
  for (int it = 0; it < G * KT * W_CH / NT; ++it) {
    const int i = tid + it * NT;
    const int g = i / (KT * W_CH), rem = i % (KT * W_CH);
    const int kk = rem / W_CH, pp = (rem % W_CH) * E;
    const int key = k0 + kk;
    copy_chunk(sw + (g * KT + kk) * WS + pp, winb + (key * h + g) * p + pp,
               base,
               key < q && h0 + g < h ? p - pp : 0, vec);
  }
}

template <typename T, int NP>
__global__ void __launch_bounds__(NT, MIN_BLOCKS) ssd_intra_kernel(
    const T* __restrict__ cb, const T* __restrict__ cs,
    const T* __restrict__ win, T* __restrict__ out, int q, int h, int p,
    int vec) {
  constexpr int G = heads_per_block<NP>();
  constexpr int CBS = cb_stride<T>();
  constexpr int WS = win_stride<NP>();
  constexpr bool EXACT_B = sizeof(T) == 2;       // bf16 Win: small == 0
  constexpr int STAGE = stage_bytes<T, NP>();
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gq = lane >> 2;                      // fragment row group
  const int tq = lane & 3;                       // thread in the group
  const int n_qt = gridDim.z;
  const int h0 = blockIdx.x * G;
  const long long c = blockIdx.y;
  const int q0 = (n_qt - 1 - blockIdx.z) * BQ;   // most keys first
  const int k_end = min(q, q0 + BQ);             // keys the block needs
  const int n_tiles = (k_end + KT - 1) / KT;
  const T* cbb = cb + (c * q + q0) * q;
  const T* winb = win + (c * q * h + h0) * p;

  float* s_cs = reinterpret_cast<float*>(smem);  // [q0 + 64][G]
  unsigned char* stages = smem + cs_bytes(n_qt, G);

  // the cs column: every load in flight at once, then the stores
  constexpr int CS_IT = (MAX_Q * G + NT - 1) / NT;
  const int n_cs = (q0 + BQ) * G;
  float csv[CS_IT];
#pragma unroll
  for (int it = 0; it < CS_IT; ++it) {
    const int i = tid + it * NT;
    const int r = i / G, hh = h0 + i % G;
    csv[it] = i < n_cs && r < q && hh < h ? to_f(cs[(c * q + r) * h + hh])
                                          : 0.f;
  }
  load_tile<T, NP>(reinterpret_cast<T*>(stages), cbb, winb, cb, q, h, p, q0,
                   h0, 0, tid, vec);
  cp_commit();
  if (n_tiles > 1)
    load_tile<T, NP>(reinterpret_cast<T*>(stages + STAGE), cbb, winb, cb, q,
                     h, p, q0, h0, KT, tid, vec);
  cp_commit();
#pragma unroll
  for (int it = 0; it < CS_IT; ++it)
    if (tid + it * NT < n_cs) s_cs[tid + it * NT] = csv[it];
  __syncthreads();

  const int wrow = q0 + warp * 16;               // the warp's first row
  const int row0 = wrow + gq, row1 = row0 + 8;   // rows of c0,c1 / c2,c3
  const int w_last = wrow < q ? min(wrow + 15, q - 1) : -1;  // last key
  float cs_q[G][2];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    cs_q[g][0] = s_cs[row0 * G + g];
    cs_q[g][1] = s_cs[row1 * G + g];
  }
  float acc[G][NP][4];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int n = 0; n < NP; ++n)
      acc[g][n][0] = acc[g][n][1] = acc[g][n][2] = acc[g][n][3] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    cp_wait1();                                  // tile j has landed
    __syncthreads();
    const int k0 = j * KT;
    const T* stage = reinterpret_cast<const T*>(stages + (j & 1) * STAGE);
    const T* scb = stage + warp * 16 * CBS;
    const T* sw = stage + BQ * CBS;
#pragma unroll
    for (int st = 0; st < KT / 8; ++st) {
      const int kb = k0 + 8 * st;
      if (kb > w_last) break;                    // past the warp's diagonal
      const int key0 = kb + tq, key1 = key0 + 4;
      // A elements: a0 (row0, key0), a1 (row1, key0), a2 (row0, key1),
      // a3 (row1, key1)
      const T* cbp = scb + gq * CBS + 8 * st + tq;
      const float cbv[4] = {to_f(cbp[0]), to_f(cbp[8 * CBS]), to_f(cbp[4]),
                            to_f(cbp[8 * CBS + 4])};
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float ck[2] = {s_cs[key0 * G + g], s_cs[key1 * G + g]};
        uint32_t ab[4], as[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = e < 2 ? key0 : key1;
          const int row = e & 1 ? row1 : row0;
          // select before the multiply: above the diagonal ex2 is inf
          const float dec =
              key <= row ? ex2((cs_q[g][e & 1] - ck[e >> 1]) * LOG2E) : 0.f;
          const float sv = cbv[e] * dec;
          ab[e] = tf32(sv);
          as[e] = tf32(sv - __uint_as_float(ab[e]));
        }
        // B: Win rows 8st + tq (b0) and 8st + tq + 4 (b1), column 8n + gq;
        // the small terms first, then big . big
        const T* wp = sw + (g * KT + 8 * st + tq) * WS + gq;
#pragma unroll
        for (int n = 0; n < NP; ++n) {
          const float b0 = to_f(wp[8 * n]), b1 = to_f(wp[4 * WS + 8 * n]);
          if constexpr (EXACT_B) {
            const uint32_t bb0 = __float_as_uint(b0);
            const uint32_t bb1 = __float_as_uint(b1);
            mma(acc[g][n], as, bb0, bb1);
            mma(acc[g][n], ab, bb0, bb1);
          } else {
            const uint32_t bb0 = tf32(b0), bb1 = tf32(b1);
            mma(acc[g][n], as, bb0, bb1);
            mma(acc[g][n], ab, tf32(b0 - __uint_as_float(bb0)),
                tf32(b1 - __uint_as_float(bb1)));
            mma(acc[g][n], ab, bb0, bb1);
          }
        }
      }
    }
    __syncthreads();                             // stage j & 1 consumed
    if (j + 2 < n_tiles)
      load_tile<T, NP>(reinterpret_cast<T*>(stages + (j & 1) * STAGE), cbb,
                       winb, cb, q, h, p, q0, h0, k0 + 2 * KT, tid, vec);
    cp_commit();                                 // possibly empty
  }

  // C fragments: c0, c1 at (row0, 8n + 2tq + {0, 1}), c2, c3 at row1
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int hh = h0 + g;
    if (hh >= h) break;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = half ? row1 : row0;
      if (row >= q) continue;
      T* orow = out + ((c * q + row) * h + hh) * p;
#pragma unroll
      for (int n = 0; n < NP; ++n) {
        const int col = 8 * n + 2 * tq;
        const float v0 = acc[g][n][2 * half], v1 = acc[g][n][2 * half + 1];
        if (col + 1 < p && p % 2 == 0) {         // one aligned pair
          store2(orow + col, v0, v1);
        } else {
          if (col < p) orow[col] = from_f<T>(v0);
          if (col + 1 < p) orow[col + 1] = from_f<T>(v1);
        }
      }
    }
  }
}

template <typename T, int NP>
int launch_typed(const void* cb, const void* cs, const void* win, void* out,
                 int bc, int q, int h, int p, cudaStream_t stream) {
  constexpr int G = heads_per_block<NP>();
  constexpr int E = 16 / sizeof(T);
  const int n_qt = (q + BQ - 1) / BQ;
  const int bytes = smem_bytes<T, NP>(n_qt);
  auto kernel = ssd_intra_kernel<T, NP>;
  // set on every launch: the attribute belongs to the current device
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const bool aligned = ((reinterpret_cast<uintptr_t>(cb) |
                         reinterpret_cast<uintptr_t>(win)) & 15) == 0;
  const int vec = aligned && q % E == 0 && p % E == 0;
  dim3 grid((h + G - 1) / G, bc, n_qt);
  kernel<<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(cb), static_cast<const T*>(cs),
      static_cast<const T*>(win), static_cast<T*>(out), q, h, p, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_p(const void* cb, const void* cs, const void* win, void* out,
             int bc, int q, int h, int p, cudaStream_t stream) {
  if (p <= 16)
    return launch_typed<T, 2>(cb, cs, win, out, bc, q, h, p, stream);
  if (p <= 32)
    return launch_typed<T, 4>(cb, cs, win, out, bc, q, h, p, stream);
  if (p <= 64)
    return launch_typed<T, 8>(cb, cs, win, out, bc, q, h, p, stream);
  if (p <= 128)
    return launch_typed<T, 16>(cb, cs, win, out, bc, q, h, p, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// cb [bc, q, q], cs [bc, q, h], win and out [bc, q, h, p], all contiguous
// and of one dtype (bf16: 1 = bfloat16, 0 = float32).  Returns a CUDA
// error code (0 = none); q > 256, p > 128 or q * h * p >= 2^31 is
// cudaErrorInvalidValue.
extern "C" int ssd_intra_launch(const void* cb, const void* cs,
                                const void* win, void* out, int bc, int q,
                                int h, int p, int bf16, void* stream) {
  if (bc == 0 || q == 0 || h == 0 || p == 0) return 0;
  if (q > MAX_Q || p > 128 || static_cast<long long>(q) * h * p >= 1LL << 31)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_p<__nv_bfloat16>(cb, cs, win, out, bc, q, h, p, st);
  return launch_p<float>(cb, cs, win, out, bc, q, h, p, st);
}
