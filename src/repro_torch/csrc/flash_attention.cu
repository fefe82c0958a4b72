// Forward GQA flash attention with an online fp32 softmax.
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py
// (flash_attention, the pallas_call at line 90); the wrapper is
// src/repro_torch/kernels/flash_attention.py:flash_attention, which the
// model's attention() (src/repro_torch/models/attention.py) calls for
// every attention of a prefill on the card, self and cross, and for the
// encoder-decoder's cross-attention at every decode step.
//
// What it computes: for each batch b, query head h and query row i < Sq
// at position p = q_offset + i, softmax_j(q[b,h,i] . k[b,h/G,j] /
// sqrt(hd)) over the keys j < Sk (and j <= p when causal, and j > p - W
// when a window W is given: JAX's _mask in src/repro/models/
// attention.py with qpos = q_offset + i), times v; the output has q's
// dtype.  Sq and Sk may differ (cross-attention: the decoder's queries
// over the encoder's keys), and any of them may be ragged: the last
// tiles are masked.  Every query row must see at least one key (the
// wrapper and flash_attention_launch refuse a call where one does not,
// which takes a window: with q_offset >= 0 a causal row always sees key
// 0).  q, k, v and out are read and written
// through (batch, head, sequence) strides with a contiguous last
// dimension, so the model passes its [B, S, H, hd] tensors as
// transposed views and nothing is copied.  A masked score's probability
// is selected to 0, never computed (exp(NEG - NEG) would be 1 in a
// fully masked row of a tile).  Key tiles wholly above the causal
// diagonal are never visited, like the Pallas kernel's pl.when skip, nor
// those wholly below the window of the q tile's first row: a q tile
// whose first row is at position p0 walks from the key tile that holds
// key p0 - W + 1 up to the key of its last row below Sq (causal) or to
// Sk, so the work per q tile is bounded by (W + 64) / 64 key tiles
// whatever Sk is.
// GQA is an index: the kv head is h / G, K/V are never expanded.
//
// What bounds it on the H100: bytes, on the tensor cores.  At the
// Qwen3-1.7B prefill shape (B 4, S 512, 16 q heads, 8 kv heads, hd 128,
// causal) the causal half is 4.3 GFLOP of products against 25 MB of
// traffic: 4.4 us at the bf16 tensor-core rate against 7.5 us of bytes
// at 3.35 TB/s.  With no more than 8 q tiles of work per head, the
// practical limit is latency: how fast one block streams its k/v tiles
// through the tensor cores.  The llava-next-mistral-7b prefill (1664
// positions, 32 q heads) is bound by operations.  The encoder-decoder's
// cross-attention (seamless-m4t-medium: 512 decoder rows over 128
// encoder keys, not causal) is bound by bytes, and its decode step
// (Sq 1) fills one row of a 64-row q tile: the other 63 compute on zero
// rows and are not stored.  A split of Sk across blocks for Sq 1, as K3
// splits its window, is left for later.
//
// bf16 inputs (the model's whole card path) run flash_attention_bf16_
// kernel, in FlashAttention-2 shape.  A block of 4 warps owns a 64-row
// q tile of one (batch, q head); each warp owns 16 rows.  Both products
// are mma.sync.m16n8k16 (bf16 in, fp32 sums) on fragments that
// ldmatrix reads from shared memory: the q tile's fragments are loaded
// once (kept in registers for hd <= 128, re-read from shared memory for
// hd 256, where registers hold the 16 x 256 fp32 accumulator), k with
// ldmatrix, v with ldmatrix.trans.  The scores stay in the mma's C
// fragments; the online softmax runs on them in fp32 registers, a row's
// max reduced over the 4 lanes that share it (its sum once, at the
// end), exp2 on the MUFU unit.  Only a tile that crosses the causal
// diagonal, the window's lower edge for one of the warp's rows, or the
// ragged end applies the mask, behind one branch that
// is uniform over the warp, with bitwise predicates and selects: a
// branch per score element (what `||` and a conditional exp compile
// to) cost more than both products together.  The fp32 probabilities
// are rounded to bf16 and repacked in
// registers as the A operand of P.V, so P never touches shared memory.
// That rounding is the one numerical difference from the Pallas kernel,
// whose P.V is fp32: it moves the output by at most a few bf16 steps,
// inside the bf16 tolerance of 2e-2 (tests/test_torch_kernel_design.py
// emulates it on the CPU).  K/V tiles of 64 keys come in by cp.async,
// 16 bytes a thread, into a two-stage ring in dynamic shared memory:
// tile j+1's copy is in flight while tile j is computed.  Rows are
// 16-byte chunks XOR-swizzled by the row's low three bits, so the 8 row
// addresses of every ldmatrix fall in 8 distinct bank groups.  The grid
// issues the q tiles with the most causal work first (blockIdx.y
// reversed, heads fastest), so the triangle leaves no tail.  The output
// tile goes back through the warp's own q rows in shared memory and out
// as 16-byte stores.  Left for later: wgmma, TMA, warp specialisation.
// The `// PHASE <name>` lines of the key-tile loop mark its phases for
// scripts/bench_attention_kernels.py --phases, which reads the clock at
// each: keep them at the phase boundaries.
//
// fp32 inputs keep the first port's kernel, flash_attention_f32_kernel:
// scalar fp32 FMAs on the CUDA cores from fp32 shared-memory tiles.
// The tensor cores would take fp32 only as TF32, whose 10-bit mantissa
// loses digits that the fp32 tolerance of 2e-5 holds.  No served path
// runs fp32 K4; the model's fp32 tests on the card do.

#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// ------------------------------------------- fp32: the FMA kernel
// One block of 256 threads owns a 64-row q tile and loops over 32-key
// tiles staged in shared memory as fp32 (q and k rows padded to hd + 1
// floats); thread (ty, tx) owns rows 4ty..4ty+3, score columns tx and
// tx + 16 and output dims tx + 16n, a row's max and sum reduced over its
// 16 lanes; the probabilities go through shared memory to P.V.

constexpr int BQ = 64;               // q rows per block
constexpr int BK = 32;               // keys per tile
constexpr int NT = 256;              // threads per block (16 x 16)
constexpr int PS = BK + 1;           // padded row stride of the P tile
constexpr float NEG = -1e30f;        // the JAX kernel's NEG_INF

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ void from_f(float x, float* out) { *out = x; }

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
__global__ void __launch_bounds__(NT) flash_attention_f32_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, Strides qs, Strides ks,
    Strides vs, Strides os, int hq, int hkv, int sq, int sk, int q_offset,
    float scale, int causal, int window) {
  constexpr int QS = HD + 1;         // padded row stride of q and k tiles
  constexpr int DPT = HD / 16;       // output dims per thread
  extern __shared__ float smem[];
  float* sqt = smem;                 // [BQ][QS]
  float* skt = sqt + BQ * QS;        // [BK][QS]
  float* sv = skt + BK * QS;         // [BK][HD]
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
    sqt[r * QS + d] = pos < sq ? to_f(qb[pos * qs.s + d]) : 0.f;
  }

  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DPT; ++e) acc[i][e] = 0.f;
  }

  const int p0 = q_offset + q0;      // position of the tile's first row
  // causal: up to the key of the tile's last row (its last row < Sq)
  const int k_end = causal ? min(sk, p0 + min(BQ, sq - q0)) : sk;
  // the first key tile holding a key that row q0 sees (window 0: none)
  const int k_begin = window > 0 ? max(0, p0 - window + 1) / BK * BK : 0;
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();                 // q tile staged / last tile consumed
    for (int i = tid; i < BK * HD; i += NT) {
      const int r = i / HD, d = i % HD;
      const int pos = k0 + r;
      float kf = 0.f, vf = 0.f;
      if (pos < sk) {
        kf = to_f(kb[pos * ks.s + d]);
        vf = to_f(vb[pos * vs.s + d]);
      }
      skt[r * QS + d] = kf;
      sv[r * HD + d] = vf;
    }
    __syncthreads();

    float sc[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) sc[i][0] = sc[i][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      const float k0f = skt[tx * QS + d];
      const float k1f = skt[(tx + 16) * QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float qf = sqt[(ty * 4 + i) * QS + d];
        sc[i][0] += qf * k0f;
        sc[i][1] += qf * k1f;
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = p0 + ty * 4 + i;
      bool ok[2];
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kpos = k0 + tx + 16 * j;
        ok[j] = kpos < sk && (!causal || kpos <= qpos) &&
                (window == 0 || kpos > qpos - window);
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
    if (pos >= sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int e = 0; e < DPT; ++e)
      from_f(acc[i][e] * inv, &ob[pos * os.s + tx + 16 * e]);
  }
}

template <typename T, int HD>
int launch_typed(const void* q, const void* k, const void* v, void* out,
                 Strides qs, Strides ks, Strides vs, Strides os, int b,
                 int hq, int hkv, int sq, int sk, int q_offset, float scale,
                 int causal, int window, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<HD>();
  static bool configured = false;    // the attribute is per function
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_f32_kernel<T, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  dim3 grid((sq + BQ - 1) / BQ, b * hq);
  flash_attention_f32_kernel<T, HD><<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), qs, ks, vs, os, hq,
      hkv, sq, sk, q_offset, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v,
              void* out, Strides qs, Strides ks, Strides vs, Strides os,
              int b, int hq, int hkv, int sq, int sk, int q_offset,
              float scale, int causal, int window, cudaStream_t stream) {
  switch (hd) {
    case 64:
      return launch_typed<T, 64>(q, k, v, out, qs, ks, vs, os, b, hq, hkv,
                                 sq, sk, q_offset, scale, causal, window,
                                 stream);
    case 128:
      return launch_typed<T, 128>(q, k, v, out, qs, ks, vs, os, b, hq,
                                  hkv, sq, sk, q_offset, scale, causal,
                                  window, stream);
    case 256:
      return launch_typed<T, 256>(q, k, v, out, qs, ks, vs, os, b, hq,
                                  hkv, sq, sk, q_offset, scale, causal,
                                  window, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}


// ------------------------------------------- bf16: the tensor-core kernel

namespace tc {

constexpr int BQ = 64;               // q rows per block
constexpr int BK = 64;               // keys per tile
constexpr int NW = 4;                // warps per block, 16 q rows each
constexpr int NT = NW * 32;
constexpr int STAGES = 2;            // k/v tiles in the cp.async ring

using bf16 = __nv_bfloat16;

template <int HD>
constexpr int smem_bytes() {
  return (BQ + 2 * STAGES * BK) * HD * 2;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk c of row r in a [rows][HD] bf16 tile,
// the chunk index XOR-swizzled by the row's low three bits
template <int HD>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>(r * HD * 2 + ((c ^ (r & 7)) << 4));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  // src-size 0 writes 16 zero bytes: rows past S come in as zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0,
                                        uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t& r0,
                                          uint32_t& r1, uint32_t& r2,
                                          uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr)
      : "memory");
}

// d += a . b for one m16n8k16 tile: bf16 operands, fp32 sums
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x on the MUFU unit, one instruction (denormal results flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One score tile's online-softmax step on a warp's C fragments (query
// positions qrow0 / qrow1 for elements 0-1 / 2-3; wnd the window, read
// only when WND; sk the key count): scale into the log2 domain,
// raise the running max (reduced over the 4 lanes of a row), rescale
// the row's sum and accumulator, and leave the probabilities in sc.
// MASK selects a masked score's probability to 0 (never exp(NEG - NEG),
// which is 1 in a row with no key yet); the predicates are bitwise, so
// no element branches.
template <bool MASK, bool WND, int NN, int ND>
__device__ __forceinline__ void softmax_tile(float (&sc)[NN][4],
                                             float (&m)[2], float (&l)[2],
                                             float (&acc)[ND][4], int k0,
                                             int sk, int causal, int wnd,
                                             int qrow0, int qrow1, int lane,
                                             float scale_log2) {
  auto ok = [&](int n, int e) {
    const int key = k0 + 8 * n + 2 * (lane & 3) + (e & 1);
    const int row = e < 2 ? qrow0 : qrow1;
    return (key < sk) & (!causal | (key <= row)) &
           (!WND | (key > row - wnd));
  };
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int n = 0; n < NN; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (MASK) {
        sc[n][e] = ok(n, e) ? sc[n][e] * scale_log2 : -1e30f;
      } else {
        sc[n][e] *= scale_log2;
      }
      mx[e >> 1] = fmaxf(mx[e >> 1], sc[n][e]);
    }
  }
  float corr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    corr[r] = ex2(m[r] - mx[r]);
    m[r] = mx[r];
    l[r] *= corr[r];
  }
#pragma unroll
  for (int n = 0; n < NN; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = MASK ? (ok(n, e) ? ex2(sc[n][e] - m[e >> 1]) : 0.f)
                           : ex2(sc[n][e] - m[e >> 1]);
      sc[n][e] = p;
      l[e >> 1] += p;
    }
  }
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    acc[n][0] *= corr[0];
    acc[n][1] *= corr[0];
    acc[n][2] *= corr[1];
    acc[n][3] *= corr[1];
  }
}

// ROWS rows of HD bf16 starting at sequence position row0, by cp.async
template <int HD, int ROWS>
__device__ __forceinline__ void load_tile(unsigned char* dst, const bf16* src,
                                          long long stride, int row0, int s,
                                          int tid) {
  constexpr int KC = HD / 8;
  static_assert(ROWS * KC % NT == 0, "whole passes over the tile");
#pragma unroll
  for (int it = 0; it < ROWS * KC / NT; ++it) {
    const int i = tid + it * NT;
    const int r = i / KC, c = i % KC;
    const int pos = row0 + r;
    const bool ok = pos < s;
    const bf16* g = ok ? src + pos * stride + c * 8 : src;
    cp_async16(smem_u32(dst + swz<HD>(r, c)), g, ok);
  }
}

// WND: a window is given; XQ: Sq != Sk or a query offset (each chosen
// per launch, so self-attention at offset 0 without a window runs
// code that compares nothing for either: one length, positions = rows)
template <int HD, bool WND, bool XQ>
__global__ void __launch_bounds__(NT) flash_attention_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ out, Strides qs,
    Strides ks, Strides vs, Strides os, int hq, int hkv, int sq_len,
    int sk_len, int q_offset, float scale_log2, int causal, int window) {
  constexpr int KC = HD / 8;         // 16-byte chunks of a row
  constexpr int KS = HD / 16;        // k-steps of Q.K^T
  constexpr int NN = BK / 8;         // 8-key n-tiles of a score tile
  constexpr int ND = HD / 8;         // 8-dim n-tiles of the output
  constexpr bool Q_REGS = HD <= 128;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  unsigned char* sq = tc_smem;                       // [BQ][HD]
  unsigned char* sk = sq + BQ * HD * 2;              // [STAGES][BK][HD]
  unsigned char* sv = sk + STAGES * BK * HD * 2;     // [STAGES][BK][HD]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int bh = blockIdx.x;
  const int b = bh / hq;
  const int h = bh % hq;
  const int kh = h / (hq / hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // most work first
  const int skl = XQ ? sk_len : sq_len;              // keys
  const int p0 = (XQ ? q_offset : 0) + q0;  // position of the tile's row 0
  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + kh * ks.h;
  const bf16* vb = v + b * vs.b + kh * vs.h;

  // causal: up to the key of the tile's last row below Sq (with Sq = Sk
  // at offset 0, min(Sk, q0 + BQ) is the same bound)
  const int k_end = causal ? min(skl, p0 + (XQ ? min(BQ, sq_len - q0) : BQ))
                           : skl;
  // the first key tile holding a key that row q0 sees
  const int k_begin = WND ? max(0, p0 - window + 1) / BK * BK : 0;
  const int n_tiles = (k_end - k_begin + BK - 1) / BK;

  // prologue: group t = k/v tile t of the walk (group 0 with the q tile)
  load_tile<HD, BQ>(sq, qb, qs.s, q0, sq_len, tid);
#pragma unroll
  for (int t = 0; t < STAGES; ++t) {
    if (t < n_tiles) {
      const int kt = k_begin + t * BK;
      load_tile<HD, BK>(sk + t * BK * HD * 2, kb, ks.s, kt, skl, tid);
      load_tile<HD, BK>(sv + t * BK * HD * 2, vb, vs.s, kt, skl, tid);
    }
    cp_commit();
  }

  const int wrow = warp * 16;                       // the warp's first row
  const int qrow0 = p0 + wrow + (lane >> 2);  // positions of c0,c1 / c2,c3
  const int qrow1 = qrow0 + 8;
  const uint32_t q_addr = smem_u32(sq);

  uint32_t qf[KS][4];                 // unused (and dropped) for hd 256
  float m[2] = {-1e30f, -1e30f};      // running max, log2 domain
  float l[2] = {0.f, 0.f};            // this lane's share of the row sum
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    // PHASE wait
    cp_wait<STAGES - 1>();            // tile j's group has landed
    __syncthreads();
    const int k0 = k_begin + j * BK;
    const int st = j % STAGES;
    const uint32_t k_addr = smem_u32(sk + st * BK * HD * 2);
    const uint32_t v_addr = smem_u32(sv + st * BK * HD * 2);
    if (Q_REGS && j == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        ldsm_x4(q_addr + swz<HD>(wrow + (lane & 15), 2 * kk + (lane >> 4)),
                qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3]);
    }

    // PHASE qk
    // S = Q K^T for this warp's 16 rows and the tile's 64 keys
    float sc[NN][4];
#pragma unroll
    for (int n = 0; n < NN; ++n)
      sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[4];
      if (Q_REGS) {
        a[0] = qf[kk][0];
        a[1] = qf[kk][1];
        a[2] = qf[kk][2];
        a[3] = qf[kk][3];
      } else {
        ldsm_x4(q_addr + swz<HD>(wrow + (lane & 15), 2 * kk + (lane >> 4)),
                a[0], a[1], a[2], a[3]);
      }
#pragma unroll
      for (int n2 = 0; n2 < NN / 2; ++n2) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4(k_addr + swz<HD>(n2 * 16 + (lane & 7) + ((lane >> 4) << 3),
                                 2 * kk + ((lane >> 3) & 1)),
                b0, b1, b2, b3);
        mma(sc[2 * n2], a, b0, b1);
        mma(sc[2 * n2 + 1], a, b2, b3);
      }
    }

    // PHASE softmax
    // online softmax on the C fragments: element e of n-tile n is row
    // (e < 2 ? qrow0 : qrow1), key k0 + 8n + 2 (lane & 3) + (e & 1).
    // Only a tile that crosses the diagonal, the window's lower edge
    // (key p - window + 1 of the warp's last row, at position p) or the
    // ragged end of the keys takes the masked path; the branch is uniform
    // over the warp.
    if (k0 + BK > skl || (causal && k0 + BK - 1 > p0 + wrow) ||
        (WND && k0 <= p0 + wrow + 15 - window))
      softmax_tile<true, WND>(sc, m, l, acc, k0, skl, causal, window,
                              qrow0, qrow1, lane, scale_log2);
    else
      softmax_tile<false, WND>(sc, m, l, acc, k0, skl, causal, window,
                               qrow0, qrow1, lane, scale_log2);

    // PHASE pv
    // O += P V: P's C fragments repacked as bf16 A fragments
#pragma unroll
    for (int t = 0; t < BK / 16; ++t) {
      const uint32_t a[4] = {pack_bf16(sc[2 * t][0], sc[2 * t][1]),
                             pack_bf16(sc[2 * t][2], sc[2 * t][3]),
                             pack_bf16(sc[2 * t + 1][0], sc[2 * t + 1][1]),
                             pack_bf16(sc[2 * t + 1][2], sc[2 * t + 1][3])};
#pragma unroll
      for (int d2 = 0; d2 < ND / 2; ++d2) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4_t(v_addr + swz<HD>(t * 16 + (lane & 7) +
                                       (((lane >> 3) & 1) << 3),
                                   2 * d2 + (lane >> 4)),
                  b0, b1, b2, b3);
        mma(acc[2 * d2], a, b0, b1);
        mma(acc[2 * d2 + 1], a, b2, b3);
      }
    }

    // PHASE next_loads
    __syncthreads();                  // every warp is done with stage st
    if (j + STAGES < n_tiles) {
      const int k1 = k0 + STAGES * BK;
      load_tile<HD, BK>(sk + st * BK * HD * 2, kb, ks.s, k1, skl, tid);
      load_tile<HD, BK>(sv + st * BK * HD * 2, vb, vs.s, k1, skl, tid);
    }
    cp_commit();                      // possibly empty: keeps the count
    // PHASE end
  }
  cp_wait<0>();

  // normalise; stage the bf16 tile in the warp's own q rows, store it
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
  const int r0 = wrow + (lane >> 2);
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    *reinterpret_cast<uint32_t*>(sq + swz<HD>(r0, n) + (lane & 3) * 4) =
        pack_bf16(acc[n][0] * inv[0], acc[n][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(sq + swz<HD>(r0 + 8, n) + (lane & 3) * 4) =
        pack_bf16(acc[n][2] * inv[1], acc[n][3] * inv[1]);
  }
  __syncwarp();
  bf16* ob = out + b * os.b + h * os.h;
#pragma unroll
  for (int i = lane; i < 16 * KC; i += 32) {
    const int r = wrow + i / KC, c = i % KC;
    const int pos = q0 + r;
    if (pos < sq_len)
      *reinterpret_cast<uint4*>(ob + pos * os.s + c * 8) =
          *reinterpret_cast<const uint4*>(sq + swz<HD>(r, c));
  }
}

template <int HD, bool WND, bool XQ>
int launch(const void* q, const void* k, const void* v, void* out,
           Strides qs, Strides ks, Strides vs, Strides os, int b, int hq,
           int hkv, int sq, int sk, int q_offset, float scale, int causal,
           int window, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<HD>();
  static bool configured = false;    // the attribute is per function
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_bf16_kernel<HD, WND, XQ>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  dim3 grid(b * hq, (sq + BQ - 1) / BQ);
  flash_attention_bf16_kernel<HD, WND, XQ><<<grid, NT, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), qs, ks, vs, os,
      hq, hkv, sq, sk, q_offset, scale * 1.4426950408889634f, causal,
      window);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_w(const void* q, const void* k, const void* v, void* out,
             Strides qs, Strides ks, Strides vs, Strides os, int b, int hq,
             int hkv, int sq, int sk, int q_offset, float scale, int causal,
             int window, cudaStream_t stream) {
  auto go = [&](auto wnd, auto xq) {
    return launch<HD, decltype(wnd)::value, decltype(xq)::value>(
        q, k, v, out, qs, ks, vs, os, b, hq, hkv, sq, sk, q_offset, scale,
        causal, window, stream);
  };
  using T = std::true_type;
  using F = std::false_type;
  if (sq != sk || q_offset != 0)
    return window ? go(T{}, T{}) : go(F{}, T{});
  return window ? go(T{}, F{}) : go(F{}, F{});
}

int launch_hd(int hd, const void* q, const void* k, const void* v,
              void* out, Strides qs, Strides ks, Strides vs, Strides os,
              int b, int hq, int hkv, int sq, int sk, int q_offset,
              float scale, int causal, int window, cudaStream_t stream) {
  switch (hd) {
    case 64:
      return launch_w<64>(q, k, v, out, qs, ks, vs, os, b, hq, hkv, sq, sk,
                          q_offset, scale, causal, window, stream);
    case 128:
      return launch_w<128>(q, k, v, out, qs, ks, vs, os, b, hq, hkv, sq, sk,
                           q_offset, scale, causal, window, stream);
    case 256:
      return launch_w<256>(q, k, v, out, qs, ks, vs, os, b, hq, hkv, sq, sk,
                           q_offset, scale, causal, window, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace tc

}  // namespace

// strides: 12 element strides, (batch, head, sequence) for q, k, v, out
// in that order.  sq query rows at positions q_offset .. q_offset + sq - 1
// over sk keys.  window: 0 = none, else 1 <= W <= q_offset + sq (key j
// visible to the query at position p only if j > p - W).  bf16: 1 = all
// four tensors bfloat16 (the tensor-core kernel; every stride a multiple
// of 8 and every base 16-byte aligned), 0 = float32 (the FMA kernel).
// Returns a CUDA error code (0 = none); hd outside {64, 128, 256}, sk < 1,
// q_offset < 0, a window outside [0, q_offset + sq], or a query row
// with no visible key (a window whose last row starts at or past key sk)
// is cudaErrorInvalidValue.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out,
    const long long* strides, int b, int hq, int hkv, int sq, int sk,
    int q_offset, int hd, float scale, int causal, int window, int bf16,
    void* stream) {
  if (b == 0 || sq == 0) return 0;
  if (sk < 1 || q_offset < 0 || window < 0 || window > q_offset + sq ||
      (window > 0 && q_offset + sq - window >= sk))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{strides[0], strides[1], strides[2]};
  const Strides ks{strides[3], strides[4], strides[5]};
  const Strides vs{strides[6], strides[7], strides[8]};
  const Strides os{strides[9], strides[10], strides[11]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return tc::launch_hd(hd, q, k, v, out, qs, ks, vs, os, b, hq, hkv, sq,
                         sk, q_offset, scale, causal, window, st);
  return launch_hd<float>(hd, q, k, v, out, qs, ks, vs, os, b, hq, hkv, sq,
                          sk, q_offset, scale, causal, window, st);
}
