// One-token GQA decode attention through a page table, split across a
// thread-block cluster.
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
// its int32 payload lanes.  Only the table entries of the
// ceil(lens[b]/page) valid pages are read (entries past them may be
// -1); a page outside the pool is skipped.
//
// What bounds it on the H100: bytes.  Each k/v element of a valid
// token is read once (at most 16 MiB at the serving shapes with full
// 256-token windows: about 5 us at 3.35 TB/s); the arithmetic is 4
// flops per k/v element pair per query head, far below the card's
// rate.  With one block per (sequence, kv head) the serve's 128 blocks
// each walked 256 tokens through a chain of dependent loads (table
// entry, k row, reduction, v row), 2-byte loads at a time, and every
// warp of a GQA group read the same rows again; the kernel sat at 9x
// its bound, latency-bound.
//
// The design, against that latency:
// - One k/v row is read once for the whole GQA group.  A lane group of
//   LPR lanes loads a token's row as 16-byte vectors (16 lanes for bf16
//   at hd 128, 32 for fp32) and scores it against NH query heads held
//   in fp32 registers; the partial dot products reduce over those LPR
//   lanes only (log2 LPR shuffles a head).  Each lane group keeps TPG
//   tokens' k and v vectors in flight at once.  Groups of more than 8
//   heads split into chunks of 8, each chunk on its own lane groups.
// - The window is split across a cluster of CS blocks (CS chosen by
//   the wrapper, paged_attention.py:cluster_size; the serve's 128 (b,
//   kv head) pairs take 2 blocks each, the fastest of 1, 2, 4 and 8 at
//   its windows of 256 to 1024 tokens).  Each block takes a contiguous
//   slice of the valid pages and stages the slice's table entries in
//   shared memory once.  Lane groups merge their (max, sum,
//   acc) states in shared memory.  Each block owns a share of the
//   group's outputs; the blocks push their states of every output into
//   its owner's shared memory (cluster.map_shared_rank, remote stores
//   only), and after one cluster barrier each block merges its share
//   locally.  One launch, no scratch tensor: the launch count is one
//   per call.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;              // threads per block
constexpr int TPG = 4;               // tokens in flight per lane group
constexpr float NEG_INIT = -1e30f;

// q and out are fp32 or bf16 by a flag, not a template parameter: q is
// read once a block and out written once, so the branch costs nothing
// and the instantiations halve
__device__ __forceinline__ float load_q(const void* q, long long i,
                                        int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(q)[i])
              : static_cast<const float*>(q)[i];
}
__device__ __forceinline__ void store_out(void* out, long long i, float x,
                                          int bf16) {
  if (bf16)
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(x);
  else
    static_cast<float*>(out)[i] = x;
}

// one 16-byte vector as floats: 4 of fp32 or 8 of bf16
__device__ __forceinline__ void unpack(const uint4& u, float* f, float) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float* f,
                                       __nv_bfloat16) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// how a row of HD elements of type KT spreads over a lane group
template <typename KT, int HD>
struct Geo {
  static constexpr int VEC = 16 / sizeof(KT);   // elements per vector
  static constexpr int NV = HD / VEC;           // vectors per row
  static constexpr int LPR = NV < 32 ? NV : 32; // lanes per row
  static constexpr int VPL = NV / LPR;          // vectors per lane
  static constexpr int EPL = VPL * VEC;         // elements per lane
  static constexpr int NG = NT / LPR;           // lane groups per block
};

// dynamic shared memory: the lane groups' states, then the states
// pushed by the cluster's blocks for this block's share of the outputs
// (3 x cs x share floats), then the slice's table entries
template <typename KT, int HD, int NH>
__host__ __device__ constexpr int group_floats() {
  return Geo<KT, HD>::NG * NH * (2 + HD);
}
__host__ __device__ inline int share_of(int n_out, int cs) {
  return (n_out + cs - 1) / cs;
}

template <typename KT, int HD, int NH>
__global__ void __launch_bounds__(NT) paged_attention_kernel(
    const void* __restrict__ q, const KT* __restrict__ k,
    const KT* __restrict__ v, long long page_stride,
    const int32_t* __restrict__ page_tbl, const int32_t* __restrict__ lens,
    void* __restrict__ out, int hq, int hkv, int page, int max_pages,
    int n_pool, float scale, int q_bf16) {
  using Gm = Geo<KT, HD>;
  constexpr int LPR = Gm::LPR, VPL = Gm::VPL, EPL = Gm::EPL, NG = Gm::NG;
  constexpr int VEC = Gm::VEC;
  cg::cluster_group cluster = cg::this_cluster();
  // a block may write another's shared memory only once that block has
  // started: arrive now, wait just before the first remote store
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int group = hq / hkv;
  const int n_chunk = (group + NH - 1) / NH;   // head chunks of NH
  const int per_chunk = NG / n_chunk;          // lane groups per chunk
  const int grp = threadIdx.x / LPR;
  const int li = threadIdx.x % LPR;
  const int hc = grp % n_chunk;                // this group's head chunk
  const int sub = grp / n_chunk;               // its place in the chunk
  const bool active = sub < per_chunk;
  // the lane group's own lanes: two groups of one warp may run their
  // token loops a different number of times
  const unsigned gmask = (0xffffffffu >> (32 - LPR))
                         << ((threadIdx.x & 31) & ~(LPR - 1));

  const int n_out = group * HD;                // the group's outputs
  const int share = share_of(n_out, cs);       // outputs a block writes
  extern __shared__ __align__(16) float smem[];
  float* s_m = smem;                           // [NG][NH]
  float* s_l = s_m + NG * NH;                  // [NG][NH]
  float* s_acc = s_l + NG * NH;                // [NG][NH][HD]
  float* x_m = s_acc + NG * NH * HD;           // [cs][share]
  float* x_l = x_m + cs * share;               // [cs][share]
  float* x_acc = x_l + cs * share;             // [cs][share]
  int32_t* s_tbl = reinterpret_cast<int32_t*>(x_acc + cs * share);

  // this block's slice of the valid pages, its table entries staged
  int len = lens[b];
  len = len < 0 ? 0 : (len > max_pages * page ? max_pages * page : len);
  const int n_pg = (len + page - 1) / page;
  const int per_rank = (n_pg + cs - 1) / cs;
  const int pg0 = rank * per_rank;
  const int pg1 = min(n_pg, pg0 + per_rank);
  const int32_t* tbl = page_tbl + static_cast<long long>(b) * max_pages;
  for (int i = threadIdx.x; i < pg1 - pg0; i += NT) s_tbl[i] = tbl[pg0 + i];
  const int t0 = pg0 * page;
  const int t1 = min(len, pg1 * page);

  // the lane's dims: vector u of the lane covers (u * LPR + li) * VEC ..
  float qv[NH][EPL], acc[NH][EPL], m[NH], l[NH];
#pragma unroll
  for (int j = 0; j < NH; ++j) {
    const int hj = hc * NH + j;
    const long long qrow =
        (static_cast<long long>(b) * hq + kh * group + hj) * HD;
#pragma unroll
    for (int u = 0; u < VPL; ++u)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        qv[j][u * VEC + e] =
            hj < group ? load_q(q, qrow + (u * LPR + li) * VEC + e, q_bf16)
                       : 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[j][e] = 0.f;
    m[j] = NEG_INIT;
    l[j] = 0.f;
  }
  __syncthreads();                             // s_tbl staged

  const long long tok_stride = static_cast<long long>(hkv) * HD;
  const long long head_off = static_cast<long long>(kh) * HD;
  for (int base = t0 + sub * TPG; active && base < t1;
       base += per_chunk * TPG) {
    uint4 kr[TPG][VPL], vr[TPG][VPL];
    bool ok[TPG];
#pragma unroll
    for (int c = 0; c < TPG; ++c) {
      const int t = base + c;
      ok[c] = false;
      long long off = 0;
      if (t < t1) {
        const int pg = s_tbl[t / page - pg0];
        ok[c] = pg >= 0 && pg < n_pool;
        off = static_cast<long long>(pg) * page_stride +
              (t % page) * tok_stride + head_off;
      }
#pragma unroll
      for (int u = 0; u < VPL; ++u) {
        kr[c][u] = vr[c][u] = make_uint4(0u, 0u, 0u, 0u);
        if (ok[c]) {
          const long long o = off + (u * LPR + li) * VEC;
          kr[c][u] = *reinterpret_cast<const uint4*>(k + o);
          vr[c][u] = *reinterpret_cast<const uint4*>(v + o);
        }
      }
    }
    float sc[TPG][NH];
#pragma unroll
    for (int c = 0; c < TPG; ++c) {
      float kf[EPL];
#pragma unroll
      for (int u = 0; u < VPL; ++u) unpack(kr[c][u], kf + u * VEC, KT());
#pragma unroll
      for (int j = 0; j < NH; ++j) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) part += qv[j][e] * kf[e];
#pragma unroll
        for (int o = LPR / 2; o > 0; o >>= 1)
          part += __shfl_xor_sync(gmask, part, o);
        sc[c][j] = part * scale;
      }
    }
#pragma unroll
    for (int j = 0; j < NH; ++j) {
      float m_new = m[j];
#pragma unroll
      for (int c = 0; c < TPG; ++c)
        if (ok[c]) m_new = fmaxf(m_new, sc[c][j]);
      const float corr = expf(m[j] - m_new);
      l[j] *= corr;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[j][e] *= corr;
#pragma unroll
      for (int c = 0; c < TPG; ++c) {
        // select, never compute, a skipped token's probability
        sc[c][j] = ok[c] ? expf(sc[c][j] - m_new) : 0.f;
        l[j] += sc[c][j];
      }
      m[j] = m_new;
    }
#pragma unroll
    for (int c = 0; c < TPG; ++c) {
      float vf[EPL];
#pragma unroll
      for (int u = 0; u < VPL; ++u) unpack(vr[c][u], vf + u * VEC, KT());
#pragma unroll
      for (int j = 0; j < NH; ++j)
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[j][e] += sc[c][j] * vf[e];
    }
  }

  // merge the lane groups of each head: rescale to the largest max, sum
#pragma unroll
  for (int j = 0; j < NH; ++j) {
    if (li == 0) {
      s_m[grp * NH + j] = m[j];
      s_l[grp * NH + j] = l[j];
    }
#pragma unroll
    for (int u = 0; u < VPL; ++u)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        s_acc[(grp * NH + j) * HD + (u * LPR + li) * VEC + e] =
            acc[j][u * VEC + e];
  }
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  // ... and push the block's state of output i to the block that owns
  // it (rank i / share), into that block's row `rank`: remote stores
  // only, so one cluster barrier suffices
  for (int i = threadIdx.x; i < n_out; i += NT) {
    const int hj = i / HD, d = i % HD;
    const int ch = hj / NH, j = hj % NH;
    float mx = NEG_INIT;
    for (int sb = 0; sb < per_chunk; ++sb)
      mx = fmaxf(mx, s_m[(sb * n_chunk + ch) * NH + j]);
    float tot = 0.f, a = 0.f;
    for (int sb = 0; sb < per_chunk; ++sb) {
      const int w = (sb * n_chunk + ch) * NH + j;
      const float f = expf(s_m[w] - mx);
      tot += s_l[w] * f;
      a += s_acc[w * HD + d] * f;
    }
    const int owner = i / share;
    const int at = rank * share + (i - owner * share);
    cluster.map_shared_rank(x_m, owner)[at] = mx;
    cluster.map_shared_rank(x_l, owner)[at] = tot;
    cluster.map_shared_rank(x_acc, owner)[at] = a;
  }
  cluster.sync();                  // every block's pushes have landed

  // merge the cluster's states of this block's outputs, all local
  const long long orow = (static_cast<long long>(b) * hq + kh * group) * HD;
  for (int li = threadIdx.x; li < share && rank * share + li < n_out;
       li += NT) {
    float mx = NEG_INIT;
    for (int r = 0; r < cs; ++r) mx = fmaxf(mx, x_m[r * share + li]);
    float tot = 0.f, a = 0.f;
    for (int r = 0; r < cs; ++r) {
      const float f = expf(x_m[r * share + li] - mx);
      tot += x_l[r * share + li] * f;
      a += x_acc[r * share + li] * f;
    }
    // lens == 0: every state is (-1e30, 0, 0) and the output 0 / 1e-30
    store_out(out, orow + rank * share + li, a / fmaxf(tot, 1e-30f), q_bf16);
  }
}

template <typename KT, int HD, int NH>
int launch_nh(const void* q, const void* k, const void* v,
              long long page_stride, const void* tbl, const void* lens,
              void* out, int b, int hq, int hkv, int page, int max_pages,
              int n_pool, float scale, int q_bf16, int cs, cudaStream_t s) {
  const int group = hq / hkv;
  const int per_rank_pages = (max_pages + cs - 1) / cs;
  const int bytes = (group_floats<KT, HD, NH>() +
                     3 * cs * share_of(group * HD, cs) + per_rank_pages) *
                    4;
  auto kernel = paged_attention_kernel<KT, HD, NH>;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, hkv, b);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, q, static_cast<const KT*>(k),
      static_cast<const KT*>(v), page_stride,
      static_cast<const int32_t*>(tbl), static_cast<const int32_t*>(lens),
      out, hq, hkv, page, max_pages, n_pool, scale, q_bf16);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename KT, int HD>
int launch_hd(const void* q, const void* k, const void* v,
              long long page_stride, const void* tbl, const void* lens,
              void* out, int b, int hq, int hkv, int page, int max_pages,
              int n_pool, float scale, int q_bf16, int cs, cudaStream_t s) {
  const int group = hq / hkv;
#define REPRO_PA_LAUNCH(NH)                                                  \
  return launch_nh<KT, HD, NH>(q, k, v, page_stride, tbl, lens, out, b, hq, \
                               hkv, page, max_pages, n_pool, scale, q_bf16,  \
                               cs, s)
  if (group <= 1) REPRO_PA_LAUNCH(1);
  if (group <= 2) REPRO_PA_LAUNCH(2);
  if (group <= 4) REPRO_PA_LAUNCH(4);
  REPRO_PA_LAUNCH(8);
#undef REPRO_PA_LAUNCH
}

template <typename KT>
int launch_typed(const void* q, const void* k, const void* v,
                 long long page_stride, const void* tbl, const void* lens,
                 void* out, int b, int hq, int hkv, int hd, int page,
                 int max_pages, int n_pool, float scale, int q_bf16, int cs,
                 cudaStream_t s) {
  switch (hd) {
    case 64:
      return launch_hd<KT, 64>(q, k, v, page_stride, tbl, lens, out, b, hq,
                               hkv, page, max_pages, n_pool, scale, q_bf16,
                               cs, s);
    case 128:
      return launch_hd<KT, 128>(q, k, v, page_stride, tbl, lens, out, b, hq,
                                hkv, page, max_pages, n_pool, scale, q_bf16,
                                cs, s);
    case 256:
      return launch_hd<KT, 256>(q, k, v, page_stride, tbl, lens, out, b, hq,
                                hkv, page, max_pages, n_pool, scale, q_bf16,
                                cs, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q_bf16 / kv_bf16: 1 = bfloat16, 0 = float32.  cluster: blocks per
// (sequence, kv head), chosen by the wrapper (paged_attention.py:
// cluster_size); more than the card's portable 8 fails at launch.  k, v
// and the page stride must keep every row 16-byte aligned.  Returns a
// CUDA error code (0 = none); hd outside {64, 128, 256} or a cluster
// under 1 is cudaErrorInvalidValue.
extern "C" int paged_attention_launch(
    const void* q, const void* k, const void* v, long long page_stride,
    const void* tbl, const void* lens, void* out, int b, int hq, int hkv,
    int hd, int page, int max_pages, int n_pool, float scale, int q_bf16,
    int kv_bf16, int cluster, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b == 0) return 0;
  if (cluster < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (kv_bf16)
    return launch_typed<__nv_bfloat16>(q, k, v, page_stride, tbl, lens, out,
                                       b, hq, hkv, hd, page, max_pages,
                                       n_pool, scale, q_bf16, cluster, s);
  return launch_typed<float>(q, k, v, page_stride, tbl, lens, out, b, hq,
                             hkv, hd, page, max_pages, n_pool, scale, q_bf16,
                             cluster, s);
}
