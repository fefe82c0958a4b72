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
// Design: one block of 256 threads owns a tile of 16 keys of one chunk
// and a group of HPB = 8 heads, and walks its heads in order; for each
// head it walks the query rows at or below its keys in steps of 32.  It
// owns dWin and dcs of its 16 keys and heads, and sums the [Q, 16] column
// strip of dCB over its heads in shared memory, in head order.  The
// strips of a key tile's head groups are summed by the last of its
// blocks to finish (an atomic counter per key tile, after a memory
// fence), in group order, whichever block that is: no atomics touch a
// value, and every sum is the same from run to run.  A step computes G
// for 32 x 16 (query, key) pairs (one thread two pairs, P FMAs each),
// stages CB o L and dS in shared memory, and adds them into the 16 x P
// dWin accumulators (P / 16 a thread) and the key's column sum of dS.
// The [Q, 16] strips of CB and of dCB stay in shared memory for the
// whole walk.  Rows are padded to odd strides, so the reads are free of
// bank conflicts.  (A first version walked all 80 heads in one block,
// 128 blocks at the Mamba2 shape: 2.79 ms, latency-bound.)
//
// What bounds it on the H100: operations.  At the Mamba2-2.7B training
// shape (8 chunks of Q 256, 80 heads, P 64) the triangle is 2 products of
// 2 P operations per (q, k, h) pair, 5.4 GFLOP, 81 us at the fp32 peak
// of 67 TFLOP/s; its bytes (CB, cs, Win, Y, dY in; dCB, dcs, dWin out)
// are 173 MB, 52 us.  The grid is 16 key tiles x 8 chunks x 10 head
// groups, 1280 blocks; the key tiles near the diagonal have the fewest
// rows, so their blocks finish first.  Left for later: tensor cores
// (3xTF32 as the forward), and a ring that loads the next dY tile while
// a step computes.

#include <cuda_runtime.h>

namespace {

constexpr int KT = 16;               // keys a block
constexpr int QT = 32;               // query rows a step
constexpr int NT = 256;
constexpr int MAX_Q = 256;
constexpr int KS = KT + 1;           // padded rows of the key-wide tiles
constexpr int HPB = 8;               // heads a block

template <int P>
constexpr int smem_floats(int nq) {
  return 2 * nq * KS + nq + KT * (P + 1) + QT * (P + 1) + 2 * QT * KS;
}

template <int P>
__global__ void __launch_bounds__(NT) ssd_intra_bwd_kernel(
    const float* __restrict__ cb, const float* __restrict__ cs,
    const float* __restrict__ win, const float* __restrict__ y,
    const float* __restrict__ dy, float* __restrict__ dcb,
    float* __restrict__ dcs, float* __restrict__ dwin,
    float* __restrict__ part, int* __restrict__ done, int q, int h) {
  constexpr int PS = P + 1;
  constexpr int EP = P / 16;         // dWin columns a thread
  extern __shared__ float sm[];
  const int c = blockIdx.y;
  const int k0 = blockIdx.x * KT;
  const int groups = gridDim.z;      // head groups of a key tile
  const int h_begin = blockIdx.z * HPB;
  const int h_end = min(h, h_begin + HPB);
  const int nq = q - k0;             // rows k0 .. q-1 see these keys
  float* s_cb = sm;                  // [nq][KS] CB[k0 + r, k0 + j]
  float* s_dcb = s_cb + nq * KS;     // [nq][KS] dCB, summed over heads
  float* s_cs = s_dcb + nq * KS;     // [nq]     cs[k0 + r, head]
  float* s_w = s_cs + nq;            // [KT][PS] Win[k0 + j, head, :]
  float* s_dy = s_w + KT * PS;       // [QT][PS] dY rows of a step
  float* s_cl = s_dy + QT * PS;      // [QT][KS] CB o L
  float* s_ds = s_cl + QT * KS;      // [QT][KS] CB o L o G

  const int tid = threadIdx.x;
  const int j = tid & 15;            // key of the G pairs; dWin column
  const int rr = tid >> 4;           // row of the G pairs; dWin key
  const long long cq = static_cast<long long>(c) * q;
  for (int i = tid; i < nq * KT; i += NT) {
    const int r = i / KT, jj = i % KT, key = k0 + jj;
    s_cb[r * KS + jj] = key < q ? cb[(cq + k0 + r) * q + key] : 0.f;
    s_dcb[r * KS + jj] = 0.f;
  }

  for (int hh = h_begin; hh < h_end; ++hh) {
    __syncthreads();                 // the last head's tiles are consumed
    for (int i = tid; i < nq; i += NT) s_cs[i] = cs[(cq + k0 + i) * h + hh];
    for (int i = tid; i < KT * P; i += NT) {
      const int jj = i / P, p = i % P, key = k0 + jj;
      s_w[jj * PS + p] = key < q ? win[((cq + key) * h + hh) * P + p] : 0.f;
    }
    float acc[EP];
#pragma unroll
    for (int e = 0; e < EP; ++e) acc[e] = 0.f;
    float col = 0.f;                 // partial column sum of dS, key rr

    for (int r0 = 0; r0 < nq; r0 += QT) {
      __syncthreads();               // staged / last step's tiles consumed
      for (int i = tid; i < QT * P; i += NT) {
        const int r = i / P, p = i % P, row = k0 + r0 + r;
        s_dy[r * PS + p] = row < q ? dy[((cq + row) * h + hh) * P + p] : 0.f;
      }
      __syncthreads();
      float g2[2] = {0.f, 0.f};      // G of rows rr and rr + 16, key j
#pragma unroll 8
      for (int p = 0; p < P; ++p) {
        const float w = s_w[j * PS + p];
        g2[0] += s_dy[rr * PS + p] * w;
        g2[1] += s_dy[(rr + 16) * PS + p] * w;
      }
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int r = rr + 16 * t;   // row of the step
        const int rel = r0 + r;      // row - k0
        const float g = g2[t];
        float cl = 0.f, ds = 0.f;
        if (rel < nq && rel >= j && k0 + j < q) {   // row >= key: select
          const float l = expf(s_cs[rel] - s_cs[j]);
          cl = s_cb[rel * KS + j] * l;
          ds = cl * g;
          s_dcb[rel * KS + j] += l * g;
        }
        s_cl[r * KS + j] = cl;
        s_ds[r * KS + j] = ds;
      }
      __syncthreads();
      for (int r = 0; r < QT; ++r) {
        const float cl = s_cl[r * KS + rr];
#pragma unroll
        for (int e = 0; e < EP; ++e) acc[e] += cl * s_dy[r * PS + j + 16 * e];
      }
      col += s_ds[j * KS + rr] + s_ds[(j + 16) * KS + rr];
    }

    // the head's dWin and dcs of key k0 + rr (16 threads a key)
    const int key = k0 + rr;
    float rp = 0.f;                  // sum_p dY . Y of row `key`
    if (key < q) {
      const long long base = ((cq + key) * h + hh) * P;
#pragma unroll
      for (int e = 0; e < EP; ++e)
        rp += dy[base + j + 16 * e] * y[base + j + 16 * e];
    }
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) {
      rp += __shfl_xor_sync(0xffffffffu, rp, o);
      col += __shfl_xor_sync(0xffffffffu, col, o);
    }
    if (key < q) {
      const long long base = ((cq + key) * h + hh) * P;
#pragma unroll
      for (int e = 0; e < EP; ++e) dwin[base + j + 16 * e] = acc[e];
      if (j == 0) dcs[(cq + key) * h + hh] = rp - col;
    }
  }
  // this group's dCB strip to the partials; the key tile's last block
  // to finish sums the groups' strips in group order
  const long long tile = static_cast<long long>(c) * gridDim.x + blockIdx.x;
  float* mine = part + (tile * groups + blockIdx.z) * (MAX_Q * KT);
  __syncthreads();
  for (int i = tid; i < nq * KT; i += NT)
    mine[i] = s_dcb[(i / KT) * KS + i % KT];
  __threadfence();
  __syncthreads();
  __shared__ int last;
  if (tid == 0) last = atomicAdd(done + tile, 1) == groups - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* all = part + tile * groups * (MAX_Q * KT);
  for (int i = tid; i < q * KT; i += NT) {
    const int row = i / KT, jj = i % KT, key = k0 + jj;
    if (key >= q) continue;
    float sum = 0.f;
    if (row >= k0)
      for (int gi = 0; gi < groups; ++gi)
        sum += __ldcg(all + gi * (MAX_Q * KT) + (row - k0) * KT + jj);
    dcb[(cq + row) * q + key] = sum;
  }
}

template <int P>
int launch(const float* cb, const float* cs, const float* win,
           const float* y, const float* dy, float* dcb, float* dcs,
           float* dwin, float* part, int* done, int bc, int q, int h,
           cudaStream_t stream) {
  const int bytes = smem_floats<P>(q) * 4;
  static bool configured = false;    // the attribute is per function
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_intra_bwd_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_floats<P>(MAX_Q) * 4);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  ssd_intra_bwd_kernel<P>
      <<<dim3((q + KT - 1) / KT, bc, (h + HPB - 1) / HPB), NT, bytes,
         stream>>>(cb, cs, win, y, dy, dcb, dcs, dwin, part, done, q, h);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// All tensors contiguous fp32: cb [bc, q, q], cs [bc, q, h], win, y, dy
// [bc, q, h, p] (y the forward's output, dy its gradient) in; dcb, dcs,
// dwin of the inputs' shapes out, every element written.  Scratch: part,
// bc * ceil(q / 16) * ceil(h / 8) * 256 * 16 floats (a dCB strip a
// block); done, bc * ceil(q / 16) ints, zero on entry.  Returns a CUDA
// error code (0 = none); q above 256 or p outside {16, 32, 64, 128} is
// cudaErrorInvalidValue.
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
