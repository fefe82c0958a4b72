// Batched latch-word CAS/FAA, applied in request order per word.
//
// Replaces the TPU kernel src/repro/kernels/latch_ops/latch_ops.py
// (latch_apply, the pallas_call at line 90), reached through
// kernels/latch_ops/ops.py:apply_batch; the wrapper is
// src/repro_torch/kernels/latch_ops.py:apply_batch.
//
// What it computes: words [N, 2] int32 hold 64-bit latch words as
// (hi, lo) lanes.  Request i names a line (-1 = empty slot), an op
// (0 = CAS on the whole 64-bit word, otherwise FAA, which carries lo
// into hi and wraps mod 2^64), a swap value or addend, and a compare
// value.  Each request gets the word as it was just before it (what an
// RDMA atomic returns) and ok = CAS hit (FAA: 1; empty slot: 0).
//
// What bounds it on the H100: not bytes or operations — a serving
// round sends ~32 requests at ~1024 words, a few KiB — but one launch
// and then the longest chain of same-line requests, which must apply
// one after another.  So a call is one kernel (no separate copy of the
// words), and everything a chain step reads is in shared memory.
//
// Design.  Each block owns a slice of LINES consecutive lines, like the
// TPU kernel's line blocks, and applies, in request order, every request
// whose line falls in the slice.  No two blocks touch one word or one
// reply, so there is no global atomic and no order between blocks.  A
// block reads device memory once before the chains: its slice of
// words_in, as 16-byte vectors (a scalar tail where the slice is odd),
// copied straight to words_out and kept in shared memory as uint64, and
// the first RT requests, coalesced, into shared memory.  A shared table
// then finds each line's first request (atomicMin of the request index),
// the lines that have one are listed, and one thread per listed line
// walks the line's chain from its first request, the word in a register.
// More than RT requests are staged and walked tile by tile, the word
// kept in shared memory between tiles.  Block 0 also writes the replies
// of empty slots and out-of-range lines (zeros, ok = 0), so every reply
// slot is written by exactly one block.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int LINES = 1024;          // lines a block owns
constexpr int RT = 1024;             // requests staged per tile
constexpr int NT = 256;              // threads per block

__device__ __forceinline__ uint64_t pack_word(int32_t hi, int32_t lo) {
  return (static_cast<uint64_t>(static_cast<uint32_t>(hi)) << 32) |
         static_cast<uint64_t>(static_cast<uint32_t>(lo));
}
__device__ __forceinline__ int32_t hi_of(uint64_t w) {
  return static_cast<int32_t>(static_cast<uint32_t>(w >> 32));
}
__device__ __forceinline__ int32_t lo_of(uint64_t w) {
  return static_cast<int32_t>(static_cast<uint32_t>(w));
}

// request tile t0 of at most RT into shared memory, coalesced
__device__ __forceinline__ void stage_requests(
    int t0, int tn, const int32_t* __restrict__ line,
    const int32_t* __restrict__ op, const int32_t* __restrict__ arg_hi,
    const int32_t* __restrict__ arg_lo, const int32_t* __restrict__ cmp_hi,
    const int32_t* __restrict__ cmp_lo, int* s_line, int* s_op,
    uint64_t* s_arg, uint64_t* s_cmp) {
  for (int i = threadIdx.x; i < tn; i += NT) {
    s_line[i] = line[t0 + i];
    s_op[i] = op[t0 + i];
    s_arg[i] = pack_word(arg_hi[t0 + i], arg_lo[t0 + i]);
    s_cmp[i] = pack_word(cmp_hi[t0 + i], cmp_lo[t0 + i]);
  }
}

__global__ void __launch_bounds__(NT) latch_apply_kernel(
    const int32_t* __restrict__ words_in, int32_t* __restrict__ words_out,
    int n_words, const int32_t* __restrict__ line,
    const int32_t* __restrict__ op, const int32_t* __restrict__ arg_hi,
    const int32_t* __restrict__ arg_lo, const int32_t* __restrict__ cmp_hi,
    const int32_t* __restrict__ cmp_lo, int32_t* __restrict__ old_hi,
    int32_t* __restrict__ old_lo, int32_t* __restrict__ ok, int r,
    int vec) {
  __shared__ uint64_t s_word[LINES];      // the slice's words
  __shared__ int s_first[LINES];          // first request on each line
  __shared__ int s_active[LINES];         // slice lines with a request
  __shared__ int s_line[RT], s_op[RT];    // one tile of requests
  __shared__ uint64_t s_arg[RT], s_cmp[RT];
  __shared__ int s_n_active;

  const int tid = threadIdx.x;
  const int l0 = blockIdx.x * LINES;
  const int nl = max(0, min(LINES, n_words - l0));   // lines of the slice

  // the one read of device memory before the chains: the slice's words,
  // copied to words_out as they were, and the first request tile
  const int32_t* src = words_in + 2LL * l0;
  int32_t* dst = words_out + 2LL * l0;
  if (vec) {                              // 16 bytes = two lines
    for (int i = tid; i < nl / 2; i += NT) {
      const int4 v = reinterpret_cast<const int4*>(src)[i];
      reinterpret_cast<int4*>(dst)[i] = v;
      s_word[2 * i] = pack_word(v.x, v.y);
      s_word[2 * i + 1] = pack_word(v.z, v.w);
    }
    if ((nl & 1) && tid == 0) {
      const int2 v = reinterpret_cast<const int2*>(src)[nl - 1];
      reinterpret_cast<int2*>(dst)[nl - 1] = v;
      s_word[nl - 1] = pack_word(v.x, v.y);
    }
  } else {
    for (int i = tid; i < nl; i += NT) {
      const int32_t hi = src[2 * i], lo = src[2 * i + 1];
      dst[2 * i] = hi;
      dst[2 * i + 1] = lo;
      s_word[i] = pack_word(hi, lo);
    }
  }
  stage_requests(0, min(RT, r), line, op, arg_hi, arg_lo, cmp_hi, cmp_lo,
                 s_line, s_op, s_arg, s_cmp);
  for (int i = tid; i < nl; i += NT) s_first[i] = INT_MAX;
  if (tid == 0) s_n_active = 0;
  __syncthreads();

  // first request of each line of the slice; empty slots' replies
  for (int i = tid; i < r; i += NT) {
    const int ln = i < RT ? s_line[i] : line[i];
    if (ln >= l0 && ln < l0 + nl) {
      atomicMin(&s_first[ln - l0], i);
    } else if (blockIdx.x == 0 && (ln < 0 || ln >= n_words)) {
      old_hi[i] = 0;
      old_lo[i] = 0;
      ok[i] = 0;
    }
  }
  __syncthreads();
  for (int i = tid; i < nl; i += NT)
    if (s_first[i] != INT_MAX) s_active[atomicAdd(&s_n_active, 1)] = i;
  __syncthreads();
  const int n_active = s_n_active;
  if (n_active == 0) return;

  for (int t0 = 0; t0 < r; t0 += RT) {
    const int tn = min(RT, r - t0);
    if (t0 > 0) {                         // the first tile is staged
      __syncthreads();                    // the last tile's walks are done
      stage_requests(t0, tn, line, op, arg_hi, arg_lo, cmp_hi, cmp_lo,
                     s_line, s_op, s_arg, s_cmp);
      __syncthreads();
    }
    for (int a = tid; a < n_active; a += NT) {
      const int li = s_active[a];
      const int ln = l0 + li;
      int j = max(s_first[li] - t0, 0);
      if (j >= tn) continue;
      uint64_t w = s_word[li];
      for (; j < tn; ++j) {               // the line's chain, in order
        if (s_line[j] != ln) continue;
        const int i = t0 + j;
        old_hi[i] = hi_of(w);
        old_lo[i] = lo_of(w);
        if (s_op[j] == 0) {
          const bool hit = w == s_cmp[j];
          if (hit) w = s_arg[j];
          ok[i] = hit ? 1 : 0;
        } else {
          w += s_arg[j];                  // 64-bit FAA, wraps like the NIC
          ok[i] = 1;
        }
      }
      s_word[li] = w;
    }
  }

  // each listed line's final word, over the copy written above (the
  // barriers since order the two writes)
  for (int a = tid; a < n_active; a += NT) {
    const int li = s_active[a];
    dst[2 * li] = hi_of(s_word[li]);
    dst[2 * li + 1] = lo_of(s_word[li]);
  }
}

}  // namespace

// words_out receives words_in with every request applied, in one
// kernel launch; returns the launch's CUDA error (0 = none).
extern "C" int latch_apply_launch(
    const void* words_in, void* words_out, int n_words, const void* line,
    const void* op, const void* arg_hi, const void* arg_lo,
    const void* cmp_hi, const void* cmp_lo, void* old_hi, void* old_lo,
    void* ok, int r, void* stream) {
  if (n_words <= 0 && r <= 0) return 0;
  const int blocks = n_words > 0 ? (n_words + LINES - 1) / LINES : 1;
  const int vec = ((reinterpret_cast<uintptr_t>(words_in) |
                    reinterpret_cast<uintptr_t>(words_out)) & 15) == 0;
  latch_apply_kernel<<<blocks, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(words_in), static_cast<int32_t*>(words_out),
      n_words, static_cast<const int32_t*>(line),
      static_cast<const int32_t*>(op), static_cast<const int32_t*>(arg_hi),
      static_cast<const int32_t*>(arg_lo),
      static_cast<const int32_t*>(cmp_hi),
      static_cast<const int32_t*>(cmp_lo), static_cast<int32_t*>(old_hi),
      static_cast<int32_t*>(old_lo), static_cast<int32_t*>(ok), r, vec);
  return static_cast<int>(cudaGetLastError());
}
