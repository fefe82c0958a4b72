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
// round sends ~32 requests at ~1024 words, a few KiB, so the kernel is
// bound by its launch and by the serial chain of same-line requests.
// The TPU ran its grid in order and looped over requests one by one;
// Hopper runs threads in parallel, and its hardware atomics keep no
// request order, so order is kept explicitly: thread i owns request i
// only when no earlier request names the same line, and then walks
// every request on that line in request order, holding the word in a
// register as uint64.  Distinct lines proceed in parallel; no two
// threads ever touch one word, so no atomics are needed.  One block
// suffices at the request counts of the serving path (R is at most
// prefill_chunk + n_slots there); the words that no request names are
// copied to the output by cudaMemcpyAsync on the same stream first.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint64_t pack_word(int32_t hi, int32_t lo) {
  return (static_cast<uint64_t>(static_cast<uint32_t>(hi)) << 32) |
         static_cast<uint64_t>(static_cast<uint32_t>(lo));
}

__global__ void latch_apply_kernel(
    int32_t* __restrict__ words, int n_words,
    const int32_t* __restrict__ line, const int32_t* __restrict__ op,
    const int32_t* __restrict__ arg_hi, const int32_t* __restrict__ arg_lo,
    const int32_t* __restrict__ cmp_hi, const int32_t* __restrict__ cmp_lo,
    int32_t* __restrict__ old_hi, int32_t* __restrict__ old_lo,
    int32_t* __restrict__ ok, int r) {
  for (int i = threadIdx.x; i < r; i += blockDim.x) {
    const int ln = line[i];
    if (ln < 0 || ln >= n_words) {        // empty slot: zeros, not ok
      old_hi[i] = 0;
      old_lo[i] = 0;
      ok[i] = 0;
      continue;
    }
    bool owner = true;                    // first request on this line?
    for (int j = 0; j < i; ++j) {
      if (line[j] == ln) {
        owner = false;
        break;
      }
    }
    if (!owner) continue;
    uint64_t w = pack_word(words[2 * ln], words[2 * ln + 1]);
    for (int j = i; j < r; ++j) {         // the line's chain, in order
      if (line[j] != ln) continue;
      old_hi[j] = static_cast<int32_t>(static_cast<uint32_t>(w >> 32));
      old_lo[j] = static_cast<int32_t>(static_cast<uint32_t>(w));
      const uint64_t arg = pack_word(arg_hi[j], arg_lo[j]);
      if (op[j] == 0) {
        const bool hit = w == pack_word(cmp_hi[j], cmp_lo[j]);
        if (hit) w = arg;
        ok[j] = hit ? 1 : 0;
      } else {
        w += arg;                         // 64-bit FAA, wraps like the NIC
        ok[j] = 1;
      }
    }
    words[2 * ln] = static_cast<int32_t>(static_cast<uint32_t>(w >> 32));
    words[2 * ln + 1] = static_cast<int32_t>(static_cast<uint32_t>(w));
  }
}

}  // namespace

// words_out receives words_in with every request applied; returns the
// CUDA error of the copy or the launch (0 = none).
extern "C" int latch_apply_launch(
    const void* words_in, void* words_out, int n_words, const void* line,
    const void* op, const void* arg_hi, const void* arg_lo,
    const void* cmp_hi, const void* cmp_lo, void* old_hi, void* old_lo,
    void* ok, int r, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemcpyAsync(
      words_out, words_in, sizeof(int32_t) * 2 * static_cast<size_t>(n_words),
      cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (r > 0) {
    int threads = ((r + 31) / 32) * 32;
    if (threads > 1024) threads = 1024;
    latch_apply_kernel<<<1, threads, 0, s>>>(
        static_cast<int32_t*>(words_out), n_words,
        static_cast<const int32_t*>(line), static_cast<const int32_t*>(op),
        static_cast<const int32_t*>(arg_hi),
        static_cast<const int32_t*>(arg_lo),
        static_cast<const int32_t*>(cmp_hi),
        static_cast<const int32_t*>(cmp_lo), static_cast<int32_t*>(old_hi),
        static_cast<int32_t*>(old_lo), static_cast<int32_t*>(ok), r);
  }
  return static_cast<int>(cudaGetLastError());
}
