// Fetch-on-grant: latch verdict, reader-bit merge and payload gather in
// one pass (the paper's combined latch+read round trip).
//
// Replaces the TPU kernel src/repro/kernels/gcl_fetch/gcl_fetch.py
// (gcl_fetch, the pallas_call at line 63), reached through
// kernels/gcl_fetch/ops.py:fetch; the wrapper is
// src/repro_torch/kernels/gcl_fetch.py:fetch.
//
// What it computes, per request r naming a page (-1 = empty slot):
// payload[r] = pages[page] (zeros for an empty slot), the old word
// lanes, granted = (writer byte of the old hi lane == 0), and the
// requester's reader bits ORed into new_words[page].  new_words starts
// as a copy of words (cudaMemcpyAsync on the same stream) and the merge
// is an atomicOr, so duplicate requests for one page OR their bits
// together; the returned old lanes are always the pre-merge words.
//
// What bounds it on the H100: bytes.  Each request moves one payload
// row (64 KiB at the serving pool's defaults: 16 tokens x 8 heads x
// 128 dims x 2 bytes for k and v), read once and written once, so a
// 32-request round moves 4 MiB: about 1.3 us at 3.35 TB/s.  The TPU
// kernel walked one request per grid step.  Here each row is cut into
// chunks of CHUNK_VECS 16-byte vectors, one block per (request, chunk),
// so a serving round puts 128 blocks on the 132 SMs; neighbouring
// threads move neighbouring 16-byte vectors.  Rows whose size or base
// address is not a multiple of 16 bytes take a byte-wise path.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr long long CHUNK_VECS = THREADS * 4;   // 16 KiB per block

__global__ void gcl_fetch_kernel(
    const char* __restrict__ pages, long long row_bytes, int n_pages,
    const int32_t* __restrict__ words, int32_t* new_words,
    const int32_t* __restrict__ req_page,
    const int32_t* __restrict__ bit_hi, const int32_t* __restrict__ bit_lo,
    char* __restrict__ payload, int32_t* __restrict__ old_hi,
    int32_t* __restrict__ old_lo, int32_t* __restrict__ granted,
    int vec16) {
  const int r = blockIdx.x;
  const int page = req_page[r];
  const bool valid = page >= 0 && page < n_pages;
  if (blockIdx.y == 0 && threadIdx.x == 0) {
    if (valid) {
      const int32_t hi = words[2 * page];
      const int32_t lo = words[2 * page + 1];
      old_hi[r] = hi;
      old_lo[r] = lo;
      granted[r] = (static_cast<uint32_t>(hi) & 0xFF000000u) == 0u;
      atomicOr(&new_words[2 * page], bit_hi[r]);
      atomicOr(&new_words[2 * page + 1], bit_lo[r]);
    } else {
      old_hi[r] = 0;
      old_lo[r] = 0;
      granted[r] = 0;
    }
  }
  const char* src = pages + static_cast<long long>(valid ? page : 0) *
                                row_bytes;
  char* dst = payload + static_cast<long long>(r) * row_bytes;
  if (vec16) {
    const long long n_vec = row_bytes / 16;
    const long long end = min(n_vec, (blockIdx.y + 1) * CHUNK_VECS);
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    for (long long v = blockIdx.y * CHUNK_VECS + threadIdx.x; v < end;
         v += THREADS) {
      d[v] = valid ? s[v] : make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    const long long chunk = CHUNK_VECS * 16;
    const long long end = min(row_bytes, (blockIdx.y + 1) * chunk);
    for (long long b = blockIdx.y * chunk + threadIdx.x; b < end;
         b += THREADS) {
      dst[b] = valid ? src[b] : 0;
    }
  }
}

}  // namespace

extern "C" int gcl_fetch_launch(
    const void* pages, long long row_bytes, int n_pages, const void* words,
    void* new_words, const void* req_page, const void* bit_hi,
    const void* bit_lo, void* payload, void* old_hi, void* old_lo,
    void* granted, int r, int vec16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemcpyAsync(
      new_words, words, sizeof(int32_t) * 2 * static_cast<size_t>(n_pages),
      cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (r > 0) {
    const long long chunk_bytes = CHUNK_VECS * 16;
    long long chunks = (row_bytes + chunk_bytes - 1) / chunk_bytes;
    if (chunks < 1) chunks = 1;
    dim3 grid(r, static_cast<unsigned>(chunks));
    gcl_fetch_kernel<<<grid, THREADS, 0, s>>>(
        static_cast<const char*>(pages), row_bytes, n_pages,
        static_cast<const int32_t*>(words), static_cast<int32_t*>(new_words),
        static_cast<const int32_t*>(req_page),
        static_cast<const int32_t*>(bit_hi),
        static_cast<const int32_t*>(bit_lo), static_cast<char*>(payload),
        static_cast<int32_t*>(old_hi), static_cast<int32_t*>(old_lo),
        static_cast<int32_t*>(granted), vec16);
  }
  return static_cast<int>(cudaGetLastError());
}
