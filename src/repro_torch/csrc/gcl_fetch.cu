// Fetch-on-grant: latch verdict, reader-bit merge and payload gather in
// one launch (the paper's combined latch+read round trip).
//
// Replaces the TPU kernel src/repro/kernels/gcl_fetch/gcl_fetch.py:56
// (gcl_fetch, the pallas_call at line 63), reached through
// kernels/gcl_fetch/ops.py:fetch; the wrapper is
// src/repro_torch/kernels/gcl_fetch.py:fetch.
//
// What it computes, per request r naming a page (-1 or a page at or
// past n_pages = empty slot): payload[r] = pages[page] (zeros for an
// empty slot), the old word lanes, granted = (writer byte of the old hi
// lane == 0), and new_words[p] = words[p] | the reader bits of every
// request naming p, so duplicate requests OR their bits together.  The
// old lanes and granted are read from words, never from new_words.
//
// What bounds it on the H100: bytes, at both of the main path's shapes.
// A serving round asks for 32 rows of 64 KiB (16 tokens x 8 kv heads x
// 128 dims x 2 bytes for k and v): with 28 rows granted that is 3.75 MiB
// to move, 1.18 us at 3.35 TB/s; in the serve's own mix, where most
// rounds grant no row or one, a 2 MiB zero fill and one row, 0.65 us.
// Both are a few MiB, about what the card keeps in flight at once (at
// ~0.7 us of memory latency, 3.35 TB/s needs ~2 MB in flight, ~16 KiB
// an SM), so a call is one wave of loads and stores: its time is the
// launch, the request read, the row read that depends on it, and the
// stores draining.
//
// Design: one kernel of two kinds of block, against the four costs of
// the first port (a copy of the words before the kernel, 4 KiB in
// flight an SM, empty rows through the copy loop, a merge ordered after
// that copy).
// - One launch, one graph node.  Merge blocks, one per slice of WP
//   pages, come first in the grid.  Each loads its slice of words into
//   registers, ORs the bits of every request naming the slice into a
//   shared table (requests walked NT at a time straight from device
//   memory, page and bits loaded together: each is read once), and
//   writes words | table.  Every new_words lane has one writer and no
//   global atomic is used, and the replies read words, never new_words,
//   so nothing orders one block after another.
// - Bytes in flight.  Copy blocks, one per (request, chunk of NT x U
//   16-byte vectors of its row), issue all U loads of a thread before
//   any store.  U = 2 gives a 32-row round of 64 KiB rows 512 blocks,
//   about four an SM, so the whole round is in flight at once (1, 4
//   and 8 timed within noise of 2 at the dense and the serve's shape).
// - Empty rows.  A block's row is valid or empty as a whole, so it
//   branches once; an empty chunk is U plain zero stores a thread, with
//   no load and no select.  The chunk-0 block of each request writes
//   its old lanes and verdict.
// Rows whose size or base is not a multiple of 16 bytes take the same
// tiles byte by byte.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 128;              // threads a block
constexpr int U = 2;                 // 16-byte vectors a copy thread moves
constexpr int WP = 1024;             // pages a merge block owns
constexpr int LANES = 2 * WP / NT;   // word lanes a merge thread holds

struct FetchArgs {
  const char* pages;
  long long row_bytes;
  int n_pages;
  const int32_t* words;
  int32_t* new_words;
  const int32_t* req_page;
  const int32_t* bit_hi;
  const int32_t* bit_lo;
  char* payload;
  int32_t* old_hi;
  int32_t* old_lo;
  int32_t* granted;
  int r;
};

// new_words of pages [b * WP, (b + 1) * WP): words | the OR of the bits
// of every request naming the page
__device__ __forceinline__ void merge_words(const FetchArgs& a, int b) {
  __shared__ int32_t s_or[2 * WP];
  const int tid = threadIdx.x;
  const int p0 = b * WP;
  const int np = min(WP, a.n_pages - p0);             // pages of the slice
  const int n = 2 * np;                                // lanes of the slice
  const int32_t* w = a.words + 2LL * p0;
  int32_t held[LANES];                                 // loads in flight
#pragma unroll
  for (int k = 0; k < LANES; ++k) {
    const int i = tid + k * NT;
    held[k] = i < n ? w[i] : 0;
  }
  for (int i = tid; i < n; i += NT) s_or[i] = 0;
  __syncthreads();
  for (int i = tid; i < a.r; i += NT) {                // NT requests a pass
    const int page = a.req_page[i];                    // all three loads
    const int32_t hi = a.bit_hi[i], lo = a.bit_lo[i];  // in flight at once
    if (page >= p0 && page - p0 < np) {                // no overflow
      atomicOr(&s_or[2 * (page - p0)], hi);
      atomicOr(&s_or[2 * (page - p0) + 1], lo);
    }
  }
  __syncthreads();
  int32_t* nw = a.new_words + 2LL * p0;
#pragma unroll
  for (int k = 0; k < LANES; ++k) {
    const int i = tid + k * NT;
    if (i < n) nw[i] = held[k] | s_or[i];
  }
}

// request r's old lanes and verdict, from words (the pre-merge state)
__device__ __forceinline__ void write_reply(const FetchArgs& a, int r,
                                            int page, bool valid) {
  int32_t hi = 0, lo = 0;
  if (valid) {
    hi = a.words[2LL * page];
    lo = a.words[2LL * page + 1];
  }
  a.old_hi[r] = hi;
  a.old_lo[r] = lo;
  a.granted[r] = valid && (static_cast<uint32_t>(hi) & 0xFF000000u) == 0u;
}

// chunk c of request r's row: U 16-byte vectors a thread, all loads
// issued before the first store
__device__ __forceinline__ void copy_vectors(const FetchArgs& a, int r,
                                             int c, int page, bool valid) {
  const long long n_vec = a.row_bytes / 16;
  const long long v0 = static_cast<long long>(c) * NT * U + threadIdx.x;
  uint4* d = reinterpret_cast<uint4*>(a.payload + r * a.row_bytes);
  if (valid) {
    const uint4* s = reinterpret_cast<const uint4*>(a.pages +
                                                    page * a.row_bytes);
    uint4 x[U];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const long long v = v0 + k * NT;
      if (v < n_vec) x[k] = s[v];
    }
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const long long v = v0 + k * NT;
      if (v < n_vec) d[v] = x[k];
    }
  } else {
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const long long v = v0 + k * NT;
      if (v < n_vec) d[v] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// the same chunk byte by byte, for rows not aligned to 16 bytes
__device__ __forceinline__ void copy_bytes(const FetchArgs& a, int r, int c,
                                           int page, bool valid) {
  const long long chunk = static_cast<long long>(NT) * U * 16;
  const long long end = min(a.row_bytes, (c + 1) * chunk);
  char* d = a.payload + r * a.row_bytes;
  if (valid) {
    const char* s = a.pages + page * a.row_bytes;
    for (long long b = c * chunk + threadIdx.x; b < end; b += NT) d[b] = s[b];
  } else {
    for (long long b = c * chunk + threadIdx.x; b < end; b += NT) d[b] = 0;
  }
}

__global__ void __launch_bounds__(NT) gcl_fetch_kernel(FetchArgs a,
                                                       int n_merge,
                                                       int chunks,
                                                       int vec16) {
  if (static_cast<int>(blockIdx.x) < n_merge) {
    merge_words(a, blockIdx.x);
    return;
  }
  const int t = blockIdx.x - n_merge;
  const int r = t / chunks;
  const int c = t - r * chunks;
  const int page = a.req_page[r];
  const bool valid = page >= 0 && page < a.n_pages;
  if (c == 0 && threadIdx.x == 0) write_reply(a, r, page, valid);
  if (vec16) {
    copy_vectors(a, r, c, page, valid);
  } else {
    copy_bytes(a, r, c, page, valid);
  }
}

// blocks of the grid: merge blocks, then r x chunks copy blocks
struct Grid {
  int n_merge, chunks, blocks;
};

Grid fetch_grid(long long row_bytes, int n_pages, int r) {
  const long long chunk = static_cast<long long>(NT) * U * 16;
  Grid g;
  g.n_merge = n_pages > 0 ? (n_pages + WP - 1) / WP : 0;
  g.chunks = static_cast<int>(row_bytes > chunk ? (row_bytes + chunk - 1) /
                                                      chunk : 1);
  g.blocks = g.n_merge + (r > 0 ? r * g.chunks : 0);
  return g;
}

FetchArgs fetch_args(const void* pages, long long row_bytes, int n_pages,
                     const void* words, void* new_words,
                     const void* req_page, const void* bit_hi,
                     const void* bit_lo, void* payload, void* old_hi,
                     void* old_lo, void* granted, int r) {
  return FetchArgs{static_cast<const char*>(pages), row_bytes, n_pages,
                   static_cast<const int32_t*>(words),
                   static_cast<int32_t*>(new_words),
                   static_cast<const int32_t*>(req_page),
                   static_cast<const int32_t*>(bit_hi),
                   static_cast<const int32_t*>(bit_lo),
                   static_cast<char*>(payload),
                   static_cast<int32_t*>(old_hi),
                   static_cast<int32_t*>(old_lo),
                   static_cast<int32_t*>(granted), r};
}

}  // namespace

// One launch: new_words, the replies and the payload rows.  vec16 says
// rows and bases are 16-byte aligned.  Returns the launch's CUDA error
// (0 = none).
extern "C" int gcl_fetch_launch(
    const void* pages, long long row_bytes, int n_pages, const void* words,
    void* new_words, const void* req_page, const void* bit_hi,
    const void* bit_lo, void* payload, void* old_hi, void* old_lo,
    void* granted, int r, int vec16, void* stream) {
  const Grid g = fetch_grid(row_bytes, n_pages, r);
  if (g.blocks == 0) return 0;
  const FetchArgs a = fetch_args(pages, row_bytes, n_pages, words,
                                 new_words, req_page, bit_hi, bit_lo,
                                 payload, old_hi, old_lo, granted, r);
  gcl_fetch_kernel<<<g.blocks, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      a, g.n_merge, g.chunks, vec16);
  return static_cast<int>(cudaGetLastError());
}
