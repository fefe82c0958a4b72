// bf16 tensor-core primitives of K4's forward (flash_attention.cu):
// cp.async copies, ldmatrix fragment loads, one mma.sync.m16n8k16 (bf16
// in, fp32 sums), the bf16 pair packing that turns C fragments into A
// fragments (which the backward, flash_attention_bwd.cu, also uses, with
// the MUFU exp2 and the stride triple), and the XOR swizzle of 16-byte
// chunks in a [rows][HD] bf16 tile.
//
// Fragment layouts of m16n8k16 (row.col), lane = threadIdx.x % 32:
//   A 16x16: a0 row lane/4, cols 2(lane%4)+{0,1}; a1 row +8; a2 cols +8;
//            a3 row +8, cols +8.
//   B 16x8:  b0 k rows 2(lane%4)+{0,1}, col lane/4; b1 k rows +8.
//   C 16x8:  c0,c1 row lane/4, cols 2(lane%4)+{0,1}; c2,c3 row +8.
// So the C fragments of two adjacent 8-column tiles, packed pairwise to
// bf16, are the A fragment of a 16-deep product over those 16 columns.

#pragma once

#include <cstdint>
#include <cuda_bf16.h>

namespace mma_bf16 {

using bf16 = __nv_bfloat16;

struct Strides {
  long long b, h, s;
};

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

// ROWS rows of HD bf16 starting at sequence position row0 (rows at or
// past s come in as zeros), by cp.async from NT threads
template <int HD, int ROWS, int NT>
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

}  // namespace mma_bf16
