// Warp-level building blocks shared by attn_fwd.cu and attn_bwd.cu: cp.async
// tile staging, ldmatrix fragment loads and the bf16 tensor-core product
// mma.sync.m16n8k16 (f32 accumulate).
//
// Fragment layout of m16n8k16 (g = lane / 4, t = lane % 4):
//   A 16x16, 4 regs: (row g, cols 2t..2t+1), (row g+8, same), (row g, cols
//     2t+8..), (row g+8, cols 2t+8..);
//   B 16x8, 2 regs: (k rows 2t..2t+1, col g), (k rows 2t+8.., col g);
//   C 16x8, 4 floats: (row g, cols 2t, 2t+1), (row g+8, cols 2t, 2t+1).
// So the C tiles of two neighbouring 8-column blocks, rounded to bf16 and
// packed in pairs, are the A fragment of a 16-deep product: a probability
// tile goes from one product into the next without leaving registers.
//
// Tiles sit in shared memory row-major with a row stride of HD + 8 bf16
// (16 bytes of pad): the eight row addresses of an ldmatrix then fall in
// distinct banks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 128;  // 4 warps per CTA
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool full) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = full ? 16 : 0;  // 0 source bytes: the 16 destination bytes are zeroed
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage rows [r0, r0 + ROWS) of a [S, HD] bf16 matrix into shared memory
// (row stride HD + 8); rows >= S are zero-filled.
template <int ROWS, int HD>
__device__ __forceinline__ void load_tile(bf16* sm, const bf16* __restrict__ g, int r0, int S) {
  constexpr int CH = HD / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < ROWS * CH; c += THREADS) {
    const int r = c / CH, col = (c % CH) * 8;
    const bool ok = r0 + r < S;
    cp_async16(sm + r * (HD + 8) + col, ok ? g + (size_t)(r0 + r) * HD + col : g, ok);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const bf16* p) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const bf16* p) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// A fragment of the 16x16 block at (row0, k0) of a row-major [m][k] tile.
__device__ __forceinline__ void load_a(uint32_t* a, const bf16* tile, int ld, int row0, int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(a, tile + (row0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
}

// B fragments of two neighbouring 8-column blocks (n0, n0 + 8), depth k0..k0+15,
// for B = Tᵀ where T is a row-major [n][k] tile (the "k" rows of a q·kᵀ):
// b[0..1] for block n0, b[2..3] for block n0 + 8.
__device__ __forceinline__ void load_b_nk(uint32_t* b, const bf16* tile, int ld, int n0, int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(b, tile + (n0 + ((lane >> 4) << 3) + (lane & 7)) * ld + k0 + ((lane >> 3) & 1) * 8);
}

// The same for B = T where T is a row-major [k][n] tile (the "v" of a p·v).
__device__ __forceinline__ void load_b_kn(uint32_t* b, const bf16* tile, int ld, int k0, int n0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_trans(b, tile + (k0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * ld + n0 + (lane >> 4) * 8);
}

// c += a · b on the tensor cores, bf16 operands, f32 accumulation.
__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low 16 bits
  return *reinterpret_cast<uint32_t*>(&v);
}

// A fragment (16 rows x 16 deep) from the C tiles of 8-column blocks 2j and
// 2j + 1 of a 16-row f32 accumulator, rounded to bf16.
__device__ __forceinline__ void c_to_a(uint32_t* a, const float* c_lo, const float* c_hi) {
  a[0] = pack_bf16(c_lo[0], c_lo[1]);
  a[1] = pack_bf16(c_lo[2], c_lo[3]);
  a[2] = pack_bf16(c_hi[0], c_hi[1]);
  a[3] = pack_bf16(c_hi[2], c_hi[3]);
}

// acc[16 x 8·NT] += A (16 x 16·KT, row-major [m][k] tile at row0) · Tᵀ, T a
// row-major [n][k] tile whose rows n0.. give the NT column blocks.
template <int NT, int KT>
__device__ __forceinline__ void gemm_a_bnk(float (*acc)[4], const bf16* a_tile, int lda, int row0,
                                           const bf16* b_tile, int ldb, int n0) {
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    uint32_t a[4];
    load_a(a, a_tile, lda, row0, kk * 16);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      load_b_nk(b, b_tile, ldb, n0 + np * 16, kk * 16);
      mma(acc[2 * np], a, b[0], b[1]);
      mma(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// acc[16 x 8·NT] += P · T, P the bf16 rounding of a 16 x 16·KT register
// accumulator p (in C layout), T a row-major [k][n] tile.
template <int NT, int KT>
__device__ __forceinline__ void gemm_p_bkn(float (*acc)[4], float (*p)[4], const bf16* b_tile,
                                           int ldb) {
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    uint32_t a[4];
    c_to_a(a, p[2 * kk], p[2 * kk + 1]);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      load_b_kn(b, b_tile, ldb, kk * 16, np * 16);
      mma(acc[2 * np], a, b[0], b[1]);
      mma(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

}  // namespace attn
