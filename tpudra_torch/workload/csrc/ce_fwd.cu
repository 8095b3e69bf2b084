// Fused cross-entropy forward for Hopper (sm_90a): per row of x, the
// logsumexp of x·Eᵀ over the whole vocabulary and the target's logit, with
// the [N, V] logits never written to device memory.
//
// Replaces: tpudra/workload/ce_kernel.py::_fwd_kernel, launched by
// _fwd_pallas (the Pallas online-softmax kernel of the fused CE head).
//
// What bounds it on an H100: the logits product, 2·N·D·V operations
// (2.2 TFLOP at the flagship N = 16368, D = 2048, V = 32768), against about
// 0.2 GB of operands, so the tensor cores and not the memory are the limit.
//
// Design.  On the TPU the grid walks the vocab blocks in order and carries
// the running max/sum in scratch memory between grid steps.  GPU blocks run
// in no order, so here one CTA owns BM rows of x and walks the WHOLE vocab
// itself, keeping each row's running max, sum and target logit in registers:
//   - a [BM x BV] logits tile is accumulated in f32 on the tensor cores
//     (nvcuda::wmma, bf16 x bf16 -> f32) from BK-deep slices of x and E;
//   - the slices are staged through shared memory with cp.async, two stages
//     deep, so the next slice's copy overlaps this slice's products;
//   - when a tile is complete it goes to shared memory once and four threads
//     per row fold it into that row's online max/sum and pick the target.
// Ragged edges: rows >= N and vocab columns >= V are zero-filled on load and
// the vocab tail is masked to -inf in the softmax, so any N and V are taken
// (no dividing block is needed, and no tail is dropped).  D must be a
// multiple of 8 (16-byte copies); the wrapper checks it.
//
// A first, simple design: wmma rather than wgmma, no TMA, no warp
// specialisation.  Its time beside its bound is recorded in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 64;              // rows of x per CTA
constexpr int BV = 128;             // vocab columns per logits tile
constexpr int BK = 64;              // depth (D) per staged slice
constexpr int LDS = BK + 8;         // bf16 row stride of a staged slice
constexpr int LDL = BV + 4;         // f32 row stride of the logits tile
constexpr int THREADS = 256;        // 8 warps: 2 along rows x 4 along vocab
constexpr int STAGES = 2;
constexpr int X_TILE = BM * LDS;    // bf16 elements per x slice
constexpr int E_TILE = BV * LDS;    // bf16 elements per E slice
constexpr int SMEM_BYTES =
    STAGES * (X_TILE + E_TILE) * (int)sizeof(bf16) + BM * LDL * (int)sizeof(float);

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool full) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = full ? 16 : 0;  // 0 source bytes: the 16 destination bytes are zeroed
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Stage the BK-deep slice at depth k0 of x rows [row0, row0+BM) and of E
// rows [v0, v0+BV) into shared memory, zero-filling outside [N) x [V) x [D).
__device__ __forceinline__ void load_slice(bf16* xs, bf16* es, const bf16* __restrict__ x,
                                           const bf16* __restrict__ e, int row0, int v0,
                                           int k0, int N, int V, int D) {
  constexpr int CHUNKS = BK / 8;  // 16-byte chunks per slice row
  for (int c = threadIdx.x; c < BM * CHUNKS; c += THREADS) {
    int r = c / CHUNKS, kk = (c % CHUNKS) * 8;
    int gr = row0 + r, gk = k0 + kk;
    bool ok = gr < N && gk < D;
    cp_async16(xs + r * LDS + kk, ok ? x + (size_t)gr * D + gk : x, ok);
  }
  for (int c = threadIdx.x; c < BV * CHUNKS; c += THREADS) {
    int r = c / CHUNKS, kk = (c % CHUNKS) * 8;
    int gv = v0 + r, gk = k0 + kk;
    bool ok = gv < V && gk < D;
    cp_async16(es + r * LDS + kk, ok ? e + (size_t)gv * D + gk : e, ok);
  }
}

__global__ void __launch_bounds__(THREADS, 2)
    ce_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ e,
                  const int32_t* __restrict__ targets, float* __restrict__ lse,
                  float* __restrict__ tlog, int N, int V, int D) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* es = xs + STAGES * X_TILE;
  float* logits = reinterpret_cast<float*>(es + STAGES * E_TILE);

  const int row0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32;
  const int wm = warp / 4;  // 32-row band of the tile
  const int wn = warp % 4;  // 32-column band of the tile

  // Row statistics: four neighbouring lanes own one row; lane `quarter`
  // reads the tile's columns quarter, quarter+4, ... (bank-conflict free).
  const int my_row = threadIdx.x >> 2;
  const int quarter = threadIdx.x & 3;
  const int grow = row0 + my_row;
  const int my_target = grow < N ? targets[grow] : -1;
  float run_max = -INFINITY, run_sum = 0.f, tgt_logit = 0.f;

  const int n_k = (D + BK - 1) / BK;
  const int n_v = (V + BV - 1) / BV;
  const int total = n_k * n_v;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];

  load_slice(xs, es, x, e, row0, 0, 0, N, V, D);
  cp_async_commit();

  for (int it = 0; it < total; ++it) {
    const int vt = it / n_k, kc = it % n_k;
    if (kc == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
    }
    // Prefetch the next slice into the other stage; always commit a group
    // (possibly empty) so that "all but one" means "this slice".
    if (it + 1 < total) {
      const int nvt = (it + 1) / n_k, nkc = (it + 1) % n_k;
      const int s = (it + 1) & 1;
      load_slice(xs + s * X_TILE, es + s * E_TILE, x, e, row0, nvt * BV, nkc * BK, N, V, D);
    }
    cp_async_commit();
    cp_async_wait_all_but_one();
    __syncthreads();

    const bf16* xs_c = xs + (it & 1) * X_TILE;
    const bf16* es_c = es + (it & 1) * E_TILE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], xs_c + (wm * 32 + i * 16) * LDS + kk, LDS);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], es_c + (wn * 32 + j * 16) * LDS + kk, LDS);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    // Every warp is done with this stage before the next iteration's
    // prefetch overwrites it.
    __syncthreads();

    if (kc == n_k - 1) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::store_matrix_sync(logits + (wm * 32 + i * 16) * LDL + wn * 32 + j * 16,
                                  acc[i][j], LDL, wmma::mem_row_major);
      __syncthreads();

      // Online max/sum over this tile's valid columns.  The tile is written
      // again only after the next tile's slices, two barriers later.
      const int v0 = vt * BV;
      const float* lrow = logits + my_row * LDL;
      float tile_max = -INFINITY;
      for (int c = quarter; c < BV; c += 4)
        if (v0 + c < V) tile_max = fmaxf(tile_max, lrow[c]);
      if (tile_max > -INFINITY) {
        const float new_max = fmaxf(run_max, tile_max);
        float tile_sum = 0.f;
        for (int c = quarter; c < BV; c += 4)
          if (v0 + c < V) tile_sum += expf(lrow[c] - new_max);
        run_sum = run_sum * expf(run_max - new_max) + tile_sum;
        run_max = new_max;
      }
      const int local = my_target - v0;
      if (local >= 0 && local < BV && (local & 3) == quarter && v0 + local < V)
        tgt_logit = lrow[local];
    }
  }

  // Combine the four lanes of each row.
  float m = run_max;
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
  float s = run_max == -INFINITY ? 0.f : run_sum * expf(run_max - m);
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  float t = tgt_logit;
  t += __shfl_xor_sync(0xffffffffu, t, 1);
  t += __shfl_xor_sync(0xffffffffu, t, 2);
  if (quarter == 0 && grow < N) {
    lse[grow] = m + logf(s);
    tlog[grow] = t;
  }
}

}  // namespace

// x [N, D] bf16, e [V, D] bf16, targets [N] int32 -> lse [N] f32, tlog [N]
// f32 (0 for a target outside [0, V)).  All contiguous on one device.
// Launches on `stream`, allocates nothing, does not synchronise; returns
// cudaGetLastError() after the launch.
extern "C" int tpudra_ce_fwd(const void* x, const void* e, const void* targets, void* lse,
                             void* tlog, int N, int V, int D, void* stream) {
  if (N <= 0 || V <= 0 || D <= 0 || D % 8 != 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ce_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + BM - 1) / BM);
  ce_fwd_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(e),
      static_cast<const int32_t*>(targets), static_cast<float*>(lse),
      static_cast<float*>(tlog), N, V, D);
  return (int)cudaGetLastError();
}
