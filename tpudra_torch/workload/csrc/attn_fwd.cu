// Causal flash-attention forward for Hopper (sm_90a): per (batch, head),
// o = softmax(q·kᵀ)·v under the causal mask and the row logsumexp lse, with
// the [S, S] scores never written to device memory.  q comes in already
// scaled (the caller scales it in bf16, as the JAX model does).
//
// Replaces: the forward of jax's splash attention kernel
// (jax.experimental.pallas.ops.tpu.splash_attention, flash_attention_kernel),
// as tpudra/workload/model.py::_layer builds and calls it (:272-288).
//
// What bounds it on an H100: at the flagship [16, 16, 1024, 128] the causal
// products are 4·B·H·S²·hd/2 = 68.7 GFLOP (0.069 ms at 989 TFLOP/s) against
// 269.5 MB of q, k, v, o and lse (0.080 ms at 3.35 TB/s): near the ridge, so
// both the tensor cores and the memory traffic matter; at seq 8192 the
// products dominate.
//
// Design.  On the TPU, splash's grid walks the kv blocks in order and carries
// the running max/sum in VMEM scratch.  Here one CTA of 4 warps owns a
// 64-row q tile (16 rows per warp) and walks the kv tiles itself, from the
// first to the diagonal; tiles wholly above the diagonal are skipped, not
// masked.  Per kv tile:
//   - S = Q·Kᵀ on the tensor cores (mma.sync m16n8k16, bf16 -> f32);
//   - the online max and sum stay in registers (two rows per thread, the
//     four threads of a row combine by shuffles); only the diagonal tile is
//     masked;
//   - P·V with P rounded to bf16 and f32 accumulation (splash keeps P in f32
//     and casts v up instead; the difference is one bf16 rounding of each
//     probability, within the tolerance chip_smoke.py states);
//   - the next K/V tile is copied with cp.async while this one is used (two
//     stages).
// Ragged S: rows and keys >= S are zero-filled on load; a key >= S only ever
// sits after a valid query, so the causal mask already drops it, and rows
// >= S are not stored.  Any S >= 1 is taken.
//
// A first, simple design: mma.sync rather than wgmma, no TMA, no warp
// specialisation.  Its time beside its bound is recorded in PERF.md.

#include <math.h>

#include "attn_common.cuh"

using namespace attn;

namespace {

constexpr int BM = 64;  // q rows per CTA (4 warps x 16)
constexpr int BN = 64;  // kv rows per tile

template <int HD>
constexpr int fwd_smem_bytes() {
  return (BM + 4 * BN) * (HD + 8) * (int)sizeof(bf16);  // q, 2 x k, 2 x v
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
    attn_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                    int S) {
  constexpr int LD = HD + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + BM * LD;
  bf16* vs = ks + 2 * BN * LD;

  // The longest rows (most kv tiles) first.
  const int mt = gridDim.x - 1 - blockIdx.x;
  const int m0 = mt * BM;
  const size_t base = (size_t)blockIdx.y * S * HD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int row_a = m0 + warp * 16 + g;  // this thread's two rows
  const int row_b = row_a + 8;

  const int n_kv = (m0 + BM - 1) / BN + 1;  // kv tiles up to the diagonal
  load_tile<BM, HD>(qs, q + base, m0, S);
  load_tile<BN, HD>(ks, k + base, 0, S);
  load_tile<BN, HD>(vs, v + base, 0, S);
  cp_async_commit();

  float acc[HD / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float run_max[2] = {-INFINITY, -INFINITY};
  float run_sum[2] = {0.f, 0.f};  // this thread's columns only, combined at the end

  for (int j = 0; j < n_kv; ++j) {
    // Prefetch the next tile into the other stage; always commit a group
    // (possibly empty) so that "all but one" means "this tile".
    if (j + 1 < n_kv) {
      const int s = (j + 1) & 1;
      load_tile<BN, HD>(ks + s * BN * LD, k + base, (j + 1) * BN, S);
      load_tile<BN, HD>(vs + s * BN * LD, v + base, (j + 1) * BN, S);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* kc = ks + (j & 1) * BN * LD;
    const bf16* vc = vs + (j & 1) * BN * LD;

    float sc[BN / 8][4];
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) sc[i][0] = sc[i][1] = sc[i][2] = sc[i][3] = 0.f;
    gemm_a_bnk<BN / 8, HD / 16>(sc, qs, LD, warp * 16, kc, LD, 0);

    const int n0 = j * BN;
    if (n0 + BN - 1 > m0 + warp * 16) {  // this warp's block crosses the diagonal
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        const int col = n0 + nt * 8 + 2 * t4;
        if (col > row_a) sc[nt][0] = -INFINITY;
        if (col + 1 > row_a) sc[nt][1] = -INFINITY;
        if (col > row_b) sc[nt][2] = -INFINITY;
        if (col + 1 > row_b) sc[nt][3] = -INFINITY;
      }
    }

    // Online softmax, row by row (r = 0: row_a, elements 0, 1; r = 1: row_b).
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = run_max[r];
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) mx = fmaxf(mx, fmaxf(sc[nt][2 * r], sc[nt][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // A row with no key yet keeps max -inf; 0 stands in so no inf - inf.
      const float ref = mx == -INFINITY ? 0.f : mx * LOG2E;
      const float alpha = exp2f(run_max[r] * LOG2E - ref);
      run_max[r] = mx;
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        sc[nt][2 * r] = exp2f(fmaf(sc[nt][2 * r], LOG2E, -ref));
        sc[nt][2 * r + 1] = exp2f(fmaf(sc[nt][2 * r + 1], LOG2E, -ref));
        sum += sc[nt][2 * r] + sc[nt][2 * r + 1];
      }
      run_sum[r] = run_sum[r] * alpha + sum;
#pragma unroll
      for (int dt = 0; dt < HD / 8; ++dt) {
        acc[dt][2 * r] *= alpha;
        acc[dt][2 * r + 1] *= alpha;
      }
    }

    gemm_p_bkn<HD / 8, BN / 16>(acc, sc, vc, LD);
    // Every warp is done with this stage before the next prefetch reuses it.
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    run_sum[r] += __shfl_xor_sync(0xffffffffu, run_sum[r], 1);
    run_sum[r] += __shfl_xor_sync(0xffffffffu, run_sum[r], 2);
  }
  const float inv[2] = {1.f / run_sum[0], 1.f / run_sum[1]};
  const int rows[2] = {row_a, row_b};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= S) continue;
    bf16* orow = o + base + (size_t)rows[r] * HD;
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt) {
      *reinterpret_cast<__nv_bfloat162*>(orow + dt * 8 + 2 * t4) =
          __floats2bfloat162_rn(acc[dt][2 * r] * inv[r], acc[dt][2 * r + 1] * inv[r]);
    }
    if (t4 == 0) lse[(size_t)blockIdx.y * S + rows[r]] = run_max[r] + logf(run_sum[r]);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int BH, int S,
           cudaStream_t stream) {
  constexpr int smem = fwd_smem_bytes<HD>();
  cudaError_t err =
      cudaFuncSetAttribute(attn_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + BM - 1) / BM, BH);
  attn_fwd_kernel<HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), static_cast<float*>(lse), S);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o [BH, S, hd] bf16 and lse [BH, S] f32, contiguous on one device;
// hd 64 or 128.  Launches on `stream`, allocates nothing, does not
// synchronise; returns cudaGetLastError() after the launch.
extern "C" int tpudra_attn_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                               int BH, int S, int hd, void* stream) {
  if (BH <= 0 || BH > 65535 || S <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 64) return launch<64>(q, k, v, o, lse, BH, S, st);
  if (hd == 128) return launch<128>(q, k, v, o, lse, BH, S, st);
  return (int)cudaErrorInvalidValue;
}
