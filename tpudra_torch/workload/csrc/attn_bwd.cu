// Causal flash-attention backward for Hopper (sm_90a): dq, dk and dv of
// attn_fwd.cu's o = softmax(q·kᵀ)·v, the probabilities recomputed from the
// saved row logsumexp, the [S, S] scores never written to device memory.
//
// Replaces: the fused backward of jax's splash attention kernel
// (_flash_attention_dkv_kernel with use_fused_bwd_kernel=True, which also
// writes dq; di = rowsum(o·do) is an einsum outside the kernel there), as
// tpudra/workload/model.py::_layer builds it (:280-287).
//
// What bounds it on an H100: five products (q·kᵀ again, do·vᵀ, pᵀ·do, dsᵀ·q,
// ds·k), 171.8 GFLOP causal at the flagship [16, 16, 1024, 128] (0.174 ms at
// 989 TFLOP/s), against about 8 [B, H, S, hd] bf16 tensors read or written
// (0.160 ms at 3.35 TB/s): the tensor cores.
//
// Design.  Splash's fused kernel walks q blocks inside a kv block and adds
// into dq across grid steps; GPU blocks run in no order, so that sum would
// need atomics.  Here it is two kernels, deterministic, each owning what it
// writes:
//   - dq: one CTA per (b·h, 64-row q tile) walks the kv tiles up to the
//     diagonal, recomputes P = exp(q·kᵀ − lse), dP = dO·vᵀ,
//     dS = P·(dP − di) and adds dS·K into dq in registers.  Its prologue
//     computes di = rowsum(o·do) for its rows (f32) and writes it out.
//   - dk/dv: one CTA per (b·h, 64-row kv tile), launched after dq on the
//     same stream, walks the 32-row q tiles from the diagonal to the end,
//     works on the transposed tiles (Pᵀ = exp(k·qᵀ − lse), dPᵀ = v·doᵀ) so
//     that Pᵀ·dO and dSᵀ·Q come straight from registers, and keeps dK and
//     dV in registers.
// Products on the tensor cores (mma.sync m16n8k16, bf16 -> f32); P and dS
// rounded to bf16 where they feed a product, as in attn_fwd.cu.  The next
// tile is copied with cp.async while this one is used (two stages).  Ragged
// S: rows >= S are zero-filled on load, get lse = +inf (so P = 0) and di =
// 0, and are not stored.
//
// A first, simple design (mma.sync, no TMA, no warp specialisation); its
// time beside its bound is recorded in PERF.md.

#include <math.h>

#include "attn_common.cuh"

using namespace attn;

namespace {

constexpr int DQ_BQ = 64;    // dq kernel: q rows per CTA
constexpr int DQ_BKV = 64;   // dq kernel: kv rows per tile
constexpr int DKV_BKV = 64;  // dk/dv kernel: kv rows per CTA
constexpr int DKV_BQ = 32;   // dk/dv kernel: q rows per tile

template <int HD>
constexpr int dq_smem_bytes() {  // q, do, 2 x k, 2 x v; di and lse of the rows
  return (2 * DQ_BQ + 4 * DQ_BKV) * (HD + 8) * (int)sizeof(bf16) + 2 * DQ_BQ * (int)sizeof(float);
}

template <int HD>
constexpr int dkv_smem_bytes() {  // k, v, 2 x q, 2 x do; 2 x lse and di of the q rows
  return (2 * DKV_BKV + 4 * DKV_BQ) * (HD + 8) * (int)sizeof(bf16) +
         4 * DKV_BQ * (int)sizeof(float);
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
    attn_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ o,
                       const float* __restrict__ lse, const bf16* __restrict__ dout,
                       bf16* __restrict__ dq, float* __restrict__ di, int S) {
  constexpr int LD = HD + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = qs + DQ_BQ * LD;
  bf16* ks = dos + DQ_BQ * LD;
  bf16* vs = ks + 2 * DQ_BKV * LD;
  float* d_s = reinterpret_cast<float*>(vs + 2 * DQ_BKV * LD);
  float* l_s = d_s + DQ_BQ;

  const int mt = gridDim.x - 1 - blockIdx.x;  // the longest rows first
  const int m0 = mt * DQ_BQ;
  const size_t base = (size_t)blockIdx.y * S * HD;
  const size_t row_base = (size_t)blockIdx.y * S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int row_a = m0 + warp * 16 + g;
  const int row_b = row_a + 8;

  const int n_kv = (m0 + DQ_BQ - 1) / DQ_BKV + 1;
  load_tile<DQ_BQ, HD>(qs, q + base, m0, S);
  load_tile<DQ_BQ, HD>(dos, dout + base, m0, S);
  load_tile<DQ_BKV, HD>(ks, k + base, 0, S);
  load_tile<DQ_BKV, HD>(vs, v + base, 0, S);
  cp_async_commit();

  // di = rowsum(o·do) in f32 for this CTA's rows, two threads per row, while
  // the tiles are in flight; written out for the dk/dv kernel.
  {
    const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
    const int row = m0 + r;
    float sum = 0.f;
    if (row < S) {
      const uint4* op = reinterpret_cast<const uint4*>(o + base + (size_t)row * HD + half * (HD / 2));
      const uint4* dp = reinterpret_cast<const uint4*>(dout + base + (size_t)row * HD + half * (HD / 2));
#pragma unroll
      for (int c = 0; c < HD / 16; ++c) {
        uint4 a = op[c], b = dp[c];
        const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
        const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 fa = __bfloat1622float2(a2[e]), fb = __bfloat1622float2(b2[e]);
          sum = fmaf(fa.x, fb.x, sum);
          sum = fmaf(fa.y, fb.y, sum);
        }
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (half == 0) {
      d_s[r] = sum;
      l_s[r] = row < S ? lse[row_base + row] * LOG2E : INFINITY;
      if (row < S) di[row_base + row] = sum;
    }
  }

  float acc[HD / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float row_d[2], row_l[2];

  for (int j = 0; j < n_kv; ++j) {
    if (j + 1 < n_kv) {
      const int s = (j + 1) & 1;
      load_tile<DQ_BKV, HD>(ks + s * DQ_BKV * LD, k + base, (j + 1) * DQ_BKV, S);
      load_tile<DQ_BKV, HD>(vs + s * DQ_BKV * LD, v + base, (j + 1) * DQ_BKV, S);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (j == 0) {
      row_d[0] = d_s[warp * 16 + g];
      row_d[1] = d_s[warp * 16 + g + 8];
      row_l[0] = l_s[warp * 16 + g];
      row_l[1] = l_s[warp * 16 + g + 8];
    }
    const bf16* kc = ks + (j & 1) * DQ_BKV * LD;
    const bf16* vc = vs + (j & 1) * DQ_BKV * LD;

    float sc[DQ_BKV / 8][4], dp[DQ_BKV / 8][4];
#pragma unroll
    for (int i = 0; i < DQ_BKV / 8; ++i) {
      sc[i][0] = sc[i][1] = sc[i][2] = sc[i][3] = 0.f;
      dp[i][0] = dp[i][1] = dp[i][2] = dp[i][3] = 0.f;
    }
    gemm_a_bnk<DQ_BKV / 8, HD / 16>(sc, qs, LD, warp * 16, kc, LD, 0);   // q·kᵀ
    gemm_a_bnk<DQ_BKV / 8, HD / 16>(dp, dos, LD, warp * 16, vc, LD, 0);  // do·vᵀ

    const int n0 = j * DQ_BKV;
    if (n0 + DQ_BKV - 1 > m0 + warp * 16) {
#pragma unroll
      for (int nt = 0; nt < DQ_BKV / 8; ++nt) {
        const int col = n0 + nt * 8 + 2 * t4;
        if (col > row_a) sc[nt][0] = -INFINITY;
        if (col + 1 > row_a) sc[nt][1] = -INFINITY;
        if (col > row_b) sc[nt][2] = -INFINITY;
        if (col + 1 > row_b) sc[nt][3] = -INFINITY;
      }
    }
    // ds = p·(dp − di), p = exp(s − lse), kept in sc.
#pragma unroll
    for (int nt = 0; nt < DQ_BKV / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = exp2f(fmaf(sc[nt][e], LOG2E, -row_l[r]));
        sc[nt][e] = p * (dp[nt][e] - row_d[r]);
      }
    }
    gemm_p_bkn<HD / 8, DQ_BKV / 16>(acc, sc, kc, LD);  // dq += ds·k
    __syncthreads();
  }

  const int rows[2] = {row_a, row_b};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= S) continue;
    bf16* out = dq + base + (size_t)rows[r] * HD;
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(out + dt * 8 + 2 * t4) =
          __floats2bfloat162_rn(acc[dt][2 * r], acc[dt][2 * r + 1]);
  }
}

// Stage lse (·log2 e; +inf past S) and di (0 past S) of q rows [q0, q0 + DKV_BQ).
__device__ __forceinline__ void load_row_stats(float* l_s, float* d_s, const float* __restrict__ lse,
                                               const float* __restrict__ di, int q0, int S) {
  const int t = threadIdx.x;
  if (t < DKV_BQ) {
    const int row = q0 + t;
    l_s[t] = row < S ? lse[row] * LOG2E : INFINITY;
    d_s[t] = row < S ? di[row] : 0.f;
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
    attn_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const float* __restrict__ lse,
                        const bf16* __restrict__ dout, const float* __restrict__ di,
                        bf16* __restrict__ dk, bf16* __restrict__ dv, int S) {
  constexpr int LD = HD + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + DKV_BKV * LD;
  bf16* qs = vs + DKV_BKV * LD;
  bf16* dos = qs + 2 * DKV_BQ * LD;
  float* l_s = reinterpret_cast<float*>(dos + 2 * DKV_BQ * LD);
  float* d_s = l_s + 2 * DKV_BQ;

  const int n0 = blockIdx.x * DKV_BKV;  // the longest columns (first kv tiles) first
  const size_t base = (size_t)blockIdx.y * S * HD;
  const float* lse_bh = lse + (size_t)blockIdx.y * S;
  const float* di_bh = di + (size_t)blockIdx.y * S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int krow_a = n0 + warp * 16 + g;  // this thread's two kv rows
  const int krow_b = krow_a + 8;

  const int i0 = n0 / DKV_BQ;  // first q tile that sees this kv tile
  const int n_q = (S + DKV_BQ - 1) / DKV_BQ;
  load_tile<DKV_BKV, HD>(ks, k + base, n0, S);
  load_tile<DKV_BKV, HD>(vs, v + base, n0, S);
  load_tile<DKV_BQ, HD>(qs, q + base, i0 * DKV_BQ, S);
  load_tile<DKV_BQ, HD>(dos, dout + base, i0 * DKV_BQ, S);
  load_row_stats(l_s, d_s, lse_bh, di_bh, i0 * DKV_BQ, S);
  cp_async_commit();

  float dk_acc[HD / 8][4], dv_acc[HD / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) {
    dk_acc[i][0] = dk_acc[i][1] = dk_acc[i][2] = dk_acc[i][3] = 0.f;
    dv_acc[i][0] = dv_acc[i][1] = dv_acc[i][2] = dv_acc[i][3] = 0.f;
  }

  for (int i = i0; i < n_q; ++i) {
    const int st = (i - i0) & 1;
    if (i + 1 < n_q) {
      const int ns = st ^ 1;
      load_tile<DKV_BQ, HD>(qs + ns * DKV_BQ * LD, q + base, (i + 1) * DKV_BQ, S);
      load_tile<DKV_BQ, HD>(dos + ns * DKV_BQ * LD, dout + base, (i + 1) * DKV_BQ, S);
      load_row_stats(l_s + ns * DKV_BQ, d_s + ns * DKV_BQ, lse_bh, di_bh, (i + 1) * DKV_BQ, S);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* qc = qs + st * DKV_BQ * LD;
    const bf16* doc = dos + st * DKV_BQ * LD;
    const float* lc = l_s + st * DKV_BQ;
    const float* dc = d_s + st * DKV_BQ;

    // Pᵀ = exp(k·qᵀ − lse) [16 kv rows x 32 q columns per warp].
    float sc[DKV_BQ / 8][4];
#pragma unroll
    for (int c = 0; c < DKV_BQ / 8; ++c) sc[c][0] = sc[c][1] = sc[c][2] = sc[c][3] = 0.f;
    gemm_a_bnk<DKV_BQ / 8, HD / 16>(sc, ks, LD, warp * 16, qc, LD, 0);
    const int q0 = i * DKV_BQ;
    const bool diag = q0 < n0 + warp * 16 + 15;  // some query before some key
#pragma unroll
    for (int nt = 0; nt < DKV_BQ / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + 2 * t4 + (e & 1);
        const int krow = (e >> 1) ? krow_b : krow_a;
        const float s = diag && q0 + c < krow ? -INFINITY : sc[nt][e];
        sc[nt][e] = exp2f(fmaf(s, LOG2E, -lc[c]));
      }
    }
    gemm_p_bkn<HD / 8, DKV_BQ / 16>(dv_acc, sc, doc, LD);  // dv += pᵀ·do

    // dSᵀ = Pᵀ·(dPᵀ − di), dPᵀ = v·doᵀ.
    float dp[DKV_BQ / 8][4];
#pragma unroll
    for (int c = 0; c < DKV_BQ / 8; ++c) dp[c][0] = dp[c][1] = dp[c][2] = dp[c][3] = 0.f;
    gemm_a_bnk<DKV_BQ / 8, HD / 16>(dp, vs, LD, warp * 16, doc, LD, 0);
#pragma unroll
    for (int nt = 0; nt < DKV_BQ / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] *= dp[nt][e] - dc[nt * 8 + 2 * t4 + (e & 1)];
    }
    gemm_p_bkn<HD / 8, DKV_BQ / 16>(dk_acc, sc, qc, LD);  // dk += dsᵀ·q
    __syncthreads();
  }

  const int rows[2] = {krow_a, krow_b};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= S) continue;
    bf16* dk_row = dk + base + (size_t)rows[r] * HD;
    bf16* dv_row = dv + base + (size_t)rows[r] * HD;
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt) {
      *reinterpret_cast<__nv_bfloat162*>(dk_row + dt * 8 + 2 * t4) =
          __floats2bfloat162_rn(dk_acc[dt][2 * r], dk_acc[dt][2 * r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv_row + dt * 8 + 2 * t4) =
          __floats2bfloat162_rn(dv_acc[dt][2 * r], dv_acc[dt][2 * r + 1]);
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* o, const void* lse,
           const void* dout, void* dq, void* dk, void* dv, void* di, int BH, int S,
           cudaStream_t stream) {
  constexpr int smem_dq = dq_smem_bytes<HD>();
  constexpr int smem_dkv = dkv_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_dq_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dq);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(attn_bwd_dkv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_dkv);
  if (err != cudaSuccess) return (int)err;
  const bf16 *qb = static_cast<const bf16*>(q), *kb = static_cast<const bf16*>(k),
             *vb = static_cast<const bf16*>(v), *dob = static_cast<const bf16*>(dout);
  const float* lf = static_cast<const float*>(lse);
  float* dif = static_cast<float*>(di);
  attn_bwd_dq_kernel<HD><<<dim3((S + DQ_BQ - 1) / DQ_BQ, BH), THREADS, smem_dq, stream>>>(
      qb, kb, vb, static_cast<const bf16*>(o), lf, dob, static_cast<bf16*>(dq), dif, S);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dkv_kernel<HD><<<dim3((S + DKV_BKV - 1) / DKV_BKV, BH), THREADS, smem_dkv, stream>>>(
      qb, kb, vb, lf, dob, dif, static_cast<bf16*>(dk), static_cast<bf16*>(dv), S);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o, do and dq, dk, dv [BH, S, hd] bf16; lse and the scratch di
// [BH, S] f32; all contiguous on one device, hd 64 or 128.  Launches the dq
// kernel (which writes di) and then the dk/dv kernel on `stream`, allocates
// nothing, does not synchronise; returns cudaGetLastError() after the
// launches.
extern "C" int tpudra_attn_bwd(const void* q, const void* k, const void* v, const void* o,
                               const void* lse, const void* dout, void* dq, void* dk, void* dv,
                               void* di, int BH, int S, int hd, void* stream) {
  if (BH <= 0 || BH > 65535 || S <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 64) return launch<64>(q, k, v, o, lse, dout, dq, dk, dv, di, BH, S, st);
  if (hd == 128) return launch<128>(q, k, v, o, lse, dout, dq, dk, dv, di, BH, S, st);
  return (int)cudaErrorInvalidValue;
}
