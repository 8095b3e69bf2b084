// Causal flash-attention backward for Hopper (sm_90a): dq, dk and dv of
// attn_fwd.cu's o = softmax(q·kᵀ)·v, the probabilities recomputed from the
// saved row logsumexp, the [S, S] scores never written to device memory.
//
// Replaces: the fused backward of jax's splash attention kernel
// (_flash_attention_dkv_kernel with use_fused_bwd_kernel=True, which also
// writes dq; di = rowsum(o·do) is an einsum outside the kernel there), as
// tpudra/workload/model.py::_layer builds it (:280-287).
//
// What bounds it on an H100: five products (q·kᵀ, do·vᵀ, pᵀ·do, dsᵀ·q,
// ds·k), 171.8 GFLOP causal at the flagship [16, 16, 1024, 128] (0.174 ms at
// 989 TFLOP/s), against about 8 [B, H, S, hd] bf16 tensors read or written
// (0.160 ms at 3.35 TB/s): the tensor cores.  This design does seven (the dq
// kernel computes q·kᵀ and do·vᵀ again), whose bound is 0.243 ms there.
//
// Design.  Splash's fused kernel walks q blocks inside a kv block and adds
// into dq across grid steps; GPU blocks run in no order, so that sum would
// need atomics, whose order changes from run to run.  Here it is two
// kernels, each owning what it writes, so a run repeats bit for bit:
//   - dq: a CTA owns 128 q rows of one (b·h), 64 per warpgroup, and walks
//     the 64-row kv tiles up to the diagonal.
//     S = Q·Kᵀ and dP = dO·Vᵀ by SS wgmma (m64n64, both K-major); P =
//     exp(S − lse), masked on the diagonal tile; dS = P∘(dP − di), packed to
//     bf16 as the register A operand of dQ += dS·K (RS wgmma, K read
//     MN-major).  Its prologue computes di = rowsum(o·do) in f32 for its
//     rows and writes it out for the dk/dv kernel.
//   - dk/dv: launched after dq on the same stream; a CTA owns 128 kv rows,
//     64 per warpgroup, and walks the 64-row q tiles from the diagonal to
//     the end.  It works on the
//     transposed tiles, so that every A operand is in shared memory or
//     registers: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ (SS, m64n64); Pᵀ = exp(Sᵀ −
//     lse_col), masked on the diagonal tile, packed to bf16 for dV += Pᵀ·dO;
//     dSᵀ = Pᵀ∘(dPᵀ − di_col), packed for dK += dSᵀ·Q (RS, dO and Q read
//     MN-major).  dK and dV stay in registers to the end.
//   - Order: the CTAs of 16 heads run together, longest rows first within
//     them (cta_work), so the tiles each CTA streams, which several CTAs of
//     the head read, come from L2 rather than device memory (launching
//     every head's longest tiles first measured slower on an H100).
//   - Loads (both kernels): thread 0 loads the CTA's own tiles once and
//     streams the other side's 64-row tiles through a three-stage ring by
//     TMA, with full and empty mbarriers, at the start of its warpgroup's
//     turn (as attn_fwd.cu argues, the stage it loads into is free by then
//     or is freed without waiting on warpgroup 0).  The tensor maps are 3-D
//     over [BH, S, hd], so a tile that runs past S reads zeros, not the next
//     head's rows.  The dk/dv kernel's column stats (lse and di of the q
//     tile) cannot come by TMA (a row of S floats is not a multiple of 16
//     bytes for every S): warp 0 copies them with 4-byte cp.async into the
//     same stage, and their arrival completes the stage's full barrier.
//   - Overlap: the two warpgroups take turns to issue their SS products
//     (named barriers 1 and 2, a ping-pong), so one's elementwise pass runs
//     under the other's products; S and dP are two commit groups, so the
//     exponentials start while dP is still being computed.  The dq kernel
//     issues tile j's SS products and tile j−1's RS product in one turn and
//     runs tile j's elementwise pass while the RS product is in flight.  The
//     dk/dv kernel cannot: its warpgroup holds dK, dV (64 + 64 f32 a thread
//     at hd 128) and Sᵀ, dPᵀ (32 + 32), and the packed Pᵀ, dSᵀ (16 + 16)
//     live beside them spilled at 255 registers; it issues tile j's RS
//     products right after packing them, outside its turn, and they run
//     while it waits for the next.  Two warpgroups of 256 threads, no
//     producer warpgroup: a third warpgroup caps every thread at 168
//     registers.
//   - No product is issued under a branch (ptxas serialises wgmma in a
//     path it cannot prove uniform): the dq kernel peels its first and last
//     steps, and a warpgroup whose rows see none of a tile (dq: warpgroup 0 and
//     the kv tile past its diagonal; dk/dv: warpgroup 1 and the first q
//     tile) runs its products all the same, masked to P = 0.
// P and dS are rounded to bf16 only where they feed a product, as in
// attn_fwd.cu; their f32 values make dS.  Ragged S: q and k rows >= S come
// in as zeros; in the dq kernel rows >= S take lse = +inf (P = 0); in the
// dk/dv kernel q columns >= S take lse = di = 0 and, with q = do = 0 there,
// add nothing to dk or dv.  Rows >= S are not stored.  Any S >= 1.

#include <math.h>

#include "hopper.cuh"

using namespace hopper;

namespace {

constexpr int BM = 128;  // rows a CTA owns (2 warpgroups x 64)
constexpr int BT = 64;   // rows of a streamed tile
constexpr int STAGES = 3;
constexpr int THREADS = 256;
constexpr int CONSUMER_WARPS = 8;
constexpr int BIG_BOX = BM * BOX_COLS;    // [128 x 64] box, elements
constexpr int SMALL_BOX = BT * BOX_COLS;  // [64 x 64] box, elements
constexpr uint32_t BIG_BOX_BYTES = BIG_BOX * sizeof(bf16);
constexpr uint32_t SMALL_BOX_BYTES = SMALL_BOX * sizeof(bf16);
constexpr int HEAD_GROUP = 16;  // heads whose CTAs run together (cta_work)

// Shared memory of either kernel: two [128 x HD] tiles of its own rows, two
// [64 x HD] tiles per stage, the mbarriers, and `floats` f32 values.
template <int HD>
constexpr int smem_bytes(int floats) {
  return 1024 /* alignment slack */ +
         2 * (HD / BOX_COLS) * (int)(BIG_BOX_BYTES + STAGES * SMALL_BOX_BYTES) +
         (1 + 2 * STAGES) * (int)sizeof(uint64_t) + floats * (int)sizeof(float);
}

// acc[32] = A·Bᵀ over depth HD: A 64 rows of a 128-row tile (`a` at its
// first row, in box 0), B a 64-row tile; both K-major.
template <int HD>
__device__ __forceinline__ void ss_product(float* acc, const bf16* a, const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int col = (kk % 4) * 16;
    wgmma_ss_n64(acc, desc_kmajor(a + (kk / 4) * BIG_BOX + col),
                 desc_kmajor(b + (kk / 4) * SMALL_BOX + col), kk > 0);
  }
}

// acc[HD / 2] += A·B over depth 64: A packed in registers (a[16], 4 per
// k16 step: pack_a), B a 64-row tile read MN-major.
template <int HD>
__device__ __forceinline__ void rs_product(float* acc, const uint32_t* a, const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk) {
    const uint64_t desc = desc_mnmajor(b + kk * 16 * BOX_COLS, SMALL_BOX_BYTES);
    if constexpr (HD == 128) {
      wgmma_rs_n128_mn(acc, a + 4 * kk, desc, 1);
    } else {
      wgmma_rs_n64_mn(acc, a + 4 * kk, desc, 1);
    }
  }
}

template <int N>
__device__ __forceinline__ void pack_all(uint32_t* a, const float* acc) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) pack_a(a + 4 * kk, acc + 8 * kk);
}

// The f32 accumulator rows of one warpgroup as bf16 rows of `out` ([S, HD]
// of one head): this thread's rows r0 and r0 + 8; rows >= S are dropped.
template <int HD>
__device__ __forceinline__ void store_rows(bf16* out, const float* acc, int r0, int S, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= S) continue;
    bf16* p = out + (size_t)row * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(p + 8 * j + 2 * t) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
}

// This CTA's head and tile rank (0 = the longest rows) in a 1-D grid of
// BH·T CTAs, T tiles a head: heads in groups of HEAD_GROUP, every tile of a
// group's heads before the next group's, longest first within a group.  So
// the CTAs in flight share few heads, and the rows they stream (each read
// by several CTAs of the head) come from L2, not device memory.
struct Work {
  int bh, rank;
};
__device__ __forceinline__ Work cta_work(int T) {
  const int BH = gridDim.x / T;
  const int group = blockIdx.x / (HEAD_GROUP * T), in = blockIdx.x % (HEAD_GROUP * T);
  const int heads = min(HEAD_GROUP, BH - group * HEAD_GROUP);
  return {group * HEAD_GROUP + in % heads, in / heads};
}

// Ping-pong between the warpgroups: warpgroup w waits on barrier 1 + w
// before it issues products and then lets the other one go.  Both walk the
// same number of steps; warpgroup 0 does not wait before its first,
// warpgroup 1 does not signal after its last, so every barrier phase gets
// 256 threads.
__device__ __forceinline__ void my_turn(int wg, bool first) {
  if (!(wg == 0 && first)) bar_sync(1 + wg, 256);
}
__device__ __forceinline__ void your_turn(int wg, bool last) {
  if (!(wg == 1 && last)) bar_arrive(2 - wg, 256);
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
    attn_bwd_dq_kernel(const __grid_constant__ CUtensorMap tmap_q,
                       const __grid_constant__ CUtensorMap tmap_do,
                       const __grid_constant__ CUtensorMap tmap_k,
                       const __grid_constant__ CUtensorMap tmap_v, const bf16* __restrict__ o,
                       const bf16* __restrict__ dout, const float* __restrict__ lse,
                       bf16* __restrict__ dq, float* __restrict__ di, int S) {
  constexpr int NB = HD / BOX_COLS;  // boxes per row of a tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* qs = reinterpret_cast<bf16*>(base);
  bf16* dos = qs + NB * BIG_BOX;
  bf16* ks = dos + NB * BIG_BOX;
  bf16* vs = ks + STAGES * NB * SMALL_BOX;
  uint64_t* qdo_full = reinterpret_cast<uint64_t*>(vs + STAGES * NB * SMALL_BOX);
  uint64_t* full = qdo_full + 1;
  uint64_t* empty = full + STAGES;
  float* d_s = reinterpret_cast<float*>(empty + STAGES);  // di of the CTA's rows
  float* l_s = d_s + BM;                                   // lse·log2 e (+inf past S)

  const int T = (S + BM - 1) / BM;
  const Work w = cta_work(T);
  const int bh = w.bh;
  const int mt = T - 1 - w.rank;  // the q tiles nearest the end have the longest rows
  const int m0 = mt * BM;
  // kv tiles up to the diagonal, none wholly past S.
  const int n_kv = min(2 * mt + 2, (S + BT - 1) / BT);

  if (threadIdx.x == 0) {
    mbar_init(qdo_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // Loads, issued by thread 0 alone: kv tile j into stage j % STAGES once
  // both warpgroups have released the tile held there.
  const bool loader = threadIdx.x == 0;
  auto load = [&](int j) {
    const int s = j % STAGES;
    mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
    mbar_expect_tx(&full[s], 2 * NB * SMALL_BOX_BYTES);
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      tma_load_3d(ks + (s * NB + b) * SMALL_BOX, &tmap_k, &full[s], b * BOX_COLS, j * BT, bh);
      tma_load_3d(vs + (s * NB + b) * SMALL_BOX, &tmap_v, &full[s], b * BOX_COLS, j * BT, bh);
    }
  };
  if (loader) {
    mbar_expect_tx(qdo_full, 2 * NB * BIG_BOX_BYTES);
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      tma_load_3d(qs + b * BIG_BOX, &tmap_q, qdo_full, b * BOX_COLS, m0, bh);
      tma_load_3d(dos + b * BIG_BOX, &tmap_do, qdo_full, b * BOX_COLS, m0, bh);
    }
    load(0);
  }

  // di = rowsum(o·do) in f32 for this CTA's rows, two threads per row, while
  // the tiles are in flight; written out for the dk/dv kernel.
  const size_t head = (size_t)bh * S;
  {
    const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
    const int row = m0 + r;
    float sum = 0.f;
    if (row < S) {
      const size_t at = (head + row) * HD + half * (HD / 2);
      const uint4* op = reinterpret_cast<const uint4*>(o + at);
      const uint4* dp = reinterpret_cast<const uint4*>(dout + at);
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
      l_s[r] = row < S ? lse[head + row] * LOG2E : INFINITY;
      if (row < S) di[head + row] = sum;
    }
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int t = lane % 4;
  const int lrow = warp * 16 + lane / 4;  // this thread's rows in its warpgroup: lrow, lrow + 8
  const float row_l[2] = {l_s[wg * 64 + lrow], l_s[wg * 64 + lrow + 8]};
  const float row_d[2] = {d_s[wg * 64 + lrow], d_s[wg * 64 + lrow + 8]};
  const bf16* qa = qs + wg * 64 * BOX_COLS;
  const bf16* doa = dos + wg * 64 * BOX_COLS;
  auto release = [&](int j) {
    if (lane == 0) mbar_arrive(&empty[j % STAGES]);
  };

  float s_acc[BT / 2], dp_acc[BT / 2], dq_acc[HD / 2];
  uint32_t ds_a[BT / 4];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dq_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BT / 2; ++i) s_acc[i] = dp_acc[i] = 0.f;

  // For kv tile j: mask, then P in s_acc (f32); then dS = P∘(dP − di) in
  // s_acc.  Key column c of the tile lies after row lrow (+ 8) when c + off
  // > lrow (+ 8): on the diagonal tile (2·mt + wg) and on warpgroup 0's tile
  // 2·mt + 1, which is wholly masked (its products run, P is 0).
  auto p_pass = [&](int j) {
    const int off = j * BT - (m0 + wg * 64);
#pragma unroll
    for (int jj = 0; jj < BT / 8; ++jj)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1;
        const float sv =
            8 * jj + 2 * t + (i & 1) + off > lrow + 8 * r ? -INFINITY : s_acc[4 * jj + i];
        s_acc[4 * jj + i] = exp2f(fmaf(sv, LOG2E, -row_l[r]));
      }
  };
  auto ds_pass = [&]() {
#pragma unroll
    for (int i = 0; i < BT / 2; ++i) s_acc[i] *= dp_acc[i] - row_d[(i >> 1) & 1];
  };
  // S and dP as two commit groups.
  auto issue_ss = [&](int j) {
    const int s = j % STAGES;
    ss_product<HD>(s_acc, qa, ks + s * NB * SMALL_BOX);
    wgmma_commit();
    ss_product<HD>(dp_acc, doa, vs + s * NB * SMALL_BOX);
    wgmma_commit();
  };
  auto issue_rs = [&](int j) {
    rs_product<HD>(dq_acc, ds_a, ks + (j % STAGES) * NB * SMALL_BOX);
  };

  // Step 0: S and dP of kv tile 0.
  mbar_wait(qdo_full, 0);
  mbar_wait(&full[0], 0);
  my_turn(wg, true);
  if (loader && n_kv > 1) load(1);
  __syncwarp();  // warp 0 whole again before the warpgroup-wide wgmma
  wgmma_fence();
  issue_ss(0);
  your_turn(wg, false);
  wgmma_wait<1>();
  fence_regs(s_acc);
  p_pass(0);
  wgmma_wait<0>();
  fence_regs(dp_acc);
  ds_pass();
  pack_all<BT>(ds_a, s_acc);

  // Step j: S and dP of tile j, with dQ += dS·K of tile j - 1 behind them.
  for (int j = 1; j < n_kv; ++j) {
    mbar_wait(&full[j % STAGES], (j / STAGES) & 1);
    my_turn(wg, false);
    if (loader && j + 1 < n_kv) load(j + 1);
    __syncwarp();
    wgmma_fence();
    issue_ss(j);
    issue_rs(j - 1);
    wgmma_commit();
    your_turn(wg, false);
    wgmma_wait<2>();  // S done; dP and dQ += dS·K may still run
    fence_regs(s_acc);
    p_pass(j);
    wgmma_wait<1>();  // dP done
    fence_regs(dp_acc);
    ds_pass();
    wgmma_wait<0>();
    fence_regs(dq_acc);
    fence_regs(ds_a);
    release(j - 1);
    pack_all<BT>(ds_a, s_acc);
  }

  // Step n_kv: dQ += dS·K of the last tile.
  my_turn(wg, false);
  wgmma_fence();
  issue_rs(n_kv - 1);
  wgmma_commit();
  your_turn(wg, true);
  wgmma_wait<0>();
  fence_regs(dq_acc);
  release(n_kv - 1);

  store_rows<HD>(dq + (head + m0 + wg * 64) * HD, dq_acc, lrow, S - m0 - wg * 64, t);
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
    attn_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tmap_k,
                        const __grid_constant__ CUtensorMap tmap_v,
                        const __grid_constant__ CUtensorMap tmap_q,
                        const __grid_constant__ CUtensorMap tmap_do, const float* __restrict__ lse,
                        const float* __restrict__ di, bf16* __restrict__ dk,
                        bf16* __restrict__ dv, int S) {
  constexpr int NB = HD / BOX_COLS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* ks = reinterpret_cast<bf16*>(base);
  bf16* vs = ks + NB * BIG_BOX;
  bf16* qs = vs + NB * BIG_BOX;
  bf16* dos = qs + STAGES * NB * SMALL_BOX;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(dos + STAGES * NB * SMALL_BOX);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;
  float* l_s = reinterpret_cast<float*>(empty + STAGES);  // [STAGES][64] lse of the q tile
  float* d_s = l_s + STAGES * BT;                          // [STAGES][64] di of the q tile

  const Work w = cta_work((S + BM - 1) / BM);
  const int bh = w.bh;
  const int n0 = w.rank * BM;  // the first kv tiles have the longest columns
  const int i0 = n0 / BT;          // the first q tile that sees these keys
  const int n_q = (S + BT - 1) / BT - i0;  // q tiles walked (>= 1: n0 < S)

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1 + 32);  // thread 0's bytes and warp 0's stats
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int lane = threadIdx.x % 32;
  const size_t head = (size_t)bh * S;
  // Loads, by warp 0: q tile i0 + u (its q and do rows by TMA from thread 0,
  // its lse and di by cp.async from every lane) into stage u % STAGES once
  // both warpgroups have released the tile held there.
  const bool loader = threadIdx.x < 32;
  auto load = [&](int u) {
    const int s = u % STAGES, q0 = (i0 + u) * BT;
    mbar_wait(&empty[s], ((u / STAGES) & 1) ^ 1);
    if (lane == 0) {
      mbar_expect_tx(&full[s], 2 * NB * SMALL_BOX_BYTES);
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        tma_load_3d(qs + (s * NB + b) * SMALL_BOX, &tmap_q, &full[s], b * BOX_COLS, q0, bh);
        tma_load_3d(dos + (s * NB + b) * SMALL_BOX, &tmap_do, &full[s], b * BOX_COLS, q0, bh);
      }
    }
#pragma unroll
    for (int e = 0; e < BT / 32; ++e) {
      const int c = lane + 32 * e, row = q0 + c;
      const bool in = row < S;
      cp_async_4(&l_s[s * BT + c], lse + head + (in ? row : 0), in);
      cp_async_4(&d_s[s * BT + c], di + head + (in ? row : 0), in);
    }
    cp_async_mbar_arrive(&full[s]);
  };
  if (loader) {
    if (lane == 0) {
      mbar_expect_tx(kv_full, 2 * NB * BIG_BOX_BYTES);
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        tma_load_3d(ks + b * BIG_BOX, &tmap_k, kv_full, b * BOX_COLS, n0, bh);
        tma_load_3d(vs + b * BIG_BOX, &tmap_v, kv_full, b * BOX_COLS, n0, bh);
      }
    }
    load(0);
  }

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int t = lane % 4;
  const int lrow = warp * 16 + lane / 4;  // this thread's kv rows in its warpgroup: lrow, lrow + 8
  const bf16* ka = ks + wg * 64 * BOX_COLS;
  const bf16* va = vs + wg * 64 * BOX_COLS;
  auto release = [&](int u) {
    if (lane == 0) mbar_arrive(&empty[u % STAGES]);
  };

  float s_acc[BT / 2], dp_acc[BT / 2], dk_acc[HD / 2], dv_acc[HD / 2];
  uint32_t p_a[BT / 4], ds_a[BT / 4];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BT / 2; ++i) s_acc[i] = dp_acc[i] = 0.f;

  // For q tile i0 + u: mask, then Pᵀ in s_acc (f32); then dSᵀ = Pᵀ∘(dPᵀ −
  // di) in dp_acc.  Query column c of the tile comes before key row lrow
  // (+ 8) when c + off < lrow (+ 8): on the diagonal tile (i0 + wg) and on
  // warpgroup 1's tile i0, which is wholly masked (its products run, Pᵀ is
  // 0).
  auto p_pass = [&](int u) {
    const int off = (u - wg) * BT;
    const float* lc = l_s + (u % STAGES) * BT;
#pragma unroll
    for (int jj = 0; jj < BT / 8; ++jj) {
      const float2 l2 = *reinterpret_cast<const float2*>(lc + 8 * jj + 2 * t);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = 8 * jj + 2 * t + (i & 1);
        const float sv = c + off < lrow + 8 * (i >> 1) ? -INFINITY : s_acc[4 * jj + i];
        s_acc[4 * jj + i] = exp2f((sv - ((i & 1) ? l2.y : l2.x)) * LOG2E);
      }
    }
  };
  auto ds_pass = [&](int u) {
    const float* dc = d_s + (u % STAGES) * BT;
#pragma unroll
    for (int jj = 0; jj < BT / 8; ++jj) {
      const float2 d2 = *reinterpret_cast<const float2*>(dc + 8 * jj + 2 * t);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        dp_acc[4 * jj + i] = s_acc[4 * jj + i] * (dp_acc[4 * jj + i] - ((i & 1) ? d2.y : d2.x));
    }
  };
  auto pack = [&]() {
    pack_all<BT>(p_a, s_acc);
    pack_all<BT>(ds_a, dp_acc);
  };
  // Sᵀ and dPᵀ as two commit groups.
  auto issue_ss = [&](int u) {
    const int s = u % STAGES;
    ss_product<HD>(s_acc, ka, qs + s * NB * SMALL_BOX);
    wgmma_commit();
    ss_product<HD>(dp_acc, va, dos + s * NB * SMALL_BOX);
    wgmma_commit();
  };
  auto issue_rs = [&](int u) {
    const int s = u % STAGES;
    rs_product<HD>(dv_acc, p_a, dos + s * NB * SMALL_BOX);
    rs_product<HD>(dk_acc, ds_a, qs + s * NB * SMALL_BOX);
  };

  // Step u: Sᵀ and dPᵀ of q tile i0 + u in this warpgroup's turn, then its
  // elementwise pass, then dV += Pᵀ·dO and dK += dSᵀ·Q issued at once; they
  // run while the warpgroup waits for its next turn.  Keeping them out of
  // the turn's products keeps Pᵀ, dSᵀ (packed) and Sᵀ, dPᵀ (f32) from being
  // live together beside dK and dV, which spilled at 255 registers.
  mbar_wait(kv_full, 0);
  for (int u = 0; u < n_q; ++u) {
    mbar_wait(&full[u % STAGES], (u / STAGES) & 1);
    wgmma_wait<0>();  // the RS products of tile u - 1
    fence_regs(dk_acc);
    fence_regs(dv_acc);
    fence_regs(p_a);
    fence_regs(ds_a);
    if (u > 0) release(u - 1);
    my_turn(wg, u == 0);
    if (loader && u + 1 < n_q) load(u + 1);
    __syncwarp();  // warp 0 whole again before the warpgroup-wide wgmma
    wgmma_fence();
    issue_ss(u);
    your_turn(wg, u == n_q - 1);
    wgmma_wait<1>();  // Sᵀ done, dPᵀ may still run
    fence_regs(s_acc);
    p_pass(u);
    wgmma_wait<0>();
    fence_regs(dp_acc);
    ds_pass(u);
    pack();
    wgmma_fence();
    issue_rs(u);
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_regs(dk_acc);
  fence_regs(dv_acc);
  release(n_q - 1);

  const int r0 = n0 + wg * 64;
  store_rows<HD>(dk + (head + r0) * HD, dk_acc, lrow, S - r0, t);
  store_rows<HD>(dv + (head + r0) * HD, dv_acc, lrow, S - r0, t);
}

// A 3-D tensor map over a [BH, S, HD] bf16 tensor, boxes of `rows` x 64.
template <int HD>
int head_map(CUtensorMap* map, const void* base, int BH, int S, int rows) {
  const uint64_t dims[3] = {(uint64_t)HD, (uint64_t)S, (uint64_t)BH};
  const uint64_t strides[2] = {(uint64_t)HD * sizeof(bf16), (uint64_t)S * HD * sizeof(bf16)};
  const uint32_t box[3] = {BOX_COLS, (uint32_t)rows, 1};
  return hopper_host::make_map(map, base, 3, dims, strides, box);
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* o, const void* lse,
           const void* dout, void* dq, void* dk, void* dv, void* di, int BH, int S,
           cudaStream_t stream) {
  // dq walks 64-row kv tiles past its own 128 q rows; dk/dv the other way.
  CUtensorMap q_big, do_big, k_small, v_small, k_big, v_big, q_small, do_small;
  const struct {
    CUtensorMap* map;
    const void* base;
    int rows;
  } maps[8] = {{&q_big, q, BM},   {&do_big, dout, BM}, {&k_small, k, BT}, {&v_small, v, BT},
               {&k_big, k, BM},   {&v_big, v, BM},     {&q_small, q, BT}, {&do_small, dout, BT}};
  for (const auto& m : maps) {
    int err = head_map<HD>(m.map, m.base, BH, S, m.rows);
    if (err) return err;
  }
  constexpr int smem_dq = smem_bytes<HD>(2 * BM);
  constexpr int smem_dkv = smem_bytes<HD>(2 * STAGES * BT);
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_dq_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dq);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(attn_bwd_dkv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_dkv);
  if (err != cudaSuccess) return (int)err;
  const int grid = BH * ((S + BM - 1) / BM);  // cta_work
  attn_bwd_dq_kernel<HD><<<grid, THREADS, smem_dq, stream>>>(
      q_big, do_big, k_small, v_small, static_cast<const bf16*>(o),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse), static_cast<bf16*>(dq),
      static_cast<float*>(di), S);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dkv_kernel<HD><<<grid, THREADS, smem_dkv, stream>>>(
      k_big, v_big, q_small, do_small, static_cast<const float*>(lse),
      static_cast<const float*>(di), static_cast<bf16*>(dk), static_cast<bf16*>(dv), S);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o, do and dq, dk, dv [BH, S, hd] bf16; lse and the scratch di
// [BH, S] f32; all contiguous and 16-byte aligned on one device, hd 64 or
// 128.  Launches the dq kernel (which writes di) and then the dk/dv kernel
// on `stream`, allocates nothing, does not synchronise; returns a
// cudaError_t value (cudaGetLastError() after the launches).
extern "C" int tpudra_attn_bwd(const void* q, const void* k, const void* v, const void* o,
                               const void* lse, const void* dout, void* dq, void* dk, void* dv,
                               void* di, int BH, int S, int hd, void* stream) {
  if (BH <= 0 || BH > 65535 || S <= 0 || (int64_t)BH * ((S + BM - 1) / BM) > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 64) return launch<64>(q, k, v, o, lse, dout, dq, dk, dv, di, BH, S, st);
  if (hd == 128) return launch<128>(q, k, v, o, lse, dout, dq, dk, dv, di, BH, S, st);
  return (int)cudaErrorInvalidValue;
}
