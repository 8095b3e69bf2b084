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
// products are 4·B·H·S(S+1)/2·hd = 68.8 GFLOP (0.070 ms at 989 TFLOP/s)
// against 269.5 MB of q, k, v, o and lse (0.080 ms at 3.35 TB/s): near the
// ridge, so both the tensor cores and the memory traffic matter; at seq 8192
// the products dominate.
//
// Design (FA3's forward, warp-specialised; hopper.cuh):
//   - A CTA owns a 128-row q tile of one (batch, head) and walks the kv tiles
//     of BN = 128 rows from the first to the diagonal; tiles above it are
//     skipped, only the diagonal one is masked.  Tiles are launched longest
//     rows first (the q tiles nearest the end of the sequence).
//   - Thread 0 loads Q once and streams K and V tiles through a
//     three-stage ring with TMA, with their own full and empty mbarriers so
//     that Q·Kᵀ can start before V has arrived; it issues the loads for the
//     next tile at the start of its own warpgroup's turn (below), when the
//     stages they go to are free.  The
//     tensor map is 3-D over [BH, S, hd]: a tile that runs past S gets TMA's
//     zeros, not the next head's rows.  At hd 128 a row (256 bytes) is two
//     128B-swizzled boxes of 64 columns; the wgmma descriptors step across
//     them (hopper.cuh).
//   - Warpgroups 0 and 1 own 64 q rows each.  S = Q·Kᵀ by wgmma with both
//     operands in shared memory; the online softmax runs on the accumulator
//     registers (quad shuffles); P is rounded to bf16 in registers and fed as
//     wgmma's register A operand for O += P·V, with V read MN-major from
//     shared memory (the transpose-B flag).  Rounding P is the one departure
//     from splash's math (splash keeps P in f32 and upcasts v); the tolerance
//     in chip_smoke.py covers it.
//   - Overlap: each warpgroup issues tile j's Q·Kᵀ and tile j−1's P·V
//     together and runs tile j's softmax while P·V is in flight; and the two
//     warpgroups take turns to issue (named barriers 1 and 2, a ping-pong),
//     so one's softmax runs under the other's products.
// Ragged S: rows and keys >= S come in as zeros; a key >= S only ever sits
// after a valid query, so the causal mask drops it, and rows >= S are not
// stored.  Any S >= 1 is taken.

#include <math.h>

#include "hopper.cuh"

using namespace hopper;

namespace {

constexpr int BM = 128;  // q rows per CTA (2 consumer warpgroups x 64)
constexpr int BN = 128;  // kv rows per tile (equal to BM: the diagonal tile is the last)
constexpr int STAGES = 3;
// Two warpgroups, both consumers; thread 0 also issues the loads.  A third
// (producer) warpgroup makes the launch reserve registers for 384 threads,
// and ptxas then compiles every thread against 168 (setmaxnreg does not lift
// that at compile time): the consumers, which hold S and O (64 + 64 f32) and
// P (32) at once at hd 128, spill there and their products are serialised.
// At 256 threads they get the ~200 registers they need.
constexpr int THREADS = 256;
constexpr int CONSUMER_WARPS = 8;
constexpr int BOX_ELEMS = 128 * BOX_COLS;  // one [128 x 64] box, 16 KB
constexpr uint32_t BOX_BYTES = BOX_ELEMS * sizeof(bf16);

template <int HD>
constexpr int fwd_smem_bytes() {
  return 1024 /* alignment slack */ + (1 + 2 * STAGES) * (HD / BOX_COLS) * (int)BOX_BYTES +
         (1 + 4 * STAGES) * (int)sizeof(uint64_t);
}

// s[64] = Q·Kᵀ for this warpgroup's 64 rows; q at its first row in box 0,
// k at the stage's box 0.
template <int HD>
__device__ __forceinline__ void qk_product(float* s, const bf16* q, const bf16* k) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int off = (kk / 4) * BOX_ELEMS + (kk % 4) * 16;
    wgmma_ss_n128(s, desc_kmajor(q + off), desc_kmajor(k + off), kk > 0);
  }
}

// o += P·V; p holds P as bf16 A operands (4 per 16 keys), v the stage's box 0.
template <int HD>
__device__ __forceinline__ void pv_product(float* o, const uint32_t* p, const bf16* v) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    const uint64_t desc = desc_mnmajor(v + kk * 16 * BOX_COLS, BOX_BYTES);
    if constexpr (HD == 128) {
      wgmma_rs_n128_mn(o, p + 4 * kk, desc, 1);
    } else {
      wgmma_rs_n64_mn(o, p + 4 * kk, desc, 1);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
    attn_fwd_kernel(const __grid_constant__ CUtensorMap tmap_q,
                    const __grid_constant__ CUtensorMap tmap_k,
                    const __grid_constant__ CUtensorMap tmap_v, bf16* __restrict__ o,
                    float* __restrict__ lse, int S) {
  constexpr int NB = HD / BOX_COLS;  // boxes per row of a tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* qs = reinterpret_cast<bf16*>(base);
  bf16* ks = qs + NB * BOX_ELEMS;
  bf16* vs = ks + STAGES * NB * BOX_ELEMS;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + STAGES * NB * BOX_ELEMS);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* k_empty = v_full + STAGES;
  uint64_t* v_empty = k_empty + STAGES;

  const int bh = blockIdx.x;
  const int mt = gridDim.y - 1 - blockIdx.y;  // the longest rows first
  const int m0 = mt * BM;
  const int n_kv = mt + 1;                    // kv tiles up to the diagonal (BN == BM)

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], CONSUMER_WARPS);
      mbar_init(&v_empty[s], CONSUMER_WARPS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // Loads, issued by thread 0 alone: tile j's K (or V) rows into stage
  // j % STAGES once both warpgroups have released the tile held there.
  const bool loader = threadIdx.x == 0;
  auto load = [&](const CUtensorMap* map, bf16* tiles, uint64_t* full, uint64_t* empty, int j) {
    const int s = j % STAGES;
    mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
    mbar_expect_tx(&full[s], NB * BOX_BYTES);
#pragma unroll
    for (int b = 0; b < NB; ++b)
      tma_load_3d(tiles + (s * NB + b) * BOX_ELEMS, map, &full[s], b * BOX_COLS, j * BN, bh);
  };
  if (loader) {
    mbar_expect_tx(q_full, NB * BOX_BYTES);
#pragma unroll
    for (int b = 0; b < NB; ++b) tma_load_3d(qs + b * BOX_ELEMS, &tmap_q, q_full, b * BOX_COLS, m0, bh);
    load(&tmap_k, ks, k_full, k_empty, 0);
  }

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int t = lane % 4;
  const int row0 = wg * 64 + warp * 16 + lane / 4;  // this thread's rows: row0, row0 + 8 (of the tile)
  const bf16* qa = qs + wg * 64 * BOX_COLS;

  // Ping-pong: warpgroup w waits on barrier 1 + w before it issues
  // products and then lets the other one go.  Both walk n_kv + 1 issue
  // blocks; warpgroup 0 does not wait before its first, warpgroup 1 does
  // not signal after its last, so every barrier phase gets 256 threads.
  auto my_turn = [&](bool first) {
    if (!(wg == 0 && first)) bar_sync(1 + wg, 256);
  };
  auto your_turn = [&](bool last) {
    if (!(wg == 1 && last)) bar_arrive(2 - wg, 256);
  };
  auto release = [&](uint64_t* bar) {
    if (lane == 0) mbar_arrive(bar);
  };

  float s_acc[BN / 2];
  float o_acc[HD / 2];
  uint32_t p_a[BN / 4];
  float run_max[2] = {-INFINITY, -INFINITY}, run_sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) s_acc[i] = 0.f;

  // Mask (on the diagonal tile), then the online softmax of s_acc: s_acc
  // becomes P relative to the new row max; scale[r] is what rescales the
  // rows' earlier sums and outputs.
  auto softmax = [&](bool diagonal, float* scale) {
    if (diagonal) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (8 * j + 2 * t + (i & 1) > row0 + 8 * (i >> 1)) s_acc[4 * j + i] = -INFINITY;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
        mx = fmaxf(mx, fmaxf(s_acc[4 * j + 2 * r], s_acc[4 * j + 2 * r + 1]));
      // Finite: key 0 of the first tile precedes every row.
      const float new_max = fmaxf(run_max[r], quad_max(mx));
      const float ref = new_max * LOG2E;
      scale[r] = exp2f(fmaf(run_max[r], LOG2E, -ref));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(fmaf(s_acc[4 * j + 2 * r + e], LOG2E, -ref));
          s_acc[4 * j + 2 * r + e] = p;
          sum += p;
        }
      run_sum[r] = run_sum[r] * scale[r] + sum;
      run_max[r] = new_max;
    }
  };
  auto pack_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) pack_a(p_a + 4 * kk, s_acc + 8 * kk);
  };
  float scale[2];

  // Block j (of n_kv + 1) starts by loading K of tile j + 1 and V of tile
  // j.  Their stages held tiles j - 2 and j - 3, which both warpgroups have
  // released: the other warpgroup's turn of block j - 1 came after its
  // block j - 2 was done.

  // Block 0: S of tile 0.
  mbar_wait(q_full, 0);
  mbar_wait(&k_full[0], 0);
  my_turn(true);
  if (loader) {
    if (n_kv > 1) load(&tmap_k, ks, k_full, k_empty, 1);
    load(&tmap_v, vs, v_full, v_empty, 0);
  }
  __syncwarp();  // warp 0 whole again before the warpgroup-wide wgmma
  wgmma_fence();
  qk_product<HD>(s_acc, qa, ks);
  wgmma_commit();
  your_turn(false);
  wgmma_wait<0>();
  fence_regs(s_acc);
  release(&k_empty[0]);
  softmax(n_kv == 1, scale);
  pack_p();

  // Block j: S of tile j with P·V of tile j - 1 behind it.
  for (int j = 1; j < n_kv; ++j) {
    const int s = j % STAGES, sp = (j - 1) % STAGES;
    mbar_wait(&k_full[s], (j / STAGES) & 1);
    my_turn(false);
    if (loader) {
      if (j + 1 < n_kv) load(&tmap_k, ks, k_full, k_empty, j + 1);
      load(&tmap_v, vs, v_full, v_empty, j);
    }
    __syncwarp();
    wgmma_fence();
    qk_product<HD>(s_acc, qa, ks + s * NB * BOX_ELEMS);
    wgmma_commit();
    mbar_wait(&v_full[sp], ((j - 1) / STAGES) & 1);
    pv_product<HD>(o_acc, p_a, vs + sp * NB * BOX_ELEMS);
    wgmma_commit();
    your_turn(false);
    wgmma_wait<1>();  // S done, P·V may still run
    fence_regs(s_acc);
    release(&k_empty[s]);
    softmax(j == n_kv - 1, scale);
    wgmma_wait<0>();
    fence_regs(o_acc);
    fence_regs(p_a);
    release(&v_empty[sp]);
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o_acc[i] *= scale[(i >> 1) & 1];
    pack_p();
  }

  // Block n_kv: P·V of the last tile.
  {
    const int sp = (n_kv - 1) % STAGES;
    mbar_wait(&v_full[sp], ((n_kv - 1) / STAGES) & 1);
    my_turn(false);
    wgmma_fence();
    pv_product<HD>(o_acc, p_a, vs + sp * NB * BOX_ELEMS);
    wgmma_commit();
    your_turn(true);
    wgmma_wait<0>();
    fence_regs(o_acc);
    release(&v_empty[sp]);
  }

  const size_t head = (size_t)bh * S;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + row0 + 8 * r;
    const float l = quad_sum(run_sum[r]);
    if (row >= S) continue;
    const float inv = 1.f / l;
    bf16* orow = o + (head + row) * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * t) =
          __floats2bfloat162_rn(o_acc[4 * j + 2 * r] * inv, o_acc[4 * j + 2 * r + 1] * inv);
    if (t == 0) lse[head + row] = run_max[r] + logf(l);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int BH, int S,
           cudaStream_t stream) {
  CUtensorMap maps[3];
  const uint64_t dims[3] = {(uint64_t)HD, (uint64_t)S, (uint64_t)BH};
  const uint64_t strides[2] = {(uint64_t)HD * sizeof(bf16), (uint64_t)S * HD * sizeof(bf16)};
  const uint32_t box[3] = {BOX_COLS, 128, 1};
  const void* bases[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    int err = hopper_host::make_map(&maps[i], bases[i], 3, dims, strides, box);
    if (err) return err;
  }
  constexpr int smem = fwd_smem_bytes<HD>();
  cudaError_t err =
      cudaFuncSetAttribute(attn_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(BH, (S + BM - 1) / BM);
  attn_fwd_kernel<HD><<<grid, THREADS, smem, stream>>>(
      maps[0], maps[1], maps[2], static_cast<bf16*>(o), static_cast<float*>(lse), S);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o [BH, S, hd] bf16 and lse [BH, S] f32, contiguous and 16-byte
// aligned on one device; hd 64 or 128.  Launches on `stream`, allocates
// nothing, does not synchronise; returns a cudaError_t value (the launch's
// cudaGetLastError()).
extern "C" int tpudra_attn_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                               int BH, int S, int hd, void* stream) {
  if (BH <= 0 || BH > 65535 || S <= 0 || (S + BM - 1) / BM > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 64) return launch<64>(q, k, v, o, lse, BH, S, st);
  if (hd == 128) return launch<128>(q, k, v, o, lse, BH, S, st);
  return (int)cudaErrorInvalidValue;
}
