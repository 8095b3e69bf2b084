// Fused cross-entropy forward for Hopper (sm_90a): per row of x, the
// logsumexp of x·Eᵀ over the whole vocabulary and the target's logit, with
// the [N, V] logits never written to device memory.
//
// Replaces: tpudra/workload/ce_kernel.py::_fwd_kernel, launched by
// _fwd_pallas (the Pallas online-softmax kernel of the fused CE head).
//
// What bounds it on an H100: the logits product, 2·N·D·V operations
// (2.2 TFLOP at the flagship N = 16368, D = 2048, V = 32768, 2.2 ms at
// 989 TFLOP/s), against about 0.2 GB of operands, so the tensor cores and
// not the memory are the limit.
//
// Design (warp-specialised, TMA + mbarrier ring + wgmma; hopper.cuh):
//   - A CTA owns a tile of BM = 128 rows of x and a chunk of CHUNK = 4096
//     vocab columns.  Warpgroups 0 and 1 each own 64 of the rows; warpgroup 2
//     is the producer: one thread keeps a STAGES-deep ring of [128 x 64] x
//     slices and [256 x 64] E slices in flight with TMA (128B-swizzled boxes),
//     each stage completed by an mbarrier's transaction count and released by
//     the eight consumer warps.  A 384-thread CTA gives every thread 168
//     registers; a consumer's 128-register accumulator and its row state fit
//     them (ptxas: no spills).
//   - Each consumer warpgroup runs wgmma m64n256k16 (both operands in shared
//     memory) into a [64 x 256] f32 accumulator, 128 registers a thread, over
//     the depth D, then folds the finished tile into its rows' running max,
//     sum and target logit straight from the accumulator registers: quad
//     shuffles, exp2 with log2e folded into one fma, no shared-memory round
//     trip and no CTA barrier.  The two warpgroups run unsynchronised, so
//     one's fold overlaps the other's products.
//   - L2 traffic.  A CTA re-reads its x rows (512 KB at D = 2048) once per
//     vocab tile.  Had each CTA walked the whole vocabulary, 128 resident
//     CTAs would cycle through all of x (67 MB, more than the 50 MB L2) once
//     per vocab tile, from device memory: ~8.6 GB a call.  So the vocabulary
//     is split into chunks and CTAs are launched in groups of GROUP row tiles
//     x all chunks: the ~132 resident CTAs share 16 row tiles of x (8 MB,
//     held in L2) and each E slice is read by the 16 CTAs of its chunk at
//     about the same time.  E then comes from device memory once per group
//     (8 times at N = 16368, ~1.1 GB), x about once.
//   - Each CTA writes its chunk's partial (max, sum relative to it, target
//     logit or 0) per row to an f32 scratch [3, chunks, N] that the wrapper
//     allocates; a second, small kernel combines the chunks of each row in a
//     fixed order, so the result is deterministic.
// Ragged edges: TMA zero-fills rows >= N, vocab rows >= V and depth >= D;
// vocab columns >= V are masked to -inf in the last tile (a zero logit would
// count), rows >= N are not stored.  Any N and V; D must be a multiple of 8
// (TMA strides are multiples of 16 bytes); the wrapper checks it.

#include <math.h>

#include "hopper.cuh"

using namespace hopper;

namespace {

constexpr int BM = 128;             // rows of x per CTA (2 consumer warpgroups x 64)
constexpr int BV = 256;             // vocab columns per logits tile (wgmma N)
constexpr int BK = 64;              // depth per staged slice (one 128-byte box row)
constexpr int STAGES = 4;
constexpr int TILES_PER_CHUNK = 16;  // vocab tiles per CTA: CHUNK = 4096 columns
constexpr int GROUP = 16;           // row tiles launched together (L2 reuse of x)
constexpr int THREADS = 384;        // 2 consumer warpgroups + 1 producer warpgroup
constexpr int CONSUMER_WARPS = 8;
constexpr int X_TILE = BM * BK;     // bf16 elements per x slice (16 KB)
constexpr int E_TILE = BV * BK;     // bf16 elements per E slice (32 KB)
constexpr uint32_t STAGE_BYTES = (X_TILE + E_TILE) * sizeof(bf16);
constexpr int SMEM_BYTES = 1024 /* alignment slack */ + STAGES * (int)STAGE_BYTES +
                           2 * STAGES * (int)sizeof(uint64_t);

int n_chunks(int V) {
  const int n_vt = (V + BV - 1) / BV;
  return (n_vt + TILES_PER_CHUNK - 1) / TILES_PER_CHUNK;
}

__global__ void __launch_bounds__(THREADS, 1)
    ce_fwd_kernel(const __grid_constant__ CUtensorMap tmap_x,
                  const __grid_constant__ CUtensorMap tmap_e, const int32_t* __restrict__ targets,
                  float* __restrict__ part, int N, int V, int D, int n_rb, int nvc) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* xs = reinterpret_cast<bf16*>(base);
  bf16* es = xs + STAGES * X_TILE;
  uint64_t* full = reinterpret_cast<uint64_t*>(es + STAGES * E_TILE);
  uint64_t* empty = full + STAGES;

  // Launch order: groups of GROUP row tiles; inside a group, chunk-major.
  const int per_group = GROUP * nvc;
  const int group = blockIdx.x / per_group;
  const int first_rb = group * GROUP;
  const int rows_in_group = min(GROUP, n_rb - first_rb);
  const int r_in = blockIdx.x - group * per_group;
  const int vc = r_in / rows_in_group;
  const int rb = first_rb + r_in % rows_in_group;
  const int n_vt = (V + BV - 1) / BV;
  const int vt0 = vc * TILES_PER_CHUNK;
  const int vt1 = min(n_vt, vt0 + TILES_PER_CHUNK);
  const int n_k = (D + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ---- producer warpgroup: one thread issues every load ----
    if (threadIdx.x == 256) {
      int it = 0;
      for (int vt = vt0; vt < vt1; ++vt) {
        for (int kc = 0; kc < n_k; ++kc, ++it) {
          const int s = it % STAGES;
          mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(&full[s], STAGE_BYTES);
          tma_load_2d(xs + s * X_TILE, &tmap_x, &full[s], kc * BK, rb * BM);
          tma_load_2d(es + s * E_TILE, &tmap_e, &full[s], kc * BK, vt * BV);
        }
      }
    }
  } else {
    // ---- consumer warpgroups ----
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int t = lane % 4;
    int rows[2], tgt[2];
    rows[0] = rb * BM + wg * 64 + warp * 16 + lane / 4;
    rows[1] = rows[0] + 8;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int v = rows[r] < N ? targets[rows[r]] : -1;
      tgt[r] = (v >= 0 && v < V) ? v : -1;  // a target outside [0, V) has logit 0
    }
    float run_max[2] = {-INFINITY, -INFINITY}, run_sum[2] = {0.f, 0.f}, tlog[2] = {0.f, 0.f};
    float acc[BV / 2];
#pragma unroll
    for (int i = 0; i < BV / 2; ++i) acc[i] = 0.f;  // defined before the first product

    int it = 0;
    for (int vt = vt0; vt < vt1; ++vt) {
      for (int kc = 0; kc < n_k; ++kc, ++it) {
        const int s = it % STAGES;
        mbar_wait(&full[s], (it / STAGES) & 1);
        const bf16* xa = xs + s * X_TILE + wg * 64 * BK;
        const bf16* eb = es + s * E_TILE;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_ss_n256(acc, desc_kmajor(xa + kk * 16), desc_kmajor(eb + kk * 16),
                        (kc | kk) != 0);
        wgmma_commit();
        if (kc > 0) {  // the previous slice's products are done: free its stage
          wgmma_wait<1>();
          if (lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
        }
      }
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
      fence_regs(acc);

      // Fold the [64 x 256] tile into each row's running max, sum and target.
      const int v0 = vt * BV;
      if (v0 + BV > V) {
#pragma unroll
        for (int j = 0; j < BV / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (v0 + 8 * j + 2 * t + e >= V) acc[4 * j + e] = acc[4 * j + 2 + e] = -INFINITY;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < BV / 8; ++j)
          mx = fmaxf(mx, fmaxf(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]));
        const float new_max = fmaxf(run_max[r], quad_max(mx));  // finite: column v0 is valid
        const float ref = new_max * LOG2E;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < BV / 8; ++j)
          sum += exp2f(fmaf(acc[4 * j + 2 * r], LOG2E, -ref)) +
                 exp2f(fmaf(acc[4 * j + 2 * r + 1], LOG2E, -ref));
        run_sum[r] = run_sum[r] * exp2f(fmaf(run_max[r], LOG2E, -ref)) + sum;
        run_max[r] = new_max;
        const int local = tgt[r] - v0;  // the lane that holds column `local` picks it
        if (local >= 0 && local < BV && ((local >> 1) & 3) == t) {
          const int jj = local >> 3, odd = local & 1;
#pragma unroll
          for (int j = 0; j < BV / 8; ++j)
            if (j == jj) tlog[r] = odd ? acc[4 * j + 2 * r + 1] : acc[4 * j + 2 * r];
        }
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float s = quad_sum(run_sum[r]);
      const float tl = quad_sum(tlog[r]);
      if (t == 0 && rows[r] < N) {
        part[(size_t)vc * N + rows[r]] = run_max[r];
        part[(size_t)(nvc + vc) * N + rows[r]] = s;
        part[(size_t)(2 * nvc + vc) * N + rows[r]] = tl;
      }
    }
  }
}

// Per row, the chunks' partials in chunk order: lse = M + log Σ s_c·e^(m_c−M).
__global__ void ce_combine_kernel(const float* __restrict__ part, float* __restrict__ lse,
                                  float* __restrict__ tlog, int N, int nvc) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= N) return;
  float m = -INFINITY;
  for (int c = 0; c < nvc; ++c) m = fmaxf(m, part[(size_t)c * N + row]);
  float s = 0.f, t = 0.f;
  for (int c = 0; c < nvc; ++c) {
    s += part[(size_t)(nvc + c) * N + row] * expf(part[(size_t)c * N + row] - m);
    t += part[(size_t)(2 * nvc + c) * N + row];
  }
  lse[row] = m + logf(s);
  tlog[row] = t;
}

}  // namespace

// f32 elements of the scratch tpudra_ce_fwd needs for N rows and V columns.
extern "C" long long tpudra_ce_fwd_scratch_floats(int N, int V) {
  return 3LL * n_chunks(V) * N;
}

// x [N, D] bf16, e [V, D] bf16, targets [N] int32 -> lse [N] f32, tlog [N]
// f32 (0 for a target outside [0, V)); scratch: tpudra_ce_fwd_scratch_floats
// f32.  All contiguous and 16-byte aligned on one device.  Launches on
// `stream`, allocates nothing, does not synchronise; returns a cudaError_t
// value (the launches' cudaGetLastError()).
extern "C" int tpudra_ce_fwd(const void* x, const void* e, const void* targets, void* lse,
                             void* tlog, void* scratch, int N, int V, int D, void* stream) {
  if (N <= 0 || V <= 0 || D <= 0 || D % 8 != 0) return (int)cudaErrorInvalidValue;
  CUtensorMap tmap_x, tmap_e;
  const uint64_t row_bytes[1] = {(uint64_t)D * sizeof(bf16)};
  const uint64_t x_dims[2] = {(uint64_t)D, (uint64_t)N};
  const uint64_t e_dims[2] = {(uint64_t)D, (uint64_t)V};
  const uint32_t x_box[2] = {BK, BM};
  const uint32_t e_box[2] = {BK, BV};
  int err = hopper_host::make_map(&tmap_x, x, 2, x_dims, row_bytes, x_box);
  if (err) return err;
  err = hopper_host::make_map(&tmap_e, e, 2, e_dims, row_bytes, e_box);
  if (err) return err;
  cudaError_t cerr =
      cudaFuncSetAttribute(ce_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (cerr != cudaSuccess) return (int)cerr;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_rb = (N + BM - 1) / BM;
  const int nvc = n_chunks(V);
  float* part = static_cast<float*>(scratch);
  ce_fwd_kernel<<<n_rb * nvc, THREADS, SMEM_BYTES, st>>>(
      tmap_x, tmap_e, static_cast<const int32_t*>(targets), part, N, V, D, n_rb, nvc);
  cerr = cudaGetLastError();
  if (cerr != cudaSuccess) return (int)cerr;
  ce_combine_kernel<<<(N + 255) / 256, 256, 0, st>>>(part, static_cast<float*>(lse),
                                                      static_cast<float*>(tlog), N, nvc);
  return (int)cudaGetLastError();
}
