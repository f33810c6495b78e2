// Fused AIS distribution updates: the elite / weighted covariance refit with
// shrinkage, jitter and Cholesky, and the CMA-ES tail.
//
// Replaces the Pallas TPU kernels of mpopis_tpu/kernels/ais_update.py, which
// the JAX package runs behind MPOPIS_FUSED_UPDATE=1:
// - _masked_refit_kernel (:192) and _weighted_refit_kernel (:219), both
//   launched at :265 by _refit_call: L = chol(jitter(estimate)) of the masked
//   elite columns of E (CEMPPI, five estimators) or of the probability-
//   weighted columns (muSigma-AIS, and PMC with its K/(K-1) correction). The
//   two share one call site and one finalize step, and here one kernel.
// - _cma_kernel (:329), launched at :471 by cma_update_chol: Sigma^-1/2 by 20
//   coupled Newton-Schulz steps, the evolution paths, the guarded step size,
//   h_sigma, the scalar rank-mu term over K, the symmetrization from the upper
//   triangle, jitter and sigma * chol.
//
// Design
// - Refit (refit_cluster_kernel): one launch of a cluster of 16 blocks of
//   384 threads (a card that cannot schedule it fails the launch). Each
//   block ballots the K mask entries or weights 32 at a time and lists its
//   equal share of the columns that count, in ascending order: the m elite
//   columns of CEMPPI's mask, the nonzero weights of PMC's counts (~63% of
//   K), every column of muSigma-AIS's weights. It gathers them 32 at a time
//   into registers (a lane a column, coalesced where the columns are
//   dense), centres them and stores them into one of two stages in shared
//   memory, the next chunk's loads in flight over this chunk's products.
//   Only the lower triangle of A = Xl Xr^T (and, lw/ss, B = (Xl o Xl)
//   (Xr o Xr)^T) is summed, in register tiles: 8 x 8 where only A is
//   (four 16-byte loads of a column for 64 multiply-adds, where the kernel
//   pair before took two loads for one), 4 x 4 where B is too, with up to 8
//   column groups per tile where the tiles leave threads idle, their
//   accumulators in registers over all chunks and added in group order.
//   A cluster barrier; each block sums a slice of the tiles over the 16
//   partials in rank order (distributed shared memory; no atomics, so
//   double repeats bit for bit), writes it into block 0's factor buffer and
//   its part of the estimator's two sums into block 0's slots. A second
//   barrier; block 0 alone forms the estimate and its jitter in place (the
//   per-entry math of refit_math.cuh, which the host check builds with
//   g++) and factors it with block_linalg.cuh at 384 threads, where the
//   diagonal blocks do not spill. Partials and factor sit in shared memory
//   where they fit (n = 100 both dtypes, 136 in float), else in global
//   scratch and the output (n = 136 in double: A and B alone are 296 KB).
//   The TPU kernel's 2048-column chunking and zero padding existed for
//   VMEM; its masked columns are multiplied by zero, here they are skipped.
// - CMA (cma_cluster_kernel): a cluster of 16 blocks of 416 threads (a
//   card that cannot schedule it fails the launch). Block r owns a band of rows of the
//   Newton-Schulz matrices y, z and t. Each of the 20 steps is two stages,
//   each ended by one cluster barrier: t = 1.5 I - 0.5 z y, then y t and t z
//   together (where the one-block kernel before ran three products behind
//   three barriers). A stage copies the whole right operand from L2 into
//   shared memory (each block writes its band's rows of the whole matrices
//   to global memory as it computes them) and multiplies its band in
//   register tiles of four rows of a column: a 16-byte broadcast load of
//   the left rows and one load of the right column for four multiply-adds,
//   where the one-output-per-thread products made two loads per
//   multiply-add. Each output's sum runs over q in ascending order, as
//   before. Block 0 then runs the tail and the Cholesky alone, at 416
//   threads (128 registers a thread where the one-block kernel had 64). n
//   that no cluster holds in shared memory (two ld x ld staging matrices and
//   five bands: n > 152 in float, n > 108 in double) run on one block of
//   1024 threads from global scratch (cma_block_kernel), one output entry
//   per thread and step. Full precision, no tensor cores.
//
// What bounds them on an H100: at the headline (n = 100, K = 8192, m =
// 1638) the masked `ss` refit's moments over the elite columns are 2 x
// 5050 x 1638 multiply-adds (33 MFLOP, ~0.5 us at the 67 TFLOP/s float
// peak), the weighted refit's 5050 x 8192 (83 MFLOP), against 3.3 MB of E
// read (~1 us at 3.35 TB/s): bound by bytes, but on 16 SMs the weighted
// moments take ~11 us of their multiply-adds alone, and block 0's factor is
// a latency-bound chain on one SM. Measured (f32, device-only; H100 80GB
// HBM3, 700 W): ss 0.056, mle 0.051, weighted 0.082 ms (the kernel pair
// before: 0.098 / 0.082 / 0.084), of which ~35 us are fixed (the factor
// 21.7 us at 384 threads, the cluster reduction 5-9, the compaction 3.7,
// the estimate 3-4) and the moments run at ~30% of 16 SMs' multiply-add
// rate (scripts/refit_phase_times.py splits the time). The CMA tail's 60
// products (2 MFLOP each, 120 MFLOP) are ~1.8 us of the card's float peak
// but ~270 us of one SM's; on 16 SMs
// each of its 40 dependent stages costs the copy of a whole operand (~1
// us), a band product of ~25 dependent steps of loads and multiply-adds and
// a cluster barrier, ~4.5 us a stage in all at n = 100
// (scripts/cma_phase_times.py). The CMA tail's Cholesky is block_linalg.cuh's
// blocked factor, 17.3 us at 416 threads (31.0 at 1024: the diagonal
// blocks spill at 64 registers a thread).
//
// Interface: plain C functions per dtype, loaded with ctypes. Each launches on
// the given stream, does not synchronise, and returns cudaGetLastError(); the
// caller allocates the scratch that *_scratch_elems asks for.

#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>

#include <cooperative_groups.h>

#include "block_linalg.cuh"
#include "refit_math.cuh"

namespace cg = cooperative_groups;

namespace {

using refit::clip_nan;
using refit::eps_of;
using refit::max_nan;

constexpr int kThreads = 1024;  // the one-block CMA kernel
constexpr size_t kMaxDynamicSmem = refit::kMaxSmem;

// The two halves of a cluster barrier: arrive (release) and wait (acquire).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// ---------------------------------------------------------------------------
// refit
// ---------------------------------------------------------------------------

// Phase stamps of the refit (scripts/refit_phase_times.py): the script builds
// a copy with REFIT_STAMP defined, whose stamps charge the time since the
// previous one to a phase (thread 0 of block 0); otherwise a stamp is
// nothing. REFIT_STAMP_BARRIER first waits for the block.
enum RefitPhase { kRefitCompact, kRefitFirst, kRefitProducts, kRefitStore, kRefitMoments,
                  kRefitReduce, kRefitShrink, kRefitFactor, kRefitPhases };
#ifndef REFIT_STAMP
#define REFIT_STAMP(phase) ((void)0)
#define REFIT_STAMP_START() ((void)0)
#define REFIT_STAMP_BARRIER(phase) ((void)0)
#endif

constexpr int kRefitThreads = refit::kThreads;  // the factor's width (csrc/linalg.cu)
constexpr int kRefitWarps = kRefitThreads / 32;
constexpr int kRefitCluster = refit::kCluster;
using refit::RefitLayout;
using refit::refit_layout;

// E consecutive values from 16-byte aligned shared memory
template <typename T, int E>
__device__ __forceinline__ void load_edge(const T* p, T (&v)[E]) {
  constexpr int kW = 16 / sizeof(T);
#pragma unroll
  for (int g = 0; g < E / kW; ++g) mpopis::load16<T, true>(p + g * kW, v + g * kW);
}

// The tile's rows of a column times the column's weight.
template <typename T, int E>
__device__ __forceinline__ void weigh(T (&u)[E], T wc) {
#pragma unroll
  for (int p = 0; p < E; ++p) u[p] = u[p] * wc;
}

// p[q * stride] = v[q] (+ p[q * stride] where `add`), q < kV: 8 old values
// read before their writes, so that the loads issue together without
// holding a second tile of registers.
template <typename T, int kV>
__device__ __forceinline__ void add_tile(T* p, int stride, const T (&v)[kV], bool add) {
#pragma unroll
  for (int q0 = 0; q0 < kV; q0 += 8) {
    T old[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) old[q] = add ? p[(q0 + q) * stride] : T(0);
#pragma unroll
    for (int q = 0; q < 8; ++q) p[(q0 + q) * stride] = add ? old[q] + v[q0 + q] : v[q0 + q];
  }
}

// The block's partial moments over its `count` columns (their indices in
// idx), in chunks of `cols`. A chunk is gathered into registers, a lane a
// column and a warp every kRefitWarps-th row (coalesced where the columns
// are dense), centred there and stored into its stage of x, column c at
// c * ldx, zero from n to the staged rows: masked, (E - mu) w; weighted
// (kW), E - mu, with the column's weight after the columns, which the
// products multiply into the tile's rows (the same rounding as staging
// the weighted rows, with half the stores). The next chunk's loads are
// issued before this chunk's products and stored after them, into the
// other stage: one barrier a chunk. Products in E x E tiles of the lower
// triangle (refit::tile_edge, refit::tile_groups); the partials pa (and,
// kB, pb) hold value v of tile t at v * tiles + t, so that a warp's threads
// meet distinct banks.
template <typename T, int E, bool kB, bool kW>
__device__ __forceinline__ void block_moments(const T* __restrict__ e, const T* __restrict__ w,
                                              const int* idx, int count, int n, int k, int cols,
                                              int ldx, T* x, const T* s_mu, T* pa, T* pb) {
  constexpr int kV = E * E;
  constexpr int kRows = 12;  // values a thread holds in flight: 144 rows a batch
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tiles = refit::num_tiles(n, E);
  const int groups = refit::tile_groups(tiles);
  const int rows = refit::staged_rows(n);
  const int chunks = (count + cols - 1) / cols;
  const int stage = refit::stage_elems(cols, ldx, sizeof(T));
  // this thread's tile and column group (groups > 0), accumulated over all chunks
  const int t = groups ? static_cast<int>(threadIdx.x) % tiles : 0;
  const int g = groups ? static_cast<int>(threadIdx.x) / tiles : 0;
  const bool live = groups > 0 && g < groups;
  int ti = 0, tj = 0;
  if (live) refit::tile_of(t, ti, tj);
  T a[kV], b[kV];
#pragma unroll
  for (int q = 0; q < kV; ++q) {
    a[q] = T(0);
    b[q] = T(0);
  }
  if (groups == 0) {  // each chunk's products are added to the partials
    for (int q = threadIdx.x; q < kV * tiles; q += blockDim.x) {
      pa[q] = T(0);
      if (kB) pb[q] = T(0);
    }
  }
  // the gather: a lane a column of the chunk, a warp every kRefitWarps-th
  // row (coalesced where the columns are dense)
  const int batches = (rows + kRefitWarps * kRows - 1) / (kRefitWarps * kRows);
  T gv[kRows];
  T gw = T(0);
  auto fetch = [&](int ch, int rb) {
    const bool on = ch < chunks && lane < min(cols, count - ch * cols);
    const int col = on ? idx[ch * cols + lane] : 0;
    if (rb == 0) gw = on ? __ldg(w + col) : T(0);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = warp + kRefitWarps * (rb * kRows + r);
      gv[r] = on && i < n ? __ldg(e + static_cast<size_t>(i) * k + col) : T(0);
    }
  };
  auto store = [&](int ch, int rb) {  // zeros past the chunk's count and past n
    T* xs = x + (ch & 1) * stage;
    if (lane >= cols) return;
    if (kW && rb == 0 && warp == 0) xs[cols * ldx + lane] = gw;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = warp + kRefitWarps * (rb * kRows + r);
      if (i < rows) {
        const T vr = i < n ? gv[r] - s_mu[i] : T(0);
        xs[lane * ldx + i] = kW ? vr : vr * gw;
      }
    }
  };
  for (int rb = 0; rb < batches; ++rb) {
    fetch(0, rb);
    store(0, rb);
  }
  __syncthreads();
  REFIT_STAMP(kRefitFirst);
  for (int ch = 0; ch < chunks; ++ch) {
    fetch(ch + 1, 0);  // in flight over the products
    const T* xs = x + (ch & 1) * stage;
    const T* ws = xs + cols * ldx;
    const int cc = min(cols, count - ch * cols);
    if (groups > 0) {
      if (live) {
        const T* u_col = xs + E * ti;
        const T* v_col = xs + E * tj;
#pragma unroll 2
        for (int c = g; c < cc; c += groups) {
          T u[E], v[E];
          load_edge<T, E>(u_col + c * ldx, u);
          load_edge<T, E>(v_col + c * ldx, v);
          if (kW) weigh<T, E>(u, ws[c]);
          refit::tile_column<T, E, kB>(u, v, a, b);
        }
      }
    } else {
      for (int tt = threadIdx.x; tt < tiles; tt += blockDim.x) {
        int ui, uj;
        refit::tile_of(tt, ui, uj);
        T ca[kV], cb[kV];
#pragma unroll
        for (int q = 0; q < kV; ++q) {
          ca[q] = T(0);
          cb[q] = T(0);
        }
        for (int c = 0; c < cc; ++c) {
          T u[E], v[E];
          load_edge<T, E>(xs + E * ui + c * ldx, u);
          load_edge<T, E>(xs + E * uj + c * ldx, v);
          if (kW) weigh<T, E>(u, ws[c]);
          refit::tile_column<T, E, kB>(u, v, ca, cb);
        }
        add_tile<T, kV>(pa + tt, tiles, ca, true);
        if (kB) add_tile<T, kV>(pb + tt, tiles, cb, true);
      }
    }
    REFIT_STAMP_BARRIER(kRefitProducts);
    if (ch + 1 < chunks) {
      store(ch + 1, 0);
      for (int rb = 1; rb < batches; ++rb) {
        fetch(ch + 1, rb);
        store(ch + 1, rb);
      }
    }
    __syncthreads();  // chunk ch + 1 is staged; chunk ch's stage is free
    REFIT_STAMP(kRefitStore);
  }
  // the groups' accumulators into the partials, in group order
  for (int gg = 0; gg < groups; ++gg) {
    if (live && g == gg) {
      add_tile<T, kV>(pa + t, tiles, a, gg > 0);
      if (kB) add_tile<T, kV>(pb + t, tiles, b, gg > 0);
    }
    __syncthreads();
  }
}

// One launch, a cluster of kRefitCluster blocks (a card that cannot schedule
// it fails the launch):
// 1. Each block reads the K mask entries or weights 32 at a time, a ballot
//    each, counts the columns that count and lists its share of them in
//    ascending order (refit::share), from the ballots kept in shared memory.
// 2. It gathers its columns of E, `cols` at a time a lane each, into
//    registers, centres (and, masked, weights) them into a stage in shared
//    memory, and multiplies them into its partial moments (block_moments):
//    the lower tiles of A and, for lw/ss, B.
// 3. After a cluster barrier, each block sums a slice of the tiles over the
//    blocks' partials in rank order (distributed shared memory, or global
//    scratch), writes A's lower triangle to block 0's factor buffer, and puts
//    its part of the estimator's two sums (refit::entry_sums) into block 0's
//    slots. ss's per-row values come from the diagonal, which every block
//    sums first; the other estimators' scalars need no diagonal of their own.
// 4. After a second cluster barrier, block 0 alone sums the slots in rank
//    order, forms the estimate and the jitter in place, and factors it into
//    L (block_linalg.cuh) at kRefitThreads.
template <typename T, bool kSmem>
__global__ void __launch_bounds__(kRefitThreads)
    refit_cluster_kernel(const T* __restrict__ e, const T* __restrict__ w,
                         const T* __restrict__ mu, RefitLayout L, int method, double m,
                         double jitter, int corrected, T* __restrict__ scratch,
                         T* __restrict__ l_out) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int warp_counts[kRefitWarps];
  __shared__ T red[kRefitWarps][2];
  __shared__ T slots[kRefitCluster][2];
  const int n = L.n;
  const int k = L.k;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  T* base = reinterpret_cast<T*>(smem_raw);
  T* pa = kSmem ? base + L.parts : scratch + 2 * L.part * rank;
  T* pb = pa + L.part;
  T* x = base + L.x;
  T* lbuf = kSmem ? x : l_out;  // block 0's factor: over the stages, or the output
  const int lda = kSmem ? L.lda : n;
  T* s_mu = base + L.vec;
  T* inv_sd = s_mu + n;
  T* sd_mle = inv_sd + n;
  unsigned* bits = reinterpret_cast<unsigned*>(smem_raw + L.ints);
  int* idx = reinterpret_cast<int*>(bits + L.words);
  REFIT_STAMP_START();

  for (int i = threadIdx.x; i < n; i += blockDim.x) s_mu[i] = mu[i];

  // 1. the columns that count: a ballot per 32 entries, a warp a run of words
  const int words = static_cast<int>(L.words);
  const int per_warp = (words + kRefitWarps - 1) / kRefitWarps;
  const int w0 = warp * per_warp;
  const int w1 = min(words, w0 + per_warp);
  int count_warp = 0;
  constexpr int kBatch = 32;  // loads in flight before their ballots
  for (int wb = w0; wb < w1; wb += kBatch) {
    bool nz[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int col = (wb + u) * 32 + lane;
      nz[u] = wb + u < w1 && col < k && refit::counts(w[col]);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const unsigned bal = __ballot_sync(mpopis::kFullMask, nz[u]);
      if (lane == 0 && wb + u < w1) bits[wb + u] = bal;
      count_warp += __popc(bal);
    }
  }
  if (lane == 0) warp_counts[warp] = count_warp;
  __syncthreads();
  int total = 0, pos = 0;
  for (int v = 0; v < kRefitWarps; ++v) {
    if (v == warp) pos = total;
    total += warp_counts[v];
  }
  int lo, hi;
  refit::share(total, rank, kRefitCluster, lo, hi);
  for (int wd = w0; wd < w1 && pos < hi; ++wd) {
    const unsigned bal = bits[wd];
    if ((bal >> lane) & 1u) {
      const int p = pos + __popc(bal & ((1u << lane) - 1u));
      if (p >= lo && p < hi) idx[p - lo] = wd * 32 + lane;
    }
    pos += __popc(bal);
  }
  const int count = hi - lo;
  __syncthreads();
  REFIT_STAMP(kRefitCompact);

  // 2. the moments over this block's columns
  const bool need_b = refit::needs_b(method);
  if (need_b) {
    block_moments<T, 4, true, false>(e, w, idx, count, n, k, L.cols, L.ldx, x, s_mu, pa, pb);
  } else if (method == refit::kWeighted) {
    block_moments<T, 8, false, true>(e, w, idx, count, n, k, L.cols, L.ldx, x, s_mu, pa, pb);
  } else {
    block_moments<T, 8, false, false>(e, w, idx, count, n, k, L.cols, L.ldx, x, s_mu, pa, pb);
  }
  cluster.sync();  // every block's partials are complete, and every block runs
  REFIT_STAMP(kRefitMoments);

  // 3. sums over the blocks in rank order: for ss the diagonal (every
  // block), then this block's slice of tiles into block 0's factor buffer
  // and slots
  auto peer = [&](int r) -> const T* {
    if constexpr (kSmem) {
      return cluster.map_shared_rank(pa, r);
    } else {
      return scratch + 2 * L.part * r;
    }
  };
  auto load = [](const T* p) -> T {
    if constexpr (kSmem) {
      return *p;
    } else {
      return __ldcg(p);  // written by another SM: never a stale L1 line
    }
  };
  const int edge = refit::tile_edge(method);
  const int vals = edge * edge;
  const int tiles = refit::num_tiles(n, edge);
  refit::Shrink<T> sh = refit::shrink_consts<T>(m);
  const bool ss = method == refit::kSs;
  if (ss) {  // every block needs ss's per-row values of the summed diagonal
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int at = refit::diag_value(i, edge) * tiles + refit::diag_tile(i, edge);
      T d = T(0);
#pragma unroll
      for (int r = 0; r < kRefitCluster; ++r) d += load(peer(r) + at);
      refit::ss_row(d, sh, inv_sd[i], sd_mle[i]);
    }
    __syncthreads();
  }
  T* l0 = kSmem ? cluster.map_shared_rank(lbuf, 0) : lbuf;
  T s0 = T(0), s1 = T(0);
  const int t_lo = static_cast<int>(static_cast<long long>(tiles) * rank / kRefitCluster);
  const int slice = static_cast<int>(static_cast<long long>(tiles) * (rank + 1) / kRefitCluster) -
                    t_lo;
  for (int q = threadIdx.x; q < vals * slice; q += blockDim.x) {
    const int v = q / slice;  // value v of tile t: consecutive threads, consecutive tiles
    const int t = t_lo + q - v * slice;
    int ti, tj;
    refit::tile_of(t, ti, tj);
    const int i = edge * ti + v / edge;
    const int j = edge * tj + v % edge;
    if (i >= n || j > i) continue;
    const int at = v * tiles + t;
    T a = T(0), b = T(0);
#pragma unroll
    for (int r = 0; r < kRefitCluster; ++r) {
      const T* pr = peer(r);
      a += load(pr + at);
      if (need_b) b += load(pr + L.part + at);
    }
    l0[i * lda + j] = a;
    if (ss) {
      refit::entry_sums(method, i, j, a, b, sh, inv_sd[i], inv_sd[j], s0, s1);
    } else {
      refit::entry_sums(method, i, j, a, b, sh, T(0), T(0), s0, s1);
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    s0 += __shfl_down_sync(mpopis::kFullMask, s0, o);
    s1 += __shfl_down_sync(mpopis::kFullMask, s1, o);
  }
  if (lane == 0) {
    red[warp][0] = s0;
    red[warp][1] = s1;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    T b0 = T(0), b1 = T(0);
    for (int v = 0; v < kRefitWarps; ++v) {
      b0 += red[v][0];
      b1 += red[v][1];
    }
    T* slot0 = cluster.map_shared_rank(&slots[0][0], 0);
    slot0[2 * rank] = b0;
    slot0[2 * rank + 1] = b1;
  }
  cluster.sync();  // block 0 holds the lower triangle of A and the slots;
                   // no block reads another's memory after this
  REFIT_STAMP(kRefitReduce);
  if (rank != 0) return;

  // 4. block 0: the estimate with its jitter in place, then the factor
  T g0 = T(0), g1 = T(0);
  for (int r = 0; r < kRefitCluster; ++r) {
    g0 += slots[r][0];
    g1 += slots[r][1];
  }
  refit::shrink_scalar(method, g0, g1, n, sh);
  T diag = T(0);  // the estimate's trace, summed by every warp alike
  for (int i = lane; i < n; i += 32) {
    diag += refit::estimate(method, i, i, load(lbuf + i * lda + i), sh, ss ? inv_sd[i] : T(0),
                            ss ? inv_sd[i] : T(0), ss ? sd_mle[i] : T(0),
                            ss ? sd_mle[i] : T(0), corrected);
  }
  for (int o = 16; o > 0; o >>= 1) diag += __shfl_xor_sync(mpopis::kFullMask, diag, o);
  const T add = refit::jitter_add(diag, n, jitter);
  __syncthreads();  // every warp has read the diagonal before any is rewritten
  for (int i = warp; i < n; i += kRefitWarps) {  // a warp a row of the lower triangle
    for (int j = lane; j <= i; j += 32) {
      T* at = lbuf + i * lda + j;
      const T est = refit::estimate(method, i, j, load(at), sh, ss ? inv_sd[i] : T(0),
                                    ss ? inv_sd[j] : T(0), ss ? sd_mle[i] : T(0),
                                    ss ? sd_mle[j] : T(0), corrected);
      *at = i == j ? est + add : est;
    }
  }
  REFIT_STAMP_BARRIER(kRefitShrink);
  mpopis::block_cholesky(lbuf, n, lda, kSmem ? l_out : nullptr);  // its first barrier orders
  REFIT_STAMP(kRefitFactor);                                      // the writes above
}

// Lets the refit kernel take all the shared memory a block can have and a
// cluster of 16 blocks; set once a process.
template <typename T, bool kSmem>
cudaError_t refit_attributes() {
  static bool set = false;
  if (set) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(refit_cluster_kernel<T, kSmem>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kMaxDynamicSmem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(refit_cluster_kernel<T, kSmem>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) cudaGetLastError();  // returned here, not left for the next launch
  set = err == cudaSuccess;
  return err;
}

template <typename T, bool kSmem>
cudaError_t refit_launch_layout(const RefitLayout& L, const T* e, const T* w, const T* mu,
                                int method, double m, double jitter, int corrected, T* scratch,
                                T* l, cudaStream_t s) {
  const cudaError_t attr_err = refit_attributes<T, kSmem>();
  if (attr_err != cudaSuccess) return attr_err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kRefitCluster);
  cfg.blockDim = dim3(kRefitThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(L.bytes);
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kRefitCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, refit_cluster_kernel<T, kSmem>, e, w, mu, L,
                                             method, m, jitter, corrected, scratch, l);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T>
int refit_launch(const void* e, const void* w, const void* mu, int n, int k, int method,
                 double m, double jitter, int corrected, void* scratch, void* l, void* stream) {
  if (n < 1 || k < 1 || method < refit::kMle || method > refit::kWeighted)
    return static_cast<int>(cudaErrorInvalidValue);
  const RefitLayout L = refit_layout<T>(n, k);
  if (L.bytes == 0) return static_cast<int>(cudaErrorInvalidValue);  // no layout fits
  const T* te = static_cast<const T*>(e);
  const T* tw = static_cast<const T*>(w);
  const T* tmu = static_cast<const T*>(mu);
  T* ts = static_cast<T*>(scratch);
  T* tl = static_cast<T*>(l);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      L.in_smem ? refit_launch_layout<T, true>(L, te, tw, tmu, method, m, jitter, corrected, ts,
                                               tl, s)
                : refit_launch_layout<T, false>(L, te, tw, tmu, method, m, jitter, corrected,
                                                ts, tl, s);
  return static_cast<int>(err);
}

// ---------------------------------------------------------------------------
// CMA tail
// ---------------------------------------------------------------------------

// Phase stamps of the CMA tail (scripts/cma_phase_times.py): the script
// builds a copy with CMA_STAMP and CMA_STAMP_START defined, which charge the
// time since the previous stamp to a phase; otherwise a stamp is nothing.
enum CmaPhase { kCmaSetup, kCmaPull, kCmaStageT, kCmaStageYZ, kCmaScale, kCmaTail, kCmaSigma,
                kCmaFactor, kCmaWrite, kCmaPhases };
#ifndef CMA_STAMP
#define CMA_STAMP(phase) ((void)0)
#define CMA_STAMP_START() ((void)0)
#endif

struct CmaConsts {
  double c1, c_Sigma, c_mu, c_sigma, d_sigma, e_norm, mu_eff;
};

// The CMA tail after Newton-Schulz, on one block: the evolution paths, the
// guarded step size, h_sigma, the scalar rank-mu term over K, Sigma_new from
// the upper triangle, jitter and sigma * chol. `cdw` holds C dw and norm_c2
// ||C||^2; `w` is n x n scratch (row stride n).
template <typename T>
__device__ void cma_tail(const T* __restrict__ sigma_in, const T* __restrict__ dw,
                         const T* __restrict__ ps_in, const T* __restrict__ pS_in,
                         const T* __restrict__ svals, const T* __restrict__ ws, T sigma_s,
                         int n, int k, const CmaConsts& c, double it, double jitter, int guards,
                         int update_chol, const T* cdw, T norm_c2, T* p_sig, T* p_Sig, T* w,
                         T* red, T* __restrict__ chol_out, T* __restrict__ sigma_out,
                         T* __restrict__ ps_out, T* __restrict__ pS_out, T* __restrict__ sig_out) {
  const int nn = n * n;
  const T it_f = T(it);
  // evolution path p_sigma and the step size
  const T k_ps = T(sqrt(c.c_sigma * (2.0 - c.c_sigma) * c.mu_eff));
  T ps2 = T(0);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const T p = T(1.0 - c.c_sigma) * ps_in[i] + k_ps * cdw[i];
    p_sig[i] = p;
    ps2 += p * p;
  }
  const T norm_ps = sqrt(mpopis::block_sum(ps2, red));
  T step_exp = T(c.c_sigma / c.d_sigma) * (norm_ps / T(c.e_norm) - T(1));
  if (guards) step_exp = clip_nan(step_exp, T(-20), T(20));
  T sigma_new = sigma_s * exp(step_exp);
  if (guards) sigma_new = clip_nan(sigma_new, T(1e-10), T(1e10));

  // h_sigma with (1 - c_sigma)^(2 it) as exp(2 it log(1 - c_sigma)), and p_Sigma
  const T decay = exp(T(2) * it_f * T(log(1.0 - c.c_sigma)));
  const T denom = sqrt(T(1) - decay);
  const T h_sigma = norm_ps / denom < T((1.4 + 2.0 / (n + 1.0)) * c.e_norm) ? T(1) : T(0);
  const T k_pS = T(sqrt(c.c_Sigma * (2.0 - c.c_Sigma) * c.mu_eff));
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    p_Sig[i] = T(1.0 - c.c_Sigma) * pS_in[i] + h_sigma * k_pS * dw[i];

  // the scalar rank-mu term (the reference's quirk form) over the K samples
  T rm = T(0);
  for (int q = threadIdx.x; q < k; q += blockDim.x) {
    const T sv = svals[q];
    const T wq = ws[q];
    const T w0 = wq >= T(0) ? wq : it_f * wq / max_nan(norm_c2 * sv * sv, T(1e-30));
    rm += w0 * sv * sv;
  }
  const T rank_mu = mpopis::block_sum(rm, red);  // also orders p_Sig
  CMA_STAMP(kCmaTail);

  // Sigma_new from the upper triangle, symmetrized
  const T k_old = T(1.0 - c.c1 - c.c_mu);
  const T k_h = (T(1) - h_sigma) * T(c.c_Sigma) * T(2.0 - c.c_Sigma);
  for (int idx = threadIdx.x; idx < nn; idx += blockDim.x) {
    const int i = idx / n;
    const int j = idx % n;
    const int u = i <= j ? idx : j * n + i;  // the upper-triangle entry
    const int ui = i <= j ? i : j;
    const int uj = i <= j ? j : i;
    const T sg = sigma_in[u];
    const T v = k_old * sg + T(c.c1) * (p_Sig[ui] * p_Sig[uj] + k_h * sg) + T(c.c_mu) * rank_mu;
    sigma_out[idx] = v;
    w[idx] = v;
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    ps_out[i] = p_sig[i];
    pS_out[i] = p_Sig[i];
  }
  if (threadIdx.x == 0) *sig_out = sigma_new;
  __syncthreads();
  CMA_STAMP(kCmaSigma);
  if (update_chol) {
    mpopis::block_jitter(w, n, jitter, eps_of(T()), red);
    mpopis::block_cholesky(w, n, n);
  }
  CMA_STAMP(kCmaFactor);
  for (int idx = threadIdx.x; idx < nn; idx += blockDim.x)
    chol_out[idx] = update_chol ? sigma_new * w[idx] : T(0);
  CMA_STAMP(kCmaWrite);
}

// ---- the cluster kernel ----------------------------------------------------

constexpr int kCmaThreads = 416;  // a block of the cluster kernel: 13 warps
constexpr int kCmaCluster = 16;   // blocks of the cluster (non-portable size)

// The register tile of the band products: kTileRows rows of one column of
// the band a thread, the q loop unrolled kTileUnroll times.
constexpr int kTileRows = 4;
constexpr int kTileUnroll = 4;

// Row stride of the cluster kernel's matrices: n rounded up to 4 values, so
// that a row holds whole 4-wide groups and starts 16-byte aligned.
int cma_ld(int n) { return (n + 3) / 4 * 4; }

// Rows of each block's band (rounded up to 4 in its buffers), and the
// kernel's shared memory (elements): two ld x ld staging matrices, the bands
// of y (two), z (two) and t, then C dw, p_sigma, p_Sigma and the blocks'
// parts of ||C||^2.
int cma_band_rows(int n) { return (n + kCmaCluster - 1) / kCmaCluster; }
size_t cma_cluster_elems(int n) {
  const size_t ld = cma_ld(n);
  const size_t rbp = (cma_band_rows(n) + kTileRows - 1) / kTileRows * kTileRows;
  return 2 * ld * ld + 5 * rbp * ld + 3 * static_cast<size_t>(n) + kCmaCluster;
}

// out[r * ld] (r < rows) = sum over q of a[r * ld + q] b[q * ld]: kTileRows
// band rows of one output column, q in ascending order for each output (the
// one-output-per-thread products' order; the padding past n adds zeros at
// the end), a's rows read 16 bytes at a time (broadcasts: the threads of a
// warp share the rows), b's column a value a row (the warp's threads on
// consecutive columns). kT: t = 1.5 I - 0.5 (a . b), the entry r on the
// diagonal where diag + r == 0. The rows also go to gout, this block's rows
// of the whole matrix.
template <typename T, bool kT>
__device__ __forceinline__ void col_tile(const T* __restrict__ a, const T* __restrict__ b,
                                         T* out, T* __restrict__ gout, int ld, int rows,
                                         int diag) {
  T acc[kTileRows];
#pragma unroll
  for (int r = 0; r < kTileRows; ++r) acc[r] = T(0);
#pragma unroll kTileUnroll
  for (int q = 0; q < ld; q += 4) {
    T av[kTileRows][4];
#pragma unroll
    for (int r = 0; r < kTileRows; ++r) {
      mpopis::load16<T, true>(a + r * ld + q, av[r]);
      if constexpr (sizeof(T) == 8) mpopis::load16<T, true>(a + r * ld + q + 2, av[r] + 2);
    }
    T bv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) bv[e] = b[(q + e) * ld];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int r = 0; r < kTileRows; ++r) acc[r] += av[r][e] * bv[e];
    }
  }
#pragma unroll
  for (int r = 0; r < kTileRows; ++r) {
    if (kT) acc[r] = (diag + r == 0 ? T(1.5) : T(0)) - T(0.5) * acc[r];
    if (r < rows) {
      out[r * ld] = acc[r];
      gout[r * ld] = acc[r];
    }
  }
}

// The band product out = a . b for this block's rows: a band (rbp rows), b a
// staged ld x ld matrix, one thread a tile of kTileRows rows of a column; the rows go to the band `out` and to this block's rows of the
// whole matrix g.
template <typename T, bool kT>
__device__ __forceinline__ void band_item(int item, const T* a, const T* b, T* out, T* g,
                                          int ld, int rows, int row0) {
  const int grp = item / ld;
  const int j = item - grp * ld;
  const int r0 = kTileRows * grp;
  col_tile<T, kT>(a + r0 * ld, b + j, out + r0 * ld + j, g + (row0 + r0) * ld + j, ld,
                  rows - r0, row0 + r0 - j);
}

// dst (ld x ld, its rows past n zero) = the first n rows of the matrix g in
// global memory, which the cluster's blocks wrote band by band: read from
// L2 (ld.global.cg: never a stale L1 line), 16 bytes a load and
// kStageBatch loads in flight a thread.
constexpr int kStageBatch = 8;

template <typename T>
__device__ void stage_full(T* dst, const T* g, int n, int ld) {
  const int total = n * ld * static_cast<int>(sizeof(T)) / 16;
  const float4* src = reinterpret_cast<const float4*>(g);
  float4* to = reinterpret_cast<float4*>(dst);
  for (int base = threadIdx.x; base < total; base += kStageBatch * blockDim.x) {
    float4 v[kStageBatch];
#pragma unroll
    for (int b = 0; b < kStageBatch; ++b) {
      const int idx = base + b * blockDim.x;
      if (idx < total) v[b] = __ldcg(src + idx);
    }
#pragma unroll
    for (int b = 0; b < kStageBatch; ++b) {
      const int idx = base + b * blockDim.x;
      if (idx < total) to[idx] = v[b];
    }
  }
}

// One launch of a cluster of csize blocks. Newton-Schulz on bands of rb rows:
// block r owns rows r rb .. r rb + rb - 1 of y, z and t, in its shared
// memory (the left operands) and in the whole matrices in global memory. A
// stage copies the whole right operand from L2 into shared memory and
// computes its band, a thread four rows of a column; a cluster barrier ends
// it: t = 1.5 I - 0.5 z y, then y t and t z together (two stages and two
// barriers a step, where the one-block kernel had three products behind
// three barriers). z, which the second stage needs whole, is copied while
// the first stage's barrier completes. Then each block forms its rows of C
// dw and its part of ||C||^2 in block 0's shared memory (distributed shared
// memory), and block 0 runs the tail and the factor (cma_tail) alone.
// The bands travel through L2 and not through distributed shared memory:
// a block copying a 100 x 100 float matrix from its 15 peers' shared memory
// took 2.5 us a copy, from L2 1.1 us (scripts/cma_phase_times.py, the stamps
// after each copy).
template <typename T>
__global__ void __launch_bounds__(kCmaThreads)
    cma_cluster_kernel(const T* __restrict__ sigma_in, const T* __restrict__ dw,
                       const T* __restrict__ ps_in, const T* __restrict__ pS_in,
                       const T* __restrict__ svals, const T* __restrict__ ws,
                       const T* __restrict__ sigma_s_in, int n, int k, CmaConsts c, double it,
                       double jitter, int guards, int ns_its, int update_chol, int rb, int ld,
                       T* __restrict__ work, T* __restrict__ chol_out, T* __restrict__ sigma_out,
                       T* __restrict__ ps_out, T* __restrict__ pS_out, T* __restrict__ sig_out) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int csize = static_cast<int>(cluster.num_blocks());
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T red[32];
  const int rbp = (rb + kTileRows - 1) / kTileRows * kTileRows;
  const int band = rbp * ld;
  T* s0 = reinterpret_cast<T*>(smem_raw);
  T* s1 = s0 + ld * ld;
  // the bands: y (two), z (two), t; y of step parity p at yb + p band, z
  // at zb + p band (pointers into shared memory, not an array of them, so
  // that the loads stay shared-memory loads)
  T* yb = s1 + ld * ld;
  T* zb = yb + 2 * band;
  T* tb = zb + 2 * band;
  T* cdw = tb + band;
  T* p_sig = cdw + n;
  T* p_Sig = p_sig + n;
  T* c2_part = p_Sig + n;
  // the whole matrices in global memory, each block writing its rows: y and
  // z twice (a block may still read one while the others write the next)
  const size_t full = static_cast<size_t>(n) * ld;
  T* gy = work;  // y of parity p at gy + p full
  T* gz = work + 2 * full;
  T* gt = work + 4 * full;
  const int row0 = rank * rb;
  const int rows = max(0, min(rb, n - row0));
  const int items = rbp / kTileRows * ld;  // a product's register tiles
  CMA_STAMP_START();

  // y = Sigma / s, z = I on this block's rows; zeros past n, and in the
  // staging matrices' rows past n (they meet the bands' zero columns)
  T d = T(0);
  for (int i = threadIdx.x; i < n; i += blockDim.x) d += sigma_in[i * n + i];
  const T s_tr = mpopis::block_sum(d, red);
  for (int idx = threadIdx.x; idx < 5 * band; idx += blockDim.x) {
    const int i = (idx % band) / ld;
    const int j = idx % ld;
    const bool live = i < rows && j < n;
    T v = T(0);
    if (idx < band) v = live ? sigma_in[(row0 + i) * n + j] / s_tr : T(0);
    if (idx >= 2 * band && idx < 3 * band) v = live && row0 + i == j ? T(1) : T(0);
    yb[idx] = v;
    if (i < rows && idx < band) gy[(row0 + i) * ld + j] = v;
    if (i < rows && idx >= 2 * band && idx < 3 * band) gz[(row0 + i) * ld + j] = v;
  }
  for (int idx = n * ld + threadIdx.x; idx < ld * ld; idx += blockDim.x) {
    s0[idx] = T(0);
    s1[idx] = T(0);
  }
  cluster.sync();  // every block's rows are written, and every block runs
  CMA_STAMP(kCmaSetup);
  int cur = 0;
  for (int step = 0; step < ns_its; ++step) {
    const int nxt = cur ^ 1;
    // t = 1.5 I - 0.5 z y on this block's rows
    stage_full(s0, gy + cur * full, n, ld);
    __syncthreads();
    CMA_STAMP(kCmaPull);
    for (int it_ = threadIdx.x; it_ < items; it_ += blockDim.x)
      band_item<T, true>(it_, zb + cur * band, s0, tb, gt, ld, rows, row0);
    cluster_arrive();  // this block's rows of t are written
    stage_full(s1, gz + cur * full, n, ld);  // z is final since the last barrier
    cluster_wait();  // t is complete
    CMA_STAMP(kCmaStageT);
    // y <- y t and z <- t z on this block's rows
    stage_full(s0, gt, n, ld);
    __syncthreads();
    CMA_STAMP(kCmaPull);
    for (int it_ = threadIdx.x; it_ < 2 * items; it_ += blockDim.x) {
      if (it_ < items) {
        band_item<T, false>(it_, yb + cur * band, s0, yb + nxt * band, gy + nxt * full, ld,
                            rows, row0);
      } else {
        band_item<T, false>(it_ - items, tb, s1, zb + nxt * band, gz + nxt * full, ld, rows,
                            row0);
      }
    }
    cluster.sync();  // y and z are complete
    CMA_STAMP(kCmaStageYZ);
    cur = nxt;
  }

  // C = z / sqrt(s): this block's rows of C dw and its part of ||C||^2, into block 0
  const T sqrt_s = sqrt(s_tr);
  T* zc = zb + cur * band;
  T c2 = T(0);
  for (int idx = threadIdx.x; idx < rows * n; idx += blockDim.x) {
    const int at = (idx / n) * ld + idx % n;
    const T cij = zc[at] / sqrt_s;
    zc[at] = cij;
    c2 += cij * cij;
  }
  c2 = mpopis::block_sum(c2, red);  // also orders the writes to zc
  T* cdw0 = cluster.map_shared_rank(cdw, 0);
  for (int i = threadIdx.x; i < rows; i += blockDim.x) {
    T c_dw = T(0);
    for (int j = 0; j < n; ++j) c_dw += zc[i * ld + j] * dw[j];
    cdw0[row0 + i] = c_dw;
  }
  if (threadIdx.x == 0) cluster.map_shared_rank(c2_part, 0)[rank] = c2;
  cluster.sync();  // block 0 holds C dw and the parts; no block reads another's memory after
  if (rank != 0) return;
  T norm_c2 = T(0);
  for (int r = 0; r < csize; ++r) norm_c2 += c2_part[r];
  CMA_STAMP(kCmaScale);
  cma_tail(sigma_in, dw, ps_in, pS_in, svals, ws, *sigma_s_in, n, k, c, it, jitter, guards,
           update_chol, cdw, norm_c2, p_sig, p_Sig, s0, red, chol_out, sigma_out, ps_out, pS_out,
           sig_out);
}

// The cluster size for n in T: kCmaCluster where the cluster's shared
// memory holds n, else 0 (the one-block kernel then runs from global
// memory). Decided from the size alone.
template <typename T>
int cma_cluster_size(int n) {
  return cma_cluster_elems(n) * sizeof(T) <= kMaxDynamicSmem ? kCmaCluster : 0;
}

// Lets the cluster kernel take all the shared memory a block can have and a
// cluster of 16 blocks; set once a process.
template <typename T>
cudaError_t cma_cluster_attributes() {
  static bool set = false;
  if (set) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      cma_cluster_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kMaxDynamicSmem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(cma_cluster_kernel<T>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) cudaGetLastError();  // returned here, not left for the next launch
  set = err == cudaSuccess;
  return err;
}

// ---- the one-block kernel, for n that no cluster holds ----------------------

// One block of kThreads runs everything: the four n x n Newton-Schulz
// matrices in global scratch, one output entry per thread and step.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    cma_block_kernel(const T* __restrict__ sigma_in, const T* __restrict__ dw,
                     const T* __restrict__ ps_in, const T* __restrict__ pS_in,
                     const T* __restrict__ svals, const T* __restrict__ ws,
                     const T* __restrict__ sigma_s_in, int n, int k, CmaConsts c, double it,
                     double jitter, int guards, int ns_its, int update_chol,
                     T* __restrict__ work, T* __restrict__ chol_out, T* __restrict__ sigma_out,
                     T* __restrict__ ps_out, T* __restrict__ pS_out, T* __restrict__ sig_out) {
  __shared__ T red[32];
  const int nn = n * n;
  T* y = work;
  T* z = y + nn;
  T* t = z + nn;
  T* w = t + nn;
  T* p_sig = w + nn;  // (n,)
  T* p_Sig = p_sig + n;  // (n,)
  T* cdw = p_Sig + n;    // (n,)
  CMA_STAMP_START();

  // C = Sigma^-1/2 by coupled Newton-Schulz: Y -> (Sigma/s)^1/2, Z -> (Sigma/s)^-1/2
  T d = T(0);
  for (int i = threadIdx.x; i < n; i += blockDim.x) d += sigma_in[i * n + i];
  const T s_tr = mpopis::block_sum(d, red);
  for (int idx = threadIdx.x; idx < nn; idx += blockDim.x) {
    y[idx] = sigma_in[idx] / s_tr;
    z[idx] = idx / n == idx % n ? T(1) : T(0);
  }
  __syncthreads();
  CMA_STAMP(kCmaSetup);
  for (int step = 0; step < ns_its; ++step) {
    for (int idx = threadIdx.x; idx < nn; idx += blockDim.x) {  // t = 1.5 I - 0.5 z y
      const int i = idx / n;
      const int j = idx % n;
      T acc = T(0);
      for (int q = 0; q < n; ++q) acc += z[i * n + q] * y[q * n + j];
      t[idx] = (i == j ? T(1.5) : T(0)) - T(0.5) * acc;
    }
    __syncthreads();
    CMA_STAMP(kCmaStageT);
    mpopis::block_matmul(y, t, w, n);  // y <- y t
    T* tmp = y;
    y = w;
    w = tmp;
    mpopis::block_matmul(t, z, w, n);  // z <- t z
    tmp = z;
    z = w;
    w = tmp;
    CMA_STAMP(kCmaStageYZ);
  }
  const T sqrt_s = sqrt(s_tr);
  T c2 = T(0);
  for (int idx = threadIdx.x; idx < nn; idx += blockDim.x) {
    const T cij = z[idx] / sqrt_s;
    z[idx] = cij;
    c2 += cij * cij;
  }
  const T norm_c2 = mpopis::block_sum(c2, red);  // also orders the writes to z
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    T c_dw = T(0);
    for (int j = 0; j < n; ++j) c_dw += z[i * n + j] * dw[j];
    cdw[i] = c_dw;
  }
  __syncthreads();
  CMA_STAMP(kCmaScale);
  cma_tail(sigma_in, dw, ps_in, pS_in, svals, ws, *sigma_s_in, n, k, c, it, jitter, guards,
           update_chol, cdw, norm_c2, p_sig, p_Sig, w, red, chol_out, sigma_out, ps_out, pS_out,
           sig_out);
}

// Global scratch (elements) of either kernel: the cluster kernel's five whole
// matrices (n x ld), or the one-block kernel's four (n x n) and three vectors.
size_t cma_work_elems(int n) {
  return std::max(5 * static_cast<size_t>(n) * cma_ld(n),
                  4 * static_cast<size_t>(n) * n + 3 * n);
}

template <typename T>
int cma_launch(const void* sigma, const void* dw, const void* ps, const void* pS,
               const void* svals, const void* ws, const void* sigma_s, int n, int k,
               const double* consts, double it, double jitter, int guards, int ns_its,
               int update_chol, void* scratch, void* chol, void* sigma_out, void* ps_out,
               void* pS_out, void* sig_out, void* stream) {
  if (n < 1 || k < 1 || ns_its < 0) return static_cast<int>(cudaErrorInvalidValue);
  const CmaConsts c{consts[0], consts[1], consts[2], consts[3], consts[4], consts[5], consts[6]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* a_sigma = static_cast<const T*>(sigma);
  const T* a_dw = static_cast<const T*>(dw);
  const T* a_ps = static_cast<const T*>(ps);
  const T* a_pS = static_cast<const T*>(pS);
  const T* a_sv = static_cast<const T*>(svals);
  const T* a_ws = static_cast<const T*>(ws);
  const T* a_sig = static_cast<const T*>(sigma_s);
  T* o_chol = static_cast<T*>(chol);
  T* o_sigma = static_cast<T*>(sigma_out);
  T* o_ps = static_cast<T*>(ps_out);
  T* o_pS = static_cast<T*>(pS_out);
  T* o_sig = static_cast<T*>(sig_out);
  if (cma_cluster_size<T>(n) == 0) {
    cma_block_kernel<T><<<1, kThreads, 0, s>>>(a_sigma, a_dw, a_ps, a_pS, a_sv, a_ws, a_sig, n,
                                               k, c, it, jitter, guards, ns_its, update_chol,
                                               static_cast<T*>(scratch), o_chol, o_sigma, o_ps,
                                               o_pS, o_sig);
    return static_cast<int>(cudaGetLastError());
  }
  const cudaError_t attr_err = cma_cluster_attributes<T>();
  if (attr_err != cudaSuccess) return static_cast<int>(attr_err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCmaCluster);
  cfg.blockDim = dim3(kCmaThreads);
  cfg.dynamicSmemBytes = cma_cluster_elems(n) * sizeof(T);
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCmaCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, cma_cluster_kernel<T>, a_sigma, a_dw, a_ps, a_pS, a_sv, a_ws, a_sig, n, k, c, it,
      jitter, guards, ns_its, update_chol, cma_band_rows(n), cma_ld(n),
      static_cast<T*>(scratch), o_chol, o_sigma,
      o_ps, o_pS, o_sig);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

extern "C" {

// Global scratch (in elements of the dtype) the caller allocates for one
// refit: 0 where the cluster's shared memory holds the partials and the factor.
long long ais_refit_scratch_elems(int n, int k, int f64) {
  return f64 ? refit_layout<double>(n, k).scratch : refit_layout<float>(n, k).scratch;
}

// The refit's layout for n, K and the dtype: 1 where the partial moments and
// the factor sit in the cluster's shared memory, 0 where they sit in global
// memory, -1 where no layout fits (the launch is refused).
int ais_refit_layout(int n, int k, int f64) {
  const RefitLayout L = f64 ? refit_layout<double>(n, k) : refit_layout<float>(n, k);
  return L.bytes == 0 ? -1 : L.in_smem;
}

// The blocks of the refit's cluster.
int ais_refit_cluster_size() { return kRefitCluster; }

long long ais_cma_scratch_elems(int n) { return static_cast<long long>(cma_work_elems(n)); }

// The CMA kernel's cluster size for n (16 blocks), or 0 where it runs on one
// block from global memory.
int ais_cma_cluster_size(int n, int f64) {
  return f64 ? cma_cluster_size<double>(n) : cma_cluster_size<float>(n);
}

int ais_num_cma_consts() { return 7; }

// method: 0 mle, 1 lw, 2 ss, 3 rblw, 4 oas (masked refit); 5 the weighted refit
int ais_refit_chol_f32(const void* e, const void* w, const void* mu, int n, int k, int method,
                       double m, double jitter, int corrected, void* scratch, void* l,
                       void* stream) {
  return refit_launch<float>(e, w, mu, n, k, method, m, jitter, corrected, scratch, l, stream);
}

int ais_refit_chol_f64(const void* e, const void* w, const void* mu, int n, int k, int method,
                       double m, double jitter, int corrected, void* scratch, void* l,
                       void* stream) {
  return refit_launch<double>(e, w, mu, n, k, method, m, jitter, corrected, scratch, l, stream);
}

// consts: c1, c_Sigma, c_mu, c_sigma, d_sigma, e_norm, mu_eff
int ais_cma_update_f32(const void* sigma, const void* dw, const void* ps, const void* pS,
                       const void* svals, const void* ws, const void* sigma_s, int n, int k,
                       const double* consts, double it, double jitter, int guards, int ns_its,
                       int update_chol, void* scratch, void* chol, void* sigma_out,
                       void* ps_out, void* pS_out, void* sig_out, void* stream) {
  return cma_launch<float>(sigma, dw, ps, pS, svals, ws, sigma_s, n, k, consts, it, jitter,
                           guards, ns_its, update_chol, scratch, chol, sigma_out, ps_out,
                           pS_out, sig_out, stream);
}

int ais_cma_update_f64(const void* sigma, const void* dw, const void* ps, const void* pS,
                       const void* svals, const void* ws, const void* sigma_s, int n, int k,
                       const double* consts, double it, double jitter, int guards, int ns_its,
                       int update_chol, void* scratch, void* chol, void* sigma_out,
                       void* ps_out, void* pS_out, void* sig_out, void* stream) {
  return cma_launch<double>(sigma, dw, ps, pS, svals, ws, sigma_s, n, k, consts, it, jitter,
                            guards, ns_its, update_chol, scratch, chol, sigma_out, ps_out,
                            pS_out, sig_out, stream);
}

}  // extern "C"
