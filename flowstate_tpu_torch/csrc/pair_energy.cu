// Total pair energy and virial of a batch of configurations, one launch per
// call: a group of lanes per chain at small N, a thread block cluster per
// chain above.
//
// Replaces flowstate_tpu/ops/pallas_pair.py::_pair_tile_kernel (the Pallas
// TPU kernel, launched by total_energy_virial_pallas).  For each (N, 2)
// configuration of a (C, N, 2) float32 batch it computes
//   energy = sum_{i<j, r_ij <= cutoff} e_LJ(r_ij) - e_LJ(cutoff)
//            + sum_i V_well(x_i)
//   virial = sum_{i<j, r_ij <= cutoff} 48 eps (sr12 - 0.5 sr6)
// with the minimum image (round half to even, as jnp.round), and maps any
// pair with r_ij < hard_core to (+inf, +inf).  out is (2, C): energies,
// then virials.
//
// What bounds it on this card: issuing the distance of every pair.  8
// bytes per particle are read once, and at the densities the system runs
// (rho = 0.03 to 0.3) more than 99% of the pairs lie beyond the cutoff (at
// rho = 0.3 a particle has about rho pi r_c^2 = 5.9 of its N - 1 partners
// inside r_c = 2.5), so the LJ arithmetic (a division, the powers, energy
// and virial) of those pairs adds exactly zero; what every pair needs is
// its distance, two minimum images and r^2, 12 fp32 operations and a
// shared-memory load, about 14 instructions a pair; the distances alone
// take most of a call at N >= 128 (PERF.md).  At small N (the
// reference system, N = 3) there is almost no work: a call is its launch
// latency.
//
// What the design does about it.
//   * The pairs of a chain are split by a circulant rule: row i holds the
//     pairs (i, i + k mod N) for k = 1 ... floor((N - 1) / 2), and for even
//     N also k = N / 2 in the rows i < N / 2 (each unordered pair once).  A
//     row's offsets are cut into m parts of kseg offsets (a unit), and
//     thread g of the chain's P takes the units g, g + P, ...: every thread
//     does the same number of turns, row i's particle stays in registers,
//     partner j = i + k advances by one per turn, and the lanes of a warp
//     take consecutive rows, so they read consecutive addresses.
//     cuda_pair.split and cuda_pair.thread_pairs mirror the rule.
//   * A turn computes the pair's distance only; a warp vote (__any_sync)
//     skips the LJ arithmetic of a turn where no lane's r^2 <= max(r_c^2,
//     hc^2), and the pairs that remain take the branch-free division
//     (pair_math.cuh: div_rn_normal).  A skipped pair adds nothing, as in
//     the reference, so the result is the same function.
//   * N <= 32: a group of 4 (N <= 4), 8 (N <= 16) or 32 lanes per chain,
//     one warp per block holding 32 / G chains; the lanes read the chain
//     from device memory (a few hundred bytes, through L1), sum by a
//     shuffle butterfly, and one lane writes.  (100, 3) is 13 warps.
//   * N > 32: a cluster of S blocks of 256 threads per chain (S = 1 ... 8,
//     chosen from (C, N) and the SM count so that the grid's waves of 4
//     blocks per SM carry the fewest turns).  Each block stages the chain
//     in shared memory with its first N / 2 + m particles repeated after
//     it, so j = i + k needs no wrap (12 KB at N = 1024); past 52 KB (N >
//     about 4,400) it reads the chain from device memory through L1 and L2
//     instead, with the wrap.  The warps' sums meet in shared memory in
//     warp order; each block's sum goes to rank 0's shared memory over
//     distributed shared memory between two cluster barriers; rank 0 adds
//     them in rank order and writes.  A cluster rather than a last-block
//     ticket: the sums never reach device memory and there is no counter
//     to allocate or reset.  Device memory rather than a tiled j-loop past
//     52 KB: no path of the system gives K2 more than 4,096 particles, and
//     one pair loop serves both.
//   * Every unit of a row holds at least kseg - m offsets, so a thread's
//     first kseg - m turns skip the test of the offset against the row's
//     length.
//   No partials in device memory, no float atomics: every sum runs in an
//   order fixed by the launch shape, so the same input gives the same bits
//   on every call.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (flowstate_tpu_torch/kernels/build.py).  Plain C entry
// points, loaded with ctypes; each returns a cudaError_t.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "pair_math.cuh"

namespace cg = cooperative_groups;

struct PairParams {        // mirrored by ops/cuda_pair._PairParams
  int num_chains;
  int n;
  int num_wells;
  int num_sms;             // the card's SMs: they set the cluster size
  float lx, ly, inv_lx, inv_ly;
  float r_cut2, hc2, sigma2, eps4, eps48, shift;
  float wx0, wy0, wx1, wy1;  // well centers
  float v00, v01;            // well depths
  float r0, k;
};

// Lanes per chain for N up to kWarpMaxN: 4 up to kGroup4MaxN, 8 up to
// kGroup8MaxN, a warp above; clusters of blocks beyond kWarpMaxN.
static constexpr int kGroup4MaxN = 4;
static constexpr int kGroup8MaxN = 16;
static constexpr int kWarpMaxN = 32;
static constexpr int kBlock = 256;         // threads per block of a cluster
static constexpr int kWarps = kBlock / 32;
static constexpr int kBlocksPerSm = 4;     // __launch_bounds__: <= 64 registers
static constexpr int kMaxCluster = 8;      // the portable cluster size
// a block's own cost (staging, reductions, cluster barriers), in turns
static constexpr int kFixedTurns = 8;
// the staged chain's largest size; 4 blocks of it fit an SM's 228 KB
static constexpr int kMaxStagedBytes = 52 * 1024;
static constexpr unsigned int kFull = 0xffffffffu;

// The launch for C chains of n particles: the fields of
// flowstate_pair_launch_shape, mirrored by cuda_pair.launch_shape.
struct Shape {
  int threads;        // threads per chain
  int cluster;        // blocks per chain; 0 for a lane group
  int blocks;         // grid
  int block;          // threads per block
  int segments;       // m: parts of a row's offsets
  int seg_len;        // kseg: offsets per part, a unit's turns
  int units;          // units per thread
  int shared_bytes;   // the staged chain; 0: read from device memory
};

static int group_threads(int n) {
  if (n <= kGroup4MaxN) return 4;
  if (n <= kGroup8MaxN) return 8;
  return 32;
}

// The circulant split over `threads` threads: m parts of kseg offsets per
// row, and units per thread.
static void split(int n, int threads, int& m, int& kseg, int& units) {
  const int kmax = n / 2;
  m = threads / n < kmax ? threads / n : kmax;
  if (m < 1) m = 1;
  kseg = (kmax + m - 1) / m;
  units = (int)(((long long)n * m + threads - 1) / threads);
}

static Shape launch_shape(int n, int c, int num_sms) {
  Shape sh{};
  if (n <= kWarpMaxN) {
    sh.threads = group_threads(n);
    sh.block = 32;
    sh.blocks = (c + 32 / sh.threads - 1) / (32 / sh.threads);
    split(n, sh.threads, sh.segments, sh.seg_len, sh.units);
    return sh;
  }
  const long long slots = (long long)num_sms * kBlocksPerSm;
  long long best_cost = -1;
  for (int s = 1; s <= kMaxCluster; ++s) {
    int m, kseg, units;
    split(n, s * kBlock, m, kseg, units);
    const long long waves = ((long long)c * s + slots - 1) / slots;
    const long long cost = waves * ((long long)units * kseg + kFixedTurns);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      sh.cluster = s;
    }
  }
  sh.threads = sh.cluster * kBlock;
  sh.block = kBlock;
  sh.blocks = c * sh.cluster;
  split(n, sh.threads, sh.segments, sh.seg_len, sh.units);
  const long long staged = (long long)(n + n / 2 + sh.segments) * 8;
  sh.shared_bytes = staged <= kMaxStagedBytes ? (int)staged : 0;
  return sh;
}

// The pairs and the well terms of thread g of a chain's `threads`, summed
// in its fixed order: e (pairs inside the cutoff, then wells), w, and
// whether a pair lies inside the hard core.  load(j) gives particle j mod
// n for 0 <= j < n + n / 2 + m.  Every lane of the warp runs the same
// turns, so that the warp can vote.
template <class Load>
__device__ __forceinline__ void thread_share(const PairParams& P, int g,
                                             int threads, int m, int kseg,
                                             int units, Load load, float& e,
                                             float& w, bool& ov) {
  const int n = P.n, kmax = n / 2;
  const float near2 = fmaxf(P.r_cut2, P.hc2);
  for (int r = 0; r < units; ++r) {
    const int u = g + r * threads;
    const bool unit_ok = u < n * m;
    const int i = u % n;
    const int s = unit_ok ? u / n : 0;
    // row i's offsets: k <= kmax, less one for the rows i >= n / 2 of an
    // even n (their k = n / 2 pair is row i - n / 2's)
    const int len = ((n & 1) || i < kmax) ? kmax : kmax - 1;
    const int k0 = s * kseg;
    const int k_end = min(k0 + kseg, len);
    // a unit past the last row computes NaN distances: never near
    const float nan = __int_as_float(0x7fc00000);
    const float2 pi = unit_ok ? load(i) : make_float2(nan, nan);
    auto turn = [&](int t, bool valid) {
      const float2 pj = load(i + k0 + t);
      const float dx = min_image(pi.x - pj.x, P.lx, P.inv_lx);
      const float dy = min_image(pi.y - pj.y, P.ly, P.inv_ly);
      const float r2 = sq_norm(dx, dy);
      const bool near = valid && r2 <= near2;
      if (__any_sync(kFull, near)) {
        const float sr2 = div_rn_normal(P.sigma2, fmaxf(r2, 1e-24f));
        const float sr6 = sr2 * (sr2 * sr2);
        const float sr12 = sr6 * sr6;
        const bool inside = near && r2 <= P.r_cut2;
        e += inside ? P.eps4 * (sr12 - sr6) - P.shift : 0.0f;
        w += inside ? P.eps48 * (sr12 - 0.5f * sr6) : 0.0f;
        ov = ov || (near && r2 < P.hc2);
      }
    };
    // every unit of a row holds at least kseg - m offsets, so the first
    // kseg - m turns need no test of the offset
    int t = 1;
#pragma unroll 4
    for (; t <= kseg - m; ++t) turn(t, true);
    for (; t <= kseg; ++t) turn(t, k0 + t <= k_end);
  }
  if (P.num_wells > 0) {
    const bool two = P.num_wells == 2;
    for (int q = g; q < n * P.num_wells; q += threads) {
      const float2 x = load(two ? q >> 1 : q);
      const bool second = two && (q & 1);
      e += well_term(x.x, x.y, second ? P.wx1 : P.wx0,
                     second ? P.wy1 : P.wy0, second ? P.v01 : P.v00, P);
    }
  }
}

__device__ __forceinline__ void write_result(const PairParams& P, int c,
                                             float e, float w, bool ov,
                                             float* out) {
  const float inf = __int_as_float(0x7f800000);
  out[c] = ov ? inf : e;
  out[P.num_chains + c] = ov ? inf : w;
}

// G lanes per chain, one warp per block holding 32 / G chains.
template <int G>
__global__ void __launch_bounds__(32)
pair_group_kernel(PairParams P, int m, int kseg, int units,
                  const float2* __restrict__ pos, float* __restrict__ out) {
  const int lane = threadIdx.x;
  const int slot = lane / G, g = lane % G;
  const int chain = blockIdx.x * (32 / G) + slot;
  // a group past the last chain shadows it: it takes part in every vote
  // and shuffle and writes nothing
  const bool live = chain < P.num_chains;
  const int c = live ? chain : P.num_chains - 1;
  const int n = P.n;
  const float2* row = pos + (size_t)c * n;
  float e = 0.0f, w = 0.0f;
  bool ov = false;
  thread_share(P, g, G, m, kseg, units,
               [row, n](int j) { return __ldg(row + (j < n ? j : j - n)); },
               e, w, ov);
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    e += __shfl_xor_sync(kFull, e, off, G);
    w += __shfl_xor_sync(kFull, w, off, G);
  }
  const unsigned int segment = (kFull >> (32 - G)) << (slot * G);
  ov = (__ballot_sync(kFull, ov) & segment) != 0u;
  if (live && g == 0) write_result(P, c, e, w, ov, out);
}

// A cluster of gridDim.x / C blocks of kBlock threads per chain.
template <bool kStaged>
__global__ void __launch_bounds__(kBlock, kBlocksPerSm)
pair_cluster_kernel(PairParams P, int m, int kseg, int units,
                    const float2* __restrict__ pos, float* __restrict__ out) {
  extern __shared__ float2 s_chain[];
  __shared__ float s_warp_e[kWarps], s_warp_w[kWarps];
  __shared__ int s_warp_ov[kWarps];
  __shared__ float s_rank_e[kMaxCluster], s_rank_w[kMaxCluster];
  __shared__ int s_rank_ov[kMaxCluster];

  cg::cluster_group cluster = cg::this_cluster();
  const int size = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int c = blockIdx.x / size;
  const int n = P.n, tid = threadIdx.x;
  const float2* row = pos + (size_t)c * n;
  float e = 0.0f, w = 0.0f;
  bool ov = false;
  const int g = rank * kBlock + tid;
  if constexpr (kStaged) {
    const int count = n + n / 2 + m;
    for (int j = tid; j < count; j += kBlock)
      s_chain[j] = row[j < n ? j : j - n];
    __syncthreads();
    const float2* chain = s_chain;
    thread_share(P, g, size * kBlock, m, kseg, units,
                 [chain](int j) { return chain[j]; }, e, w, ov);
  } else {
    thread_share(P, g, size * kBlock, m, kseg, units,
                 [row, n](int j) { return __ldg(row + (j < n ? j : j - n)); },
                 e, w, ov);
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    e += __shfl_xor_sync(kFull, e, off);
    w += __shfl_xor_sync(kFull, w, off);
  }
  ov = __any_sync(kFull, ov);
  if ((tid & 31) == 0) {
    s_warp_e[tid >> 5] = e;
    s_warp_w[tid >> 5] = w;
    s_warp_ov[tid >> 5] = ov;
  }
  __syncthreads();
  // every block of the cluster runs before rank 0's memory is written
  cluster.sync();
  if (tid == 0) {
    float be = 0.0f, bw = 0.0f;
    int bo = 0;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) {
      be += s_warp_e[k];
      bw += s_warp_w[k];
      bo |= s_warp_ov[k];
    }
    cluster.map_shared_rank(s_rank_e, 0)[rank] = be;
    cluster.map_shared_rank(s_rank_w, 0)[rank] = bw;
    cluster.map_shared_rank(s_rank_ov, 0)[rank] = bo;
  }
  cluster.sync();
  if (rank == 0 && tid == 0) {
    float ce = 0.0f, cw = 0.0f;
    int co = 0;
    for (int k = 0; k < size; ++k) {
      ce += s_rank_e[k];
      cw += s_rank_w[k];
      co |= s_rank_ov[k];
    }
    write_result(P, c, ce, cw, co != 0, out);
  }
}

template <int G>
static int launch_group(const PairParams& P, const Shape& sh,
                        const float2* pos, float* out, cudaStream_t s) {
  pair_group_kernel<G><<<sh.blocks, sh.block, 0, s>>>(
      P, sh.segments, sh.seg_len, sh.units, pos, out);
  return (int)cudaGetLastError();
}

template <bool kStaged>
static int launch_cluster(const PairParams& P, const Shape& sh,
                          const float2* pos, float* out, cudaStream_t s) {
  if (kStaged && sh.shared_bytes > 48 * 1024) {
    static bool opted_in = false;   // once per process: above 48 KB
    if (!opted_in) {
      const cudaError_t rc = cudaFuncSetAttribute(
          pair_cluster_kernel<kStaged>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxStagedBytes);
      if (rc != cudaSuccess) return (int)rc;
      opted_in = true;
    }
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = sh.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(sh.blocks);
  cfg.blockDim = dim3(sh.block);
  cfg.dynamicSmemBytes = sh.shared_bytes;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t rc =
      cudaLaunchKernelEx(&cfg, pair_cluster_kernel<kStaged>, P, sh.segments,
                         sh.seg_len, sh.units, pos, out);
  if (rc != cudaSuccess) return (int)rc;
  return (int)cudaGetLastError();
}

static bool valid(int n, int c, int num_sms) {
  return n >= 1 && c >= 1 && num_sms >= 1 &&
         (long long)c * kMaxCluster < (1ll << 31) && n < (1 << 28);
}

// The launch for c chains of n particles on a card of num_sms SMs, as
// out[0..7] = threads per chain, blocks per chain (0: a lane group), grid,
// threads per block, parts per row, turns per unit, units per thread,
// shared bytes (0: the chain is read from device memory).
extern "C" int flowstate_pair_launch_shape(int n, int c, int num_sms,
                                           int* out) {
  if (!valid(n, c, num_sms)) return (int)cudaErrorInvalidValue;
  const Shape sh = launch_shape(n, c, num_sms);
  const int fields[8] = {sh.threads, sh.cluster,  sh.blocks,  sh.block,
                         sh.segments, sh.seg_len, sh.units, sh.shared_bytes};
  for (int k = 0; k < 8; ++k) out[k] = fields[k];
  return 0;
}

// pos: (C, N, 2) float32, 8-byte aligned, read.  out: (2, C) float32,
// written: energies, then virials.  One launch on `stream`.
extern "C" int flowstate_pair_energy(const PairParams* params,
                                     const float* pos, float* out,
                                     void* stream) {
  const PairParams P = *params;
  if (!valid(P.n, P.num_chains, P.num_sms) || P.num_wells < 0 ||
      P.num_wells > 2)
    return (int)cudaErrorInvalidValue;
  if ((uintptr_t)pos % sizeof(float2) != 0)
    return (int)cudaErrorMisalignedAddress;
  const Shape sh = launch_shape(P.n, P.num_chains, P.num_sms);
  const float2* p = reinterpret_cast<const float2*>(pos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sh.cluster == 0) {
    switch (sh.threads) {
      case 4: return launch_group<4>(P, sh, p, out, s);
      case 8: return launch_group<8>(P, sh, p, out, s);
      default: return launch_group<32>(P, sh, p, out, s);
    }
  }
  if (sh.shared_bytes > 0) return launch_cluster<true>(P, sh, p, out, s);
  return launch_cluster<false>(P, sh, p, out, s);
}
