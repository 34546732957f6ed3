// Total pair energy, virial and hard-core overlap count of a batch of
// configurations, in two passes.
//
// Replaces flowstate_tpu/ops/pallas_pair.py::_pair_tile_kernel (the Pallas
// TPU kernel, launched by total_energy_virial_pallas).  For each (N, 2)
// configuration of a (C, N, 2) float32 batch it computes
//   energy = sum_{i<j, r_ij <= cutoff} e_LJ(r_ij) - e_LJ(cutoff)
//            + sum_i V_well(x_i)
//   virial = sum_{i<j, r_ij <= cutoff} 48 eps (sr12 - 0.5 sr6)
// with the minimum image (rintf: round half to even, as jnp.round), and
// maps any pair with r_ij < hard_core to (+inf, +inf).
//
// Pass 1 (pair_tiles_kernel): one block per (chain, i-tile, j-tile) with
// j-tile >= i-tile, tiles of kTile = 256 particles.  The block stages the
// j-tile's positions in shared memory (2 KB); thread t takes row i =
// i-tile * 256 + t and loops over the j-tile, keeping energy, virial and
// overlap count in registers; the diagonal tile keeps only j > i and both
// tiles mask the padding past N.  A warp-shuffle butterfly and one
// shared-memory pass over the 8 warps reduce the block to one partial per
// quantity, written at (chain, tile pair).
// Pass 2 (pair_epilogue_kernel): one warp per chain sums that chain's
// partials and its particles' well energies, each in a fixed order, and
// writes (energy, virial) or (+inf, +inf).
//
// The TPU kernel takes one configuration and its grid runs in order on
// one core; here one launch covers every chain, and blocks run in parallel
// in no order, so the sum across blocks is the second pass.  No float
// atomics: every sum runs in an order fixed by the launch shape, so the
// same input gives the same bits on every call.
//
// What bounds it on this card: arithmetic.  A pair costs about 26 fp32
// operations (two min images, r^2, one IEEE division, the powers, energy,
// virial, accumulation) against 8 bytes per particle read once: at
// N = 1024 and C = 128, 6.7e7 pairs and 1.7e9 operations against 1 MB of
// positions.  The design therefore reads each particle of the j-tile from
// shared memory as a broadcast (every thread of a warp reads the same
// address), keeps the row particle and the sums in registers, and writes
// nothing but one partial per block.  At small N (the reference system,
// N = 3) the call is two launches of a few threads per chain and its
// time is the launch latency.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (flowstate_tpu_torch/kernels/build.py).  Plain C entry
// points, loaded with ctypes; each returns the cudaError_t of its launch.

#include <cuda_runtime.h>

struct PairParams {        // mirrored by ops/cuda_pair._PairParams
  int num_chains;
  int n;
  int num_tiles;           // ceil(n / kTile)
  int num_wells;
  float lx, ly, inv_lx, inv_ly;
  float r_cut2, hc2, sigma2, eps4, eps48, shift;
  float wx0, wy0, wx1, wy1;  // well centers
  float v00, v01;            // well depths
  float r0, k;
};

static constexpr int kTile = 256;      // particles per tile = threads per block
static constexpr int kWarps = kTile / 32;
static constexpr int kEpilogueWarps = 4;

__device__ __forceinline__ float min_image(float d, float l, float inv_l) {
  return d - l * rintf(d * inv_l);
}

// dx^2 + dy^2 rounded as fma(dy, dy, dx * dx), as XLA fuses the JAX
// package's sum and the plain PyTorch version (ops/box.py::squared_norm).
__device__ __forceinline__ float sq_norm(float dx, float dy) {
  return fmaf(dy, dy, __fmul_rn(dx, dx));
}

__device__ __forceinline__ float well_term(float x, float y, float cx,
                                           float cy, float v0,
                                           const PairParams& P) {
  const float dx = min_image(x - cx, P.lx, P.inv_lx);
  const float dy = min_image(y - cy, P.ly, P.inv_ly);
  const float r = sqrtf(sq_norm(dx, dy));
  const float t = 0.5f * (1.0f + tanhf(P.k * (r - P.r0)));
  return v0 * (1.0f - t);
}

// The upper-triangle tile pair number p = 0, 1, ... in row-major order:
// (0,0) (0,1) ... (0,T-1) (1,1) ... -> (ti, tj).
__device__ __forceinline__ void tile_pair(int p, int tiles, int& ti,
                                          int& tj) {
  ti = 0;
  while (p >= tiles - ti) {
    p -= tiles - ti;
    ++ti;
  }
  tj = ti + p;
}

// grid (num_chains, num_tiles * (num_tiles + 1) / 2), block kTile.
// pos: (C, N, 2).  part_e, part_w: (C, P) float; part_o: (C, P) int.
__global__ void __launch_bounds__(kTile)
pair_tiles_kernel(PairParams P, const float2* __restrict__ pos,
                  float* __restrict__ part_e, float* __restrict__ part_w,
                  int* __restrict__ part_o) {
  __shared__ float2 tile_j[kTile];
  __shared__ float red_e[kWarps], red_w[kWarps];
  __shared__ int red_o[kWarps];

  const int c = blockIdx.x;
  const int p = blockIdx.y;
  const int num_pairs = gridDim.y;
  int ti, tj;
  tile_pair(p, P.num_tiles, ti, tj);
  const float2* chain = pos + (size_t)c * P.n;

  const int t = threadIdx.x;
  const int j0 = tj * kTile;
  const int jn = min(kTile, P.n - j0);
  if (t < jn) tile_j[t] = chain[j0 + t];
  const int i = ti * kTile + t;
  const bool row = i < P.n;
  const float2 pi = row ? chain[i] : make_float2(0.0f, 0.0f);
  __syncthreads();

  // the diagonal tile keeps j > i; the padding past N is outside [0, jn)
  const int j_first = (ti == tj) ? t + 1 : 0;
  float e = 0.0f, w = 0.0f;
  int ov = 0;
  if (row) {
    for (int j = j_first; j < jn; ++j) {
      const float2 pj = tile_j[j];
      const float dx = min_image(pi.x - pj.x, P.lx, P.inv_lx);
      const float dy = min_image(pi.y - pj.y, P.ly, P.inv_ly);
      const float r2 = sq_norm(dx, dy);
      const float sr2 = P.sigma2 / fmaxf(r2, 1e-24f);
      const float sr6 = sr2 * (sr2 * sr2);
      const float sr12 = sr6 * sr6;
      if (r2 <= P.r_cut2) {
        e += P.eps4 * (sr12 - sr6) - P.shift;
        w += P.eps48 * (sr12 - 0.5f * sr6);
      }
      ov += (r2 < P.hc2);
    }
  }

  // butterfly within each warp, then warp 0 over the warps: a fixed order
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    e += __shfl_xor_sync(0xffffffffu, e, off);
    w += __shfl_xor_sync(0xffffffffu, w, off);
    ov += __shfl_xor_sync(0xffffffffu, ov, off);
  }
  const int warp = t >> 5, lane = t & 31;
  if (lane == 0) {
    red_e[warp] = e;
    red_w[warp] = w;
    red_o[warp] = ov;
  }
  __syncthreads();
  if (t == 0) {
    float se = 0.0f, sw = 0.0f;
    int so = 0;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) {
      se += red_e[k];
      sw += red_w[k];
      so += red_o[k];
    }
    const size_t out = (size_t)c * num_pairs + p;
    part_e[out] = se;
    part_w[out] = sw;
    part_o[out] = so;
  }
}

// grid ceil(C / kEpilogueWarps), block 32 * kEpilogueWarps: one warp per
// chain.  energy, virial: (C,) float.
__global__ void __launch_bounds__(32 * kEpilogueWarps)
pair_epilogue_kernel(PairParams P, int num_pairs,
                     const float2* __restrict__ pos,
                     const float* __restrict__ part_e,
                     const float* __restrict__ part_w,
                     const int* __restrict__ part_o,
                     float* __restrict__ energy, float* __restrict__ virial) {
  const int c = blockIdx.x * kEpilogueWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (c >= P.num_chains) return;     // whole warps leave together

  float e = 0.0f, w = 0.0f, v = 0.0f;
  int ov = 0;
  const size_t base = (size_t)c * num_pairs;
  for (int q = lane; q < num_pairs; q += 32) {
    e += part_e[base + q];
    w += part_w[base + q];
    ov += part_o[base + q];
  }
  if (P.num_wells > 0) {
    const float2* chain = pos + (size_t)c * P.n;
    for (int i = lane; i < P.n; i += 32) {
      const float2 x = chain[i];
      v += well_term(x.x, x.y, P.wx0, P.wy0, P.v00, P);
      if (P.num_wells >= 2) v += well_term(x.x, x.y, P.wx1, P.wy1, P.v01, P);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    e += __shfl_xor_sync(0xffffffffu, e, off);
    w += __shfl_xor_sync(0xffffffffu, w, off);
    v += __shfl_xor_sync(0xffffffffu, v, off);
    ov += __shfl_xor_sync(0xffffffffu, ov, off);
  }
  if (lane == 0) {
    const float inf = __int_as_float(0x7f800000);
    energy[c] = ov > 0 ? inf : e + v;
    virial[c] = ov > 0 ? inf : w;
  }
}

static int num_tile_pairs(const PairParams& P) {
  return P.num_tiles * (P.num_tiles + 1) / 2;
}

static bool valid(const PairParams& P) {
  return P.n >= 1 && P.num_chains >= 1 &&
         P.num_tiles == (P.n + kTile - 1) / kTile &&
         num_tile_pairs(P) <= 65535 && P.num_wells >= 0 && P.num_wells <= 2;
}

// pos: (C, N, 2) float32.  part_e, part_w: (C, P) float32, part_o: (C, P)
// int32, with P = num_tiles * (num_tiles + 1) / 2, overwritten.
extern "C" int flowstate_pair_tiles(const PairParams* params,
                                    const float* pos, float* part_e,
                                    float* part_w, int* part_o,
                                    void* stream) {
  const PairParams P = *params;
  if (!valid(P)) return (int)cudaErrorInvalidValue;
  const dim3 grid(P.num_chains, num_tile_pairs(P));
  pair_tiles_kernel<<<grid, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
      P, reinterpret_cast<const float2*>(pos), part_e, part_w, part_o);
  return (int)cudaGetLastError();
}

// The partials of flowstate_pair_tiles -> energy, virial: (C,) float32.
extern "C" int flowstate_pair_epilogue(const PairParams* params,
                                       const float* pos, const float* part_e,
                                       const float* part_w,
                                       const int* part_o, float* energy,
                                       float* virial, void* stream) {
  const PairParams P = *params;
  if (!valid(P)) return (int)cudaErrorInvalidValue;
  const dim3 grid((P.num_chains + kEpilogueWarps - 1) / kEpilogueWarps);
  pair_epilogue_kernel<<<grid, 32 * kEpilogueWarps, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      P, num_tile_pairs(P), reinterpret_cast<const float2*>(pos), part_e,
      part_w, part_o, energy, virial);
  return (int)cudaGetLastError();
}
