// The torus EGNN's message passing (flows/nets.py::TorusEGNN), up to
// kMaxLayers layers of one conditioner call in one launch.
//
// Replaces no TPU kernel.  On the TPU, XLA fused the JAX package's jnp EGNN
// (flowstate_tpu/flows/nets.py::TorusEGNN) into a few fusions, so it never
// needed a Pallas kernel; on this card the same composition in eager
// PyTorch is some 32 launches a call, and each layer writes and rereads
// the message inputs [h_i, h_j, e_ij] of every ordered pair of nodes,
// (rows, N, N, 2H + 2) float32, then makes four more passes over the
// (rows, N, N, H) messages (bias, SiLU, the diagonal mask, the sum over
// senders).  One launch computes, for each row's N nodes of one coordinate
// on the 2 pi torus (the couplings' feat_dim = 1) and their node states h
// (N, H) after the embedding:
//   * rel_ij = c_i - c_j wrapped by 2 pi rint(rel_ij / 2 pi) (rint rounds
//     half to even, as torch.round), e_ij = [sin rel_ij, cos rel_ij];
//   * each layer: pre_ij = (W_a h_i + b_m) + W_b h_j + W_e e_ij, where W_a
//     is rows 0 .. H-1 of the message linear, W_b rows H .. 2H-1 and W_e
//     the last 2; agg_i = the sum over j != i of SiLU(pre_ij), j in order;
//     h_i <- h_i + SiLU([h_i, agg_i] W_u + b_u);
// and writes the node states after the last layer.  SiLU is x / (1 +
// expf(-x)), as PyTorch's; sinf, cosf, expf and the division are the
// accurate ones, and every product a float32 FMA (no tensor cores).
//
// What bounds it on this card: operations.  The factorised products are
// 2 (2 N H H) + 2 N (N - 1) 2H + 2 N 2H H a row and layer (276,480 at
// N = 8, H = 64), while the bytes that must move are the coordinates and
// the node states in and out (2.1 KB a row).  Beside the products, each of
// the N (N - 1) H messages costs a SiLU, some 20 instructions.
//
// What the design does about it.  Nothing but the inputs, the weights and
// the final states touches device memory.  A block keeps its rows' node
// states and W_b h (and, past kChunk nodes, the aggregates apart) in shared
// memory for the whole launch, and stages each layer's message weight,
// then its update weight, there where they fit beside them (H up to 128 at
// N = 8); wider layers read their weights through the read-only cache from
// L2, where every block finds them.  A thread owns one row and four
// channels.  It accumulates W_b h_j of its channels for every node into its
// own slots of shared memory (no other thread reads them), then W_a h_i +
// b_m for kChunk nodes at a time in registers (each float4 of h and of a
// weight row serves up to 32 FMAs), and loops over the senders with those
// still in registers, so the messages never leave them.  The row's pair
// features are computed once a launch into shared memory.  The update's
// product runs the same way over [h, agg], and the new states go back to
// shared memory for the next layer: in place after a barrier where the
// nodes fit in one chunk, else into W_b h's slots, which then trade places
// with the states.  A block holds the rows ops/cuda_egnn.plan gives (at most
// min(128 / N, 1024 / H), fewer where their states would pass the card's
// shared memory: 16 at N = 8, H = 64: 256 threads, 108 KB, two blocks an
// SM), so a call of 16,384 rows is 1,024 blocks, and with a leading net
// axis of G block g * blocks + b meets net g's weights.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (flowstate_tpu_torch/kernels/build.py).  Plain C entry
// point, loaded with ctypes; it returns a cudaError_t.  float32 only: every
// flow on the card is float32, and flows/nets.py sends other dtypes to the
// plain version.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int kThreads = 256;     // a block
constexpr int kChunk = 8;         // nodes whose sums a thread holds at once
constexpr int kMaxHidden = 1024;  // H, a multiple of 4: H / 4 threads a row
constexpr int kMaxLayers = 4;     // a launch
constexpr int kNodeSlots = 128;   // node states a block keeps at most
constexpr int kMaxShared = 232448;  // bytes a block may opt in to on sm_90
// 2 pi as PyTorch rounds the Python scalar 2 * math.pi to float32
constexpr float kTwoPi = 6.28318530717958647692f;

}  // namespace

struct EgnnParams {         // mirrored by ops/cuda_egnn._EgnnParams
  long long rows;           // B rows a net
  int nets;                 // G
  int net_axis;             // 1: each weight has a leading axis of G nets
  int nodes;                // N
  int hidden;               // H
  int layers;               // L
  int block_rows;           // rows a block (ops/cuda_egnn.plan)
  int staged;               // 1: each layer's weights staged in shared memory
  const float* msg_w[kMaxLayers];  // ([G,] 2H + 2, H)
  const float* msg_b[kMaxLayers];  // ([G,] H)
  const float* upd_w[kMaxLayers];  // ([G,] 2H, H)
  const float* upd_b[kMaxLayers];  // ([G,] H)
};

namespace {

__device__ __forceinline__ float silu(float x) {  // F.silu's arithmetic
  return x / (1.0f + expf(-x));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// a weight's float4: from shared memory where staged, else from L2
template <bool kStaged>
__device__ __forceinline__ float4 weight4(const float* p) {
  return kStaged ? ld4(p) : ldg4(p);
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ float lane(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// acc[i] += x_i . w over rows k0 .. k0 + H - 1 of a (K, H) weight at
// channels c0 .. c0 + 3, x_i the H values of node i < cn at x + i * h
template <bool kStaged>
__device__ __forceinline__ void node_product(const float* x, int cn, int h,
                                             const float* w, int k0, int c0,
                                             float (&acc)[kChunk][4]) {
  for (int k = 0; k < h; k += 4) {
    float4 xv[kChunk];
#pragma unroll
    for (int i = 0; i < kChunk; ++i)
      if (i < cn) xv[i] = ld4(x + i * h + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 wv = weight4<kStaged>(w + (k0 + k + kk) * h + c0);
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        if (i < cn) {
          const float xs = lane(xv[i], kk);
          acc[i][0] = fmaf(xs, wv.x, acc[i][0]);
          acc[i][1] = fmaf(xs, wv.y, acc[i][1]);
          acc[i][2] = fmaf(xs, wv.z, acc[i][2]);
          acc[i][3] = fmaf(xs, wv.w, acc[i][3]);
        }
      }
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[kChunk][4]) {
#pragma unroll
  for (int i = 0; i < kChunk; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;
}

// A row's node states lie in n H + 4 floats: the pad puts the float4
// loads of the rows that neighbouring threads own on distinct banks.
__host__ __device__ __forceinline__ int row_floats(int n, int h) {
  return n * h + 4;
}

// floats of shared memory a block takes (ops/cuda_egnn.shared_bytes
// mirrors it): the node states, W_b h, past kChunk nodes the aggregates,
// where staged a layer's message weight (2H + 2, H), the pair features
// (rows, N, N, 2) and the coordinates (rows, N)
__host__ __device__ __forceinline__ long long shared_floats(int n, int h,
                                                            int rows,
                                                            int staged) {
  const long long buffers = n > kChunk ? 3 : 2;
  return buffers * rows * row_floats(n, h) +
         (staged ? (2LL * h + 2) * h : 0LL) + (long long)rows * n * n * 2 +
         (long long)rows * n;
}

// one layer's messages for this thread's row and channels: W_b h_j into
// brow, then agg_i into arow (brow itself within one chunk, once every
// W_b h_j of these channels is read)
template <bool kStaged>
__device__ __forceinline__ void messages(const float* hrow, float* brow,
                                         float* arow, const float* prow,
                                         int n, int h, int c0,
                                         const float* w,
                                         const float* __restrict__ bm) {
  float a[kChunk][4];
  for (int i0 = 0; i0 < n; i0 += kChunk) {
    const int cn = min(kChunk, n - i0);
    zero(a);
    node_product<kStaged>(hrow + i0 * h, cn, h, w, h, c0, a);
#pragma unroll
    for (int i = 0; i < kChunk; ++i)
      if (i < cn) store4(brow + (i0 + i) * h + c0, a[i]);
  }
  const float4 bias = ldg4(bm + c0);
  const float4 we0 = weight4<kStaged>(w + 2 * h * h + c0);
  const float4 we1 = weight4<kStaged>(w + (2 * h + 1) * h + c0);
  for (int i0 = 0; i0 < n; i0 += kChunk) {
    const int cn = min(kChunk, n - i0);
    zero(a);
    node_product<kStaged>(hrow + i0 * h, cn, h, w, 0, c0, a);
    // the messages to node i0 + i, summed into its registers
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      if (i >= cn) continue;
      const float ai[4] = {a[i][0] + bias.x, a[i][1] + bias.y,
                           a[i][2] + bias.z, a[i][3] + bias.w};
      const float2* e = reinterpret_cast<const float2*>(prow) + (i0 + i) * n;
      float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        if (j == i0 + i) continue;
        const float4 bj = ld4(brow + j * h + c0);
        const float2 ej = e[j];
        float pre[4] = {ai[0] + bj.x, ai[1] + bj.y, ai[2] + bj.z,
                        ai[3] + bj.w};
        pre[0] = fmaf(ej.x, we0.x, pre[0]);
        pre[1] = fmaf(ej.x, we0.y, pre[1]);
        pre[2] = fmaf(ej.x, we0.z, pre[2]);
        pre[3] = fmaf(ej.x, we0.w, pre[3]);
        pre[0] = fmaf(ej.y, we1.x, pre[0]);
        pre[1] = fmaf(ej.y, we1.y, pre[1]);
        pre[2] = fmaf(ej.y, we1.z, pre[2]);
        pre[3] = fmaf(ej.y, we1.w, pre[3]);
#pragma unroll
        for (int c = 0; c < 4; ++c) s[c] += silu(pre[c]);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) a[i][c] = s[c];
    }
#pragma unroll
    for (int i = 0; i < kChunk; ++i)
      if (i < cn) store4(arow + (i0 + i) * h + c0, a[i]);
  }
}

// one layer's update, every thread of the block (it holds the barrier of
// an in-place write): h_i + SiLU([h_i, agg_i] W_u + b_u) of this thread's
// row and channels into next, which is hrow itself within one chunk
template <bool kStaged>
__device__ __forceinline__ void update(bool active, const float* hrow,
                                       const float* arow, float* next,
                                       int n, int h, int c0, const float* w,
                                       const float* __restrict__ bu) {
  float u[kChunk][4];
  for (int i0 = 0; i0 < n; i0 += kChunk) {
    const int cn = min(kChunk, n - i0);
    zero(u);
    if (active) {
      node_product<kStaged>(hrow + i0 * h, cn, h, w, 0, c0, u);
      node_product<kStaged>(arow + i0 * h, cn, h, w, h, c0, u);
      const float4 bias = ldg4(bu + c0);
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        if (i >= cn) continue;
        const float4 hv = ld4(hrow + (i0 + i) * h + c0);
        u[i][0] = hv.x + silu(u[i][0] + bias.x);
        u[i][1] = hv.y + silu(u[i][1] + bias.y);
        u[i][2] = hv.z + silu(u[i][2] + bias.z);
        u[i][3] = hv.w + silu(u[i][3] + bias.w);
      }
    }
    if (n <= kChunk) __syncthreads();  // every read of the states done
    if (active) {
#pragma unroll
      for (int i = 0; i < kChunk; ++i)
        if (i < cn) store4(next + (i0 + i) * h + c0, u[i]);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
    egnn_messages_kernel(const EgnnParams p, const float* __restrict__ coords,
                         const float* __restrict__ h_in,
                         float* __restrict__ h_out, int blocks_per_net) {
  extern __shared__ __align__(16) float smem[];
  const int n = p.nodes, h = p.hidden, rows = p.block_rows;
  const int m_all = rows * n, h4 = h / 4, rs = row_floats(n, h);
  const bool chunked = n > kChunk;
  float* hsm = smem;                 // states: row r, node i at r rs + i h
  float* bsm = hsm + rows * rs;      // W_b h (and within a chunk, the
                                     // aggregates)
  float* asm_ = chunked ? bsm + rows * rs : bsm;  // the aggregates
  float* wsm = smem + (chunked ? 3 : 2) * rows * rs;  // a staged weight
  float* pairs = wsm + (p.staged ? (2 * h + 2) * h : 0);  // (rows, n, n, 2)
  float* cs = pairs + m_all * n * 2;  // coordinates (rows, n)

  const int g = blockIdx.x / blocks_per_net;
  const long long first = (long long)(blockIdx.x % blocks_per_net) * rows;
  const long long left = p.rows - first;
  const int valid = left < rows ? (int)left : rows;
  const long long row0 = (long long)g * p.rows + first;  // of the G B rows
  const int t = threadIdx.x;

  for (int e = t; e < m_all; e += kThreads)
    cs[e] = e < valid * n ? coords[row0 * n + e] : 0.0f;
  for (int e = t; e < m_all * h4; e += kThreads) {
    const int m = e / h4, k = (e - m * h4) * 4;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (m < valid * n) v = ld4(h_in + (row0 * n + m) * h + k);
    *reinterpret_cast<float4*>(hsm + (m / n) * rs + (m % n) * h + k) = v;
  }
  __syncthreads();
  // the pair features, as the plain version rounds them: a division, a
  // product and a difference each rounded (no contraction to an FMA)
  for (int pair = t; pair < m_all * n; pair += kThreads) {
    const int j = pair % n, ri = pair / n, r = ri / n;  // (r n + i) n + j
    const float d = __fsub_rn(cs[ri], cs[r * n + j]);
    const float turns = rintf(__fdiv_rn(d, kTwoPi));
    const float rel = __fsub_rn(d, __fmul_rn(kTwoPi, turns));
    pairs[2 * pair] = sinf(rel);
    pairs[2 * pair + 1] = cosf(rel);
  }
  __syncthreads();

  // this thread's row and channels c0 .. c0 + 3
  const bool active = t < rows * h4;
  const int r = active ? t / h4 : 0;
  const int c0 = (t - r * h4) * 4;
  const float* prow = pairs + r * n * n * 2;
  float* arow = asm_ + r * rs;

  for (int l = 0; l < p.layers; ++l) {
    const long long net = p.net_axis ? g : 0;  // net g's weights
    const float* wm = p.msg_w[l] + net * (2 * h + 2) * h;
    const float* bm = p.msg_b[l] + net * h;
    const float* wu = p.upd_w[l] + net * 2 * h * h;
    const float* bu = p.upd_b[l] + net * h;
    float* hrow = hsm + r * rs;
    float* brow = bsm + r * rs;
    float* next = chunked ? brow : hrow;

    if (p.staged) {  // the message weight into shared memory
      for (int e = t; e < (2 * h + 2) * h / 4; e += kThreads)
        *reinterpret_cast<float4*>(wsm + 4 * e) = ldg4(wm + 4 * e);
      __syncthreads();
      if (active) messages<true>(hrow, brow, arow, prow, n, h, c0, wsm, bm);
      __syncthreads();  // every aggregate written, the message weight read
      for (int e = t; e < 2 * h * h / 4; e += kThreads)  // the update weight
        *reinterpret_cast<float4*>(wsm + 4 * e) = ldg4(wu + 4 * e);
      __syncthreads();
      update<true>(active, hrow, arow, next, n, h, c0, wsm, bu);
    } else {
      if (active) messages<false>(hrow, brow, arow, prow, n, h, c0, wm, bm);
      __syncthreads();  // every aggregate written
      update<false>(active, hrow, arow, next, n, h, c0, wu, bu);
    }
    __syncthreads();  // the new states written, the old ones read
    if (chunked) {    // the new states lie in W_b h's slots
      float* old = hsm;
      hsm = bsm;
      bsm = old;
    }
  }

  for (int e = t; e < valid * n * h4; e += kThreads) {
    const int m = e / h4, k = (e - m * h4) * 4;
    *reinterpret_cast<float4*>(h_out + (row0 * n + m) * h + k) =
        ld4(hsm + (m / n) * rs + (m % n) * h + k);
  }
}

}  // namespace

// coords (G B, N), h_in and h_out (G B, N, H): float32, contiguous, h_in,
// h_out and every weight 16-byte aligned.  One launch on `stream`.
extern "C" int flowstate_egnn_messages(const EgnnParams* params,
                                       const float* coords, const float* h_in,
                                       float* h_out, void* stream) {
  const EgnnParams P = *params;
  if (P.rows < 1 || P.nets < 1 || P.nodes < 1 || P.hidden < 4 ||
      P.hidden > kMaxHidden || P.hidden % 4 != 0 || P.layers < 1 ||
      P.layers > kMaxLayers || (P.net_axis != 0 && P.net_axis != 1) ||
      (P.staged != 0 && P.staged != 1) || P.block_rows < 1 ||
      P.block_rows > kNodeSlots ||
      P.block_rows * (P.hidden / 4) > kThreads)
    return (int)cudaErrorInvalidValue;
  const long long floats =
      shared_floats(P.nodes, P.hidden, P.block_rows, P.staged);
  if (floats * (long long)sizeof(float) > kMaxShared)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = (size_t)floats * sizeof(float);
  const long long per_net = (P.rows + P.block_rows - 1) / P.block_rows;
  if (per_net > INT_MAX / P.nets) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {  // opt in, on the current device
    const cudaError_t rc = cudaFuncSetAttribute(
        egnn_messages_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (rc != cudaSuccess) return (int)rc;
  }
  egnn_messages_kernel<<<(unsigned)(per_net * P.nets), kThreads, bytes,
                         static_cast<cudaStream_t>(stream)>>>(
      P, coords, h_in, h_out, (int)per_net);
  return (int)cudaGetLastError();
}
