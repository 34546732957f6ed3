// The rational-quadratic spline of ops/splines.py, one launch per call.
//
// Replaces no TPU kernel.  On the TPU, XLA fused the JAX package's jnp
// spline (flowstate_tpu/ops/splines.py::unconstrained_rational_quadratic_
// spline) into a few fusions, so it never needed a Pallas kernel; on this
// card the same composition in eager PyTorch is some 77 launches forward
// and 91 inverse a call, and the scan of the knots (torch.cumsum over the
// bins) alone took most of the big-move round.  One launch computes, for
// every element x of a (B, D) input with the parameters of its row and
// dimension, what unconstrained_rational_quadratic_spline computes:
//   * softmax of the unnormalized widths and heights (times `scale`, the
//     couplings' 1/sqrt(hidden)), floored at min_bin_*, knots by prefix
//     sum on [-tail_bound, tail_bound] with both ends pinned;
//   * the two slopes of the chosen bin, min_derivative + softplus of the
//     unnormalized derivatives padded by the tail rule (ops/splines.py::
//     _pad_derivatives: "linear", "circular", or one rule per dimension
//     with circular_tie);
//   * the bin by the plain version's rule: the count of knots <= x, with
//     eps added to the last knot only, less one, clipped to the bins;
//   * the RQ map, or its inverse through |b^2 - 4ac|, and its log-det;
//   * identity with zero log-det outside [-tail_bound, tail_bound];
// and writes the outputs (B, D) and the log-det summed over the row's D
// dimensions (B,).
//
// What bounds it on this card: bytes.  A call reads each row's raw
// parameters once (B x D x (3 bins + 1) values: 76 MB at the A1 round's
// B = 65,536, D = 3, 32 bins, 23 us at 3.35 TB/s) and does some 20
// operations a bin.  The parameters arrive by stride: the conditional
// spline reads the net's raw output (B, D, 3 bins + 1) in place, the
// unconditional one its (D, bins) parameters with a batch stride of 0, so
// nothing is materialised before the launch.
//
// What the design does about it.  One warp a row, looping over the row's
// D dimensions; lane i holds bin i (bins <= 32), so a dimension's widths,
// heights and derivatives are three coalesced loads of up to 128 bytes,
// and the next dimension's loads are issued before this one's arithmetic.
// Every intermediate stays in registers: max and sum of the softmax by
// shuffle butterflies, the knots by a five-step shuffle scan, the bin by
// __ballot_sync and __popc, the chosen bin's knots and sizes from its
// lane by shuffle.  Lane j keeps what dimension j needs for its map (the
// bin's knots and sizes, its two unnormalized slopes), and the maps of up
// to 32 dimensions then run at once, a lane each, with softplus on the two
// slopes used; the row's log-det is their shuffle sum.  At the A1 round a
// call is 65,536 warps in 8,192 blocks of 8.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (flowstate_tpu_torch/kernels/build.py).  Plain C entry
// point, loaded with ctypes; it returns a cudaError_t.  float32 only: every
// flow on the card is float32, and ops/splines.py sends other dtypes to the
// plain version.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kRowsPerBlock = 8;  // warps (rows) a block
constexpr int kMaxBins = 32;      // a bin a lane
constexpr unsigned kFull = 0xffffffffu;

// `tails`: every dimension linear (derivative slots: bins - 1, the ends
// the identity slope), every dimension circular (bins slots, the last knot
// takes slot 0), or one rule per dimension (bins + 1 slots; `linear`
// flags the linear dimensions, nullptr for none)
constexpr int kTailsLinear = 0;
constexpr int kTailsCircular = 1;
constexpr int kTailsPerDim = 2;

}  // namespace

struct SplineParams {     // mirrored by ops/cuda_spline._SplineParams
  long long batch;        // B rows
  long long x_sb, x_sd;   // strides of the inputs (B, D), in elements
  long long w_sb, w_sd;   // of the unnormalized widths (B, D, bins)
  long long h_sb, h_sd;   // of the unnormalized heights (B, D, bins)
  long long d_sb, d_sd;   // of the unnormalized derivatives (B, D, slots)
  int dims;               // D
  int bins;               // 1 ... 32
  int slots;              // derivative slots a dimension
  int tails;              // kTailsLinear, kTailsCircular or kTailsPerDim
  int tie;                // per-dimension circular: last slope = first's
  int inverse;            // 0 the map, 1 its inverse
  double scale;           // multiplies the widths and heights
  double tail_bound;
  double min_bin_width, min_bin_height, min_derivative;
  double identity_derivative;  // the linear ends' unnormalized slope
  double eps;             // added to the last knot in the bin search
};

namespace {

__device__ __forceinline__ float softplus(float v) {  // F.softplus, beta 1,
  return v > 20.0f ? v : log1pf(expf(v));             // threshold 20
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float t = __shfl_xor_sync(kFull, v, o);
    v = t > v ? t : v;
  }
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Bin `lane` of one dimension from its unnormalized size u (lanes >= bins
// idle): its left knot, right knot and size on [left, right], as
// ops/splines.py::_knots gives them.
__device__ __forceinline__ void knots(float u, bool in_bin, int lane,
                                      int bins, double min_size, float left,
                                      float right, float& lo, float& hi,
                                      float& size) {
  const float v = in_bin ? u : -INFINITY;
  const float m = warp_max(v);
  const float e = in_bin ? expf(v - m) : 0.0f;
  const float prob = e / warp_sum(e);
  float c = in_bin ? (float)min_size + (float)(1.0 - min_size * bins) * prob
                   : 0.0f;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float t = __shfl_up_sync(kFull, c, o);
    if (lane >= o) c += t;
  }
  hi = lane == bins - 1 ? right : (right - left) * c + left;
  lo = __shfl_up_sync(kFull, hi, 1);
  if (lane == 0) lo = left;
  size = hi - lo;
}

// The unnormalized slope at knot k (0 ... bins, the same on every lane) of
// a dimension whose derivative slot s lies in lane s's `a` (s < 32) or
// lane s - 32's `b`.
__device__ __forceinline__ float knot_slope(const SplineParams& p,
                                            bool linear, int k, float a,
                                            float b) {
  bool end;  // a linear end: the identity slope
  int s;
  if (p.tails == kTailsLinear) {
    end = k == 0 || k == p.bins;
    s = k - 1;
  } else if (p.tails == kTailsCircular) {
    end = false;
    s = k == p.bins ? 0 : k;
  } else {
    end = linear && (k == 0 || k == p.bins);
    s = !linear && p.tie && k == p.bins ? 0 : k;
  }
  s = s < 0 ? 0 : s;
  const float va = __shfl_sync(kFull, a, s & 31);
  const float vb = __shfl_sync(kFull, b, s & 31);
  return end ? (float)p.identity_derivative : (s < 32 ? va : vb);
}

// The RQ map of one element (or its inverse) and its log-det, from the
// chosen bin's knots (cw, ch), sizes and the two unnormalized slopes; the
// plain version's arithmetic, operation for operation.
__device__ __forceinline__ void rq_map(bool inverse, float xc, float cw,
                                       float width, float ch, float height,
                                       float u0, float u1, float min_d,
                                       float& y, float& ld) {
  const float delta = height / width;
  const float d0 = min_d + softplus(u0);
  const float d1 = min_d + softplus(u1);
  const float d_sum = d0 + d1 - 2.0f * delta;
  if (inverse) {
    const float shifted = xc - ch;
    const float qa = shifted * d_sum + height * (delta - d0);
    const float qb = height * d0 - shifted * d_sum;
    const float qc = -delta * shifted;
    const float disc = fabsf(qb * qb - 4.0f * qa * qc);
    const float root = (2.0f * qc) / (-qb - sqrtf(disc));
    y = root * width + cw;
    const float tomt = root * (1.0f - root);
    const float denom = delta + d_sum * tomt;
    const float num = (delta * delta) * (d1 * (root * root) +
                                         2.0f * delta * tomt +
                                         d0 * ((1.0f - root) * (1.0f - root)));
    ld = -(logf(num) - 2.0f * logf(denom));
  } else {
    const float theta = (xc - cw) / width;
    const float tomt = theta * (1.0f - theta);
    const float numer = height * (delta * (theta * theta) + d0 * tomt);
    const float denom = delta + d_sum * tomt;
    y = ch + numer / denom;
    const float num = (delta * delta) * (d1 * (theta * theta) +
                                         2.0f * delta * tomt +
                                         d0 * ((1.0f - theta) *
                                               (1.0f - theta)));
    ld = logf(num) - 2.0f * logf(denom);
  }
}

__global__ void __launch_bounds__(kRowsPerBlock * 32)
    rq_spline_kernel(const SplineParams p, const float* __restrict__ x,
                     const float* __restrict__ w, const float* __restrict__ h,
                     const float* __restrict__ d,
                     const uint8_t* __restrict__ linear,
                     float* __restrict__ out, float* __restrict__ logdet) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= p.batch) return;  // the whole warp
  const int bins = p.bins;
  const bool in_bin = lane < bins;
  const float bound = (float)p.tail_bound;
  const float scale = (float)p.scale;

  // the loads of dimension j: the input (every lane the same address),
  // this lane's bin of widths and heights, derivative slots lane, lane + 32
  float xv, wv, hv, da, db;
  auto load = [&](int j) {
    xv = x[row * p.x_sb + j * p.x_sd];
    wv = in_bin ? w[row * p.w_sb + j * p.w_sd + lane] : 0.0f;
    hv = in_bin ? h[row * p.h_sb + j * p.h_sd + lane] : 0.0f;
    const float* dj = d + row * p.d_sb + j * p.d_sd;
    da = lane < p.slots ? dj[lane] : 0.0f;
    db = lane + 32 < p.slots ? dj[lane + 32] : 0.0f;
  };
  if (p.dims > 0) load(0);

  // what dimension base + lane needs for its map, kept by that lane; the
  // maps of a group of up to 32 dimensions run together, a lane each
  float my_x = 0.0f, my_cw = 0.0f, my_w = 1.0f, my_ch = 0.0f, my_h = 1.0f;
  float my_u0 = 0.0f, my_u1 = 0.0f;
  float total = 0.0f;
  for (int j = 0; j < p.dims; ++j) {
    const float xin = xv, uw = wv * scale, uh = hv * scale, a = da, b = db;
    if (j + 1 < p.dims) load(j + 1);
    const bool lin = p.tails == kTailsPerDim && linear != nullptr &&
                     linear[j] != 0;

    float lo_w, hi_w, bw, lo_h, hi_h, bh;
    knots(uw, in_bin, lane, bins, p.min_bin_width, -bound, bound, lo_w, hi_w,
          bw);
    knots(uh, in_bin, lane, bins, p.min_bin_height, -bound, bound, lo_h, hi_h,
          bh);

    // torch.clamp keeps NaN: no fmin / fmax
    const float xc = xin < -bound ? -bound : (xin > bound ? bound : xin);
    const float hi = p.inverse ? hi_h : hi_w;
    const float top = lane == bins - 1 ? hi + (float)p.eps : hi;
    const unsigned votes = __ballot_sync(kFull, in_bin && xc >= top);
    int k = (xc >= -bound ? 1 : 0) + __popc(votes) - 1;
    k = k < 0 ? 0 : (k > bins - 1 ? bins - 1 : k);

    const float cw = __shfl_sync(kFull, lo_w, k);
    const float width = __shfl_sync(kFull, bw, k);
    const float ch = __shfl_sync(kFull, lo_h, k);
    const float height = __shfl_sync(kFull, bh, k);
    const float u0 = knot_slope(p, lin, k, a, b);
    const float u1 = knot_slope(p, lin, k + 1, a, b);
    const int slot = j & 31;
    if (lane == slot) {
      my_x = xin, my_cw = cw, my_w = width, my_ch = ch, my_h = height;
      my_u0 = u0, my_u1 = u1;
    }
    if (slot == 31 || j == p.dims - 1) {  // the group's maps, a lane each
      const int base = j - slot;
      float ld = 0.0f;
      if (lane <= slot) {
        const float mxc =
            my_x < -bound ? -bound : (my_x > bound ? bound : my_x);
        float y;
        rq_map(p.inverse != 0, mxc, my_cw, my_w, my_ch, my_h, my_u0, my_u1,
               (float)p.min_derivative, y, ld);
        const bool inside = my_x >= -bound && my_x <= bound;
        ld = inside ? ld : 0.0f;
        out[row * p.dims + base + lane] = inside ? y : my_x;
      }
      total += warp_sum(ld);
    }
  }
  if (lane == 0) logdet[row] = total;
}

}  // namespace

// x (B, D), w and h (B, D, bins), d (B, D, slots): float32, read by the
// strides in `params` (the last axis contiguous).  linear: D bytes, or
// nullptr.  out (B, D) and logdet (B,), contiguous, written.  One launch
// on `stream`.
extern "C" int flowstate_rq_spline(const SplineParams* params, const float* x,
                                   const float* w, const float* h,
                                   const float* d, const uint8_t* linear,
                                   float* out, float* logdet, void* stream) {
  const SplineParams P = *params;
  const int want_slots = P.tails == kTailsLinear     ? P.bins - 1
                         : P.tails == kTailsCircular ? P.bins
                                                     : P.bins + 1;
  if (P.batch < 1 || P.dims < 0 || P.bins < 1 || P.bins > kMaxBins ||
      P.tails < kTailsLinear || P.tails > kTailsPerDim ||
      P.slots != want_slots || (P.tails == kTailsLinear && P.bins < 2) ||
      (P.batch + kRowsPerBlock - 1) / kRowsPerBlock > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (P.batch + kRowsPerBlock - 1) / kRowsPerBlock;
  rq_spline_kernel<<<(unsigned)blocks, kRowsPerBlock * 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      P, x, w, h, d, linear, out, logdet);
  return (int)cudaGetLastError();
}
