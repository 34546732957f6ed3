// The fp32 issue-rate probe: independent multiply-add chains per element,
// one thread per element, all in registers.
//
// Replaces tools/n_scaling.py::calibrate_vpu_ops's inner `kernel` (the
// Pallas TPU kernel that reads the TPU's elementwise roof).  Per float32
// element x of its input it computes
//   a_i = x + i                          for i = 0 .. n_acc - 1
//   iters times, for each i, depth times:  a_i = a_i * c_i + 1e-7
//                                           c_i = float32(1 + 1e-7 (i + 1))
//   out = a_0 + a_1 + ... + a_{n_acc-1}  (summed in order)
// as the TPU kernel does, except that a multiply and its add are one FFMA
// here (one rounding instead of two).
//
// What bounds it on this card: issue.  It moves 8 bytes per element and
// does 2 n_acc depth iters fp32 operations on it (an FMA counts two), so
// every byte is worth hundreds of thousands of operations.  The point is
// to read the rate at which the SMs retire FFMA, 132 SMs x 128 lanes x 2
// operations per clock.  The design therefore:
//   * makes n_acc a template parameter (16, 32, 64, 128, the JAX tool's
//     widths) and the depth a constant (8, its depth), so the accumulators
//     are an array the compiler keeps in registers (a runtime n_acc would
//     put them in local memory and measure its traffic);
//   * unrolls the depth and accumulator loops completely, so each
//     iteration of the runtime `iters` loop is n_acc x depth FFMA against
//     three loop instructions;
//   * passes c_i and the addend as kernel parameters, so each FFMA reads
//     its c_i from the constant bank and the addend from one register.
//     With both as literals, ptxas made the addend the immediate and
//     rebuilt the c_i in registers inside the loop (13 HFMA2/MOV per 128
//     FFMA at n_acc 16, depth 8: the loop was 89% FFMA);
//   * keeps the chains independent, so up to n_acc FFMA per thread are
//     in flight and the pipeline's latency is hidden by the thread's own
//     work, not only by other warps;
//   * launches one thread per element of a (B, 8, 128) input; the caller
//     picks B = 4 x the SM count, so every SM holds several blocks.
// The TPU kernel ran one (8, 128) tile, the vector unit of its one core.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (flowstate_tpu_torch/kernels/build.py).  Plain C entry
// point, loaded with ctypes; it returns the cudaError_t of its launch.

#include <cuda_runtime.h>

static constexpr int kThreads = 256;
static constexpr int kMaxAcc = 128;
static constexpr int kDepth = 8;   // the JAX tool's depth

struct Steps {             // one step of chain i: a = a * c[i] + add
  float c[kMaxAcc];
  float add;
};

template <int kAcc>
__global__ void __launch_bounds__(kThreads)
issue_rate_kernel(const float* __restrict__ x, float* __restrict__ out,
                  int num_elems, int iters, const Steps steps) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= num_elems) return;
  const float xe = x[e];
  float a[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) a[i] = xe + (float)i;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
#pragma unroll
      for (int d = 0; d < kDepth; ++d) a[i] = fmaf(a[i], steps.c[i], steps.add);
    }
  }
  float s = a[0];
#pragma unroll
  for (int i = 1; i < kAcc; ++i) s += a[i];
  out[e] = s;
}

template <int kAcc>
static int launch(const float* x, float* out, int num_elems, int iters,
                  cudaStream_t stream) {
  static_assert(kAcc <= kMaxAcc, "Steps holds kMaxAcc coefficients");
  Steps steps;
  for (int i = 0; i < kMaxAcc; ++i)
    steps.c[i] = (float)(1.0 + 1e-7 * (i + 1));  // float32(1 + 1e-7 (i+1))
  steps.add = 1e-7f;
  const int blocks = (num_elems + kThreads - 1) / kThreads;
  issue_rate_kernel<kAcc><<<blocks, kThreads, 0, stream>>>(
      x, out, num_elems, iters, steps);
  return (int)cudaGetLastError();
}

// x, out: num_elems float32 each (a (B, 8, 128) tensor).  n_acc must be one
// of the instantiated widths (tools/n_scaling.py: ISSUE_RATE_WIDTHS) and
// depth kDepth; anything else returns cudaErrorInvalidValue without a
// launch.
extern "C" int flowstate_issue_rate(const float* x, float* out,
                                    int num_elems, int n_acc, int depth,
                                    int iters, void* stream) {
  if (num_elems < 1 || iters < 0 || depth != kDepth)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_acc) {  // the widths instantiated: ISSUE_RATE_WIDTHS
    case 16: return launch<16>(x, out, num_elems, iters, s);
    case 32: return launch<32>(x, out, num_elems, iters, s);
    case 64: return launch<64>(x, out, num_elems, iters, s);
    case 128: return launch<128>(x, out, num_elems, iters, s);
  }
  return (int)cudaErrorInvalidValue;
}
