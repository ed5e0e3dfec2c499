// Fused BLAS with a norm: two kernels of quda_tpu/ops/blas_pallas.py.
//
// B2, the CG tail: x' = x + alpha p, r' = r - alpha Ap, |r'|^2.  Replaces
// cg_update_norm2_pallas (pallas_call at :104); plain version quda_tpu_torch/
// ops/blas.py::triple_cg_update.  Per element it reads 4 floats and writes
// 2 (24 B) for 3 multiply-adds.  Its float64 form (the tail of the native
// double fused_cg; no TPU twin, a TPU has no f64) moves 48 B an element,
// with alpha, the vectors and |r'|^2 all float64.
//
// B3, the residual update of the reliable-update CG: y' = y + a x and
// |y'|^2, for float32 or bfloat16 storage.  Replaces axpy_norm2_pallas
// (pallas_call at :151); plain version quda_tpu_torch/ops/blas_pallas.py::
// axpy_norm2_plain.  y + a x is computed in f32 with one rounding per
// operation (__fmul_rn, __fadd_rn: no contraction into an FMA, so y' has the
// plain version's bits), rounded once to y's storage type, and the norm is
// summed over the ROUNDED stored value (blas_pallas.py:135-145).  Per
// element it reads 2 and writes 1: 12 B in f32, 6 B in bf16.  bf16 is read
// and written as __nv_bfloat162 pairs (n even; a last odd element is done
// alone).
//
// What bounds both on an H100: device memory; there is nothing to reuse.
//
// Design (both): a grid-stride loop over the flat arrays writes the updated
// vectors and keeps the running sum of squares per thread in f64.  Each
// block reduces in warp shuffles, then through shared memory, into one
// partial; a second launch of one block sums the partials.  TPU grid steps
// ran in order and carried the sum in SMEM; CUDA blocks run in no order, so
// there is no cross-block accumulator and no float atomic, and with a fixed
// grid the result is the same on every run.  The scalar (alpha, a) is read
// from device memory, so the host never waits for it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Sum over the block; the result is valid in thread 0.
__device__ __forceinline__ double block_sum(double v) {
  __shared__ double warp_part[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) warp_part[warp] = v;
  __syncthreads();
  v = threadIdx.x < kThreads / 32 ? warp_part[threadIdx.x] : 0.0;
  if (warp == 0) v = warp_sum(v);
  return v;
}

template <typename Re>
__global__ void __launch_bounds__(kThreads)
    cg_update_norm2_kernel(const Re* __restrict__ alpha,
                           const Re* __restrict__ p,
                           const Re* __restrict__ ap,
                           const Re* __restrict__ x,
                           const Re* __restrict__ r,
                           Re* __restrict__ x_out,
                           Re* __restrict__ r_out,
                           double* __restrict__ partial, int64_t n) {
  const Re a = __ldg(alpha);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  double acc = 0.0;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += stride) {
    const Re xv = x[i] + a * p[i];
    const Re rv = r[i] - a * ap[i];
    x_out[i] = xv;
    r_out[i] = rv;
    acc += static_cast<double>(rv) * static_cast<double>(rv);
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) partial[blockIdx.x] = acc;
}

template <typename Re>
__global__ void __launch_bounds__(kThreads)
    sum_partials_kernel(const double* __restrict__ partial, int nblocks,
                        Re* __restrict__ r2) {
  double acc = 0.0;
  for (int i = threadIdx.x; i < nblocks; i += kThreads) acc += partial[i];
  acc = block_sum(acc);
  if (threadIdx.x == 0) *r2 = static_cast<Re>(acc);
}

template <typename Re>
int cg_update_norm2(const Re* alpha, const Re* p, const Re* ap, const Re* x,
                    const Re* r, Re* x_out, Re* r_out, double* partial,
                    Re* r2, long long n, int nblocks, void* stream) {
  if (n <= 0 || nblocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cg_update_norm2_kernel<Re><<<nblocks, kThreads, 0, s>>>(
      alpha, p, ap, x, r, x_out, r_out, partial, static_cast<int64_t>(n));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_partials_kernel<Re><<<1, kThreads, 0, s>>>(partial, nblocks, r2);
  return static_cast<int>(cudaGetLastError());
}

__device__ __forceinline__ float axpy_rn(float a, float x, float y) {
  return __fadd_rn(y, __fmul_rn(a, x));
}

__global__ void __launch_bounds__(kThreads)
    axpy_norm2_f32_kernel(const float* __restrict__ a,
                          const float* __restrict__ x,
                          const float* __restrict__ y,
                          float* __restrict__ y_out,
                          double* __restrict__ partial, int64_t n) {
  const float av = __ldg(a);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  double acc = 0.0;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += stride) {
    const float v = axpy_rn(av, x[i], y[i]);
    y_out[i] = v;
    acc += static_cast<double>(v) * static_cast<double>(v);
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) partial[blockIdx.x] = acc;
}

__global__ void __launch_bounds__(kThreads)
    axpy_norm2_bf16_kernel(const float* __restrict__ a,
                           const __nv_bfloat16* __restrict__ x,
                           const __nv_bfloat16* __restrict__ y,
                           __nv_bfloat16* __restrict__ y_out,
                           double* __restrict__ partial, int64_t n) {
  const float av = __ldg(a);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t n2 = n / 2;
  const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(x);
  const __nv_bfloat162* y2 = reinterpret_cast<const __nv_bfloat162*>(y);
  __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(y_out);
  double acc = 0.0;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  for (int64_t i = first; i < n2; i += stride) {
    const float2 xv = __bfloat1622float2(x2[i]);
    const float2 yv = __bfloat1622float2(y2[i]);
    const __nv_bfloat162 o = __floats2bfloat162_rn(axpy_rn(av, xv.x, yv.x),
                                                   axpy_rn(av, xv.y, yv.y));
    o2[i] = o;
    const float2 of = __bfloat1622float2(o);
    acc += static_cast<double>(of.x) * static_cast<double>(of.x);
    acc += static_cast<double>(of.y) * static_cast<double>(of.y);
  }
  if ((n & 1) && first == 0) {
    const __nv_bfloat16 o = __float2bfloat16_rn(
        axpy_rn(av, __bfloat162float(x[n - 1]), __bfloat162float(y[n - 1])));
    y_out[n - 1] = o;
    const double of = static_cast<double>(__bfloat162float(o));
    acc += of * of;
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) partial[blockIdx.x] = acc;
}

}  // namespace

extern "C" int qtt_cg_update_norm2_f32(const float* alpha, const float* p,
                                       const float* ap, const float* x,
                                       const float* r, float* x_out,
                                       float* r_out, double* partial,
                                       float* r2, long long n, int nblocks,
                                       void* stream) {
  return cg_update_norm2<float>(alpha, p, ap, x, r, x_out, r_out, partial,
                                r2, n, nblocks, stream);
}

// The float64 form: every array, alpha and |r'|^2 float64.
extern "C" int qtt_cg_update_norm2_f64(const double* alpha, const double* p,
                                       const double* ap, const double* x,
                                       const double* r, double* x_out,
                                       double* r_out, double* partial,
                                       double* r2, long long n, int nblocks,
                                       void* stream) {
  return cg_update_norm2<double>(alpha, p, ap, x, r, x_out, r_out, partial,
                                 r2, n, nblocks, stream);
}

// bf16: x, y and y_out are bfloat16 (else float32); a is one float32 on the
// card.  |y'|^2 lands in n2 (float32), summed as for B2.
extern "C" int qtt_axpy_norm2(const float* a, const void* x, const void* y,
                              void* y_out, double* partial, float* n2,
                              long long n, int nblocks, int bf16,
                              void* stream) {
  if (n <= 0 || nblocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    axpy_norm2_bf16_kernel<<<nblocks, kThreads, 0, s>>>(
        a, static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(y),
        static_cast<__nv_bfloat16*>(y_out), partial, static_cast<int64_t>(n));
  } else {
    axpy_norm2_f32_kernel<<<nblocks, kThreads, 0, s>>>(
        a, static_cast<const float*>(x), static_cast<const float*>(y),
        static_cast<float*>(y_out), partial, static_cast<int64_t>(n));
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_partials_kernel<float><<<1, kThreads, 0, s>>>(partial, nblocks, n2);
  return static_cast<int>(cudaGetLastError());
}
