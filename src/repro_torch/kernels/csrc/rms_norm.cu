// RMSNorm forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces repro/kernels/rmsnorm.py::rms_norm_kernel, the Pallas TPU kernel:
//   out = x * rsqrt(mean(x^2) + eps) * (1 + scale)
// over the last axis, the sum of squares and the products in f32, the result
// cast to x's dtype.  x and out are [rows, d] (f32 or bf16); scale is [d]
// (f32 or bf16, independently of x).
//
// Design.  The TPU kernel tiles block_rows rows into VMEM and reads each tile
// once.  Here one block owns one row: its threads read the row once from
// device memory (16-byte vector loads when d and the pointers allow), keep it
// in shared memory as f32 while they sum the squares (warp shuffles, then one
// value per warp through shared memory), and write the normalised row from
// shared memory.  The block has as many threads as the row has vectors, in
// whole warps from 32 to 256, so a narrow row does not leave most threads
// idle.  Any d runs (1600 is not a power of two): a row that is not a whole
// number of vectors takes scalar loads.  Rows are not padded.
//
// What bounds it on the H100.  Each element is read once and written once,
// with a few f32 operations between: bytes bound it, 2 * rows * d * elt over
// 3.35 TB/s (~0.012 ms for hymba-1.5b's 6144 x 1600 bf16 prefill rows).  At a
// decode step (4 rows) the launch itself is the cost.
#include <algorithm>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int kVec>
struct alignas(sizeof(T) * kVec) Pack {
  T v[kVec];
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// Sum of `x` over the block; every thread gets the result.
__device__ __forceinline__ float block_sum(float x) {
  __shared__ float partial[kMaxThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = warp_sum(x);
  if (lane == 0) partial[warp] = x;
  __syncthreads();
  if (warp == 0) {
    x = lane < static_cast<int>(blockDim.x >> 5) ? partial[lane] : 0.f;
    x = warp_sum(x);
    if (lane == 0) partial[0] = x;
  }
  __syncthreads();
  return partial[0];
}

template <typename T, typename TS, int kVec>
__global__ void __launch_bounds__(kMaxThreads)
rms_norm_fwd_kernel(const T* __restrict__ x, const TS* __restrict__ scale,
                    T* __restrict__ out, int d, float eps) {
  extern __shared__ float row[];  // the block's row as f32, d values
  using P = Pack<T, kVec>;
  const size_t base = static_cast<size_t>(blockIdx.x) * d;
  const int nvec = d / kVec;
  const P* xv = reinterpret_cast<const P*>(x + base);
  P* ov = reinterpret_cast<P*>(out + base);

  float ss = 0.f;
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    const P p = xv[i];
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const float f = to_f32(p.v[k]);
      row[i * kVec + k] = f;
      ss = fmaf(f, f, ss);
    }
  }
  const float r = rsqrtf(block_sum(ss) / static_cast<float>(d) + eps);

  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    P p;
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int j = i * kVec + k;
      p.v[k] = from_f32<T>((row[j] * r) * (1.f + to_f32(scale[j])));
    }
    ov[i] = p;
  }
}

template <typename T, typename TS, int kVec>
int launch(const void* x, const void* scale, void* out, int rows, int d, float eps,
           cudaStream_t stream) {
  const int nvec = d / kVec;
  const int threads = std::min(kMaxThreads, std::max(32, (nvec + 31) / 32 * 32));
  const size_t smem = static_cast<size_t>(d) * sizeof(float);
  auto kernel = rms_norm_fwd_kernel<T, TS, kVec>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<rows, threads, smem, stream>>>(static_cast<const T*>(x),
                                          static_cast<const TS*>(scale),
                                          static_cast<T*>(out), d, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename TS>
int dispatch_vec(bool vec, const void* x, const void* scale, void* out, int rows, int d,
                 float eps, cudaStream_t st) {
  constexpr int kVec = 16 / sizeof(T);  // 16-byte loads: 4 f32 or 8 bf16
  return vec ? launch<T, TS, kVec>(x, scale, out, rows, d, eps, st)
             : launch<T, TS, 1>(x, scale, out, rows, d, eps, st);
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the CUDA error (0 = launched).  `vec`
// asks for 16-byte loads: the caller sets it only when d is a multiple of
// the vector width and x and out are 16-byte aligned.  The caller allocates
// out and validates shapes; bad arguments return cudaErrorInvalidValue
// without a launch.
int rms_norm_fwd(const void* x, const void* scale, void* out, int rows, int d,
                 int x_bf16, int scale_bf16, int vec, float eps, void* stream) {
  if (rows <= 0 || d <= 0 || static_cast<size_t>(d) * sizeof(float) > 226 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    return scale_bf16
        ? dispatch_vec<__nv_bfloat16, __nv_bfloat16>(vec, x, scale, out, rows, d, eps, st)
        : dispatch_vec<__nv_bfloat16, float>(vec, x, scale, out, rows, d, eps, st);
  }
  return scale_bf16 ? dispatch_vec<float, __nv_bfloat16>(vec, x, scale, out, rows, d, eps, st)
                    : dispatch_vec<float, float>(vec, x, scale, out, rows, d, eps, st);
}

const char* rms_norm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
