// RMSNorm backward for Hopper (sm_90a), plain C interface for ctypes.
//
// The TPU kernel (repro/kernels/rmsnorm.py::rms_norm_kernel) has no VJP; the
// JAX package trains through the plain rms_norm and its custom VJP
// (repro/models/layers.py::_rms_norm_bwd).  This kernel computes that VJP:
//   r  = rsqrt(mean(x^2) + eps),  g = dy * (1 + scale)
//   dx = r * g - x * r^3 * mean(x * g)          (cast to x's dtype)
//   ds = sum over rows of dy * x * r            (cast to scale's dtype)
// with every product and sum in f32.  x, dy and dx are [rows, d] in one
// dtype (f32 or bf16); scale and ds are [d] (f32 or bf16, independently).
//
// Design.  One warp per row, as in the forward, a block of W warps walking
// its rows in a grid-stride loop.  A lane reads its elements of x, dy and
// scale twice, as 16-byte vectors where d and the pointers allow: once for
// the two row sums (x^2 and x*g, warp shuffle reductions), again (from L2)
// for dx.  ds needs a sum over rows.  Each warp adds its rows' dy * x * r
// into its own row of shared memory ([W][d] f32, each column touched by one
// lane), the block then sums its W rows in order into one row of `partial`
// ([blocks, d] f32), and a second kernel sums `partial` over blocks in
// order, one thread a column.  No atomics: the result does not depend on
// scheduling.
//
// What bounds it on the H100.  x and dy read once, dx written once: bytes,
// 3 * rows * d * elt over 3.35 TB/s (~0.018 ms at hymba-1.5b's 4096 x 1600
// bf16 training rows); the partial rows add blocks * d * 8 bytes.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSmem = 227 * 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int kVec>
struct alignas(sizeof(T) * kVec < 16 ? sizeof(T) * kVec : 16) Pack {
  T v[kVec];
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

template <typename T, typename TS, int kVec>
__global__ void rms_norm_bwd_kernel(const T* __restrict__ x, const TS* __restrict__ scale,
                                    const T* __restrict__ dy, T* __restrict__ dx,
                                    float* __restrict__ partial, int rows, int d, float eps) {
  using P = Pack<T, kVec>;
  using PS = Pack<TS, kVec>;
  extern __shared__ float acc[];  // [warps][d]: this block's ds, one row a warp
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nvec = d / kVec;
  float* const my_acc = acc + static_cast<size_t>(warp) * d;
  for (int i = lane; i < d; i += 32) my_acc[i] = 0.f;
  __syncwarp();  // a lane adds into columns another lane zeroed

  const PS* sv = reinterpret_cast<const PS*>(scale);
  const float inv_d = 1.f / static_cast<float>(d);
  for (int row = blockIdx.x * warps + warp; row < rows; row += gridDim.x * warps) {
    const P* xv = reinterpret_cast<const P*>(x + static_cast<size_t>(row) * d);
    const P* gv = reinterpret_cast<const P*>(dy + static_cast<size_t>(row) * d);
    P* dxv = reinterpret_cast<P*>(dx + static_cast<size_t>(row) * d);
    float ss = 0.f, sxg = 0.f;
    for (int i = lane; i < nvec; i += 32) {
      const P p = xv[i], g = gv[i];
      const PS s = sv[i];
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float xf = to_f32(p.v[e]);
        ss = fmaf(xf, xf, ss);
        sxg = fmaf(xf, to_f32(g.v[e]) * (1.f + to_f32(s.v[e])), sxg);
      }
    }
    const float r = rsqrtf(warp_sum(ss) * inv_d + eps);
    const float mean_xg = warp_sum(sxg) * inv_d;
    const float r3m = r * r * r * mean_xg;
    for (int i = lane; i < nvec; i += 32) {
      const P p = xv[i], g = gv[i];
      const PS s = sv[i];
      P o;
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float xf = to_f32(p.v[e]);
        const float dyf = to_f32(g.v[e]);
        const float gf = dyf * (1.f + to_f32(s.v[e]));
        o.v[e] = from_f32<T>(r * gf - xf * r3m);
        my_acc[i * kVec + e] += dyf * xf * r;
      }
      dxv[i] = o;
    }
  }
  __syncthreads();
  float* const out = partial + static_cast<size_t>(blockIdx.x) * d;
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float s = 0.f;
    for (int w = 0; w < warps; ++w) s += acc[static_cast<size_t>(w) * d + c];
    out[c] = s;
  }
}

// ds[c] = sum over the `parts` rows of partial[., c], in order.
template <typename TS>
__global__ void rms_norm_ds_kernel(const float* __restrict__ partial, TS* __restrict__ ds,
                                   int parts, int d) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= d) return;
  float s = 0.f;
  for (int p = 0; p < parts; ++p) s += partial[static_cast<size_t>(p) * d + c];
  ds[c] = from_f32<TS>(s);
}

template <typename T, typename TS, int kVec>
int launch(const void* x, const void* scale, const void* dy, void* dx, void* partial,
           void* ds, int rows, int d, int warps, int blocks, float eps, cudaStream_t st) {
  const int smem = warps * d * static_cast<int>(sizeof(float));
  auto* kernel = &rms_norm_bwd_kernel<T, TS, kVec>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<blocks, warps * 32, smem, st>>>(
      static_cast<const T*>(x), static_cast<const TS*>(scale), static_cast<const T*>(dy),
      static_cast<T*>(dx), static_cast<float*>(partial), rows, d, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rms_norm_ds_kernel<TS><<<(d + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(partial), static_cast<TS*>(ds), blocks, d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename TS>
int dispatch(int vec, const void* x, const void* scale, const void* dy, void* dx,
             void* partial, void* ds, int rows, int d, int warps, int blocks, float eps,
             cudaStream_t st) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec) {
    if (d % kVec != 0) return static_cast<int>(cudaErrorInvalidValue);
    return launch<T, TS, kVec>(x, scale, dy, dx, partial, ds, rows, d, warps, blocks, eps, st);
  }
  return launch<T, TS, 1>(x, scale, dy, dx, partial, ds, rows, d, warps, blocks, eps, st);
}

}  // namespace

extern "C" {

// Launches both kernels on `stream` and returns the CUDA error (0 =
// launched).  `vec` asks for 16-byte loads (d a multiple of the vector width,
// x, scale, dy and dx 16-byte aligned); `warps` (1, 2 or 4) and `blocks` set
// the grid; the caller allocates dx, partial [blocks, d] f32 and ds, and
// picks warps so that warps * d * 4 bytes of shared memory fit.
int rms_norm_bwd(const void* x, const void* scale, const void* dy, void* dx, void* partial,
                 void* ds, int rows, int d, int x_bf16, int scale_bf16, int vec, int warps,
                 int blocks, float eps, void* stream) {
  if (rows <= 0 || d <= 0 || blocks <= 0 || (warps != 1 && warps != 2 && warps != 4) ||
      static_cast<long long>(warps) * d * 4 > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    return scale_bf16
               ? dispatch<__nv_bfloat16, __nv_bfloat16>(vec, x, scale, dy, dx, partial, ds,
                                                        rows, d, warps, blocks, eps, st)
               : dispatch<__nv_bfloat16, float>(vec, x, scale, dy, dx, partial, ds, rows, d,
                                                warps, blocks, eps, st);
  }
  return scale_bf16 ? dispatch<float, __nv_bfloat16>(vec, x, scale, dy, dx, partial, ds, rows,
                                                     d, warps, blocks, eps, st)
                    : dispatch<float, float>(vec, x, scale, dy, dx, partial, ds, rows, d, warps,
                                             blocks, eps, st);
}

const char* rms_norm_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
