// RMSNorm forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces repro/kernels/rmsnorm.py::rms_norm_kernel, the Pallas TPU kernel:
//   out = x * rsqrt(mean(x^2) + eps) * (1 + scale)
// over the last axis, the sum of squares and the products in f32, the result
// cast to x's dtype.  x and out are [rows, d] (f32 or bf16); scale is [d]
// (f32 or bf16, independently of x).
//
// Design.  The TPU kernel tiles block_rows rows into VMEM and reads each tile
// once.  Here one warp owns one row at a time, and a block of 4 warps walks
// its rows in a grid-stride loop.  With 16-byte vectors (d a multiple of the
// vector width, pointers aligned) and a row of at most 16 vectors a lane
// (d <= 4096 in bf16, 2048 in f32), the row stays in registers between the
// sum of squares and the write: kV vectors a lane, kV a template parameter
// the wrapper picks (rmsnorm.py::launch_shape).  The sum of squares is a
// warp shuffle reduction: no shared memory, no __syncthreads.  Each lane
// loads its part of `scale` as 16-byte vectors once and keeps it for every
// row its warp takes.  A wider row, up to the wrapper's MAX_D, and a d that
// is no multiple of the vector width (scalar loads) take the streaming path
// (kV = 0): the row is read once for the sum of squares and again, from L2,
// for the write.  Rows are not padded.
//
// What bounds it on the H100.  Each element is read once and written once,
// with a few f32 operations between: bytes bound it, 2 * rows * d * elt over
// 3.35 TB/s (~0.012 ms for hymba-1.5b's 6144 x 1600 bf16 prefill rows).  At a
// decode step (4 rows: one block) the launch itself is the cost.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;  // rows in flight per block, one per warp
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// kVec elements of T in one load: 16 bytes at most per instruction, so a
// 32-byte pack (8 f32 of scale beside 8 bf16 of x) is two 16-byte loads.
template <typename T, int kVec>
struct alignas(sizeof(T) * kVec < 16 ? sizeof(T) * kVec : 16) Pack {
  T v[kVec];
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// An empty asm the compiler must assume rewrites p.  Applied once a row, it
// keeps a lane's x and scale vectors packed in registers: without it the
// compiler keeps their f32 conversions live instead (hoisting scale's out of
// the row loop), twice the registers, which spills at 16 vectors a lane.
template <typename P>
__device__ __forceinline__ void keep_packed(P& p) {
  static_assert(sizeof(P) % 4 == 0, "whole 32-bit words");
  uint32_t* w = reinterpret_cast<uint32_t*>(&p);
#pragma unroll
  for (int i = 0; i < static_cast<int>(sizeof(P) / 4); ++i) asm volatile("" : "+r"(w[i]));
}

template <typename T, typename TS, int kVec>
__device__ __forceinline__ Pack<T, kVec> normed(const Pack<T, kVec>& p,
                                                const Pack<TS, kVec>& s, float r) {
  Pack<T, kVec> o;
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    o.v[e] = from_f32<T>((to_f32(p.v[e]) * r) * (1.f + to_f32(s.v[e])));
  }
  return o;
}

// kV > 0: the row in registers, kV vectors of kVec elements a lane.
// kV == 0: the streaming path, the row read twice.
template <typename T, typename TS, int kVec, int kV>
__global__ void __launch_bounds__(kWarps * 32)
rms_norm_fwd_kernel(const T* __restrict__ x, const TS* __restrict__ scale,
                    T* __restrict__ out, int rows, int d, float eps) {
  using P = Pack<T, kVec>;
  using PS = Pack<TS, kVec>;
  const int lane = threadIdx.x & 31;
  const int nvec = d / kVec;
  const PS* sv = reinterpret_cast<const PS*>(scale);
  const int stride = gridDim.x * kWarps;
  int row = blockIdx.x * kWarps + (threadIdx.x >> 5);

  if constexpr (kV > 0) {
    PS s[kV];
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      const int i = lane + 32 * j;
      if (i < nvec) s[j] = sv[i];
    }
    for (; row < rows; row += stride) {
      const P* xv = reinterpret_cast<const P*>(x + static_cast<size_t>(row) * d);
      P* ov = reinterpret_cast<P*>(out + static_cast<size_t>(row) * d);
      P p[kV];
      float ss = 0.f;
#pragma unroll
      for (int j = 0; j < kV; ++j) {
        const int i = lane + 32 * j;
        if (i < nvec) {
          p[j] = xv[i];
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            const float f = to_f32(p[j].v[e]);
            ss = fmaf(f, f, ss);
          }
        }
      }
      const float r = rsqrtf(warp_sum(ss) / static_cast<float>(d) + eps);
#pragma unroll
      for (int j = 0; j < kV; ++j) {
        const int i = lane + 32 * j;
        if (i < nvec) {
          keep_packed(p[j]);
          keep_packed(s[j]);
          ov[i] = normed<T, TS, kVec>(p[j], s[j], r);
        }
      }
    }
  } else {
    for (; row < rows; row += stride) {
      const P* xv = reinterpret_cast<const P*>(x + static_cast<size_t>(row) * d);
      P* ov = reinterpret_cast<P*>(out + static_cast<size_t>(row) * d);
      float ss = 0.f;
      for (int i = lane; i < nvec; i += 32) {
        const P p = xv[i];
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const float f = to_f32(p.v[e]);
          ss = fmaf(f, f, ss);
        }
      }
      const float r = rsqrtf(warp_sum(ss) / static_cast<float>(d) + eps);
      for (int i = lane; i < nvec; i += 32) ov[i] = normed<T, TS, kVec>(xv[i], sv[i], r);
    }
  }
}

template <typename T, typename TS, int kVec, int kV>
int launch(const void* x, const void* scale, void* out, int rows, int d, int blocks,
           float eps, cudaStream_t stream) {
  rms_norm_fwd_kernel<T, TS, kVec, kV><<<blocks, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const TS*>(scale), static_cast<T*>(out), rows, d,
      eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename TS>
int dispatch(int vec, int per_lane, const void* x, const void* scale, void* out, int rows,
             int d, int blocks, float eps, cudaStream_t st) {
  constexpr int kVec = 16 / sizeof(T);  // 16-byte loads: 4 f32 or 8 bf16
  if (!vec) {
    return per_lane == 0 ? launch<T, TS, 1, 0>(x, scale, out, rows, d, blocks, eps, st)
                         : static_cast<int>(cudaErrorInvalidValue);
  }
  if (d % kVec != 0 || (per_lane > 0 && d > 32 * per_lane * kVec)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (per_lane) {
    case 0: return launch<T, TS, kVec, 0>(x, scale, out, rows, d, blocks, eps, st);
    case 1: return launch<T, TS, kVec, 1>(x, scale, out, rows, d, blocks, eps, st);
    case 2: return launch<T, TS, kVec, 2>(x, scale, out, rows, d, blocks, eps, st);
    case 4: return launch<T, TS, kVec, 4>(x, scale, out, rows, d, blocks, eps, st);
    case 8: return launch<T, TS, kVec, 8>(x, scale, out, rows, d, blocks, eps, st);
    case 16: return launch<T, TS, kVec, 16>(x, scale, out, rows, d, blocks, eps, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the CUDA error (0 = launched).  The
// instantiation comes from the caller (rmsnorm.py::launch_shape): `vec` asks
// for 16-byte loads (only when d is a multiple of the vector width and x,
// scale and out are 16-byte aligned), `per_lane` is the number of 16-byte
// vectors a lane holds in registers (1, 2, 4, 8 or 16; 0 = read the row
// twice), `blocks` the grid of 4-warp blocks.  The caller allocates out and
// validates shapes; bad arguments return cudaErrorInvalidValue without a
// launch.
int rms_norm_fwd(const void* x, const void* scale, void* out, int rows, int d,
                 int x_bf16, int scale_bf16, int vec, int per_lane, int blocks, float eps,
                 void* stream) {
  if (rows <= 0 || d <= 0 || blocks <= 0 ||
      static_cast<size_t>(d) * sizeof(float) > 226 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    return scale_bf16 ? dispatch<__nv_bfloat16, __nv_bfloat16>(vec, per_lane, x, scale, out,
                                                               rows, d, blocks, eps, st)
                      : dispatch<__nv_bfloat16, float>(vec, per_lane, x, scale, out, rows, d,
                                                       blocks, eps, st);
  }
  return scale_bf16 ? dispatch<float, __nv_bfloat16>(vec, per_lane, x, scale, out, rows, d,
                                                     blocks, eps, st)
                    : dispatch<float, float>(vec, per_lane, x, scale, out, rows, d, blocks,
                                             eps, st);
}

const char* rms_norm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
