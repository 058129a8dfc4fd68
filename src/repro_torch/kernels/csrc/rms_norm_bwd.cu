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
// What bounds it on the H100.  x and dy read once, dx written once, scale
// read and ds written once: bytes, (3 * rows + 2) * d * elt over 3.35 TB/s,
// 0.0117 ms at hymba-1.5b's 4096 x 1600 bf16 training rows (0.0132 at
// qwen2-0.5b's 8192 x 896, 0.0300 at falcon-mamba-7b's 4096 x 4096).  The
// ds partial rows below add blocks * d * 8 bytes, which stay in L2.
//
// Design.  A team of kSplit warps (1, 2 or 4) owns one row at a time, and
// a block's teams walk their rows in a grid-stride loop.  Register path (kV
// > 0: 16-byte vectors, at most kV = 4 a lane): a lane loads its vectors of
// x and dy once, before both row sums (warp shuffles; a split row adds its
// warps' sums through shared memory behind a named barrier), and computes
// dx from registers: one pass over HBM.  It holds its vectors of scale for
// every row its team takes.  A lane owns the same columns (vectors tlane +
// 32 * kSplit * j) in every row, so its f32 sums of dy * x * r stay in
// registers across the whole loop.  At the end each team writes its sums to
// its own row of shared memory ([teams][d], vector i's element e at e * nvec
// + i: lanes on consecutive words, no bank conflicts), and the block adds
// its teams in order into one partial row, in the same position order.  A
// row of more than 4 vectors a lane splits: hymba-1.5b's 1600 bf16 over 2
// warps, falcon-mamba-7b's 4096 over 4, ~126 registers a thread, so two
// 8-warp blocks fit an SM (`picked`).  A row wider than 4 x 4 vectors a lane
// (d > 4096 in bf16, 2048 in f32) and a d that is no multiple of the vector
// width (scalar loads) take the streaming path (kV = 0): one warp a row,
// read twice (the second time from L2), the sums of ds in the warp's row of
// shared memory, each position touched by one lane.  A second kernel sums
// the partial rows: a block per strip of 32 positions, its 16 warps each
// summing a fixed contiguous range of partial rows, then added in warp
// order.  No atomics: the same bits on every run.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 8;   // a block's warps
constexpr int kDsWarps = 16;   // the ds kernel's warps, a 32-position strip a block
// Shared memory a block may use, less the split rows' sums (row_sums below).
constexpr int kMaxSmem = 227 * 1024 - 2 * kMaxWarps * 2 * 4;

// The register path's instantiations, (kV, kSplit) as rmsnorm.py::
// bwd_launch_shape picks them (its BWD_PLANS): up to 4 vectors a lane (~126
// registers, so two 8-warp blocks an SM), a wider row over 2 or 4 warps.
// kernels/bwd_variants.py edits this to time 8 vectors a lane and others.
constexpr bool picked(int kV, int kSplit) { return kSplit == 1 ? kV <= 4 : kV == 4; }

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

// An empty asm the compiler must assume rewrites p (as in rms_norm.cu):
// applied once a row, it keeps x, dy and scale packed in registers between
// the row sums and dx, instead of their f32 conversions (twice the words).
template <typename P>
__device__ __forceinline__ void keep_packed(P& p) {
  static_assert(sizeof(P) % 4 == 0, "whole 32-bit words");
  uint32_t* w = reinterpret_cast<uint32_t*>(&p);
#pragma unroll
  for (int i = 0; i < static_cast<int>(sizeof(P) / 4); ++i) asm volatile("" : "+r"(w[i]));
}

// The kSplit warps of team `team`: named barrier 1 + team (0 is __syncthreads').
__device__ __forceinline__ void team_sync(int team, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(team + 1), "r"(threads) : "memory");
}

template <typename T, typename TS, int kVec, int kV, int kSplit>
__global__ void __launch_bounds__(kMaxWarps * 32)
rms_norm_bwd_kernel(const T* __restrict__ x, const TS* __restrict__ scale,
                    const T* __restrict__ dy, T* __restrict__ dx,
                    float* __restrict__ partial, int rows, int d, float eps) {
  using P = Pack<T, kVec>;
  using PS = Pack<TS, kVec>;
  constexpr int kLanes = 32 * kSplit;
  extern __shared__ float sums[];  // [teams][d]: each team's ds, vector i's element e at e*nvec+i
  __shared__ float row_sums[2][kMaxWarps][2];  // a split row's sums, by row parity
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int teams = (blockDim.x >> 5) / kSplit;
  const int team = warp / kSplit;
  const int tlane = (warp % kSplit) * 32 + lane;
  const int nvec = d / kVec;
  const float inv_d = 1.f / static_cast<float>(d);
  const PS* sv = reinterpret_cast<const PS*>(scale);
  float* const mine = sums + static_cast<size_t>(team) * d;
  const int stride = gridDim.x * teams;
  int row = blockIdx.x * teams + team;

  if constexpr (kV > 0) {
    PS s[kV];
    float acc[kV][kVec];
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      const int i = tlane + kLanes * j;
      if (i < nvec) s[j] = sv[i];
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[j][e] = 0.f;
    }
    int parity = 0;
    for (; row < rows; row += stride) {
      const P* xv = reinterpret_cast<const P*>(x + static_cast<size_t>(row) * d);
      const P* gv = reinterpret_cast<const P*>(dy + static_cast<size_t>(row) * d);
      P* dxv = reinterpret_cast<P*>(dx + static_cast<size_t>(row) * d);
      P p[kV], g[kV];
#pragma unroll
      for (int j = 0; j < kV; ++j) {
        const int i = tlane + kLanes * j;
        if (i < nvec) {
          p[j] = xv[i];
          g[j] = gv[i];
        }
      }
      float ss = 0.f, sxg = 0.f;
#pragma unroll
      for (int j = 0; j < kV; ++j) {
        if (tlane + kLanes * j < nvec) {
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            const float xf = to_f32(p[j].v[e]);
            ss = fmaf(xf, xf, ss);
            sxg = fmaf(xf, to_f32(g[j].v[e]) * (1.f + to_f32(s[j].v[e])), sxg);
          }
        }
      }
      ss = warp_sum(ss);
      sxg = warp_sum(sxg);
      if constexpr (kSplit > 1) {
        // Both warps write, meet, and add the sums in warp order: the same
        // r in both.  A warp writes this parity again two rows on, after
        // the other has passed the next barrier, so after it read these.
        float(*slot)[2] = row_sums[parity] + team * kSplit;
        if (lane == 0) {
          slot[warp % kSplit][0] = ss;
          slot[warp % kSplit][1] = sxg;
        }
        team_sync(team, kLanes);
        ss = slot[0][0];
        sxg = slot[0][1];
#pragma unroll
        for (int w = 1; w < kSplit; ++w) {
          ss += slot[w][0];
          sxg += slot[w][1];
        }
        parity ^= 1;
      }
      const float r = rsqrtf(ss * inv_d + eps);
      const float r3m = r * r * r * (sxg * inv_d);
#pragma unroll
      for (int j = 0; j < kV; ++j) {
        const int i = tlane + kLanes * j;
        if (i < nvec) {
          keep_packed(p[j]);
          keep_packed(g[j]);
          keep_packed(s[j]);
          P o;
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            const float xf = to_f32(p[j].v[e]);
            const float dyf = to_f32(g[j].v[e]);
            o.v[e] = from_f32<T>(r * (dyf * (1.f + to_f32(s[j].v[e]))) - xf * r3m);
            acc[j][e] += dyf * xf * r;
          }
          dxv[i] = o;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      const int i = tlane + kLanes * j;
      if (i < nvec) {
#pragma unroll
        for (int e = 0; e < kVec; ++e) mine[e * nvec + i] = acc[j][e];
      }
    }
  } else {
    static_assert(kSplit == 1, "the streaming path takes one warp a row");
    for (int c = lane; c < d; c += 32) mine[c] = 0.f;
    __syncwarp();  // a lane adds into positions another lane zeroed
    for (; row < rows; row += stride) {
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
      const float r3m = r * r * r * (warp_sum(sxg) * inv_d);
      for (int i = lane; i < nvec; i += 32) {
        const P p = xv[i], g = gv[i];
        const PS s = sv[i];
        P o;
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const float xf = to_f32(p.v[e]);
          const float dyf = to_f32(g.v[e]);
          o.v[e] = from_f32<T>(r * (dyf * (1.f + to_f32(s.v[e]))) - xf * r3m);
          mine[e * nvec + i] += dyf * xf * r;
        }
        dxv[i] = o;
      }
    }
  }
  __syncthreads();
  float* const out = partial + static_cast<size_t>(blockIdx.x) * d;
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float t = sums[c];
    for (int m = 1; m < teams; ++m) t += sums[static_cast<size_t>(m) * d + c];
    out[c] = t;
  }
}

// ds = the `parts` partial rows summed, each in position order (vector i's
// element e at e * nvec + i, nvec = d / vec): a block per 32 positions, warp
// w adds partial rows [w * per, (w + 1) * per) in order, then warp 0 adds
// the warps' sums in order and writes column i * vec + e.
template <typename TS>
__global__ void __launch_bounds__(kDsWarps * 32)
rms_norm_ds_kernel(const float* __restrict__ partial, TS* __restrict__ ds, int parts, int d,
                   int vec) {
  __shared__ float warp_sums[kDsWarps][32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int pos = blockIdx.x * 32 + lane;
  const int per = (parts + kDsWarps - 1) / kDsWarps;
  const int lo = min(parts, warp * per);
  const int hi = min(parts, lo + per);
  float s = 0.f;
  if (pos < d) {
    const float* col = partial + pos;
#pragma unroll 8
    for (int p = lo; p < hi; ++p) s += col[static_cast<size_t>(p) * d];
  }
  warp_sums[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && pos < d) {
    float t = warp_sums[0][lane];
#pragma unroll
    for (int w = 1; w < kDsWarps; ++w) t += warp_sums[w][lane];
    const int nvec = d / vec;
    ds[(pos % nvec) * vec + pos / nvec] = from_f32<TS>(t);
  }
}

template <typename T, typename TS, int kVec, int kV, int kSplit>
int launch(const void* x, const void* scale, const void* dy, void* dx, void* partial,
           void* ds, int rows, int d, int warps, int blocks, float eps, cudaStream_t st) {
  const int smem = warps / kSplit * d * static_cast<int>(sizeof(float));
  auto* kernel = &rms_norm_bwd_kernel<T, TS, kVec, kV, kSplit>;
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
  rms_norm_ds_kernel<TS><<<(d + 31) / 32, kDsWarps * 32, 0, st>>>(
      static_cast<const float*>(partial), static_cast<TS*>(ds), blocks, d, kVec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename TS, int kVec, int kSplit>
int by_per_lane(int per_lane, const void* x, const void* scale, const void* dy, void* dx,
                void* partial, void* ds, int rows, int d, int warps, int blocks, float eps,
                cudaStream_t st) {
#define RMS_BWD_LAUNCH(KV)                                                                    \
  if constexpr (picked(KV, kSplit)) {                                                        \
    return launch<T, TS, kVec, KV, kSplit>(x, scale, dy, dx, partial, ds, rows, d, warps,    \
                                           blocks, eps, st);                                 \
  }                                                                                          \
  break
  switch (per_lane) {
    case 1: RMS_BWD_LAUNCH(1);
    case 2: RMS_BWD_LAUNCH(2);
    case 4: RMS_BWD_LAUNCH(4);
    case 8: RMS_BWD_LAUNCH(8);
    default: break;
  }
#undef RMS_BWD_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, typename TS>
int dispatch(int vec, int per_lane, int split, const void* x, const void* scale,
             const void* dy, void* dx, void* partial, void* ds, int rows, int d, int warps,
             int blocks, float eps, cudaStream_t st) {
  constexpr int kVec = 16 / sizeof(T);  // 16-byte loads: 4 f32 or 8 bf16
  const auto bad = static_cast<int>(cudaErrorInvalidValue);
  if (per_lane == 0) {  // the streaming path
    if (split != 1) return bad;
    if (!vec) return launch<T, TS, 1, 0, 1>(x, scale, dy, dx, partial, ds, rows, d, warps,
                                            blocks, eps, st);
    return d % kVec != 0 ? bad : launch<T, TS, kVec, 0, 1>(x, scale, dy, dx, partial, ds,
                                                           rows, d, warps, blocks, eps, st);
  }
  if (!vec || d % kVec != 0 || d / kVec > 32 * split * per_lane) return bad;
  switch (split) {
    case 1: return by_per_lane<T, TS, kVec, 1>(per_lane, x, scale, dy, dx, partial, ds, rows,
                                               d, warps, blocks, eps, st);
    case 2: return by_per_lane<T, TS, kVec, 2>(per_lane, x, scale, dy, dx, partial, ds, rows,
                                               d, warps, blocks, eps, st);
    case 4: return by_per_lane<T, TS, kVec, 4>(per_lane, x, scale, dy, dx, partial, ds, rows,
                                               d, warps, blocks, eps, st);
    default: return bad;
  }
}

}  // namespace

extern "C" {

// Launches both kernels on `stream` and returns the CUDA error (0 =
// launched).  The instantiation and grid come from the caller
// (rmsnorm.py::bwd_launch_shape): `vec` asks for 16-byte loads (d a
// multiple of the vector width; x, scale, dy and dx 16-byte aligned),
// `per_lane` is the number of 16-byte vectors a lane holds (1, 2 or 4;
// 0 = the streaming path, one warp a row), `split` the warps that share a
// row (1, 2 or 4), `warps` (1, 2, 4 or 8, a multiple of split) and `blocks` the
// grid.  The caller allocates dx, partial [blocks, d] f32 and ds.  Bad
// arguments, or warps / split * d * 4 bytes of shared memory over a block's,
// return cudaErrorInvalidValue without a launch.
int rms_norm_bwd(const void* x, const void* scale, const void* dy, void* dx, void* partial,
                 void* ds, int rows, int d, int x_bf16, int scale_bf16, int vec, int per_lane,
                 int split, int warps, int blocks, float eps, void* stream) {
  if (rows <= 0 || d <= 0 || blocks <= 0 || (warps != 1 && warps != 2 && warps != 4 &&
                                             warps != 8) ||
      (split != 1 && split != 2 && split != 4) || warps % split != 0 ||
      static_cast<long long>(warps / split) * d * 4 > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    return scale_bf16
               ? dispatch<__nv_bfloat16, __nv_bfloat16>(vec, per_lane, split, x, scale, dy, dx,
                                                        partial, ds, rows, d, warps, blocks,
                                                        eps, st)
               : dispatch<__nv_bfloat16, float>(vec, per_lane, split, x, scale, dy, dx,
                                                partial, ds, rows, d, warps, blocks, eps, st);
  }
  return scale_bf16 ? dispatch<float, __nv_bfloat16>(vec, per_lane, split, x, scale, dy, dx,
                                                     partial, ds, rows, d, warps, blocks, eps,
                                                     st)
                    : dispatch<float, float>(vec, per_lane, split, x, scale, dy, dx, partial,
                                             ds, rows, d, warps, blocks, eps, st);
}

const char* rms_norm_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
