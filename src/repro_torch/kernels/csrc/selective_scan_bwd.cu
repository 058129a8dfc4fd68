// Mamba-1 selective scan backward for Hopper (sm_90a), plain C interface for
// ctypes.
//
// The TPU kernel (repro/kernels/selective_scan.py::selective_scan_kernel) has
// no VJP, and the JAX package's training path never reaches it: it
// differentiates the plain scan.  This kernel computes the same gradient of
// y (h_last carries none) for the forward of selective_scan.cu,
//   h_t = exp(dt_t A) h_{t-1} + (dt_t u_t) B_t,   y_t = C_t . h_t + D u_t,
// walking the sequence backwards with dh_t = C_t dy_t + exp(dt_{t+1} A) dh_{t+1}:
//   du_t  = D dy_t + dt_t sum_n dh_t B_t
//   ddt_t = sum_n dh_t (A exp(dt_t A) h_{t-1} + u_t B_t)
//   dA    = sum_{b,t} dh_t dt_t exp(dt_t A) h_{t-1}
//   dB_t  = sum_d dh_t dt_t u_t,   dC_t = sum_d dy_t h_t,   dD = sum_{b,t} dy_t u_t
// in f32 (bf16 inputs widened on load); du, ddt, dB, dC are cast to the
// input dtype, dA and dD stay f32.
//
// Layout: as the forward.  dy [B, S, DI] f32.  hck [B, ceil(S / kSeg), DI, N]
// f32 holds the state entering each kSeg-step segment but the first (which
// starts from 0), written by the forward when autograd needs it: h is not
// stored for every step (B * S * DI * N f32, 0.84 GB at hymba-1.5b's B = 2,
// S = 2048), only every kSeg-th.
//
// Design.  The forward's layout and plan (selective_scan.py::launch_plan):
// a block of 128 threads for 128 / L * K channels of one batch row, L lanes
// sharing a group of K channels, N / L states of each a lane.  Segments run
// last to first.  A segment's h_t is recomputed from its checkpoint with the
// forward's own arithmetic (the same ex2 and FMAs, so the same values) into
// shared memory, [kSeg][K * P][128] f32, a thread reading only its own
// column; then its steps run backwards, each lane carrying dh for its states
// in registers.  Sums over N (du, ddt) are butterflies over the L lanes of a
// group, as the forward's y.  Sums over channels (dB, dC) are butterflies
// over the groups of a warp, written per warp into shared memory and summed
// over the block's 4 warps in order once a segment, into per-block partial
// rows; dA and dD sum over time in registers and are written per batch row.
// A second kernel sums the partials over blocks (dB, dC) and batch rows (dA,
// dD) in order.  No atomics: the result does not depend on scheduling.
//
// What bounds it on the H100.  Per (b, t, d, n): two exps (one in the
// recompute, one in the backward step) on the special function units and
// ~12 f32 operations; bytes: u, dt, B, C, dy in, du, ddt, dB, dC out, the
// checkpoints and partial rows.  This first design reads its inputs straight
// from global memory, step by step, without the forward's staging.
#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kSeg = 16;              // steps between checkpoints (selective_scan.cu)
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxSmem = 227 * 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__host__ __device__ constexpr int block_channels(int lanes, int per_lane) {
  return kThreads / lanes * per_lane;
}
constexpr bool plan_fits(int n, int lanes, int per_lane) {
  return per_lane * (n / lanes) <= 16 && block_channels(lanes, per_lane) <= 128;
}
// The forward's plans (selective_scan.cu::picked), the only ones instantiated.
constexpr bool picked(int n, int lanes, int per_lane) {
  return (n == 16 && ((lanes == 4 && per_lane == 2) || (lanes == 8 && per_lane == 2))) ||
         (n == 8 && ((lanes == 2 && per_lane == 2) || (lanes == 4 && per_lane == 2))) ||
         (n == 4 && ((lanes == 2 && per_lane == 2) || (lanes == 4 && per_lane == 2)));
}
// Dynamic shared memory: the segment's h [kSeg][K * P][128] and the per-warp
// channel sums of dB and dC [2][kWarps][kSeg][N].  Mirrored by
// selective_scan.py::bwd_smem_bytes.
constexpr size_t bwd_smem_bytes(int n, int lanes, int per_lane) {
  return (static_cast<size_t>(kSeg) * per_lane * (n / lanes) * kThreads +
          2 * static_cast<size_t>(kWarps) * kSeg * n) * sizeof(float);
}

struct Args {
  const void *u, *dt, *a, *b, *c, *d_skip, *hck, *dy;
  void *du, *ddt, *da, *db, *dc, *dd;
  float *db_part, *dc_part, *da_part, *dd_part;
  int bsz, seq, di;
};

template <int N, int L, int K, typename T>
__global__ void __launch_bounds__(kThreads)
selective_scan_bwd_kernel(const T* __restrict__ u, const T* __restrict__ dt,
                          const float* __restrict__ a, const T* __restrict__ bm,
                          const T* __restrict__ cm, const float* __restrict__ d_skip,
                          const float* __restrict__ hck, const float* __restrict__ dy,
                          T* __restrict__ du, T* __restrict__ ddt,
                          float* __restrict__ db_part, float* __restrict__ dc_part,
                          float* __restrict__ da_part, float* __restrict__ dd_part, int bsz,
                          int seq, int di) {
  constexpr int P = N / L;
  constexpr int KP = K * P;
  constexpr int kChannels = block_channels(L, K);
  extern __shared__ float smem[];
  float* const hist = smem;                          // [kSeg][KP][kThreads]
  float* const wsum_b = hist + kSeg * KP * kThreads;  // [kWarps][kSeg][N]
  float* const wsum_c = wsum_b + kWarps * kSeg * N;   // [kWarps][kSeg][N]

  const int tid = threadIdx.x;
  const int group = tid / L;
  const int lane = tid % L;
  const int warp = tid >> 5;
  const int wl = tid & 31;
  const int dk = blockIdx.x * kChannels + group * K;
  const int brow = blockIdx.y;
  const size_t row0 = static_cast<size_t>(brow) * seq;
  const int nseg = (seq + kSeg - 1) / kSeg;

  bool live[K];
  float a2[K][P], araw[K][P], dsk[K], da_acc[K][P], dd_acc[K], dh[K][P], dec_next[K][P];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    live[k] = dk + k < di;
    const int dd = live[k] ? dk + k : di - 1;
    dsk[k] = d_skip[dd];
    dd_acc[k] = 0.f;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      araw[k][p] = a[static_cast<size_t>(dd) * N + lane * P + p];
      a2[k][p] = araw[k][p] * kLog2e;
      da_acc[k][p] = dh[k][p] = dec_next[k][p] = 0.f;
    }
  }

  // This lane's K channels of a [B, S, DI] row at step t, 0 for dead ones.
  auto channels = [&](const auto* g, int t, float (&v)[K]) {
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = live[k] ? to_f32(g[(row0 + t) * di + dk + k]) : 0.f;
  };
  auto states = [&](const T* g, int t, float (&v)[P]) {
#pragma unroll
    for (int p = 0; p < P; ++p) v[p] = to_f32(g[(row0 + t) * N + lane * P + p]);
  };

  for (int s = nseg - 1; s >= 0; --s) {
    const int t0 = s * kSeg;
    const int t1 = min(t0 + kSeg, seq);
    float h0[K][P];
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int p = 0; p < P; ++p) {
        h0[k][p] = s > 0 && live[k]
                       ? hck[((static_cast<size_t>(brow) * nseg + s) * di + dk + k) * N +
                             lane * P + p]
                       : 0.f;
      }
    }
    {  // recompute the segment's states, as the forward computes them
      float h[K][P];
#pragma unroll
      for (int k = 0; k < K; ++k) {
#pragma unroll
        for (int p = 0; p < P; ++p) h[k][p] = h0[k][p];
      }
      for (int t = t0; t < t1; ++t) {
        float dtv[K], uv[K], bv[P];
        channels(dt, t, dtv);
        channels(u, t, uv);
        states(bm, t, bv);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float dtu = dtv[k] * uv[k];
#pragma unroll
          for (int p = 0; p < P; ++p) {
            h[k][p] = fmaf(ex2(dtv[k] * a2[k][p]), h[k][p], dtu * bv[p]);
            hist[((t - t0) * KP + k * P + p) * kThreads + tid] = h[k][p];
          }
        }
      }
    }
    for (int t = t1 - 1; t >= t0; --t) {
      const int tt = t - t0;
      float dtv[K], uv[K], dyv[K], bv[P], cv[P];
      channels(dt, t, dtv);
      channels(u, t, uv);
      channels(dy, t, dyv);
      states(bm, t, bv);
      states(cm, t, cv);
      float ddt_part[K], du_part[K], db_loc[P], dc_loc[P];
#pragma unroll
      for (int p = 0; p < P; ++p) db_loc[p] = dc_loc[p] = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float dtu = dtv[k] * uv[k];
        dd_acc[k] = fmaf(dyv[k], uv[k], dd_acc[k]);
        ddt_part[k] = du_part[k] = 0.f;
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const int i = k * P + p;
          const float dec = ex2(dtv[k] * a2[k][p]);
          const float hp = tt > 0 ? hist[((tt - 1) * KP + i) * kThreads + tid] : h0[k][p];
          const float ht = hist[(tt * KP + i) * kThreads + tid];
          const float g = fmaf(dh[k][p], dec_next[k][p], cv[p] * dyv[k]);
          dh[k][p] = g;
          dec_next[k][p] = dec;
          const float gdh = g * dec * hp;
          da_acc[k][p] = fmaf(gdh, dtv[k], da_acc[k][p]);
          ddt_part[k] = fmaf(gdh, araw[k][p], fmaf(g * uv[k], bv[p], ddt_part[k]));
          du_part[k] = fmaf(g * dtv[k], bv[p], du_part[k]);
          db_loc[p] = fmaf(g, dtu, db_loc[p]);
          dc_loc[p] = fmaf(dyv[k], ht, dc_loc[p]);
        }
      }
      // sums over N: the L lanes of the group
#pragma unroll
      for (int off = 1; off < L; off <<= 1) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          ddt_part[k] += __shfl_xor_sync(kFull, ddt_part[k], off);
          du_part[k] += __shfl_xor_sync(kFull, du_part[k], off);
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (live[k]) {
            const size_t o = (row0 + t) * di + dk + k;
            du[o] = from_f32<T>(fmaf(dyv[k], dsk[k], du_part[k]));
            ddt[o] = from_f32<T>(ddt_part[k]);
          }
        }
      }
      // sums over channels: the groups of the warp, then the warps (below)
#pragma unroll
      for (int off = L; off < 32; off <<= 1) {
#pragma unroll
        for (int p = 0; p < P; ++p) {
          db_loc[p] += __shfl_xor_sync(kFull, db_loc[p], off);
          dc_loc[p] += __shfl_xor_sync(kFull, dc_loc[p], off);
        }
      }
      if (wl < L) {
#pragma unroll
        for (int p = 0; p < P; ++p) {
          wsum_b[(warp * kSeg + tt) * N + lane * P + p] = db_loc[p];
          wsum_c[(warp * kSeg + tt) * N + lane * P + p] = dc_loc[p];
        }
      }
    }
    __syncthreads();
    for (int e = tid; e < (t1 - t0) * N; e += kThreads) {
      const int tt = e / N, n = e % N;
      float sb = 0.f, sc = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        sb += wsum_b[(w * kSeg + tt) * N + n];
        sc += wsum_c[(w * kSeg + tt) * N + n];
      }
      const size_t o = ((static_cast<size_t>(blockIdx.x) * bsz + brow) * seq + t0 + tt) * N + n;
      db_part[o] = sb;
      dc_part[o] = sc;
    }
    __syncthreads();  // wsum is free for the next segment
  }

#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (!live[k]) continue;
    const size_t c = static_cast<size_t>(brow) * di + dk + k;
#pragma unroll
    for (int p = 0; p < P; ++p) da_part[c * N + lane * P + p] = da_acc[k][p];
    if (lane == 0) dd_part[c] = dd_acc[k];
  }
}

// out[i] = sum over p < parts of part[p * count + i], in order.
template <typename TO>
__global__ void sum_parts_kernel(const float* __restrict__ part, TO* __restrict__ out,
                                 int parts, long long count) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < count;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < parts; ++p) s += part[p * count + i];
    out[i] = from_f32<TO>(s);
  }
}

template <typename TO>
int sum_parts(const float* part, void* out, int parts, long long count, cudaStream_t st) {
  const long long blocks = (count + 255) / 256;
  sum_parts_kernel<TO><<<static_cast<int>(blocks < 4096 ? blocks : 4096), 256, 0, st>>>(
      part, static_cast<TO*>(out), parts, count);
  return static_cast<int>(cudaGetLastError());
}

template <int N, int L, int K, typename T>
int launch(const Args& g, cudaStream_t st) {
  constexpr int kChannels = block_channels(L, K);
  constexpr size_t kSmem = bwd_smem_bytes(N, L, K);
  auto* kernel = &selective_scan_bwd_kernel<N, L, K, T>;
  if constexpr (kSmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks_d = (g.di + kChannels - 1) / kChannels;
  kernel<<<dim3(blocks_d, g.bsz), kThreads, kSmem, st>>>(
      static_cast<const T*>(g.u), static_cast<const T*>(g.dt), static_cast<const float*>(g.a),
      static_cast<const T*>(g.b), static_cast<const T*>(g.c),
      static_cast<const float*>(g.d_skip), static_cast<const float*>(g.hck),
      static_cast<const float*>(g.dy), static_cast<T*>(g.du), static_cast<T*>(g.ddt),
      g.db_part, g.dc_part, g.da_part, g.dd_part, g.bsz, g.seq, g.di);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const long long bsn = static_cast<long long>(g.bsz) * g.seq * N;
  if ((err = sum_parts<T>(g.db_part, g.db, blocks_d, bsn, st))) return err;
  if ((err = sum_parts<T>(g.dc_part, g.dc, blocks_d, bsn, st))) return err;
  if ((err = sum_parts<float>(g.da_part, g.da, g.bsz, static_cast<long long>(g.di) * N, st)))
    return err;
  return sum_parts<float>(g.dd_part, g.dd, g.bsz, g.di, st);
}

template <int N, int L, int K, typename T>
constexpr bool instantiated() {
  return picked(N, L, K) && plan_fits(N, L, K) && bwd_smem_bytes(N, L, K) <= kMaxSmem;
}

template <int N, int L, typename T>
int dispatch_k(int per_lane, const Args& g, cudaStream_t st) {
  switch (per_lane) {
    case 1: if constexpr (instantiated<N, L, 1, T>()) return launch<N, L, 1, T>(g, st); break;
    case 2: if constexpr (instantiated<N, L, 2, T>()) return launch<N, L, 2, T>(g, st); break;
    case 4: if constexpr (instantiated<N, L, 4, T>()) return launch<N, L, 4, T>(g, st); break;
    default: break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int N, typename T>
int dispatch_lanes(int lanes, int per_lane, const Args& g, cudaStream_t st) {
  switch (lanes) {
    case 1: return dispatch_k<N, 1, T>(per_lane, g, st);
    case 2: return dispatch_k<N, 2, T>(per_lane, g, st);
    case 4: return dispatch_k<N, 4, T>(per_lane, g, st);
    case 8: if constexpr (N >= 8) return dispatch_k<N, 8, T>(per_lane, g, st); break;
    case 16: if constexpr (N >= 16) return dispatch_k<N, 16, T>(per_lane, g, st); break;
    default: break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int dispatch_n(int n, int lanes, int per_lane, const Args& g, cudaStream_t st) {
  switch (n) {
    case 4: return dispatch_lanes<4, T>(lanes, per_lane, g, st);
    case 8: return dispatch_lanes<8, T>(lanes, per_lane, g, st);
    case 16: return dispatch_lanes<16, T>(lanes, per_lane, g, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Launches the backward and its reductions on `stream` and returns the CUDA
// error (0 = launched).  The plan (lanes, per_lane) is the forward's
// (selective_scan.py::launch_plan).  The caller allocates du, ddt, db, dc
// (input dtype), da [DI, N] and dd [DI] (f32), and the f32 partials:
// db_part, dc_part [ceil(DI / channels), B, S, N], da_part [B, DI, N],
// dd_part [B, DI]; bad arguments return cudaErrorInvalidValue without a
// launch.
int selective_scan_bwd(const void* u, const void* dt, const void* a, const void* b,
                       const void* c, const void* d_skip, const void* hck, const void* dy,
                       void* du, void* ddt, void* da, void* db, void* dc, void* dd,
                       void* db_part, void* dc_part, void* da_part, void* dd_part, int bsz,
                       int seq, int di, int n, int lanes, int per_lane, int is_bf16,
                       void* stream) {
  if (bsz <= 0 || bsz > 65535 || seq <= 0 || di <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args g{u, dt, a, b, c, d_skip, hck, dy, du, ddt, da, db, dc, dd,
               static_cast<float*>(db_part), static_cast<float*>(dc_part),
               static_cast<float*>(da_part), static_cast<float*>(dd_part), bsz, seq, di};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch_n<__nv_bfloat16>(n, lanes, per_lane, g, st)
                 : dispatch_n<float>(n, lanes, per_lane, g, st);
}

const char* selective_scan_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
