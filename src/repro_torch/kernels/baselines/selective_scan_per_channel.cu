// The earlier design of the Mamba-1 selective scan forward for Hopper
// (sm_90a): one thread a channel.  No wrapper loads it: it is built beside
// csrc/selective_scan.cu only to time that kernel against it, in
// chip_smoke.py's report and in kernels/scan_variants.py, which also times
// edited copies of it.  Plain C interface for ctypes, without the current
// kernel's plan arguments.
//
// Same semantics as csrc/selective_scan.cu: from h = 0,
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * u_t) * B_t,   y_t = C_t . h_t + D * u_t
// with every product in f32; y [B, S, DI] f32 and h_last [B, DI, N] f32 from
// u, dt [B, S, DI], a [DI, N] f32, b, c [B, S, N], d_skip [DI] f32, all
// contiguous, u, dt, b and c in one dtype (f32 or bf16).
//
// Design.  One thread owns one channel (b, d) and loops over the whole
// sequence, with its N states and its row of A in registers, so y's sum
// over N is a register loop.  A block is 128 consecutive channels of one
// batch row.  B_t and C_t are shared by every channel of a step and are
// staged through shared memory kChunk timesteps at a time; the next chunk's
// u, dt, B and C are loaded into registers while the current one is
// computed.  Timesteps past S load dt = u = B = 0, which leaves h as it is,
// and channels past DI only help stage B and C.
//
// Why it is slow on the H100: the grid has B * DI / 128 blocks of 4 warps
// (100 at hymba-1.5b's prefill, 256 at falcon-mamba-7b's), so a scheduler
// holds one or two warps, and each warp's serial chain of exps, loads and
// FMAs has nothing to switch to.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // channels per block, one per thread
constexpr int kChunk = 16;     // timesteps staged per round

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <int N>
struct Staged {
  static constexpr int kValues = kChunk * N;  // B (or C) values per chunk
  static constexpr int kPerThread = (kValues + kThreads - 1) / kThreads;
};

// Loads chunk [t0, t0 + kChunk) into registers: this thread's u and dt, and
// its share of the chunk's B and C rows.  Out of range reads give 0.
template <int N, typename T>
__device__ __forceinline__ void load_chunk(
    const T* __restrict__ ub, const T* __restrict__ dtb, const T* __restrict__ bb,
    const T* __restrict__ cb, int t0, int seq, int di, bool live,
    float (&un)[kChunk], float (&dtn)[kChunk], float (&bn)[Staged<N>::kPerThread],
    float (&cn)[Staged<N>::kPerThread]) {
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    const int t = t0 + j;
    const bool in = live && t < seq;
    un[j] = in ? to_f32(ub[static_cast<size_t>(t) * di]) : 0.f;
    dtn[j] = in ? to_f32(dtb[static_cast<size_t>(t) * di]) : 0.f;
  }
#pragma unroll
  for (int i = 0; i < Staged<N>::kPerThread; ++i) {
    const int idx = threadIdx.x + i * kThreads;  // into the chunk's [kChunk][N]
    const bool in = idx < Staged<N>::kValues && t0 + idx / N < seq;
    const size_t off = static_cast<size_t>(t0) * N + idx;
    bn[i] = in ? to_f32(bb[off]) : 0.f;
    cn[i] = in ? to_f32(cb[off]) : 0.f;
  }
}

template <int N, typename T>
__global__ void __launch_bounds__(kThreads)
selective_scan_fwd_kernel(const T* __restrict__ u, const T* __restrict__ dt,
                          const float* __restrict__ a, const T* __restrict__ bm,
                          const T* __restrict__ cm, const float* __restrict__ d_skip,
                          float* __restrict__ y, float* __restrict__ h_last, int seq,
                          int di) {
  __shared__ float bs[kChunk][N];
  __shared__ float cs[kChunk][N];
  constexpr int kPer = Staged<N>::kPerThread;

  const int b = blockIdx.y;
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const bool live = d < di;
  const int dd = live ? d : di - 1;  // keeps every pointer inside its tensor
  const size_t row = static_cast<size_t>(b) * seq;
  const T* ub = u + row * di + dd;
  const T* dtb = dt + row * di + dd;
  const T* bb = bm + row * N;
  const T* cb = cm + row * N;
  float* yb = y + row * di + dd;

  float av[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    av[n] = a[static_cast<size_t>(dd) * N + n];
    h[n] = 0.f;
  }
  const float dsk = d_skip[dd];

  float un[kChunk], dtn[kChunk], bn[kPer], cn[kPer];
  load_chunk<N>(ub, dtb, bb, cb, 0, seq, di, live, un, dtn, bn, cn);

  for (int t0 = 0; t0 < seq; t0 += kChunk) {
    float uc[kChunk], dtc[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      uc[j] = un[j];
      dtc[j] = dtn[j];
    }
    __syncthreads();  // every thread is done reading the previous chunk's B, C
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      if (idx < Staged<N>::kValues) {
        bs[idx / N][idx % N] = bn[i];
        cs[idx / N][idx % N] = cn[i];
      }
    }
    __syncthreads();
    if (t0 + kChunk < seq) {
      load_chunk<N>(ub, dtb, bb, cb, t0 + kChunk, seq, di, live, un, dtn, bn, cn);
    }

#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const float dtv = dtc[j];
      const float du = dtv * uc[j];
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        h[n] = fmaf(__expf(dtv * av[n]), h[n], du * bs[j][n]);
        acc = fmaf(h[n], cs[j][n], acc);
      }
      const int t = t0 + j;
      if (live && t < seq) yb[static_cast<size_t>(t) * di] = fmaf(dsk, uc[j], acc);
    }
  }

  if (live) {
    float* hb = h_last + (static_cast<size_t>(b) * di + d) * N;
#pragma unroll
    for (int n = 0; n < N; ++n) hb[n] = h[n];
  }
}

template <int N, typename T>
void launch(const void* u, const void* dt, const void* a, const void* b, const void* c,
            const void* d_skip, void* y, void* h_last, int bsz, int seq, int di,
            cudaStream_t stream) {
  const dim3 grid((di + kThreads - 1) / kThreads, bsz);
  selective_scan_fwd_kernel<N, T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(dt), static_cast<const float*>(a),
      static_cast<const T*>(b), static_cast<const T*>(c),
      static_cast<const float*>(d_skip), static_cast<float*>(y),
      static_cast<float*>(h_last), seq, di);
}

template <typename T>
bool dispatch_n(int n, const void* u, const void* dt, const void* a, const void* b,
                const void* c, const void* d_skip, void* y, void* h_last, int bsz,
                int seq, int di, cudaStream_t st) {
  switch (n) {
    case 4: launch<4, T>(u, dt, a, b, c, d_skip, y, h_last, bsz, seq, di, st); return true;
    case 8: launch<8, T>(u, dt, a, b, c, d_skip, y, h_last, bsz, seq, di, st); return true;
    case 16: launch<16, T>(u, dt, a, b, c, d_skip, y, h_last, bsz, seq, di, st); return true;
    default: return false;
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 = launched).  The
// caller allocates y and h_last and validates shapes; bad arguments that
// reach here return cudaErrorInvalidValue without a launch.
int selective_scan_fwd(const void* u, const void* dt, const void* a, const void* b,
                       const void* c, const void* d_skip, void* y, void* h_last,
                       int bsz, int seq, int di, int n, int is_bf16, void* stream) {
  if (bsz <= 0 || bsz > 65535 || seq <= 0 || di <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool ok = is_bf16
      ? dispatch_n<__nv_bfloat16>(n, u, dt, a, b, c, d_skip, y, h_last, bsz, seq, di, st)
      : dispatch_n<float>(n, u, dt, a, b, c, d_skip, y, h_last, bsz, seq, di, st);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

const char* selective_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
