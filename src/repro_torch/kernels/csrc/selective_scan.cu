// Mamba-1 selective scan forward for Hopper (sm_90a), plain C interface for
// ctypes.
//
// Replaces repro/kernels/selective_scan.py::selective_scan_kernel, the Pallas
// TPU kernel: from h = 0,
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * u_t) * B_t,   y_t = C_t . h_t + D * u_t
// with every product in f32 (bf16 inputs are widened on load).  Returns y
// [B, S, DI] f32 and the last state h_last [B, DI, N] f32.
//
// Layout: u, dt [B, S, DI]; a [DI, N] f32; b, c [B, S, N]; d_skip [DI] f32;
// all contiguous.  u, dt, b and c share one dtype (f32 or bf16).
//
// What bounds it on the H100.  Per (b, t, d, n): one exp, which is one FMUL
// and one MUFU.EX2 on the special function units (16 a clock per SM), and
// three more f32 operations (du * B, the decay FFMA, y's FFMA).  At
// hymba-1.5b's prefill (B=4, S=1536, DI=3200, N=16) the exps alone need
// ~0.075 ms of the card's SFUs, the bytes (u, dt, B, C in, y out) ~0.05 ms.
// Reaching the SFU rate takes several warps per scheduler, and an SM's
// shared memory delivers 128 bytes a clock to its lanes (32 banks of 4
// bytes): B and C at 8 bytes an element would use all of it at 16 elements
// a clock.  On the H100 the plan launch_plan picks runs at ~0.18 ms there
// (~0.11 ms at falcon-mamba-7b's prefill, bound 0.064): at hymba's 200
// blocks the busiest SMs hold 128 of an average 97 channels, and each of
// their schedulers issues about as many f32 instructions as its SFUs take
// clocks.
//
// Design.  The TPU kernel walks sequence blocks in order on one core and
// keeps the [block_d, N] state in VMEM between grid steps.  Here a block of
// 128 threads loops over the whole sequence for 128 / L * K consecutive
// channels of one batch row.  It is 128 / L groups of L lanes; a group owns
// K channels, and each lane holds N / L states of each of them (at most 16)
// with their row of A, pre-scaled by log2(e) so a decay is one FMUL and one
// ex2.approx.  L and K are template parameters (plan_fits below).  Splitting
// the states over L lanes multiplies the warps by L over one thread a
// channel (the earlier design, ~10x the bound, kept in
// baselines/selective_scan_per_channel.cu to time this one against); K
// channels a lane share each load of B and C, which divides their
// shared-memory traffic by K.
//
// y's sum over N crosses lanes.  Each lane keeps its partial C . h for L
// consecutive steps and K channels in registers, then a butterfly
// reduce-scatter (K * (L - 1) shuffles over log2 L rounds) leaves lane i
// with the whole sums of step i: under one shuffle a lane a step per
// channel whatever L is.  Lane i adds D * u and writes y of step i for its K
// channels, one 8- or 16-byte store where DI allows.
//
// Staging.  u, dt, B and C come through shared memory kChunk steps at a
// time, in a two-stage ring filled by cp.async (16-byte vectors along DI,
// and along N for B and C) one chunk ahead of the compute.  The lanes read u
// and dt as staged (bf16 is widened by a shift); B and C are widened to f32
// once a chunk, since every lane reads them.  Inputs that are not 16-byte
// aligned (a DI, or S * N, that is no multiple of the vector width) take
// plain loads into the same ring.  Steps past S and channels past DI are
// zero-filled: dt = 0 leaves h as it is (decay 1, input 0), and nothing is
// written for them, so any S and any DI run without host padding.
//
// The wrapper (selective_scan.py::launch_plan) picks L and K for a shape,
// one of the two plans per N that are instantiated (picked below): the
// first where its grid has a block for every SM, else the second, with
// twice the lanes a channel.  picked, block_channels, plan_fits and
// smem_bytes are mirrored there.
#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 64;            // timesteps staged per round
constexpr int kUnrollElems = 128;     // (b, t, d, n) elements a lane unrolled
constexpr int kThreads = 128;         // a block: 128 / L groups of L lanes
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxSmem = 227 * 1024;  // an H100 block's dynamic shared memory
// Steps between two checkpoints of h for the backward (selective_scan_bwd.cu
// has the same kSeg; selective_scan.py::CKPT_STEPS mirrors it).
constexpr int kSeg = 16;
static_assert(kChunk % kSeg == 0 && kSeg % 16 == 0, "segments start at groups of L steps");
static_assert(kChunk % 16 == 0, "a chunk holds whole groups of up to 16 steps");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 16 bytes from global to shared memory, or 16 zero bytes when !in.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Channels of a block: 128 / L groups of L lanes, K channels a group.
__host__ __device__ constexpr int block_channels(int lanes, int per_lane) {
  return kThreads / lanes * per_lane;
}
// The plans this code takes: at most 16 states a lane (K * N / L) and 128
// channels a block.
constexpr bool plan_fits(int n, int lanes, int per_lane) {
  return per_lane * (n / lanes) <= 16 && block_channels(lanes, per_lane) <= 128;
}
// The plans selective_scan.py::launch_plan picks (its PLANS), the only ones
// instantiated: for each N, one for grids that fill the card and one for
// grids that do not.
constexpr bool picked(int n, int lanes, int per_lane) {
  return (n == 16 && ((lanes == 4 && per_lane == 2) || (lanes == 8 && per_lane == 2))) ||
         (n == 8 && ((lanes == 2 && per_lane == 2) || (lanes == 4 && per_lane == 2))) ||
         (n == 4 && ((lanes == 2 && per_lane == 2) || (lanes == 4 && per_lane == 2)));
}

// Bytes of dynamic shared memory for a block (mirrored by launch_plan): B, C
// widened to f32 [kChunk][N], then two stages of u, dt [kChunk][channels]
// and B, C [kChunk][N] in the input type.  Every part is a multiple of 16
// bytes.
constexpr size_t smem_bytes(int channels, int n, size_t elt) {
  return 2 * static_cast<size_t>(kChunk) * n * sizeof(float) +
         2 * 2 * static_cast<size_t>(kChunk) * (channels + n) * elt;
}

struct Args {
  const void *u, *dt, *a, *b, *c, *d_skip;
  void *y, *h_last, *hck;
  int bsz, seq, di, vec;
};

// P floats of shared memory into registers, as 16- or 8-byte loads.
template <int P>
__device__ __forceinline__ void load_row(const float* s, float (&v)[P]) {
  if constexpr (P % 4 == 0) {
#pragma unroll
    for (int q = 0; q < P / 4; ++q) {
      const float4 x = reinterpret_cast<const float4*>(s)[q];
      v[4 * q] = x.x;
      v[4 * q + 1] = x.y;
      v[4 * q + 2] = x.z;
      v[4 * q + 3] = x.w;
    }
  } else if constexpr (P == 2) {
    const float2 x = *reinterpret_cast<const float2*>(s);
    v[0] = x.x;
    v[1] = x.y;
  } else {
    v[0] = s[0];
  }
}
template <int P>
__device__ __forceinline__ void load_row(const __nv_bfloat16* s, float (&v)[P]) {
  if constexpr (P == 1) {
    v[0] = __bfloat162float(s[0]);
  } else {
    // bf16 is the top half of an f32: a shift or a mask widens it.
    unsigned w[P / 2];
    if constexpr (P == 2) {
      w[0] = *reinterpret_cast<const unsigned*>(s);
    } else {
      const uint2 x = *reinterpret_cast<const uint2*>(s);
      w[0] = x.x;
      w[1] = x.y;
    }
#pragma unroll
    for (int q = 0; q < P / 2; ++q) {
      v[2 * q] = __uint_as_float(w[q] << 16);
      v[2 * q + 1] = __uint_as_float(w[q] & 0xffff0000u);
    }
  }
}

// The first `live` of K floats to global memory: one 8- or 16-byte store
// when `vec` (all K live and the address aligned), else K scalar ones.
template <int K>
__device__ __forceinline__ void store_row(float* g, const float (&v)[K], int live, bool vec) {
  if constexpr (K == 4) {
    if (vec) {
      *reinterpret_cast<float4*>(g) = make_float4(v[0], v[1], v[2], v[3]);
      return;
    }
  } else if constexpr (K == 2) {
    if (vec) {
      *reinterpret_cast<float2*>(g) = make_float2(v[0], v[1]);
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (k < live) g[k] = v[k];
  }
}

// part[j] holds this lane's share of y for step j of a group of L steps.
// Round M (L/2, ..., 1) of the butterfly reduce-scatter: a lane keeps the
// half of its steps whose bit M matches its own and sends the other half to
// lane ^ M, which keeps those.  After the last round part[0] is the sum over
// the L lanes of the group for step `lane`.
template <int L, int M = L / 2>
__device__ __forceinline__ void reduce_scatter(float (&part)[L], int lane) {
  if constexpr (M >= 1) {
    const bool upper = lane & M;
#pragma unroll
    for (int k = 0; k < M; ++k) {
      const float send = upper ? part[k] : part[k + M];
      const float keep = upper ? part[k + M] : part[k];
      part[k] = keep + __shfl_xor_sync(kFull, send, M);
    }
    reduce_scatter<L, M / 2>(part, lane);
  }
}

// kCkpt: write the state entering each kSeg-step segment to hck (training);
// the serving instantiation has no code for it.
template <int N, int L, int K, typename T, bool kCkpt>
__global__ void __launch_bounds__(kThreads)
selective_scan_fwd_kernel(const T* __restrict__ u, const T* __restrict__ dt,
                          const float* __restrict__ a, const T* __restrict__ bm,
                          const T* __restrict__ cm, const float* __restrict__ d_skip,
                          float* __restrict__ y, float* __restrict__ h_last,
                          float* __restrict__ hck, int seq, int di, bool vec) {
  constexpr int P = N / L;                        // states a lane holds per channel
  constexpr int kParts = P >= 8 ? P / 4 : 1;      // C . h as chains of at most 4 FMAs
  constexpr int kChannels = block_channels(L, K);
  constexpr int kVec = 16 / sizeof(T);            // elements of a 16-byte vector
  constexpr int kStage = 2 * kChunk * (kChannels + N);
  // Groups of L steps unrolled in the step loop: about kUnrollElems
  // elements a lane, so the schedule overlaps steps without running out of
  // registers.
  constexpr int kUnrollSteps = kUnrollElems / (K * P);
  constexpr int kUnroll = kUnrollSteps <= L ? 1 : kUnrollSteps >= kChunk ? kChunk / L
                                                                          : kUnrollSteps / L;
  extern __shared__ float4 smem[];
  float* const f_b = reinterpret_cast<float*>(smem);
  float* const f_c = f_b + kChunk * N;
  T* const raw = reinterpret_cast<T*>(f_c + kChunk * N);

  const int tid = threadIdx.x;
  const int group = tid / L;                      // this lane's K channels ...
  const int lane = tid % L;                       // ... and its P states of each
  const int d0 = blockIdx.x * kChannels;
  const int dk = d0 + group * K;                  // the first of the K channels
  const size_t row0 = static_cast<size_t>(blockIdx.y) * seq;
  const bool y_vec = di % K == 0;  // a lane's K values of y as one store

  float a2[K][P], h[K][P], dsk[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int dd = dk + k < di ? dk + k : di - 1;  // reads stay inside a, d_skip
    dsk[k] = d_skip[dd];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      a2[k][p] = a[static_cast<size_t>(dd) * N + lane * P + p] * kLog2e;
      h[k][p] = 0.f;
    }
  }

  // Chunk [t0, t0 + kChunk) into raw stage s; always commits one group.
  auto issue = [&](int t0, int s) {
    T* const r_u = raw + s * kStage;
    T* const r_dt = r_u + kChunk * kChannels;
    T* const r_b = r_dt + kChunk * kChannels;
    T* const r_c = r_b + kChunk * N;
    if (t0 < seq) {
      if (vec) {
        constexpr int kPerRow = kChannels / kVec;
        for (int v = tid; v < kChunk * kPerRow; v += kThreads) {
          const int j = v / kPerRow;
          const int col = (v % kPerRow) * kVec;
          const bool in = t0 + j < seq && d0 + col < di;
          const size_t off = in ? (row0 + t0 + j) * di + d0 + col : 0;
          cp_async16(r_u + j * kChannels + col, u + off, in);
          cp_async16(r_dt + j * kChannels + col, dt + off, in);
        }
        for (int e = tid * kVec; e < kChunk * N; e += kThreads * kVec) {
          const bool in = t0 + e / N < seq;
          const size_t off = in ? (row0 + t0) * N + e : 0;
          cp_async16(r_b + e, bm + off, in);
          cp_async16(r_c + e, cm + off, in);
        }
      } else {
        for (int e = tid; e < kChunk * kChannels; e += kThreads) {
          const int j = e / kChannels;
          const int col = e % kChannels;
          const bool in = t0 + j < seq && d0 + col < di;
          const size_t off = (row0 + t0 + j) * di + d0 + col;
          r_u[e] = in ? u[off] : zero<T>();
          r_dt[e] = in ? dt[off] : zero<T>();
        }
        for (int e = tid; e < kChunk * N; e += kThreads) {
          const bool in = t0 + e / N < seq;
          const size_t off = (row0 + t0) * N + e;
          r_b[e] = in ? bm[off] : zero<T>();
          r_c[e] = in ? cm[off] : zero<T>();
        }
      }
    }
    cp_async_commit();
  };

  issue(0, 0);
  for (int t0 = 0, s = 0; t0 < seq; t0 += kChunk, s ^= 1) {
    const T* const r_u = raw + s * kStage;
    const T* const r_dt = r_u + kChunk * kChannels;
    cp_async_wait_all();  // this chunk's copies have landed ...
    __syncthreads();      // ... for every thread, and the last chunk is done
    {
      const T* const r_b = r_dt + kChunk * kChannels;
      const T* const r_c = r_b + kChunk * N;
      for (int e = tid; e < kChunk * N; e += kThreads) {
        f_b[e] = to_f32(r_b[e]);
        f_c[e] = to_f32(r_c[e]);
      }
    }
    __syncthreads();      // B and C are widened; the other stage is free
    issue(t0 + kChunk, s ^ 1);

    const T* const my_u = r_u + group * K;
    const T* const my_dt = r_dt + group * K;
#pragma unroll (kUnroll)
    for (int j0 = 0; j0 < kChunk; j0 += L) {
      if (kCkpt && (t0 + j0) % kSeg == 0 && t0 + j0 > 0 && t0 + j0 < seq) {
        // the state entering segment (t0 + j0) / kSeg, for the backward
        const int nseg = (seq + kSeg - 1) / kSeg;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (dk + k < di) {
            float* const hb = hck + ((static_cast<size_t>(blockIdx.y) * nseg + (t0 + j0) / kSeg) *
                                         di + dk + k) * N + lane * P;
#pragma unroll
            for (int p = 0; p < P; ++p) hb[p] = h[k][p];
          }
        }
      }
      float part[K][L];
#pragma unroll
      for (int jj = 0; jj < L; ++jj) {
        const int j = j0 + jj;
        float dtv[K], uv[K], bv[P], cv[P];
        load_row<K>(my_dt + j * kChannels, dtv);
        load_row<K>(my_u + j * kChannels, uv);
        load_row<P>(f_b + j * N + lane * P, bv);
        load_row<P>(f_c + j * N + lane * P, cv);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float du = dtv[k] * uv[k];
          float acc[kParts];
#pragma unroll
          for (int q = 0; q < kParts; ++q) acc[q] = 0.f;
#pragma unroll
          for (int p = 0; p < P; ++p) {
            h[k][p] = fmaf(ex2(dtv[k] * a2[k][p]), h[k][p], du * bv[p]);
            acc[p % kParts] = fmaf(h[k][p], cv[p], acc[p % kParts]);
          }
#pragma unroll
          for (int q = 1; q < kParts; ++q) acc[0] += acc[q];
          part[k][jj] = acc[0];
        }
      }
      float total[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        reduce_scatter<L>(part[k], lane);
        total[k] = part[k][0];
      }
      const int t = t0 + j0 + lane;  // the step whose y this lane writes
      if (t < seq && dk < di) {
        float us[K];
        load_row<K>(my_u + (j0 + lane) * kChannels, us);
#pragma unroll
        for (int k = 0; k < K; ++k) total[k] = fmaf(dsk[k], us[k], total[k]);
        store_row<K>(y + (row0 + t) * di + dk, total, di - dk, y_vec);
      }
    }
  }

#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (dk + k < di) {
      float* const hb = h_last + (static_cast<size_t>(blockIdx.y) * di + dk + k) * N + lane * P;
#pragma unroll
      for (int p = 0; p < P; ++p) hb[p] = h[k][p];
    }
  }
}

template <int N, int L, int K, typename T, bool kCkpt>
int launch(const Args& g, cudaStream_t stream) {
  constexpr int kChannels = block_channels(L, K);
  constexpr size_t kSmem = smem_bytes(kChannels, N, sizeof(T));
  auto* kernel = &selective_scan_fwd_kernel<N, L, K, T, kCkpt>;
  if constexpr (kSmem > 48 * 1024) {
    // Above 48 KB a block must ask for its shared memory, once per device
    // and instantiation (the first launch comes before any graph capture).
    static unsigned opted_in = 0;  // a bit per device
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= 32) return static_cast<int>(cudaErrorInvalidDevice);
    if (!(opted_in >> dev & 1u)) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(kSmem));
      if (err != cudaSuccess) return static_cast<int>(err);
      opted_in |= 1u << dev;
    }
  }
  const dim3 grid((g.di + kChannels - 1) / kChannels, g.bsz);
  kernel<<<grid, kThreads, kSmem, stream>>>(
      static_cast<const T*>(g.u), static_cast<const T*>(g.dt),
      static_cast<const float*>(g.a), static_cast<const T*>(g.b),
      static_cast<const T*>(g.c), static_cast<const float*>(g.d_skip),
      static_cast<float*>(g.y), static_cast<float*>(g.h_last), static_cast<float*>(g.hck),
      g.seq, g.di, g.vec != 0);
  return static_cast<int>(cudaGetLastError());
}

// The plans with a kernel: picked, and a block's shared memory fits.
template <int N, int L, int K, typename T>
constexpr bool instantiated() {
  return picked(N, L, K) && plan_fits(N, L, K) &&
         smem_bytes(block_channels(L, K), N, sizeof(T)) <= kMaxSmem;
}

template <int N, int L, int K, typename T>
int launch_ckpt(const Args& g, cudaStream_t st) {
  return g.hck != nullptr ? launch<N, L, K, T, true>(g, st) : launch<N, L, K, T, false>(g, st);
}

// K channels a lane, each with N / L states.
template <int N, int L, typename T>
int dispatch_k(int per_lane, const Args& g, cudaStream_t st) {
  switch (per_lane) {
    case 1: if constexpr (instantiated<N, L, 1, T>()) return launch_ckpt<N, L, 1, T>(g, st); break;
    case 2: if constexpr (instantiated<N, L, 2, T>()) return launch_ckpt<N, L, 2, T>(g, st); break;
    case 4: if constexpr (instantiated<N, L, 4, T>()) return launch_ckpt<N, L, 4, T>(g, st); break;
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

// Launches on `stream` and returns the CUDA error (0 = launched).  The plan
// comes from the caller (selective_scan.py::launch_plan): `lanes` (L, a
// power of two up to 16 that divides n) share a group of `per_lane` (K = 1,
// 2 or 4) channels, each lane holding n / L states of each, at most 16 in
// all; a block is 128 threads and 128 / L * K channels.  `vec` asks for
// 16-byte copies, only when u, dt, b and c are 16-byte aligned and di and
// seq * n are multiples of the vector width.  `hck` (nullable, f32 [bsz,
// ceil(seq / 16), di, n]) receives the state entering every 16-step segment
// but the first, for the backward; serving passes null.  The caller
// allocates y, h_last and hck and validates shapes; bad arguments return
// cudaErrorInvalidValue without a launch.
int selective_scan_fwd(const void* u, const void* dt, const void* a, const void* b,
                       const void* c, const void* d_skip, void* y, void* h_last, void* hck,
                       int bsz, int seq, int di, int n, int lanes, int per_lane, int vec,
                       int is_bf16, void* stream) {
  if (bsz <= 0 || bsz > 65535 || seq <= 0 || di <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (vec) {
    const int width = is_bf16 ? 8 : 4;
    const uintptr_t any = reinterpret_cast<uintptr_t>(u) | reinterpret_cast<uintptr_t>(dt) |
                          reinterpret_cast<uintptr_t>(b) | reinterpret_cast<uintptr_t>(c);
    if (any % 16 != 0 || di % width != 0 || (static_cast<long long>(seq) * n) % width != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const Args g{u, dt, a, b, c, d_skip, y, h_last, hck, bsz, seq, di, vec};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch_n<__nv_bfloat16>(n, lanes, per_lane, g, st)
                 : dispatch_n<float>(n, lanes, per_lane, g, st);
}

const char* selective_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
