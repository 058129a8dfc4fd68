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
//   ddt_t = sum_n dh_t A exp(dt_t A) h_{t-1} + u_t sum_n dh_t B_t
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
// What bounds it on the H100.  Per (b, t, d, n) the gradient needs one exp,
// each step's decay exp(dt_t A), on the special function units, 16 a clock
// per SM at 1980 MHz: 0.050 ms at hymba-1.5b's training shape (u [2, 2048,
// 3200], N 16), the bound chip_smoke.py reports.  This design computes that
// exp twice, in the recompute and in the backward step: ~0.10 ms.  ~14 f32
// operations, which take about as long as one exp at the f32 rate, and the
// lane shuffles of the sums over N and over channels.  The bytes (u, dt, B,
// C, dy in, du, ddt, dB, dC out, the checkpoints) are ~0.05 ms.  What holds
// this design back is instruction issue in the segment loop (the recompute
// pass, the f32 arithmetic and the shuffles of the sums) with at most 8
// warps on an SM to hide latency (the busiest SMs hold 2 of hymba's 200
// blocks, the mean is 1.5), then the per-block dB/dC partial rows, which a
// second kernel sums.  On an NVIDIA H100 80GB HBM3 at 700 W it takes
// 0.46-0.48 ms at hymba-1.5b's training shape and 0.92-0.94 ms at
// falcon-mamba-7b's (u [2, 2048, 8192]) in chip_smoke.py's report and in
// fwd_turns --backward (PERF.md section 6).
//
// Design.  A block of 128 threads for 128 / L * K channels of one batch row,
// L lanes sharing a group of K channels, N / L states of each a lane, as the
// forward; the plan (L, K) is the backward's own
// (selective_scan.py::bwd_launch_plan).  The sequence is walked last to first
// in chunks of kChunk steps: u, dt, dy, B and C of a chunk come through a
// two-stage ring in shared memory filled by cp.async (16-byte vectors along
// DI and along N where aligned, plain loads into the same ring otherwise),
// the next earlier chunk in flight while this one runs; steps past S and
// channels past DI are zero-filled, which leaves h and dh as they are and
// adds nothing.  Within a chunk the kSeg-step segments run last to first: a
// segment's h_t is recomputed from its checkpoint (prefetched into registers
// one segment ahead) with the forward's own arithmetic (the same ex2 and
// FMAs, so the same values) into shared memory, [kSeg][K * P][128] f32, a
// thread reading only its own column; then its steps run backwards from the
// staged chunk, each lane carrying dh for its states in registers.  Sums
// over N (du, ddt) are butterfly reduce-scatters over the L lanes of a group
// across L steps, which leave lane i with step i's sums (the forward's y);
// lane i puts du and ddt of its step into a staged output chunk, written out
// once a chunk in 16-byte vectors.  Sums over channels (dB, dC) are
// reduce-scatters over the 32 / L groups of a warp across as many steps,
// written per warp into shared memory and summed over the block's 4 warps in
// order once a chunk, into per-block partial rows; dA and dD sum over time
// in registers and are written per batch row.  A second kernel sums the
// partials over blocks (dB, dC) and batch rows (dA, dD) in order.  No
// atomics: the result does not depend on scheduling.
#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kSeg = 16;     // steps between checkpoints (selective_scan.cu)
constexpr int kChunk = 64;   // steps staged per round
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxSmem = 227 * 1024;
static_assert(kChunk % kSeg == 0, "a chunk holds whole segments");

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T> __device__ __forceinline__ T zero() { return from_f32<T>(0.f); }

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

__host__ __device__ constexpr int block_channels(int lanes, int per_lane) {
  return kThreads / lanes * per_lane;
}
// The plans this code takes: at least 2 and at most 16 lanes a group (the
// reduce-scatters run over L lanes and over 32 / L groups, each within a
// segment), at most 16 states a lane, at most 128 channels a block.
constexpr bool plan_fits(int n, int lanes, int per_lane) {
  return lanes >= 2 && lanes <= 16 && n % lanes == 0 && per_lane * (n / lanes) <= 16 &&
         block_channels(lanes, per_lane) <= 128;
}
// The plan selective_scan.py::bwd_launch_plan takes for each N (its
// BWD_PLANS), the only one instantiated; kernels/bwd_variants.py edits
// this to time every plan that fits.
constexpr bool picked(int n, int lanes, int per_lane) {
  return (n == 16 && lanes == 8 && per_lane == 2) || (n == 8 && lanes == 4 && per_lane == 1) ||
         (n == 4 && lanes == 4 && per_lane == 1);
}
// Dynamic shared memory, every part a multiple of 16 bytes: the segment's h
// [kSeg][K * P][128] f32, the per-warp channel sums of dB and dC
// [2][kWarps][kChunk][N] f32, two stages of dy [kChunk][channels] f32, then in
// the input type two stages of u, dt [kChunk][channels] and B, C
// [kChunk][N], and the output chunk du, ddt [kChunk][channels].  Mirrored by
// selective_scan.py::bwd_smem_bytes.
constexpr size_t bwd_smem_bytes(int n, int lanes, int per_lane, size_t elt) {
  const size_t ch = block_channels(lanes, per_lane);
  return (static_cast<size_t>(kSeg) * per_lane * (n / lanes) * kThreads +
          2 * static_cast<size_t>(kWarps) * kChunk * n + 2 * kChunk * ch) * sizeof(float) +
         (2 * (2 * kChunk * ch + 2 * kChunk * static_cast<size_t>(n)) + 2 * kChunk * ch) * elt;
}

struct Args {
  const void *u, *dt, *a, *b, *c, *d_skip, *hck, *dy;
  void *du, *ddt, *da, *db, *dc, *dd;
  float *db_part, *dc_part, *da_part, *dd_part;
  int bsz, seq, di, vec;
};

// P floats (or P values of the input type, widened) of shared memory into
// registers, as one 4-, 8- or 16-byte load where P allows.
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
#pragma unroll
      for (int q = 0; q < P / 4; ++q) {
        const uint2 x = reinterpret_cast<const uint2*>(s)[q];
        w[2 * q] = x.x;
        w[2 * q + 1] = x.y;
      }
    }
#pragma unroll
    for (int q = 0; q < P / 2; ++q) {
      v[2 * q] = __uint_as_float(w[q] << 16);
      v[2 * q + 1] = __uint_as_float(w[q] & 0xffff0000u);
    }
  }
}

// part[j] holds this participant's share of a sum for step j of a group of
// R steps; participants are R lanes `stride` apart, `idx` this one's index
// among them.  Round M (R/2, ..., 1) of the butterfly reduce-scatter: keep
// the half of the steps whose bit M matches idx, send the other half to the
// partner idx ^ M.  After the last round part[0] is the sum over the R
// participants for step idx: R - 1 shuffles for R steps.
template <int R, int kStride, int M = R / 2>
__device__ __forceinline__ void reduce_scatter(float (&part)[R], int idx) {
  if constexpr (M >= 1) {
    const bool upper = idx & M;
#pragma unroll
    for (int k = 0; k < M; ++k) {
      const float send = upper ? part[k] : part[k + M];
      const float keep = upper ? part[k + M] : part[k];
      part[k] = keep + __shfl_xor_sync(kFull, send, M * kStride);
    }
    reduce_scatter<R, kStride, M / 2>(part, idx);
  }
}

template <int N, int L, int K, typename T>
__global__ void __launch_bounds__(kThreads)
selective_scan_bwd_kernel(const T* __restrict__ u, const T* __restrict__ dt,
                          const float* __restrict__ a, const T* __restrict__ bm,
                          const T* __restrict__ cm, const float* __restrict__ d_skip,
                          const float* __restrict__ hck, const float* __restrict__ dy,
                          T* __restrict__ du, T* __restrict__ ddt,
                          float* __restrict__ db_part, float* __restrict__ dc_part,
                          float* __restrict__ da_part, float* __restrict__ dd_part, int bsz,
                          int seq, int di, bool vec) {
  constexpr int P = N / L;                 // states a lane holds per channel
  constexpr int KP = K * P;
  constexpr int G = 32 / L;                // groups of a warp
  constexpr int kSG = L > G ? L : G;       // steps of a reverse group: whole L- and G-groups
  constexpr int kChannels = block_channels(L, K);
  constexpr int kVec = 16 / sizeof(T);     // elements of a 16-byte vector
  constexpr int kStage = 2 * kChunk * kChannels + 2 * kChunk * N;  // u, dt, B, C of a stage
  static_assert(kSeg % kSG == 0, "a segment holds whole reverse groups");
  extern __shared__ float4 smem[];
  float* const hist = reinterpret_cast<float*>(smem);     // [kSeg][KP][kThreads]
  float* const wsum_b = hist + kSeg * KP * kThreads;       // [kWarps][kChunk][N]
  float* const wsum_c = wsum_b + kWarps * kChunk * N;      // [kWarps][kChunk][N]
  float* const ring_dy = wsum_c + kWarps * kChunk * N;     // [2][kChunk][kChannels]
  T* const ring = reinterpret_cast<T*>(ring_dy + 2 * kChunk * kChannels);  // [2][kStage]
  T* const out_du = ring + 2 * kStage;                     // [kChunk][kChannels]
  T* const out_ddt = out_du + kChunk * kChannels;          // [kChunk][kChannels]

  const int tid = threadIdx.x;
  const int group = tid / L;
  const int lane = tid % L;
  const int warp = tid >> 5;
  const int gw = (tid & 31) / L;  // this lane's group within the warp
  const int d0 = blockIdx.x * kChannels;
  const int dk = d0 + group * K;
  const int brow = blockIdx.y;
  const size_t row0 = static_cast<size_t>(brow) * seq;
  const int nseg = (seq + kSeg - 1) / kSeg;
  const int nchunk = (seq + kChunk - 1) / kChunk;

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

  // The state entering segment sg (0: none, h = 0).
  auto checkpoint = [&](int sg, float (&h)[K][P]) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int p = 0; p < P; ++p) {
        h[k][p] = sg > 0 && live[k]
                      ? hck[((static_cast<size_t>(brow) * nseg + sg) * di + dk + k) * N +
                            lane * P + p]
                      : 0.f;
      }
    }
  };

  // Chunk c (c < 0: none) into ring stage s; always commits one group.
  auto issue = [&](int c, int s) {
    float* const r_dy = ring_dy + s * kChunk * kChannels;
    T* const r_u = ring + s * kStage;
    T* const r_dt = r_u + kChunk * kChannels;
    T* const r_b = r_dt + kChunk * kChannels;
    T* const r_c = r_b + kChunk * N;
    const int t0 = c * kChunk;
    if (c >= 0) {
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
        constexpr int kPerRowF = kChannels / 4;
        for (int v = tid; v < kChunk * kPerRowF; v += kThreads) {
          const int j = v / kPerRowF;
          const int col = (v % kPerRowF) * 4;
          const bool in = t0 + j < seq && d0 + col < di;
          const size_t off = in ? (row0 + t0 + j) * di + d0 + col : 0;
          cp_async16(r_dy + j * kChannels + col, dy + off, in);
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
          r_dy[e] = in ? dy[off] : 0.f;
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

  float h_next[K][P];  // the checkpoint of the next segment to run
  checkpoint(nseg - 1, h_next);
  issue(nchunk - 1, 0);
  for (int c = nchunk - 1, s = 0; c >= 0; --c, s ^= 1) {
    cp_async_wait_all();  // this chunk's copies (and plain stores) have landed ...
    __syncthreads();      // ... for every thread; the last chunk's output and sums are out
    issue(c - 1, s ^ 1);
    const float* const r_dy = ring_dy + s * kChunk * kChannels + group * K;
    const T* const r_u = ring + s * kStage + group * K;
    const T* const r_dt = ring + s * kStage + kChunk * kChannels + group * K;
    const T* const r_b = ring + s * kStage + 2 * kChunk * kChannels + lane * P;
    const T* const r_c = r_b + kChunk * N;
    const int tc0 = c * kChunk;

    for (int sg = kChunk / kSeg - 1; sg >= 0; --sg) {
      const int t0 = tc0 + sg * kSeg;
      if (t0 >= seq) continue;  // the same for every thread
      const int j0 = sg * kSeg;  // the segment's first row of the chunk
      float h0[K][P];
#pragma unroll
      for (int k = 0; k < K; ++k) {
#pragma unroll
        for (int p = 0; p < P; ++p) h0[k][p] = h_next[k][p];
      }
      if (t0 > 0) checkpoint(t0 / kSeg - 1, h_next);  // in flight through this segment

      // Recompute the segment's states, as the forward computes them.
      float h[K][P];
#pragma unroll
      for (int k = 0; k < K; ++k) {
#pragma unroll
        for (int p = 0; p < P; ++p) h[k][p] = h0[k][p];
      }
#pragma unroll
      for (int tt = 0; tt < kSeg; ++tt) {
        const int j = j0 + tt;
        float dtv[K], uv[K], bv[P];
        load_row<K>(r_dt + j * kChannels, dtv);
        load_row<K>(r_u + j * kChannels, uv);
        load_row<P>(r_b + j * N, bv);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float dtu = dtv[k] * uv[k];
#pragma unroll
          for (int p = 0; p < P; ++p) {
            h[k][p] = fmaf(ex2(dtv[k] * a2[k][p]), h[k][p], dtu * bv[p]);
            if (tt < kSeg - 1) hist[(tt * KP + k * P + p) * kThreads + tid] = h[k][p];
          }
        }
      }

      // The segment's steps, last to first, in groups of kSG steps; h holds
      // h_t of the step at hand.
#pragma unroll
      for (int g0 = kSeg - kSG; g0 >= 0; g0 -= kSG) {
        float du_p[K][L], ddt_p[K][L], db_p[P][G], dc_p[P][G];
#pragma unroll
        for (int jj = kSG - 1; jj >= 0; --jj) {
          const int tt = g0 + jj;
          const int j = j0 + tt;
          float dtv[K], uv[K], dyv[K], bv[P], cv[P];
          load_row<K>(r_dt + j * kChannels, dtv);
          load_row<K>(r_u + j * kChannels, uv);
          load_row<K>(r_dy + j * kChannels, dyv);
          load_row<P>(r_b + j * N, bv);
          load_row<P>(r_c + j * N, cv);
#pragma unroll
          for (int p = 0; p < P; ++p) db_p[p][jj % G] = dc_p[p][jj % G] = 0.f;
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const float dtu = dtv[k] * uv[k];
            dd_acc[k] = fmaf(dyv[k], uv[k], dd_acc[k]);
            float gb = 0.f, gda = 0.f;  // sum_p dh B, sum_p dh A exp(dt A) h_{t-1}
#pragma unroll
            for (int p = 0; p < P; ++p) {
              const float dec = ex2(dtv[k] * a2[k][p]);
              const float hp =
                  tt > 0 ? hist[((tt - 1) * KP + k * P + p) * kThreads + tid] : h0[k][p];
              const float g = fmaf(dh[k][p], dec_next[k][p], cv[p] * dyv[k]);
              dh[k][p] = g;
              dec_next[k][p] = dec;
              const float gdh = g * dec * hp;
              da_acc[k][p] = fmaf(gdh, dtv[k], da_acc[k][p]);
              gda = fmaf(gdh, araw[k][p], gda);
              gb = fmaf(g, bv[p], gb);
              db_p[p][jj % G] = fmaf(g, dtu, db_p[p][jj % G]);
              dc_p[p][jj % G] = fmaf(dyv[k], h[k][p], dc_p[p][jj % G]);
              h[k][p] = hp;
            }
            du_p[k][jj % L] = dtv[k] * gb;
            ddt_p[k][jj % L] = fmaf(uv[k], gb, gda);
          }
          if (jj % L == 0) {  // steps g0 + jj .. + L - 1: sums over N, lane i's step i
#pragma unroll
            for (int k = 0; k < K; ++k) {
              reduce_scatter<L, 1>(du_p[k], lane);
              reduce_scatter<L, 1>(ddt_p[k], lane);
            }
            const int jr = j0 + g0 + jj + lane;
            float dyr[K];
            load_row<K>(r_dy + jr * kChannels, dyr);
#pragma unroll
            for (int k = 0; k < K; ++k) {
              out_du[jr * kChannels + group * K + k] = from_f32<T>(fmaf(dyr[k], dsk[k], du_p[k][0]));
              out_ddt[jr * kChannels + group * K + k] = from_f32<T>(ddt_p[k][0]);
            }
          }
          if (jj % G == 0) {  // steps g0 + jj .. + G - 1: sums over the warp's channels
#pragma unroll
            for (int p = 0; p < P; ++p) {
              reduce_scatter<G, L>(db_p[p], gw);
              reduce_scatter<G, L>(dc_p[p], gw);
              const int o = (warp * kChunk + j0 + g0 + jj + gw) * N + lane * P + p;
              wsum_b[o] = db_p[p][0];
              wsum_c[o] = dc_p[p][0];
            }
          }
        }
      }
    }
    __syncthreads();  // the chunk's du, ddt and per-warp sums are in shared memory

    // The block's sums of dB and dC over its warps, in order, into its
    // partial rows; the chunk's du and ddt, out in 16-byte vectors where
    // aligned.  The next chunk's first barrier frees both buffers.
    const int rows = min(kChunk, seq - tc0);
    for (int e = tid; e < rows * N; e += kThreads) {
      const int j = e / N, n = e % N;
      float sb = 0.f, sc = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        sb += wsum_b[(w * kChunk + j) * N + n];
        sc += wsum_c[(w * kChunk + j) * N + n];
      }
      const size_t o = ((static_cast<size_t>(blockIdx.x) * bsz + brow) * seq + tc0 + j) * N + n;
      db_part[o] = sb;
      dc_part[o] = sc;
    }
    if (vec) {
      constexpr int kPerRow = kChannels / kVec;
      for (int v = tid; v < kChunk * kPerRow; v += kThreads) {
        const int j = v / kPerRow;
        const int col = (v % kPerRow) * kVec;
        if (j < rows && d0 + col < di) {
          const size_t off = (row0 + tc0 + j) * di + d0 + col;
          *reinterpret_cast<uint4*>(du + off) =
              *reinterpret_cast<const uint4*>(out_du + j * kChannels + col);
          *reinterpret_cast<uint4*>(ddt + off) =
              *reinterpret_cast<const uint4*>(out_ddt + j * kChannels + col);
        }
      }
    } else {
      for (int e = tid; e < kChunk * kChannels; e += kThreads) {
        const int j = e / kChannels;
        const int col = e % kChannels;
        if (j < rows && d0 + col < di) {
          const size_t off = (row0 + tc0 + j) * di + d0 + col;
          du[off] = out_du[e];
          ddt[off] = out_ddt[e];
        }
      }
    }
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
  constexpr size_t kSmem = bwd_smem_bytes(N, L, K, sizeof(T));
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
      g.db_part, g.dc_part, g.da_part, g.dd_part, g.bsz, g.seq, g.di, g.vec != 0);
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
  return picked(N, L, K) && plan_fits(N, L, K) && bwd_smem_bytes(N, L, K, sizeof(T)) <= kMaxSmem;
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
// error (0 = launched).  The plan (lanes, per_lane) comes from
// selective_scan.py::bwd_launch_plan; `vec` asks for 16-byte copies, only
// when u, dt, b, c and dy are 16-byte aligned and di and seq * n are
// multiples of the input type's vector width.  The caller allocates du, ddt,
// db, dc (input dtype), da [DI, N] and dd [DI] (f32), and the f32 partials:
// db_part, dc_part [ceil(DI / channels), B, S, N], da_part [B, DI, N],
// dd_part [B, DI]; bad arguments return cudaErrorInvalidValue without a
// launch.
int selective_scan_bwd(const void* u, const void* dt, const void* a, const void* b,
                       const void* c, const void* d_skip, const void* hck, const void* dy,
                       void* du, void* ddt, void* da, void* db, void* dc, void* dd,
                       void* db_part, void* dc_part, void* da_part, void* dd_part, int bsz,
                       int seq, int di, int n, int lanes, int per_lane, int vec, int is_bf16,
                       void* stream) {
  if (bsz <= 0 || bsz > 65535 || seq <= 0 || di <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (vec) {
    const int width = is_bf16 ? 8 : 4;
    const uintptr_t any = reinterpret_cast<uintptr_t>(u) | reinterpret_cast<uintptr_t>(dt) |
                          reinterpret_cast<uintptr_t>(b) | reinterpret_cast<uintptr_t>(c) |
                          reinterpret_cast<uintptr_t>(dy) | reinterpret_cast<uintptr_t>(du) |
                          reinterpret_cast<uintptr_t>(ddt);
    if (any % 16 != 0 || di % width != 0 || (static_cast<long long>(seq) * n) % width != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const Args g{u, dt, a, b, c, d_skip, hck, dy, du, ddt, da, db, dc, dd,
               static_cast<float*>(db_part), static_cast<float*>(dc_part),
               static_cast<float*>(da_part), static_cast<float*>(dd_part), bsz, seq, di, vec};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch_n<__nv_bfloat16>(n, lanes, per_lane, g, st)
                 : dispatch_n<float>(n, lanes, per_lane, g, st);
}

const char* selective_scan_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
