// Flash attention backward for Hopper (sm_90a), plain C interface for ctypes.
//
// The TPU kernel (repro/kernels/flash_attention.py::flash_attention_kernel)
// has no VJP, and the JAX package never trains through it; its training
// path differentiates the plain attention.  This computes the same gradient
// as autograd through the plain version (kernels/ref.py::attention_ref):
// with S = Q K^T * scale, P = softmax(S) under the mask, O = P V,
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - D),  D = rowsum(dO * O),
//   dQ = scale * dS K,  dK = scale * dS^T Q,
// and dK, dV summed over the H / K query heads that share a kv head (GQA).
// P is recomputed tile by tile from the row log-sum-exp the forward wrote
// (lse [B, H, Sq] f32, natural log of the scaled scores): P = exp(S - lse).
// The masks are the forward's: causal and sliding-window from positions that
// both count from 0 (top-left), masked pairs get P = 0.  A query row that
// the masks leave with no key gets zero gradients.
//
// Layout: q, o, dO, dQ [B, H, Sq, HD]; k, v, dK, dV [B, K, Sk, HD];
// contiguous, f32 or bf16 (one dtype); every sum and product in f32.
//
// Three kernels, SIMT on the CUDA cores:
//   1. attn_bwd_dot_kernel: D, one warp a query row.
//   2. attn_bwd_dkdv_kernel: one block per (32-key tile, b * K + kv head).
//      K and V of the tile stay in shared memory; the block loops over the
//      group's query heads and over the 16-row query tiles that the masks
//      let reach the key tile (query_tile_range).  Per query tile, lane j
//      scores key j for 4 rows a warp (S and dP, as in the forward's SIMT
//      kernel), P and dS go through shared memory, and thread (warp w, lane
//      j) adds into dK and dV of key j at dims w, w + 4, ...: registers, no
//      atomics, so dK and dV are the same on every run.
//   3. attn_bwd_dq_kernel: one block per (16-row query tile, b * H + h),
//      over the key tiles of key_tile_range; lane j's dS is broadcast by
//      shuffles and lane i adds into dQ at dims i, i + 32, ...
//
// What bounds it on the H100: the admitted scores need 4 * HD FMAs each in
// the backward (S, dP, dV, dK; dQ 2 * HD more with its own recomputed S and
// dP), against the bytes of q, k, v, o, dO in and dq, dk, dv out.  On the
// tensor cores (bf16) the products would take ~0.1 ms at hymba-1.5b's
// training shape; this design runs them at the f32 CUDA-core rate, which is
// the first thing a redesign changes (wgmma, as the forward's mma.sync).
#include <cfloat>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kBlockQ = kWarps * kRowsPerWarp;  // query rows per tile
constexpr int kBlockK = 32;                     // keys per tile: one per lane
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

__device__ __forceinline__ bool admitted(int qpos, int kpos, int seq_q, int seq_k, int causal,
                                         int window) {
  bool ok = qpos < seq_q && kpos < seq_k;
  if (causal) ok = ok && kpos <= qpos;
  if (window > 0) ok = ok && qpos - kpos < window;
  return ok;
}

// Keys [begin, end) the query tile [q0, q0 + block_q) visits (the forward's
// key_tile_range, mirrored by flash_attention.py::key_tile_range).
__device__ __forceinline__ void key_tile_range(int q0, int block_q, int block_k, int seq_q,
                                               int seq_k, int causal, int window, int& begin,
                                               int& end) {
  const int q_last = min(q0 + block_q, seq_q) - 1;
  end = causal ? min(seq_k, q_last + 1) : seq_k;
  begin = window > 0 ? (max(0, q0 - window + 1) / block_k) * block_k : 0;
}

// Query rows [begin, end) that can see a key of the tile [k0, k0 + block_k),
// begin a multiple of block_q: causal rows start at the tile's first key, a
// window ends block_k + window - 1 rows after it.  Mirrored by
// flash_attention.py::query_tile_range.
__device__ __forceinline__ void query_tile_range(int k0, int block_k, int block_q, int seq_q,
                                                 int seq_k, int causal, int window,
                                                 int& begin, int& end) {
  const int k_last = min(k0 + block_k, seq_k) - 1;
  begin = causal ? (min(k0, seq_q) / block_q) * block_q : 0;
  end = window > 0 ? min(seq_q, k_last + window) : seq_q;
}

template <int HD>
constexpr int smem_floats() {
  return 2 * kBlockQ * HD + 2 * kBlockK * (HD + 1) + 2 * kBlockQ * kBlockK + 2 * kBlockQ;
}

// Rows [r0, r0 + rows) of a [seq][HD] matrix into an f32 tile with row
// stride `ld`, rows at or past `limit` zero-filled.
template <int HD, typename T>
__device__ __forceinline__ void load_rows(float* tile, int ld, const T* g, int r0, int rows,
                                          int limit) {
  for (int i = threadIdx.x; i < rows * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    tile[r * ld + d] = r0 + r < limit ? to_f32(g[static_cast<size_t>(r0 + r) * HD + d]) : 0.f;
  }
}

// S (raw dot products) and dP for this warp's rows row0.. of the query tile
// against key `lane` of the key tile.
template <int HD>
__device__ __forceinline__ void scores(const float* qs, const float* dos, const float* ks,
                                       const float* vs, int row0, int lane,
                                       float (&s)[kRowsPerWarp], float (&dp)[kRowsPerWarp]) {
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) s[r] = dp[r] = 0.f;
#pragma unroll 8
  for (int d = 0; d < HD; ++d) {
    const float kd = ks[lane * (HD + 1) + d];
    const float vd = vs[lane * (HD + 1) + d];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      s[r] = fmaf(qs[(row0 + r) * HD + d], kd, s[r]);
      dp[r] = fmaf(dos[(row0 + r) * HD + d], vd, dp[r]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dot_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                    float* __restrict__ dsum, int rows, int hd) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // whole warps
  const T* a = o + static_cast<size_t>(row) * hd;
  const T* b = dout + static_cast<size_t>(row) * hd;
  float s = 0.f;
  for (int d = lane; d < hd; d += 32) s = fmaf(to_f32(a[d]), to_f32(b[d]), s);
  s = warp_sum(s);
  if (lane == 0) dsum[row] = s;
}

template <int HD, typename T>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ dsum,
                     T* __restrict__ dk, T* __restrict__ dv, int group, int seq_q, int seq_k,
                     int causal, int window, float scale) {
  constexpr int kDims = HD / kWarps;  // dims a thread owns: warp, warp + 4, ...
  extern __shared__ float smem[];
  float* const qs = smem;                         // [kBlockQ][HD]
  float* const dos = qs + kBlockQ * HD;           // [kBlockQ][HD]
  float* const ks = dos + kBlockQ * HD;           // [kBlockK][HD + 1]
  float* const vs = ks + kBlockK * (HD + 1);      // [kBlockK][HD + 1]
  float* const ps = vs + kBlockK * (HD + 1);      // [kBlockQ][kBlockK]
  float* const dss = ps + kBlockQ * kBlockK;      // [kBlockQ][kBlockK]
  float* const lse_s = dss + kBlockQ * kBlockK;   // [kBlockQ]
  float* const dsum_s = lse_s + kBlockQ;          // [kBlockQ]

  const int k0 = blockIdx.x * kBlockK;
  const int kv_row = blockIdx.y;  // b * K + kv head
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = warp * kRowsPerWarp;
  const T* kb = k + static_cast<size_t>(kv_row) * seq_k * HD;
  const T* vb = v + static_cast<size_t>(kv_row) * seq_k * HD;
  load_rows<HD>(ks, HD + 1, kb, k0, kBlockK, seq_k);
  load_rows<HD>(vs, HD + 1, vb, k0, kBlockK, seq_k);

  float dk_acc[kDims], dv_acc[kDims];
#pragma unroll
  for (int i = 0; i < kDims; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  int q_begin, q_end;
  query_tile_range(k0, kBlockK, kBlockQ, seq_q, seq_k, causal, window, q_begin, q_end);
  const int kpos = k0 + lane;

  for (int g = 0; g < group; ++g) {
    const size_t bh = static_cast<size_t>(kv_row) * group + g;  // b * H + h
    const T* qb = q + bh * seq_q * HD;
    const T* db = dout + bh * seq_q * HD;
    for (int q0 = q_begin; q0 < q_end; q0 += kBlockQ) {
      __syncthreads();  // the previous tile's P and dS are consumed
      load_rows<HD>(qs, HD, qb, q0, kBlockQ, seq_q);
      load_rows<HD>(dos, HD, db, q0, kBlockQ, seq_q);
      if (threadIdx.x < kBlockQ) {
        const int qi = q0 + threadIdx.x;
        lse_s[threadIdx.x] = qi < seq_q ? lse[bh * seq_q + qi] : 0.f;
        dsum_s[threadIdx.x] = qi < seq_q ? dsum[bh * seq_q + qi] : 0.f;
      }
      __syncthreads();
      float s[kRowsPerWarp], dp[kRowsPerWarp];
      scores<HD>(qs, dos, ks, vs, row0, lane, s, dp);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int row = row0 + r;
        const float p = admitted(q0 + row, kpos, seq_q, seq_k, causal, window)
                            ? expf(s[r] * scale - lse_s[row])
                            : 0.f;
        ps[row * kBlockK + lane] = p;
        dss[row * kBlockK + lane] = p * (dp[r] - dsum_s[row]);
      }
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < kBlockQ; ++r) {
        const float p = ps[r * kBlockK + lane];
        const float ds = dss[r * kBlockK + lane];
#pragma unroll
        for (int i = 0; i < kDims; ++i) {
          const int d = warp + kWarps * i;
          dv_acc[i] = fmaf(p, dos[r * HD + d], dv_acc[i]);
          dk_acc[i] = fmaf(ds, qs[r * HD + d], dk_acc[i]);
        }
      }
    }
  }
  if (kpos < seq_k) {
    T* dkb = dk + (static_cast<size_t>(kv_row) * seq_k + kpos) * HD;
    T* dvb = dv + (static_cast<size_t>(kv_row) * seq_k + kpos) * HD;
#pragma unroll
    for (int i = 0; i < kDims; ++i) {
      const int d = warp + kWarps * i;
      dkb[d] = from_f32<T>(dk_acc[i] * scale);
      dvb[d] = from_f32<T>(dv_acc[i]);
    }
  }
}

template <int HD, typename T>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ dout, const float* __restrict__ lse,
                   const float* __restrict__ dsum, T* __restrict__ dq, int group, int seq_q,
                   int seq_k, int causal, int window, float scale) {
  constexpr int kDimsPerLane = (HD + 31) / 32;
  extern __shared__ float smem[];
  float* const qs = smem;
  float* const dos = qs + kBlockQ * HD;
  float* const ks = dos + kBlockQ * HD;
  float* const vs = ks + kBlockK * (HD + 1);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlockQ;
  const int kv_row = bh / group;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = warp * kRowsPerWarp;
  const T* qb = q + static_cast<size_t>(bh) * seq_q * HD;
  const T* db = dout + static_cast<size_t>(bh) * seq_q * HD;
  const T* kb = k + static_cast<size_t>(kv_row) * seq_k * HD;
  const T* vb = v + static_cast<size_t>(kv_row) * seq_k * HD;
  load_rows<HD>(qs, HD, qb, q0, kBlockQ, seq_q);
  load_rows<HD>(dos, HD, db, q0, kBlockQ, seq_q);
  float lse_r[kRowsPerWarp], dsum_r[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qi = q0 + row0 + r;
    lse_r[r] = qi < seq_q ? lse[static_cast<size_t>(bh) * seq_q + qi] : 0.f;
    dsum_r[r] = qi < seq_q ? dsum[static_cast<size_t>(bh) * seq_q + qi] : 0.f;
  }

  float acc[kRowsPerWarp][kDimsPerLane];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) acc[r][i] = 0.f;
  }
  int k_begin, k_end;
  key_tile_range(q0, kBlockQ, kBlockK, seq_q, seq_k, causal, window, k_begin, k_end);
  for (int kt = k_begin; kt < k_end; kt += kBlockK) {
    __syncthreads();  // the previous key tile is consumed (and qs, dos written)
    load_rows<HD>(ks, HD + 1, kb, kt, kBlockK, seq_k);
    load_rows<HD>(vs, HD + 1, vb, kt, kBlockK, seq_k);
    __syncthreads();
    float s[kRowsPerWarp], dp[kRowsPerWarp], ds[kRowsPerWarp];
    scores<HD>(qs, dos, ks, vs, row0, lane, s, dp);
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float p = admitted(q0 + row0 + r, kt + lane, seq_q, seq_k, causal, window)
                          ? expf(s[r] * scale - lse_r[r])
                          : 0.f;
      ds[r] = p * (dp[r] - dsum_r[r]);
    }
#pragma unroll 4
    for (int j = 0; j < kBlockK; ++j) {
      float kj[kDimsPerLane];
#pragma unroll
      for (int i = 0; i < kDimsPerLane; ++i) {
        const int d = lane + 32 * i;
        kj[i] = d < HD ? ks[j * (HD + 1) + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float dsj = __shfl_sync(kFull, ds[r], j);
#pragma unroll
        for (int i = 0; i < kDimsPerLane; ++i) acc[r][i] = fmaf(dsj, kj[i], acc[r][i]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qi = q0 + row0 + r;
    if (qi >= seq_q) continue;
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) {
      const int d = lane + 32 * i;
      if (d < HD) {
        dq[(static_cast<size_t>(bh) * seq_q + qi) * HD + d] = from_f32<T>(acc[r][i] * scale);
      }
    }
  }
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* dsum;
  void *dq, *dk, *dv;
  int b, h, kh, sq, sk, causal, window;
  float scale;
};

template <typename Kernel>
int opt_in(Kernel kernel, int smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

template <int HD, typename T>
int launch(const Args& a, cudaStream_t st) {
  const int group = a.h / a.kh;
  const int rows = a.b * a.h * a.sq;
  attn_bwd_dot_kernel<T><<<(rows + kWarps - 1) / kWarps, kThreads, 0, st>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.dsum, rows, HD);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  constexpr int smem = smem_floats<HD>() * static_cast<int>(sizeof(float));
  auto* dkdv = &attn_bwd_dkdv_kernel<HD, T>;
  auto* dqk = &attn_bwd_dq_kernel<HD, T>;
  int e = opt_in(dkdv, smem);
  if (e) return e;
  e = opt_in(dqk, smem);
  if (e) return e;
  const int n_kt = (a.sk + kBlockK - 1) / kBlockK;
  const int n_qt = (a.sq + kBlockQ - 1) / kBlockQ;
  dkdv<<<dim3(n_kt, a.b * a.kh), kThreads, smem, st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.dsum, static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), group, a.sq, a.sk, a.causal, a.window, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dqk<<<dim3(n_qt, a.b * a.h), kThreads, smem, st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.dsum, static_cast<T*>(a.dq), group, a.sq, a.sk,
      a.causal, a.window, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(int hd, const Args& a, cudaStream_t st) {
  switch (hd) {
    case 16: return launch<16, T>(a, st);
    case 32: return launch<32, T>(a, st);
    case 64: return launch<64, T>(a, st);
    case 128: return launch<128, T>(a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Launches the three kernels on `stream` and returns the CUDA error (0 =
// launched).  lse [B, H, Sq] comes from flash_attention_fwd; dsum is f32
// scratch of the same shape.  The caller allocates dq, dk, dv and validates
// shapes; bad arguments return cudaErrorInvalidValue without a launch.
int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                        const void* dout, const void* lse, void* dsum, void* dq, void* dk,
                        void* dv, int b, int h, int kh, int sq, int sk, int hd, int causal,
                        int window, int is_bf16, float scale, void* stream) {
  if (b <= 0 || h <= 0 || kh <= 0 || h % kh != 0 || sq <= 0 || sk <= 0 || window < 0 ||
      b * h > 65535 || (sq + kBlockQ - 1) / kBlockQ > 2147483647 / 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q, k, v, o, dout, static_cast<const float*>(lse), static_cast<float*>(dsum),
               dq, dk, dv, b, h, kh, sq, sk, causal, window, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch_hd<__nv_bfloat16>(hd, a, st) : dispatch_hd<float>(hd, a, st);
}

const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
