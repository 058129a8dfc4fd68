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
// contiguous, f32 or bf16 (one dtype), q, k, v, dO 16-byte aligned.
//
// What bounds it on the H100: each admitted score costs 10 * HD flops of
// products (S recomputed, dP, dV, dK, dQ) and two exps (P in each of the two
// kernels below), against the bytes of q, k, v, o, dO in and dq, dk, dv out.
// At hymba-1.5b's training shape (q [2, 25, 2048, 64], window 1024) that is
// ~0.05 ms of the bf16 tensor-core peak; the bytes are ~0.02 ms.  The
// products go to the tensor cores; the exps to the special function units.
// mma.sync reaches only part of the tensor-core peak (wgmma is the full
// rate), and S and dP are computed twice (in the dK/dV and in the dQ kernel,
// since dQ is summed without atomics): on an NVIDIA H100 80GB HBM3 at 700 W
// this design takes ~0.29 ms at hymba's shape and ~0.41 ms at qwen2-0.5b's
// (q [4, 14, 2048, 64], causal), against ~0.60 and ~0.29 ms of device time
// for SDPA's backward (cuDNN's wgmma kernel) on the same inputs.
//
// Three kernels, chosen by dtype like the forward's (each dtype has exactly
// one path; none is a fallback):
//   1. attn_bwd_dot_kernel: D, 16-byte loads, HD / (16 / sizeof(T)) lanes a
//      query row, summed by shuffles.
//   bf16, on the tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulate),
//   64-row query tiles by 64-key tiles, 4 warps of 16 rows a block:
//   2. attn_bwd_dkdv_tc_kernel: one block per (kv row b * K + kv head, key
//      tile), key tile 0 first: under a causal mask it sees every query tile,
//      the last one query tile.  Where that skew would leave the heaviest
//      blocks running alone (a causal mask without a window, GQA group 7:
//      the first key tile's block does twice the mean's work), the group is
//      cut into `splits` chunks of blocks (bwd_gqa_splits) whose f32 partial
//      rows of dK and dV a small kernel sums in order.
//      Each warp owns 16 keys, whose K and V rows it holds as bf16 A
//      fragments (HD <= 64; HD 128 reads them from shared memory by ldmatrix
//      to stay under 255 registers).  For each query head of the GQA group
//      and each 64-row query tile that query_tile_range admits, Q, dO, lse
//      and D come through a two-stage cp.async ring of XOR-swizzled rows (the
//      forward's K/V ring), the next tile's copies in flight while this one
//      runs.  S^T = K Q^T and dP^T = V dO^T take Q and dO as B fragments by
//      ldmatrix; P^T = exp2(S^T scale log2 e - lse log2 e), masked where the
//      tile needs it, and dS^T = P^T (dP^T - D); then dV += P^T dO and dK +=
//      dS^T Q with P^T and dS^T rounded to bf16 and passed from the
//      accumulators straight to A fragments (as the forward passes P), dO
//      and Q as B fragments by ldmatrix.trans.  HD 128 takes the query tile
//      in four strips of 16 (and the dQ kernel the key tile likewise), to
//      stay under 255 registers.  The GQA sum stays in registers (and in a
//      fixed order over the chunks of a split group): no atomics, so dK and
//      dV are the same bits on every run.
//   3. attn_bwd_dq_tc_kernel: one block per (b * H + h, query tile), the
//      heaviest (last) tiles first; each warp owns 16 query rows, held with
//      their dO rows (HD <= 64) as A fragments, over the key tiles of
//      key_tile_range, K and V through the ring: S = Q K^T, dP = dO V^T,
//      dS = P (dP - D), dQ += dS K with K by ldmatrix.trans.  No atomics.
//   f32, SIMT on the CUDA cores (it serves the f32 checks, which need f32
//   accuracy end to end):
//   2'. attn_bwd_dkdv_kernel: one block per (32-key tile, b * K + kv head)
//      over the 16-row query tiles of query_tile_range; lane j scores key j.
//   3'. attn_bwd_dq_kernel: one block per (16-row query tile, b * H + h).
// The one numerical departure from the plain version in bf16: P and dS are
// rounded to bf16 before their products, as the forward rounds P.
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

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

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

// o . dO of one 16-byte vector of each, in f32.
__device__ __forceinline__ float dot16(const uint4& a, const uint4& b, float) {
  return __uint_as_float(a.x) * __uint_as_float(b.x) + __uint_as_float(a.y) * __uint_as_float(b.y) +
         __uint_as_float(a.z) * __uint_as_float(b.z) + __uint_as_float(a.w) * __uint_as_float(b.w);
}
__device__ __forceinline__ float dot16(const uint4& a, const uint4& b, __nv_bfloat16) {
  const uint32_t x[4] = {a.x, a.y, a.z, a.w}, y[4] = {b.x, b.y, b.z, b.w};
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // bf16 is the top half of an f32: a shift or a mask widens it
    s = fmaf(__uint_as_float(x[i] << 16), __uint_as_float(y[i] << 16), s);
    s = fmaf(__uint_as_float(x[i] & 0xffff0000u), __uint_as_float(y[i] & 0xffff0000u), s);
  }
  return s;
}

// D = rowsum(dO * O) in f32: HD / kVec lanes a query row, each one 16-byte
// vector of o and of dO, summed over the row's lanes by shuffles.
template <int HD, typename T>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dot_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                    float* __restrict__ dsum, int rows) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kLanes = HD / kVec;         // 2 .. 32, a power of two
  constexpr int kRows = kThreads / kLanes;  // query rows a block
  const int row = blockIdx.x * kRows + threadIdx.x / kLanes;
  const int c = threadIdx.x % kLanes;
  float s = 0.f;
  if (row < rows) {
    const size_t off = static_cast<size_t>(row) * HD + c * kVec;
    s = dot16(*reinterpret_cast<const uint4*>(o + off),
              *reinterpret_cast<const uint4*>(dout + off), T());
  }
#pragma unroll
  for (int m = kLanes / 2; m > 0; m >>= 1) s += __shfl_xor_sync(kFull, s, m);
  if (row < rows && c == 0) dsum[row] = s;
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

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kTcWarps = 4;
constexpr int kTcThreads = kTcWarps * 32;
constexpr int kTcBlock = kTcWarps * 16;  // query rows and keys of a tile: 16 a warp
constexpr int kTcStages = 2;             // ring of tiles in shared memory
constexpr float kLog2e = 1.4426950408889634f;

// Dynamic shared memory of a dK/dV block (K and V tiles, then the ring of Q,
// dO, lse and D) and of a dQ block (Q and dO tiles, then the ring of K and
// V).  Mirrored by repro_torch/kernels/flash_attention.py::bwd_tc_smem_bytes.
constexpr int tc_dkdv_smem_bytes(int hd) {
  return (2 + 2 * kTcStages) * kTcBlock * hd * 2 + 2 * kTcStages * kTcBlock * 4;
}
constexpr int tc_dq_smem_bytes(int hd) { return (2 + 2 * kTcStages) * kTcBlock * hd * 2; }

// Whether the tile of query rows [q0, q0 + block_q) and keys [kt, kt +
// block_k) needs the mask: false only if the mask admits every pair in it
// with a query row below seq_q (the forward's tile_needs_mask, mirrored by
// flash_attention.py::tile_needs_mask).
__device__ __forceinline__ bool tile_needs_mask(int q0, int block_q, int kt, int block_k,
                                                int seq_q, int seq_k, int causal,
                                                int window) {
  const int q_last = min(q0 + block_q, seq_q) - 1;
  return kt + block_k > seq_k || (causal && kt + block_k - 1 > q0) ||
         (window > 0 && q_last - kt >= window);
}

// Element offset of 16-byte chunk c of `row` in a [rows][HD] bf16 tile, the
// chunk index XOR-swizzled by the row (by the 128-byte line for HD 16 and
// 32) so that ldmatrix and cp.async are free of bank conflicts: the
// forward's swz (csrc/flash_attention.cu).
template <int HD>
__device__ __forceinline__ int swz(int row, int c) {
  constexpr int kChunks = HD / 8;
  if constexpr (kChunks >= 8) {
    return row * HD + ((c ^ (row & 7)) << 3);
  } else {
    return row * HD + ((c ^ ((row / (8 / kChunks)) & (kChunks - 1))) << 3);
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy that bypasses L1; zero-fills when !valid.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// 4-byte copy, zero-filled when !valid (lse and D: a row's one float).
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a * b for one m16n8k16 tile: a 16x16 bf16 (row), b 16x8 bf16 (col), d f32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The A fragment of k16 slice kk of a warp's 16 x N accumulator strip (n8
// tiles 2 kk and 2 kk + 1), rounded to bf16: the accumulator layout of two
// adjacent n8 tiles is the A layout of one k16 slice.
template <int kNT>
__device__ __forceinline__ void acc_to_a(const float (&c)[kNT][4], int kk, uint32_t (&a)[4]) {
  a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// A fragment of k16 slice kk of rows [row0, row0 + 16) of a swizzled tile.
template <int HD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* tile, int row0,
                                       int kk, int lane) {
  ldmatrix_x4(a, smem_u32(tile + swz<HD>(row0 + (lane & 15), 2 * kk + (lane >> 4))));
}

// B fragments of n8 tiles (rows [row0, row0 + 8) and [row0 + 8, row0 + 16)
// of the tile) over k16 slice kk of its columns: b[0..1] and b[2..3].  B is
// the tile transposed, as K is in S = Q K^T.
template <int HD>
__device__ __forceinline__ void load_b(uint32_t (&b)[4], const __nv_bfloat16* tile, int row0,
                                       int kk, int lane) {
  ldmatrix_x4(b, smem_u32(tile + swz<HD>(row0 + (lane & 7) + ((lane >> 4) << 3),
                                         2 * kk + ((lane >> 3) & 1))));
}

// B fragments over k16 slice rows [row0, row0 + 16) of the tile, for the
// n8 tiles of columns 16 dp .. 16 dp + 15: b[0..1] and b[2..3].  B is the
// tile as stored, as V is in O = P V.
template <int HD>
__device__ __forceinline__ void load_b_trans(uint32_t (&b)[4], const __nv_bfloat16* tile,
                                             int row0, int dp, int lane) {
  ldmatrix_x4_trans(b, smem_u32(tile + swz<HD>(row0 + (lane & 7) + (((lane >> 3) & 1) << 3),
                                               2 * dp + (lane >> 4))));
}

// Copies rows [row0, row0 + 64) of a [seq][HD] bf16 matrix into a swizzled
// shared tile, rows at or past `limit` zero-filled.
template <int HD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* tile, const __nv_bfloat16* g,
                                          int row0, int limit, int tid) {
  constexpr int kChunks = HD / 8;
#pragma unroll
  for (int it = 0; it < kTcBlock * kChunks / kTcThreads; ++it) {
    const int i = tid + it * kTcThreads;
    const int r = i / kChunks, c = i % kChunks;
    const bool valid = row0 + r < limit;
    const __nv_bfloat16* src = g + static_cast<size_t>(valid ? row0 + r : 0) * HD + c * 8;
    cp_async16(smem_u32(tile + swz<HD>(r, c)), src, valid);
  }
}

// A warp's 16 x HD f32 accumulator strip, times `mul`, as bf16 rows
// [row0, row0 + 16) of a swizzled tile, then out to global rows
// [pos0, pos0 + 16) below `limit` in 16-byte stores.
template <int HD>
__device__ __forceinline__ void store_strip(const float (&acc)[HD / 8][4], float mul,
                                            __nv_bfloat16* tile, int row0,
                                            __nv_bfloat16* g, int pos0, int limit, int lane) {
  constexpr int kChunks = HD / 8;
  const int gr = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      *reinterpret_cast<uint32_t*>(tile + swz<HD>(row0 + gr + 8 * r, j) + 2 * t) =
          pack_bf16(acc[j][2 * r] * mul, acc[j][2 * r + 1] * mul);
    }
  }
  __syncwarp();
#pragma unroll
  for (int it = 0; it < 16 * kChunks / 32; ++it) {
    const int i = lane + it * 32;
    const int r = i / kChunks, c = i % kChunks;
    if (pos0 + r < limit) {
      *reinterpret_cast<uint4*>(g + static_cast<size_t>(pos0 + r) * HD + c * 8) =
          *reinterpret_cast<const uint4*>(tile + swz<HD>(row0 + r, c));
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kTcThreads, 2)
attn_bwd_dkdv_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                        const float* __restrict__ dsum, __nv_bfloat16* __restrict__ dk,
                        __nv_bfloat16* __restrict__ dv, float* __restrict__ part, int splits,
                        int group, int seq_q, int seq_k, int causal, int window, float scale,
                        float scale_log2) {
  static_assert(HD % 16 == 0 && HD <= 128, "head dim: a multiple of k16 up to 128");
  constexpr int kD = HD / 8;                       // n8 tiles of a dK or dV strip
  constexpr bool kKVRegs = HD <= 64;               // K, V rows held as A fragments
  constexpr int kSub = HD <= 64 ? kTcBlock : 16;   // queries of one S^T strip
  constexpr int kNT = kSub / 8;                    // its n8 tiles
  extern __shared__ __align__(128) unsigned char tc_smem[];
  __nv_bfloat16* const sk = reinterpret_cast<__nv_bfloat16*>(tc_smem);  // [64][HD]
  __nv_bfloat16* const sv = sk + kTcBlock * HD;                      // [64][HD]
  __nv_bfloat16* const sq = sv + kTcBlock * HD;                 // [kTcStages][64][HD]
  __nv_bfloat16* const sdo = sq + kTcStages * kTcBlock * HD;    // [kTcStages][64][HD]
  float* const slse = reinterpret_cast<float*>(sdo + kTcStages * kTcBlock * HD);  // [st][64]
  float* const sdsum = slse + kTcStages * kTcBlock;                               // [st][64]

  const int kv_row = blockIdx.x / splits;  // b * K + kv head
  const int chunk = blockIdx.x % splits;   // this block's share of the GQA group
  const int k0 = blockIdx.y * kTcBlock;    // key tile 0 (every query tile under causal) first
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = lane & 3;
  const int key_a = k0 + warp * 16 + (lane >> 2);  // key of accumulator rows c0, c1 (+8: c2, c3)
  const __nv_bfloat16* kb = k + static_cast<size_t>(kv_row) * seq_k * HD;
  const __nv_bfloat16* vb = v + static_cast<size_t>(kv_row) * seq_k * HD;

  int q_begin, q_end;
  query_tile_range(k0, kTcBlock, kTcBlock, seq_q, seq_k, causal, window, q_begin, q_end);
  const int n_qt = q_end > q_begin ? (q_end - q_begin + kTcBlock - 1) / kTcBlock : 0;
  const int per = (group + splits - 1) / splits;  // query heads of a chunk
  const int h0 = chunk * per;
  const int n_it = max(0, min(group, h0 + per) - h0) * n_qt;  // (head, query tile) pairs

  // Q, dO, lse and D of pair `it` into ring stage `st`.
  auto issue = [&](int it, int st) {
    const size_t bh = static_cast<size_t>(kv_row) * group + h0 + it / n_qt;  // b * H + h
    const int q0 = q_begin + (it % n_qt) * kTcBlock;
    load_tile<HD>(sq + st * kTcBlock * HD, q + bh * seq_q * HD, q0, seq_q, tid);
    load_tile<HD>(sdo + st * kTcBlock * HD, dout + bh * seq_q * HD, q0, seq_q, tid);
    const int r = tid & (kTcBlock - 1);
    const bool valid = q0 + r < seq_q;
    const float* src = (tid < kTcBlock ? lse : dsum) + bh * seq_q + (valid ? q0 + r : 0);
    cp_async4(smem_u32((tid < kTcBlock ? slse : sdsum) + st * kTcBlock + r), src, valid);
  };

  load_tile<HD>(sk, kb, k0, seq_k, tid);
  load_tile<HD>(sv, vb, k0, seq_k, tid);
  if (n_it > 0) issue(0, 0);
  cp_async_commit();

  uint32_t kf[kKVRegs ? HD / 16 : 1][4], vf[kKVRegs ? HD / 16 : 1][4];
  float dk_acc[kD][4], dv_acc[kD][4];
#pragma unroll
  for (int j = 0; j < kD; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;
  }

  for (int it = 0; it < n_it; ++it) {
    const int st = it % kTcStages;
    if (it + 1 < n_it) {  // the next pair's copies go out before this pair's math
      issue(it + 1, (it + 1) % kTcStages);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // pair `it` (and at it == 0, K and V) has landed for every thread
    if constexpr (kKVRegs) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          load_a<HD>(kf[kk], sk, warp * 16, kk, lane);
          load_a<HD>(vf[kk], sv, warp * 16, kk, lane);
        }
      }
    }
    const int q0 = q_begin + (it % n_qt) * kTcBlock;
    const __nv_bfloat16* qs = sq + st * kTcBlock * HD;
    const __nv_bfloat16* dos = sdo + st * kTcBlock * HD;
    const float* ls = slse + st * kTcBlock;
    const float* ds = sdsum + st * kTcBlock;
    // rows past seq_q are zero-filled and contribute nothing; they are
    // masked all the same, so lse and D of 0 never meet a stray score
    const bool masked = q0 + kTcBlock > seq_q ||
                        tile_needs_mask(q0, kTcBlock, k0, kTcBlock, seq_q, seq_k, causal, window);

#pragma unroll
    for (int sub = 0; sub < kTcBlock / kSub; ++sub) {
      // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x kSub queries.
      float s[kNT][4], dp[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t ka[4], va[4];
        if constexpr (kKVRegs) {
#pragma unroll
          for (int e = 0; e < 4; ++e) ka[e] = kf[kk][e], va[e] = vf[kk][e];
        } else {
          load_a<HD>(ka, sk, warp * 16, kk, lane);
          load_a<HD>(va, sv, warp * 16, kk, lane);
        }
#pragma unroll
        for (int np = 0; np < kNT / 2; ++np) {
          uint32_t b[4];
          load_b<HD>(b, qs, sub * kSub + np * 16, kk, lane);
          mma_bf16(s[2 * np], ka, b[0], b[1]);
          mma_bf16(s[2 * np + 1], ka, b[2], b[3]);
          load_b<HD>(b, dos, sub * kSub + np * 16, kk, lane);
          mma_bf16(dp[2 * np], va, b[0], b[1]);
          mma_bf16(dp[2 * np + 1], va, b[2], b[3]);
        }
      }
      // P^T = exp2(S^T scale log2 e - lse log2 e), dS^T = P^T (dP^T - D).
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int qc = sub * kSub + j * 8 + 2 * t;  // query column of c0 (c1: + 1)
        const float2 l2 = *reinterpret_cast<const float2*>(ls + qc);
        const float2 d2 = *reinterpret_cast<const float2*>(ds + qc);
        const float nl[2] = {-l2.x * kLog2e, -l2.y * kLog2e};
        const float dd[2] = {d2.x, d2.y};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = ex2(fmaf(s[j][e], scale_log2, nl[e & 1]));
          if (masked) {
            const int qpos = q0 + qc + (e & 1), kpos = key_a + 8 * (e >> 1);
            if (!admitted(qpos, kpos, seq_q, seq_k, causal, window)) p = 0.f;
          }
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - dd[e & 1]);
        }
      }
      // dV += P^T dO, dK += dS^T Q over this strip's queries.
#pragma unroll
      for (int kk = 0; kk < kSub / 16; ++kk) {
        uint32_t pa[4], dsa[4];
        acc_to_a(s, kk, pa);
        acc_to_a(dp, kk, dsa);
#pragma unroll
        for (int dpi = 0; dpi < HD / 16; ++dpi) {
          uint32_t b[4];
          load_b_trans<HD>(b, dos, sub * kSub + kk * 16, dpi, lane);
          mma_bf16(dv_acc[2 * dpi], pa, b[0], b[1]);
          mma_bf16(dv_acc[2 * dpi + 1], pa, b[2], b[3]);
          load_b_trans<HD>(b, qs, sub * kSub + kk * 16, dpi, lane);
          mma_bf16(dk_acc[2 * dpi], dsa, b[0], b[1]);
          mma_bf16(dk_acc[2 * dpi + 1], dsa, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // Epilogue: each warp's rows of the K and V tiles (read by no other warp)
  // carry dK and dV out; a chunk of a split group writes f32 partial rows,
  // [2][splits][B * K][Sk][HD], which gqa_sum_kernel adds in order.
  cp_async_wait<0>();
  __syncthreads();  // no copy into K or V is in flight (n_it == 0)
  if (splits == 1) {
    const size_t out0 = static_cast<size_t>(kv_row) * seq_k * HD;
    store_strip<HD>(dk_acc, scale, sk, warp * 16, dk + out0, k0 + warp * 16, seq_k, lane);
    store_strip<HD>(dv_acc, 1.f, sv, warp * 16, dv + out0, k0 + warp * 16, seq_k, lane);
    return;
  }
  const size_t rows = static_cast<size_t>(gridDim.x / splits) * seq_k;  // B * K * Sk
  float* const pk = part + (static_cast<size_t>(chunk) * rows + static_cast<size_t>(kv_row) * seq_k) * HD;
  float* const pv = pk + static_cast<size_t>(splits) * rows * HD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kpos = key_a + 8 * r;
    if (kpos >= seq_k) continue;
#pragma unroll
    for (int j = 0; j < kD; ++j) {
      const size_t o = static_cast<size_t>(kpos) * HD + j * 8 + 2 * t;
      *reinterpret_cast<float2*>(pk + o) =
          make_float2(dk_acc[j][2 * r] * scale, dk_acc[j][2 * r + 1] * scale);
      *reinterpret_cast<float2*>(pv + o) = make_float2(dv_acc[j][2 * r], dv_acc[j][2 * r + 1]);
    }
  }
}

// out[i] = bf16(sum over c < splits of part[c * count + i]), in order: the
// chunks of a split GQA group.
__global__ void gqa_sum_kernel(const float* __restrict__ part, __nv_bfloat16* __restrict__ out,
                               int splits, long long count) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < count;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int c = 0; c < splits; ++c) s += part[c * count + i];
    out[i] = __float2bfloat16(s);
  }
}

template <int HD>
__global__ void __launch_bounds__(kTcThreads, 2)
attn_bwd_dq_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ dsum,
                      __nv_bfloat16* __restrict__ dq, int group, int seq_q, int seq_k,
                      int causal, int window, float scale, float scale_log2) {
  static_assert(HD % 16 == 0 && HD <= 128, "head dim: a multiple of k16 up to 128");
  constexpr int kD = HD / 8;                      // n8 tiles of a dQ strip
  constexpr int kSub = HD <= 64 ? kTcBlock : 16;  // keys of one S strip
  constexpr int kNT = kSub / 8;
  constexpr bool kDoRegs = HD <= 64;              // dO rows held as A fragments
  extern __shared__ __align__(128) unsigned char tc_smem[];
  __nv_bfloat16* const sq = reinterpret_cast<__nv_bfloat16*>(tc_smem);  // [64][HD]
  __nv_bfloat16* const sdo = sq + kTcBlock * HD;                     // [64][HD]
  __nv_bfloat16* const sk = sdo + kTcBlock * HD;                // [kTcStages][64][HD]
  __nv_bfloat16* const sv = sk + kTcStages * kTcBlock * HD;     // [kTcStages][64][HD]

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTcBlock;  // heaviest tiles first
  const int kv_row = bh / group;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = lane & 3;
  const int row_a = q0 + warp * 16 + (lane >> 2);  // query of accumulator rows c0, c1 (+8: c2, c3)
  const __nv_bfloat16* kb = k + static_cast<size_t>(kv_row) * seq_k * HD;
  const __nv_bfloat16* vb = v + static_cast<size_t>(kv_row) * seq_k * HD;

  int k_begin, k_end;
  key_tile_range(q0, kTcBlock, kTcBlock, seq_q, seq_k, causal, window, k_begin, k_end);
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kTcBlock - 1) / kTcBlock : 0;

  load_tile<HD>(sq, q + static_cast<size_t>(bh) * seq_q * HD, q0, seq_q, tid);
  load_tile<HD>(sdo, dout + static_cast<size_t>(bh) * seq_q * HD, q0, seq_q, tid);
  if (n_tiles > 0) {
    load_tile<HD>(sk, kb, k_begin, seq_k, tid);
    load_tile<HD>(sv, vb, k_begin, seq_k, tid);
  }
  cp_async_commit();

  float nl[2], dd[2];  // -lse log2 e and D of rows row_a and row_a + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row_a + 8 * r;
    const size_t i = static_cast<size_t>(bh) * seq_q + qi;
    nl[r] = qi < seq_q ? -lse[i] * kLog2e : 0.f;
    dd[r] = qi < seq_q ? dsum[i] : 0.f;
  }
  uint32_t qf[HD / 16][4], df[kDoRegs ? HD / 16 : 1][4];  // this warp's Q (and dO) rows
  float acc[kD][4];
#pragma unroll
  for (int j = 0; j < kD; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int kt = k_begin + it * kTcBlock;
    const int st = it % kTcStages;
    if (it + 1 < n_tiles) {
      const int next = (it + 1) % kTcStages;
      load_tile<HD>(sk + next * kTcBlock * HD, kb, kt + kTcBlock, seq_k, tid);
      load_tile<HD>(sv + next * kTcBlock * HD, vb, kt + kTcBlock, seq_k, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile `it` (and at it == 0, Q and dO) has landed for every thread
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        load_a<HD>(qf[kk], sq, warp * 16, kk, lane);
        if constexpr (kDoRegs) load_a<HD>(df[kk], sdo, warp * 16, kk, lane);
      }
    }
    const __nv_bfloat16* ks = sk + st * kTcBlock * HD;
    const __nv_bfloat16* vs = sv + st * kTcBlock * HD;
    const bool masked = tile_needs_mask(q0, kTcBlock, kt, kTcBlock, seq_q, seq_k, causal, window);

#pragma unroll
    for (int sub = 0; sub < kTcBlock / kSub; ++sub) {
      // S = Q K^T and dP = dO V^T: this warp's 16 rows x kSub keys.
      float s[kNT][4], dp[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t da[4];
        if constexpr (kDoRegs) {
#pragma unroll
          for (int e = 0; e < 4; ++e) da[e] = df[kk][e];
        } else {
          load_a<HD>(da, sdo, warp * 16, kk, lane);
        }
#pragma unroll
        for (int np = 0; np < kNT / 2; ++np) {
          uint32_t b[4];
          load_b<HD>(b, ks, sub * kSub + np * 16, kk, lane);
          mma_bf16(s[2 * np], qf[kk], b[0], b[1]);
          mma_bf16(s[2 * np + 1], qf[kk], b[2], b[3]);
          load_b<HD>(b, vs, sub * kSub + np * 16, kk, lane);
          mma_bf16(dp[2 * np], da, b[0], b[1]);
          mma_bf16(dp[2 * np + 1], da, b[2], b[3]);
        }
      }
      // dS = P (dP - D), P = exp2(S scale log2 e - lse log2 e) under the mask.
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = ex2(fmaf(s[j][e], scale_log2, nl[e >> 1]));
          if (masked) {
            const int qpos = row_a + 8 * (e >> 1);
            const int kpos = kt + sub * kSub + j * 8 + 2 * t + (e & 1);
            if (!admitted(qpos, kpos, seq_q, seq_k, causal, window)) p = 0.f;
          }
          dp[j][e] = p * (dp[j][e] - dd[e >> 1]);
        }
      }
      // dQ += dS K, dS straight from the accumulators as bf16 A fragments.
#pragma unroll
      for (int kk = 0; kk < kSub / 16; ++kk) {
        uint32_t a[4];
        acc_to_a(dp, kk, a);
#pragma unroll
        for (int dpi = 0; dpi < HD / 16; ++dpi) {
          uint32_t b[4];
          load_b_trans<HD>(b, ks, sub * kSub + kk * 16, dpi, lane);
          mma_bf16(acc[2 * dpi], a, b[0], b[1]);
          mma_bf16(acc[2 * dpi + 1], a, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  cp_async_wait<0>();
  __syncthreads();  // no copy into Q is in flight (n_tiles == 0)
  store_strip<HD>(acc, scale, sq, warp * 16, dq + static_cast<size_t>(bh) * seq_q * HD,
                  q0 + warp * 16, seq_q, lane);
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* dsum;
  void *dq, *dk, *dv;
  float* part;
  int b, h, kh, sq, sk, causal, window, splits;
  float scale;
};

template <typename Kernel>
int opt_in(Kernel kernel, int smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

template <int HD, typename T>
int launch_dot(const Args& a, cudaStream_t st) {
  constexpr int kRows = kThreads / (HD / (16 / static_cast<int>(sizeof(T))));
  const int rows = a.b * a.h * a.sq;
  attn_bwd_dot_kernel<HD, T><<<(rows + kRows - 1) / kRows, kThreads, 0, st>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.dsum, rows);
  return static_cast<int>(cudaGetLastError());
}

// f32: the SIMT kernels.
template <int HD>
int launch_simt(const Args& a, cudaStream_t st) {
  using T = float;
  int e = launch_dot<HD, T>(a, st);
  if (e) return e;
  const int group = a.h / a.kh;
  constexpr int smem = smem_floats<HD>() * static_cast<int>(sizeof(float));
  auto* dkdv = &attn_bwd_dkdv_kernel<HD, T>;
  auto* dqk = &attn_bwd_dq_kernel<HD, T>;
  if ((e = opt_in(dkdv, smem))) return e;
  if ((e = opt_in(dqk, smem))) return e;
  const int n_kt = (a.sk + kBlockK - 1) / kBlockK;
  const int n_qt = (a.sq + kBlockQ - 1) / kBlockQ;
  dkdv<<<dim3(n_kt, a.b * a.kh), kThreads, smem, st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.dsum, static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), group, a.sq, a.sk, a.causal, a.window, a.scale);
  if ((e = static_cast<int>(cudaGetLastError()))) return e;
  dqk<<<dim3(n_qt, a.b * a.h), kThreads, smem, st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.dsum, static_cast<T*>(a.dq), group, a.sq, a.sk,
      a.causal, a.window, a.scale);
  return static_cast<int>(cudaGetLastError());
}

// bf16: the tensor-core kernels.
template <int HD>
int launch_tc(const Args& a, cudaStream_t st) {
  using T = __nv_bfloat16;
  const int n_kt = (a.sk + kTcBlock - 1) / kTcBlock;
  const int n_qt = (a.sq + kTcBlock - 1) / kTcBlock;
  if (n_kt > 65535 || n_qt > 65535) return static_cast<int>(cudaErrorInvalidValue);
  int e = launch_dot<HD, T>(a, st);
  if (e) return e;
  constexpr int smem_dkdv = tc_dkdv_smem_bytes(HD);
  constexpr int smem_dq = tc_dq_smem_bytes(HD);
  auto* dkdv = &attn_bwd_dkdv_tc_kernel<HD>;
  auto* dqk = &attn_bwd_dq_tc_kernel<HD>;
  if ((e = opt_in(dkdv, smem_dkdv))) return e;
  if ((e = opt_in(dqk, smem_dq))) return e;
  dkdv<<<dim3(a.b * a.kh * a.splits, n_kt), kTcThreads, smem_dkdv, st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.dsum, static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.part, a.splits, a.h / a.kh, a.sq, a.sk, a.causal, a.window,
      a.scale, a.scale * kLog2e);
  if ((e = static_cast<int>(cudaGetLastError()))) return e;
  if (a.splits > 1) {
    const long long count = static_cast<long long>(a.b) * a.kh * a.sk * HD;
    const long long blocks = (count + 255) / 256;
    const int grid = static_cast<int>(blocks < 4096 ? blocks : 4096);
    gqa_sum_kernel<<<grid, 256, 0, st>>>(a.part, static_cast<T*>(a.dk), a.splits, count);
    gqa_sum_kernel<<<grid, 256, 0, st>>>(a.part + a.splits * count, static_cast<T*>(a.dv),
                                         a.splits, count);
    if ((e = static_cast<int>(cudaGetLastError()))) return e;
  }
  dqk<<<dim3(a.b * a.h, n_qt), kTcThreads, smem_dq, st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.dsum, static_cast<T*>(a.dq), a.h / a.kh, a.sq,
      a.sk, a.causal, a.window, a.scale, a.scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch(int is_bf16, const Args& a, cudaStream_t st) {
  return is_bf16 ? launch_tc<HD>(a, st) : launch_simt<HD>(a, st);
}

}  // namespace

extern "C" {

// Launches the kernels on `stream` and returns the CUDA error (0 =
// launched): the tensor-core kernels for bf16 (is_bf16), the SIMT kernels
// for f32.  lse [B, H, Sq] comes from flash_attention_fwd; dsum is f32
// scratch of the same shape.  `splits` (bf16 only; f32 takes 1) cuts each
// GQA group of H / K query heads into that many chunks of dK/dV blocks, whose
// f32 partial rows go to `part` [2][splits][B * K][Sk][HD] and are summed in
// order (flash_attention.py::bwd_gqa_splits picks it).  The caller allocates
// dq, dk, dv and part and validates shapes and alignment; bad arguments
// return cudaErrorInvalidValue without a launch.
int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                        const void* dout, const void* lse, void* dsum, void* dq, void* dk,
                        void* dv, void* part, int b, int h, int kh, int sq, int sk, int hd,
                        int causal, int window, int splits, int is_bf16, float scale,
                        void* stream) {
  if (b <= 0 || h <= 0 || kh <= 0 || h % kh != 0 || sq <= 0 || sk <= 0 || window < 0 ||
      b * h > 65535 || (sq + kBlockQ - 1) / kBlockQ > 2147483647 / 2 || splits < 1 ||
      splits > h / kh || (splits > 1 && (!is_bf16 || part == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q, k, v, o, dout, static_cast<const float*>(lse), static_cast<float*>(dsum),
               dq, dk, dv, static_cast<float*>(part), b, h, kh, sq, sk, causal, window, splits,
               scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch<16>(is_bf16, a, st);
    case 32: return launch<32>(is_bf16, a, st);
    case 64: return launch<64>(is_bf16, a, st);
    case 128: return launch<128>(is_bf16, a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
