// Flash attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces repro/kernels/flash_attention.py::flash_attention_kernel, the
// Pallas TPU kernel: online-softmax attention with m, l and acc in f32, q
// scaled by 1/sqrt(hd) in f32 before the dot, GQA (q head h reads kv head
// h / (H/K), no KV replication in memory), causal and sliding-window masks
// from query/key positions that both count from 0 (top-left alignment, also
// when Sq != Sk), the finite mask value -0.7 * FLT_MAX, and l clamped at
// 1e-30 before the division.  bf16 operands are widened to f32 for the
// arithmetic and the output is cast back to q's dtype.
//
// Layout: q/o [B, H, Sq, HD] and k/v [B, K, Sk, HD], contiguous.
//
// Design.  One block of 4 warps per (b*H + h, 16-row query tile).  The TPU
// kernel's sequential kv grid axis becomes a loop inside the block: each
// 32-key tile of K and V is staged in shared memory as f32 and read by all
// 16 query rows of the block.  Each warp owns 4 query rows; lane j scores
// key j of the tile for those rows (so the row max and row sum are warp
// shuffles), and lane j owns output dims j, j+32, ... of the accumulator.
// The loop stops at the last key a causal tile can see and starts at the
// first tile a sliding window reaches.  The ragged Sq/Sk edges are masked
// here (zero-filled loads, kpos < Sk), with no host-side padding.
//
// What bounds it on the H100.  At the serving prefill shape (B=4, H=14,
// K=2, S=512, HD=64, causal, bf16) the work is ~1.9 GFLOP and ~8.4 MB, so
// the card's bound is a few microseconds either way.  This kernel runs its
// dots as f32 FMAs on the CUDA cores out of shared memory, so it is bound
// by CUDA-core instruction throughput and shared-memory reads, far above
// that bound.  The tensor-core path (mma/wgmma on bf16 tiles, TMA staging)
// is later work; this version is the simple one that is right.
#include <cfloat>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kBlockQ = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kBlockK = 32;                     // keys per tile: one per lane
constexpr float kNegInf = -0.7f * FLT_MAX;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

template <int HD, typename T>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int group,
                 int seq_q, int seq_k, int causal, int window, float scale) {
  constexpr int kDimsPerLane = (HD + 31) / 32;
  __shared__ float qs[kBlockQ][HD];
  __shared__ float ks[kBlockK][HD + 1];  // +1: lane j reads row j, conflict-free
  __shared__ float vs[kBlockK][HD];

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlockQ;
  const int kv_row = bh / group;  // b*K + h/group, since H = K*group
  const T* qb = q + static_cast<size_t>(bh) * seq_q * HD;
  const T* kb = k + static_cast<size_t>(kv_row) * seq_k * HD;
  const T* vb = v + static_cast<size_t>(kv_row) * seq_k * HD;
  T* ob = o + static_cast<size_t>(bh) * seq_q * HD;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int row0 = (tid >> 5) * kRowsPerWarp;  // this warp's first row in the tile

  for (int i = tid; i < kBlockQ * HD; i += kWarps * 32) {
    const int r = i / HD, d = i % HD;
    const int qi = q0 + r;
    qs[r][d] = qi < seq_q ? to_f32(qb[static_cast<size_t>(qi) * HD + d]) * scale : 0.f;
  }

  // Keys this query tile can see: causal stops after the tile's last row,
  // a window starts at the first tile that reaches the tile's first row.
  const int q_last = min(q0 + kBlockQ, seq_q) - 1;
  const int k_end = causal ? min(seq_k, q_last + 1) : seq_k;
  const int k_begin = window > 0 ? (max(0, q0 - window + 1) / kBlockK) * kBlockK : 0;

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kDimsPerLane];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) acc[r][i] = 0.f;
  }

  for (int kt = k_begin; kt < k_end; kt += kBlockK) {
    __syncthreads();  // the previous tile is consumed (and qs is written)
    for (int i = tid; i < kBlockK * HD; i += kWarps * 32) {
      const int j = i / HD, d = i % HD;
      const int kj = kt + j;
      const bool in = kj < seq_k;
      ks[j][d] = in ? to_f32(kb[static_cast<size_t>(kj) * HD + d]) : 0.f;
      vs[j][d] = in ? to_f32(vb[static_cast<size_t>(kj) * HD + d]) : 0.f;
    }
    __syncthreads();

    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float kd = ks[lane][d];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) s[r] = fmaf(qs[row0 + r][d], kd, s[r]);
    }

    const int kpos = kt + lane;
    float p[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int qpos = q0 + row0 + r;
      bool ok = kpos < seq_k;
      if (causal) ok = ok && kpos <= qpos;
      if (window > 0) ok = ok && qpos - kpos < window;
      const float sv = ok ? s[r] : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(sv));
      p[r] = expf(sv - m_new);
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + warp_sum(p[r]);
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < kDimsPerLane; ++i) acc[r][i] *= corr;
    }

#pragma unroll 4
    for (int j = 0; j < kBlockK; ++j) {
      float vj[kDimsPerLane];
#pragma unroll
      for (int i = 0; i < kDimsPerLane; ++i) {
        const int d = lane + 32 * i;
        vj[i] = d < HD ? vs[j][d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float pj = __shfl_sync(kFull, p[r], j);
#pragma unroll
        for (int i = 0; i < kDimsPerLane; ++i) acc[r][i] = fmaf(pj, vj[i], acc[r][i]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qi = q0 + row0 + r;
    if (qi >= seq_q) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) {
      const int d = lane + 32 * i;
      if (d < HD) ob[static_cast<size_t>(qi) * HD + d] = from_f32<T>(acc[r][i] / denom);
    }
  }
}

template <int HD, typename T>
void launch(const void* q, const void* k, const void* v, void* o, int b, int h,
            int kh, int sq, int sk, int causal, int window, float scale,
            cudaStream_t stream) {
  const dim3 grid((sq + kBlockQ - 1) / kBlockQ, b * h);
  flash_fwd_kernel<HD, T><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), h / kh, sq, sk, causal, window, scale);
}

template <typename T>
bool dispatch_hd(int hd, const void* q, const void* k, const void* v, void* o,
                 int b, int h, int kh, int sq, int sk, int causal, int window,
                 float scale, cudaStream_t stream) {
  switch (hd) {
    case 16: launch<16, T>(q, k, v, o, b, h, kh, sq, sk, causal, window, scale, stream); return true;
    case 32: launch<32, T>(q, k, v, o, b, h, kh, sq, sk, causal, window, scale, stream); return true;
    case 64: launch<64, T>(q, k, v, o, b, h, kh, sq, sk, causal, window, scale, stream); return true;
    case 128: launch<128, T>(q, k, v, o, b, h, kh, sq, sk, causal, window, scale, stream); return true;
    default: return false;
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 = launched).  The
// caller allocates o and validates shapes; bad arguments that reach here
// return cudaErrorInvalidValue without a launch.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int b, int h, int kh, int sq, int sk, int hd,
                        int causal, int window, int is_bf16, float scale,
                        void* stream) {
  if (b <= 0 || h <= 0 || kh <= 0 || h % kh != 0 || sq <= 0 || sk <= 0 ||
      window < 0 || b * h > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool ok = is_bf16
      ? dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, b, h, kh, sq, sk, causal, window, scale, st)
      : dispatch_hd<float>(hd, q, k, v, o, b, h, kh, sq, sk, causal, window, scale, st);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
