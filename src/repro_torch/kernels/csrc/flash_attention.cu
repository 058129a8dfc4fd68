// Flash attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces repro/kernels/flash_attention.py::flash_attention_kernel, the
// Pallas TPU kernel: online-softmax attention with m, l and acc in f32, q
// scaled by 1/sqrt(hd), GQA (q head h reads kv head h / (H/K), no KV
// replication in memory), causal and sliding-window masks from query/key
// positions that both count from 0 (top-left alignment, also when Sq != Sk),
// the finite mask value -0.7 * FLT_MAX applied after scaling, and l clamped
// at 1e-30 before the division.  The output is cast back to q's dtype.
//
// Layout: q/o [B, H, Sq, HD] and k/v [B, K, Sk, HD], contiguous, 16-byte
// aligned.
//
// Two kernels, chosen by dtype (not a fallback: each dtype has exactly one):
//
// bf16: flash_fwd_tc_kernel, FA2-style on the tensor cores.  One block of 4
// warps per (b*H + h, 64-row query tile); each warp owns 16 query rows (one
// m16 tile).  Query tiles launch heaviest first (the last tiles under a
// causal mask), so the tail of the grid is short.  Q is copied once into
// shared memory by cp.async and held in registers as bf16 A fragments
// (ldmatrix) for the whole key loop.  K and V pass through a ring of 2
// stages of 64-key tiles in dynamic shared memory, filled by 16-byte
// cp.async.cg copies whose 16-byte chunk index is XOR-swizzled by the row,
// so that ldmatrix reads are free of bank conflicts; the next tile's copies
// are issued before the current tile is computed.  S = Q.K^T and O += P.V run
// on mma.sync m16n8k16 (bf16 in, f32 accumulate); K's B fragments come from
// ldmatrix, V's from ldmatrix.trans.  P goes from the S accumulators straight
// into bf16 A fragments: the accumulator layout of two adjacent n8 tiles is
// the A layout of one k16 slice.  The softmax works in base 2 (scores scaled
// by scale * log2(e), then ex2), the row max and sum are reduced over the 4
// lanes of a quad, and m, l and O stay in registers.  Only the tiles that
// need it are masked (the causal diagonal, the first tile a window reaches,
// the ragged last key tile); Sq and Sk need not be multiples of 64: copies
// past the edge are zero-filled and those keys masked, with no host padding.
// The one numerical departure from the TPU kernel: P is rounded to bf16
// before the P.V product (the TPU kernel keeps p in f32); Q.K^T is exact, as
// there (bf16 products in f32).
//
// f32: flash_fwd_kernel, the SIMT kernel of the first port slice, unchanged.
// It serves the f32 checks, which need f32 accuracy end to end.  One block of
// 4 warps per (b*H + h, 16-row query tile); each 32-key tile of K and V is
// staged in shared memory as f32; lane j scores key j, lane j owns output
// dims j, j+32, ...; dots are f32 FMAs on the CUDA cores.
//
// What bounds it on the H100.  At hymba-1.5b's prefill shape (B=4, H=25,
// K=5, S=1536, HD=64, window 1024) the admitted scores need ~27 GFLOP of
// bf16 products against ~47 MB of q, k, v and o: the tensor cores bound it
// (~0.027 ms).  mma.sync reaches only part of the tensor-core peak (wgmma is
// the full rate), and each score also costs an ex2 on the special function
// units, 16 a clock per SM, which takes about as long as its share of the
// products: those two limit this design.
#include <cfloat>
#include <cstdint>
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

// kLse: write each query row's log-sum-exp (training); serving's
// instantiation has no code for it.
template <int HD, typename T, bool kLse>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse, int group,
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
    if (kLse && lane == 0) {
      lse[static_cast<size_t>(bh) * seq_q + qi] = m[r] + logf(denom);
    }
  }
}

template <int HD, typename T>
void launch(const void* q, const void* k, const void* v, void* o, float* lse, int b, int h,
            int kh, int sq, int sk, int causal, int window, float scale,
            cudaStream_t stream) {
  const dim3 grid((sq + kBlockQ - 1) / kBlockQ, b * h);
  auto* kernel =
      lse != nullptr ? &flash_fwd_kernel<HD, T, true> : &flash_fwd_kernel<HD, T, false>;
  kernel<<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, h / kh, sq, sk, causal, window, scale);
}

template <typename T>
bool dispatch_hd(int hd, const void* q, const void* k, const void* v, void* o,
                 float* lse, int b, int h, int kh, int sq, int sk, int causal, int window,
                 float scale, cudaStream_t stream) {
  switch (hd) {
    case 16: launch<16, T>(q, k, v, o, lse, b, h, kh, sq, sk, causal, window, scale, stream); return true;
    case 32: launch<32, T>(q, k, v, o, lse, b, h, kh, sq, sk, causal, window, scale, stream); return true;
    case 64: launch<64, T>(q, k, v, o, lse, b, h, kh, sq, sk, causal, window, scale, stream); return true;
    case 128: launch<128, T>(q, k, v, o, lse, b, h, kh, sq, sk, causal, window, scale, stream); return true;
    default: return false;
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kTcWarps = 4;
constexpr int kTcThreads = kTcWarps * 32;
constexpr int kTcBlockM = kTcWarps * 16;  // query rows per block: one m16 tile a warp
constexpr int kTcBlockN = 64;             // keys per tile
constexpr int kTcStages = 2;              // ring of K/V tiles in shared memory
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Dynamic shared memory of one block: the Q tile and the K/V ring, bf16.
// Mirrored by repro_torch/kernels/flash_attention.py::tc_smem_bytes.
constexpr int tc_smem_bytes(int hd) {
  return (kTcBlockM + 2 * kTcStages * kTcBlockN) * hd * 2;
}

// Keys [begin, end) a query tile [q0, q0 + block_q) must visit: a causal tile
// stops after its last row, a window starts at the tile (of block_k keys)
// that its first row reaches.  Mirrored by
// repro_torch/kernels/flash_attention.py::key_tile_range, which the CPU tests
// hold against the mask; change the two together.
__device__ __forceinline__ void key_tile_range(int q0, int block_q, int block_k,
                                               int seq_q, int seq_k, int causal,
                                               int window, int& begin, int& end) {
  const int q_last = min(q0 + block_q, seq_q) - 1;
  end = causal ? min(seq_k, q_last + 1) : seq_k;
  begin = window > 0 ? (max(0, q0 - window + 1) / block_k) * block_k : 0;
}

// Whether the key tile [kt, kt + block_k) needs the mask for the query rows
// [q0, q0 + block_q) below seq_q: false only if the mask admits every pair in
// it.  Mirrored by repro_torch/kernels/flash_attention.py::tile_needs_mask.
__device__ __forceinline__ bool tile_needs_mask(int q0, int block_q, int kt, int block_k,
                                                int seq_q, int seq_k, int causal,
                                                int window) {
  const int q_last = min(q0 + block_q, seq_q) - 1;
  return kt + block_k > seq_k || (causal && kt + block_k - 1 > q0) ||
         (window > 0 && q_last - kt >= window);
}

// Element offset of 16-byte chunk c of `row` in a [rows][HD] bf16 tile.  The
// chunk index is XOR-swizzled by the row so that the 8 rows one ldmatrix
// matrix reads at one chunk column, and 8 consecutive 16-byte cp.async
// writes, fall in 8 different 16-byte bank groups.  A row narrower than 128
// bytes (HD 16, 32) shares a 128-byte line with the next rows, so there the
// swizzle takes the line's index instead of the row's.
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

// One key tile's online-softmax update of a warp's rows g (s[.][0..1]) and
// g + 8 (s[.][2..3]); s becomes P.  Scores of a masked tile come scaled to
// base 2 with the mask applied; an unmasked tile's come raw, and its scale
// is folded into the exponent (one FFMA) and into the row max.  m is in
// scaled base-2 units; l is this lane's part of the row sum.
template <bool kScaled, int kNTiles, int kDTiles>
__device__ __forceinline__ void online_softmax(float (&s)[kNTiles][4], float (&m)[2],
                                               float (&l)[2], float (&acc)[kDTiles][4],
                                               float scale_log2) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = s[0][2 * r];
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
    const float m_new = fmaxf(m[r], kScaled ? mx : mx * scale_log2);
    const float corr = ex2(m[r] - m_new);
    m[r] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e) {
        s[j][e] = kScaled ? ex2(s[j][e] - m_new) : ex2(fmaf(s[j][e], scale_log2, -m_new));
        sum += s[j][e];
      }
    }
    l[r] = l[r] * corr + sum;
#pragma unroll
    for (int j = 0; j < kDTiles; ++j) {
      acc[j][2 * r] *= corr;
      acc[j][2 * r + 1] *= corr;
    }
  }
}

// Copies rows [row0, row0 + 64) of a [seq][HD] bf16 matrix into a swizzled
// shared tile, rows at or past `limit` zero-filled.
template <int HD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* tile, const __nv_bfloat16* g,
                                          int row0, int limit, int tid) {
  constexpr int kChunks = HD / 8;
  static_assert(kTcBlockN == kTcBlockM, "one loader for Q, K and V tiles");
#pragma unroll
  for (int it = 0; it < kTcBlockN * kChunks / kTcThreads; ++it) {
    const int i = tid + it * kTcThreads;
    const int r = i / kChunks, c = i % kChunks;
    const bool valid = row0 + r < limit;
    const __nv_bfloat16* src = g + static_cast<size_t>(valid ? row0 + r : 0) * HD + c * 8;
    cp_async16(smem_u32(tile + swz<HD>(r, c)), src, valid);
  }
}

template <int HD, bool kLse>
__global__ void __launch_bounds__(kTcThreads, HD <= 64 ? 4 : 2)
flash_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                    float* __restrict__ lse, int group, int seq_q, int seq_k, int causal, int window,
                    float scale_log2) {
  static_assert(HD % 16 == 0 && HD <= 128, "head dim: a multiple of k16 up to 128");
  constexpr int kChunks = HD / 8;
  constexpr int kNTiles = kTcBlockN / 8;  // n8 tiles of scores a warp holds
  constexpr int kDTiles = HD / 8;         // n8 tiles of output a warp holds
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sk = sq + kTcBlockM * HD;            // [kTcStages][kTcBlockN][HD]
  __nv_bfloat16* sv = sk + kTcStages * kTcBlockN * HD;  // [kTcStages][kTcBlockN][HD]

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTcBlockM;  // heaviest tiles first
  const int kv_row = bh / group;  // b*K + h/group, since H = K*group
  const __nv_bfloat16* qb = q + static_cast<size_t>(bh) * seq_q * HD;
  const __nv_bfloat16* kb = k + static_cast<size_t>(kv_row) * seq_k * HD;
  const __nv_bfloat16* vb = v + static_cast<size_t>(kv_row) * seq_k * HD;
  __nv_bfloat16* ob = o + static_cast<size_t>(bh) * seq_q * HD;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group and column pair

  int k_begin, k_end;
  key_tile_range(q0, kTcBlockM, kTcBlockN, seq_q, seq_k, causal, window, k_begin, k_end);
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kTcBlockN - 1) / kTcBlockN : 0;

  load_tile<HD>(sq, qb, q0, seq_q, tid);
  if (n_tiles > 0) {
    load_tile<HD>(sk, kb, k_begin, seq_k, tid);
    load_tile<HD>(sv, vb, k_begin, seq_k, tid);
  }
  cp_async_commit();

  uint32_t qf[HD / 16][4];  // this warp's 16 query rows as A fragments
  float acc[kDTiles][4];
#pragma unroll
  for (int j = 0; j < kDTiles; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // rows g and g + 8, in scaled base-2 units
  float l[2] = {0.f, 0.f};          // this lane's part of the row sums
  const int row_a = q0 + warp * 16 + g;  // query position of fragment rows c0, c1

  for (int it = 0; it < n_tiles; ++it) {
    const int kt = k_begin + it * kTcBlockN;
    const int stage = it % kTcStages;
    if (it + 1 < n_tiles) {  // the next tile's copies go out before this tile's math
      const int next = (it + 1) % kTcStages;
      load_tile<HD>(sk + next * kTcBlockN * HD, kb, kt + kTcBlockN, seq_k, tid);
      load_tile<HD>(sv + next * kTcBlockN * HD, vb, kt + kTcBlockN, seq_k, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile `it` (and at it == 0, Q) has landed for every thread
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        ldmatrix_x4(qf[kk], smem_u32(sq + swz<HD>(warp * 16 + (lane & 15), 2 * kk + (lane >> 4))));
      }
    }
    const __nv_bfloat16* ks = sk + stage * kTcBlockN * HD;
    const __nv_bfloat16* vs = sv + stage * kTcBlockN * HD;

    // S = Q K^T: a 16 x 64 strip of scores per warp.
    float s[kNTiles][4];
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < kNTiles / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, smem_u32(ks + swz<HD>(np * 16 + (lane & 7) + ((lane >> 4) << 3),
                                             2 * kk + ((lane >> 3) & 1))));
        mma_bf16(s[2 * np], qf[kk], b[0], b[1]);
        mma_bf16(s[2 * np + 1], qf[kk], b[2], b[3]);
      }
    }

    // The mask, after the base-2 scale, only where the tile needs it.
    if (tile_needs_mask(q0, kTcBlockM, kt, kTcBlockN, seq_q, seq_k, causal, window)) {
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qpos = row_a + (e >> 1) * 8;
          const int kpos = kt + j * 8 + 2 * t + (e & 1);
          bool ok = kpos < seq_k;
          if (causal) ok = ok && kpos <= qpos;
          if (window > 0) ok = ok && qpos - kpos < window;
          s[j][e] = ok ? s[j][e] * scale_log2 : kNegInf;
        }
      }
      online_softmax<true>(s, m, l, acc, scale_log2);
    } else {
      online_softmax<false>(s, m, l, acc, scale_log2);
    }

    // O += P V, P straight from the score registers as bf16 A fragments.
#pragma unroll
    for (int kk = 0; kk < kTcBlockN / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, smem_u32(vs + swz<HD>(kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3),
                                                   2 * dp + (lane >> 4))));
        mma_bf16(acc[2 * dp], a, b[0], b[1]);
        mma_bf16(acc[2 * dp + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // Epilogue: O / l through this warp's rows of the Q tile, then 16-byte stores.
  cp_async_wait<0>();
  __syncthreads();  // no copy into the Q tile is still in flight (n_tiles == 0)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
    const float denom = fmaxf(l[r], 1e-30f);
    const int row = warp * 16 + g + 8 * r;
    if (kLse && t == 0 && q0 + row < seq_q) {
      // m and l are in base 2 of the scaled scores: lse = ln 2 * (m + log2 l)
      lse[static_cast<size_t>(bh) * seq_q + q0 + row] = kLn2 * (m[r] + __log2f(denom));
    }
#pragma unroll
    for (int j = 0; j < kDTiles; ++j) {
      *reinterpret_cast<uint32_t*>(sq + swz<HD>(row, j) + 2 * t) =
          pack_bf16(acc[j][2 * r] / denom, acc[j][2 * r + 1] / denom);
    }
  }
  __syncwarp();
#pragma unroll
  for (int it = 0; it < 16 * kChunks / 32; ++it) {
    const int i = lane + it * 32;
    const int r = i / kChunks, c = i % kChunks;
    const int qi = q0 + warp * 16 + r;
    if (qi < seq_q) {
      *reinterpret_cast<uint4*>(ob + static_cast<size_t>(qi) * HD + c * 8) =
          *reinterpret_cast<const uint4*>(sq + swz<HD>(warp * 16 + r, c));
    }
  }
}

template <int HD>
int launch_tc(const void* q, const void* k, const void* v, void* o, float* lse, int b, int h,
              int kh,
              int sq, int sk, int causal, int window, float scale, cudaStream_t stream) {
  const int n_qt = (sq + kTcBlockM - 1) / kTcBlockM;
  if (n_qt > 65535) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = tc_smem_bytes(HD);
  auto kernel =
      lse != nullptr ? flash_fwd_tc_kernel<HD, true> : flash_fwd_tc_kernel<HD, false>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3(b * h, n_qt), kTcThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, h / kh, sq, sk,
      causal, window, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_tc(int hd, const void* q, const void* k, const void* v, void* o, float* lse,
                int b, int h,
                int kh, int sq, int sk, int causal, int window, float scale,
                cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_tc<16>(q, k, v, o, lse, b, h, kh, sq, sk, causal, window, scale, stream);
    case 32: return launch_tc<32>(q, k, v, o, lse, b, h, kh, sq, sk, causal, window, scale, stream);
    case 64: return launch_tc<64>(q, k, v, o, lse, b, h, kh, sq, sk, causal, window, scale, stream);
    case 128: return launch_tc<128>(q, k, v, o, lse, b, h, kh, sq, sk, causal, window, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the CUDA error (0 = launched): the
// tensor-core kernel for bf16 (is_bf16), the SIMT kernel for f32.  `lse`
// (nullable, f32 [B, H, Sq]) receives each query row's log-sum-exp of the
// scaled scores, natural log, for the backward (flash_attention_bwd.cu);
// serving passes null and writes nothing more.  The caller
// allocates o and validates shapes and alignment; bad arguments that reach
// here return cudaErrorInvalidValue without a launch.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                        int b, int h, int kh, int sq, int sk, int hd,
                        int causal, int window, int is_bf16, float scale,
                        void* stream) {
  if (b <= 0 || h <= 0 || kh <= 0 || h % kh != 0 || sq <= 0 || sk <= 0 ||
      window < 0 || b * h > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* const l = static_cast<float*>(lse);
  if (is_bf16) return dispatch_tc(hd, q, k, v, o, l, b, h, kh, sq, sk, causal, window, scale, st);
  if (!dispatch_hd<float>(hd, q, k, v, o, l, b, h, kh, sq, sk, causal, window, scale, st)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
