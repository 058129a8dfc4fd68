// Weight and bias gradients of a 3D surrogate's stem convolution for Hopper
// (sm_90a), plain C interface for ctypes.
//
// It replaces no Pallas kernel: the JAX package leaves its convolutions to
// XLA (repro/models/cnn.py).  It was added because cuDNN's float32 weight
// gradient of this one convolution (wgrad2d_grouped_direct_kernel) took 148
// ms of a ~207 ms CosmoFlow training step on an H100: 0.4% of its bound.
//
// The convolution is models/cnn.py's stride-2, 3x3x3 "SAME" convolution of
// an input of 1, 4 or 8 channels into a multiple of 4 channels: x [N, D, H,
// W, C] channels-last, padded before each axis by pd/ph/pw (0 or 1; the pad
// after is whatever the output size leaves), and the output gradient dy [N,
// Do, Ho, Wo, Cout] channels-last.  A tile's x planes of C channels sit in
// shared memory (kSlots * C * kPlane floats: 138 KiB with dy's stages at
// C = 8, 245 KiB at 16, past the 227 KiB a block may have), which caps C at
// 8.  With P = N * Do * Ho * Wo positions it computes
//   dw[co, ci, kd, kh, kw] = sum_p dy[p, co] * x[n, 2od+kd-pd, 2oh+kh-ph, 2ow+kw-pw, ci]
//   db[co]                 = sum_p dy[p, co]
// (x is 0 outside its extent): a skinny product dw [Cout x 27C] = dy^T [Cout
// x P] . im2col(x) [P x 27C], every product and sum in float32 FFMA (no TF32,
// no tensor cores: a lower precision than the model's float32 would be
// another result).
//
// What bounds it on the H100.  At CosmoFlow's stem (B 24 of 128^3 x 4 ->
// 32 channels at 64^3): M = 32, N = 108, K = P = 6.29 M, 2 * 32 * 108 * P =
// 43.5 GFLOP, 0.65 ms at 67 TFLOP/s of float32; x (805 MB) and dy (805 MB)
// read once are 0.48 ms at 3.35 TB/s.  So the bound is 0.65 ms of FFMA, and
// the design keeps the FMA units fed from shared memory and registers.
//
// Design, two passes.
//   Pass 1 (stem_wgrad_kernel): a block of 128 threads owns a tile of kTh
// output rows by kWt output columns of one sample and up to 32 output
// channels, and walks every output plane od.  For each od it needs x planes
// 2od .. 2od+2 (plane 2od is the previous od's 2od+2) and the tile's dy; the
// loads of od+1 (two new x planes, one dy tile) go out with cp.async while
// od is computed: a ring of kSlots x planes and two dy stages in shared
// memory.  x is transposed on the way in, to one plane per channel with the
// w axis contiguous, so a thread reads the 9 x values of one (kd, kh) row of
// 4 neighbouring outputs with two 16-byte loads and one 4-byte load.  A
// thread owns 4 output channels x one input channel x the 27 taps: 108
// accumulators in registers.  For a run of 4 outputs along w it loads their
// dy once (4 x 16 bytes) and each (kd, kh) row of x once (9 floats) and
// does 48 FMAs per row, 432 per run against 31 shared loads.  The channel
// groups and input channels of a warp read broadcast addresses (the
// channel planes sit 8 banks apart), so the loads do not conflict.
// Threads with the same (channel group, input channel) split the tile's
// runs ("streams"); at the end the block adds its streams in a fixed order
// and writes one partial row of Cout * 27C + Cout sums.  The bias gradient
// is summed from each dy stage in shared memory.
//   Pass 2 (stem_wgrad_sum_kernel): sums the partial rows in a fixed order
// (8 warps over fixed ranges of rows, then in warp order), no atomics: two
// runs give the same bits.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTh = 2;                    // output rows of a tile
constexpr int kWt = 64;                   // output columns of a tile
constexpr int kRun = 4;                   // outputs along w a thread takes at once
constexpr int kRuns = kTh * kWt / kRun;   // runs of a tile, split over streams
constexpr int kCoSlice = 32;              // output channels of a block
constexpr int kRows = 2 * kTh + 1;        // x rows of a tile
constexpr int kXCols = 2 * kWt + 1;       // x columns of a tile
constexpr int kRowLen = 2 * kWt + 4;      // a row in shared memory (16-byte multiple)
constexpr int kPlane = 680;               // one channel's rows: >= kRows * kRowLen, 8 banks mod 32
constexpr int kSlots = 5;                 // x planes in flight: 3 read, 2 loading
constexpr int kDyStage = kTh * kWt * kCoSlice;
constexpr int kTaps = 27;
constexpr int kRedStride = 4 * kTaps + 1;  // a thread's sums in the final reduction
constexpr int kSumWarps = 8;
static_assert(kPlane >= kRows * kRowLen && kPlane % 32 == 8 && kPlane % 4 == 0, "plane");

struct Dims {
  int d, h, w, cout;         // x's extent and the output channels
  int od, oh, ow;            // dy's extent
  int pd, ph, pw;            // pads before each axis
  int gco;                   // channel groups of 4 a block's threads cover (power of 2)
  int n_oh, n_ow;            // tiles along oh and ow
  int entries;               // a partial row: cout * 27C + cout
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int kN>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kN));
}

// x planes q0 .. q0+nq-1 (padded d coordinates) of the tile into their ring
// slots, one plane per channel, zeros outside x.  A thread takes the same
// (column, channel) elements of every row.
template <int C>
__device__ __forceinline__ void stage_x(float* sx, const float* __restrict__ x, const Dims& dm,
                                        int n, int oh0, int ow0, int q0, int nq) {
  constexpr int kElems = kXCols * C;
#pragma unroll
  for (int k = 0; k < (kElems + kThreads - 1) / kThreads; ++k) {
    const int e = threadIdx.x + k * kThreads;
    if (e < kElems) {
      const int col = e / C, ci = e % C;
      const int w = 2 * ow0 + col - dm.pw;
      const bool w_ok = static_cast<unsigned>(w) < static_cast<unsigned>(dm.w);
      float* dst0 = sx + ci * kPlane + col;
      for (int j = 0; j < nq; ++j) {
        const int q = q0 + j;
        const int d = q - dm.pd;
        const bool d_ok = w_ok && static_cast<unsigned>(d) < static_cast<unsigned>(dm.d);
        float* dst = dst0 + (q % kSlots) * (C * kPlane);
        const long long plane = (static_cast<long long>(n) * dm.d + d) * dm.h;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int h = 2 * oh0 + r - dm.ph;
          const bool ok = d_ok && static_cast<unsigned>(h) < static_cast<unsigned>(dm.h);
          const float* src = ok ? x + ((plane + h) * dm.w + w) * C + ci : x;
          cp_async4(dst + r * kRowLen, src, ok);
        }
      }
    }
  }
}

// The tile's dy of plane od into one stage [kTh][kWt][kCoSlice] with 16-byte
// copies (cout % 4 == 0, dy 16-byte aligned), zeros outside dy and past the
// last channel.
__device__ __forceinline__ void stage_dy(float* sdy, const float* __restrict__ dy, const Dims& dm,
                                         int n, int od, int oh0, int ow0, int co0) {
  const long long plane = (static_cast<long long>(n) * dm.od + od) * dm.oh;
  const int c4 = (threadIdx.x & 7) * 4;
  const bool c_ok = co0 + c4 < dm.cout;
#pragma unroll
  for (int k = 0; k < kDyStage / 4 / kThreads; ++k) {
    const int pos = (threadIdx.x >> 3) + k * (kThreads / 8);
    const int oh = oh0 + pos / kWt, ow = ow0 + pos % kWt;
    const bool ok = c_ok && oh < dm.oh && ow < dm.ow;
    const float* src = ok ? dy + ((plane + oh) * dm.ow + ow) * dm.cout + co0 + c4 : dy;
    cp_async16(sdy + pos * kCoSlice + c4, src, ok);
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads, 2)
stem_wgrad_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                  float* __restrict__ partial, Dims dm) {
  extern __shared__ __align__(16) float smem[];
  float* const sx = smem;                              // [kSlots][C][kPlane]
  float* const sdy = smem + kSlots * C * kPlane;       // [2][kDyStage]
  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  const int ow0 = (tile % dm.n_ow) * kWt;
  const int oh0 = (tile / dm.n_ow % dm.n_oh) * kTh;
  const int n = tile / dm.n_ow / dm.n_oh;
  const int co0 = blockIdx.y * kCoSlice;

  // a thread's (channel group, input channel) pair and its stream of runs
  const int pairs = dm.gco * C;
  const int pair = tid & (pairs - 1);
  const int stream = tid / pairs;
  const int streams = kThreads / pairs;
  const int ci = pair / dm.gco, cg = pair % dm.gco;

  float acc[4][kTaps];
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int t = 0; t < kTaps; ++t) acc[c][t] = 0.f;
  float dbacc[4] = {0.f, 0.f, 0.f, 0.f};

  stage_x<C>(sx, x, dm, n, oh0, ow0, 0, 3);
  stage_dy(sdy, dy, dm, n, 0, oh0, ow0, co0);
  cp_async_commit();
  for (int od = 0; od < dm.od; ++od) {
    if (od + 1 < dm.od) {
      stage_x<C>(sx, x, dm, n, oh0, ow0, 2 * od + 3, 2);
      stage_dy(sdy + ((od + 1) & 1) * kDyStage, dy, dm, n, od + 1, oh0, ow0, co0);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const float* const sd = sdy + (od & 1) * kDyStage;
    // the bias gradient: a thread's fixed group of 4 channels (tid % 8)
#pragma unroll
    for (int k = 0; k < kDyStage / 4 / kThreads; ++k) {
      const float4 v = reinterpret_cast<const float4*>(sd)[tid + k * kThreads];
      dbacc[0] += v.x;
      dbacc[1] += v.y;
      dbacc[2] += v.z;
      dbacc[3] += v.w;
    }
    const float* xs[3];
#pragma unroll
    for (int kd = 0; kd < 3; ++kd) {
      xs[kd] = sx + ((2 * od + kd) % kSlots) * (C * kPlane) + ci * kPlane;
    }

    for (int run = stream; run < kRuns; run += streams) {
      const int rh = run / (kWt / kRun), rw = (run % (kWt / kRun)) * kRun;
      if (oh0 + rh >= dm.oh || ow0 + rw >= dm.ow) continue;
      float g[kRun][4];
#pragma unroll
      for (int r = 0; r < kRun; ++r) {
        const float4 v =
            *reinterpret_cast<const float4*>(sd + (rh * kWt + rw + r) * kCoSlice + 4 * cg);
        g[r][0] = v.x;
        g[r][1] = v.y;
        g[r][2] = v.z;
        g[r][3] = v.w;
      }
#pragma unroll
      for (int kd = 0; kd < 3; ++kd) {
#pragma unroll
        for (int kh = 0; kh < 3; ++kh) {
          const float* row = xs[kd] + (2 * rh + kh) * kRowLen + 2 * rw;
          const float4 a = *reinterpret_cast<const float4*>(row);
          const float4 b = *reinterpret_cast<const float4*>(row + 4);
          const float xv[2 * kRun + 1] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, row[8]};
#pragma unroll
          for (int r = 0; r < kRun; ++r)
#pragma unroll
            for (int kw = 0; kw < 3; ++kw)
#pragma unroll
              for (int c = 0; c < 4; ++c)
                acc[c][kd * 9 + kh * 3 + kw] =
                    fmaf(g[r][c], xv[2 * r + kw], acc[c][kd * 9 + kh * 3 + kw]);
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  __syncthreads();

  // the block's streams, added in stream order, and its bias sums
  float* const red = smem;                                  // [kThreads][kRedStride]
  float* const red_db = smem + kThreads * kRedStride;       // [kThreads][4]
#pragma unroll
  for (int c = 0; c < 4; ++c) {
#pragma unroll
    for (int t = 0; t < kTaps; ++t) red[tid * kRedStride + c * kTaps + t] = acc[c][t];
    red_db[tid * 4 + c] = dbacc[c];
  }
  __syncthreads();
  const int cs = min(kCoSlice, dm.cout - co0);
  const int row_w = C * kTaps;
  float* const out = partial + static_cast<long long>(tile) * dm.entries;
  for (int e = tid; e < cs * row_w; e += kThreads) {
    const int col = e / row_w, rem = e % row_w;
    const int p = (rem / kTaps) * dm.gco + col / 4;
    const int j = (col % 4) * kTaps + rem % kTaps;
    float s = 0.f;
    for (int st = 0; st < streams; ++st) s += red[(st * pairs + p) * kRedStride + j];
    out[(co0 + col) * row_w + rem] = s;
  }
  for (int col = tid; col < cs; col += kThreads) {
    float s = 0.f;
    for (int t = col / 4; t < kThreads; t += kCoSlice / 4) s += red_db[t * 4 + col % 4];
    out[dm.cout * row_w + co0 + col] = s;
  }
}

// dw (the first `nw` entries of a row) and db (the rest) as the sums of
// `rows` partial rows: a block per 32 entries, warp w over its fixed range of
// rows, then the warps in order.
__global__ void __launch_bounds__(kSumWarps * 32)
stem_wgrad_sum_kernel(const float* __restrict__ partial, float* __restrict__ dw,
                      float* __restrict__ db, int rows, int entries, int nw) {
  __shared__ float part[kSumWarps][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int e = blockIdx.x * 32 + lane;
  const int per = (rows + kSumWarps - 1) / kSumWarps;
  float s = 0.f;
  if (e < entries) {
    const int end = min(rows, (warp + 1) * per);
    for (int r = warp * per; r < end; ++r) s += partial[static_cast<long long>(r) * entries + e];
  }
  part[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && e < entries) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kSumWarps; ++w) t += part[w][lane];
    if (e < nw) {
      dw[e] = t;
    } else {
      db[e - nw] = t;
    }
  }
}

template <int C>
int launch(const float* x, const float* dy, float* partial, float* dw, float* db, const Dims& dm,
           int tiles, int slices, cudaStream_t st) {
  const int stage = (kSlots * C * kPlane + 2 * kDyStage) * static_cast<int>(sizeof(float));
  const int reduce = kThreads * (kRedStride + 4) * static_cast<int>(sizeof(float));
  const int smem = stage > reduce ? stage : reduce;
  auto* kernel = &stem_wgrad_kernel<C>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(tiles, slices), kThreads, smem, st>>>(x, dy, partial, dm);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  stem_wgrad_sum_kernel<<<(dm.entries + 31) / 32, kSumWarps * 32, 0, st>>>(
      partial, dw, db, tiles, dm.entries, dm.entries - dm.cout);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches both passes on `stream` and returns the CUDA error (0 =
// launched).  x [n, d, h, w, cin] and dy [n, od, oh, ow, cout] are
// contiguous float32 (channels-last), pd/ph/pw the pads before each axis (0
// or 1).  `tiles` must be n * ceil(oh / 2) * ceil(ow / 64) (conv_wgrad.py::
// launch_plan): the caller allocates partial [tiles, cout * 27 * cin + cout]
// float32, dw [cout, cin, 3, 3, 3] and db [cout].  cin must be 1, 4 or 8,
// cout a multiple of 4 and dy 16-byte aligned.  Anything else returns
// cudaErrorInvalidValue without a launch.
int conv3d_stem_wgrad(const void* x, const void* dy, void* partial, void* dw, void* db, int n,
                      int d, int h, int w, int cin, int cout, int od, int oh, int ow, int pd,
                      int ph, int pw, int tiles, void* stream) {
  const int n_oh = (oh + kTh - 1) / kTh, n_ow = (ow + kWt - 1) / kWt;
  if (n <= 0 || d <= 0 || h <= 0 || w <= 0 || cout <= 0 || od <= 0 || oh <= 0 || ow <= 0 ||
      (cin != 1 && cin != 4 && cin != 8) || cout % 4 != 0 ||
      reinterpret_cast<uintptr_t>(dy) % 16 != 0 || pd < 0 || pd > 1 || ph < 0 || ph > 1 ||
      pw < 0 || pw > 1 || static_cast<long long>(n) * n_oh * n_ow != tiles ||
      static_cast<long long>(cout) * (kTaps * cin + 1) >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int slice_co = cout < kCoSlice ? cout : kCoSlice;
  int gco = 1;
  while (gco * 4 < slice_co) gco *= 2;
  const Dims dm{d, h, w, cout, od, oh, ow, pd, ph, pw, gco, n_oh, n_ow,
                cout * (kTaps * cin + 1)};
  const int slices = (cout + kCoSlice - 1) / kCoSlice;
  const auto* xf = static_cast<const float*>(x);
  const auto* dyf = static_cast<const float*>(dy);
  auto* pf = static_cast<float*>(partial);
  auto* dwf = static_cast<float*>(dw);
  auto* dbf = static_cast<float*>(db);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (cin) {
    case 1: return launch<1>(xf, dyf, pf, dwf, dbf, dm, tiles, slices, st);
    case 4: return launch<4>(xf, dyf, pf, dwf, dbf, dm, tiles, slices, st);
    default: return launch<8>(xf, dyf, pf, dwf, dbf, dm, tiles, slices, st);
  }
}

const char* conv3d_stem_wgrad_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
