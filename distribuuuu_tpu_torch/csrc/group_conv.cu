// Grouped 3x3 "same" convolution for Hopper (sm_90a).
//
// Replaces the Pallas kernel distribuuuu_tpu/ops/group_conv.py:170
// (_conv_core's pl.pallas_call over _kernel_s1 / _kernel_s2, reached
// through group_conv3x3). For x [B, H, W, C] (NHWC, C = G * cg) and the
// weight in the port's layout [C_out, cg, 3, 3] stored channels last
// (memory order [C_out, 3, 3, cg], C_out = G * fg) it computes
//
//     out[b, i, j, g*fg + n] = sum_{dy, dx, c} x[b, i*s + dy - 1, j*s + dx - 1, g*cg + c]
//                                             * w[g*fg + n, dy, dx, c]
//
// with zero padding of one pixel, stride s of 1 or 2, an fp32 accumulator
// and the output written NHWC [B, Ho, Wo, C_out] in x's dtype.
//
// The design is an implicit GEMM per group: M = B*Ho*Wo output pixels,
// N = fg output channels, K = 9*cg taken tap by tap, cg input channels a
// tap. The grid is (M tiles, G x N tiles). A block stages its A tile for
// one (tap, K chunk) straight from the NHWC input into shared memory: the
// padding is a predicate that loads zero (no padded copy, where the TPU
// kernel padded with jnp.pad), and the stride only enters the index
// arithmetic. B rows are contiguous in the weight's memory order, so the
// weight is read as it is stored. The TPU kernel's static loop over all G
// groups and its VMEM batch tile (_pick_bb) were Mosaic workarounds and
// are not carried over: here a group is a grid coordinate.
//
//  * bf16: a 128 x 64 output tile per 256-thread block, eight warps of
//    32 x 32, mma.sync.m16n8k16 into fp32 registers (tensor cores), the
//    tile stepped through shared memory 32 deep;
//  * f32: the same tile on the CUDA cores (fp32 FMA, 8 x 4 outputs a
//    thread), 16 deep, so f32 stays f32 (no TF32 rounding);
//  * ragged K chunks (cg = 232 of regnety_320, the 11 or 4 channels of
//    the test shapes), ragged M and ragged N (fg = 112 in two tiles of 64)
//    are masked with zero on load and skipped on store.
//
// What bounds it on the H100: at regnety_160's stage 3 ([B, 14, 14, 1232],
// G = 11, cg = fg = 112) one site does 2*B*196*9*112*1232 operations over
// about 2*B*196*1232*2 bytes, some 500 operations a byte, above the ~295
// the card needs before its bf16 tensor cores are the limit: the site is
// bound by operations (3.9 us at batch 8, 31.5 us at 64, 98 us at 200).
// This first kernel loads each tile synchronously with no overlap of copy
// and compute; a later PR would move it to wgmma with TMA loads into a
// pipelined shared-memory ring and larger M tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 64;
constexpr int THREADS = 256;

enum DType { DT_F32 = 0, DT_BF16 = 1 };

struct Geom {
  int B, H, W, C;    // input, NHWC; C = G * cg
  int Ho, Wo, Cout;  // output, NHWC; Cout = G * fg
  int cg, fg, stride, M;
};

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// One output pair (row, col) and (row, col + 1) of group `grp`.
template <typename T>
__device__ __forceinline__ void store_pair(T* out, const Geom& g, int grp,
                                           int row, int col, float v0,
                                           float v1) {
  if (row >= g.M) return;
  T* dst = out + (size_t)row * g.Cout + (size_t)grp * g.fg;
  if (col < g.fg) store_out(dst + col, v0);
  if (col + 1 < g.fg) store_out(dst + col + 1, v1);
}

// Where the A row `m` (an output pixel) reads its tap (0, 0): the image
// row base b*H and the input coordinates of the top-left tap.
struct RowGeom {
  int bh, h0, w0;
  bool ok;
};

__device__ __forceinline__ RowGeom row_geom(const Geom& g, int m) {
  RowGeom r{0, 0, 0, m < g.M};
  if (r.ok) {
    const int hw = g.Ho * g.Wo;
    const int b = m / hw, rem = m % hw;
    r.bh = b * g.H;
    r.h0 = (rem / g.Wo) * g.stride - 1;
    r.w0 = (rem % g.Wo) * g.stride - 1;
  }
  return r;
}

// Element offset of the input pixel tap (dy, dx) of row r, or -1 when the
// tap falls in the zero padding (or the row is past M).
__device__ __forceinline__ long long tap_offset(const Geom& g,
                                                const RowGeom& r, int dy,
                                                int dx) {
  const int hi = r.h0 + dy, wi = r.w0 + dx;
  if (!r.ok || hi < 0 || hi >= g.H || wi < 0 || wi >= g.W) return -1;
  return ((long long)(r.bh + hi) * g.W + wi) * g.C;
}

// ---------------------------------------------------------------- bf16 path

constexpr int BK16 = 32;
constexpr int PAD16 = 8;  // row stride 40 bf16 = 80 B: fragment loads hit 32 banks

__device__ __forceinline__ void mma_bf16_16816(float* d, const uint32_t* a,
                                               const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Eight bf16 values from `src` into `dst` (16-byte aligned), element j kept
// only where `valid` > j; one 16-byte load when all eight are valid and
// the addresses allow it.
__device__ __forceinline__ void load8(__nv_bfloat16* dst,
                                      const __nv_bfloat16* src, int valid,
                                      int vec) {
  if (vec && valid >= 8) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
  } else {
    const __nv_bfloat16 zero = __float2bfloat16(0.0f);
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[j] = j < valid ? src[j] : zero;
  }
}

__global__ void __launch_bounds__(THREADS)
    gconv_bf16(const __nv_bfloat16* __restrict__ x,
               const __nv_bfloat16* __restrict__ w,
               __nv_bfloat16* __restrict__ out, Geom g, int vec) {
  // A tile row-major [m][k]; B tile [n][k] (the weight's own order), so the
  // two k-adjacent bf16 values of a fragment register are adjacent.
  __shared__ __align__(16) __nv_bfloat16 As[BM][BK16 + PAD16];
  __shared__ __align__(16) __nv_bfloat16 Bs[BN][BK16 + PAD16];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;  // 4 x 2 warps of 32 x 32
  const int gq = lane >> 2, tq = lane & 3;  // PTX fragment group / thread-in-group
  const int n_tiles = (g.fg + BN - 1) / BN;
  const int grp = blockIdx.y / n_tiles, n0 = (blockIdx.y % n_tiles) * BN;
  const int m0 = blockIdx.x * BM;

  // loaders: A is BM x BK16 in 512 chunks of 8, two a thread at rows
  // tid/4 and tid/4 + 64, column (tid%4)*8; B is BN x BK16 in 256 chunks,
  // one a thread at row tid/4, the same column
  const int lc = (tid & 3) * 8;
  const int lr = tid >> 2;
  const RowGeom ra0 = row_geom(g, m0 + lr), ra1 = row_geom(g, m0 + lr + 64);
  const bool b_ok = n0 + lr < g.fg;
  const __nv_bfloat16* wrow =
      w + (size_t)(grp * g.fg + (b_ok ? n0 + lr : 0)) * 9 * g.cg;
  const __nv_bfloat16* xg = x + (size_t)grp * g.cg;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.0f;

  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3, dx = tap % 3;
    const long long o0 = tap_offset(g, ra0, dy, dx);
    const long long o1 = tap_offset(g, ra1, dy, dx);
    for (int c0 = 0; c0 < g.cg; c0 += BK16) {
      const int left = g.cg - c0 - lc;  // valid channels from this chunk on
      load8(&As[lr][lc], xg + (o0 < 0 ? 0 : o0) + c0 + lc, o0 < 0 ? 0 : left,
            vec);
      load8(&As[lr + 64][lc], xg + (o1 < 0 ? 0 : o1) + c0 + lc,
            o1 < 0 ? 0 : left, vec);
      load8(&Bs[lr][lc], wrow + tap * g.cg + c0 + lc, b_ok ? left : 0, vec);
      __syncthreads();

#pragma unroll
      for (int kk = 0; kk < BK16; kk += 16) {
        uint32_t af[2][4], bfr[4][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const int r = wm * 32 + mi * 16 + gq;
          af[mi][0] = *reinterpret_cast<const uint32_t*>(&As[r][kk + 2 * tq]);
          af[mi][1] =
              *reinterpret_cast<const uint32_t*>(&As[r + 8][kk + 2 * tq]);
          af[mi][2] =
              *reinterpret_cast<const uint32_t*>(&As[r][kk + 2 * tq + 8]);
          af[mi][3] =
              *reinterpret_cast<const uint32_t*>(&As[r + 8][kk + 2 * tq + 8]);
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int cn = wn * 32 + ni * 8 + gq;
          bfr[ni][0] = *reinterpret_cast<const uint32_t*>(&Bs[cn][kk + 2 * tq]);
          bfr[ni][1] =
              *reinterpret_cast<const uint32_t*>(&Bs[cn][kk + 2 * tq + 8]);
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
            mma_bf16_16816(acc[mi][ni], af[mi], bfr[ni]);
      }
      __syncthreads();
    }
  }

  // accumulator layout of m16n8k16: c0,c1 at (gq, 2tq..2tq+1) of the
  // 16 x 8 tile, c2,c3 at (gq + 8, 2tq..2tq+1)
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int row = m0 + wm * 32 + mi * 16 + gq;
      const int col = n0 + wn * 32 + ni * 8 + 2 * tq;
      store_pair(out, g, grp, row, col, acc[mi][ni][0], acc[mi][ni][1]);
      store_pair(out, g, grp, row + 8, col, acc[mi][ni][2], acc[mi][ni][3]);
    }
}

// ---------------------------------------------------------------- fp32 path

constexpr int BK32 = 16;

__global__ void __launch_bounds__(THREADS)
    gconv_f32(const float* __restrict__ x, const float* __restrict__ w,
              float* __restrict__ out, Geom g) {
  // k-major tiles: a thread's 8 rows and 4 columns are contiguous
  __shared__ float As[BK32][BM + 4];
  __shared__ float Bs[BK32][BN + 4];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;  // 16 x 16 threads, 8 x 4 outputs each
  const int n_tiles = (g.fg + BN - 1) / BN;
  const int grp = blockIdx.y / n_tiles, n0 = (blockIdx.y % n_tiles) * BN;
  const int m0 = blockIdx.x * BM;

  // loaders: A element (tid + 256 j) is row tid/16 + 16 j, channel tid%16;
  // B element (tid + 256 j) is output channel tid/16 + 16 j, the same channel
  const int lk = tid % 16, lr = tid / 16;
  RowGeom ra[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) ra[j] = row_geom(g, m0 + lr + 16 * j);
  const float* xg = x + (size_t)grp * g.cg;

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3, dx = tap % 3;
    long long off[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) off[j] = tap_offset(g, ra[j], dy, dx);
    for (int c0 = 0; c0 < g.cg; c0 += BK32) {
      const int c = c0 + lk;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        As[lk][lr + 16 * j] = (off[j] >= 0 && c < g.cg) ? xg[off[j] + c] : 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + lr + 16 * j;
        Bs[lk][lr + 16 * j] =
            (n < g.fg && c < g.cg)
                ? w[((size_t)(grp * g.fg + n) * 9 + tap) * g.cg + c]
                : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK32; ++kk) {
        float av[8], bv[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) av[i] = As[kk][ty * 8 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx * 4 + j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; j += 2)
      store_pair(out, g, grp, m0 + ty * 8 + i, n0 + tx * 4 + j, acc[i][j],
                 acc[i][j + 1]);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// Plain C entry point, loaded with ctypes. x [B, H, W, G*cg], w [G*fg, 3,
// 3, cg] (the channels-last memory order of [C_out, cg, 3, 3]), out
// [B, Ho, Wo, G*fg] with Ho = ceil(H / stride); all in one dtype. Launches
// on `stream`, does not synchronise, allocates nothing, and returns the
// launch's cudaError_t (0 on success; -1 for a dtype it does not take).
extern "C" int group_conv3x3_launch(const void* x, const void* w, void* out,
                                    int B, int H, int W, int G, int cg, int fg,
                                    int stride, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || G <= 0 || cg <= 0 || fg <= 0 ||
      (stride != 1 && stride != 2))
    return (int)cudaErrorInvalidValue;
  Geom g;
  g.B = B, g.H = H, g.W = W, g.C = G * cg;
  g.Ho = (H + stride - 1) / stride, g.Wo = (W + stride - 1) / stride;
  g.Cout = G * fg, g.cg = cg, g.fg = fg, g.stride = stride;
  g.M = B * g.Ho * g.Wo;
  const int n_tiles = (fg + BN - 1) / BN;
  if ((long long)G * n_tiles > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((g.M + BM - 1) / BM, G * n_tiles);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16) {
    const int vec = (cg % 8 == 0) && aligned16(x) && aligned16(w);
    gconv_bf16<<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(out), g, vec);
  } else if (dtype == DT_F32) {
    gconv_f32<<<grid, THREADS, 0, s>>>(static_cast<const float*>(x),
                                       static_cast<const float*>(w),
                                       static_cast<float*>(out), g);
  } else {
    return -1;
  }
  return (int)cudaGetLastError();
}
