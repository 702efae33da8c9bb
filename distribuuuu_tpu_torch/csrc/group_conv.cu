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
// It is an implicit GEMM per group: M = B*Ho*Wo output pixels, N = fg
// output channels, K = 9*cg, with k = tap*cg + c, the order in which the
// weight is stored. So a group's B is a plain K-major [fg, 9*cg] matrix,
// read as it is stored, and an A row (one output pixel) is nine runs of
// cg channels, one a tap, from the NHWC input. The padding is a predicate
// that loads zero (where the TPU kernel padded with jnp.pad), the stride
// only enters the index arithmetic, and a group is a grid coordinate (the
// TPU kernel's static loop over groups and its VMEM batch tile were
// Mosaic workarounds).
//
// The bf16 design (gconv_wgmma):
//  * a block is BM = 64 or 128 output pixels (one or two consumer
//    warpgroups of 64 rows) by BN output channels of one group: BN = fg
//    at the group widths of ResNeXt, regnety_160/regnetx_160 and
//    regnety_320 (16, 112, 128, 232), else tiles of 64. The grid is
//    (M tiles, G x N tiles);
//  * a ring of `stages` shared-memory stages, each BM x 64 k of A and
//    BN x 64 k of B, both with the 128-byte swizzle;
//  * B: one TMA load a stage from a 2-D map over the weight seen as
//    [C_out, 9*cg]; TMA's zero fill past 9*cg covers the last chunk of K
//    (K is 9*cg rounded up to 64: 1024 at cg 112, where the tap-by-tap
//    walk of 32 channels took 1152);
//  * A: a producer warpgroup gathers it straight into the ring. cg is a
//    multiple of 8, so each 16-byte piece (8 channels) lies inside one
//    tap: a thread steps its (tap, c) by 64 channels a stage and finds
//    the input pixel (b, i*s + dy - 1, j*s + dx - 1), and copies 16
//    bytes with cp.async.cg to the swizzled address (piece ^ row % 8),
//    with a source size of 0 (zero fill) for taps in the padding, rows
//    past M and k past 9*cg. It never reads another group's channels
//    (TMA's im2col mode would, at cg 112 and 232, and a NaN there times a
//    zero weight is NaN). Each thread then hands its copies to the stage's
//    full barrier (cp.async.mbarrier.arrive.noinc: the barrier counts the
//    128 producer threads and the TMA thread's expect-tx) and goes on to
//    the next stage without waiting for them;
//  * the consumers wait for a stage, fence the gathered A from the
//    generic proxy it landed through to the async proxy wgmma reads
//    through (fence.proxy.async), run wgmma m64nBNk16 (A and B from
//    shared memory, B K-major, fp32 accumulators in registers) and free
//    the stage one step later on its empty barrier; the bf16 outputs are
//    written from the registers, masked at M's tail and at fg;
//  * the tiling (warpgroups, stages) is ops/cuda/group_conv.plan, from
//    group_conv_sweep.py.
//
// What bounds it on the H100: at regnety_160's stage 3 ([B, 14, 14, 1232],
// G = 11, cg = fg = 112) one site does 2*B*196*9*112*1232 operations over
// about 2*B*196*1232*2 bytes, some 500 operations a byte, above the ~295
// the card needs before its bf16 tensor cores are the limit: the site is
// bound by operations (3.9 us at batch 8, 31.5 us at 64, 98 us at 200).
// Inside the card the gather is the cost: each input pixel is read from
// L2 once a tap (9 times), and each block reads its group's whole weight
// (225 KB at cg 112), some 520 MB of L2 reads a site at batch 64. A
// variant without the products runs nearly as long as the kernel, one
// without the gather about half as long (PERF.md §6): the producers'
// L2 reads are the limit, and a halo tile (each input row staged once per
// M tile) is the next step.
//
// Tried and taken out (PERF.md §6): a producer that waited for its copies
// (cp.async.wait_group) and fenced them itself before arriving (up to a
// fifth slower); two blocks of a cluster sharing each weight stage by TMA
// multicast, freed by both blocks' consumers (faster at N = 232 only,
// slower at 112 and 128); blocks of 192 or 256 rows (three consumers, or
// two 64-row sub-tiles a consumer: no faster on the main path).
//
// Shapes the gather cannot take (cg or fg not a multiple of 8, or a base
// not 16-byte aligned; no RegNet site) run gconv_mma_sync, the first
// design: a 128 x 64 tile of mma.sync.m16n8k16 stepped 32 channels deep
// with masked loads. The launcher routes by shape. fp32 runs gconv_f32 on
// the CUDA cores (no TF32 rounding).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "hopper.cuh"

namespace {

using namespace hopper;

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

// ------------------------------------ bf16: gathered A, TMA B, wgmma (the rule)

constexpr int KC = 64;            // k of one ring stage: one 128-byte swizzle row
constexpr int MAX_SMEM = 232448;  // dynamic shared memory a block may use

template <int kWG, int kBN>
struct Ring {
  static constexpr int BM = 64 * kWG;              // output pixels of a block
  static constexpr int THREADS = 128 * (kWG + 1);  // producer warpgroup + consumers
  static constexpr int ROWS = BM / 16;             // A rows one producer thread gathers
  static constexpr int A_BYTES = BM * 128;
  static constexpr int B_BYTES = kBN * 128;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  // two blocks an SM where the accumulators leave room (128 registers a thread)
  static constexpr int MIN_BLOCKS = kWG == 1 && kBN <= 128 ? 2 : 1;
};

// 16 bytes from global to shared memory, bypassing L1; `bytes` = 0 reads
// nothing and writes zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}

// One arrival on `bar` when this thread's cp.async copies so far have
// landed (the barrier's count includes it: noinc).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// A block computes BM output pixels x kBN channels of one group.
template <int kWG, int kBN>
__global__ void __launch_bounds__(Ring<kWG, kBN>::THREADS, Ring<kWG, kBN>::MIN_BLOCKS)
    gconv_wgmma(const __grid_constant__ CUtensorMap tm_w, const __nv_bfloat16* __restrict__ x,
                __nv_bfloat16* __restrict__ out, Geom g, int stages) {
  using R = Ring<kWG, kBN>;
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the ring to it
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + stages * R::STAGE_BYTES);
  uint64_t* empty = full + stages;

  const int tid = threadIdx.x, wg = tid >> 7;
  const int n_tiles = (g.fg + kBN - 1) / kBN;
  const int grp = blockIdx.y / n_tiles, n0 = (blockIdx.y % n_tiles) * kBN;
  const int m0 = blockIdx.x * R::BM;
  const int K = 9 * g.cg, k_steps = (K + KC - 1) / KC;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(smem_u32(&full[s]), 128 + 1);  // the producer's threads + expect-tx
      mbar_init(smem_u32(&empty[s]), kWG);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const uint32_t base = smem_u32(smem);

  if (wg == 0) {
    // ---- producer: thread t gathers 16-byte piece t % 8 of rows t / 8 + 16 j
    const int q = tid & 7, r0 = tid >> 3;
    const uint32_t a_off = r0 * 128 + ((q ^ (r0 & 7)) << 4);  // (r0 + 16 j) % 8 == r0 % 8
    int h0[R::ROWS], w0[R::ROWS], pix[R::ROWS];
    const int hw = g.Ho * g.Wo;
#pragma unroll
    for (int j = 0; j < R::ROWS; ++j) {
      const int m = m0 + r0 + 16 * j;
      const int b = m / hw, rem = m - b * hw, i = rem / g.Wo;
      const bool ok = m < g.M;
      h0[j] = ok ? i * g.stride - 1 : -4;  // a row past M reads only padding
      w0[j] = (rem - i * g.Wo) * g.stride - 1;
      pix[j] = ok ? (b * g.H + h0[j]) * g.W + w0[j] : 0;  // pixel of tap (0, 0)
    }
    const __nv_bfloat16* xg = x + (size_t)grp * g.cg;
    // this thread's channel run: k = kt * 64 + 8 q is channel c of tap `tap`
    int tap = (q * 8) / g.cg, c = q * 8 - tap * g.cg;
    if (tid == 0) prefetch_map(&tm_w);
    int stage = 0;
    uint32_t phase = 0;
    for (int kt = 0; kt < k_steps; ++kt) {
      mbar_wait(smem_u32(&empty[stage]), phase ^ 1);
      const uint32_t sA = base + stage * R::STAGE_BYTES, fb = smem_u32(&full[stage]);
      if (tid == 0) {
        mbar_expect_tx(fb, R::B_BYTES);
        tma_load_2d(sA + R::A_BYTES, &tm_w, fb, kt * KC, grp * g.fg + n0);
      }
      const int dy = tap / 3, dx = tap - 3 * dy;  // tap 9 and on: past K
      const int shift = dy * g.W + dx;
#pragma unroll
      for (int j = 0; j < R::ROWS; ++j) {
        const bool ok = tap < 9 && (unsigned)(h0[j] + dy) < (unsigned)g.H &&
                        (unsigned)(w0[j] + dx) < (unsigned)g.W;
        const __nv_bfloat16* src = ok ? xg + (long long)(pix[j] + shift) * g.C + c : x;
        cp_async16(sA + a_off + j * 16 * 128, src, ok ? 16 : 0);
      }
      cp_async_arrive(fb);
      for (c += KC; c >= g.cg && tap < 9; c -= g.cg) ++tap;
      if (++stage == stages) {
        stage = 0;
        phase ^= 1;
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");  // exit with no copy in flight
  } else {
    // ---- consumers: rows 64 (wg - 1) .. + 63 of the tile, all kBN columns
    const int cw = wg - 1, wtid = tid & 127;
    float acc[kBN / 2];
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.0f;
    int stage = 0, prev = -1;
    uint32_t phase = 0;
    for (int kt = 0; kt < k_steps; ++kt) {
      mbar_wait(smem_u32(&full[stage]), phase);
      // the gathered A landed through the generic proxy; wgmma reads
      // through the async proxy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      const uint32_t sA = base + stage * R::STAGE_BYTES + cw * 64 * 128;
      const uint32_t sB = base + stage * R::STAGE_BYTES + R::A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk)  // k16 slice: 32 bytes along both swizzled tiles
        wgmma_ss<kBN, 0, __nv_bfloat16>(acc, sw128_desc(sA + kk * 32, 16, 1024),
                                        sw128_desc(sB + kk * 32, 16, 1024));
      wgmma_commit();
      if (stages > 1) {
        wgmma_wait<1>();  // the previous stage's products are done: free it
        if (prev >= 0 && wtid == 0) mbar_arrive(smem_u32(&empty[prev]));
        prev = stage;
      } else {  // a ring of one stage: free it before the next load
        wgmma_wait<0>();
        if (wtid == 0) mbar_arrive(smem_u32(&empty[stage]));
      }
      if (++stage == stages) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) reg_fence(acc[i]);

    // wgmma's accumulator layout: register i of lane l in warp w holds row
    // w*16 + l/4 (+8 for the odd pairs), column 8*(i/4) + 2*(l%4) + i%2;
    // fg is even, so a pair lies wholly inside or outside the group
    const int w = wtid >> 5, l = wtid & 31;
    const int row0 = m0 + cw * 64 + w * 16 + (l >> 2);
    __nv_bfloat16* og = out + (size_t)grp * g.fg;
#pragma unroll
    for (int i = 0; i < kBN / 2; i += 2) {
      const int row = row0 + 8 * ((i >> 1) & 1);
      const int col = n0 + (i >> 2) * 8 + (l & 3) * 2;
      if (row < g.M && col < g.fg)
        *reinterpret_cast<__nv_bfloat162*>(og + (size_t)row * g.Cout + col) =
            __floats2bfloat162_rn(acc[i], acc[i + 1]);
    }
  }
}

// ------------------------------ bf16 for shapes the gather cannot take

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
    gconv_mma_sync(const __nv_bfloat16* __restrict__ x,
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

// The N tile of the wgmma body: one tile at the group widths it is built
// for, else tiles of 64 (the columns past fg are computed and not stored).
int n_tile(int fg) { return fg == 16 || fg == 112 || fg == 128 || fg == 232 ? fg : 64; }

template <int kWG, int kBN>
int launch_wgmma(const void* x, const void* w, void* out, const Geom& g, int stages,
                 cudaStream_t s) {
  using R = Ring<kWG, kBN>;
  const int smem = 1024 + stages * (R::STAGE_BYTES + 16);
  if (stages < 1 || smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  // the weight [C_out, 3, 3, cg] as a K-major [C_out, 9 cg] matrix
  CUtensorMap tw;
  const cuuint64_t dims[2] = {(cuuint64_t)9 * g.cg, (cuuint64_t)g.Cout};
  const cuuint64_t strides[1] = {(cuuint64_t)9 * g.cg * 2};
  const cuuint32_t box[2] = {KC, kBN};
  if (!swizzled_map(&tw, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w, dims, strides, box))
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  static std::atomic<unsigned> raised{0};  // for this tiling
  e = raise_smem_once(gconv_wgmma<kWG, kBN>, MAX_SMEM, dev, raised);
  if (e != cudaSuccess) return (int)e;
  const long long y = (long long)(g.C / g.cg) * ((g.fg + kBN - 1) / kBN);
  if (y > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((g.M + R::BM - 1) / R::BM, (unsigned)y);
  gconv_wgmma<kWG, kBN><<<grid, R::THREADS, smem, s>>>(
      tw, static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out), g, stages);
  return (int)cudaGetLastError();
}

int launch_tiling(const void* x, const void* w, void* out, const Geom& g, int warpgroups,
                  int stages, cudaStream_t s) {
  const int bn = n_tile(g.fg);
#define GC_TILE(wg, n) \
  if (warpgroups == wg && bn == n) return launch_wgmma<wg, n>(x, w, out, g, stages, s);
  GC_TILE(1, 16)
  GC_TILE(2, 16)
  GC_TILE(1, 64)
  GC_TILE(2, 64)
  GC_TILE(1, 112)
  GC_TILE(2, 112)
  GC_TILE(1, 128)
  GC_TILE(2, 128)
  GC_TILE(1, 232)
  GC_TILE(2, 232)
#undef GC_TILE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point, loaded with ctypes. x [B, H, W, G*cg], w [G*fg, 3,
// 3, cg] (the channels-last memory order of [C_out, cg, 3, 3]), out
// [B, Ho, Wo, G*fg] with Ho = ceil(H / stride); all in one dtype.
// (warpgroups, stages) is the wrapper's plan for the bf16 wgmma body,
// which takes cg and fg that are multiples of 8 and 16-byte aligned bases;
// other bf16 calls run the mma.sync body. Launches on `stream`, does not
// synchronise, allocates nothing, and returns the launch's cudaError_t (0
// on success; -1 for a dtype it does not take).
extern "C" int group_conv3x3_launch(const void* x, const void* w, void* out,
                                    int B, int H, int W, int G, int cg, int fg,
                                    int stride, int dtype, int warpgroups, int stages,
                                    void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || G <= 0 || cg <= 0 || fg <= 0 ||
      (stride != 1 && stride != 2) || (long long)B * H * W >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  Geom g;
  g.B = B, g.H = H, g.W = W, g.C = G * cg;
  g.Ho = (H + stride - 1) / stride, g.Wo = (W + stride - 1) / stride;
  g.Cout = G * fg, g.cg = cg, g.fg = fg, g.stride = stride;
  g.M = B * g.Ho * g.Wo;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16 && cg % 8 == 0 && fg % 8 == 0 && aligned16(x) && aligned16(w) &&
      aligned16(out))
    return launch_tiling(x, w, out, g, warpgroups, stages, s);
  const int n_tiles = (fg + BN - 1) / BN;
  if ((long long)G * n_tiles > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((g.M + BM - 1) / BM, G * n_tiles);
  if (dtype == DT_BF16) {
    const int vec = (cg % 8 == 0) && aligned16(x) && aligned16(w);
    gconv_mma_sync<<<grid, THREADS, 0, s>>>(
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
