// Fused pointwise conv + folded eval BatchNorm + activation for Hopper (sm_90a).
//
// Replaces the Pallas kernel distribuuuu_tpu/ops/pallas/conv_epilogue.py
// (_mm_epilogue_kernel, reached through conv1x1_bn_act). It computes
//
//     out[m, n] = act((sum_k x[m, k] * w[k, n]) * a[n] + c[n])
//
// for x [M, K] (an NHWC activation viewed as rows), w [K, N], and the
// per-channel affine a, c [N] in fp32 that eval BatchNorm folds to.
//
// What bounds it on the H100: at the ResNet-50 sites the products are
// 64..2048 deep, well below the ~295 operations per byte the card needs
// before the tensor cores are the limit, so the sites are memory-bound.
// The one thing the kernel must do is the thing the TPU kernel did: apply
// the affine and the activation to the fp32 accumulator while it is still
// in registers, so the conv output is never written to device memory
// un-normalised and never read back.
//
// Design (simple and right first; wgmma, TMA and a pipelined ring come later):
//  * a 128 x 64 output tile per 256-thread block, K stepped through shared
//    memory, fp32 accumulators in registers;
//  * bf16 inputs: eight warps, each a 32 x 32 sub-tile of
//    mma.sync.m16n8k16 bf16 products (tensor cores), whose accumulator
//    layout is fixed by the PTX ISA, so the epilogue knows each register's
//    (row, column);
//  * fp32 inputs: the same tile on the CUDA cores (fp32 FMA), 8 x 4 outputs
//    a thread, so fp32 stays fp32 (no TF32 rounding);
//  * ragged M, N and K edges are masked on load (zero fill) and on store.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 64;
constexpr int THREADS = 256;

enum Act { ACT_ID = 0, ACT_RELU = 1, ACT_SILU = 2 };
enum DType { DT_F32 = 0, DT_BF16 = 1 };

__device__ __forceinline__ float apply_act(float y, int act) {
  if (act == ACT_RELU) return fmaxf(y, 0.0f);
  if (act == ACT_SILU) return y / (1.0f + expf(-y));
  return y;
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Epilogue for one accumulator pair at (row, col) and (row, col + 1).
template <typename OutT>
__device__ __forceinline__ void epilogue_pair(OutT* out, const float* a,
                                              const float* c, int M, int N,
                                              int row, int col, float v0,
                                              float v1, int act) {
  if (row >= M) return;
  OutT* dst = out + (size_t)row * N;
  if (col < N) store_out(dst + col, apply_act(v0 * a[col] + c[col], act));
  if (col + 1 < N)
    store_out(dst + col + 1, apply_act(v1 * a[col + 1] + c[col + 1], act));
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

template <typename OutT>
__global__ void __launch_bounds__(THREADS)
    epilogue_gemm_bf16(const __nv_bfloat16* __restrict__ x,
                       const __nv_bfloat16* __restrict__ w,
                       const float* __restrict__ a,
                       const float* __restrict__ c, OutT* __restrict__ out,
                       int M, int N, int K, int act, int vec) {
  // A tile row-major [m][k]; B tile transposed to [n][k] so that the two
  // k-adjacent bf16 values of a B fragment register are adjacent in memory.
  __shared__ __align__(16) __nv_bfloat16 As[BM][BK16 + PAD16];
  __shared__ __align__(16) __nv_bfloat16 Bs[BN][BK16 + PAD16];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;  // 4 x 2 warps of 32 x 32
  const int g = lane >> 2, t = lane & 3;    // PTX fragment group / thread-in-group
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK16) {
    // x tile: BM x BK16 in chunks of 8 along k (16 B when in bounds)
    for (int i = tid; i < BM * BK16 / 8; i += THREADS) {
      const int r = i / (BK16 / 8), cc = (i % (BK16 / 8)) * 8;
      const int gm = m0 + r, gk = k0 + cc;
      if (vec && gm < M && gk + 8 <= K) {
        *reinterpret_cast<uint4*>(&As[r][cc]) =
            *reinterpret_cast<const uint4*>(x + (size_t)gm * K + gk);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          As[r][cc + j] =
              (gm < M && gk + j < K) ? x[(size_t)gm * K + gk + j] : zero;
      }
    }
    // w tile: BK16 x BN in chunks of 8 along n, stored transposed
    for (int i = tid; i < BK16 * BN / 8; i += THREADS) {
      const int kr = i / (BN / 8), nc = (i % (BN / 8)) * 8;
      const int gk = k0 + kr, gn = n0 + nc;
      __align__(16) __nv_bfloat16 tmp[8];
      if (vec && gk < K && gn + 8 <= N) {
        *reinterpret_cast<uint4*>(tmp) =
            *reinterpret_cast<const uint4*>(w + (size_t)gk * N + gn);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          tmp[j] = (gk < K && gn + j < N) ? w[(size_t)gk * N + gn + j] : zero;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) Bs[nc + j][kr] = tmp[j];
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK16; kk += 16) {
      uint32_t af[2][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = wm * 32 + mi * 16 + g;
        af[mi][0] = *reinterpret_cast<const uint32_t*>(&As[r][kk + 2 * t]);
        af[mi][1] = *reinterpret_cast<const uint32_t*>(&As[r + 8][kk + 2 * t]);
        af[mi][2] = *reinterpret_cast<const uint32_t*>(&As[r][kk + 2 * t + 8]);
        af[mi][3] =
            *reinterpret_cast<const uint32_t*>(&As[r + 8][kk + 2 * t + 8]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int cn = wn * 32 + ni * 8 + g;
        bfr[ni][0] = *reinterpret_cast<const uint32_t*>(&Bs[cn][kk + 2 * t]);
        bfr[ni][1] =
            *reinterpret_cast<const uint32_t*>(&Bs[cn][kk + 2 * t + 8]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16_16816(acc[mi][ni], af[mi], bfr[ni]);
    }
    __syncthreads();
  }

  // epilogue straight from the accumulator registers: c0,c1 sit at
  // (g, 2t..2t+1) of the 16 x 8 tile, c2,c3 at (g + 8, 2t..2t+1)
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int row = m0 + wm * 32 + mi * 16 + g;
      const int col = n0 + wn * 32 + ni * 8 + 2 * t;
      epilogue_pair(out, a, c, M, N, row, col, acc[mi][ni][0],
                    acc[mi][ni][1], act);
      epilogue_pair(out, a, c, M, N, row + 8, col, acc[mi][ni][2],
                    acc[mi][ni][3], act);
    }
}

// ---------------------------------------------------------------- fp32 path

constexpr int BK32 = 16;

template <typename OutT>
__global__ void __launch_bounds__(THREADS)
    epilogue_gemm_f32(const float* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ a, const float* __restrict__ c,
                      OutT* __restrict__ out, int M, int N, int K, int act) {
  // k-major tiles: a thread's 8 rows and 4 columns are contiguous
  __shared__ float As[BK32][BM + 4];
  __shared__ float Bs[BK32][BN + 4];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;  // 16 x 16 threads, 8 x 4 outputs each
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK32) {
    for (int i = tid; i < BM * BK32; i += THREADS) {
      const int r = i / BK32, kk = i % BK32;
      const int gm = m0 + r, gk = k0 + kk;
      As[kk][r] = (gm < M && gk < K) ? x[(size_t)gm * K + gk] : 0.0f;
    }
    for (int i = tid; i < BK32 * BN; i += THREADS) {
      const int kr = i / BN, nc = i % BN;
      const int gk = k0 + kr, gn = n0 + nc;
      Bs[kr][nc] = (gk < K && gn < N) ? w[(size_t)gk * N + gn] : 0.0f;
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

#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; j += 2)
      epilogue_pair(out, a, c, M, N, m0 + ty * 8 + i, n0 + tx * 4 + j,
                    acc[i][j], acc[i][j + 1], act);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// Plain C entry point, loaded with ctypes. Launches on `stream`, does not
// synchronise, allocates nothing, and returns the launch's cudaError_t
// (0 on success; -1 for a dtype pair the kernel does not take).
extern "C" int conv_epilogue_launch(const void* x, const void* w,
                                    const void* a, const void* c, void* out,
                                    int M, int N, int K, int in_dtype,
                                    int out_dtype, int act, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  const dim3 block(THREADS);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* cf = static_cast<const float*>(c);
  if (in_dtype == DT_BF16) {
    const int vec = (K % 8 == 0) && (N % 8 == 0) && aligned16(x) && aligned16(w);
    const auto* xb = static_cast<const __nv_bfloat16*>(x);
    const auto* wb = static_cast<const __nv_bfloat16*>(w);
    if (out_dtype == DT_BF16)
      epilogue_gemm_bf16<__nv_bfloat16><<<grid, block, 0, s>>>(
          xb, wb, af, cf, static_cast<__nv_bfloat16*>(out), M, N, K, act, vec);
    else if (out_dtype == DT_F32)
      epilogue_gemm_bf16<float><<<grid, block, 0, s>>>(
          xb, wb, af, cf, static_cast<float*>(out), M, N, K, act, vec);
    else
      return -1;
  } else if (in_dtype == DT_F32) {
    const auto* xf = static_cast<const float*>(x);
    const auto* wf = static_cast<const float*>(w);
    if (out_dtype == DT_F32)
      epilogue_gemm_f32<float><<<grid, block, 0, s>>>(
          xf, wf, af, cf, static_cast<float*>(out), M, N, K, act);
    else if (out_dtype == DT_BF16)
      epilogue_gemm_f32<__nv_bfloat16><<<grid, block, 0, s>>>(
          xf, wf, af, cf, static_cast<__nv_bfloat16*>(out), M, N, K, act);
    else
      return -1;
  } else {
    return -1;
  }
  return (int)cudaGetLastError();
}
