// Flash attention for Hopper (sm_90a): forward, dQ and dK/dV.
//
// Replaces the three Pallas kernels of distribuuuu_tpu/ops/flash_attention.py:
//   * _fwd_kernel  (reached through _flash_forward, :315)  -> flash_fwd_launch
//   * _dq_kernel   (reached through _flash_backward, :359) -> flash_dq_launch
//   * _dkdv_kernel (reached through _flash_backward, :372) -> flash_dkdv_launch
// on q, k, v, dO of [BH, L, D] (contiguous; D in {64, 128} in bf16/f16,
// {32, 64, 128} in fp32; the wrapper zero-pads any other D <= 128, a 16-bit
// D <= 32 to 64), lse and delta of [BH, L] in fp32.
//
//   forward:  o = softmax(q k^T * scale) v,  lse = m + log(l)   (online softmax)
//   dQ:       p = exp(s - lse), ds = p (dO v^T - delta) scale,  dq = ds k
//   dK/dV:    dv = p^T dO,  dk = ds^T q   (computed as s^T = k q^T)
//
// with keys past L masked, and under `causal` keys past the query row. The
// rounding points are the Pallas bodies': p is rounded to the input dtype
// before p.v and p^T.dO, ds before ds.k and ds^T.q; everything else is fp32
// (the forward's row sum l adds the fp32 p).
//
// What bounds it on the H100: at the ViT-S/16 training shape [32*6, 196, 64]
// a call does 1-2 GFLOP over 20-30 MB, under the ~295 operations per byte
// the tensor cores need, so it is bound by bytes (about 6-9 us at
// 3.35 TB/s); its 384-768 small blocks make it a matter of latency first.
// At ViT-Ti/16 on 1024^2 inputs ([4*3, 4096, 64]) a call does 51-103 GFLOP
// over a few MB: bound by the tensor cores (50-100 us at 989 TFLOP/s),
// which only wgmma fed from shared memory reaches. Every design keeps the
// L x L scores and probabilities out of device memory (they live in
// registers for one tile).
//
// The 16-bit bodies (fwd_wgmma, dq_wgmma, dkdv_wgmma) at D 64 and 128:
//  * a block is one or two consumer warpgroups of 64 rows (queries for the
//    forward and dQ, keys for dK/dV) and one producer warp, so that two to
//    four blocks share an SM and their products interleave on the tensor
//    cores. The block's own rows are loaded once (Q; Q and dO; or K and V);
//    the other side streams through a ring of stages (K and V; or Q, dO
//    with their lse and delta), filled by TMA and completed on mbarriers
//    while the consumers work on the stages that arrived;
//  * every operand is a box of a 3-D tensor map over [BH, L, D] with the
//    128-byte swizzle, so rows past L of a head read zeros (never the next
//    head's), and each product reads it in that layout: K-major for
//    S = Q.K^T, dP = dO.V^T, S^T = K.Q^T and dP^T = V.dO^T, MN-major through
//    wgmma's transpose bit for P.V, dS.K, P^T.dO and dS^T.Q, whose A operand
//    is the previous product's fp32 accumulator rounded to T in registers.
//    No tile is transposed in shared memory;
//  * wgmma.mma_async m64nNk16 with fp32 accumulators. The forward runs
//    S = Q.K^T, the softmax (exp2 domain, on the SFU) and P.V of a tile in
//    turn: its overlap is across warpgroups, two to four on an SM, because
//    issuing the next tile's S before this tile's P.V measured slower (it
//    holds each stage one tile longer). dQ computes the exp of S under dP
//    in commit groups, dK/dV dS^T under dV's product;
//  * the forward's tiling (consumer warpgroups, key tile, ring stages) and
//    dK/dV's (query tile, stages) are the wrapper's per-shape plans (ops/
//    cuda/flash_attention.py `fwd_plan`, `bwd_plan`); dQ's ring holds two
//    stages. Each launcher checks its plan against its shared memory;
//  * masks (keys or queries past L, causal) are applied only in the tiles
//    that hold masked pairs; causal: wholly masked tiles are skipped (the
//    forward's and dQ's last key tiles, dK/dV's first query tiles), and
//    the forward and dQ launch their longest rows first. Key tile 0 is
//    always the first a query row meets, so its running max is finite from
//    the first tile on (masked scores never enter it).
//
// The fp32 bodies (right and simple first): the CUDA cores (fp32 FMA, no
// TF32), one thread per query row (forward, dQ) or key row (dK/dV) of a
// block's 64, the other side streamed through shared memory in tiles of 64;
// no atomics: dQ and dK/dV are two kernels, each owning its output rows, so
// the bits do not depend on scheduling. Query rows past L contribute
// exactly 0 to dK/dV (masked explicitly).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include <atomic>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BT = 64;  // rows of a block's own tile, and of a streamed tile (fp32)
constexpr float NEG_BIG = -0.7f * FLT_MAX;

enum DType { DT_F32 = 0, DT_BF16 = 1, DT_F16 = 2 };

// ------------------------------------------------------------ 16-bit types

template <typename T>
struct Ops;

template <>
struct Ops<__nv_bfloat16> {
  // two floats rounded to the type, `lo` in the low 16 bits
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

template <>
struct Ops<__half> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

// the max and sum over the four lanes that hold one accumulator row
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ------------------------------------------------ TMA + wgmma bodies
// bf16/f16 at D 64 and 128. Every operand is a TMA box of [1, rows, 64]
// from a 3-D map over [BH, L, D] with the 128-byte swizzle: rows past L of
// a head read zeros, never the next head's. Each product reads its
// shared-memory operands in that one layout: K-major for S = Q.K^T,
// dP = dO.V^T (and S^T = K.Q^T, dP^T = V.dO^T), MN-major through the
// transpose bit for P.V, dS.K (and P^T.dO, dS^T.Q), with P, dS, P^T and
// dS^T fed from registers: the fp32 accumulator of one product is the A
// fragment of the next once rounded to T, so no tile is ever transposed.

constexpr int BOX = 64;  // 16-bit columns of one TMA box: one 128-byte swizzled row
constexpr int BKV = 64;  // keys of a dQ ring stage
constexpr int MAX_SMEM = 232448;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

constexpr int BWD_THREADS = 160;  // a consumer warpgroup and the producer warp

template <int D, int NWG, int KT>
struct FwdTile {
  static constexpr int BM = 64 * NWG;             // query rows of a block
  static constexpr int THREADS = 128 * NWG + 32;  // the consumer warpgroups and the producer warp
  static constexpr int WG_BYTES = 64 * D * 2;     // Q of one warpgroup, resident
  static constexpr int TILE_BYTES = KT * D * 2;   // K (and V) of a stage
  static constexpr int STAGE_BYTES = 2 * TILE_BYTES;
  // blocks an SM the registers are bounded for: at D 64 with 64-key tiles
  // ptxas takes 96 (four blocks of one warpgroup, two of two), else 128
  static constexpr int MIN_BLOCKS = D == 64 && KT == 64 ? 4 / NWG : 2 / NWG;
  static size_t smem(int stages) {
    return 1024 + NWG * WG_BYTES + (size_t)stages * STAGE_BYTES + (2 * stages + 1) * 8;
  }
};

template <int D>
struct DqTile {
  static constexpr int BM = 64;                      // query rows of a block
  static constexpr int RES_BYTES = BM * D * 2;       // Q (and dO), resident
  static constexpr int TILE_BYTES = BKV * D * 2;     // K (and V) of a stage
  static constexpr int STAGE_BYTES = 2 * TILE_BYTES;
  static size_t smem(int stages) {
    return 1024 + 2 * RES_BYTES + (size_t)stages * STAGE_BYTES + (2 * stages + 1) * 8;
  }
};

template <int D, int BQ>
struct DkdvTile {
  static constexpr int BK = 64;                      // keys of a block
  static constexpr int RES_BYTES = BK * D * 2;       // K (and V), resident
  static constexpr int TILE_BYTES = BQ * D * 2;      // Q (and dO) of a stage
  static constexpr int STAGE_BYTES = 2 * TILE_BYTES;
  static size_t smem(int stages) {
    return 1024 + 2 * RES_BYTES + (size_t)stages * (STAGE_BYTES + 2 * BQ * 4) +
           (2 * stages + 1) * 8;
  }
};

// 2^x on the SFU (ex2.approx, subnormal results flushed to 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the 128-byte-swizzled descriptor of the k16 step kk of a K-major operand
// whose boxes hold `rows` rows each
__device__ __forceinline__ uint64_t kmajor(uint32_t base, int rows, int kk) {
  return sw128_desc(base + (kk >> 2) * (rows * 128) + (kk & 3) * 32, 16, 1024);
}
// ... and of an MN-major operand: k16 step kc is 16 rows down, the next 64
// columns one box (rows x 128 bytes) on
__device__ __forceinline__ uint64_t mnmajor(uint32_t base, int rows, int kc) {
  return sw128_desc(base + kc * 2048, rows * 128, 1024);
}

// The fp32 wgmma accumulator (m64nN) of a warpgroup: register 4j + e of
// lane l in warp w holds row 16w + l/4 + 8(e/2), column 8j + 2(l%4) + e%2.
// Two n8 blocks j = 2kc, 2kc + 1 are the A fragment of k16 step kc.
template <typename T>
__device__ __forceinline__ void pack_a(uint32_t (*a)[4], int j, const float* v) {
  a[j >> 1][(j & 1) * 2] = Ops<T>::pack(v[0], v[1]);
  a[j >> 1][(j & 1) * 2 + 1] = Ops<T>::pack(v[2], v[3]);
}

// Store a warpgroup's 64 x D accumulator (rows r0 and r0 + 8 of this
// thread), rows past L skipped.
template <typename T, int D>
__device__ __forceinline__ void store_acc(T* out, const float* acc, int r0, int L, int t) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (r0 < L)
      *reinterpret_cast<uint32_t*>(out + (size_t)r0 * D + col) =
          Ops<T>::pack(acc[4 * j], acc[4 * j + 1]);
    if (r0 + 8 < L)
      *reinterpret_cast<uint32_t*>(out + (size_t)(r0 + 8) * D + col) =
          Ops<T>::pack(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// Forward: the block owns 64 NWG query rows of head blockIdx.x (under
// `causal` the longest rows launch first); K and V stream through the
// ring in tiles of KT keys, which every consumer warpgroup reads for its
// own 64 rows. A warpgroup runs S = Q.K^T, the softmax and P.V (P in
// registers) of a tile in turn and releases its stage; the products of
// one warpgroup run under the softmax of the others on the SM (two or
// three blocks an SM, or two warpgroups a block), and the producer keeps
// the next tiles in flight. The softmax runs in the exp2 domain: m2 is the
// row max of s * scale * log2(e) (scale >= 0, which the wrapper
// guarantees, so it is the scaled max of the raw scores), and
// p = 2^(s * scale * log2(e) - m2).
template <typename T, int D, int NWG, int KT>
__global__ void __launch_bounds__(FwdTile<D, NWG, KT>::THREADS, FwdTile<D, NWG, KT>::MIN_BLOCKS)
    fwd_wgmma(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
              const __grid_constant__ CUtensorMap tm_v, T* __restrict__ o,
              float* __restrict__ lse, int L, int causal, float scale, int stages) {
  using P = FwdTile<D, NWG, KT>;
  constexpr int NB = D / BOX;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sQ = smem_u32(smem), ring = sQ + NWG * P::WG_BYTES;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + NWG * P::WG_BYTES + (size_t)stages * P::STAGE_BYTES);
  uint64_t* empty = full + stages;
  uint64_t* resident = empty + stages;

  const int bh = blockIdx.x;
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * P::BM;
  const int nk = (L + KT - 1) / KT;
  const int nk_hi = causal ? min(nk, (q0 + P::BM - 1) / KT + 1) : nk;  // causal tile skip
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), 4 * NWG);  // one arrival a consumer warp
    }
    mbar_init(smem_u32(resident), 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4 * NWG) {
    // ---- producer: Q once, then K and V into the ring
    if (lane == 0) {
      prefetch_map(&tm_q);
      prefetch_map(&tm_k);
      prefetch_map(&tm_v);
      const uint32_t rb = smem_u32(resident);
      mbar_expect_tx(rb, NWG * P::WG_BYTES);
#pragma unroll
      for (int w = 0; w < NWG; ++w)
#pragma unroll
        for (int c = 0; c < NB; ++c)
          tma_load_3d(sQ + w * P::WG_BYTES + c * 64 * 128, &tm_q, rb, c * BOX, q0 + 64 * w, bh);
      int stage = 0;
      uint32_t phase = 0;
      for (int kt = 0; kt < nk_hi; ++kt) {
        mbar_wait(smem_u32(&empty[stage]), phase ^ 1);
        const uint32_t fb = smem_u32(&full[stage]);
        mbar_expect_tx(fb, P::STAGE_BYTES);
        const uint32_t sK = ring + stage * P::STAGE_BYTES, sV = sK + P::TILE_BYTES;
#pragma unroll
        for (int c = 0; c < NB; ++c) {
          tma_load_3d(sK + c * KT * 128, &tm_k, fb, c * BOX, kt * KT, bh);
          tma_load_3d(sV + c * KT * 128, &tm_v, fb, c * BOX, kt * KT, bh);
        }
        if (++stage == stages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumer warpgroup wg: rows r0 .. r0 + 63
  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int r0 = q0 + 64 * wg;
  const int row0 = r0 + 16 * (warp & 3) + g, row1 = row0 + 8;
  // the key tiles these rows meet: under `causal` the first of two
  // warpgroups meets fewer, and releases the other's last stages unread
  const int nk_w = causal ? min(nk, (r0 + 63) / KT + 1) : nk;
  const uint32_t sQw = sQ + wg * P::WG_BYTES;
  const float c2 = scale * LOG2E;

  float acc[D / 2], s[KT / 2];
  uint32_t pa[KT / 16][4];  // P rounded to T: the A fragments of P.V
  // each row's max in the exp2 domain, and this thread's share of its sum
  float m2[2] = {NEG_BIG, NEG_BIG}, l[2] = {0.0f, 0.0f}, corr[2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;

  auto release = [&](int st) {
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_u32(&empty[st]));
  };
  // p = 2^(s c2 - m2) in place, masked pairs (keys past L; under `causal`,
  // keys past the row) 0 and out of the max, only in a tile that has such
  // pairs; the row max and sum move on, and corr is what O is rescaled by
  auto probs = [&](auto masked, int k0) {
    auto keep = [&](int j, int e) {
      if constexpr (decltype(masked)::value) {
        const int col = k0 + 8 * j + 2 * t + (e & 1);
        return col < L && !(causal && col > (e < 2 ? row0 : row1));
      } else {
        return true;
      }
    };
    float mx[2] = {NEG_BIG, NEG_BIG}, rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        reg_fence(s[4 * j + e]);
        if (keep(j, e)) mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m2[r], quad_max(mx[r]) * c2);
      corr[r] = fast_exp2(m2[r] - m_new);
      m2[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = keep(j, e) ? fast_exp2(fmaf(s[4 * j + e], c2, -m2[e >> 1])) : 0.0f;
        s[4 * j + e] = p;
        rs[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rs[r];
  };

  mbar_wait(smem_u32(resident), 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int kt = 0; kt < nk_w; ++kt) {
    const int k0 = kt * KT;
    mbar_wait(smem_u32(&full[stage]), phase);
    const uint32_t sK = ring + stage * P::STAGE_BYTES, sV = sK + P::TILE_BYTES;
    // S = Q.K^T, K read K-major
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<KT, 0, T>(s, kmajor(sQw, 64, kk), kmajor(sK, KT, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    if (k0 + KT > L || (causal && k0 + KT - 1 > r0))
      probs(std::true_type(), k0);
    else
      probs(std::false_type(), k0);
    // O rescaled (0 times 0 on the first tile), then O += P.V with P
    // rounded to T in registers and V read MN-major
#pragma unroll
    for (int i = 0; i < D / 2; ++i) {
      reg_fence(acc[i]);
      acc[i] *= corr[(i >> 1) & 1];
    }
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) pack_a<T>(pa, j, s + 4 * j);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < KT / 16; ++kc) wgmma_rs<D, 1, T>(acc, pa[kc], mnmajor(sV, KT, kc));
    wgmma_commit();
    wgmma_wait<0>();
    release(stage);
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  }
  for (int kt = nk_w; kt < nk_hi; ++kt) {  // the other warpgroup's last tiles
    mbar_wait(smem_u32(&full[stage]), phase);
    release(stage);
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  }

  // o = acc / l, lse = (m2 + log2 l) ln 2
  float inv[2];
  const size_t vb = (size_t)bh * L;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float ls = fmaxf(quad_sum(l[r]), 1e-30f);
    inv[r] = 1.0f / ls;
    const int row = r ? row1 : row0;
    if (t == 0 && row < L) lse[vb + row] = (m2[r] + log2f(ls)) * LN2;
  }
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    reg_fence(acc[i]);
    acc[i] *= inv[(i >> 1) & 1];
  }
  store_acc<T, D>(o + vb * D, acc, row0, L, t);
}

// dQ: the block owns 64 query rows of head blockIdx.x (under `causal` the
// longest rows launch first); K and V stream in tiles of 64.
template <typename T, int D>
__global__ void __launch_bounds__(BWD_THREADS, D == 64 ? 3 : 2)
    dq_wgmma(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
             const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
             const float* __restrict__ lse, const float* __restrict__ delta, T* __restrict__ dq,
             int L, int causal, float scale, int stages) {
  using P = DqTile<D>;
  constexpr int BM = P::BM, NB = D / BOX;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sQ = smem_u32(smem), sDo = sQ + P::RES_BYTES, ring = sDo + P::RES_BYTES;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + 2 * P::RES_BYTES + (size_t)stages * P::STAGE_BYTES);
  uint64_t* empty = full + stages;
  uint64_t* resident = empty + stages;

  const int bh = blockIdx.x;
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * BM;
  const int nk = (L + BKV - 1) / BKV;
  const int nk_hi = causal ? min(nk, (q0 + BM - 1) / BKV + 1) : nk;  // causal tile skip
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), 4);  // one arrival a consumer warp
    }
    mbar_init(smem_u32(resident), 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4) {
    // ---- producer: Q and dO once, then K and V into the ring
    if (lane == 0) {
      prefetch_map(&tm_q);
      prefetch_map(&tm_do);
      prefetch_map(&tm_k);
      prefetch_map(&tm_v);
      const uint32_t rb = smem_u32(resident);
      mbar_expect_tx(rb, 2 * P::RES_BYTES);
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        tma_load_3d(sQ + c * BM * 128, &tm_q, rb, c * BOX, q0, bh);
        tma_load_3d(sDo + c * BM * 128, &tm_do, rb, c * BOX, q0, bh);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int kt = 0; kt < nk_hi; ++kt) {
        mbar_wait(smem_u32(&empty[stage]), phase ^ 1);
        const uint32_t fb = smem_u32(&full[stage]);
        mbar_expect_tx(fb, P::STAGE_BYTES);
        const uint32_t sK = ring + stage * P::STAGE_BYTES, sV = sK + P::TILE_BYTES;
#pragma unroll
        for (int c = 0; c < NB; ++c) {
          tma_load_3d(sK + c * BKV * 128, &tm_k, fb, c * BOX, kt * BKV, bh);
          tma_load_3d(sV + c * BKV * 128, &tm_v, fb, c * BOX, kt * BKV, bh);
        }
        if (++stage == stages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ---- the consumer warpgroup: rows q0 .. q0 + 63
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + 16 * warp + g, row1 = row0 + 8;
  const size_t vb = (size_t)bh * L;
  const float scale_log2 = scale * LOG2E;
  const float lse2[2] = {row0 < L ? lse[vb + row0] * LOG2E : 0.0f,
                         row1 < L ? lse[vb + row1] * LOG2E : 0.0f};
  const float del[2] = {row0 < L ? delta[vb + row0] : 0.0f, row1 < L ? delta[vb + row1] : 0.0f};

  float acc[D / 2], s[BKV / 2], dp[BKV / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < BKV / 2; ++i) s[i] = dp[i] = 0.0f;
  mbar_wait(smem_u32(resident), 0);

  int stage = 0;
  uint32_t phase = 0;
  for (int kt = 0; kt < nk_hi; ++kt) {
    const int k0 = kt * BKV;
    mbar_wait(smem_u32(&full[stage]), phase);
    const uint32_t sK = ring + stage * P::STAGE_BYTES, sV = sK + P::TILE_BYTES;
    // S and dP in two commit groups: exp of S runs while dP is computed
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BKV, 0, T>(s, kmajor(sQ, BM, kk), kmajor(sK, BKV, kk), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BKV, 0, T>(dp, kmajor(sDo, BM, kk), kmajor(sV, BKV, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<1>();
    // p = exp(s scale - lse), masked (keys past L; under `causal`, keys past
    // the row) only in a tile that has such pairs
    auto probs = [&](auto masked) {
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          reg_fence(s[4 * j + e]);
          float p = fast_exp2(fmaf(s[4 * j + e], scale_log2, -lse2[e >> 1]));
          if constexpr (decltype(masked)::value) {
            const int col = k0 + 8 * j + 2 * t + (e & 1);
            if (col >= L || (causal && col > (e < 2 ? row0 : row1))) p = 0.0f;
          }
          s[4 * j + e] = p;
        }
    };
    if (k0 + BKV > L || (causal && k0 + BKV - 1 > q0))
      probs(std::true_type());
    else
      probs(std::false_type());
    wgmma_wait<0>();
    uint32_t dsa[BKV / 16][4];  // dS rounded to T: the A fragments of dS.K
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        reg_fence(dp[4 * j + e]);
        ds[e] = s[4 * j + e] * (dp[4 * j + e] - del[e >> 1]) * scale;
      }
      pack_a<T>(dsa, j, ds);
    }
    // every k16 step, key rows past L too (dS = 0 there): a step skipped
    // under a branch makes ptxas serialise the kernel's wgmma
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < BKV / 16; ++kc)
      wgmma_rs<D, 1, T>(acc, dsa[kc], mnmajor(sK, BKV, kc));
    wgmma_commit();
    wgmma_wait<0>();
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_u32(&empty[stage]));
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  }
#pragma unroll
  for (int i = 0; i < D / 2; ++i) reg_fence(acc[i]);
  store_acc<T, D>(dq + vb * D, acc, row0, L, t);
}

// dK/dV: the block owns 64 keys of head blockIdx.x (under `causal`
// the first keys, which meet the most queries, launch first); Q, dO and
// their lse and delta stream in tiles of BQ queries. The producer warp's
// lanes copy lse (times log2 e) and delta of a tile into shared memory and
// arrive on its barrier with the TMA bytes.
template <typename T, int D, int BQ>
__global__ void __launch_bounds__(BWD_THREADS, D == 64 ? 2 : 1)
    dkdv_wgmma(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
               const float* __restrict__ lse, const float* __restrict__ delta,
               T* __restrict__ dk, T* __restrict__ dv, int L, int causal, float scale,
               int stages) {
  using P = DkdvTile<D, BQ>;
  constexpr int BK = P::BK, NB = D / BOX;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sK = smem_u32(smem), sV = sK + P::RES_BYTES, ring = sV + P::RES_BYTES;
  float* ls = reinterpret_cast<float*>(smem + 2 * P::RES_BYTES + (size_t)stages * P::STAGE_BYTES);
  float* dl = ls + stages * BQ;
  uint64_t* full = reinterpret_cast<uint64_t*>(dl + stages * BQ);
  uint64_t* empty = full + stages;
  uint64_t* resident = empty + stages;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BK;
  const int nq = (L + BQ - 1) / BQ;
  const int qt_lo = causal ? k0 / BQ : 0;  // causal: the first query tile that meets these keys
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t vb = (size_t)bh * L;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(smem_u32(&full[s]), 32);  // the producer warp's lanes, one with the bytes
      mbar_init(smem_u32(&empty[s]), 4);
    }
    mbar_init(smem_u32(resident), 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4) {
    // ---- producer warp: K and V once, then Q, dO, lse, delta into the ring
    if (lane == 0) {
      prefetch_map(&tm_q);
      prefetch_map(&tm_do);
      prefetch_map(&tm_k);
      prefetch_map(&tm_v);
      const uint32_t rb = smem_u32(resident);
      mbar_expect_tx(rb, 2 * P::RES_BYTES);
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        tma_load_3d(sK + c * BK * 128, &tm_k, rb, c * BOX, k0, bh);
        tma_load_3d(sV + c * BK * 128, &tm_v, rb, c * BOX, k0, bh);
      }
    }
    int stage = 0;
    uint32_t phase = 0;
    for (int qt = qt_lo; qt < nq; ++qt) {
      const int q0 = qt * BQ;
      mbar_wait(smem_u32(&empty[stage]), phase ^ 1);
      for (int i = lane; i < BQ; i += 32) {
        ls[stage * BQ + i] = q0 + i < L ? lse[vb + q0 + i] * LOG2E : 0.0f;
        dl[stage * BQ + i] = q0 + i < L ? delta[vb + q0 + i] : 0.0f;
      }
      const uint32_t fb = smem_u32(&full[stage]);
      if (lane == 0) {
        mbar_expect_tx(fb, P::STAGE_BYTES);
        const uint32_t sQ = ring + stage * P::STAGE_BYTES, sDo = sQ + P::TILE_BYTES;
#pragma unroll
        for (int c = 0; c < NB; ++c) {
          tma_load_3d(sQ + c * BQ * 128, &tm_q, fb, c * BOX, q0, bh);
          tma_load_3d(sDo + c * BQ * 128, &tm_do, fb, c * BOX, q0, bh);
        }
      } else {
        mbar_arrive(fb);
      }
      if (++stage == stages) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // ---- the consumer warpgroup: keys k0 .. k0 + 63
  const int g = lane >> 2, t = lane & 3;
  const int key0 = k0 + 16 * warp + g, key1 = key0 + 8;
  const float scale_log2 = scale * LOG2E;

  float ak[D / 2], av[D / 2], st[BQ / 2], dpt[BQ / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) ak[i] = av[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < BQ / 2; ++i) st[i] = dpt[i] = 0.0f;
  mbar_wait(smem_u32(resident), 0);

  int stage = 0;
  uint32_t phase = 0;
  for (int qt = qt_lo; qt < nq; ++qt) {
    const int q0 = qt * BQ;
    mbar_wait(smem_u32(&full[stage]), phase);
    const uint32_t sQ = ring + stage * P::STAGE_BYTES, sDo = sQ + P::TILE_BYTES;
    // four commit groups, so that the exp of S^T runs under dP^T and dS^T
    // under dV's product
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BQ, 0, T>(st, kmajor(sK, BK, kk), kmajor(sQ, BQ, kk), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BQ, 0, T>(dpt, kmajor(sV, BK, kk), kmajor(sDo, BQ, kk), kk > 0);
    wgmma_commit();
    const float* lsv = ls + stage * BQ;
    const float* dlv = dl + stage * BQ;
    wgmma_wait<1>();
    // p^T = exp(s^T scale - lse), masked (keys or queries past L; under
    // `causal`, queries before the key) only in a tile that has such pairs.
    // Padded query rows are masked here, not left to an underflow.
    uint32_t pa[BQ / 16][4], dsa[BQ / 16][4];  // P^T and dS^T rounded to T
    auto probs = [&](auto masked) {
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(lsv + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          reg_fence(st[4 * j + e]);
          float p = fast_exp2(fmaf(st[4 * j + e], scale_log2, -((e & 1) ? l2.y : l2.x)));
          if constexpr (decltype(masked)::value) {
            const int qpos = q0 + 8 * j + 2 * t + (e & 1);
            const int key = e < 2 ? key0 : key1;
            if (key >= L || qpos >= L || (causal && qpos < key)) p = 0.0f;
          }
          st[4 * j + e] = p;
        }
        pack_a<T>(pa, j, st + 4 * j);
      }
    };
    if (k0 + BK > L || q0 + BQ > L || (causal && q0 < k0 + BK - 1))
      probs(std::true_type());
    else
      probs(std::false_type());
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < BQ / 16; ++kc)
      wgmma_rs<D, 1, T>(av, pa[kc], mnmajor(sDo, BQ, kc));  // dV += P^T dO
    wgmma_commit();
    wgmma_wait<1>();  // dP^T
    // dS^T = p^T (dP^T - delta) scale: 0 wherever p^T was masked (dP^T is
    // finite there: K, V, Q and dO rows past L read zeros)
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const float2 d2 = *reinterpret_cast<const float2*>(dlv + 8 * j + 2 * t);
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        reg_fence(dpt[4 * j + e]);
        ds[e] = st[4 * j + e] * (dpt[4 * j + e] - ((e & 1) ? d2.y : d2.x)) * scale;
      }
      pack_a<T>(dsa, j, ds);
    }
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < BQ / 16; ++kc)
      wgmma_rs<D, 1, T>(ak, dsa[kc], mnmajor(sQ, BQ, kc));  // dK += dS^T Q
    wgmma_commit();
    wgmma_wait<0>();
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_u32(&empty[stage]));
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  }
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    reg_fence(ak[i]);
    reg_fence(av[i]);
  }
  store_acc<T, D>(dk + vb * D, ak, key0, L, t);
  store_acc<T, D>(dv + vb * D, av, key0, L, t);
}

// ------------------------------------------------------------- fp32 path
// One thread per row of the block's 64; rows a thread owns sit in shared
// memory with a stride of D + 1 (conflict-free), the streamed tile with a
// stride of D (every thread reads the same element: a broadcast).

constexpr int SUB = 16;  // keys per online-softmax step of the fp32 forward

template <int D>
__device__ __forceinline__ void load_f32(float* dst, int ld, const float* src, int r0, int L) {
  for (int i = threadIdx.x; i < BT * D; i += blockDim.x) {
    const int r = i / D, c = i % D;
    dst[r * ld + c] = r0 + r < L ? src[(size_t)(r0 + r) * D + c] : 0.0f;
  }
}

template <int D>
__device__ __forceinline__ float dot_f32(const float* a, const float* b) {
  float acc = 0.0f;
#pragma unroll
  for (int c = 0; c < D; ++c) acc = fmaf(a[c], b[c], acc);
  return acc;
}

template <int D>
__global__ void __launch_bounds__(BT)
    fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse, int L,
            int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);  // [64][D + 1]
  float* Ks = Qs + BT * (D + 1);               // [64][D]
  float* Vs = Ks + BT * D;                     // [64][D]
  const size_t base = (size_t)blockIdx.y * L * D;
  q += base, k += base, v += base, o += base;
  lse += (size_t)blockIdx.y * L;
  const int q0 = blockIdx.x * BT, row = q0 + threadIdx.x;
  const float* qr = Qs + threadIdx.x * (D + 1);
  load_f32<D>(Qs, D + 1, q, q0, L);

  float m = NEG_BIG, l = 0.0f, acc[D];
#pragma unroll
  for (int c = 0; c < D; ++c) acc[c] = 0.0f;
  const int nk = (L + BT - 1) / BT;
  const int nk_hi = causal ? min(nk, (q0 + 2 * BT - 1) / BT) : nk;
  for (int kt = 0; kt < nk_hi; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();
    load_f32<D>(Ks, D, k, k0, L);
    load_f32<D>(Vs, D, v, k0, L);
    __syncthreads();
    for (int j0 = 0; j0 < BT; j0 += SUB) {
      float s[SUB], mx = m;
#pragma unroll
      for (int j = 0; j < SUB; ++j) {
        const int col = k0 + j0 + j;
        float x = dot_f32<D>(qr, Ks + (j0 + j) * D) * scale;
        if (col >= L || (causal && col > row)) x = NEG_BIG;
        s[j] = x;
        mx = fmaxf(mx, x);
      }
      const float corr = expf(m - mx);
      float rs = 0.0f;
      m = mx;
#pragma unroll
      for (int j = 0; j < SUB; ++j) {
        s[j] = expf(s[j] - m);
        rs += s[j];
      }
      l = corr * l + rs;
#pragma unroll
      for (int c = 0; c < D; ++c) {
        float a = acc[c] * corr;
#pragma unroll
        for (int j = 0; j < SUB; ++j) a = fmaf(s[j], Vs[(j0 + j) * D + c], a);
        acc[c] = a;
      }
    }
  }
  if (row < L) {
    const float ls = fmaxf(l, 1e-30f);
#pragma unroll
    for (int c = 0; c < D; ++c) o[(size_t)row * D + c] = acc[c] / ls;
    lse[row] = m + logf(ls);
  }
}

template <int D>
__global__ void __launch_bounds__(BT)
    dq_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
           const float* __restrict__ dout, const float* __restrict__ lse,
           const float* __restrict__ delta, float* __restrict__ dq, int L, int causal,
           float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);  // [64][D + 1]
  float* Ds = Qs + BT * (D + 1);               // dO [64][D + 1]
  float* Ks = Ds + BT * (D + 1);               // [64][D]
  float* Vs = Ks + BT * D;                     // [64][D]
  const size_t base = (size_t)blockIdx.y * L * D;
  q += base, k += base, v += base, dout += base, dq += base;
  lse += (size_t)blockIdx.y * L;
  delta += (size_t)blockIdx.y * L;
  const int q0 = blockIdx.x * BT, row = q0 + threadIdx.x;
  const float* qr = Qs + threadIdx.x * (D + 1);
  const float* dr = Ds + threadIdx.x * (D + 1);
  const float lse_r = row < L ? lse[row] : 0.0f, del_r = row < L ? delta[row] : 0.0f;
  load_f32<D>(Qs, D + 1, q, q0, L);
  load_f32<D>(Ds, D + 1, dout, q0, L);

  float acc[D];
#pragma unroll
  for (int c = 0; c < D; ++c) acc[c] = 0.0f;
  const int nk = (L + BT - 1) / BT;
  const int nk_hi = causal ? min(nk, (q0 + 2 * BT - 1) / BT) : nk;
  for (int kt = 0; kt < nk_hi; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();
    load_f32<D>(Ks, D, k, k0, L);
    load_f32<D>(Vs, D, v, k0, L);
    __syncthreads();
    for (int j = 0; j < BT; ++j) {
      const int col = k0 + j;
      if (col >= L || (causal && col > row)) continue;  // p = 0: adds nothing
      const float p = expf(dot_f32<D>(qr, Ks + j * D) * scale - lse_r);
      const float ds = p * (dot_f32<D>(dr, Vs + j * D) - del_r) * scale;
#pragma unroll
      for (int c = 0; c < D; ++c) acc[c] = fmaf(ds, Ks[j * D + c], acc[c]);
    }
  }
  if (row < L) {
#pragma unroll
    for (int c = 0; c < D; ++c) dq[(size_t)row * D + c] = acc[c];
  }
}

template <int D>
__global__ void __launch_bounds__(BT)
    dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             float* __restrict__ dk, float* __restrict__ dv, int L, int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);  // [64][D + 1]
  float* Vs = Ks + BT * (D + 1);               // [64][D + 1]
  float* Qs = Vs + BT * (D + 1);               // [64][D]
  float* Ds = Qs + BT * D;                     // dO [64][D]
  float* ls = Ds + BT * D;                     // [64]
  float* dl = ls + BT;                         // [64]
  const size_t base = (size_t)blockIdx.y * L * D;
  q += base, k += base, v += base, dout += base, dk += base, dv += base;
  lse += (size_t)blockIdx.y * L;
  delta += (size_t)blockIdx.y * L;
  const int k0 = blockIdx.x * BT, key = k0 + threadIdx.x;
  const float* kr = Ks + threadIdx.x * (D + 1);
  const float* vr = Vs + threadIdx.x * (D + 1);
  load_f32<D>(Ks, D + 1, k, k0, L);
  load_f32<D>(Vs, D + 1, v, k0, L);

  float ak[D], av[D];
#pragma unroll
  for (int c = 0; c < D; ++c) ak[c] = av[c] = 0.0f;
  const int nq = (L + BT - 1) / BT;
  for (int qt = causal ? k0 / BT : 0; qt < nq; ++qt) {
    const int q0 = qt * BT;
    __syncthreads();
    load_f32<D>(Qs, D, q, q0, L);
    load_f32<D>(Ds, D, dout, q0, L);
    for (int i = threadIdx.x; i < BT; i += blockDim.x) {
      ls[i] = q0 + i < L ? lse[q0 + i] : 0.0f;
      dl[i] = q0 + i < L ? delta[q0 + i] : 0.0f;
    }
    __syncthreads();
    for (int r = 0; r < BT; ++r) {
      const int qpos = q0 + r;
      if (key >= L || qpos >= L || (causal && qpos < key)) continue;  // p = 0
      const float p = expf(dot_f32<D>(kr, Qs + r * D) * scale - ls[r]);
      const float ds = p * (dot_f32<D>(vr, Ds + r * D) - dl[r]) * scale;
#pragma unroll
      for (int c = 0; c < D; ++c) {
        av[c] = fmaf(p, Ds[r * D + c], av[c]);
        ak[c] = fmaf(ds, Qs[r * D + c], ak[c]);
      }
    }
  }
  if (key < L) {
#pragma unroll
    for (int c = 0; c < D; ++c) {
      dk[(size_t)key * D + c] = ak[c];
      dv[(size_t)key * D + c] = av[c];
    }
  }
}

// ------------------------------------------------------------------ host

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int D>
constexpr size_t f32_own_bytes() {
  return (size_t)BT * (D + 1) * sizeof(float);
}
template <int D>
constexpr size_t f32_tile_bytes() {
  return (size_t)BT * D * sizeof(float);
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse_in, *delta;
  void *o, *dq, *dk, *dv;
  float* lse;
  int BH, L, causal;
  float scale;
  cudaStream_t stream;
  int bq, stages;  // dK/dV's plan (the wrapper's bwd_plan), or the forward's ring stages
  int wg, kt;      // the forward's consumer warpgroups and key tile (the wrapper's fwd_plan)
};

template <int D>
int fwd32(const Args& a) {
  const size_t smem = f32_own_bytes<D>() + 2 * f32_tile_bytes<D>();
  cudaError_t e = set_smem(fwd_f32<D>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.L + BT - 1) / BT, a.BH);
  fwd_f32<D><<<grid, BT, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.lse, a.L, a.causal, a.scale);
  return (int)cudaGetLastError();
}

template <int D>
int dq32(const Args& a) {
  const size_t smem = 2 * f32_own_bytes<D>() + 2 * f32_tile_bytes<D>();
  cudaError_t e = set_smem(dq_f32<D>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.L + BT - 1) / BT, a.BH);
  dq_f32<D><<<grid, BT, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse_in, a.delta,
      static_cast<float*>(a.dq), a.L, a.causal, a.scale);
  return (int)cudaGetLastError();
}

template <int D>
int dkdv32(const Args& a) {
  const size_t smem = 2 * f32_own_bytes<D>() + 2 * f32_tile_bytes<D>() + 2 * BT * sizeof(float);
  cudaError_t e = set_smem(dkdv_f32<D>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.L + BT - 1) / BT, a.BH);
  dkdv_f32<D><<<grid, BT, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse_in, a.delta,
      static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.L, a.causal, a.scale);
  return (int)cudaGetLastError();
}

constexpr int DQ_STAGES = 2;  // dQ's K/V ring (fewer where the sequence has fewer tiles)

// [BH, L, D] 16-bit as a 3-D tensor map, read in boxes of [1, rows, 64]
bool head_map(CUtensorMap* map, const void* base, int dtype, const Args& a, int D, int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)a.L, (cuuint64_t)a.BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)a.L * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)BOX, (cuuint32_t)rows, 1};
  return swizzled_map(map,
                      dtype == DT_F16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                      : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                      3, base, dims, strides, box);
}

template <typename T, int D, int NWG, int KT>
int fwd_tma(const Args& a, int dtype) {
  using P = FwdTile<D, NWG, KT>;
  static std::atomic<unsigned> raised{0};
  const size_t smem = P::smem(a.stages);
  const unsigned tiles = (a.L + P::BM - 1) / P::BM;
  if (a.stages < 1 || smem > (size_t)MAX_SMEM || tiles > 65535) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  if (!head_map(&tq, a.q, dtype, a, D, 64) || !head_map(&tk, a.k, dtype, a, D, KT) ||
      !head_map(&tv, a.v, dtype, a, D, KT))
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = raise_smem_once(fwd_wgmma<T, D, NWG, KT>, MAX_SMEM, dev, raised);
  if (e != cudaSuccess) return (int)e;
  fwd_wgmma<T, D, NWG, KT><<<dim3(a.BH, tiles), P::THREADS, smem, a.stream>>>(
      tq, tk, tv, static_cast<T*>(a.o), a.lse, a.L, a.causal, a.scale, a.stages);
  return (int)cudaGetLastError();
}

// The 16-bit forward with the wrapper's plan: one or two consumer
// warpgroups with key tiles of 64, or one with 128 at D 64; the ring's
// stages. D 32 is not taken: the wrapper pads it to 64.
template <typename T, int D>
int fwd16(const Args& a, int dtype) {
  if constexpr (D == 32) {
    return -1;
  } else {
    if (a.kt == 64 && a.wg == 1) return fwd_tma<T, D, 1, 64>(a, dtype);
    if (a.kt == 64 && a.wg == 2) return fwd_tma<T, D, 2, 64>(a, dtype);
    if constexpr (D == 64) {
      if (a.kt == 128 && a.wg == 1) return fwd_tma<T, D, 1, 128>(a, dtype);
    }
    return (int)cudaErrorInvalidValue;
  }
}

template <typename T, int D>
int dq_tma(const Args& a, int dtype) {
  using P = DqTile<D>;
  static std::atomic<unsigned> raised{0};
  const int key_tiles = (a.L + BKV - 1) / BKV;
  const int stages = key_tiles < DQ_STAGES ? key_tiles : DQ_STAGES;
  const size_t smem = P::smem(stages);
  const unsigned tiles = (a.L + P::BM - 1) / P::BM;
  if (stages < 1 || smem > (size_t)MAX_SMEM || tiles > 65535) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv, tdo;
  if (!head_map(&tq, a.q, dtype, a, D, P::BM) || !head_map(&tdo, a.dout, dtype, a, D, P::BM) ||
      !head_map(&tk, a.k, dtype, a, D, BKV) || !head_map(&tv, a.v, dtype, a, D, BKV))
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = raise_smem_once(dq_wgmma<T, D>, MAX_SMEM, dev, raised);
  if (e != cudaSuccess) return (int)e;
  dq_wgmma<T, D><<<dim3(a.BH, tiles), BWD_THREADS, smem, a.stream>>>(
      tq, tk, tv, tdo, a.lse_in, a.delta, static_cast<T*>(a.dq), a.L, a.causal, a.scale,
      stages);
  return (int)cudaGetLastError();
}

template <typename T, int D, int BQ>
int dkdv_tma(const Args& a, int dtype, int stages) {
  using P = DkdvTile<D, BQ>;
  static std::atomic<unsigned> raised{0};
  const size_t smem = P::smem(stages);
  const unsigned tiles = (a.L + P::BK - 1) / P::BK;
  if (stages < 1 || smem > (size_t)MAX_SMEM || tiles > 65535) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv, tdo;
  if (!head_map(&tq, a.q, dtype, a, D, BQ) || !head_map(&tdo, a.dout, dtype, a, D, BQ) ||
      !head_map(&tk, a.k, dtype, a, D, P::BK) || !head_map(&tv, a.v, dtype, a, D, P::BK))
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = raise_smem_once(dkdv_wgmma<T, D, BQ>, MAX_SMEM, dev, raised);
  if (e != cudaSuccess) return (int)e;
  dkdv_wgmma<T, D, BQ><<<dim3(a.BH, tiles), BWD_THREADS, smem, a.stream>>>(
      tq, tk, tv, tdo, a.lse_in, a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.L,
      a.causal, a.scale, stages);
  return (int)cudaGetLastError();
}

// The 16-bit backward: the TMA + wgmma kernels at D 64 and 128, dK/dV with
// the wrapper's plan (bq queries a stage: 32, or 64 at D 64; the ring's
// stages). D 32 is not taken: the wrapper pads it to 64.
template <typename T, int D>
int bwd16(int kind, const Args& a, int dtype) {
  if constexpr (D == 32) {
    return -1;
  } else {
    if (kind == 1) return dq_tma<T, D>(a, dtype);
    if (a.bq == 32) return dkdv_tma<T, D, 32>(a, dtype, a.stages);
    if constexpr (D == 64) {
      if (a.bq == 64) return dkdv_tma<T, D, 64>(a, dtype, a.stages);
    }
    return (int)cudaErrorInvalidValue;
  }
}

// kind: 0 forward, 1 dQ, 2 dK/dV
template <int D>
int dispatch_d(int kind, int dtype, const Args& a) {
  switch (dtype) {
    case DT_BF16:
      return kind == 0 ? fwd16<__nv_bfloat16, D>(a, dtype) : bwd16<__nv_bfloat16, D>(kind, a, dtype);
    case DT_F16:
      return kind == 0 ? fwd16<__half, D>(a, dtype) : bwd16<__half, D>(kind, a, dtype);
    case DT_F32:
      return kind == 0 ? fwd32<D>(a) : kind == 1 ? dq32<D>(a) : dkdv32<D>(a);
    default:
      return -1;
  }
}

int dispatch(int kind, int D, int dtype, const Args& a) {
  if (a.BH <= 0 || a.BH > 65535 || a.L <= 0) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 32:
      return dispatch_d<32>(kind, dtype, a);
    case 64:
      return dispatch_d<64>(kind, dtype, a);
    case 128:
      return dispatch_d<128>(kind, dtype, a);
    default:
      return -1;
  }
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each launches on `stream`, does
// not synchronise, allocates nothing, and returns the launch's cudaError_t
// (0 on success; -1 for a dtype or head dim the kernels do not take). The
// forward and dK/dV entry points take the wrapper's plans (ops/cuda/
// flash_attention.py `fwd_plan`, `bwd_plan`), read by the 16-bit bodies:
// the forward's consumer warpgroups `wg`, key tile `kt` and ring `stages`
// (the 16-bit forward takes scale >= 0 only); dK/dV's query tile `bq` and
// ring `stages`.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v, void* o, void* lse,
                                int BH, int L, int D, int dtype, int causal, float scale, int wg,
                                int kt, int stages, void* stream) {
  if (dtype != DT_F32 && scale < 0.0f) return (int)cudaErrorInvalidValue;
  Args a{q, k, v, nullptr, nullptr, nullptr, o, nullptr, nullptr, nullptr,
         static_cast<float*>(lse), BH, L, causal, scale,
         reinterpret_cast<cudaStream_t>(stream), 0, stages, wg, kt};
  return dispatch(0, D, dtype, a);
}

extern "C" int flash_dq_launch(const void* q, const void* k, const void* v, const void* dout,
                               const void* lse, const void* delta, void* dq, int BH, int L,
                               int D, int dtype, int causal, float scale, void* stream) {
  Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
         nullptr, dq, nullptr, nullptr, nullptr, BH, L, causal, scale,
         reinterpret_cast<cudaStream_t>(stream)};
  return dispatch(1, D, dtype, a);
}

extern "C" int flash_dkdv_launch(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dk, void* dv, int BH,
                                 int L, int D, int dtype, int causal, float scale, int bq,
                                 int stages, void* stream) {
  Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
         nullptr, nullptr, dk, dv, nullptr, BH, L, causal, scale,
         reinterpret_cast<cudaStream_t>(stream), bq, stages};
  return dispatch(2, D, dtype, a);
}
