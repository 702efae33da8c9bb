// Flash attention for Hopper (sm_90a): forward, dQ and dK/dV.
//
// Replaces the three Pallas kernels of distribuuuu_tpu/ops/flash_attention.py:
//   * _fwd_kernel  (reached through _flash_forward, :315)  -> flash_fwd_launch
//   * _dq_kernel   (reached through _flash_backward, :359) -> flash_dq_launch
//   * _dkdv_kernel (reached through _flash_backward, :372) -> flash_dkdv_launch
// on q, k, v, dO of [BH, L, D] (contiguous, D in {32, 64, 128}; the wrapper
// zero-pads any other D <= 128), lse and delta of [BH, L] in fp32.
//
//   forward:  o = softmax(q k^T * scale) v,  lse = m + log(l)   (online softmax)
//   dQ:       p = exp(s - lse), ds = p (dO v^T - delta) scale,  dq = ds k
//   dK/dV:    dv = p^T dO,  dk = ds^T q   (computed as s^T = k q^T)
//
// with keys past L masked, and under `causal` keys past the query row. The
// rounding points are the Pallas bodies': p is rounded to the input dtype
// before p.v and p^T.dO, ds before ds.k and ds^T.q; everything else is fp32.
//
// What bounds it on the H100: at the ViT-S/16 training shape [32*6, 196, 64]
// a call does about 2 GFLOP over 20-30 MB, under the ~295 operations per
// byte the tensor cores need, so it is bound by bytes (about 6-9 us at
// 3.35 TB/s). At ViT-Ti/16 on 1024^2 inputs ([4*3, 4096, 64]) a call does
// 51-103 GFLOP over a few MB: bound by the tensor cores (50-100 us at 989
// TFLOP/s). The design keeps the L x L scores and probabilities out of
// device memory entirely (each lives in registers for one 64 x 64 tile),
// which is what both regimes need; reaching the tensor-core rate needs
// wgmma, TMA and warp specialisation, which are a later change.
//
// Design (right and simple first):
//  * a block of 4 warps owns 64 query rows (forward, dQ) or 64 keys
//    (dK/dV) of one (batch, head); each warp 16 of them. The other side is
//    streamed from device memory through shared memory in tiles of 64, so
//    any L runs (the TPU kernels kept whole-sequence K/V in VMEM);
//  * bf16/f16: S = Q.K^T and the other products on mma.sync.m16n8k16 with
//    fp32 accumulators; the accumulator layout of one product is the A
//    operand layout of the next, so P and dS never leave registers. B
//    operands that need the other orientation are stored transposed in
//    shared memory when the tile is loaded;
//  * fp32: the same tiling on the CUDA cores (fp32 FMA, no TF32), one thread
//    per query row (forward, dQ) or key row (dK/dV);
//  * no atomics: dQ and dK/dV are two kernels, each owning its output rows.
//    Query rows past L contribute exactly 0 to dK/dV (masked explicitly).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int BT = 64;  // rows of a block's own tile, and of a streamed tile
constexpr int THREADS = 128;  // 4 warps x 16 rows (mma path)
constexpr int PAD = 8;  // 16-byte row padding of 16-bit tiles: conflict-free fragments
constexpr int TLD = BT + PAD;  // row stride of a transposed [D][64] tile
constexpr float NEG_BIG = -0.7f * FLT_MAX;

enum DType { DT_F32 = 0, DT_BF16 = 1, DT_F16 = 2 };

// ------------------------------------------------------------ 16-bit types

template <typename T>
struct Ops;

template <>
struct Ops<__nv_bfloat16> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a, const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  // two floats rounded to the type, `lo` in the low 16 bits
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

template <>
struct Ops<__half> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a, const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

template <typename T>
__device__ __forceinline__ uint32_t ld32(const T* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Copy rows r0..r0+63 of a row-major [L, D] slab into shared memory, as a
// row-major [64][D + PAD] tile (ROW) and/or a transposed [D][TLD] tile
// (TRANS); rows past L are zero.
template <typename T, int D, bool ROW, bool TRANS>
__device__ __forceinline__ void load_tile(T* row, T* tr, const T* src, int r0, int L) {
  constexpr int CH = D / 8;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < BT * CH; i += blockDim.x) {
    const int r = i / CH, c = (i % CH) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < L) v = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * D + c);
    if (ROW) *reinterpret_cast<uint4*>(row + r * (D + PAD) + c) = v;
    if (TRANS) {
      const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
      for (int j = 0; j < 8; ++j) tr[(c + j) * TLD + r] = e[j];
    }
  }
}

// mma.m16n8k16 fragments (PTX ISA, g = lane / 4, t = lane % 4).
// A (16 x 16, row-major in shared memory at rows m0.., columns k0..).
template <typename T>
__device__ __forceinline__ void frag_a(uint32_t* a, const T* s, int ld, int m0, int k0, int g,
                                       int t) {
  a[0] = ld32(s + (m0 + g) * ld + k0 + 2 * t);
  a[1] = ld32(s + (m0 + g + 8) * ld + k0 + 2 * t);
  a[2] = ld32(s + (m0 + g) * ld + k0 + 2 * t + 8);
  a[3] = ld32(s + (m0 + g + 8) * ld + k0 + 2 * t + 8);
}

// B (16 x 8) from a tile stored [n][k]: B[k][n] = s[(n0 + n) * ld + k0 + k].
template <typename T>
__device__ __forceinline__ void frag_b(uint32_t* b, const T* s, int ld, int n0, int k0, int g,
                                       int t) {
  b[0] = ld32(s + (n0 + g) * ld + k0 + 2 * t);
  b[1] = ld32(s + (n0 + g) * ld + k0 + 2 * t + 8);
}

// The A fragment of columns 16*kc.. of a 16 x 64 accumulator held as eight
// 16 x 8 tiles: c0,c1 at (g, 2t..2t+1), c2,c3 at (g + 8, 2t..2t+1).
template <typename T>
__device__ __forceinline__ void acc_to_a(uint32_t* a, const float (*c)[4], int kc) {
  a[0] = Ops<T>::pack(c[2 * kc][0], c[2 * kc][1]);
  a[1] = Ops<T>::pack(c[2 * kc][2], c[2 * kc][3]);
  a[2] = Ops<T>::pack(c[2 * kc + 1][0], c[2 * kc + 1][1]);
  a[3] = Ops<T>::pack(c[2 * kc + 1][2], c[2 * kc + 1][3]);
}

// Store a warp's 16 x D fp32 accumulator (rows row0 and row0 + 8 of this
// thread) as T, rows past L skipped.
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* out, const float (*acc)[4], int row0, int L, int t,
                                           float div0, float div1) {
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int col = nd * 8 + 2 * t;
    if (row0 < L)
      *reinterpret_cast<uint32_t*>(out + (size_t)row0 * D + col) =
          Ops<T>::pack(acc[nd][0] / div0, acc[nd][1] / div0);
    if (row0 + 8 < L)
      *reinterpret_cast<uint32_t*>(out + (size_t)(row0 + 8) * D + col) =
          Ops<T>::pack(acc[nd][2] / div1, acc[nd][3] / div1);
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ------------------------------------------------------- forward, mma path

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    fwd_mma(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            T* __restrict__ o, float* __restrict__ lse, int L, int causal, float scale) {
  constexpr int LD = D + PAD;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);  // [64][LD]
  T* Ks = Qs + BT * LD;                // [64][LD]
  T* Vt = Ks + BT * LD;                // [D][TLD]

  const size_t base = (size_t)blockIdx.y * L * D;
  q += base, k += base, v += base, o += base;
  lse += (size_t)blockIdx.y * L;
  const int q0 = blockIdx.x * BT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;
  const int row0 = q0 + wr + g, row1 = row0 + 8;

  load_tile<T, D, true, false>(Qs, nullptr, q, q0, L);
  __syncthreads();
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) frag_a(qa[kc], Qs, LD, wr, kc * 16, g, t);

  float m[2] = {NEG_BIG, NEG_BIG}, l[2] = {0.0f, 0.0f};
  float acc[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.0f;

  const int nk = (L + BT - 1) / BT;
  const int nk_hi = causal ? min(nk, (q0 + 2 * BT - 1) / BT) : nk;  // causal block skip
  for (int kt = 0; kt < nk_hi; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D, true, false>(Ks, nullptr, k, k0, L);
    load_tile<T, D, false, true>(nullptr, Vt, v, k0, L);
    __syncthreads();

    float s[BT / 8][4];
#pragma unroll
    for (int nt = 0; nt < BT / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc)
#pragma unroll
      for (int nt = 0; nt < BT / 8; ++nt) {
        uint32_t b[2];
        frag_b(b, Ks, LD, nt * 8, kc * 16, g, t);
        Ops<T>::mma(s[nt], qa[kc], b);
      }

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < BT / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + 2 * t + (e & 1);
        const int row = (e < 2) ? row0 : row1;
        float x = s[nt][e] * scale;
        if (col >= L || (causal && col > row)) x = NEG_BIG;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      corr[r] = expf(m[r] - mx[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int nt = 0; nt < BT / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[nt][e] - m[e >> 1]);
        s[nt][e] = p;
        rs[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = corr[r] * l[r] + rs[r];  // this thread's share of the row
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      acc[nd][0] *= corr[0];
      acc[nd][1] *= corr[0];
      acc[nd][2] *= corr[1];
      acc[nd][3] *= corr[1];
    }
#pragma unroll
    for (int kc = 0; kc < BT / 16; ++kc) {
      uint32_t pa[4];
      acc_to_a<T>(pa, s, kc);  // p rounded to the input dtype, as the Pallas body
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        uint32_t b[2];
        frag_b(b, Vt, TLD, nd * 8, kc * 16, g, t);
        Ops<T>::mma(acc[nd], pa, b);
      }
    }
  }

  const float ls0 = fmaxf(quad_sum(l[0]), 1e-30f), ls1 = fmaxf(quad_sum(l[1]), 1e-30f);
  store_rows<T, D>(o, acc, row0, L, t, ls0, ls1);
  if (t == 0) {
    if (row0 < L) lse[row0] = m[0] + logf(ls0);
    if (row1 < L) lse[row1] = m[1] + logf(ls1);
  }
}

// ------------------------------------------------------------ dQ, mma path

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    dq_mma(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const T* __restrict__ dout, const float* __restrict__ lse,
           const float* __restrict__ delta, T* __restrict__ dq, int L, int causal, float scale) {
  constexpr int LD = D + PAD;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);  // [64][LD]
  T* Ds = Qs + BT * LD;                // dO [64][LD]
  T* Ks = Ds + BT * LD;                // [64][LD]
  T* Vs = Ks + BT * LD;                // [64][LD]
  T* Kt = Vs + BT * LD;                // [D][TLD]

  const size_t base = (size_t)blockIdx.y * L * D;
  q += base, k += base, v += base, dout += base, dq += base;
  lse += (size_t)blockIdx.y * L;
  delta += (size_t)blockIdx.y * L;
  const int q0 = blockIdx.x * BT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;
  const int row0 = q0 + wr + g, row1 = row0 + 8;
  const float lse_r[2] = {row0 < L ? lse[row0] : 0.0f, row1 < L ? lse[row1] : 0.0f};
  const float del_r[2] = {row0 < L ? delta[row0] : 0.0f, row1 < L ? delta[row1] : 0.0f};

  load_tile<T, D, true, false>(Qs, nullptr, q, q0, L);
  load_tile<T, D, true, false>(Ds, nullptr, dout, q0, L);

  float acc[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.0f;

  const int nk = (L + BT - 1) / BT;
  const int nk_hi = causal ? min(nk, (q0 + 2 * BT - 1) / BT) : nk;
  for (int kt = 0; kt < nk_hi; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();
    load_tile<T, D, true, true>(Ks, Kt, k, k0, L);
    load_tile<T, D, true, false>(Vs, nullptr, v, k0, L);
    __syncthreads();

    float s[BT / 8][4], dp[BT / 8][4];
#pragma unroll
    for (int nt = 0; nt < BT / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.0f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t qa[4], da[4];
      frag_a(qa, Qs, LD, wr, kc * 16, g, t);
      frag_a(da, Ds, LD, wr, kc * 16, g, t);
#pragma unroll
      for (int nt = 0; nt < BT / 8; ++nt) {
        uint32_t b[2];
        frag_b(b, Ks, LD, nt * 8, kc * 16, g, t);
        Ops<T>::mma(s[nt], qa, b);
        frag_b(b, Vs, LD, nt * 8, kc * 16, g, t);
        Ops<T>::mma(dp[nt], da, b);
      }
    }
#pragma unroll
    for (int nt = 0; nt < BT / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + 2 * t + (e & 1);
        const int row = (e < 2) ? row0 : row1;
        const bool keep = col < L && !(causal && col > row);
        const float p = keep ? expf(s[nt][e] * scale - lse_r[e >> 1]) : 0.0f;
        s[nt][e] = p * (dp[nt][e] - del_r[e >> 1]) * scale;  // ds
      }
#pragma unroll
    for (int kc = 0; kc < BT / 16; ++kc) {
      uint32_t dsa[4];
      acc_to_a<T>(dsa, s, kc);  // ds rounded to the input dtype
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        uint32_t b[2];
        frag_b(b, Kt, TLD, nd * 8, kc * 16, g, t);
        Ops<T>::mma(acc[nd], dsa, b);
      }
    }
  }
  store_rows<T, D>(dq, acc, row0, L, t, 1.0f, 1.0f);
}

// --------------------------------------------------------- dK/dV, mma path

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    dkdv_mma(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const T* __restrict__ dout, const float* __restrict__ lse,
             const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int L,
             int causal, float scale) {
  constexpr int LD = D + PAD;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);  // [64][LD]
  T* Vs = Ks + BT * LD;                // [64][LD]
  T* Qs = Vs + BT * LD;                // [64][LD]
  T* Ds = Qs + BT * LD;                // dO [64][LD]
  T* Qt = Ds + BT * LD;                // [D][TLD]
  T* Dt = Qt + D * TLD;                // dO^T [D][TLD]
  float* ls = reinterpret_cast<float*>(Dt + D * TLD);  // lse [64]
  float* dl = ls + BT;                                 // delta [64]

  const size_t base = (size_t)blockIdx.y * L * D;
  q += base, k += base, v += base, dout += base, dk += base, dv += base;
  lse += (size_t)blockIdx.y * L;
  delta += (size_t)blockIdx.y * L;
  const int k0 = blockIdx.x * BT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;
  const int key0 = k0 + wr + g, key1 = key0 + 8;

  load_tile<T, D, true, false>(Ks, nullptr, k, k0, L);
  load_tile<T, D, true, false>(Vs, nullptr, v, k0, L);

  float ak[D / 8][4], av[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) ak[nd][e] = av[nd][e] = 0.0f;

  const int nq = (L + BT - 1) / BT;
  const int qt_lo = causal ? k0 / BT : 0;  // causal: the first q tile that meets this key tile
  for (int qt = qt_lo; qt < nq; ++qt) {
    const int q0 = qt * BT;
    __syncthreads();
    load_tile<T, D, true, true>(Qs, Qt, q, q0, L);
    load_tile<T, D, true, true>(Ds, Dt, dout, q0, L);
    for (int i = threadIdx.x; i < BT; i += blockDim.x) {
      ls[i] = q0 + i < L ? lse[q0 + i] : 0.0f;
      dl[i] = q0 + i < L ? delta[q0 + i] : 0.0f;
    }
    __syncthreads();

    float st[BT / 8][4], dpt[BT / 8][4];
#pragma unroll
    for (int nt = 0; nt < BT / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.0f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t ka[4], va[4];
      frag_a(ka, Ks, LD, wr, kc * 16, g, t);
      frag_a(va, Vs, LD, wr, kc * 16, g, t);
#pragma unroll
      for (int nt = 0; nt < BT / 8; ++nt) {
        uint32_t b[2];
        frag_b(b, Qs, LD, nt * 8, kc * 16, g, t);
        Ops<T>::mma(st[nt], ka, b);  // s^T = k q^T
        frag_b(b, Ds, LD, nt * 8, kc * 16, g, t);
        Ops<T>::mma(dpt[nt], va, b);  // dp^T = v dO^T
      }
    }
#pragma unroll
    for (int nt = 0; nt < BT / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = nt * 8 + 2 * t + (e & 1);
        const int qpos = q0 + qi, key = (e < 2) ? key0 : key1;
        // padded query rows are masked here, not left to an underflow
        const bool keep = key < L && qpos < L && !(causal && qpos < key);
        const float p = keep ? expf(st[nt][e] * scale - ls[qi]) : 0.0f;
        st[nt][e] = p;
        dpt[nt][e] = keep ? p * (dpt[nt][e] - dl[qi]) * scale : 0.0f;  // ds^T
      }
#pragma unroll
    for (int kc = 0; kc < BT / 16; ++kc) {
      uint32_t pa[4], dsa[4];
      acc_to_a<T>(pa, st, kc);
      acc_to_a<T>(dsa, dpt, kc);
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        uint32_t b[2];
        frag_b(b, Dt, TLD, nd * 8, kc * 16, g, t);
        Ops<T>::mma(av[nd], pa, b);  // dv += p^T dO
        frag_b(b, Qt, TLD, nd * 8, kc * 16, g, t);
        Ops<T>::mma(ak[nd], dsa, b);  // dk += ds^T q
      }
    }
  }
  store_rows<T, D>(dk, ak, key0, L, t, 1.0f, 1.0f);
  store_rows<T, D>(dv, av, key0, L, t, 1.0f, 1.0f);
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

template <typename T, int D>
constexpr size_t mma_tile_bytes() {
  return (size_t)BT * (D + PAD) * sizeof(T);
}
template <typename T, int D>
constexpr size_t mma_trans_bytes() {
  return (size_t)D * TLD * sizeof(T);
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
};

template <typename T, int D>
int fwd16(const Args& a) {
  const size_t smem = 2 * mma_tile_bytes<T, D>() + mma_trans_bytes<T, D>();
  cudaError_t e = set_smem(fwd_mma<T, D>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.L + BT - 1) / BT, a.BH);
  fwd_mma<T, D><<<grid, THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<T*>(a.o), a.lse, a.L, a.causal, a.scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int dq16(const Args& a) {
  const size_t smem = 4 * mma_tile_bytes<T, D>() + mma_trans_bytes<T, D>();
  cudaError_t e = set_smem(dq_mma<T, D>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.L + BT - 1) / BT, a.BH);
  dq_mma<T, D><<<grid, THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse_in, a.delta, static_cast<T*>(a.dq), a.L, a.causal,
      a.scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int dkdv16(const Args& a) {
  const size_t smem =
      4 * mma_tile_bytes<T, D>() + 2 * mma_trans_bytes<T, D>() + 2 * BT * sizeof(float);
  cudaError_t e = set_smem(dkdv_mma<T, D>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.L + BT - 1) / BT, a.BH);
  dkdv_mma<T, D><<<grid, THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse_in, a.delta, static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.L, a.causal, a.scale);
  return (int)cudaGetLastError();
}

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

// kind: 0 forward, 1 dQ, 2 dK/dV
template <int D>
int dispatch_d(int kind, int dtype, const Args& a) {
  switch (dtype) {
    case DT_BF16:
      return kind == 0   ? fwd16<__nv_bfloat16, D>(a)
             : kind == 1 ? dq16<__nv_bfloat16, D>(a)
                         : dkdv16<__nv_bfloat16, D>(a);
    case DT_F16:
      return kind == 0 ? fwd16<__half, D>(a) : kind == 1 ? dq16<__half, D>(a) : dkdv16<__half, D>(a);
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
// (0 on success; -1 for a dtype or head dim the kernels do not take).
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v, void* o, void* lse,
                                int BH, int L, int D, int dtype, int causal, float scale,
                                void* stream) {
  Args a{q, k, v, nullptr, nullptr, nullptr, o, nullptr, nullptr, nullptr,
         static_cast<float*>(lse), BH, L, causal, scale,
         reinterpret_cast<cudaStream_t>(stream)};
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
                                 int L, int D, int dtype, int causal, float scale,
                                 void* stream) {
  Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
         nullptr, nullptr, dk, dv, nullptr, BH, L, causal, scale,
         reinterpret_cast<cudaStream_t>(stream)};
  return dispatch(2, D, dtype, a);
}
