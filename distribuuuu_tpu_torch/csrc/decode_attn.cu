// Decode attention over a paged KV cache for Hopper (sm_90a): the T=1 step
// of LM generation.
//
// Replaces the Pallas kernel of distribuuuu_tpu/ops/pallas/decode_attn.py
// (_decode_kernel, reached through decode_attention, :121). For each batch
// row b and head h, with the new token's K/V already written at position
// lengths[b]:
//
//   s_j = (q . k_j) * scale            for keys j = 0 .. min(lengths[b], C-1)
//   out = sum_j softmax(s)_j v_j       (online max / sum / accumulation, fp32)
//   out = acc / max(l, 1e-30)          written as fp32 [B, H, D]
//
// q is [B, H, D], the cache [B, H, C, D], both bf16 or f32; lengths [B]
// int32. Keys past a row's length are never read, and the cache is read in
// its stored dtype (no fp32 copy). A row with a negative length reads
// nothing and gives 0, as the TPU kernel's empty block loop does.
//
// What bounds it on the H100: bytes. A step reads each live K/V row once
// (2 * D * csz bytes a key) for about 4 * D operations a key, about one
// operation per byte, far under the ~295 operations per byte the card can
// do per byte it reads. The least time is the live cache bytes over
// 3.35 TB/s.
//
// Design (right and simple first; split-K across blocks and TMA/cp.async
// pipelining are later work):
//  * one block of WARPS warps per (b, h);
//  * each lane holds VEC = 16 / sizeof(T) elements of a head-dim slice: a
//    key row of DP elements (DP = 32, 64 or 128, the head dim rounded up)
//    is read by LPK = DP / VEC lanes with one 16-byte load each, so a warp
//    covers KPW = 32 / LPK consecutive keys per load, 512 contiguous bytes;
//  * q is loaded once into registers as fp32; the dot product is reduced
//    across the LPK lanes of a key by xor shuffles;
//  * each group of LPK lanes keeps its own online-softmax state (m, l and
//    its slice of acc), updated U keys at a time (U loads in flight, one
//    rescale per U keys);
//  * the groups of a warp merge by shuffles, the warps through shared
//    memory at the end.
// A head dim that is not a multiple of VEC, or an operand that is not
// 16-byte aligned, takes scalar loads in the same kernel (vec_ok = 0).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int U = 4;  // keys per group per iteration
constexpr float NEG_BIG = -0.7f * FLT_MAX;

enum DType { DT_F32 = 0, DT_BF16 = 1 };

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
  }
  __device__ __forceinline__ static float scalar(const float* p) { return *p; }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
      const float2 f = __bfloat1622float2(h);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static float scalar(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
};

// VEC elements of a row starting at d0 (elements at or past D read as 0)
template <typename T>
__device__ __forceinline__ void load_slice(const T* row, int d0, int D, bool vec_ok, float* out) {
  constexpr int VEC = Vec<T>::N;
  if (vec_ok) {
    if (d0 < D) {
      Vec<T>::load(row + d0, out);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) out[e] = 0.f;
    }
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) out[e] = (d0 + e < D) ? Vec<T>::scalar(row + d0 + e) : 0.f;
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS)
    decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const int* __restrict__ lengths,
                       float* __restrict__ out, int H, int C, int D, float scale, int vec_ok) {
  constexpr int VEC = Vec<T>::N;
  constexpr int LPK = DP / VEC;  // lanes per key row
  constexpr int KPW = 32 / LPK;  // keys per warp per load
  static_assert(LPK >= 1 && LPK <= 32 && (32 % LPK) == 0, "bad lane split");
  constexpr int STEP = WARPS * KPW;  // keys the block covers per load

  __shared__ float sm_acc[WARPS][DP];
  __shared__ float sm_m[WARPS], sm_l[WARPS];

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = lane / LPK;  // which key of the warp's KPW
  const int d0 = (lane % LPK) * VEC;
  const int n_keys = max(0, min(lengths[b] + 1, C));  // keys 0..lengths[b] visible
  const bool vec = vec_ok != 0;

  float qr[VEC];
  load_slice(q + (size_t)bh * D, d0, D, vec, qr);
  const T* kb = k + (size_t)bh * C * D;
  const T* vb = v + (size_t)bh * C * D;

  float m = NEG_BIG, l = 0.f, acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;

  // `it` is uniform across the warp, so every lane reaches the shuffles
  for (int it = warp * KPW; it < n_keys; it += STEP * U) {
    float kr[U][VEC], vr[U][VEC];
    bool live[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = it + u * STEP + sub;
      live[u] = j < n_keys;
      if (live[u]) {
        load_slice(kb + (size_t)j * D, d0, D, vec, kr[u]);
        load_slice(vb + (size_t)j * D, d0, D, vec, vr[u]);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) kr[u][e] = vr[u][e] = 0.f;
      }
    }
    float s[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < VEC; ++e) dot = fmaf(qr[e], kr[u][e], dot);
#pragma unroll
      for (int off = LPK / 2; off >= 1; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
      s[u] = dot * scale;
    }
    float mx = m;
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (live[u]) mx = fmaxf(mx, s[u]);
    const float corr = expf(m - mx);
    l *= corr;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] *= corr;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (live[u]) {
        const float p = expf(s[u] - mx);
        l += p;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] = fmaf(p, vr[u][e], acc[e]);
      }
    }
    m = mx;
  }

  // merge the KPW key groups of the warp (lanes with the same d0)
#pragma unroll
  for (int off = LPK; off < 32; off <<= 1) {
    const float m_o = __shfl_xor_sync(0xffffffffu, m, off);
    const float l_o = __shfl_xor_sync(0xffffffffu, l, off);
    const float mx = fmaxf(m, m_o);
    const float c = expf(m - mx), c_o = expf(m_o - mx);
    l = l * c + l_o * c_o;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float a_o = __shfl_xor_sync(0xffffffffu, acc[e], off);
      acc[e] = acc[e] * c + a_o * c_o;
    }
    m = mx;
  }
  if (sub == 0) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) sm_acc[warp][d0 + e] = acc[e];
    if (lane == 0) {
      sm_m[warp] = m;
      sm_l[warp] = l;
    }
  }
  __syncthreads();

  // merge the warps: one thread per output element
  for (int d = threadIdx.x; d < D; d += THREADS) {
    float mx = sm_m[0];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) mx = fmaxf(mx, sm_m[w]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float c = expf(sm_m[w] - mx);
      lsum = fmaf(sm_l[w], c, lsum);
      a = fmaf(sm_acc[w][d], c, a);
    }
    out[(size_t)bh * D + d] = a / fmaxf(lsum, 1e-30f);
  }
}

template <typename T>
int launch_t(const void* q, const void* k, const void* v, const void* lengths, void* out, int B,
             int H, int C, int D, float scale, int vec_ok, cudaStream_t stream) {
  const dim3 grid(B * H), block(THREADS);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const int* lt = static_cast<const int*>(lengths);
  float* ot = static_cast<float*>(out);
  if (D <= 32) {
    decode_attn_kernel<T, 32><<<grid, block, 0, stream>>>(qt, kt, vt, lt, ot, H, C, D, scale,
                                                          vec_ok);
  } else if (D <= 64) {
    decode_attn_kernel<T, 64><<<grid, block, 0, stream>>>(qt, kt, vt, lt, ot, H, C, D, scale,
                                                          vec_ok);
  } else {
    decode_attn_kernel<T, 128><<<grid, block, 0, stream>>>(qt, kt, vt, lt, ot, H, C, D, scale,
                                                           vec_ok);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns 0 on a successful launch, else a CUDA error code (an unsupported
// dtype or shape gives cudaErrorInvalidValue).
extern "C" int decode_attn_launch(const void* q, const void* k, const void* v,
                                  const void* lengths, void* out, int B, int H, int C, int D,
                                  int dtype, float scale, int vec_ok, void* stream) {
  if (B < 1 || H < 1 || C < 1 || D < 1 || D > 128 || (long long)B * H > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == DT_F32) return launch_t<float>(q, k, v, lengths, out, B, H, C, D, scale, vec_ok, s);
  if (dtype == DT_BF16)
    return launch_t<__nv_bfloat16>(q, k, v, lengths, out, B, H, C, D, scale, vec_ok, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
