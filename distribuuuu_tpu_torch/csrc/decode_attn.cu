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
// do per byte it reads, and at M = 1 a head the tensor cores have nothing
// to do. The least time is the live cache bytes over 3.35 TB/s: 66 ns at
// the GPT-nano tile [4, 4, 256, 32], under what any launch takes, so there
// the chain of dependent latencies a block walks sets the time; at long
// caches it is the bytes in flight.
//
// The design (decode_split): flash-decoding across a thread-block cluster.
//  * The grid is (splits, H, B), launched as clusters of `splits` blocks
//    (cudaLaunchAttributeClusterDimension, splits <= 8). n = clamp(
//    lengths[b] + 1, 0, C) is read on the device, and block r of a cluster
//    takes keys [r * kpb, (r + 1) * kpb) of [0, n), kpb = ceil(n / splits):
//    the live keys of a row are spread over all its blocks whatever the
//    row's length, and the host never reads `lengths`.
//  * A (b, h) page is row-major [C, D], so a block's K keys and its V keys
//    are each one contiguous run of bytes. One thread feeds a ring of
//    `stages` shared-memory stages of `stage_keys` keys each with 1-D bulk
//    async copies (cp.async.bulk ... mbarrier::complete_tx, two a stage:
//    the K tile and the V tile), each stage completing on its mbarrier. A
//    block copies only its live keys; one with none copies nothing. The
//    next stages are in flight while a stage is consumed, and a stage is
//    refilled once every thread is done with it.
//  * The consumers read the tiles from shared memory in the first design's
//    lane layout: a key row of DP elements (the head dim rounded up to 32,
//    64 or 128) is read by LPK = DP / VEC lanes with one 16-byte load each
//    (VEC = 16 / sizeof(T)), the dot product reduced across them by xor
//    shuffles; each group of LPK lanes keeps its own online softmax over
//    keys NG apart (NG groups a block), U keys a step. q is loaded once
//    with scale * log2(e) folded in, so the softmax runs in the exp2
//    domain on the SFU (ex2.approx).
//  * The groups of a warp merge by shuffles, the warps of a block through
//    shared memory, into the block's (m, l, acc[D]). Then the cluster
//    combines without global memory: each rank r > 0 pushes its state into
//    slot r of rank 0's shared memory with st.async (mapa addresses), each
//    store completing its bytes on rank 0's combine mbarrier, and leaves;
//    rank 0 waits on that barrier, merges its own state and then ranks
//    1, 2, ... in order (so the result is the same bits every call) and
//    writes the output. A cluster barrier split around the main loop (every
//    thread arrives after the barriers are set up, waits before pushing)
//    orders rank 0's barrier set-up before any push. A block with no live
//    key takes part with m = -big, l = 0. A plan of one block a row writes
//    its state directly. No workspace, no counter, one launch.
//  * The tiling (splits, stage_keys, stages) is ops/cuda/decode_attn.plan,
//    from ops/cuda/decode_sweep.py.
//
// Tried and taken out (PERF.md §6): rank 0 pulling the states through
// ld.shared::cluster between two full cluster barriers (0.4-1 us slower at
// every shape, 12 % at the probe); the combine through a per-(device,
// stream) fp32 workspace, the last block of a (b, h) merging the partials
// in split order after an arrival counter (conv_epilogue.cu's split-K;
// slower still).
//
// Calls the bulk copy cannot take (D * sizeof(T) not a multiple of 16, or
// a base that is not 16-byte aligned) run decode_simple, the first design:
// one block of 4 warps per (b, h) streaming its keys with 16-byte loads
// from device memory (scalar loads where D is not a multiple of VEC or a
// base is not aligned), groups merged by shuffles and the warps through
// shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include <atomic>

#include "hopper.cuh"

namespace {

using hopper::smem_u32;

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int U = 4;  // keys per group per step
constexpr int MAX_SPLITS = 8;  // the portable cluster size
constexpr int MAX_RING = 200 * 1024;  // bytes of a split block's ring, at most
constexpr int MAX_STAGES = 16;
constexpr float NEG_BIG = -0.7f * FLT_MAX;
constexpr float LOG2E = 1.4426950408889634f;

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

// 2^x on the SFU (ex2.approx, subnormal results flushed to 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ------------------------------------------------------ the first design

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS)
    decode_simple(const T* __restrict__ q, const T* __restrict__ k,
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

// ------------------------------------------ the cluster design (Hopper)

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// this block's shared-memory address `addr` in rank 0's shared memory
__device__ __forceinline__ uint32_t mapa0(uint32_t addr) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(addr), "r"(0));
  return remote;
}

// a float into another block's shared memory, completing 4 bytes on its barrier
__device__ __forceinline__ void st_async(uint32_t remote, float x, uint32_t remote_bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n"
               ::"r"(remote), "r"(__float_as_uint(x)), "r"(remote_bar) : "memory");
}

// One (b, h) per cluster of gridDim.x blocks; see the note at the top.
// Dynamic shared memory: the ring ([stages][K tile, V tile] of stage_keys
// x D elements), then one mbarrier a stage.
template <typename T, int DP>
__global__ void __launch_bounds__(THREADS)
    decode_split(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ lengths,
                 float* __restrict__ out, int H, int C, int D, float qscale, int stage_keys,
                 int stages) {
  constexpr int VEC = Vec<T>::N;
  constexpr int LPK = DP / VEC;  // lanes per key row
  constexpr int KPW = 32 / LPK;  // keys per warp per load
  static_assert(LPK >= 1 && LPK <= 32 && (32 % LPK) == 0, "bad lane split");
  constexpr int NG = WARPS * KPW;  // key groups of the block

  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float w_acc[WARPS][DP];
  __shared__ float w_m[WARPS], w_l[WARPS];
  __shared__ float c_acc[MAX_SPLITS][DP];  // rank 0: the other ranks' states
  __shared__ float c_m[MAX_SPLITS], c_l[MAX_SPLITS];
  __shared__ __align__(8) uint64_t c_bar;  // rank 0: completes when they have landed

  const int splits = gridDim.x, rank = blockIdx.x;
  const int b = blockIdx.z;
  const size_t bh = (size_t)b * H + blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = warp * KPW + lane / LPK;  // this lane's key group
  const int d0 = (lane % LPK) * VEC;

  const int n = max(0, min(lengths[b] + 1, C));  // keys 0..lengths[b] visible
  const int kpb = (n + splits - 1) / splits;
  const int lo = min(n, rank * kpb);
  const int nk = min(n, lo + kpb) - lo;  // this block's live keys
  const int n_st = (nk + stage_keys - 1) / stage_keys;
  const int tile = stage_keys * D;  // elements of one K (or V) tile
  const T* ring = reinterpret_cast<const T*>(smem);
  const uint32_t ring_u32 = smem_u32(smem);
  const uint32_t full0 = ring_u32 + (uint32_t)(2 * stages * tile * sizeof(T));
  const T* kb = k + (bh * C + lo) * D;
  const T* vb = v + (bh * C + lo) * D;

  // stage i of this block's keys into slot i % stages
  auto load_stage = [&](int i) {
    const int slot = i % stages;
    const uint32_t bytes = (uint32_t)(min(stage_keys, nk - i * stage_keys) * D * sizeof(T));
    const uint32_t bar = full0 + 8 * slot;
    const uint32_t dst = ring_u32 + (uint32_t)(2 * slot * tile * sizeof(T));
    hopper::mbar_expect_tx(bar, 2 * bytes);
    hopper::bulk_load(dst, kb + (size_t)i * tile, bytes, bar);
    hopper::bulk_load(dst + (uint32_t)(tile * sizeof(T)), vb + (size_t)i * tile, bytes, bar);
  };
  if (tid == 0) {
    for (int s = 0; s < stages && n_st > 0; ++s) hopper::mbar_init(full0 + 8 * s, 1);
    if (rank == 0 && splits > 1) hopper::mbar_init(smem_u32(&c_bar), 1);
    hopper::mbar_init_fence();
    for (int i = 0; i < min(stages, n_st); ++i) load_stage(i);
  }
  // rank 0's combine barrier is set up before any rank pushes to it: every
  // thread arrives now and waits once its state is ready
  if (splits > 1) cluster_arrive();

  float qr[VEC];
  load_slice(q + bh * D, d0, D, true, qr);
#pragma unroll
  for (int e = 0; e < VEC; ++e) qr[e] *= qscale;
  float m = NEG_BIG, l = 0.f, acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
  __syncthreads();  // the barriers are initialised

  for (int i = 0; i < n_st; ++i) {
    const int slot = i % stages;
    hopper::mbar_wait(full0 + 8 * slot, (uint32_t)((i / stages) & 1));
    const int rows = min(stage_keys, nk - i * stage_keys);
    const T* ks = ring + (size_t)2 * slot * tile;
    const T* vs = ks + tile;
    // `j0` is uniform across the warp, so every lane reaches the shuffles
    for (int j0 = 0; j0 < rows; j0 += NG * U) {
      float kr[U][VEC], vr[U][VEC];
      bool live[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + u * NG + g;
        live[u] = j < rows;
        if (live[u] && d0 < D) {  // D * sizeof(T) is a multiple of 16: whole vectors
          Vec<T>::load(ks + j * D + d0, kr[u]);
          Vec<T>::load(vs + j * D + d0, vr[u]);
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
        s[u] = dot;
      }
      float mx = m;
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (live[u]) mx = fmaxf(mx, s[u]);
      const float corr = fast_exp2(m - mx);
      l *= corr;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] *= corr;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (live[u]) {
          const float p = fast_exp2(s[u] - mx);
          l += p;
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[e] = fmaf(p, vr[u][e], acc[e]);
        }
      }
      m = mx;
    }
    if (i + stages < n_st) {  // refill the slot once every thread is done with it
      __syncthreads();
      if (tid == 0) load_stage(i + stages);
    }
  }

  // merge the KPW key groups of the warp (lanes with the same d0)
#pragma unroll
  for (int off = LPK; off < 32; off <<= 1) {
    const float m_o = __shfl_xor_sync(0xffffffffu, m, off);
    const float l_o = __shfl_xor_sync(0xffffffffu, l, off);
    const float mx = fmaxf(m, m_o);
    const float c = fast_exp2(m - mx), c_o = fast_exp2(m_o - mx);
    l = l * c + l_o * c_o;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float a_o = __shfl_xor_sync(0xffffffffu, acc[e], off);
      acc[e] = acc[e] * c + a_o * c_o;
    }
    m = mx;
  }
  if (lane < LPK) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) w_acc[warp][d0 + e] = acc[e];
    if (lane == 0) {
      w_m[warp] = m;
      w_l[warp] = l;
    }
  }
  __syncthreads();

  // the block's state: one thread per element, the warps in order
  if (tid < DP) {
    float mx = w_m[0];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) mx = fmaxf(mx, w_m[w]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float c = fast_exp2(w_m[w] - mx);
      lsum = fmaf(w_l[w], c, lsum);
      a = fmaf(w_acc[w][tid], c, a);
    }
    if (splits == 1) {  // one block a row: its state is the row's
      if (tid < D) out[bh * D + tid] = a / fmaxf(lsum, 1e-30f);
      return;
    }
    cluster_wait();
    if (rank != 0) {  // push the state into rank 0's slot, then leave
      const uint32_t bar = mapa0(smem_u32(&c_bar));
      st_async(mapa0(smem_u32(&c_acc[rank][tid])), a, bar);
      if (tid == 0) {
        st_async(mapa0(smem_u32(&c_m[rank])), mx, bar);
        st_async(mapa0(smem_u32(&c_l[rank])), lsum, bar);
      }
      return;
    }
    if (tid == 0)
      hopper::mbar_expect_tx(smem_u32(&c_bar), (uint32_t)((splits - 1) * (DP + 2) * 4));
    hopper::mbar_wait(smem_u32(&c_bar), 0);
    if (tid < D) {  // rank 0's own state, then ranks 1.. in order
      float m_all = mx;
      for (int r = 1; r < splits; ++r) m_all = fmaxf(m_all, c_m[r]);
      const float c0 = fast_exp2(mx - m_all);
      float ls = lsum * c0, ac = a * c0;
      for (int r = 1; r < splits; ++r) {
        const float c = fast_exp2(c_m[r] - m_all);
        ls = fmaf(c_l[r], c, ls);
        ac = fmaf(c_acc[r][tid], c, ac);
      }
      out[bh * D + tid] = ac / fmaxf(ls, 1e-30f);
    }
    return;
  }
  if (splits > 1) cluster_wait();  // threads past DP: their one wait
}

__global__ void decode_floor(int) {}

template <typename T>
int launch_simple(const void* q, const void* k, const void* v, const void* lengths, void* out,
                  int B, int H, int C, int D, float scale, int vec_ok, cudaStream_t stream) {
  const dim3 grid(B * H), block(THREADS);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const int* lt = static_cast<const int*>(lengths);
  float* ot = static_cast<float*>(out);
  if (D <= 32) {
    decode_simple<T, 32><<<grid, block, 0, stream>>>(qt, kt, vt, lt, ot, H, C, D, scale, vec_ok);
  } else if (D <= 64) {
    decode_simple<T, 64><<<grid, block, 0, stream>>>(qt, kt, vt, lt, ot, H, C, D, scale, vec_ok);
  } else {
    decode_simple<T, 128><<<grid, block, 0, stream>>>(qt, kt, vt, lt, ot, H, C, D, scale,
                                                      vec_ok);
  }
  return static_cast<int>(cudaGetLastError());
}

// a launch of `kernel` over the grid (splits, H, B) in clusters of `splits`
template <typename... Params, typename... Args>
cudaError_t launch_clusters(void (*kernel)(Params...), int splits, int H, int B, int smem,
                            cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, H, B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  const cudaError_t last = cudaGetLastError();  // cleared either way
  return e != cudaSuccess ? e : last;
}

template <typename T, int DP>
int launch_split_dp(const T* q, const T* k, const T* v, const int* lengths, float* out, int B,
                    int H, int C, int D, float scale, int splits, int stage_keys, int stages,
                    cudaStream_t stream) {
  const long long ring = 2ll * stages * stage_keys * D * sizeof(T);
  const int smem = static_cast<int>(ring + 8 * stages);
  if (ring > MAX_RING || stages > MAX_STAGES) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = decode_split<T, DP>;
  static std::atomic<unsigned> raised{0};  // the limit raised to the most any tiling takes
  if (smem > 48 * 1024) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = hopper::raise_smem_once(kernel, MAX_RING + 8 * MAX_STAGES, dev, raised);
    if (e != cudaSuccess) {
      cudaGetLastError();
      return static_cast<int>(e);
    }
  }
  return static_cast<int>(launch_clusters(kernel, splits, H, B, smem, stream, q, k, v, lengths,
                                          out, H, C, D, scale * LOG2E, stage_keys, stages));
}

template <typename T>
int launch_split(const void* q, const void* k, const void* v, const void* lengths, void* out,
                 int B, int H, int C, int D, float scale, int splits, int stage_keys, int stages,
                 cudaStream_t stream) {
  if ((D * sizeof(T)) % 16 != 0 ||
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v)) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const int* lt = static_cast<const int*>(lengths);
  float* ot = static_cast<float*>(out);
  if (D <= 32)
    return launch_split_dp<T, 32>(qt, kt, vt, lt, ot, B, H, C, D, scale, splits, stage_keys,
                                  stages, stream);
  if (D <= 64)
    return launch_split_dp<T, 64>(qt, kt, vt, lt, ot, B, H, C, D, scale, splits, stage_keys,
                                  stages, stream);
  return launch_split_dp<T, 128>(qt, kt, vt, lt, ot, B, H, C, D, scale, splits, stage_keys,
                                 stages, stream);
}

bool bad_shape(int B, int H, int C, int D) {
  return B < 1 || H < 1 || C < 1 || D < 1 || D > 128 || (long long)B * H > 0x7fffffffLL;
}

}  // namespace

// Each returns 0 on a successful launch, else a CUDA error code (an
// unsupported dtype, shape or tiling gives cudaErrorInvalidValue).

// The first design, one block per (b, h).
extern "C" int decode_simple_launch(const void* q, const void* k, const void* v,
                                    const void* lengths, void* out, int B, int H, int C, int D,
                                    int dtype, float scale, int vec_ok, void* stream) {
  if (bad_shape(B, H, C, D)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    return launch_simple<float>(q, k, v, lengths, out, B, H, C, D, scale, vec_ok, s);
  if (dtype == DT_BF16)
    return launch_simple<__nv_bfloat16>(q, k, v, lengths, out, B, H, C, D, scale, vec_ok, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The cluster design: clusters of `splits` blocks, a ring of `stages`
// stages of `stage_keys` keys. D * element size must be a multiple of 16
// and q, k, v 16-byte aligned.
extern "C" int decode_split_launch(const void* q, const void* k, const void* v,
                                   const void* lengths, void* out, int B, int H, int C, int D,
                                   int dtype, float scale, int splits, int stage_keys,
                                   int stages, void* stream) {
  if (bad_shape(B, H, C, D) || B > 65535 || H > 65535 || splits < 1 || splits > MAX_SPLITS ||
      stage_keys < 1 || stages < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    return launch_split<float>(q, k, v, lengths, out, B, H, C, D, scale, splits, stage_keys,
                               stages, s);
  if (dtype == DT_BF16)
    return launch_split<__nv_bfloat16>(q, k, v, lengths, out, B, H, C, D, scale, splits,
                                       stage_keys, stages, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// An empty kernel over the same grid and clusters: the launch floor the
// cluster design stands on (splits 1 and H = B = 1: one empty block).
extern "C" int decode_floor_launch(int B, int H, int splits, void* stream) {
  if (B < 1 || H < 1 || B > 65535 || H > 65535 || splits < 1 || splits > MAX_SPLITS)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      launch_clusters(decode_floor, splits, H, B, 0, reinterpret_cast<cudaStream_t>(stream), 0));
}
