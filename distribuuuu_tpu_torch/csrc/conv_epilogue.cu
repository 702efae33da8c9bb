// Fused pointwise conv + folded eval BatchNorm + activation for Hopper (sm_90a).
//
// Replaces the Pallas kernel distribuuuu_tpu/ops/pallas/conv_epilogue.py
// (_mm_epilogue_kernel, reached through conv1x1_bn_act). It computes
//
//     out[m, n] = act((sum_k x[m, k] * w[k, n]) * a[n] + c[n])
//
// for x [M, K] (an NHWC activation viewed as rows), w [K, N], and the
// per-channel affine a, c [N] in fp32 that eval BatchNorm folds to. The
// affine and the activation are applied to the fp32 accumulator while it
// is in registers: the conv output never reaches device memory
// un-normalised.
//
// What bounds it on the H100. The card needs ~295 bf16 operations per byte
// of device memory before the tensor cores are the limit. At ResNet-50's
// widths (K and N 64..2048) a site does fewer, so it is bound by bytes:
// read x and w once, write the output once. At RegNet's stages 3 and 4
// (K = N = 1232 or 3024 in regnety_160) a site does more (440 at
// 1568 x 1232 x 1232), so it is bound by operations, and only wgmma fed
// from shared memory reaches the tensor cores' rate. Inside the card, an
// SM moves ~40 bytes a clock to and from L2 (measured with the kernel's
// own clock trace), so a tile must do many products per byte it loads and
// stores. At batch 8 many sites are latency: a few dozen output tiles
// leave most of the 132 SMs idle.
//
// The bf16 design (epilogue_gemm_wgmma):
//  * persistent: one CTA per SM walks the output tiles (and splits of K)
//    in turn, the N tile fastest;
//  * a ring of `stages` shared-memory stages, each a [BM x 64] tile of x
//    and a [64 x BN] tile of w, filled by TMA with the 128-byte swizzle and
//    completed on an mbarrier (expect-tx); TMA's zero fill past the
//    tensor's edge replaces per-element masks at ragged M, N and K. The
//    ring runs on across tiles, so the next tile's loads overlap this
//    tile's epilogue;
//  * warp specialisation: warpgroup 0 is the producer (one thread issues
//    the TMA loads and waits for free stages), warpgroups 1 and 2 are the
//    consumers, each a 64-row (BM 128) or BN/2-column (BM 64) part of the
//    tile, and run wgmma.mma_async m64nNk16 bf16 -> fp32 on the stage that
//    has arrived while the producer fills the next ones. A is K-major; B is
//    read MN-major straight from the [K, N] tile of w (the transpose bit of
//    wgmma), so the weight keeps the layout JAX and the wrapper give it.
//    setmaxnreg moves registers to the consumers of a 128 x 256 tile;
//  * the tile (128 x 64, 128 x 128, 128 x 256 or 64 x 128) and the split
//    of K are a plan chosen per shape by the wrapper
//    (ops/cuda/conv_epilogue.py `plan`): BN covers N up to 256 so x is read
//    once, and 256 at wider N (the fewest L2 bytes a product); 128 and
//    then BM 64 where the tiles would leave most SMs idle;
//  * split-K where the tiles fill at most a quarter of the SMs: each split
//    writes its fp32 partial tile to a workspace, and the CTA that arrives
//    last at the tile's counter sums the partials in split order, runs the
//    epilogue and resets the counter to 0. One launch, no memset, and the
//    result is the same bits from run to run;
//  * the epilogue applies a and c (read one tile ahead, held in shared
//    memory) and the activation to the accumulator registers, stages the
//    part in shared memory with the 128-byte swizzle (no bank conflicts)
//    and writes whole rows with 16-byte stores, clipped at M and N.
//
// A bf16 shape that TMA cannot describe (K or N not a multiple of 8, or a
// base not 16-byte aligned) takes epilogue_gemm_mma_sync, a 128 x 64 tile
// of mma.sync.m16n8k16 with masked loads. No site of ResNet, RegNet or
// EfficientNet has such a shape; the launcher picks the body by the shape.
// fp32 inputs run epilogue_gemm_f32 on the CUDA cores (no TF32 rounding).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

enum Act { ACT_ID = 0, ACT_RELU = 1, ACT_SILU = 2 };
enum DType { DT_F32 = 0, DT_BF16 = 1 };

__device__ __forceinline__ float apply_act(float y, int act) {
  if (act == ACT_RELU) return fmaxf(y, 0.0f);
  if (act == ACT_SILU) return y / (1.0f + expf(-y));
  return y;
}

template <int ACT>
__device__ __forceinline__ float act_t(float y) {
  return apply_act(y, ACT);
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// ------------------------------------------------ bf16 path: TMA ring + wgmma

constexpr int HK = 64;             // K of one ring stage: one 128-byte swizzle row
constexpr int HTHREADS = 384;      // producer warpgroup + two consumer warpgroups
constexpr int ATOM = 64 * 128;     // bytes of one [64 k][64 n] swizzled box of w
constexpr int MAX_SMEM = 232448;   // dynamic shared memory a block may use

template <int kBM, int kBN>
struct Tile {
  static constexpr int SN = kBM == 128 ? kBN : kBN / 2;  // columns of one consumer
  static constexpr int WN = SN < 128 ? SN : 128;         // columns of one wgmma
  static constexpr int NREG = SN / 2;                    // fp32 accumulators a thread
  static constexpr int A_BYTES = kBM * HK * 2;
  static constexpr int STAGE_BYTES = A_BYTES + HK * kBN * 2;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait for the completion of the barrier's phase of parity `parity`. A
// wait of more than 4 s is a fault of the ring, not a wait: trap, so the
// launch fails instead of hanging the stream.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  uint64_t since = 0;
  for (uint32_t polls = 1;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if ((polls & 1023) == 0) {
      const uint64_t now = global_ns();
      if (since == 0) since = now;
      else if (now - since > 4000000000ull) __trap();
    }
  }
}

// One 2-D box of a tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand (the
// layout TMA writes with CU_TENSOR_MAP_SWIZZLE_128B). Offsets in bytes:
// K-major A: sbo = 1024 between 8-row groups (lbo unused);
// MN-major B: lbo = 8 KB between 64-column boxes, sbo = 1024 between
// 8-row (k) groups.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from reading an accumulator before wgmma_wait
__device__ __forceinline__ void reg_fence(float& r) { asm volatile("" : "+f"(r)::"memory"); }

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// d[0 .. N/2) += A (64 x 16, K-major) * B (16 x N, MN-major), fp32 accumulate
__device__ __forceinline__ void wgmma_m64n64(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n128(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <int WN>
__device__ __forceinline__ void wgmma_bf16(float* d, uint64_t da, uint64_t db) {
  if constexpr (WN == 64)
    wgmma_m64n64(d, da, db);
  else
    wgmma_m64n128(d, da, db);
}

__device__ __forceinline__ void store_pair(float* p, float y0, float y1) {
  *reinterpret_cast<float2*>(p) = make_float2(y0, y1);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float y0, float y1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(y0, y1);
}

// a, c of the column pair (col, col + 1); N is even, so both or neither lie
// inside
__device__ __forceinline__ float4 affine_pair(const float* a, const float* c, int col, int N) {
  return col < N ? make_float4(a[col], a[col + 1], c[col], c[col + 1])
                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// The epilogue of one consumer's 64 x SN part: affine + activation on the
// accumulators, staged in shared memory as blocks of [64 rows][128 bytes]
// with the 128-byte swizzle (a warp's fragment writes hit 32 distinct
// banks, and so do the 16-byte reads of eight threads), then whole rows
// written with 16-byte stores, clipped at M and N (N is a multiple of 8, so
// a 16-byte chunk lies wholly inside or outside).
template <typename OutT, int SN, int ACT>
__device__ __forceinline__ void epilogue_store(const float* acc, uint8_t* staging,
                                               const float4* aff, OutT* out, int M, int N,
                                               int row0, int col0, int wtid, int bar_id) {
  constexpr int EPB = 128 / sizeof(OutT);  // elements in a 128-byte block row
  constexpr int CPR = SN / EPB * 8;        // 16-byte chunks in a row of the part
  const int w = wtid >> 5, l = wtid & 31;
  // wgmma's accumulator layout: register i of lane l in warp w holds row
  // w*16 + l/4 (+8 for the odd pairs), column 8*(i/4) + 2*(l%4) + i%2
#pragma unroll
  for (int i = 0; i < SN / 2; i += 2) {
    const int r = w * 16 + (l >> 2) + 8 * ((i >> 1) & 1);
    const int cc = (i >> 2) * 8 + (l & 3) * 2;
    const float4 f = aff[cc >> 1];  // a[cc], a[cc + 1], c[cc], c[cc + 1]
    const float y0 = act_t<ACT>(acc[i] * f.x + f.z);
    const float y1 = act_t<ACT>(acc[i + 1] * f.y + f.w);
    const int byte = (cc % EPB) * static_cast<int>(sizeof(OutT));  // within the block row
    const int off =
        (cc / EPB) * (64 * 128) + r * 128 + ((((byte >> 4) ^ r) & 7) << 4) + (byte & 15);
    store_pair(reinterpret_cast<OutT*>(staging + off), y0, y1);
  }
  bar_sync(bar_id, 128);
  // all of a thread's reads first, then its stores: CPR / 2 of each
  constexpr int ITERS = 64 * CPR / 128;
  uint4 v[ITERS];
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int q = it * 128 + wtid, r = q / CPR, j = q % CPR;  // row, 16-byte chunk
    v[it] = *reinterpret_cast<const uint4*>(staging + (j >> 3) * (64 * 128) + r * 128 +
                                            (((j ^ r) & 7) << 4));
  }
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int q = it * 128 + wtid, r = q / CPR, j = q % CPR;
    const int gr = row0 + r, gc = col0 + j * (16 / static_cast<int>(sizeof(OutT)));
    if (gr < M && gc < N)
      *reinterpret_cast<uint4*>(out + static_cast<size_t>(gr) * N + gc) = v[it];
  }
}

template <typename OutT, int SN>
__device__ __forceinline__ void epilogue_act(int act, const float* acc, uint8_t* staging,
                                             const float4* aff, OutT* out, int M, int N,
                                             int row0, int col0, int wtid, int bar_id) {
  if (act == ACT_RELU)
    epilogue_store<OutT, SN, ACT_RELU>(acc, staging, aff, out, M, N, row0, col0, wtid, bar_id);
  else if (act == ACT_SILU)
    epilogue_store<OutT, SN, ACT_SILU>(acc, staging, aff, out, M, N, row0, col0, wtid, bar_id);
  else
    epilogue_store<OutT, SN, ACT_ID>(acc, staging, aff, out, M, N, row0, col0, wtid, bar_id);
}

// A persistent kernel: one CTA per SM walks the work units (output tile,
// split of K) u = blockIdx.x, + gridDim.x, ..., the N tile fastest, so the
// CTAs reading the same rows of x run together and share them in L2. The
// ring runs on across units: the producer loads the next unit's stages
// while the consumers run this unit's epilogue. Shared memory: the ring
// (`stages` stages), then each consumer's staging of its output part and
// its columns' a and c, then the barriers. The plan makes `splits` divide
// the K steps.
template <int kBM, int kBN>
__global__ void __launch_bounds__(HTHREADS, 1)
    epilogue_gemm_wgmma(const __grid_constant__ CUtensorMap tm_x,
                        const __grid_constant__ CUtensorMap tm_w,
                        const float* __restrict__ a, const float* __restrict__ c,
                        void* __restrict__ out, float* __restrict__ partials,
                        int* __restrict__ arrivals, int M, int N, int K, int act,
                        int out_bf16, int splits, int stages, int staging_bytes) {
  using T = Tile<kBM, kBN>;
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the ring to it
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* staging = smem + stages * T::STAGE_BYTES;
  float* affine = reinterpret_cast<float*>(staging + 2 * staging_bytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(affine + 4 * T::SN);
  uint64_t* empty = full + stages;
  int* last_flag = reinterpret_cast<int*>(empty + stages);

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int tiles_n = (N + kBN - 1) / kBN, tiles_m = (M + kBM - 1) / kBM;
  const int tiles = tiles_n * tiles_m;
  const int units = tiles * splits;
  const int steps = ((K + HK - 1) / HK) / splits;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread keeps the ring full
    if constexpr (T::SN == 256) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tm_x))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tm_w))
                   : "memory");
      const uint32_t base = smem_u32(smem);
      int stage = 0;
      uint32_t phase = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const int n0 = (u % tiles_n) * kBN, m0 = ((u / tiles_n) % tiles_m) * kBM;
        const int k_step0 = (u / tiles) * steps;
        for (int kt = 0; kt < steps; ++kt) {
          mbar_wait(smem_u32(&empty[stage]), phase ^ 1);
          const uint32_t fb = smem_u32(&full[stage]);
          mbar_expect_tx(fb, T::STAGE_BYTES);
          const uint32_t sA = base + stage * T::STAGE_BYTES;
          const int k0 = (k_step0 + kt) * HK;
          tma_load_2d(sA, &tm_x, fb, k0, m0);
#pragma unroll
          for (int j = 0; j < kBN / 64; ++j)
            tma_load_2d(sA + T::A_BYTES + j * ATOM, &tm_w, fb, n0 + 64 * j, k0);
          if (++stage == stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers: wgmma on the stages that have arrived, then the epilogue
    if constexpr (T::SN == 256) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = wg - 1;        // consumer 0 or 1
    const int ctid = tid - 128;   // 0..255 over both consumers
    const int wtid = tid & 127;   // within this consumer
    const int bar_id = 2 + cw;    // this consumer's named barrier
    // BM 128: the consumers split the rows; BM 64: they split the columns
    const uint32_t a_off = kBM == 128 ? cw * 64 * 128 : 0;
    const uint32_t b_off = kBM == 128 ? 0 : cw * (T::SN / 64) * ATOM;
    const int scol0 = kBM == 128 ? 0 : cw * T::SN;  // this part's first column in the tile
    uint8_t* my_staging = staging + cw * staging_bytes;
    // this part's affine, a float4 a column pair, read from device memory
    // one unit ahead (thread t holds pair t in registers)
    float4* aff = reinterpret_cast<float4*>(affine) + cw * (T::SN / 2);
    float4 next_aff = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (wtid < T::SN / 2 && blockIdx.x < units)
      next_aff = affine_pair(a, c, (blockIdx.x % tiles_n) * kBN + scol0 + 2 * wtid, N);
    const uint32_t base = smem_u32(smem);
    int stage = 0;
    uint32_t phase = 0;
    float acc[T::NREG];

    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int tn = u % tiles_n, tm = (u / tiles_n) % tiles_m, split = u / tiles;
      const int m0 = tm * kBM, col0 = tn * kBN + scol0;
      // the last unit's epilogue is done with the staging and the affine
      bar_sync(bar_id, 128);
      if (wtid < T::SN / 2) {
        aff[wtid] = next_aff;
        const int un = u + gridDim.x;
        if (un < units) next_aff = affine_pair(a, c, (un % tiles_n) * kBN + scol0 + 2 * wtid, N);
      }
#pragma unroll
      for (int i = 0; i < T::NREG; ++i) acc[i] = 0.0f;

      int prev = -1;
      for (int kt = 0; kt < steps; ++kt) {
        mbar_wait(smem_u32(&full[stage]), phase);
        const uint32_t sA = base + stage * T::STAGE_BYTES + a_off;
        const uint32_t sB = base + stage * T::STAGE_BYTES + T::A_BYTES + b_off;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HK / 16; ++kk) {
          // k16 slice: 32 bytes along A's swizzled rows, 16 rows (2 KB) down B
          const uint64_t da = sw128_desc(sA + kk * 32, 16, 1024);
#pragma unroll
          for (int j = 0; j < T::SN / T::WN; ++j)
            wgmma_bf16<T::WN>(acc + j * (T::WN / 2), da,
                              sw128_desc(sB + kk * 2048 + j * (T::WN / 64) * ATOM, ATOM, 1024));
        }
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
      if (prev >= 0 && wtid == 0) mbar_arrive(smem_u32(&empty[prev]));
#pragma unroll
      for (int i = 0; i < T::NREG; ++i) reg_fence(acc[i]);

      if (splits > 1) {
        // every split writes its partial (coalesced: float4 q of thread t
        // at [q][t]); the last to arrive at the tile's counter sums them in
        // split order, so the bits do not depend on which CTA came last
        const int tile = tm * tiles_n + tn;
        constexpr int TILE_F = kBM * kBN;
        float4* mine = reinterpret_cast<float4*>(
            partials + (static_cast<size_t>(tile) * splits + split) * TILE_F);
#pragma unroll
        for (int q = 0; q < T::NREG / 4; ++q)
          __stcg(mine + q * 256 + ctid,
                 make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]));
        __threadfence();
        bar_sync(1, 256);
        if (ctid == 0) *last_flag = atomicAdd(&arrivals[tile], 1);
        bar_sync(1, 256);
        if (*last_flag != splits - 1) continue;
        __threadfence();
        if (ctid == 0) arrivals[tile] = 0;  // ready for the next launch
        const float4* all = reinterpret_cast<const float4*>(
            partials + static_cast<size_t>(tile) * splits * TILE_F);
#pragma unroll
        for (int i = 0; i < T::NREG; ++i) acc[i] = 0.0f;
        for (int s = 0; s < splits; ++s) {
#pragma unroll
          for (int q = 0; q < T::NREG / 4; ++q) {
            const float4 v =
                __ldcg(all + static_cast<size_t>(s) * (TILE_F / 4) + q * 256 + ctid);
            acc[4 * q] += v.x;
            acc[4 * q + 1] += v.y;
            acc[4 * q + 2] += v.z;
            acc[4 * q + 3] += v.w;
          }
        }
      }

      bar_sync(bar_id, 128);  // the affine is in shared memory
      const int row0 = m0 + (kBM == 128 ? cw * 64 : 0);
      if (out_bf16)
        epilogue_act<__nv_bfloat16, T::SN>(act, acc, my_staging, aff,
                                           static_cast<__nv_bfloat16*>(out), M, N, row0, col0,
                                           wtid, bar_id);
      else
        epilogue_act<float, T::SN>(act, acc, my_staging, aff, static_cast<float*>(out), M, N,
                                   row0, col0, wtid, bar_id);
    }
  }
}

// cuTensorMapEncodeTiled, found through the runtime so that the library
// does not link against libcuda (-lcuda)
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = []() -> EncodeTiledFn {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &q);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// A row-major bf16 [outer, inner] tensor in boxes of [box_outer, box_inner]
// with the 128-byte swizzle; loads past the edge fill zeros.
bool bf16_map(CUtensorMap* map, const void* base, uint64_t inner, uint64_t outer,
              uint32_t box_inner, uint32_t box_outer) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {inner * 2};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int sm_count(int dev) {
  static std::atomic<int> counts[32];
  int n = counts[dev & 31].load();
  if (n == 0) {
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
    counts[dev & 31].store(n);
  }
  return n;
}

template <int kBM, int kBN>
int launch_wgmma(const void* x, const void* w, const float* a, const float* c, void* out,
                 float* partials, int* arrivals, int M, int N, int K, int act, int out_bf16,
                 int splits, int stages, cudaStream_t s) {
  using T = Tile<kBM, kBN>;
  CUtensorMap tx, tw;
  if (!bf16_map(&tx, x, K, M, HK, kBM) || !bf16_map(&tw, w, N, K, 64, HK))
    return (int)cudaErrorInvalidValue;
  const int staging = 64 * T::SN * (out_bf16 ? 2 : 4);  // one consumer's output part
  const int fixed = 1024 + 2 * staging + 4 * T::SN * 4 + 16;
  // the plan's ring is sized for bf16 outputs; f32 staging may take stages
  while (stages > 1 && fixed + stages * (T::STAGE_BYTES + 16) > MAX_SMEM) --stages;
  const int smem = fixed + stages * (T::STAGE_BYTES + 16);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  // the dynamic shared memory limit, raised once per device for this tile
  static std::atomic<unsigned> raised{0};
  const unsigned bit = 1u << (dev & 31);
  if (!(raised.load() & bit)) {
    e = cudaFuncSetAttribute(epilogue_gemm_wgmma<kBM, kBN>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (e != cudaSuccess) return (int)e;
    raised.fetch_or(bit);
  }
  const long long units =
      (long long)((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN) * splits;
  if (units >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  const int sms = sm_count(dev);
  const unsigned grid = (unsigned)(units < sms ? units : sms);
  epilogue_gemm_wgmma<kBM, kBN><<<grid, HTHREADS, smem, s>>>(
      tx, tw, a, c, out, partials, arrivals, M, N, K, act, out_bf16, splits, stages, staging);
  return (int)cudaGetLastError();
}

// ------------------------------- bf16 path for shapes TMA cannot describe

// a 128 x 64 output tile per 256-thread block, eight warps of 32 x 32 in
// mma.sync.m16n8k16 (the fp32 body below uses the same tile)
constexpr int BM = 128;
constexpr int BN = 64;
constexpr int THREADS = 256;

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
    epilogue_gemm_mma_sync(const __nv_bfloat16* __restrict__ x,
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

int launch_tma(const void* x, const void* w, const float* a, const float* c, void* out,
               float* partials, int* arrivals, int M, int N, int K, int act,
               int out_bf16, int bm, int bn, int splits, int stages, cudaStream_t s) {
  const int steps = (K + HK - 1) / HK;
  if (splits < 1 || steps % splits || stages < 1 ||
      (splits > 1 && (partials == nullptr || arrivals == nullptr)))
    return (int)cudaErrorInvalidValue;
#define CE_TILE(m, n)                                                                  \
  if (bm == m && bn == n)                                                              \
    return launch_wgmma<m, n>(x, w, a, c, out, partials, arrivals, M, N, K, act, out_bf16, \
                              splits, stages, s);
  CE_TILE(128, 64)
  CE_TILE(128, 128)
  CE_TILE(128, 256)
  CE_TILE(64, 128)
#undef CE_TILE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point, loaded with ctypes. Launches on `stream`, does not
// synchronise, allocates nothing, and returns the launch's cudaError_t
// (0 on success; -1 for a dtype pair the kernel does not take).
// (bm, bn, splits, stages) is the wrapper's plan for the bf16 TMA body;
// with splits > 1, `partials` holds splits x tiles x bm x bn floats and
// `arrivals` one int a tile, all 0 (the kernel leaves them 0).
extern "C" int conv_epilogue_launch(const void* x, const void* w, const void* a,
                                    const void* c, void* out, int M, int N, int K,
                                    int in_dtype, int out_dtype, int act, int bm,
                                    int bn, int splits, int stages, void* partials,
                                    void* arrivals, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  const dim3 block(THREADS);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* cf = static_cast<const float*>(c);
  if (out_dtype != DT_BF16 && out_dtype != DT_F32) return -1;
  if (in_dtype == DT_BF16) {
    if (K % 8 == 0 && N % 8 == 0 && aligned16(x) && aligned16(w) && aligned16(out))
      return launch_tma(x, w, af, cf, out, static_cast<float*>(partials),
                        static_cast<int*>(arrivals), M, N, K, act, out_dtype == DT_BF16,
                        bm, bn, splits, stages, s);
    const int vec = (K % 8 == 0) && (N % 8 == 0) && aligned16(x) && aligned16(w);
    const auto* xb = static_cast<const __nv_bfloat16*>(x);
    const auto* wb = static_cast<const __nv_bfloat16*>(w);
    if (out_dtype == DT_BF16)
      epilogue_gemm_mma_sync<__nv_bfloat16><<<grid, block, 0, s>>>(
          xb, wb, af, cf, static_cast<__nv_bfloat16*>(out), M, N, K, act, vec);
    else
      epilogue_gemm_mma_sync<float><<<grid, block, 0, s>>>(
          xb, wb, af, cf, static_cast<float*>(out), M, N, K, act, vec);
  } else if (in_dtype == DT_F32) {
    const auto* xf = static_cast<const float*>(x);
    const auto* wf = static_cast<const float*>(w);
    if (out_dtype == DT_F32)
      epilogue_gemm_f32<float><<<grid, block, 0, s>>>(
          xf, wf, af, cf, static_cast<float*>(out), M, N, K, act);
    else
      epilogue_gemm_f32<__nv_bfloat16><<<grid, block, 0, s>>>(
          xf, wf, af, cf, static_cast<__nv_bfloat16*>(out), M, N, K, act);
  } else {
    return -1;
  }
  return (int)cudaGetLastError();
}
