// Fused optimizer update for Hopper (sm_90a): one launch per optimizer step
// over every parameter leaf of the model.
//
// Replaces the Pallas kernels of distribuuuu_tpu/ops/pallas/opt_update.py
// (_sgd_kernel, _sgd_plain_kernel, _adamw_kernel, reached through _call
// from sgd_leaf / adamw_leaf). Per element it computes, with the rounding
// that the jitted JAX kernel has on the CPU (XLA contracts a multiply
// feeding an add into one fused multiply-add):
//
//   SGD, momentum:   u  = fma(wd, p, g)
//                    tn = fma(mom_t, t, u)        mom_t = bf16(mom) for a bf16
//                                                 trace (an exact product)
//                    upd = nesterov ? fma(mom, tn, u) : tn
//                    p' = fma(upd, -lr, p);  t' = tn (rounded to the trace type)
//   SGD, no momentum: p' = fma(fma(wd, p, g), -lr, p)
//   AdamW:           mu' = fma(1-b1, g, b1*mu);  nu' = fma(1-b2, g*g, b2*nu)
//                    u  = mu' / (c1 * (sqrt(nu' / c2) + eps))   (XLA's reassociation
//                                                 of (mu'/c1)/(sqrt(nu'/c2)+eps))
//                    p' = fma(fma(wd, p, u), -lr, p)
//
// Every other product and sum is __fmul_rn / __fadd_rn, so nvcc contracts
// nothing else; sqrt and division are IEEE (-prec-sqrt / -prec-div default).
//
// What bounds it on the H100: nothing but bytes. Each element reads p, g and
// the moments once and writes p and the moments once (12 to 28 bytes for a
// handful of flops), so the whole update is a memory-bound stream; no tensor
// core applies. The TPU kernel tiled each leaf as (rows, 128) and ran one
// call per leaf. Here the leaves are described by a device table and ONE
// launch covers them all: ResNet-50's 161 leaves would otherwise cost 161
// launches of host overhead on a step whose host time already bounds it.
//
// Design (simple and right first; vector loads and a persistent grid later):
//  * table[l] = {p, g, m, v, n, first_chunk} (int64) per leaf; the chunks
//    of CHUNK elements are numbered across leaves, one block per chunk;
//  * a block finds its leaf by a binary search over first_chunk, then its
//    256 threads stride the chunk with coalesced scalar loads;
//  * m is the SGD trace (f32 or bf16) or AdamW's mu, v is AdamW's nu;
//  * the step's constants are read from device memory, not passed by value,
//    so a captured CUDA graph reads each replay's own: row `*step_row` of the
//    table `scal` (N_SCALARS floats a row, in the order of struct Scalars;
//    a fold of K steps stages K rows and `step_row` moves on in the graph), and
//    a device flag `skip` (nonzero: this step leaves every param and moment
//    as it was, the `TRAIN.NONFINITE skip` policy decided on the device).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 16;
constexpr int64_t CHUNK = (int64_t)THREADS * PER_THREAD;

enum Kind { SGD_MOMENTUM = 0, SGD_PLAIN = 1, ADAMW = 2 };

struct Scalars {
  float lr, wd, mom, mom_t, b1, b2, ob1, ob2, eps, c1, c2;
};
constexpr int N_SCALARS = sizeof(Scalars) / sizeof(float);

__device__ __forceinline__ float load_m(const float* m, int64_t i) { return m[i]; }
__device__ __forceinline__ float load_m(const __nv_bfloat16* m, int64_t i) {
  return __bfloat162float(m[i]);
}
__device__ __forceinline__ void store_m(float* m, int64_t i, float v) { m[i] = v; }
__device__ __forceinline__ void store_m(__nv_bfloat16* m, int64_t i, float v) {
  m[i] = __float2bfloat16_rn(v);
}

template <int K, typename MT, bool NESTEROV>
__global__ void __launch_bounds__(THREADS)
    opt_update_kernel(const int64_t* __restrict__ table, int n_leaves,
                      const float* __restrict__ scal, const int* __restrict__ step_row,
                      const float* __restrict__ skip) {
  if (skip != nullptr && *skip != 0.f) return;
  const Scalars s =
      *reinterpret_cast<const Scalars*>(scal + (step_row ? *step_row : 0) * N_SCALARS);
  // leaf of this block: the last l with table[l].first_chunk <= blockIdx.x
  const int64_t chunk = blockIdx.x;
  int lo = 0, hi = n_leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (table[mid * 6 + 5] <= chunk) lo = mid; else hi = mid - 1;
  }
  const int64_t* row = table + lo * 6;
  float* p = reinterpret_cast<float*>(row[0]);
  const float* g = reinterpret_cast<const float*>(row[1]);
  MT* m = reinterpret_cast<MT*>(row[2]);
  float* v = reinterpret_cast<float*>(row[3]);
  const int64_t n = row[4];
  const int64_t begin = (chunk - row[5]) * CHUNK;
  const int64_t end = begin + CHUNK < n ? begin + CHUNK : n;

  for (int64_t i = begin + threadIdx.x; i < end; i += THREADS) {
    const float pi = p[i];
    const float gi = g[i];
    if (K == SGD_MOMENTUM) {
      const float u = __fmaf_rn(s.wd, pi, gi);
      const float tn = __fmaf_rn(s.mom_t, load_m(m, i), u);
      const float upd = NESTEROV ? __fmaf_rn(s.mom, tn, u) : tn;
      p[i] = __fmaf_rn(upd, -s.lr, pi);
      store_m(m, i, tn);
    } else if (K == SGD_PLAIN) {
      p[i] = __fmaf_rn(__fmaf_rn(s.wd, pi, gi), -s.lr, pi);
    } else {
      const float mu = __fmaf_rn(s.ob1, gi, __fmul_rn(s.b1, load_m(m, i)));
      const float nu = __fmaf_rn(s.ob2, __fmul_rn(gi, gi), __fmul_rn(s.b2, v[i]));
      const float den = __fmul_rn(s.c1, __fadd_rn(sqrtf(__fdiv_rn(nu, s.c2)), s.eps));
      const float u = __fmaf_rn(s.wd, pi, __fdiv_rn(mu, den));
      p[i] = __fmaf_rn(u, -s.lr, pi);
      store_m(m, i, mu);
      v[i] = nu;
    }
  }
}

template <int K, typename MT, bool NESTEROV>
cudaError_t launch(const int64_t* table, int n_leaves, int64_t n_chunks, const float* scal,
                   const int* row, const float* skip, cudaStream_t stream) {
  opt_update_kernel<K, MT, NESTEROV>
      <<<(unsigned)n_chunks, THREADS, 0, stream>>>(table, n_leaves, scal, row, skip);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Elements each block updates; the wrapper numbers the chunks with it.
int opt_update_chunk() { return (int)CHUNK; }

// Floats a row of the scalar table; the wrapper checks its layout with it.
int opt_update_n_scalars() { return N_SCALARS; }

// kind: 0 SGD with momentum, 1 SGD without momentum, 2 AdamW.
// trace_bf16: the SGD trace is bf16 (else f32). scal: the device table of
// step constants; row: device int32 row index into it (null: row 0);
// skip: device f32 flag (null: never skip). Returns a cudaError_t.
int opt_update_launch(const int64_t* table, int n_leaves, int64_t n_chunks, int kind,
                      int trace_bf16, int nesterov, const float* scal, const int* row,
                      const float* skip, void* stream) {
  if (n_leaves <= 0 || n_chunks <= 0 || n_chunks > 0x7fffffffLL || scal == nullptr)
    return (int)cudaErrorInvalidValue;
  const float* s = scal;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == SGD_MOMENTUM) {
    if (trace_bf16)
      return nesterov ? launch<SGD_MOMENTUM, __nv_bfloat16, true>(table, n_leaves, n_chunks, s, row, skip, st)
                      : launch<SGD_MOMENTUM, __nv_bfloat16, false>(table, n_leaves, n_chunks, s, row, skip, st);
    return nesterov ? launch<SGD_MOMENTUM, float, true>(table, n_leaves, n_chunks, s, row, skip, st)
                    : launch<SGD_MOMENTUM, float, false>(table, n_leaves, n_chunks, s, row, skip, st);
  }
  if (kind == SGD_PLAIN)
    return launch<SGD_PLAIN, float, false>(table, n_leaves, n_chunks, s, row, skip, st);
  if (kind == ADAMW) return launch<ADAMW, float, false>(table, n_leaves, n_chunks, s, row, skip, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
