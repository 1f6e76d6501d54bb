// K4: paged (block-table) decode attention for Hopper (sm_90a).
//
// Replaces: ray_tpu/ops/paged_attention.py::_paged_kernel (the Pallas TPU
// kernel launched by paged_attention).  One query token per sequence attends
// to its context, which sits in a (num_blocks, block_size, h, d) page pool
// reached through block_tables[b, i].  Only the trailing `window` positions
// [max(ctx - window, 0), ctx) count (window 0 = all); pages outside them are
// never read, so table entries past the context may hold anything.  q arrives
// pre-scaled by sm_scale*log2(e); the softmax is an f32 online softmax in the
// log2 domain with the finite NEG_INF = -1e30.
//
// window = 1 must stay an exact gather of the stored row (the serving
// decoder's bitwise chains rest on it): the one live position gives
// m = s, alpha = exp2f(NEG_INF - s) = 0, p = exp2f(0) = 1 exactly (exp2f,
// not a fast approximation), l = 1 and acc = v, and the cross-warp combine
// weighs the live warp by exp2f(0) = 1 and the idle ones by 0.
//
// Bound: at the serving shape (B <= 8 sequences, h = 1, d = 32, f32,
// block_size 8, window 1) a launch moves about 16 KB at most (q, one k and
// one v row per sequence, the tables, o): a few nanoseconds of memory time,
// so the launch overhead (microseconds) bounds it, not memory or arithmetic.
// At long contexts it is bound by reading the live k/v rows; the design reads
// each live row exactly once, coalesced (lanes split d), spreads a sequence's
// pages over the block's 4 warps, and merges the warps' (m, l, acc) once in
// shared memory at the end.
//
// Grid: one block per (head, sequence); each block loads its own block-table
// entries (the TPU kernel's scalar prefetch).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_D = 256;
constexpr int PER = MAX_D / 32;  // d elements per lane, at most
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                    const T* __restrict__ vc, const int* __restrict__ bt,
                    const int* __restrict__ cl, T* __restrict__ o, int H,
                    int D, int BS, int max_pages, int window) {
  __shared__ float sm_m[WARPS], sm_l[WARPS];
  __shared__ float sm_acc[WARPS][MAX_D];
  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  float qv[PER], acc[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int d = lane + 32 * i;
    qv[i] = d < D ? to_f32(q[((size_t)b * H + h) * D + d]) : 0.f;
    acc[i] = 0.f;
  }
  const int ctx = cl[b];
  const int start = window > 0 ? max(ctx - window, 0) : 0;
  float m = NEG_INF, l = 0.f;
  const int last = (ctx - 1) / BS;  // ctx >= 1: the caller's contract
  for (int page = start / BS + warp; page <= last; page += WARPS) {
    const size_t blk = (size_t)bt[(size_t)b * max_pages + page];
    const int lo = max(page * BS, start), hi = min(page * BS + BS, ctx);
    for (int pos = lo; pos < hi; ++pos) {
      const size_t row = ((blk * BS + (pos - page * BS)) * H + h) * D;
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int d = lane + 32 * i;
        if (d < D) s += qv[i] * to_f32(kc[row + d]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);  // same sum in every lane
      const float m_new = fmaxf(m, s);
      const float alpha = exp2f(m - m_new);
      const float p = exp2f(s - m_new);
      l = l * alpha + p;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int d = lane + 32 * i;
        if (d < D) acc[i] = acc[i] * alpha + p * to_f32(vc[row + d]);
      }
      m = m_new;
    }
  }
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int d = lane + 32 * i;
    if (d < D) sm_acc[warp][d] = acc[i];
  }
  __syncthreads();

  float M = sm_m[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) M = fmaxf(M, sm_m[w]);
  float scale[WARPS], L = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    scale[w] = exp2f(sm_m[w] - M);  // idle warps: exp2f(NEG_INF - M) = 0
    L += sm_l[w] * scale[w];
  }
  for (int d = threadIdx.x; d < D; d += THREADS) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) a += sm_acc[w][d] * scale[w];
    o[((size_t)b * H + h) * D + d] = from_f32<T>(a / L);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.
extern "C" int rtt_paged_decode(const void* q, const void* k_cache,
                                const void* v_cache, const void* block_tables,
                                const void* context_lens, void* o, int dtype,
                                int B, int H, int D, int BS, int max_pages,
                                int window, void* stream) {
  if (D < 1 || D > MAX_D) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(H, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* bt = static_cast<const int*>(block_tables);
  const auto* cl = static_cast<const int*>(context_lens);
  if (dtype == 0) {
    paged_decode_kernel<float><<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k_cache),
        static_cast<const float*>(v_cache), bt, cl, static_cast<float*>(o), H,
        D, BS, max_pages, window);
  } else if (dtype == 1) {
    paged_decode_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k_cache),
        static_cast<const __nv_bfloat16*>(v_cache), bt, cl,
        static_cast<__nv_bfloat16*>(o), H, D, BS, max_pages, window);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
