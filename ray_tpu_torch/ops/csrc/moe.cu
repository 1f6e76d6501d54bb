// K6: the MoE layer's dispatch and combine for Hopper (sm_90a), as two
// row movers driven by the routing's slot tables (ops/moe.py).
//
// Replaces no Pallas kernel: the reference computes the dispatch and the
// combine in XLA, as einsums with dense (T, E, C) one-hot tensors
// (ray_tpu/ops/moe.py).  On the card those einsums were GEMMs of
// 2·T·E·C·d operations each (5.5 TFLOP at Mixtral's T = 16384, E = 8,
// C = 5120, d = 4096), in which one product in E·C is not zero.  These
// kernels skip the one-hot product and move the rows it selects.
//
// Bound: bytes.  The dispatch writes E·C rows of d and reads the kept
// rows of x; the combine reads the kept rows of the expert outputs and
// writes T rows; a row's arithmetic is one multiply (and one add, or one
// multiply-add for the dot) an element, far below the card's rate.  So:
//
// - rtt_moe_gather_kernel, slot-major: one warp a slot s.  The slot's
//   (token, choice) a = source[s] (-1: empty) gives the row a / k of src
//   and the weight w[a]; out[s] = w[a] · src[a / k] in f32, stored in
//   src's type, zeros where empty (the expert GEMMs read every slot).
//   With b, the warp also reads b[s] and writes dot[s] = <src[a / k],
//   b[s]> in f32, 0 where empty: the combine's backward, grad of the
//   expert outputs and of the gates in one pass.
// - rtt_moe_combine_kernel, token-major: one warp a token t;
//   out[t] = sum over c of w[t, c] · src[slot[t, c]], over the kept
//   choices (slot >= 0), in f32 in the order of c, stored in src's type.
//   It is also the dispatch's backward (w = nullptr: weight 1).
// - 16-byte loads and stores (8 bf16 or 4 f32), each lane UNROLL of them
//   in flight; a row is d / 8 or d / 4 such vectors, d a multiple of 8.
// - No atomics: each output element is written by one lane, and each
//   dot is a lane's running sum in a fixed order, then a fixed butterfly
//   across the warp, so two runs give the same bits.  Products and sums
//   are rounded one at a time (__fmul_rn, __fadd_rn), as the plain
//   versions round them.
//
// Takes contiguous rows starting on 16 bytes; the wrapper checks dtype,
// shape, device and alignment, and the C launchers check them again.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;
constexpr unsigned FULL = 0xffffffffu;

// 16 bytes of T as floats, and back (round to nearest even).
template <typename T>
struct Vec;

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4& u, float (&x)[N]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
  __device__ static uint4 pack(const float (&x)[N]) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < N / 2; ++i)
      h[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
    return u;
  }
  __device__ static float one(const __nv_bfloat16 v) {
    return __bfloat162float(v);
  }
};

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4& u, float (&x)[N]) {
    x[0] = __uint_as_float(u.x);
    x[1] = __uint_as_float(u.y);
    x[2] = __uint_as_float(u.z);
    x[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 pack(const float (&x)[N]) {
    return make_uint4(__float_as_uint(x[0]), __float_as_uint(x[1]),
                      __float_as_uint(x[2]), __float_as_uint(x[3]));
  }
  __device__ static float one(const float v) { return v; }
};

// out[s] = w[a] * src[a / k] (w == nullptr: a copy), a = source[s];
// zeros where a < 0.  With b: dot[s] = <src[a / k], b[s]>.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    rtt_moe_gather_kernel(const T* __restrict__ src,
                          const int* __restrict__ source, int k,
                          const T* __restrict__ w, const T* __restrict__ b,
                          float* __restrict__ dot, T* __restrict__ out,
                          int slots, int vecs) {
  using V = Vec<T>;
  const int s = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (s >= slots) return;  // warp-uniform
  const int lane = threadIdx.x & 31;
  const int a = __ldg(source + s);
  uint4* o = reinterpret_cast<uint4*>(out) + static_cast<long long>(s) * vecs;
  if (a < 0) {
    for (int j = lane; j < vecs; j += 32) o[j] = make_uint4(0u, 0u, 0u, 0u);
    if (dot != nullptr && lane == 0) dot[s] = 0.f;
    return;
  }
  const uint4* row = reinterpret_cast<const uint4*>(src) +
                     static_cast<long long>(a / k) * vecs;
  const uint4* brow =
      b == nullptr ? nullptr
                   : reinterpret_cast<const uint4*>(b) +
                         static_cast<long long>(s) * vecs;
  const float ws = w == nullptr ? 1.f : V::one(w[a]);
  float acc = 0.f;
  for (int j0 = lane; j0 < vecs; j0 += 32 * UNROLL) {
    uint4 x[UNROLL], y[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = j0 + u * 32;
      if (j < vecs) {
        x[u] = __ldg(row + j);
        if (brow != nullptr) y[u] = __ldg(brow + j);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = j0 + u * 32;
      if (j >= vecs) break;
      if (brow == nullptr && w == nullptr) {
        o[j] = x[u];
        continue;
      }
      float f[V::N];
      V::unpack(x[u], f);
      if (brow != nullptr) {
        float g[V::N];
        V::unpack(y[u], g);
#pragma unroll
        for (int i = 0; i < V::N; ++i) acc = __fmaf_rn(f[i], g[i], acc);
      }
      if (w != nullptr) {
#pragma unroll
        for (int i = 0; i < V::N; ++i) f[i] = __fmul_rn(ws, f[i]);
        o[j] = V::pack(f);
      } else {
        o[j] = x[u];
      }
    }
  }
  if (dot != nullptr) {
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) acc += __shfl_xor_sync(FULL, acc, m);
    if (lane == 0) dot[s] = acc;
  }
}

// out[t] = sum over c < k with slot[t*k + c] >= 0, in order, of
// w[t*k + c] * src[slot[t*k + c]] (w == nullptr: weight 1).
template <typename T>
__global__ void __launch_bounds__(THREADS)
    rtt_moe_combine_kernel(const T* __restrict__ src,
                           const int* __restrict__ slot, int k,
                           const T* __restrict__ w, T* __restrict__ out,
                           int tokens, int vecs) {
  using V = Vec<T>;
  const int t = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (t >= tokens) return;  // warp-uniform
  const int lane = threadIdx.x & 31;
  uint4* o = reinterpret_cast<uint4*>(out) + static_cast<long long>(t) * vecs;
  for (int j0 = lane; j0 < vecs; j0 += 32 * UNROLL) {
    float acc[UNROLL][V::N];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
#pragma unroll
      for (int i = 0; i < V::N; ++i) acc[u][i] = 0.f;
    for (int c = 0; c < k; ++c) {
      const int s = __ldg(slot + t * k + c);
      if (s < 0) continue;  // warp-uniform
      const float wc = w == nullptr ? 1.f : V::one(w[t * k + c]);
      const uint4* row = reinterpret_cast<const uint4*>(src) +
                         static_cast<long long>(s) * vecs;
      uint4 x[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int j = j0 + u * 32;
        if (j < vecs) x[u] = __ldg(row + j);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (j0 + u * 32 >= vecs) break;
        float f[V::N];
        V::unpack(x[u], f);
#pragma unroll
        for (int i = 0; i < V::N; ++i)
          acc[u][i] = __fadd_rn(acc[u][i],
                                w == nullptr ? f[i] : __fmul_rn(wc, f[i]));
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = j0 + u * 32;
      if (j < vecs) o[j] = V::pack(acc[u]);
    }
  }
}

bool aligned16(const void* p) {
  return p != nullptr && (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

int blocks(int rows) { return (rows + WARPS - 1) / WARPS; }

}  // namespace

// dtype: 0 bfloat16, 1 float32 (ops/moe.py's _DTYPES).  w, b and dot may
// be null; b and dot come together.
extern "C" int rtt_moe_gather(const void* src, const void* source, int k,
                              const void* w, const void* b, void* dot,
                              void* out, int slots, int d, int dtype,
                              void* stream) {
  if (!aligned16(src) || !aligned16(out) || source == nullptr || k < 1 ||
      slots < 0 || d < 8 || d % 8 != 0 || (b == nullptr) != (dot == nullptr) ||
      (b != nullptr && !aligned16(b)) || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (slots == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* idx = static_cast<const int*>(source);
  float* dt = static_cast<float*>(dot);
  if (dtype == 0) {
    using T = __nv_bfloat16;
    rtt_moe_gather_kernel<T><<<blocks(slots), THREADS, 0, st>>>(
        static_cast<const T*>(src), idx, k, static_cast<const T*>(w),
        static_cast<const T*>(b), dt, static_cast<T*>(out), slots,
        d / Vec<T>::N);
  } else {
    rtt_moe_gather_kernel<float><<<blocks(slots), THREADS, 0, st>>>(
        static_cast<const float*>(src), idx, k, static_cast<const float*>(w),
        static_cast<const float*>(b), dt, static_cast<float*>(out), slots,
        d / Vec<float>::N);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rtt_moe_combine(const void* src, const void* slot, int k,
                               const void* w, void* out, int tokens, int d,
                               int dtype, void* stream) {
  if (!aligned16(src) || !aligned16(out) || slot == nullptr || k < 1 ||
      tokens < 0 || d < 8 || d % 8 != 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (tokens == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* sl = static_cast<const int*>(slot);
  if (dtype == 0) {
    using T = __nv_bfloat16;
    rtt_moe_combine_kernel<T><<<blocks(tokens), THREADS, 0, st>>>(
        static_cast<const T*>(src), sl, k, static_cast<const T*>(w),
        static_cast<T*>(out), tokens, d / Vec<T>::N);
  } else {
    rtt_moe_combine_kernel<float><<<blocks(tokens), THREADS, 0, st>>>(
        static_cast<const float*>(src), sl, k, static_cast<const float*>(w),
        static_cast<float*>(out), tokens, d / Vec<float>::N);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
