// K5: the train step's optimizer for Hopper (sm_90a): the global norm of
// the gradients, then the clipped AdamW update, each over every leaf of a
// param tree in one launch.
//
// Replaces no Pallas kernel: the reference leaves optax's
// chain(clip_by_global_norm, adamw) to XLA.  The plain version
// (ops/optim.py) runs the same arithmetic as about fifteen PyTorch
// elementwise passes a leaf.
//
// Bound: bytes.  The update's arithmetic needs each f32 element of the
// grads read twice and of the params and both moments read and written
// once: 32 bytes a parameter, against about 152 for the per-leaf passes.
// Its operations (two divisions, a square root, a few multiply-adds an
// element) are an order of magnitude below the card's f32 rate at
// 3.35 TB/s.  Two passes are the least: the clip scales every grad by
// clip / norm, and the norm is a sum over all grads, so no element can be
// updated before the last grad is read.  So the design:
//
// - Pass 1, rtt_optim_sumsq_kernel, reads g once (4 B).  Each block sums
//   the f32 squares of its chunks in f64, and writes one f64 partial; the
//   last block of the last launch to take its ticket (an integer atomic)
//   sums the partials in a fixed order, takes the square root and writes
//   the norm as a 0-d f32.  The grid and the chunks' order depend on the
//   tree and the card alone, so the norm is bitwise the same from run to
//   run; no float atomic.  The partials are f64 so that the sum of 10^9
//   squares stays within a few f32 ulps of the plain version's pairwise
//   f32 sums.
// - Pass 2, rtt_optim_adamw_kernel, reads p, g, m, v once and writes p,
//   m, v once, in place (28 B).  It reads the norm from its pointer and
//   clips on the device, g / norm * clip when norm >= clip as the plain
//   version does, so the host never waits on the norm and no clipped
//   copy of the grads is made.  The scalars (lr, b1, b2, eps, the weight
//   decay and the bias corrections) come from the host, which computes
//   them from the host-side step count.
// - One launch a pass: a pointer table of up to SUMSQ_LEAVES or
//   ADAMW_LEAVES leaves rides in the kernel's parameters (within the
//   4 KB that every CUDA version takes), with each leaf's size and its
//   first chunk.  A block walks chunks blockIdx.x, + gridDim.x, ... of
//   the whole table (neighbouring blocks on neighbouring chunks), and a
//   leaf cursor that only moves forward finds each chunk's leaf.  A
//   larger tree is split by the host into as few launches as its tables
//   need.
// - 16-byte loads and stores: chunks are whole float4 runs of a leaf, so
//   a leaf that starts on 16 bytes is read in float4s, with a scalar tail
//   at its end; a leaf that does not (a view at an odd offset) is read
//   element by element.  Each thread issues its VEC loads of every
//   tensor before it uses any, to keep bytes in flight.  Loads and stores
//   are marked streaming (evict first): nothing is read twice within a
//   pass, and the hint took the update from 2.73 to 2.84 TB/s on the
//   Mixtral tree (H100 SXM; VEC 4 at 2 blocks an SM read 2.85, VEC 1 at
//   8 read 2.51).
//
// Takes contiguous f32 leaves; the wrapper makes a grad that is not
// contiguous (an expanded view) contiguous and raises on the rest.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 4;  // __launch_bounds__: all blocks resident
constexpr int SUMSQ_VEC = 4;      // float4s a thread loads a chunk
constexpr int ADAMW_VEC = 2;
constexpr long long SUMSQ_CHUNK = THREADS * 4 * SUMSQ_VEC;  // 4096 elements
constexpr long long ADAMW_CHUNK = THREADS * 4 * ADAMW_VEC;  // 2048 elements
constexpr int SUMSQ_LEAVES = 160;
constexpr int ADAMW_LEAVES = 80;
constexpr int PARAM_LIMIT = 4096;  // bytes of a kernel's parameters
constexpr unsigned FULL = 0xffffffffu;

struct SumsqTable {
  const float* g[SUMSQ_LEAVES];
  long long numel[SUMSQ_LEAVES];
  long long chunk0[SUMSQ_LEAVES + 1];  // [i]: leaf i's first chunk; [n]: all
  int n;
};

struct AdamwTable {
  float* p[ADAMW_LEAVES];
  const float* g[ADAMW_LEAVES];
  float* m[ADAMW_LEAVES];
  float* v[ADAMW_LEAVES];
  long long numel[ADAMW_LEAVES];
  long long chunk0[ADAMW_LEAVES + 1];
  int n;
};

struct AdamwScalars {
  float clip, b1, omb1, b2, omb2, bc1, bc2, eps, wd, lr;
};

// Each kernel's other parameters take well under 128 bytes.
static_assert(sizeof(SumsqTable) + 128 <= PARAM_LIMIT, "sumsq table");
static_assert(sizeof(AdamwTable) + sizeof(AdamwScalars) + 128 <= PARAM_LIMIT,
              "adamw table");

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Elements e..e+3 of a leaf of n elements (0 past its end).
__device__ __forceinline__ float4 load4(const float* p, long long e,
                                        long long n, bool vec) {
  if (vec && e + 4 <= n) return __ldcs(reinterpret_cast<const float4*>(p + e));
  float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
  if (e < n) x.x = p[e];
  if (e + 1 < n) x.y = p[e + 1];
  if (e + 2 < n) x.z = p[e + 2];
  if (e + 3 < n) x.w = p[e + 3];
  return x;
}

__device__ __forceinline__ void store4(float* p, long long e, long long n,
                                       bool vec, float4 x) {
  if (vec && e + 4 <= n) {
    __stcs(reinterpret_cast<float4*>(p + e), x);
    return;
  }
  if (e < n) p[e] = x.x;
  if (e + 1 < n) p[e + 1] = x.y;
  if (e + 2 < n) p[e + 2] = x.z;
  if (e + 3 < n) p[e + 3] = x.w;
}

__device__ __forceinline__ double sq(float x) {
  return static_cast<double>(__fmul_rn(x, x));
}

// The block's sum of every thread's x, in a fixed order; valid in thread 0.
__device__ __forceinline__ double block_sum(double x) {
  __shared__ double warps[THREADS / 32];
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(FULL, x, o);
  __syncthreads();  // warps[] may still be read by a previous call
  if ((threadIdx.x & 31) == 0) warps[threadIdx.x >> 5] = x;
  __syncthreads();
  double s = 0.0;
  if (threadIdx.x == 0)
    for (int w = 0; w < THREADS / 32; ++w) s += warps[w];
  return s;
}

// Sum of squares of the table's leaves into partials[base + blockIdx.x];
// the last block of the launch resets *counter, and with `last` also sums
// partials[0, total) and writes sqrt of it to *out.
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
    rtt_optim_sumsq_kernel(const SumsqTable t, double* partials,
                           unsigned* counter, float* out, int base,
                           int total, int last) {
  double acc = 0.0;
  int leaf = 0;
  const long long nchunks = t.chunk0[t.n];
  for (long long c = blockIdx.x; c < nchunks; c += gridDim.x) {
    while (c >= t.chunk0[leaf + 1]) ++leaf;
    const float* g = t.g[leaf];
    const long long n = t.numel[leaf];
    const bool vec = aligned16(g);
    const long long start = (c - t.chunk0[leaf]) * SUMSQ_CHUNK;
    float4 x[SUMSQ_VEC];
#pragma unroll
    for (int j = 0; j < SUMSQ_VEC; ++j)
      x[j] = load4(g, start + (j * THREADS + threadIdx.x) * 4LL, n, vec);
#pragma unroll
    for (int j = 0; j < SUMSQ_VEC; ++j)
      acc += sq(x[j].x) + sq(x[j].y) + sq(x[j].z) + sq(x[j].w);
  }
  const double s = block_sum(acc);
  __shared__ bool is_last;
  if (threadIdx.x == 0) {
    partials[base + blockIdx.x] = s;
    __threadfence();
    is_last = atomicAdd(counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  if (threadIdx.x == 0) *counter = 0;  // ready for the next launch
  if (!last) return;
  double part = 0.0;
  for (int i = threadIdx.x; i < total; i += THREADS)
    part += __ldcg(partials + i);  // from L2: other blocks wrote them
  const double all = block_sum(part);
  if (threadIdx.x == 0) *out = static_cast<float>(sqrt(all));
}

__device__ __forceinline__ void adamw1(float& p, float g, float& m, float& v,
                                       const AdamwScalars& s, bool clip,
                                       float norm) {
  if (clip) g = __fmul_rn(__fdiv_rn(g, norm), s.clip);
  m = s.b1 * m + s.omb1 * g;
  v = s.b2 * v + s.omb2 * g * g;
  const float upd = __fdiv_rn(__fdiv_rn(m, s.bc1),
                              __fsqrt_rn(__fdiv_rn(v, s.bc2)) + s.eps) +
                    s.wd * p;
  p = p - s.lr * upd;
}

// One AdamW step of every leaf of the table, in place.  norm: the global
// norm of the raw grads (nullptr: no clip).
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
    rtt_optim_adamw_kernel(const AdamwTable t, const AdamwScalars s,
                           const float* norm) {
  float nrm = 1.f;
  bool clip = false;
  if (norm != nullptr) {
    nrm = __ldg(norm);
    clip = !(nrm < s.clip);  // as the plain where(norm < clip, g, ...)
  }
  int leaf = 0;
  const long long nchunks = t.chunk0[t.n];
  for (long long c = blockIdx.x; c < nchunks; c += gridDim.x) {
    while (c >= t.chunk0[leaf + 1]) ++leaf;
    float* p = t.p[leaf];
    const float* g = t.g[leaf];
    float* m = t.m[leaf];
    float* v = t.v[leaf];
    const long long n = t.numel[leaf];
    const bool vec = aligned16(p) && aligned16(g) && aligned16(m) &&
                     aligned16(v);
    const long long start = (c - t.chunk0[leaf]) * ADAMW_CHUNK;
    float4 px[ADAMW_VEC], gx[ADAMW_VEC], mx[ADAMW_VEC], vx[ADAMW_VEC];
#pragma unroll
    for (int j = 0; j < ADAMW_VEC; ++j) {
      const long long e = start + (j * THREADS + threadIdx.x) * 4LL;
      gx[j] = load4(g, e, n, vec);
      px[j] = load4(p, e, n, vec);
      mx[j] = load4(m, e, n, vec);
      vx[j] = load4(v, e, n, vec);
    }
#pragma unroll
    for (int j = 0; j < ADAMW_VEC; ++j) {
      const long long e = start + (j * THREADS + threadIdx.x) * 4LL;
      adamw1(px[j].x, gx[j].x, mx[j].x, vx[j].x, s, clip, nrm);
      adamw1(px[j].y, gx[j].y, mx[j].y, vx[j].y, s, clip, nrm);
      adamw1(px[j].z, gx[j].z, mx[j].z, vx[j].z, s, clip, nrm);
      adamw1(px[j].w, gx[j].w, mx[j].w, vx[j].w, s, clip, nrm);
      store4(p, e, n, vec, px[j]);
      store4(m, e, n, vec, mx[j]);
      store4(v, e, n, vec, vx[j]);
    }
  }
}

// Fills a table's shared columns; false if the host's plan does not fit.
template <int L>
bool fill(int n, const long long* numel, const long long* chunk0,
          long long chunk, long long (&t_numel)[L],
          long long (&t_chunk0)[L + 1], int& t_n) {
  if (n < 1 || n > L || chunk0[0] != 0) return false;
  for (int i = 0; i < n; ++i) {
    if (numel[i] < 1 ||
        chunk0[i + 1] - chunk0[i] != (numel[i] + chunk - 1) / chunk)
      return false;
    t_numel[i] = numel[i];
    t_chunk0[i] = chunk0[i];
  }
  t_chunk0[n] = chunk0[n];
  t_n = n;
  return true;
}

}  // namespace

extern "C" int rtt_optim_sumsq(int n, const uint64_t* g,
                               const long long* numel,
                               const long long* chunk0, void* partials,
                               void* counter, void* out, int base, int total,
                               int last, int grid, void* stream) {
  SumsqTable t;
  if (!fill<SUMSQ_LEAVES>(n, numel, chunk0, SUMSQ_CHUNK, t.numel, t.chunk0,
                         t.n) ||
      grid < 1 || base < 0 || base + grid > total || partials == nullptr ||
      counter == nullptr || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < n; ++i) t.g[i] = reinterpret_cast<const float*>(g[i]);
  rtt_optim_sumsq_kernel<<<grid, THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      t, static_cast<double*>(partials), static_cast<unsigned*>(counter),
      static_cast<float*>(out), base, total, last);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rtt_optim_adamw(int n, const uint64_t* p, const uint64_t* g,
                               const uint64_t* m, const uint64_t* v,
                               const long long* numel,
                               const long long* chunk0, const void* norm,
                               float clip, float b1, float omb1, float b2,
                               float omb2, float bc1, float bc2, float eps,
                               float wd, float lr, int grid, void* stream) {
  AdamwTable t;
  if (!fill<ADAMW_LEAVES>(n, numel, chunk0, ADAMW_CHUNK, t.numel, t.chunk0,
                         t.n) ||
      grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < n; ++i) {
    t.p[i] = reinterpret_cast<float*>(p[i]);
    t.g[i] = reinterpret_cast<const float*>(g[i]);
    t.m[i] = reinterpret_cast<float*>(m[i]);
    t.v[i] = reinterpret_cast<float*>(v[i]);
  }
  const AdamwScalars s{clip, b1, omb1, b2, omb2, bc1, bc2, eps, wd, lr};
  rtt_optim_adamw_kernel<<<grid, THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      t, s, static_cast<const float*>(norm));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rtt_optim_limits(int* out) {
  // What the host plans its launches with (ops/optim.py's Limits).
  out[0] = static_cast<int>(SUMSQ_CHUNK);
  out[1] = static_cast<int>(ADAMW_CHUNK);
  out[2] = SUMSQ_LEAVES;
  out[3] = ADAMW_LEAVES;
  out[4] = BLOCKS_PER_SM;
  return 0;
}

extern "C" const char* rtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
