// K1: flash-attention forward for Hopper (sm_90a), bf16 in, f32 accumulate.
//
// Replaces: ray_tpu/ops/attention.py::_fwd_kernel (the Pallas TPU kernel
// launched by _fwd_call).  Same algorithm: q arrives pre-scaled by
// sm_scale*log2(e) (the wrapper rounds it back to bf16, as the reference
// does), the softmax runs online in the log2 domain with exp2, the finite
// NEG_INF = -1e30 masks, fully masked causal kv tiles are never visited,
// o = acc / l and lse = m + log2(l).
//
// Bound: at the flagship shape (b=4, s=512, h=6, d=128, causal) q, k, v and o
// are 3.15 MB each, 12.6 MB in all: about 3.8 us at 3.35 TB/s.  The causal
// product work is about 1.61 GFLOP: about 1.6 us at 989 TFLOP/s (bf16 tensor
// cores).  So the call is bound by memory.  The design reads each q tile once
// into registers and each k/v tile once per q tile into shared memory, keeps
// the 64 x d accumulator and the running (m, l) in f32 registers and never
// writes the s x s score matrix: device memory sees q, k, v once per q tile
// and o, lse once.  Both products run on the tensor cores (mma.sync
// m16n8k16 bf16 -> f32).  Not done yet (work for a later, faster version):
// cp.async/TMA double buffering of the k/v tiles and wgmma.
//
// Layout: q, o are (b, sq, h, d) and k, v are (b, sk, h_kv, d), contiguous,
// read through their strides (no transposes); GQA maps q head -> kv head
// h / (h / h_kv).  lse is (b, h, sq) f32.  Ragged sequence tails are masked
// here (rows past sq are not stored, columns past sk are masked), so any
// sq, sk >= 1 runs.
//
// Grid: one block per (tile of 64 query rows, head, batch); 4 warps, each
// owning 16 query rows.  A loop inside the block walks the kv tiles (it stops
// at the diagonal when causal) and replaces the TPU's sequential grid axis.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_Q = 64;
constexpr int BLOCK_K = 64;
constexpr int THREADS = 128;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 -> one register of two bf16 (round to nearest even); `lo` takes the
// lower column index, as the mma fragments expect.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                 const uint16_t* __restrict__ v, uint16_t* __restrict__ o,
                 float* __restrict__ lse, int H, int Hkv, int sq, int sk,
                 int causal) {
  constexpr int STR = D + 8;             // padded smem row: conflict-free
  constexpr int KSTEPS = D / 16;         // contraction steps of Q K^T
  constexpr int DTILES = D / 8;          // n-tiles of the output
  constexpr int STILES = BLOCK_K / 8;    // n-tiles of the score tile
  __shared__ __align__(16) uint16_t Ks[BLOCK_K * STR];
  __shared__ __align__(16) uint16_t Vs[BLOCK_K * STR];

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment row / column group
  const int q0 = qt * BLOCK_Q;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;  // this thread's two rows

  const size_t q_row = (size_t)H * D;    // elements between positions
  const size_t kv_row = (size_t)Hkv * D;
  const uint16_t* qb = q + (size_t)b * sq * q_row + (size_t)h * D;
  const uint16_t* kb = k + (size_t)b * sk * kv_row + (size_t)hk * D;
  const uint16_t* vb = v + (size_t)b * sk * kv_row + (size_t)hk * D;

  // Q fragments (A operand of S = Q K^T), in registers for the whole loop.
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    const int c = ks * 16 + 2 * t;
    qf[ks][0] = r0 < sq ? ld32(qb + r0 * q_row + c) : 0u;
    qf[ks][1] = r1 < sq ? ld32(qb + r1 * q_row + c) : 0u;
    qf[ks][2] = r0 < sq ? ld32(qb + r0 * q_row + c + 8) : 0u;
    qf[ks][3] = r1 < sq ? ld32(qb + r1 * q_row + c + 8) : 0u;
  }

  float acc[DTILES][4];
#pragma unroll
  for (int dt = 0; dt < DTILES; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};  // per-thread partial row sums (quad-reduced last)

  int nk = (sk + BLOCK_K - 1) / BLOCK_K;
  if (causal) nk = min(nk, (q0 + BLOCK_Q - 1) / BLOCK_K + 1);

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BLOCK_K;
    __syncthreads();  // every warp is done with the previous tile
    constexpr int CHUNKS = BLOCK_K * D / 8;  // 16-byte chunks per tile
    for (int i = tid; i < CHUNKS; i += THREADS) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      uint4 kk = make_uint4(0u, 0u, 0u, 0u), vv = kk;
      if (k0 + r < sk) {
        kk = *reinterpret_cast<const uint4*>(kb + (size_t)(k0 + r) * kv_row + c);
        vv = *reinterpret_cast<const uint4*>(vb + (size_t)(k0 + r) * kv_row + c);
      }
      *reinterpret_cast<uint4*>(Ks + r * STR + c) = kk;
      *reinterpret_cast<uint4*>(Vs + r * STR + c) = vv;
    }
    __syncthreads();

    // S = Q K^T: this warp's 16 rows x BLOCK_K columns, f32.
    float s[STILES][4];
#pragma unroll
    for (int nt = 0; nt < STILES; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        const uint16_t* kp = Ks + (nt * 8 + g) * STR + ks * 16 + 2 * t;
        mma_bf16(s[nt], qf[ks], ld32(kp), ld32(kp + 8));
      }
    }
    // Mask the ragged tail and, on the diagonal tile, the causal triangle.
    if (k0 + BLOCK_K > sk || (causal && k0 + BLOCK_K - 1 > q0)) {
#pragma unroll
      for (int nt = 0; nt < STILES; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + nt * 8 + 2 * t + (e & 1);
          const int row = e < 2 ? r0 : r1;
          if (col >= sk || (causal && col > row)) s[nt][e] = NEG_INF;
        }
    }
    // Online softmax, log2 domain.  Each row lives in the 4 lanes of a quad.
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < STILES; ++nt) {
      mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    }
    const float alpha0 = exp2f(m[0] - mx[0]), alpha1 = exp2f(m[1] - mx[1]);
    m[0] = mx[0];
    m[1] = mx[1];
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < STILES; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - mx[0]);
      s[nt][1] = exp2f(s[nt][1] - mx[0]);
      s[nt][2] = exp2f(s[nt][2] - mx[1]);
      s[nt][3] = exp2f(s[nt][3] - mx[1]);
      rs0 += s[nt][0] + s[nt][1];
      rs1 += s[nt][2] + s[nt][3];
    }
    l[0] = l[0] * alpha0 + rs0;
    l[1] = l[1] * alpha1 + rs1;
#pragma unroll
    for (int dt = 0; dt < DTILES; ++dt) {
      acc[dt][0] *= alpha0;
      acc[dt][1] *= alpha0;
      acc[dt][2] *= alpha1;
      acc[dt][3] *= alpha1;
    }
    // O += P V with P rounded to bf16 (the reference's p.astype(v.dtype)).
    // The score tile's accumulator layout is the A-fragment layout of P.
#pragma unroll
    for (int ks = 0; ks < BLOCK_K / 16; ++ks) {
      const uint32_t pa[4] = {pack_bf16(s[2 * ks][0], s[2 * ks][1]),
                              pack_bf16(s[2 * ks][2], s[2 * ks][3]),
                              pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]),
                              pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3])};
#pragma unroll
      for (int dt = 0; dt < DTILES; ++dt) {
        const uint16_t* vp = Vs + (ks * 16 + 2 * t) * STR + dt * 8 + g;
        const uint32_t b0 = (uint32_t)vp[0] | ((uint32_t)vp[STR] << 16);
        const uint32_t b1 =
            (uint32_t)vp[8 * STR] | ((uint32_t)vp[9 * STR] << 16);
        mma_bf16(acc[dt], pa, b0, b1);
      }
    }
  }

  // Finalize: full row sums, o = acc / l in bf16, lse = m + log2(l).
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  uint16_t* ob = o + (size_t)b * sq * q_row + (size_t)h * D;
#pragma unroll
  for (int dt = 0; dt < DTILES; ++dt) {
    const int c = dt * 8 + 2 * t;
    if (r0 < sq)
      *reinterpret_cast<uint32_t*>(ob + r0 * q_row + c) =
          pack_bf16(acc[dt][0] / l[0], acc[dt][1] / l[0]);
    if (r1 < sq)
      *reinterpret_cast<uint32_t*>(ob + r1 * q_row + c) =
          pack_bf16(acc[dt][2] / l[1], acc[dt][3] / l[1]);
  }
  if (t == 0) {
    float* lb = lse + ((size_t)b * H + h) * sq;
    if (r0 < sq) lb[r0] = m[0] + log2f(l[0]);
    if (r1 < sq) lb[r1] = m[1] + log2f(l[1]);
  }
}

}  // namespace

extern "C" int rtt_flash_fwd_bf16(const void* q, const void* k, const void* v,
                                  void* o, void* lse, int B, int H, int Hkv,
                                  int sq, int sk, int D, int causal,
                                  void* stream) {
  const dim3 grid((sq + BLOCK_Q - 1) / BLOCK_Q, H, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* q_ = static_cast<const uint16_t*>(q);
  const auto* k_ = static_cast<const uint16_t*>(k);
  const auto* v_ = static_cast<const uint16_t*>(v);
  auto* o_ = static_cast<uint16_t*>(o);
  auto* l_ = static_cast<float*>(lse);
  switch (D) {
    case 32:
      flash_fwd_kernel<32><<<grid, THREADS, 0, st>>>(q_, k_, v_, o_, l_, H, Hkv,
                                                     sq, sk, causal);
      break;
    case 64:
      flash_fwd_kernel<64><<<grid, THREADS, 0, st>>>(q_, k_, v_, o_, l_, H, Hkv,
                                                     sq, sk, causal);
      break;
    case 128:
      flash_fwd_kernel<128><<<grid, THREADS, 0, st>>>(q_, k_, v_, o_, l_, H,
                                                      Hkv, sq, sk, causal);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
