// K2 and K3: flash-attention backward for Hopper (sm_90a), bf16 in, f32
// accumulate.
//
// Replaces: ray_tpu/ops/attention.py::_dkdv_kernel (K2) and ::_dq_kernel
// (K3), the two Pallas TPU kernels launched by _bwd_call.  Same algorithm:
// q arrives pre-scaled by sm_scale*log2(e) (rounded to bf16 by the wrapper,
// as the reference does); both kernels recompute p = exp2(s - lse) from the
// saved log2-domain lse, round p (for dv) and ds = p * (dp - delta) (for dk
// and dq) to bf16 before the grad products, accumulate in f32, and scale dk
// by ln 2 and dq by sm_scale at the end.  delta = rowsum(o * do) comes in
// precomputed (f32), as the reference computes it outside its kernels.
//
// Bound: at the flagship shape (b=4, s=512, h=6, d=128, causal) K2 must read
// q, k, v, do and write dk, dv (3.15 MB each) and read lse and delta: 18.97
// MB, about 5.7 us at 3.35 TB/s; its four products over the 131,328 causal
// pairs per head are 3.23 GFLOP, about 3.3 us at 989 TFLOP/s.  K3 moves 15.83
// MB (4.7 us) for 2.42 GFLOP (2.4 us).  Both are bound by memory.  The design
// keeps every tile product on the tensor cores (mma.sync m16n8k16 bf16 ->
// f32) and never writes the s x s matrices: a block stages its fixed tile
// (K2: k and v; K3: q and do) in shared memory once and walks the other
// operand's tiles through shared memory, so device memory sees each fixed
// tile once and each walked tile once per block.  The score tile's
// accumulator layout is reused as the A operand of the next product (as K1
// reuses P), and the B operands that need a transpose (do and q in K2, k in
// K3) are read with ldmatrix.trans.  Not done yet (work for a later, faster
// version): cp.async/TMA double buffering, wgmma, and a single fused kernel
// that writes dq with atomics.
//
// Layout: q, do, dq are (b, sq, h, d) and k, v, dk, dv are (b, sk, h_kv, d),
// contiguous, read through their strides; GQA maps q head -> kv head
// h / (h / h_kv).  lse and delta are (b, h, sq) f32.  Ragged sequence tails
// are masked here (rows past the end are loaded as zeros and never stored;
// their p is 0), so any sq, sk >= 1 runs.
//
// K2 grid: one block per (64-row kv tile, kv head, batch); 4 warps, each
// owning 16 kv rows.  The block loops over the q heads of its kv head and,
// for each, over the q tiles from the causal diagonal to the end, adding
// into the same dk/dv registers.  Warps compute s^T = k q^T directly, so lse
// and delta are indexed by column.  K3 grid: one block per (64-row q tile,
// q head, batch); 4 warps of 16 q rows walk the kv tiles up to the diagonal.
// Both hold s and dp for 32 columns at a time (CHUNK) beside the 64 x d
// accumulators, to stay clear of register spills at d = 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 64;    // rows of the fixed tile and of each walked tile
constexpr int CHUNK = 32;    // walked-tile columns held in registers at once
constexpr int THREADS = 128;
constexpr float NEG_INF = -1e30f;
constexpr float LN2 = 0.6931471805599453f;

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

// A fragment (16 rows x 16 contraction columns) of a row-major smem tile.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const uint16_t* tile,
                                       int stride, int row, int col, int g,
                                       int t) {
  const uint16_t* p = tile + (row + g) * stride + col + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * stride);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * stride + 8);
}

// B fragments of two adjacent n-tiles (n0, n0 + 8) of a product whose B
// operand is stored row-major as [contraction][n] in smem (do, q or k
// tiles): ldmatrix.trans hands each thread rows 2t, 2t+1 of column g.
__device__ __forceinline__ void load_b_trans(uint32_t (&b)[4],
                                             const uint16_t* tile, int stride,
                                             int k0, int n0, int lane) {
  const uint16_t* p = tile + (k0 + (lane & 15)) * stride + n0 + (lane >> 4) * 8;
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
      : "r"(addr));
}

// Copy a BLOCK x D tile of rows [r0, r0 + BLOCK) (row pitch `pitch`
// elements) into smem with row stride D + 8, zeros past `rows`.
template <int D>
__device__ __forceinline__ void load_tile(uint16_t* dst, const uint16_t* src,
                                          size_t pitch, int r0, int rows,
                                          int tid) {
  constexpr int STR = D + 8;
  constexpr int CHUNKS = BLOCK * D / 8;  // 16-byte chunks per tile
  for (int i = tid; i < CHUNKS; i += THREADS) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < rows)
      x = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * pitch + c);
    *reinterpret_cast<uint4*>(dst + r * STR + c) = x;
  }
}

template <int D>
constexpr size_t smem_bytes() {
  return 4 * BLOCK * (D + 8) * sizeof(uint16_t) + 2 * BLOCK * sizeof(float);
}

// ------------------------------------------------------------------- K2

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_dkdv_kernel(const uint16_t* __restrict__ q,
                  const uint16_t* __restrict__ k,
                  const uint16_t* __restrict__ v,
                  const uint16_t* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, uint16_t* __restrict__ dk,
                  uint16_t* __restrict__ dv, int H, int Hkv, int sq, int sk,
                  int causal) {
  constexpr int STR = D + 8;             // padded smem row: conflict-free
  constexpr int KSTEPS = D / 16;         // contraction steps of k q^T
  constexpr int DTILES = D / 8;          // n-tiles of dk, dv
  constexpr int CTILES = CHUNK / 8;      // n-tiles of a chunk of s^T
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* Ks = smem;
  uint16_t* Vs = Ks + BLOCK * STR;
  uint16_t* Qs = Vs + BLOCK * STR;
  uint16_t* Os = Qs + BLOCK * STR;       // the do tile
  float* Ls = reinterpret_cast<float*>(Os + BLOCK * STR);
  float* Ds = Ls + BLOCK;

  const int kt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int group = H / Hkv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment row / column group
  const int k0 = kt * BLOCK, wr = warp * 16;
  const int r0 = k0 + wr + g, r1 = r0 + 8;  // this thread's two kv rows

  const size_t q_row = (size_t)H * D;    // elements between positions
  const size_t kv_row = (size_t)Hkv * D;
  const size_t kv_off = (size_t)b * sk * kv_row + (size_t)hk * D;
  load_tile<D>(Ks, k + kv_off, kv_row, k0, sk, tid);
  load_tile<D>(Vs, v + kv_off, kv_row, k0, sk, tid);

  float dka[DTILES][4], dva[DTILES][4];
#pragma unroll
  for (int dt = 0; dt < DTILES; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[dt][e] = dva[dt][e] = 0.f;

  const int nq = (sq + BLOCK - 1) / BLOCK;
  for (int j = 0; j < group; ++j) {
    const int h = hk * group + j;
    const size_t q_off = (size_t)b * sq * q_row + (size_t)h * D;
    const float* lb = lse + ((size_t)b * H + h) * sq;
    const float* db = delta + ((size_t)b * H + h) * sq;
    for (int qt = causal ? kt : 0; qt < nq; ++qt) {
      const int q0 = qt * BLOCK;
      __syncthreads();  // every warp is done with the previous q tile
      load_tile<D>(Qs, q + q_off, q_row, q0, sq, tid);
      load_tile<D>(Os, dout + q_off, q_row, q0, sq, tid);
      if (tid < BLOCK) {
        Ls[tid] = q0 + tid < sq ? lb[q0 + tid] : 0.f;
        Ds[tid] = q0 + tid < sq ? db[q0 + tid] : 0.f;
      }
      __syncthreads();

      for (int c0 = 0; c0 < BLOCK; c0 += CHUNK) {
        // Warp-uniform skips: the chunk is past sq, or every column of it
        // is above the diagonal for all 16 rows of this warp.
        if (q0 + c0 >= sq || (causal && q0 + c0 + CHUNK - 1 < k0 + wr))
          continue;
        // s^T = k q^T and dp^T = v do^T: 16 kv rows x CHUNK q columns.
        float st[CTILES][4], dpt[CTILES][4];
#pragma unroll
        for (int nt = 0; nt < CTILES; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < KSTEPS; ++ks) {
          uint32_t ak[4], av[4];
          load_a(ak, Ks, STR, wr, ks * 16, g, t);
          load_a(av, Vs, STR, wr, ks * 16, g, t);
#pragma unroll
          for (int nt = 0; nt < CTILES; ++nt) {
            const int off = (c0 + nt * 8 + g) * STR + ks * 16 + 2 * t;
            mma_bf16(st[nt], ak, ld32(Qs + off), ld32(Qs + off + 8));
            mma_bf16(dpt[nt], av, ld32(Os + off), ld32(Os + off + 8));
          }
        }
        // p^T = exp2(s^T - lse[col]) (0 where masked), ds^T in place of dp^T.
#pragma unroll
        for (int nt = 0; nt < CTILES; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = c0 + nt * 8 + 2 * t + (e & 1);
            const int qc = q0 + col, row = e < 2 ? r0 : r1;
            const bool live = qc < sq && row < sk && (!causal || qc >= row);
            const float p = live ? exp2f(st[nt][e] - Ls[col]) : 0.f;
            st[nt][e] = p;
            dpt[nt][e] = p * (dpt[nt][e] - Ds[col]);
          }
        // dv += p^T do and dk += ds^T q, contracting over the chunk's q
        // rows; the accumulator layout of p^T / ds^T is the A fragment.
#pragma unroll
        for (int kk = 0; kk < CHUNK / 16; ++kk) {
          const uint32_t pa[4] = {pack_bf16(st[2 * kk][0], st[2 * kk][1]),
                                  pack_bf16(st[2 * kk][2], st[2 * kk][3]),
                                  pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]),
                                  pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3])};
          const uint32_t da[4] = {pack_bf16(dpt[2 * kk][0], dpt[2 * kk][1]),
                                  pack_bf16(dpt[2 * kk][2], dpt[2 * kk][3]),
                                  pack_bf16(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]),
                                  pack_bf16(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3])};
#pragma unroll
          for (int dt = 0; dt < DTILES; dt += 2) {
            uint32_t bo[4], bq[4];
            load_b_trans(bo, Os, STR, c0 + kk * 16, dt * 8, lane);
            load_b_trans(bq, Qs, STR, c0 + kk * 16, dt * 8, lane);
            mma_bf16(dva[dt], pa, bo[0], bo[1]);
            mma_bf16(dva[dt + 1], pa, bo[2], bo[3]);
            mma_bf16(dka[dt], da, bq[0], bq[1]);
            mma_bf16(dka[dt + 1], da, bq[2], bq[3]);
          }
        }
      }
    }
  }

  // dk = ln2 * ds^T q (q was pre-scaled by sm_scale*log2e), dv as is.
  uint16_t* dkb = dk + kv_off;
  uint16_t* dvb = dv + kv_off;
#pragma unroll
  for (int dt = 0; dt < DTILES; ++dt) {
    const int c = dt * 8 + 2 * t;
    if (r0 < sk) {
      *reinterpret_cast<uint32_t*>(dkb + r0 * kv_row + c) =
          pack_bf16(dka[dt][0] * LN2, dka[dt][1] * LN2);
      *reinterpret_cast<uint32_t*>(dvb + r0 * kv_row + c) =
          pack_bf16(dva[dt][0], dva[dt][1]);
    }
    if (r1 < sk) {
      *reinterpret_cast<uint32_t*>(dkb + r1 * kv_row + c) =
          pack_bf16(dka[dt][2] * LN2, dka[dt][3] * LN2);
      *reinterpret_cast<uint32_t*>(dvb + r1 * kv_row + c) =
          pack_bf16(dva[dt][2], dva[dt][3]);
    }
  }
}

// ------------------------------------------------------------------- K3

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_dq_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                const uint16_t* __restrict__ v,
                const uint16_t* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, uint16_t* __restrict__ dq,
                int H, int Hkv, int sq, int sk, int causal, float sm_scale) {
  constexpr int STR = D + 8;
  constexpr int KSTEPS = D / 16;         // contraction steps of q k^T
  constexpr int DTILES = D / 8;          // n-tiles of dq
  constexpr int CTILES = CHUNK / 8;      // n-tiles of a chunk of s
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* Qs = smem;
  uint16_t* Os = Qs + BLOCK * STR;       // the do tile
  uint16_t* Ks = Os + BLOCK * STR;
  uint16_t* Vs = Ks + BLOCK * STR;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = qt * BLOCK, wr = warp * 16;
  const int r0 = q0 + wr + g, r1 = r0 + 8;  // this thread's two q rows

  const size_t q_row = (size_t)H * D;
  const size_t kv_row = (size_t)Hkv * D;
  const size_t q_off = (size_t)b * sq * q_row + (size_t)h * D;
  const size_t kv_off = (size_t)b * sk * kv_row + (size_t)hk * D;
  load_tile<D>(Qs, q + q_off, q_row, q0, sq, tid);
  load_tile<D>(Os, dout + q_off, q_row, q0, sq, tid);
  const float* lb = lse + ((size_t)b * H + h) * sq;
  const float* db = delta + ((size_t)b * H + h) * sq;
  const float l0 = r0 < sq ? lb[r0] : 0.f, l1 = r1 < sq ? lb[r1] : 0.f;
  const float d0 = r0 < sq ? db[r0] : 0.f, d1 = r1 < sq ? db[r1] : 0.f;

  float dqa[DTILES][4];
#pragma unroll
  for (int dt = 0; dt < DTILES; ++dt)
    dqa[dt][0] = dqa[dt][1] = dqa[dt][2] = dqa[dt][3] = 0.f;

  int nk = (sk + BLOCK - 1) / BLOCK;
  if (causal) nk = min(nk, (q0 + BLOCK - 1) / BLOCK + 1);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BLOCK;
    __syncthreads();  // every warp is done with the previous kv tile
    load_tile<D>(Ks, k + kv_off, kv_row, k0, sk, tid);
    load_tile<D>(Vs, v + kv_off, kv_row, k0, sk, tid);
    __syncthreads();

    for (int c0 = 0; c0 < BLOCK; c0 += CHUNK) {
      // Warp-uniform skips: the chunk is past sk, or every column of it is
      // above the diagonal for all 16 rows of this warp.
      if (k0 + c0 >= sk || (causal && k0 + c0 > q0 + wr + 15)) continue;
      // s = q k^T and dp = do v^T: 16 q rows x CHUNK kv columns.
      float s[CTILES][4], dp[CTILES][4];
#pragma unroll
      for (int nt = 0; nt < CTILES; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        uint32_t aq[4], ao[4];
        load_a(aq, Qs, STR, wr, ks * 16, g, t);
        load_a(ao, Os, STR, wr, ks * 16, g, t);
#pragma unroll
        for (int nt = 0; nt < CTILES; ++nt) {
          const int off = (c0 + nt * 8 + g) * STR + ks * 16 + 2 * t;
          mma_bf16(s[nt], aq, ld32(Ks + off), ld32(Ks + off + 8));
          mma_bf16(dp[nt], ao, ld32(Vs + off), ld32(Vs + off + 8));
        }
      }
      // ds = p * (dp - delta) with p = exp2(s - lse) (0 where masked).
#pragma unroll
      for (int nt = 0; nt < CTILES; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + c0 + nt * 8 + 2 * t + (e & 1);
          const int row = e < 2 ? r0 : r1;
          const bool live = col < sk && row < sq && (!causal || col <= row);
          const float p = live ? exp2f(s[nt][e] - (e < 2 ? l0 : l1)) : 0.f;
          dp[nt][e] = p * (dp[nt][e] - (e < 2 ? d0 : d1));
        }
      // dq += ds k, contracting over the chunk's kv rows.
#pragma unroll
      for (int kk = 0; kk < CHUNK / 16; ++kk) {
        const uint32_t da[4] = {pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
                                pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
                                pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                                pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
        for (int dt = 0; dt < DTILES; dt += 2) {
          uint32_t bk[4];
          load_b_trans(bk, Ks, STR, c0 + kk * 16, dt * 8, lane);
          mma_bf16(dqa[dt], da, bk[0], bk[1]);
          mma_bf16(dqa[dt + 1], da, bk[2], bk[3]);
        }
      }
    }
  }

  uint16_t* dqb = dq + q_off;
#pragma unroll
  for (int dt = 0; dt < DTILES; ++dt) {
    const int c = dt * 8 + 2 * t;
    if (r0 < sq)
      *reinterpret_cast<uint32_t*>(dqb + r0 * q_row + c) =
          pack_bf16(dqa[dt][0] * sm_scale, dqa[dt][1] * sm_scale);
    if (r1 < sq)
      *reinterpret_cast<uint32_t*>(dqb + r1 * q_row + c) =
          pack_bf16(dqa[dt][2] * sm_scale, dqa[dt][3] * sm_scale);
  }
}

template <int D>
int launch_dkdv(const dim3& grid, cudaStream_t st, const void* q,
                const void* k, const void* v, const void* dout,
                const void* lse, const void* delta, void* dk, void* dv, int H,
                int Hkv, int sq, int sk, int causal) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_dkdv_kernel<D><<<grid, THREADS, smem, st>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<const uint16_t*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<uint16_t*>(dk), static_cast<uint16_t*>(dv), H, Hkv, sq, sk,
      causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq(const dim3& grid, cudaStream_t st, const void* q, const void* k,
              const void* v, const void* dout, const void* lse,
              const void* delta, void* dq, int H, int Hkv, int sq, int sk,
              int causal, float sm_scale) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_dq_kernel<D><<<grid, THREADS, smem, st>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<const uint16_t*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<uint16_t*>(dq), H, Hkv, sq, sk, causal, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rtt_flash_dkdv_bf16(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse,
                                   const void* delta, void* dk, void* dv,
                                   int B, int H, int Hkv, int sq, int sk,
                                   int D, int causal, void* stream) {
  const dim3 grid((sk + BLOCK - 1) / BLOCK, Hkv, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch_dkdv<32>(grid, st, q, k, v, dout, lse, delta, dk, dv, H,
                             Hkv, sq, sk, causal);
    case 64:
      return launch_dkdv<64>(grid, st, q, k, v, dout, lse, delta, dk, dv, H,
                             Hkv, sq, sk, causal);
    case 128:
      return launch_dkdv<128>(grid, st, q, k, v, dout, lse, delta, dk, dv, H,
                              Hkv, sq, sk, causal);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int rtt_flash_dq_bf16(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, int B, int H,
                                 int Hkv, int sq, int sk, int D, int causal,
                                 float sm_scale, void* stream) {
  const dim3 grid((sq + BLOCK - 1) / BLOCK, H, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch_dq<32>(grid, st, q, k, v, dout, lse, delta, dq, H, Hkv,
                           sq, sk, causal, sm_scale);
    case 64:
      return launch_dq<64>(grid, st, q, k, v, dout, lse, delta, dq, H, Hkv,
                           sq, sk, causal, sm_scale);
    case 128:
      return launch_dq<128>(grid, st, q, k, v, dout, lse, delta, dq, H, Hkv,
                            sq, sk, causal, sm_scale);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* rtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
