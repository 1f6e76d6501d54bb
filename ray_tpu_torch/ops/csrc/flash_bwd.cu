// K2 and K3: flash-attention backward for Hopper (sm_90a), bf16 in, f32
// accumulate.
//
// Replaces: ray_tpu/ops/attention.py::_dkdv_kernel (K2) and ::_dq_kernel
// (K3), the two Pallas TPU kernels launched by _bwd_call.  Same algorithm:
// q arrives pre-scaled by sm_scale*log2(e) (rounded to bf16 by the wrapper,
// as the reference does); both kernels recompute p = exp2(s - lse) from the
// saved log2-domain lse, round p (for dv) and ds = p * (dp - delta) (for dk
// and dq) to bf16 before the grad products, accumulate in f32, and scale dk
// by ln 2 and dq by sm_scale at the end.  delta = rowsum(o * do) in f32,
// which the reference computes outside its kernels, is computed in K3's
// prologue and written for K2: the wrapper launches K3, then K2.
//
// Bound: at the flagship shape (b=4, s=512, h=6, d=128, causal) K2 must read
// q, k, v, do and write dk, dv (3.15 MB each) and read lse and delta: 18.97
// MB, 5.7 us at 3.35 TB/s; its four products over the 131,328 causal pairs
// per head are 3.23 GFLOP, 3.3 us at 989 TFLOP/s.  K3 reads q, k, v, o, do
// and lse and writes dq and delta: 18.97 MB (5.7 us) for 2.42 GFLOP (2.4
// us).  Both are bound by bytes on paper, and in practice by latency: the
// heaviest block walks 8 tiles of 64 rows in series.  At the long shape
// (b=2, s=2048, h=32, d=128, causal) K2 does 137.5 GFLOP (0.139 ms) and K3
// 103.1 (0.104 ms), each on 202 MB (0.060 ms): bound by operations.
//
// Design:
// - Warp specialisation as in K1 (flash_fwd.cu): one producer warpgroup and
//   two consumer warpgroups.  The producer loads the block's fixed tile once
//   by TMA and keeps a ring of STAGES walked tiles of 64 rows full (rank-4
//   (b, s, h, d) maps, 128-byte swizzle, 64-byte for d = 32; rows past s
//   load as zeros), with a "full" and an "empty" mbarrier per stage.
// - wgmma for every product: S, dP and their transposes are ss products
//   (both operands K-major from shared memory, N = 64); P, dS and their
//   transposes go from the f32 accumulators, rounded to bf16, straight into
//   the A fragments of the rs products dV += P^T dO, dK += dS^T Q and dQ +=
//   dS K, whose B operands (dO, Q, K) are read MN-major through transposed
//   descriptors.  Nothing s x s touches shared or device memory.
// - Registers.  ptxas (nvcc 12.9.86) holds the whole kernel to the launch
//   bound of 168 registers a thread: setmaxnreg moves registers between
//   the warpgroups at run time, but consumers asking for 240 or 232
//   compiled to the same spills.  So a consumer thread holds one 64 x d f32
//   accumulator (64 registers at d = 128) beside at most S and dP (32
//   each), and issues each tile's products after the last tile's are done:
//   K3 overlapping tile j's S and dP with tile j-1's dQ product spilled,
//   and K2 overlapping them gained nothing.
// - K3: one block per 128-row q tile; each consumer warpgroup owns 64 q rows
//   and walks the kv tiles (causal ones up to the diagonal), computing S, dP
//   (ss), dS, then dQ += dS K (rs).  Its prologue sums delta = o * do over
//   its rows from the swizzled shared-memory o and do tiles (o lands before
//   the first K/V stage), uses it, and writes delta (b, h, sq) for K2.
// - K2: one block per 64-row kv tile; it walks the q tiles of every q head
//   of its kv head's group (causal ones from the diagonal on).  dK and dV
//   together would not fit one thread's registers, so the consumers split
//   by gradient: warpgroup 0 computes S^T, P^T and dV += P^T dO, warpgroup
//   1 dP^T, dS^T = P^T (dP^T - delta) and dK += dS^T Q.  Warpgroup 0 hands
//   its f32 P^T to warpgroup 1 through shared memory (two buffers, named
//   barriers), thread t to thread t, as both accumulators share a layout;
//   so each warpgroup runs two products a tile and none is computed twice
//   (computing S^T in both ran K2 8% slower at the long shape, 5% at the
//   flagship).  The producer's first warp copies each q tile's lse and
//   delta rows beside the TMA loads and arrives on the same "full"
//   barrier.
// - Block order.  (batch, head) pairs in chunks whose walked tiles fit in
//   16 MB of L2; inside a chunk the heaviest causal tiles first (K3: the
//   last q tile; K2: the first kv tile).  Every product is issued under
//   block-uniform control: ptxas serialises wgmma issued in a branch that
//   depends on the warp, so both K3 warpgroups walk every tile of the block
//   (the mask zeroes what a warpgroup's rows do not see), and K2's two roles
//   are two instantiations of one loop.
//
// Layout: q, o, do, dq are (b, sq, h, d) and k, v, dk, dv are (b, sk, h_kv,
// d), contiguous; GQA maps q head -> kv head h / (h / h_kv), and K2 sums a
// group's q heads in f32 in its registers and rounds once.  lse and delta
// are (b, h, sq) f32.  Any sq, sk >= 1 and d in {32, 64, 128} run.

#include <algorithm>
#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace rtt;

constexpr float NEG_INF = -1e30f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int Q_ROWS = 128;  // K3: q rows of a block, 64 a warpgroup
constexpr int KV_ROWS = 64;  // K2: kv rows of a block, both warpgroups
constexpr int WALK = 64;     // rows of a walked tile
constexpr int STAGES = 3;
constexpr int THREADS = 384;  // two consumer warpgroups + the producer's

template <int D>
struct Cfg {
  static constexpr int PW = D < 64 ? D : 64;      // panel width, elements
  static constexpr int ROWB = PW * 2;             // panel row = swizzle span
  static constexpr int NP = D / PW;               // panels per tile
  static constexpr uint32_t LAYOUT = swizzle_layout(ROWB);
  // The swizzle as an address map: 16-byte chunk bits [4, 7) (64-byte
  // swizzle: [4, 6)) XOR address bits [7, 10) ([7, 9)).
  static constexpr uint32_t SWZ = ROWB == 128 ? 0x70u : 0x30u;
  static constexpr int Q_BYTES = Q_ROWS * D * 2;
  static constexpr int KV_BYTES = KV_ROWS * D * 2;
  static constexpr int WALK_BYTES = WALK * D * 2;
  static constexpr int P_BYTES = 64 * WALK * 4;  // an f32 P^T tile
  // Dynamic shared memory, after 1024 bytes of slack to align the tiles.
  // K2: K, V; per stage Q, then per stage dO, lse, delta; two P^T
  // exchange buffers; the mbarriers kv_full and per stage full, empty.
  static constexpr int SMEM_DKDV = 1024 + 2 * KV_BYTES +
                                   STAGES * (2 * WALK_BYTES + 2 * WALK * 4) +
                                   2 * P_BYTES + 8 * (1 + 2 * STAGES);
  // K3: Q, dO, O; per stage K, then per stage V; the mbarriers q_full,
  // o_full and per stage full, empty.
  static constexpr int SMEM_DQ =
      1024 + 3 * Q_BYTES + 2 * STAGES * WALK_BYTES + 8 * (2 + 2 * STAGES);
  static_assert(SMEM_DKDV <= 232448 && SMEM_DQ <= 232448,
                "more than an SM's 227 KB");
};

// Block-tile t of the launch order: (batch, head) pairs in chunks of
// `chunk` (head fastest), whose walked tiles fit in L2 together, and inside
// a chunk the heaviest tile index first (descending when `last_first`),
// then the pairs.
struct Tile {
  int idx, h, b;
  __device__ Tile(int t, int n_idx, int B, int H, int chunk,
                  bool last_first) {
    const int c = t / (chunk * n_idx), r = t - c * chunk * n_idx;
    const int size = min(chunk, B * H - c * chunk);  // the last may be short
    const int bh = c * chunk + r % size;
    idx = last_first ? n_idx - 1 - r / size : r / size;
    h = bh % H;
    b = bh / H;
  }
};

// The accumulator of a 64 x WALK product as the bf16 A fragments of WALK/16
// k-steps of m64nDk16: k-step kk covers columns 16 kk .. 16 kk + 15, i.e.
// registers 8 kk .. 8 kk + 7.
__device__ __forceinline__ void pack_a(const float (&x)[WALK / 2],
                                       uint32_t (&a)[WALK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < WALK / 16; ++kk) {
    a[kk][0] = pack_bf16(x[8 * kk + 0], x[8 * kk + 1]);
    a[kk][1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
    a[kk][2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
    a[kk][3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

// acc = A B^T over d for the 64 rows at `a` of an A_ROWS-row tile (K-major)
// and a WALK-row tile at `b` (K-major): the ss form of S = Q K^T, dP =
// dO V^T and their transposes.  Issued, not waited for.
template <int D, int A_ROWS>
__device__ __forceinline__ void ss_over_d(float (&acc)[WALK / 2], uint32_t a,
                                          uint32_t b) {
  using C = Cfg<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int p = kk * 16 / C::PW;               // panel
    const uint32_t off = (kk * 16 % C::PW) * 2;  // bytes into a row
    Wgmma<WALK>::ss(
        acc,
        smem_desc(a + p * A_ROWS * C::ROWB + off, 16, 8 * C::ROWB, C::LAYOUT),
        smem_desc(b + p * WALK * C::ROWB + off, 16, 8 * C::ROWB, C::LAYOUT),
        kk > 0);
  }
}

// acc += A B for A the packed 64 x WALK fragments and B a WALK-row tile at
// `b` read MN-major (contraction over its rows, N = d): dV += P^T dO,
// dK += dS^T Q, dQ += dS K.  Issued, not waited for.
template <int D>
__device__ __forceinline__ void rs_over_walk(float (&acc)[D / 2],
                                             const uint32_t (&a)[WALK / 16][4],
                                             uint32_t b) {
  using C = Cfg<D>;
#pragma unroll
  for (int kk = 0; kk < WALK / 16; ++kk)
    Wgmma<D>::rs(acc, a[kk],
                 smem_desc(b + kk * 16 * C::ROWB, WALK * C::ROWB,
                           8 * C::ROWB, C::LAYOUT));
}

// Sum of the products of 8 bf16 pairs, in f32.
__device__ __forceinline__ float dot_bf16x8(const uint4& x, const uint4& y) {
  const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    s += __uint_as_float(xs[i] << 16) * __uint_as_float(ys[i] << 16);
    s += __uint_as_float(xs[i] & 0xffff0000u) *
         __uint_as_float(ys[i] & 0xffff0000u);
  }
  return s;
}

// ------------------------------------------------------------------- K3

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_dq_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const __grid_constant__ CUtensorMap to,
                const __grid_constant__ CUtensorMap tdo,
                const float* __restrict__ lse, float* __restrict__ delta,
                uint16_t* __restrict__ dq, int B, int H, int Hkv, int sq,
                int sk, int causal, float sm_scale, int chunk) {
  using C = Cfg<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint8_t* smem = smem_raw + (sQ - smem_u32(smem_raw));  // generic
  const uint32_t sDO = sQ + C::Q_BYTES;
  const uint32_t sO = sDO + C::Q_BYTES;
  const uint32_t sK = sO + C::Q_BYTES;                 // STAGES K tiles
  const uint32_t sV = sK + STAGES * C::WALK_BYTES;     // STAGES V tiles
  const uint32_t q_full = sV + STAGES * C::WALK_BYTES;  // then the barriers
  const uint32_t o_full = q_full + 8;
  const uint32_t full = o_full + 8;                    // [STAGES]
  const uint32_t empty = full + 8 * STAGES;            // [STAGES]

  const int n_qt = (sq + Q_ROWS - 1) / Q_ROWS;
  const Tile tile(blockIdx.x, n_qt, B, H, chunk, true);
  const int q0 = tile.idx * Q_ROWS, hk = tile.h / (H / Hkv);
  const int n_kv = (sk + WALK - 1) / WALK;
  // kv tiles the block walks: causal ones up to its last row's diagonal.
  const int nk = causal ? min(n_kv, (min(q0 + Q_ROWS, sq) - 1) / WALK + 1)
                        : n_kv;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(o_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2 * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer warpgroup: one thread issues every TMA load ----
    setmaxnreg_dec<24>();
    if (threadIdx.x == 2 * 128) {
      tma_prefetch(&tq);
      tma_prefetch(&tk);
      tma_prefetch(&tv);
      tma_prefetch(&to);
      tma_prefetch(&tdo);
      mbar_arrive_expect_tx(q_full, 2 * C::Q_BYTES);
#pragma unroll
      for (int p = 0; p < C::NP; ++p) {
        tma_load_4d(sQ + p * Q_ROWS * C::ROWB, &tq, q_full, p * C::PW,
                    tile.h, q0, tile.b);
        tma_load_4d(sDO + p * Q_ROWS * C::ROWB, &tdo, q_full, p * C::PW,
                    tile.h, q0, tile.b);
      }
      mbar_arrive_expect_tx(o_full, C::Q_BYTES);
#pragma unroll
      for (int p = 0; p < C::NP; ++p)
        tma_load_4d(sO + p * Q_ROWS * C::ROWB, &to, o_full, p * C::PW,
                    tile.h, q0, tile.b);
      for (int j = 0; j < nk; ++j) {
        const int s = j % STAGES;
        mbar_wait(empty + 8 * s, ((j / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(full + 8 * s, 2 * C::WALK_BYTES);
#pragma unroll
        for (int p = 0; p < C::NP; ++p) {
          tma_load_4d(sK + s * C::WALK_BYTES + p * WALK * C::ROWB, &tk,
                      full + 8 * s, p * C::PW, hk, j * WALK, tile.b);
          tma_load_4d(sV + s * C::WALK_BYTES + p * WALK * C::ROWB, &tv,
                      full + 8 * s, p * C::PW, hk, j * WALK, tile.b);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroup wg: query rows q0 + 64 wg .. + 63 ----
  setmaxnreg_inc<240>();
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int lr0 = 64 * wg + 16 * warp + g;  // this thread's rows in the tile
  const int row_lo = q0 + 64 * wg;
  const int r0 = q0 + lr0, r1 = r0 + 8;
  const uint32_t qa = sQ + wg * 64 * C::ROWB;
  const uint32_t doa = sDO + wg * 64 * C::ROWB;
  const float* lb = lse + (static_cast<size_t>(tile.b) * H + tile.h) * sq;
  const float l0 = r0 < sq ? lb[r0] : 0.f, l1 = r1 < sq ? lb[r1] : 0.f;
  float d0 = 0.f, d1 = 0.f;  // delta of rows r0, r1

  float acc[D / 2];
  float s[WALK / 2], dp[WALK / 2];
  uint32_t da[WALK / 16][4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  // delta = rowsum(O * dO) of rows r0, r1 from the swizzled tiles (the O
  // tile lands before the first K/V stage): the four threads of a quad take
  // every fourth 16-byte chunk of both rows.
  mbar_wait(q_full, 0);
  mbar_wait(o_full, 0);
#pragma unroll
  for (int c = t4; c < D / 8; c += 4) {
    const int p = c / (C::PW / 8), ch = c % (C::PW / 8);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const uint32_t off =
          p * Q_ROWS * C::ROWB + (lr0 + 8 * half) * C::ROWB + ch * 16;
      const uint32_t sw = off ^ ((off >> 3) & C::SWZ);
      const float x =
          dot_bf16x8(*reinterpret_cast<const uint4*>(smem + (sO - sQ) + sw),
                     *reinterpret_cast<const uint4*>(smem + (sDO - sQ) + sw));
      if (half)
        d1 += x;
      else
        d0 += x;
    }
  }
  d0 += __shfl_xor_sync(0xffffffffu, d0, 1);
  d0 += __shfl_xor_sync(0xffffffffu, d0, 2);
  d1 += __shfl_xor_sync(0xffffffffu, d1, 1);
  d1 += __shfl_xor_sync(0xffffffffu, d1, 2);

  for (int j = 0; j < nk; ++j) {
    const int st = j % STAGES, k0 = j * WALK;
    const uint32_t ka = sK + st * C::WALK_BYTES;
    mbar_wait(full + 8 * st, (j / STAGES) & 1);
    // S = Q K^T and dP = dO V^T: q rows x kv columns.
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    ss_over_d<D, Q_ROWS>(s, qa, ka);
    ss_over_d<D, Q_ROWS>(dp, doa, sV + st * C::WALK_BYTES);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    // dS = P (dP - delta) with P = exp2(S - lse), 0 where the causal mask
    // or the ragged kv tail hides the entry.  Register i is in row
    // (i / 2) % 2 of the thread's two and column 8 (i / 4) + 2 t4 + i % 2
    // of the tile.
    if (k0 + WALK > sk || (causal && k0 + WALK - 1 > row_lo)) {
#pragma unroll
      for (int i = 0; i < WALK / 2; ++i) {
        const int col = k0 + (i / 4) * 8 + 2 * t4 + (i & 1);
        const int row = (i & 2) ? r1 : r0;
        if (col >= sk || (causal && col > row)) s[i] = NEG_INF;
      }
    }
#pragma unroll
    for (int i = 0; i < WALK / 2; ++i)
      dp[i] = exp2_approx(s[i] - ((i & 2) ? l1 : l0)) *
              (dp[i] - ((i & 2) ? d1 : d0));
    pack_a(dp, da);
    // dQ += dS K, K read MN-major.
    fence_regs(acc);
    wgmma_fence();
    rs_over_walk<D>(acc, da, ka);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(empty + 8 * st);
  }

  // dq = sm_scale * acc in bf16 (q was pre-scaled by sm_scale*log2e), and
  // delta for K2.
  if (t4 == 0) {
    float* db = delta + (static_cast<size_t>(tile.b) * H + tile.h) * sq;
    if (r0 < sq) db[r0] = d0;
    if (r1 < sq) db[r1] = d1;
  }
  const size_t q_row = static_cast<size_t>(H) * D;
  uint16_t* qb = dq + static_cast<size_t>(tile.b) * sq * q_row +
                 static_cast<size_t>(tile.h) * D;
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int col = (i / 4) * 8 + 2 * t4;
    const int row = (i & 2) ? r1 : r0;
    if (row < sq)
      *reinterpret_cast<uint32_t*>(qb + row * q_row + col) =
          pack_bf16(acc[i] * sm_scale, acc[i + 1] * sm_scale);
  }
}

// ------------------------------------------------------------------- K2

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_dkdv_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap tdo,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, uint16_t* __restrict__ dk,
                  uint16_t* __restrict__ dv, int B, int H, int Hkv, int sq,
                  int sk, int causal, int chunk) {
  using C = Cfg<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sK = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (sK - smem_u32(smem_raw));  // generic
  const uint32_t sV = sK + C::KV_BYTES;
  const uint32_t sQ = sV + C::KV_BYTES;                // STAGES Q tiles
  const uint32_t sDO = sQ + STAGES * C::WALK_BYTES;    // STAGES dO tiles
  const uint32_t sL = sDO + STAGES * C::WALK_BYTES;    // STAGES x WALK lse
  const uint32_t sD = sL + STAGES * WALK * 4;          // STAGES x WALK delta
  const uint32_t sP = sD + STAGES * WALK * 4;          // 2 P^T tiles
  const uint32_t kv_full = sP + 2 * C::P_BYTES;        // then the barriers
  const uint32_t full = kv_full + 8;                   // [STAGES]
  const uint32_t empty = full + 8 * STAGES;            // [STAGES]
  float* lse_s = reinterpret_cast<float*>(smem + (sL - sK));
  float* delta_s = reinterpret_cast<float*>(smem + (sD - sK));
  float* p_s = reinterpret_cast<float*>(smem + (sP - sK));

  const int n_kt = (sk + KV_ROWS - 1) / KV_ROWS;
  const Tile tile(blockIdx.x, n_kt, B, Hkv, chunk, false);
  const int k0 = tile.idx * KV_ROWS, group = H / Hkv;
  const int n_qt = (sq + WALK - 1) / WALK;
  // q tiles walked per q head of the group: causal ones from the diagonal.
  const int qt0 = causal ? k0 / WALK : 0;
  const int nq = max(n_qt - qt0, 0);
  const int n_walk = group * nq;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 32);  // the producer's first warp
      mbar_init(empty + 8 * s, 2 * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer warpgroup: its first warp loads lse and delta rows,
    // one thread of it issues every TMA load ----
    setmaxnreg_dec<24>();
    if (threadIdx.x < 2 * 128 + 32) {
      const int lane = threadIdx.x % 32;
      if (lane == 0) {
        tma_prefetch(&tq);
        tma_prefetch(&tk);
        tma_prefetch(&tv);
        tma_prefetch(&tdo);
        mbar_arrive_expect_tx(kv_full, 2 * C::KV_BYTES);
#pragma unroll
        for (int p = 0; p < C::NP; ++p) {
          tma_load_4d(sK + p * KV_ROWS * C::ROWB, &tk, kv_full, p * C::PW,
                      tile.h, k0, tile.b);
          tma_load_4d(sV + p * KV_ROWS * C::ROWB, &tv, kv_full, p * C::PW,
                      tile.h, k0, tile.b);
        }
      }
      for (int w = 0; w < n_walk; ++w) {
        const int s = w % STAGES;
        const int h = tile.h * group + w / nq, q0 = (qt0 + w % nq) * WALK;
        mbar_wait(empty + 8 * s, ((w / STAGES) & 1) ^ 1);
        const size_t row = (static_cast<size_t>(tile.b) * H + h) * sq;
        for (int c = lane; c < WALK; c += 32) {
          const bool in = q0 + c < sq;
          lse_s[s * WALK + c] = in ? lse[row + q0 + c] : 0.f;
          delta_s[s * WALK + c] = in ? delta[row + q0 + c] : 0.f;
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(full + 8 * s, 2 * C::WALK_BYTES);
#pragma unroll
          for (int p = 0; p < C::NP; ++p) {
            tma_load_4d(sQ + s * C::WALK_BYTES + p * WALK * C::ROWB, &tq,
                        full + 8 * s, p * C::PW, h, q0, tile.b);
            tma_load_4d(sDO + s * C::WALK_BYTES + p * WALK * C::ROWB, &tdo,
                        full + 8 * s, p * C::PW, h, q0, tile.b);
          }
        } else {
          mbar_arrive(full + 8 * s);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups, both on kv rows k0 .. k0 + 63: warpgroup 0
  // computes S^T, P^T and dV += P^T dO, warpgroup 1 dP^T, dS^T = P^T (dP^T
  // - delta) and dK += dS^T Q, with warpgroup 0's f32 P^T handed over in
  // shared memory.  The two accumulators have the same layout, so thread t
  // of warpgroup 1 reads what thread t of warpgroup 0 wrote.  Named
  // barriers 1 + buf ("P^T in buffer buf") and 3 + buf ("buffer buf read")
  // order the two; the buffers alternate by walked tile.  Each role is its
  // own instantiation, so no product is issued under a branch on the
  // warpgroup ----
  setmaxnreg_inc<240>();
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int r0 = k0 + 16 * warp + g, r1 = r0 + 8;  // this thread's kv rows
  const size_t kv_row = static_cast<size_t>(Hkv) * D;
  const size_t out_off = static_cast<size_t>(tile.b) * sk * kv_row +
                         static_cast<size_t>(tile.h) * D;

  auto consume = [&](auto dk_role) {
    constexpr bool DK = decltype(dk_role)::value;
    float acc[D / 2];  // dk (DK) or dv, f32
    float x[WALK / 2];  // S^T -> P^T, or dP^T -> dS^T (DK)
    uint32_t a[WALK / 16][4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    mbar_wait(kv_full, 0);
    for (int w = 0; w < n_walk; ++w) {
      const int s = w % STAGES, q0 = (qt0 + w % nq) * WALK, buf = w % 2;
      const uint32_t qs = sQ + s * C::WALK_BYTES;
      const uint32_t dos = sDO + s * C::WALK_BYTES;
      // This thread's slots of the exchange buffer, 128 floats apart.
      float* pb = p_s + buf * (WALK / 2) * 128 + tid;
      mbar_wait(full + 8 * s, (w / STAGES) & 1);
      // S^T = K Q^T, or dP^T = V dO^T (DK): kv rows x q columns.
      fence_regs(x);
      wgmma_fence();
      ss_over_d<D, KV_ROWS>(x, DK ? sV : sK, DK ? dos : qs);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(x);
      // Register i is in kv row (i / 2) % 2 of the thread's two and q
      // column 8 (i / 4) + 2 t4 + i % 2 of the tile; lse and delta are per
      // q column.
      if constexpr (!DK) {
        // P^T = exp2(S^T - lse[col]), 0 where masked.
        const float* ls = lse_s + s * WALK;
        if (q0 + WALK > sq || (causal && q0 < k0 + KV_ROWS - 1)) {
#pragma unroll
          for (int i = 0; i < WALK / 2; ++i) {
            const int qr = q0 + (i / 4) * 8 + 2 * t4 + (i & 1);
            const int kr = (i & 2) ? r1 : r0;
            if (qr >= sq || (causal && qr < kr)) x[i] = NEG_INF;
          }
        }
#pragma unroll
        for (int i = 0; i < WALK / 2; ++i)
          x[i] = exp2_approx(x[i] - ls[(i / 4) * 8 + 2 * t4 + (i & 1)]);
        if (w >= 2) named_bar_sync(3 + buf, 256);
#pragma unroll
        for (int i = 0; i < WALK / 2; ++i) pb[i * 128] = x[i];
        named_bar_arrive(1 + buf, 256);
      } else {
        // dS^T = P^T (dP^T - delta[col]).
        const float* dls = delta_s + s * WALK;
        named_bar_sync(1 + buf, 256);
#pragma unroll
        for (int i = 0; i < WALK / 2; ++i)
          x[i] = pb[i * 128] * (x[i] - dls[(i / 4) * 8 + 2 * t4 + (i & 1)]);
        if (w + 2 < n_walk) named_bar_arrive(3 + buf, 256);
      }
      pack_a(x, a);
      // dV += P^T dO or dK += dS^T Q, dO and Q read MN-major.
      fence_regs(acc);
      wgmma_fence();
      rs_over_walk<D>(acc, a, DK ? qs : dos);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(empty + 8 * s);
    }

    // dk = ln2 * dS^T q (q was pre-scaled by sm_scale*log2e), dv as is.
    uint16_t* out = (DK ? dk : dv) + out_off;
    const float scale = DK ? LN2 : 1.f;
#pragma unroll
    for (int i = 0; i < D / 2; i += 2) {
      const int col = (i / 4) * 8 + 2 * t4;
      const int row = (i & 2) ? r1 : r0;
      if (row < sk)
        *reinterpret_cast<uint32_t*>(out + row * kv_row + col) =
            pack_bf16(acc[i] * scale, acc[i + 1] * scale);
    }
  };
  if (wg == 0)
    consume(std::false_type{});
  else
    consume(std::true_type{});
}

// (batch, head) pairs whose `pair_bytes` of walked tiles take at most 16 MB
// of the 50 MB L2.
int l2_chunk(int pairs, long pair_bytes) {
  return static_cast<int>(
      std::max(1L, std::min<long>(pairs, (16L << 20) / pair_bytes)));
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const void* lse, void* delta, void* dq,
              int B, int H, int Hkv, int sq, int sk, int causal,
              float sm_scale, cudaStream_t st) {
  using C = Cfg<D>;
  CUtensorMap tq, tk, tv, to, tdo;
  if (!encode_bshd(&tq, q, B, sq, H, D, Q_ROWS, C::PW) ||
      !encode_bshd(&tdo, dout, B, sq, H, D, Q_ROWS, C::PW) ||
      !encode_bshd(&to, o, B, sq, H, D, Q_ROWS, C::PW) ||
      !encode_bshd(&tk, k, B, sk, Hkv, D, WALK, C::PW) ||
      !encode_bshd(&tv, v, B, sk, Hkv, D, WALK, C::PW))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM_DQ);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid =
      static_cast<unsigned>((sq + Q_ROWS - 1) / Q_ROWS) * H * B;
  flash_dq_kernel<D><<<grid, THREADS, C::SMEM_DQ, st>>>(
      tq, tk, tv, to, tdo, static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<uint16_t*>(dq), B, H, Hkv, sq,
      sk, causal, sm_scale, l2_chunk(B * H, 4L * sk * D));
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkdv(const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* delta,
                void* dk, void* dv, int B, int H, int Hkv, int sq, int sk,
                int causal, cudaStream_t st) {
  using C = Cfg<D>;
  CUtensorMap tq, tk, tv, tdo;
  if (!encode_bshd(&tk, k, B, sk, Hkv, D, KV_ROWS, C::PW) ||
      !encode_bshd(&tv, v, B, sk, Hkv, D, KV_ROWS, C::PW) ||
      !encode_bshd(&tq, q, B, sq, H, D, WALK, C::PW) ||
      !encode_bshd(&tdo, dout, B, sq, H, D, WALK, C::PW))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash_dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM_DKDV);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid =
      static_cast<unsigned>((sk + KV_ROWS - 1) / KV_ROWS) * Hkv * B;
  flash_dkdv_kernel<D><<<grid, THREADS, C::SMEM_DKDV, st>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<uint16_t*>(dk),
      static_cast<uint16_t*>(dv), B, H, Hkv, sq, sk, causal,
      l2_chunk(B * Hkv, 4L * (H / Hkv) * sq * D));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rtt_flash_dq_bf16(const void* q, const void* k, const void* v,
                                 const void* o, const void* dout,
                                 const void* lse, void* delta, void* dq,
                                 int B, int H, int Hkv, int sq, int sk, int D,
                                 int causal, float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch_dq<32>(q, k, v, o, dout, lse, delta, dq, B, H, Hkv, sq,
                           sk, causal, sm_scale, st);
    case 64:
      return launch_dq<64>(q, k, v, o, dout, lse, delta, dq, B, H, Hkv, sq,
                           sk, causal, sm_scale, st);
    case 128:
      return launch_dq<128>(q, k, v, o, dout, lse, delta, dq, B, H, Hkv, sq,
                            sk, causal, sm_scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int rtt_flash_dkdv_bf16(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse,
                                   const void* delta, void* dk, void* dv,
                                   int B, int H, int Hkv, int sq, int sk,
                                   int D, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch_dkdv<32>(q, k, v, dout, lse, delta, dk, dv, B, H, Hkv,
                             sq, sk, causal, st);
    case 64:
      return launch_dkdv<64>(q, k, v, dout, lse, delta, dk, dv, B, H, Hkv,
                             sq, sk, causal, st);
    case 128:
      return launch_dkdv<128>(q, k, v, dout, lse, delta, dk, dv, B, H, Hkv,
                              sq, sk, causal, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* rtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
