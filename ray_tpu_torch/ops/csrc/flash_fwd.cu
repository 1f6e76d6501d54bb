// K1: flash-attention forward for Hopper (sm_90a), bf16 in, f32 accumulate.
//
// Replaces: ray_tpu/ops/attention.py::_fwd_kernel (the Pallas TPU kernel
// launched by _fwd_call).  Same algorithm: q arrives pre-scaled by
// sm_scale*log2(e) (the wrapper rounds it back to bf16, as the reference
// does), the softmax runs online in the log2 domain with exp2, the finite
// NEG_INF = -1e30 masks, p is rounded to bf16 before the P V product (the
// reference's p.astype(v.dtype)), fully masked causal kv tiles are never
// visited, o = acc / l and lse = m + log2(l).
//
// Bound: at the flagship shape (b=4, s=512, h=6, d=128, causal) q, k, v and
// o are 3.15 MB each, 12.6 MB in all: 3.8 us at 3.35 TB/s, against 1.6
// GFLOP of causal products, 1.6 us at 989 TFLOP/s.  Bound by bytes, and in
// practice by latency: 96 blocks of 128 q rows, and the last walks 4 kv
// tiles in series.  At the long shape (b=2, s=2048, h=32, d=128, causal: the
// heads of LlamaConfig.llama2_7b at its max_seq_len) 134.7 MB against 68.75
// GFLOP: 0.040 ms of bytes, 0.0695 ms of tensor work.  Bound by operations,
// but every q tile re-reads its head's K and V (570 MB through L2 at this
// shape), and that stream is what the kernel waits on (PERF.md).
//
// Design:
// - Warp specialisation.  One producer warpgroup (a single thread of it
//   issues every load) and two consumer warpgroups, each owning 64 of the
//   block's 128 query rows.  setmaxnreg hands the producer's registers to
//   the consumers.
// - TMA.  The producer loads the Q tile once and keeps a ring of STAGES K/V
//   tiles full ahead of the consumers (cp.async.bulk.tensor on rank-4 maps
//   of (b, s, h, d), 128-byte swizzle; 64-byte for d = 32), so copies
//   overlap the products.  Per stage a "K full" and a "V full" mbarrier
//   (the consumers start Q K^T while V is still landing) and an "empty"
//   mbarrier that every consumer thread arrives on.  No __syncthreads()
//   after the barriers are set up.  TMA zero-fills positions past s; the
//   kernel masks those columns to NEG_INF and stores no row past sq.
// - wgmma for both products.  S = Q K^T is m64n128k16 with Q and K K-major
//   from shared memory; O += P V takes P from registers (the f32
//   accumulator of S packs pairwise into the bf16 A fragments) and V
//   through an MN-major (transposed) descriptor.  Row max and row sum are
//   quad reductions, as the accumulator rows are warp*16 + lane/4 (+8).
//   S_j is issued with P_{j-1} V_{j-1}, so a warpgroup's softmax runs while
//   its previous P V is on the tensor cores, and the two consumer
//   warpgroups take turns to issue (named barriers).
// - Block order.  One block per 128-row q tile.  (batch, head) pairs go in
//   chunks whose K and V fit in a third of L2, so the blocks in flight
//   re-read K/V from L2 and not from HBM; inside a chunk the heaviest
//   causal q tiles go first.
// - Tiles: 128 q rows x 128 kv columns, the fastest of the four tiles of
//   64 or 128 rows by 64 or 128 columns at both shapes (PERF.md).
//
// Layout: q, o are (b, sq, h, d) and k, v are (b, sk, h_kv, d), contiguous;
// GQA maps q head -> kv head h / (h / h_kv).  lse is (b, h, sq) f32.  Any
// sq, sk >= 1 and d in {32, 64, 128} run.

#include <algorithm>

#include "hopper.cuh"

namespace {

using namespace rtt;

constexpr float NEG_INF = -1e30f;
constexpr int BM = 128;  // q rows of a block: two consumer warpgroups
constexpr int BN = 128;  // kv columns of a tile
constexpr int STAGES = 3;
constexpr int THREADS = 384;  // two consumer warpgroups + the producer's

template <int D>
struct Cfg {
  static constexpr int PW = D < 64 ? D : 64;      // panel width, elements
  static constexpr int ROWB = PW * 2;             // panel row = swizzle span
  static constexpr int NP = D / PW;               // panels per tile
  static constexpr uint32_t LAYOUT = swizzle_layout(ROWB);
  static constexpr int Q_BYTES = BM * D * 2;
  static constexpr int KV_BYTES = BN * D * 2;     // one K (or V) stage
  // Dynamic shared memory: 1024 bytes of slack to align the tiles, the Q
  // tile, STAGES K and V tiles, then the mbarriers q_full, q_empty and per
  // stage k_full, v_full, empty.
  static constexpr int SMEM =
      1024 + Q_BYTES + 2 * STAGES * KV_BYTES + 8 * (2 + 3 * STAGES);
  static_assert(SMEM <= 232448, "more than an SM's 227 KB");
};

// Block-tile t of the order the blocks take: the (batch, head) pairs in
// chunks of `chunk` (head fastest), whose K and V fit in L2 together, and
// inside a chunk the heaviest first: q tiles in descending order, then
// the pairs.  So the blocks in flight share a few heads' K/V, read from
// L2, and the long causal rows start first.
struct Tile {
  int qt, h, b;
  __device__ Tile(int t, int n_qt, int B, int H, int chunk) {
    const int c = t / (chunk * n_qt), r = t - c * chunk * n_qt;
    const int size = min(chunk, B * H - c * chunk);  // the last may be short
    const int bh = c * chunk + r % size;
    qt = n_qt - 1 - r / size;
    h = bh % H;
    b = bh / H;
  }
};

// Score tile S_j (64 rows x BN columns of this warpgroup, f32) ->
// exp2(S_j - m) in place, with the causal and ragged-tail mask, the new
// running maxima m0/m1 of this thread's two rows, the factors alpha that
// rescale what came before, and partial row sums of this thread's columns.
// Register i is in row (i / 2) % 2 of the two; each row lives in the 4
// lanes of a quad.  Two partial maxima and sums a row shorten the
// dependency chains.
__device__ __forceinline__ void softmax_step(float (&sc)[BN / 2], int k0,
                                             int r0, int r1, int t4,
                                             int row_lo, int sk, int causal,
                                             float& m0, float& m1,
                                             float& alpha0, float& alpha1,
                                             float& rs0, float& rs1) {
  if (k0 + BN > sk || (causal && k0 + BN - 1 > row_lo)) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int col = k0 + (i / 4) * 8 + 2 * t4 + (i & 1);
      const int row = (i & 2) ? r1 : r0;
      if (col >= sk || (causal && col > row)) sc[i] = NEG_INF;
    }
  }
  float mx[2][2] = {{m0, m0}, {m1, m1}};
#pragma unroll
  for (int i = 0; i < BN / 2; ++i)
    mx[(i >> 1) & 1][(i >> 2) & 1] =
        fmaxf(mx[(i >> 1) & 1][(i >> 2) & 1], sc[i]);
  float mx0 = fmaxf(mx[0][0], mx[0][1]), mx1 = fmaxf(mx[1][0], mx[1][1]);
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  alpha0 = exp2_approx(m0 - mx0);
  alpha1 = exp2_approx(m1 - mx1);
  m0 = mx0;
  m1 = mx1;
  float rs[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    sc[i] = exp2_approx(sc[i] - ((i & 2) ? mx1 : mx0));
    rs[(i >> 1) & 1][(i >> 2) & 1] += sc[i];
  }
  rs0 = rs[0][0] + rs[0][1];
  rs1 = rs[1][0] + rs[1][1];
}

// P in bf16, as the A fragments of m64nDk16: k-step kk covers the score
// columns 16 kk .. 16 kk + 15, i.e. registers 8 kk .. 8 kk + 7.
__device__ __forceinline__ void pack_p(const float (&sc)[BN / 2],
                                       uint32_t (&pa)[BN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
    pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
    pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
    pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 uint16_t* __restrict__ o, float* __restrict__ lse, int B,
                 int H, int Hkv, int sq, int sk, int causal, int chunk) {
  using C = Cfg<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = sQ + C::Q_BYTES;                 // STAGES K tiles
  const uint32_t sV = sK + STAGES * C::KV_BYTES;       // STAGES V tiles
  const uint32_t q_full = sV + STAGES * C::KV_BYTES;   // then the barriers
  const uint32_t q_empty = q_full + 8;
  const uint32_t k_full = q_empty + 8;                 // [STAGES]
  const uint32_t v_full = k_full + 8 * STAGES;         // [STAGES]
  const uint32_t empty = v_full + 8 * STAGES;          // [STAGES]

  const int n_qt = (sq + BM - 1) / BM;
  const int n_tiles = n_qt * B * H;
  auto kv_tiles = [&](int q0) {  // kv tiles a q tile visits
    const int n = (sk + BN - 1) / BN;
    return causal ? min(n, (q0 + BM - 1) / BN + 1) : n;
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 2 * 128);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2 * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // A block walks block-tiles blockIdx.x, + gridDim.x, ...  The launcher
  // gives every tile its own block, so the loop runs once.  It stays, with
  // q_empty (which would hand the Q buffer to a next tile), because ptxas
  // fits the kernel in 168 registers only in this form: with nvcc 12.9.86
  // each loop-free form tried (this body with the tile loop's header
  // replaced by t = blockIdx.x; a rewrite without q_empty, with or without
  // `#pragma unroll 1` on the kv loop and with the tile computed after
  // setmaxnreg) spills 208-224 bytes at d = 128 and runs 27-48% slower
  // (PERF.md).  Try the loop-free form again with a later nvcc.
  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer warpgroup: one thread issues every TMA load ----
    setmaxnreg_dec<24>();
    if (threadIdx.x == 2 * 128) {
      tma_prefetch(&tq);
      tma_prefetch(&tk);
      tma_prefetch(&tv);
      int it = 0;  // K/V stage fills, over all tiles of this block
      for (int t = blockIdx.x, n = 0; t < n_tiles; t += gridDim.x, ++n) {
        const Tile tile(t, n_qt, B, H, chunk);
        const int q0 = tile.qt * BM, hk = tile.h / (H / Hkv);
        mbar_wait(q_empty, (n & 1) ^ 1);  // the last tile's Q is read
        mbar_arrive_expect_tx(q_full, C::Q_BYTES);
#pragma unroll
        for (int p = 0; p < C::NP; ++p)
          tma_load_4d(sQ + p * BM * C::ROWB, &tq, q_full, p * C::PW, tile.h,
                      q0, tile.b);
        const int nk = kv_tiles(q0);
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % STAGES;
          mbar_wait(empty + 8 * s, ((it / STAGES) & 1) ^ 1);
          mbar_arrive_expect_tx(k_full + 8 * s, C::KV_BYTES);
#pragma unroll
          for (int p = 0; p < C::NP; ++p)
            tma_load_4d(sK + s * C::KV_BYTES + p * BN * C::ROWB, &tk,
                        k_full + 8 * s, p * C::PW, hk, kt * BN, tile.b);
          mbar_arrive_expect_tx(v_full + 8 * s, C::KV_BYTES);
#pragma unroll
          for (int p = 0; p < C::NP; ++p)
            tma_load_4d(sV + s * C::KV_BYTES + p * BN * C::ROWB, &tv,
                        v_full + 8 * s, p * C::PW, hk, kt * BN, tile.b);
        }
      }
    }
  } else {
    // ---- consumer warpgroup wg: query rows q0 + 64 wg .. + 63 ----
    setmaxnreg_inc<240>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;
    const uint32_t qa = sQ + wg * 64 * C::ROWB;  // this warpgroup's Q rows
    // Turns on the tensor cores (named barriers 1 and 2): wait for ours
    // before issuing products, hand over after; one warpgroup's products
    // run while the other's softmax does.  Warpgroup 0 goes first.
    auto turn_begin = [&] { named_bar_sync(1 + wg, 256); };
    auto turn_end = [&](bool last) {
      if (!last) named_bar_arrive(2 - wg, 256);
    };
    if (wg == 1) named_bar_arrive(1, 256);

    float acc[D / 2];
    float sc[BN / 2];
    uint32_t pa[BN / 16][4];
    // S = Q K^T for the K tile in stage `st` (issued, not waited for).
    auto issue_s = [&](int st) {
      const uint32_t ka = sK + st * C::KV_BYTES;
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int p = kk * 16 / C::PW;               // panel
        const uint32_t off = (kk * 16 % C::PW) * 2;  // bytes into a row
        Wgmma<BN>::ss(sc,
                      smem_desc(qa + p * BM * C::ROWB + off, 16, 8 * C::ROWB,
                                C::LAYOUT),
                      smem_desc(ka + p * BN * C::ROWB + off, 16, 8 * C::ROWB,
                                C::LAYOUT),
                      kk > 0);
      }
      wgmma_commit();
    };
    // O += P V for the V tile in stage `st`, V MN-major: 16 kv rows a step.
    auto issue_pv = [&](int st) {
      const uint32_t va = sV + st * C::KV_BYTES;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        Wgmma<D>::rs(acc, pa[kk],
                     smem_desc(va + kk * 16 * C::ROWB, BN * C::ROWB,
                               8 * C::ROWB, C::LAYOUT));
      wgmma_commit();
    };
    auto rescale = [&](float alpha0, float alpha1) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= (i & 2) ? alpha1 : alpha0;
    };

    int it = 0;  // K/V stage uses, over all tiles of this block
    for (int t = blockIdx.x, n = 0; t < n_tiles; t += gridDim.x, ++n) {
      const Tile tile(t, n_qt, B, H, chunk);
      const int q0 = tile.qt * BM, nk = kv_tiles(q0);
      const bool last_tile = t + static_cast<int>(gridDim.x) >= n_tiles;
      const int row_lo = q0 + wg * 64;
      const int r0 = row_lo + warp * 16 + g, r1 = r0 + 8;  // this thread's
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      float m0 = NEG_INF, m1 = NEG_INF;
      float l0 = 0.f, l1 = 0.f;  // per-thread partial row sums
      float alpha0, alpha1, rs0, rs1;

      // S_0, then per kv tile j >= 1: S_j is issued together with
      // O += P_{j-1} V_{j-1}, so the softmax of S_j runs while P_{j-1}
      // V_{j-1} is still on the tensor cores; the last P V after the loop.
      mbar_wait(q_full, n & 1);
      mbar_wait(k_full + 8 * (it % STAGES), (it / STAGES) & 1);
      turn_begin();
      issue_s(it % STAGES);
      turn_end(false);
      wgmma_wait<0>();
      fence_regs(sc);
      if (nk == 1) mbar_arrive(q_empty);  // done with this Q tile
      softmax_step(sc, 0, r0, r1, t4, row_lo, sk, causal, m0, m1, alpha0,
                   alpha1, rs0, rs1);
      l0 = rs0;
      l1 = rs1;
      pack_p(sc, pa);
      for (int kt = 1; kt < nk; ++kt) {
        const int sj = (it + kt) % STAGES, sp = (it + kt - 1) % STAGES;
        mbar_wait(k_full + 8 * sj, ((it + kt) / STAGES) & 1);
        mbar_wait(v_full + 8 * sp, ((it + kt - 1) / STAGES) & 1);
        turn_begin();
        issue_s(sj);
        issue_pv(sp);
        turn_end(false);
        wgmma_wait<1>();  // S_j is in; P_{j-1} V_{j-1} may still run
        fence_regs(sc);
        if (kt == nk - 1) mbar_arrive(q_empty);
        softmax_step(sc, kt * BN, r0, r1, t4, row_lo, sk, causal, m0, m1,
                     alpha0, alpha1, rs0, rs1);
        wgmma_wait<0>();  // P_{j-1} V_{j-1} done: O and P are free again
        fence_regs(acc);
        mbar_arrive(empty + 8 * sp);
        rescale(alpha0, alpha1);
        l0 = l0 * alpha0 + rs0;
        l1 = l1 * alpha1 + rs1;
        pack_p(sc, pa);
      }
      const int sl = (it + nk - 1) % STAGES;
      mbar_wait(v_full + 8 * sl, ((it + nk - 1) / STAGES) & 1);
      turn_begin();
      issue_pv(sl);
      turn_end(wg == 1 && last_tile);  // warpgroup 1's last: to no one
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(empty + 8 * sl);
      it += nk;

      // Finalize: full row sums, o = acc / l in bf16, lse = m + log2(l).
      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      const size_t q_row = static_cast<size_t>(H) * D;
      uint16_t* ob = o + static_cast<size_t>(tile.b) * sq * q_row +
                     static_cast<size_t>(tile.h) * D;
#pragma unroll
      for (int i = 0; i < D / 2; i += 2) {
        const int col = (i / 4) * 8 + 2 * t4;
        const int row = (i & 2) ? r1 : r0;
        const float l = (i & 2) ? l1 : l0;
        if (row < sq)
          *reinterpret_cast<uint32_t*>(ob + row * q_row + col) =
              pack_bf16(acc[i] / l, acc[i + 1] / l);
      }
      if (t4 == 0) {
        float* lb = lse + (static_cast<size_t>(tile.b) * H + tile.h) * sq;
        if (r0 < sq) lb[r0] = m0 + log2f(l0);
        if (r1 < sq) lb[r1] = m1 + log2f(l1);
      }
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int H, int Hkv, int sq, int sk, int causal,
           cudaStream_t st) {
  using C = Cfg<D>;
  CUtensorMap tq, tk, tv;
  if (!encode_bshd(&tq, q, B, sq, H, D, BM, C::PW) ||
      !encode_bshd(&tk, k, B, sk, Hkv, D, BN, C::PW) ||
      !encode_bshd(&tv, v, B, sk, Hkv, D, BN, C::PW))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>((sq + BM - 1) / BM) * H * B;
  // (batch, head) pairs whose K and V take at most 16 MB of the 50 MB L2.
  const long kv_bytes = 4L * sk * D;
  const int chunk = static_cast<int>(
      std::max(1L, std::min<long>(B * H, (16L << 20) / kv_bytes)));
  flash_fwd_kernel<D><<<grid, THREADS, C::SMEM, st>>>(
      tq, tk, tv, static_cast<uint16_t*>(o), static_cast<float*>(lse), B, H,
      Hkv, sq, sk, causal, chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rtt_flash_fwd_bf16(const void* q, const void* k, const void* v,
                                  void* o, void* lse, int B, int H, int Hkv,
                                  int sq, int sk, int D, int causal,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch<32>(q, k, v, o, lse, B, H, Hkv, sq, sk, causal, st);
    case 64:
      return launch<64>(q, k, v, o, lse, B, H, Hkv, sq, sk, causal, st);
    case 128:
      return launch<128>(q, k, v, o, lse, B, H, Hkv, sq, sk, causal, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* rtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
