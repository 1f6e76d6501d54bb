// K4: paged (block-table) decode attention for Hopper (sm_90a).
//
// Replaces: ray_tpu/ops/paged_attention.py::_paged_kernel (the Pallas TPU
// kernel launched by paged_attention).  One query token per sequence attends
// to its context, which sits in a (num_blocks, block_size, h, d) page pool
// reached through block_tables[b, i].  Only the trailing `window` positions
// [max(ctx - window, 0), ctx) count (window 0 = all); pages outside them are
// never read, so table entries past the context may hold anything.  q comes
// unscaled with the constant c = sm_scale*log2(e) already rounded to q's
// dtype; the kernel forms q*c in f32 and rounds it to q's dtype (bf16 by
// __float2bfloat16_rn), bitwise what the plain path's _prescale gives.  The
// softmax is an f32 online softmax in the log2 domain with the finite
// NEG_INF = -1e30.
//
// Bound: bytes.  Each (sequence, head) reads its live k and v rows once:
// 4 d flop per 4 d bytes in bf16, two orders of magnitude below the
// card's 67 TFLOP/s f32 over 3.35 TB/s.  One query row per head gives no
// product for the tensor cores to take, so the math is f32 on the CUDA
// cores, and what the design has to supply is bytes in flight and blocks:
//
// - Grid (split, head, sequence).  The host splits each sequence's live
//   pages into `nsplit` runs of `pps` whole pages (flash-decoding), from an
//   upper bound on the live length, B, h and the SM count, without a device
//   sync (ops/paged_attention.py::_split_plan).  A split whose run holds no
//   live page marks its partial empty and only takes its ticket.
// - Each block is one warp.  It keeps a ring of `stages` (>= 3) page slots
//   in shared memory full with 1-D bulk copies (one per k or v row of the
//   page: d * elem bytes at a stride of h * d elements, issued by the lanes
//   in parallel) that complete on one mbarrier per slot, and refills a slot
//   as soon as it has read it.  The ring is sized to ~26 KB so that 8
//   blocks, ~150 KB of loads, can be in flight on each SM.  The split's
//   table entries are read 32 pages ahead, so no copy waits on a load.
// - A page is computed at once: its bs scores, 32 / LPR rows at a time
//   with LPR lanes to a row (16-byte vectors, 8 bf16 or 4 f32; one or two
//   shuffles sum a row).  Each row group (the lanes of rows g, g + R, ...)
//   keeps its own (m, l, acc): it takes the max of its scores on the page,
//   rescales once per page, then adds p = 2^(s - m) and p * v per live
//   row.  Dead positions (before `start` or past `ctx` in a live page) are
//   selected out, never multiplied by a weight of 0: their rows may hold
//   NaN or Inf.  The groups merge once, by shuffles, at the end, weighted
//   2^(m_g - M) as the splits are.  No load sits behind a branch: a lane's
//   vectors past the row's end read its last vector (q is 0 there).
// - q's, the context length's and the split's first table entries' loads
//   go out first, so a short call waits on the length, then the rows.
// - The splits are merged in the same launch: every split writes its
//   unnormalised (m, l, acc) to a workspace, and the last block of each
//   (sequence, head) to take its ticket merges them (weights 2^(m_s - M);
//   an empty split, l = 0, is skipped) and resets the ticket to 0, so the
//   cached workspace serves the next launch.  With one split the block
//   writes acc / l itself.
//
// 2^x is ex2.approx.ftz (exp2_approx): 0 gives exactly 1, and NEG_INF - m
// gives 0.  So window = 1 stays an exact gather of the stored row (the
// serving decoder's bitwise chains rest on it): one split, one live
// position, m = s, p = 2^0 = 1, l = 1 and acc = fmaf(1, v, 0) = v, and the
// idle groups (NEG_INF, 0, 0) add exact zeros; the card tests hold it
// bitwise at the serving and the long-batch shapes.
//
// Takes f32 and bf16 with d * elem a multiple of 16 bytes, 16 <= d * elem
// <= 1024 (d <= 256), and 3 ring slots of 2 * bs rows in shared memory; the
// wrapper raises on the rest.  k_cache and v_cache may alias.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"

namespace {

using namespace rtt;

constexpr int MAX_STAGES = 8;
constexpr int MAX_SMEM = 231424;  // dynamic shared memory a block may ask
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const void* q;
  const void* kc;
  const void* vc;
  const int* bt;
  const int* cl;
  void* o;
  float* ws;     // nsplit > 1: B*H*nsplit*D acc partials, B*H*nsplit (m, l)
  int* tickets;  // nsplit > 1: B*H zeros, left zero
  float qscale;
  int H, D, BS, max_pages, window, nsplit, pps, stages, lpr_log2;
};

// A 16-byte vector of T as f32, and back.
__device__ __forceinline__ void load16(const float* p, float (&f)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p,
                                       float (&f)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void store16(float* p, const float (&f)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}
__device__ __forceinline__ void store16(__nv_bfloat16* p,
                                        const float (&f)[8]) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]),
                 pack_bf16(f[4], f[5]), pack_bf16(f[6], f[7]));
}

// x rounded to T's precision (the pre-scaled q lives in q's dtype).
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Lanes split a row into its 16-byte vectors: 2^lpr_log2 lanes a row, each
// holding VPL of them, so the warp covers R = 32 / LPR rows at a time.  The
// host picks LPR >= 32 / bs (no lane idle on a page) and >= d / 64 (VPL * E
// <= 64 f32 of q and of acc a lane).  Rows sit in shared memory 16 bytes
// apart beyond their length, and lane `sub` of a row takes runs of G =
// max(8 / LPR, 1) vectors starting 16 * G * sub bytes in, so for rows a
// multiple of 128 bytes long the 8 lanes of a 128-byte load phase hit 8
// distinct 16-byte bank groups.
template <typename T, int VPL>
__global__ void __launch_bounds__(32)
paged_decode_kernel(const Args a) {
  constexpr int E = 16 / sizeof(T);
  extern __shared__ __align__(128) uint8_t ring[];
  __shared__ __align__(8) uint64_t full[MAX_STAGES];
  const int split = blockIdx.x, head = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x, lg = a.lpr_log2;
  const int LPR = 1 << lg, R = 32 >> lg;
  const int sub = lane & (LPR - 1), rg = lane >> lg;
  const int gl = lg >= 3 ? 0 : 3 - lg;  // runs of G = 2^gl vectors a lane
  const int H = a.H, D = a.D, BS = a.BS;
  const int NV = D / E;  // 16-byte vectors in a row
  const uint32_t row_bytes = D * sizeof(T);
  const uint32_t stride = row_bytes + 16;
  const uint32_t stage_bytes = 2 * BS * stride;  // k rows, then v rows
  // The ring (which later holds the splits' weights), then the page's
  // scores.
  float* sc = reinterpret_cast<float*>(
      ring + max(a.stages * stage_bytes, 4u * a.nsplit));
  const size_t bh = (size_t)b * H + head;
  // The vectors of this lane: runs of G, the lanes of a row side by side.
  // Past the row's end (vec >= NV) a lane reads the last vector instead,
  // so no load sits behind a branch: its q is 0 there, and that part of
  // its acc is never stored.
  int vec[VPL];
  uint32_t voff[VPL];
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    vec[i] = (i & ((1 << gl) - 1)) + ((sub + LPR * (i >> gl)) << gl);
    voff[i] = min(vec[i], NV - 1) * 16;
  }

  // The loads nothing depends on first: the context length, q, and the
  // table entries this split starts at when the window does not move it
  // (window 0), else the table's first 32.
  const int cl_b = a.cl[b];
  const int* bt_row = a.bt + (size_t)b * a.max_pages;
  const int spec0 = a.window > 0 ? 0 : split * a.pps;
  const int tb_spec = spec0 + lane < a.max_pages ? bt_row[spec0 + lane] : 0;
  float qf[VPL][E];
  const T* q = static_cast<const T*>(a.q) + bh * D;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    if (vec[i] < NV) {
      load16(q + vec[i] * E, qf[i]);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) qf[i][e] = 0.f;
    }
  }
  const uint32_t bar0 = smem_u32(full);
  if (lane == 0) {
    for (int s = 0; s < a.stages; ++s) mbar_init(bar0 + 8 * s, 1);
    fence_barrier_init();
  }
  __syncwarp();

  // This split's live pages [p0, p0 + n): relative to the sequence's first
  // live page, so short sequences leave their last splits empty.
  const int ctx = min(cl_b, a.max_pages * BS);
  const int start = a.window > 0 ? max(ctx - a.window, 0) : 0;
  const int p0 = start / BS + split * a.pps;
  const int n = ctx > 0 ? max(min(a.pps, (ctx - 1) / BS + 1 - p0), 0) : 0;

  // Each row group (the LPR lanes of rows rg, rg + R, ...) keeps its own
  // (m, l, acc); the groups merge once at the end.
  float acc[VPL][E];
#pragma unroll
  for (int i = 0; i < VPL; ++i)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[i][e] = 0.f;
  float m = NEG_INF, l = 0.f;

  if (n > 0) {
    const T* kc = static_cast<const T*>(a.kc);
    const T* vc = static_cast<const T*>(a.vc);
    // The split's table entries, 32 pages to a register (the first 32
    // from the early load where it holds them), the next 32 loaded as the
    // current ones start to be used.
    const int* bt = bt_row + p0;
    const int src = lane + p0 - spec0;  // p0 >= spec0
    int tb_cur = __shfl_sync(FULL, tb_spec, src & 31);
    if (src >= 32 && lane < n) tb_cur = bt[lane];
    int tb_next = lane + 32 < n ? bt[lane + 32] : 0;
    int chunk = 0;
    // The live rows of page j of the split (j rising by one a call) into
    // ring slot `stage`: one copy per k or v row, the lanes issuing in
    // parallel after lane 0 has armed the slot's barrier.  Dead rows are
    // not copied; their stale slots are selected out like any dead row.
    auto issue = [&](int j, int stage) {
      if ((j >> 5) != chunk) {
        chunk = j >> 5;
        tb_cur = tb_next;
        const int jn = (chunk + 1) * 32 + lane;
        tb_next = jn < n ? bt[jn] : 0;
      }
      const size_t blk = (size_t)__shfl_sync(FULL, tb_cur, j & 31);
      const int lo = (p0 + j) * BS;
      const int r0 = max(start - lo, 0), rows = min(ctx - lo, BS) - r0;
      const uint32_t bar = bar0 + 8 * stage;
      if (lane == 0) mbar_arrive_expect_tx(bar, 2 * rows * row_bytes);
      __syncwarp();
      const uint32_t dst = smem_u32(ring + stage * stage_bytes);
      for (int r = lane; r < 2 * rows; r += 32) {
        const int row = r0 + (r < rows ? r : r - rows);
        const size_t at = ((blk * BS + row) * H + head) * D;
        bulk_load(dst + (r < rows ? row : BS + row) * stride,
                  (r < rows ? kc : vc) + at, row_bytes, bar);
      }
    };
#pragma unroll 1
    for (int i = 0; i < min(n, a.stages); ++i) issue(i, i);
#pragma unroll
    for (int i = 0; i < VPL; ++i)
#pragma unroll
      for (int e = 0; e < E; ++e) qf[i][e] = round_to<T>(qf[i][e] * a.qscale);

    int stage = 0;
    uint32_t parity = 0;
    for (int i = 0; i < n; ++i) {
      mbar_wait(bar0 + 8 * stage, parity);
      const uint8_t* ks = ring + stage * stage_bytes;
      const uint8_t* vs = ks + BS * stride;
      const int lo = (p0 + i) * BS;
      // The dot products of row j of the page with q, summed over the
      // LPR lanes of its group.  Rows past the page (j >= BS) read its
      // last row and are masked by the caller.
      auto score = [&](int j) {
        const uint8_t* krow = ks + min(j, BS - 1) * stride;
        float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int i2 = 0; i2 < VPL; ++i2) {
          float kf[E];
          load16(reinterpret_cast<const T*>(krow + voff[i2]), kf);
#pragma unroll
          for (int e = 0; e < E; ++e)
            part[e % 4] = fmaf(qf[i2][e], kf[e], part[e % 4]);
        }
        float s = (part[0] + part[1]) + (part[2] + part[3]);
        for (int off = LPR / 2; off > 0; off /= 2)
          s += __shfl_xor_sync(FULL, s, off);
        const bool live = j < BS && lo + j >= start && lo + j < ctx;
        return live ? s : NEG_INF;
      };
      auto add_row = [&](int j, float p) {  // l += p, acc += p * v_j
        l += p;
        const uint8_t* vrow = vs + j * stride;
#pragma unroll
        for (int i2 = 0; i2 < VPL; ++i2) {
          float vf[E];
          load16(reinterpret_cast<const T*>(vrow + voff[i2]), vf);
#pragma unroll
          for (int e = 0; e < E; ++e) acc[i2][e] = fmaf(p, vf[e], acc[i2][e]);
        }
      };
      auto rescale = [&](float alpha) {
        l *= alpha;
#pragma unroll
        for (int i2 = 0; i2 < VPL; ++i2)
#pragma unroll
          for (int e = 0; e < E; ++e) acc[i2][e] *= alpha;
      };
      float m_new;
      if (BS <= R) {
        // One row a group: its score, one rescale, its weight and value.
        const float s = score(rg);
        m_new = fmaxf(m, s);
        rescale(exp2_approx(m - m_new));
        if (s != NEG_INF) add_row(rg, exp2_approx(s - m_new));
      } else {
        // Several rows a group: their scores (kept in shared memory) and
        // max, one rescale, then each live row's weight and value.
        float pm = NEG_INF;
        for (int j = rg; j - rg < BS; j += R) {
          const float s = score(j);
          if (sub == 0 && j < BS) sc[j] = s;
          pm = fmaxf(pm, s);
        }
        __syncwarp();
        m_new = fmaxf(m, pm);
        rescale(exp2_approx(m - m_new));
        for (int j = rg; j < BS; j += R)
          if (sc[j] != NEG_INF) add_row(j, exp2_approx(sc[j] - m_new));
      }
      m = m_new;
      if (i + a.stages < n) {  // every lane is done with this slot: refill
        fence_proxy_async();
        __syncwarp();
        issue(i + a.stages, stage);
      }
      if (++stage == a.stages) stage = 0, parity ^= 1;
    }
  }

  // Merge the R row groups pairwise by shuffles, weights 2^(m - M): an idle
  // group's (NEG_INF, 0, 0) weighs 0 and leaves the other exact.  Then
  // every row group holds the merged (m, l, acc) of this split.  When one
  // group alone saw live rows (always so at window = 1), its own state is
  // the split's, and group `owner` writes it.
  const unsigned busy = __ballot_sync(FULL, sub == 0 && l > 0.f);
  const int owner = busy ? (__ffs(busy) - 1) >> lg : 0;
  if (__popc(busy) <= 1) {
    m = __shfl_sync(FULL, m, owner << lg);
    l = __shfl_sync(FULL, l, owner << lg);
  } else {
    for (int off = LPR; off < 32; off *= 2) {
      const float m_o = __shfl_xor_sync(FULL, m, off);
      const float l_o = __shfl_xor_sync(FULL, l, off);
      const float m_n = fmaxf(m, m_o);
      const float w = exp2_approx(m - m_n), w_o = exp2_approx(m_o - m_n);
      l = fmaf(l_o, w_o, l * w);
#pragma unroll
      for (int i = 0; i < VPL; ++i)
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float x = __shfl_xor_sync(FULL, acc[i][e], off);
          acc[i][e] = fmaf(x, w_o, acc[i][e] * w);
        }
      m = m_n;
    }
  }

  T* o = static_cast<T*>(a.o) + bh * D;
  if (a.nsplit == 1) {
    if (rg == owner) {
      const float inv = __frcp_rn(l);
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        if (vec[i] < NV) {
          float r[E];
#pragma unroll
          for (int e = 0; e < E; ++e) r[e] = acc[i][e] * inv;
          store16(o + vec[i] * E, r);
        }
      }
    }
    return;
  }

  // Several splits: publish this one's partial, take the ticket.
  float* red = reinterpret_cast<float*>(ring);  // the splits' weights
  const size_t part = bh * a.nsplit + split;
  float* ml = a.ws + (size_t)gridDim.z * H * a.nsplit * D;
  if (n > 0 && rg == owner) {
#pragma unroll
    for (int i = 0; i < VPL; ++i)
      if (vec[i] < NV)
#pragma unroll
        for (int e = 0; e < E; e += 4)
          *reinterpret_cast<float4*>(a.ws + part * D + vec[i] * E + e) =
              make_float4(acc[i][e], acc[i][e + 1], acc[i][e + 2],
                          acc[i][e + 3]);
  }
  if (lane == 0) {
    ml[2 * part] = m;
    ml[2 * part + 1] = l;  // 0 marks an empty split: its acc is not written
  }
  __threadfence();
  __syncwarp();
  int ticket = 0;
  if (lane == 0) ticket = atomicAdd(a.tickets + bh, 1);
  ticket = __shfl_sync(FULL, ticket, 0);
  if (ticket != a.nsplit - 1) return;

  // The last split of this (sequence, head) merges all of them.
  __threadfence();
  if (lane == 0) a.tickets[bh] = 0;
  // Each lane takes splits lane, lane + 32, ...: M and L by warp
  // reductions, each split's weight (0 for an empty one) into shared
  // memory, then every lane merges its vectors over all splits at once.
  const float* mls = ml + 2 * bh * a.nsplit;
  float M = NEG_INF;
  for (int s = lane; s < a.nsplit; s += 32) M = fmaxf(M, __ldcg(mls + 2 * s));
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    M = fmaxf(M, __shfl_xor_sync(FULL, M, off));
  float L = 0.f;
  for (int s = lane; s < a.nsplit; s += 32) {
    const float ls = __ldcg(mls + 2 * s + 1);
    const float w = ls > 0.f ? exp2_approx(__ldcg(mls + 2 * s) - M) : 0.f;
    red[s] = w;
    L += ls * w;
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) L += __shfl_xor_sync(FULL, L, off);
  __syncwarp();
  const float* accs = a.ws + bh * a.nsplit * D;
  for (int c = lane; c < NV; c += 32) {
    float r[E];
#pragma unroll
    for (int e = 0; e < E; ++e) r[e] = 0.f;
#pragma unroll 4
    for (int s = 0; s < a.nsplit; ++s) {
      const float w = red[s];
#pragma unroll
      for (int e = 0; e < E; e += 4) {
        const float4 v = __ldcg(
            reinterpret_cast<const float4*>(accs + s * D + c * E + e));
        // An empty split's acc was never written: select, never 0 * x.
        r[e] = w != 0.f ? fmaf(w, v.x, r[e]) : r[e];
        r[e + 1] = w != 0.f ? fmaf(w, v.y, r[e + 1]) : r[e + 1];
        r[e + 2] = w != 0.f ? fmaf(w, v.z, r[e + 2]) : r[e + 2];
        r[e + 3] = w != 0.f ? fmaf(w, v.w, r[e + 3]) : r[e + 3];
      }
    }
    const float inv = __frcp_rn(L);
#pragma unroll
    for (int e = 0; e < E; ++e) r[e] *= inv;
    store16(o + c * E, r);
  }
}

template <typename T, int VPL>
int launch(const Args& a, int B, size_t smem, cudaStream_t st) {
  auto kernel = paged_decode_kernel<T, VPL>;
  // A ring of large pages may need more than the default 48 KB.
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<dim3(a.nsplit, a.H, B), 32, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The instantiation whose VPL covers the row's 16-byte vectors at the
// host's lanes per row (which keeps VPL * E <= 64).
template <typename T>
int launch_for(const Args& a, int B, size_t smem, cudaStream_t st) {
  const int nv = a.D * static_cast<int>(sizeof(T)) / 16;
  const int g = a.lpr_log2 >= 3 ? 1 : 8 >> a.lpr_log2;
  const int vpl = max((nv + (1 << a.lpr_log2) - 1) >> a.lpr_log2, g);
  if (vpl <= 1) return launch<T, 1>(a, B, smem, st);
  if (vpl <= 2) return launch<T, 2>(a, B, smem, st);
  if (vpl <= 4) return launch<T, 4>(a, B, smem, st);
  if (vpl <= 8) return launch<T, 8>(a, B, smem, st);
  if constexpr (sizeof(T) == 4) {
    if (vpl <= 16) return launch<T, 16>(a, B, smem, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; 2^lpr_log2 lanes share a row.  ws and
// tickets may be null when nsplit == 1.  Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for what the kernel does not take.
extern "C" int rtt_paged_decode(const void* q, const void* k_cache,
                                const void* v_cache, const void* block_tables,
                                const void* context_lens, void* o, void* ws,
                                void* tickets, int dtype, int B, int H, int D,
                                int BS, int max_pages, int window, int nsplit,
                                int pps, int stages, int lpr_log2,
                                float qscale, void* stream) {
  const int elem = dtype == 0 ? 4 : 2;
  const size_t row = static_cast<size_t>(D) * elem;
  const size_t stride = row + 16;
  const size_t smem = std::max(stages * 2 * BS * stride, 4 * size_t(nsplit)) +
                      4 * static_cast<size_t>(BS);
  if ((dtype != 0 && dtype != 1) || D < 1 || row % 16 || row > 1024 ||
      B < 1 || B > 65535 || H < 1 || H > 65535 || BS < 1 ||
      max_pages < 1 || stages < 3 || stages > MAX_STAGES || lpr_log2 < 0 ||
      lpr_log2 > 5 || smem > MAX_SMEM || nsplit < 1 || pps < 1 ||
      (nsplit > 1 && (ws == nullptr || tickets == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k_cache, v_cache,
               static_cast<const int*>(block_tables),
               static_cast<const int*>(context_lens), o,
               static_cast<float*>(ws), static_cast<int*>(tickets), qscale,
               H, D, BS, max_pages, window, nsplit, pps, stages, lpr_log2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_for<float>(a, B, smem, st)
                    : launch_for<__nv_bfloat16>(a, B, smem, st);
}

extern "C" const char* rtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
