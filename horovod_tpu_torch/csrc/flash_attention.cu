// FlashAttention forward and backward for Hopper (sm_90a), CUDA C++.
//
// Three kernels replace the Pallas kernels of the JAX package
// (horovod_tpu/ops/flash_attention.py).  At gpt_small's training shape
// (B*H = 96, T = 2048, D = 64, causal, bf16) each does O(T^2 D) tensor-core
// work on O(T D) bytes, so operations at 989 TFLOP/s (dense bf16) bound
// it, not the 3.35 TB/s of device memory; all three keep the T x T scores
// out of device memory and own their outputs (no atomics, no second pass).
//
// flash_fwd_kernel <- _fwd_kernel.  o = softmax(q.k^T * scale) . v and the
//   row log-sum-exp.  Bound: 4 D flops a visible (query, key) pair,
//   0.052 ms at the main shape; at D = 64 the exp unit (16 a clock per SM)
//   is as busy per pair as the tensor cores, so the softmax is no small
//   addition.  Design for Hopper, warp-specialised: a block is one
//   producer warpgroup and three consumer warpgroups at D <= 64 (two at
//   D = 128), each consumer owning 64 queries; setmaxnreg moves registers
//   from the producer to the consumers.  One producer thread loads the
//   block's Q tile once and streams K and V tiles of 128 keys (64 at
//   D = 128) through a two-stage ring by TMA, each stage with a full and
//   an empty mbarrier, so loads overlap the products.  Each consumer
//   computes S = Q.K^T with wgmma from shared memory, runs the online
//   softmax on the accumulator fragments (exp2; a row's max across its 4
//   threads by two shuffles), packs P to 16 bits in registers and adds
//   P.V with the register-A form of wgmma, V read transposed from its
//   [key][d] tile.  Blocks run head-group by head-group (K and V stay in
//   L2), heaviest causal tiles (the last queries) first.
// flash_bwd_dq_kernel <- _bwd_dq_kernel.  dq = (p * (do.v^T - delta)) *
//   scale . k.  Bound: 6 D flops a pair, 0.078 ms.  The forward's data
//   flow and design: three consumer warpgroups at D <= 64 (two at
//   D = 128), each owning 64 queries; Q and dO are loaded once by TMA,
//   and the producer streams K and V tiles of 64 keys through the
//   two-stage ring, K and V behind their own full barriers so that
//   S = Q.K^T starts before V lands.  Each consumer holds its rows' lse
//   and delta in registers, computes S and dP = dO.V^T with wgmma, forms
//   P and dS in registers (the exp of P overlapping the dP product), and
//   adds dQ += dS.K with register-A wgmma, K read transposed as the
//   forward reads V.  Blocks run head-group by head-group, heaviest causal
//   tiles first.
// flash_bwd_dkv_kernel <- _bwd_dkv_kernel.  dv = p^T.do, dk = ds^T.q.
//   Bound: 8 D flops a pair, 0.104 ms.  Same design as the forward with two
//   consumer warpgroups: a block owns 128 keys, 64 per consumer; K and V
//   are loaded once by TMA, and the producer warp streams Q and dO tiles
//   of 64 queries (32 at D = 128) through a two-stage ring, from the first
//   tile that sees the block's keys, with lse and delta copied beside them
//   by plain loads masked at tq.  Each consumer computes S^T = K.Q^T and
//   dP^T = V.dO^T with wgmma, forms P^T and dS^T in registers, and adds
//   dV += P^T.dO and dK += dS^T.Q with register-A wgmma.  Working on the
//   transposed scores keeps each warpgroup's dk and dv rows private.
//   Blocks run head-group by head-group, earliest keys (which see the
//   most queries) first.
//
// All three follow the reference's semantics: the bottom-right causal
// offset tk - tq, rows and columns past the sequence end masked (so any
// length works), fp32 softmax statistics, NEG_INF = -1e30 (rows with no
// weight give o = 0 and lse = NEG_INF), and the rounding points p -> v's
// type before P.V, ds -> k's type before dS.K, p -> do's type before
// P^T.dO, ds -> q's type before dS^T.Q.
//
// Interface: plain C functions, loaded with ctypes.  Tensors are
// contiguous [BH, T, D] with 16-byte aligned bases (TMA needs them); lse
// and delta are [BH, tq] fp32.  The TMA maps are encoded on the host in
// each call.  Each entry returns cudaGetLastError() after its launch (0 on
// success), or the error that stopped it before.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <atomic>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // the reference's NEG_INF, not -inf

// Rounds two fp32 values to one register of two 16-bit T (lo first).
template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    uint32_t r;
    memcpy(&r, &v, 4);
    return r;
  }
};

template <>
struct Mma<__half> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    uint32_t r;
    memcpy(&r, &v, 4);
    return r;
  }
};

// Register fragments (PTX ISA), with g = lane / 4 and t = lane % 4.  A
// wgmma m64nN fp32 accumulator gives each warp 16 rows; a thread's element
// i is row g + 8 ((i >> 1) & 1) and column 8 (i >> 2) + 2t + (i & 1).  The
// A operand of a register-A wgmma (per warp the A fragment of
// mma.m16n8k16) holds a 16x16 slice as a0 (g, 2t..2t+1), a1 (g+8, 2t..),
// a2 (g, 2t+8..), a3 (g+8, 2t+8..).  So 16 accumulator columns, packed to
// 16 bits, are exactly one A fragment of the next product (pack_a), which
// is how P and dS stay in registers.

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Stores a thread's D / 2 fp32 accumulators of rows row_a and row_a + 8
// (scaled per row) as T, from the layout of a wgmma m64nD accumulator.
template <typename T, int D>
__device__ __forceinline__ void store_acc(T* out, const float* acc,
                                          int row_a, int n_rows,
                                          float scale_a, float scale_b) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = j * 8 + 2 * t;
    if (row_a < n_rows)
      *reinterpret_cast<uint32_t*>(out + (size_t)row_a * D + col) =
          Mma<T>::pack(acc[4 * j] * scale_a, acc[4 * j + 1] * scale_a);
    if (row_a + 8 < n_rows)
      *reinterpret_cast<uint32_t*>(out + (size_t)(row_a + 8) * D + col) =
          Mma<T>::pack(acc[4 * j + 2] * scale_b, acc[4 * j + 3] * scale_b);
  }
}

// ---------------------------------------------------------------------------
// Shared by the warp-specialised kernels
// ---------------------------------------------------------------------------
constexpr int kStages = 2;        // depth of the TMA ring
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// A block is one producer warpgroup (warp 0 issues the loads) and
// `Consumers` consumer warpgroups; setmaxnreg moves registers from the
// producer to the consumers (64 K registers a SM).
template <int Consumers>
struct WsRegs {
  static constexpr int kThreads = 128 * (Consumers + 1);
  static constexpr int kProducer = Consumers == 3 ? 24 : 40;
  static constexpr int kConsumer = Consumers == 3 ? 160 : 232;
  static_assert(128 * kProducer + 128 * Consumers * kConsumer <= 65536,
                "register file of one SM");
};

// The (head, tile) of this block in a 1-D grid of bh * n_tiles blocks:
// group by group of `Group` heads, and inside a group tile 0 of every head,
// then tile 1, ...  So the K and V (or Q and dO) tiles a group streams stay
// in L2 while its blocks run.  Each kernel maps tile 0 to its heaviest
// causal tile.
template <int Group>
__device__ __forceinline__ void block_coords(int bh_total, int n_tiles,
                                             int& bh, int& tile) {
  const int per_group = Group * n_tiles;
  const int group = blockIdx.x / per_group, rem = blockIdx.x % per_group;
  const int heads = min(Group, bh_total - group * Group);
  bh = group * Group + rem % heads;
  tile = rem / heads;
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Packs accumulator fragments (m64nN, fp32) into the A fragments of the
// next product, rounded to T: columns [16 kk, 16 kk + 16) of each row.
template <typename T, int R>
__device__ __forceinline__ void pack_a(uint32_t (&a)[R / 8][4],
                                       const float (&s)[R]) {
#pragma unroll
  for (int kk = 0; kk < R / 8; ++kk) {
    a[kk][0] = Mma<T>::pack(s[8 * kk + 0], s[8 * kk + 1]);
    a[kk][1] = Mma<T>::pack(s[8 * kk + 2], s[8 * kk + 3]);
    a[kk][2] = Mma<T>::pack(s[8 * kk + 4], s[8 * kk + 5]);
    a[kk][3] = Mma<T>::pack(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// The producer thread's loop of the forward and dq kernels: K and V tiles
// j = 0 .. n_kv-1 of BN keys into ring stage j % kStages, each once the
// consumers have released tile j - kStages.  `bars` holds per stage a K
// full, a V full and an empty mbarrier: k_full(s) = bars + 8 s,
// v_full(s) = bars + 8 (kStages + s), empty(s) = bars + 8 (2 kStages + s).
template <int BN, int D>
__device__ __forceinline__ void stream_kv(const CUtensorMap* k_map,
                                          const CUtensorMap* v_map,
                                          uint32_t k_s, uint32_t v_s,
                                          uint32_t bars, int n_kv, int bh) {
  using Tile = hopper::SmemTile<BN, D>;
  for (int j = 0; j < n_kv; ++j) {
    const int s = j % kStages;
    const uint32_t k_full = bars + 8 * s, v_full = k_full + 8 * kStages;
    if (j >= kStages)
      hopper::mbar_wait(v_full + 8 * kStages, (j / kStages - 1) & 1);
    hopper::mbar_arrive_expect_tx(k_full, Tile::kBytes);
    hopper::tma_load_tile<BN, D>(k_s + s * Tile::kBytes, k_map, k_full,
                                 j * BN, bh);
    hopper::mbar_arrive_expect_tx(v_full, Tile::kBytes);
    hopper::tma_load_tile<BN, D>(v_s + s * Tile::kBytes, v_map, v_full,
                                 j * BN, bh);
  }
}

// ---------------------------------------------------------------------------
// Forward: o = softmax(q.k^T * scale) . v, lse = log-sum-exp of each row.
// ---------------------------------------------------------------------------
template <int D>
struct FwdShape {
  // At D <= 64 the softmax costs as much as the two products, and a third
  // consumer warpgroup hides more of its latency; at D = 128 the
  // accumulators of two fill the registers.
  static constexpr int kConsumers = D > 64 ? 2 : 3;
  static constexpr int kHeadGroup = 16;
  using Regs = WsRegs<kConsumers>;
  static constexpr int kBM = 64 * kConsumers;    // queries of a block
  static constexpr int kBN = D > 64 ? 64 : 128;  // keys of a ring stage
  using QTile = hopper::SmemTile<kBM, D>;
  using KTile = hopper::SmemTile<kBN, D>;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + QTile::kBytes;
  static constexpr int kV = kK + kStages * KTile::kBytes;
  static constexpr int kBars = kV + kStages * KTile::kBytes;
  // q_full, then per stage k_full, v_full, empty; 1024 bytes of slack to
  // align the tiles.
  static constexpr int kSmem = kBars + 8 * (1 + 3 * kStages) + 1024;
};

template <typename T, int D>
__global__ void __launch_bounds__(FwdShape<D>::Regs::kThreads, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     T* __restrict__ o, float* __restrict__ lse, int bh_total,
                     int tq, int tk, float sm_scale, int causal) {
  using S = FwdShape<D>;
  using QTile = typename S::QTile;
  using KTile = typename S::KTile;
  constexpr int kBN = S::kBN;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (hopper::smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base + S::kQ;
  const uint32_t bars = base + S::kBars;
  const uint32_t q_full = bars;
  auto k_tile = [&](int s) { return base + S::kK + s * KTile::kBytes; };
  auto v_tile = [&](int s) { return base + S::kV + s * KTile::kBytes; };
  auto k_full = [&](int s) { return bars + 8 * (1 + s); };
  auto v_full = [&](int s) { return bars + 8 * (1 + kStages + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + 2 * kStages + s); };

  // Heaviest causal tiles (late queries) are scheduled first.
  const int n_q = (tq + S::kBM - 1) / S::kBM;
  int bh, tile;
  block_coords<S::kHeadGroup>(bh_total, n_q, bh, tile);
  const int q0 = (n_q - 1 - tile) * S::kBM;
  const int offset = tk - tq;
  int n_kv = (tk + kBN - 1) / kBN;
  if (causal) n_kv = min(n_kv, (q0 + S::kBM - 1 + offset) / kBN + 1);

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(k_full(s), 1);
      hopper::mbar_init(v_full(s), 1);
      hopper::mbar_init(empty(s), S::kConsumers);  // one arrival each
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer warpgroup: one thread issues every load.
    hopper::regs_dec<S::Regs::kProducer>();
    if (threadIdx.x == 0) {
      hopper::mbar_arrive_expect_tx(q_full, QTile::kBytes);
      hopper::tma_load_tile<S::kBM, D>(q_s, &q_map, q_full, q0, bh);
      stream_kv<kBN, D>(&k_map, &v_map, k_tile(0), v_tile(0), k_full(0),
                        n_kv, bh);
    }
  } else {
    // Consumer warpgroup c owns queries [q0 + 64c, q0 + 64c + 64); each
    // warp 16 of them, each thread rows g and g + 8 of its warp's.
    hopper::regs_inc<S::Regs::kConsumer>();
    const int c = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int row0 = q0 + 64 * c;
    const int row_a = row0 + 16 * warp + g, row_b = row_a + 8;
    const float scale_log2 = sm_scale * kLog2e;

    // Softmax statistics in the log2 domain: m is the running max of
    // s * scale * log2(e), l the thread's share of its rows' sums.
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    hopper::mbar_wait(q_full, 0);
    for (int j = 0; j < n_kv; ++j) {
      const int s = j % kStages;
      const uint32_t parity = (j / kStages) & 1;
      const int k0 = j * kBN;

      float sc[kBN / 2];
      hopper::mbar_wait(k_full(s), parity);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_ss<T, kBN>(sc, QTile::k_major(q_s, 64 * c, kk),
                                 KTile::k_major(k_tile(s), 0, kk), kk > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::reg_fence(sc);

#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) sc[i] *= scale_log2;
      if (k0 + kBN > tk || (causal && k0 + kBN - 1 > row0 + offset)) {
#pragma unroll
        for (int i = 0; i < kBN / 2; ++i) {
          const int col = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
          const int row = (i & 2) ? row_b : row_a;
          if (!(col < tk && (!causal || row + offset >= col)))
            sc[i] = kNegInf;
        }
      }
      // Row max and row sum in 4 independent chains a row (element i
      // goes to chain (i >> 2) & 3), not one chain of kBN / 4.
      float mx[2][4];
#pragma unroll
      for (int i = 0; i < 8; ++i) mx[i >> 2][i & 3] = kNegInf;
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i)
        mx[(i >> 1) & 1][(i >> 2) & 3] =
            fmaxf(mx[(i >> 1) & 1][(i >> 2) & 3], sc[i]);
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float tile_max = fmaxf(fmaxf(mx[r][0], mx[r][1]),
                                     fmaxf(mx[r][2], mx[r][3]));
        const float m_new = fmaxf(m[r], quad_max(tile_max));
        alpha[r] = fast_exp2(m[r] - m_new);
        m[r] = m_new;
      }
      float rs[2][4] = {};
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) {
        const float p = fast_exp2(sc[i] - m[(i >> 1) & 1]);
        sc[i] = p;
        rs[(i >> 1) & 1][(i >> 2) & 3] += p;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
        l[r] = l[r] * alpha[r] +
               ((rs[r][0] + rs[r][1]) + (rs[r][2] + rs[r][3]));
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

      // acc += p.v, with p rounded to v's type (reference :116).
      uint32_t pa[kBN / 16][4];
      pack_a<T, kBN / 2>(pa, sc);
      hopper::mbar_wait(v_full(s), parity);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
        hopper::wgmma_rs<T, D>(acc, pa[kk], KTile::mn_major(v_tile(s), kk),
                               1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::reg_fence(acc);
      hopper::reg_fence(pa);
      if (tid == 0) hopper::mbar_arrive(empty(s));
    }

    // Rows with no weight give o = 0 and lse = NEG_INF (reference :118-128).
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = quad_sum(l[r]);
      const float l_safe = l[r] == 0.f ? 1.f : l[r];
      inv[r] = 1.f / l_safe;
      const int row = r == 0 ? row_a : row_b;
      if (t == 0 && row < tq)
        lse[(size_t)bh * tq + row] =
            l[r] == 0.f ? kNegInf : m[r] * kLn2 + logf(l_safe);
    }
    store_acc<T, D>(o + (size_t)bh * tq * D, acc, row_a, tq, inv[0], inv[1]);
  }
}

// ---------------------------------------------------------------------------
// Backward, dq: p = exp(s - lse), ds = p * (do.v^T - delta) * scale,
// dq = ds.k.  One block per (bh, query tile of 64 rows a consumer), loop
// over the key tiles its queries see.
// ---------------------------------------------------------------------------
template <int D>
struct DqShape {
  // As in the forward, a third consumer warpgroup at D <= 64 hides more of
  // the exp's latency; with 160 registers a thread it holds S, dP, dQ and
  // dS of 64-key tiles (128-key tiles need 192 for them alone).  Timed in
  // turns on the card, three consumers with 64-key tiles beat two with
  // 128-key tiles by 3 %.
  static constexpr int kConsumers = D > 64 ? 2 : 3;
  using Regs = WsRegs<kConsumers>;
  static constexpr int kHeadGroup = 16;
  static constexpr int kBM = 64 * kConsumers;  // queries of a block
  static constexpr int kBN = 64;               // keys of a ring stage
  using QTile = hopper::SmemTile<kBM, D>;
  using KTile = hopper::SmemTile<kBN, D>;
  static constexpr int kQ = 0;
  static constexpr int kDo = kQ + QTile::kBytes;
  static constexpr int kK = kDo + QTile::kBytes;
  static constexpr int kV = kK + kStages * KTile::kBytes;
  static constexpr int kBars = kV + kStages * KTile::kBytes;
  // q_full (Q and dO), then per stage k_full, v_full, empty; slack to
  // align the tiles.
  static constexpr int kSmem = kBars + 8 * (1 + 3 * kStages) + 1024;
};

template <typename T, int D>
__global__ void __launch_bounds__(DqShape<D>::Regs::kThreads, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap q_map,
                        const __grid_constant__ CUtensorMap k_map,
                        const __grid_constant__ CUtensorMap v_map,
                        const __grid_constant__ CUtensorMap do_map,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int bh_total, int tq, int tk, float sm_scale,
                        int causal) {
  using S = DqShape<D>;
  using QTile = typename S::QTile;
  using KTile = typename S::KTile;
  constexpr int kBN = S::kBN;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (hopper::smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base + S::kQ, do_s = base + S::kDo;
  const uint32_t bars = base + S::kBars;
  const uint32_t q_full = bars;
  auto k_tile = [&](int s) { return base + S::kK + s * KTile::kBytes; };
  auto v_tile = [&](int s) { return base + S::kV + s * KTile::kBytes; };
  auto k_full = [&](int s) { return bars + 8 * (1 + s); };
  auto v_full = [&](int s) { return bars + 8 * (1 + kStages + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + 2 * kStages + s); };

  // Heaviest causal tiles (late queries) are scheduled first.
  const int n_q = (tq + S::kBM - 1) / S::kBM;
  int bh, tile;
  block_coords<S::kHeadGroup>(bh_total, n_q, bh, tile);
  const int q0 = (n_q - 1 - tile) * S::kBM;
  const int offset = tk - tq;
  int n_kv = (tk + kBN - 1) / kBN;
  if (causal) n_kv = min(n_kv, (q0 + S::kBM - 1 + offset) / kBN + 1);

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(k_full(s), 1);
      hopper::mbar_init(v_full(s), 1);
      hopper::mbar_init(empty(s), S::kConsumers);  // one arrival each
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer warpgroup: one thread issues every load.
    hopper::regs_dec<S::Regs::kProducer>();
    if (threadIdx.x == 0) {
      hopper::mbar_arrive_expect_tx(q_full, 2 * QTile::kBytes);
      hopper::tma_load_tile<S::kBM, D>(q_s, &q_map, q_full, q0, bh);
      hopper::tma_load_tile<S::kBM, D>(do_s, &do_map, q_full, q0, bh);
      stream_kv<kBN, D>(&k_map, &v_map, k_tile(0), v_tile(0), k_full(0),
                        n_kv, bh);
    }
  } else {
    // Consumer warpgroup c owns queries [q0 + 64c, q0 + 64c + 64); each
    // warp 16 of them, each thread rows g and g + 8 of its warp's.
    hopper::regs_inc<S::Regs::kConsumer>();
    const int c = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int row0 = q0 + 64 * c;
    const int row_a = row0 + 16 * warp + g, row_b = row_a + 8;
    const float scale_log2 = sm_scale * kLog2e;

    // The two rows' lse (log2 domain) and delta, fixed for the block;
    // rows past tq read 0 and are masked.
    float lse2[2], dlt[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r == 0 ? row_a : row_b;
      lse2[r] = row < tq ? lse[(size_t)bh * tq + row] * kLog2e : 0.f;
      dlt[r] = row < tq ? delta[(size_t)bh * tq + row] : 0.f;
    }
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    hopper::mbar_wait(q_full, 0);
    for (int j = 0; j < n_kv; ++j) {
      const int s = j % kStages;
      const uint32_t parity = (j / kStages) & 1;
      const int k0 = j * kBN;

      // S = Q.K^T as soon as K lands, then dP = dO.V^T behind it.
      float sc[kBN / 2], dp[kBN / 2];
      hopper::mbar_wait(k_full(s), parity);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_ss<T, kBN>(sc, QTile::k_major(q_s, 64 * c, kk),
                                 KTile::k_major(k_tile(s), 0, kk), kk > 0);
      hopper::wgmma_commit();
      hopper::mbar_wait(v_full(s), parity);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_ss<T, kBN>(dp, QTile::k_major(do_s, 64 * c, kk),
                                 KTile::k_major(v_tile(s), 0, kk), kk > 0);
      hopper::wgmma_commit();

      // p = exp(s * scale - lse) while dP runs.
      hopper::wgmma_wait<1>();
      hopper::reg_fence(sc);
      const bool edge = k0 + kBN > tk || row0 + 64 > tq ||
                        (causal && k0 + kBN - 1 > row0 + offset);
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) {
        float p = fast_exp2(sc[i] * scale_log2 - lse2[(i >> 1) & 1]);
        if (edge) {
          const int col = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
          const int row = (i & 2) ? row_b : row_a;
          if (!(row < tq && col < tk && (!causal || row + offset >= col)))
            p = 0.f;
        }
        sc[i] = p;
      }
      hopper::wgmma_wait<0>();
      hopper::reg_fence(dp);
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i)
        dp[i] = sc[i] * (dp[i] - dlt[(i >> 1) & 1]) * sm_scale;

      // dq += ds.k, with ds rounded to k's type (reference :217).
      uint32_t dsa[kBN / 16][4];
      pack_a<T, kBN / 2>(dsa, dp);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
        hopper::wgmma_rs<T, D>(acc, dsa[kk], KTile::mn_major(k_tile(s), kk),
                               1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::reg_fence(acc);
      hopper::reg_fence(dsa);
      if (tid == 0) hopper::mbar_arrive(empty(s));
    }
    store_acc<T, D>(dq + (size_t)bh * tq * D, acc, row_a, tq, 1.f, 1.f);
  }
}

// ---------------------------------------------------------------------------
// Backward, dk and dv: one block per (bh, 128-key tile), loop over the
// query tiles that can see it.  Works on S^T = k.q^T so each consumer
// warpgroup's 64 key rows own their dk and dv rows:  dv += p^T.do,
// dk += ds^T.q.
// ---------------------------------------------------------------------------
template <int D>
struct DkvShape {
  using Regs = WsRegs<2>;
  static constexpr int kHeadGroup = 8;
  static constexpr int kBM = 128;             // keys of a block
  static constexpr int kBQ = D > 64 ? 32 : 64;  // queries of a ring stage
  using KTile = hopper::SmemTile<kBM, D>;
  using QTile = hopper::SmemTile<kBQ, D>;
  static constexpr int kK = 0;
  static constexpr int kV = kK + KTile::kBytes;
  static constexpr int kQ = kV + KTile::kBytes;
  static constexpr int kDo = kQ + kStages * QTile::kBytes;
  static constexpr int kLse = kDo + kStages * QTile::kBytes;  // fp32, log2
  static constexpr int kDelta = kLse + kStages * kBQ * 4;
  static constexpr int kBars = kDelta + kStages * kBQ * 4;
  // kv_full, then per stage full and empty; slack to align the tiles.
  static constexpr int kSmem = kBars + 8 * (1 + 2 * kStages) + 1024;
};

template <typename T, int D>
__global__ void __launch_bounds__(DkvShape<D>::Regs::kThreads, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap q_map,
                         const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map,
                         const __grid_constant__ CUtensorMap do_map,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, int bh_total, int tq, int tk,
                         float sm_scale, int causal) {
  using S = DkvShape<D>;
  using KTile = typename S::KTile;
  using QTile = typename S::QTile;
  constexpr int kBQ = S::kBQ;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t k_s = base + S::kK, v_s = base + S::kV;
  const uint32_t bars = base + S::kBars;
  const uint32_t kv_full = bars;
  auto q_tile = [&](int s) { return base + S::kQ + s * QTile::kBytes; };
  auto do_tile = [&](int s) { return base + S::kDo + s * QTile::kBytes; };
  auto lse_s = [&](int s) {
    return reinterpret_cast<float*>(smem + S::kLse) + s * kBQ;
  };
  auto delta_s = [&](int s) {
    return reinterpret_cast<float*>(smem + S::kDelta) + s * kBQ;
  };
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + kStages + s); };

  // Earliest keys see the most queries: schedule them first.
  int bh, tile;
  block_coords<S::kHeadGroup>(bh_total, (tk + S::kBM - 1) / S::kBM, bh,
                             tile);
  const int k0 = tile * S::kBM;
  const int offset = tk - tq;
  // First query tile with a row that sees key k0: i*BQ + BQ-1 + offset >= k0.
  int i0 = 0;
  if (causal) {
    const int lo = k0 - offset - (kBQ - 1);
    if (lo > 0) i0 = (lo + kBQ - 1) / kBQ;
  }
  const int n_q = (tq + kBQ - 1) / kBQ;

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(full(s), 32);  // every producer lane arrives
      hopper::mbar_init(empty(s), 2);  // one arrival per consumer
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer warpgroup: warp 0 copies lse and delta, lane 0 issues the
    // TMA loads.
    hopper::regs_dec<S::Regs::kProducer>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        hopper::mbar_arrive_expect_tx(kv_full, 2 * KTile::kBytes);
        hopper::tma_load_tile<S::kBM, D>(k_s, &k_map, kv_full, k0, bh);
        hopper::tma_load_tile<S::kBM, D>(v_s, &v_map, kv_full, k0, bh);
      }
      const float* lse_b = lse + (size_t)bh * tq;
      const float* delta_b = delta + (size_t)bh * tq;
      for (int it = i0; it < n_q; ++it) {
        const int u = it - i0, s = u % kStages;
        if (u >= kStages) hopper::mbar_wait(empty(s), (u / kStages - 1) & 1);
        const int qq0 = it * kBQ;
        if (lane == 0) {
          hopper::mbar_expect_tx(full(s), 2 * QTile::kBytes);
          hopper::tma_load_tile<kBQ, D>(q_tile(s), &q_map, full(s), qq0, bh);
          hopper::tma_load_tile<kBQ, D>(do_tile(s), &do_map, full(s), qq0,
                                        bh);
        }
        for (int r = lane; r < kBQ; r += 32) {
          const bool in = qq0 + r < tq;
          lse_s(s)[r] = in ? lse_b[qq0 + r] * kLog2e : 0.f;
          delta_s(s)[r] = in ? delta_b[qq0 + r] : 0.f;
        }
        hopper::mbar_arrive(full(s));  // after this lane's stores
      }
    }
  } else {
    // Consumer warpgroup c owns keys [k0 + 64c, k0 + 64c + 64); each warp
    // 16 of them, each thread rows g and g + 8 of its warp's.
    hopper::regs_inc<S::Regs::kConsumer>();
    const int c = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int key0 = k0 + 64 * c;
    const int kv_a = key0 + 16 * warp + g, kv_b = kv_a + 8;
    const float scale_log2 = sm_scale * kLog2e;

    float dka[D / 2], dva[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;

    hopper::mbar_wait(kv_full, 0);
    for (int it = i0; it < n_q; ++it) {
      const int u = it - i0, s = u % kStages;
      const int qq0 = it * kBQ;
      float st[kBQ / 2], dpt[kBQ / 2];
      hopper::mbar_wait(full(s), (u / kStages) & 1);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_ss<T, kBQ>(st, KTile::k_major(k_s, 64 * c, kk),
                                 QTile::k_major(q_tile(s), 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_ss<T, kBQ>(dpt, KTile::k_major(v_s, 64 * c, kk),
                                 QTile::k_major(do_tile(s), 0, kk), kk > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::reg_fence(st);
      hopper::reg_fence(dpt);

      const bool edge = qq0 + kBQ > tq || key0 + 64 > tk ||
                        (causal && qq0 + offset < key0 + 63);
      const float* lse_t = lse_s(s);
      const float* delta_t = delta_s(s);
#pragma unroll
      for (int i = 0; i < kBQ / 2; ++i) {
        const int local = 8 * (i >> 2) + 2 * t + (i & 1);
        float p = fast_exp2(st[i] * scale_log2 - lse_t[local]);
        if (edge) {
          const int qrow = qq0 + local;
          const int kv = (i & 2) ? kv_b : kv_a;
          if (!(qrow < tq && kv < tk && (!causal || qrow + offset >= kv)))
            p = 0.f;
        }
        st[i] = p;
        dpt[i] = p * (dpt[i] - delta_t[local]) * sm_scale;
      }
      // dv += p^T.do (p rounded to do's type, reference :263);
      // dk += ds^T.q (ds rounded to q's type, reference :268).
      uint32_t pa[kBQ / 16][4], dsa[kBQ / 16][4];
      pack_a<T, kBQ / 2>(pa, st);
      pack_a<T, kBQ / 2>(dsa, dpt);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk) {
        hopper::wgmma_rs<T, D>(dva, pa[kk], QTile::mn_major(do_tile(s), kk),
                               1);
        hopper::wgmma_rs<T, D>(dka, dsa[kk], QTile::mn_major(q_tile(s), kk),
                               1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::reg_fence(dva);
      hopper::reg_fence(dka);
      hopper::reg_fence(pa);
      hopper::reg_fence(dsa);
      if (tid == 0) hopper::mbar_arrive(empty(s));
    }
    store_acc<T, D>(dk + (size_t)bh * tk * D, dka, kv_a, tk, 1.f, 1.f);
    store_acc<T, D>(dv + (size_t)bh * tk * D, dva, kv_a, tk, 1.f, 1.f);
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------
// Raises a kernel's dynamic shared-memory limit on the current device,
// once per device: `done` is the launcher's own mask of devices so far.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem,
                    std::atomic<unsigned long long>& done) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = device < 64 ? 1ull << device : 0;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       void* lse, int bh, int tq, int tk, float sm_scale,
                       int causal, cudaStream_t stream) {
  using S = FwdShape<D>;
  CUtensorMap q_map, k_map, v_map;
  cudaError_t err = hopper::encode_map<T>(&q_map, q, bh, tq, D, S::kBM);
  if (err == cudaSuccess)
    err = hopper::encode_map<T>(&k_map, k, bh, tk, D, S::kBN);
  if (err == cudaSuccess)
    err = hopper::encode_map<T>(&v_map, v, bh, tk, D, S::kBN);
  if (err != cudaSuccess) return err;
  auto kernel = flash_fwd_kernel<T, D>;
  static std::atomic<unsigned long long> prepared{0};
  err = prepare(kernel, S::kSmem, prepared);
  if (err != cudaSuccess) return err;
  const int blocks = bh * ((tq + S::kBM - 1) / S::kBM);
  kernel<<<blocks, S::Regs::kThreads, S::kSmem, stream>>>(
      q_map, k_map, v_map, static_cast<T*>(o), static_cast<float*>(lse), bh,
      tq, tk, sm_scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int bh, int tq, int tk, float sm_scale,
                      int causal, cudaStream_t stream) {
  using S = DqShape<D>;
  CUtensorMap q_map, k_map, v_map, do_map;
  cudaError_t err = hopper::encode_map<T>(&q_map, q, bh, tq, D, S::kBM);
  if (err == cudaSuccess)
    err = hopper::encode_map<T>(&do_map, dout, bh, tq, D, S::kBM);
  if (err == cudaSuccess)
    err = hopper::encode_map<T>(&k_map, k, bh, tk, D, S::kBN);
  if (err == cudaSuccess)
    err = hopper::encode_map<T>(&v_map, v, bh, tk, D, S::kBN);
  if (err != cudaSuccess) return err;
  auto kernel = flash_bwd_dq_kernel<T, D>;
  static std::atomic<unsigned long long> prepared{0};
  err = prepare(kernel, S::kSmem, prepared);
  if (err != cudaSuccess) return err;
  const int blocks = bh * ((tq + S::kBM - 1) / S::kBM);
  kernel<<<blocks, S::Regs::kThreads, S::kSmem, stream>>>(
      q_map, k_map, v_map, do_map, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), bh, tq, tk,
      sm_scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int bh, int tq, int tk,
                       float sm_scale, int causal, cudaStream_t stream) {
  using S = DkvShape<D>;
  CUtensorMap q_map, k_map, v_map, do_map;
  cudaError_t err = hopper::encode_map<T>(&q_map, q, bh, tq, D, S::kBQ);
  if (err == cudaSuccess)
    err = hopper::encode_map<T>(&do_map, dout, bh, tq, D, S::kBQ);
  if (err == cudaSuccess)
    err = hopper::encode_map<T>(&k_map, k, bh, tk, D, S::kBM);
  if (err == cudaSuccess)
    err = hopper::encode_map<T>(&v_map, v, bh, tk, D, S::kBM);
  if (err != cudaSuccess) return err;
  auto kernel = flash_bwd_dkv_kernel<T, D>;
  static std::atomic<unsigned long long> prepared{0};
  err = prepare(kernel, S::kSmem, prepared);
  if (err != cudaSuccess) return err;
  const int blocks = bh * ((tk + S::kBM - 1) / S::kBM);
  kernel<<<blocks, S::Regs::kThreads, S::kSmem, stream>>>(
      q_map, k_map, v_map, do_map, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk),
      static_cast<T*>(dv), bh, tq, tk, sm_scale, causal);
  return cudaGetLastError();
}

// Calls `fn.template run<T, D>()` for the runtime (dtype, head dim).
template <typename Fn>
cudaError_t dispatch(int dtype, int d, const Fn& fn) {
  switch (dtype * 1000 + d) {
    case 16: return fn.template run<__nv_bfloat16, 16>();
    case 32: return fn.template run<__nv_bfloat16, 32>();
    case 64: return fn.template run<__nv_bfloat16, 64>();
    case 128: return fn.template run<__nv_bfloat16, 128>();
    case 1016: return fn.template run<__half, 16>();
    case 1032: return fn.template run<__half, 32>();
    case 1064: return fn.template run<__half, 64>();
    case 1128: return fn.template run<__half, 128>();
    default: return cudaErrorInvalidValue;
  }
}

struct FwdArgs {
  const void *q, *k, *v;
  void *o, *lse;
  int bh, tq, tk;
  float scale;
  int causal;
  cudaStream_t stream;
  template <typename T, int D>
  cudaError_t run() const {
    return launch_fwd<T, D>(q, k, v, o, lse, bh, tq, tk, scale, causal,
                            stream);
  }
};

struct DqArgs {
  const void *q, *k, *v, *dout, *lse, *delta;
  void* dq;
  int bh, tq, tk;
  float scale;
  int causal;
  cudaStream_t stream;
  template <typename T, int D>
  cudaError_t run() const {
    return launch_dq<T, D>(q, k, v, dout, lse, delta, dq, bh, tq, tk, scale,
                           causal, stream);
  }
};

struct DkvArgs {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *dk, *dv;
  int bh, tq, tk;
  float scale;
  int causal;
  cudaStream_t stream;
  template <typename T, int D>
  cudaError_t run() const {
    return launch_dkv<T, D>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk,
                            scale, causal, stream);
  }
};

}  // namespace

// dtype: 0 = bfloat16, 1 = float16.  d: 16, 32, 64 or 128.
extern "C" int hvd_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int bh, int tq, int tk,
                             int d, int dtype, float sm_scale, int causal,
                             void* stream) {
  const FwdArgs args{q,  k,  v,        o,      lse,
                     bh, tq, tk, sm_scale, causal,
                     static_cast<cudaStream_t>(stream)};
  return (int)dispatch(dtype, d, args);
}

extern "C" int hvd_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq, int bh, int tq,
                                int tk, int d, int dtype, float sm_scale,
                                int causal, void* stream) {
  const DqArgs args{q,  k,  v,  dout,     lse,    delta,
                    dq, bh, tq, tk,       sm_scale, causal,
                    static_cast<cudaStream_t>(stream)};
  return (int)dispatch(dtype, d, args);
}

extern "C" int hvd_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv,
                                 int bh, int tq, int tk, int d, int dtype,
                                 float sm_scale, int causal, void* stream) {
  const DkvArgs args{q,  k,  v,  dout, lse,      delta,  dk,
                     dv, bh, tq, tk,   sm_scale, causal,
                     static_cast<cudaStream_t>(stream)};
  return (int)dispatch(dtype, d, args);
}

extern "C" const char* hvd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

