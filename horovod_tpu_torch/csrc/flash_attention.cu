// FlashAttention-2 forward and backward for Hopper (sm_90a), CUDA C++.
//
// These three kernels replace the Pallas kernels of the JAX package:
//
//   flash_fwd_kernel     <- horovod_tpu/ops/flash_attention.py  _fwd_kernel
//   flash_bwd_dq_kernel  <- horovod_tpu/ops/flash_attention.py  _bwd_dq_kernel
//   flash_bwd_dkv_kernel <- horovod_tpu/ops/flash_attention.py  _bwd_dkv_kernel
//
// What bounds them on an H100: at the training shapes (T = 2048, D = 64)
// each kernel does O(T^2 * D) tensor-core work on O(T * D) bytes, so the
// least time is set by operations (989 TFLOP/s dense bf16), not by the
// 3.35 TB/s of device memory.  Their design therefore keeps the T x T
// score matrix out of device memory entirely and feeds every product to
// the tensor cores (mma.sync m16n8k16, bf16/fp16 inputs, fp32 sums).
//
// Design, and where it departs from the Pallas grid:
//   * The Pallas kernels carry their accumulators across a sequential grid
//     axis.  Blocks on Hopper run in no order, so that axis becomes a loop
//     inside the block: the KV loop for the forward and dq kernels, the Q
//     loop for the dk/dv kernel.
//   * Each block owns its outputs (the FlashAttention-2 split): forward and
//     dq blocks are one (batch*head, 64-row query tile), a dk/dv block is
//     one (batch*head, 64-row key tile).  No atomics, no second pass.
//   * A block is 4 warps; each warp owns 16 rows of the block's tile and
//     keeps their accumulators and softmax statistics in registers in the
//     mma.sync fragment layout, so the scores of one tile go from the
//     Q.K^T product straight into the P.V (or dS.K) product without a trip
//     through shared memory.  The dk/dv kernel computes the transposed
//     scores S^T = K.Q^T so that its accumulators are also warp-private.
//   * Causal blocks wholly above the diagonal are skipped, with the
//     bottom-right offset tk - tq of the reference.  Rows and columns past
//     the sequence end are masked, so any sequence length works.
//   * Rounding points follow the reference: p -> v's type before P.V,
//     ds -> k's type before dS.K, p -> do's type before P^T.dO, ds -> q's
//     type before dS^T.Q.  Softmax statistics stay fp32.
//   * Simple first: tiles are staged with plain 16-byte loads and one
//     barrier, not TMA; products use mma.sync, not wgmma.  Making these
//     kernels fast (TMA, wgmma, warp specialisation) is later work.
//
// Interface: plain C functions, loaded with ctypes.  Tensors are
// contiguous [BH, T, D]; lse and delta are [BH, tq] fp32.  Each entry
// returns cudaGetLastError() after its launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <atomic>

namespace {

constexpr float kNegInf = -1e30f;  // the reference's NEG_INF, not -inf
constexpr int kThreads = 128;      // 4 warps, 16 rows each
constexpr int kTile = 64;          // rows of a block's own tile

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
  static __device__ __forceinline__ void run(float c[4], const uint32_t a[4],
                                             const uint32_t b[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
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
  static __device__ __forceinline__ void run(float c[4], const uint32_t a[4],
                                             const uint32_t b[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

// Fragment layouts of mma.m16n8k16 (PTX ISA), with g = lane / 4 and
// t = lane % 4:
//   A 16x16 row-major: a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 2t+8..)
//                      a3 (g+8, 2t+8..)
//   B 16x8 (k x n):    b0 (k = 2t..2t+1, n = g)  b1 (k = 2t+8.., n = g)
//   C 16x8 fp32:       c0,c1 (g, 2t..2t+1)  c2,c3 (g+8, 2t..2t+1)
// Two C tiles side by side (n = 0..15) are, packed to 16 bits, exactly the
// A fragment of the next product, which is how P and dS stay in registers.

// A fragment from a row-major shared tile; `base` points at (row0, col0).
template <typename T>
__device__ __forceinline__ void load_a(uint32_t a[4], const T* base, int ld) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const T* p0 = base + g * ld + 2 * t;
  const T* p1 = p0 + 8 * ld;
  a[0] = *reinterpret_cast<const uint32_t*>(p0);
  a[1] = *reinterpret_cast<const uint32_t*>(p1);
  a[2] = *reinterpret_cast<const uint32_t*>(p0 + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p1 + 8);
}

// B fragment (k x n) from a shared tile stored [n][k]: B = M^T, so the two
// k-neighbours of a register are adjacent.  `base` points at (n0, k0).
template <typename T>
__device__ __forceinline__ void load_b_nk(uint32_t b[2], const T* base,
                                          int ld) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const T* p = base + g * ld + 2 * t;
  b[0] = *reinterpret_cast<const uint32_t*>(p);
  b[1] = *reinterpret_cast<const uint32_t*>(p + 8);
}

// B fragment (k x n) from a shared tile stored [k][n]; the k-neighbours
// are a row apart, so each register is packed from two 16-bit loads.
// `base` points at (k0, n0).
template <typename T>
__device__ __forceinline__ void load_b_kn(uint32_t b[2], const T* base,
                                          int ld) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const uint16_t* p = reinterpret_cast<const uint16_t*>(base) + g;
  const uint32_t x0 = p[(2 * t) * ld], x1 = p[(2 * t + 1) * ld];
  const uint32_t x2 = p[(2 * t + 8) * ld], x3 = p[(2 * t + 9) * ld];
  b[0] = x0 | (x1 << 16);
  b[1] = x2 | (x3 << 16);
}

// Copy rows [row0, row0 + ROWS) of a contiguous [n_rows, D] matrix into a
// shared tile [ROWS][LD], 16 bytes per thread and step; rows past the end
// are zero-filled.
template <typename T, int ROWS, int D, int LD>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int row0,
                                          int n_rows) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  for (int i = threadIdx.x; i < ROWS * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * kVec;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows)
      v = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = v;
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Store a warp's 16 x D fp32 accumulator rows (scaled per row) as T.
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* out, float acc[D / 8][4],
                                           int row_a, int n_rows,
                                           float scale_a, float scale_b) {
  const int t = (threadIdx.x & 31) & 3;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    const int col = nt * 8 + 2 * t;
    if (row_a < n_rows)
      *reinterpret_cast<uint32_t*>(out + (size_t)row_a * D + col) =
          Mma<T>::pack(acc[nt][0] * scale_a, acc[nt][1] * scale_a);
    if (row_a + 8 < n_rows)
      *reinterpret_cast<uint32_t*>(out + (size_t)(row_a + 8) * D + col) =
          Mma<T>::pack(acc[nt][2] * scale_b, acc[nt][3] * scale_b);
  }
}

// Number of 64-wide key tiles a causal query tile starting at q0 needs.
__device__ __forceinline__ int kv_tiles(int q0, int tq, int tk, int causal) {
  int n = (tk + kTile - 1) / kTile;
  if (causal) n = min(n, (q0 + kTile - 1 + (tk - tq)) / kTile + 1);
  return n;
}

// ---------------------------------------------------------------------------
// Forward: o = softmax(q.k^T * scale) . v, lse = log-sum-exp of each row.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int tq, int tk, float sm_scale,
                     int causal) {
  constexpr int LD = D + 8;  // padded rows: conflict-free fragment loads
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* ks = qs + kTile * LD;
  T* vs = ks + kTile * LD;

  const int bh = blockIdx.x;
  // Heaviest causal tiles (late queries) are scheduled first.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int offset = tk - tq;
  const T* kb = k + (size_t)bh * tk * D;
  const T* vb = v + (size_t)bh * tk * D;
  const T* qw = qs + warp * 16 * LD;

  load_tile<T, kTile, D, LD>(qs, q + (size_t)bh * tq * D, q0, tq);

  const int row_a = q0 + warp * 16 + g, row_b = row_a + 8;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

  const int n_kv = kv_tiles(q0, tq, tk, causal);
  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * kTile;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, kTile, D, LD>(ks, kb, k0, tk);
    load_tile<T, kTile, D, LD>(vs, vb, k0, tk);
    __syncthreads();

    float s[kTile / 8][4];
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt)
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      load_a(a, qw + kk * 16, LD);
#pragma unroll
      for (int nt = 0; nt < kTile / 8; ++nt) {
        uint32_t b[2];
        load_b_nk(b, ks + nt * 8 * LD + kk * 16, LD);
        Mma<T>::run(s[nt], a, b);
      }
    }

    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = k0 + nt * 8 + 2 * t + (i & 1);
        const int row = (i < 2) ? row_a : row_b;
        const bool ok = col < tk && (!causal || row + offset >= col);
        const float x = ok ? s[nt][i] * sm_scale : kNegInf;
        s[nt][i] = x;
        mx[i >> 1] = fmaxf(mx[i >> 1], x);
      }
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      alpha[r] = __expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = __expf(s[nt][i] - m[i >> 1]);
        s[nt][i] = p;
        rs[i >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(rs[r]);
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      acc[nt][0] *= alpha[0];
      acc[nt][1] *= alpha[0];
      acc[nt][2] *= alpha[1];
      acc[nt][3] *= alpha[1];
    }
    // acc += p.v, with p rounded to v's type (reference :116).
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      const uint32_t a[4] = {Mma<T>::pack(s[2 * kk][0], s[2 * kk][1]),
                             Mma<T>::pack(s[2 * kk][2], s[2 * kk][3]),
                             Mma<T>::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             Mma<T>::pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        uint32_t b[2];
        load_b_kn(b, vs + kk * 16 * LD + nt * 8, LD);
        Mma<T>::run(acc[nt], a, b);
      }
    }
  }

  // Rows with no weight give o = 0 and lse = NEG_INF (reference :118-128).
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l_safe = l[r] == 0.f ? 1.f : l[r];
    inv[r] = 1.f / l_safe;
    const int row = r == 0 ? row_a : row_b;
    if (t == 0 && row < tq)
      lse[(size_t)bh * tq + row] =
          l[r] == 0.f ? kNegInf : m[r] + logf(l_safe);
  }
  store_rows<T, D>(o + (size_t)bh * tq * D, acc, row_a, tq, inv[0], inv[1]);
}

// ---------------------------------------------------------------------------
// Backward, dq: p = exp(s - lse), ds = p * (do.v^T - delta) * scale,
// dq = ds.k.  One block per (bh, 64-row query tile), loop over keys.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int tq, int tk, float sm_scale, int causal) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* dos = qs + kTile * LD;
  T* ks = dos + kTile * LD;
  T* vs = ks + kTile * LD;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int offset = tk - tq;
  const T* kb = k + (size_t)bh * tk * D;
  const T* vb = v + (size_t)bh * tk * D;
  const T* qw = qs + warp * 16 * LD;
  const T* dow = dos + warp * 16 * LD;

  load_tile<T, kTile, D, LD>(qs, q + (size_t)bh * tq * D, q0, tq);
  load_tile<T, kTile, D, LD>(dos, dout + (size_t)bh * tq * D, q0, tq);

  const int row_a = q0 + warp * 16 + g, row_b = row_a + 8;
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r == 0 ? row_a : row_b;
    row_lse[r] = row < tq ? lse[(size_t)bh * tq + row] : 0.f;
    row_delta[r] = row < tq ? delta[(size_t)bh * tq + row] : 0.f;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

  const int n_kv = kv_tiles(q0, tq, tk, causal);
  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * kTile;
    __syncthreads();
    load_tile<T, kTile, D, LD>(ks, kb, k0, tk);
    load_tile<T, kTile, D, LD>(vs, vb, k0, tk);
    __syncthreads();

    float s[kTile / 8][4], dp[kTile / 8][4];
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = dp[nt][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t aq[4], ado[4];
      load_a(aq, qw + kk * 16, LD);
      load_a(ado, dow + kk * 16, LD);
#pragma unroll
      for (int nt = 0; nt < kTile / 8; ++nt) {
        uint32_t b[2];
        load_b_nk(b, ks + nt * 8 * LD + kk * 16, LD);
        Mma<T>::run(s[nt], aq, b);
        load_b_nk(b, vs + nt * 8 * LD + kk * 16, LD);
        Mma<T>::run(dp[nt], ado, b);
      }
    }
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = k0 + nt * 8 + 2 * t + (i & 1);
        const int row = (i < 2) ? row_a : row_b;
        const bool ok =
            row < tq && col < tk && (!causal || row + offset >= col);
        const float p =
            ok ? __expf(s[nt][i] * sm_scale - row_lse[i >> 1]) : 0.f;
        s[nt][i] = p * (dp[nt][i] - row_delta[i >> 1]) * sm_scale;
      }
    }
    // dq += ds.k, with ds rounded to k's type (reference :217).
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      const uint32_t a[4] = {Mma<T>::pack(s[2 * kk][0], s[2 * kk][1]),
                             Mma<T>::pack(s[2 * kk][2], s[2 * kk][3]),
                             Mma<T>::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             Mma<T>::pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        uint32_t b[2];
        load_b_kn(b, ks + kk * 16 * LD + nt * 8, LD);
        Mma<T>::run(acc[nt], a, b);
      }
    }
  }
  store_rows<T, D>(dq + (size_t)bh * tq * D, acc, row_a, tq, 1.f, 1.f);
}

// ---------------------------------------------------------------------------
// Backward, dk and dv: one block per (bh, 64-row key tile), loop over the
// query tiles that can see it.  Works on S^T = k.q^T so each warp's 16 key
// rows own their dk and dv rows:  dv += p^T.do,  dk += ds^T.q.
// ---------------------------------------------------------------------------
template <typename T, int D, int BQ>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, int tq, int tk, float sm_scale,
                         int causal) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);
  T* vs = ks + kTile * LD;
  T* qs = vs + kTile * LD;
  T* dos = qs + BQ * LD;
  float* lse_s = reinterpret_cast<float*>(dos + BQ * LD);
  float* delta_s = lse_s + BQ;

  const int bh = blockIdx.x;
  // Earliest keys see the most queries: schedule them first.
  const int k0 = blockIdx.y * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int offset = tk - tq;
  const T* qb = q + (size_t)bh * tq * D;
  const T* dob = dout + (size_t)bh * tq * D;
  const float* lseb = lse + (size_t)bh * tq;
  const float* deltab = delta + (size_t)bh * tq;
  const T* kw = ks + warp * 16 * LD;
  const T* vw = vs + warp * 16 * LD;

  load_tile<T, kTile, D, LD>(ks, k + (size_t)bh * tk * D, k0, tk);
  load_tile<T, kTile, D, LD>(vs, v + (size_t)bh * tk * D, k0, tk);

  const int kv_a = k0 + warp * 16 + g, kv_b = kv_a + 8;
  // First query tile with a row that sees key k0: i*BQ + BQ-1 + offset >= k0.
  int i0 = 0;
  if (causal) {
    const int lo = k0 - offset - (BQ - 1);
    if (lo > 0) i0 = (lo + BQ - 1) / BQ;
  }
  const int n_q = (tq + BQ - 1) / BQ;

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) dka[nt][i] = dva[nt][i] = 0.f;

  for (int it = i0; it < n_q; ++it) {
    const int qq0 = it * BQ;
    __syncthreads();
    load_tile<T, BQ, D, LD>(qs, qb, qq0, tq);
    load_tile<T, BQ, D, LD>(dos, dob, qq0, tq);
    for (int r = threadIdx.x; r < BQ; r += kThreads) {
      lse_s[r] = qq0 + r < tq ? lseb[qq0 + r] : 0.f;
      delta_s[r] = qq0 + r < tq ? deltab[qq0 + r] : 0.f;
    }
    __syncthreads();

    float st[BQ / 8][4], dpt[BQ / 8][4];
#pragma unroll
    for (int nt = 0; nt < BQ / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) st[nt][i] = dpt[nt][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ak[4], av[4];
      load_a(ak, kw + kk * 16, LD);
      load_a(av, vw + kk * 16, LD);
#pragma unroll
      for (int nt = 0; nt < BQ / 8; ++nt) {
        uint32_t b[2];
        load_b_nk(b, qs + nt * 8 * LD + kk * 16, LD);
        Mma<T>::run(st[nt], ak, b);
        load_b_nk(b, dos + nt * 8 * LD + kk * 16, LD);
        Mma<T>::run(dpt[nt], av, b);
      }
    }
#pragma unroll
    for (int nt = 0; nt < BQ / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int local = nt * 8 + 2 * t + (i & 1);
        const int qrow = qq0 + local;
        const int kv = (i < 2) ? kv_a : kv_b;
        const bool ok =
            qrow < tq && kv < tk && (!causal || qrow + offset >= kv);
        const float p =
            ok ? __expf(st[nt][i] * sm_scale - lse_s[local]) : 0.f;
        st[nt][i] = p;
        dpt[nt][i] = p * (dpt[nt][i] - delta_s[local]) * sm_scale;
      }
    }
    // dv += p^T.do (p rounded to do's type, reference :263);
    // dk += ds^T.q (ds rounded to q's type, reference :268).
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      const uint32_t ap[4] = {
          Mma<T>::pack(st[2 * kk][0], st[2 * kk][1]),
          Mma<T>::pack(st[2 * kk][2], st[2 * kk][3]),
          Mma<T>::pack(st[2 * kk + 1][0], st[2 * kk + 1][1]),
          Mma<T>::pack(st[2 * kk + 1][2], st[2 * kk + 1][3])};
      const uint32_t ads[4] = {
          Mma<T>::pack(dpt[2 * kk][0], dpt[2 * kk][1]),
          Mma<T>::pack(dpt[2 * kk][2], dpt[2 * kk][3]),
          Mma<T>::pack(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]),
          Mma<T>::pack(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3])};
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        uint32_t b[2];
        load_b_kn(b, dos + kk * 16 * LD + nt * 8, LD);
        Mma<T>::run(dva[nt], ap, b);
        load_b_kn(b, qs + kk * 16 * LD + nt * 8, LD);
        Mma<T>::run(dka[nt], ads, b);
      }
    }
  }
  store_rows<T, D>(dk + (size_t)bh * tk * D, dka, kv_a, tk, 1.f, 1.f);
  store_rows<T, D>(dv + (size_t)bh * tk * D, dva, kv_a, tk, 1.f, 1.f);
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
  constexpr size_t smem = 3 * kTile * (D + 8) * sizeof(T);
  auto kernel = flash_fwd_kernel<T, D>;
  static std::atomic<unsigned long long> prepared{0};
  cudaError_t err = prepare(kernel, smem, prepared);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (tq + kTile - 1) / kTile);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      tq, tk, sm_scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int bh, int tq, int tk, float sm_scale,
                      int causal, cudaStream_t stream) {
  constexpr size_t smem = 4 * kTile * (D + 8) * sizeof(T);
  auto kernel = flash_bwd_dq_kernel<T, D>;
  static std::atomic<unsigned long long> prepared{0};
  cudaError_t err = prepare(kernel, smem, prepared);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (tq + kTile - 1) / kTile);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), tq, tk, sm_scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int bh, int tq, int tk,
                       float sm_scale, int causal, cudaStream_t stream) {
  // A narrower query tile at D = 128 keeps dk and dv in registers.
  constexpr int BQ = D > 64 ? 32 : 64;
  constexpr size_t smem =
      (2 * kTile + 2 * BQ) * (D + 8) * sizeof(T) + 2 * BQ * sizeof(float);
  auto kernel = flash_bwd_dkv_kernel<T, D, BQ>;
  static std::atomic<unsigned long long> prepared{0};
  cudaError_t err = prepare(kernel, smem, prepared);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (tk + kTile - 1) / kTile);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), tq, tk, sm_scale, causal);
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
