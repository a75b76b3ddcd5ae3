// Flash attention for Hopper (sm_90a), plain C interface: the forward, dQ and
// dK/dV kernels.
//
// Replaces the three Pallas TPU kernels of detectmateservice_tpu/ops/flash.py:
//   forward <- `_flash_kernel` (reached through `_flash_forward`)
//   dQ      <- `_dq_kernel`    (reached through `_flash_bwd`)
//   dK/dV   <- `_dkv_kernel`   (reached through `_flash_bwd`)
//
// For q [B, H, S, D], k and v [B, H, T, D] (unit stride along D, any strides
// along B, H and the sequence), an additive key bias [B, T] (0 or -1e30 for
// PAD keys; none = 0) and scale = D^-1/2:
//
//   s    = q k^T * scale + bias                      (fp32)
//   out  = softmax(s) v,  lse = logsumexp(s)         (forward)
//   p    = exp(s - lse),  ds = p * (dO v^T - delta)  (backward, delta given)
//   dQ   = ds k * scale,  dV = p^T dO,  dK = ds^T q * scale
//
// The [S, T] score matrix never reaches device memory in either direction.
// Rounding follows the TPU kernels: p is rounded to v's type before p v, ds
// to k's type in dQ, p to dO's type and ds to q's type in dK/dV (every operand
// has the one type T here); products and sums are fp32.
//
// Variants, chosen by dtype (`dm_flash_variant` names them):
//   16-bit forward, dQ and dK/dV -> wgmma kernels fed by TMA (below);
//   fp32 forward, dQ and dK/dV   -> CUDA-core kernels, fp32 products.
// A 16-bit launch the wgmma kernels refuse (an operand whose base or stride
// is not a multiple of 16 bytes) fails; it never falls back.
//
// What bounds them: 4 (forward), 6 (dQ) and 8 (dK/dV) * B*H*S*T*D operations
// on O((S + T) * D) bytes per head, far above the card's operations-per-byte
// line, so the bound is arithmetic: the bf16 tensor-core peak for 16-bit
// operands. At D = 64 the forward also takes one exp per score against 256
// tensor-core operations (dQ: 384), and the SM's exp unit (16 a clock)
// needs about as long as the tensor cores (dQ: two thirds); with two or
// three warps of softmax a scheduler, latency rather than either unit is
// what the forward waits on (PERF.md).
//
// Design of the wgmma kernels. A CTA holds consumer warpgroups of 64 rows
// each and one producer warpgroup; `setmaxnreg` moves the producer's
// registers to the consumers. One producer warp starts the TMA loads
// (rank-4 tensor maps built from the caller's strides, 128-byte swizzle,
// zero fill past the sequence and past D) into a ring of stages guarded by
// full/empty mbarriers, and writes the per-key bias (forward, dQ) or the
// per-query lse and delta (dK/dV) beside each stage. Tiles stay in their
// 16-bit type in shared memory; every product is a wgmma with fp32
// accumulators in registers (helpers in hopper.cuh):
//   forward: CTA per (batch*head, 192 query rows at D = 64, 128 at D = 128),
//            three-stage ring of 128-key K and V tiles. Per stage, S = Q K^T
//            (both operands in shared memory) is started together with
//            O += P V of the stage before (P as the register A operand, V
//            as an MN-major B); the online softmax of S (row max and sum by
//            quad shuffles, p rounded to T in registers) runs while P V is
//            on the tensor cores, and O is rescaled once P V is done.
//   dQ:      CTA per (batch*head, 128 query rows), two consumer warpgroups;
//            Q and dO load once, K and V stream through a four-stage ring
//            of 64-key tiles. Per stage, S = Q K^T and dP = dO V^T (SS),
//            then p and ds in fp32 registers from the rows' lse and delta
//            (held in registers), then dQ += dS K (dS as the register A
//            operand, K read again as an MN-major B). dQ stays in registers
//            over the whole key loop and is written once. Starting the next
//            stage's S and dP with dS K, as the forward does with P V,
//            measured slower (PERF.md).
//   dK/dV:   CTA per (batch*head, 128 key rows), two consumer warpgroups;
//            K and V load once; per stage of 64 (D = 64) or 32 (D = 128)
//            query rows, S^T = K Q^T and dP^T = V dO^T, then P^T and dS^T in
//            fp32 registers and dV += P^T dO, dK += dS^T Q with A from
//            registers and dO, Q read again as MN-major B operands. dK and dV
//            stay in registers over the whole query loop and are written
//            once: no atomics, no second pass.
// The consumer warpgroups share each stage, so one's softmax also overlaps
// another's products, and the producer keeps the next loads in flight.

// CUDA-core kernels (fp32). One CTA owns one (batch*head, 64-row tile) and
// loops over the other sequence itself, so no state crosses CTAs:
//   forward: CTA per query tile; loops over key tiles with (m, l) per row and
//            the [64, D] accumulator in registers (online softmax);
//   dQ:      CTA per query tile; loops over key tiles, recomputing p from lse;
//   dK/dV:   CTA per key tile; loops over query tiles, recomputing p from lse.
// dQ and dK/dV are split as in the JAX package, so neither needs atomics or a
// second pass. Each tile is staged in shared memory; each of the 256
// threads computes a 4 x 4 block of the 64 x 64 score tile and a
// 4 x (D/16) block of the [64, D] products.
//
// Ragged tails, in every variant: key rows t >= T get s = -inf (p = 0, so a
// fully masked row averages v over its T real keys only), query rows s >= S
// are zero-filled and never written.

#include "hopper.cuh"

#include <math.h>

namespace {

constexpr int kBlockM = 64;   // query rows per tile
constexpr int kBlockN = 64;   // key rows per tile
constexpr int kThreads = 256; // 16 x 16 threads
constexpr int kTileLd = 65;   // padded stride of a 64 x 64 score tile
constexpr float kNegBig = -1e30f;
constexpr int kMaxDim = 128;

// x rounded to T and widened back: the cast the TPU kernels make before a
// product
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  // element strides along (batch, head, sequence); D has unit stride
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long do_sb, do_sh, do_ss;
  const float* bias;   // [B, T] additive key bias, or nullptr
  const float* lse;    // [B*H, S] (backward)
  const float* delta;  // [B*H, S] (backward)
  void* out;           // [B*H, S, D] (forward)
  float* lse_out;      // [B*H, S] or nullptr (forward)
  void* dq;            // [B*H, S, D]
  void* dk;            // [B*H, T, D]
  void* dv;            // [B*H, T, D]
  int b, h, s, t, d;
  int n_qtiles, n_ktiles;
  float scale;
};

// Stage rows [row0, row0 + 64) of one head's [rows, d] matrix into dst as
// fp32 with stride kD + 4; rows past `rows` and columns past d are 0.
template <int kD, typename T>
__device__ __forceinline__ void stage_tile(const T* __restrict__ base,
                                           long long row_stride,
                                           float* __restrict__ dst, int row0,
                                           int rows, int d) {
  constexpr int ld = kD + 4;
  for (int idx = threadIdx.x; idx < 64 * kD; idx += kThreads) {
    const int r = idx / kD;
    const int c = idx % kD;
    const int row = row0 + r;
    dst[r * ld + c] = (row < rows && c < d)
                          ? to_float(base[(long long)row * row_stride + c])
                          : 0.f;
  }
}

// acc[i][j] = A[ty + 16 i] . B[tx + 16 j] over kD columns (A, B: [64][kD+4])
template <int kD>
__device__ __forceinline__ void mm_abt(const float* __restrict__ a_s,
                                       const float* __restrict__ b_s,
                                       float acc[4][4], int ty, int tx) {
  constexpr int ld = kD + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int k = 0; k < kD; k += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(&a_s[(ty + 16 * i) * ld + k]);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(&b_s[(tx + 16 * j) * ld + k]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
      }
  }
}

// acc[i][j] += sum_r P[ty + 16 i][r] * M[r][tx + 16 j] over the tile's 64
// rows r (P: [64][kTileLd], M: [64][kD+4])
template <int kD>
__device__ __forceinline__ void mm_ab_acc(const float* __restrict__ p_s,
                                          const float* __restrict__ m_s,
                                          float acc[4][kD / 16], int ty,
                                          int tx) {
  constexpr int ld = kD + 4;
#pragma unroll 8
  for (int r = 0; r < 64; ++r) {
    float pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[i] = p_s[(ty + 16 * i) * kTileLd + r];
#pragma unroll
    for (int j = 0; j < kD / 16; ++j) {
      const float m = m_s[r * ld + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], m, acc[i][j]);
    }
  }
}

// bias of key rows [key0, key0 + 64): the caller's additive bias, -inf past T
__device__ __forceinline__ void stage_bias(const Params& p, int bi, int key0,
                                           float* b_s) {
  if (threadIdx.x < kBlockN) {
    const int j = key0 + threadIdx.x;
    b_s[threadIdx.x] =
        j < p.t ? (p.bias ? p.bias[(long long)bi * p.t + j] : 0.f) : -INFINITY;
  }
}

// lse and delta of query rows [row0, row0 + 64); 0 past S
__device__ __forceinline__ void stage_rows(const Params& p, int bh, int row0,
                                           float* lse_s, float* delta_s) {
  if (threadIdx.x < kBlockM) {
    const int i = row0 + threadIdx.x;
    const bool ok = i < p.s;
    lse_s[threadIdx.x] = ok ? p.lse[(long long)bh * p.s + i] : 0.f;
    delta_s[threadIdx.x] = ok ? p.delta[(long long)bh * p.s + i] : 0.f;
  }
}

template <int kD, typename T>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int ld = kD + 4;
  constexpr int kCols = kD / 16;
  float* q_s = smem;                       // [64][ld]
  float* k_s = q_s + kBlockM * ld;         // [64][ld]
  float* v_s = k_s + kBlockN * ld;         // [64][ld]
  float* s_s = v_s + kBlockN * ld;         // [64][kTileLd]
  float* b_s = s_s + kBlockM * kTileLd;    // [64] key bias
  float* row_s = b_s + kBlockN;            // [64] per-row correction, then l

  const int tid = threadIdx.x;
  const int qtile = blockIdx.x % p.n_qtiles;
  const int bh = blockIdx.x / p.n_qtiles;
  const int bi = bh / p.h;
  const int hi = bh % p.h;
  const int row0 = qtile * kBlockM;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int red_row = tid / 4;  // softmax: four adjacent lanes per row
  const int red_part = tid % 4;

  const T* qb = static_cast<const T*>(p.q) + bi * p.q_sb + hi * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + bi * p.k_sb + hi * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + bi * p.v_sb + hi * p.v_sh;
  stage_tile<kD>(qb, p.q_ss, q_s, row0, p.s, p.d);

  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  float m_run = kNegBig;  // the TPU kernel's initial running max
  float l_run = 0.f;

  for (int key0 = 0; key0 < p.t; key0 += kBlockN) {
    stage_tile<kD>(kb, p.k_ss, k_s, key0, p.t, p.d);
    stage_tile<kD>(vb, p.v_ss, v_s, key0, p.t, p.d);
    stage_bias(p, bi, key0, b_s);
    __syncthreads();

    float sc[4][4];
    mm_abt<kD>(q_s, k_s, sc, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        s_s[(ty + 16 * i) * kTileLd + tx + 16 * j] =
            sc[i][j] * p.scale + b_s[tx + 16 * j];
    __syncthreads();

    float* srow = s_s + red_row * kTileLd;
    float tmax = -INFINITY;
    for (int j = red_part; j < kBlockN; j += 4) tmax = fmaxf(tmax, srow[j]);
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m_run, tmax);
    const float corr = expf(m_run - m_new);
    float tsum = 0.f;
    for (int j = red_part; j < kBlockN; j += 4) {
      const float e = expf(srow[j] - m_new);  // 0 for keys past T
      tsum += e;
      srow[j] = round_to<T>(e);  // p in v's type for the p v product
    }
    tsum += __shfl_xor_sync(0xffffffffu, tsum, 1);
    tsum += __shfl_xor_sync(0xffffffffu, tsum, 2);
    l_run = l_run * corr + tsum;
    m_run = m_new;
    if (red_part == 0) row_s[red_row] = corr;
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float c = row_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= c;
    }
    mm_ab_acc<kD>(s_s, v_s, acc, ty, tx);
    __syncthreads();  // k_s, v_s, s_s and row_s are rewritten next
  }

  const float l_safe = fmaxf(l_run, 1e-30f);
  if (red_part == 0) {
    row_s[red_row] = l_safe;
    const int row = row0 + red_row;
    if (p.lse_out != nullptr && row < p.s)
      p.lse_out[(long long)bh * p.s + row] = m_run + logf(l_safe);
  }
  __syncthreads();
  T* ob = static_cast<T*>(p.out) + (long long)bh * p.s * p.d;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= p.s) continue;
    const float l = row_s[ty + 16 * i];
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int col = tx + 16 * j;
      if (col < p.d)
        ob[(long long)row * p.d + col] = from_float<T>(acc[i][j] / l);
    }
  }
}

template <int kD, typename T>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int ld = kD + 4;
  constexpr int kCols = kD / 16;
  float* q_s = smem;                       // [64][ld]
  float* do_s = q_s + kBlockM * ld;        // [64][ld]
  float* k_s = do_s + kBlockM * ld;        // [64][ld]
  float* v_s = k_s + kBlockN * ld;         // [64][ld]
  float* ds_s = v_s + kBlockN * ld;        // [64][kTileLd]
  float* b_s = ds_s + kBlockM * kTileLd;   // [64]
  float* lse_s = b_s + kBlockN;            // [64]
  float* delta_s = lse_s + kBlockM;        // [64]

  const int tid = threadIdx.x;
  const int qtile = blockIdx.x % p.n_qtiles;
  const int bh = blockIdx.x / p.n_qtiles;
  const int bi = bh / p.h;
  const int hi = bh % p.h;
  const int row0 = qtile * kBlockM;
  const int ty = tid / 16;
  const int tx = tid % 16;

  const T* qb = static_cast<const T*>(p.q) + bi * p.q_sb + hi * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + bi * p.k_sb + hi * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + bi * p.v_sb + hi * p.v_sh;
  const T* dob = static_cast<const T*>(p.dout) + bi * p.do_sb + hi * p.do_sh;
  stage_tile<kD>(qb, p.q_ss, q_s, row0, p.s, p.d);
  stage_tile<kD>(dob, p.do_ss, do_s, row0, p.s, p.d);
  stage_rows(p, bh, row0, lse_s, delta_s);

  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;

  for (int key0 = 0; key0 < p.t; key0 += kBlockN) {
    stage_tile<kD>(kb, p.k_ss, k_s, key0, p.t, p.d);
    stage_tile<kD>(vb, p.v_ss, v_s, key0, p.t, p.d);
    stage_bias(p, bi, key0, b_s);
    __syncthreads();

    float sc[4][4], dp[4][4];
    mm_abt<kD>(q_s, k_s, sc, ty, tx);
    mm_abt<kD>(do_s, v_s, dp, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float pr = expf(sc[i][j] * p.scale + b_s[c] - lse_s[r]);
        const float ds = key0 + c < p.t ? pr * (dp[i][j] - delta_s[r]) : 0.f;
        ds_s[r * kTileLd + c] = round_to<T>(ds);  // ds in k's type
      }
    }
    __syncthreads();
    mm_ab_acc<kD>(ds_s, k_s, acc, ty, tx);
    __syncthreads();  // k_s, v_s, ds_s and b_s are rewritten next
  }

  T* dqb = static_cast<T*>(p.dq) + (long long)bh * p.s * p.d;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= p.s) continue;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int col = tx + 16 * j;
      if (col < p.d)
        dqb[(long long)row * p.d + col] = from_float<T>(acc[i][j] * p.scale);
    }
  }
}

template <int kD, typename T>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int ld = kD + 4;
  constexpr int kCols = kD / 16;
  float* k_s = smem;                       // [64][ld]
  float* v_s = k_s + kBlockN * ld;         // [64][ld]
  float* q_s = v_s + kBlockN * ld;         // [64][ld]
  float* do_s = q_s + kBlockM * ld;        // [64][ld]
  float* pt_s = do_s + kBlockM * ld;       // [64 keys][kTileLd]
  float* dst_s = pt_s + kBlockN * kTileLd; // [64 keys][kTileLd]
  float* b_s = dst_s + kBlockN * kTileLd;  // [64]
  float* lse_s = b_s + kBlockN;            // [64]
  float* delta_s = lse_s + kBlockM;        // [64]

  const int tid = threadIdx.x;
  const int ktile = blockIdx.x % p.n_ktiles;
  const int bh = blockIdx.x / p.n_ktiles;
  const int bi = bh / p.h;
  const int hi = bh % p.h;
  const int key0 = ktile * kBlockN;
  const int ty = tid / 16;  // key rows ty + 16 a
  const int tx = tid % 16;  // query columns tx + 16 b

  const T* qb = static_cast<const T*>(p.q) + bi * p.q_sb + hi * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + bi * p.k_sb + hi * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + bi * p.v_sb + hi * p.v_sh;
  const T* dob = static_cast<const T*>(p.dout) + bi * p.do_sb + hi * p.do_sh;
  stage_tile<kD>(kb, p.k_ss, k_s, key0, p.t, p.d);
  stage_tile<kD>(vb, p.v_ss, v_s, key0, p.t, p.d);
  stage_bias(p, bi, key0, b_s);

  float dk[4][kCols], dv[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      dk[i][j] = 0.f;
      dv[i][j] = 0.f;
    }

  for (int row0 = 0; row0 < p.s; row0 += kBlockM) {
    stage_tile<kD>(qb, p.q_ss, q_s, row0, p.s, p.d);
    stage_tile<kD>(dob, p.do_ss, do_s, row0, p.s, p.d);
    stage_rows(p, bh, row0, lse_s, delta_s);
    __syncthreads();

    float st[4][4], dpt[4][4];
    mm_abt<kD>(k_s, q_s, st, ty, tx);    // st[a][b] = k_j . q_i
    mm_abt<kD>(v_s, do_s, dpt, ty, tx);  // dpt[a][b] = v_j . dO_i
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int j = ty + 16 * a;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int i = tx + 16 * b;
        const bool valid = key0 + j < p.t && row0 + i < p.s;
        const float pr = expf(st[a][b] * p.scale + b_s[j] - lse_s[i]);
        const float ds = pr * (dpt[a][b] - delta_s[i]);
        pt_s[j * kTileLd + i] = valid ? round_to<T>(pr) : 0.f;   // dO's type
        dst_s[j * kTileLd + i] = valid ? round_to<T>(ds) : 0.f;  // q's type
      }
    }
    __syncthreads();
    mm_ab_acc<kD>(pt_s, do_s, dv, ty, tx);
    mm_ab_acc<kD>(dst_s, q_s, dk, ty, tx);
    __syncthreads();  // q_s, do_s, pt_s, dst_s and the rows are rewritten next
  }

  T* dkb = static_cast<T*>(p.dk) + (long long)bh * p.t * p.d;
  T* dvb = static_cast<T*>(p.dv) + (long long)bh * p.t * p.d;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = key0 + ty + 16 * a;
    if (row >= p.t) continue;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int col = tx + 16 * j;
      if (col < p.d) {
        dkb[(long long)row * p.d + col] = from_float<T>(dk[a][j] * p.scale);
        dvb[(long long)row * p.d + col] = from_float<T>(dv[a][j]);
      }
    }
  }
}

// -- 16-bit forward and dK/dV: wgmma on tiles staged by TMA ------------------

constexpr int kFwdKeys = 128;  // keys per forward stage
constexpr int kDkvKeys = 128;  // key rows per dK/dV CTA
constexpr int kDqKeys = 64;    // keys per dQ stage

// The forward's roles: at D = 64 three consumer warpgroups (192 query rows)
// at 160 registers; at D = 128 two at 232, for the wider accumulators.
template <int kD>
using FwdRoles = WarpRoles<kD == 64 ? 3 : 2, kD == 64 ? 24 : 40, kD == 64 ? 160 : 232>;

// Shared memory of the forward. Each tile is [rows][64] 16-bit values per
// 64-column chunk of D, as TMA writes it with the 128-byte swizzle; every
// tile starts on a 1024-byte boundary (the swizzle's period).
template <int kD>
struct FwdSmem : FwdRoles<kD> {
  static constexpr int kChunks = kD / kAtom;
  static constexpr int kRows = 64 * FwdRoles<kD>::kConsumers;  // query rows a CTA
  // three stages: a stage is free only once P V of the stage before the
  // current one is done, and two left the next load's latency exposed;
  // at D = 128 the three take 231,424 bytes, within one CTA's 232,448
  static constexpr int kStages = 3;
  alignas(1024) uint16_t q[kChunks][kRows * kAtom];
  alignas(1024) uint16_t k[kStages][kChunks][kFwdKeys * kAtom];
  alignas(1024) uint16_t v[kStages][kChunks][kFwdKeys * kAtom];
  float bias[kStages][kFwdKeys];  // the caller's bias; -inf past T
  uint64_t q_full, full[kStages], empty[kStages];
};

template <int kD>
struct DkvSmem : WarpRoles<2, 40, 232> {
  static constexpr int kChunks = kD / kAtom;
  static constexpr int kStages = 2;
  // query rows per stage: 32 at D = 128 keeps dK, dV (2 x 64 registers)
  // and the two [64, 32] score tiles within the register file
  static constexpr int kRows = kD == 64 ? 64 : 32;
  alignas(1024) uint16_t k[kChunks][kDkvKeys * kAtom];
  alignas(1024) uint16_t v[kChunks][kDkvKeys * kAtom];
  alignas(1024) uint16_t q[kStages][kChunks][kRows * kAtom];
  alignas(1024) uint16_t dout[kStages][kChunks][kRows * kAtom];
  float lse[kStages][kRows];    // +inf past S, so p = 0 there
  float delta[kStages][kRows];  // 0 past S
  uint64_t kv_full, full[kStages], empty[kStages];
};

// dQ: CTA per (batch*head, 128 query rows), two consumer warpgroups. A
// thread holds S and dP of one 64-key stage (2 x 32 registers), dQ (kD / 2)
// and the stage's dS fragment (16), 144 at D = 128; a 128-key stage would
// take 208 before addresses and the loop's temporaries.
template <int kD>
struct DqSmem : WarpRoles<2, 40, 232> {
  static constexpr int kChunks = kD / kAtom;
  static constexpr int kRows = 128;
  // a stage is released once dS K of it is done; four 64-key stages keep
  // the next loads in flight meanwhile
  static constexpr int kStages = 4;
  alignas(1024) uint16_t q[kChunks][kRows * kAtom];
  alignas(1024) uint16_t dout[kChunks][kRows * kAtom];
  alignas(1024) uint16_t k[kStages][kChunks][kDqKeys * kAtom];
  alignas(1024) uint16_t v[kStages][kChunks][kDqKeys * kAtom];
  float bias[kStages][kDqKeys];  // the caller's bias; -inf past T
  uint64_t q_full, full[kStages], empty[kStages];
};

struct TcArgs {
  CUtensorMap q, k, v, dout;  // rank 4: (D, sequence, head, batch)
  Params p;
};

// A [64, kD] accumulator fragment (rows row, row + 8 of the warpgroup's) to
// rows [0, rows) and columns [0, d) of a row-major [rows, d] output.
template <int kD, typename T>
__device__ __forceinline__ void store_fragment(T* __restrict__ base,
                                               const float (&acc)[kD / 2],
                                               int row, int rows, int d,
                                               int col0) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row + 8 * half;
    if (r >= rows) continue;
    T* dst = base + (long long)r * d;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      const int col = j * 8 + col0;
      const float x = acc[4 * j + 2 * half];
      const float y = acc[4 * j + 2 * half + 1];
      if (d % 2 == 0) {
        if (col < d) *reinterpret_cast<uint32_t*>(dst + col) = pack2<T>(x, y);
      } else {
        if (col < d) dst[col] = from_float<T>(x);
        if (col + 1 < d) dst[col + 1] = from_float<T>(y);
      }
    }
  }
}

// S = Q K^T of one stage for warpgroup wg: [64 rows, 128 keys], both
// operands K-major in shared memory
template <int kD, typename T>
__device__ __forceinline__ void start_scores(float (&sc)[kFwdKeys / 2],
                                             const FwdSmem<kD>& sm, int s, int wg) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const uint64_t a =
        sw128_desc(&sm.q[kk / 4][wg * 64 * kAtom + (kk % 4) * 16], 16, 1024);
    const uint64_t b = sw128_desc(&sm.k[s][kk / 4][(kk % 4) * 16], 16, 1024);
    Mma<kFwdKeys, T>::ss(sc, a, b, kk);
  }
}

// O += P V of one stage: P from registers, V MN-major in shared memory
template <int kD, typename T>
__device__ __forceinline__ void start_pv(float (&o)[kD / 2],
                                         const uint32_t (&pf)[kFwdKeys / 16][4],
                                         const FwdSmem<kD>& sm, int s) {
#pragma unroll
  for (int kb = 0; kb < kFwdKeys / 16; ++kb) {
    const uint64_t b =
        sw128_desc(&sm.v[s][0][kb * 16 * kAtom], kFwdKeys * kAtom * 2, 1024);
    Mma<kD, T>::rs(o, pf[kb], b);
  }
}

// The online softmax of one stage's scores (this thread's fragment of rows
// r and r + 8) in fp32: s = acc * scale + bias, the running max m and sum l
// updated, `corr` the factor the output so far must be scaled by, and
// p = exp(s - m), unnormalised and rounded to v's type, as the A fragments
// of P V. exp(x - m) is taken as exp2((x - m) log2 e): x - m is exact where
// both are the -1e30 PAD level, so a fully masked row keeps p = 1 on its
// real keys (and 0 past T, where the bias is -inf).
template <typename T>
__device__ __forceinline__ void online_softmax(float (&sc)[kFwdKeys / 2],
                                               const float* bias, float scale,
                                               int col0, float (&m)[2],
                                               float (&l)[2], float (&corr)[2],
                                               uint32_t (&pf)[kFwdKeys / 16][4]) {
  // row maxima and sums in 4 partial chains each, for instruction-level
  // parallelism: two or three warps a scheduler hide little latency
  float part[2][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int c = 0; c < 4; ++c) part[h][c] = m[h];
#pragma unroll
  for (int j = 0; j < kFwdKeys / 8; ++j) {
    const float2 b = *reinterpret_cast<const float2*>(&bias[j * 8 + col0]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sc[4 * j + 2 * h] = sc[4 * j + 2 * h] * scale + b.x;
      sc[4 * j + 2 * h + 1] = sc[4 * j + 2 * h + 1] * scale + b.y;
      part[h][j % 4] =
          fmaxf(part[h][j % 4], fmaxf(sc[4 * j + 2 * h], sc[4 * j + 2 * h + 1]));
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = fmaxf(fmaxf(part[h][0], part[h][1]), fmaxf(part[h][2], part[h][3]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    corr[h] = exp2_ftz((m[h] - mx) * kLog2e);
    m[h] = mx;
#pragma unroll
    for (int c = 0; c < 4; ++c) part[h][c] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < kFwdKeys / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float e0 = exp2_ftz((sc[4 * j + 2 * h] - m[h]) * kLog2e);
      const float e1 = exp2_ftz((sc[4 * j + 2 * h + 1] - m[h]) * kLog2e);
      part[h][j % 4] += e0 + e1;
      pf[j / 2][(j % 2) * 2 + h] = pack2<T>(e0, e1);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float sum = (part[h][0] + part[h][1]) + (part[h][2] + part[h][3]);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l[h] = l[h] * corr[h] + sum;
  }
}

template <int kD, typename T>
__global__ void __launch_bounds__(FwdSmem<kD>::kThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ TcArgs args) {
  using Smem = FwdSmem<kD>;
  constexpr int kChunks = Smem::kChunks;
  constexpr int kStages = Smem::kStages;
  constexpr int kRows = Smem::kRows;
  extern __shared__ uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(align_1024(smem_raw));
  const Params& p = args.p;
  const int qtile = blockIdx.x % p.n_qtiles;
  const int bh = blockIdx.x / p.n_qtiles;
  const int bi = bh / p.h;
  const int hi = bh % p.h;
  const int row0 = qtile * kRows;
  const int n_tiles = (p.t + kFwdKeys - 1) / kFwdKeys;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 32);                // the producer warp's lanes
      mbar_init(&sm.empty[s], Smem::kConsumers * 4);  // a lane a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= Smem::kProducerWarp) {  // the producer warpgroup: one warp loads
    setmaxnreg_dec<Smem::kProducerRegs>();
    if (warp != Smem::kProducerWarp) return;
    if (lane == 0) {
      mbar_arrive_tx(&sm.q_full, kChunks * kRows * kAtom * 2);
      for (int c = 0; c < kChunks; ++c)
        tma_load(sm.q[c], &args.q, &sm.q_full, c * kAtom, row0, hi, bi);
    }
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      mbar_wait(&sm.empty[s], ((it / kStages) & 1) ^ 1);
      const int key0 = it * kFwdKeys;
      for (int j = lane; j < kFwdKeys; j += 32) {
        const int key = key0 + j;
        sm.bias[s][j] = key < p.t
                            ? (p.bias ? p.bias[(long long)bi * p.t + key] : 0.f)
                            : -INFINITY;
      }
      if (lane == 0) {
        mbar_arrive_tx(&sm.full[s], 2 * kChunks * kFwdKeys * kAtom * 2);
        for (int c = 0; c < kChunks; ++c) {
          tma_load(sm.k[s][c], &args.k, &sm.full[s], c * kAtom, key0, hi, bi);
          tma_load(sm.v[s][c], &args.v, &sm.full[s], c * kAtom, key0, hi, bi);
        }
      } else {
        mbar_arrive(&sm.full[s]);
      }
    }
    return;
  }

  // consumer warpgroup wg: query rows row0 + 64 wg + [0, 64). The scores
  // of stage i and P V of stage i - 1 are started together; the softmax of
  // stage i then runs while P V is on the tensor cores.
  setmaxnreg_inc<Smem::kConsumerRegs>();
  const int wg = warp / 4;
  const int r = (warp % 4) * 16 + lane / 4;  // this thread's rows: r, r + 8
  const int col0 = (lane % 4) * 2;
  float o[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) o[i] = 0.f;
  // running max (the TPU kernel's initial -1e30) and sum of rows r, r + 8
  float m[2] = {kNegBig, kNegBig}, l[2] = {0.f, 0.f}, corr[2];
  float sc[kFwdKeys / 2];
  uint32_t pf[kFwdKeys / 16][4];  // p of the previous stage, in v's type

  mbar_wait(&sm.q_full, 0);
  mbar_wait(&sm.full[0], 0);
  wgmma_fence();
  start_scores<kD, T>(sc, sm, 0, wg);
  wgmma_commit();
  wgmma_wait<0>();
  pin(sc);
  online_softmax<T>(sc, sm.bias[0], p.scale, col0, m, l, corr, pf);  // o is 0
  for (int it = 1; it < n_tiles; ++it) {
    const int s = it % kStages;
    const int prev = (it - 1) % kStages;
    mbar_wait(&sm.full[s], (it / kStages) & 1);
    wgmma_fence();
    start_scores<kD, T>(sc, sm, s, wg);
    wgmma_commit();
    start_pv<kD, T>(o, pf, sm, prev);
    wgmma_commit();
    wgmma_wait<1>();  // the scores; P V may still run
    pin(sc);
    uint32_t pn[kFwdKeys / 16][4];
    online_softmax<T>(sc, sm.bias[s], p.scale, col0, m, l, corr, pn);
    wgmma_wait<0>();
    pin(o);
    release_stage(&sm.empty[prev], lane);
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      o[4 * j + 0] *= corr[0];
      o[4 * j + 1] *= corr[0];
      o[4 * j + 2] *= corr[1];
      o[4 * j + 3] *= corr[1];
    }
#pragma unroll
    for (int kb = 0; kb < kFwdKeys / 16; ++kb)
#pragma unroll
      for (int i = 0; i < 4; ++i) pf[kb][i] = pn[kb][i];
  }
  wgmma_fence();
  start_pv<kD, T>(o, pf, sm, (n_tiles - 1) % kStages);
  wgmma_commit();
  wgmma_wait<0>();
  pin(o);

  const int row = row0 + wg * 64 + r;
  l[0] = fmaxf(l[0], 1e-30f);
  l[1] = fmaxf(l[1], 1e-30f);
  if (p.lse_out != nullptr && lane % 4 == 0) {
    if (row < p.s) p.lse_out[(long long)bh * p.s + row] = m[0] + logf(l[0]);
    if (row + 8 < p.s) p.lse_out[(long long)bh * p.s + row + 8] = m[1] + logf(l[1]);
  }
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) {
    o[4 * j + 0] /= l[0];
    o[4 * j + 1] /= l[0];
    o[4 * j + 2] /= l[1];
    o[4 * j + 3] /= l[1];
  }
  store_fragment<kD>(static_cast<T*>(p.out) + (long long)bh * p.s * p.d, o, row,
                     p.s, p.d, col0);
}

template <int kD, typename T>
__global__ void __launch_bounds__(DkvSmem<kD>::kThreads, 1)
    flash_dkv_wgmma_kernel(const __grid_constant__ TcArgs args) {
  using Smem = DkvSmem<kD>;
  constexpr int kChunks = Smem::kChunks;
  constexpr int kRows = Smem::kRows;
  constexpr int kStages = Smem::kStages;
  extern __shared__ uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(align_1024(smem_raw));
  const Params& p = args.p;
  const int ktile = blockIdx.x % p.n_ktiles;
  const int bh = blockIdx.x / p.n_ktiles;
  const int bi = bh / p.h;
  const int hi = bh % p.h;
  const int key0 = ktile * kDkvKeys;
  const int n_tiles = (p.s + kRows - 1) / kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(&sm.kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 32);
      mbar_init(&sm.empty[s], Smem::kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= Smem::kProducerWarp) {  // the producer warpgroup: one warp loads
    setmaxnreg_dec<Smem::kProducerRegs>();
    if (warp != Smem::kProducerWarp) return;
    if (lane == 0) {
      mbar_arrive_tx(&sm.kv_full, 2 * kChunks * kDkvKeys * kAtom * 2);
      for (int c = 0; c < kChunks; ++c) {
        tma_load(sm.k[c], &args.k, &sm.kv_full, c * kAtom, key0, hi, bi);
        tma_load(sm.v[c], &args.v, &sm.kv_full, c * kAtom, key0, hi, bi);
      }
    }
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      mbar_wait(&sm.empty[s], ((it / kStages) & 1) ^ 1);
      const int qrow0 = it * kRows;
      for (int j = lane; j < kRows; j += 32) {
        const int row = qrow0 + j;
        const bool ok = row < p.s;
        sm.lse[s][j] = ok ? p.lse[(long long)bh * p.s + row] : INFINITY;
        sm.delta[s][j] = ok ? p.delta[(long long)bh * p.s + row] : 0.f;
      }
      if (lane == 0) {
        mbar_arrive_tx(&sm.full[s], 2 * kChunks * kRows * kAtom * 2);
        for (int c = 0; c < kChunks; ++c) {
          tma_load(sm.q[s][c], &args.q, &sm.full[s], c * kAtom, qrow0, hi, bi);
          tma_load(sm.dout[s][c], &args.dout, &sm.full[s], c * kAtom, qrow0, hi, bi);
        }
      } else {
        mbar_arrive(&sm.full[s]);
      }
    }
    return;
  }

  // consumer warpgroup wg: key rows key0 + 64 wg + [0, 64)
  setmaxnreg_inc<Smem::kConsumerRegs>();
  const int wg = warp / 4;
  const int r = (warp % 4) * 16 + lane / 4;  // this thread's keys: r, r + 8
  const int col0 = (lane % 4) * 2;           // and queries col0, col0 + 1 of each 8
  const int key = key0 + wg * 64 + r;
  const float bias_lo =
      key < p.t ? (p.bias ? p.bias[(long long)bi * p.t + key] : 0.f) : -INFINITY;
  const float bias_hi =
      key + 8 < p.t ? (p.bias ? p.bias[(long long)bi * p.t + key + 8] : 0.f)
                    : -INFINITY;
  float dk[kD / 2], dv[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) {
    dk[i] = 0.f;
    dv[i] = 0.f;
  }

  mbar_wait(&sm.kv_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages;
    mbar_wait(&sm.full[s], (it / kStages) & 1);

    float st[kRows / 2], dpt[kRows / 2];  // S^T and dP^T: [64 keys, kRows]
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const int off = wg * 64 * kAtom + (kk % 4) * 16;
      Mma<kRows, T>::ss(st, sw128_desc(&sm.k[kk / 4][off], 16, 1024),
                        sw128_desc(&sm.q[s][kk / 4][(kk % 4) * 16], 16, 1024), kk);
    }
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const int off = wg * 64 * kAtom + (kk % 4) * 16;
      Mma<kRows, T>::ss(dpt, sw128_desc(&sm.v[kk / 4][off], 16, 1024),
                        sw128_desc(&sm.dout[s][kk / 4][(kk % 4) * 16], 16, 1024),
                        kk);
    }
    wgmma_commit();
    wgmma_wait<0>();
    pin(st);
    pin(dpt);

    // p^T in dO's type and ds^T in q's type: A fragments of the next products
    uint32_t pf[kRows / 16][4], df[kRows / 16][4];
#pragma unroll
    for (int j = 0; j < kRows / 8; ++j) {
      const float2 lse = *reinterpret_cast<const float2*>(&sm.lse[s][j * 8 + col0]);
      const float2 dl = *reinterpret_cast<const float2*>(&sm.delta[s][j * 8 + col0]);
      const float p0 = exp2_ftz((st[4 * j + 0] * p.scale + bias_lo - lse.x) * kLog2e);
      const float p1 = exp2_ftz((st[4 * j + 1] * p.scale + bias_lo - lse.y) * kLog2e);
      const float p2 = exp2_ftz((st[4 * j + 2] * p.scale + bias_hi - lse.x) * kLog2e);
      const float p3 = exp2_ftz((st[4 * j + 3] * p.scale + bias_hi - lse.y) * kLog2e);
      pf[j / 2][(j % 2) * 2 + 0] = pack2<T>(p0, p1);
      pf[j / 2][(j % 2) * 2 + 1] = pack2<T>(p2, p3);
      df[j / 2][(j % 2) * 2 + 0] =
          pack2<T>(p0 * (dpt[4 * j + 0] - dl.x), p1 * (dpt[4 * j + 1] - dl.y));
      df[j / 2][(j % 2) * 2 + 1] =
          pack2<T>(p2 * (dpt[4 * j + 2] - dl.x), p3 * (dpt[4 * j + 3] - dl.y));
    }

    wgmma_fence();
#pragma unroll
    for (int kb = 0; kb < kRows / 16; ++kb) {
      Mma<kD, T>::rs(dv, pf[kb], sw128_desc(&sm.dout[s][0][kb * 16 * kAtom],
                                            kRows * kAtom * 2, 1024));
      Mma<kD, T>::rs(dk, df[kb], sw128_desc(&sm.q[s][0][kb * 16 * kAtom],
                                            kRows * kAtom * 2, 1024));
    }
    wgmma_commit();
    wgmma_wait<0>();
    pin(dv);
    pin(dk);
    release_stage(&sm.empty[s], lane);
  }

#pragma unroll
  for (int i = 0; i < kD / 2; ++i) dk[i] *= p.scale;
  const int row = key0 + wg * 64 + r;
  store_fragment<kD>(static_cast<T*>(p.dk) + (long long)bh * p.t * p.d, dk, row,
                     p.t, p.d, col0);
  store_fragment<kD>(static_cast<T*>(p.dv) + (long long)bh * p.t * p.d, dv, row,
                     p.t, p.d, col0);
}

// S = Q K^T and dP = dO V^T of one dQ stage for warpgroup wg: [64 rows,
// 64 keys] each, all four operands K-major in shared memory
template <int kD, typename T>
__device__ __forceinline__ void start_dq_scores(float (&sc)[kDqKeys / 2],
                                                float (&dp)[kDqKeys / 2],
                                                const DqSmem<kD>& sm, int s,
                                                int wg) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const int off = wg * 64 * kAtom + (kk % 4) * 16;
    const int key_off = (kk % 4) * 16;
    Mma<kDqKeys, T>::ss(sc, sw128_desc(&sm.q[kk / 4][off], 16, 1024),
                        sw128_desc(&sm.k[s][kk / 4][key_off], 16, 1024), kk);
    Mma<kDqKeys, T>::ss(dp, sw128_desc(&sm.dout[kk / 4][off], 16, 1024),
                        sw128_desc(&sm.v[s][kk / 4][key_off], 16, 1024), kk);
  }
}

// dQ += dS K of one stage: dS from registers, K MN-major in shared memory
// (the same swizzled tile the scores read K-major)
template <int kD, typename T>
__device__ __forceinline__ void start_dq_product(float (&dq)[kD / 2],
                                                 const uint32_t (&df)[kDqKeys / 16][4],
                                                 const DqSmem<kD>& sm, int s) {
#pragma unroll
  for (int kb = 0; kb < kDqKeys / 16; ++kb) {
    const uint64_t b =
        sw128_desc(&sm.k[s][0][kb * 16 * kAtom], kDqKeys * kAtom * 2, 1024);
    Mma<kD, T>::rs(dq, df[kb], b);
  }
}

// dS of one stage (this thread's fragment of rows r and r + 8) in fp32:
// x = s * scale + bias, p = exp(x - lse) taken as exp2((x - lse) log2 e),
// ds = p (dP - delta), rounded to k's type as the A fragments of dS K. x -
// lse is exact where both are the -1e30 PAD level, so a fully masked row
// recomputes p = 1 on its real keys (and 0 past T, where the bias is -inf).
template <typename T>
__device__ __forceinline__ void stage_ds(const float (&sc)[kDqKeys / 2],
                                         const float (&dp)[kDqKeys / 2],
                                         const float* bias, float scale, int col0,
                                         const float (&lse)[2],
                                         const float (&delta)[2],
                                         uint32_t (&df)[kDqKeys / 16][4]) {
#pragma unroll
  for (int j = 0; j < kDqKeys / 8; ++j) {
    const float2 b = *reinterpret_cast<const float2*>(&bias[j * 8 + col0]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float x0 = sc[4 * j + 2 * h] * scale + b.x;
      const float x1 = sc[4 * j + 2 * h + 1] * scale + b.y;
      const float p0 = exp2_ftz((x0 - lse[h]) * kLog2e);
      const float p1 = exp2_ftz((x1 - lse[h]) * kLog2e);
      df[j / 2][(j % 2) * 2 + h] =
          pack2<T>(p0 * (dp[4 * j + 2 * h] - delta[h]),
                   p1 * (dp[4 * j + 2 * h + 1] - delta[h]));
    }
  }
}

template <int kD, typename T>
__global__ void __launch_bounds__(DqSmem<kD>::kThreads, 1)
    flash_dq_wgmma_kernel(const __grid_constant__ TcArgs args) {
  using Smem = DqSmem<kD>;
  constexpr int kChunks = Smem::kChunks;
  constexpr int kStages = Smem::kStages;
  constexpr int kRows = Smem::kRows;
  extern __shared__ uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(align_1024(smem_raw));
  const Params& p = args.p;
  const int qtile = blockIdx.x % p.n_qtiles;
  const int bh = blockIdx.x / p.n_qtiles;
  const int bi = bh / p.h;
  const int hi = bh % p.h;
  const int row0 = qtile * kRows;
  const int n_tiles = (p.t + kDqKeys - 1) / kDqKeys;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 32);                     // the producer warp's lanes
      mbar_init(&sm.empty[s], Smem::kConsumers * 4);  // a lane a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= Smem::kProducerWarp) {  // the producer warpgroup: one warp loads
    setmaxnreg_dec<Smem::kProducerRegs>();
    if (warp != Smem::kProducerWarp) return;
    if (lane == 0) {
      mbar_arrive_tx(&sm.q_full, 2 * kChunks * kRows * kAtom * 2);
      for (int c = 0; c < kChunks; ++c) {
        tma_load(sm.q[c], &args.q, &sm.q_full, c * kAtom, row0, hi, bi);
        tma_load(sm.dout[c], &args.dout, &sm.q_full, c * kAtom, row0, hi, bi);
      }
    }
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      mbar_wait(&sm.empty[s], ((it / kStages) & 1) ^ 1);
      const int key0 = it * kDqKeys;
      for (int j = lane; j < kDqKeys; j += 32) {
        const int key = key0 + j;
        sm.bias[s][j] = key < p.t
                            ? (p.bias ? p.bias[(long long)bi * p.t + key] : 0.f)
                            : -INFINITY;
      }
      if (lane == 0) {
        mbar_arrive_tx(&sm.full[s], 2 * kChunks * kDqKeys * kAtom * 2);
        for (int c = 0; c < kChunks; ++c) {
          tma_load(sm.k[s][c], &args.k, &sm.full[s], c * kAtom, key0, hi, bi);
          tma_load(sm.v[s][c], &args.v, &sm.full[s], c * kAtom, key0, hi, bi);
        }
      } else {
        mbar_arrive(&sm.full[s]);
      }
    }
    return;
  }

  // consumer warpgroup wg: query rows row0 + 64 wg + [0, 64). Per stage,
  // S and dP, then dS in registers, then dS K; the other warpgroup's
  // products run on the tensor cores while this one computes dS.
  setmaxnreg_inc<Smem::kConsumerRegs>();
  const int wg = warp / 4;
  const int r = (warp % 4) * 16 + lane / 4;  // this thread's rows: r, r + 8
  const int col0 = (lane % 4) * 2;
  const int row = row0 + wg * 64 + r;
  // the thread's rows stay the same over the key loop, so their lse and
  // delta live in registers; 0 past S, where Q and dO are zero-filled and
  // ds comes out 0
  float lse[2], delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = row + 8 * h;
    lse[h] = i < p.s ? p.lse[(long long)bh * p.s + i] : 0.f;
    delta[h] = i < p.s ? p.delta[(long long)bh * p.s + i] : 0.f;
  }
  float dq[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) dq[i] = 0.f;
  float sc[kDqKeys / 2], dp[kDqKeys / 2];
  uint32_t df[kDqKeys / 16][4];  // dS of the stage, in k's type

  mbar_wait(&sm.q_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages;
    mbar_wait(&sm.full[s], (it / kStages) & 1);
    wgmma_fence();
    start_dq_scores<kD, T>(sc, dp, sm, s, wg);
    wgmma_commit();
    wgmma_wait<0>();
    pin(sc);
    pin(dp);
    stage_ds<T>(sc, dp, sm.bias[s], p.scale, col0, lse, delta, df);
    wgmma_fence();
    start_dq_product<kD, T>(dq, df, sm, s);
    wgmma_commit();
    wgmma_wait<0>();
    pin(dq);
    release_stage(&sm.empty[s], lane);
  }

#pragma unroll
  for (int i = 0; i < kD / 2; ++i) dq[i] *= p.scale;
  store_fragment<kD>(static_cast<T*>(p.dq) + (long long)bh * p.s * p.d, dq, row,
                     p.s, p.d, col0);
}

// -- launches -----------------------------------------------------------------

enum Kind { kForward = 0, kDq = 1, kDkv = 2 };

// dtype 0 = float32, 1 = float16, 2 = bfloat16: every 16-bit launch takes a
// wgmma kernel, every fp32 one a CUDA-core kernel
bool uses_wgmma(int dtype) { return dtype != 0; }

size_t smem_bytes(Kind kind, int kd) {
  const size_t tile = (size_t)64 * (kd + 4);
  const size_t score = (size_t)64 * kTileLd;
  switch (kind) {
    case kForward: return sizeof(float) * (3 * tile + score + 2 * 64);
    case kDq: return sizeof(float) * (4 * tile + score + 3 * 64);
    default: return sizeof(float) * (4 * tile + 2 * score + 3 * 64);
  }
}

// the CUDA-core kernels: fp32 forward, dQ and dK/dV
template <int kD>
cudaError_t launch_cuda_core(Kind kind, const Params& p, cudaStream_t stream) {
  void (*kernel)(Params) = flash_dq_kernel<kD, float>;
  long long blocks = (long long)p.b * p.h * p.n_qtiles;
  if (kind == kForward) kernel = flash_fwd_kernel<kD, float>;
  if (kind == kDkv) {
    kernel = flash_dkv_kernel<kD, float>;
    blocks = (long long)p.b * p.h * p.n_ktiles;
  }
  return launch_grid(kernel, blocks, kThreads, smem_bytes(kind, kD), stream, p);
}

// the wgmma kernels: 16-bit forward, dQ and dK/dV. Q and dO are boxes of a
// CTA's query rows (forward, dQ) or of one stage's (dK/dV); K and V of one
// stage's keys (forward, dQ) or of a CTA's (dK/dV).
template <int kD, typename T>
cudaError_t launch_wgmma(Kind kind, Params p, cudaStream_t stream) {
  const int q_box = kind == kForward ? FwdSmem<kD>::kRows
                    : kind == kDq    ? DqSmem<kD>::kRows
                                     : DkvSmem<kD>::kRows;
  const int kv_box = kind == kForward ? kFwdKeys : kind == kDq ? kDqKeys : kDkvKeys;
  TcArgs args;
  memset(&args, 0, sizeof(args));
  cudaError_t err = make_map<T>(&args.q, p.q, p.d, p.s, p.h, p.b, p.q_ss,
                                p.q_sh, p.q_sb, q_box);
  if (err == cudaSuccess)
    err = make_map<T>(&args.k, p.k, p.d, p.t, p.h, p.b, p.k_ss, p.k_sh, p.k_sb,
                      kv_box);
  if (err == cudaSuccess)
    err = make_map<T>(&args.v, p.v, p.d, p.t, p.h, p.b, p.v_ss, p.v_sh, p.v_sb,
                      kv_box);
  if (err == cudaSuccess && kind != kForward)
    err = make_map<T>(&args.dout, p.dout, p.d, p.s, p.h, p.b, p.do_ss, p.do_sh,
                      p.do_sb, q_box);
  if (err != cudaSuccess) return err;
  p.n_qtiles = (p.s + q_box - 1) / q_box;
  p.n_ktiles = (p.t + kDkvKeys - 1) / kDkvKeys;
  args.p = p;
  const long long bh = (long long)p.b * p.h;
  switch (kind) {
    case kForward:
      return launch_grid(flash_fwd_wgmma_kernel<kD, T>, bh * p.n_qtiles,
                         FwdSmem<kD>::kThreads, sizeof(FwdSmem<kD>) + 1024, stream,
                         args);
    case kDq:
      return launch_grid(flash_dq_wgmma_kernel<kD, T>, bh * p.n_qtiles,
                         DqSmem<kD>::kThreads, sizeof(DqSmem<kD>) + 1024, stream,
                         args);
    default:
      return launch_grid(flash_dkv_wgmma_kernel<kD, T>, bh * p.n_ktiles,
                         DkvSmem<kD>::kThreads, sizeof(DkvSmem<kD>) + 1024, stream,
                         args);
  }
}

template <typename T>
cudaError_t launch_t(Kind kind, const Params& p, cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value)
    return p.d <= 64 ? launch_cuda_core<64>(kind, p, stream)
                     : launch_cuda_core<128>(kind, p, stream);
  else
    return p.d <= 64 ? launch_wgmma<64, T>(kind, p, stream)
                     : launch_wgmma<128, T>(kind, p, stream);
}

int launch(Kind kind, Params& p, int dtype, void* stream) {
  if (p.b < 1 || p.h < 1 || p.s < 1 || p.t < 1 || p.d < 1 || p.d > kMaxDim)
    return (int)cudaErrorInvalidValue;
  p.n_qtiles = (p.s + kBlockM - 1) / kBlockM;
  p.n_ktiles = (p.t + kBlockN - 1) / kBlockN;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_t<float>(kind, p, s);
    case 1: return (int)launch_t<__half>(kind, p, s);
    case 2: return (int)launch_t<__nv_bfloat16>(kind, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

Params make_params(const void* q, const void* k, const void* v,
                   const void* dout, const long long* strides,
                   const float* bias, int b, int h, int s, int t, int d,
                   float scale) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.q_sb = strides[0]; p.q_sh = strides[1]; p.q_ss = strides[2];
  p.k_sb = strides[3]; p.k_sh = strides[4]; p.k_ss = strides[5];
  p.v_sb = strides[6]; p.v_sh = strides[7]; p.v_ss = strides[8];
  if (dout != nullptr) {
    p.do_sb = strides[9]; p.do_sh = strides[10]; p.do_ss = strides[11];
  }
  p.bias = bias;
  p.b = b;
  p.h = h;
  p.s = s;
  p.t = t;
  p.d = d;
  p.scale = scale;
  return p;
}

}  // namespace

extern "C" {

// All tensors share one dtype: 0 = float32, 1 = float16, 2 = bfloat16.
// `strides` holds the element strides (batch, head, sequence) of q, k, v
// and, for the backward, dO: 9 or 12 values. `bias` may be NULL (no mask).
// Each returns a cudaError_t code; 0 means the launch was accepted.

int dm_flash_forward(const void* q, const void* k, const void* v,
                     const long long* strides, const float* bias, void* out,
                     float* lse, int b, int h, int s, int t, int d,
                     float scale, int dtype, void* stream) {
  Params p = make_params(q, k, v, nullptr, strides, bias, b, h, s, t, d, scale);
  p.out = out;
  p.lse_out = lse;
  return launch(kForward, p, dtype, stream);
}

int dm_flash_dq(const void* q, const void* k, const void* v, const void* dout,
                const long long* strides, const float* bias, const float* lse,
                const float* delta, void* dq, int b, int h, int s, int t,
                int d, float scale, int dtype, void* stream) {
  Params p = make_params(q, k, v, dout, strides, bias, b, h, s, t, d, scale);
  p.lse = lse;
  p.delta = delta;
  p.dq = dq;
  return launch(kDq, p, dtype, stream);
}

int dm_flash_dkv(const void* q, const void* k, const void* v,
                 const void* dout, const long long* strides, const float* bias,
                 const float* lse, const float* delta, void* dk, void* dv,
                 int b, int h, int s, int t, int d, float scale, int dtype,
                 void* stream) {
  Params p = make_params(q, k, v, dout, strides, bias, b, h, s, t, d, scale);
  p.lse = lse;
  p.delta = delta;
  p.dk = dk;
  p.dv = dv;
  return launch(kDkv, p, dtype, stream);
}

// The kernel variant a launch takes: kind 0 = forward, 1 = dQ, 2 = dK/dV;
// "" for arguments no launch accepts.
const char* dm_flash_variant(int kind, int dtype, int d) {
  if (kind < 0 || kind > 2 || dtype < 0 || dtype > 2 || d < 1 || d > kMaxDim)
    return "";
  static const char* const names[2][2] = {{"cuda_core_d64", "cuda_core_d128"},
                                          {"wgmma_tma_d64", "wgmma_tma_d128"}};
  return names[uses_wgmma(dtype)][d > 64];
}

// Largest head dimension the kernels take.
int dm_flash_max_dim(void) { return kMaxDim; }

const char* dm_flash_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
