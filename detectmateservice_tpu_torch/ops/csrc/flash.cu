// Flash attention for Hopper (sm_90a), plain C interface: the forward, dQ and
// dK/dV kernels.
//
// Replaces the three Pallas TPU kernels of detectmateservice_tpu/ops/flash.py:
//   flash_fwd_kernel  <- `_flash_kernel` (reached through `_flash_forward`)
//   flash_dq_kernel   <- `_dq_kernel`    (reached through `_flash_bwd`)
//   flash_dkv_kernel  <- `_dkv_kernel`   (reached through `_flash_bwd`)
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
// What bounds it: 4 (forward), 6 (dQ) and 8 (dK/dV) * B*H*S*T*D operations on
// O((S + T) * D) bytes per head, far above the card's operations-per-byte
// line, so the bound is arithmetic. This first version computes the products
// on CUDA cores in fp32 (no mma.sync, wgmma or TMA yet), so it runs against
// the fp32 CUDA-core rate, not the bf16 tensor-core peak it is measured
// against.
//
// Design. The TPU grid walks its inner axis sequentially on one core and
// carries (m, l, acc) in VMEM between steps. Here one CTA owns one
// (batch*head, 64-row tile) and loops over the other sequence itself, so no
// state crosses CTAs:
//   forward: CTA per query tile; loops over key tiles with (m, l) per row and
//            the [64, D] accumulator in registers (online softmax);
//   dQ:      CTA per query tile; loops over key tiles, recomputing p from lse;
//   dK/dV:   CTA per key tile; loops over query tiles, recomputing p from lse.
// dQ and dK/dV are split as in the JAX package, so neither needs atomics or a
// second pass. Each tile is staged in shared memory as fp32 (exact for bf16
// and fp16 inputs); each of the 256 threads computes a 4 x 4 block of the
// 64 x 64 score tile and a 4 x (D/16) block of the [64, D] products. Ragged
// tails are masked here: key rows t >= T get s = -inf (p = 0, so a fully
// masked row averages v over its T real keys only), query rows s >= S are
// zero-filled and never written.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;   // query rows per tile
constexpr int kBlockN = 64;   // key rows per tile
constexpr int kThreads = 256; // 16 x 16 threads
constexpr int kTileLd = 65;   // padded stride of a 64 x 64 score tile
constexpr float kNegBig = -1e30f;
constexpr size_t kMaxSmem = 232448;  // opt-in shared memory per block
constexpr int kMaxDim = 128;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half_rn(x);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

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

enum Kind { kForward = 0, kDq = 1, kDkv = 2 };

size_t smem_bytes(Kind kind, int kd) {
  const size_t tile = (size_t)64 * (kd + 4);
  const size_t score = (size_t)64 * kTileLd;
  switch (kind) {
    case kForward: return sizeof(float) * (3 * tile + score + 2 * 64);
    case kDq: return sizeof(float) * (4 * tile + score + 3 * 64);
    default: return sizeof(float) * (4 * tile + 2 * score + 3 * 64);
  }
}

template <int kD, typename T>
cudaError_t launch_kd(Kind kind, const Params& p, cudaStream_t stream) {
  void (*kernel)(Params);
  long long blocks;
  switch (kind) {
    case kForward:
      kernel = flash_fwd_kernel<kD, T>;
      blocks = (long long)p.b * p.h * p.n_qtiles;
      break;
    case kDq:
      kernel = flash_dq_kernel<kD, T>;
      blocks = (long long)p.b * p.h * p.n_qtiles;
      break;
    default:
      kernel = flash_dkv_kernel<kD, T>;
      blocks = (long long)p.b * p.h * p.n_ktiles;
      break;
  }
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const size_t smem = smem_bytes(kind, kD);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((unsigned)blocks), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(Kind kind, const Params& p, cudaStream_t stream) {
  if (p.d <= 64) return launch_kd<64, T>(kind, p, stream);
  return launch_kd<128, T>(kind, p, stream);
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

// Largest head dimension the kernels take.
int dm_flash_max_dim(void) { return kMaxDim; }

const char* dm_flash_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
