// Fused vocab logsumexp head for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `_lse_kernel` reached through
// `candidate_lse` in detectmateservice_tpu/ops/scorehead.py. Computes, for
// every row n of hidden [N, D] against emb [C, D]:
//
//     out[n] = log(max(l, 1e-30)) + m,   (m, l) = online max / sum of
//                                         exp(hidden[n] . emb[c]) over c
//
// with fp32 products and sums, without ever writing the [N, C] logits to
// device memory (at N = 16384, C = 32768 they would be 2 GiB of fp32).
//
// What bounds it: the work is 2*N*C*D operations on N*D + C*D input
// elements, far above the card's operations-per-byte line, so the bound is
// arithmetic: the bf16 tensor-core peak for 16-bit operands. Beside the
// products it takes one exp per logit: 2 D tensor-core operations per exp,
// so at D = 128 the SM's exp unit (16 a clock) needs as long as its tensor
// cores (4096 operations a clock), at D = 256 half as long; the two must
// overlap.
//
// Variants, chosen by a stated rule of dtype and D
// (`dm_candidate_lse_variant` names them):
//   16-bit, D a multiple of 16 up to 256 -> `lse_wgmma_kernel`, tensor cores
//       fed by TMA, "wgmma_tma_d{64,128,256}_split{S}";
//   fp32, or any other D                  -> `lse_kernel`, fp32 CUDA cores,
//       "cuda_core".
// A 16-bit launch whose operands TMA refuses (base or row stride not a
// multiple of 16 bytes) fails; it never falls back.
//
// Design of the wgmma kernel: the flash forward without P V (helpers in
// hopper.cuh). A CTA holds 192 hidden rows (three consumer warpgroups of
// 64) x D, loaded once by TMA with the 128-byte swizzle (D = 256 is four
// 64-column atoms); a producer warp streams emb in stages of 128 vocabulary
// rows through an mbarrier ring. Per stage, S = H E^T is one SS wgmma chain
// with fp32 accumulators; the stage is released as soon as it completes,
// columns at or past C (zero-filled by TMA, which would give logit 0) are
// set to -inf in the fragment, and the tile is folded into a running
// (m, l) per thread and row, exp taken as exp2((s - m) log2 e) on the SFU.
// The three warpgroups share each stage, so one's exps overlap the others'
// wgmma; issuing the next stage's product before the fold (two accumulator
// fragments) measured slower, three warpgroups faster than two (PERF.md). The four lanes of a row merge their
// (m, l) once, at the end.
//
// Split over C. With ceil(N / 192) row tiles too few to give about two CTAs
// an SM, the grid also splits C into `splits` contiguous ranges of whole
// stages; each CTA then writes its (m, l) to an fp32 scratch [splits, N, 2]
// (allocated by the caller), and `lse_combine_kernel` merges them:
//   M = max_i m_i, L = sum_i l_i exp(m_i - M), out = log(max(L, 1e-30)) + M.
// `splits` is a function of (N, C) alone, never of the card, so a shape
// always sums in one order and alert decisions repeat from run to run.
//
// The CUDA-core kernel: each CTA owns kBlockN rows and loops over
// all of C itself:
//   1. the CTA's hidden rows are converted to fp32 into shared memory once;
//   2. for each kBlockC-column tile of emb: stage it (fp32) in shared
//      memory, each of the 256 threads computes a 4x4 block of dot products
//      with float4 shared-memory reads, the 64x64 score tile goes to shared
//      memory;
//   3. four lanes per row reduce the tile to its max and sum of exp and
//      fold it into the row's running (max, sum) held in registers.
// Tail columns (c >= C) are never read; tail rows (n >= N) are zero-filled
// and not written, in every variant.

#include "hopper.cuh"

#include <math.h>
#include <stdio.h>

#include <algorithm>

namespace {

constexpr int kBlockN = 64;   // rows per CTA
constexpr int kBlockC = 64;   // emb rows (columns of the logits) per tile
constexpr int kThreads = 256; // 16 x 16 threads, each a 4 x 4 micro-tile
constexpr int kTileLd = kBlockC + 1;  // padded stride of the score tile
constexpr float kNegBig = -1e30f;

// Stage rows [row0, row0 + kTileRows) of a [rows, d] matrix into dst as
// fp32, row-major with stride ld; rows past `rows` and columns past d are 0.
template <int kTileRows, typename T>
__device__ __forceinline__ void stage_rows(const T* __restrict__ src,
                                           float* __restrict__ dst, int row0,
                                           int rows, int d, int dp, int ld) {
  for (int idx = threadIdx.x; idx < kTileRows * dp; idx += kThreads) {
    const int r = idx / dp;
    const int k = idx - r * dp;
    const int row = row0 + r;
    dst[r * ld + k] = (row < rows && k < d)
                          ? to_float(src[(size_t)row * d + k])
                          : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    lse_kernel(const T* __restrict__ hidden, const T* __restrict__ emb,
               float* __restrict__ out, int n, int c, int d, int dp) {
  extern __shared__ __align__(16) float smem[];
  const int ld = dp + 4;  // keeps float4 alignment, spreads banks
  float* h_s = smem;                   // [kBlockN][ld]
  float* e_s = h_s + kBlockN * ld;     // [kBlockC][ld]
  float* s_s = e_s + kBlockC * ld;     // [kBlockN][kTileLd]

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kBlockN;
  const int ty = tid / 16;  // micro-tile rows ty + 16 i
  const int tx = tid % 16;  // micro-tile cols tx + 16 j
  const int red_row = tid / 4;   // reduction: four lanes per row
  const int red_part = tid % 4;

  stage_rows<kBlockN>(hidden, h_s, row0, n, d, dp, ld);

  float m_run = kNegBig;
  float l_run = 0.f;
  for (int c0 = 0; c0 < c; c0 += kBlockC) {
    stage_rows<kBlockC>(emb, e_s, c0, c, d, dp, ld);
    __syncthreads();

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k = 0; k < dp; k += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(&h_s[(ty + 16 * i) * ld + k]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = *reinterpret_cast<const float4*>(&e_s[(tx + 16 * j) * ld + k]);
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
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        s_s[(ty + 16 * i) * kTileLd + tx + 16 * j] = acc[i][j];
    __syncthreads();

    // online (max, sum) over the tile's valid columns; the four lanes of a
    // row are adjacent, so two xor-shuffles combine them
    const int valid = min(kBlockC, c - c0);
    const float* srow = s_s + red_row * kTileLd;
    float tmax = kNegBig;
    for (int j = red_part; j < valid; j += 4) tmax = fmaxf(tmax, srow[j]);
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m_run, tmax);
    float tsum = 0.f;
    for (int j = red_part; j < valid; j += 4) tsum += expf(srow[j] - m_new);
    tsum += __shfl_xor_sync(0xffffffffu, tsum, 1);
    tsum += __shfl_xor_sync(0xffffffffu, tsum, 2);
    l_run = l_run * expf(m_run - m_new) + tsum;
    m_run = m_new;
    // the next iteration's first __syncthreads orders these s_s reads
    // before the next tile's s_s writes; e_s is rewritten only after every
    // thread passed this iteration's second __syncthreads
  }
  const int row = row0 + red_row;
  if (red_part == 0 && row < n) out[row] = logf(fmaxf(l_run, 1e-30f)) + m_run;
}

size_t smem_bytes(int dp) {
  return sizeof(float) * ((size_t)(kBlockN + kBlockC) * (dp + 4) +
                          (size_t)kBlockN * kTileLd);
}

// -- 16-bit: wgmma on tiles staged by TMA -------------------------------------

constexpr int kLseRows = 192;      // hidden rows per CTA: three warpgroups of 64
constexpr int kLseCols = 128;      // vocabulary rows per stage
constexpr int kMaxWgmmaDim = 256;  // the largest D the shared-memory plan admits
// split C until the grid holds about this many CTAs (two an SM of an H100);
// a constant, so that the split depends on the shape alone
constexpr int kTargetCtas = 264;
constexpr int kMinSplitStages = 4;  // stages a split walks at least

// Shared memory of the wgmma kernel: the hidden tile and a ring of emb
// stages, each [rows][64] 16-bit values per 64-column chunk of D as TMA
// writes them; every tile starts on a 1024-byte boundary. At D = 256 two
// stages fit beside the 96 KiB hidden tile (224 KiB in all), at D <= 128
// four. Three consumer warpgroups at 160 registers: a thread holds one
// [64, 128] fragment of logits (64 registers) and its (m, l).
template <int kD>
struct LseSmem : WarpRoles<3, 24, 160> {
  static constexpr int kChunks = kD / kAtom;
  static constexpr int kStages = kD == 256 ? 2 : 4;
  alignas(1024) uint16_t h[kChunks][kLseRows * kAtom];
  alignas(1024) uint16_t e[kStages][kChunks][kLseCols * kAtom];
  uint64_t h_full, full[kStages], empty[kStages];
};

struct LseArgs {
  CUtensorMap h, e;  // rank 4: (D, rows, 1, 1)
  float* out;        // [N] (splits == 1) or the [splits, N, 2] scratch
  int n, c, splits, stages_per;
};

// S = H E^T of one stage for warpgroup wg: [64 rows, 128 vocabulary rows],
// both operands K-major in shared memory
template <int kD, typename T>
__device__ __forceinline__ void start_lse_scores(float (&sc)[kLseCols / 2],
                                                 const LseSmem<kD>& sm, int s,
                                                 int wg) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const uint64_t a =
        sw128_desc(&sm.h[kk / 4][wg * 64 * kAtom + (kk % 4) * 16], 16, 1024);
    const uint64_t b = sw128_desc(&sm.e[s][kk / 4][(kk % 4) * 16], 16, 1024);
    Mma<kLseCols, T>::ss(sc, a, b, kk);
  }
}

// Fold one stage's logits (this thread's fragment: rows r and r + 8,
// columns col_base + 8 j + col0 + {0, 1}) into the thread's running (m, l)
// of each row; columns at or past C count as -inf.
__device__ __forceinline__ void fold_scores(float (&sc)[kLseCols / 2], int col_base,
                                            int c, int col0, float (&m)[2],
                                            float (&l)[2]) {
  if (col_base + kLseCols > c) {
#pragma unroll
    for (int j = 0; j < kLseCols / 8; ++j)
#pragma unroll
      for (int q = 0; q < 2; ++q)
        if (col_base + 8 * j + col0 + q >= c) {
          sc[4 * j + q] = -INFINITY;
          sc[4 * j + 2 + q] = -INFINITY;
        }
  }
  // maxima and sums in 4 partial chains each, for instruction-level
  // parallelism
  float part[2][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int k = 0; k < 4; ++k) part[h][k] = m[h];
#pragma unroll
  for (int j = 0; j < kLseCols / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      part[h][j % 4] =
          fmaxf(part[h][j % 4], fmaxf(sc[4 * j + 2 * h], sc[4 * j + 2 * h + 1]));
  float corr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float mx =
        fmaxf(fmaxf(part[h][0], part[h][1]), fmaxf(part[h][2], part[h][3]));
    corr[h] = exp2_ftz((m[h] - mx) * kLog2e);
    m[h] = mx;
#pragma unroll
    for (int k = 0; k < 4; ++k) part[h][k] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < kLseCols / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      part[h][j % 4] += exp2_ftz((sc[4 * j + 2 * h] - m[h]) * kLog2e) +
                        exp2_ftz((sc[4 * j + 2 * h + 1] - m[h]) * kLog2e);
#pragma unroll
  for (int h = 0; h < 2; ++h)
    l[h] = l[h] * corr[h] + ((part[h][0] + part[h][1]) + (part[h][2] + part[h][3]));
}

template <int kD, typename T>
__global__ void __launch_bounds__(LseSmem<kD>::kThreads, 1)
    lse_wgmma_kernel(const __grid_constant__ LseArgs args) {
  using Smem = LseSmem<kD>;
  constexpr int kChunks = Smem::kChunks;
  constexpr int kStages = Smem::kStages;
  extern __shared__ uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(align_1024(smem_raw));
  const int tile = blockIdx.x / args.splits;
  const int split = blockIdx.x % args.splits;
  const int row0 = tile * kLseRows;
  const int stage0 = split * args.stages_per;
  const int n_stages =
      min(args.stages_per, (args.c + kLseCols - 1) / kLseCols - stage0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(&sm.h_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);                      // the loading lane
      mbar_init(&sm.empty[s], Smem::kConsumers * 4);  // a lane a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= Smem::kProducerWarp) {  // the producer warpgroup: one lane loads
    setmaxnreg_dec<Smem::kProducerRegs>();
    if (warp != Smem::kProducerWarp || lane != 0) return;
    mbar_arrive_tx(&sm.h_full, kChunks * kLseRows * kAtom * 2);
    for (int c = 0; c < kChunks; ++c)
      tma_load(sm.h[c], &args.h, &sm.h_full, c * kAtom, row0, 0, 0);
    for (int it = 0; it < n_stages; ++it) {
      const int s = it % kStages;
      mbar_wait(&sm.empty[s], ((it / kStages) & 1) ^ 1);
      mbar_arrive_tx(&sm.full[s], kChunks * kLseCols * kAtom * 2);
      for (int c = 0; c < kChunks; ++c)
        tma_load(sm.e[s][c], &args.e, &sm.full[s], c * kAtom,
                 (stage0 + it) * kLseCols, 0, 0);
    }
    return;
  }

  // consumer warpgroup wg: hidden rows row0 + 64 wg + [0, 64). Each stage's
  // product is waited for, the stage released and its logits folded; the
  // other warpgroup's product runs on the tensor cores meanwhile.
  setmaxnreg_inc<Smem::kConsumerRegs>();
  const int wg = warp / 4;
  const int r = (warp % 4) * 16 + lane / 4;  // this thread's rows: r, r + 8
  const int col0 = (lane % 4) * 2;
  // this thread's running max (the TPU kernel's initial -1e30) and sum
  float m[2] = {kNegBig, kNegBig}, l[2] = {0.f, 0.f};
  float sc[kLseCols / 2];

  mbar_wait(&sm.h_full, 0);
  for (int it = 0; it < n_stages; ++it) {
    const int s = it % kStages;
    mbar_wait(&sm.full[s], (it / kStages) & 1);
    wgmma_fence();
    start_lse_scores<kD, T>(sc, sm, s, wg);
    wgmma_commit();
    wgmma_wait<0>();
    pin(sc);
    release_stage(&sm.empty[s], lane);
    fold_scores(sc, (stage0 + it) * kLseCols, args.c, col0, m, l);
  }

  // the four lanes of a row merge their (m, l)
  const int row = row0 + wg * 64 + r;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    float sum = l[h] * exp2_ftz((m[h] - mx) * kLog2e);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int i = row + 8 * h;
    if (lane % 4 != 0 || i >= args.n) continue;
    if (args.splits == 1) {
      args.out[i] = logf(fmaxf(sum, 1e-30f)) + mx;
    } else {
      float* part = args.out + ((long long)split * args.n + i) * 2;
      part[0] = mx;
      part[1] = sum;
    }
  }
}

// merge the splits' partial (m, l) of each row: part [splits, N, 2]
__global__ void lse_combine_kernel(const float* __restrict__ part,
                                   float* __restrict__ out, int n, int splits) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  float mx = kNegBig;
  for (int s = 0; s < splits; ++s)
    mx = fmaxf(mx, part[((long long)s * n + row) * 2]);
  float sum = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float* pr = part + ((long long)s * n + row) * 2;
    sum += pr[1] * expf(pr[0] - mx);
  }
  out[row] = logf(fmaxf(sum, 1e-30f)) + mx;
}

// -- launches -----------------------------------------------------------------

struct Plan {
  int kd;          // the wgmma kernel's D (64, 128, 256), or 0: CUDA cores
  int splits;      // ranges of C, each a whole number of stages
  int stages_per;  // stages in each range but perhaps the last
};

// dtype 0 = float32, 1 = float16, 2 = bfloat16
Plan make_plan(int n, int c, int d, int dtype) {
  Plan plan = {0, 1, 0};
  if (dtype == 0 || d % 16 != 0 || d > kMaxWgmmaDim) return plan;
  plan.kd = d <= 64 ? 64 : d <= 128 ? 128 : 256;
  const int stages = (c + kLseCols - 1) / kLseCols;
  const int tiles = (n + kLseRows - 1) / kLseRows;
  int splits = (kTargetCtas + tiles - 1) / tiles;
  splits = std::max(1, std::min(splits, stages / kMinSplitStages));
  plan.stages_per = (stages + splits - 1) / splits;
  plan.splits = (stages + plan.stages_per - 1) / plan.stages_per;
  return plan;
}

template <typename T>
cudaError_t launch_cuda_core(const void* hidden, const void* emb, float* out,
                             int n, int c, int d, cudaStream_t stream) {
  const int dp = (d + 3) / 4 * 4;
  const size_t smem = smem_bytes(dp);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      lse_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((n + kBlockN - 1) / kBlockN));
  lse_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(hidden), static_cast<const T*>(emb), out, n, c, d,
      dp);
  return cudaGetLastError();
}

template <int kD, typename T>
cudaError_t launch_wgmma(const void* hidden, const void* emb, float* out,
                         float* scratch, int n, int c, int d, const Plan& plan,
                         cudaStream_t stream) {
  if (plan.splits > 1 && scratch == nullptr) return cudaErrorInvalidValue;
  LseArgs args;
  memset(&args, 0, sizeof(args));
  cudaError_t err = make_map<T>(&args.h, hidden, d, n, 1, 1, d, 0, 0, kLseRows);
  if (err == cudaSuccess)
    err = make_map<T>(&args.e, emb, d, c, 1, 1, d, 0, 0, kLseCols);
  if (err != cudaSuccess) return err;
  args.out = plan.splits > 1 ? scratch : out;
  args.n = n;
  args.c = c;
  args.splits = plan.splits;
  args.stages_per = plan.stages_per;
  const long long tiles = (n + kLseRows - 1) / kLseRows;
  err = launch_grid(lse_wgmma_kernel<kD, T>, tiles * plan.splits,
                    LseSmem<kD>::kThreads, sizeof(LseSmem<kD>) + 1024, stream, args);
  if (err != cudaSuccess || plan.splits == 1) return err;
  lse_combine_kernel<<<(n + 255) / 256, 256, 0, stream>>>(scratch, out, n,
                                                          plan.splits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(const void* hidden, const void* emb, float* out,
                     float* scratch, int n, int c, int d, const Plan& plan,
                     cudaStream_t stream) {
  if constexpr (!std::is_same<T, float>::value) {
    switch (plan.kd) {
      case 64: return launch_wgmma<64, T>(hidden, emb, out, scratch, n, c, d, plan, stream);
      case 128: return launch_wgmma<128, T>(hidden, emb, out, scratch, n, c, d, plan, stream);
      case 256: return launch_wgmma<256, T>(hidden, emb, out, scratch, n, c, d, plan, stream);
      default: break;
    }
  }
  return launch_cuda_core<T>(hidden, emb, out, n, c, d, stream);
}

int max_dim() {
  int dp = 4;
  while (smem_bytes(dp + 4) <= kMaxSmem) dp += 4;
  return dp;
}

bool valid(int n, int c, int d, int dtype) {
  return n >= 1 && c >= 1 && d >= 1 && d <= max_dim() && dtype >= 0 && dtype <= 2;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = float16, 2 = bfloat16 (both operands the same).
// `scratch` is fp32 [splits, N, 2] (`dm_candidate_lse_splits`), or NULL
// where the variant takes no split. Returns a cudaError_t code; 0 means the
// launch was accepted.
int dm_candidate_lse_split(const void* hidden, const void* emb, void* out,
                           void* scratch, int n, int c, int d, int dtype,
                           void* stream) {
  if (!valid(n, c, d, dtype)) return (int)cudaErrorInvalidValue;
  const Plan plan = make_plan(n, c, d, dtype);
  float* o = static_cast<float*>(out);
  float* sc = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_t<float>(hidden, emb, o, sc, n, c, d, plan, s);
    case 1: return (int)launch_t<__half>(hidden, emb, o, sc, n, c, d, plan, s);
    default: return (int)launch_t<__nv_bfloat16>(hidden, emb, o, sc, n, c, d, plan, s);
  }
}

// Every variant that takes no split (`dm_candidate_lse_splits` gives 1).
int dm_candidate_lse(const void* hidden, const void* emb, void* out, int n,
                     int c, int d, int dtype, void* stream) {
  return dm_candidate_lse_split(hidden, emb, out, nullptr, n, c, d, dtype, stream);
}

// The number of ranges a launch splits C into (1: no scratch); 0 for
// arguments no launch accepts.
int dm_candidate_lse_splits(int n, int c, int d, int dtype) {
  return valid(n, c, d, dtype) ? make_plan(n, c, d, dtype).splits : 0;
}

// The kernel variant a launch takes: "cuda_core" or
// "wgmma_tma_d{64,128,256}_split{S}"; "" for arguments no launch accepts.
const char* dm_candidate_lse_variant(int n, int c, int d, int dtype) {
  static thread_local char name[48];
  if (!valid(n, c, d, dtype)) return "";
  const Plan plan = make_plan(n, c, d, dtype);
  if (plan.kd == 0) return "cuda_core";
  snprintf(name, sizeof(name), "wgmma_tma_d%d_split%d", plan.kd, plan.splits);
  return name;
}

// Largest D any variant takes (the CUDA-core kernel's shared-memory plan).
int dm_candidate_lse_max_dim(void) { return max_dim(); }

const char* dm_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
