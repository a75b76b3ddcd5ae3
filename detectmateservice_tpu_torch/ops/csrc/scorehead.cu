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
// arithmetic. This first version computes the dot products on CUDA cores in
// fp32 (the tensor cores, wgmma and TMA are left for a later version), so it
// runs against the fp32 CUDA-core rate, not the bf16 tensor-core peak.
//
// Design. The TPU kernel walks C sequentially inside one core; here each CTA
// owns kBlockN rows and loops over all of C itself, so no state crosses
// CTAs and no second pass is needed:
//   1. the CTA's hidden rows are converted to fp32 into shared memory once;
//   2. for each kBlockC-column tile of emb: stage it (fp32) in shared
//      memory, each of the 256 threads computes a 4x4 block of dot products
//      with float4 shared-memory reads, the 64x64 score tile goes to shared
//      memory;
//   3. four lanes per row reduce the tile to its max and sum of exp and
//      fold it into the row's running (max, sum) held in registers.
// Tail columns (c >= C) are never read; tail rows (n >= N) are zero-filled
// and not written.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockN = 64;   // rows per CTA
constexpr int kBlockC = 64;   // emb rows (columns of the logits) per tile
constexpr int kThreads = 256; // 16 x 16 threads, each a 4 x 4 micro-tile
constexpr int kTileLd = kBlockC + 1;  // padded stride of the score tile
constexpr float kNegBig = -1e30f;
constexpr size_t kMaxSmem = 232448;  // opt-in shared memory per block

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

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

template <typename T>
cudaError_t launch(const void* hidden, const void* emb, float* out, int n,
                   int c, int d, cudaStream_t stream) {
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

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = float16, 2 = bfloat16 (both operands the same).
// Returns a cudaError_t code; 0 means the launch was accepted.
int dm_candidate_lse(const void* hidden, const void* emb, void* out, int n,
                     int c, int d, int dtype, void* stream) {
  if (n < 1 || c < 1 || d < 1) return (int)cudaErrorInvalidValue;
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch<float>(hidden, emb, o, n, c, d, s);
    case 1: return (int)launch<__half>(hidden, emb, o, n, c, d, s);
    case 2: return (int)launch<__nv_bfloat16>(hidden, emb, o, n, c, d, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Largest D the kernel's shared-memory plan admits.
int dm_candidate_lse_max_dim(void) {
  int dp = 4;
  while (smem_bytes(dp + 4) <= kMaxSmem) dp += 4;
  return dp;
}

const char* dm_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
