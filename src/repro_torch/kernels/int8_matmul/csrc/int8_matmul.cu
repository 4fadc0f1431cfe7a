// Weight-only int8 GEMM for Hopper (sm_90a), written by hand in CUDA C++.
//
// Replaces the Pallas TPU kernel `_int8_mm_kernel` in
// src/repro/kernels/int8_matmul/kernel.py:18 (wrapper `int8_matmul` :37,
// `pl.pallas_call` :45), and computes what it computes:
//   out = ((x.f32 @ wq.f32) * scales.f32).astype(x.dtype)
// x (M,K) fp32 or bf16 with a unit column stride, wq (K,N) int8 contiguous,
// scales (N,) fp32, out (M,N) contiguous in x's type. Products and sums are
// fp32 on the CUDA cores (no TF32); the per-output-channel scale is applied
// once, after the last K tile, as the Pallas kernel does at its last K step.
//
// What bounds it on the H100. At stablelm-1.6b's MLP up-projection (K =
// 2048, N = 5632) a 4-row decode step moves 11.6 MB, nearly all of it the
// int8 weights (11.5 MB): 0.0035 ms at 3.35 TB/s, a bytes-bound GEMV. The
// 2 x 2048-token prefill wave (M = 4096) does 9.45e10 flop: 0.0955 ms on the
// bf16 tensor cores at 989 TFLOP/s, operations-bound.
//
// What this first design does about it. It is the simple, correct first
// step, not yet a fast one:
//   - One block of 256 threads per 64 x 64 output tile; each thread keeps a
//     4 x 4 fp32 accumulator in registers.
//   - The K axis is the block's own loop (the Pallas grid's innermost,
//     sequential axis) in tiles of 32: each tile of x (64 x 32) and of wq
//     (32 x 64) is staged through shared memory, the int8 values widened to
//     fp32 on the way in. The tile's products are summed into a per-tile
//     partial and the partial into the accumulator, as the Pallas kernel
//     adds one tile's dot into its VMEM accumulator: the running sum sees
//     K / 32 additions, not K, which keeps fp32 rounding small at K = 2048.
//   - Any M, N and K work: rows, columns and K steps past the edge are
//     masked (read as zero, never written). The Pallas wrapper asserts that
//     its blocks divide M, N and K.
//   - Loads of x are coalesced along K and loads of wq along N, one element
//     a thread; no cp.async, TMA or tensor cores yet.
// What a later speed PR can use: an int8 value of magnitude <= 127 widens
// exactly to bf16, so the bf16 path can feed `mma.sync`/`wgmma` with bf16
// operands and fp32 accumulation and still compute the same function. A
// decode-sized M (<= 16) is a GEMV that should read the weights at 1 byte an
// element with many blocks along N and a split of K, not 64-row tiles.
// The kernel launches on the caller's stream, allocates nothing and does not
// synchronize; the C entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;   // output rows a block
constexpr int BN = 64;   // output columns a block
constexpr int BK = 32;   // K steps a staged tile
constexpr int TM = 4;    // rows a thread
constexpr int TN = 4;    // columns a thread
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256

template <typename T> __device__ __forceinline__ float to_float(T x);
template <> __device__ __forceinline__ float to_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_float<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) int8_matmul_kernel(
    const T* __restrict__ x, const int8_t* __restrict__ wq,
    const float* __restrict__ scales, T* __restrict__ out, int M, int N,
    int K, int64_t ldx) {
  // x tile stored k-major so a thread reads its TM rows of one k together;
  // +1 pads the rows apart in the banks for the transposing store.
  __shared__ float xs[BK][BM + 1];
  __shared__ float ws[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);   // column group
  const int ty = tid / (BN / TN);   // row group
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();  // every thread is done with the previous tile
#pragma unroll
    for (int r = 0; r < BM * BK / THREADS; ++r) {
      const int idx = tid + r * THREADS;
      const int m = idx / BK, k = idx % BK;
      const int gm = row0 + m, gk = k0 + k;
      xs[k][m] = (gm < M && gk < K) ? to_float(x[int64_t(gm) * ldx + gk])
                                    : 0.f;
    }
#pragma unroll
    for (int r = 0; r < BK * BN / THREADS; ++r) {
      const int idx = tid + r * THREADS;
      const int k = idx / BN, n = idx % BN;
      const int gk = k0 + k, gn = col0 + n;
      ws[k][n] = (gk < K && gn < N) ? float(wq[int64_t(gk) * N + gn]) : 0.f;
    }
    __syncthreads();

    float part[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) part[i][j] = 0.f;
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[k][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ws[k][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) part[i][j] = fmaf(a[i], b[j], part[i][j]);
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] += part[i][j];
  }

#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int gn = col0 + tx * TN + j;
    if (gn >= N) continue;
    const float s = scales[gn];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int gm = row0 + ty * TM + i;
      if (gm < M) out[int64_t(gm) * N + gn] = from_float<T>(acc[i][j] * s);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const int8_t* wq, const float* scales,
                   void* out, int M, int N, int K, int64_t ldx,
                   cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  int8_matmul_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), wq, scales, static_cast<T*>(out), M, N, K,
      ldx);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: type of x and out (0 = float32, 1 = bfloat16). wq (K,N) int8 and
// scales (N,) float32 are contiguous, out (M,N) contiguous; ldx is x's row
// stride in elements (its column stride is 1). Returns cudaGetLastError()
// after the launch (0 on success).
int repro_int8_matmul(int dtype, const void* x, const int8_t* wq,
                      const float* scales, void* out, int M, int N, int K,
                      int64_t ldx, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return int(launch<float>(x, wq, scales, out, M, N, K, ldx, s));
  if (dtype == 1)
    return int(launch<__nv_bfloat16>(x, wq, scales, out, M, N, K, ldx, s));
  return int(cudaErrorInvalidValue);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
