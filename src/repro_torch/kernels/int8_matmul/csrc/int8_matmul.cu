// Weight-only int8 GEMM for Hopper (sm_90a), written by hand in CUDA C++.
//
// Replaces the Pallas TPU kernel `_int8_mm_kernel` in
// src/repro/kernels/int8_matmul/kernel.py:18 (wrapper `int8_matmul` :37,
// `pl.pallas_call` :45), and computes what it computes:
//   out = ((x.f32 @ wq.f32) * scales.f32).astype(x.dtype)
// x (M,K) fp32 or bf16 with a unit column stride, wq (K,N) int8 contiguous,
// scales (N,) fp32, out (M,N) contiguous in x's type. Products and sums are
// fp32 (no TF32); the per-output-channel scale is applied once, after the
// whole K sum, as the Pallas kernel does at its last K step.
//
// What bounds it on the H100. At stablelm-1.6b's MLP up-projection (K =
// 2048, N = 5632) a 4-row decode step moves 11.6 MB, nearly all of it the
// int8 weights (11.5 MB): 0.0035 ms at 3.35 TB/s, a bytes-bound GEMV. The
// 2 x 2048-token prefill wave (M = 4096) does 9.45e10 flop: 0.0955 ms on the
// bf16 tensor cores at 989 TFLOP/s, operations-bound.
//
// Three paths; the wrapper's `_plan(m, n, k, dtype)` picks one and its
// launch parameters. Each takes any M, N and K and masks ragged edges.
//
// 1. bf16, M > 16: `int8_mma_kernel`, a tensor-core GEMM. An int8 value
//    with |v| <= 127 widens to bf16 exactly and bf16 x bf16 products are
//    exact in fp32, so mma.sync.m16n8k16 bf16 with fp32 accumulation
//    computes the Pallas kernel's function. 128 x 128 x 64 tiles over 8
//    warps (each 64 x 32), a ring of 3 cp.async stages (x as bf16 rows
//    padded by 16 bytes, wq as int8 rows), the int8 stage widened once per
//    tile into a bf16 tile that ldmatrix.x4.trans reads as the .col
//    operand. Operands whose rows are not 16-byte aligned are staged
//    element by element instead of by cp.async.
// 2. M <= 16, fp32 and bf16: `int8_gemv_kernel`, a split-K GEMV bound by
//    the weight bytes. A block covers 32 x CPT columns and one K slice;
//    each thread reads CPT contiguous weight bytes of a row (16 at M <= 4)
//    in one load, 4 rows in flight, x's slice staged in shared memory as
//    fp32. Products and sums are fp32 FMAs on the CUDA cores (exact
//    products for both types). The 8 warps of a block split the slice's
//    rows and fold in a fixed tree; each split writes its fp32 partial to
//    a workspace, and the last block of a column slab to finish (a counter
//    a slab) sums the slab's splits in order (results repeat), scales and
//    casts: one launch. The split puts at least 2 blocks on each of the
//    132 SMs.
// 3. fp32, M > 16: `int8_matmul_kernel`, the first design, unchanged. fp32
//    x has no exact bf16 form and TF32 would fail the fp32 gate, so it
//    stays on fp32 CUDA-core FMAs in 64 x 64 tiles: each 32-step K tile is
//    summed into a partial and the partial into the accumulator, as the
//    Pallas kernel adds one tile's dot into its VMEM accumulator, which
//    keeps fp32 rounding small at K = 2048.
// wgmma and TMA for path 1 are later work. Each kernel launches on the
// caller's stream, allocates nothing and does not synchronize; each C entry
// point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_mma.cuh"

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


// ------------------------------------ path 1: bf16 on the tensor cores

namespace mma {

using bf16 = __nv_bfloat16;
constexpr int WARPS_M = 2, WARPS_N = 4;
constexpr int THREADS = 32 * WARPS_M * WARPS_N;
constexpr int BM = 128, BN = 128, BK = 64, STAGES = 3;
constexpr int WTM = BM / WARPS_M, WTN = BN / WARPS_N;   // a warp's tile
constexpr int MI = WTM / 16;   // m16-tiles of a warp
constexpr int NJ = WTN / 8;    // n8-tiles of a warp
constexpr int XLD = BK + 8;    // bf16 row stride of an x stage: +16 bytes
constexpr int WLD = BN + 8;    // bf16 row stride of the widened wq tile
constexpr int X_STAGE = BM * XLD;   // bf16 elements
constexpr int W8_STAGE = BK * BN;   // int8 elements
constexpr int WB_TILE = BK * WLD;   // bf16 elements
constexpr size_t SMEM_BYTES = sizeof(bf16) * STAGES * X_STAGE +
                              STAGES * W8_STAGE + sizeof(bf16) * WB_TILE;

struct Args {
  const bf16* x;
  const int8_t* wq;
  const float* scales;
  bf16* out;
  int M, N, K;
  int64_t ldx;
  int vec_x, vec_w;   // rows 16-byte aligned: cp.async, else element-wise
};

// x rows m0.., columns k0.. (BM x BK) and wq rows k0.., columns n0..
// (BK x BN) into one ring stage; out-of-range elements read as zero.
__device__ __forceinline__ void load_stage(const Args& a, bf16* xs,
                                           int8_t* ws, int m0, int n0,
                                           int k0, int tid) {
#pragma unroll
  for (int i = 0; i < BM * BK / 8 / THREADS; ++i) {   // chunks of 8 bf16
    const int e = tid + i * THREADS;
    const int r = e / (BK / 8), c = (e % (BK / 8)) * 8;
    const int gm = m0 + r, gk = k0 + c;
    bf16* dst = xs + r * XLD + c;
    const bf16* src = a.x + int64_t(gm) * a.ldx + gk;
    if (a.vec_x) {
      const bool in = gm < a.M && gk < a.K;   // K % 8 == 0: all or nothing
      repro_ptx::cp_async_16(dst, in ? src : a.x, in);
    } else {
      __align__(16) bf16 v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v[j] = (gm < a.M && gk + j < a.K) ? src[j] : __float2bfloat16(0.f);
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
    }
  }
#pragma unroll
  for (int i = 0; i < BK * BN / 16 / THREADS; ++i) {  // chunks of 16 int8
    const int e = tid + i * THREADS;
    const int r = e / (BN / 16), c = (e % (BN / 16)) * 16;
    const int gk = k0 + r, gn = n0 + c;
    int8_t* dst = ws + r * BN + c;
    const int8_t* src = a.wq + int64_t(gk) * a.N + gn;
    if (a.vec_w) {
      const bool in = gk < a.K && gn < a.N;   // N % 16 == 0: all or nothing
      repro_ptx::cp_async_16(dst, in ? src : a.wq, in);
    } else {
      __align__(16) int8_t v[16];
#pragma unroll
      for (int j = 0; j < 16; ++j)
        v[j] = (gk < a.K && gn + j < a.N) ? src[j] : int8_t(0);
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
    }
  }
}

__global__ void __launch_bounds__(THREADS) int8_mma_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);                 // STAGES
  int8_t* w8 = reinterpret_cast<int8_t*>(xs + STAGES * X_STAGE);  // STAGES
  bf16* wb = reinterpret_cast<bf16*>(w8 + STAGES * W8_STAGE);   // 1

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / WARPS_N;
  const int wn = warp % WARPS_N;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int nk = (a.K + BK - 1) / BK;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk)
      load_stage(a, xs + s * X_STAGE, w8 + s * W8_STAGE, m0, n0, s * BK, tid);
    repro_ptx::cp_async_commit();
  }

  float acc[MI][NJ][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt % STAGES;
    repro_ptx::cp_async_wait<STAGES - 2>();   // stage kt has landed
    __syncthreads();
    // widen this stage's int8 tile to bf16, 16 bytes a copy. wb is free:
    // every warp passed the barrier above after its products of tile kt-1.
#pragma unroll
    for (int i = 0; i < BK * BN / 16 / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / (BN / 16), c = (e % (BN / 16)) * 16;
      const uint4 q = *reinterpret_cast<const uint4*>(
          w8 + st * W8_STAGE + r * BN + c);
      uint4 lo, hi;
      repro_ptx::int8x4_to_bf16x4(q.x, lo.x, lo.y);
      repro_ptx::int8x4_to_bf16x4(q.y, lo.z, lo.w);
      repro_ptx::int8x4_to_bf16x4(q.z, hi.x, hi.y);
      repro_ptx::int8x4_to_bf16x4(q.w, hi.z, hi.w);
      bf16* dst = wb + r * WLD + c;
      *reinterpret_cast<uint4*>(dst) = lo;
      *reinterpret_cast<uint4*>(dst + 8) = hi;
    }
    __syncthreads();
    {  // refill the stage read in tile kt - 1
      const int next = kt + STAGES - 1;
      if (next < nk)
        load_stage(a, xs + (next % STAGES) * X_STAGE,
                   w8 + (next % STAGES) * W8_STAGE, m0, n0, next * BK, tid);
      repro_ptx::cp_async_commit();
    }

    const bf16* xt = xs + st * X_STAGE + wm * WTM * XLD;
    const bf16* wt = wb + wn * WTN;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t af[MI][4], bfr[NJ][2];
#pragma unroll
      for (int i = 0; i < MI; ++i)
        repro_ptx::ldmatrix_x4(af[i], xt + (i * 16 + (lane & 15)) * XLD +
                                          kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < NJ / 2; ++np) {
        uint32_t r[4];
        repro_ptx::ldmatrix_x4_trans(
            r, wt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * WLD +
                   np * 16 + (lane >> 4) * 8);
        bfr[2 * np][0] = r[0];
        bfr[2 * np][1] = r[1];
        bfr[2 * np + 1][0] = r[2];
        bfr[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          repro_ptx::mma_bf16_16816(acc[i][j], af[i], bfr[j][0], bfr[j][1]);
    }
  }
  repro_ptx::cp_async_wait<0>();

  // out = acc * scale in bf16; pairs of columns where N is even
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int col = n0 + wn * WTN + j * 8 + 2 * t;
    if (col >= a.N) continue;
    const bool pair = col + 1 < a.N;
    const float s0 = a.scales[col];
    const float s1 = pair ? a.scales[col + 1] : 0.f;
#pragma unroll
    for (int i = 0; i < MI; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * WTM + i * 16 + g + 8 * h;
        if (row >= a.M) continue;
        bf16* dst = a.out + int64_t(row) * a.N + col;
        const float v0 = acc[i][j][2 * h] * s0;
        const float v1 = acc[i][j][2 * h + 1] * s1;
        if (pair && (a.N % 2 == 0)) {
          *reinterpret_cast<__nv_bfloat162*>(dst) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          dst[0] = __float2bfloat16_rn(v0);
          if (pair) dst[1] = __float2bfloat16_rn(v1);
        }
      }
    }
  }
}

cudaError_t launch(const Args& a, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      int8_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(SMEM_BYTES));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((a.N + BN - 1) / BN, (a.M + BM - 1) / BM);
  int8_mma_kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace mma

// ------------------------------------ path 2: the split-K GEMV, M <= 16

namespace gemv {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS_IN_FLIGHT = 4;   // weight loads a thread keeps in flight

struct Args {
  const void* x;
  const int8_t* wq;
  const float* scales;
  float* ws;      // (splits, M, N) fp32 partials
  int* counters;  // one a column slab, 0 between calls
  void* out;
  int M, N, K;
  int64_t ldx;
  int kps;        // K rows a split; the last split takes the rest
  int splits;
  int vec_w;      // rows of wq aligned for CPT-byte loads
};

template <int CPT> struct Bytes;
template <> struct Bytes<4> {
  using type = uint32_t;
};
template <> struct Bytes<8> {
  using type = uint2;
};
template <> struct Bytes<16> {
  using type = uint4;
};

// CPT weight bytes of row k from column n, zero past N.
template <int CPT>
__device__ __forceinline__ void load_w(const Args& a, int k, int n,
                                       uint32_t (&w)[CPT / 4]) {
  const int8_t* src = a.wq + int64_t(k) * a.N + n;
  if (a.vec_w && n + CPT <= a.N) {
    using V = typename Bytes<CPT>::type;
    const V v = __ldg(reinterpret_cast<const V*>(src));
    const uint32_t* u = reinterpret_cast<const uint32_t*>(&v);
#pragma unroll
    for (int i = 0; i < CPT / 4; ++i) w[i] = u[i];
  } else {
#pragma unroll
    for (int i = 0; i < CPT / 4; ++i) {
      uint32_t word = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 4 * i + j;
        const uint32_t byte = n + c < a.N ? uint8_t(src[c]) : 0u;
        word |= byte << (8 * j);
      }
      w[i] = word;
    }
  }
}

// One block: columns [n0, n0 + 32 CPT) over K rows [k_begin, k_end) of
// split blockIdx.y. Writes the split's fp32 partial (M x columns); the last
// block of a column slab to finish sums the slab's partials in split order
// (no atomics on the data: results repeat), scales and casts.
template <typename T, int MT, int CPT>
__global__ void __launch_bounds__(THREADS) int8_gemv_kernel(Args a) {
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int n = blockIdx.x * (32 * CPT) + lane * CPT;
  const int k_begin = blockIdx.y * a.kps;
  const int k_len = min(a.kps, a.K - k_begin);

  // x's slice as fp32, k-major: xs[kr * MT + m]; rows past M are zero
  float* xs = sm;
  const T* x = static_cast<const T*>(a.x);
  for (int e = tid; e < MT * k_len; e += THREADS) {
    const int m = e / k_len, kr = e % k_len;
    xs[kr * MT + m] =
        m < a.M ? to_float(x[int64_t(m) * a.ldx + k_begin + kr]) : 0.f;
  }
  __syncthreads();

  float acc[MT][CPT];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[m][c] = 0.f;

  // warp w takes rows w, w + 8, ... of the slice, in order
  for (int kb = warp; kb < k_len; kb += WARPS * ROWS_IN_FLIGHT) {
    uint32_t w[ROWS_IN_FLIGHT][CPT / 4];
#pragma unroll
    for (int u = 0; u < ROWS_IN_FLIGHT; ++u) {
      const int kr = kb + u * WARPS;
      if (kr < k_len) load_w<CPT>(a, k_begin + kr, n, w[u]);
    }
#pragma unroll
    for (int u = 0; u < ROWS_IN_FLIGHT; ++u) {
      const int kr = kb + u * WARPS;
      if (kr >= k_len) break;
      float xv[MT];
#pragma unroll
      for (int m = 0; m < MT; ++m) xv[m] = xs[kr * MT + m];
#pragma unroll
      for (int i = 0; i < CPT / 4; ++i) {
        const uint32_t biased = w[u][i] ^ 0x80808080u;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float wf = repro_ptx::int8_byte_to_float(biased, j);
#pragma unroll
          for (int m = 0; m < MT; ++m)
            acc[m][4 * i + j] = fmaf(xv[m], wf, acc[m][4 * i + j]);
        }
      }
    }
  }

  // fold the 8 warps in a fixed tree: (0+4, 1+5, 2+6, 3+7), then (0+2,
  // 1+3), then 0+1; the slots reuse x's shared memory
  constexpr int PER_LANE = MT * CPT;
  __syncthreads();
  float* red = sm;   // [4 slots][PER_LANE][32]
#pragma unroll
  for (int half = WARPS / 2; half >= 1; half /= 2) {
    if (warp >= half && warp < 2 * half) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int c = 0; c < CPT; ++c)
          red[((warp - half) * PER_LANE + m * CPT + c) * 32 + lane] =
              acc[m][c];
    }
    __syncthreads();
    if (warp < half) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int c = 0; c < CPT; ++c)
          acc[m][c] += red[(warp * PER_LANE + m * CPT + c) * 32 + lane];
    }
    __syncthreads();
  }
  const int64_t mn = int64_t(a.M) * a.N;
  if (warp == 0) {
    float* dst = a.ws + blockIdx.y * mn;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m >= a.M) break;
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        if (n + c < a.N) dst[int64_t(m) * a.N + n + c] = acc[m][c];
    }
    __threadfence();   // the partial is visible before the count says so
  }
  __shared__ int last;
  __syncthreads();
  if (tid == 0) last = atomicAdd(a.counters + blockIdx.x, 1) == a.splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  constexpr int NB = 32 * CPT;
  constexpr int IN_FLIGHT = 8;   // splits' loads a thread keeps in flight
  const int n0 = blockIdx.x * NB;
  T* out = static_cast<T*>(a.out);
  if (a.N % 4 == 0) {   // 4 columns a thread, 16-byte loads
    const float4* ws4 = reinterpret_cast<const float4*>(a.ws);
    const int64_t mn4 = mn / 4;
    for (int e = tid; e < a.M * (NB / 4); e += THREADS) {
      const int m = e / (NB / 4), col = n0 + (e % (NB / 4)) * 4;
      if (col >= a.N) continue;
      const float4* p = ws4 + (int64_t(m) * a.N + col) / 4;
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int s0 = 0; s0 < a.splits; s0 += IN_FLIGHT) {
        float4 v[IN_FLIGHT];
#pragma unroll
        for (int u = 0; u < IN_FLIGHT; ++u)
          v[u] = s0 + u < a.splits ? __ldcg(p + (s0 + u) * mn4)
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int u = 0; u < IN_FLIGHT; ++u) {   // in split order
          sum.x += v[u].x;
          sum.y += v[u].y;
          sum.z += v[u].z;
          sum.w += v[u].w;
        }
      }
      T* dst = out + int64_t(m) * a.N + col;
      dst[0] = from_float<T>(sum.x * a.scales[col]);
      dst[1] = from_float<T>(sum.y * a.scales[col + 1]);
      dst[2] = from_float<T>(sum.z * a.scales[col + 2]);
      dst[3] = from_float<T>(sum.w * a.scales[col + 3]);
    }
  } else {
    for (int e = tid; e < a.M * NB; e += THREADS) {
      const int m = e / NB, col = n0 + e % NB;
      if (col >= a.N) continue;
      const float* p = a.ws + int64_t(m) * a.N + col;
      float sum = 0.f;
      for (int s0 = 0; s0 < a.splits; s0 += IN_FLIGHT) {
        float v[IN_FLIGHT];
#pragma unroll
        for (int u = 0; u < IN_FLIGHT; ++u)
          v[u] = s0 + u < a.splits ? __ldcg(p + (s0 + u) * mn) : 0.f;
#pragma unroll
        for (int u = 0; u < IN_FLIGHT; ++u) sum += v[u];   // in split order
      }
      out[int64_t(m) * a.N + col] = from_float<T>(sum * a.scales[col]);
    }
  }
  if (tid == 0) a.counters[blockIdx.x] = 0;   // ready for the next call
}

template <typename T, int MT, int CPT>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  // x's slice and the fold's 4 slots share the dynamic shared memory
  const size_t slice = size_t(a.kps) * MT;
  const size_t slots = size_t(WARPS / 2) * MT * CPT * 32;
  const size_t smem = sizeof(float) * (slice > slots ? slice : slots);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  const dim3 grid((a.N + 32 * CPT - 1) / (32 * CPT), a.splits);
  int8_gemv_kernel<T, MT, CPT><<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

// (MT, CPT): rows padded to MT, CPT columns a thread; MT x CPT <= 64
// accumulators a thread.
template <typename T>
cudaError_t dispatch(const Args& a, int mt, int cpt, cudaStream_t stream) {
  if (mt == 1 && cpt == 16) return launch<T, 1, 16>(a, stream);
  if (mt == 2 && cpt == 16) return launch<T, 2, 16>(a, stream);
  if (mt == 4 && cpt == 16) return launch<T, 4, 16>(a, stream);
  if (mt == 8 && cpt == 8) return launch<T, 8, 8>(a, stream);
  if (mt == 16 && cpt == 4) return launch<T, 16, 4>(a, stream);
  return cudaErrorInvalidValue;
}

}  // namespace gemv

}  // namespace

extern "C" {

// All entry points: wq (K,N) int8 and scales (N,) float32 are contiguous,
// out (M,N) contiguous; ldx is x's row stride in elements (its column
// stride is 1). Each returns cudaGetLastError() after its launches (0 on
// success).
//
// Path 3, fp32 x and out at M > 16 (bf16 takes path 1 or 2). dtype: type
// of x and out, 0 = float32.
int repro_int8_matmul(int dtype, const void* x, const int8_t* wq,
                      const float* scales, void* out, int M, int N, int K,
                      int64_t ldx, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return int(launch<float>(x, wq, scales, out, M, N, K, ldx, s));
  return int(cudaErrorInvalidValue);
}

// Path 1, bf16 x and out. vec_x: x's rows 16-byte aligned and K % 8 == 0;
// vec_w: N % 16 == 0 and wq 16-byte aligned (else element-wise staging).
int repro_int8_matmul_mma(const void* x, const int8_t* wq,
                          const float* scales, void* out, int M, int N, int K,
                          int64_t ldx, int vec_x, int vec_w, void* stream) {
  const mma::Args a{static_cast<const __nv_bfloat16*>(x), wq, scales,
                    static_cast<__nv_bfloat16*>(out), M, N, K, ldx, vec_x,
                    vec_w};
  return int(mma::launch(a, static_cast<cudaStream_t>(stream)));
}

// Path 2, M <= mt. ws: (splits, M, N) fp32 scratch; counters: one int a
// column slab (ceil(N / (32 cpt))), zero, and left zero; split s covers K
// rows [s kps, min(K, (s + 1) kps)). vec_w: N % cpt == 0 and wq 16-byte
// aligned. Calls that share ws and counters must share a stream.
int repro_int8_gemv(int dtype, const void* x, const int8_t* wq,
                    const float* scales, float* ws, int* counters, void* out,
                    int M, int N, int K, int64_t ldx, int mt, int cpt,
                    int kps, int splits, int vec_w, void* stream) {
  const gemv::Args a{x, wq, scales, ws, counters, out, M, N, K, ldx, kps,
                     splits, vec_w};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return int(gemv::dispatch<float>(a, mt, cpt, s));
  if (dtype == 1) return int(gemv::dispatch<__nv_bfloat16>(a, mt, cpt, s));
  return int(cudaErrorInvalidValue);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
