// Flash attention forward for Hopper (sm_90a), written by hand in CUDA C++.
//
// Replaces the Pallas TPU kernel `_flash_kernel` in
// src/repro/kernels/flash_attention/kernel.py (wrapper `flash_attention`,
// `pl.pallas_call`), and computes what it computes:
//   out = softmax(q k^T / sqrt(hd) + mask) v
// with causal and sliding-window masks from absolute indices (masked scores
// are -1e30), GQA (q-head h reads kv-head h / (H / Hkv)), an online softmax
// whose running max m, sum l and accumulator acc are fp32, l floored at
// 1e-30, and the output in the input type (fp32 or bf16).
//
// What bounds it on the H100. At stablelm-1.6b prefill (B=2, H=32, S=2048,
// hd=64, causal, bf16) the function does about 34 GFLOP and must move about
// 67 MB: about 35 us at the 989 TFLOP/s of the bf16 tensor cores against
// about 20 us at 3.35 TB/s, so the bound is compute.
//
// What this first design does about it. It is the simple, correct first
// step, not yet a fast one:
//   - One thread block per (q-tile of 64 rows, q-head, batch). The TPU grid
//     visits every KV block and skips the masked ones under pl.when; here a
//     loop inside the block bounds the KV range of each q-tile, from
//     max(0, q_start - window + 1) up to the causal edge, so masked blocks
//     cost nothing. Causal q-tiles are launched longest first.
//   - q (pre-scaled), K and V tiles are staged in shared memory as fp32 with
//     a padded row stride (no bank conflicts on the access patterns below);
//     scores are fp32 on the CUDA cores, 4 rows x 8 columns per thread, and
//     P goes through shared memory for the P.V product. This runs at the
//     fp32 CUDA-core and shared-memory rate, far from the tensor-core bound;
//     mma.sync / wgmma, TMA and a ring of K/V stages are later work.
//   - Ragged S and T (the serve path's prompts are 8 to 64 tokens) are
//     masked in the kernel: rows past S are not stored, columns past T get
//     a score of -inf (weight exactly 0), unlike the Pallas wrapper, which
//     asserts divisibility.
//   - q, k, v and out are read and written by strides, so the model's
//     (B,S,H,hd) activations need no transpose. The last axis must be
//     contiguous.
// The kernel launches on the caller's stream, allocates nothing and does not
// synchronize; the C entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // q rows per block
constexpr int BK = 64;        // kv columns per tile
constexpr int NT = 128;       // threads per block: 16 row groups x 8 lanes
constexpr int LDP = BK + 1;   // padded row stride of the P tile
constexpr float kMaskValue = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int64_t q_sb, q_sh, q_ss;
  int64_t k_sb, k_sh, k_st;
  int64_t v_sb, v_sh, v_st;
  int64_t o_sb, o_sh, o_ss;
  int B, H, Hkv, S, T;
  int causal, window;
};

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

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t(BQ) * (HD + 1) + 2 * size_t(BK) * (HD + 1) +
                          size_t(BQ) * LDP);
}

// Thread layout: tid = ty * 8 + tx. A thread owns q rows ty*4 .. ty*4+3 of
// the tile, score columns tx + 8j (j < 8) and output channels tx + 8c
// (c < HD/8). The 8 lanes that share a row group sit in one warp, so row
// max and row sum reduce with three xor-shuffles.
template <typename T, int HD>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(Args a) {
  static_assert(HD % 32 == 0, "head_dim must be a multiple of 32");
  constexpr int LD = HD + 1;
  constexpr int NC = HD / 8;
  extern __shared__ float smem[];
  float* Qs = smem;               // BQ x LD
  float* Ks = Qs + BQ * LD;       // BK x LD
  float* Vs = Ks + BK * LD;       // BK x LD
  float* Ps = Vs + BK * LD;       // BQ x LDP

  const int nq = (a.S + BQ - 1) / BQ;
  const int q0 = (nq - 1 - int(blockIdx.x)) * BQ;  // longest causal rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (a.H / a.Hkv);
  const int tid = threadIdx.x;
  const int tx = tid & 7;
  const int ty = tid >> 3;
  const float scale = 1.0f / sqrtf(float(HD));

  const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;
  T* op = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;

  for (int e = tid; e < BQ * HD; e += NT) {
    const int r = e / HD, c = e % HD, qi = q0 + r;
    Qs[r * LD + c] = qi < a.S ? to_float(qp[qi * a.q_ss + c]) * scale : 0.f;
  }

  // KV range this q-tile can see: rows q0 .. min(q0+BQ, S)-1.
  const int q_end = min(q0 + BQ, a.S);
  const int kv_lo = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int kv_hi = a.causal ? min(a.T, q_end) : a.T;

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMaskValue;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = kv_lo; k0 < kv_hi; k0 += BK) {
    __syncthreads();  // the previous tile's K, V reads are done
    for (int e = tid; e < BK * HD; e += NT) {
      const int r = e / HD, c = e % HD, kj = k0 + r;
      const bool in = kj < a.T;
      Ks[r * LD + c] = in ? to_float(kp[kj * a.k_st + c]) : 0.f;
      Vs[r * LD + c] = in ? to_float(vp[kj * a.v_st + c]) : 0.f;
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = Ks[(tx + 8 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      float row_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kj = k0 + tx + 8 * j;
        float x = s[i][j];
        if (kj >= a.T) {
          x = -INFINITY;  // past the end of the keys: weight exactly 0
        } else {
          bool valid = true;
          if (a.causal) valid = valid && kj <= qi;
          if (a.window > 0) valid = valid && (qi - kj) < a.window;
          if (!valid) x = kMaskValue;
        }
        s[i][j] = x;
        row_max = fmaxf(row_max, x);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
      const float m_new = fmaxf(m[i], row_max);
      const float corr = expf(m[i] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(s[i][j] - m_new);
        row_sum += p;
        Ps[(ty * 4 + i) * LDP + tx + 8 * j] = p;
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      l[i] = l[i] * corr + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
    __syncwarp();  // a row group's P rows are written and read by its warp

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pv[4], vv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * LDP + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = Vs[j * LD + tx + 8 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
    __syncwarp();  // P reads are done before the next tile overwrites it
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi < a.S) {
      const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int c = 0; c < NC; ++c)
        op[qi * a.o_ss + tx + 8 * c] = from_float<T>(acc[i][c] / denom);
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  // Above 48 KB dynamic shared memory must be opted into, once per
  // instantiation.
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((a.S + BQ - 1) / BQ, a.H, a.B);
  flash_fwd_kernel<T, HD><<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_head_dim(const Args& a, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(a, stream);
    case 64: return launch<T, 64>(a, stream);
    case 128: return launch<T, 128>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements, for the
// (B, H, S|T, hd) view of each tensor; the hd axis has stride 1.
// Returns cudaGetLastError() after the launch (0 on success).
int repro_flash_attention_fwd(
    int dtype, const void* q, const void* k, const void* v, void* o,
    int B, int H, int Hkv, int S, int T, int hd,
    int64_t q_sb, int64_t q_sh, int64_t q_ss,
    int64_t k_sb, int64_t k_sh, int64_t k_st,
    int64_t v_sb, int64_t v_sh, int64_t v_st,
    int64_t o_sb, int64_t o_sh, int64_t o_ss,
    int causal, int window, void* stream) {
  Args a{q, k, v, o,
         q_sb, q_sh, q_ss, k_sb, k_sh, k_st, v_sb, v_sh, v_st,
         o_sb, o_sh, o_ss,
         B, H, Hkv, S, T, causal, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return int(dispatch_head_dim<float>(a, hd, s));
  if (dtype == 1) return int(dispatch_head_dim<__nv_bfloat16>(a, hd, s));
  return int(cudaErrorInvalidValue);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
