// Flash attention backward for Hopper (sm_90a), written by hand in CUDA C++:
// the reference's `_blockwise_bwd` (src/repro/models/attention.py:153),
// the custom VJP of `blockwise_sdpa`; the Pallas kernel
// (src/repro/kernels/flash_attention/kernel.py:27) is a forward only and has
// none. It is FlashAttention-2's backward. From q, k, v, the forward's out
// and lse and the output's gradient dO it recomputes P = exp(z - lse) a
// tile at a time and never holds a (S, T) matrix:
//   delta = rowsum(dO o out)                       (B, H, S) fp32
//   dV    = P^T dO
//   dP    = dO V^T,  dS = P o (dP - delta) [o (1 - tanh^2) under softcap]
//   dK    = dS^T q / sqrt(hd),  dQ = dS K / sqrt(hd)
// in three launches on the caller's stream:
//   1. `flash_bwd_delta_kernel`: delta, one warp a row.
//   2. dK and dV, one block per (batch, kv head, tile of keys): the block
//      loops over the G query heads of its group and over only the q-tiles
//      its keys can reach under the causal mask and the window, so GQA sums
//      its heads in registers and needs no atomics.
//   3. dQ, one block per (batch, head, q-tile) over the key tiles it reaches,
//      as the forward does.
// Here every sum has one owner and a fixed order: the result is the same
// every run. Masked entries take weight 0, as keys past T and rows past S
// do; a row whose lse is -inf (it saw no key) takes weight 0 too, not NaN.
//
// This design serves fp32 at every head_dim and bf16 at head_dim 32 (a
// 64-byte row, half a 128-byte swizzled TMA box). bf16 at 64, 128, 192 and
// 256 runs the single-pass wgmma + TMA backward of
// flash_attention_bwd_sm90.cu (`dispatch_bwd` refuses it here), whose dQ is
// a sum of fp32 reduce-adds in no fixed order: its last bits may differ
// from run to run.
//
// What bounds it: five products a score (S, dP, dV, dK, dQ) against the
// forward's two, so it is operations-bound wherever the forward is
// (`ops.bwd_cost`): fp32 against the CUDA cores' 67 TFLOP/s, bf16 at
// head_dim 32 against the tensor cores' 989.
//
// bf16 runs on the tensor cores (mma.sync m16n8k16, fp32 accumulators; P
// and dS rounded to bf16 as the operands of their products, as the forward
// rounds P); a warp owns 16 rows of its block's side (keys for dK/dV, q rows
// for dQ); only its head_dim 32 is built. fp32 runs on the CUDA cores in
// full fp32 (no TF32), q pre-scaled as the fp32 forward scales it, so that
// P there is the forward's to the last bit but for lse.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "hopper_mma.cuh"

namespace {

constexpr int kBwdThreads = 128;

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;   // (B, H, S) fp32, the forward's
  float* delta;       // (B, H, S) fp32 scratch, written by launch 1
  void* dq;
  void* dk;
  void* dv;
  int64_t q_sb, q_sh, q_ss;
  int64_t k_sb, k_sh, k_st;
  int64_t v_sb, v_sh, v_st;
  int64_t o_sb, o_sh, o_ss;
  int64_t do_sb, do_sh, do_ss;
  int64_t dq_sb, dq_sh, dq_ss;
  int64_t dk_sb, dk_sh, dk_st;
  int64_t dv_sb, dv_sh, dv_st;
  int B, H, Hkv, S, T, D;
  int causal, window;
  float softcap;
};

// Whether key kj is a valid key of query row qi under the masks (keys past
// T never are; rows past S are weighted 0 through their lse).
__device__ __forceinline__ bool key_valid(const BwdArgs& a, int qi, int kj) {
  return kj < a.T && (!a.causal || kj <= qi) &&
         (a.window <= 0 || qi - kj < a.window);
}

// The lse of row qi of a (B, H, S) row block, as the exponent subtracts it:
// rows past S and rows that saw no key (-inf) give +inf, so exp(z - lse) = 0.
__device__ __forceinline__ float row_lse(const float* lse, int qi, int S) {
  const float l = qi < S ? lse[qi] : INFINITY;
  return l == -INFINITY ? INFINITY : l;
}

// delta = rowsum(dO o out) in fp32: one warp a (b, h, s) row.
template <typename T>
__global__ void __launch_bounds__(kBwdThreads) flash_bwd_delta_kernel(
    BwdArgs a) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t row = int64_t(blockIdx.x) * (kBwdThreads / 32) + warp;
  if (row >= int64_t(a.B) * a.H * a.S) return;
  const int s = int(row % a.S);
  const int bh = int(row / a.S);
  const int h = bh % a.H, b = bh / a.H;
  const T* op = static_cast<const T*>(a.o) + b * a.o_sb + h * a.o_sh +
                s * a.o_ss;
  const T* dop = static_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh +
                 s * a.do_ss;
  float acc = 0.f;
  for (int c = lane; c < a.D; c += 32)
    acc = fmaf(to_float(op[c]), to_float(dop[c]), acc);
#pragma unroll
  for (int off = 16; off; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) a.delta[row] = acc;
}

// z and its chain factor from a scaled score u: c tanh(u / c) and 1 - tanh^2
// under softcap c > 0, else u and 1.
__device__ __forceinline__ float capped_score(float u, float cap,
                                              float& fac) {
  if (cap > 0.f) {
    const float th = tanhf(u / cap);
    fac = 1.f - th * th;
    return cap * th;
  }
  fac = 1.f;
  return u;
}

// ------------------------------------------------- fp32 on the CUDA cores

// A thread group (8 lanes of one warp) owns R rows of the block's own side;
// the other side comes in tiles of BN, 4 columns a lane (tx + 8 j). R = 1
// above hd 128 keeps dK and dV at 2 x hd / 8 registers.
template <int HD> struct F32Bwd {
  static constexpr int R = HD > 128 ? 1 : 2;
  static constexpr int BM = 16 * R;
  static constexpr int BN = 32;
  static constexpr int LD = HD + 1;
  static constexpr int LDS = BN + 1;
  static constexpr size_t dq_smem =
      sizeof(float) * (size_t(2 * BM + 2 * BN) * LD + size_t(BM) * LDS);
  static constexpr size_t dkdv_smem =
      sizeof(float) * (size_t(2 * BM + 2 * BN) * LD + 2 * size_t(BM) * LDS);
};

// rows [row0, row0 + n) of a (rows, HD) strided operand -> fp32 shared rows
// of stride HD + 1, times `mul`; rows at or past `end` are 0.
template <typename T, int HD>
__device__ __forceinline__ void stage_rows_f32(float* dst, const T* src,
                                               int64_t stride, int row0,
                                               int n, int end, float mul,
                                               int tid) {
  for (int e = tid; e < n * HD; e += kBwdThreads) {
    const int r = e / HD, c = e % HD, gr = row0 + r;
    dst[r * (HD + 1) + c] = gr < end ? to_float(src[gr * stride + c]) * mul
                                     : 0.f;
  }
}

// dQ: one block per (q-tile of BM rows, head, batch).
template <int HD>
__global__ void __launch_bounds__(kBwdThreads) flash_bwd_dq_kernel(
    BwdArgs a) {
  using F = F32Bwd<HD>;
  constexpr int LD = F::LD, LDS = F::LDS, R = F::R, BM = F::BM, BN = F::BN;
  constexpr int NC = HD / 8;
  extern __shared__ float smem[];
  float* Qs = smem;              // BM x LD, scaled
  float* dOs = Qs + BM * LD;     // BM x LD
  float* Ks = dOs + BM * LD;     // BN x LD
  float* Vs = Ks + BN * LD;      // BN x LD
  float* dSs = Vs + BN * LD;     // BM x LDS

  const int nq = (a.S + BM - 1) / BM;
  const int q0 = (nq - 1 - int(blockIdx.x)) * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (a.H / a.Hkv);
  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  const float scale = 1.0f / sqrtf(float(HD));

  const float* qp = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* dop =
      static_cast<const float*>(a.dout) + b * a.do_sb + h * a.do_sh;
  const float* kp = static_cast<const float*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const float* vp = static_cast<const float*>(a.v) + b * a.v_sb + hk * a.v_sh;
  float* dqp = static_cast<float*>(a.dq) + b * a.dq_sb + h * a.dq_sh;
  const float* lse = a.lse + (int64_t(b) * a.H + h) * a.S;
  const float* delta = a.delta + (int64_t(b) * a.H + h) * a.S;

  stage_rows_f32<float, HD>(Qs, qp, a.q_ss, q0, BM, a.S, scale, tid);
  stage_rows_f32<float, HD>(dOs, dop, a.do_ss, q0, BM, a.S, 1.f, tid);
  float lr[R], dl[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qi = q0 + ty * R + i;
    lr[i] = row_lse(lse, qi, a.S);
    dl[i] = qi < a.S ? delta[qi] : 0.f;
  }

  const int q_end = min(q0 + BM, a.S);
  const int kv_lo = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int kv_hi = a.causal ? min(a.T, q_end) : a.T;

  float acc[R][NC];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;

  for (int k0 = kv_lo; k0 < kv_hi; k0 += BN) {
    __syncthreads();  // q, dO staged; the previous tile's K reads are done
    stage_rows_f32<float, HD>(Ks, kp, a.k_st, k0, BN, a.T, 1.f, tid);
    stage_rows_f32<float, HD>(Vs, vp, a.v_st, k0, BN, a.T, 1.f, tid);
    __syncthreads();

    float s[R][4], dp[R][4];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[R], ov[R], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        qv[i] = Qs[(ty * R + i) * LD + d];
        ov[i] = dOs[(ty * R + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = Ks[(tx + 8 * j) * LD + d];
        vv[j] = Vs[(tx + 8 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qi = q0 + ty * R + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 8 * j;
        float fac;
        const float z = capped_score(s[i][j], a.softcap, fac);
        const float p = key_valid(a, qi, kj) ? expf(z - lr[i]) : 0.f;
        dSs[(ty * R + i) * LDS + tx + 8 * j] = p * (dp[i][j] - dl[i]) * fac;
      }
    }
    __syncwarp();  // a row group's dS rows are written and read by its warp

#pragma unroll 4
    for (int j = 0; j < BN; ++j) {
      float dsv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) dsv[i] = dSs[(ty * R + i) * LDS + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float kc = Ks[j * LD + tx + 8 * c];
#pragma unroll
        for (int i = 0; i < R; ++i) acc[i][c] = fmaf(dsv[i], kc, acc[i][c]);
      }
    }
    __syncwarp();  // dS reads are done before the next tile overwrites it
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qi = q0 + ty * R + i;
    if (qi < a.S) {
#pragma unroll
      for (int c = 0; c < NC; ++c)
        dqp[qi * a.dq_ss + tx + 8 * c] = acc[i][c] * scale;
    }
  }
}

// dK and dV: one block per (tile of BM keys, kv head, batch), over the G
// query heads of the group and the q-tiles its keys reach.
template <int HD>
__global__ void __launch_bounds__(kBwdThreads) flash_bwd_dkdv_kernel(
    BwdArgs a) {
  using F = F32Bwd<HD>;
  constexpr int LD = F::LD, LDS = F::LDS, R = F::R, BM = F::BM, BN = F::BN;
  constexpr int NC = HD / 8;
  extern __shared__ float smem[];
  float* Ks = smem;              // BM x LD
  float* Vs = Ks + BM * LD;      // BM x LD
  float* Qs = Vs + BM * LD;      // BN x LD, scaled
  float* dOs = Qs + BN * LD;     // BN x LD
  float* Ps = dOs + BN * LD;     // BM x LDS: P^T
  float* dSs = Ps + BM * LDS;    // BM x LDS: dS^T

  const int k0 = int(blockIdx.x) * BM;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int G = a.H / a.Hkv;
  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  const float scale = 1.0f / sqrtf(float(HD));

  const float* kp = static_cast<const float*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const float* vp = static_cast<const float*>(a.v) + b * a.v_sb + hk * a.v_sh;
  float* dkp = static_cast<float*>(a.dk) + b * a.dk_sb + hk * a.dk_sh;
  float* dvp = static_cast<float*>(a.dv) + b * a.dv_sb + hk * a.dv_sh;
  stage_rows_f32<float, HD>(Ks, kp, a.k_st, k0, BM, a.T, 1.f, tid);
  stage_rows_f32<float, HD>(Vs, vp, a.v_st, k0, BM, a.T, 1.f, tid);

  // the q rows these keys reach
  const int k_end = min(k0 + BM, a.T);
  const int q_lo = a.causal ? k0 : 0;
  const int q_hi = a.window > 0 ? min(a.S, k_end - 1 + a.window) : a.S;

  float dk[R][NC], dv[R][NC];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk[i][c] = dv[i][c] = 0.f;

  for (int gi = 0; gi < G; ++gi) {
    const int h = hk * G + gi;
    const float* qp = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
    const float* dop =
        static_cast<const float*>(a.dout) + b * a.do_sb + h * a.do_sh;
    const float* lse = a.lse + (int64_t(b) * a.H + h) * a.S;
    const float* delta = a.delta + (int64_t(b) * a.H + h) * a.S;
    for (int q0 = (q_lo / BN) * BN; q0 < q_hi; q0 += BN) {
      __syncthreads();  // K, V staged; the previous tile's q, dO reads done
      stage_rows_f32<float, HD>(Qs, qp, a.q_ss, q0, BN, a.S, scale, tid);
      stage_rows_f32<float, HD>(dOs, dop, a.do_ss, q0, BN, a.S, 1.f, tid);
      __syncthreads();

      float st[R][4], dpt[R][4];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) {
        float kv[R], vv[R], qv[4], ov[4];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          kv[i] = Ks[(ty * R + i) * LD + d];
          vv[i] = Vs[(ty * R + i) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qv[j] = Qs[(tx + 8 * j) * LD + d];
          ov[j] = dOs[(tx + 8 * j) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            st[i][j] = fmaf(qv[j], kv[i], st[i][j]);
            dpt[i][j] = fmaf(ov[j], vv[i], dpt[i][j]);
          }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qi = q0 + tx + 8 * j;
        const float lr = row_lse(lse, qi, a.S);
        const float dl = qi < a.S ? delta[qi] : 0.f;
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const int kj = k0 + ty * R + i;
          float fac;
          const float z = capped_score(st[i][j], a.softcap, fac);
          const float p = key_valid(a, qi, kj) ? expf(z - lr) : 0.f;
          Ps[(ty * R + i) * LDS + tx + 8 * j] = p;
          dSs[(ty * R + i) * LDS + tx + 8 * j] = p * (dpt[i][j] - dl) * fac;
        }
      }
      __syncwarp();  // a row group's P and dS rows are its warp's

#pragma unroll 4
      for (int c = 0; c < BN; ++c) {
        float pv[R], dsv[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          pv[i] = Ps[(ty * R + i) * LDS + c];
          dsv[i] = dSs[(ty * R + i) * LDS + c];
        }
#pragma unroll
        for (int m = 0; m < NC; ++m) {
          const float o = dOs[c * LD + tx + 8 * m];
          const float qq = Qs[c * LD + tx + 8 * m];
#pragma unroll
          for (int i = 0; i < R; ++i) {
            dv[i][m] = fmaf(pv[i], o, dv[i][m]);
            dk[i][m] = fmaf(dsv[i], qq, dk[i][m]);
          }
        }
      }
      __syncwarp();
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int kj = k0 + ty * R + i;
    if (kj < a.T) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        dkp[kj * a.dk_st + tx + 8 * c] = dk[i][c];   // q was pre-scaled
        dvp[kj * a.dv_st + tx + 8 * c] = dv[i][c];
      }
    }
  }
}

template <int HD>
cudaError_t launch_bwd_f32(const BwdArgs& a, cudaStream_t stream) {
  using F = F32Bwd<HD>;
  static_assert(F::dkdv_smem <= 232448 && F::dq_smem <= 232448,
                "shared memory beyond a block's 227 KB");
  static const cudaError_t attr_q = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(F::dq_smem));
  static const cudaError_t attr_kv = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(F::dkdv_smem));
  if (attr_q != cudaSuccess) return attr_q;
  if (attr_kv != cudaSuccess) return attr_kv;
  const int64_t rows = int64_t(a.B) * a.H * a.S;
  flash_bwd_delta_kernel<float>
      <<<int((rows + 3) / 4), kBwdThreads, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_kernel<HD>
      <<<dim3((a.T + F::BM - 1) / F::BM, a.Hkv, a.B), kBwdThreads,
         F::dkdv_smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<HD>
      <<<dim3((a.S + F::BM - 1) / F::BM, a.H, a.B), kBwdThreads, F::dq_smem,
         stream>>>(a);
  return cudaGetLastError();
}

// ------------------------------------------------- bf16 on the tensor cores

namespace tcb {

using bf16 = __nv_bfloat16;

// A block is 4 warps of 16 own rows (BM = 64: keys for dK/dV, q rows for
// dQ); the other side comes in tiles of BN_KV q rows (dK/dV) or BN_Q keys
// (dQ), through a ring of 2 stages as the forward's K and V do.
template <int HD> struct BwdConfig {
  static constexpr int BM = 64;
  static constexpr int BN_KV = HD <= 64 ? 64 : 32;
  static constexpr int BN_Q = HD <= 128 ? 64 : 32;
  static constexpr int LD = HD + 8;   // bf16 row stride: +16 bytes
  static constexpr size_t dkdv_smem =
      sizeof(bf16) * size_t(2 * BM + 4 * BN_KV) * LD;
  static constexpr size_t dq_smem = sizeof(bf16) * size_t(2 * BM + 4 * BN_Q) * LD;
};

// rows [row0, row0 + n) of a (rows, HD) strided operand -> shared rows of
// stride HD + 8, 16 bytes a cp.async; rows at or past `end` are zero-filled.
template <int HD>
__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* src,
                                          int64_t stride, int row0, int n,
                                          int end, int tid) {
  constexpr int CH = HD / 8, LD = HD + 8;
  for (int e = tid; e < n * CH; e += kBwdThreads) {
    const int r = e / CH, c = e % CH, gr = row0 + r;
    const bool in = gr < end;
    repro_ptx::cp_async_16(dst + r * LD + c * 8,
                           in ? src + gr * stride + c * 8 : src, in);
  }
}

// A warp's 16 rows of NC n-tiles of fp32 accumulators (m16n8 C layout) ->
// bf16 columns [col0, col0 + 8 NC) of rows row0 + (0..15) that lie before
// `end`, times `mul`.
template <int NC>
__device__ __forceinline__ void store_tiles(bf16* dst, int64_t stride,
                                            int row0, int end, int col0,
                                            const float (&acc)[NC][4],
                                            float mul, int g, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row < end) {
#pragma unroll
      for (int j = 0; j < NC; ++j)
        *reinterpret_cast<uint32_t*>(dst + row * stride + col0 + j * 8 +
                                     2 * t) =
            repro_ptx::pack_bf16x2(acc[j][2 * r] * mul,
                                   acc[j][2 * r + 1] * mul);
    }
  }
}

// z log2(e) of a raw score s and its chain factor, as the forward forms it
__device__ __forceinline__ float score_l2(float s, bool capped, float sl2,
                                          float cap_in, float cap_out,
                                          float& fac) {
  if (capped) {
    const float th = tanhf(s * cap_in);
    fac = 1.f - th * th;
    return cap_out * th;
  }
  fac = 1.f;
  return s * sl2;
}

template <int HD>
__global__ void __launch_bounds__(kBwdThreads)
    flash_bwd_dkdv_mma_kernel(BwdArgs a) {
  static_assert(HD % 16 == 0, "head_dim must be a multiple of 16");
  using C = BwdConfig<HD>;
  constexpr int BM = C::BM, BN = C::BN_KV, LD = C::LD;
  constexpr int KSTEPS = HD / 16;   // k-steps of S^T and dP^T
  constexpr int NQ = BN / 8;        // n-tiles of S^T and dP^T (q columns)
  constexpr int NC = HD / 8;        // n-tiles of dK and dV
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);   // BM x LD
  bf16* Vs = Ks + BM * LD;                        // BM x LD
  bf16* Qs = Vs + BM * LD;                        // 2 stages of BN x LD
  bf16* dOs = Qs + 2 * BN * LD;                   // 2 stages of BN x LD

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int k0 = int(blockIdx.z) * BM;
  const int G = a.H / a.Hkv;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = warp * 16;
  const float scale = 1.0f / sqrtf(float(HD));
  const float sl2 = kLog2e * scale;
  const bool capped = a.softcap > 0.f;
  const float cap_in = capped ? scale / a.softcap : 0.f;
  const float cap_out = a.softcap * kLog2e;

  const bf16* kp = static_cast<const bf16*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const bf16* vp = static_cast<const bf16*>(a.v) + b * a.v_sb + hk * a.v_sh;
  bf16* dkp = static_cast<bf16*>(a.dk) + b * a.dk_sb + hk * a.dk_sh;
  bf16* dvp = static_cast<bf16*>(a.dv) + b * a.dv_sb + hk * a.dv_sh;

  // the q rows these keys reach, as q-tiles of BN rows, for each of the G
  // heads
  const int k_end = min(k0 + BM, a.T);
  const int q_lo = a.causal ? k0 : 0;
  const int q_hi = a.window > 0 ? min(a.S, k_end - 1 + a.window) : a.S;
  const int first = q_lo / BN;
  const int nqt = q_hi > q_lo ? (q_hi + BN - 1) / BN - first : 0;
  const int total = G * nqt;

  // one cp.async group a tile: (K, V, q_0, dO_0), then q and dO of tile
  // it+1 issued at the top of tile it
  copy_rows<HD>(Ks, kp, a.k_st, k0, BM, a.T, tid);
  copy_rows<HD>(Vs, vp, a.v_st, k0, BM, a.T, tid);
  if (total > 0) {
    const int h = hk * G;
    copy_rows<HD>(Qs, static_cast<const bf16*>(a.q) + b * a.q_sb +
                          h * a.q_sh, a.q_ss, first * BN, BN, a.S, tid);
    copy_rows<HD>(dOs, static_cast<const bf16*>(a.dout) + b * a.do_sb +
                           h * a.do_sh, a.do_ss, first * BN, BN, a.S, tid);
  }
  repro_ptx::cp_async_commit();

  const bf16* Kw = Ks + wrow * LD;
  const bf16* Vw = Vs + wrow * LD;
  float dk[NC][4], dv[NC][4];
#pragma unroll
  for (int j = 0; j < NC; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  for (int it = 0; it < total; ++it) {
    const int h = hk * G + it / nqt;
    const int q0 = (first + it % nqt) * BN;
    const int st = it & 1;
    repro_ptx::cp_async_wait<0>();   // this tile's q, dO (and K, V) landed
    __syncthreads();                 // ... for every thread; and every warp
                                     // is done with stage st ^ 1
    if (it + 1 < total) {
      const int nh = hk * G + (it + 1) / nqt;
      const int nq0 = (first + (it + 1) % nqt) * BN;
      copy_rows<HD>(Qs + (st ^ 1) * BN * LD,
                    static_cast<const bf16*>(a.q) + b * a.q_sb + nh * a.q_sh,
                    a.q_ss, nq0, BN, a.S, tid);
      copy_rows<HD>(dOs + (st ^ 1) * BN * LD,
                    static_cast<const bf16*>(a.dout) + b * a.do_sb +
                        nh * a.do_sh, a.do_ss, nq0, BN, a.S, tid);
      repro_ptx::cp_async_commit();
    }
    const bf16* Qt = Qs + st * BN * LD;
    const bf16* dOt = dOs + st * BN * LD;
    const float* lse = a.lse + (int64_t(b) * a.H + h) * a.S;
    const float* delta = a.delta + (int64_t(b) * a.H + h) * a.S;
    // a warp whose keys no row of the tile sees skips the math: past T,
    // after every row (causal), or out of every row's window
    const int kw0 = k0 + wrow;
    const bool warp_live =
        kw0 < a.T && (!a.causal || kw0 <= q0 + BN - 1) &&
        (a.window <= 0 || q0 - (kw0 + 15) < a.window);

    if (warp_live) {
      // S^T = K q^T and dP^T = V dO^T, raw fp32
      float sT[NQ][4], dpT[NQ][4];
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sT[j][e] = dpT[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        uint32_t ka[4], va[4];
        repro_ptx::ldmatrix_x4(
            ka, Kw + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
        repro_ptx::ldmatrix_x4(
            va, Vw + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < NQ / 2; ++np) {
          const int off = (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                          kk * 16 + ((lane >> 3) & 1) * 8;
          uint32_t r[4];
          repro_ptx::ldmatrix_x4(r, Qt + off);
          repro_ptx::mma_bf16_16816(sT[2 * np], ka, r[0], r[1]);
          repro_ptx::mma_bf16_16816(sT[2 * np + 1], ka, r[2], r[3]);
          repro_ptx::ldmatrix_x4(r, dOt + off);
          repro_ptx::mma_bf16_16816(dpT[2 * np], va, r[0], r[1]);
          repro_ptx::mma_bf16_16816(dpT[2 * np + 1], va, r[2], r[3]);
        }
      }

      // P^T = 2^(z - lse) into sT, dS^T = P^T (dP^T - delta) fac into dpT;
      // element e of n-tile j: key kw0 + g + 8 (e / 2), q row
      // q0 + 8 j + 2 t + e % 2
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int qi = q0 + j * 8 + 2 * t + c;
          const float l2 = row_lse(lse, qi, a.S) * kLog2e;
          const float dl = qi < a.S ? delta[qi] : 0.f;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int e = 2 * r + c;
            const int kj = kw0 + g + 8 * r;
            float fac;
            const float z = score_l2(sT[j][e], capped, sl2, cap_in, cap_out,
                                     fac);
            const float p = key_valid(a, qi, kj)
                                ? repro_ptx::exp2_approx(z - l2) : 0.f;
            sT[j][e] = p;
            dpT[j][e] = p * (dpT[j][e] - dl) * fac;
          }
        }
      }

      // dV += P^T dO and dK += dS^T q, the q rows as the k axis
      // (ldmatrix.trans), P^T and dS^T rounded to bf16
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        uint32_t pa[4], da[4];
        pa[0] = repro_ptx::pack_bf16x2(sT[2 * kk][0], sT[2 * kk][1]);
        pa[1] = repro_ptx::pack_bf16x2(sT[2 * kk][2], sT[2 * kk][3]);
        pa[2] = repro_ptx::pack_bf16x2(sT[2 * kk + 1][0], sT[2 * kk + 1][1]);
        pa[3] = repro_ptx::pack_bf16x2(sT[2 * kk + 1][2], sT[2 * kk + 1][3]);
        da[0] = repro_ptx::pack_bf16x2(dpT[2 * kk][0], dpT[2 * kk][1]);
        da[1] = repro_ptx::pack_bf16x2(dpT[2 * kk][2], dpT[2 * kk][3]);
        da[2] = repro_ptx::pack_bf16x2(dpT[2 * kk + 1][0], dpT[2 * kk + 1][1]);
        da[3] = repro_ptx::pack_bf16x2(dpT[2 * kk + 1][2], dpT[2 * kk + 1][3]);
#pragma unroll
        for (int np = 0; np < NC / 2; ++np) {
          const int off = (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                          np * 16 + (lane >> 4) * 8;
          uint32_t r[4];
          repro_ptx::ldmatrix_x4_trans(r, dOt + off);
          repro_ptx::mma_bf16_16816(dv[2 * np], pa, r[0], r[1]);
          repro_ptx::mma_bf16_16816(dv[2 * np + 1], pa, r[2], r[3]);
          repro_ptx::ldmatrix_x4_trans(r, Qt + off);
          repro_ptx::mma_bf16_16816(dk[2 * np], da, r[0], r[1]);
          repro_ptx::mma_bf16_16816(dk[2 * np + 1], da, r[2], r[3]);
        }
      }
    }
  }
  repro_ptx::cp_async_wait<0>();
  // dK and dV out (0 for keys no row sees)
  store_tiles<NC>(dkp, a.dk_st, k0 + wrow, a.T, 0, dk, scale, g, t);
  store_tiles<NC>(dvp, a.dv_st, k0 + wrow, a.T, 0, dv, 1.f, g, t);
}

template <int HD>
__global__ void __launch_bounds__(kBwdThreads)
    flash_bwd_dq_mma_kernel(BwdArgs a) {
  static_assert(HD % 16 == 0, "head_dim must be a multiple of 16");
  using C = BwdConfig<HD>;
  constexpr int BM = C::BM, BN = C::BN_Q, LD = C::LD;
  constexpr int KSTEPS = HD / 16;   // k-steps of S and dP
  constexpr int NS = BN / 8;        // n-tiles of S and dP
  constexpr int NO = HD / 8;        // n-tiles of dQ
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);   // BM x LD
  bf16* dOs = Qs + BM * LD;                       // BM x LD
  bf16* Ks = dOs + BM * LD;                       // 2 stages of BN x LD
  bf16* Vs = Ks + 2 * BN * LD;                    // 2 stages of BN x LD

  const int q0 = (int(gridDim.z) - 1 - int(blockIdx.z)) * BM;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int hk = h / (a.H / a.Hkv);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = warp * 16;
  const float scale = 1.0f / sqrtf(float(HD));
  const float sl2 = kLog2e * scale;
  const bool capped = a.softcap > 0.f;
  const float cap_in = capped ? scale / a.softcap : 0.f;
  const float cap_out = a.softcap * kLog2e;

  const bf16* qp = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const bf16* dop =
      static_cast<const bf16*>(a.dout) + b * a.do_sb + h * a.do_sh;
  const bf16* kp = static_cast<const bf16*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const bf16* vp = static_cast<const bf16*>(a.v) + b * a.v_sb + hk * a.v_sh;
  bf16* dqp = static_cast<bf16*>(a.dq) + b * a.dq_sb + h * a.dq_sh;
  const float* lse = a.lse + (int64_t(b) * a.H + h) * a.S;
  const float* delta = a.delta + (int64_t(b) * a.H + h) * a.S;

  const int q_end = min(q0 + BM, a.S);
  const int kv_lo = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int kv_hi = a.causal ? min(a.T, q_end) : a.T;
  const int n_tiles = max(0, (kv_hi - kv_lo + BN - 1) / BN);

  copy_rows<HD>(Qs, qp, a.q_ss, q0, BM, a.S, tid);
  copy_rows<HD>(dOs, dop, a.do_ss, q0, BM, a.S, tid);
  if (n_tiles > 0) {
    copy_rows<HD>(Ks, kp, a.k_st, kv_lo, BN, a.T, tid);
    copy_rows<HD>(Vs, vp, a.v_st, kv_lo, BN, a.T, tid);
  }
  repro_ptx::cp_async_commit();

  // this thread's rows g and g + 8 of the warp's 16
  float l2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + wrow + g + 8 * r;
    l2[r] = row_lse(lse, qi, a.S) * kLog2e;
    dl[r] = qi < a.S ? delta[qi] : 0.f;
  }
  const bf16* Qw = Qs + wrow * LD;
  const bf16* dOw = dOs + wrow * LD;
  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = kv_lo + it * BN;
    const int st = it & 1;
    repro_ptx::cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < n_tiles) {
      copy_rows<HD>(Ks + (st ^ 1) * BN * LD, kp, a.k_st, k0 + BN, BN, a.T,
                    tid);
      copy_rows<HD>(Vs + (st ^ 1) * BN * LD, vp, a.v_st, k0 + BN, BN, a.T,
                    tid);
      repro_ptx::cp_async_commit();
    }
    // a warp whose rows see no key of this tile skips the math: past S,
    // before every key (causal), or past every key's window
    const int qw0 = q0 + wrow;
    const bool warp_live = qw0 < a.S && (!a.causal || qw0 + 15 >= k0) &&
                           (a.window <= 0 || qw0 - (k0 + BN - 1) < a.window);
    if (warp_live) {
      const bf16* Kt = Ks + st * BN * LD;
      const bf16* Vt = Vs + st * BN * LD;
      float s[NS][4], dp[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        uint32_t qa[4], oa[4];
        repro_ptx::ldmatrix_x4(
            qa, Qw + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
        repro_ptx::ldmatrix_x4(
            oa, dOw + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {
          const int off = (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                          kk * 16 + ((lane >> 3) & 1) * 8;
          uint32_t r[4];
          repro_ptx::ldmatrix_x4(r, Kt + off);
          repro_ptx::mma_bf16_16816(s[2 * np], qa, r[0], r[1]);
          repro_ptx::mma_bf16_16816(s[2 * np + 1], qa, r[2], r[3]);
          repro_ptx::ldmatrix_x4(r, Vt + off);
          repro_ptx::mma_bf16_16816(dp[2 * np], oa, r[0], r[1]);
          repro_ptx::mma_bf16_16816(dp[2 * np + 1], oa, r[2], r[3]);
        }
      }
      // dS = P (dP - delta) fac into s; element e of n-tile j: row
      // qw0 + g + 8 (e / 2), key k0 + 8 j + 2 t + e % 2
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int qi = qw0 + g + 8 * r;
          const int kj = k0 + j * 8 + 2 * t + (e & 1);
          float fac;
          const float z = score_l2(s[j][e], capped, sl2, cap_in, cap_out,
                                   fac);
          const float p = key_valid(a, qi, kj)
                              ? repro_ptx::exp2_approx(z - l2[r]) : 0.f;
          s[j][e] = p * (dp[j][e] - dl[r]) * fac;
        }
      // dQ += dS K, the keys as the k axis (ldmatrix.trans), dS in bf16
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        uint32_t da[4];
        da[0] = repro_ptx::pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
        da[1] = repro_ptx::pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
        da[2] = repro_ptx::pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        da[3] = repro_ptx::pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
        for (int np = 0; np < NO / 2; ++np) {
          uint32_t r[4];
          repro_ptx::ldmatrix_x4_trans(
              r, Kt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                     np * 16 + (lane >> 4) * 8);
          repro_ptx::mma_bf16_16816(acc[2 * np], da, r[0], r[1]);
          repro_ptx::mma_bf16_16816(acc[2 * np + 1], da, r[2], r[3]);
        }
      }
    }
  }
  repro_ptx::cp_async_wait<0>();
  store_tiles<NO>(dqp, a.dq_ss, q0 + wrow, a.S, 0, acc, scale, g, t);
}

template <int HD>
cudaError_t launch_bwd(const BwdArgs& a, cudaStream_t stream) {
  using C = BwdConfig<HD>;
  static_assert(C::dkdv_smem <= 232448 && C::dq_smem <= 232448,
                "shared memory beyond a block's 227 KB");
  static const cudaError_t attr_kv = cudaFuncSetAttribute(
      flash_bwd_dkdv_mma_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(C::dkdv_smem));
  static const cudaError_t attr_q = cudaFuncSetAttribute(
      flash_bwd_dq_mma_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(C::dq_smem));
  if (attr_kv != cudaSuccess) return attr_kv;
  if (attr_q != cudaSuccess) return attr_q;
  const int64_t rows = int64_t(a.B) * a.H * a.S;
  flash_bwd_delta_kernel<bf16>
      <<<int((rows + 3) / 4), kBwdThreads, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_mma_kernel<HD>
      <<<dim3(a.Hkv, a.B, (a.T + C::BM - 1) / C::BM), kBwdThreads,
         C::dkdv_smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_mma_kernel<HD>
      <<<dim3(a.H, a.B, (a.S + C::BM - 1) / C::BM), kBwdThreads,
         C::dq_smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace tcb

cudaError_t dispatch_bwd(const BwdArgs& a, int dtype, cudaStream_t s) {
  if (dtype == 0) {
    switch (a.D) {
      case 32: return launch_bwd_f32<32>(a, s);
      case 64: return launch_bwd_f32<64>(a, s);
      case 128: return launch_bwd_f32<128>(a, s);
      case 192: return launch_bwd_f32<192>(a, s);
      case 256: return launch_bwd_f32<256>(a, s);
      default: return cudaErrorInvalidValue;
    }
  }
  if (dtype == 1) {
    // Which design serves each head_dim is fixed by head_dim alone: 64,
    // 128, 192 and 256 are flash_attention_bwd_sm90.cu's (its own C entry
    // point; the wrapper routes by `ops.bwd_path`), 32 these kernels'.
    if (a.D == 32) return tcb::launch_bwd<32>(a, s);
    return cudaErrorInvalidValue;
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The backward of `repro_flash_attention_fwd` (flash_attention.cu), called
// with the dtype, shapes, mask and softcap of the forward: dq, dk, dv (the
// inputs' dtype and layout rules) from q, k, v, its out and lse and dout;
// `delta` is (B, H, S) fp32 scratch. Three launches on `stream` (delta, dK/dV, dQ); returns
// cudaGetLastError() after the last (0 on success).
int repro_flash_attention_bwd(
    int dtype, const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int B, int H, int Hkv, int S, int T, int hd,
    int64_t q_sb, int64_t q_sh, int64_t q_ss,
    int64_t k_sb, int64_t k_sh, int64_t k_st,
    int64_t v_sb, int64_t v_sh, int64_t v_st,
    int64_t o_sb, int64_t o_sh, int64_t o_ss,
    int64_t do_sb, int64_t do_sh, int64_t do_ss,
    int64_t dq_sb, int64_t dq_sh, int64_t dq_ss,
    int64_t dk_sb, int64_t dk_sh, int64_t dk_st,
    int64_t dv_sb, int64_t dv_sh, int64_t dv_st,
    int causal, int window, float softcap, void* stream) {
  BwdArgs a{q, k, v, o, dout, lse, delta, dq, dk, dv,
            q_sb, q_sh, q_ss, k_sb, k_sh, k_st, v_sb, v_sh, v_st,
            o_sb, o_sh, o_ss, do_sb, do_sh, do_ss,
            dq_sb, dq_sh, dq_ss, dk_sb, dk_sh, dk_st, dv_sb, dv_sh, dv_st,
            B, H, Hkv, S, T, hd, causal, window, softcap};
  return int(dispatch_bwd(a, dtype, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
