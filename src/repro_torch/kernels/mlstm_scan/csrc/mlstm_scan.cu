// Chunkwise mLSTM forward for Hopper (sm_90a), written by hand in CUDA C++.
//
// Replaces the Pallas TPU kernel `_mlstm_kernel` in
// src/repro/kernels/mlstm_scan/kernel.py:22 (wrapper `mlstm_scan` :78,
// `pl.pallas_call` :90), and computes what it computes, the stabilized
// chunkwise mLSTM of src/repro/models/xlstm.py `_mlstm_chunk`, chunk after
// chunk, with the state taken in and given out:
//   per chunk of rows i, j (j <= i), with b = cumsum(log_f) over the chunk,
//   logd_ij = b_i - b_j + log_i_j  (masked entries -1e30),
//   m_i     = max(max_j logd_ij, b_i + m_run)
//   y_i     = (sum_j (q_i.k_j) e^{logd_ij - m_i} v_j + e^{b_i + m_run - m_i} q_i C)
//             / max(|same with k_j for v_j and n for C|, e^{-m_i})
//   and C, n, m carried to the chunk's end. q is scaled by 1/sqrt(hd).
// The state layout is the model's cache: C (B,H,hd_k,hd_v) fp32, n (B,H,hd),
// m (B,H). With no state in, C = n = 0 and m = 0. fp32 or bf16 q, k, v;
// fp32 gates; fp32 math on the CUDA cores (no TF32); y in q's type.
//
// What bounds it on the H100. At xlstm-125m's training shape (B=4, H=4,
// S=512, hd=384, bf16) the useful work is, per (b, h), the in-chunk causal
// scores and weighted sum (2 x 2 * bc(bc+1)/2 * hd per chunk) plus q.C and
// the C update (2 * S * hd^2 each): about 5.0 GFLOP, against about 35 MB of
// q, k, v, y, gates and state out. At the 989 TFLOP/s of the bf16 tensor
// cores that is about 5 us, at 3.35 TB/s about 10 us: the bound is bytes.
//
// What this first design does about it. It is the simple, correct first
// step, not yet a fast one:
//   - The state does not fit a block: at hd=384 an fp32 C is 576 KB and a
//     block has 227 KB. C is split along its v axis: grid (hd/BV, H, B),
//     each block holding C[:, v0:v0+BV] (hd x 32 fp32, 48 KB at hd=384) in
//     shared memory for the whole sequence. The Pallas grid's sequential
//     chunk axis becomes a loop over chunks inside the block.
//   - Every block recomputes what all v-slices share from full-hd q and k
//     tiles: the chunk's decay matrix, the scores, q.n, the denominator and
//     the n update. Only the block of v-slice 0 writes n and m out.
//   - Shared memory at hd=384, BC=32, BV=32 (floats): q and k tiles
//     2 x 32 x 385, v tile 32 x 33, scores 32 x 33, C slice 384 x 32, n 384,
//     row vectors and scalars 7 x 32: 39,648 floats = 158,592 bytes, one
//     block per SM.
//     Rows are padded by one float so the row-strided reads below hit 32
//     distinct banks.
//   - A ragged last chunk (any S >= 1, decode's S = 1 included) is masked:
//     rows past S are zero, take no part in the state update and are not
//     stored, unlike the Pallas wrapper, which asserts divisibility.
//   - q, k, v, the gates and y are read and written by strides, so the
//     model's (B,S,H,hd) and (B,S,H) tensors need no transpose.
// Tensor cores (mma.sync / wgmma on bf16 tiles), TMA staging and a v-split
// that shares the score work across blocks are later work.
// The kernel launches on the caller's stream, allocates nothing and does not
// synchronize; the C entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BC = 32;        // chunk rows (one warp's lanes for the gates)
constexpr int BV = 32;        // v-columns of C per block
constexpr int NT = 256;       // threads: 32 rows x 8 lanes in the row phases
constexpr int LDV = BV + 1;   // padded row stride of the v tile
constexpr int LDS = BC + 1;   // padded row stride of the score tile
constexpr float kNeg = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* li;
  const float* lf;
  const float* c0;   // null: zero state, m = 0
  const float* n0;
  const float* m0;
  void* y;
  float* c1;
  float* n1;
  float* m1;
  int64_t q_sb, q_sh, q_ss;
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t li_sb, li_sh, li_ss;
  int64_t lf_sb, lf_sh, lf_ss;
  int64_t y_sb, y_sh, y_ss;
  int B, H, S;
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
constexpr size_t smem_floats() {
  return 2 * size_t(BC) * (HD + 1)   // q, k tiles
         + size_t(BC) * LDV          // v tile
         + size_t(BC) * LDS          // decayed scores
         + size_t(HD) * BV           // C slice
         + HD                        // n
         + 7 * size_t(BC);           // bcum, log_i, w_state, den, w_upd, scalars
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT) mlstm_fwd_kernel(Args a) {
  static_assert(HD % 32 == 0 && HD >= BV, "head_dim must be a multiple of 32");
  constexpr int LD = HD + 1;
  constexpr int ROWS = HD / (NT / BV);  // C rows per thread in the update
  extern __shared__ float smem[];
  float* Qs = smem;                 // BC x LD, q * scale
  float* Ks = Qs + BC * LD;         // BC x LD, k (then k * w_upd)
  float* Vs = Ks + BC * LD;         // BC x LDV, v[:, v0:v0+BV]
  float* Ss = Vs + BC * LDV;        // BC x LDS, decayed scores
  float* Cs = Ss + BC * LDS;        // HD x BV, C[:, v0:v0+BV]
  float* Ns = Cs + HD * BV;         // HD
  float* bcum = Ns + HD;            // BC
  float* lis = bcum + BC;           // BC
  float* wst = lis + BC;            // BC, w_state per row
  float* dens = wst + BC;           // BC, den per row
  float* wupd = dens + BC;          // BC
  float* scal = wupd + BC;          // [0] m_next, [1] decay

  const int v0 = blockIdx.x * BV;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const float scale = 1.0f / sqrtf(float(HD));

  const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh + v0;
  const float* lip = a.li + b * a.li_sb + h * a.li_sh;
  const float* lfp = a.lf + b * a.lf_sb + h * a.lf_sh;
  T* yp = static_cast<T*>(a.y) + b * a.y_sb + h * a.y_sh + v0;
  const int64_t bh = int64_t(b) * a.H + h;

  for (int e = tid; e < HD * BV; e += NT) {
    const int d = e / BV, c = e % BV;
    Cs[e] = a.c0 ? a.c0[(bh * HD + d) * HD + v0 + c] : 0.f;
  }
  for (int d = tid; d < HD; d += NT) Ns[d] = a.n0 ? a.n0[bh * HD + d] : 0.f;
  float m_run = a.m0 ? a.m0[bh] : 0.f;

  // Row phases: thread (i, tx) owns row i and columns tx + 8r.
  const int i = tid >> 3;
  const int tx = tid & 7;
  // C update: thread (dr, e) owns column e and rows dr + 8 rr.
  const int e = tid % BV;
  const int dr = tid / BV;

  for (int t0 = 0; t0 < a.S; t0 += BC) {
    const int L = min(BC, a.S - t0);
    __syncthreads();  // the previous chunk is done with every tile

    for (int x = tid; x < BC * HD; x += NT) {
      const int r = x / HD, c = x % HD;
      const bool in = r < L;
      const int64_t t = t0 + r;
      Qs[r * LD + c] = in ? to_float(qp[t * a.q_ss + c]) * scale : 0.f;
      Ks[r * LD + c] = in ? to_float(kp[t * a.k_ss + c]) : 0.f;
    }
    for (int x = tid; x < BC * BV; x += NT) {
      const int r = x / BV, c = x % BV;
      Vs[r * LDV + c] = r < L ? to_float(vp[(t0 + r) * a.v_ss + c]) : 0.f;
    }
    if (tid < 32) {
      // Gates of the chunk: one lane per row. Rows past S get log_f = 0
      // (bcum stays at the last row's) and log_i = -1e30.
      const int lane = tid;
      const bool in = lane < L;
      const float f = in ? lfp[(t0 + lane) * a.lf_ss] : 0.f;
      const float ig = in ? lip[(t0 + lane) * a.li_ss] : kNeg;
      float cum = f;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, cum, off);
        if (lane >= off) cum += up;
      }
      bcum[lane] = cum;
      lis[lane] = ig;
      const float btot = __shfl_sync(0xffffffffu, cum, L - 1);
      const float cand = in ? (btot - cum) + ig : -INFINITY;
      float mx = cand;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_next = fmaxf(btot + m_run, mx);
      wupd[lane] = in ? expf((btot - cum) + ig - m_next) : 0.f;
      if (lane == 0) {
        scal[0] = m_next;
        scal[1] = expf(btot + m_run - m_next);
      }
    }
    __syncthreads();

    // Scores, q.n, stabilizer and denominator of row i.
    {
      float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
      for (int d = 0; d < HD; ++d) {
        const float qv = Qs[i * LD + d];
#pragma unroll
        for (int r = 0; r < 4; ++r) s[r] = fmaf(qv, Ks[(tx + 8 * r) * LD + d], s[r]);
      }
      float qn = 0.f;
      for (int d = tx; d < HD; d += 8) qn = fmaf(Qs[i * LD + d], Ns[d], qn);
      const float bi = bcum[i];
      float ld[4];
      float mx = -INFINITY;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = tx + 8 * r;
        ld[r] = j <= i ? (bi - bcum[j]) + lis[j] : kNeg;
        mx = fmaxf(mx, ld[r]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        qn += __shfl_xor_sync(0xffffffffu, qn, off);
      }
      const float mn = fmaxf(mx, bi + m_run);
      const float ws = expf(bi + m_run - mn);
      float rs = 0.f;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float p = s[r] * expf(ld[r] - mn);
        Ss[i * LDS + tx + 8 * r] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      if (tx == 0) {
        wst[i] = ws;
        dens[i] = fmaxf(fabsf(rs + ws * qn), expf(-mn));
      }
    }
    __syncthreads();

    // y of row i, columns v0 + tx + 8r, from the old C. Then k rows are
    // weighted by w_upd for the update (k is not read in this phase).
    {
      float sv[4] = {0.f, 0.f, 0.f, 0.f};
      float qc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
      for (int j = 0; j < BC; ++j) {
        const float p = Ss[i * LDS + j];
#pragma unroll
        for (int r = 0; r < 4; ++r) sv[r] = fmaf(p, Vs[j * LDV + tx + 8 * r], sv[r]);
      }
#pragma unroll 8
      for (int d = 0; d < HD; ++d) {
        const float qv = Qs[i * LD + d];
#pragma unroll
        for (int r = 0; r < 4; ++r) qc[r] = fmaf(qv, Cs[d * BV + tx + 8 * r], qc[r]);
      }
      if (i < L) {
        const float ws = wst[i], den = dens[i];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          yp[(t0 + i) * a.y_ss + tx + 8 * r] = from_float<T>((sv[r] + ws * qc[r]) / den);
      }
      for (int x = tid; x < BC * HD; x += NT) {
        const int r = x / HD, c = x % HD;
        Ks[r * LD + c] *= wupd[r];
      }
    }
    __syncthreads();

    // Carry the state to the chunk's end:
    //   C = decay C + sum_j (w_upd_j k_j) v_j^T,  n = decay n + sum_j w_upd_j k_j.
    {
      const float decay = scal[1];
      float acc[ROWS];
#pragma unroll
      for (int rr = 0; rr < ROWS; ++rr) acc[rr] = 0.f;
#pragma unroll 4
      for (int j = 0; j < BC; ++j) {
        const float vj = Vs[j * LDV + e];
#pragma unroll
        for (int rr = 0; rr < ROWS; ++rr)
          acc[rr] = fmaf(Ks[j * LD + dr + 8 * rr], vj, acc[rr]);
      }
#pragma unroll
      for (int rr = 0; rr < ROWS; ++rr) {
        const int d = dr + 8 * rr;
        Cs[d * BV + e] = decay * Cs[d * BV + e] + acc[rr];
      }
      for (int d = tid; d < HD; d += NT) {
        float upd = 0.f;
#pragma unroll 8
        for (int j = 0; j < BC; ++j) upd += Ks[j * LD + d];
        Ns[d] = decay * Ns[d] + upd;
      }
      m_run = scal[0];
    }
  }
  __syncthreads();

  for (int x = tid; x < HD * BV; x += NT) {
    const int d = x / BV, c = x % BV;
    a.c1[(bh * HD + d) * HD + v0 + c] = Cs[x];
  }
  if (blockIdx.x == 0) {
    for (int d = tid; d < HD; d += NT) a.n1[bh * HD + d] = Ns[d];
    if (tid == 0) a.m1[bh] = m_run;
  }
}

template <typename T, int HD>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * smem_floats<HD>();
  static_assert(smem <= 232448, "shared memory beyond the 227 KB of a block");
  // Above 48 KB dynamic shared memory must be opted into, once per
  // instantiation.
  static const cudaError_t attr = cudaFuncSetAttribute(
      mlstm_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (attr != cudaSuccess) return attr;
  const dim3 grid(HD / BV, a.H, a.B);
  mlstm_fwd_kernel<T, HD><<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_head_dim(const Args& a, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(a, stream);
    case 64: return launch<T, 64>(a, stream);
    case 256: return launch<T, 256>(a, stream);
    case 384: return launch<T, 384>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype of q, k, v and y: 0 = float32, 1 = bfloat16. Gates and state are
// float32. Strides are in elements, for the (B, H, S[, hd]) view of each
// tensor; the hd axis of q, k, v, y has stride 1. The state tensors are
// contiguous; c0, n0, m0 may all be null (zero state). Returns
// cudaGetLastError() after the launch (0 on success).
int repro_mlstm_scan_fwd(
    int dtype, const void* q, const void* k, const void* v,
    const float* li, const float* lf,
    const float* c0, const float* n0, const float* m0,
    void* y, float* c1, float* n1, float* m1,
    int B, int H, int S, int hd,
    int64_t q_sb, int64_t q_sh, int64_t q_ss,
    int64_t k_sb, int64_t k_sh, int64_t k_ss,
    int64_t v_sb, int64_t v_sh, int64_t v_ss,
    int64_t li_sb, int64_t li_sh, int64_t li_ss,
    int64_t lf_sb, int64_t lf_sh, int64_t lf_ss,
    int64_t y_sb, int64_t y_sh, int64_t y_ss,
    void* stream) {
  Args a{q, k, v, li, lf, c0, n0, m0, y, c1, n1, m1,
         q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
         li_sb, li_sh, li_ss, lf_sb, lf_sh, lf_ss, y_sb, y_sh, y_ss,
         B, H, S};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return int(dispatch_head_dim<float>(a, hd, s));
  if (dtype == 1) return int(dispatch_head_dim<__nv_bfloat16>(a, hd, s));
  return int(cudaErrorInvalidValue);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
