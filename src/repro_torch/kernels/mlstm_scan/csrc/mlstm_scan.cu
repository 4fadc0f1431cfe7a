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
// The chunk does not change the math (the tests hold chunk invariance).
// The state layout is the model's cache: C (B,H,hd_k,hd_v) fp32, n (B,H,hd),
// m (B,H). With no state in, C = n = 0 and m = 0. fp32 gates; y in q's
// type; the state out fp32. q, k, v, the gates and y are read and written by
// strides, so the model's (B,S,H,hd) and (B,S,H) tensors need no transpose.
// A ragged last chunk (any S >= 1, decode's S = 1 included) is masked: rows
// past S are zero, take no part in the state update and are not stored,
// where the Pallas wrapper asserts divisibility.
//
// What bounds it on the H100. At xlstm-125m's training shape (B=4, H=4,
// S=512, hd=384, bf16) the useful work is about 5-7 GFLOP (the in-chunk
// causal scores and their weighted sum, q.C and the C update), against about
// 35 MB of q, k, v, y, gates and state out: about 5-7 us at the 989 TFLOP/s
// of the bf16 tensor cores, 10 us at 3.35 TB/s. The bound is bytes.
//
// Two designs, chosen by dtype in the C entry points:
//
// bf16: two passes on the tensor cores, the chunkwise form of "Tiled Flash
//   Linear Attention" (Beck et al., arXiv 2503.14376), chunks of L = 64 rows.
//   - (a) `mlstm_fwd_state_kernel`, the recurrence: grid (hd/MB row blocks x
//     hd/BV v-tiles, H, B), 128 blocks of 12 warps at the training shape,
//     one wave (a second wave would run the whole recurrence again). A
//     block walks the chunks in turn holding C[d0:d0+MB, v0:v0+BV] in fp32
//     registers (a warp owns one m16 row tile of hd_k) and, per chunk,
//     records the state at the chunk's start (C in bf16, staged in shared
//     memory and stored 16 bytes a lane; n and m in fp32; in scratch the
//     wrapper allocates), then adds (w_upd * k)^T v by
//     mma.sync.m16n8k16. The state out must keep fp32's 1e-4, so w_upd * k
//     (fp32) is split in registers into three bf16 parts, hi + mid + lo, each
//     multiplied by v (bf16, exact) into one fp32 accumulator: two parts
//     would leave 2^-16 of each product, a third of the tolerance. The decay
//     of C, n's update and the gates stay fp32 on the CUDA cores (the v-tile
//     0 blocks own n, one of them m). k and v come in by cp.async a chunk
//     ahead; one barrier a chunk, the next chunk's gates worked out by the
//     last warp while the others multiply.
//   - (b) `mlstm_fwd_out_kernel`, every chunk at once: grid (chunk, v-tile,
//     B H), 256 blocks of 4 warps of 16 rows at the training shape (2
//     v-tiles of 192 columns). It reduces over hd in slices of 32 through a
//     2-stage cp.async ring of q, k and the chunk-start C tile: S = q k^T and
//     q C by mma.sync, q.n in fp32 on the CUDA cores. Then, in fp32, the scale
//     1/sqrt(hd) (no power of two: applied after the products), the decay
//     mask in the exp2 domain (ex2.approx; masked entries -inf, weight 0),
//     the denominator from the row sums of P = S * D and q.n, and
//     y = (P v + e^{b_i + m_run - m_i} q C) / den with P rounded to bf16 for
//     its mma; y is stored in bf16.
//   - No atomics: results repeat bit for bit. Only y uses bf16 chunk-start
//     states and bf16 P tiles (its tolerance is 5e-2).
//   - Every row start of q, k, v must be 16-byte aligned (the wrapper checks).
//
// fp32: `mlstm_fwd_kernel`, the first design, unchanged: fp32 math on the
//   CUDA cores (no TF32), which the card-vs-CPU parity needs.
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
// The kernels launch on the caller's stream, allocate nothing and do not
// synchronize; the C entry points return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_mma.cuh"

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

template <int HD>
constexpr size_t smem_floats() {
  return 2 * size_t(BC) * (HD + 1)   // q, k tiles
         + size_t(BC) * LDV          // v tile
         + size_t(BC) * LDS          // decayed scores
         + size_t(HD) * BV           // C slice
         + HD                        // n
         + 7 * size_t(BC);           // bcum, log_i, w_state, den, w_upd, scalars
}

template <int HD>
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

  const float* qp = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kp = static_cast<const float*>(a.k) + b * a.k_sb + h * a.k_sh;
  const float* vp =
      static_cast<const float*>(a.v) + b * a.v_sb + h * a.v_sh + v0;
  const float* lip = a.li + b * a.li_sb + h * a.li_sh;
  const float* lfp = a.lf + b * a.lf_sb + h * a.lf_sh;
  float* yp = static_cast<float*>(a.y) + b * a.y_sb + h * a.y_sh + v0;
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
      Qs[r * LD + c] = in ? qp[t * a.q_ss + c] * scale : 0.f;
      Ks[r * LD + c] = in ? kp[t * a.k_ss + c] : 0.f;
    }
    for (int x = tid; x < BC * BV; x += NT) {
      const int r = x / BV, c = x % BV;
      Vs[r * LDV + c] = r < L ? vp[(t0 + r) * a.v_ss + c] : 0.f;
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
          yp[(t0 + i) * a.y_ss + tx + 8 * r] = (sv[r] + ws * qc[r]) / den;
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

template <int HD>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * smem_floats<HD>();
  static_assert(smem <= 232448, "shared memory beyond the 227 KB of a block");
  // Above 48 KB dynamic shared memory must be opted into, once per
  // instantiation.
  static const cudaError_t attr = cudaFuncSetAttribute(
      mlstm_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (attr != cudaSuccess) return attr;
  const dim3 grid(HD / BV, a.H, a.B);
  mlstm_fwd_kernel<HD><<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t dispatch_head_dim(const Args& a, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<32>(a, stream);
    case 64: return launch<64>(a, stream);
    case 256: return launch<256>(a, stream);
    case 384: return launch<384>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ------------------------------------------------------------------ bf16

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int L = 64;                          // chunk rows
constexpr int NB = 128;                        // pass (b) threads: 4 warps
constexpr float kLog2e = 1.4426950408889634f;

// Tile shapes by head dim. Pass (a): blocks of MB rows x BV columns of C,
// one m16 row tile a warp (WA = MB / 16 warps), NM x NV blocks a head:
// 8 at hd 384 and 256, so B = 4 H = 4 is 128 blocks, one wave on 132 SMs
// (the recurrence is latency-bound; a second wave would double it). Pass
// (b): BO v-columns a block (NO v-tiles: 2 at hd 384 and 256, so q and k
// are read twice, not hd/64 times), the hd reduction in slices of KD = 32.
// Both chosen by timing alternatives on the H100 at the training shape.
// Row strides are padded by 16 bytes so ldmatrix's 8 row addresses fall in
// 8 distinct groups of 4 banks.
template <int HD>
struct Shape {
  static constexpr int MB = HD >= 256 ? HD / 2 : HD;
  static constexpr int BV = HD >= 256 ? HD / 4 : HD;
  static constexpr int WA = MB / 16;
  static constexpr int NA = 32 * WA;
  static constexpr int NM = HD / MB;
  static constexpr int NV = HD / BV;
  static constexpr int LDK = MB + 8;
  static constexpr int LDV = BV + 8;
  static constexpr int BO = HD >= 256 ? HD / 2 : HD;
  static constexpr int NO = HD / BO;
  static constexpr int KD = 32;
  static constexpr int LDS = KD + 8;
  static constexpr int LDO = BO + 8;
  static constexpr int LDC = BV + 8;   // the chunk-start tile, staged
  static constexpr size_t state_bytes =
      sizeof(bf16) * size_t(2 * L * LDK + 2 * L * LDV + MB * LDC) +
      sizeof(float) * (4 * L + 4);
  static constexpr size_t out_bytes =
      sizeof(bf16) * size_t(2 * L * LDS * 2 + 2 * KD * LDO + L * LDO) +
      sizeof(float) * size_t(HD + 2 * L);
};
struct TcArgs {
  Args a;
  bf16* cst;     // (B H, NC, hd, hd) C at each chunk's start, bf16
  float* nst;    // (B H, NC, hd) n at each chunk's start
  float* mst;    // (B H, NC) m at each chunk's start
  int NC;        // chunks of L rows
};

// L rows [row0, row0 + L) of W bf16 columns of a strided operand -> shared
// rows of stride LD, 16 bytes a cp.async; rows at or past `end` are
// zero-filled.
template <int W, int LD, int NT>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          int64_t stride, int row0, int end,
                                          int tid) {
  constexpr int CH = W / 8;
  for (int e = tid; e < L * CH; e += NT) {
    const int r = e / CH, c = e % CH, gr = row0 + r;
    const bool in = gr < end;
    repro_ptx::cp_async_16(dst + r * LD + c * 8,
                           in ? src + int64_t(gr) * stride + c * 8 : src, in);
  }
}

// The gates of chunk rows [t0, t0 + L), by one warp (two rows a lane):
// `gate_load` reads log_f and log_i (rows at or past S get log_f = 0, so
// bcum stays at the last row's, and log_i = -inf, weight 0 everywhere);
// `gate_scan` writes bcum = the inclusive cumsum of log_f over the chunk,
// and log_i, to shared memory.
__device__ __forceinline__ void gate_load(const float* lip, const float* lfp,
                                          int64_t li_ss, int64_t lf_ss,
                                          int t0, int S, int lane,
                                          float (&f)[2], float (&ig)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = t0 + lane + 32 * r;
    const bool in = t < S;
    f[r] = in ? lfp[int64_t(t) * lf_ss] : 0.f;
    ig[r] = in ? lip[int64_t(t) * li_ss] : -INFINITY;
  }
}

__device__ __forceinline__ void gate_scan(const float (&f)[2],
                                          const float (&ig)[2], float* bcum,
                                          float* lis, int lane) {
  float cum[2] = {f[0], f[1]};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, cum[r], off);
      if (lane >= off) cum[r] += up;
    }
  }
  cum[1] += __shfl_sync(0xffffffffu, cum[0], 31);
  bcum[lane] = cum[0];
  bcum[lane + 32] = cum[1];
  lis[lane] = ig[0];
  lis[lane + 32] = ig[1];
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<const uint32_t*>(&x);
}

// Two bf16 keys (one bf16x2 fragment register) times their weights, in
// fp32, split into three bf16x2 parts hi + mid + lo equal to the products
// to about 2^-24 of each.
__device__ __forceinline__ void split3(uint32_t k2, float w_lo, float w_hi,
                                       uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  const __nv_bfloat162 k = *reinterpret_cast<const __nv_bfloat162*>(&k2);
  const float a0 = w_lo * __low2float(k), a1 = w_hi * __high2float(k);
  const __nv_bfloat162 h = __floats2bfloat162_rn(a0, a1);
  const float r0 = a0 - __low2float(h), r1 = a1 - __high2float(h);
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  hi = bits(h);
  mid = bits(m);
  lo = bits(__floats2bfloat162_rn(r0 - __low2float(m), r1 - __high2float(m)));
}

// Pass (a): the recurrence. Block (row block mb, v-tile vt) of (h, b) owns
// C[d0:d0+MB, v0:v0+BV] and walks the chunks in turn; the vt = 0 blocks
// also carry n[d0:d0+MB], block (0, 0) m. One barrier a chunk: the last warp
// (which carries no n) works out the next chunk's gates while the others
// multiply, into the other of two gate buffers, with its loads issued a
// chunk ahead.
template <int HD>
__global__ void __launch_bounds__(Shape<HD>::NA, 1)
    mlstm_fwd_state_kernel(TcArgs t) {
  using Sh = Shape<HD>;
  constexpr int BV = Sh::BV, MB = Sh::MB, NA = Sh::NA;
  constexpr int LDK = Sh::LDK, LDV = Sh::LDV;
  constexpr int NN = BV / 8;                  // n8 tiles of the C tile
  constexpr int GW = Sh::WA - 1;              // the gate warp
  static_assert(GW * 32 >= MB, "the gate warp must carry no n");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);    // 2 stages of L x LDK
  bf16* Vs = Ks + 2 * L * LDK;                     // 2 stages of L x LDV
  bf16* Cb = Vs + 2 * L * LDV;                     // MB x LDC, C in bf16
  float* wup = reinterpret_cast<float*>(Cb + MB * Sh::LDC);  // 2 x L w_upd
  float* scal = wup + 2 * L;                       // 2 x (m_next, decay)
  float* bcum = scal + 4;                          // the gate warp's scratch
  float* lis = bcum + L;

  const Args& a = t.a;
  const int vt = blockIdx.x % Sh::NV, mb = blockIdx.x / Sh::NV;
  const int h = blockIdx.y, b = blockIdx.z;
  const int v0 = vt * BV, d0 = mb * MB;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int64_t bh = int64_t(b) * a.H + h;
  const bool owner = vt == 0;          // carries n[d0:d0+MB]
  const int nd = d0 + tid;             // ... entry nd, for tid < MB
  const bf16* kp =
      static_cast<const bf16*>(a.k) + b * a.k_sb + h * a.k_sh + d0;
  const bf16* vp =
      static_cast<const bf16*>(a.v) + b * a.v_sb + h * a.v_sh + v0;
  const float* lip = a.li + b * a.li_sb + h * a.li_sh;
  const float* lfp = a.lf + b * a.lf_sb + h * a.lf_sh;

  load_rows<MB, LDK, NA>(Ks, kp, a.k_ss, 0, a.S, tid);
  load_rows<BV, LDV, NA>(Vs, vp, a.v_ss, 0, a.S, tid);
  repro_ptx::cp_async_commit();

  float m_run = a.m0 ? a.m0[bh] : 0.f;
  // the gate warp: w_upd_j = e^{b_L - b_j + log_i_j - m_next} and decay =
  // e^{b_L + m - m_next} of chunk c into buffer c & 1, with the accurate
  // expf (the state out is held to fp32's 1e-4); returns m_next
  float gf[2], gi[2];
  auto gates = [&](int c, float m_prev) {
    gate_scan(gf, gi, bcum, lis, lane);
    __syncwarp();
    const float btot = bcum[L - 1];
    const float g0 = btot - bcum[lane] + lis[lane];
    const float g1 = btot - bcum[lane + 32] + lis[lane + 32];
    float mx = fmaxf(g0, g1);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_next = fmaxf(btot + m_prev, mx);
    float* w = wup + (c & 1) * L;
    w[lane] = expf(g0 - m_next);
    w[lane + 32] = expf(g1 - m_next);
    if (lane == 0) {
      scal[2 * (c & 1)] = m_next;
      scal[2 * (c & 1) + 1] = expf(btot + m_prev - m_next);
    }
    __syncwarp();   // bcum and lis are read before the next chunk's scan
    return m_next;
  };
  float m_gate = 0.f;   // the gate warp's m after the last chunk it did
  if (warp == GW) {
    gate_load(lip, lfp, a.li_ss, a.lf_ss, 0, a.S, lane, gf, gi);
    m_gate = gates(0, m_run);
    if (t.NC > 1) gate_load(lip, lfp, a.li_ss, a.lf_ss, L, a.S, lane, gf, gi);
  }

  // the C tile in registers: warp w's rows d = d0 + 16 w + g (+8), columns
  // v0 + 8 ni + 2 tq (+1)
  const int dw = d0 + warp * 16;
  float acc[NN][4];
#pragma unroll
  for (int ni = 0; ni < NN; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = dw + g + (e >> 1) * 8;
      const int col = v0 + ni * 8 + 2 * tq + (e & 1);
      acc[ni][e] = a.c0 ? a.c0[(bh * HD + d) * HD + col] : 0.f;
    }
  float n_run = (a.n0 && owner && tid < MB) ? a.n0[bh * HD + nd] : 0.f;

  for (int c = 0; c < t.NC; ++c) {
    const int st = c & 1;
    repro_ptx::cp_async_wait<0>();   // k and v of chunk c have landed
    __syncthreads();                 // ... for all, with chunk c's gates;
                                     // stage st ^ 1 and gate buffer st ^ 1
                                     // (chunk c - 1's) are free
    if (c + 1 < t.NC) {
      load_rows<MB, LDK, NA>(Ks + (st ^ 1) * L * LDK, kp, a.k_ss, (c + 1) * L,
                             a.S, tid);
      load_rows<BV, LDV, NA>(Vs + (st ^ 1) * L * LDV, vp, a.v_ss, (c + 1) * L,
                             a.S, tid);
      repro_ptx::cp_async_commit();
    }
    // the state at the chunk's start, for pass (b): each warp stages its
    // 16 rows in bf16 and stores them 16 bytes a lane, whole rows at once
    {
      constexpr int LDC = Sh::LDC, CH = BV / 8;
      bf16* cw = Cb + warp * 16 * LDC;
      __syncwarp();   // the warp's stores of the last chunk have read cw
#pragma unroll
      for (int ni = 0; ni < NN; ++ni)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<uint32_t*>(cw + (g + 8 * r) * LDC + ni * 8 +
                                       2 * tq) =
              repro_ptx::pack_bf16x2(acc[ni][2 * r], acc[ni][2 * r + 1]);
      __syncwarp();
      bf16* cs = t.cst + ((bh * t.NC + c) * HD + dw) * HD + v0;
#pragma unroll
      for (int e = lane; e < 16 * CH; e += 32) {
        const int r = e / CH, cc = e % CH;
        *reinterpret_cast<uint4*>(cs + r * HD + cc * 8) =
            *reinterpret_cast<const uint4*>(cw + r * LDC + cc * 8);
      }
      if (owner && tid < MB) t.nst[(bh * t.NC + c) * HD + nd] = n_run;
      if (owner && mb == 0 && tid == 0) t.mst[bh * t.NC + c] = m_run;
    }
    const float* w = wup + st * L;
    const float decay = scal[2 * st + 1];
    m_run = scal[2 * st];
#pragma unroll
    for (int ni = 0; ni < NN; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[ni][e] *= decay;

    // C += (w_upd k)^T v: A = (w_upd k)^T from k's rows by ldmatrix.trans,
    // weighted and split in registers; B = v by ldmatrix.trans
    const bf16* Kt = Ks + st * L * LDK;
    const bf16* Vt = Vs + st * L * LDV;
#pragma unroll
    for (int kk = 0; kk < L / 16; ++kk) {
      const int j = kk * 16 + 2 * tq;
      uint32_t kr[4], hi[4], mid[4], lo[4];
      repro_ptx::ldmatrix_x4_trans(
          kr, Kt + (kk * 16 + ((lane >> 4) << 3) + (lane & 7)) * LDK +
                  warp * 16 + ((lane >> 3) & 1) * 8);
      split3(kr[0], w[j], w[j + 1], hi[0], mid[0], lo[0]);
      split3(kr[1], w[j], w[j + 1], hi[1], mid[1], lo[1]);
      split3(kr[2], w[j + 8], w[j + 9], hi[2], mid[2], lo[2]);
      split3(kr[3], w[j + 8], w[j + 9], hi[3], mid[3], lo[3]);
#pragma unroll
      for (int np = 0; np < NN / 2; ++np) {
        uint32_t r[4];
        repro_ptx::ldmatrix_x4_trans(
            r, Vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDV +
                   np * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float (&cacc)[4] = acc[2 * np + half];
          repro_ptx::mma_bf16_16816(cacc, hi, r[2 * half], r[2 * half + 1]);
          repro_ptx::mma_bf16_16816(cacc, mid, r[2 * half], r[2 * half + 1]);
          repro_ptx::mma_bf16_16816(cacc, lo, r[2 * half], r[2 * half + 1]);
        }
      }
    }
    if (owner && tid < MB) {
      // n = decay n + sum_j w_upd_j k_j in fp32, four partial sums
      float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int jj = 0; jj < L; jj += 4)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          part[q] = fmaf(w[jj + q], __bfloat162float(Kt[(jj + q) * LDK + tid]),
                         part[q]);
      n_run = decay * n_run + ((part[0] + part[1]) + (part[2] + part[3]));
    }
    if (warp == GW && c + 1 < t.NC) {
      m_gate = gates(c + 1, m_gate);
      if (c + 2 < t.NC)
        gate_load(lip, lfp, a.li_ss, a.lf_ss, (c + 2) * L, a.S, lane, gf, gi);
    }
  }

  // the state out, fp32
#pragma unroll
  for (int ni = 0; ni < NN; ++ni)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float2*>(a.c1 + (bh * HD + dw + g + 8 * r) * HD + v0 +
                                 ni * 8 + 2 * tq) =
          make_float2(acc[ni][2 * r], acc[ni][2 * r + 1]);
  if (owner && tid < MB) a.n1[bh * HD + nd] = n_run;
  if (owner && mb == 0 && tid == 0) a.m1[bh] = m_run;
}

// Pass (b): y of chunk blockIdx.x, v columns of tile blockIdx.y, of (b, h)
// = blockIdx.z, from the chunk's start state. Warp w owns rows 16w..16w+15.
template <int HD>
__global__ void __launch_bounds__(NB) mlstm_fwd_out_kernel(TcArgs t) {
  using Sh = Shape<HD>;
  constexpr int BV = Sh::BO, KD = Sh::KD, LDS = Sh::LDS, LDV = Sh::LDO;
  constexpr int NN = BV / 8;    // n8 tiles of y and q C
  constexpr int NS = L / 8;     // n8 tiles of S
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);    // 2 stages of L x LDS
  bf16* Ks = Qs + 2 * L * LDS;                     // 2 stages of L x LDS
  bf16* Cs = Ks + 2 * L * LDS;                     // 2 stages of KD x LDV
  bf16* Vs = Cs + 2 * KD * LDV;                    // L x LDV
  float* Ns = reinterpret_cast<float*>(Vs + L * LDV);   // hd
  float* bcum = Ns + HD;
  float* lis = bcum + L;

  const Args& a = t.a;
  const int c = blockIdx.x, vt = blockIdx.y, bhi = blockIdx.z;
  const int b = bhi / a.H, h = bhi % a.H;
  const int64_t bh = bhi;
  const int v0 = vt * BV, t0 = c * L;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int wrow = warp * 16;
  const bf16* qp = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const bf16* kp = static_cast<const bf16*>(a.k) + b * a.k_sb + h * a.k_sh;
  const bf16* vp =
      static_cast<const bf16*>(a.v) + b * a.v_sb + h * a.v_sh + v0;
  const bf16* cp = t.cst + (bh * t.NC + c) * HD * HD + v0;

  // one cp.async group a slice: q, k and C rows of hd slice `sl`
  auto load_slice = [&](int sl, int stage) {
    load_rows<KD, LDS, NB>(Qs + stage * L * LDS, qp + sl * KD, a.q_ss, t0,
                           a.S, tid);
    load_rows<KD, LDS, NB>(Ks + stage * L * LDS, kp + sl * KD, a.k_ss, t0,
                           a.S, tid);
    constexpr int CH = BV / 8;
    for (int e = tid; e < KD * CH; e += NB) {
      const int r = e / CH, cc = e % CH;
      repro_ptx::cp_async_16(Cs + stage * KD * LDV + r * LDV + cc * 8,
                             cp + int64_t(sl * KD + r) * HD + cc * 8, true);
    }
  };
  load_rows<BV, LDV, NB>(Vs, vp, a.v_ss, t0, a.S, tid);
  load_slice(0, 0);
  repro_ptx::cp_async_commit();
  if (warp == 0) {
    float f[2], ig[2];
    gate_load(a.li + b * a.li_sb + h * a.li_sh,
              a.lf + b * a.lf_sb + h * a.lf_sh, a.li_ss, a.lf_ss, t0, a.S,
              lane, f, ig);
    gate_scan(f, ig, bcum, lis, lane);
  }
  for (int d = tid; d < HD; d += NB) Ns[d] = t.nst[(bh * t.NC + c) * HD + d];
  const float mc = t.mst[bh * t.NC + c];

  float s[NS][4], o[NN][4];
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int j = 0; j < NN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  // q.n in fp32: lane l sums row wrow + l % 16 over half l / 16 of a slice
  float qn = 0.f;
  const int qrow = wrow + (lane & 15), qhalf = (lane >> 4) * (KD / 2);

  for (int sl = 0; sl < HD / KD; ++sl) {
    const int st = sl & 1;
    repro_ptx::cp_async_wait<0>();
    __syncthreads();
    if (sl + 1 < HD / KD) {
      load_slice(sl + 1, st ^ 1);
      repro_ptx::cp_async_commit();
    }
    const bf16* Qt = Qs + st * L * LDS;
    const bf16* Kt = Ks + st * L * LDS;
    const bf16* Ct = Cs + st * KD * LDV;
#pragma unroll
    for (int kk = 0; kk < KD / 16; ++kk) {
      uint32_t qa[4];
      repro_ptx::ldmatrix_x4(
          qa, Qt + (wrow + (lane & 15)) * LDS + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t r[4];
        repro_ptx::ldmatrix_x4(
            r, Kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDS +
                   kk * 16 + ((lane >> 3) & 1) * 8);
        repro_ptx::mma_bf16_16816(s[2 * np], qa, r[0], r[1]);
        repro_ptx::mma_bf16_16816(s[2 * np + 1], qa, r[2], r[3]);
      }
#pragma unroll
      for (int np = 0; np < NN / 2; ++np) {
        uint32_t r[4];
        repro_ptx::ldmatrix_x4_trans(
            r, Ct + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDV +
                   np * 16 + (lane >> 4) * 8);
        repro_ptx::mma_bf16_16816(o[2 * np], qa, r[0], r[1]);
        repro_ptx::mma_bf16_16816(o[2 * np + 1], qa, r[2], r[3]);
      }
    }
#pragma unroll 8
    for (int dd = 0; dd < KD / 2; ++dd)
      qn = fmaf(__bfloat162float(Qt[qrow * LDS + qhalf + dd]),
                Ns[sl * KD + qhalf + dd], qn);
  }
  qn += __shfl_xor_sync(0xffffffffu, qn, 16);

  // rows g and g + 8 of the warp: decay weights, P = S D, the denominator
  const float scale = 1.0f / sqrtf(float(HD));
  float den[2], ws[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = wrow + g + 8 * r;
    const float bi = bcum[i];
    const float qni = __shfl_sync(0xffffffffu, qn, g + 8 * r) * scale;
    float mx = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = nt * 8 + 2 * tq + e;
        if (j <= i) mx = fmaxf(mx, bi - bcum[j] + lis[j]);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float mi = fmaxf(mx, bi + mc);
    const float ml2 = mi * kLog2e;
    float rs = 0.f;
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = nt * 8 + 2 * tq + e;
        const float ld = j <= i ? bi - bcum[j] + lis[j] : -INFINITY;
        const float p = s[nt][2 * r + e] * scale *
                        repro_ptx::exp2_approx(fmaf(ld, kLog2e, -ml2));
        s[nt][2 * r + e] = p;
        rs += p;
      }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    ws[r] = expf(bi + mc - mi);
    den[r] = fmaxf(fabsf(rs + ws[r] * qni), expf(-mi));
  }
  // o = w_state q C, then += P v with P rounded to bf16
#pragma unroll
  for (int ni = 0; ni < NN; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[ni][e] *= scale * ws[e >> 1];
#pragma unroll
  for (int kk = 0; kk < L / 16; ++kk) {
    uint32_t pa[4];
    pa[0] = repro_ptx::pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
    pa[1] = repro_ptx::pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
    pa[2] = repro_ptx::pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    pa[3] = repro_ptx::pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
    for (int np = 0; np < NN / 2; ++np) {
      uint32_t r[4];
      repro_ptx::ldmatrix_x4_trans(
          r, Vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDV +
                 np * 16 + (lane >> 4) * 8);
      repro_ptx::mma_bf16_16816(o[2 * np], pa, r[0], r[1]);
      repro_ptx::mma_bf16_16816(o[2 * np + 1], pa, r[2], r[3]);
    }
  }
  bf16* yp = static_cast<bf16*>(a.y) + b * a.y_sb + h * a.y_sh + v0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = t0 + wrow + g + 8 * r;
    if (row < a.S) {
#pragma unroll
      for (int ni = 0; ni < NN; ++ni)
        *reinterpret_cast<uint32_t*>(yp + int64_t(row) * a.y_ss + ni * 8 +
                                     2 * tq) =
            repro_ptx::pack_bf16x2(o[ni][2 * r] / den[r],
                                   o[ni][2 * r + 1] / den[r]);
    }
  }
}

template <int HD>
cudaError_t launch(const TcArgs& t, cudaStream_t stream) {
  using Sh = Shape<HD>;
  static_assert(Sh::state_bytes <= 232448 && Sh::out_bytes <= 232448,
                "shared memory beyond the 227 KB of a block");
  static const cudaError_t attr_a = cudaFuncSetAttribute(
      mlstm_fwd_state_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(Sh::state_bytes));
  static const cudaError_t attr_b = cudaFuncSetAttribute(
      mlstm_fwd_out_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(Sh::out_bytes));
  if (attr_a != cudaSuccess) return attr_a;
  if (attr_b != cudaSuccess) return attr_b;
  mlstm_fwd_state_kernel<HD><<<dim3(Sh::NV * Sh::NM, t.a.H, t.a.B), Sh::NA,
                               Sh::state_bytes, stream>>>(t);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mlstm_fwd_out_kernel<HD>
      <<<dim3(t.NC, Sh::NO, t.a.B * t.a.H), NB, Sh::out_bytes, stream>>>(t);
  return cudaGetLastError();
}

cudaError_t dispatch_head_dim(const TcArgs& t, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<32>(t, stream);
    case 64: return launch<64>(t, stream);
    case 256: return launch<256>(t, stream);
    case 384: return launch<384>(t, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc

}  // namespace

extern "C" {

// float32 q, k, v and y on the CUDA cores: dtype must be 0 (= float32).
// Gates and state are float32. Strides are in elements, for the (B, H, S[, hd]) view of each
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
  if (dtype == 0) return int(dispatch_head_dim(a, hd, s));
  return int(cudaErrorInvalidValue);
}

// bf16 q, k, v and y on the tensor cores, in two launches (the recurrence,
// then every chunk's output); arguments as above, plus the chunk-start
// state scratch the wrapper allocates: cst (B H, NC, hd, hd) bf16, nst
// (B H, NC, hd) and mst (B H, NC) fp32, NC = ceil(S / 64). Every row start
// of q, k and v must be 16-byte aligned. Returns cudaGetLastError() after
// the launches (0 on success).
int repro_mlstm_scan_fwd_bf16(
    const void* q, const void* k, const void* v,
    const float* li, const float* lf,
    const float* c0, const float* n0, const float* m0,
    void* y, float* c1, float* n1, float* m1,
    void* cst, float* nst, float* mst,
    int B, int H, int S, int hd,
    int64_t q_sb, int64_t q_sh, int64_t q_ss,
    int64_t k_sb, int64_t k_sh, int64_t k_ss,
    int64_t v_sb, int64_t v_sh, int64_t v_ss,
    int64_t li_sb, int64_t li_sh, int64_t li_ss,
    int64_t lf_sb, int64_t lf_sh, int64_t lf_ss,
    int64_t y_sb, int64_t y_sh, int64_t y_ss,
    void* stream) {
  tc::TcArgs t{Args{q, k, v, li, lf, c0, n0, m0, y, c1, n1, m1,
                    q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
                    li_sb, li_sh, li_ss, lf_sb, lf_sh, lf_ss, y_sb, y_sh, y_ss,
                    B, H, S},
               static_cast<tc::bf16*>(cst), nst, mst, (S + tc::L - 1) / tc::L};
  return int(tc::dispatch_head_dim(t, hd, static_cast<cudaStream_t>(stream)));
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
