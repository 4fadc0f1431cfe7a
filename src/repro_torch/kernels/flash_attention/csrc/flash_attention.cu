// Flash attention for Hopper (sm_90a), forward and backward, written by hand
// in CUDA C++.
//
// The forward replaces the Pallas TPU kernel `_flash_kernel` in
// src/repro/kernels/flash_attention/kernel.py:27 (wrapper `flash_attention`
// :84, `pl.pallas_call` :98), and computes what it computes:
//   out = softmax(z + mask) v,  z = q k^T / sqrt(hd)
// with causal and sliding-window masks from absolute indices (masked scores
// are -1e30, keys past T -inf), GQA (q-head h reads kv-head h / (H / Hkv)),
// an online softmax whose running max m, sum l and accumulator acc are
// fp32, l floored at 1e-30, P rounded to v's type before P.V (kernel.py:72),
// and the output in the input type (fp32 or bf16). Two things the Pallas
// kernel lacks and the reference's `blockwise_sdpa`
// (src/repro/models/attention.py:76) has: logit softcapping, z = c tanh(z /
// c) for a softcap c > 0, taken after the scale and before the mask
// (attention.py:114), and the log-sum-exp of each row, lse = m + log(l) in
// fp32 (attention.py:139), written where the caller asks for it (training)
// and not otherwise (serving).
//
// bf16 at head_dim 64, 128, 192 and 256 runs the wgmma + TMA forward of
// flash_attention_fwd_sm90.cu (`ops.fwd_path`); this file serves fp32 at
// every head_dim and bf16 at 32. The backward, the reference's
// `_blockwise_bwd` (attention.py:153) written for the card, is
// flash_attention_bwd.cu and flash_attention_bwd_sm90.cu (the Pallas kernel
// has none).
//
// What bounds it on the H100. At stablelm-1.6b prefill (B=2, H=32, S=2048,
// hd=64, causal, bf16) the function does 34.4 GFLOP over the causal pairs
// and must move 67.1 MB: 35 us at the 989 TFLOP/s of the bf16 tensor cores
// against 20 us at 3.35 TB/s. At jamba's prefill (B=2, H=64 over 8 kv heads,
// hd=128) 137.5 GFLOP against 151.0 MB: 139 us against 45 us. Both are operations-bound, so
// the products belong on the tensor cores.
//
// Two designs, chosen by dtype in the C entry point:
//
// bf16 at hd 32: `flash_fwd_mma_kernel`, FlashAttention-2 in shape (a
//   64-byte row is half of the 128-byte swizzled box the wgmma forward
//   reads).
//   - One block per (head, batch, q-tile of 128 rows); q-tiles are the
//     slowest grid axis, longest causal tiles first. A warp owns 32 whole
//     rows, sharing each K and V fragment between two m16 tiles, so row
//     max and row sum stay in the warp (two quad shuffles). `Config` holds
//     the tile shape.
//   - q, K and V come in by cp.async, 16 bytes a thread, into shared rows
//     padded by 16 bytes (ldmatrix's 8 row addresses then fall in 8
//     distinct groups of 4 banks). K and V sit in a ring of 2 stages: the
//     copy of tile j+1 is in flight while tile j is multiplied, and one
//     barrier a tile both publishes tile j and frees the stage of j-1.
//   - q moves into mma A fragments by ldmatrix.x4, once for the whole KV
//     loop. S = q K^T runs as
//     mma.sync.m16n8k16 bf16 with fp32 accumulation, K's rows taken as the
//     .col operand as they lie (ldmatrix.x4).
//   - Masks are applied only on tiles that touch the causal diagonal, the
//     window's edge or the end of T; the KV range of a q-tile is bounded so
//     fully masked tiles are never visited. The softmax runs in fp32 with
//     ex2.approx, `scale * log2(e)` folded into one fma. Masked scores are
//     -inf here, and a row that has seen no key yet keeps weight 0: the
//     Pallas kernel's -1e30 weighs such a row 1 until a key arrives and
//     then scales it by exp(-1e30 - m) = 0, so the two agree on every row
//     that sees a key, which the wrapper's checks guarantee.
//   - P goes from the C fragments straight into bf16 A fragments (the
//     m16n8k16 C layout is the A layout), V through ldmatrix.x4.trans: no
//     shared-memory round trip.
//   - The epilogue divides by max(l, 1e-30), rounds to bf16, stages the
//     warp's rows in the q tile's shared memory and stores 16 bytes a
//     thread. Every row start must be 16-byte aligned (the wrapper checks
//     the pointers and strides and raises otherwise).
//   The wider bf16 heads have taken the next step (wgmma fed by TMA, warp
//   specialisation: flash_attention_fwd_sm90.cu).
//
// fp32: `flash_fwd_kernel`, the first design. The card-vs-CPU
//   parity runs the model in fp32 and needs full fp32 products (no TF32),
//   so q, K and V are staged in shared memory as fp32 with a padded row
//   stride, scores and P.V are fp32 FMAs on the CUDA cores, 4 rows x 8
//   columns a thread (2 rows at hd 192 and 256, `F32Rows`), and P goes
//   through shared memory. It runs at the fp32 CUDA-core rate.
//
// Softcapping takes the accurate `tanhf` on both paths (not tanh.approx,
// whose 2^-11 relative error would move a logit capped at 50 by 0.02).
//
// Both take ragged S and T (the serve path's prompts are 8 to 64 tokens):
// rows past S are not stored and keys past T get weight exactly 0, where the
// Pallas wrapper asserts divisibility. q, k, v and out are read and written
// by strides, so the model's (B,S,H,hd) activations need no transpose; the
// last axis must be contiguous. A kernel launches on the caller's stream,
// allocates nothing and does not synchronize; the C entry point returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "hopper_mma.cuh"

namespace {

constexpr int BK = 64;        // kv columns per tile
constexpr int NT = 128;       // threads per block: 16 row groups x 8 lanes
constexpr int LDP = BK + 1;   // padded row stride of the P tile
constexpr float kMaskValue = -1e30f;

// fp32 path: q rows a thread, and so 16 ROWS q rows a block. A thread
// accumulates ROWS x HD/8 outputs: 4 rows up to hd 128 (64 fp32
// accumulators at 128). Above it 4 rows would take 96 and 128 of the 255
// registers beside the scores, operands and addresses: 2 rows (48 and 64).
template <int HD> struct F32Rows {
  static constexpr int ROWS = HD > 128 ? 2 : 4;
  static constexpr int BQ = 16 * ROWS;
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;   // (B, H, S) fp32, natural log; null: not written
  int64_t q_sb, q_sh, q_ss;
  int64_t k_sb, k_sh, k_st;
  int64_t v_sb, v_sh, v_st;
  int64_t o_sb, o_sh, o_ss;
  int B, H, Hkv, S, T;
  int causal, window;
  float softcap;   // > 0: z = softcap tanh(z / softcap)
};

template <int HD>
constexpr size_t smem_bytes() {
  constexpr int BQ = F32Rows<HD>::BQ;
  return sizeof(float) * (size_t(BQ) * (HD + 1) + 2 * size_t(BK) * (HD + 1) +
                          size_t(BQ) * LDP);
}

// Thread layout: tid = ty * 8 + tx. A thread owns q rows ty*R .. ty*R+R-1
// of the tile (R = F32Rows<HD>::ROWS), score columns tx + 8j (j < 8) and
// output channels tx + 8c (c < HD/8). The 8 lanes that share a row group
// sit in one warp, so row max and row sum reduce with three xor-shuffles.
template <typename T, int HD>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(Args a) {
  static_assert(HD % 32 == 0, "head_dim must be a multiple of 32");
  constexpr int LD = HD + 1;
  constexpr int NC = HD / 8;
  constexpr int R = F32Rows<HD>::ROWS;
  constexpr int BQ = F32Rows<HD>::BQ;
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

  float m[R], l[R], acc[R][NC];
#pragma unroll
  for (int i = 0; i < R; ++i) {
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

    float s[R][8];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[R], kv[8];
#pragma unroll
      for (int i = 0; i < R; ++i) qv[i] = Qs[(ty * R + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = Ks[(tx + 8 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qi = q0 + ty * R + i;
      float row_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kj = k0 + tx + 8 * j;
        float x = s[i][j];
        if (kj >= a.T) {
          x = -INFINITY;  // past the end of the keys: weight exactly 0
        } else {
          if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
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
        Ps[(ty * R + i) * LDP + tx + 8 * j] = p;
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
      float pv[R], vv[NC];
#pragma unroll
      for (int i = 0; i < R; ++i) pv[i] = Ps[(ty * R + i) * LDP + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = Vs[j * LD + tx + 8 * c];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
    __syncwarp();  // P reads are done before the next tile overwrites it
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qi = q0 + ty * R + i;
    if (qi < a.S) {
      const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int c = 0; c < NC; ++c)
        op[qi * a.o_ss + tx + 8 * c] = from_float<T>(acc[i][c] / denom);
      if (a.lse != nullptr && tx == 0)
        a.lse[(int64_t(b) * a.H + h) * a.S + qi] = m[i] + logf(denom);
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  static_assert(smem <= 232448, "shared memory beyond a block's 227 KB");
  // Above 48 KB dynamic shared memory must be opted into, once per
  // instantiation.
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (attr != cudaSuccess) return attr;
  constexpr int BQ = F32Rows<HD>::BQ;
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
    case 192: return launch<T, 192>(a, stream);
    case 256: return launch<T, 256>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}


// ------------------------------------------------- bf16 on the tensor cores

namespace tc {

using bf16 = __nv_bfloat16;

// The tile shape: each warp owns MI m16-tiles (16 MI whole rows), a block
// WARPS warps (BQ = 16 MI WARPS q rows), a KV tile BKV keys; q's A
// fragments stay in registers for the whole KV loop. MIN_BLOCKS blocks fit
// on an SM (registers capped to match).
template <int HD> struct Config;
template <> struct Config<32> {
  static constexpr int MI = 2, BKV = 64, WARPS = 4, MIN_BLOCKS = 1;
};

template <int HD>
struct Layout {
  using C = Config<HD>;
  static constexpr int MI = C::MI, BKV = C::BKV, WARPS = C::WARPS;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int BQ = 16 * MI * WARPS;   // q rows a block
  static constexpr int LD = HD + 8;            // bf16 row stride: +16 bytes
  static constexpr int Q = BQ * LD;            // q tile, later the out tile
  static constexpr int KV = BKV * LD;          // one K or V stage
  static constexpr size_t bytes = sizeof(bf16) * size_t(Q + 4 * KV);
};

// rows [row0, row0 + n) of a (rows, HD) strided operand -> shared rows of
// stride LD, 16 bytes a copy; rows at or past `end` are zero-filled.
template <int HD>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          int64_t stride, int row0, int n,
                                          int end, int tid) {
  constexpr int CH = HD / 8;
  for (int e = tid; e < n * CH; e += Layout<HD>::THREADS) {
    const int r = e / CH, c = e % CH, gr = row0 + r;
    const bool in = gr < end;
    repro_ptx::cp_async_16(dst + r * Layout<HD>::LD + c * 8,
                           in ? src + gr * stride + c * 8 : src, in);
  }
}

template <int HD>
__global__ void __launch_bounds__(Layout<HD>::THREADS,
                                  Config<HD>::MIN_BLOCKS)
    flash_fwd_mma_kernel(Args a) {
  static_assert(HD % 16 == 0, "head_dim must be a multiple of 16");
  using L = Layout<HD>;
  constexpr int MI = L::MI, BKV = L::BKV, BQ = L::BQ, LD = L::LD;
  constexpr int KSTEPS = HD / 16;   // k-steps of q K^T
  constexpr int NS = BKV / 8;       // n-tiles of S
  constexpr int NO = HD / 8;        // n-tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + L::Q;             // 2 stages
  bf16* Vs = Ks + 2 * L::KV;        // 2 stages

  const int q0 = (int(gridDim.z) - 1 - int(blockIdx.z)) * BQ;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int hk = h / (a.H / a.Hkv);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const float sl2 = kLog2e / sqrtf(float(HD));   // scale * log2(e)
  // Under softcap the raw score s becomes z log2(e) = softcap log2(e)
  // tanh(s scale / softcap) in place, and `mul` takes it into the exp2
  // domain as it is; without, `mul` is scale log2(e).
  const bool capped = a.softcap > 0.f;
  const float cap_in = capped ? 1.f / (sqrtf(float(HD)) * a.softcap) : 0.f;
  const float cap_out = a.softcap * kLog2e;
  const float mul = capped ? 1.f : sl2;

  const bf16* qp = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const bf16* kp = static_cast<const bf16*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const bf16* vp = static_cast<const bf16*>(a.v) + b * a.v_sb + hk * a.v_sh;
  bf16* op = static_cast<bf16*>(a.o) + b * a.o_sb + h * a.o_sh;

  // KV range this q-tile can see: rows q0 .. q_end-1.
  const int q_end = min(q0 + BQ, a.S);
  const int kv_lo = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int kv_hi = a.causal ? min(a.T, q_end) : a.T;
  const int n_tiles = max(0, (kv_hi - kv_lo + BKV - 1) / BKV);

  // one cp.async group a tile: (q, K_0, V_0), then K_j+1 and V_j+1 issued
  // at the top of tile j, a whole tile ahead of their use
  load_rows<HD>(Qs, qp, a.q_ss, q0, BQ, a.S, tid);
  if (n_tiles > 0) {
    load_rows<HD>(Ks, kp, a.k_st, kv_lo, BKV, a.T, tid);
    load_rows<HD>(Vs, vp, a.v_st, kv_lo, BKV, a.T, tid);
  }
  repro_ptx::cp_async_commit();

  const int wrow = warp * 16 * MI;   // the warp's first row in the tile
  const int row_a = q0 + wrow + g;   // global row of c0/c1 in m-tile 0
  const bf16* Qw = Qs + wrow * LD;
  uint32_t qf[MI][KSTEPS][4];
  float o[MI][NO][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NO; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][j][e] = 0.f;
  // raw row maxima (-inf until a row sees a key) and this thread's share of
  // the row sums: rows g and g + 8 of each m-tile
  float m[MI][2], l[MI][2];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[i][r] = -INFINITY;
      l[i][r] = 0.f;
    }

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = kv_lo + it * BKV;
    const int st = it & 1;
    repro_ptx::cp_async_wait<0>();   // K_it, V_it (and q) have landed
    __syncthreads();                 // ... for every thread; and every warp
                                     // is done with stage st ^ 1 (tile it-1)
    if (it + 1 < n_tiles) {
      load_rows<HD>(Ks + (st ^ 1) * L::KV, kp, a.k_st, k0 + BKV, BKV, a.T,
                    tid);
      load_rows<HD>(Vs + (st ^ 1) * L::KV, vp, a.v_st, k0 + BKV, BKV, a.T,
                    tid);
      repro_ptx::cp_async_commit();
    }
    if (it == 0) {
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk)
          repro_ptx::ldmatrix_x4(
              qf[i][kk], Qw + (i * 16 + (lane & 15)) * LD + kk * 16 +
                             (lane >> 4) * 8);
    }
    // Under a causal mask a warp whose rows all lie before k0 sees no key
    // of this tile: its weights there are exactly 0, so it skips the math.
    const bool warp_live = !a.causal || q0 + wrow + 16 * MI - 1 >= k0;

    // S = q K^T, raw (unscaled) fp32
    float s[MI][NS][4];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][j][e] = 0.f;
    const bf16* Kt = Ks + st * L::KV;
    if (warp_live) {
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        uint32_t qa[MI][4];
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) qa[i][e] = qf[i][kk][e];
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {
          uint32_t r[4];
          repro_ptx::ldmatrix_x4(
              r, Kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                     kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
          for (int i = 0; i < MI; ++i) {
            repro_ptx::mma_bf16_16816(s[i][2 * np], qa[i], r[0], r[1]);
            repro_ptx::mma_bf16_16816(s[i][2 * np + 1], qa[i], r[2], r[3]);
          }
        }
      }

      if (capped) {
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < NS; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              s[i][j][e] = cap_out * tanhf(s[i][j][e] * cap_in);
      }

      // masks, only where the tile needs them
      const bool need_mask =
          k0 + BKV > a.T || (a.causal && k0 + BKV - 1 > q0) ||
          (a.window > 0 && q_end - 1 - k0 >= a.window);
      if (need_mask) {
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < NS; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int qi = row_a + i * 16 + (e >> 1) * 8;
              const int kj = k0 + j * 8 + 2 * t + (e & 1);
              if (kj >= a.T || (a.causal && kj > qi) ||
                  (a.window > 0 && qi - kj >= a.window))
                s[i][j][e] = -INFINITY;
            }
      }

      // online softmax in the exp2 domain: p = 2^(s mul - m mul)
#pragma unroll
      for (int i = 0; i < MI; ++i) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx = m[i][r];
#pragma unroll
          for (int j = 0; j < NS; ++j)
            mx = fmaxf(mx, fmaxf(s[i][j][2 * r], s[i][j][2 * r + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          // a row that has seen no key yet keeps weights and sums at 0
          const float ms = mx == -INFINITY ? 0.f : mx * mul;
          const float corr = repro_ptx::exp2_approx(m[i][r] * mul - ms);
          m[i][r] = mx;
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < NS; ++j) {
#pragma unroll
            for (int e = 2 * r; e < 2 * r + 2; ++e) {
              const float p =
                  repro_ptx::exp2_approx(fmaf(s[i][j][e], mul, -ms));
              s[i][j][e] = p;
              sum += p;
            }
          }
          l[i][r] = l[i][r] * corr + sum;
#pragma unroll
          for (int j = 0; j < NO; ++j) {
            o[i][j][2 * r] *= corr;
            o[i][j][2 * r + 1] *= corr;
          }
        }
      }
    }

    if (warp_live) {
      // O += P V, P rounded to bf16 in registers
      const bf16* Vt = Vs + st * L::KV;
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        uint32_t pa[MI][4];
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          pa[i][0] = repro_ptx::pack_bf16x2(s[i][2 * kk][0], s[i][2 * kk][1]);
          pa[i][1] = repro_ptx::pack_bf16x2(s[i][2 * kk][2], s[i][2 * kk][3]);
          pa[i][2] =
              repro_ptx::pack_bf16x2(s[i][2 * kk + 1][0], s[i][2 * kk + 1][1]);
          pa[i][3] =
              repro_ptx::pack_bf16x2(s[i][2 * kk + 1][2], s[i][2 * kk + 1][3]);
        }
#pragma unroll
        for (int np = 0; np < NO / 2; ++np) {
          uint32_t r[4];
          repro_ptx::ldmatrix_x4_trans(
              r, Vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                     np * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int i = 0; i < MI; ++i) {
            repro_ptx::mma_bf16_16816(o[i][2 * np], pa[i], r[0], r[1]);
            repro_ptx::mma_bf16_16816(o[i][2 * np + 1], pa[i], r[2], r[3]);
          }
        }
      }
    }
  }
  repro_ptx::cp_async_wait<0>();
  __syncthreads();   // every warp is done with q and the last stage

  // out = acc / max(l, 1e-30) in bf16, staged in the warp's own q rows
  bf16* Os = Qs + wrow * LD;
#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float x = l[i][r];
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      const float denom = fmaxf(x, 1e-30f);
#pragma unroll
      for (int j = 0; j < NO; ++j)
        *reinterpret_cast<uint32_t*>(Os + (i * 16 + g + 8 * r) * LD + j * 8 +
                                     2 * t) =
            repro_ptx::pack_bf16x2(o[i][j][2 * r] / denom,
                                   o[i][j][2 * r + 1] / denom);
      const int qi = row_a + i * 16 + 8 * r;
      if (a.lse != nullptr && t == 0 && qi < a.S)
        a.lse[(int64_t(b) * a.H + h) * a.S + qi] =
            m[i][r] == -INFINITY ? -INFINITY
                                 : (m[i][r] * mul + log2f(denom)) * kLn2;
    }
  }
  __syncwarp();
  constexpr int CH = HD / 8;
  for (int e = lane; e < 16 * MI * CH; e += 32) {
    const int r = e / CH, c = e % CH;
    const int qi = q0 + wrow + r;
    if (qi < a.S)
      *reinterpret_cast<uint4*>(op + qi * a.o_ss + c * 8) =
          *reinterpret_cast<const uint4*>(Os + r * LD + c * 8);
  }
}

template <int HD>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using L = Layout<HD>;
  static_assert(L::bytes <= 232448, "shared memory beyond a block's 227 KB");
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_mma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(L::bytes));
  if (attr != cudaSuccess) return attr;
  const dim3 grid(a.H, a.B, (a.S + L::BQ - 1) / L::BQ);
  flash_fwd_mma_kernel<HD><<<grid, L::THREADS, L::bytes, stream>>>(a);
  return cudaGetLastError();
}

// bf16 at hd 32 only: the wider heads are flash_attention_fwd_sm90.cu's.
cudaError_t dispatch_head_dim(const Args& a, int hd, cudaStream_t stream) {
  return hd == 32 ? launch<32>(a, stream) : cudaErrorInvalidValue;
}

}  // namespace tc

}  // namespace

extern "C" {

// dtype: 0 = float32 (CUDA cores, hd 32 to 256), 1 = bfloat16 (tensor
// cores, hd 32; every row start 16-byte aligned). Strides are in elements,
// for the (B, H, S|T, hd) view of each tensor; the hd axis has stride 1. `lse` (B, H, S) fp32 is
// written where it is not null; softcap > 0 caps the scaled scores.
// Returns cudaGetLastError() after the launch (0 on success).
int repro_flash_attention_fwd(
    int dtype, const void* q, const void* k, const void* v, void* o,
    float* lse, int B, int H, int Hkv, int S, int T, int hd,
    int64_t q_sb, int64_t q_sh, int64_t q_ss,
    int64_t k_sb, int64_t k_sh, int64_t k_st,
    int64_t v_sb, int64_t v_sh, int64_t v_st,
    int64_t o_sb, int64_t o_sh, int64_t o_ss,
    int causal, int window, float softcap, void* stream) {
  Args a{q, k, v, o, lse,
         q_sb, q_sh, q_ss, k_sb, k_sh, k_st, v_sb, v_sh, v_st,
         o_sb, o_sh, o_ss,
         B, H, Hkv, S, T, causal, window, softcap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return int(dispatch_head_dim<float>(a, hd, s));
  if (dtype == 1) return int(tc::dispatch_head_dim(a, hd, s));
  return int(cudaErrorInvalidValue);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
