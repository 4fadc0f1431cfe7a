// Flash attention forward for Hopper (sm_90a), bf16 at head_dim 64, 128,
// 192 and 256, on wgmma fed by TMA, written by hand in CUDA C++. It
// replaces the Pallas TPU kernel `_flash_kernel`
// (src/repro/kernels/flash_attention/kernel.py:27, wrapper :84,
// `pl.pallas_call` :98) on the path flash_attention.cu's `mma.sync` design
// took before; that design still serves bf16 at head_dim 32 and all fp32
// (`ops.fwd_path`). It computes what `flash_fwd_mma_kernel` computes, by the
// same rules:
//   out = softmax(z + mask) v,  z = q k^T / sqrt(hd)  [c tanh(z / c) under
//   softcap c > 0, the accurate tanhf, after the scale, before the mask]
// with causal and sliding-window masks from absolute indices, GQA (q head h
// reads KV head h / (H / Hkv)), -inf masks (a row that has seen no key
// keeps weight 0), an fp32 online softmax in the exp2 domain (scale log2 e
// folded into one fma), l floored at 1e-30, P rounded to bf16 before P V,
// ragged S and T (rows past S not stored, keys past T weighted 0), and the
// lse (B, H, S) in fp32, natural log, written only where it is asked for
// (the backward reads it).
//
// The design is FlashAttention-3's forward (Shah et al., 2024, sections
// 3.1-3.2) over the port's masks:
//   - One block per (head, batch, 128 q rows); the q tile is the grid's
//     slowest axis, last tile first, so the longest causal rows start
//     first and the short ones fill the tail.
//   - A producer warp (its warpgroup gives up its registers: `setmaxnreg`
//     24) loads the q tile once by TMA, then keeps the K and V tiles of the
//     tile's key range in flight through a ring of 2 stages, K and V each
//     with full and empty mbarriers of their own (K's stage is free once S
//     is computed, V's once P V is). Boxes are 64 columns (128 bytes)
//     wide, 128-byte swizzled; rows past S or T are zero-filled and masked.
//   - Two consumer warpgroups (`setmaxnreg` 240) of 64 q rows each run, a
//     key tile at a time, S = Q K^T on wgmma (both operands in shared
//     memory, K-major), the online softmax on the D fragments in registers
//     (masks only on tiles that cross the diagonal, the window's edge or
//     T), P rounded into the A registers of O += P V (wgmma, V from shared
//     memory as an MN-major B), each product waited for before the next
//     step; one warpgroup's softmax overlaps the other's products as the
//     warp schedulers interleave them. FA3's explicit overlaps, the next
//     tile's S issued ahead of this tile's P V inside a warpgroup and the
//     two warpgroups taking turns at their products by named barriers,
//     were both slower on the H100 (PERF.md §6), as were a third
//     stage and wider key tiles.
//   - The key range of a q tile is bounded by the causal edge and the
//     window, so fully masked tiles are never loaded.
//   - Epilogue: O / l rounded to bf16 into the q tile's shared memory
//     (`stmatrix`, the swizzled layout), then one TMA store a 64-column
//     chunk into the strided (B,S,H,hd) output, which clips rows past S.
//
// What bounds it: at stablelm's causal prefill (2 x 32 heads, S 2048, hd
// 64) 34.4 GFLOP against 67.1 MB, at jamba's (2 x 64 heads over 8, hd 128)
// 137.5 GFLOP against 151.0 MB: operations, 35 and 139 us at the 989
// TFLOP/s of the bf16 tensor cores (`ops.cost`). wgmma is the only way to
// that rate; TMA frees the consumers' registers and issue slots for the
// softmax.
//
// Tiles by head dim (the entry point's `launch_fwd<HD, BK>`): 128 keys a
// tile at hd 64 and 128 (S takes 64 fp32 registers a thread, O 32 and
// 64); 64 keys at hd 192 and 256, where O takes 96 and 128 registers and
// shared memory holds the q tile (48 and 64 KB) beside two stages of K and
// V (96 and 128 KB). O is kept as 64-column pieces; P V runs as N = 128
// products where it can (hd 128, 256, the first 128 columns of 192) and
// N = 64 for the rest.
//
// Inputs: q, k, v (B,H|Hkv,S|T,hd) bf16 views read through TMA descriptors
// built on the host for each call from `ops._tma_geometry` (every stride of
// an axis longer than 1 a multiple of 16 bytes, no broadcast axis), the
// output's likewise. A launch on the caller's stream, allocating nothing.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "hopper_mma.cuh"
#include "hopper_wgmma.cuh"

namespace {

using namespace repro_sm90;

constexpr int kThreads = 384;   // consumer warpgroups 0 and 1, producer 2
constexpr int kBQ = 128;        // q rows a block, 64 a consumer warpgroup

template <int HD, int BK_> struct Sm90Fwd {
  static_assert(HD == 64 || HD == 128 || HD == 192 || HD == 256,
                "the wgmma forward takes hd 64, 128, 192, 256");
  static constexpr int BK = BK_;   // keys a tile
  static constexpr int STAGES = 2;
  static constexpr int Q_TILE = kBQ * HD * 2;   // HD/64 chunks [128][64]
  static constexpr int KV_TILE = BK * HD * 2;   // HD/64 chunks [BK][64]
  static constexpr int OFF_Q = 0;
  static constexpr int OFF_K = OFF_Q + Q_TILE;
  static constexpr int OFF_V = OFF_K + STAGES * KV_TILE;
  static constexpr int OFF_BAR = OFF_V + STAGES * KV_TILE;
  // barriers (q; K's full and empty, V's full and empty of each stage),
  // and room to round the base up to 1024 bytes
  static constexpr int SMEM = OFF_BAR + 8 * (1 + 4 * STAGES) + 1024;
};

struct FwdArgs {
  float* lse;   // (B, H, S) fp32, natural log; null: not written
  int B, H, Hkv, S, T;
  int causal, window;
  float softcap;
};

// S = Q K^T of a key tile, raw, issued and committed (not waited for): q_s
// the warpgroup's 64 rows of the q tile, k_s the stage's K, both K-major.
template <int HD, int BK>
__device__ __forceinline__ void issue_s(float (&s)[BK / 2], uint32_t q_s,
                                        uint32_t k_s) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    WgmmaSS<BK, 0, 0>::run(
        s, desc_kmajor(q_s + (kk >> 2) * (kBQ * 128) + (kk & 3) * 32),
        desc_kmajor(k_s + (kk >> 2) * (BK * 128) + (kk & 3) * 32), kk);
  wgmma_commit();
}

// O += P V of a key tile (the keys as the k axis: V MN-major), issued and
// committed: N = 128 products over pairs of O's pieces, N = 64 for an odd
// last one.
template <int HD, int BK>
__device__ __forceinline__ void issue_pv(float (&o)[HD / 64][32],
                                         uint32_t (&pa)[BK / 4],
                                         uint32_t v_s) {
  constexpr int NP = HD / 64;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
    for (int p = 0; p + 1 < NP; p += 2)
      WgmmaRS<128, 1>::run(
          pair(o, p), pa + 4 * kk,
          desc_mnmajor(v_s + p * (BK * 128) + kk * 2048, BK * 128), 1);
    if constexpr (NP % 2)
      WgmmaRS<64, 1>::run(
          o[NP - 1], pa + 4 * kk,
          desc_mnmajor(v_s + (NP - 1) * (BK * 128) + kk * 2048, BK * 128),
          1);
  }
  wgmma_commit();
}

// A thread's place in its consumer warpgroup and the softmax's constants.
struct Rows {
  int r0;      // the warpgroup's first q row
  int row_g;   // this thread's rows: row_g and row_g + 8
  int t;       // lane % 4
  // Under softcap the raw score s becomes z log2(e) = softcap log2(e)
  // tanh(s scale / softcap) in place, and `mul` takes it into the exp2
  // domain as it is; without, `mul` is scale log2(e).
  float mul, cap_in, cap_out;
};

// S of the tile at key k0 -> P (fp32, in s), the running max m (raw, -inf
// until a row sees a key) and this thread's share of the row sums l; corr
// the factor O must be scaled by. Element 4 j + 2 r + e of s: row row_g + 8
// r, key k0 + 8 j + 2 t + e. Masks only where the tile crosses the
// diagonal, the window's edge or T.
template <int BK, bool CAPPED>
__device__ __forceinline__ void softmax(float (&s)[BK / 2], float (&m)[2],
                                        float (&l)[2], float (&corr)[2],
                                        const FwdArgs& a, const Rows& w,
                                        int k0) {
  if constexpr (CAPPED) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i)
      s[i] = w.cap_out * tanhf(s[i] * w.cap_in);
  }
  const bool masked = k0 + BK > a.T || (a.causal && k0 + BK - 1 > w.r0) ||
                      (a.window > 0 && w.r0 + 63 - k0 >= a.window);
  if (masked) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qi = w.row_g + 8 * r, kj = k0 + 8 * j + 2 * w.t + e;
          if (kj >= a.T || (a.causal && kj > qi) ||
              (a.window > 0 && qi - kj >= a.window))
            s[4 * j + 2 * r + e] = -INFINITY;
        }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = m[r];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
      mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    // a row that has seen no key yet keeps weights and sums at 0
    const float ms = mx == -INFINITY ? 0.f : mx * w.mul;
    corr[r] = repro_ptx::exp2_approx(m[r] * w.mul - ms);
    m[r] = mx;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * r + e;
        s[i] = repro_ptx::exp2_approx(fmaf(s[i], w.mul, -ms));
        sum += s[i];
      }
    l[r] = l[r] * corr[r] + sum;
  }
}

template <int NP>
__device__ __forceinline__ void rescale(float (&o)[NP][32],
                                        const float (&corr)[2]) {
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[p][i] *= corr[(i >> 1) & 1];
}

// P rounded to bf16 pairs: two neighbouring n-tiles of S are the A
// registers of one k-step.
template <int BK>
__device__ __forceinline__ void pack(uint32_t (&pa)[BK / 4],
                                     const float (&s)[BK / 2]) {
#pragma unroll
  for (int i = 0; i < BK / 4; ++i)
    pa[i] = repro_ptx::pack_bf16x2(s[2 * i], s[2 * i + 1]);
}

// After the wait for a P V: its A registers and O stay where they were.
template <int NP, int NA>
__device__ __forceinline__ void fence_pv(float (&o)[NP][32],
                                         uint32_t (&pa)[NA]) {
  fence_regs(pa);
#pragma unroll
  for (int p = 0; p < NP; ++p) fence_regs(o[p]);
}

template <int HD, int BK_, bool CAPPED>
__global__ void __launch_bounds__(kThreads, 1) flash_fwd_sm90_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_o, const FwdArgs a) {
  using C = Sm90Fwd<HD, BK_>;
  constexpr int BK = C::BK, STAGES = C::STAGES;
  constexpr int NP = HD / 64;   // 64-column pieces of q, K, V and O
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t bar_q = base + C::OFF_BAR;
  const uint32_t k_full = bar_q + 8;   // STAGES of each
  const uint32_t k_empty = k_full + 8 * STAGES;
  const uint32_t v_full = k_empty + 8 * STAGES;
  const uint32_t v_empty = v_full + 8 * STAGES;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (int(gridDim.z) - 1 - int(blockIdx.z)) * kBQ;
  const int hk = h / (a.H / a.Hkv);
  // the keys rows q0 .. q_end - 1 can see, a tile of BK at a time
  const int q_end = min(q0 + kBQ, a.S);
  const int kv_lo = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int kv_hi = a.causal ? min(a.T, q_end) : a.T;
  const int n_tiles = kv_hi > kv_lo ? (kv_hi - kv_lo + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, 8);   // one arrival a consumer warp
      mbar_init(v_empty + 8 * s, 8);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == 2) {
    // ---------------------------------------------------------- producer
    setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      mbar_arrive_expect_tx(bar_q, C::Q_TILE);
#pragma unroll
      for (int c = 0; c < NP; ++c)
        tma_load_4d(base + C::OFF_Q + c * kBQ * 128, &tm_q, bar_q, c * 64,
                    q0, h, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % STAGES, k0 = kv_lo + it * BK;
        const uint32_t parity = ((it / STAGES) & 1) ^ 1;
        mbar_wait(k_empty + 8 * st, parity);
        mbar_arrive_expect_tx(k_full + 8 * st, C::KV_TILE);
#pragma unroll
        for (int c = 0; c < NP; ++c)
          tma_load_4d(base + C::OFF_K + st * C::KV_TILE + c * BK * 128,
                      &tm_k, k_full + 8 * st, c * 64, k0, hk, b);
        mbar_wait(v_empty + 8 * st, parity);
        mbar_arrive_expect_tx(v_full + 8 * st, C::KV_TILE);
#pragma unroll
        for (int c = 0; c < NP; ++c)
          tma_load_4d(base + C::OFF_V + st * C::KV_TILE + c * BK * 128,
                      &tm_v, v_full + 8 * st, c * 64, k0, hk, b);
      }
    }
    return;
  }

  // ----------------------------------------------------------- consumers
  setmaxnreg_inc<240>();
  const int w = wg;   // q rows q0 + 64 w ..
  const int tw = threadIdx.x & 127;
  const int warp = tw >> 5, lane = tw & 31;
  const Rows rows{q0 + 64 * w, q0 + 64 * w + 16 * warp + (lane >> 2),
                  lane & 3,
                  CAPPED ? 1.f : kLog2e / sqrtf(float(HD)),
                  CAPPED ? 1.f / (sqrtf(float(HD)) * a.softcap) : 0.f,
                  a.softcap * kLog2e};
  // this warpgroup's 64 rows of each 64-column chunk of the q tile
  const uint32_t q_s = base + C::OFF_Q + w * (64 * 128);
  const uint32_t k_s = base + C::OFF_K, v_s = base + C::OFF_V;

  float o[NP][32];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[p][i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float s[BK / 2];       // S of the tile, then its P in fp32
  uint32_t pa[BK / 4];   // P in bf16: the A registers of BK / 16 k-steps
  float corr[2];

  // a consumer warp's arrival at an empty barrier
  auto release = [&](uint32_t bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  mbar_wait(bar_q, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % STAGES;
    const uint32_t parity = (it / STAGES) & 1;
    mbar_wait(k_full + 8 * st, parity);
    issue_s<HD, BK>(s, q_s, k_s + st * C::KV_TILE);
    wgmma_wait<0>();
    fence_regs(s);
    release(k_empty + 8 * st);
    softmax<BK, CAPPED>(s, m, l, corr, a, rows, kv_lo + it * BK);
    rescale(o, corr);
    pack<BK>(pa, s);
    mbar_wait(v_full + 8 * st, parity);
    issue_pv<HD, BK>(o, pa, v_s + st * C::KV_TILE);
    wgmma_wait<0>();
    fence_pv(o, pa);
    release(v_empty + 8 * st);
  }

  // out = O / max(l, 1e-30) in bf16, and the lse of each row
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float x = l[r];
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    x += __shfl_xor_sync(0xffffffffu, x, 2);
    const float denom = fmaxf(x, 1e-30f);
    inv[r] = 1.f / denom;
    const int qi = rows.row_g + 8 * r;
    if (a.lse != nullptr && rows.t == 0 && qi < a.S)
      a.lse[(int64_t(b) * a.H + h) * a.S + qi] =
          m[r] == -INFINITY ? -INFINITY
                          : (m[r] * rows.mul + log2f(denom)) * kLn2;
  }
  // staged in this warpgroup's rows of the q tile (its products are done
  // with them; the other warpgroup reads only its own), the layout TMA's
  // 128-byte swizzle reads: lane l addresses row 16 warp + 8 ((l / 8) % 2)
  // + l % 8, 16-byte chunk jj + l / 16 of the 64-column piece
  {
    const int mi = lane >> 3, rr = lane & 7;
    const int row = 16 * warp + rr + 8 * (mi & 1);
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int jj = 0; jj < 8; jj += 2) {
        const uint32_t addr = q_s + p * (kBQ * 128) + row * 128 +
                              (((jj + (mi >> 1)) ^ rr) << 4);
        stmatrix_x4(addr,
                    repro_ptx::pack_bf16x2(o[p][4 * jj] * inv[0],
                                           o[p][4 * jj + 1] * inv[0]),
                    repro_ptx::pack_bf16x2(o[p][4 * jj + 2] * inv[1],
                                           o[p][4 * jj + 3] * inv[1]),
                    repro_ptx::pack_bf16x2(o[p][4 * jj + 4] * inv[0],
                                           o[p][4 * jj + 5] * inv[0]),
                    repro_ptx::pack_bf16x2(o[p][4 * jj + 6] * inv[1],
                                           o[p][4 * jj + 7] * inv[1]));
      }
  }
  fence_proxy_async();
  named_bar_sync(1 + w, 128);
  if (tw == 0 && rows.r0 < a.S) {
#pragma unroll
    for (int p = 0; p < NP; ++p)
      tma_store_4d(&tm_o, q_s + p * (kBQ * 128), p * 64, rows.r0, h, b);
    bulk_commit();
    bulk_wait_read<0>();   // shared memory stays until the store read it
  }
}

template <int HD, int BK>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       void* o, const FwdArgs& a, const int64_t* tma,
                       cudaStream_t stream) {
  using C = Sm90Fwd<HD, BK>;
  static_assert(C::SMEM <= 232448, "shared memory beyond a block's 227 KB");
  static const cudaError_t attr[2] = {
      cudaFuncSetAttribute(flash_fwd_sm90_kernel<HD, BK, false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           C::SMEM),
      cudaFuncSetAttribute(flash_fwd_sm90_kernel<HD, BK, true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           C::SMEM)};
  if (attr[0] != cudaSuccess) return attr[0];
  if (attr[1] != cudaSuccess) return attr[1];
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  cudaError_t err = encode_tma_4d(&tm_q, q, tma, kBQ);
  if (err == cudaSuccess) err = encode_tma_4d(&tm_k, k, tma + 7, C::BK);
  if (err == cudaSuccess) err = encode_tma_4d(&tm_v, v, tma + 14, C::BK);
  if (err == cudaSuccess) err = encode_tma_4d(&tm_o, o, tma + 21, 64);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.H, a.B, (a.S + kBQ - 1) / kBQ);
  if (a.softcap > 0.f)
    flash_fwd_sm90_kernel<HD, BK, true>
        <<<grid, kThreads, C::SMEM, stream>>>(tm_q, tm_k, tm_v, tm_o, a);
  else
    flash_fwd_sm90_kernel<HD, BK, false>
        <<<grid, kThreads, C::SMEM, stream>>>(tm_q, tm_k, tm_v, tm_o, a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The bf16 forward at head_dim 64, 128, 192 or 256 (any other:
// cudaErrorInvalidValue): out ((B,H,S,hd) strided view) from q, k, v, and
// the lse (B, H, S) fp32 where `lse` is not null. `tma`: for q, k, v and out
// in turn the 4 dims (hd, rows, heads, batch) and 3 byte strides (rows,
// heads, batch) of its TMA descriptor. One launch on `stream`; returns
// cudaGetLastError() after it, or the error that stopped it (0 on
// success).
int repro_flash_attention_fwd_sm90(const void* q, const void* k,
                                   const void* v, void* o, float* lse, int B,
                                   int H, int Hkv, int S, int T, int hd,
                                   const int64_t* tma, int causal, int window,
                                   float softcap, void* stream) {
  const FwdArgs a{lse, B, H, Hkv, S, T, causal, window, softcap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: return int(launch_fwd<64, 128>(q, k, v, o, a, tma, s));
    case 128: return int(launch_fwd<128, 128>(q, k, v, o, a, tma, s));
    case 192: return int(launch_fwd<192, 64>(q, k, v, o, a, tma, s));
    case 256: return int(launch_fwd<256, 64>(q, k, v, o, a, tma, s));
    default: return int(cudaErrorInvalidValue);
  }
}

// The CUresult of the last tensor-map encoding (0: CUDA_SUCCESS).
int repro_flash_attention_fwd_sm90_cu_result() {
  return repro_sm90::g_last_cu_result;
}

}  // extern "C"
