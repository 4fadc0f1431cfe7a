// Flash attention backward for Hopper (sm_90a), bf16 at head_dim 64, 128,
// 192 and 256: dK, dV and dQ in one pass, on wgmma fed by TMA, written by
// hand in CUDA C++. It replaces the reference's `_blockwise_bwd`
// (src/repro/models/attention.py:153), the custom VJP of `blockwise_sdpa`
// (the Pallas kernel, src/repro/kernels/flash_attention/kernel.py:27, is a
// forward only), on the path flash_attention_bwd.cu's two-kernel `mma.sync`
// design took before; that design still serves fp32 and bf16 at head_dim
// 32 (`ops.bwd_path`). The design is FlashAttention-3's backward (Shah et
// al., 2024, section 3) over the port's GQA loop:
//   delta = rowsum(dO o out),  P = exp(z - lse),  dV = P^T dO,
//   dS = P o (dO V^T - delta) [o (1 - tanh^2) under softcap],
//   dK = dS^T q / sqrt(hd),    dQ = dS K / sqrt(hd).
//
// Three launches on the caller's stream:
//   1. `flash_bwd_sm90_prep_kernel`: delta and lse log2(e) of every row,
//      padded to a multiple of 64 rows (+inf and 0 past S, +inf where lse is
//      -inf: P is 0 there, not NaN), and the fp32 dQ accumulator zeroed.
//   2. The main kernel, one block per (KV head, batch, key tile): two
//      consumer warpgroups and one producer warp. The producer loads the
//      block's K and V once by TMA, then keeps Q, dO, lse and delta of the
//      next q tiles (64 rows) of its G query heads in flight through a ring
//      of 2 stages (full / empty mbarriers). dK and dV stay in registers
//      over the G heads (no atomics) and are written once. By head_dim:
//      - hd 64 and 128, `flash_bwd_sm90_kernel`: 128 keys a block, 64 a
//        consumer warpgroup. Per q tile each warpgroup runs
//          S^T = K Q^T, dP^T = V dO^T  (wgmma, both operands in shared)
//          P^T, dS^T in registers       (the mask, lse and softcap rules)
//          dV += P^T dO, dK += dS^T Q  (wgmma, A from registers)
//        and stores dS^T to shared memory; then the warpgroup whose turn
//        it is (the tile's parity) runs dQ^T = K^T dS^T over all 128 keys
//        and adds the tile's fp32 dQ^T block into the accumulator by one
//        bulk TMA reduce-add, while the other goes on to the next tile.
//      - hd 192 and 256, `flash_bwd_sm90_wide_kernel`: there a warpgroup
//        holding the whole head_dim of both dK and dV takes 192 and 256
//        fp32 registers a thread, and the layout above 320 and 416 KB of
//        shared memory. So 64 keys a block, warpgroup 0 owns dV and
//        warpgroup 1 dK (HD / 2 registers a thread each). Per q tile each
//        computes S^T and dP^T of all 64 keys for its 32 q rows (wgmma N =
//        32, 16 + 16 registers: each score once), forms P^T and dS^T, and
//        stores both (bf16, [q row][key]) to shared memory; after a named
//        barrier warpgroup 0 runs dV += P^T dO and warpgroup 1 dK += dS^T
//        Q over the whole tile, with P, dS, dO and Q MN-major from shared
//        memory, then each runs two 64-column pieces of dQ = dS K and adds
//        them into the accumulator by float4 atomics from registers (no
//        staging: at hd 256 K, V, two stages of Q and dO and two buffers
//        of P and dS take 225 KB of the 227). At hd 192 three pieces are
//        shared as 2 + 1 over two tiles in turn; the warpgroup with one
//        computes it twice and adds it once, as a product issued on one
//        warpgroup's branch only made ptxas serialize every wgmma (C7520).
//   3. `flash_bwd_sm90_dq_kernel` / `flash_bwd_sm90_wide_dq_kernel`: the
//      accumulator times 1/sqrt(hd), cast into dq's bf16 strided layout.
// dK and dV have one owner and a fixed order: the same every run. dQ at hd
// 64 and 128 is a sum of fp32 reduce-adds in the order the blocks reach
// them, so its last bits may differ from run to run (before rounding to
// bf16); at 192 and 256 the blocks add into a q tile in key-tile order
// (`tiles`, a count a tile), so that it is the same every run too: there
// the last bits of dQ, tipped to the next bf16 value, moved gemma3's
// bf16 embedding gradient by 1.6% of its largest entry between two runs of
// the same step.
//
// What bounds it: five products a score against the forward's two, so it
// is operations-bound where the forward is (`ops.bwd_cost`, the bf16
// tensor cores' 989 TFLOP/s against 3.35 TB/s): at mixtral's training shape
// (2 x 48 heads over 8, 2048 rows, hd 128, window 4096) 257,823,866,880
// flop, 0.2607 ms, against 236,453,888 bytes (0.0706 ms); at MLA's (128
// heads, 2048 rows, q and k over 192, v over 128 of its 192) 446,894,702,592
// flop, 0.4519 ms, against 673,185,792 bytes; at gemma3's (16 heads over 8,
// 2048 rows, hd 256) 85,941,288,960 flop globally and 64,445,480,960 under
// its window of 1024, 0.0869 and 0.0652 ms, against 100,925,440 bytes. What
// the design does about the four limits of the design it replaces:
//   1. mma.sync m16n8k16 fed by ldmatrix -> wgmma, the only way to the
//      card's full bf16 rate, reading its operands from shared memory.
//   2. S and dP computed twice (7 products a score for the 5 counted) ->
//      once: dQ comes from the same dS as dK, through shared memory and
//      an fp32 accumulator in device memory, so each score takes the 5
//      products `bwd_cost` counts (at hd 192, 5 and 1/15).
//   3. Small tiles and every thread issuing cp.async -> whole tiles issued
//      by one thread by TMA (128-byte swizzled, out-of-bounds rows
//      zero-filled for ragged S and T), the consumers holding the
//      registers (`setmaxnreg` 240 against the producer's 24).
//   4. Uneven causal work -> key tiles first tile first: the blocks with
//      the most q tiles start first and the short last tiles fill the
//      tail. At hd 64 and 128 the key tile is the grid's slowest axis; at
//      192 and 256 the slower inside groups of (batch, KV head) pairs of
//      at least two blocks an SM, so that the blocks resident at once
//      share a few KV heads' q tiles and accumulator rows in L2 (MLA has
//      128 KV heads: one key tile of each read 200 MB).
//
// Shapes: q, k, v, dout (B,H|Hkv,S|T,hd) views read by their strides (the
// TMA descriptors are built on the host for each call from the dims and
// byte strides `ops._tma_geometry` gives), every stride of an axis longer
// than 1 a multiple of 16 bytes. A tile's block of the accumulator at hd 64
// and 128 is dQ^T: HD rows (head columns) of 64 (the tile's q rows), the
// 8-column groups of row c permuted by c % 8 so that a warp's stores into
// shared memory spread over the banks; at hd 192 and 256 it is HD / 64
// pieces of 4,096 floats in the wgmma fragment's order (`add_dq_piece`).
// Each dq kernel undoes its layout.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "hopper_mma.cuh"
#include "hopper_wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace repro_sm90;

constexpr int kThreads = 384;   // consumer warpgroups 0 and 1, producer 2
constexpr int kBK = 128;        // keys a block
constexpr int kBQ = 64;         // q rows a tile
constexpr int kStages = 2;      // ring of Q, dO, lse, delta

template <int HD> struct Sm90Bwd {
  static_assert(HD == 64 || HD == 128, "the wgmma backward takes hd 64, 128");
  static constexpr int KV_TILE = kBK * HD * 2;     // HD/64 chunks [128][64]
  static constexpr int Q_TILE = kBQ * HD * 2;      // HD/64 chunks [64][64]
  static constexpr int DS_TILE = kBQ * kBK * 2;    // 2 chunks [64 q][64 keys]
  static constexpr int DQ_TILE = 64 * HD * 4;      // a tile's dQ^T, fp32
  static constexpr int ROWS = 2 * kBQ * 4;         // lse log2(e), delta
  static constexpr int OFF_K = 0;
  static constexpr int OFF_V = OFF_K + KV_TILE;
  static constexpr int OFF_Q = OFF_V + KV_TILE;
  static constexpr int OFF_DO = OFF_Q + kStages * Q_TILE;
  static constexpr int OFF_DS = OFF_DO + kStages * Q_TILE;   // 2 buffers
  static constexpr int OFF_DQ = OFF_DS + 2 * DS_TILE;   // 1 a warpgroup
  static constexpr int OFF_ROWS = OFF_DQ + 2 * DQ_TILE;
  static constexpr int OFF_BAR = OFF_ROWS + kStages * ROWS;
  // barriers, and room to round the base up to 1024 bytes
  static constexpr int SMEM = OFF_BAR + 8 * (1 + 2 * kStages) + 1024;
};

struct PrepArgs {
  const bf16* o;
  const bf16* dout;
  const float* lse;   // (B, H, S), the forward's
  float* lse2;        // (B, H, Sp)
  float* delta;       // (B, H, Sp)
  float* dq_acc;      // (B, H, Sp, HD) fp32
  int* tiles;         // (B H Sp / 64 + 1): the wide kernel's counts, ticket
  int64_t o_sb, o_sh, o_ss, do_sb, do_sh, do_ss;
  int B, H, S, Sp;
};

// One warp a padded row (b, h, s < Sp): delta = rowsum(dO o out) (0 past
// S), lse log2(e) (+inf past S and where lse = -inf), and the row's HD
// floats of the accumulator zeroed (and the count of its q tile's adds,
// at the tile's first row).
template <int HD>
__global__ void __launch_bounds__(128) flash_bwd_sm90_prep_kernel(PrepArgs p) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t row = int64_t(blockIdx.x) * 4 + warp;
  if (row >= int64_t(p.B) * p.H * p.Sp) return;
  const int s = int(row % p.Sp);
  const int bh = int(row / p.Sp);
  const int h = bh % p.H, b = bh / p.H;
  // HD / 32 elements a lane, in bf16 pairs (row starts are 16-byte aligned)
  float acc = 0.f;
  if (s < p.S) {
    const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(
        p.o + b * p.o_sb + h * p.o_sh + s * p.o_ss + lane * (HD / 32));
    const __nv_bfloat162* dop = reinterpret_cast<const __nv_bfloat162*>(
        p.dout + b * p.do_sb + h * p.do_sh + s * p.do_ss + lane * (HD / 32));
#pragma unroll
    for (int x = 0; x < HD / 64; ++x) {
      const float2 o2 = __bfloat1622float2(op[x]);
      const float2 d2 = __bfloat1622float2(dop[x]);
      acc = fmaf(o2.x, d2.x, fmaf(o2.y, d2.y, acc));
    }
  }
#pragma unroll
  for (int off = 16; off; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const float l = s < p.S ? p.lse[int64_t(bh) * p.S + s] : -INFINITY;
    p.lse2[row] = l == -INFINITY ? INFINITY : l * kLog2e;
    p.delta[row] = acc;
    if (s % 64 == 0) p.tiles[row / 64] = 0;
    if (row == 0) p.tiles[int64_t(p.B) * p.H * (p.Sp / 64)] = 0;   // ticket
  }
  float4* z = reinterpret_cast<float4*>(p.dq_acc + row * HD);
  for (int c = lane; c < HD / 4; c += 32) z[c] = make_float4(0.f, 0.f, 0.f, 0.f);
}

struct Sm90Args {
  const float* lse2;   // (B, H, Sp)
  const float* delta;  // (B, H, Sp)
  float* dq_acc;       // (B, H, Sp / 64) blocks of 64 x HD fp32
  bf16* dk;
  bf16* dv;
  int64_t dk_sb, dk_sh, dk_st, dv_sb, dv_sh, dv_st;
  int B, H, Hkv, S, T, Sp;
  int causal, window;
  float softcap;
  int kv_group;   // the wide kernel's (batch, KV head) pairs a group
};

__device__ __forceinline__ bool key_valid(const Sm90Args& a, int qi, int kj) {
  return kj < a.T && (!a.causal || kj <= qi) &&
         (a.window <= 0 || qi - kj < a.window);
}

template <int HD, bool CAPPED>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_sm90_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_do, const Sm90Args a) {
  using C = Sm90Bwd<HD>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const unsigned char* sbase = smem_raw + (base - raw);
  const uint32_t bar_kv = base + C::OFF_BAR;
  const uint32_t bar_full = bar_kv + 8;                // kStages of them
  const uint32_t bar_empty = bar_full + 8 * kStages;   // kStages of them

  const int hk = blockIdx.x, b = blockIdx.y;
  const int k0 = int(blockIdx.z) * kBK;
  const int G = a.H / a.Hkv;
  // the q rows these keys reach, as tiles of 64 rows, for each of G heads;
  // the items go tile by tile, last tile first, the G heads of a tile in
  // turn, so that the blocks of one KV head (which all start at the last
  // tile and move at one pace) add into the same accumulator rows at once
  // and those rows stay in L2
  const int k_end = min(k0 + kBK, a.T);
  const int q_lo = a.causal ? k0 : 0;
  const int q_hi = a.window > 0 ? min(a.S, k_end - 1 + a.window) : a.S;
  const int first = q_lo / kBQ;
  const int nqt = q_hi > q_lo ? (q_hi + kBQ - 1) / kBQ - first : 0;
  const int n_items = G * nqt;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 8);   // one arrival a consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == 2) {
    // ---------------------------------------------------------- producer
    setmaxnreg_dec<24>();
    if (threadIdx.x == 256 && n_items > 0) {
      mbar_arrive_expect_tx(bar_kv, 2 * C::KV_TILE);
#pragma unroll
      for (int c = 0; c < HD / 64; ++c) {
        tma_load_4d(base + C::OFF_K + c * kBK * 128, &tm_k, bar_kv, c * 64,
                    k0, hk, b);
        tma_load_4d(base + C::OFF_V + c * kBK * 128, &tm_v, bar_kv, c * 64,
                    k0, hk, b);
      }
      for (int it = 0; it < n_items; ++it) {
        const int st = it % kStages;
        mbar_wait(bar_empty + 8 * st, ((it / kStages) & 1) ^ 1);
        const int h = hk * G + it % G;
        const int q0 = (first + nqt - 1 - it / G) * kBQ;
        const uint32_t full = bar_full + 8 * st;
        mbar_arrive_expect_tx(full, 2 * C::Q_TILE + C::ROWS);
#pragma unroll
        for (int c = 0; c < HD / 64; ++c) {
          tma_load_4d(base + C::OFF_Q + st * C::Q_TILE + c * kBQ * 128,
                      &tm_q, full, c * 64, q0, h, b);
          tma_load_4d(base + C::OFF_DO + st * C::Q_TILE + c * kBQ * 128,
                      &tm_do, full, c * 64, q0, h, b);
        }
        const int64_t row = (int64_t(b) * a.H + h) * a.Sp + q0;
        const uint32_t rows = base + C::OFF_ROWS + st * C::ROWS;
        bulk_load(rows, a.lse2 + row, kBQ * 4, full);
        bulk_load(rows + kBQ * 4, a.delta + row, kBQ * 4, full);
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    setmaxnreg_inc<240>();
    const int w = wg;   // keys k0 + 64 w ..
    const int tw = threadIdx.x & 127;
    const int warp = tw >> 5, lane = tw & 31, g = lane >> 2, t = lane & 3;
    const int kw0 = k0 + 64 * w;
    const float scale = 1.0f / sqrtf(float(HD));
    const float sl2 = kLog2e * scale;
    const float cap_in = CAPPED ? scale / a.softcap : 0.f;
    const float cap_out = a.softcap * kLog2e;

    float dk[HD / 2], dv[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dk[i] = dv[i] = 0.f;

    if (n_items > 0) mbar_wait(bar_kv, 0);

    for (int it = 0; it < n_items; ++it) {
      const int st = it % kStages;
      const int h = hk * G + it % G;
      const int q0 = (first + nqt - 1 - it / G) * kBQ;
      mbar_wait(bar_full + 8 * st, (it / kStages) & 1);
      const uint32_t q_s = base + C::OFF_Q + st * C::Q_TILE;
      const uint32_t do_s = base + C::OFF_DO + st * C::Q_TILE;

      // S^T = K Q^T and dP^T = V dO^T for this warpgroup's 64 keys, raw,
      // in two groups: P is formed while dP^T is still in the tensor cores
      float sT[32], dpT[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        WgmmaSS<64, 0, 0>::run(
            sT,
            desc_kmajor(base + C::OFF_K + (kk >> 2) * (kBK * 128) +
                        w * (64 * 128) + (kk & 3) * 32),
            desc_kmajor(q_s + (kk >> 2) * (kBQ * 128) + (kk & 3) * 32), kk);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        WgmmaSS<64, 0, 0>::run(
            dpT,
            desc_kmajor(base + C::OFF_V + (kk >> 2) * (kBK * 128) +
                        w * (64 * 128) + (kk & 3) * 32),
            desc_kmajor(do_s + (kk >> 2) * (kBQ * 128) + (kk & 3) * 32), kk);
      wgmma_commit();

      // P^T = 2^(z log2 e - lse log2 e) into sT, dS^T = P^T (dP^T - delta)
      // fac into dpT; element 4 j + 2 r + e: key kw0 + 16 warp + g + 8 r,
      // q row q0 + 8 j + 2 t + e. Only a tile that crosses the diagonal,
      // the window's edge or T tests each pair; rows past S have lse +inf.
      const float* rows =
          reinterpret_cast<const float*>(sbase + C::OFF_ROWS + st * C::ROWS);
      const bool masked = (a.causal && kw0 + 63 > q0) ||
                          (a.window > 0 && q0 + 63 - kw0 >= a.window) ||
                          kw0 + 63 >= a.T;
      float fac[CAPPED ? 32 : 1];
      wgmma_wait<1>();
      fence_regs(sT);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qc = 8 * j + 2 * t + e;
          const float l2 = rows[qc];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int i = 4 * j + 2 * r + e;
            float z;
            if constexpr (CAPPED) {
              const float th = tanhf(sT[i] * cap_in);
              fac[i] = 1.f - th * th;
              z = cap_out * th;
            } else {
              z = sT[i] * sl2;
            }
            float p = repro_ptx::exp2_approx(z - l2);
            if (masked && !key_valid(a, q0 + qc, kw0 + 16 * warp + g + 8 * r))
              p = 0.f;
            sT[i] = p;
          }
        }
      wgmma_wait<0>();
      fence_regs(dpT);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float dl = rows[kBQ + 8 * j + 2 * t + e];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int i = 4 * j + 2 * r + e;
            float ds = sT[i] * (dpT[i] - dl);
            if constexpr (CAPPED) ds *= fac[i];
            dpT[i] = ds;
          }
        }
      // P^T and dS^T rounded to bf16 as the A registers of 4 k-steps
      uint32_t pa[16], da[16];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          pa[4 * kk + x] = repro_ptx::pack_bf16x2(sT[8 * kk + 2 * x],
                                                  sT[8 * kk + 2 * x + 1]);
          da[4 * kk + x] = repro_ptx::pack_bf16x2(dpT[8 * kk + 2 * x],
                                                  dpT[8 * kk + 2 * x + 1]);
        }

      // dV += P^T dO, dK += dS^T Q (the q rows as the k axis: dO and Q
      // MN-major), in the tensor cores while dS^T goes to shared memory
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        WgmmaRS<HD, 1>::run(dv, pa + 4 * kk,
                            desc_mnmajor(do_s + kk * 2048, kBQ * 128), 1);
        WgmmaRS<HD, 1>::run(dk, da + 4 * kk,
                            desc_mnmajor(q_s + kk * 2048, kBQ * 128), 1);
      }
      wgmma_commit();

      // dS^T into shared memory as dS (q rows by keys, K-major, 128-byte
      // swizzled: chunk w holds this warpgroup's keys), buffer it % 2, by
      // transposing stores of the warp's 16 keys x 16 rows a k-step: lane
      // l addresses row 16 kk + 8 (l / 16) + l % 8 of 8 keys 8 ((l / 8) %
      // 2) on. The buffer was last read by the dQ^T of item it - 2, done
      // before its warpgroup reached the barrier of item it - 1.
      const uint32_t ds_s = base + C::OFF_DS + (it & 1) * C::DS_TILE;
      {
        const int mi = lane >> 3, q8 = lane & 7;
        const uint32_t row0 = ds_s + w * (kBQ * 128) + q8 * 128 +
                              (((2 * warp + (mi & 1)) ^ q8) << 4);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          stmatrix_x4_trans(row0 + (16 * kk + 8 * (mi >> 1)) * 128,
                            da[4 * kk], da[4 * kk + 1], da[4 * kk + 2],
                            da[4 * kk + 3]);
      }
      fence_proxy_async();
      named_bar_sync(1, 256);   // both warpgroups' dS^T are in

      // dQ^T = K^T dS^T over all 128 keys (K MN-major, dS K-major), all
      // HD rows, by the warpgroup whose turn it is (the item's parity): its
      // dQ^T and the block's way out overlap the other's next S^T and dP^T
      wgmma_wait<0>();   // dV and dK: Q, dO and the rows are read
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * st);
      if ((it & 1) == w) {
        float dq[HD / 64][32];
        wgmma_fence();
#pragma unroll
        for (int mh = 0; mh < HD / 64; ++mh)
#pragma unroll
          for (int kk = 0; kk < kBK / 16; ++kk)
            WgmmaSS<64, 1, 0>::run(
                dq[mh],
                desc_mnmajor(base + C::OFF_K + mh * kBK * 128 + kk * 2048,
                             kBK * 128),
                desc_kmajor(ds_s + (kk >> 2) * (kBQ * 128) + (kk & 3) * 32),
                kk);
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int mh = 0; mh < HD / 64; ++mh) fence_regs(dq[mh]);

        // the 64 x HD dQ^T block -> shared (this warpgroup's buffer) ->
        // one bulk reduce-add
        const uint32_t dq_s = base + C::OFF_DQ + w * C::DQ_TILE;
        if (tw == 0) bulk_wait_read<0>();   // its last reduce-add read it
        named_bar_sync(2 + w, 128);
#pragma unroll
        for (int mh = 0; mh < HD / 64; ++mh)
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int m = 16 * warp + g + 8 * r;
              const int col = 8 * (j ^ (m & 7)) + 2 * t;
              st_shared_v2_f32(dq_s + ((mh * 64 + m) * 64 + col) * 4,
                               dq[mh][4 * j + 2 * r], dq[mh][4 * j + 2 * r + 1]);
            }
        fence_proxy_async();
        named_bar_sync(2 + w, 128);
        if (tw == 0) {
          bulk_reduce_add_f32(
              a.dq_acc + ((int64_t(b) * a.H + h) * a.Sp + q0) * HD, dq_s,
              C::DQ_TILE);
          bulk_commit();
        }
      }
    }
    if (tw == 0) bulk_wait<0>();
    fence_regs(dk);
    fence_regs(dv);

    // dK (q was not pre-scaled: times 1/sqrt(hd)) and dV, rows before T
    bf16* dkp = a.dk + b * a.dk_sb + hk * a.dk_sh;
    bf16* dvp = a.dv + b * a.dv_sb + hk * a.dv_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kj = kw0 + 16 * warp + g + 8 * r;
      if (kj < a.T) {
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          const int c = 8 * j + 2 * t;
          *reinterpret_cast<uint32_t*>(dkp + kj * a.dk_st + c) =
              repro_ptx::pack_bf16x2(dk[4 * j + 2 * r] * scale,
                                     dk[4 * j + 2 * r + 1] * scale);
          *reinterpret_cast<uint32_t*>(dvp + kj * a.dv_st + c) =
              repro_ptx::pack_bf16x2(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
        }
      }
    }
  }
}

struct DqArgs {
  const float* dq_acc;
  bf16* dq;
  int64_t dq_sb, dq_sh, dq_ss;
  int H, S, Sp;
};

// One block a (64-row tile, head, batch): the tile's accumulator block in
// (coalesced float4 reads), through shared memory as [q row][head column]
// (row stride HD + 1), then dq = acc / sqrt(hd) in bf16 pairs along rows.
template <int HD>
__global__ void __launch_bounds__(256) flash_bwd_sm90_dq_kernel(DqArgs p) {
  constexpr int LD = HD + 1;
  __shared__ float tile[64 * LD];
  const int q0 = blockIdx.x * 64, h = blockIdx.y, b = blockIdx.z;
  const float4* src = reinterpret_cast<const float4*>(
      p.dq_acc + ((int64_t(b) * p.H + h) * p.Sp + q0) * HD);
  for (int i = threadIdx.x; i < 64 * HD / 4; i += 256) {
    const float4 x = src[i];
    // element 4 i: row c of dQ^T (a head column), position pos (a multiple
    // of 4) of the row, which holds q rows n0 .. n0 + 3
    const int c = (4 * i) / 64, pos = (4 * i) % 64;
    const int n0 = 8 * ((pos >> 3) ^ (c & 7)) + (pos & 7);
    float* dst = tile + n0 * LD + c;
    dst[0] = x.x;
    dst[LD] = x.y;
    dst[2 * LD] = x.z;
    dst[3 * LD] = x.w;
  }
  __syncthreads();
  const float scale = 1.0f / sqrtf(float(HD));
  bf16* dq = p.dq + b * p.dq_sb + h * p.dq_sh;
  for (int i = threadIdx.x; i < 64 * HD / 2; i += 256) {
    const int qq = i / (HD / 2), c = 2 * (i % (HD / 2));
    if (q0 + qq < p.S)
      *reinterpret_cast<uint32_t*>(dq + (q0 + qq) * p.dq_ss + c) =
          repro_ptx::pack_bf16x2(tile[qq * LD + c] * scale,
                                 tile[qq * LD + c + 1] * scale);
  }
}

// ------------------------------------------------ head_dim 192 and 256

constexpr int kWK = 64;   // keys a block of the wide design

template <int HD> struct Sm90BwdWide {
  static_assert(HD == 192 || HD == 256, "the wide design takes hd 192, 256");
  static constexpr int NP = HD / 64;             // 64-column pieces
  static constexpr int KV_TILE = kWK * HD * 2;   // NP chunks [64 keys][64]
  static constexpr int Q_TILE = kBQ * HD * 2;    // NP chunks [64 rows][64]
  static constexpr int PS_TILE = kBQ * kWK * 2;  // [64 q rows][64 keys]
  static constexpr int ROWS = 2 * kBQ * 4;       // lse log2(e), delta
  static constexpr int OFF_K = 0;
  static constexpr int OFF_V = OFF_K + KV_TILE;
  static constexpr int OFF_Q = OFF_V + KV_TILE;
  static constexpr int OFF_DO = OFF_Q + kStages * Q_TILE;
  static constexpr int OFF_P = OFF_DO + kStages * Q_TILE;   // 2 buffers
  static constexpr int OFF_DS = OFF_P + 2 * PS_TILE;        // 2 buffers
  static constexpr int OFF_ROWS = OFF_DS + 2 * PS_TILE;
  static constexpr int OFF_BAR = OFF_ROWS + kStages * ROWS;
  // barriers, the block's ticket, and room to round the base up to 1024
  static constexpr int SMEM = OFF_BAR + 8 * (1 + 2 * kStages) + 8 + 1024;
};

// A 64 x 64 piece of a tile's dQ (the wgmma D fragment, unscaled) added
// into its block of the accumulator by 8 float4 atomics a thread: float4
// (8 w + j) * 32 + lane of the block holds D elements 4 j .. 4 j + 3 of
// lane `lane` of warp w, so that each warp's adds are 512 contiguous bytes
// (`flash_bwd_sm90_wide_dq_kernel` undoes the order).
__device__ __forceinline__ void add_dq_piece(float* blk, const float (&d)[32],
                                             int warp, int lane) {
  float4* dst = reinterpret_cast<float4*>(blk) + warp * 8 * 32 + lane;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    atomicAdd(dst + j * 32,
              make_float4(d[4 * j], d[4 * j + 1], d[4 * j + 2], d[4 * j + 3]));
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// `tiles`: the counts a q tile, then the blocks' ticket (a parameter of its
// own: a pointer added to Sm90Args made the hd 64 kernel 6% slower).
// One block per (KV head, batch, 64 keys): consumer warpgroup 0 owns dV,
// warpgroup 1 dK (64 keys x HD each, HD / 2 registers a thread); the
// producer warp as in the kernel above. Per q tile of 64 rows each
// consumer warpgroup runs
//   S^T = K Q^T, dP^T = V dO^T     for all 64 keys x its 32 q rows (N = 32)
//   P^T, dS^T in registers          (the mask, lse and softcap rules)
// and stores P and dS (bf16, [q row][key], 128-byte swizzled) to shared
// memory; after a barrier of the two,
//   dV += P^T dO (warpgroup 0) or dK += dS^T Q (warpgroup 1)
//   dQ = dS K in 64-column pieces, the pieces split between the two
// with P, dS, dO and Q MN-major from shared memory; each dQ piece is added
// into the fp32 accumulator by float4 atomics from registers, the blocks
// that reach a q tile in key-tile order (a count a tile), so that dQ is
// the same every run.
template <int HD, bool CAPPED>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_sm90_wide_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_do, const Sm90Args a,
    int* const tiles) {
  using C = Sm90BwdWide<HD>;
  constexpr int NP = C::NP;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const unsigned char* sbase = smem_raw + (base - raw);
  const uint32_t bar_kv = base + C::OFF_BAR;
  const uint32_t bar_full = bar_kv + 8;                // kStages of them
  const uint32_t bar_empty = bar_full + 8 * kStages;   // kStages of them

  // The block's work by a ticket taken when it starts, not blockIdx: a
  // block waits only on blocks of lower tickets (below), which have all
  // started, so that every wait ends whatever order the blocks are run in.
  // (in the dynamic shared memory, after the barriers: a static variable
  // would be placed 1024-aligned beside it, past the 227 KB at hd 256)
  int* const ticket_s = reinterpret_cast<int*>(
      smem_raw + (base - raw) + C::OFF_BAR + 8 * (1 + 2 * kStages));
  if (threadIdx.x == 0)
    *ticket_s = atomicAdd(tiles + int64_t(a.B) * a.H * (a.Sp / kBQ), 1);
  __syncthreads();
  const int ticket = *ticket_s;
  // A 1-D order over groups of a.kv_group (batch, KV head) pairs; within a
  // group the key tile is the slower index, first (longest) first. The
  // blocks resident at once are then the key tiles of the pairs of one or
  // two groups, which read the same q tiles and add into the same
  // accumulator rows, so that those stay in L2 (MLA's 128 KV heads at one
  // key tile each would read and add 200 MB apiece, four times the L2),
  // and a group is long enough (the host's choice) that the longest
  // blocks start first where there are few (gemma3's 8 KV heads are one
  // group).
  const int nkt = (a.T + kWK - 1) / kWK;
  const int grp = ticket / (a.kv_group * nkt);
  const int in_grp = ticket - grp * a.kv_group * nkt;
  const int pairs = min(a.kv_group, a.B * a.Hkv - grp * a.kv_group);
  const int k0 = (in_grp / pairs) * kWK;
  const int pair_id = grp * a.kv_group + in_grp % pairs;
  const int hk = pair_id % a.Hkv, b = pair_id / a.Hkv;
  const int G = a.H / a.Hkv;
  // the q tiles these keys reach, last first, the G heads of a tile in
  // turn (as in the kernel above)
  const int k_end = min(k0 + kWK, a.T);
  const int q_lo = a.causal ? k0 : 0;
  const int q_hi = a.window > 0 ? min(a.S, k_end - 1 + a.window) : a.S;
  const int first = q_lo / kBQ;
  const int nqt = q_hi > q_lo ? (q_hi + kBQ - 1) / kBQ - first : 0;
  const int n_items = G * nqt;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 8);   // one arrival a consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == 2) {
    // ---------------------------------------------------------- producer
    setmaxnreg_dec<24>();
    if (threadIdx.x == 256 && n_items > 0) {
      mbar_arrive_expect_tx(bar_kv, 2 * C::KV_TILE);
#pragma unroll
      for (int c = 0; c < NP; ++c) {
        tma_load_4d(base + C::OFF_K + c * kWK * 128, &tm_k, bar_kv, c * 64,
                    k0, hk, b);
        tma_load_4d(base + C::OFF_V + c * kWK * 128, &tm_v, bar_kv, c * 64,
                    k0, hk, b);
      }
      for (int it = 0; it < n_items; ++it) {
        const int st = it % kStages;
        mbar_wait(bar_empty + 8 * st, ((it / kStages) & 1) ^ 1);
        const int h = hk * G + it % G;
        const int q0 = (first + nqt - 1 - it / G) * kBQ;
        const uint32_t full = bar_full + 8 * st;
        mbar_arrive_expect_tx(full, 2 * C::Q_TILE + C::ROWS);
#pragma unroll
        for (int c = 0; c < NP; ++c) {
          tma_load_4d(base + C::OFF_Q + st * C::Q_TILE + c * kBQ * 128,
                      &tm_q, full, c * 64, q0, h, b);
          tma_load_4d(base + C::OFF_DO + st * C::Q_TILE + c * kBQ * 128,
                      &tm_do, full, c * 64, q0, h, b);
        }
        const int64_t row = (int64_t(b) * a.H + h) * a.Sp + q0;
        const uint32_t rows = base + C::OFF_ROWS + st * C::ROWS;
        bulk_load(rows, a.lse2 + row, kBQ * 4, full);
        bulk_load(rows + kBQ * 4, a.delta + row, kBQ * 4, full);
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    setmaxnreg_inc<240>();
    const int w = wg;   // 0: dV, 1: dK; q rows 32 w .. of S^T and dP^T
    const int tw = threadIdx.x & 127;
    const int warp = tw >> 5, lane = tw & 31, g = lane >> 2, t = lane & 3;
    const float scale = 1.0f / sqrtf(float(HD));
    const float sl2 = kLog2e * scale;
    const float cap_in = CAPPED ? scale / a.softcap : 0.f;
    const float cap_out = a.softcap * kLog2e;
    const bool masked_keys = k0 + kWK - 1 >= a.T;

    float acc[NP][32];   // dV or dK: keys k0 + 16 warp + g (+8), pieces
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[p][i] = 0.f;

    if (n_items > 0) mbar_wait(bar_kv, 0);

    for (int it = 0; it < n_items; ++it) {
      const int st = it % kStages;
      const int h = hk * G + it % G;
      const int q0 = (first + nqt - 1 - it / G) * kBQ;
      mbar_wait(bar_full + 8 * st, (it / kStages) & 1);
      const uint32_t q_s = base + C::OFF_Q + st * C::Q_TILE;
      const uint32_t do_s = base + C::OFF_DO + st * C::Q_TILE;

      // S^T = K Q^T and dP^T = V dO^T, the block's 64 keys by this
      // warpgroup's 32 q rows, raw, in two groups
      float sT[16], dpT[16];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        WgmmaSS<32, 0, 0>::run(
            sT,
            desc_kmajor(base + C::OFF_K + (kk >> 2) * (kWK * 128) +
                        (kk & 3) * 32),
            desc_kmajor(q_s + (kk >> 2) * (kBQ * 128) + w * (32 * 128) +
                        (kk & 3) * 32),
            kk);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        WgmmaSS<32, 0, 0>::run(
            dpT,
            desc_kmajor(base + C::OFF_V + (kk >> 2) * (kWK * 128) +
                        (kk & 3) * 32),
            desc_kmajor(do_s + (kk >> 2) * (kBQ * 128) + w * (32 * 128) +
                        (kk & 3) * 32),
            kk);
      wgmma_commit();

      // P^T into sT, dS^T into dpT; element 4 j + 2 r + e: key k0 + 16 warp
      // + g + 8 r, q row q0 + 32 w + 8 j + 2 t + e
      const float* rows =
          reinterpret_cast<const float*>(sbase + C::OFF_ROWS + st * C::ROWS);
      const bool masked = (a.causal && k0 + kWK - 1 > q0) ||
                          (a.window > 0 && q0 + kBQ - 1 - k0 >= a.window) ||
                          masked_keys;
      float fac[CAPPED ? 16 : 1];
      wgmma_wait<1>();
      fence_regs(sT);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qc = 32 * w + 8 * j + 2 * t + e;
          const float l2 = rows[qc];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int i = 4 * j + 2 * r + e;
            float z;
            if constexpr (CAPPED) {
              const float th = tanhf(sT[i] * cap_in);
              fac[i] = 1.f - th * th;
              z = cap_out * th;
            } else {
              z = sT[i] * sl2;
            }
            float p = repro_ptx::exp2_approx(z - l2);
            if (masked && !key_valid(a, q0 + qc, k0 + 16 * warp + g + 8 * r))
              p = 0.f;
            sT[i] = p;
          }
        }
      wgmma_wait<0>();
      fence_regs(dpT);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float dl = rows[kBQ + 32 * w + 8 * j + 2 * t + e];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int i = 4 * j + 2 * r + e;
            float ds = sT[i] * (dpT[i] - dl);
            if constexpr (CAPPED) ds *= fac[i];
            dpT[i] = ds;
          }
        }

      // P and dS into shared memory as [q row][key] (128-byte rows,
      // swizzled), buffer it % 2, by transposing stores of the warp's 16
      // keys x 16 rows a step: lane l addresses row 32 w + 16 kk + 8 (l /
      // 16) + l % 8 of 8 keys 16 warp + 8 ((l / 8) % 2) on. A buffer was
      // last read by the products of item it - 2, done before the other
      // warpgroup reached the barrier of item it - 1.
      const uint32_t p_s = base + C::OFF_P + (it & 1) * C::PS_TILE;
      const uint32_t ds_s = base + C::OFF_DS + (it & 1) * C::PS_TILE;
      {
        const int mi = lane >> 3, q8 = lane & 7;
        const uint32_t off = (32 * w + 8 * (mi >> 1) + q8) * 128 +
                             (((2 * warp + (mi & 1)) ^ q8) << 4);
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          uint32_t x[4], y[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            x[c] = repro_ptx::pack_bf16x2(sT[8 * kk + 2 * c],
                                          sT[8 * kk + 2 * c + 1]);
            y[c] = repro_ptx::pack_bf16x2(dpT[8 * kk + 2 * c],
                                          dpT[8 * kk + 2 * c + 1]);
          }
          stmatrix_x4_trans(p_s + off + kk * 2048, x[0], x[1], x[2], x[3]);
          stmatrix_x4_trans(ds_s + off + kk * 2048, y[0], y[1], y[2], y[3]);
        }
      }
      fence_proxy_async();
      named_bar_sync(1, 256);   // both warpgroups' P and dS are in

      // dV += P^T dO or dK += dS^T Q: the q rows as the k axis, both
      // operands MN-major; N = 128 over pairs of pieces, 64 for the last
      const uint32_t a_s = w ? ds_s : p_s;
      const uint32_t b_s = w ? q_s : do_s;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk) {
        const uint64_t da = desc_mnmajor(a_s + kk * 2048, kWK * 128);
#pragma unroll
        for (int pp = 0; pp < NP / 2; ++pp)
          WgmmaSS<128, 1, 1>::run(
              pair(acc, 2 * pp), da,
              desc_mnmajor(b_s + 2 * pp * (kBQ * 128) + kk * 2048, kBQ * 128),
              1);
        if constexpr (NP % 2 == 1)
          WgmmaSS<64, 1, 1>::run(
              acc[NP - 1], da,
              desc_mnmajor(b_s + (NP - 1) * (kBQ * 128) + kk * 2048,
                           kBQ * 128),
              1);
      }
      wgmma_commit();

      // dQ = dS K (dS K-major, K MN-major) in pieces of 64 columns: this
      // warpgroup's are p0 and p0 + 2, p0 = (it + w) % 2, so that the two
      // share the pieces evenly over two tiles. At hd 192 the warpgroup
      // whose p0 is 1 has no piece 3: it computes piece 1 again and drops
      // it, 1/15 of the products wasted, where a product issued on one
      // warpgroup's branch only made ptxas serialize every wgmma (C7520)
      const int p0 = (it + w) & 1;
      const int p1 = p0 + 2 < NP ? p0 + 2 : p0;
      float dq0[32], dq1[32];
#pragma unroll
      for (int kk = 0; kk < kWK / 16; ++kk)
        WgmmaSS<64, 0, 1>::run(
            dq0, desc_kmajor(ds_s + kk * 32),
            desc_mnmajor(base + C::OFF_K + p0 * (kWK * 128) + kk * 2048,
                         kWK * 128),
            kk);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < kWK / 16; ++kk)
        WgmmaSS<64, 0, 1>::run(
            dq1, desc_kmajor(ds_s + kk * 32),
            desc_mnmajor(base + C::OFF_K + p1 * (kWK * 128) + kk * 2048,
                         kWK * 128),
            kk);
      wgmma_commit();

      wgmma_wait<1>();   // dV or dK, and the first dQ piece
      fence_regs(dq0);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * st);   // Q, dO, rows read
      wgmma_wait<0>();
      fence_regs(dq1);

      // dQ into the accumulator after the 8 consumer warps of each block
      // of an earlier key tile that reaches this q tile (every one from
      // key tile kt_a on; the window's first), which add in the same
      // order: the sum's order is fixed. Those blocks hold lower tickets
      // (a group's key tiles in order), so they have started, and they
      // wait on none of a higher ticket.
      int* count = tiles + (int64_t(b) * a.H + h) * (a.Sp / kBQ) + q0 / kBQ;
      const int reach = q0 - (kWK - 1) - a.window;   // key tile kt_a's key
      const int kt_a = a.window > 0 && reach >= 0 ? reach / kWK + 1 : 0;
      if (lane == 0)
        while (ld_acquire(count) < 8 * (k0 / kWK - kt_a)) __nanosleep(64);
      __syncwarp();
      float* blk = a.dq_acc + ((int64_t(b) * a.H + h) * a.Sp + q0) * HD;
      add_dq_piece(blk + p0 * 4096, dq0, warp, lane);
      if (p1 != p0) add_dq_piece(blk + p1 * 4096, dq1, warp, lane);
      __threadfence();   // this lane's adds before the count
      __syncwarp();
      if (lane == 0) atomicAdd(count, 1);
    }
#pragma unroll
    for (int p = 0; p < NP; ++p) fence_regs(acc[p]);

    // dV, or dK (q was not pre-scaled: times 1/sqrt(hd)), rows before T
    bf16* out = w ? a.dk + b * a.dk_sb + hk * a.dk_sh
                  : a.dv + b * a.dv_sb + hk * a.dv_sh;
    const int64_t st_t = w ? a.dk_st : a.dv_st;
    const float mul = w ? scale : 1.f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kj = k0 + 16 * warp + g + 8 * r;
      if (kj < a.T) {
#pragma unroll
        for (int p = 0; p < NP; ++p)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            *reinterpret_cast<uint32_t*>(out + kj * st_t + 64 * p + 8 * j +
                                         2 * t) =
                repro_ptx::pack_bf16x2(acc[p][4 * j + 2 * r] * mul,
                                       acc[p][4 * j + 2 * r + 1] * mul);
      }
    }
  }
}

// One block a (64-row tile, head, batch): each of the tile's HD / 64
// blocks of the accumulator in (coalesced float4 reads, `add_dq_piece`'s
// order undone) through shared memory as [q row][column] (row stride 65),
// then dq = acc / sqrt(hd) in bf16 pairs along rows, rows before S.
template <int HD>
__global__ void __launch_bounds__(256) flash_bwd_sm90_wide_dq_kernel(
    DqArgs p) {
  constexpr int LD = 65;
  __shared__ float tile[64 * LD];
  const int q0 = blockIdx.x * 64, h = blockIdx.y, b = blockIdx.z;
  const float4* src = reinterpret_cast<const float4*>(
      p.dq_acc + ((int64_t(b) * p.H + h) * p.Sp + q0) * HD);
  const float scale = 1.0f / sqrtf(float(HD));
  bf16* dq = p.dq + b * p.dq_sb + h * p.dq_sh;
  for (int pc = 0; pc < HD / 64; ++pc) {
    for (int i = threadIdx.x; i < 1024; i += 256) {
      // float4 i of the piece: warp i / 256, n8 tile (i / 32) % 8, lane
      // i % 32; elements (row, col), (row, col + 1), then row + 8
      const float4 x = src[pc * 1024 + i];
      const int l = i & 31;
      float* d = tile + (16 * (i >> 8) + (l >> 2)) * LD + 8 * ((i >> 5) & 7) +
                 2 * (l & 3);
      d[0] = x.x;
      d[1] = x.y;
      d[8 * LD] = x.z;
      d[8 * LD + 1] = x.w;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < 64 * 32; i += 256) {
      const int r = i >> 5, c = 2 * (i & 31);
      if (q0 + r < p.S)
        *reinterpret_cast<uint32_t*>(dq + (q0 + r) * p.dq_ss + 64 * pc + c) =
            repro_ptx::pack_bf16x2(tile[r * LD + c] * scale,
                                   tile[r * LD + c + 1] * scale);
    }
    __syncthreads();
  }
}

// The tensor maps of q, k, v and dout (boxes of 64 columns by `kb` key
// rows for k and v, kBQ rows for q and dout), then the prep launch.
template <int HD>
cudaError_t maps_and_prep(const void* q, const void* k, const void* v,
                          const PrepArgs& prep, const int64_t* tma, int kb,
                          CUtensorMap* maps, cudaStream_t stream) {
  cudaError_t err = encode_tma_4d(&maps[0], q, tma, kBQ);
  if (err == cudaSuccess) err = encode_tma_4d(&maps[1], k, tma + 7, kb);
  if (err == cudaSuccess) err = encode_tma_4d(&maps[2], v, tma + 14, kb);
  if (err == cudaSuccess)
    err = encode_tma_4d(&maps[3], prep.dout, tma + 21, kBQ);
  if (err != cudaSuccess) return err;
  const int64_t rows = int64_t(prep.B) * prep.H * prep.Sp;
  flash_bwd_sm90_prep_kernel<HD>
      <<<int((rows + 3) / 4), 128, 0, stream>>>(prep);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_sm90(const void* q, const void* k, const void* v,
                        const PrepArgs& prep, Sm90Args a, const DqArgs& dq,
                        const int64_t* tma, cudaStream_t stream) {
  using C = Sm90Bwd<HD>;
  static_assert(C::SMEM <= 232448, "shared memory beyond a block's 227 KB");
  static const cudaError_t attr[2] = {
      cudaFuncSetAttribute(flash_bwd_sm90_kernel<HD, false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           C::SMEM),
      cudaFuncSetAttribute(flash_bwd_sm90_kernel<HD, true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           C::SMEM)};
  if (attr[0] != cudaSuccess) return attr[0];
  if (attr[1] != cudaSuccess) return attr[1];
  CUtensorMap m[4];
  cudaError_t err = maps_and_prep<HD>(q, k, v, prep, tma, kBK, m, stream);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.Hkv, a.B, (a.T + kBK - 1) / kBK);
  if (a.softcap > 0.f)
    flash_bwd_sm90_kernel<HD, true>
        <<<grid, kThreads, C::SMEM, stream>>>(m[0], m[1], m[2], m[3], a);
  else
    flash_bwd_sm90_kernel<HD, false>
        <<<grid, kThreads, C::SMEM, stream>>>(m[0], m[1], m[2], m[3], a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_sm90_dq_kernel<HD>
      <<<dim3(prep.Sp / 64, prep.H, prep.B), 256, 0, stream>>>(dq);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_sm90_wide(const void* q, const void* k, const void* v,
                             const PrepArgs& prep, Sm90Args a,
                             const DqArgs& dq, const int64_t* tma,
                             cudaStream_t stream) {
  using C = Sm90BwdWide<HD>;
  static_assert(C::SMEM <= 232448, "shared memory beyond a block's 227 KB");
  static const cudaError_t attr[2] = {
      cudaFuncSetAttribute(flash_bwd_sm90_wide_kernel<HD, false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           C::SMEM),
      cudaFuncSetAttribute(flash_bwd_sm90_wide_kernel<HD, true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           C::SMEM)};
  if (attr[0] != cudaSuccess) return attr[0];
  if (attr[1] != cudaSuccess) return attr[1];
  CUtensorMap m[4];
  cudaError_t err = maps_and_prep<HD>(q, k, v, prep, tma, kWK, m, stream);
  if (err != cudaSuccess) return err;
  // groups of (batch, KV head) pairs of at least two blocks an SM
  static const int sms = [] {
    int dev = 0, n = 132;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 132;
    return n;
  }();
  const int nkt = (a.T + kWK - 1) / kWK;
  a.kv_group = (2 * sms + nkt - 1) / nkt;
  const unsigned grid = unsigned(nkt) * a.Hkv * a.B;
  if (a.softcap > 0.f)
    flash_bwd_sm90_wide_kernel<HD, true><<<grid, kThreads, C::SMEM, stream>>>(
        m[0], m[1], m[2], m[3], a, prep.tiles);
  else
    flash_bwd_sm90_wide_kernel<HD, false><<<grid, kThreads, C::SMEM, stream>>>(
        m[0], m[1], m[2], m[3], a, prep.tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_sm90_wide_dq_kernel<HD>
      <<<dim3(prep.Sp / 64, prep.H, prep.B), 256, 0, stream>>>(dq);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The bf16 backward at head_dim 64, 128, 192 or 256 (any other:
// cudaErrorInvalidValue):
// dq, dk, dv ((B,H|Hkv,S|T,hd) strided views) from q, k, v, the forward's
// out and lse (B, H, S) fp32, and dout. Scratch from the caller: `rows`
// (2, B, H, Sp) fp32 (lse log2(e), delta), `dq_acc` (B, H, Sp, hd) fp32,
// `tiles` (B H Sp / 64 + 1) int32 (a count a q tile, then the blocks'
// ticket), Sp = S rounded up to 64. `tma`: for q, k, v, dout in turn the 4 dims
// (hd, rows, heads, batch) and 3 byte strides (rows, heads, batch) of its
// TMA descriptor; `strides`: the element strides (batch, head, row) of out,
// dout, dq, dk and dv. Three launches on `stream`; returns cudaGetLastError()
// after the last, or the error that stopped it (0 on success).
int repro_flash_attention_bwd_sm90(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* rows, float* dq_acc,
    int* tiles, void* dq, void* dk, void* dv, int B, int H, int Hkv, int S,
    int T,
    int hd, const int64_t* tma, const int64_t* strides, int causal,
    int window, float softcap, void* stream) {
  const int Sp = (S + kBQ - 1) / kBQ * kBQ;
  const int64_t n = int64_t(B) * H * Sp;
  const PrepArgs prep{static_cast<const bf16*>(o),
                      static_cast<const bf16*>(dout), lse, rows, rows + n,
                      dq_acc, tiles, strides[0], strides[1], strides[2],
                      strides[3], strides[4], strides[5], B, H, S, Sp};
  const Sm90Args a{rows, rows + n, dq_acc,
                   static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                   strides[9], strides[10], strides[11],
                   strides[12], strides[13], strides[14],
                   B, H, Hkv, S, T, Sp, causal, window, softcap};
  const DqArgs dqa{dq_acc, static_cast<bf16*>(dq), strides[6], strides[7],
                   strides[8], H, S, Sp};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: return int(launch_sm90<64>(q, k, v, prep, a, dqa, tma, s));
    case 128: return int(launch_sm90<128>(q, k, v, prep, a, dqa, tma, s));
    case 192: return int(launch_sm90_wide<192>(q, k, v, prep, a, dqa, tma, s));
    case 256: return int(launch_sm90_wide<256>(q, k, v, prep, a, dqa, tma, s));
    default: return int(cudaErrorInvalidValue);
  }
}

// The CUresult of the last tensor-map encoding (0: CUDA_SUCCESS).
int repro_flash_attention_bwd_sm90_cu_result() {
  return repro_sm90::g_last_cu_result;
}

}  // extern "C"
