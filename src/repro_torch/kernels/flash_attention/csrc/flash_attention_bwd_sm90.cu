// Flash attention backward for Hopper (sm_90a), bf16 at head_dim 64 and
// 128: dK, dV and dQ in one pass, on wgmma fed by TMA, written by hand in
// CUDA C++. It replaces the reference's `_blockwise_bwd`
// (src/repro/models/attention.py:153), the custom VJP of `blockwise_sdpa`
// (the Pallas kernel, src/repro/kernels/flash_attention/kernel.py:27, is a
// forward only), on the path flash_attention_bwd.cu's two-kernel `mma.sync`
// design took before; that design still serves fp32 and bf16 at head_dim
// 32, 192 and 256 (`ops.bwd_path`). The design is FlashAttention-3's
// backward (Shah et al., 2024, section 3) over the port's GQA loop:
//   delta = rowsum(dO o out),  P = exp(z - lse),  dV = P^T dO,
//   dS = P o (dO V^T - delta) [o (1 - tanh^2) under softcap],
//   dK = dS^T q / sqrt(hd),    dQ = dS K / sqrt(hd).
//
// Three launches on the caller's stream:
//   1. `flash_bwd_sm90_prep_kernel`: delta and lse log2(e) of every row,
//      padded to a multiple of 64 rows (+inf and 0 past S, +inf where lse is
//      -inf: P is 0 there, not NaN), and the fp32 dQ accumulator zeroed.
//   2. `flash_bwd_sm90_kernel`: one block per (KV head, batch, 128 keys),
//      two consumer warpgroups of 64 keys and one producer warp. The
//      producer loads the block's K and V once by TMA, then keeps Q, dO,
//      lse and delta of the next q tiles (64 rows) of its G query heads in
//      flight through a ring of 2 stages (full / empty mbarriers). Per q
//      tile each consumer warpgroup runs
//        S^T = K Q^T, dP^T = V dO^T    (wgmma, both operands in shared)
//        P^T, dS^T in registers         (the mask, lse and softcap rules)
//        dV += P^T dO, dK += dS^T Q    (wgmma, A from registers)
//      and stores dS^T to shared memory; then the warpgroup whose turn it
//      is (the tile's parity) runs dQ^T = K^T dS^T over all 128 keys
//      (wgmma from shared) and adds the tile's fp32 dQ^T block into the
//      accumulator by one bulk TMA reduce-add, while the other goes on to
//      the next tile. dK and dV stay in registers over the G heads (no
//      atomics) and are written once.
//   3. `flash_bwd_sm90_dq_kernel`: the accumulator times 1/sqrt(hd), cast
//      into dq's bf16 strided layout.
// dK and dV have one owner and a fixed order: the same every run. dQ is a
// sum of fp32 reduce-adds in the order the blocks reach them, so its last
// bits may differ from run to run (before rounding to bf16).
//
// What bounds it: five products a score against the forward's two, so it
// is operations-bound where the forward is: at mixtral's training shape (2
// x 48 heads over 8, 2048 rows, hd 128, window 4096) 257,823,866,880 flop a
// call, 0.2607 ms at the bf16 tensor cores' 989 TFLOP/s (ops.bwd_cost),
// against 236,453,888 bytes to move (0.0706 ms at 3.35 TB/s). What the
// design does about the four limits of the design it replaces:
//   1. mma.sync m16n8k16 fed by ldmatrix -> wgmma, the only way to the
//      card's full bf16 rate, reading its operands from shared memory.
//   2. S and dP computed twice (7 products a score for the 5 counted) ->
//      once: dQ comes from the same dS^T as dK, through shared memory and
//      an fp32 accumulator in device memory, so each score takes the 5
//      products `bwd_cost` counts.
//   3. Small tiles and every thread issuing cp.async -> 128 keys a block,
//      64-row q tiles, one thread issuing whole tiles by TMA (128-byte
//      swizzled, out-of-bounds rows zero-filled for ragged S and T), the
//      consumers holding the registers (`setmaxnreg` 240 against the
//      producer's 24), the two consumer warpgroups taking turns at dQ.
//   4. Uneven causal work -> the grid's slowest axis is the key tile,
//      first tile first: the blocks with the most q tiles start first and
//      the short last tiles fill the tail.
//
// Shapes: hd 64 or 128, q, k, v, dout (B,H|Hkv,S|T,hd) views read by their
// strides (the TMA descriptors are built on the host for each call from the
// dims and byte strides `ops._tma_geometry` gives), every stride of an axis
// longer than 1 a multiple of 16 bytes. A tile's block of the accumulator
// is dQ^T: HD rows (head columns) of 64 (the tile's q rows), the 8-column
// groups of row c permuted by c % 8 so that a warp's stores into shared
// memory spread over the banks (`flash_bwd_sm90_dq_kernel` undoes it).

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
  int64_t o_sb, o_sh, o_ss, do_sb, do_sh, do_ss;
  int B, H, S, Sp;
};

// One warp a padded row (b, h, s < Sp): delta = rowsum(dO o out) (0 past
// S), lse log2(e) (+inf past S and where lse = -inf), and the row's HD
// floats of the accumulator zeroed.
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

// cuTensorMapEncodeTiled from libcuda, reached through the CUDA runtime's
// entry-point query (no -lcuda at link time).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

int g_last_cu_result = 0;   // the last encode's CUresult, for the message

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A 4-D bf16 tensor map over (hd, rows, heads, batch): geometry g = those 4
// dims, then the byte strides of rows, heads and batch; boxes of 64
// columns by `box_rows` rows, 128-byte swizzled, zero fill out of bounds.
cudaError_t encode(CUtensorMap* map, const void* ptr, const int64_t* g,
                   int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {cuuint64_t(g[0]), cuuint64_t(g[1]),
                              cuuint64_t(g[2]), cuuint64_t(g[3])};
  const cuuint64_t strides[3] = {cuuint64_t(g[4]), cuuint64_t(g[5]),
                                 cuuint64_t(g[6])};
  const cuuint32_t box[4] = {64, cuuint32_t(box_rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  g_last_cu_result = int(r);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
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
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  cudaError_t err = encode(&tm_q, q, tma, kBQ);
  if (err == cudaSuccess) err = encode(&tm_k, k, tma + 7, kBK);
  if (err == cudaSuccess) err = encode(&tm_v, v, tma + 14, kBK);
  if (err == cudaSuccess) err = encode(&tm_do, prep.dout, tma + 21, kBQ);
  if (err != cudaSuccess) return err;
  const int64_t rows = int64_t(prep.B) * prep.H * prep.Sp;
  flash_bwd_sm90_prep_kernel<HD>
      <<<int((rows + 3) / 4), 128, 0, stream>>>(prep);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid(a.Hkv, a.B, (a.T + kBK - 1) / kBK);
  if (a.softcap > 0.f)
    flash_bwd_sm90_kernel<HD, true>
        <<<grid, kThreads, C::SMEM, stream>>>(tm_q, tm_k, tm_v, tm_do, a);
  else
    flash_bwd_sm90_kernel<HD, false>
        <<<grid, kThreads, C::SMEM, stream>>>(tm_q, tm_k, tm_v, tm_do, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_sm90_dq_kernel<HD>
      <<<dim3(prep.Sp / 64, prep.H, prep.B), 256, 0, stream>>>(dq);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The bf16 backward at head_dim 64 or 128 (any other: cudaErrorInvalidValue):
// dq, dk, dv ((B,H|Hkv,S|T,hd) strided views) from q, k, v, the forward's
// out and lse (B, H, S) fp32, and dout. Scratch from the caller: `rows`
// (2, B, H, Sp) fp32 (lse log2(e), delta), `dq_acc` (B, H, Sp, hd) fp32,
// Sp = S rounded up to 64. `tma`: for q, k, v, dout in turn the 4 dims
// (hd, rows, heads, batch) and 3 byte strides (rows, heads, batch) of its
// TMA descriptor; `strides`: the element strides (batch, head, row) of out,
// dout, dq, dk and dv. Three launches on `stream`; returns cudaGetLastError()
// after the last, or the error that stopped it (0 on success).
int repro_flash_attention_bwd_sm90(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* rows, float* dq_acc,
    void* dq, void* dk, void* dv, int B, int H, int Hkv, int S, int T,
    int hd, const int64_t* tma, const int64_t* strides, int causal,
    int window, float softcap, void* stream) {
  const int Sp = (S + kBQ - 1) / kBQ * kBQ;
  const int64_t n = int64_t(B) * H * Sp;
  const PrepArgs prep{static_cast<const bf16*>(o),
                      static_cast<const bf16*>(dout), lse, rows, rows + n,
                      dq_acc, strides[0], strides[1], strides[2],
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
    default: return int(cudaErrorInvalidValue);
  }
}

// The CUresult of the last tensor-map encoding (0: CUDA_SUCCESS).
int repro_flash_attention_bwd_sm90_cu_result() { return g_last_cu_result; }

}  // extern "C"
