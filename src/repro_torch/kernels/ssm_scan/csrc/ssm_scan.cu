// Mamba selective scan for Hopper (sm_90a), written by hand in CUDA C++.
//
// Replaces the Pallas TPU kernel `_ssm_kernel` in
// src/repro/kernels/ssm_scan/kernel.py:21 (wrapper `ssm_scan` :52,
// `pl.pallas_call` :63), and computes what it computes, with the state
// taken in and given out (the Pallas kernel zeroes its VMEM state at the
// first chunk and keeps the last one to itself):
//   h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t x_t     (per channel d: ds states)
//   y_t = C_t . h_t + D x_t
// x (B,S,di) and y: fp32 or bf16. dt (B,S,di), B and C (B,S,ds): fp32 or
// bf16, one type for the three, independent of x's (the model passes bf16 x
// with fp32 dt, B, C). A (di,ds) and D (di,) fp32. h0 (B,di,ds) fp32 or null
// (zeros); h_last (B,di,ds) fp32, the layout of the model's decode cache.
// Math is fp32; the decay is 2^(dt A log2(e)) on the special function units
// (ex2.approx, about 2 ulp).
//
// What bounds it on the H100. At jamba's serve shape (B=2, S=2048,
// di=16,384, ds=16, bf16 x and y, fp32 dt, B, C) the kernel must move about
// 543 MB (x 134 MB, dt 268 MB, y 134 MB, the state in and out 4 MB): 0.162 ms
// at 3.35 TB/s. It does 1.07e9 state updates, each one exp on the special
// function units (16 per SM per clock: 0.257 ms at 1.98 GHz over 132 SMs)
// and about 6 flop (0.096 ms at 67 TFLOP/s fp32). The exps bound it.
//
// The design (this file's second; the first gave one thread a whole channel,
// 8 warps an SM at the serve shape, one wave of too few warps, issue-bound
// on the accurate expf):
//   - Two lanes share a channel, each owning ds/2 of its states (8 at ds 16,
//     4 at ds 8) and the matching entries of A, pre-scaled by log2(e) once,
//     in registers for the whole sequence. A state update is one ex2.approx
//     and four FMA-pipe operations. That is 2x the threads of the first
//     design: 65,536 at the serve shape. (Four lanes a channel, at most 64
//     registers a thread for one wave, timed slower on the H100: spills, and
//     more per-step work a state.) The state is read and written as 16-byte
//     vectors, the lanes of a channel on consecutive addresses.
//   - A block is 128 channels (256 threads), grid (ceil(di/128), B), at most
//     128 registers a thread so that 2 blocks fit an SM and the serve
//     shape's 256 blocks run in one wave. It stages TC steps at a time in
//     shared memory, as fp32: B_t and C_t (read as vectors by each lane,
//     broadcast across the warp), and (x, dt) pairs of its 128 channels
//     (loaded coalesced along di). The next chunk's loads are issued into
//     registers before the current chunk is computed, so they are in flight
//     with it; the exps depend only on dt, so they can run ahead of the FMA
//     chain. Every load and store of a chunk steps one pointer by a constant
//     stride (the address arithmetic was a third of the instructions).
//   - y: each lane writes its share (C_t . h_t over its states, plus D x_t
//     in the channel's first lane) to shared memory, and the shares are
//     summed when the chunk's y is stored, coalesced along di: no shuffles
//     on the recurrence.
//   - The Pallas grid's sequential chunk axis becomes the block's loop over
//     time, so no state leaves registers until h_last is written.
//   - Any di and any S >= 1 work: channels past di and steps past S are
//     masked. The Pallas wrapper asserts di % bd == 0 and S % bc == 0; the
//     serve path has prompts of 8-64 tokens and decode at S = 1.
//   - x, dt, B, C and y are read and written by (batch, time) strides with a
//     contiguous last axis, so views of the model's tensors need no copy.
// The kernel launches on the caller's stream, allocates nothing and does not
// synchronize; the C entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_mma.cuh"

namespace {

constexpr int LPC = 2;              // lanes a channel
constexpr int NT = 256;             // threads a block
constexpr int CPB = NT / LPC;       // channels a block
constexpr int TC = 16;              // time steps a staged chunk
// at most 128 registers a thread: 2 blocks an SM, so the serve shape's 256
// blocks run in one wave on 132 SMs
constexpr int MIN_BLOCKS = 2;
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const void* x;
  const void* dt;
  const void* b;
  const void* c;
  const float* a;
  const float* d;
  const float* h0;  // null: zero state
  void* y;
  float* h1;
  int64_t x_sb, x_ss;
  int64_t dt_sb, dt_ss;
  int64_t b_sb, b_ss;
  int64_t c_sb, c_ss;
  int64_t y_sb, y_ss;
  int B, S, DI;
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

// N consecutive floats at p (aligned to min(N, 4) floats) as 16-byte (or,
// for N = 2, 8-byte) vector accesses.
template <int N>
__device__ __forceinline__ void load_vec(float (&dst)[N], const float* p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      dst[i] = v.x; dst[i + 1] = v.y; dst[i + 2] = v.z; dst[i + 3] = v.w;
    }
  } else {
    static_assert(N == 2, "vectors of 2 or of a multiple of 4 floats");
    const float2 v = *reinterpret_cast<const float2*>(p);
    dst[0] = v.x; dst[1] = v.y;
  }
}

template <int N>
__device__ __forceinline__ void store_vec(float* p, const float (&src)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4)
      *reinterpret_cast<float4*>(p + i) =
          make_float4(src[i], src[i + 1], src[i + 2], src[i + 3]);
  } else {
    static_assert(N == 2, "vectors of 2 or of a multiple of 4 floats");
    *reinterpret_cast<float2*>(p) = make_float2(src[0], src[1]);
  }
}

// TX: x and y; TP: dt, B and C.
template <typename TX, typename TP, int DS>
__global__ void __launch_bounds__(NT, MIN_BLOCKS) ssm_scan_kernel(Args p) {
  constexpr int SPL = DS / LPC;                // states a lane
  constexpr int XPT = TC * CPB / NT;           // x (and dt) loads a thread
  constexpr int BPT = (TC * DS + NT - 1) / NT; // B (and C) loads a thread
  __shared__ __align__(16) float Bs[TC][DS];
  __shared__ __align__(16) float Cs[TC][DS];
  __shared__ __align__(8) float2 XD[TC][CPB];    // (x, dt)
  __shared__ __align__(16) float Yp[TC][CPB][LPC]; // each lane's share of y
  const int tid = threadIdx.x;
  const int chl = tid / LPC, part = tid % LPC;
  const int ch0 = blockIdx.x * CPB;
  const int ch = ch0 + chl;
  const int bi = blockIdx.y;
  const bool active = ch < p.DI;
  const int s0 = part * SPL;
  const int64_t state0 = (int64_t(bi) * p.DI + ch) * DS + s0;

  float a2[SPL], h[SPL];
  float dq = 0.f;   // D of the channel in its first lane, 0 in the others
  if (active) {
    if (part == 0) dq = p.d[ch];
    load_vec<SPL>(a2, p.a + int64_t(ch) * DS + s0);
    if (p.h0 != nullptr) {
      load_vec<SPL>(h, p.h0 + state0);
    } else {
#pragma unroll
      for (int s = 0; s < SPL; ++s) h[s] = 0.f;
    }
  } else {
#pragma unroll
    for (int s = 0; s < SPL; ++s) a2[s] = h[s] = 0.f;
  }
#pragma unroll
  for (int s = 0; s < SPL; ++s) a2[s] *= kLog2e;

  const TX* xb = static_cast<const TX*>(p.x) + bi * p.x_sb;
  const TP* dtb = static_cast<const TP*>(p.dt) + bi * p.dt_sb;
  const TP* bb = static_cast<const TP*>(p.b) + bi * p.b_sb;
  const TP* cb = static_cast<const TP*>(p.c) + bi * p.c_sb;
  TX* yb = static_cast<TX*>(p.y) + bi * p.y_sb;
  const int S = p.S;
  const int64_t x_ss = p.x_ss, dt_ss = p.dt_ss, y_ss = p.y_ss;

  // Staging and storing, by (step, channel): this thread's channel xc and
  // steps xt, xt + LPC, ... of each chunk (XPT of them), so every access
  // of a chunk is one pointer stepped by a constant stride.
  const int xc = tid % CPB, xt = tid / CPB;
  const bool xin = ch0 + xc < p.DI;
  float xr[XPT], dr[XPT], br[BPT], cr[BPT];
  auto fetch = [&](int t0) {
    const TX* xp = xb + int64_t(t0 + xt) * x_ss + ch0 + xc;
    const TP* dp = dtb + int64_t(t0 + xt) * dt_ss + ch0 + xc;
#pragma unroll
    for (int i = 0; i < XPT; ++i) {
      const bool in = xin && t0 + xt + i * LPC < S;
      xr[i] = in ? to_float(*xp) : 0.f;
      dr[i] = in ? to_float(*dp) : 0.f;
      xp += LPC * x_ss;
      dp += LPC * dt_ss;
    }
#pragma unroll
    for (int i = 0; i < BPT; ++i) {
      const int e = tid + i * NT, t = t0 + e / DS, s = e % DS;
      const bool in = e < TC * DS && t < S;
      br[i] = in ? to_float(bb[int64_t(t) * p.b_ss + s]) : 0.f;
      cr[i] = in ? to_float(cb[int64_t(t) * p.c_ss + s]) : 0.f;
    }
  };

  // one step of this lane's states: per state one ex2 and four FMA-pipe
  // operations; the lane's share of y_t (C_t . h_t over its states, plus
  // D x_t in the first lane) goes to shared memory, and the shares are
  // summed when y is stored, off the recurrence
  auto step = [&](int t) {
    const float2 xd = XD[t][chl];
    const float dx = xd.y * xd.x;
    float bv[SPL], cv[SPL];
    load_vec<SPL>(bv, &Bs[t][s0]);
    load_vec<SPL>(cv, &Cs[t][s0]);
    float acc = dq * xd.x;
#pragma unroll
    for (int s = 0; s < SPL; ++s) {
      h[s] = fmaf(repro_ptx::exp2_approx(xd.y * a2[s]), h[s], dx * bv[s]);
      acc = fmaf(h[s], cv[s], acc);
    }
    Yp[t][chl][part] = acc;
  };

  fetch(0);
  for (int t0 = 0; t0 < S; t0 += TC) {
    const int n = min(TC, S - t0);
#pragma unroll
    for (int i = 0; i < XPT; ++i)
      XD[xt + i * LPC][xc] = make_float2(xr[i], dr[i]);
#pragma unroll
    for (int i = 0; i < BPT; ++i) {
      const int e = tid + i * NT;
      if (e < TC * DS) {
        Bs[e / DS][e % DS] = br[i];
        Cs[e / DS][e % DS] = cr[i];
      }
    }
    __syncthreads();   // the chunk is staged; the last chunk's y is stored
    if (t0 + TC < S) fetch(t0 + TC);   // in flight while this one runs
    if (n == TC) {
#pragma unroll
      for (int t = 0; t < TC; ++t) step(t);
    } else {
      for (int t = 0; t < n; ++t) step(t);
    }
    __syncthreads();   // Yp is complete; XD, Bs, Cs are free
    TX* yp = yb + int64_t(t0 + xt) * y_ss + ch0 + xc;
#pragma unroll
    for (int i = 0; i < XPT; ++i) {
      const int t = xt + i * LPC;
      if (xin && t < n) {
        float share[LPC];
        load_vec<LPC>(share, &Yp[t][xc][0]);
        float y = share[0];
#pragma unroll
        for (int l = 1; l < LPC; ++l) y += share[l];
        *yp = from_float<TX>(y);
      }
      yp += LPC * y_ss;
    }
  }
  if (active) store_vec<SPL>(p.h1 + state0, h);
}

template <typename TX, typename TP, int DS>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const dim3 grid((a.DI + CPB - 1) / CPB, a.B);
  ssm_scan_kernel<TX, TP, DS><<<grid, NT, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename TX, typename TP>
cudaError_t dispatch_state(const Args& a, int ds, cudaStream_t stream) {
  switch (ds) {
    case 8: return launch<TX, TP, 8>(a, stream);
    case 16: return launch<TX, TP, 16>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename TX>
cudaError_t dispatch_param(const Args& a, int p_dtype, int ds,
                           cudaStream_t stream) {
  if (p_dtype == 0) return dispatch_state<TX, float>(a, ds, stream);
  if (p_dtype == 1) return dispatch_state<TX, __nv_bfloat16>(a, ds, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x_dtype: type of x and y; p_dtype: type of dt, B and C (0 = float32,
// 1 = bfloat16). A, D, h0 and h1 are float32 and contiguous; h0 may be null
// (zero state). Strides are in elements, for the batch and time axes; the
// last axis of x, dt, B, C and y has stride 1. Returns cudaGetLastError()
// after the launch (0 on success).
int repro_ssm_scan_fwd(
    int x_dtype, int p_dtype, int ds,
    const void* x, const void* dt, const void* b, const void* c,
    const float* a, const float* d, const float* h0,
    void* y, float* h1,
    int B, int S, int DI,
    int64_t x_sb, int64_t x_ss, int64_t dt_sb, int64_t dt_ss,
    int64_t b_sb, int64_t b_ss, int64_t c_sb, int64_t c_ss,
    int64_t y_sb, int64_t y_ss,
    void* stream) {
  Args args{x, dt, b, c, a, d, h0, y, h1,
            x_sb, x_ss, dt_sb, dt_ss, b_sb, b_ss, c_sb, c_ss, y_sb, y_ss,
            B, S, DI};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0) return int(dispatch_param<float>(args, p_dtype, ds, s));
  if (x_dtype == 1)
    return int(dispatch_param<__nv_bfloat16>(args, p_dtype, ds, s));
  return int(cudaErrorInvalidValue);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
