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
// Math is fp32 on the CUDA cores, with the accurate `expf`.
//
// What bounds it on the H100. At jamba's serve shape (B=2, S=2048,
// di=16,384, ds=16, bf16 x and y, fp32 dt, B, C) the kernel must move about
// 543 MB (x 134 MB, dt 268 MB, y 134 MB, the state in and out 4 MB): 0.162 ms
// at 3.35 TB/s. It does 1.07e9 state updates, each one exp on the special
// function units (16 per SM per clock: 0.257 ms at 1.98 GHz over 132 SMs)
// and about 6 flop (0.096 ms at 67 TFLOP/s fp32). The exps bound it.
//
// What this first design does about it. It is the simple, correct first
// step, not yet a fast one:
//   - One thread owns one (batch, channel) and keeps its ds fp32 states, its
//     row of A and its D in registers for the whole sequence. The Pallas
//     grid's sequential chunk axis becomes the thread's own loop over time,
//     so no state ever leaves the thread until h_last is written.
//   - Grid (ceil(di/128), B), 128 threads a block. Each block stages a chunk
//     of TC time steps of B and C (shared by all its channels) in shared
//     memory once, and each thread loads its TC values of x and dt into
//     registers before it steps through them, so the chunk's loads are in
//     flight together. Loads of x, dt and stores of y are coalesced along di.
//   - Any di and any S >= 1 work: channels past di and steps past S are
//     masked. The Pallas wrapper asserts di % bd == 0 and S % bc == 0; the
//     serve path has prompts of 8-64 tokens and decode at S = 1.
//   - x, dt, B, C and y are read and written by (batch, time) strides with a
//     contiguous last axis, so views of the model's tensors need no copy.
//   - At the serve shape that is 256 blocks of 128 threads, under two blocks
//     (8 warps) per SM: too few warps to hide the loads' latency. Splitting
//     the sequence across blocks (a chunked scan with a second pass for the
//     carried state) and spreading the ds states over lanes are later work.
// The kernel launches on the caller's stream, allocates nothing and does not
// synchronize; the C entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BD = 128;  // channels per block, one a thread
constexpr int TC = 16;   // time steps per staged chunk

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

// TX: x and y; TP: dt, B and C.
template <typename TX, typename TP, int DS>
__global__ void __launch_bounds__(BD) ssm_scan_kernel(Args p) {
  __shared__ float Bs[TC][DS];
  __shared__ float Cs[TC][DS];
  const int tid = threadIdx.x;
  const int ch = blockIdx.x * BD + tid;
  const int bi = blockIdx.y;
  const bool active = ch < p.DI;
  const int64_t state0 = (int64_t(bi) * p.DI + ch) * DS;

  float a[DS], h[DS];
  float dd = 0.f;
#pragma unroll
  for (int s = 0; s < DS; ++s) {
    a[s] = active ? p.a[int64_t(ch) * DS + s] : 0.f;
    h[s] = (active && p.h0 != nullptr) ? p.h0[state0 + s] : 0.f;
  }
  if (active) dd = p.d[ch];

  const TX* xb = static_cast<const TX*>(p.x) + bi * p.x_sb;
  const TP* dtb = static_cast<const TP*>(p.dt) + bi * p.dt_sb;
  const TP* bb = static_cast<const TP*>(p.b) + bi * p.b_sb;
  const TP* cb = static_cast<const TP*>(p.c) + bi * p.c_sb;
  TX* yb = static_cast<TX*>(p.y) + bi * p.y_sb;

  for (int t0 = 0; t0 < p.S; t0 += TC) {
    const int n = min(TC, p.S - t0);
    __syncthreads();  // every thread is done with the previous chunk's B, C
    for (int i = tid; i < TC * DS; i += BD) {
      const int t = i / DS, s = i % DS;
      float bv = 0.f, cv = 0.f;
      if (t < n) {
        bv = to_float(bb[int64_t(t0 + t) * p.b_ss + s]);
        cv = to_float(cb[int64_t(t0 + t) * p.c_ss + s]);
      }
      Bs[t][s] = bv;
      Cs[t][s] = cv;
    }
    float xv[TC], dv[TC];
#pragma unroll
    for (int t = 0; t < TC; ++t) {
      xv[t] = 0.f;
      dv[t] = 0.f;
      if (active && t < n) {
        xv[t] = to_float(xb[int64_t(t0 + t) * p.x_ss + ch]);
        dv[t] = to_float(dtb[int64_t(t0 + t) * p.dt_ss + ch]);
      }
    }
    __syncthreads();
    if (active) {
#pragma unroll
      for (int t = 0; t < TC; ++t) {
        if (t < n) {
          float acc = 0.f;
#pragma unroll
          for (int s = 0; s < DS; ++s) {
            const float decay = expf(dv[t] * a[s]);
            const float drive = dv[t] * Bs[t][s] * xv[t];
            h[s] = decay * h[s] + drive;
            acc += h[s] * Cs[t][s];
          }
          yb[int64_t(t0 + t) * p.y_ss + ch] = from_float<TX>(acc + dd * xv[t]);
        }
      }
    }
  }
  if (active) {
#pragma unroll
    for (int s = 0; s < DS; ++s) p.h1[state0 + s] = h[s];
  }
}

template <typename TX, typename TP, int DS>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const dim3 grid((a.DI + BD - 1) / BD, a.B);
  ssm_scan_kernel<TX, TP, DS><<<grid, BD, 0, stream>>>(a);
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
