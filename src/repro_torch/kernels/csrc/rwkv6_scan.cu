// RWKV-6 WKV recurrence for Hopper (sm_90a): the time mix of every rwkv6
// layer, in prefill (T = prompt length) and in decode (T = 1).
//
// Replaces the TPU kernel repro/kernels/rwkv6_scan.py `rwkv6_scan_pallas`
// (body `_wkv_kernel`), and computes what it computes, plus an optional
// initial state in and the final state out (the model's time mix carries
// the state across calls):
//
//   y_t[j]   = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//   S[i][j] <- w_t[i] * S[i][j] + k_t[i] * v_t[j]
//
// per (batch, head), with the (hd x hd) state in float32.
//
// What bounds it on the H100: the recurrence.  Per step and head it reads
// 4 * hd inputs and does ~5 * hd * hd flops, so over a whole call the
// work (at rwkv6-3b's B=4, T=2048, 40 heads of 64: ~422 MB, ~1e10 flops)
// would take ~0.13 ms at the memory rate and ~0.14 ms at the float32
// rate.  But step t needs the state of step t - 1, so a (batch, head)
// pair is a serial chain of T steps, and there are only B * H pairs (160
// at that shape, on 132 SMs): the card is mostly latency-bound.
//
// What the design does about it:
//   * one block per (batch, head), one thread per value channel j; the
//     thread keeps the state column S[:, j] (hd floats) in registers for
//     the whole sequence, so the state never touches memory between steps;
//   * r, k, v, w are read in place from (B, T, H, hd) (no transposes): for
//     a step the hd threads read hd neighbouring elements;
//   * steps are staged kChunk at a time: each thread loads the next
//     chunk's r/k/v/w of its channel into registers while the block
//     computes the current chunk out of shared memory, so the loads are in
//     flight during the arithmetic and there are two barriers per chunk,
//     not one per step;
//   * the sum over i runs in four independent partial sums, so one step
//     is not a chain of hd dependent adds.
// It uses no tensor cores and splits no (batch, head) pair across blocks;
// a chunked (matrix) form of the recurrence is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 16;  // steps staged per barrier pair

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// HD threads per block, one per value channel j.
template <typename T, int HD>
__global__ void __launch_bounds__(HD) rwkv6_scan_kernel(
    const T* __restrict__ r, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ w,
    const float* __restrict__ u, const float* __restrict__ state_in,
    float* __restrict__ state_out, T* __restrict__ y, int steps, int H) {
  __shared__ float sr[kChunk][HD];
  __shared__ float sk[kChunk][HD];
  __shared__ float sv[kChunk][HD];
  __shared__ float sw[kChunk][HD];
  __shared__ float su[HD];

  const int bh = blockIdx.x;  // b * H + h
  const int b = bh / H;
  const int h = bh - b * H;
  const int j = threadIdx.x;
  const long long t_stride = (long long)H * HD;  // one step in (B,T,H,hd)
  const long long base = ((long long)b * steps * H + h) * HD + j;

  float S[HD];  // S[:, j]
  const long long s_base = (long long)bh * HD * HD + j;
#pragma unroll
  for (int i = 0; i < HD; ++i)
    S[i] = state_in ? state_in[s_base + (long long)i * HD] : 0.f;
  su[j] = u[h * HD + j];

  float pr[kChunk], pk[kChunk], pv[kChunk], pw[kChunk];
  auto prefetch = [&](int c0) {
#pragma unroll
    for (int t = 0; t < kChunk; ++t) {
      const bool ok = c0 + t < steps;
      const long long off = base + (long long)(c0 + t) * t_stride;
      pr[t] = ok ? to_f32(r[off]) : 0.f;
      pk[t] = ok ? to_f32(k[off]) : 0.f;
      pv[t] = ok ? to_f32(v[off]) : 0.f;
      pw[t] = ok ? to_f32(w[off]) : 0.f;
    }
  };
  prefetch(0);

  for (int c0 = 0; c0 < steps; c0 += kChunk) {
    __syncthreads();  // the previous chunk's readers are done
#pragma unroll
    for (int t = 0; t < kChunk; ++t) {
      sr[t][j] = pr[t];
      sk[t][j] = pk[t];
      sv[t][j] = pv[t];
      sw[t][j] = pw[t];
    }
    __syncthreads();
    if (c0 + kChunk < steps) prefetch(c0 + kChunk);
    const int n = min(kChunk, steps - c0);
    for (int t = 0; t < n; ++t) {
      const float vj = sv[t][j];
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < HD; ++i) {
        const float kv = sk[t][i] * vj;
        acc[i & 3] += sr[t][i] * (S[i] + su[i] * kv);
        S[i] = sw[t][i] * S[i] + kv;
      }
      y[base + (long long)(c0 + t) * t_stride] =
          from_f32<T>((acc[0] + acc[1]) + (acc[2] + acc[3]));
    }
  }

  if (state_out) {
#pragma unroll
    for (int i = 0; i < HD; ++i) state_out[s_base + (long long)i * HD] = S[i];
  }
}

template <typename T, int HD>
int launch(const void* r, const void* k, const void* v, const void* w,
           const float* u, const float* state_in, float* state_out, void* y,
           int B, int steps, int H, cudaStream_t stream) {
  rwkv6_scan_kernel<T, HD><<<B * H, HD, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w), u, state_in,
      state_out, static_cast<T*>(y), steps, H);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(int hd, const void* r, const void* k, const void* v,
              const void* w, const float* u, const float* state_in,
              float* state_out, void* y, int B, int steps, int H,
              cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<T, 32>(r, k, v, w, u, state_in, state_out, y, B, steps,
                           H, stream);
    case 64:
      return launch<T, 64>(r, k, v, w, u, state_in, state_out, y, B, steps,
                           H, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry point, loaded with ctypes.  dtype: 0 float32, 1 bfloat16
// (r, k, v, w and y share it); u, state_in and state_out are float32;
// state_in / state_out may be null.  Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int repro_rwkv6_scan(int dtype, const void* r, const void* k,
                                const void* v, const void* w, const void* u,
                                const void* state_in, void* state_out,
                                void* y, int B, int steps, int H, int hd,
                                void* stream) {
  if (B <= 0 || steps <= 0 || H <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* uf = static_cast<const float*>(u);
  const float* si = static_cast<const float*>(state_in);
  float* so = static_cast<float*>(state_out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_hd<float>(hd, r, k, v, w, uf, si, so, y, B, steps, H, st);
    case 1:
      return launch_hd<__nv_bfloat16>(hd, r, k, v, w, uf, si, so, y, B, steps,
                                      H, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
