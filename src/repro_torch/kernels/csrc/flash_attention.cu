// Blockwise streaming-softmax attention for Hopper (sm_90a): the prefill
// attention of the scan engine (a prompt attending to itself from
// position 0), GQA, causal or not, with an optional sliding window.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py
// `flash_attention_pallas` (body `_flash_kernel`), and computes what it
// computes: q pre-scaled by hd**-0.5, scores in float32, key j visible to
// query i where j <= i (causal) and j > i - window (when a window is
// given), masked scores -1e30 (never -inf, so no row turns NaN), a
// running max, sum and accumulator in float32 across the key tiles, the
// output acc / max(l, 1e-20) cast to q's type.  Any S is taken: the last
// query and key tiles may be ragged (the TPU kernel needs S to be a
// multiple of its blocks; that is a limit of its tiling, not part of the
// function).
//
// What bounds it on the H100: operations.  At llama3.2-3b's prefill (B=4,
// S=2048, 24 heads over 8 kv heads, hd=128, causal) the function needs
// ~1.0e11 flops (the half of QK^T and PV below the diagonal) and reads
// and writes ~134 MB: ~0.10 ms at the bf16 tensor-core rate against
// ~0.04 ms at the memory rate.
//
// What the design does about it (a first, simple kernel; tensor cores,
// TMA and wgmma come with a later redesign):
//   * one block per (batch, q head, 64-row q tile); the kv head is
//     h / (H / KV); blocks of the last q tiles (the most key tiles under
//     the causal mask) are scheduled first;
//   * 64-row K and V tiles of that kv head stream through shared memory,
//     converted to float32 once on the way in; Q and K are stored
//     transposed (d-major) so the score loop reads four rows with one
//     16-byte load;
//   * 256 threads in a 16 x 16 grid: each computes a 4 x 4 patch of the
//     64 x 64 score tile (16 independent FMAs per pair of loads), reduces
//     the row max and sum across its 16-thread half-warp with shuffles,
//     and owns 4 rows x hd/16 columns of the output accumulator in
//     registers;
//   * key tiles wholly past the causal diagonal, or wholly before every
//     row's window, are never loaded;
//   * the probabilities go through shared memory once per tile for P.V,
//     in the space K^T held (so two blocks fit on an SM at hd = 128).
// Float32 FMAs on the CUDA cores bound it at ~67 TFLOP/s, ~15x below the
// tensor cores; that is the redesign's target.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // key rows per tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kPad = 4;        // keeps 16-byte alignment, spreads banks
constexpr int kLd = kBQ + kPad;
constexpr float kNegInf = -1e30f;

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

// floats of the region that holds K^T while the scores are computed and
// P after them: (max(HD, kBQ), kLd)
template <int HD>
__host__ __device__ constexpr int kt_floats() {
  return (HD > kBQ ? HD : kBQ) * kLd;
}

template <int HD>
constexpr size_t smem_bytes() {
  // Qt: (HD, kLd); Kt / P: kt_floats; V: (kBK, HD)
  return sizeof(float) * (HD * kLd + kt_floats<HD>() + kBK * HD);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 2) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, int S, int H, int KV,
    int causal, int window, float scale) {
  constexpr int kDpt = HD / 16;  // output columns per thread
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Qt = smem;              // [HD][kLd]   q, d-major, pre-scaled
  float* Kt = Qt + HD * kLd;     // [HD][kLd]   k, d-major
  float* Ps = Kt;                // [kBQ][kLd]  probabilities, row-major,
                                 //             once the scores are done
  float* Vs = Kt + kt_floats<HD>();  // [kBK][HD]

  const int n_qt = (S + kBQ - 1) / kBQ;
  const int qt = n_qt - 1 - (blockIdx.x % n_qt);  // heavy tiles first
  const int bh = blockIdx.x / n_qt;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = h / (H / KV);
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x;
  const int tx = tid & 15;  // score columns 4tx.., output columns tx + 16c
  const int ty = tid >> 4;  // rows 4ty..4ty+3

  const long long q_row = (long long)H * HD;   // stride of s in q / out
  const long long kv_row = (long long)KV * HD;  // stride of s in k / v
  const T* qb = q + (long long)b * S * q_row + (long long)h * HD;
  const T* kb = k + (long long)b * S * kv_row + (long long)kvh * HD;
  const T* vb = v + (long long)b * S * kv_row + (long long)kvh * HD;

  for (int idx = tid; idx < kBQ * HD; idx += kThreads) {
    const int row = idx / HD;
    const int d = idx - row * HD;
    const int s = q0 + row;
    Qt[d * kLd + row] = s < S ? to_f32(qb[s * q_row + d]) * scale : 0.f;
  }

  float m[4], l[4], acc[4][kDpt];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kDpt; ++c) acc[r][c] = 0.f;
  }

  // key tiles that any row of this q tile can see
  const int n_kt = (S + kBK - 1) / kBK;
  int kt_end = n_kt;
  if (causal) kt_end = min(n_kt, (min(q0 + kBQ, S) - 1) / kBK + 1);
  int kt_begin = 0;
  if (window > 0) kt_begin = max(0, q0 - window + 1) / kBK;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < kBK * HD; idx += kThreads) {
      const int row = idx / HD;
      const int d = idx - row * HD;
      const int s = k0 + row;
      const bool ok = s < S;
      Kt[d * kLd + row] = ok ? to_f32(kb[s * kv_row + d]) : 0.f;
      Vs[row * HD + d] = ok ? to_f32(vb[s * kv_row + d]) : 0.f;
    }
    __syncthreads();

    // scores for rows 4ty.., columns 4tx..
    float sc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[r][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(&Qt[d * kLd + 4 * ty]);
      const float4 ka = *reinterpret_cast<const float4*>(&Kt[d * kLd + 4 * tx]);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[4] = {ka.x, ka.y, ka.z, ka.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[r][c] += qv[r] * kv[c];
    }

    __syncthreads();  // every thread is done with Kt before P lands there

    // mask, then the streaming-softmax update of each row
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qpos = q0 + 4 * ty + r;
      float mx = m[r];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kpos = k0 + 4 * tx + c;
        bool ok = kpos < S;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        if (!ok) sc[r][c] = kNegInf;
        mx = fmaxf(mx, sc[r][c]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float alpha = expf(m[r] - mx);
      float p[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) p[c] = expf(sc[r][c] - mx);
      float psum = (p[0] + p[1]) + (p[2] + p[3]);
      *reinterpret_cast<float4*>(&Ps[(4 * ty + r) * kLd + 4 * tx]) =
          make_float4(p[0], p[1], p[2], p[3]);
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, o);
      l[r] = l[r] * alpha + psum;
      m[r] = mx;
#pragma unroll
      for (int c = 0; c < kDpt; ++c) acc[r][c] *= alpha;
    }
    __syncthreads();

    // acc[r][c] += sum_j P[row 4ty + r][j] * V[j][tx + 16 c], four keys
    // at a time (one 16-byte load of P per row)
#pragma unroll 2
    for (int j0 = 0; j0 < kBK; j0 += 4) {
      float pv[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float4 pa =
            *reinterpret_cast<const float4*>(&Ps[(4 * ty + r) * kLd + j0]);
        pv[r][0] = pa.x;
        pv[r][1] = pa.y;
        pv[r][2] = pa.z;
        pv[r][3] = pa.w;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vv[kDpt];
#pragma unroll
        for (int c = 0; c < kDpt; ++c) vv[c] = Vs[(j0 + u) * HD + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < kDpt; ++c) acc[r][c] += pv[r][u] * vv[c];
      }
    }
  }

  T* ob = out + (long long)b * S * q_row + (long long)h * HD;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int s = q0 + 4 * ty + r;
    if (s < S) {
      const float inv = 1.f / fmaxf(l[r], 1e-20f);
#pragma unroll
      for (int c = 0; c < kDpt; ++c)
        ob[s * q_row + tx + 16 * c] = from_f32<T>(acc[r][c] * inv);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int H, int KV, int causal, int window, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  auto kernel = flash_attention_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (long long)B * H * ((S + kBQ - 1) / kBQ);
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, H, KV, causal,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v, void* out,
              int B, int S, int H, int KV, int causal, int window,
              float scale, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, out, B, S, H, KV, causal, window, scale,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, out, B, S, H, KV, causal, window, scale,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, out, B, S, H, KV, causal, window, scale,
                            stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry point, loaded with ctypes.  dtype: 0 float32, 1 bfloat16
// (q, k, v and out share it); q/out (B,S,H,hd) and k/v (B,S,KV,hd), all
// contiguous; window <= 0 means none.  Returns cudaGetLastError() after
// the launch (0 on success).
extern "C" int repro_flash_attention(int dtype, const void* q, const void* k,
                                     const void* v, void* out, int B, int S,
                                     int H, int KV, int hd, int causal,
                                     int window, float scale, void* stream) {
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_hd<float>(hd, q, k, v, out, B, S, H, KV, causal, window,
                              scale, st);
    case 1:
      return launch_hd<__nv_bfloat16>(hd, q, k, v, out, B, S, H, KV, causal,
                                      window, scale, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
