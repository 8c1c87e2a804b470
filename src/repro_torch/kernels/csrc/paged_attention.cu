// Paged-attention decode for Hopper (sm_90a): one new query token per
// serving slot attends over that slot's pages of a shared KV page pool.
//
// Replaces the TPU kernel repro/kernels/paged_attention.py
// `paged_attention_pallas` (body `_paged_kernel`), and computes what it
// computes: GQA decode attention, q pre-scaled by hd**-0.5, a streaming
// softmax across the slot's context with the running max, sum and
// accumulator in float32, the tail of the last page masked, int8 pools
// dequantized per page, output acc / max(l, 1e-20) cast to q's type.
//
// What bounds it on the H100: bytes.  Each (slot, kv head) reads
// length * hd elements of K and as many of V and does 4 flops per element
// and query row (g = H / KV rows share the read), so at g = 3 it does
// ~6 flops per K/V element against the ~295 flops per byte the card can
// do before memory is the limit.  Decode attention therefore runs at the
// K/V read rate, 3.35 TB/s at most.
//
// What the design does about it:
//   * one block per (slot, kv head): the g query rows of a group share
//     every K/V row read, so each K/V byte of a slot is read once;
//   * inside the block, the slot's logical pages are dealt out to the
//     block's 8 warps (the TPU's sequential page axis becomes a loop per
//     warp), each warp reading page_table[b, j] itself and stopping at
//     ceil(length / page_size): pages past the length are never read
//     (the TPU version DMAs them before skipping the compute);
//   * a warp keeps its own running max, sum and accumulator in registers
//     and issues the K and V loads of 8 tokens before using any of them,
//     so it has several loads in flight and no block barrier in the loop;
//     the 8 tokens' scores are reduced independently and the running max
//     moves once per 8 tokens; one barrier at the end merges the 8 warps'
//     partial softmax states;
//   * lanes read neighbouring elements of a row; any stride over
//     (P, page_size, KV, hd) is taken, so the per-layer view pool[l] of an
//     (L, P, ...) pool is read in place.
// It uses no tensor cores, no TMA and no split of the context across
// blocks; those are later work.  B * KV blocks (64 at 8 slots and 8 kv
// heads) leave about half the card's 132 SMs idle at small batch, and the
// longest slot sets the time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxG = 8;     // query rows per kv head
constexpr int kMaxHd = 128;  // head dim
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct PoolStrides {
  long long p, t, h, d;  // elements, over (P, page_size, KV, hd)
};

// DPL: head-dim elements per lane (hd <= 32 * DPL); lane owns d = lane + 32 i
template <typename TQ, typename TKV, int DPL>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const TQ* __restrict__ q, const TKV* __restrict__ k_pool,
    const TKV* __restrict__ v_pool, PoolStrides ks, PoolStrides vs,
    const int* __restrict__ page_table, long long pt_stride,
    const int* __restrict__ lengths, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, TQ* __restrict__ out, int H, int KV,
    int hd, int page_size, int max_pages, float scale) {
  constexpr int kTok = 8;  // tokens whose K/V loads are issued together
  __shared__ float m_sh[kWarps][kMaxG];
  __shared__ float l_sh[kWarps][kMaxG];
  extern __shared__ float acc_sh[];  // (kWarps, g, hd)

  const int g = H / KV;
  const int b = blockIdx.x / KV;
  const int kh = blockIdx.x % KV;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int length = lengths[b];

  // this group's g query rows, pre-scaled, in registers
  const TQ* qb = q + ((long long)b * H + (long long)kh * g) * hd;
  float qr[kMaxG][DPL];
  float m[kMaxG], l[kMaxG], acc[kMaxG][DPL];
#pragma unroll
  for (int r = 0; r < kMaxG; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      qr[r][i] = (r < g && d < hd) ? to_f32(qb[r * hd + d]) * scale : 0.f;
      acc[r][i] = 0.f;
    }
  }

  int n_pages = (length + page_size - 1) / page_size;
  if (n_pages > max_pages) n_pages = max_pages;
  for (int j = warp; j < n_pages; j += kWarps) {
    const long long pid = page_table[(long long)b * pt_stride + j];
    const int n_valid = min(page_size, length - j * page_size);
    const float kq = k_scale ? k_scale[pid] : 1.f;
    const float vq = v_scale ? v_scale[pid] : 1.f;
    const TKV* kpage = k_pool + pid * ks.p + (long long)kh * ks.h;
    const TKV* vpage = v_pool + pid * vs.p + (long long)kh * vs.h;
    for (int t0 = 0; t0 < n_valid; t0 += kTok) {
      float kr[kTok][DPL], vr[kTok][DPL];
#pragma unroll
      for (int u = 0; u < kTok; ++u) {
        const int t = t0 + u;
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          const int d = lane + 32 * i;
          const bool ok = t < n_valid && d < hd;
          kr[u][i] = ok ? to_f32(kpage[t * ks.t + d * ks.d]) * kq : 0.f;
          vr[u][i] = ok ? to_f32(vpage[t * vs.t + d * vs.d]) * vq : 0.f;
        }
      }
      // one softmax update per row for the whole group: the kTok warp
      // reductions are independent, and the running max moves once
#pragma unroll
      for (int r = 0; r < kMaxG; ++r) {
        if (r < g) {
          float sc[kTok];
          float mx = m[r];
#pragma unroll
          for (int u = 0; u < kTok; ++u) {
            float s = 0.f;
#pragma unroll
            for (int i = 0; i < DPL; ++i) s += qr[r][i] * kr[u][i];
#pragma unroll
            for (int o = 16; o > 0; o >>= 1)
              s += __shfl_xor_sync(0xffffffffu, s, o);
            sc[u] = t0 + u < n_valid ? s : kNegInf;  // tail of the page
            mx = fmaxf(mx, sc[u]);
          }
          const float alpha = expf(m[r] - mx);
          float psum = 0.f;
#pragma unroll
          for (int i = 0; i < DPL; ++i) acc[r][i] *= alpha;
#pragma unroll
          for (int u = 0; u < kTok; ++u) {
            const float p = expf(sc[u] - mx);
            psum += p;
#pragma unroll
            for (int i = 0; i < DPL; ++i) acc[r][i] += p * vr[u][i];
          }
          l[r] = l[r] * alpha + psum;
          m[r] = mx;
        }
      }
    }
  }

  // merge the warps' partial softmax states
#pragma unroll
  for (int r = 0; r < kMaxG; ++r) {
    if (r < g) {
      if (lane == 0) {
        m_sh[warp][r] = m[r];
        l_sh[warp][r] = l[r];
      }
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        if (d < hd) acc_sh[(warp * g + r) * hd + d] = acc[r][i];
      }
    }
  }
  __syncthreads();
  TQ* ob = out + ((long long)b * H + (long long)kh * g) * hd;
  for (int idx = tid; idx < g * hd; idx += kThreads) {
    const int r = idx / hd;
    const int d = idx - r * hd;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_sh[w][r]);
    float lsum = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float e = expf(m_sh[w][r] - mx);
      lsum += l_sh[w][r] * e;
      o += acc_sh[(w * g + r) * hd + d] * e;
    }
    ob[idx] = from_f32<TQ>(o / fmaxf(lsum, 1e-20f));
  }
}

template <typename TQ, typename TKV, int DPL>
int launch(const void* q, const void* k_pool, const void* v_pool,
           PoolStrides ks, PoolStrides vs, const int* page_table,
           long long pt_stride, const int* lengths, const float* k_scale,
           const float* v_scale, void* out, int B, int H, int KV, int hd,
           int page_size, int max_pages, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * kWarps * (size_t)(H / KV) * hd;
  paged_attention_kernel<TQ, TKV, DPL><<<B * KV, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k_pool),
      static_cast<const TKV*>(v_pool), ks, vs, page_table, pt_stride, lengths,
      k_scale, v_scale, static_cast<TQ*>(out), H, KV, hd, page_size,
      max_pages, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TKV>
int launch_hd(const void* q, const void* k_pool, const void* v_pool,
              PoolStrides ks, PoolStrides vs, const int* page_table,
              long long pt_stride, const int* lengths, const float* k_scale,
              const float* v_scale, void* out, int B, int H, int KV, int hd,
              int page_size, int max_pages, float scale,
              cudaStream_t stream) {
#define REPRO_LAUNCH(DPL)                                                    \
  return launch<TQ, TKV, DPL>(q, k_pool, v_pool, ks, vs, page_table,        \
                              pt_stride, lengths, k_scale, v_scale, out, B, \
                              H, KV, hd, page_size, max_pages, scale, stream)
  if (hd <= 32) REPRO_LAUNCH(1);
  if (hd <= 64) REPRO_LAUNCH(2);
  REPRO_LAUNCH(4);
#undef REPRO_LAUNCH
}

template <typename TQ>
int launch_kv(int kv_dtype, const void* q, const void* k_pool,
              const void* v_pool, PoolStrides ks, PoolStrides vs,
              const int* page_table, long long pt_stride, const int* lengths,
              const float* k_scale, const float* v_scale, void* out, int B,
              int H, int KV, int hd, int page_size, int max_pages,
              float scale, cudaStream_t stream) {
  switch (kv_dtype) {
    case 0:
      return launch_hd<TQ, float>(q, k_pool, v_pool, ks, vs, page_table,
                                  pt_stride, lengths, k_scale, v_scale, out,
                                  B, H, KV, hd, page_size, max_pages, scale,
                                  stream);
    case 1:
      return launch_hd<TQ, __nv_bfloat16>(q, k_pool, v_pool, ks, vs,
                                          page_table, pt_stride, lengths,
                                          k_scale, v_scale, out, B, H, KV, hd,
                                          page_size, max_pages, scale, stream);
    case 2:
      return launch_hd<TQ, int8_t>(q, k_pool, v_pool, ks, vs, page_table,
                                   pt_stride, lengths, k_scale, v_scale, out,
                                   B, H, KV, hd, page_size, max_pages, scale,
                                   stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Type codes: 0 float32,
// 1 bfloat16, 2 int8 (pools only).  Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int repro_paged_attention(
    int q_dtype, int kv_dtype, const void* q, const void* k_pool,
    const void* v_pool, long long ks_p, long long ks_t, long long ks_h,
    long long ks_d, long long vs_p, long long vs_t, long long vs_h,
    long long vs_d, const void* page_table, long long pt_stride,
    const void* lengths, const void* k_scale, const void* v_scale, void* out,
    int B, int H, int KV, int hd, int page_size, int max_pages, float scale,
    void* stream) {
  if (KV <= 0 || H % KV != 0 || H / KV > kMaxG || hd > kMaxHd)
    return static_cast<int>(cudaErrorInvalidValue);
  const PoolStrides ks{ks_p, ks_t, ks_h, ks_d};
  const PoolStrides vs{vs_p, vs_t, vs_h, vs_d};
  const int* pt = static_cast<const int*>(page_table);
  const int* ln = static_cast<const int*>(lengths);
  const float* ksc = static_cast<const float*>(k_scale);
  const float* vsc = static_cast<const float*>(v_scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case 0:
      return launch_kv<float>(kv_dtype, q, k_pool, v_pool, ks, vs, pt,
                              pt_stride, ln, ksc, vsc, out, B, H, KV, hd,
                              page_size, max_pages, scale, st);
    case 1:
      return launch_kv<__nv_bfloat16>(kv_dtype, q, k_pool, v_pool, ks, vs, pt,
                                      pt_stride, ln, ksc, vsc, out, B, H, KV,
                                      hd, page_size, max_pages, scale, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
