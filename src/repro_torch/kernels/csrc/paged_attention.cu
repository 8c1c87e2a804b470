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
//   * each slot's context is split across blocks: the grid is
//     (B * KV, n_split), block (slot, kv head, split) takes `split_tokens`
//     tokens (the wrapper picks 128: 8 pages of 16), n_split comes from
//     the page table's width, so the host never reads `lengths`; a block
//     whose split starts past its slot's length writes an empty partial
//     (m = -1e30, l = 0) and returns without touching the pools.  At 8
//     slots, 8 kv heads and a 72-page table that is 576 blocks where one
//     block per (slot, kv head) gave 64 on 132 SMs and the longest slot's
//     serial walk set the time;
//   * the g query rows of a group share every K/V row read, so each K/V
//     byte of a slot is read once; the block's partial (m, l, acc) per
//     query row goes to f32 scratch, and a second, small kernel merges a
//     row's splits with the usual rescale and writes acc / max(l, 1e-20)
//     in q's type: one call is two launches;
//   * the split's page ids (and int8 scales) are read once into shared
//     memory, so no K/V load waits on a page-table load;
//   * a lane reads 16 contiguous bytes of a K/V row (8 bf16, 16 int8 or
//     4 f32; 8 int8 at g > 4, where 16 would spill the registers): a
//     256-byte bf16 row (hd 128) is read by 16 lanes, so a warp covers two
//     tokens a load; the dot product is reduced across a row's lanes with
//     shuffles; each lane issues the K and V loads of 4 tokens before
//     using any, and a row group's running max moves once per 4 tokens
//     (staging the rows in shared memory with cp.async, a chunk ahead,
//     was slower: the per-token arithmetic, not the loads, sets the pace);
//   * int8 scales enter once a token: on the score and on p;
//   * any stride over (P, page_size, KV, hd) is taken, so the per-layer
//     view pool[l] of an (L, P, ...) pool is read in place; where the
//     strides, the pools' alignment or hd rule out 16-byte loads the
//     wrapper picks the narrow variant of the same kernel (one element a
//     lane, a lane owning d = lane + 32 i).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxG = 8;     // query rows per kv head
constexpr int kMaxHd = 128;  // head dim
constexpr int kTok = 4;      // tokens a lane loads before using them
constexpr int kMaxSplitPages = 128;  // pages one block's split may span
constexpr float kNegInf = -1e30f;

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// the raw bits of one element in the low bits of a word
__device__ __forceinline__ uint32_t bits_of(float x) {
  return __float_as_uint(x);
}
__device__ __forceinline__ uint32_t bits_of(__nv_bfloat16 x) {
  return __bfloat16_as_ushort(x);
}
__device__ __forceinline__ uint32_t bits_of(int8_t x) {
  return static_cast<uint8_t>(x);
}

// element i of a run of T packed into 32-bit words, as a float
template <typename T>
__device__ __forceinline__ float elem(const uint32_t* w, int i);
template <>
__device__ __forceinline__ float elem<float>(const uint32_t* w, int i) {
  return __uint_as_float(w[i]);
}
template <>
__device__ __forceinline__ float elem<__nv_bfloat16>(const uint32_t* w,
                                                     int i) {
  const uint32_t v = w[i / 2];
  return __uint_as_float(i % 2 ? v & 0xffff0000u : v << 16);
}
template <>
__device__ __forceinline__ float elem<int8_t>(const uint32_t* w, int i) {
  return static_cast<float>(
      static_cast<int8_t>((w[i / 4] >> (8 * (i % 4))) & 0xffu));
}

// VEC elements of a K/V row starting at element d0 into W words: one
// VEC * sizeof(T)-byte load (FAST), or (VEC == 1) one element at stride
// sd, zero past hd
template <typename T, int VEC, bool FAST, int W>
__device__ __forceinline__ void load_run(const T* row, long long sd, int d0,
                                         int hd, uint32_t (&w)[W]) {
  if constexpr (FAST) {
    constexpr int kBytes = VEC * sizeof(T);
    if constexpr (kBytes == 16) {
      const uint4 t = __ldg(reinterpret_cast<const uint4*>(row + d0));
      w[0] = t.x;
      w[1] = t.y;
      w[2] = t.z;
      w[3] = t.w;
    } else {
      static_assert(kBytes == 8, "16- or 8-byte runs");
      const uint2 t = __ldg(reinterpret_cast<const uint2*>(row + d0));
      w[0] = t.x;
      w[1] = t.y;
    }
  } else {
    static_assert(VEC == 1, "the narrow variant loads one element");
    w[0] = d0 < hd ? bits_of(row[d0 * sd]) : 0u;
  }
}

struct PoolStrides {
  long long p, t, h, d;  // elements, over (P, page_size, KV, hd)
};

// G: query rows per kv head rounded up (g <= G); VEC: elements a lane
// loads at once; NCH: runs of VEC a lane owns (the lanes of a token's
// row own d = (c * lpr + lane_in_row) * VEC + e)
template <typename TQ, typename TKV, int G, int VEC, int NCH, bool FAST>
__global__ void __launch_bounds__(kThreads) paged_attention_split_kernel(
    const TQ* __restrict__ q, const TKV* __restrict__ k_pool,
    const TKV* __restrict__ v_pool, PoolStrides ks, PoolStrides vs,
    const int* __restrict__ page_table, long long pt_stride,
    const int* __restrict__ lengths, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, float* __restrict__ m_part,
    float* __restrict__ l_part, float* __restrict__ acc_part, int H, int KV,
    int hd, int lpr, int page_size, int max_pages, int split_tokens,
    int n_split, float scale) {
  constexpr int W = (VEC * sizeof(TKV) + 3) / 4;  // words per run
  constexpr int E = NCH * VEC;                    // elements per lane
  __shared__ float m_sh[kWarps][G];
  __shared__ float l_sh[kWarps][G];
  __shared__ float acc_sh[kWarps][G][kMaxHd];
  __shared__ long long pid_sh[kMaxSplitPages];  // the split's page ids
  __shared__ float ksc_sh[kMaxSplitPages], vsc_sh[kMaxSplitPages];

  const int g = H / KV;
  const int b = blockIdx.x / KV;
  const int kh = blockIdx.x - b * KV;
  const int split = blockIdx.y;
  const int length = min(lengths[b], max_pages * page_size);
  const int t_begin = split * split_tokens;
  const int t_end = min(t_begin + split_tokens, length);
  // partial of query row r: index part + r * n_split in (B, H, n_split)
  const long long part = ((long long)b * H + (long long)kh * g) * n_split +
                         split;
  if (t_begin >= t_end) {  // past the slot's length: an empty partial
    if (threadIdx.x < g) {
      m_part[part + threadIdx.x * n_split] = kNegInf;
      l_part[part + threadIdx.x * n_split] = 0.f;
    }
    return;
  }

  // the split's page ids and int8 scales, read once into shared memory,
  // so no K/V load waits on a page-table load
  const int p_begin = t_begin / page_size;  // split_tokens is whole pages
  const int n_pages = (t_end - 1) / page_size + 1 - p_begin;
  for (int j = threadIdx.x; j < n_pages; j += kThreads) {
    const long long pid = page_table[(long long)b * pt_stride + p_begin + j];
    pid_sh[j] = pid;
    ksc_sh[j] = k_scale ? k_scale[pid] : 1.f;
    vsc_sh[j] = v_scale ? v_scale[pid] : 1.f;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = lane / lpr;     // which token of the warp's rows
  const int lr = lane - row * lpr;  // lane within the token's row
  const int rpw = 32 / lpr;       // tokens a warp reads per load

  // this group's g query rows, pre-scaled, in registers
  const TQ* qb = q + ((long long)b * H + (long long)kh * g) * hd;
  float qr[G][E];
  float m[G], l[G], acc[G][E];
#pragma unroll
  for (int r = 0; r < G; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const int d = (c * lpr + lr) * VEC + e;
        qr[r][c * VEC + e] =
            (r < g && d < hd) ? to_f32(qb[r * hd + d]) * scale : 0.f;
        acc[r][c * VEC + e] = 0.f;
      }
    }
  }

  const int step = kWarps * rpw;  // tokens the block covers per load
  for (int base = t_begin + warp * rpw; base < t_end; base += kTok * step) {
    uint32_t kw[kTok][NCH][W], vw[kTok][NCH][W];
    float kq[kTok], vq[kTok];
    bool ok[kTok];
    // every lane issues its 2 * kTok loads back to back; a token past the
    // split's end reads the split's first token instead and is masked
#pragma unroll
    for (int u = 0; u < kTok; ++u) {
      const int t = base + row + u * step;
      ok[u] = t < t_end;
      const int j = (ok[u] ? t : t_begin) / page_size - p_begin;
      const int off = (ok[u] ? t : t_begin) - (p_begin + j) * page_size;
      const long long pid = pid_sh[j];
      const TKV* kp = k_pool + pid * ks.p + off * ks.t + kh * ks.h;
      const TKV* vp = v_pool + pid * vs.p + off * vs.t + kh * vs.h;
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch) {
        const int d0 = (ch * lpr + lr) * VEC;
        load_run<TKV, VEC, FAST>(kp, ks.d, d0, hd, kw[u][ch]);
        load_run<TKV, VEC, FAST>(vp, vs.d, d0, hd, vw[u][ch]);
      }
      kq[u] = ksc_sh[j];
      vq[u] = vsc_sh[j];
    }
    // one softmax update per row for the kTok tokens: the reductions are
    // independent, and the running max moves once
#pragma unroll
    for (int r = 0; r < G; ++r) {
      if (r < g) {
        float sc[kTok];
        float mx = m[r];
#pragma unroll
        for (int u = 0; u < kTok; ++u) {
          float s = 0.f;
#pragma unroll
          for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              s += qr[r][ch * VEC + e] * elem<TKV>(kw[u][ch], e);
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)  // across the token's lanes
            if (o < lpr) s += __shfl_xor_sync(0xffffffffu, s, o);
          sc[u] = ok[u] ? s * kq[u] : kNegInf;
          mx = fmaxf(mx, sc[u]);
        }
        const float alpha = __expf(m[r] - mx);
        float psum = 0.f;
#pragma unroll
        for (int i = 0; i < E; ++i) acc[r][i] *= alpha;
#pragma unroll
        for (int u = 0; u < kTok; ++u) {
          const float p = ok[u] ? __expf(sc[u] - mx) : 0.f;
          psum += p;
          const float pv = p * vq[u];
#pragma unroll
          for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              acc[r][ch * VEC + e] += pv * elem<TKV>(vw[u][ch], e);
        }
        l[r] = l[r] * alpha + psum;
        m[r] = mx;
      }
    }
  }

  // merge the warp's token rows (lanes lpr apart), then the warps
  for (int o = lpr; o < 32; o <<= 1) {
#pragma unroll
    for (int r = 0; r < G; ++r) {
      if (r < g) {
        const float mo = __shfl_xor_sync(0xffffffffu, m[r], o);
        const float lo = __shfl_xor_sync(0xffffffffu, l[r], o);
        const float mx = fmaxf(m[r], mo);
        const float a = expf(m[r] - mx);
        const float bo = expf(mo - mx);
        l[r] = l[r] * a + lo * bo;
#pragma unroll
        for (int i = 0; i < E; ++i) {
          const float ao = __shfl_xor_sync(0xffffffffu, acc[r][i], o);
          acc[r][i] = acc[r][i] * a + ao * bo;
        }
        m[r] = mx;
      }
    }
  }
  if (lane < lpr) {
#pragma unroll
    for (int r = 0; r < G; ++r) {
      if (r < g) {
        if (lane == 0) {
          m_sh[warp][r] = m[r];
          l_sh[warp][r] = l[r];
        }
#pragma unroll
        for (int c = 0; c < NCH; ++c)
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            const int d = (c * lpr + lr) * VEC + e;
            if (d < hd) acc_sh[warp][r][d] = acc[r][c * VEC + e];
          }
      }
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < g * hd; idx += kThreads) {
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
      o += acc_sh[w][r][d] * e;
    }
    const long long pr = part + (long long)r * n_split;
    acc_part[pr * hd + d] = o;
    if (d == 0) {
      m_part[pr] = mx;
      l_part[pr] = lsum;
    }
  }
}

// one block per (slot, query head): the splits' partials merged with the
// usual rescale; splits with l == 0 are empty and their acc is not read
template <typename TQ>
__global__ void __launch_bounds__(kMaxHd) paged_attention_merge_kernel(
    const float* __restrict__ m_part, const float* __restrict__ l_part,
    const float* __restrict__ acc_part, TQ* __restrict__ out, int hd,
    int n_split) {
  const long long bh = blockIdx.x;
  const float* mp = m_part + bh * n_split;
  const float* lp = l_part + bh * n_split;
  float mx = kNegInf;
  for (int s = 0; s < n_split; ++s)
    if (lp[s] > 0.f) mx = fmaxf(mx, mp[s]);
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float lsum = 0.f, o = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float ls = lp[s];
      if (ls > 0.f) {
        const float e = expf(mp[s] - mx);
        lsum += ls * e;
        o += acc_part[(bh * n_split + s) * hd + d] * e;
      }
    }
    out[bh * hd + d] = from_f32<TQ>(o / fmaxf(lsum, 1e-20f));
  }
}

struct Args {
  const void *q, *k_pool, *v_pool;
  PoolStrides ks, vs;
  const int* page_table;
  long long pt_stride;
  const int* lengths;
  const float *k_scale, *v_scale;
  float *m_part, *l_part, *acc_part;
  void* out;
  int B, H, KV, hd, page_size, max_pages, split_tokens, n_split, vec;
  float scale;
  cudaStream_t stream;
  cudaFuncAttributes* attr;  // not null: report the split kernel, no launch
};

template <typename TQ, typename TKV, int G, int VEC, int NCH, bool FAST>
int launch(const Args& a) {
  auto split_kernel = paged_attention_split_kernel<TQ, TKV, G, VEC, NCH, FAST>;
  if (a.attr != nullptr)
    return static_cast<int>(cudaFuncGetAttributes(a.attr, split_kernel));
  const int lpr = FAST ? a.hd / VEC : 32;
  const dim3 grid(a.B * a.KV, a.n_split);
  split_kernel<<<grid, kThreads, 0, a.stream>>>(
          static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k_pool),
          static_cast<const TKV*>(a.v_pool), a.ks, a.vs, a.page_table,
          a.pt_stride, a.lengths, a.k_scale, a.v_scale, a.m_part, a.l_part,
          a.acc_part, a.H, a.KV, a.hd, lpr, a.page_size, a.max_pages,
          a.split_tokens, a.n_split, a.scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_attention_merge_kernel<TQ><<<a.B * a.H, kMaxHd, 0, a.stream>>>(
      a.m_part, a.l_part, a.acc_part, static_cast<TQ*>(a.out), a.hd,
      a.n_split);
  return static_cast<int>(cudaGetLastError());
}

// the 16-byte variant (8 bytes for int8 at G = 8), or the narrow one
template <typename TQ, typename TKV, int G>
int launch_vec(const Args& a) {
  constexpr int kVec =
      (sizeof(TKV) == 1 && G == 8) ? 8 : 16 / static_cast<int>(sizeof(TKV));
  if (a.vec == kVec) return launch<TQ, TKV, G, kVec, 1, true>(a);
  if (a.vec == 1) return launch<TQ, TKV, kMaxG, 1, kMaxHd / 32, false>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename TQ, typename TKV>
int launch_g(const Args& a) {
  const int g = a.H / a.KV;
  if (a.vec == 1) return launch_vec<TQ, TKV, kMaxG>(a);
  if (g <= 1) return launch_vec<TQ, TKV, 1>(a);
  if (g <= 2) return launch_vec<TQ, TKV, 2>(a);
  if (g <= 4) return launch_vec<TQ, TKV, 4>(a);
  return launch_vec<TQ, TKV, 8>(a);
}

template <typename TQ>
int launch_kv(int kv_dtype, const Args& a) {
  switch (kv_dtype) {
    case 0:
      return launch_g<TQ, float>(a);
    case 1:
      return launch_g<TQ, __nv_bfloat16>(a);
    case 2:
      return launch_g<TQ, int8_t>(a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Type codes: 0 float32,
// 1 bfloat16, 2 int8 (pools only).  m_part / l_part (B, H, n_split) and
// acc_part (B, H, n_split, hd) are float32 scratch; block (slot, kv head,
// split) takes tokens [split * split_tokens, (split + 1) * split_tokens),
// whole pages, at most kMaxSplitPages of them.
// vec: elements a lane loads at once, 16 bytes' worth (8 for int8 pools
// at g > 4), or 1 for the narrow variant; the caller checks that the
// pools' strides and alignment allow it.  Two launches (the splits, then
// the merge); returns cudaGetLastError() after them (0 on success).
extern "C" int repro_paged_attention(
    int q_dtype, int kv_dtype, const void* q, const void* k_pool,
    const void* v_pool, long long ks_p, long long ks_t, long long ks_h,
    long long ks_d, long long vs_p, long long vs_t, long long vs_h,
    long long vs_d, const void* page_table, long long pt_stride,
    const void* lengths, const void* k_scale, const void* v_scale,
    void* m_part, void* l_part, void* acc_part, void* out, int B, int H,
    int KV, int hd, int page_size, int max_pages, int split_tokens,
    int n_split, int vec, float scale, void* stream) {
  if (B <= 0 || KV <= 0 || H % KV != 0 || H / KV > kMaxG || hd <= 0 ||
      hd > kMaxHd || split_tokens <= 0 || n_split <= 0 ||
      (long long)n_split * split_tokens < (long long)max_pages * page_size)
    return static_cast<int>(cudaErrorInvalidValue);
  if (page_size <= 0 || split_tokens % page_size != 0 ||
      split_tokens / page_size > kMaxSplitPages)
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec != 1 && (hd % vec != 0 || 32 % (hd / vec) != 0 || ks_d != 1 ||
                   vs_d != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q,
         k_pool,
         v_pool,
         PoolStrides{ks_p, ks_t, ks_h, ks_d},
         PoolStrides{vs_p, vs_t, vs_h, vs_d},
         static_cast<const int*>(page_table),
         pt_stride,
         static_cast<const int*>(lengths),
         static_cast<const float*>(k_scale),
         static_cast<const float*>(v_scale),
         static_cast<float*>(m_part),
         static_cast<float*>(l_part),
         static_cast<float*>(acc_part),
         out,
         B,
         H,
         KV,
         hd,
         page_size,
         max_pages,
         split_tokens,
         n_split,
         vec,
         scale,
         static_cast<cudaStream_t>(stream),
         nullptr};
  switch (q_dtype) {
    case 0:
      return launch_kv<float>(kv_dtype, a);
    case 1:
      return launch_kv<__nv_bfloat16>(kv_dtype, a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// What the compiler gave the split kernel that a call with these types
// and shapes launches: out = {registers a thread, static shared bytes,
// local (stack and spill) bytes a thread}.  Launches nothing.
extern "C" int repro_paged_attention_attributes(int q_dtype, int kv_dtype,
                                                int H, int KV, int hd,
                                                int vec, int* out) {
  if (KV <= 0 || H % KV != 0 || H / KV > kMaxG || hd <= 0 || hd > kMaxHd)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  Args a{};
  a.H = H;
  a.KV = KV;
  a.hd = hd;
  a.vec = vec;
  a.attr = &attr;
  int rc = static_cast<int>(cudaErrorInvalidValue);
  if (q_dtype == 0) rc = launch_kv<float>(kv_dtype, a);
  if (q_dtype == 1) rc = launch_kv<__nv_bfloat16>(kv_dtype, a);
  if (rc != 0) return rc;
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.sharedSizeBytes);
  out[2] = static_cast<int>(attr.localSizeBytes);
  return 0;
}
