// Blockwise streaming-softmax attention for Hopper (sm_90a): the prefill
// attention of the scan engine (a prompt attending to itself from
// position 0), GQA, causal or not, with an optional sliding window.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py
// `flash_attention_pallas` (body `_flash_kernel`), and computes what it
// computes: scores in float32 scaled by hd**-0.5, key j visible to query
// i where j <= i (causal) and j > i - window (when a window is given),
// masked scores -1e30 (never -inf, so no row turns NaN), a running max,
// sum and accumulator in float32 across the key tiles, the output
// acc / max(l, 1e-20) cast to q's type.  Any S is taken: the last query
// and key tiles may be ragged (the TPU kernel needs S to be a multiple of
// its blocks; that is a limit of its tiling, not part of the function).
//
// What bounds it on the H100: operations.  At llama3.2-3b's prefill (B=4,
// S=2048, 24 heads over 8 kv heads, hd=128, causal) the function needs
// ~1.0e11 flops (the half of QK^T and PV below the diagonal) and reads
// and writes ~134 MB: ~0.10 ms at the bf16 tensor-core rate against
// ~0.04 ms at the memory rate.
//
// Two kernels, one per type:
//
// bf16 (`tc::flash_bf16_kernel`, every full-width prefill): the tensor
// cores through wgmma, K/V tiles fed by TMA (PTX helpers in sm90.cuh).
//   * one block per (batch, q head, 128-row q tile): two consumer
//     warpgroups of 64 query rows each and one producer warp; the last
//     q tiles (the most key tiles under the causal mask) go first;
//   * the producer's one thread loads the q tile once and streams the
//     128-key K and V tiles of kv head h / (H / KV) into a ring of 2
//     stages with cp.async.bulk.tensor over 4-D (B, S, heads, hd) tensor
//     maps, each stage guarded by a full / empty mbarrier pair; tiles are
//     rows of 128 bytes in the 128-byte swizzle (64 bytes at hd = 32), so
//     hd = 128 is two 64-column boxes; rows past S arrive as zeros;
//   * S = Q K^T by wgmma m64n128k16 (bf16 in, f32 accumulate), Q and K
//     both read from shared memory (K-major), hd / 16 k-steps;
//   * the softmax runs in the accumulator's registers: the hd**-0.5 scale
//     and log2(e) are applied to the f32 scores, row max and sum across
//     the 4 threads that share a row, exp2 on the MUFU; O is rescaled only
//     where the max moved; the mask is computed only on tiles that
//     straddle the diagonal, the window's edge or S;
//   * P is rounded to bf16 (as every tensor-core flash does; the row sum
//     l adds the same rounded values in f32, so the weights of a row sum
//     to one) and fed to O += P V as wgmma's A operand
//     straight from registers (the score fragment of m64n128 is, 16 keys
//     at a time, the A fragment of k16), V read from shared memory with
//     the transpose bit;
//   * key tiles wholly past the diagonal, or wholly before every row's
//     window, are never loaded; a warpgroup whose rows cannot see a
//     loaded tile skips its products but still releases the stage;
//   * the output goes through shared memory and leaves in 16-byte stores,
//     rows past S not written.
// Each warpgroup waits for its S before the softmax and for its P V
// before the next tile; the two warpgroups overlap each other's softmax
// with their products.  Overlapping a warpgroup's own softmax with its
// P V (FlashAttention-3's intra-warpgroup pipeline), and handing the
// tensor cores back and forth between the two warpgroups with named
// barriers, were both slower as written here: ptxas serialized their
// wgmmas (its C7513 and C7518 notes).  Three stages of 64-key tiles were
// no faster than two; 128-key tiles were faster than 64.  At hd = 128 the
// block holds Q (32 KB), two stages of K and V (128 KB) and the staged
// output (34 KB): one block an SM.
//
// f32 (`flash_attention_kernel`, the reduced float32 path only): float32
// FMAs on the CUDA cores, kept because TF32 on the tensor cores would
// break the 2e-5 float32 tolerance, and it already beats the library's
// float32 attention.  One block per (batch, q head, 64-row q tile); K and
// V tiles stream through shared memory, Q and K stored d-major so the
// score loop reads four rows with one 16-byte load; 256 threads in a
// 16 x 16 grid each compute a 4 x 4 score patch, reduce the row max and
// sum across their 16-thread half-warp with shuffles and own 4 rows x
// hd/16 columns of the accumulator; P goes through shared memory once a
// tile for P.V, in the space K^T held.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // key rows per tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kPad = 4;        // keeps 16-byte alignment, spreads banks
constexpr int kLd = kBQ + kPad;
constexpr float kNegInf = -1e30f;

// the CUDA-core kernel's element conversions (float32 only)
__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

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

template <int HD>
int attributes_f32(cudaFuncAttributes* attr, int* dynamic_smem) {
  *dynamic_smem = static_cast<int>(smem_bytes<HD>());
  return static_cast<int>(
      cudaFuncGetAttributes(attr, flash_attention_kernel<float, HD>));
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

// ---------------------------------------------------------------------------
// bf16: wgmma on the tensor cores, TMA-fed K/V ring
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kRowsWg = 64;                 // query rows per consumer warpgroup
constexpr int kConsumers = 2;               // consumer warpgroups
constexpr int kBQ = kRowsWg * kConsumers;   // query rows per block
constexpr int kBK = 128;                    // keys per tile
constexpr int kStages = 2;                  // K/V ring depth
constexpr int kThreads = 128 * kConsumers + 32;  // + the producer warp
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Geo {
  static constexpr int kSw = HD >= 64 ? 128 : 64;  // swizzle = chunk row bytes
  static constexpr int kCw = kSw / 2;              // bf16 columns per chunk
  static constexpr int kChunks = HD / kCw;         // 1, or 2 at hd = 128
  static constexpr int kKPerChunk = kCw / 16;      // k16 steps per chunk
  static constexpr uint32_t kLayout =
      kSw == 128 ? sm90::kSwizzle128 : sm90::kSwizzle64;
  static constexpr int kQBytes = kBQ * HD * 2;
  static constexpr int kTileBytes = kBK * HD * 2;  // one K or one V tile
  static constexpr int kEpiLd = HD + 8;            // staged output row, bf16
  static constexpr int kEpiBytes = kConsumers * kRowsWg * kEpiLd * 2;
  // + 1024: the dynamic shared memory is re-aligned to the swizzle repeat
  static constexpr int kSmem =
      kQBytes + 2 * kStages * kTileBytes + kEpiBytes + 1024;
};

__device__ __forceinline__ bool visible(int row, int key, int S, int causal,
                                        int window) {
  return key < S && (!causal || key <= row) &&
         (window <= 0 || key > row - window);
}

// S = Q K^T for one warpgroup's 64 rows and a key tile (issued, not
// waited for): hd / 16 k-steps, both operands K-major in shared memory
template <int HD>
__device__ __forceinline__ void qk_wgmma(float* s, uint32_t q_base,
                                         uint32_t k_base) {
  using G = Geo<HD>;
#pragma unroll
  for (int k = 0; k < HD / 16; ++k) {
    const int c = k / G::kKPerChunk;
    const int kk = k % G::kKPerChunk;
    const uint64_t da = sm90::make_desc(q_base + c * kBQ * G::kSw + kk * 32,
                                        16, 8 * G::kSw, G::kLayout);
    const uint64_t db = sm90::make_desc(k_base + c * kBK * G::kSw + kk * 32,
                                        16, 8 * G::kSw, G::kLayout);
    sm90::wgmma_m64n128k16_ss(s, da, db, k > 0);
  }
}

// O += P V (issued, not waited for): P from registers, 16 keys a step; V
// is MN-major (hd contiguous), so the transpose bit is set
template <int HD>
__device__ __forceinline__ void pv_wgmma(float* o,
                                         const uint32_t (&p)[kBK / 16][4],
                                         uint32_t v_base) {
  using G = Geo<HD>;
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    const uint64_t db = sm90::make_desc(v_base + kk * 16 * G::kSw,
                                        kBK * G::kSw, 8 * G::kSw, G::kLayout);
    if constexpr (HD == 32) {
      sm90::wgmma_m64n32k16_rs(o, p[kk], db);
    } else if constexpr (HD == 64) {
      sm90::wgmma_m64n64k16_rs(o, p[kk], db);
    } else {
      sm90::wgmma_m64n128k16_rs(o, p[kk], db);
    }
  }
}

// The thread's place in the accumulator fragments (two rows, a and b =
// a + 8, and the column pair `col` of every 8) and the running softmax
// state of those rows.
struct RowState {
  int row_a, row_b, col;
  float m_a, m_b;  // running max, in units of log2 (scale * log2(e) applied)
  float l_a, l_b;  // running sum of this thread's columns
};

// The softmax of one score tile in registers: scale into log2 units,
// mask (only where `need_mask`), move the running max (across the 4
// threads of a row), P = 2^(x - m) rounded to bf16 into `p` (the A
// fragments of P V: the score fragment of m64n128 is, 16 keys at a
// time, the A fragment of k16), l += the same rounded values.  Returns alpha = 2^(m_old - m_new)
// of rows a and b, by which O must be rescaled.
__device__ __forceinline__ void softmax_tile(float* s,
                                             uint32_t (&p)[kBK / 16][4],
                                             RowState& rs, bool need_mask,
                                             int k0, int S, int causal,
                                             int window, float scale_log2,
                                             float& alpha_a, float& alpha_b) {
  float mx_a = rs.m_a, mx_b = rs.m_b;
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float xa = s[4 * j + e] * scale_log2;
      float xb = s[4 * j + 2 + e] * scale_log2;
      if (need_mask) {
        const int key = k0 + 8 * j + rs.col + e;
        if (!visible(rs.row_a, key, S, causal, window)) xa = kNegInf;
        if (!visible(rs.row_b, key, S, causal, window)) xb = kNegInf;
      }
      s[4 * j + e] = xa;
      s[4 * j + 2 + e] = xb;
      mx_a = fmaxf(mx_a, xa);
      mx_b = fmaxf(mx_b, xb);
    }
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
  }
  alpha_a = sm90::exp2_approx(rs.m_a - mx_a);
  alpha_b = sm90::exp2_approx(rs.m_b - mx_b);
  rs.m_a = mx_a;
  rs.m_b = mx_b;
  float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j) {
    const uint32_t pk_a =
        sm90::pack_bf16(sm90::exp2_approx(s[4 * j + 0] - mx_a),
                        sm90::exp2_approx(s[4 * j + 1] - mx_a));
    const uint32_t pk_b =
        sm90::pack_bf16(sm90::exp2_approx(s[4 * j + 2] - mx_b),
                        sm90::exp2_approx(s[4 * j + 3] - mx_b));
    p[j / 2][(j % 2) * 2 + 0] = pk_a;
    p[j / 2][(j % 2) * 2 + 1] = pk_b;
    sum_a += sm90::bf16_lo(pk_a) + sm90::bf16_hi(pk_a);
    sum_b += sm90::bf16_lo(pk_b) + sm90::bf16_hi(pk_b);
  }
  rs.l_a = rs.l_a * alpha_a + sum_a;
  rs.l_b = rs.l_b * alpha_b + sum_b;
}

// O of rows a and b times their alpha, only where the max moved
template <int HD>
__device__ __forceinline__ void rescale(float* o, float alpha_a,
                                        float alpha_b) {
  if (alpha_a != 1.f) {
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      o[4 * j + 0] *= alpha_a;
      o[4 * j + 1] *= alpha_a;
    }
  }
  if (alpha_b != 1.f) {
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      o[4 * j + 2] *= alpha_b;
      o[4 * j + 3] *= alpha_b;
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1) flash_bf16_kernel(
    const __grid_constant__ CUtensorMap q_map,
    const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map,
    __nv_bfloat16* __restrict__ out, int B, int S, int H, int KV, int causal,
    int window, float scale_log2) {
  using G = Geo<HD>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full_bar[kStages], empty_bar[kStages], q_bar;
  uint8_t* smem =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* q_sm = smem;                              // [chunk][128 rows][sw]
  uint8_t* k_sm = q_sm + G::kQBytes;                 // [stage][chunk][64][sw]
  uint8_t* v_sm = k_sm + kStages * G::kTileBytes;    // the same
  __nv_bfloat16* epi =
      reinterpret_cast<__nv_bfloat16*>(v_sm + kStages * G::kTileBytes);

  const int BH = B * H;
  const int n_qt = (S + kBQ - 1) / kBQ;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x / BH);  // heavy first
  const int bh = blockIdx.x % BH;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = h / (H / KV);
  const int q0 = qt * kBQ;
  const int n_kt = (S + kBK - 1) / kBK;
  // key tiles any row of the block can see: [kt_begin, kt_end)
  const int kt_begin = window > 0 ? max(0, q0 - window + 1) / kBK : 0;
  const int kt_end =
      causal ? min(n_kt, (min(q0 + kBQ, S) - 1) / kBK + 1) : n_kt;
  const int n_tiles = kt_end - kt_begin;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full_bar[s], 1);
      sm90::mbar_init(&empty_bar[s], 4 * kConsumers);  // one per consumer warp
    }
    sm90::mbar_init(&q_bar, 1);
    sm90::fence_mbar_init();
  }
  __syncthreads();

  if (warp == 4 * kConsumers) {  // the producer warp: one thread issues TMA
    if (lane == 0) {
      sm90::prefetch_tensormap(&q_map);
      sm90::prefetch_tensormap(&k_map);
      sm90::prefetch_tensormap(&v_map);
      sm90::mbar_arrive_expect_tx(&q_bar, G::kQBytes);
#pragma unroll
      for (int c = 0; c < G::kChunks; ++c)
        sm90::tma_load_4d(q_sm + c * kBQ * G::kSw, &q_map, &q_bar,
                          c * G::kCw, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages;
        if (i >= kStages)  // wait for both warpgroups to release the stage
          sm90::mbar_wait(&empty_bar[st], ((i / kStages) - 1) & 1);
        sm90::mbar_arrive_expect_tx(&full_bar[st], 2 * G::kTileBytes);
        const int k0 = (kt_begin + i) * kBK;
#pragma unroll
        for (int c = 0; c < G::kChunks; ++c) {
          const int off = st * G::kTileBytes + c * kBK * G::kSw;
          sm90::tma_load_4d(k_sm + off, &k_map, &full_bar[st], c * G::kCw,
                            kvh, k0, b);
          sm90::tma_load_4d(v_sm + off, &v_map, &full_bar[st], c * G::kCw,
                            kvh, k0, b);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: 64 query rows from r0w
  const int wg = warp / 4;
  const int wl = warp % 4;
  const int r0w = q0 + wg * kRowsWg;
  // the block's tiles these rows can see: [i_lo, i_hi) (none past S);
  // the others are only waited for and released
  int i_lo = n_tiles, i_hi = n_tiles;
  if (r0w < S) {
    i_lo = (window > 0 ? max(0, r0w - window + 1) / kBK : 0) - kt_begin;
    i_hi = (causal ? min(n_kt, (min(r0w + kRowsWg, S) - 1) / kBK + 1)
                   : n_kt) - kt_begin;
  }
  RowState rs;
  rs.row_a = r0w + wl * 16 + lane / 4;
  rs.row_b = rs.row_a + 8;
  rs.col = 2 * (lane % 4);
  rs.m_a = rs.m_b = kNegInf;
  rs.l_a = rs.l_b = 0.f;
  // a tile needs the mask where it straddles the diagonal, the window's
  // edge or S
  auto need_mask = [&](int k0) {
    return k0 + kBK > S || (causal && k0 + kBK - 1 > r0w) ||
           (window > 0 && k0 <= r0w + kRowsWg - 1 - window);
  };
  auto stage_full = [&](int i) {
    sm90::mbar_wait(&full_bar[i % kStages], (i / kStages) & 1);
  };
  auto release = [&](int i) {
    if (lane == 0) sm90::mbar_arrive(&empty_bar[i % kStages]);
  };

  float s[kBK / 2];  // scores, 64 x kBK over the warpgroup
  float o[HD / 2];  // output accumulator, 64 x HD over the warpgroup
  uint32_t p[kBK / 16][4];  // P of the tile, bf16 A fragments of P V
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;

  const uint32_t q_base = sm90::smem_u32(q_sm) + wg * kRowsWg * G::kSw;
  const uint32_t k_base = sm90::smem_u32(k_sm);
  const uint32_t v_base = sm90::smem_u32(v_sm);
  sm90::mbar_wait(&q_bar, 0);
  for (int i = 0; i < i_lo; ++i) {  // tiles before these rows' window
    stage_full(i);
    release(i);
  }
  for (int i = i_lo; i < i_hi; ++i) {
    stage_full(i);
    sm90::wgmma_fence();
    qk_wgmma<HD>(s, q_base, k_base + (i % kStages) * G::kTileBytes);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < kBK / 2; ++j) sm90::fence_operand(s[j]);
    const int k0 = (kt_begin + i) * kBK;
    float alpha_a, alpha_b;
    softmax_tile(s, p, rs, need_mask(k0), k0, S, causal, window, scale_log2,
                 alpha_a, alpha_b);
    rescale<HD>(o, alpha_a, alpha_b);
    sm90::wgmma_fence();
    pv_wgmma<HD>(o, p, v_base + (i % kStages) * G::kTileBytes);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < HD / 2; ++j) sm90::fence_operand(o[j]);
#pragma unroll
    for (int j = 0; j < kBK / 4; ++j) sm90::fence_operand(p[j / 4][j % 4]);
    release(i);  // this warp is done with the stage
  }
  for (int i = i_hi; i < n_tiles; ++i) {  // tiles past these rows' diagonal
    stage_full(i);
    release(i);
  }

  // epilogue: acc / max(l, 1e-20) in bf16, staged in shared memory, then
  // 16-byte stores of the rows below S
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    rs.l_a += __shfl_xor_sync(0xffffffffu, rs.l_a, off);
    rs.l_b += __shfl_xor_sync(0xffffffffu, rs.l_b, off);
  }
  const float inv_a = 1.f / fmaxf(rs.l_a, 1e-20f);
  const float inv_b = 1.f / fmaxf(rs.l_b, 1e-20f);
  __nv_bfloat16* e = epi + wg * kRowsWg * G::kEpiLd;
  const int ra = wl * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    *reinterpret_cast<uint32_t*>(e + ra * G::kEpiLd + 8 * j + rs.col) =
        sm90::pack_bf16(o[4 * j] * inv_a, o[4 * j + 1] * inv_a);
    *reinterpret_cast<uint32_t*>(e + (ra + 8) * G::kEpiLd + 8 * j + rs.col) =
        sm90::pack_bf16(o[4 * j + 2] * inv_b, o[4 * j + 3] * inv_b);
  }
  sm90::named_sync(1 + wg, 128);
  constexpr int kVecs = HD / 8;  // 16-byte pieces of a row
  for (int idx = threadIdx.x % 128; idx < kRowsWg * kVecs; idx += 128) {
    const int row = idx / kVecs;
    const int piece = idx - row * kVecs;
    const int srow = r0w + row;
    if (srow < S)
      *reinterpret_cast<uint4*>(
          out + (((long long)b * S + srow) * H + h) * HD + piece * 8) =
          *reinterpret_cast<const uint4*>(e + row * G::kEpiLd + piece * 8);
  }
}

// cuTensorMapEncodeTiled, through the runtime's driver entry point (no
// link against libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// the contiguous bf16 (B, S, heads, hd) tensor at `ptr` as a 4-D map
// (innermost first), boxes of `cw` columns x `rows` positions of one head
bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int heads,
              int hd, int cw, int rows, int swizzle_bytes) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)S * heads * hd * 2};
  const cuuint32_t box[4] = {(cuuint32_t)cw, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int H, int KV, int causal, int window, float scale,
           cudaStream_t stream) {
  using G = Geo<HD>;
  CUtensorMap q_map, k_map, v_map;
  if (!make_map(&q_map, q, B, S, H, HD, G::kCw, kBQ, G::kSw) ||
      !make_map(&k_map, k, B, S, KV, HD, G::kCw, kBK, G::kSw) ||
      !make_map(&v_map, v, B, S, KV, HD, G::kCw, kBK, G::kSw))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_bf16_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (long long)B * H * ((S + kBQ - 1) / kBQ);
  kernel<<<(unsigned)blocks, kThreads, G::kSmem, stream>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(out), B, S, H, KV,
      causal, window, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

// the kernel's attributes and its dynamic shared memory
template <int HD>
int attributes(cudaFuncAttributes* attr, int* dynamic_smem) {
  *dynamic_smem = Geo<HD>::kSmem;
  return static_cast<int>(cudaFuncGetAttributes(attr, flash_bf16_kernel<HD>));
}

int launch_hd(int hd, const void* q, const void* k, const void* v, void* out,
              int B, int S, int H, int KV, int causal, int window,
              float scale, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<32>(q, k, v, out, B, S, H, KV, causal, window, scale,
                        stream);
    case 64:
      return launch<64>(q, k, v, out, B, S, H, KV, causal, window, scale,
                        stream);
    case 128:
      return launch<128>(q, k, v, out, B, S, H, KV, causal, window, scale,
                         stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tc

}  // namespace

// Plain C entry point, loaded with ctypes.  dtype: 0 float32 (the CUDA-core
// kernel), 1 bfloat16 (the tensor-core kernel; q, k, v and out 16-byte
// aligned, as TMA requires); q, k, v and out share the dtype; q/out
// (B,S,H,hd) and k/v (B,S,KV,hd), all contiguous; window <= 0 means none.  Returns cudaGetLastError() after
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
      return tc::launch_hd(hd, q, k, v, out, B, S, H, KV, causal, window,
                           scale, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// What the compiler gave the kernel a call with this dtype and head dim
// launches: out = {registers a thread, static shared bytes, local (stack
// and spill) bytes a thread, dynamic shared bytes}.  Launches nothing.
extern "C" int repro_flash_attention_attributes(int dtype, int hd, int* out) {
  cudaFuncAttributes attr;
  int dynamic_smem = 0;
  int rc = static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    if (hd == 32) rc = attributes_f32<32>(&attr, &dynamic_smem);
    if (hd == 64) rc = attributes_f32<64>(&attr, &dynamic_smem);
    if (hd == 128) rc = attributes_f32<128>(&attr, &dynamic_smem);
  } else if (dtype == 1) {
    if (hd == 32) rc = tc::attributes<32>(&attr, &dynamic_smem);
    if (hd == 64) rc = tc::attributes<64>(&attr, &dynamic_smem);
    if (hd == 128) rc = tc::attributes<128>(&attr, &dynamic_smem);
  }
  if (rc != 0) return rc;
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.sharedSizeBytes);
  out[2] = static_cast<int>(attr.localSizeBytes);
  out[3] = dynamic_smem;
  return 0;
}
