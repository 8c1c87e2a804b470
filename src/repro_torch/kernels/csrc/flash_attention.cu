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
// and writes ~134 MB in bf16: ~0.10 ms at the bf16 tensor-core rate
// against ~0.04 ms at the memory rate; in f32, ~0.63 ms at the 3xTF32
// rate (a third of the 495 TFLOP/s TF32 rate) against ~0.08 ms.
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
// f32 (`f32::flash_f32_kernel`, the reduced float32 path): float32
// products on the tensor cores by 3xTF32 mma.sync.m16n8k8 (helpers in
// sm90.cuh, shared with the WKV kernel): each operand splits into a TF32
// high part and a TF32 residual, and hi*hi + hi*lo + lo*hi keeps float32
// accuracy (the 2e-5 bound; one TF32 product would not hold it, see
// kernels/ref.py `flash_attention_3xtf32_ref`).  Its bound is then the
// TF32 rate over 3, not the CUDA cores' FFMA rate.
//   * one block per (batch, q head, 128-row q tile), eight warps of 16
//     query rows, heavy q tiles first;
//   * the Q tile lands in shared memory once, K and V tiles of 64 keys
//     stream into two stages behind it, all by cp.async (the next tile's
//     copy runs under this tile's products), raw f32 with padded rows so
//     that every fragment load is free of bank conflicts; a fragment is
//     split as it is loaded (Q's held in registers instead spilled);
//   * S = Q K^T accumulates in registers; the softmax runs there (row max
//     and sum across the 4 threads of a row, exp2 on the MUFU, O rescaled
//     only where the max moved; the mask only on tiles that straddle the
//     diagonal, the window's edge or S);
//   * P feeds P V from the accumulators, without shared memory: the m16n8
//     accumulator holds keys 2c and 2c + 1 of each 8 where the k8 A
//     fragment wants slots c and c + 4, and the sum over keys does not
//     care about their order, so key 2c is slot c, key 2c + 1 slot c + 4,
//     and V's fragment reads rows 2c and 2c + 1;
//   * key tiles wholly past the diagonal, or before every row's window,
//     are never loaded; a warp skips the products of a tile its rows
//     cannot see.
// At hd = 128 the Q tile and two stages take 207 KB: one block (8 warps)
// an SM.  On the H100 the mma.sync rate sets its time: with one TF32
// product in place of three it ran in 0.53x the time, so the products
// take about 70% of it.  Splitting Q and each K/V tile once into shared
// memory (it fits only below hd 128) was slower at hd 64: the fragments
// then read twice the shared bytes to save a few ALU instructions.
// Packing the query heads of a kv head into one block was slower at
// hd 128 (6 warps of 32 rows a head: fewer warps an SM).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// key `key` is visible to query `row`
__device__ __forceinline__ bool visible(int row, int key, int S, int causal,
                                        int window) {
  return key < S && (!causal || key <= row) &&
         (window <= 0 || key > row - window);
}

// ---------------------------------------------------------------------------
// f32: 3xTF32 mma.sync on the tensor cores, cp.async-fed K/V
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int kWarps = 8;             // 16 query rows each
constexpr int kBQ = 16 * kWarps;      // query rows per block
constexpr int kBK = 64;               // keys per tile
constexpr int kThreads = 32 * kWarps;

template <int HD>
struct Geo {
  // row strides of the K and V tiles in floats: a K fragment (an 8-byte
  // load of dims 2q, 2q+1 of key g) and a V fragment (rows 2q and 2q+1,
  // column g) each hit distinct banks
  static constexpr int kKLd = HD + 8;  // Q's rows too (its A fragments)
  static constexpr int kVLd = HD + 4;
  static constexpr int kQ = kBQ * kKLd;               // floats of the Q tile
  static constexpr int kStage = kBK * (kKLd + kVLd);  // floats of K + V
  static constexpr int kSmem = (kQ + 2 * kStage) * 4;  // Q, two stages
};

// cp.async: the helpers of sm90.cuh
using sm90::cp_async16;
using sm90::cp_async_commit;
using sm90::cp_async_wait;

// rows [r0, r0 + ROWS) of a (B, S, heads, HD) tensor's head at `base` into
// shared memory rows of LD floats, rows past S as zeros; every thread
// issues its share
template <int HD, int ROWS, int LD>
__device__ __forceinline__ void load_rows(float* dst, const float* base,
                                          long long row_stride, int r0,
                                          int S) {
  constexpr int kPieces = HD / 4;  // 16-byte pieces a row
  for (int idx = threadIdx.x; idx < ROWS * kPieces; idx += kThreads) {
    const int row = idx / kPieces;
    const int c = 4 * (idx - row * kPieces);
    const bool ok = r0 + row < S;
    cp_async16(dst + row * LD + c,
               base + (ok ? r0 + row : 0) * row_stride + c, ok);
  }
}

// the K and V rows [k0, k0 + kBK) of one kv head into a stage
template <int HD>
__device__ __forceinline__ void load_tile(float* ks, const float* kb,
                                          const float* vb, long long kv_row,
                                          int k0, int S) {
  using G = Geo<HD>;
  load_rows<HD, kBK, G::kKLd>(ks, kb, kv_row, k0, S);
  load_rows<HD, kBK, G::kVLd>(ks + kBK * G::kKLd, vb, kv_row, k0, S);
}

// Below hd 128 the Q tile and two stages fit twice in an SM, so two blocks
// an SM are asked for; at hd 64 that caps a thread at 128 registers and
// spills 44 bytes, and was still faster at S = 2048 on the H100 than one
// block an SM without the spill.
template <int HD>
__global__ void __launch_bounds__(kThreads, HD == 128 ? 1 : 2)
    flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     int S, int H, int KV, int causal, int window,
                     float scale_log2) {
  using G = Geo<HD>;
  using sm90::Frag;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // the Q tile
  float* smem = qs + G::kQ;                      // [stage][K tile, V tile]

  const int n_qt = (S + kBQ - 1) / kBQ;
  const int BH = gridDim.x / n_qt;
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

  const long long q_row = (long long)H * HD;   // stride of s in q / out
  const long long kv_row = (long long)KV * HD;  // stride of s in k / v
  const float* kb = k + (long long)b * S * kv_row + (long long)kvh * HD;
  const float* vb = v + (long long)b * S * kv_row + (long long)kvh * HD;
  load_rows<HD, kBQ, G::kKLd>(
      qs, q + (long long)b * S * q_row + (long long)h * HD, q_row, q0, S);
  load_tile<HD>(smem, kb, vb, kv_row, kt_begin * kBK, S);
  cp_async_commit();

  // this warp's 16 rows from r0w; the thread's rows a and b = a + 8 and
  // its column pair 2c, 2c + 1 of every 8 (the m16n8 accumulator layout)
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int c = lane % 4;
  const int r0w = q0 + 16 * warp;
  const int row_a = r0w + g;
  const int row_b = row_a + 8;
  // the block's tiles these rows can see: [w_lo, w_hi) (none past S)
  int w_lo = kt_end, w_hi = kt_end;
  if (r0w < S) {
    w_lo = window > 0 ? max(0, r0w - window + 1) / kBK : 0;
    w_hi = causal ? min(r0w + 15, S - 1) / kBK + 1 : n_kt;
  }

  // Q's A fragments are read from the Q tile at each k step and split
  // there.  Every 8-wide k step takes its slot c from dim 2c and slot
  // c + 4 from dim 2c + 1 (a permutation of the sum; the K fragments
  // follow it), so a thread's dims of a row are one 8-byte load
  const float* qa = qs + (16 * warp + g) * G::kKLd + 2 * c;

  float m_a = kNegInf, m_b = kNegInf;  // running max, log2 units
  float l_a = 0.f, l_b = 0.f;          // running sum of this thread's columns
  float o[HD / 8][4];
#pragma unroll
  for (int t = 0; t < HD / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[t][e] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const float* ks = smem + ((kt - kt_begin) & 1) * G::kStage;
    const float* vs = ks + kBK * G::kKLd;
    if (kt + 1 < kt_end) {  // the next tile streams in under this one
      load_tile<HD>(smem + ((kt + 1 - kt_begin) & 1) * G::kStage, kb, vb,
                    kv_row, (kt + 1) * kBK, S);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile kt is in shared memory for every thread
    if (kt >= w_lo && kt < w_hi) {
      const int k0 = kt * kBK;
      // S = Q K^T, 16 rows x 64 keys: s[j] holds keys 8j + 2c, 8j + 2c + 1
      float s[kBK / 8][4];
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 8; ++kk) {
        const float2 xa = *reinterpret_cast<const float2*>(qa + 8 * kk);
        const float2 xb =
            *reinterpret_cast<const float2*>(qa + 8 * G::kKLd + 8 * kk);
        Frag<4> a;
        a.x[0] = xa.x;
        a.x[1] = xb.x;
        a.x[2] = xa.y;
        a.x[3] = xb.y;
        a.split();
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j) {
          const float2 kv = *reinterpret_cast<const float2*>(
              ks + (8 * j + g) * G::kKLd + 8 * kk + 2 * c);
          Frag<2> bf;
          bf.x[0] = kv.x;
          bf.x[1] = kv.y;
          bf.split();
          sm90::mma(s[j], a, bf);
        }
      }

      // the softmax in registers: scale into log2 units, mask only where
      // the tile straddles the diagonal, the window's edge or S, move the
      // running max across the 4 threads of a row, P = 2^(x - m)
      const bool need_mask = k0 + kBK > S || (causal && k0 + kBK - 1 > r0w) ||
                             (window > 0 && k0 <= r0w + 15 - window);
      float mx_a = m_a, mx_b = m_b;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float xa = s[j][e] * scale_log2;
          float xb = s[j][2 + e] * scale_log2;
          if (need_mask) {
            const int key = k0 + 8 * j + 2 * c + e;
            if (!visible(row_a, key, S, causal, window)) xa = kNegInf;
            if (!visible(row_b, key, S, causal, window)) xb = kNegInf;
          }
          s[j][e] = xa;
          s[j][2 + e] = xb;
          mx_a = fmaxf(mx_a, xa);
          mx_b = fmaxf(mx_b, xb);
        }
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
      }
      const float alpha_a = sm90::exp2_approx(m_a - mx_a);
      const float alpha_b = sm90::exp2_approx(m_b - mx_b);
      m_a = mx_a;
      m_b = mx_b;
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[j][e] = sm90::exp2_approx(s[j][e] - mx_a);
          s[j][2 + e] = sm90::exp2_approx(s[j][2 + e] - mx_b);
          sum_a += s[j][e];
          sum_b += s[j][2 + e];
        }
      }
      l_a = l_a * alpha_a + sum_a;
      l_b = l_b * alpha_b + sum_b;
      if (alpha_a != 1.f) {  // O rescaled only where the max moved
#pragma unroll
        for (int t = 0; t < HD / 8; ++t) {
          o[t][0] *= alpha_a;
          o[t][1] *= alpha_a;
        }
      }
      if (alpha_b != 1.f) {
#pragma unroll
        for (int t = 0; t < HD / 8; ++t) {
          o[t][2] *= alpha_b;
          o[t][3] *= alpha_b;
        }
      }

      // O += P V straight from the accumulators: the 8 keys of s[j] are
      // the k step, key 8j + 2c in slot c and 8j + 2c + 1 in slot c + 4,
      // so V's fragment reads rows 2c and 2c + 1
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        Frag<4> a;
        a.x[0] = s[j][0];
        a.x[1] = s[j][2];
        a.x[2] = s[j][1];
        a.x[3] = s[j][3];
        a.split();
        const float* v0 = vs + (8 * j + 2 * c) * G::kVLd + g;
#pragma unroll
        for (int t = 0; t < HD / 8; ++t) {
          Frag<2> bf;
          bf.x[0] = v0[8 * t];
          bf.x[1] = v0[G::kVLd + 8 * t];
          bf.split();
          sm90::mma(o[t], a, bf);
        }
      }
    }
    __syncthreads();  // every thread is done with the stage before reuse
  }

  // epilogue: acc / max(l, 1e-20), rows past S not written
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float inv_a = 1.f / fmaxf(l_a, 1e-20f);
  const float inv_b = 1.f / fmaxf(l_b, 1e-20f);
  float* oa = out + ((long long)b * S + row_a) * q_row + h * HD + 2 * c;
  float* ob = oa + 8 * q_row;
#pragma unroll
  for (int t = 0; t < HD / 8; ++t) {
    if (row_a < S)
      *reinterpret_cast<float2*>(oa + 8 * t) =
          make_float2(o[t][0] * inv_a, o[t][1] * inv_a);
    if (row_b < S)
      *reinterpret_cast<float2*>(ob + 8 * t) =
          make_float2(o[t][2] * inv_b, o[t][3] * inv_b);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int H, int KV, int causal, int window, float scale,
           cudaStream_t stream) {
  auto kernel = flash_f32_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Geo<HD>::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (long long)B * H * ((S + kBQ - 1) / kBQ);
  kernel<<<(unsigned)blocks, kThreads, Geo<HD>::kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), S, H, KV,
      causal, window, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

// the kernel's attributes and its dynamic shared memory
template <int HD>
int attributes(cudaFuncAttributes* attr, int* dynamic_smem) {
  *dynamic_smem = Geo<HD>::kSmem;
  return static_cast<int>(cudaFuncGetAttributes(attr, flash_f32_kernel<HD>));
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

}  // namespace f32

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

// Plain C entry point, loaded with ctypes.  dtype: 0 float32 (3xTF32
// mma.sync, cp.async-fed), 1 bfloat16 (wgmma, TMA-fed); q, k, v and out
// share the dtype and are 16-byte aligned (cp.async and TMA copy 16-byte
// pieces); q/out (B,S,H,hd) and k/v (B,S,KV,hd), all contiguous; window
// <= 0 means none.  Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int repro_flash_attention(int dtype, const void* q, const void* k,
                                     const void* v, void* out, int B, int S,
                                     int H, int KV, int hd, int causal,
                                     int window, float scale, void* stream) {
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return f32::launch_hd(hd, q, k, v, out, B, S, H, KV, causal, window,
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
    if (hd == 32) rc = f32::attributes<32>(&attr, &dynamic_smem);
    if (hd == 64) rc = f32::attributes<64>(&attr, &dynamic_smem);
    if (hd == 128) rc = f32::attributes<128>(&attr, &dynamic_smem);
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
