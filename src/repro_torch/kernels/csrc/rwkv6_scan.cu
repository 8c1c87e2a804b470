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
// What bounds it on the H100: at rwkv6-3b's prefill shape (B=4, T=2048,
// 40 heads of 64, f32) the call must move ~425 MB (0.127 ms at 3.35 TB/s)
// and do ~6.7e9 flops (0.100 ms at the f32 rate), so bytes bound it.  But
// step t needs the state of step t - 1: walked one step at a time, a head
// is a serial chain of T steps of hd x hd multiply-adds fed by broadcast
// shared-memory loads, and one block per (batch, head) puts 160 blocks on
// 132 SMs.  The earlier kernel (one thread per value channel) took 5.3x
// the bound, issue-bound on 2 warps an SM.
//
// What this design does about it:
//   * the sequence is walked C = 16 steps at a time, in the chunked form
//     of the recurrence: with S_in the state entering a chunk (c0 <= t <
//     c1), P_t = prod_{c0<=tau<t} w_tau, Q_s = prod_{s<tau<c1} w_tau and
//     G = prod_{c0<=tau<c1} w_tau,
//
//       y_t   = (r_t * P_t) S_in + sum_{s<t} A[t][s] v_s + A[t][t] v_t
//       S_out = diag(G) S_in + (k * Q)^T v
//
//     with A[t][s] = sum_i r_t[i] k_s[i] prod_{s<tau<t} w_tau[i] (s < t)
//     and A[t][t] = sum_i r_t[i] u[i] k_t[i].  The state products are
//     matrix products on the tensor cores; the pair term A (C^2/2 x hd
//     multiply-adds) runs on the CUDA cores, each lane owning two key steps
//     s and C-1-s (C-1 pairs a lane, every lane the same) and 4 channels,
//     summed over channels by a butterfly of warp shuffles;
//   * the key channels of a head are split across a cluster of two blocks
//     (KC = 32 channels each; 320 blocks at the prefill shape, 2-3 an SM).
//     Everything above is linear in the channels, so a block computes the
//     decays, A and the state rows of its own channels only (nothing is
//     computed twice) and a partial y over them; the two partials of each
//     y element meet in the block that owns its columns: the other block
//     sends its half by st.async into that block's shared memory, counted
//     on an mbarrier there, a chunk ahead of the sum (a relaxed cluster
//     barrier a chunk orders the reuse of the two buffers).  Splitting the
//     value columns instead, so that every block holds whole state columns
//     and needs no exchange, recomputes the decays and A in every block of
//     a head; split four ways either way, the blocks are too thin;
//   * every decay factor is a running product of w over a range: P and Q
//     in one pass over the chunk each, A's factor over t for each s.
//     Nothing is divided and no logarithm is taken, so every factor is in
//     [0, 1] and a decay that underflows to 0 gives the exact limit, not
//     inf or NaN (a prefix quotient P_t / P_s would divide by 0);
//   * the products are 3xTF32 mma.sync.m16n8k8: each f32 operand splits
//     into a TF32 high part and a TF32 residual, and hi*hi + hi*lo + lo*hi
//     keeps float32 accuracy (the 1e-4 bound of the f32 path; plain TF32
//     would not).  Operands
//     that several warps read (r*P, k*Q, A) are split once, as they are
//     written; the state tile is the accumulator of the state update and,
//     read in place, the A operand of y^T = S_in^T (r*P)^T (each 8-wide k
//     step takes k = q, q+4 from the elements 2q, 2q+1, a permutation of
//     the sum, so the accumulator layout is the operand layout);
//   * the next chunk's r/k/w (C x KC) and v (C x hd) arrive by TMA into the
//     other of two stages while the block computes the current chunk; the
//     ragged last chunk's missing steps arrive as zeros and decay by 1;
//   * the warps' work before the products (the pair term on two warps,
//     the decays and the previous chunk's y on the other two) rotates with
//     the block, so the blocks of an SM spread it over its schedulers; the
//     registers are capped so that every cluster of the rwkv6-3b prefill
//     shape is resident at once (see Geo::MIN_BLOCKS).
// Decode (T = 1) runs a separate step kernel: one block per (batch, head),
// a thread per 4 x 4 piece of the state, the partial y of the row groups
// summed in shared memory; a chunk of the chunked kernel would be mostly
// padding and two cluster barriers.
//
// C = 16, 32 key channels a block and 3xTF32 were chosen on the H100
// against C = 32 and 64, 16 and 64 channels a block and the products in
// f32 FMAs, all slower (PERF.md lists their times).
//
// Training's backward (the gradient of the recurrence, which the TPU side
// leaves to XLA's autodiff of a lax.scan) is the second half of this file:
// three kernels in namespace bwd (the chunk walks, every chunk's grads,
// du), entry point repro_rwkv6_scan_bwd; its own head comment says how it
// works.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kC = 16;     // steps a chunk
constexpr int kKeys = 32;  // key channels a block (at most hd)

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

// p ? a : b as a register select (a plain ?: on two elements of a
// register array can compile to an indexed load from local memory)
__device__ __forceinline__ float pick(bool p, float a, float b) {
  float r;
  asm("{\n .reg .pred q;\n setp.ne.u32 q, %1, 0;\n selp.f32 %0, %2, %3, q;\n}\n"
      : "=f"(r)
      : "r"(static_cast<uint32_t>(p)), "f"(a), "f"(b));
  return r;
}

// the 3xTF32 mma.sync helpers (fragment layout, split, Frag, store_split,
// mma) are shared with the flash-attention kernel, in sm90.cuh
using sm90::Frag;
using sm90::mma;
using sm90::store_split;

// ---- cluster (distributed shared memory) -----------------------------------

using sm90::cluster_arrive_relaxed;
using sm90::cluster_rank;
using sm90::cluster_sync;
using sm90::cluster_wait;
using sm90::map_rank;

// 16 bytes into the shared memory of another block of the cluster; the
// write completes 16 bytes of a transaction on the mbarrier `bar` there
__device__ __forceinline__ void st_async4(uint32_t addr, float a, float b,
                                          float c, float d, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(addr),
      "f"(a), "f"(b), "f"(c), "f"(d), "r"(bar)
      : "memory");
}

// Level LV of the butterfly over NL lanes: lanes o = NL >> (LV+1) apart
// swap halves of their live slots and add, so after all levels a lane holds
// C/NL sums (see fold_base for which).  A template per level, so that
// every index is a constant and part[] stays in registers.
template <int LV, int LEVELS, int C, int NL>
__device__ __forceinline__ void fold(float* part, float& d2, int lane) {
  if constexpr (LV < LEVELS) {
    constexpr int o = NL >> (LV + 1), half = C >> (LV + 1);
    const bool upper = (lane & o) != 0;
#pragma unroll
    for (int a = 0; a < half; ++a) {
      const float lo = part[a], hi = part[a + half];
      const float got = __shfl_xor_sync(0xffffffffu, pick(upper, lo, hi), o);
      part[a] = pick(upper, hi, lo) + got;
    }
    d2 += __shfl_xor_sync(0xffffffffu, d2, o);
    fold<LV + 1, LEVELS, C, NL>(part, d2, lane);
  }
}

// the slot that part[0] of `lane` holds after fold: the upper lane of each
// level keeps the upper half
template <int C, int NL>
__device__ __forceinline__ int fold_base(int lane) {
  int base = 0;
#pragma unroll
  for (int o = NL / 2, half = C / 2; o >= 1; o /= 2, half /= 2)
    if (lane & o) base += half;
  return base;
}

// ---- geometry --------------------------------------------------------------

constexpr int log2_of(int n) { return n <= 1 ? 0 : 1 + log2_of(n / 2); }

template <typename T, int HD>
struct Geo {
  static constexpr int C = kC;
  static constexpr int KC = kKeys < HD ? kKeys : HD;  // key channels a block
  static constexpr int NB = HD / KC;     // blocks a head (one cluster)
  static constexpr int NW = HD / 16;     // warp w: value columns [16w, +16)
  static constexpr int NT = 32 * NW;
  static constexpr int KT = KC / 8;      // 8-channel tiles of the block
  static constexpr int WPR = KC / 16;    // warps whose columns a block owns
  // blocks an SM must hold, which caps the registers a thread.  A tuning
  // for one shape and one card only: the clusters of the rwkv6-3b prefill
  // shape (B=4, 40 heads of 64, so 160 NB blocks) resident at once on the
  // H100's 132 SMs with a fifth to spare (clusters are placed within a
  // GPC, so an SM count that just fits the blocks leaves some clusters to
  // a second wave).  Other shapes and cards get the same register cap.
  static constexpr int MIN_BLOCKS = (192 * NB + 131) / 132;
  static constexpr int TT = C / 8;       // 8-step tiles of a chunk
  static constexpr int E = TT * 4;       // y accumulator floats a lane
  // pair term: roles [0, AW), C/2 groups of NL lanes, IPT channels a lane
  // in fours; the decays: roles [NW - DW, NW), a lane per (channel,
  // direction)
  static constexpr int AW = KC * C / 256 < NW ? KC * C / 256 : NW;
  static constexpr int DW = KC / 16;
  static constexpr int NL = 64 * AW / C;
  static constexpr int IPT = KC / NL;
  static constexpr int LEVELS = log2_of(NL);
  static_assert(NL >= 1 && (1 << LEVELS) == NL && NL <= 32 && IPT % 4 == 0,
                "pair-term lanes");
  // shared rows (elements); the paddings make the fragment loads
  // conflict-free
  static constexpr int P_ROW = KC + 8;    // r*P, {hi, lo} pairs
  static constexpr int S_ROW = C + 8;     // (k*Q)^T and A, {hi, lo} pairs
  // shared layout (bytes): two raw stages (the TMA boxes r, k, w [C][KC]
  // and v [C][HD]), the chunk's derived tiles, two buffers of the partial
  // y this block receives (one slot a block), the mbarriers
  static constexpr int RAW = C * KC * int(sizeof(T));
  static constexpr int VT = C * HD * int(sizeof(T));
  static constexpr int STAGE = 3 * RAW + VT;  // r, k, w, v
  static constexpr int RP = 2 * STAGE;
  static constexpr int KQ = RP + C * P_ROW * 8;
  static constexpr int A = KQ + KC * S_ROW * 8;
  static constexpr int G = A + C * S_ROW * 8;
  static constexpr int Y = G + KC * 4;
  static constexpr int Y_BUF = NB * WPR * E * 32;  // floats
  static constexpr int MB = Y + 2 * Y_BUF * 4;  // y buffers, raw stages
  static constexpr int SMEM = MB + 4 * 8;
  static_assert(STAGE % 128 == 0 && RAW % 128 == 0, "TMA boxes 128-aligned");
  static_assert(E % 4 == 0, "y pushed in 16-byte stores");
};

// four consecutive elements (16 bytes of float, 8 of bf16), as float
__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  out[0] = a.x, out[1] = a.y, out[2] = a.z, out[3] = a.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* out) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  out[0] = a.x, out[1] = a.y, out[2] = b.x, out[3] = b.y;
}

// ---- the chunked kernel ------------------------------------------------------

// One cluster of NB = hd/KC blocks per (batch, head); block x owns key
// channels [KC x, KC x + KC) and every value column, warp w the columns
// [16w, 16w+16); 2 * hd threads.
template <typename T, int HD>
__global__ void __launch_bounds__(Geo<T, HD>::NT, Geo<T, HD>::MIN_BLOCKS)
    rwkv6_chunked_kernel(const __grid_constant__ CUtensorMap r_map,
                         const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map,
                         const __grid_constant__ CUtensorMap w_map,
                         const float* __restrict__ u,
                         const float* __restrict__ state_in,
                         float* __restrict__ state_out, T* __restrict__ y,
                         int steps, int H) {
  using Gm = Geo<T, HD>;
  constexpr int C = Gm::C, KC = Gm::KC, NB = Gm::NB, NW = Gm::NW;
  constexpr int NT = Gm::NT, TT = Gm::TT, E = Gm::E, KT = Gm::KT;
  constexpr int WPR = Gm::WPR;
  extern __shared__ __align__(128) unsigned char smem[];
  uint2* s_rp = reinterpret_cast<uint2*>(smem + Gm::RP);
  uint2* s_kq = reinterpret_cast<uint2*>(smem + Gm::KQ);  // [channel][step]
  uint2* s_a = reinterpret_cast<uint2*>(smem + Gm::A);
  float* s_g = reinterpret_cast<float*>(smem + Gm::G);
  float* s_y = reinterpret_cast<float*>(smem + Gm::Y);
  uint64_t* s_full = reinterpret_cast<uint64_t*>(smem + Gm::MB);  // y
  uint64_t* s_raw = s_full + 2;  // raw stages

  const int bh = blockIdx.x / NB;
  const int x = static_cast<int>(cluster_rank());  // = blockIdx.x % NB
  const int i0 = x * KC;                           // this block's channels
  const int b = bh / H, h = bh - b * H;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const long long t_stride = (long long)H * HD;  // one step in (B,T,H,hd)
  const long long row0 = ((long long)b * steps * H + h) * HD;  // (b, 0, h)

  // ---- the state tile S^T (value columns of this warp x this block's key
  // channels) as mma accumulators: sc[n][e] = S[i][j] with
  // i = i0 + 8n + 2q + (e&1), j = 16 wid + g + 8(e>>1)
  float sc[KT][4] = {};
  const long long s_base = (long long)bh * HD * HD;
  if (state_in) {
#pragma unroll
    for (int n = 0; n < KT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + 8 * n + 2 * q + (e & 1);
        const int j = 16 * wid + g + 8 * (e >> 1);
        sc[n][e] = state_in[s_base + (long long)i * HD + j];
      }
  }
  for (int a = tid; a < C * Gm::S_ROW; a += NT) s_a[a] = make_uint2(0u, 0u);

  // a warp's role in a chunk before the matrix products: roles [0, AW)
  // the pair term, roles [NW-DW, NW) the decays.  The roles rotate with the
  // block, so that the blocks on an SM spread them over its schedulers.
  const int role = (wid + blockIdx.x) & (NW - 1);
  // the pair term's lane: group sp owns key steps sp and s2 = C-1-sp, lane
  // ic of the group the channels c = 4 (ic + NL m) + 0..3
  constexpr int NL = Gm::NL, MV = Gm::IPT / 4;
  const int pt = 32 * role + lane;
  const int sp = pt / NL, ic = pt % NL, s2 = C - 1 - sp;
  float uu[MV][4];
#pragma unroll
  for (int m = 0; m < MV; ++m)
    load4(u + h * HD + i0 + 4 * (ic + NL * m), uu[m]);
  // where the lane's C/NL summed slots go in A: slot n < C-1 is the pair
  // (t, s) of the loop below, slot C-1 the diagonal of sp
  int a_at[C / NL];
#pragma unroll
  for (int a = 0; a < C / NL; ++a) {
    const int slot = fold_base<C, NL>(lane) + a;
    const int s = slot == C - 1 || slot < s2 ? sp : s2;
    const int t = slot == C - 1 ? sp : slot < s2 ? sp + 1 + slot : slot + 1;
    a_at[a] = t * Gm::S_ROW + s;
  }

  // a chunk's r, k, w (this block's channels) and v (every column) by four
  // TMA boxes into a stage, completing on the stage's mbarrier; steps past
  // the end arrive as zeros
  auto stage = [&](int ch, int buf) {
    if (tid == 0) {
      uint64_t* bar = &s_raw[buf];
      unsigned char* dst = smem + buf * Gm::STAGE;
      sm90::mbar_arrive_expect_tx(bar, Gm::STAGE);
      sm90::tma_load_4d(dst, &r_map, bar, i0, h, ch * C, b);
      sm90::tma_load_4d(dst + Gm::RAW, &k_map, bar, i0, h, ch * C, b);
      sm90::tma_load_4d(dst + 2 * Gm::RAW, &w_map, bar, i0, h, ch * C, b);
      sm90::tma_load_4d(dst + 3 * Gm::RAW, &v_map, bar, 0, h, ch * C, b);
    }
  };

  // y: warp w of every block pushes its partial y^T (columns [16w, +16),
  // summed over the block's key channels) into the block that owns those
  // columns (rank w / WPR; block x owns columns [KC x, KC x + KC)), into
  // the pushing block's slot, by st.async that completes bytes on the
  // owner's mbarrier of the buffer; the owner waits for all slots and
  // stores its columns
  // (a block's partial for its own columns is written in place, so the
  // mbarrier counts the other blocks' bytes)
  constexpr uint32_t Y_BYTES = (NB - 1) * WPR * E * 32 * 4;
  if (tid == 0) {
#pragma unroll
    for (int a = 0; a < 4; ++a) sm90::mbar_init(&s_full[a], 1);
    sm90::fence_mbar_init();
  }
  const uint32_t y_dst = map_rank(s_y, wid / WPR);
  const uint32_t full_dst = map_rank(s_full, wid / WPR);
  cluster_sync();  // every block runs, its mbarriers set, before any push

  // the `count` threads numbered `id` store the y of `chunk`
  auto store_y = [&](int chunk, int id, int count) {
    // thread (ln, nt) sums the four elements e = 4nt .. 4nt+3 of lane ln's
    // slots: y rows 8nt + 2(ln&3) + 0..1, columns (ln>>2) + 0, 8, so each
    // store instruction of a warp writes 4 rows x 32 bytes
    const int buf = chunk & 1, c0 = chunk * C, n_valid = min(C, steps - c0);
    for (int a = id; a < WPR * 32 * TT; a += count) {
      sm90::mbar_wait(&s_full[buf], (chunk >> 1) & 1);
      const int wl = a / (32 * TT), ln = a & 31, nt = (a >> 5) % TT;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int src = 0; src < NB; ++src) {
        const float4 p = *reinterpret_cast<const float4*>(
            s_y + buf * Gm::Y_BUF + ((src * WPR + wl) * 32 + ln) * E +
            4 * nt);
        acc.x += p.x, acc.y += p.y, acc.z += p.z, acc.w += p.w;
      }
      const int t = 8 * nt + 2 * (ln & 3);
      const int j = 16 * (x * WPR + wl) + (ln >> 2);
      T* out = y + row0 + (long long)(c0 + t) * t_stride + j;
      if (t < n_valid) {
        out[0] = from_f32<T>(acc.x);
        out[8] = from_f32<T>(acc.z);
      }
      if (t + 1 < n_valid) {
        out[t_stride] = from_f32<T>(acc.y);
        out[t_stride + 8] = from_f32<T>(acc.w);
      }
    }
  };

  stage(0, 0);
  const int chunks = (steps + C - 1) / C;
  for (int ch = 0; ch < chunks; ++ch) {
    const int c0 = ch * C;
    const int n_valid = min(C, steps - c0);
    sm90::mbar_wait(&s_raw[ch & 1], (ch >> 1) & 1);
    __syncthreads();  // chunk ch landed; chunk ch-1's readers are done
    if (ch + 1 < chunks) stage(ch + 1, (ch + 1) & 1);
    if (tid == 0) sm90::mbar_arrive_expect_tx(&s_full[ch & 1], Y_BYTES);
    const unsigned char* raw = smem + (ch & 1) * Gm::STAGE;
    const T* s_r = reinterpret_cast<const T*>(raw);
    const T* s_k = reinterpret_cast<const T*>(raw + Gm::RAW);
    const T* s_w = reinterpret_cast<const T*>(raw + 2 * Gm::RAW);
    const T* s_v = reinterpret_cast<const T*>(raw + 3 * Gm::RAW);

    if (role < Gm::AW) {
      // ---- the pair term A over this block's channels.  Slot n < C-1 of
      // a lane is the pair (t, s) below, slot C-1 the diagonal of sp, d2
      // the diagonal of s2
      float part[C];
#pragma unroll
      for (int a = 0; a < C; ++a) part[a] = 0.f;
      float d2 = 0.f;
#pragma unroll
      for (int m = 0; m < MV; ++m) {
        const int c = 4 * (ic + NL * m);
        float ra[4], ka[4], rb[4], kb[4], kd[4];
        load4(s_r + sp * KC + c, ra);
        load4(s_k + sp * KC + c, ka);
        load4(s_r + s2 * KC + c, rb);
        load4(s_k + s2 * KC + c, kb);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          part[C - 1] += ra[e] * uu[m][e] * ka[e];
          d2 += rb[e] * uu[m][e] * kb[e];
          kd[e] = ka[e];
        }
        if (n_valid > 1) {
#pragma unroll
          for (int n = 0; n < C - 1; ++n) {
            // slot n: s = sp, t = sp + 1 + n while n < s2; then s = s2,
            // t = n + 1 (the running product restarts there)
            const int t = n < s2 ? sp + 1 + n : n + 1;
            float rt[4], wt[4];
            load4(s_r + t * KC + c, rt);
            load4(s_w + t * KC + c, wt);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if (n == s2) kd[e] = kb[e];
              part[n] += rt[e] * kd[e];
              kd[e] *= wt[e];
            }
          }
        }
      }
      // sum over the group's NL lanes (a butterfly that halves the slots
      // at each level, leaving C/NL slots a lane)
      fold<0, Gm::LEVELS, C, NL>(part, d2, lane);
#pragma unroll
      for (int a = 0; a < C / NL; ++a) store_split(s_a + a_at[a], part[a]);
      if (ic == 0) store_split(s_a + s2 * Gm::S_ROW + s2, d2);
    }
    if (role >= NW - Gm::DW) {
      // ---- decays of this block's channels: r*P and G walking forward
      // (lanes dl < KC), k*Q walking back (the others); a ragged chunk's
      // missing steps decay by 1
      // (pointers stepped from s_r and s_rp, so that the accesses stay
      // shared-memory ones and cost one address each)
      const int dl = 32 * (role - (NW - Gm::DW)) + lane;
      const int c = dl % KC;
      const bool fwd = dl < KC;
      const int step = fwd ? KC : -KC;  // r from step 0 up, k from C-1 down
      const T* xs = s_r + (fwd ? c : (2 * C - 1) * KC + c);
      const T* ws = s_w + (fwd ? c : (C - 1) * KC + c);
      uint2* dst = s_rp + (fwd ? c : (Gm::KQ - Gm::RP) / 8 + c * Gm::S_ROW + C - 1);
      const int dstep = fwd ? Gm::P_ROW : -1;
      // bit n: the n-th step of the walk is real (t < n_valid)
      const uint32_t ones = (1u << n_valid) - 1u;
      const uint32_t real = fwd ? ones : ones << (C - n_valid);
      float p = 1.f;
#pragma unroll
      for (int n = 0; n < C; ++n) {
        const float xv = to_f32(xs[n * step]), wv = to_f32(ws[n * step]);
        store_split(dst + n * dstep, xv * p);
        if ((real >> n) & 1u) p *= wv;
      }
      if (fwd) s_g[c] = p;
      // the previous chunk's y, while the pair term still runs
      if (ch > 0) store_y(ch - 1, dl, 32 * Gm::DW);
    }
    __syncthreads();

    {
      // ---- matrix products, value columns [16 wid, 16 wid + 16).  Each
      // 8-wide k step takes its index k = q, q+4 from the element 2q, 2q+1
      // (a permutation of the sum), so a lane's two B elements are adjacent
      // in shared memory and the state accumulators are A operands.
      // v^T as the A operand, one fragment per 8-step tile
      Frag<4> vt[TT];
#pragma unroll
      for (int ks = 0; ks < TT; ++ks) {
        const T* p = s_v + (8 * ks + 2 * q) * HD + 16 * wid + g;
        vt[ks].x[0] = to_f32(p[0]);
        vt[ks].x[1] = to_f32(p[8]);
        vt[ks].x[2] = to_f32(p[HD]);
        vt[ks].x[3] = to_f32(p[HD + 8]);
        vt[ks].split();
      }

      // partial y^T (16 x C) = S_in^T (r*P)^T over this block's channels
      // + v^T A^T (A's lower 8x8 blocks), in two sets of accumulators (by
      // the parity of the k step), so that the chains of dependent mma
      // are half as long
      float yc[2][TT][4] = {};
#pragma unroll
      for (int ks = 0; ks < KT; ++ks) {
        Frag<4> sa;
        sa.x[0] = sc[ks][0];
        sa.x[1] = sc[ks][2];
        sa.x[2] = sc[ks][1];
        sa.x[3] = sc[ks][3];
        sa.split();
#pragma unroll
        for (int nt = 0; nt < TT; ++nt) {
          Frag<2> rb;
          rb.load_split(s_rp + (8 * nt + g) * Gm::P_ROW + 8 * ks + 2 * q);
          mma(yc[ks & 1][nt], sa, rb);
        }
      }
#pragma unroll
      for (int nt = 0; nt < TT; ++nt)
#pragma unroll
        for (int ks = 0; ks <= nt; ++ks) {
          Frag<2> ab;
          ab.load_split(s_a + (8 * nt + g) * Gm::S_ROW + 8 * ks + 2 * q);
          mma(yc[(ks + 1) & 1][nt], vt[ks], ab);
        }

      // S^T <- S^T diag(G) + v^T (k*Q), the KT channel tiles independent
#pragma unroll
      for (int n = 0; n < KT; ++n) {
        const float2 gg =
            *reinterpret_cast<const float2*>(s_g + 8 * n + 2 * q);
        sc[n][0] *= gg.x;
        sc[n][1] *= gg.y;
        sc[n][2] *= gg.x;
        sc[n][3] *= gg.y;
      }
#pragma unroll
      for (int ks = 0; ks < TT; ++ks)
#pragma unroll
        for (int n = 0; n < KT; ++n) {
          Frag<2> kb;
          kb.load_split(s_kq + (8 * n + g) * Gm::S_ROW + 8 * ks + 2 * q);
          mma(sc[n], vt[ks], kb);
        }

      // ---- once every block has stored the y of the buffer it
      // overwrites (two chunks back), this chunk's partial
      if (ch > 0) cluster_wait();
      const int slot =
          (ch & 1) * Gm::Y_BUF + ((x * WPR + wid % WPR) * 32 + lane) * E;
#pragma unroll
      for (int nt = 0; nt < TT; ++nt) {
        const float4 part = make_float4(
            yc[0][nt][0] + yc[1][nt][0], yc[0][nt][1] + yc[1][nt][1],
            yc[0][nt][2] + yc[1][nt][2], yc[0][nt][3] + yc[1][nt][3]);
        if (wid / WPR == x)  // read after the next chunk's first barrier
          *reinterpret_cast<float4*>(s_y + slot + 4 * nt) = part;
        else
          st_async4(y_dst + 4u * (slot + 4 * nt), part.x, part.y, part.z,
                    part.w, full_dst + 8u * (ch & 1));
      }
    }
    cluster_arrive_relaxed();
  }
  __syncthreads();  // the last chunk's partials written in place
  store_y(chunks - 1, tid, NT);
  cluster_wait();

  if (state_out) {
#pragma unroll
    for (int n = 0; n < KT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + 8 * n + 2 * q + (e & 1);
        const int j = 16 * wid + g + 8 * (e >> 1);
        state_out[s_base + (long long)i * HD + j] = sc[n][e];
      }
  }
}

// ---- one step (T = 1) ------------------------------------------------------

// y = r S + (r . (u * k)) v and S <- diag(w) S + k^T v for one step, one
// block per (batch, head): thread (row group ig, column quad jq) owns
// S[4ig .. 4ig+3][4jq .. 4jq+3]; the partial y of the row groups is summed
// in shared memory.  A decode step is a few loads and stores per state
// element; a chunk of the chunked kernel would be mostly padding.
template <typename T, int HD>
__global__ void __launch_bounds__(HD * HD / 16) rwkv6_step_kernel(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ w, const float* __restrict__ u,
    const float* __restrict__ state_in, float* __restrict__ state_out,
    T* __restrict__ y, int H) {
  constexpr int NQ = HD / 4;  // column quads, and row groups
  __shared__ float4 part[NQ][NQ];
  const int bh = blockIdx.x, h = bh % H;
  const int jq = threadIdx.x % NQ, ig = threadIdx.x / NQ;
  const long long base = (long long)bh * HD;  // (b, 0, h) of (B, 1, H, hd)
  float rr[4], kk[4], ww[4], vv[4], uu[4];
  load4(r + base + 4 * ig, rr);
  load4(k + base + 4 * ig, kk);
  load4(w + base + 4 * ig, ww);
  load4(v + base + 4 * jq, vv);
  load4(u + h * HD + 4 * ig, uu);
  const float bonus = rr[0] * uu[0] * kk[0] + rr[1] * uu[1] * kk[1] +
                      rr[2] * uu[2] * kk[2] + rr[3] * uu[3] * kk[3];
  float acc[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] = bonus * vv[e];
  const long long s0 = ((long long)bh * HD + 4 * ig) * HD + 4 * jq;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    if (state_in) load4(state_in + s0 + m * HD, s);
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] += rr[m] * s[e];
    if (state_out)
      *reinterpret_cast<float4*>(state_out + s0 + m * HD) = make_float4(
          ww[m] * s[0] + kk[m] * vv[0], ww[m] * s[1] + kk[m] * vv[1],
          ww[m] * s[2] + kk[m] * vv[2], ww[m] * s[3] + kk[m] * vv[3]);
  }
  part[ig][jq] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  __syncthreads();
  if (ig == 0) {
    float4 sum = part[0][jq];
#pragma unroll
    for (int gi = 1; gi < NQ; ++gi) {
      const float4 p = part[gi][jq];
      sum.x += p.x, sum.y += p.y, sum.z += p.z, sum.w += p.w;
    }
    T* out = y + base + 4 * jq;
    out[0] = from_f32<T>(sum.x);
    out[1] = from_f32<T>(sum.y);
    out[2] = from_f32<T>(sum.z);
    out[3] = from_f32<T>(sum.w);
  }
}

// ---- the backward (training) ----------------------------------------------
//
// The gradient of the recurrence, for training.  The TPU side has no kernel
// for it (XLA differentiates the reference's lax.scan); on the card it is
// this one.  float32 only: the time mix hands the forward float32 r/k/v/w.
// With G_t the adjoint of the state after step t (G_{T-1} the final
// state's gradient, or zero) and S_{t-1} the state entering step t:
//
//   dr_t[i] = sum_j S_{t-1}[i][j] dy_t[j] + u[i] k_t[i] (v_t . dy_t)
//   dk_t[i] = sum_j G_t[i][j] v_t[j]      + r_t[i] u[i] (v_t . dy_t)
//   dv_t[j] = sum_i k_t[i] G_t[i][j]      + (sum_i r_t[i] u[i] k_t[i]) dy_t[j]
//   dw_t[i] = sum_j G_t[i][j] S_{t-1}[i][j]
//   du[i]   = sum_{b,t} r_t[i] k_t[i] (v_t . dy_t)
//   G_{t-1} = diag(w_t) G_t + r_t^T dy_t,     dstate0 = G_{-1}
//
// What bounds it: at rwkv6-3b's training shape (B=2, T=256, 40 heads of
// 64) the function moves ~47 MB (r, k, v, w, dy in, dr, dk, dv, dw out:
// 0.014 ms at 3.35 TB/s) and does ~14 flops per state element and step
// (0.007 ms at the 3xTF32 rate), so bytes bound it.  But the recurrence is
// a chain over T in both directions: walked a step at a time, each head is
// ~2T dependent steps, and the chain, not the card's rates, sets the time.
//
// What this design does about it: the sequence is cut into chunks of C =
// 16 steps (c0 <= t < c1; P_t = prod_{c0<=tau<t} w_tau, Q_t =
// prod_{t<tau<c1} w_tau, Gamma = prod over the chunk, D(s,t) =
// prod_{s<tau<t} w_tau for s < t), and the chain becomes ceil(T/16) chunk
// hops, with every chunk's gradients computed in parallel:
//   * launch 1 (rwkv6_bwd_walk_kernel) walks the chunks in the chunked
//     form, S_out = diag(Gamma) S_in + (k*Q)^T v forward and G_in =
//     diag(Gamma) G_out + (r*P)^T dy in reverse, and writes every chunk's
//     S_in and G_out to the workspace (dstate0 is chunk 0's G_in).  The
//     two walks are independent blocks of one launch, and each walk splits
//     the value columns across blocks (column j of S depends on v[:, j]
//     only, of G on dy[:, j] only), 16 a block, with no exchange; each
//     block recomputes the chunk's decays.  The hop's (hd x C)(C x 16)
//     product is 3xTF32 mma.sync, the next chunk arrives by cp.async while
//     the current one computes;
//   * launch 2 (rwkv6_bwd_chunk_kernel), one block per (batch, head,
//     chunk), computes dr, dk, dv, dw of its steps from S_in, G_out and
//     the chunk's inputs.  With X = dy S_in^T, Y = v G_out^T, Z = (k*Q)
//     G_out (3xTF32 mma.sync), B2[s][t] = dy_s . v_t and the forward's
//     pair matrix A[s][t] = sum_i r_s k_t D(t,s) (s > t), A[t][t] =
//     sum_i r_t u k_t (CUDA cores, spread over the block):
//       dr_t = P_t X_t + sum_{s<t} D(s,t) k_s B2[t][s] + u k_t B2[t][t]
//       dk_t = Q_t Y_t + sum_{s>t} D(t,s) r_s B2[s][t] + r_t u B2[t][t]
//       dv_t = Z_t + sum_{s>=t} A[s][t] dy_s
//     dw_t = sum_j G_t S_{t-1} is built from the two ends of the chunk:
//     with S_{t-1} = P_t S_in + sum_{s<t} D(s,t) k_s^T v_s and G_t = Q_t
//     G_out + sum_{s>t} D(t,s) r_s^T dy_s, it is P_t Q_t (G_out . S_in) +
//     Q_t L_t + P_t R_t + sum_{s<t<s'} D(s,t) D(t,s') k_s r_s' B2[s'][s],
//     where L_t = sum_{s<t} D(s,t) k_s Y_s and R_t = sum_{s>t} D(t,s) r_s
//     X_s are running sums over the chunk (16 steps each way).  Each key
//     channel is walked by two threads, one forward over t (the dr pair
//     sums, L), one back (the dk pair sums, R and the cross term), each a
//     running product of w: nothing divides by w and nothing takes a
//     logarithm, so a decay that underflows to 0 gives exact grads.  A
//     block holds the whole head, so it writes dv directly;
//   * launch 3 (rwkv6_bwd_du_kernel) sums the blocks' du partials over
//     (batch, chunk) in a fixed order.  No float atomics anywhere: the
//     grads are the same bits from run to run.
// The workspace (S_in and G_out of every chunk, 2 B H ceil(T/16) hd^2
// floats) is the design's own traffic, beside the function's bytes.  16
// columns and two stages a walk block, and two chunk blocks an SM, were
// kept on the H100 against 32 or 64 columns, four stages, warps walking
// on their own, the chunk's loads in two groups and one persistent chunk
// block an SM, all slower (PERF.md).
// kernels/ref.py::rwkv6_scan_bwd_chunked_ref is a plain model of this
// arithmetic; kernels/ref.py::rwkv6_scan_bwd_ref the reverse recurrence
// the kernel is held to.

namespace bwd {

constexpr int kC = 16;     // steps a chunk
constexpr int kCols = 16;  // state columns a walk block

// ---- launch 1: the chunk walks ---------------------------------------------

template <int HD>
struct WalkGeo {
  static constexpr int NW = HD / 16;      // warp w: state rows [16w, +16)
  static constexpr int NT = 32 * NW;
  static constexpr int NS = HD / kCols;   // column slices a head
  // rows padded so that the fragment loads are conflict-free: the value-side
  // tile (floats) and the split key-side tile (uint2)
  static constexpr int Y_ROW = kCols + 8;
  static constexpr int XD_ROW = HD + 4;
  // shared layout (bytes): two stages of {x [C][HD], w [C][HD], y
  // [C][Y_ROW]} (x = k or r, y = v or dy), then x * decay split {hi, lo}
  // [C][XD_ROW] and the chunk's Gamma [HD]
  static constexpr int X = 0;
  static constexpr int W = X + kC * HD * 4;
  static constexpr int Y = W + kC * HD * 4;
  static constexpr int STAGE = Y + kC * Y_ROW * 4;
  static constexpr int XD = 2 * STAGE;
  static constexpr int GAM = XD + kC * XD_ROW * 8;
  static constexpr int SMEM = GAM + HD * 4;
  static_assert(STAGE % 16 == 0 && W % 16 == 0 && Y % 16 == 0, "cp.async");
};

// One block per (batch, head, 16-column slice, direction).  Direction 0
// walks the state forward from state_in and writes the state entering
// every chunk to s_in; direction 1 walks the adjoint back from
// dstate_final and writes the adjoint leaving every chunk to g_out, then
// (when dstate0 is not null) the adjoint entering chunk 0 to dstate0.
// Warp w holds rows [16w, +16) of the slice as the accumulators of two
// m16n8 tiles: st[n][e] = S[16w + g + 8(e>>1)][j0 + 8n + 2q + (e&1)].
template <int HD>
__global__ void __launch_bounds__(WalkGeo<HD>::NT) rwkv6_bwd_walk_kernel(
    const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ dy, const float* __restrict__ state_in,
    const float* __restrict__ dstate_final, float* __restrict__ s_in,
    float* __restrict__ g_out, float* __restrict__ dstate0, int steps,
    int H) {
  using Gm = WalkGeo<HD>;
  constexpr int NT = Gm::NT;
  extern __shared__ __align__(16) unsigned char smem[];
  uint2* s_xd = reinterpret_cast<uint2*>(smem + Gm::XD);
  float* s_gam = reinterpret_cast<float*>(smem + Gm::GAM);

  const int dir = blockIdx.x & 1;
  const int slice = (blockIdx.x >> 1) % Gm::NS;
  const int bh = (blockIdx.x >> 1) / Gm::NS;
  const int b = bh / H, h = bh - b * H;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int j0 = slice * kCols, i0 = 16 * wid;
  const int chunks = (steps + kC - 1) / kC;
  const float* x = dir ? r : k;    // the key-channel factor
  const float* y = dir ? dy : v;   // the value-column factor
  const long long t_stride = (long long)H * HD;
  const long long row0 = ((long long)b * steps * H + h) * HD;  // (b, 0, h)
  const long long s_base = (long long)bh * HD * HD;

  float st[2][4];
  const float* init = dir ? dstate_final : state_in;
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + g + 8 * (e >> 1), j = j0 + 8 * n + 2 * q + (e & 1);
      st[n][e] = init ? init[s_base + (long long)i * HD + j] : 0.f;
    }

  // chunk ch's x, w (every channel) and y (the slice's columns) into stage
  // `buf`; steps past the end arrive as zeros
  auto stage = [&](int ch, int buf) {
    constexpr int V4 = HD / 4;
    unsigned char* dst = smem + buf * Gm::STAGE;
    for (int a = tid; a < 2 * kC * V4; a += NT) {
      const int m = a / (kC * V4), rem = a - m * (kC * V4);
      const int s = rem / V4, c4 = rem - s * V4, t = ch * kC + s;
      const bool ok = t < steps;
      sm90::cp_async16(
          dst + (m ? Gm::W : Gm::X) + (s * HD + 4 * c4) * 4,
          (m ? w : x) + row0 + (long long)(ok ? t : 0) * t_stride + 4 * c4,
          ok);
    }
    for (int a = tid; a < kC * (kCols / 4); a += NT) {
      const int s = a / (kCols / 4), c4 = a % (kCols / 4), t = ch * kC + s;
      const bool ok = t < steps;
      sm90::cp_async16(
          dst + Gm::Y + (s * Gm::Y_ROW + 4 * c4) * 4,
          y + row0 + (long long)(ok ? t : 0) * t_stride + j0 + 4 * c4, ok);
    }
    sm90::cp_async_commit();
  };

  stage(dir ? chunks - 1 : 0, 0);
  for (int it = 0; it < chunks; ++it) {
    const int ch = dir ? chunks - 1 - it : it;
    // the state entering chunk ch / the adjoint leaving it
    float* out = (dir ? g_out : s_in) + s_base * chunks +
                 (long long)ch * HD * HD;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int i = i0 + g + 8 * hf, j = j0 + 8 * n + 2 * q;
        *reinterpret_cast<float2*>(out + (long long)i * HD + j) =
            make_float2(st[n][2 * hf], st[n][2 * hf + 1]);
      }
    sm90::cp_async_wait<0>();
    // no hop after the last chunk, except the reverse walk's to dstate0
    if (it + 1 == chunks && !(dir && dstate0)) break;
    __syncthreads();  // chunk ch landed; the previous hop's readers done
    if (it + 1 < chunks) stage(dir ? ch - 1 : ch + 1, (it + 1) & 1);
    const unsigned char* raw = smem + (it & 1) * Gm::STAGE;
    const float* sx = reinterpret_cast<const float*>(raw + Gm::X);
    const float* sw = reinterpret_cast<const float*>(raw + Gm::W);
    const float* sy = reinterpret_cast<const float*>(raw + Gm::Y);
    const int nv = min(kC, steps - ch * kC);
    if (tid < HD) {
      // x * Q (forward: suffix products) or x * P (reverse: prefix), split
      // once for every warp; a ragged chunk's missing steps decay by 1
      float d = 1.f;
#pragma unroll
      for (int n = 0; n < kC; ++n) {
        const int s = dir ? n : kC - 1 - n;
        sm90::store_split(s_xd + s * Gm::XD_ROW + tid, sx[s * HD + tid] * d);
        if (s < nv) d *= sw[s * HD + tid];
      }
      s_gam[tid] = d;
    }
    __syncthreads();

    // st <- diag(Gamma) st + (x * decay)^T y, K = the chunk's 16 steps
    float acc[2][4] = {};
#pragma unroll
    for (int ks = 0; ks < kC / 8; ++ks) {
      sm90::Frag<4> a;  // A[i][s] = xd[s][i]
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint2 p =
            s_xd[(8 * ks + q + 4 * (e >> 1)) * Gm::XD_ROW + i0 + g +
                 8 * (e & 1)];
        a.hi[e] = p.x;
        a.lo[e] = p.y;
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        sm90::Frag<2> bb;  // B[s][j] = y[s][j]
        bb.x[0] = sy[(8 * ks + q) * Gm::Y_ROW + 8 * n + g];
        bb.x[1] = sy[(8 * ks + q + 4) * Gm::Y_ROW + 8 * n + g];
        bb.split();
        mma(acc[n], a, bb);
      }
    }
    const float ga = s_gam[i0 + g], gb = s_gam[i0 + g + 8];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        st[n][e] = (e < 2 ? ga : gb) * st[n][e] + acc[n][e];
  }
  if (dir && dstate0) {
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int i = i0 + g + 8 * hf, j = j0 + 8 * n + 2 * q;
        *reinterpret_cast<float2*>(dstate0 + s_base + (long long)i * HD + j) =
            make_float2(st[n][2 * hf], st[n][2 * hf + 1]);
      }
  }
}

// ---- launch 2: every chunk's gradients ---------------------------------

template <int HD>
struct ChunkGeo {
  // threads [0, 2HD): the products X, Y, then Z and the pair matrix;
  // [2HD, 4HD): k * Q, G_out . S_in and B2, then the channel walks
  static constexpr int NT = 4 * HD;
  static constexpr int NQ = HD / 4;  // channel quads
  // rows padded so that the fragment loads are conflict-free
  static constexpr int ROW = HD + 4;     // input tiles (floats)
  static constexpr int P_ROW = HD + 8;   // X, Y, Z (floats)
  static constexpr int KQ_ROW = HD + 8;  // split k * Q (uint2)
  static constexpr int B_ROW = kC + 1;   // B2, A (floats)
  // shared layout (floats): r, k, v, w, dy [C][ROW]; S_in, G_out
  // [HD][ROW]; X, Y, Z [C][P_ROW]; k * Q split [C][KQ_ROW] uint2; B2 and A
  // [C][B_ROW]; G_out . S_in per row, u [HD]; the two channel walks' dw
  // parts [2][C][HD]; the pair matrix's partial sums [C][C][NQ]
  static constexpr int IN = kC * ROW;
  static constexpr int R = 0, K = IN, V = 2 * IN, W = 3 * IN, DY = 4 * IN;
  static constexpr int SI = 5 * IN;
  static constexpr int GO = SI + HD * ROW;
  static constexpr int X = GO + HD * ROW;
  static constexpr int Y = X + kC * P_ROW;
  static constexpr int Z = Y + kC * P_ROW;
  static constexpr int KQ = Z + kC * P_ROW;
  static constexpr int B2 = KQ + 2 * kC * KQ_ROW;
  static constexpr int AM = B2 + kC * B_ROW;
  static constexpr int CR = AM + kC * B_ROW;
  static constexpr int U = CR + HD;
  static constexpr int DW = U + HD;
  static constexpr int AP = DW + 2 * kC * HD;
  static constexpr int SMEM = (AP + kC * kC * NQ) * 4;
  static_assert(SI % 4 == 0 && KQ % 4 == 0 && DW % 4 == 0, "16-byte rows");
  static_assert(NT == kC * NQ, "one (step, quad) a thread");
};

// One block per (batch, head, chunk).  du_part: (B, H, chunks, hd), each
// block's du over its steps.
template <int HD>
__global__ void __launch_bounds__(ChunkGeo<HD>::NT, 2) rwkv6_bwd_chunk_kernel(
    const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ u, const float* __restrict__ dy,
    const float* __restrict__ s_in, const float* __restrict__ g_out,
    float* __restrict__ dr, float* __restrict__ dk, float* __restrict__ dv,
    float* __restrict__ dw, float* __restrict__ du_part, int steps, int H) {
  using Gm = ChunkGeo<HD>;
  constexpr int NT = Gm::NT, ROW = Gm::ROW, NQ = Gm::NQ, PR = Gm::P_ROW;
  constexpr int BR = Gm::B_ROW;
  extern __shared__ __align__(16) float sm[];
  const float *s_r = sm + Gm::R, *s_k = sm + Gm::K, *s_v = sm + Gm::V;
  const float *s_dy = sm + Gm::DY, *s_si = sm + Gm::SI, *s_go = sm + Gm::GO;
  float* s_w = sm + Gm::W;
  float* s_b2 = sm + Gm::B2;
  uint2* s_kq = reinterpret_cast<uint2*>(sm + Gm::KQ);

  const int chunks = (steps + kC - 1) / kC;
  const int ch = blockIdx.x % chunks, bh = blockIdx.x / chunks;
  const int b = bh / H, h = bh - b * H;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int c0 = ch * kC, nv = min(kC, steps - c0);
  const long long t_stride = (long long)H * HD;
  const long long row0 = ((long long)(b * (long long)steps + c0) * H + h) * HD;
  const long long st_at = ((long long)bh * chunks + ch) * HD * HD;

  // ---- the chunk's r, k, v, w, dy (steps past the end as zeros), S_in,
  // G_out and u
  {
    constexpr int V4 = HD / 4;
    for (int a = tid; a < 5 * kC * V4; a += NT) {
      const int m = a / (kC * V4), rem = a - m * (kC * V4);
      const int s = rem / V4, c4 = rem - s * V4;
      const float* src = m == 0 ? r : m == 1 ? k : m == 2 ? v : m == 3 ? w : dy;
      const bool ok = s < nv;
      sm90::cp_async16(sm + m * Gm::IN + s * ROW + 4 * c4,
                       src + row0 + (ok ? s : 0) * t_stride + 4 * c4, ok);
    }
    for (int a = tid; a < 2 * HD * V4; a += NT) {
      const int m = a / (HD * V4), rem = a - m * (HD * V4);
      const int i = rem / V4, c4 = rem - i * V4;
      sm90::cp_async16(sm + Gm::SI + m * HD * ROW + i * ROW + 4 * c4,
                       (m ? g_out : s_in) + st_at + i * HD + 4 * c4, true);
    }
    sm90::cp_async_commit();
    for (int a = tid; a < HD; a += NT) sm[Gm::U + a] = u[h * HD + a];
    sm90::cp_async_wait<0>();
    __syncthreads();
    if (nv < kC) {  // a ragged chunk's missing steps decay by 1
      for (int a = tid; a < (kC - nv) * HD; a += NT)
        s_w[(nv + a / HD) * ROW + a % HD] = 1.f;
      __syncthreads();
    }
  }

  const bool products = tid < 2 * HD;
  // ---- phase 1
  if (products) {
    // X = dy S_in^T (warps [0, HD/32)) or Y = v G_out^T (the next HD/32),
    // [t][i]; a warp 4 n-tiles (32 channels), K = hd
    constexpr int XW = HD / 32;
    const int xy = wid / XW, nt0 = 4 * (wid % XW);
    const float* sa = xy ? s_v : s_dy;
    const float* sb = xy ? s_go : s_si;
    float acc[4][4] = {};
#pragma unroll
    for (int ks = 0; ks < HD / 8; ++ks) {
      sm90::Frag<4> a;  // A[t][j]
      a.x[0] = sa[g * ROW + 8 * ks + q];
      a.x[1] = sa[(g + 8) * ROW + 8 * ks + q];
      a.x[2] = sa[g * ROW + 8 * ks + q + 4];
      a.x[3] = sa[(g + 8) * ROW + 8 * ks + q + 4];
      a.split();
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        sm90::Frag<2> bb;  // B[j][i] = S[i][j]
        const float* p = sb + (8 * (nt0 + n) + g) * ROW + 8 * ks + q;
        bb.x[0] = p[0];
        bb.x[1] = p[4];
        bb.split();
        mma(acc[n], a, bb);
      }
    }
    float* out = sm + (xy ? Gm::Y : Gm::X);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int i = 8 * (nt0 + n) + 2 * q;
      *reinterpret_cast<float2*>(out + g * PR + i) =
          make_float2(acc[n][0], acc[n][1]);
      *reinterpret_cast<float2*>(out + (g + 8) * PR + i) =
          make_float2(acc[n][2], acc[n][3]);
    }
  } else {
    const int rt = tid - 2 * HD;
    if (rt < HD) {
      // k * Q for Z, channel rt, Q walked back from the chunk's end
      float d = 1.f;
#pragma unroll
      for (int s = kC - 1; s >= 0; --s) {
        sm90::store_split(s_kq + s * Gm::KQ_ROW + rt, s_k[s * ROW + rt] * d);
        d *= s_w[s * ROW + rt];
      }
    } else {
      // G_out . S_in of row i, the columns rotated by the row so that the
      // lanes' loads are conflict-free
      const int i = rt - HD;
      float acc = 0.f;
      for (int jj = 0; jj < HD; ++jj) {
        const int j = (jj + i) & (HD - 1);
        acc += s_go[i * ROW + j] * s_si[i * ROW + j];
      }
      sm[Gm::CR + i] = acc;
    }
    // B2[s][t] = dy_s . v_t, the C x C entries over the group
    for (int e = rt; e < kC * kC; e += 2 * HD) {
      const int s = e / kC, t = e % kC;
      float acc = 0.f;
#pragma unroll 4
      for (int c = 0; c < HD; c += 4) {
        const float4 a = *reinterpret_cast<const float4*>(s_dy + s * ROW + c);
        const float4 bb = *reinterpret_cast<const float4*>(s_v + t * ROW + c);
        acc += a.x * bb.x + a.y * bb.y + a.z * bb.z + a.w * bb.w;
      }
      s_b2[s * BR + t] = acc;
    }
  }
  __syncthreads();

  // ---- phase 2
  if (products) {
    {
      // Z = (k * Q) G_out, [t][j]; warp wid the columns [16 wid, +16).  The
      // k step takes its index k = q, q+4 from the channels 2q, 2q+1 (a
      // permutation of the sum), so that the loads are conflict-free
      float acc[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < HD / 8; ++ks) {
        sm90::Frag<4> a;  // A[t][i] = (k * Q)[t][i]
        const uint4 lo = *reinterpret_cast<const uint4*>(
            s_kq + g * Gm::KQ_ROW + 8 * ks + 2 * q);
        const uint4 hi = *reinterpret_cast<const uint4*>(
            s_kq + (g + 8) * Gm::KQ_ROW + 8 * ks + 2 * q);
        a.hi[0] = lo.x, a.lo[0] = lo.y, a.hi[2] = lo.z, a.lo[2] = lo.w;
        a.hi[1] = hi.x, a.lo[1] = hi.y, a.hi[3] = hi.z, a.lo[3] = hi.w;
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          sm90::Frag<2> bb;  // B[i][j] = G_out[i][j]
          const float* p = s_go + (8 * ks + 2 * q) * ROW + 16 * wid + 8 * n + g;
          bb.x[0] = p[0];
          bb.x[1] = p[ROW];
          bb.split();
          mma(acc[n], a, bb);
        }
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int j = 16 * wid + 8 * n + 2 * q;
        *reinterpret_cast<float2*>(sm + Gm::Z + g * PR + j) =
            make_float2(acc[n][0], acc[n][1]);
        *reinterpret_cast<float2*>(sm + Gm::Z + (g + 8) * PR + j) =
            make_float2(acc[n][2], acc[n][3]);
      }
    }
    {
      // the pair matrix A's partial sums over channel quad cq: thread (cq,
      // p) owns the key steps p and 15 - p (15 pairs (s, t) between them,
      // every thread the same), A[s][t] for s > t with the running product
      // D(t, s), and the two diagonals
      const int cq = tid % NQ, p = tid / NQ, c = 4 * cq, p2 = kC - 1 - p;
      float* ap = sm + Gm::AP + cq;
      const float4 uu = *reinterpret_cast<const float4*>(sm + Gm::U + c);
      float kd[4];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int t = x ? p2 : p;
        const float4 rr = *reinterpret_cast<const float4*>(s_r + t * ROW + c);
        const float4 kk = *reinterpret_cast<const float4*>(s_k + t * ROW + c);
        ap[(t * kC + t) * NQ] = rr.x * uu.x * kk.x + rr.y * uu.y * kk.y +
                                rr.z * uu.z * kk.z + rr.w * uu.w * kk.w;
        if (x == 0) kd[0] = kk.x, kd[1] = kk.y, kd[2] = kk.z, kd[3] = kk.w;
      }
      for (int n = 0; n < kC - 1; ++n) {
        // pairs n < 15 - p: t = p, s = p + 1 + n; then t = 15 - p, s = n + 1
        const bool second = n >= kC - 1 - p;
        if (n == kC - 1 - p) {
          const float4 kk = *reinterpret_cast<const float4*>(s_k + p2 * ROW + c);
          kd[0] = kk.x, kd[1] = kk.y, kd[2] = kk.z, kd[3] = kk.w;
        }
        const int t = second ? p2 : p, s = second ? n + 1 : p + 1 + n;
        const float4 rs = *reinterpret_cast<const float4*>(s_r + s * ROW + c);
        const float4 ws = *reinterpret_cast<const float4*>(s_w + s * ROW + c);
        ap[(s * kC + t) * NQ] =
            rs.x * kd[0] + rs.y * kd[1] + rs.z * kd[2] + rs.w * kd[3];
        kd[0] *= ws.x, kd[1] *= ws.y, kd[2] *= ws.z, kd[3] *= ws.w;
      }
    }
  } else if (tid < 3 * HD) {
    // channel i walked forward: the dr pair sums V_t[s] = sum_{s'<t}
    // D(s',t) k_s' B2[s][s'] (V_t[t] is dr's), L_t, and dw's
    // Q_t (P_t (G_out . S_in) + L_t)
    const int i = tid - 2 * HD;
    float ww[kC], kk[kC], qq[kC], vs[kC];
#pragma unroll
    for (int t = 0; t < kC; ++t) {
      ww[t] = s_w[t * ROW + i];
      kk[t] = s_k[t * ROW + i];
      vs[t] = 0.f;
    }
    float d = 1.f;
#pragma unroll
    for (int t = kC - 1; t >= 0; --t) {
      qq[t] = d;
      d *= ww[t];
    }
    const float cr = sm[Gm::CR + i], ui = sm[Gm::U + i];
    float L = 0.f, pd = 1.f;
#pragma unroll
    for (int t = 0; t < kC; ++t) {
      const float bonus = s_b2[t * BR + t];
      const float drt = pd * sm[Gm::X + t * PR + i] + vs[t] + ui * kk[t] * bonus;
      if (t < nv) dr[row0 + t * t_stride + i] = drt;
      sm[Gm::DW + t * HD + i] = qq[t] * (pd * cr + L);
      L = ww[t] * L + kk[t] * sm[Gm::Y + t * PR + i];
#pragma unroll
      for (int s = t + 1; s < kC; ++s)
        vs[s] = ww[t] * vs[s] + kk[t] * s_b2[s * BR + t];
      pd *= ww[t];
    }
  } else {
    // channel i walked back: the dk pair sums U_t[s] = sum_{s'>t} D(t,s')
    // r_s' B2[s'][s] (U_t[t] is dk's), R_t, the cross term sum_{s<t}
    // D(s,t) k_s U_t[s], dw's P_t R_t + cross, and du's partial
    const int i = tid - 3 * HD;
    float ww[kC], kk[kC], rr[kC], pp[kC], us[kC];
#pragma unroll
    for (int t = 0; t < kC; ++t) {
      ww[t] = s_w[t * ROW + i];
      kk[t] = s_k[t * ROW + i];
      rr[t] = s_r[t * ROW + i];
      us[t] = 0.f;
    }
    float d = 1.f;
#pragma unroll
    for (int t = 0; t < kC; ++t) {
      pp[t] = d;
      d *= ww[t];
    }
    const float ui = sm[Gm::U + i];
    float R = 0.f, qd = 1.f, du = 0.f;
#pragma unroll
    for (int t = kC - 1; t >= 0; --t) {
      const float bonus = s_b2[t * BR + t];
      const float dkt = qd * sm[Gm::Y + t * PR + i] + us[t] + rr[t] * ui * bonus;
      if (t < nv) dk[row0 + t * t_stride + i] = dkt;
      float cross = 0.f, dd = 1.f;
#pragma unroll
      for (int s = t - 1; s >= 0; --s) {
        cross += dd * kk[s] * us[s];
        dd *= ww[s];
      }
      sm[Gm::DW + (kC + t) * HD + i] = pp[t] * R + cross;
      du += rr[t] * kk[t] * bonus;
      R = ww[t] * R + rr[t] * sm[Gm::X + t * PR + i];
#pragma unroll
      for (int s = 0; s < t; ++s)
        us[s] = ww[t] * us[s] + rr[t] * s_b2[t * BR + s];
      qd *= ww[t];
    }
    du_part[((long long)bh * chunks + ch) * HD + i] = du;
  }
  __syncthreads();

  // ---- phase 3: A summed over the quads; dw; then dv
  for (int e = tid; e < kC * kC; e += NT) {
    const int s = e / kC, t = e % kC;
    if (s >= t) {
      float acc = 0.f;
      for (int x = 0; x < NQ; ++x) acc += sm[Gm::AP + e * NQ + x];
      sm[Gm::AM + s * BR + t] = acc;
    }
  }
  const int t = tid / NQ, c = 4 * (tid % NQ);
  const long long o = row0 + t * t_stride + c;
  if (t < nv) {
    const float4 f = *reinterpret_cast<const float4*>(sm + Gm::DW + t * HD + c);
    const float4 bk =
        *reinterpret_cast<const float4*>(sm + Gm::DW + (kC + t) * HD + c);
    *reinterpret_cast<float4*>(dw + o) =
        make_float4(f.x + bk.x, f.y + bk.y, f.z + bk.z, f.w + bk.w);
  }
  __syncthreads();
  if (t < nv) {
    float4 acc = *reinterpret_cast<const float4*>(sm + Gm::Z + t * PR + c);
    for (int s = t; s < nv; ++s) {
      const float a = sm[Gm::AM + s * BR + t];
      const float4 y = *reinterpret_cast<const float4*>(s_dy + s * ROW + c);
      acc.x += a * y.x, acc.y += a * y.y, acc.z += a * y.z, acc.w += a * y.w;
    }
    *reinterpret_cast<float4*>(dv + o) = acc;
  }
}

// ---- launch 3: du ----------------------------------------------------------

constexpr int kDuThreads = 1024;

// du[h] = the sum of du_part[b][h][chunk] over (batch, chunk): one block a
// head, thread (part, channel) a strided share of the (batch, chunk)
// pairs in four running sums (four loads in flight), the shares added in
// part order; a fixed order throughout
__global__ void __launch_bounds__(kDuThreads) rwkv6_bwd_du_kernel(
    const float* __restrict__ du_part, int B, int chunks, int H, int hd,
    float* __restrict__ du) {
  __shared__ float red[kDuThreads];
  const int h = blockIdx.x, parts = kDuThreads / hd, n_all = B * chunks;
  const int i = threadIdx.x % hd, part = threadIdx.x / hd;
  auto at = [&](int n) {
    const int bb = n / chunks, c = n - bb * chunks;
    return du_part[(((long long)bb * H + h) * chunks + c) * hd + i];
  };
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  int n = part;
  for (; n + 3 * parts < n_all; n += 4 * parts) {
    a0 += at(n);
    a1 += at(n + parts);
    a2 += at(n + 2 * parts);
    a3 += at(n + 3 * parts);
  }
  for (; n < n_all; n += parts) a0 += at(n);
  red[threadIdx.x] = (a0 + a1) + (a2 + a3);
  __syncthreads();
  if (part == 0) {
    float s = 0.f;
    for (int x = 0; x < parts; ++x) s += red[x * hd + i];
    du[h * hd + i] = s;
  }
}

template <typename K>
int set_smem(K kernel, int bytes, int* configured) {
  if (*configured < 0)
    *configured = static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
  return *configured;
}

template <int HD>
int launch_bwd(const float* r, const float* k, const float* v, const float* w,
               const float* u, const float* state_in, const float* dy,
               const float* dstate_final, float* dr, float* dk, float* dv,
               float* dw, float* du, float* dstate0, float* ws,
               float* du_part, int B, int steps, int H, cudaStream_t stream) {
  using Wg = WalkGeo<HD>;
  using Cg = ChunkGeo<HD>;
  static int walk_ok = -1, chunk_ok = -1;  // cudaFuncSetAttribute, once
  int rc = set_smem(rwkv6_bwd_walk_kernel<HD>, Wg::SMEM, &walk_ok);
  if (rc == 0) rc = set_smem(rwkv6_bwd_chunk_kernel<HD>, Cg::SMEM, &chunk_ok);
  if (rc != 0) return rc;
  const int chunks = (steps + kC - 1) / kC;
  float* s_in = ws;
  float* g_out = ws + (long long)B * H * chunks * HD * HD;
  rwkv6_bwd_walk_kernel<HD><<<B * H * Wg::NS * 2, Wg::NT, Wg::SMEM, stream>>>(
      r, k, v, w, dy, state_in, dstate_final, s_in, g_out, dstate0, steps, H);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  rwkv6_bwd_chunk_kernel<HD><<<B * H * chunks, Cg::NT, Cg::SMEM, stream>>>(
      r, k, v, w, u, dy, s_in, g_out, dr, dk, dv, dw, du_part, steps, H);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  rwkv6_bwd_du_kernel<<<H, kDuThreads, 0, stream>>>(du_part, B, chunks, H, HD,
                                                    du);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bwd

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

// the contiguous (B, T, H, hd) tensor at `ptr` as a 4-D map (innermost
// first), boxes of `cols` channels x `rows` steps of one head, no swizzle;
// steps past T are filled with zeros
bool make_map(CUtensorMap* map, const void* ptr, CUtensorMapDataType type,
              int elt, int B, int T, int H, int hd, int cols, int rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)H, (cuuint64_t)T,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * elt,
                                 (cuuint64_t)H * hd * elt,
                                 (cuuint64_t)T * H * hd * elt};
  const cuuint32_t box[4] = {(cuuint32_t)cols, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, type, 4, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int HD>
int launch(const void* r, const void* k, const void* v, const void* w,
           const float* u, const float* state_in, float* state_out, void* y,
           int B, int steps, int H, cudaStream_t stream) {
  using Gm = Geo<T, HD>;
  const T* rt = static_cast<const T*>(r);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* wt = static_cast<const T*>(w);
  T* yt = static_cast<T*>(y);
  if (steps == 1) {
    rwkv6_step_kernel<T, HD><<<B * H, HD * HD / 16, 0, stream>>>(
        rt, kt, vt, wt, u, state_in, state_out, yt, H);
    return static_cast<int>(cudaGetLastError());
  }
  constexpr CUtensorMapDataType type = sizeof(T) == 4
                                          ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                          : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap r_map, k_map, v_map, w_map;
  if (!make_map(&r_map, r, type, sizeof(T), B, steps, H, HD, Gm::KC, Gm::C) ||
      !make_map(&k_map, k, type, sizeof(T), B, steps, H, HD, Gm::KC, Gm::C) ||
      !make_map(&w_map, w, type, sizeof(T), B, steps, H, HD, Gm::KC, Gm::C) ||
      !make_map(&v_map, v, type, sizeof(T), B, steps, H, HD, HD, Gm::C))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = rwkv6_chunked_kernel<T, HD>;
  static int configured = -1;  // cudaFuncSetAttribute's result, once
  if (configured < 0)
    configured = static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Gm::SMEM));
  if (configured != 0) return configured;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * H * Gm::NB);
  cfg.blockDim = dim3(Gm::NT);
  cfg.dynamicSmemBytes = Gm::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = Gm::NB;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t rc =
      cudaLaunchKernelEx(&cfg, kernel, r_map, k_map, v_map, w_map, u,
                         state_in, state_out, yt, steps, H);
  if (rc != cudaSuccess) return static_cast<int>(rc);
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

template <typename T, int HD>
int attributes(int steps, int* out) {
  cudaFuncAttributes attr;
  const int rc = static_cast<int>(
      steps == 1 ? cudaFuncGetAttributes(&attr, rwkv6_step_kernel<T, HD>)
                 : cudaFuncGetAttributes(&attr, rwkv6_chunked_kernel<T, HD>));
  if (rc != 0) return rc;
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.sharedSizeBytes);
  out[2] = static_cast<int>(attr.localSizeBytes);
  out[3] = steps == 1 ? 0 : Geo<T, HD>::SMEM;
  return 0;
}

}  // namespace

// Plain C entry point, loaded with ctypes.  dtype: 0 float32, 1 bfloat16
// (r, k, v, w and y share it); u, state_in and state_out are float32;
// state_in / state_out may be null; every pointer 16-byte aligned.  One
// step (steps == 1) runs the step kernel, more the chunked one.  Returns
// cudaGetLastError() after the launch (0 on success).
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

// What the compiler gave the kernel a call of (dtype, hd, steps) launches:
// registers a thread, static shared bytes, local (stack and spill) bytes,
// dynamic shared bytes.
extern "C" int repro_rwkv6_scan_attributes(int dtype, int hd, int steps,
                                           int* out) {
  if (dtype == 0 && hd == 32) return attributes<float, 32>(steps, out);
  if (dtype == 0 && hd == 64) return attributes<float, 64>(steps, out);
  if (dtype == 1 && hd == 32) return attributes<__nv_bfloat16, 32>(steps, out);
  if (dtype == 1 && hd == 64) return attributes<__nv_bfloat16, 64>(steps, out);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The backward, float32: the grads of r, k, v, w (B, T, H, hd), u (H, hd)
// and, when dstate0 is not null, of the initial state (B, H, hd, hd), for
// the upstream grads dy (B, T, H, hd) and dstate_final (the final state's;
// null: zero).  state_in null: a zero initial state.  Workspaces, float32
// and written before they are read: ws (2, B, H, ceil(T / 16), hd, hd),
// the state entering and the adjoint leaving each 16-step chunk; du_part
// (B, H, ceil(T / 16), hd), each chunk's du.  Three launches (the chunk
// walks, every chunk's grads, du); returns cudaGetLastError() after them
// (0 on success).
extern "C" int repro_rwkv6_scan_bwd(
    const void* r, const void* k, const void* v, const void* w, const void* u,
    const void* state_in, const void* dy, const void* dstate_final, void* dr,
    void* dk, void* dv, void* dw, void* du, void* dstate0, void* ws,
    void* du_part, int B, int steps, int H, int hd, void* stream) {
  if (B <= 0 || steps <= 0 || H <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto m = [](void* p) { return static_cast<float*>(p); };
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:
      return bwd::launch_bwd<32>(f(r), f(k), f(v), f(w), f(u), f(state_in),
                                 f(dy), f(dstate_final), m(dr), m(dk), m(dv),
                                 m(dw), m(du), m(dstate0), m(ws), m(du_part),
                                 B, steps, H, st);
    case 64:
      return bwd::launch_bwd<64>(f(r), f(k), f(v), f(w), f(u), f(state_in),
                                 f(dy), f(dstate_final), m(dr), m(dk), m(dv),
                                 m(dw), m(du), m(dstate0), m(ws), m(du_part),
                                 B, steps, H, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

namespace {
template <typename K>
int bwd_attributes(K kernel, int smem, int* out) {
  cudaFuncAttributes attr;
  const int rc = static_cast<int>(cudaFuncGetAttributes(&attr, kernel));
  if (rc != 0) return rc;
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.sharedSizeBytes);
  out[2] = static_cast<int>(attr.localSizeBytes);
  out[3] = smem;
  return 0;
}
}  // namespace

// What the compiler gave launch `which` of the backward at head dim hd (0
// the chunk walks, 1 the chunks' grads, 2 du), as
// repro_rwkv6_scan_attributes reports the forward's.
extern "C" int repro_rwkv6_scan_bwd_attributes(int hd, int which, int* out) {
  if (which == 2) return bwd_attributes(bwd::rwkv6_bwd_du_kernel, 0, out);
  if (hd == 32 && which == 0)
    return bwd_attributes(bwd::rwkv6_bwd_walk_kernel<32>,
                          bwd::WalkGeo<32>::SMEM, out);
  if (hd == 64 && which == 0)
    return bwd_attributes(bwd::rwkv6_bwd_walk_kernel<64>,
                          bwd::WalkGeo<64>::SMEM, out);
  if (hd == 32 && which == 1)
    return bwd_attributes(bwd::rwkv6_bwd_chunk_kernel<32>,
                          bwd::ChunkGeo<32>::SMEM, out);
  if (hd == 64 && which == 1)
    return bwd_attributes(bwd::rwkv6_bwd_chunk_kernel<64>,
                          bwd::ChunkGeo<64>::SMEM, out);
  return static_cast<int>(cudaErrorInvalidValue);
}
