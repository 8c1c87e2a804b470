// Selective-scan (Mamba) recurrence for Hopper (sm_90a): the state-space
// half of every hybrid (hymba) layer, in prefill (T = prompt length), in
// decode (T = 1) and in training (forward, then the backward below).
//
// Replaces no TPU kernel: the reference computes the recurrence as a
// lax.scan over time (repro/models/ssm.py `_mamba_core`, the scan at
// :72), and XLA differentiates that scan.  Run eagerly on the card, that
// scan is T dependent steps of small elementwise launches in every layer.
// Per (batch b, channel d, state s), with A the (negative) state matrix:
//
//   h_t[d,s] = exp(dt_t[d] A[d,s]) h_{t-1}[d,s] + dt_t[d] B_t[s] u_t[d]
//   y_t[d]   = sum_s h_t[d,s] C_t[s]
//
// all in float32, from an optional carried state, writing the final state
// when asked (the model carries it from prefill into decode).
//
// What bounds it on the H100: at hymba-1.5b's prefill shape (B=4, T=2048,
// DI=3200, S=16) the call must read u and dt and write y (3 x 105 MB, f32),
// read B and C (1 MB) and the states (1.6 MB): ~317 MB, 0.095 ms at
// 3.35 TB/s, against ~3.4e9 operations (0.02 ms at the f32 rate).  So
// bytes bound it, but step t needs the state of step t - 1: a channel is a
// serial chain of T steps, and one thread a (b, d) channel gives only
// B*DI = 12,800 threads for 132 SMs.
//
// What this design does about it (the forward):
//   * a channel's 16 states are spread over 8 lanes of a warp, two states
//     a lane, each its own chain: 102,400 threads at the prefill shape, a
//     block 16 channels x 8 lanes, every block resident at once (at most
//     40 registers a thread, 12 blocks an SM);
//   * the sequence is staged through shared memory 16 steps at a time (u
//     and dt rows of the block's 16 channels, B and C rows of the batch),
//     by cp.async into two buffers, so the next chunk's loads are in
//     flight while a chunk runs: a staging that waits on its loads leaves
//     a block idle for the memory latency every chunk, and the other
//     blocks of its SM do not cover it.  y is staged back and written a
//     row of 16 channels at a time;
//   * the step is a handful of instructions: the full chunk runs unrolled
//     with no bound check; exp(dt A) is one multiply by A log2(e) and the
//     hardware exp2 (a decay below 2^-126 is flushed to 0, which changes h
//     by less than 2^-126 of its size); each lane leaves its two states'
//     share of y_t in shared memory, and after the chunk lane q adds up
//     steps q and q + 8 of its channel (one store a step and one load a
//     step amortized, where a butterfly of shuffles takes three of each);
//   * no decay is divided or logged: exp(dt A) may underflow to exactly 0
//     (A down to -16, dt up to softplus's range), and the backward keeps
//     the states instead of walking them back (below).
//
// The backward (training): the grads of u, dt, B, C, A and, with a carried
// state, of the initial state, for dy and an optional final-state grad.
// With a_t = exp(dt_t A) and g_t the adjoint of h_t:
//
//   g_t      = C_t dy_t[d] + a_{t+1} g_{t+1}      (g after the last step:
//                                                  the final-state grad)
//   du_t[d]  = sum_s g_t dt_t B_t[s]
//   ddt_t[d] = sum_s g_t (B_t[s] u_t[d] + h_{t-1} a_t A)
//   dB_t[s]  = sum_d g_t dt_t u_t,   dC_t[s] = sum_d h_t dy_t[d]
//   dA[d,s]  = sum_{b,t} g_t h_{t-1} a_t dt_t,   dstate0 = a_0 g_0
//
// Two launches: selective_scan_bwd_kernel, one thread a (b, d, s) (a block
// 16 channels x 16 states, synchronous staging: the simple form), walks
// the sequence forward and keeps the state entering every kBwdChunk steps
// (a workspace), then walks it back a chunk at a time, recomputing the
// chunk's states from its boundary into registers; du and ddt sum over s
// by xor-shuffles, dB and dC over the block's 16 channels (a shuffle, then
// the 8 warps' values in order in shared memory), each block writing its
// partial sums of dB and dC and each (b, d, s) its dA term to workspaces.
// selective_scan_bwd_reduce_kernel adds the partials over the channel
// blocks (dB, dC) and over the batch (dA) in a fixed order.  No float
// atomics: two calls on the same inputs give the same bits.

#include <cuda_runtime.h>

#include <cstddef>

#include "sm90.cuh"

namespace {

constexpr int kS = 16;               // states a channel (STATE_DIMS)
constexpr int kCh = 16;              // backward channels a block
constexpr int kThreads = kS * kCh;   // backward threads a block, 256
constexpr int kWarps = kThreads / 32;
constexpr int kFwdLanes = 8;         // forward lanes a channel, 2 states each
constexpr int kFwdCh = 16;           // forward channels a block
constexpr int kFwdThreads = kFwdLanes * kFwdCh;  // 128
constexpr int kFwdBlocks = 12;       // forward blocks an SM (<= 40 registers)
constexpr int kFwdChunk = 16;        // steps the forward stages at once
constexpr int kFwdPartStride = kFwdCh * kFwdLanes + 1;  // a step's, padded
constexpr int kBwdChunk = 16;        // steps a backward chunk (SSM_BWD_CHUNK)
constexpr int kReduceThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float sum_states(float x) {
  // lanes s of one channel are 16 consecutive lanes of the warp
  x += __shfl_xor_sync(0xffffffffu, x, 8);
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x;
}

// Stage rows [t0, t0 + n) of a (B, T, width) tensor's columns [c0, c0 +
// cols) for batch b into dst (rows x cols), zero past n or width.
template <int Rows, int Cols>
__device__ __forceinline__ void stage(float (*dst)[Cols],
                                      const float* __restrict__ src, int b,
                                      int T, int width, int t0, int n,
                                      int c0) {
  for (int i = threadIdx.x; i < Rows * Cols; i += kThreads) {
    const int r = i / Cols, c = i % Cols;
    const bool ok = r < n && c0 + c < width;
    dst[r][c] =
        ok ? src[(static_cast<size_t>(b) * T + t0 + r) * width + c0 + c] : 0.f;
  }
}

// 4 bytes from global to shared memory, asynchronously; a zero where
// !valid (the source is then not read)
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   sm90::smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// The forward's copies of one chunk, kFwdChunk rows of u and dt (the
// block's kFwdCh channels), B and C, into one of two buffers: kCopies
// elements of each a thread, at a fixed (row, column) of the chunk, u's
// and dt's at one offset, B's and C's at another (int: the wrapper holds
// (B T + 16) DI below 2^31).  The offsets advance a chunk at a time; past T or
// DI a zero is written and nothing read.
struct ChunkCopies {
  static constexpr int kCopies = kFwdChunk * kFwdCh / kFwdThreads;
  static_assert(kFwdCh == kS && kFwdChunk * kFwdCh % kFwdThreads == 0,
                "u, dt, B and C rows are equally wide");
  int off_ud[kCopies], off_bc[kCopies];
  bool in_d[kCopies];  // the column is a channel < DI

  __device__ __forceinline__ ChunkCopies(int b, int T, int DI, int d0) {
#pragma unroll
    for (int k = 0; k < kCopies; ++k) {
      const int i = threadIdx.x + k * kFwdThreads;
      const int r = i / kFwdCh, col = i % kFwdCh;
      off_ud[k] = (b * T + r) * DI + d0 + col;
      off_bc[k] = (b * T + r) * kS + col;
      in_d[k] = d0 + col < DI;
    }
  }

  // the copies of the chunk at t0 into buf (u, dt, B, C one after the
  // other, kFwdChunk x kFwdCh each), then advance
  __device__ __forceinline__ void copy_chunk(
      float* buf, const float* __restrict__ u, const float* __restrict__ dt,
      const float* __restrict__ Bm, const float* __restrict__ Cm, int t0,
      int T, int DI) {
    constexpr int kArray = kFwdChunk * kFwdCh;
#pragma unroll
    for (int k = 0; k < kCopies; ++k) {
      const int i = threadIdx.x + k * kFwdThreads;
      const bool in_t = t0 + i / kFwdCh < T, ok = in_t && in_d[k];
      cp_async4(buf + i, ok ? u + off_ud[k] : u, ok);
      cp_async4(buf + kArray + i, ok ? dt + off_ud[k] : dt, ok);
      cp_async4(buf + 2 * kArray + i, in_t ? Bm + off_bc[k] : Bm, in_t);
      cp_async4(buf + 3 * kArray + i, in_t ? Cm + off_bc[k] : Cm, in_t);
      off_ud[k] += kFwdChunk * DI;
      off_bc[k] += kFwdChunk * kS;
    }
  }
};

// Write rows [0, n) of src (rows x kCh) into a (B, T, DI) tensor at rows
// [t0, t0 + n) and channels [d0, d0 + kCh) of batch b.
__device__ __forceinline__ void unstage(float* __restrict__ dst,
                                        float (*src)[kCh], int b, int T,
                                        int DI, int t0, int n, int d0) {
  for (int i = threadIdx.x; i < n * kCh; i += kThreads) {
    const int r = i / kCh, c = i % kCh;
    if (d0 + c < DI)
      dst[(static_cast<size_t>(b) * T + t0 + r) * DI + d0 + c] = src[r][c];
  }
}

// grid (ceil(DI / kFwdCh), B), kFwdThreads threads; thread (c, q) =
// (threadIdx.x / kFwdLanes, threadIdx.x % kFwdLanes) owns channel d0 + c,
// states 2q and 2q + 1.  A chunk's inputs arrive by cp.async into one of
// two buffers while the chunk before runs from the other.  The chunk's 16
// steps run unrolled; each lane leaves its two states' share of y_t in
// shared memory, and after the chunk lane q adds up steps q and q + 8 of
// its channel over the 8 lanes (a transpose through shared memory: one
// store a step and one load a step amortized, where a butterfly of
// shuffles takes three of each).  The channel's 8 lanes are a quarter of
// a warp, so a warp barrier orders them.
__global__ void __launch_bounds__(kFwdThreads, kFwdBlocks)
selective_scan_fwd_kernel(const float* __restrict__ u,
                          const float* __restrict__ dt,
                          const float* __restrict__ Bm,
                          const float* __restrict__ Cm,
                          const float* __restrict__ A,
                          const float* __restrict__ h0,
                          float* __restrict__ hT, float* __restrict__ y,
                          int T, int DI) {
  static_assert(kFwdChunk == 2 * kFwdLanes, "a lane sums two steps");
  // [buffer][u, dt, B, C][step][column]
  __shared__ __align__(16) float stage_in[2][4][kFwdChunk * kFwdCh];
  __shared__ float sy[kFwdChunk][kFwdCh + 1];
  __shared__ float part[kFwdChunk * kFwdPartStride];  // [step][channel][lane]
  const int b = blockIdx.y, d0 = blockIdx.x * kFwdCh;
  const int c = threadIdx.x / kFwdLanes, q = threadIdx.x % kFwdLanes;
  const int d = d0 + c;
  const bool live = d < DI;
  const size_t sidx = (static_cast<size_t>(b) * DI + d) * kS + 2 * q;
  // exp(dt A) as exp2(dt A log2 e): one multiply and the hardware exp2
  const float2 a2 = live ? make_float2(A[d * kS + 2 * q] * kLog2e,
                                       A[d * kS + 2 * q + 1] * kLog2e)
                         : make_float2(0.f, 0.f);
  float2 h = (live && h0 != nullptr) ? make_float2(h0[sidx], h0[sidx + 1])
                                     : make_float2(0.f, 0.f);
  float* const mine = part + c * kFwdLanes + q;  // this lane's share
  const int chunks = (T + kFwdChunk - 1) / kFwdChunk;
  ChunkCopies copies(b, T, DI, d0);
  copies.copy_chunk(stage_in[0][0], u, dt, Bm, Cm, 0, T, DI);
  sm90::cp_async_commit();
  for (int k = 0; k < chunks; ++k) {
    const int t0 = k * kFwdChunk, n = min(kFwdChunk, T - t0);
    if (k + 1 < chunks)  // the next chunk, into the buffer read last chunk
      copies.copy_chunk(stage_in[(k + 1) & 1][0], u, dt, Bm, Cm,
                        t0 + kFwdChunk, T, DI);
    sm90::cp_async_commit();
    sm90::cp_async_wait<1>();  // this chunk's copies have landed
    __syncthreads();
    // this chunk's rows, the channel's u and dt, the lane's B and C pair
    const float* const cu = stage_in[k & 1][0] + c;
    const float* const cdt = stage_in[k & 1][1] + c;
    const float2* const cB =
        reinterpret_cast<const float2*>(stage_in[k & 1][2]) + q;
    const float2* const cC =
        reinterpret_cast<const float2*>(stage_in[k & 1][3]) + q;
    auto step = [&](int r) {
      const float dtv = cdt[r * kFwdCh], uv = cu[r * kFwdCh];
      const float2 Bv = cB[r * kS / 2], Cv = cC[r * kS / 2];
      h.x = sm90::exp2_approx(dtv * a2.x) * h.x + dtv * Bv.x * uv;
      h.y = sm90::exp2_approx(dtv * a2.y) * h.y + dtv * Bv.y * uv;
      mine[r * kFwdPartStride] = h.x * Cv.x + h.y * Cv.y;
    };
    if (n == kFwdChunk) {
#pragma unroll
      for (int r = 0; r < kFwdChunk; ++r) step(r);
    } else {
      for (int r = 0; r < n; ++r) step(r);
    }
    __syncwarp();
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = q + half * kFwdLanes;
      if (r < n) {
        const float* const row = part + r * kFwdPartStride + c * kFwdLanes;
        float yv = 0.f;
#pragma unroll
        for (int i = 0; i < kFwdLanes; ++i) yv += row[i];
        sy[r][c] = yv;
      }
    }
    __syncthreads();  // y complete, and both buffers' reads done
    for (int i = threadIdx.x; i < n * kFwdCh; i += kFwdThreads) {
      const int r = i / kFwdCh, col = i % kFwdCh;
      if (d0 + col < DI)
        y[(static_cast<size_t>(b) * T + t0 + r) * DI + d0 + col] = sy[r][col];
    }
  }
  if (live && hT != nullptr) {
    hT[sidx] = h.x;
    hT[sidx + 1] = h.y;
  }
}

// The backward's walks: grid (ceil(DI / kCh), B), kThreads threads; thread
// (c, s) = (threadIdx.x / kS, threadIdx.x % kS) owns channel d0 + c, state
// s.  Workspaces:
// hb (B, ceil(T / kBwdChunk), DI, kS), the state entering each chunk;
// partB, partC (gridDim.x, B, T, kS), each channel block's sums of dB and
// dC; dApart (B, DI, kS), each (b, d, s)'s dA over t.
__global__ void __launch_bounds__(kThreads)
selective_scan_bwd_kernel(const float* __restrict__ u,
                          const float* __restrict__ dt,
                          const float* __restrict__ Bm,
                          const float* __restrict__ Cm,
                          const float* __restrict__ A,
                          const float* __restrict__ h0,
                          const float* __restrict__ dy,
                          const float* __restrict__ dhT,
                          float* __restrict__ du, float* __restrict__ ddt,
                          float* __restrict__ dh0, float* __restrict__ hb,
                          float* __restrict__ partB,
                          float* __restrict__ partC,
                          float* __restrict__ dApart, int Bsz, int T,
                          int DI) {
  __shared__ float su[kBwdChunk][kCh], sdt[kBwdChunk][kCh];
  __shared__ float sdy[kBwdChunk][kCh];
  __shared__ float sB[kBwdChunk][kS], sC[kBwdChunk][kS];
  __shared__ float sdu[kBwdChunk][kCh], sddt[kBwdChunk][kCh];
  __shared__ float redB[kBwdChunk][kWarps][kS], redC[kBwdChunk][kWarps][kS];
  const int b = blockIdx.y, d0 = blockIdx.x * kCh;
  const int c = threadIdx.x / kS, s = threadIdx.x % kS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int d = d0 + c;
  const bool live = d < DI;
  const int chunks = (T + kBwdChunk - 1) / kBwdChunk;
  const size_t sidx = (static_cast<size_t>(b) * DI + d) * kS + s;
  const float a_ds = live ? A[d * kS + s] : 0.f;
  const float a2 = a_ds * kLog2e;  // exp(dt A) = exp2(dt a2), as forward
  auto boundary = [&](int ch) -> float& {
    return hb[((static_cast<size_t>(b) * chunks + ch) * DI + d) * kS + s];
  };

  // forward walk: the state entering every chunk
  float h = (live && h0 != nullptr) ? h0[sidx] : 0.f;
  for (int ch = 0; ch < chunks; ++ch) {
    const int t0 = ch * kBwdChunk, n = min(kBwdChunk, T - t0);
    if (live) boundary(ch) = h;
    __syncthreads();  // the previous chunk's reads of the stages are done
    stage<kBwdChunk, kCh>(su, u, b, T, DI, t0, n, d0);
    stage<kBwdChunk, kCh>(sdt, dt, b, T, DI, t0, n, d0);
    stage<kBwdChunk, kS>(sB, Bm, b, T, kS, t0, n, 0);
    __syncthreads();
    for (int r = 0; r < n; ++r) {
      const float dtv = sdt[r][c];
      h = exp2f(dtv * a2) * h + dtv * sB[r][s] * su[r][c];
    }
  }

  // backward walk, a chunk at a time from the last
  float carry = (live && dhT != nullptr) ? dhT[sidx] : 0.f;  // a_{t+1} g_{t+1}
  float dA_acc = 0.f;
  for (int ch = chunks - 1; ch >= 0; --ch) {
    const int t0 = ch * kBwdChunk, n = min(kBwdChunk, T - t0);
    __syncthreads();  // the previous chunk's reads of the stages are done
    stage<kBwdChunk, kCh>(su, u, b, T, DI, t0, n, d0);
    stage<kBwdChunk, kCh>(sdt, dt, b, T, DI, t0, n, d0);
    stage<kBwdChunk, kCh>(sdy, dy, b, T, DI, t0, n, d0);
    stage<kBwdChunk, kS>(sB, Bm, b, T, kS, t0, n, 0);
    stage<kBwdChunk, kS>(sC, Cm, b, T, kS, t0, n, 0);
    __syncthreads();
    float hs[kBwdChunk + 1];  // hs[0] = h_{t0-1}, hs[r + 1] = h_{t0+r}
    hs[0] = live ? boundary(ch) : 0.f;
#pragma unroll
    for (int r = 0; r < kBwdChunk; ++r) {
      if (r < n) {
        const float dtv = sdt[r][c];
        hs[r + 1] = exp2f(dtv * a2) * hs[r] + dtv * sB[r][s] * su[r][c];
      }
    }
#pragma unroll
    for (int r = kBwdChunk - 1; r >= 0; --r) {
      if (r < n) {
        const float dtv = sdt[r][c], uv = su[r][c], bv = sB[r][s];
        const float a = exp2f(dtv * a2);
        const float g = carry + sC[r][s] * sdy[r][c];
        const float da = g * hs[r] * a;  // d/d(dt A)
        const float du_t = sum_states(g * dtv * bv);
        const float ddt_t = sum_states(g * bv * uv + da * a_ds);
        if (s == 0) {
          sdu[r][c] = du_t;
          sddt[r][c] = ddt_t;
        }
        float gB = g * dtv * uv, gC = hs[r + 1] * sdy[r][c];
        gB += __shfl_xor_sync(0xffffffffu, gB, 16);  // the warp's 2 channels
        gC += __shfl_xor_sync(0xffffffffu, gC, 16);
        if (lane < kS) {
          redB[r][warp][lane] = gB;
          redC[r][warp][lane] = gC;
        }
        dA_acc += da * dtv;
        carry = a * g;
      }
    }
    __syncthreads();
    unstage(du, sdu, b, T, DI, t0, n, d0);
    unstage(ddt, sddt, b, T, DI, t0, n, d0);
    {  // this block's sums of dB and dC over its channels, warps in order
      const int r = threadIdx.x / kS, ss = threadIdx.x % kS;
      static_assert(kBwdChunk * kS == kThreads, "a thread a (step, state)");
      if (r < n) {
        float sb = 0.f, sc = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          sb += redB[r][w][ss];
          sc += redC[r][w][ss];
        }
        const size_t o =
            ((static_cast<size_t>(blockIdx.x) * Bsz + b) * T + t0 + r) * kS +
            ss;
        partB[o] = sb;
        partC[o] = sc;
      }
    }
  }
  if (live) {
    dApart[sidx] = dA_acc;
    if (dh0 != nullptr) dh0[sidx] = carry;
  }
}

// dB, dC (B, T, kS): the channel blocks' partials summed in block order;
// dA (DI, kS): the batch's partials summed in batch order.  One thread an
// output element.
__global__ void __launch_bounds__(kReduceThreads)
selective_scan_bwd_reduce_kernel(const float* __restrict__ partB,
                                 const float* __restrict__ partC,
                                 const float* __restrict__ dApart,
                                 float* __restrict__ dB,
                                 float* __restrict__ dC,
                                 float* __restrict__ dA, int blocks,
                                 int Bsz, int bts, int dis) {
  const int i = blockIdx.x * kReduceThreads + threadIdx.x;
  if (i < bts) {
    float sb = 0.f, sc = 0.f;
    for (int k = 0; k < blocks; ++k) {
      sb += partB[static_cast<size_t>(k) * bts + i];
      sc += partC[static_cast<size_t>(k) * bts + i];
    }
    dB[i] = sb;
    dC[i] = sc;
  } else if (i - bts < dis) {
    const int j = i - bts;
    float sa = 0.f;
    for (int b = 0; b < Bsz; ++b)
      sa += dApart[static_cast<size_t>(b) * dis + j];
    dA[j] = sa;
  }
}

template <typename K>
int attributes(K kernel, int* out) {
  cudaFuncAttributes attr;
  const int rc = static_cast<int>(cudaFuncGetAttributes(&attr, kernel));
  if (rc != 0) return rc;
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.sharedSizeBytes);
  out[2] = static_cast<int>(attr.localSizeBytes);
  out[3] = 0;
  return 0;
}

}  // namespace

// The forward, float32: u, dt (B, T, DI), Bm, Cm (B, T, S), A (DI, S) ->
// y (B, T, DI); state_in (B, DI, S) or null (zero); state_out (B, DI, S) or
// null (not written).  One launch; returns cudaGetLastError() after it (0
// on success).
extern "C" int repro_selective_scan(const void* u, const void* dt,
                                    const void* Bm, const void* Cm,
                                    const void* A, const void* state_in,
                                    void* state_out, void* y, int B, int T,
                                    int DI, int S, void* stream) {
  if (B <= 0 || T <= 0 || DI <= 0 || B > 65535 || S != kS)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((DI + kFwdCh - 1) / kFwdCh, B);
  selective_scan_fwd_kernel<<<grid, kFwdThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(u), static_cast<const float*>(dt),
      static_cast<const float*>(Bm), static_cast<const float*>(Cm),
      static_cast<const float*>(A), static_cast<const float*>(state_in),
      static_cast<float*>(state_out), static_cast<float*>(y), T, DI);
  return static_cast<int>(cudaGetLastError());
}

// The backward, float32: the grads du, ddt (B, T, DI), dB, dC (B, T, S),
// dA (DI, S) and, when dstate0 is not null, of the initial state (B, DI,
// S), for dy (B, T, DI) and dstate_final (the final state's; null: zero).
// state_in null: a zero initial state.  Workspaces, float32, written before
// they are read: hb (B, ceil(T / 16), DI, S); partB, partC (ceil(DI / 16),
// B, T, S); dApart (B, DI, S).  Two launches; returns cudaGetLastError()
// after them (0 on success).
extern "C" int repro_selective_scan_bwd(
    const void* u, const void* dt, const void* Bm, const void* Cm,
    const void* A, const void* state_in, const void* dy,
    const void* dstate_final, void* du, void* ddt, void* dB, void* dC,
    void* dA, void* dstate0, void* hb, void* partB, void* partC,
    void* dApart, int B, int T, int DI, int S, void* stream) {
  if (B <= 0 || T <= 0 || DI <= 0 || B > 65535 || S != kS)
    return static_cast<int>(cudaErrorInvalidValue);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto m = [](void* p) { return static_cast<float*>(p); };
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((DI + kCh - 1) / kCh, B);
  selective_scan_bwd_kernel<<<grid, kThreads, 0, st>>>(
      f(u), f(dt), f(Bm), f(Cm), f(A), f(state_in), f(dy), f(dstate_final),
      m(du), m(ddt), m(dstate0), m(hb), m(partB), m(partC), m(dApart), B, T,
      DI);
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  const int bts = B * T * kS, dis = DI * kS;
  const int total = bts + dis;
  selective_scan_bwd_reduce_kernel<<<(total + kReduceThreads - 1) /
                                         kReduceThreads,
                                     kReduceThreads, 0, st>>>(
      f(partB), f(partC), f(dApart), m(dB), m(dC), m(dA),
      static_cast<int>(grid.x), B, bts, dis);
  return static_cast<int>(cudaGetLastError());
}

// What the compiler gave kernel `which` (0 the forward, 1 the backward's
// walks, 2 its reduction): registers a thread, static shared bytes, local
// (stack and spill) bytes, dynamic shared bytes (none).
extern "C" int repro_selective_scan_attributes(int which, int* out) {
  if (which == 0) return attributes(selective_scan_fwd_kernel, out);
  if (which == 1) return attributes(selective_scan_bwd_kernel, out);
  if (which == 2) return attributes(selective_scan_bwd_reduce_kernel, out);
  return static_cast<int>(cudaErrorInvalidValue);
}
