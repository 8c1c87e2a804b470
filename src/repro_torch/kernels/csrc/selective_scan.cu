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
// 3.35 TB/s, against ~3.4e9 operations (0.05 ms at the f32 FFMA rate).
// But a (b, d, s) is a serial chain of T steps, and every (b, t, d, s)
// takes one exp (4.2e8 on the SMs' 16 MUFU lanes each: 0.11 ms) and about
// seven other instructions a lane.  On the card the staging alone (every
// input through shared memory, no arithmetic) takes 0.076 ms at that shape,
// and the walk, not the memory, sets the time: an SM's warps issue their
// steps' instructions and exps at near the rate the SM allows
// (chip_smoke.py phase 13; PERF.md §6).
//
// What this design does about it (the forward, T > 1):
//   * a channel's 16 states are spread over 4 lanes, four states a lane,
//     a block 32 channels (128 threads): u and dt rows of 128 bytes, one
//     shared-memory load of each a step for four states, B and C as one
//     float4 each a lane; a lane keeps its four states' share of y for a
//     whole stage, then three xor-shuffles a group of four steps fold the
//     four lanes' shares so that lane q stores step q's y (8 channels x 4
//     steps of a warp: whole 32-byte sectors).  A step is ~29 issued
//     instructions a warp and 4 exps; a stage's copies, its visit's chunk
//     and stage (counters, no division) and its stores add little;
//   * the sequence is staged through shared memory 32 steps a stage, in
//     kFwdStages stages, by 16-byte cp.async (4-byte copies where DI is
//     not a multiple of 4 or a base is off 16 bytes), kFwdStages - 1
//     stages in flight ahead of the step being walked; up to 128
//     registers a thread, 4 blocks an SM;
//   * segments in a cluster, as the backward: the sequence is cut into
//     `nseg` segments of L steps, one block each, a (batch, channel
//     block)'s segments one cluster (the last padded with dt = u = 0, so a
//     = 1 and the padding is the identity).  Segment 0 walks from the
//     carried state, writing y, and keeps its end state; segments 1 ..
//     nseg-2 meanwhile walk from a zero state and keep (hloc, Gamma =
//     exp(A sum dt)) at their end.  The blocks then hop through distributed
//     shared memory: block k reads segment 0's end state and the (Gamma,
//     hloc) of segments 1 .. k-1 and folds h_in = Gamma_j h_in + hloc_j in
//     segment order.  Segments 1 .. nseg-1 then walk again from h_in,
//     writing y; the last writes the final state.  The last segment has no
//     first walk (no one reads it), and segment 0 no second: (2 nseg - 2)
//     walks of L steps, against nseg for one block a (b, channel block),
//     on a path 2L steps long.  So segments pay only where the blocks of
//     one segment leave SMs idle: the wrapper takes 4 or 8 where the
//     segments' blocks still fit two an SM (a long sequence over few
//     channels: 3.7x faster at B=1, DI=128, T=4096), and one at hymba's
//     prefill, training and train_4k shapes, where more are slower;
//   * a segment of at most kFwdStages chunks (96 steps) stays in its
//     stages between the two walks, so its inputs cross HBM once; a longer
//     one reads them again for the second walk;
//   * exp(dt A) is one multiply by A log2(e) and the hardware exp2 (a decay
//     below 2^-126 is flushed to 0, which changes h by less than 2^-126 of
//     its size); no decay is divided or logged: exp(dt A) may underflow to
//     exactly 0 (A down to -16, dt up to softplus's range), and Gamma then
//     is 0.  Gamma is exp2(A log2(e) sum dt), one exp a state a segment;
//   * T = 1 (decode) runs selective_scan_step_kernel: a thread four states
//     of a (b, d), every input read directly with float4 loads (no
//     staging, no barrier), y folded by two xor-shuffles over the
//     channel's 4 lanes.
// No float atomics: two calls on the same inputs give the same bits.  The
// hop associates the state differently from a sequential walk, so the
// result is not one walk's bits; the tolerance against the plain
// recurrence is the contract.  Nothing limits T.
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
// What bounds it: at the training shape (B=2, T=256, DI=3200, S=16) the
// call must move ~36 MB (u, dt, dy in; du, ddt out), 0.011 ms at 3.35
// TB/s, against ~28 operations an element (b, t, d, s), 0.011 ms at the
// f32 rate; at the prefill shape (B=4, T=2048) the bytes, 0.175 ms.  Both
// walks are serial chains of T steps a (b, d, s), forward for h and
// backward for g, and each step's grads need both.
//
// What this design does about it: the recurrence is diagonal, so the
// sequence is cut into a power of two of segments, at most kSegs, of L
// steps (chosen by the wrapper: as many segments as keep four 16-step
// chunks each; the last padded with dt = u = dy = 0, B = C = 0, so a = 1
// and the padding is the identity) that run at once, one block each, the
// segments of a (batch, 16-channel block) one cluster.  Every
// (b, d, s) chain is a segment long, not 3T:
//   1. the local pass walks the segment forward once from a zero state:
//      its state hloc, its decay product Gamma = prod a_t (a running
//      product) and the adjoint it sends to the state entering it, gloc =
//      sum_t (prod_{tau<=t} a_tau) C_t dy_t (the same running product);
//      the (hloc, Gamma) entering each 16-step chunk are kept in shared
//      memory;
//   2. the hop, through distributed shared memory: block k reads the
//      (hloc, Gamma) of the segments before it and the (Gamma, gloc) of
//      those after it from their blocks, all at once, then h_in = Gamma_j
//      h_in + hloc_j from the carried state and g_out = Gamma_j g_out +
//      gloc_j from the final-state grad, in segment order;
//   3. the grad pass walks its chunks back from g_out, each chunk's states
//      recomputed into registers from hloc + Gamma h_in at its start,
//      writing du and ddt, the block's partial sums of dB and dC over its
//      16 channels and each chain's dA term; segment 0's last carry is
//      dstate0.
// The segment boundaries never leave the chip: the workspaces are the dB
// and dC partials (ceil(DI / 16) B T S floats each) and the dA terms (B
// segments DI S).  Nothing is divided and no logarithm is taken: an a_t
// that underflows to exactly 0 gives Gamma = 0 and exact grads.  The lanes
// are 8 a channel, 2 states each, at most 102 registers a
// thread so that 5 blocks share an SM.  A step's sums over a channel's
// states (du, ddt) and over a warp's 4 channels (dB, dC) are xor-shuffle
// folds, each level halving the values a lane carries (three shuffles for
// two or four values), left in shared memory; once a chunk they are added
// up over the lanes and warps and written.  Every chunk's inputs arrive
// by cp.async into one of two buffers while the chunk before runs.
// selective_scan_bwd_reduce_kernel adds the partials over the channel
// blocks (dB, dC) and over (batch, segment) (dA) in a fixed order.  No
// float atomics: two calls on the same inputs give the same bits.  The hop
// associates the state differently from a sequential walk, so the result
// is not the earlier kernel's bits; the tolerance against the plain
// reverse recurrence is the contract.

#include <cuda_runtime.h>

#include <cstddef>

#include "sm90.cuh"

namespace {

constexpr int kS = 16;               // states a channel (STATE_DIMS)
constexpr int kFwdLanes = 4;         // forward lanes a channel, 4 states each
constexpr int kFwdCh = 32;           // forward channels a block
constexpr int kFwdThreads = kFwdLanes * kFwdCh;  // 128
constexpr int kFwdBlocks = 4;        // forward blocks an SM (<= 128 registers)
constexpr int kFwdChunk = 32;        // steps a stage
constexpr int kFwdStages = 3;        // stages (kFwdStages - 1 in flight)
constexpr int kStepLanes = 4;        // T = 1: lanes a channel, 4 states each
constexpr int kStepThreads = 256;    // threads a block of the T = 1 kernel
constexpr int kCh = 16;              // backward channels a block (CHANNELS)
constexpr int kLanes = 8;            // backward lanes a channel, 2 states each
constexpr int kThreads = kCh * kLanes;  // backward threads a block, 128
constexpr int kWarps = kThreads / 32;
constexpr int kBwdBlocks = 5;        // backward blocks an SM (<= 102 registers)
constexpr int kBwdChunk = 16;        // steps a backward chunk (SSM_BWD_CHUNK)
constexpr int kSegs = 8;             // segments at most, a cluster (SEGMENTS)
constexpr int kMaxSegment = 1536;    // steps a segment at most (MAX_SEGMENT)
constexpr int kReduceThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

// 4 bytes from global to shared memory, asynchronously; a zero where
// !valid (the source is then not read)
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   sm90::smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// One stage of the forward: kFwdChunk rows of u and dt (the block's kFwdCh
// channels), of B and of C, in dynamic shared memory.
struct FwdStage {
  float u[kFwdChunk][kFwdCh];
  float dt[kFwdChunk][kFwdCh];
  float B[kFwdChunk][kS];
  float C[kFwdChunk][kS];
};
constexpr int kFwdSmem = kFwdStages * static_cast<int>(sizeof(FwdStage));

// The copies of the chunk at row t0 into `st`: with `vec`, 16 bytes a copy,
// else 4 bytes; every loop's trip count is fixed, so a thread's copies are
// a few instructions each.  Past T or DI a zero is written and nothing
// read.  int offsets: a row that is read lies inside its tensor, which the
// wrapper holds below 2^31 elements.
__device__ __forceinline__ void copy_fwd_chunk(
    FwdStage& st, const float* __restrict__ u, const float* __restrict__ dt,
    const float* __restrict__ Bm, const float* __restrict__ Cm, int b, int t0,
    int T, int d0, int DI, bool vec) {
  const int tid = threadIdx.x, rows = T - t0, row0 = b * T + t0;
  constexpr int kUV = kFwdChunk * kFwdCh, kBC = kFwdChunk * kS;
  static_assert(kUV % (4 * kFwdThreads) == 0 && kBC % (4 * kFwdThreads) == 0,
                "whole vectors a thread");
  if (vec) {  // a vector of 4 floats a copy
    const int col = tid % (kFwdCh / 4) * 4;
    const bool in_d = d0 + col < DI;
#pragma unroll
    for (int k = 0; k < kUV / 4 / kFwdThreads; ++k) {
      const int r = (tid + k * kFwdThreads) / (kFwdCh / 4);
      const bool ok = r < rows && in_d;
      const int o = ok ? (row0 + r) * DI + d0 + col : 0;
      sm90::cp_async16(&st.u[r][col], u + o, ok);
      sm90::cp_async16(&st.dt[r][col], dt + o, ok);
    }
    const int bcol = tid % (kS / 4) * 4;
#pragma unroll
    for (int k = 0; k < kBC / 4 / kFwdThreads; ++k) {
      const int r = (tid + k * kFwdThreads) / (kS / 4);
      const bool ok = r < rows;
      const int o = ok ? (row0 + r) * kS + bcol : 0;
      sm90::cp_async16(&st.B[r][bcol], Bm + o, ok);
      sm90::cp_async16(&st.C[r][bcol], Cm + o, ok);
    }
  } else {
    const int col = tid % kFwdCh;
    const bool in_d = d0 + col < DI;
#pragma unroll
    for (int k = 0; k < kUV / kFwdThreads; ++k) {
      const int r = (tid + k * kFwdThreads) / kFwdCh;
      const bool ok = r < rows && in_d;
      const int o = ok ? (row0 + r) * DI + d0 + col : 0;
      cp_async4(&st.u[r][col], u + o, ok);
      cp_async4(&st.dt[r][col], dt + o, ok);
    }
    const int bcol = tid % kS;
#pragma unroll
    for (int k = 0; k < kBC / kFwdThreads; ++k) {
      const int r = (tid + k * kFwdThreads) / kS;
      const bool ok = r < rows;
      const int o = ok ? (row0 + r) * kS + bcol : 0;
      cp_async4(&st.B[r][bcol], Bm + o, ok);
      cp_async4(&st.C[r][bcol], Cm + o, ok);
    }
  }
}

// A forward visit, its chunk of the segment and its stage, kept as counters
// (no division a visit).
struct Cursor {
  int v = 0, chunk = 0, st = 0;
  __device__ __forceinline__ void next(int nch) {
    ++v;
    if (++chunk == nch) chunk = 0;
    if (++st == kFwdStages) st = 0;
  }
};

// grid (segments, ceil(DI / kFwdCh), B), a cluster of all the segments of a
// (channel block, batch); kFwdThreads threads; thread (c, q) = (threadIdx.x
// / kFwdLanes, threadIdx.x % kFwdLanes) owns channel d0 + c, states 4q ..
// 4q + 3 (four chains), of the L steps of segment blockIdx.x.  Dynamic
// shared memory: kFwdStages stages (kFwdSmem bytes).  Visits: the block's
// chunks once a walk it takes (segment 0 and the last one walk once, the
// others twice), visit v's stage v % kFwdStages, or chunk j's stage j when
// the segment fits its stages (then loaded once).
__global__ void __launch_bounds__(kFwdThreads, kFwdBlocks)
selective_scan_fwd_kernel(const float* __restrict__ u,
                          const float* __restrict__ dt,
                          const float* __restrict__ Bm,
                          const float* __restrict__ Cm,
                          const float* __restrict__ A,
                          const float* __restrict__ h0,
                          float* __restrict__ hT, float* __restrict__ y,
                          int T, int DI, int L, int vec) {
  extern __shared__ __align__(16) float fwd_smem[];
  FwdStage* const stage = reinterpret_cast<FwdStage*>(fwd_smem);
  // a segment's end, read by the later blocks in the hop: segment 0's
  // state, or another's (hloc, Gamma)
  __shared__ float4 pub_h[kFwdThreads], pub_g[kFwdThreads];
  const int seg = blockIdx.x, nseg = gridDim.x, b = blockIdx.z;
  const int d0 = blockIdx.y * kFwdCh;
  const int tid = threadIdx.x, c = tid / kFwdLanes, q = tid % kFwdLanes;
  const int d = d0 + c;
  const bool live = d < DI;
  const size_t sidx = (static_cast<size_t>(b) * DI + d) * kS + 4 * q;
  // exp(dt A) as exp2(dt A log2 e): one multiply and the hardware exp2
  float a2[4] = {0.f, 0.f, 0.f, 0.f};
  float h[4] = {0.f, 0.f, 0.f, 0.f};
  if (live) {
    const float4 Av = *reinterpret_cast<const float4*>(A + d * kS + 4 * q);
    a2[0] = Av.x * kLog2e, a2[1] = Av.y * kLog2e;
    a2[2] = Av.z * kLog2e, a2[3] = Av.w * kLog2e;
    if (seg == 0 && h0 != nullptr) {
      const float4 hv = *reinterpret_cast<const float4*>(h0 + sidx);
      h[0] = hv.x, h[1] = hv.y, h[2] = hv.z, h[3] = hv.w;
    }
  }
  const int nch = L / kFwdChunk, t_seg = seg * L;
  const bool last = seg == nseg - 1;
  // the walks: segment 0 walks once, first; the last (nseg > 1) once,
  // second; the others a zero-state walk, then the walk that writes y
  const int first = (nseg > 1 && last) ? 0 : 1;
  const int second = seg > 0 ? 1 : 0;
  const int visits = (first + second) * nch, hook_at = first * nch;
  const bool resident = nch <= kFwdStages;
  auto slot = [&](const Cursor& k) { return resident ? k.chunk : k.st; };
  Cursor load;  // the next visit to copy
  auto start_copies = [&]() {
    if (load.v < visits && (!resident || load.v < nch))
      copy_fwd_chunk(stage[slot(load)], u, dt, Bm, Cm, b,
                     t_seg + load.chunk * kFwdChunk, T, d0, DI, vec != 0);
    sm90::cp_async_commit();
    load.next(nch);
  };
  float sum_dt = 0.f;  // the zero-state walk's, for Gamma
  // the hop: publish this segment's end, fold the earlier ones' into h
  auto hop = [&]() {
    if (nseg == 1) return;
    if (seg == 0) {
      pub_h[tid] = make_float4(h[0], h[1], h[2], h[3]);
    } else if (!last) {
      pub_h[tid] = make_float4(h[0], h[1], h[2], h[3]);
      pub_g[tid] = make_float4(sm90::exp2_approx(a2[0] * sum_dt),
                               sm90::exp2_approx(a2[1] * sum_dt),
                               sm90::exp2_approx(a2[2] * sum_dt),
                               sm90::exp2_approx(a2[3] * sum_dt));
    }
    sm90::cluster_sync();
    if (seg > 0) {
      float4 hin = sm90::ld_cluster(&pub_h[tid], 0);
      for (int k = 1; k < seg; ++k) {
        const float4 g = sm90::ld_cluster(&pub_g[tid], k);
        const float4 hl = sm90::ld_cluster(&pub_h[tid], k);
        hin = make_float4(fmaf(g.x, hin.x, hl.x), fmaf(g.y, hin.y, hl.y),
                          fmaf(g.z, hin.z, hl.z), fmaf(g.w, hin.w, hl.w));
      }
      h[0] = hin.x, h[1] = hin.y, h[2] = hin.z, h[3] = hin.w;
    }
    sm90::cluster_arrive();  // this block's reads of the others are done
  };

  float* const y_col = y + static_cast<size_t>(b) * T * DI + d;
#pragma unroll
  for (int k = 0; k < kFwdStages - 1; ++k) start_copies();
  Cursor walk;  // the visit walked
  for (; walk.v < visits; walk.next(nch)) {
    const int v = walk.v;
    if (v == hook_at) hop();
    sm90::cp_async_wait<kFwdStages - 2>();  // visit v's copies have landed
    __syncthreads();  // and every thread is done with visit v - 1's stage
    start_copies();   // visit v + kFwdStages - 1
    const FwdStage& st = stage[slot(walk)];
    const float* const cu = &st.u[0][c];
    const float* const cdt = &st.dt[0][c];
    const float4* const cB = reinterpret_cast<const float4*>(&st.B[0][0]) + q;
    const float4* const cC = reinterpret_cast<const float4*>(&st.C[0][0]) + q;
    if (v < hook_at && seg > 0) {  // the zero-state walk: hloc, sum dt
#pragma unroll
      for (int r = 0; r < kFwdChunk; ++r) {
        const float dtv = cdt[r * kFwdCh], x = dtv * cu[r * kFwdCh];
        const float4 Bv = cB[r * (kS / 4)];
        sum_dt += dtv;
        h[0] = fmaf(sm90::exp2_approx(dtv * a2[0]), h[0], x * Bv.x);
        h[1] = fmaf(sm90::exp2_approx(dtv * a2[1]), h[1], x * Bv.y);
        h[2] = fmaf(sm90::exp2_approx(dtv * a2[2]), h[2], x * Bv.z);
        h[3] = fmaf(sm90::exp2_approx(dtv * a2[3]), h[3], x * Bv.w);
      }
      continue;
    }
    // the walk that writes y: every step's share of y first, then the
    // folds, independent of each other
    float p[kFwdChunk];
#pragma unroll
    for (int r = 0; r < kFwdChunk; ++r) {
      const float dtv = cdt[r * kFwdCh], x = dtv * cu[r * kFwdCh];
      const float4 Bv = cB[r * (kS / 4)], Cv = cC[r * (kS / 4)];
      h[0] = fmaf(sm90::exp2_approx(dtv * a2[0]), h[0], x * Bv.x);
      h[1] = fmaf(sm90::exp2_approx(dtv * a2[1]), h[1], x * Bv.y);
      h[2] = fmaf(sm90::exp2_approx(dtv * a2[2]), h[2], x * Bv.z);
      h[3] = fmaf(sm90::exp2_approx(dtv * a2[3]), h[3], x * Bv.w);
      p[r] = fmaf(h[3], Cv.w, fmaf(h[2], Cv.z, fmaf(h[1], Cv.y,
                                                    h[0] * Cv.x)));
    }
    // fold the channel's 4 lanes a group of four steps: lane q keeps step
    // 4g + q's y
    const int t0 = t_seg + walk.chunk * kFwdChunk;
    float* const y_rows = y_col + static_cast<size_t>(t0 + q) * DI;
    const bool hi2 = q & 2, hi1 = q & 1;
#pragma unroll
    for (int g = 0; g < kFwdChunk / 4; ++g) {
      const float* const pg = p + 4 * g;
      float k0 = hi2 ? pg[2] : pg[0], k1 = hi2 ? pg[3] : pg[1];
      k0 += __shfl_xor_sync(0xffffffffu, hi2 ? pg[0] : pg[2], 2);
      k1 += __shfl_xor_sync(0xffffffffu, hi2 ? pg[1] : pg[3], 2);
      float yv = hi1 ? k1 : k0;
      yv += __shfl_xor_sync(0xffffffffu, hi1 ? k0 : k1, 1);
      if (live && t0 + 4 * g + q < T)
        y_rows[static_cast<size_t>(4 * g) * DI] = yv;
    }
  }
  if (visits == hook_at) hop();  // segment 0: after its walk
  if (last && live && hT != nullptr)
    *reinterpret_cast<float4*>(hT + sidx) = make_float4(h[0], h[1], h[2], h[3]);
  if (nseg > 1) sm90::cluster_wait();  // no block leaves while another reads
}

// T = 1: grid ceil(4 B DI / kStepThreads); thread g the states 4q .. 4q + 3
// (q = g % 4) of (b, d) = divmod(g / 4, DI).  Every base is 16-byte aligned
// (the wrapper's check).
__global__ void __launch_bounds__(kStepThreads)
selective_scan_step_kernel(const float* __restrict__ u,
                           const float* __restrict__ dt,
                           const float* __restrict__ Bm,
                           const float* __restrict__ Cm,
                           const float* __restrict__ A,
                           const float* __restrict__ h0,
                           float* __restrict__ hT, float* __restrict__ y,
                           int DI, int items) {
  const int g = blockIdx.x * kStepThreads + threadIdx.x;
  const int item = g / kStepLanes, q = g % kStepLanes;
  // a whole warp folds, so every lane runs; those past the end store nothing
  const bool live = item < items;
  const int it = live ? item : 0, b = it / DI, d = it % DI;
  const float dtv = dt[it], x = dtv * u[it];
  const float4 Av = reinterpret_cast<const float4*>(A)[d * 4 + q];
  const float4 Bv = reinterpret_cast<const float4*>(Bm)[b * 4 + q];
  const float4 Cv = reinterpret_cast<const float4*>(Cm)[b * 4 + q];
  float4 h = h0 != nullptr
                 ? reinterpret_cast<const float4*>(h0)[static_cast<size_t>(it) * 4 + q]
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  h.x = fmaf(sm90::exp2_approx(dtv * Av.x * kLog2e), h.x, x * Bv.x);
  h.y = fmaf(sm90::exp2_approx(dtv * Av.y * kLog2e), h.y, x * Bv.y);
  h.z = fmaf(sm90::exp2_approx(dtv * Av.z * kLog2e), h.z, x * Bv.z);
  h.w = fmaf(sm90::exp2_approx(dtv * Av.w * kLog2e), h.w, x * Bv.w);
  float p = fmaf(h.w, Cv.w, fmaf(h.z, Cv.z, fmaf(h.y, Cv.y, h.x * Cv.x)));
  p += __shfl_xor_sync(0xffffffffu, p, 2);
  p += __shfl_xor_sync(0xffffffffu, p, 1);
  if (!live) return;
  if (q == 0) y[it] = p;
  if (hT != nullptr)
    reinterpret_cast<float4*>(hT)[static_cast<size_t>(it) * 4 + q] = h;
}

// The backward's copies of the 16-step chunk at row t0: the rows of u, dt
// and dy at the block's kCh channels, and of B and C, into one of two
// buffers (u, dt, dy, B, C one after the other, kBwdChunk x kCh each), two
// elements of each a thread; past T or DI a zero is written and nothing
// read (the padding of the last segment).  int offsets: a row that is read
// lies inside its tensor, which the wrapper holds below 2^31 elements.
__device__ __forceinline__ void copy_bwd_chunk(
    float* buf, const float* __restrict__ u, const float* __restrict__ dt,
    const float* __restrict__ dy, const float* __restrict__ Bm,
    const float* __restrict__ Cm, int b, int t0, int T, int d0, int DI) {
  constexpr int kArray = kBwdChunk * kCh;
  static_assert(kCh == kS && kArray % kThreads == 0,
                "u, dt, dy, B and C rows are equally wide");
#pragma unroll
  for (int k = 0; k < kArray / kThreads; ++k) {
    const int i = threadIdx.x + k * kThreads;
    const int t = t0 + i / kCh, col = i % kCh;
    const bool in_t = t < T, ok = in_t && d0 + col < DI;
    const int ud = ok ? (b * T + t) * DI + d0 + col : 0;
    const int bc = in_t ? (b * T + t) * kS + col : 0;
    cp_async4(buf + i, u + ud, ok);
    cp_async4(buf + kArray + i, dt + ud, ok);
    cp_async4(buf + 2 * kArray + i, dy + ud, ok);
    cp_async4(buf + 3 * kArray + i, Bm + bc, in_t);
    cp_async4(buf + 4 * kArray + i, Cm + bc, in_t);
  }
}

// grid (segments, ceil(DI / kCh), B), a cluster of all the segments of a
// (channel block, batch); kThreads threads; thread (c, q) = (threadIdx.x /
// kLanes, threadIdx.x % kLanes) owns channel d0 + c, states 2q and 2q + 1
// (two chains), of the L steps of segment blockIdx.x.  Dynamic shared
// memory: (hloc, Gamma) of both chains entering each of the segment's L/16
// chunks, a float4 a thread a chunk.  Workspaces: partB, partC
// (ceil(DI / kCh), B, T, kS), each channel block's sums of dB and dC;
// dApart (B, segments, DI, kS), each (b, segment, d, s)'s dA over its t.
__global__ void __launch_bounds__(kThreads, kBwdBlocks)
selective_scan_bwd_kernel(const float* __restrict__ u,
                          const float* __restrict__ dt,
                          const float* __restrict__ Bm,
                          const float* __restrict__ Cm,
                          const float* __restrict__ A,
                          const float* __restrict__ h0,
                          const float* __restrict__ dy,
                          const float* __restrict__ dhT,
                          float* __restrict__ du, float* __restrict__ ddt,
                          float* __restrict__ dh0,
                          float* __restrict__ partB,
                          float* __restrict__ partC,
                          float* __restrict__ dApart, int T, int DI, int L) {
  constexpr int kArray = kBwdChunk * kCh;
  // [buffer][u, dt, dy, B, C][step][column]
  __shared__ __align__(16) float stage_in[2][5][kArray];
  // the segment's hloc, Gamma and gloc, read by the other blocks in the hop
  __shared__ float2 seg_h[kThreads], seg_g[kThreads], seg_l[kThreads];
  // a step's sums over a channel's states: [sum g B, sum da A][step][channel]
  __shared__ float chan[2][kBwdChunk][kCh];
  // a step's sums over a warp's 4 channels: [step][warp][lane], lane (m, q)
  // holding dB (m < 2) or dC (m >= 2) of state 2q + (m & 1)
  __shared__ float red[kBwdChunk][kWarps][32];
  extern __shared__ float4 ckpt[];  // [chunk][thread]
  const int seg = blockIdx.x, nseg = gridDim.x, b = blockIdx.z;
  const int cb = blockIdx.y, d0 = cb * kCh;
  const int tid = threadIdx.x, c = tid / kLanes, q = tid % kLanes;
  const int warp = tid / 32, lane = tid % 32;
  const int d = d0 + c;
  const bool live = d < DI;
  const size_t sidx = (static_cast<size_t>(b) * DI + d) * kS + 2 * q;
  const float2 Av = live ? make_float2(A[d * kS + 2 * q], A[d * kS + 2 * q + 1])
                         : make_float2(0.f, 0.f);
  // exp(dt A) as exp2(dt A log2 e), as the forward
  const float2 a2 = make_float2(Av.x * kLog2e, Av.y * kLog2e);
  const int t_seg = seg * L, nch = L / kBwdChunk;

  // The chunks in the order they are visited: 0 .. nch-1 (the local pass),
  // then nch-1 .. 0 (the grad pass); visit v's inputs go to buffer v & 1.
  // Visit v waits for its copies, then (every thread past the barrier, so
  // done with visit v - 1's buffer) starts those of visit v + 1, which land
  // while visit v runs.
  auto visit_chunk = [&](int v) { return v < nch ? v : 2 * nch - 1 - v; };
  auto start_copies = [&](int v) {
    if (v < 2 * nch)
      copy_bwd_chunk(stage_in[v & 1][0], u, dt, dy, Bm, Cm, b,
                     t_seg + visit_chunk(v) * kBwdChunk, T, d0, DI);
    sm90::cp_async_commit();
  };

  // 1. the local pass, from a zero state
  float2 hl = make_float2(0.f, 0.f), G = make_float2(1.f, 1.f);
  float2 gl = make_float2(0.f, 0.f);
  start_copies(0);
  for (int v = 0; v < nch; ++v) {
    sm90::cp_async_wait<0>();  // this chunk's copies have landed
    __syncthreads();
    start_copies(v + 1);
    ckpt[v * kThreads + tid] = make_float4(hl.x, hl.y, G.x, G.y);
    const float* const cu = stage_in[v & 1][0] + c;
    const float* const cdt = stage_in[v & 1][1] + c;
    const float* const cdy = stage_in[v & 1][2] + c;
    const float2* const cB =
        reinterpret_cast<const float2*>(stage_in[v & 1][3]) + q;
    const float2* const cC =
        reinterpret_cast<const float2*>(stage_in[v & 1][4]) + q;
#pragma unroll
    for (int r = 0; r < kBwdChunk; ++r) {
      const float dtv = cdt[r * kCh], x = dtv * cu[r * kCh];
      const float dyv = cdy[r * kCh];
      const float2 Bv = cB[r * kS / 2], Cv = cC[r * kS / 2];
      const float ax = sm90::exp2_approx(dtv * a2.x);
      const float ay = sm90::exp2_approx(dtv * a2.y);
      hl.x = fmaf(ax, hl.x, x * Bv.x);
      hl.y = fmaf(ay, hl.y, x * Bv.y);
      G.x *= ax;
      G.y *= ay;
      gl.x = fmaf(G.x, Cv.x * dyv, gl.x);
      gl.y = fmaf(G.y, Cv.y * dyv, gl.y);
    }
  }

  // 2. the hop, in segment order, from the other blocks of the cluster
  seg_h[tid] = hl;
  seg_g[tid] = G;
  seg_l[tid] = gl;
  sm90::cluster_sync();
  // the other segments' Gamma, and hloc of those before, gloc of those after
  float2 rg[kSegs], rx[kSegs];
#pragma unroll
  for (int k = 0; k < kSegs; ++k) {
    if (k < nseg && k != seg) {
      rg[k] = sm90::ld_cluster(&seg_g[tid], k);
      rx[k] = sm90::ld_cluster(k < seg ? &seg_h[tid] : &seg_l[tid], k);
    }
  }
  float2 hin = (live && h0 != nullptr) ? make_float2(h0[sidx], h0[sidx + 1])
                                       : make_float2(0.f, 0.f);
#pragma unroll
  for (int k = 0; k < kSegs; ++k) {
    if (k < seg)
      hin = make_float2(fmaf(rg[k].x, hin.x, rx[k].x),
                        fmaf(rg[k].y, hin.y, rx[k].y));
  }
  // carry: a_{t+1} g_{t+1} at the step walked next, from the last step's
  float2 carry = (live && dhT != nullptr)
                     ? make_float2(dhT[sidx], dhT[sidx + 1])
                     : make_float2(0.f, 0.f);
#pragma unroll
  for (int k = kSegs - 1; k >= 0; --k) {
    if (k > seg && k < nseg)
      carry = make_float2(fmaf(rg[k].x, carry.x, rx[k].x),
                          fmaf(rg[k].y, carry.y, rx[k].y));
  }
  sm90::cluster_arrive();  // the reads of the other blocks are done

  // 3. the grad pass, the chunks from the last
  const bool hi4 = q & 4, hi8 = lane & 8, hi16 = lane & 16;
  const int prow = tid / kCh, pcol = tid % kCh;
  const bool pcol_live = d0 + pcol < DI;
  const size_t row0 = static_cast<size_t>(b) * T * DI + d0 + pcol;
  float* const du_row = du + row0;
  float* const ddt_row = ddt + row0;
  const int from = (2 * (lane / kS) + (lane & 1)) * kLanes + lane % kS / 2;
  float* const part_row = (lane < kS ? partB : partC) +
                          (static_cast<size_t>(cb) * gridDim.z + b) * T * kS +
                          lane % kS;
  float2 dA_acc = make_float2(0.f, 0.f);
  for (int v = nch; v < 2 * nch; ++v) {
    sm90::cp_async_wait<0>();
    __syncthreads();  // and the sums of visit v - 1 are read
    start_copies(v + 1);
    const int j = visit_chunk(v), t0 = t_seg + j * kBwdChunk;
    const float* const cu = stage_in[v & 1][0] + c;
    const float* const cdt = stage_in[v & 1][1] + c;
    const float* const cdy = stage_in[v & 1][2] + c;
    const float2* const cB =
        reinterpret_cast<const float2*>(stage_in[v & 1][3]) + q;
    const float2* const cC =
        reinterpret_cast<const float2*>(stage_in[v & 1][4]) + q;
    // hx[0] = h_{t0-1}, hx[r + 1] = h_{t0+r}: the chunk's states
    float hx[kBwdChunk + 1], hy[kBwdChunk + 1];
    const float4 ck = ckpt[j * kThreads + tid];
    hx[0] = fmaf(ck.z, hin.x, ck.x);
    hy[0] = fmaf(ck.w, hin.y, ck.y);
#pragma unroll
    for (int r = 0; r < kBwdChunk; ++r) {
      const float dtv = cdt[r * kCh], x = dtv * cu[r * kCh];
      const float2 Bv = cB[r * kS / 2];
      hx[r + 1] = fmaf(sm90::exp2_approx(dtv * a2.x), hx[r], x * Bv.x);
      hy[r + 1] = fmaf(sm90::exp2_approx(dtv * a2.y), hy[r], x * Bv.y);
    }
#pragma unroll
    for (int r = kBwdChunk - 1; r >= 0; --r) {
      const float dtv = cdt[r * kCh], uv = cu[r * kCh], dyv = cdy[r * kCh];
      const float2 Bv = cB[r * kS / 2], Cv = cC[r * kS / 2];
      const float ax = sm90::exp2_approx(dtv * a2.x);
      const float ay = sm90::exp2_approx(dtv * a2.y);
      const float gx = fmaf(Cv.x, dyv, carry.x), gy = fmaf(Cv.y, dyv, carry.y);
      carry = make_float2(ax * gx, ay * gy);
      const float dax = carry.x * hx[r], day = carry.y * hy[r];  // d/d(dt A)
      dA_acc.x = fmaf(dax, dtv, dA_acc.x);
      dA_acc.y = fmaf(day, dtv, dA_acc.y);
      {  // sum g B and sum da A over the channel's 16 states: lanes q < 4
         // end with the first, q >= 4 with the second
        const float sg = fmaf(gx, Bv.x, gy * Bv.y);
        const float sd = fmaf(dax, Av.x, day * Av.y);
        float keep = hi4 ? sd : sg;
        keep += __shfl_xor_sync(0xffffffffu, hi4 ? sg : sd, 4);
        keep += __shfl_xor_sync(0xffffffffu, keep, 2);
        keep += __shfl_xor_sync(0xffffffffu, keep, 1);
        if ((q & 3) == 0) chan[hi4][r][c] = keep;
      }
      {  // dB = g dt u and dC = h dy of both states over the warp's 4
         // channels: lane bit 4 keeps dC, bit 3 the odd state
        const float dtu = dtv * uv;
        const float bx = gx * dtu, by = gy * dtu;
        const float cx = hx[r + 1] * dyv, cy = hy[r + 1] * dyv;
        float k0 = hi16 ? cx : bx, k1 = hi16 ? cy : by;
        k0 += __shfl_xor_sync(0xffffffffu, hi16 ? bx : cx, 16);
        k1 += __shfl_xor_sync(0xffffffffu, hi16 ? by : cy, 16);
        float keep = hi8 ? k1 : k0;
        keep += __shfl_xor_sync(0xffffffffu, hi8 ? k0 : k1, 8);
        red[r][warp][lane] = keep;
      }
    }
    __syncthreads();
    // du = dt sum g B, ddt = u sum g B + sum da A: thread (prow, pcol) the
    // steps prow and prow + 8 of channel d0 + pcol
#pragma unroll
    for (int k = 0; k < kArray / kThreads; ++k) {
      const int r = prow + k * (kThreads / kCh), i = r * kCh + pcol;
      const float sg = chan[0][r][pcol], sd = chan[1][r][pcol];
      const float dtv = stage_in[v & 1][1][i], uv = stage_in[v & 1][0][i];
      if (pcol_live && t0 + r < T) {
        const size_t o = static_cast<size_t>(t0 + r) * DI;
        du_row[o] = dtv * sg;
        ddt_row[o] = fmaf(uv, sg, sd);
      }
    }
    // this block's sums of dB and dC over its channels, warps in order:
    // warp w the steps w, w + 4, ..., lane m dB (m < 16) or dC of state m % 16
#pragma unroll
    for (int k = 0; k < kBwdChunk / kWarps; ++k) {
      const int r = warp + k * kWarps;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += red[r][w][from];
      if (t0 + r < T) part_row[static_cast<size_t>(t0 + r) * kS] = sum;
    }
  }
  if (live) {
    const size_t o = ((static_cast<size_t>(b) * nseg + seg) * DI + d) * kS +
                     2 * q;
    dApart[o] = dA_acc.x;
    dApart[o + 1] = dA_acc.y;
    if (seg == 0 && dh0 != nullptr) {
      dh0[sidx] = carry.x;
      dh0[sidx + 1] = carry.y;
    }
  }
  sm90::cluster_wait();  // no block leaves while another reads its hop
}

// dB, dC (B, T, kS): each output's channel-block partials in kGroups
// interleaved groups (block k in group k % kGroups), a thread summing a
// group in block order, then the groups in order; dA (DI, kS): the (batch,
// segment) partials summed in that order, a thread an output.  The first
// ceil(bts / kRedOut) blocks take dB and dC, kRedOut outputs each, the rest
// dA, kReduceThreads outputs each.
constexpr int kRedOut = 32;
constexpr int kGroups = kReduceThreads / kRedOut;
__global__ void __launch_bounds__(kReduceThreads)
selective_scan_bwd_reduce_kernel(const float* __restrict__ partB,
                                 const float* __restrict__ partC,
                                 const float* __restrict__ dApart,
                                 float* __restrict__ dB,
                                 float* __restrict__ dC,
                                 float* __restrict__ dA, int blocks,
                                 int parts, int bts, int dis) {
  __shared__ float sb[kGroups][kRedOut], sc[kGroups][kRedOut];
  const int bc_blocks = (bts + kRedOut - 1) / kRedOut;
  if (static_cast<int>(blockIdx.x) < bc_blocks) {
    const int o = threadIdx.x % kRedOut, g = threadIdx.x / kRedOut;
    const int i = blockIdx.x * kRedOut + o;
    float b = 0.f, c = 0.f;
    if (i < bts) {
#pragma unroll 4
      for (int k = g; k < blocks; k += kGroups) {
        b += partB[static_cast<size_t>(k) * bts + i];
        c += partC[static_cast<size_t>(k) * bts + i];
      }
    }
    sb[g][o] = b;
    sc[g][o] = c;
    __syncthreads();
    if (g == 0 && i < bts) {
#pragma unroll
      for (int k = 1; k < kGroups; ++k) {
        b += sb[k][o];
        c += sc[k][o];
      }
      dB[i] = b;
      dC[i] = c;
    }
  } else {
    const int j = (blockIdx.x - bc_blocks) * kReduceThreads + threadIdx.x;
    if (j < dis) {
      float a = 0.f;
#pragma unroll 4
      for (int p = 0; p < parts; ++p)
        a += dApart[static_cast<size_t>(p) * dis + j];
      dA[j] = a;
    }
  }
}

// The backward's dynamic shared memory for segments of L steps: a float4
// a thread for each 16-step chunk.
constexpr int bwd_dynamic_smem(int L) {
  return L / kBwdChunk * kThreads * static_cast<int>(sizeof(float4));
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
// null (not written).  `segment` (L, a multiple of kFwdChunk) cuts T into
// ceil(T / L) <= kSegs segments, one cluster; `vec`: u, dt, Bm and Cm start
// on 16 bytes and DI is a multiple of 4 (16-byte copies).  A and the states
// start on 16 bytes.  One launch; returns its error (0 on success).
extern "C" int repro_selective_scan(const void* u, const void* dt,
                                    const void* Bm, const void* Cm,
                                    const void* A, const void* state_in,
                                    void* state_out, void* y, int B, int T,
                                    int DI, int S, int segment, int vec,
                                    void* stream) {
  const int blocks = (DI + kFwdCh - 1) / kFwdCh;
  if (B <= 0 || T <= 0 || DI <= 0 || B > 65535 || blocks > 65535 ||
      S != kS || segment <= 0 || segment % kFwdChunk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long nseg = (static_cast<long long>(T) + segment - 1) / segment;
  if (nseg > kSegs) return static_cast<int>(cudaErrorInvalidValue);
  // the opt-in beyond 48 KB, set on every call (it is per device)
  cudaError_t rc = cudaFuncSetAttribute(
      selective_scan_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kFwdSmem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto m = [](void* p) { return static_cast<float*>(p); };
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(nseg), blocks, B);
  cfg.blockDim = dim3(kFwdThreads);
  cfg.dynamicSmemBytes = kFwdSmem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(nseg);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  rc = cudaLaunchKernelEx(
      &cfg, selective_scan_fwd_kernel, f(u), f(dt), f(Bm), f(Cm), f(A),
      f(state_in), m(state_out), m(y), T, DI, segment, vec);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

// The forward at T = 1 (a decode step): the same contract as
// repro_selective_scan with T = 1, every base on 16 bytes.  One launch.
extern "C" int repro_selective_scan_step(const void* u, const void* dt,
                                         const void* Bm, const void* Cm,
                                         const void* A, const void* state_in,
                                         void* state_out, void* y, int B,
                                         int DI, int S, void* stream) {
  if (B <= 0 || DI <= 0 || S != kS ||
      static_cast<long long>(B) * DI * kStepLanes >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const int items = B * DI;
  const int grid = (items * kStepLanes + kStepThreads - 1) / kStepThreads;
  selective_scan_step_kernel<<<grid, kStepThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(u), static_cast<const float*>(dt),
      static_cast<const float*>(Bm), static_cast<const float*>(Cm),
      static_cast<const float*>(A), static_cast<const float*>(state_in),
      static_cast<float*>(state_out), static_cast<float*>(y), DI, items);
  return static_cast<int>(cudaGetLastError());
}

// The backward, float32: the grads du, ddt (B, T, DI), dB, dC (B, T, S),
// dA (DI, S) and, when dstate0 is not null, of the initial state (B, DI,
// S), for dy (B, T, DI) and dstate_final (the final state's; null: zero).
// state_in null: a zero initial state.  `segment` (L) is the segments'
// length, a multiple of 16 up to kMaxSegment with ceil(T / L) <= kSegs
// (so T is at most kSegs * kMaxSegment = 12,288); the segments are
// the smallest power of two >= ceil(T / L).  Workspaces, float32, written
// before they are read: partB, partC (ceil(DI / 16), B, T, S); dApart (B,
// segments, DI, S).  Two launches; returns cudaGetLastError() after them (0
// on success).
extern "C" int repro_selective_scan_bwd(
    const void* u, const void* dt, const void* Bm, const void* Cm,
    const void* A, const void* state_in, const void* dy,
    const void* dstate_final, void* du, void* ddt, void* dB, void* dC,
    void* dA, void* dstate0, void* partB, void* partC, void* dApart, int B,
    int T, int DI, int S, int segment, void* stream) {
  const int blocks = (DI + kCh - 1) / kCh;
  if (B <= 0 || T <= 0 || DI <= 0 || B > 65535 || blocks > 65535 ||
      S != kS || segment <= 0 || segment > kMaxSegment ||
      segment % kBwdChunk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int nseg = 1;
  while (nseg * segment < T) nseg *= 2;
  if (nseg > kSegs) return static_cast<int>(cudaErrorInvalidValue);
  // the opt-in beyond 48 KB, set on every call (it is per device, and the
  // same value from every caller): the longest segment's
  cudaError_t rc = cudaFuncSetAttribute(
      selective_scan_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bwd_dynamic_smem(kMaxSegment));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int smem = bwd_dynamic_smem(segment);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto m = [](void* p) { return static_cast<float*>(p); };
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nseg, blocks, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nseg;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  rc = cudaLaunchKernelEx(
      &cfg, selective_scan_bwd_kernel, f(u), f(dt), f(Bm), f(Cm), f(A),
      f(state_in), f(dy), f(dstate_final), m(du), m(ddt), m(dstate0),
      m(partB), m(partC), m(dApart), T, DI, segment);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int bts = B * T * kS, dis = DI * kS;
  const int reduce_blocks = (bts + kRedOut - 1) / kRedOut +
                            (dis + kReduceThreads - 1) / kReduceThreads;
  selective_scan_bwd_reduce_kernel<<<reduce_blocks, kReduceThreads, 0, st>>>(
      f(partB), f(partC), f(dApart), m(dB), m(dC), m(dA), blocks, B * nseg,
      bts, dis);
  return static_cast<int>(cudaGetLastError());
}

// What the compiler gave kernel `which` (0 the forward, 1 the backward's
// segments, 2 its reduction, 3 the forward's T = 1 step): registers a
// thread, static shared bytes, local (stack and spill) bytes, 0 (the
// backward's dynamic shared bytes depend on the segment length:
// bwd_dynamic_smem).
extern "C" int repro_selective_scan_attributes(int which, int* out) {
  if (which == 0) return attributes(selective_scan_fwd_kernel, out);
  if (which == 1) return attributes(selective_scan_bwd_kernel, out);
  if (which == 2) return attributes(selective_scan_bwd_reduce_kernel, out);
  if (which == 3) return attributes(selective_scan_step_kernel, out);
  return static_cast<int>(cudaErrorInvalidValue);
}
