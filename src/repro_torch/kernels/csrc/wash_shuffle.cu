// The WASH shuffle of a stacked population leaf for Hopper (sm_90a):
// two kernels over x, a contiguous (N, D) view of one leaf of N members.
//
// Replaces the TPU kernels repro/kernels/wash_shuffle.py
// `wash_shuffle_pallas` (body `_shuffle_kernel`) and
// `bucketed_shuffle_pallas` (which scatters its plan into a per-column
// shift and runs `wash_shuffle_pallas`), and computes what they compute:
//
//   dense      out[n, i] = x[perm[n, i], i]  if mask[i]  else x[n, i]
//   bucketed   for each bucket s >= 1 and column c = idx[s, j]:
//              x[n, c] <- x[(n + s) mod N, c]         (in place)
//
// Both are pure data movement, so the kernels move elements as 2- or 4-byte
// words and never interpret them: the result is bitwise the plain version's
// for bfloat16, float16 and float32 alike.
//
// What bounds them on the H100: bytes.  Neither does arithmetic beyond
// addresses.  The dense kernel must read the N x D leaf and write N x D
// outputs; the bucketed one only the N values of each selected column.
//
// What the design does about it:
//   * dense: one thread per column i, grid-stride over D.  A thread loads
//     the column's N values into registers (neighbouring threads read
//     neighbouring addresses of each row, so every row is read coalesced),
//     reads the mask byte, reads the N perm entries only where the mask is
//     set (at p = 0.01 that skips almost all of the perm's N x D int32s,
//     the largest input), picks each output from the registers by an
//     N-way select, and writes N outputs.  The TPU kernel's 128-lane
//     blocks and N-way VPU select over whole tiles have no reason to exist
//     here; no shared memory, no block barrier;
//   * bucketed: sparse and in place.  One thread per selected column of
//     buckets s >= 1 (bucket 0 is the identity and is not touched): it
//     reads the column's N values and writes them back rotated by s.  The
//     plan's rows are disjoint, so no two threads touch one column, and
//     the N - 1 buckets go in one launch.  It moves 2 N k_per (N - 1)
//     elements plus the plan, not the leaf: the TPU version's shift map
//     and full dense pass over N x D are gone.  The columns are scattered,
//     so each access costs a 32-byte sector, and at the training path's
//     density (a moved column every ~800 bytes of a member row) each
//     sector sits in a DRAM page of its own: the kernel is bound by page
//     activations, not by bytes or sectors (several times its sector
//     floor).  core.shuffle draws each plan row in ascending order, which
//     makes neighbouring threads touch neighbouring columns: a little
//     faster at that density, over twice as fast on a ten times denser
//     plan, where neighbours share pages (chip_smoke.py phase 4 times
//     both).  More columns a thread with all loads issued before any
//     store, and other grid sizes, were no faster on the card;
//   * offsets are 64-bit throughout: a stacked leaf passes 2^31 elements
//     (28 x 3072 x 8192 x 4 members = 2.82e9).
//   * a plan entry outside its range (a column outside [0, D), a perm
//     entry outside [0, N)) stops the kernel with a trap, which fails the
//     launch as PyTorch's own device-side index checks do (the plain
//     versions raise on an entry past the end and wrap a negative one):
//     a silent skip would look like a sparser shuffle.  core.shuffle's
//     plans are in range by construction.
// No vector loads, no tensor memory accelerator: later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxN = 16;
constexpr int kThreads = 256;

template <typename W>
__global__ void __launch_bounds__(kThreads)
    wash_shuffle_kernel(const W* __restrict__ x, const int32_t* __restrict__ perm,
                        const uint8_t* __restrict__ mask, W* __restrict__ out,
                        int n, long long d) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < d; i += stride) {
    W v[kMaxN];
#pragma unroll
    for (int m = 0; m < kMaxN; ++m)
      if (m < n) v[m] = x[m * d + i];
    if (mask[i]) {
#pragma unroll
      for (int m = 0; m < kMaxN; ++m) {
        if (m < n) {
          const int src = perm[m * d + i];
          if (src < 0 || src >= n) __trap();  // not a permutation of N
          W r = v[0];
#pragma unroll
          for (int k = 1; k < kMaxN; ++k)
            if (k < n && k == src) r = v[k];
          out[m * d + i] = r;
        }
      }
    } else {
#pragma unroll
      for (int m = 0; m < kMaxN; ++m)
        if (m < n) out[m * d + i] = v[m];
    }
  }
}

template <typename W>
__global__ void __launch_bounds__(kThreads)
    bucketed_shuffle_kernel(W* __restrict__ x, const int32_t* __restrict__ idx,
                            int n, long long d, long long k_per) {
  const long long total = static_cast<long long>(n - 1) * k_per;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       t < total; t += stride) {
    const int s = 1 + static_cast<int>(t / k_per);  // bucket of entry t
    const long long c = idx[k_per + t];             // rows s >= 1, in order
    if (c < 0 || c >= d) __trap();  // a plan entry outside the leaf
    W v[kMaxN];
#pragma unroll
    for (int m = 0; m < kMaxN; ++m)
      if (m < n) v[m] = x[m * d + c];
#pragma unroll
    for (int m = 0; m < kMaxN; ++m) {
      if (m < n) {
        int src = m + s;
        if (src >= n) src -= n;
        W r = v[0];
#pragma unroll
        for (int k = 1; k < kMaxN; ++k)
          if (k == src) r = v[k];
        x[m * d + c] = r;
      }
    }
  }
}

int grid_for(long long work) {
  // enough blocks to fill the card several times over; the loops stride
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long cap = 132LL * 16;
  if (blocks > cap) blocks = cap;
  return static_cast<int>(blocks < 1 ? 1 : blocks);
}

}  // namespace

// Returns 0 or the CUDA error of the launch.
extern "C" int repro_wash_shuffle(int elt_bytes, const void* x,
                                  const void* perm, const void* mask,
                                  void* out, int n, long long d,
                                  void* stream) {
  if (n < 1 || n > kMaxN || d < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (d == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = grid_for(d);
  const int32_t* p = static_cast<const int32_t*>(perm);
  const uint8_t* mk = static_cast<const uint8_t*>(mask);
  if (elt_bytes == 2) {
    wash_shuffle_kernel<uint16_t><<<grid, kThreads, 0, st>>>(
        static_cast<const uint16_t*>(x), p, mk, static_cast<uint16_t*>(out), n, d);
  } else if (elt_bytes == 4) {
    wash_shuffle_kernel<uint32_t><<<grid, kThreads, 0, st>>>(
        static_cast<const uint32_t*>(x), p, mk, static_cast<uint32_t*>(out), n, d);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_bucketed_shuffle(int elt_bytes, void* x, const void* idx,
                                      int n, long long d, long long k_per,
                                      void* stream) {
  if (n < 1 || n > kMaxN || d < 0 || k_per < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 1 || k_per == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = grid_for(static_cast<long long>(n - 1) * k_per);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  if (elt_bytes == 2) {
    bucketed_shuffle_kernel<uint16_t><<<grid, kThreads, 0, st>>>(
        static_cast<uint16_t*>(x), ix, n, d, k_per);
  } else if (elt_bytes == 4) {
    bucketed_shuffle_kernel<uint32_t><<<grid, kThreads, 0, st>>>(
        static_cast<uint32_t*>(x), ix, n, d, k_per);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
