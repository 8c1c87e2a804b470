// The WASH shuffle of stacked population leaves for Hopper (sm_90a): two
// kernels over x, a contiguous (N, D) view of one leaf of N members.
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
// addresses.  The dense kernel out of place must read the N x D leaf and
// write N x D outputs; in place (out is x) only the masked columns change,
// so it must read the mask and, where it is set, the column's N values and
// perm entries, and write the N values.  The bucketed one moves only the N
// values of each selected column.
//
// What the design does about it:
//   * dense: one launch shuffles up to kMaxLeaves leaves of one word size
//     (a step's planned leaves: 30 for the ResNet, where 19 hold at most
//     2,048 elements and a launch of its own would be all ramp and tail).
//     The leaves travel as a table of descriptors in the kernel's parameter
//     space (__grid_constant__, 3 KB of the 4 KB a launch takes): no
//     host-to-device copy, no host sync.  A descriptor holds the leaf's
//     pointers, D, N, whether it takes the vector path, and its first
//     block; a block finds its leaf by a binary search over the first
//     blocks;
//   * vector path: a thread owns 16 bytes of columns (4 f32 or 8 bf16 /
//     f16 words) in every one of the N rows: it reads the mask for those
//     columns as one 4- or 8-byte word, loads the N 16-byte vectors, reads
//     the N perm vectors only where a mask byte is set (at p = 0.05 for
//     ~19% of f32 vectors), selects each output word in registers by an
//     N-way select, and stores N vectors: 16 bytes a load and a store, the
//     widest a thread has, where a word a row left too few bytes in
//     flight to reach the memory's rate.  (Four vectors a thread, the
//     mask read 16 bytes at once, was several times slower out of place
//     on the card.)  A leaf whose
//     rows do not all start on 16 bytes (a base off 16 bytes, or D not a
//     multiple of the vector's words) takes the scalar path: a thread a
//     column, a word a row;
//   * in place: a thread reads all N values of its columns before it
//     writes any, and no two threads share a column, so `out` may be `x`.
//     In place, columns whose mask is clear keep their values: the thread
//     reads the mask first and leaves such a vector (or scalar column)
//     alone, neither read nor written, so a step's apply reads its leaves'
//     masks and moves only the masked columns' vectors.  The stacked apply
//     shuffles a leaf where it lies, with no copy back;
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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxN = 16;
constexpr int kThreads = 256;
constexpr int kMaxLeaves = 64;  // leaves a dense launch
constexpr int kVecBytes = 16;   // bytes of a row a thread moves at once

// One leaf of a dense launch, 48 bytes.  out == x shuffles in place.
struct Leaf {
  void* out;
  const void* x;
  const int32_t* perm;
  const uint8_t* mask;
  long long d;
  int first_block;  // the leaf's blocks are [first_block, next's first)
  int16_t n;
  int16_t vector;   // 1: the vector path (rows start on 16 bytes)
};
static_assert(sizeof(Leaf) == 48, "a leaf's descriptor is 48 bytes");

struct Table {
  Leaf leaf[kMaxLeaves];
  int count;
};
static_assert(sizeof(Table) <= 4096 - 64, "the table fits a launch's "
              "parameters");

// a vector of 16 bytes as words
template <typename W>
union Vec {
  uint4 q;
  W w[kVecBytes / sizeof(W)];
};

// the mask bytes of a vector's columns, as one word
template <int VW>
struct MaskWord;
template <>
struct MaskWord<4> {
  using type = uint32_t;
};
template <>
struct MaskWord<8> {
  using type = unsigned long long;
};

// the word of row `src` among v[0..NB) (src < n <= NB, checked before)
template <typename W, int NB>
__device__ __forceinline__ W pick(const Vec<W> (&v)[NB], int src, int j) {
  W r = v[0].w[j];
#pragma unroll
  for (int k = 1; k < NB; ++k)
    if (k == src) r = v[k].w[j];
  return r;
}

// One 16-byte vector of columns [c, c + VW) of every row, its mask bytes
// `mw` (a word each).
template <typename W, int NB>
__device__ __forceinline__ void vector_of_rows(
    const Leaf& L, long long c, typename MaskWord<kVecBytes / sizeof(W)>::type mw) {
  constexpr int VW = kVecBytes / sizeof(W);
  const long long d = L.d;
  const int n = L.n;
  const W* x = static_cast<const W*>(L.x);
  W* out = static_cast<W*>(L.out);
  Vec<W> v[NB];
#pragma unroll
  for (int m = 0; m < NB; ++m)
    if (m < n) v[m].q = *reinterpret_cast<const uint4*>(x + m * d + c);
  if (mw == 0) {
#pragma unroll
    for (int m = 0; m < NB; ++m)
      if (m < n) *reinterpret_cast<uint4*>(out + m * d + c) = v[m].q;
    return;
  }
#pragma unroll
  for (int m = 0; m < NB; ++m) {
    if (m < n) {
      int p[VW];
#pragma unroll
      for (int h = 0; h < VW / 4; ++h) {
        const int4 pv =
            *reinterpret_cast<const int4*>(L.perm + m * d + c + 4 * h);
        p[4 * h] = pv.x, p[4 * h + 1] = pv.y, p[4 * h + 2] = pv.z,
                p[4 * h + 3] = pv.w;
      }
      Vec<W> r;
#pragma unroll
      for (int j = 0; j < VW; ++j) {
        if ((mw >> (8 * j)) & 0xff) {
          const int src = p[j];
          if (src < 0 || src >= n) __trap();  // not a permutation of N
          r.w[j] = pick<W, NB>(v, src, j);
        } else {
          r.w[j] = v[m].w[j];
        }
      }
      *reinterpret_cast<uint4*>(out + m * d + c) = r.q;
    }
  }
}

// A thread's 16-byte vector of columns: its mask as one 4- or 8-byte word,
// then its rows; in place, a vector whose mask word is 0 is neither read
// nor written.
template <typename W, int NB>
__device__ __forceinline__ void vector_columns(const Leaf& L, long long i) {
  constexpr int VW = kVecBytes / sizeof(W);
  using M = typename MaskWord<VW>::type;
  const long long c = i * VW;
  if (c >= L.d) return;
  const M mw = *reinterpret_cast<const M*>(L.mask + c);
  if (L.out == L.x && mw == 0) return;  // nothing of these columns moves
  vector_of_rows<W, NB>(L, c, mw);
}

template <typename W, int NB>
__device__ __forceinline__ void scalar_column(const Leaf& L, long long i) {
  const long long d = L.d;
  if (i >= d) return;
  const int n = L.n;
  const bool masked = L.mask[i] != 0;
  if (L.out == L.x && !masked) return;
  const W* x = static_cast<const W*>(L.x);
  W* out = static_cast<W*>(L.out);
  W v[NB];
#pragma unroll
  for (int m = 0; m < NB; ++m)
    if (m < n) v[m] = x[m * d + i];
#pragma unroll
  for (int m = 0; m < NB; ++m) {
    if (m < n) {
      W r = v[m];
      if (masked) {
        const int src = L.perm[m * d + i];
        if (src < 0 || src >= n) __trap();  // not a permutation of N
        r = v[0];
#pragma unroll
        for (int k = 1; k < NB; ++k)
          if (k == src) r = v[k];
      }
      out[m * d + i] = r;
    }
  }
}

// grid: the table's blocks; NB >= every leaf's N.  x and out may alias, so
// neither is __restrict__.
template <typename W, int NB>
__global__ void __launch_bounds__(kThreads)
    wash_shuffle_kernel(const __grid_constant__ Table t) {
  const int b = blockIdx.x;
  int lo = 0, hi = t.count - 1;  // the last leaf whose first block <= b
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (t.leaf[mid].first_block <= b) lo = mid;
    else hi = mid - 1;
  }
  const Leaf& L = t.leaf[lo];
  const long long i =
      static_cast<long long>(b - L.first_block) * kThreads + threadIdx.x;
  if (L.vector) vector_columns<W, NB>(L, i);
  else scalar_column<W, NB>(L, i);
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

// the dense kernel for rows up to nb (2, 4, 8 or 16), or null
template <typename W>
const void* dense_kernel(int nb) {
  if (nb == 2) return reinterpret_cast<const void*>(wash_shuffle_kernel<W, 2>);
  if (nb == 4) return reinterpret_cast<const void*>(wash_shuffle_kernel<W, 4>);
  if (nb == 8) return reinterpret_cast<const void*>(wash_shuffle_kernel<W, 8>);
  if (nb == 16) return reinterpret_cast<const void*>(wash_shuffle_kernel<W, 16>);
  return nullptr;
}

template <typename W>
int launch_dense(const Table& t, int max_n, int blocks, cudaStream_t st) {
  if (max_n <= 2) wash_shuffle_kernel<W, 2><<<blocks, kThreads, 0, st>>>(t);
  else if (max_n <= 4) wash_shuffle_kernel<W, 4><<<blocks, kThreads, 0, st>>>(t);
  else if (max_n <= 8) wash_shuffle_kernel<W, 8><<<blocks, kThreads, 0, st>>>(t);
  else wash_shuffle_kernel<W, 16><<<blocks, kThreads, 0, st>>>(t);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One dense launch over `count` leaves of `elt_bytes`-byte words: the
// descriptors as the Leaf struct lays them out (the wrapper builds them),
// their first blocks ascending from 0, `blocks` the launch's.  Returns 0 or
// the CUDA error of the launch.
extern "C" int repro_wash_shuffle_many(int elt_bytes, const void* leaves,
                                       int count, int blocks, void* stream) {
  if (count < 1 || count > kMaxLeaves || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Table t = {};
  const Leaf* in = static_cast<const Leaf*>(leaves);
  int max_n = 1;
  for (int k = 0; k < count; ++k) {
    t.leaf[k] = in[k];
    if (in[k].n < 1 || in[k].n > kMaxN || in[k].d < 1 ||
        in[k].first_block < 0 || in[k].first_block >= blocks ||
        (k > 0 && in[k].first_block <= in[k - 1].first_block) ||
        (k == 0 && in[k].first_block != 0))
      return static_cast<int>(cudaErrorInvalidValue);
    if (in[k].n > max_n) max_n = in[k].n;
  }
  t.count = count;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (elt_bytes == 2) return launch_dense<uint16_t>(t, max_n, blocks, st);
  if (elt_bytes == 4) return launch_dense<uint32_t>(t, max_n, blocks, st);
  return static_cast<int>(cudaErrorInvalidValue);
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

// What the compiler gave the dense kernel for `elt_bytes`-byte words and
// rows up to `nb` (2, 4, 8, 16): registers a thread, static shared bytes,
// local (stack and spill) bytes, its parameter bytes.
extern "C" int repro_wash_shuffle_attributes(int elt_bytes, int nb, int* out) {
  const void* f = nullptr;
  if (elt_bytes == 2) f = dense_kernel<uint16_t>(nb);
  else if (elt_bytes == 4) f = dense_kernel<uint32_t>(nb);
  if (f == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  const int rc = static_cast<int>(cudaFuncGetAttributes(&attr, f));
  if (rc != 0) return rc;
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.sharedSizeBytes);
  out[2] = static_cast<int>(attr.localSizeBytes);
  out[3] = static_cast<int>(sizeof(Table));
  return 0;
}
