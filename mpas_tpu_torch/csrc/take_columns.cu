// Column gather: CUDA C++ for sm_90a, in two forms.
//
//   out[k, r] = tbl[k, idx[r]]
//   tbl [K, N], idx [R] int32 (stride ldi), out [K, R]; float32 or float64.
//
// Replaces the TPU kernels tools/pallas_gather_probe.py:kern_a (jnp.take of
// a VMEM-resident [K, N] table along lanes) and :kern_b (take_along_axis
// with that one index row broadcast to all K rows, the same function). The
// TPU kernels held the whole table in VMEM and gathered from it; on Hopper
// the gather is a plain indexed load and the table (13.6 MB at the probe's
// [83, 40962] float32) sits in the 50 MB L2.
//
// What bounds it on the H100: memory, and within memory the sectors the
// gather touches. The least traffic is one read of the table and of idx and
// one write of the output: at K = 83, N = 40962, R = 122880 float32 that is
// 13.6 + 0.5 + 40.8 MB, about 16 us at 3.35 TB/s. The reads go through L2 in
// 32-byte sectors: where neighbouring outputs name neighbouring columns (an
// index vector of a mesh) a warp's 32 reads of one level share a few
// sectors; where they scatter, each read fetches a sector for 4 useful
// bytes, 8x the gathered words.
//
// What the design does about it, in two forms; ops/take_columns.py picks
// between them from the index vector alone, as Kernel 2's wrapper does.
//
// The direct form (`take_columns_direct_*`), for index vectors with
// locality: one thread per (r, chunk of KC levels), r fastest, so each warp
// stores 32 adjacent words per level and the stores, three quarters of the
// traffic, coalesce. A thread loads its index once and reuses it for its KC
// levels; the reads are the gather, served mostly by L2.
//
// The row-read form (`transpose_table_*` of gather_reduce.cu, then
// `take_columns_rows_*`), for index vectors that scatter: the table is
// transposed into scratch [N, Ktp] with rows on 32-byte boundaries, and the
// row pass of row_read.cuh (Kernel 2's, instantiated without weights) gives
// a warp an output row: its lanes read row idx[r] of the scratch in full
// sectors, and the CTA turns its [levels, 32 rows] tile through padded
// shared memory so that the stores stay level-major and coalesced. The
// gathered words are copied, never multiplied, so the result is bit-equal
// to the direct form's. The transpose (table read and written once more) is
// traffic the bound does not count.
//
// Neither kernel bounds-checks idx: its entries must lie in [0, N).

#include <cuda_runtime.h>
#include <cstddef>

#include "row_read.cuh"

namespace {

using namespace row_read;

constexpr int KC = 8;          // levels per thread
constexpr int THREADS = 256;   // threads per block, along r

template <typename T>
__global__ void __launch_bounds__(THREADS)
take_columns_kernel(const T* __restrict__ tbl, const int* __restrict__ idx,
                    T* __restrict__ out, int K, int N, int R, int ldi) {
  const int r = blockIdx.x * THREADS + threadIdx.x;
  if (r >= R) return;
  const size_t j = static_cast<size_t>(idx[static_cast<size_t>(r) * ldi]);
  const int k0 = blockIdx.y * KC;
  const int k1 = min(K, k0 + KC);
  for (int k = k0; k < k1; ++k)
    out[static_cast<size_t>(k) * R + r] = tbl[static_cast<size_t>(k) * N + j];
}

template <typename T>
int launch_direct(const void* tbl, const void* idx, void* out, int K, int N,
                  int R, int ldi, void* stream) {
  if (K < 1 || N < 1 || R < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((R + THREADS - 1) / THREADS, (K + KC - 1) / KC);
  take_columns_kernel<T><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(tbl), static_cast<const int*>(idx),
      static_cast<T*>(out), K, N, R, ldi);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_rows(const void* tblT, const void* idx, void* out, int K, int Ktp,
                int R, int ldi, void* stream) {
  static bool opted_in = false;
  if (K < 1 || R < 1 || Ktp < K) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = KP * RLD * static_cast<int>(sizeof(T));
  cudaError_t e = opt_in(rows_kernel<T, 1, false>, smem, &opted_in);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((R + RT - 1) / RT, (K + KP - 1) / KP);
  rows_kernel<T, 1, false><<<grid, RW * 32, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(tblT), static_cast<const int*>(idx), nullptr,
      static_cast<T*>(out), K, Ktp, R, 1, ldi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each entry point returns the cudaError_t of its launch (0 on success).
// take_columns_rows reads tblT [N, Ktp], the table as transpose_table_*
// wrote it.
#define TAKE_COLUMNS_ENTRY_POINTS(T, SUFFIX)                                   \
  extern "C" int take_columns_direct_##SUFFIX(                                 \
      const void* tbl, const void* idx, void* out, int K, int N, int R,        \
      int ldi, void* stream) {                                                 \
    return launch_direct<T>(tbl, idx, out, K, N, R, ldi, stream);              \
  }                                                                            \
  extern "C" int take_columns_rows_##SUFFIX(                                   \
      const void* tblT, const void* idx, void* out, int K, int Ktp, int R,     \
      int ldi, void* stream) {                                                 \
    return launch_rows<T>(tblT, idx, out, K, Ktp, R, ldi, stream);             \
  }

TAKE_COLUMNS_ENTRY_POINTS(float, f32)
TAKE_COLUMNS_ENTRY_POINTS(double, f64)
