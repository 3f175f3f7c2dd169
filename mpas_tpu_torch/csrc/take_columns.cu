// Column gather: CUDA C++ for sm_90a.
//
//   out[k, r] = tbl[k, idx[r]]
//   tbl [K, N], idx [R] int32, out [K, R]; float32 or float64.
//
// Replaces the TPU kernels tools/pallas_gather_probe.py:kern_a (jnp.take of
// a VMEM-resident [K, N] table along lanes) and :kern_b (take_along_axis
// with that one index row broadcast to all K rows, the same function). The
// TPU kernels held the whole table in VMEM and gathered from it; on Hopper
// the gather is a plain indexed load and the table (13.6 MB at the probe's
// [83, 40962] float32) sits in the 50 MB L2.
//
// What bounds it on the H100: memory. The least traffic is one read of the
// table and of idx and one write of the output: at K = 83, N = 40962,
// R = 122880 float32 that is 13.6 + 0.5 + 40.8 MB, about 16 us at 3.35 TB/s.
//
// What the design does about it: one thread per (r, chunk of KC rows), r
// fastest, so each warp stores 32 adjacent words per row and the stores,
// three quarters of the traffic, coalesce. A thread loads its index once and
// reuses it for its KC rows; the reads are the gather, served mostly by L2.
// The kernel does not bounds-check idx: its entries must lie in [0, N).

#include <cuda_runtime.h>
#include <cstddef>

namespace {

constexpr int KC = 8;          // rows per thread
constexpr int THREADS = 256;   // threads per block, along r

template <typename T>
__global__ void __launch_bounds__(THREADS)
take_columns_kernel(const T* __restrict__ tbl, const int* __restrict__ idx,
                    T* __restrict__ out, int K, int N, int R) {
  const int r = blockIdx.x * THREADS + threadIdx.x;
  if (r >= R) return;
  const size_t j = static_cast<size_t>(idx[r]);
  const int k0 = blockIdx.y * KC;
  const int k1 = min(K, k0 + KC);
  for (int k = k0; k < k1; ++k)
    out[static_cast<size_t>(k) * R + r] = tbl[static_cast<size_t>(k) * N + j];
}

template <typename T>
int launch(const void* tbl, const void* idx, void* out, int K, int N, int R,
           void* stream) {
  const dim3 grid((R + THREADS - 1) / THREADS, (K + KC - 1) / KC);
  take_columns_kernel<T><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(tbl), static_cast<const int*>(idx),
      static_cast<T*>(out), K, N, R);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 on success).
int take_columns_f32(const void* tbl, const void* idx, void* out, int K, int N,
                     int R, void* stream) {
  return launch<float>(tbl, idx, out, K, N, R, stream);
}

int take_columns_f64(const void* tbl, const void* idx, void* out, int K, int N,
                     int R, void* stream) {
  return launch<double>(tbl, idx, out, K, N, R, stream);
}

}  // extern "C"
