// The row-read pass that the gather-reduce (gather_reduce.cu) and the column
// gather (take_columns.cu) share: CUDA C++ for sm_90a.
//
// For index tables that scatter. A tiled transpose writes tblT [N, Ktp] from
// the level-major tbl [Kt, N] (Ktp = Kt rounded up so that every row starts
// on a 32-byte boundary). In the pass a warp owns an output row r at a time
// and its lanes run along the levels, so each reference reads one whole
// contiguous row of tblT: every 32-byte sector fetched is used in full,
// where a gather from the level-major table uses 4 or 8 bytes of each. The
// [levels, 32 rows] result tile goes through padded shared memory and is
// written level-major, 32 adjacent words a warp.

#pragma once

#include <cuda_runtime.h>
#include <cstddef>

namespace row_read {

constexpr int MAX_SMEM = 232448;  // 227 KB, Hopper's per-block limit

// Dynamic shared memory above 48 KB needs the opt-in, once per instantiation.
template <typename K>
cudaError_t opt_in(K kernel, int smem, bool* done) {
  if (smem <= 48 * 1024 || *done) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (e == cudaSuccess) *done = true;
  return e;
}

constexpr int TT = 32;        // transpose tile edge
constexpr int TROWS = 8;      // blockDim.y of the transpose

template <typename T>
__global__ void __launch_bounds__(TT * TROWS)
transpose_kernel(const T* __restrict__ tbl, T* __restrict__ tblT, int Kt,
                 int N, int Ktp) {
  __shared__ T tile[TT][TT + 1];
  const int n0 = blockIdx.x * TT, k0 = blockIdx.y * TT;
  for (int i = threadIdx.y; i < TT; i += TROWS) {
    const int k = k0 + i, n = n0 + threadIdx.x;
    if (k < Kt && n < N) tile[i][threadIdx.x] = tbl[static_cast<size_t>(k) * N + n];
  }
  __syncthreads();
  for (int i = threadIdx.y; i < TT; i += TROWS) {
    const int n = n0 + i, k = k0 + threadIdx.x;
    if (n < N && k < Kt) tblT[static_cast<size_t>(n) * Ktp + k] = tile[threadIdx.x][i];
  }
}

template <typename T>
int launch_transpose(const void* tbl, void* tblT, int Kt, int N, int Ktp,
                     void* stream) {
  if (Kt < 1 || N < 1 || Ktp < Kt) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + TT - 1) / TT, (Kt + TT - 1) / TT), block(TT, TROWS);
  transpose_kernel<T><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(tbl), static_cast<T*>(tblT), Kt, N, Ktp);
  return static_cast<int>(cudaGetLastError());
}

constexpr int RT = 32;        // rows of a CTA's output tile
constexpr int RW = 8;         // warps of a CTA
constexpr int KL = 3;         // levels per lane
constexpr int KP = 32 * KL;   // levels of a CTA's pass (blockIdx.y)
constexpr int RLD = RT + 1;   // padded stride of the output tile
static_assert(RT % RW == 0, "a warp takes RT / RW rows of the tile");

// WEIGHTED: out[s, k, r] = sum_m w[s, r, m] * tblT[idx[r, m], k]. Not
// WEIGHTED (S = 1, M = 1, w unread): out[k, r] = tblT[idx[r], k], the
// gathered words copied as they are.
template <typename T, int S, bool WEIGHTED>
__global__ void __launch_bounds__(RW * 32)
rows_kernel(const T* __restrict__ tblT, const int* __restrict__ idx,
            const T* __restrict__ w, T* __restrict__ out, int Kt, int Ktp,
            int R, int M, int ldi) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_out = reinterpret_cast<T*>(smem_raw);                  // [S*KP][RLD]

  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = blockIdx.x * RT;
  const int k0 = blockIdx.y * KP;

  // the gather: lane q holds the tile's q-th index, one coalesced load
  int tile_j = 0;
  if constexpr (!WEIGHTED)
    if (r0 + lane < R) tile_j = idx[static_cast<size_t>(r0 + lane) * ldi];

  // the gather's rows are independent chains of one load each: unrolled, a
  // warp has its RT / RW rows in flight together
#pragma unroll(WEIGHTED ? 1 : RT / RW)
  for (int i = 0; i < RT / RW; ++i) {
    const int rl = warp + i * RW;
    const int r = r0 + rl;                                    // warp-uniform
    T acc[S][KL];
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int kk = 0; kk < KL; ++kk) acc[s][kk] = T(0);

    if constexpr (!WEIGHTED) {
      const int j = __shfl_sync(full, tile_j, rl);
      if (r < R) {
        const T* row = tblT + static_cast<size_t>(j) * Ktp + k0 + lane;
#pragma unroll
        for (int kk = 0; kk < KL; ++kk)
          if (k0 + lane + 32 * kk < Kt) acc[0][kk] = __ldg(row + 32 * kk);
      }
    } else if (r < R) {
      for (int m0 = 0; m0 < M; m0 += 32) {
        // lane q holds slot m0 + q of this row: its index and S weights
        const int mm = m0 + lane;
        int my_j = 0;
        T my_w[S];
#pragma unroll
        for (int s = 0; s < S; ++s) my_w[s] = T(0);
        if (mm < M) {
          my_j = idx[static_cast<size_t>(r) * ldi + mm];
#pragma unroll
          for (int s = 0; s < S; ++s)
            my_w[s] = w[(static_cast<size_t>(s) * R + r) * M + mm];
        }
        const int cnt = min(32, M - m0);
#pragma unroll 4
        for (int q = 0; q < cnt; ++q) {
          const int j = __shfl_sync(full, my_j, q);
          const T* row = tblT + static_cast<size_t>(j) * Ktp + k0 + lane;
          T g[KL];
#pragma unroll
          for (int kk = 0; kk < KL; ++kk)
            g[kk] = (k0 + lane + 32 * kk < Kt) ? __ldg(row + 32 * kk) : T(0);
#pragma unroll
          for (int s = 0; s < S; ++s) {
            const T ws = __shfl_sync(full, my_w[s], q);
#pragma unroll
            for (int kk = 0; kk < KL; ++kk) acc[s][kk] += ws * g[kk];
          }
        }
      }
    }
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int kk = 0; kk < KL; ++kk)
        s_out[(s * KP + lane + 32 * kk) * RLD + rl] = acc[s][kk];
  }
  __syncthreads();

  // the tile's rows, level-major: 32 adjacent outputs a warp
  const int r = r0 + lane;
  for (int q = warp; q < S * KP; q += RW) {
    const int s = q / KP, k = k0 + (q - s * KP);
    if (k < Kt && r < R)
      out[(static_cast<size_t>(s) * Kt + k) * R + r] = s_out[q * RLD + lane];
  }
}

}  // namespace row_read
