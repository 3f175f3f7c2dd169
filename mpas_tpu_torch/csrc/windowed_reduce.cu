// Windowed gather-reduce: CUDA C++ for sm_90a.
//
//   out[s, k, r] = sum_m wT[s, m, r] * tbl[k, cols[r / 128, idxT[m, r]]]
//   tbl [Kin, ldt] float32; cols [nb, U] int32: per 128-output block the
//   sorted distinct columns its references name, ncols [nb] of them, the
//   row padded with the last one; idxT [M, Rp] int32: each reference as a
//   position in its block's list (< ncols); wT [S, M, Rp] float32;
//   out [S, Kin, R] float32; Rp = nb*128 >= R.
//
// Replaces the TPU kernel tools/windowed_study.py:make_windowed (its inner
// `kernel`); it is also the windowed form of tools/windowed_kernels.py:
// windowed_reduce, whose unwindowed port is csrc/gather_reduce.cu. On an
// RCM-renumbered mesh (mesh/renumber.py) the indices of each 128-output
// block fall in one narrow window of W columns of the table. The TPU kernel
// DMA'd that whole window into VMEM and multiplied it by a one-hot [W, 128]
// matrix on the MXU, because Mosaic could neither gather from VMEM nor DMA
// a column list.
//
// What bounds it on the H100: memory. The least traffic is one read of the
// table, of idx and w, and one write of the output; at x1.40962 after RCM
// (E = 122880, C = 40962, M = 6) and Kin = 48 that is 23.6 + 2.0 + 7.9 MB,
// about 10 us at 3.35 TB/s. A block's 128 x M = 768 references name ~633
// distinct columns (at most 643) of its W = 1536 wide window: 128 cells
// that follow each other in RCM order form a chain one cell wide and share
// only the edges between chain neighbours. Staging the whole window reads
// 2.4x what the block needs.
//
// What the design does about it: a CTA stages only the columns its block
// reads, tbl[k, cols[b, :ncols[b]]]. The list is sorted, so a warp's 32
// copies of one level touch neighbouring or equal sectors. The copies are
// 4-byte cp.async (the card has no gathering TMA) into a ring of two stages
// of KC levels in dynamic shared memory: while the CTA reduces chunk i from
// one stage, the copies of chunk i+1 land in the other. The block's column
// list, positions and weights are staged once per CTA, not once per chunk.
// The grid's second dimension deals the level chunks round-robin over a few
// CTAs per block (chunk c goes to CTA c mod gridDim.y), because nb alone
// (321 blocks at C = 40962) would leave most of the 132 SMs' slots empty;
// the wrapper picks KC and that count from U and the card (32 KB a CTA, so
// 7 CTAs an SM, and 4 CTAs launched per resident one were the fastest of a
// sweep from 16 to 160 KB on the card during development; 256-output
// blocks, which share a few percent more columns, were slower). Each thread
// owns one output column, reads its M positions and weights once per 4
// levels and sums the slots in order m = 0..M-1, as the plain version does.

#include <cuda_runtime.h>
#include <cstddef>

namespace {

constexpr int BLOCK = 128;        // outputs per CTA = threads
constexpr int LB = 4;             // levels per register block
constexpr int MAX_SMEM = 232448;  // 227 KB, Hopper's per-block limit

__device__ __forceinline__ void cp_async_4(float* dst_shared,
                                           const float* src_global) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(dst_shared));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src_global)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int S>
__global__ void __launch_bounds__(BLOCK)
windowed_reduce_kernel(const float* __restrict__ tbl,
                       const int* __restrict__ cols,
                       const int* __restrict__ ncols,
                       const int* __restrict__ idxT,
                       const float* __restrict__ wT, float* __restrict__ out,
                       int Kin, int ldt, int R, int Rp, int M, int U, int KC) {
  extern __shared__ float smem[];
  float* ring = smem;                                          // [2][KC][U]
  int* s_cols = reinterpret_cast<int*>(ring + 2 * static_cast<size_t>(KC) * U);  // [U]
  int* s_idx = s_cols + U;                                     // [M][BLOCK]
  float* s_w = reinterpret_cast<float*>(s_idx + M * BLOCK);    // [S*M][BLOCK]

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int r = b * BLOCK + t;                                 // < Rp always
  const int nchunks = (Kin + KC - 1) / KC;
  const int nc = ncols[b];                                     // <= U

  for (int j = t; j < nc; j += BLOCK)
    s_cols[j] = cols[static_cast<size_t>(b) * U + j];
  for (int m = 0; m < M; ++m)
    s_idx[m * BLOCK + t] = idxT[static_cast<size_t>(m) * Rp + r];
  for (int q = 0; q < S * M; ++q)
    s_w[q * BLOCK + t] = wT[static_cast<size_t>(q) * Rp + r];
  __syncthreads();

  // start the copies of chunk c into a stage: thread t takes the columns
  // t, t + 128, ... of the list, each at the chunk's levels
  auto stage_chunk = [&](int c, int stage) {
    const int k0 = c * KC;
    const int nk = min(KC, Kin - k0);
    float* dst = ring + static_cast<size_t>(stage) * KC * U;
    const float* src0 = tbl + static_cast<size_t>(k0) * ldt;
    for (int j = t; j < nc; j += BLOCK) {
      const float* src = src0 + s_cols[j];
      for (int kk = 0; kk < nk; ++kk)
        cp_async_4(dst + kk * U + j, src + static_cast<size_t>(kk) * ldt);
    }
    cp_async_commit();
  };

  int c = blockIdx.y;
  int stage = 0;
  if (c < nchunks) stage_chunk(c, stage);
  for (; c < nchunks; c += gridDim.y, stage ^= 1) {
    if (c + gridDim.y < nchunks) {
      stage_chunk(c + gridDim.y, stage ^ 1);
      cp_async_wait<1>();          // chunk c has landed; the next may fly
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (r < R) {                                               // not a pad row
      const int k0 = c * KC;
      const int nk = min(KC, Kin - k0);
      const float* win = ring + static_cast<size_t>(stage) * KC * U;
      for (int kk = 0; kk < nk; kk += LB) {
        float acc[S][LB];
#pragma unroll
        for (int s = 0; s < S; ++s)
#pragma unroll
          for (int l = 0; l < LB; ++l) acc[s][l] = 0.0f;
        for (int m = 0; m < M; ++m) {
          const int j = s_idx[m * BLOCK + t];
          float ws[S];
#pragma unroll
          for (int s = 0; s < S; ++s) ws[s] = s_w[(s * M + m) * BLOCK + t];
#pragma unroll
          for (int l = 0; l < LB; ++l) {
            if (kk + l < nk) {
              const float g = win[(kk + l) * U + j];
#pragma unroll
              for (int s = 0; s < S; ++s) acc[s][l] += ws[s] * g;
            }
          }
        }
#pragma unroll
        for (int s = 0; s < S; ++s)
#pragma unroll
          for (int l = 0; l < LB; ++l)
            if (kk + l < nk)
              out[(static_cast<size_t>(s) * Kin + k0 + kk + l) * R + r] = acc[s][l];
      }
    }
    __syncthreads();               // the stage is free for the chunk after next
  }
}

template <int S>
int launch_s(const float* tbl, const int* cols, const int* ncols,
             const int* idxT,
             const float* wT, float* out, int Kin, int ldt, int R, int Rp,
             int M, int U, int KC, int slices, int smem, cudaStream_t st) {
  // above 48 KB a kernel needs the opt-in, once per instantiation
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        windowed_reduce_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        MAX_SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  const dim3 grid(Rp / BLOCK, slices);
  windowed_reduce_kernel<S><<<grid, BLOCK, smem, st>>>(
      tbl, cols, ncols, idxT, wT, out, Kin, ldt, R, Rp, M, U, KC);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 on success). S must be 1..4, Rp a
// multiple of 128, 1 <= slices, and
// smem = 4 * (2*KC*U + U + (1 + S)*M*128) <= 232448.
int windowed_reduce_f32(const void* tbl, const void* cols, const void* ncols,
                        const void* idxT, const void* wT, void* out, int Kin, int ldt, int R,
                        int Rp, int M, int S, int U, int KC, int slices,
                        int smem, void* stream) {
  if (Rp % BLOCK != 0 || Rp < R || KC < 1 || slices < 1 || slices > 65535 ||
      smem > MAX_SMEM || smem != 4 * (2 * KC * U + U + (1 + S) * M * BLOCK))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* t = static_cast<const float*>(tbl);
  const int* c = static_cast<const int*>(cols);
  const int* n = static_cast<const int*>(ncols);
  const int* i = static_cast<const int*>(idxT);
  const float* w = static_cast<const float*>(wT);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (S) {
    case 1: return launch_s<1>(t, c, n, i, w, o, Kin, ldt, R, Rp, M, U, KC, slices, smem, st);
    case 2: return launch_s<2>(t, c, n, i, w, o, Kin, ldt, R, Rp, M, U, KC, slices, smem, st);
    case 3: return launch_s<3>(t, c, n, i, w, o, Kin, ldt, R, Rp, M, U, KC, slices, smem, st);
    case 4: return launch_s<4>(t, c, n, i, w, o, Kin, ldt, R, Rp, M, U, KC, slices, smem, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
