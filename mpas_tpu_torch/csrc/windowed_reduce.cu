// Windowed gather-reduce: CUDA C++ for sm_90a.
//
//   out[s, k, r] = sum_m wT[s, m, r] * tbl[k, ws[r / 128] * 128 + idxT[m, r]]
//   tbl [Kin, ldt] float32, ws [nb] int32 (window starts, in units of 128
//   columns), idxT [M, Rp] int32 (indices local to the window, < W),
//   wT [S, M, Rp] float32, out [S, Kin, R] float32; Rp = nb * 128 >= R.
//
// Replaces the TPU kernel tools/windowed_study.py:make_windowed (its inner
// `kernel`); it is also the windowed form of tools/windowed_kernels.py:
// windowed_reduce, whose unwindowed port is csrc/gather_reduce.cu. On an
// RCM-renumbered mesh (mesh/renumber.py) the indices of each 128-output
// block fall in one narrow window of W columns of the table. The TPU kernel
// DMA'd that window into VMEM and multiplied it by a one-hot [W, 128] matrix
// on the MXU, because Mosaic could not gather from VMEM. Shared memory on
// Hopper gathers natively, so here one CTA per (128-output block, chunk of
// KC levels) stages tbl[k0:k0+KC, ws*128 : ws*128+W] in dynamic shared
// memory with coalesced row loads, stages the block's local indices and
// weights, and then each thread, which owns one output column, reads its M
// slots from shared memory for each of its KC levels. The M slots are summed
// in order m = 0..M-1, as the plain version sums them.
//
// What bounds it on the H100: memory. The least traffic is one read of the
// table, of idx and w, and one write of the output; at x1.40962 after RCM
// (E = 122880, C = 40962, M = 6) and Kin = 48 that is 23.6 + 2.0 + 7.9 MB,
// about 10 us at 3.35 TB/s. The kernel reads more: every block stages all W
// columns of its window though it needs only ~450 of them, so it reads
// nb * W / E (~4x at W = 1536) the table, mostly from L2. That is the cost
// the windowed study measures against csrc/gather_reduce.cu, which reads
// each gathered element once. The window does not fit in 227 KB of shared
// memory at every level count (one [168, 1536] float32 window is 1 MB), so
// the grid's second dimension tiles the levels; the wrapper picks KC so a
// CTA's shared memory stays near 96 KB and two CTAs fit on an SM.

#include <cuda_runtime.h>
#include <cstddef>

namespace {

constexpr int BLOCK = 128;                  // outputs per CTA = threads
constexpr int MAX_SMEM = 232448;            // 227 KB, Hopper's per-block limit

template <int S>
__global__ void __launch_bounds__(BLOCK)
windowed_reduce_kernel(const float* __restrict__ tbl, const int* __restrict__ ws,
                       const int* __restrict__ idxT,
                       const float* __restrict__ wT, float* __restrict__ out,
                       int Kin, int ldt, int R, int Rp, int M, int W, int KC) {
  extern __shared__ float smem[];
  float* win = smem;                                           // [KC][W]
  int* s_idx = reinterpret_cast<int*>(win + static_cast<size_t>(KC) * W);  // [M][BLOCK]
  float* s_w = reinterpret_cast<float*>(s_idx + M * BLOCK);    // [S*M][BLOCK]

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int r = b * BLOCK + t;                                 // < Rp always
  const int k0 = blockIdx.y * KC;
  const int nk = min(KC, Kin - k0);
  const float* src = tbl + static_cast<size_t>(k0) * ldt
                     + static_cast<size_t>(ws[b]) * BLOCK;

  // the window: nk rows of W contiguous columns, one warp per 32 columns
  for (int kk = 0; kk < nk; ++kk) {
    const float* row = src + static_cast<size_t>(kk) * ldt;
    float* dst = win + kk * W;
    for (int j = t; j < W; j += BLOCK) dst[j] = row[j];
  }
  for (int m = 0; m < M; ++m)
    s_idx[m * BLOCK + t] = idxT[static_cast<size_t>(m) * Rp + r];
  for (int q = 0; q < S * M; ++q)
    s_w[q * BLOCK + t] = wT[static_cast<size_t>(q) * Rp + r];
  __syncthreads();
  if (r >= R) return;                                          // pad rows

  for (int kk = 0; kk < nk; ++kk) {
    const float* row = win + kk * W;
    float acc[S];
#pragma unroll
    for (int s = 0; s < S; ++s) acc[s] = 0.0f;
    for (int m = 0; m < M; ++m) {
      const float g = row[s_idx[m * BLOCK + t]];
#pragma unroll
      for (int s = 0; s < S; ++s) acc[s] += s_w[(s * M + m) * BLOCK + t] * g;
    }
#pragma unroll
    for (int s = 0; s < S; ++s)
      out[(static_cast<size_t>(s) * Kin + k0 + kk) * R + r] = acc[s];
  }
}

template <int S>
int launch_s(const float* tbl, const int* ws, const int* idxT, const float* wT,
             float* out, int Kin, int ldt, int R, int Rp, int M, int W, int KC,
             int smem, cudaStream_t st) {
  // above 48 KB a kernel needs the opt-in, once per instantiation
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        windowed_reduce_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        MAX_SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  const dim3 grid(Rp / BLOCK, (Kin + KC - 1) / KC);
  windowed_reduce_kernel<S><<<grid, BLOCK, smem, st>>>(
      tbl, ws, idxT, wT, out, Kin, ldt, R, Rp, M, W, KC);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 on success). S must be 1..4, Rp a
// multiple of 128, and smem = 4 * (KC*W + M*128 + S*M*128) <= 232448.
int windowed_reduce_f32(const void* tbl, const void* ws, const void* idxT,
                        const void* wT, void* out, int Kin, int ldt, int R,
                        int Rp, int M, int S, int W, int KC, int smem,
                        void* stream) {
  if (Rp % BLOCK != 0 || smem > MAX_SMEM || KC < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* t = static_cast<const float*>(tbl);
  const int* w0 = static_cast<const int*>(ws);
  const int* i = static_cast<const int*>(idxT);
  const float* w = static_cast<const float*>(wT);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (S) {
    case 1: return launch_s<1>(t, w0, i, w, o, Kin, ldt, R, Rp, M, W, KC, smem, st);
    case 2: return launch_s<2>(t, w0, i, w, o, Kin, ldt, R, Rp, M, W, KC, smem, st);
    case 3: return launch_s<3>(t, w0, i, w, o, Kin, ldt, R, Rp, M, W, KC, smem, st);
    case 4: return launch_s<4>(t, w0, i, w, o, Kin, ldt, R, Rp, M, W, KC, smem, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
