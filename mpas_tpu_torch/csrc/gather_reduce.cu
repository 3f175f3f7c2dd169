// Stacked gather-reduce: CUDA C++ for sm_90a, in two forms.
//
//   out[s, k, r] = sum_m w[s, r, m] * tbl[k, idx[r, m]]
//   tbl [Kt, N], idx [R, M] int32 (row stride ldi), w [S, R, M], out [S, Kt, R]
//
// Replaces the TPU kernel tools/windowed_kernels.py:windowed_reduce (its inner
// `kernel`, driven by slot_reduce_windowed / edge_pairs_windowed), whose
// function is mpas_tpu/ops/stencils.py:slot_reduce, and covers the fused
// weighted reduce of tools/pallas_gather_probe.py:kern_c. The TPU kernel
// DMA'd a window of the table per 128-output block and multiplied it by a
// one-hot weight matrix, which needed an RCM-renumbered mesh. Here the
// gather is an indexed load, so any numbering works and no one-hot matrix or
// window exists.
//
// What bounds it on the H100: memory, and within memory the sectors the
// gather touches. Each output costs M multiply-adds per weight set against M
// table reads; the least traffic is one read of the table, of idx and w, and
// one write of the output (edgesOnEdge, R = E = 122880, M = 10, Kt = 82,
// S = 1, float32: 40 + 9.8 + 40 MB, 27 us at 3.35 TB/s). The table reads go
// through L2 in 32-byte sectors. Where neighbouring rows name neighbouring
// columns (a mesh's own tables) a warp's 32 references of one slot share a
// few sectors; where they scatter, each reference uses 4 bytes of its sector
// and the gather moves 8x the table per slot.
//
// The direct form (`gather_reduce_direct_*`), for tables with locality. A
// CTA owns 128 rows and walks all Kt levels, so it reads its rows' indices
// and weights from device memory once per launch: coalesced loads into
// shared memory, stored slot-major with a padded stride so that neither the
// transposing store nor the per-slot read conflicts. The loads are plain
// 4-byte ones, not cp.async: the tile is 12% of the least traffic at
// edgesOnEdge and is read once, idx rows may be strided, and the
// transposing store needs each word in a register anyway. The CTA's 256
// threads are 128 rows x 2 level lanes; lane y takes the level chunks y,
// y + 2, ... of KC = 4 levels each, which keeps twice as many warps in
// flight as one thread per row would (R = 40962 gives only 1281 row-warps
// for 132 SMs). Four CTAs fit on an SM at 64 registers a thread. Lanes (1,
// 2, 4, 8), levels a chunk (2, 4, 8) and CTAs an SM (1 to 8) were swept on
// the card during development: this shape was the fastest or close to it
// at every call shape of the step on both edge numberings, and 8 levels a
// chunk lost most where the indices scatter most (edgesOnEdge on the
// aligned numbering). M is a template parameter for the step's (S, M)
// pairs, so the slot loop unrolls and the KC gathers of several slots are
// in flight together; the gathered value feeds all S accumulators. Stores
// are 32 adjacent words a warp.
//
// The row-read form (`transpose_table_*` then `gather_reduce_rows_*`), for
// index tables that scatter. A tiled transpose writes tblT [N, Ktp] (Ktp =
// Kt rounded up to a 32-byte multiple). In the reduction a warp owns a row
// r at a time and its lanes run along the levels, so each reference reads
// one whole contiguous row of tblT: every sector fetched is used in full.
// Lane m loads idx[r, m] and the weights once and the warp broadcasts them
// by shuffle. The [levels, 32 rows] result tile goes through padded shared
// memory and is written level-major, 32 adjacent words a warp.
//
// Both forms sum the slots in order m = 0..M-1. Which form runs is decided
// in ops/gather_reduce.py from the index table alone.

#include <cuda_runtime.h>
#include <cstddef>

namespace {

constexpr int MAX_SMEM = 232448;  // 227 KB, Hopper's per-block limit

// ---- direct form ----------------------------------------------------------

constexpr int ROWS = 128;     // rows of a CTA's tile = blockDim.x
constexpr int LANES = 2;      // level lanes = blockDim.y
constexpr int LD = ROWS + 1;  // padded stride of the slot-major tiles

// levels per thread and pass: 4, or fewer where the S accumulators of a
// level would take more than 16 registers together
constexpr int KC_MAX = 4;
template <typename T, int S>
struct Chunk {
  static constexpr int fit = 64 / (static_cast<int>(sizeof(T)) * (S == 3 ? 4 : S));
  static constexpr int KC = fit < KC_MAX ? fit : KC_MAX;
};

// MT > 0: the slot count, known at compile time; MT == 0: read from M.
template <typename T, int S, int MT>
__global__ void __launch_bounds__(ROWS * LANES, 4)
direct_kernel(const T* __restrict__ tbl, const int* __restrict__ idx,
              const T* __restrict__ w, T* __restrict__ out, int Kt, int N,
              int R, int M_rt, int ldi) {
  constexpr int KC = Chunk<T, S>::KC;
  const int M = MT > 0 ? MT : M_rt;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_w = reinterpret_cast<T*>(smem_raw);                    // [S*M][LD]
  int* s_idx = reinterpret_cast<int*>(s_w + S * M * LD);      // [M][LD]

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * ROWS + tx;
  const int r0 = blockIdx.x * ROWS;
  const int rows = min(ROWS, R - r0);

  // the tile's indices and weights: consecutive threads read consecutive
  // words of the [rows, M] tile and store them slot-major
  for (int i = tid; i < rows * M; i += ROWS * LANES) {
    const int row = i / M, m = i - row * M;
    s_idx[m * LD + row] = idx[static_cast<size_t>(r0 + row) * ldi + m];
  }
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const T* ws = w + (static_cast<size_t>(s) * R + r0) * M;
    for (int i = tid; i < rows * M; i += ROWS * LANES) {
      const int row = i / M, m = i - row * M;
      s_w[(s * M + m) * LD + row] = ws[i];
    }
  }
  __syncthreads();
  if (tx >= rows) return;

  const int r = r0 + tx;
  const size_t Ns = static_cast<size_t>(N);
  const int nchunks = (Kt + KC - 1) / KC;
  for (int c = ty; c < nchunks; c += LANES) {
    const int k0 = c * KC;
    const int nk = min(KC, Kt - k0);
    const T* t0 = tbl + static_cast<size_t>(k0) * Ns;

    T acc[S][KC];
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) acc[s][kk] = T(0);

    if (nk == KC) {
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int j = s_idx[m * LD + tx];
        T ws[S];
#pragma unroll
        for (int s = 0; s < S; ++s) ws[s] = s_w[(s * M + m) * LD + tx];
#pragma unroll
        for (int kk = 0; kk < KC; ++kk) {
          const T g = __ldg(t0 + kk * Ns + j);
#pragma unroll
          for (int s = 0; s < S; ++s) acc[s][kk] += ws[s] * g;
        }
      }
    } else {
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int j = s_idx[m * LD + tx];
        T ws[S];
#pragma unroll
        for (int s = 0; s < S; ++s) ws[s] = s_w[(s * M + m) * LD + tx];
#pragma unroll
        for (int kk = 0; kk < KC; ++kk) {
          if (kk < nk) {
            const T g = __ldg(t0 + kk * Ns + j);
#pragma unroll
            for (int s = 0; s < S; ++s) acc[s][kk] += ws[s] * g;
          }
        }
      }
    }

#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int kk = 0; kk < KC; ++kk)
        if (kk < nk)
          out[(static_cast<size_t>(s) * Kt + k0 + kk) * R + r] = acc[s][kk];
  }
}

// Dynamic shared memory above 48 KB needs the opt-in, once per instantiation.
template <typename K>
cudaError_t opt_in(K kernel, int smem, bool* done) {
  if (smem <= 48 * 1024 || *done) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (e == cudaSuccess) *done = true;
  return e;
}

template <typename T, int S, int MT>
int launch_direct_sm(const T* tbl, const int* idx, const T* w, T* out, int Kt,
                     int N, int R, int M, int ldi, cudaStream_t st) {
  static bool opted_in = false;
  const int smem = M * LD * (S * static_cast<int>(sizeof(T)) + 4);
  if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = opt_in(direct_kernel<T, S, MT>, smem, &opted_in);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((R + ROWS - 1) / ROWS), block(ROWS, LANES);
  direct_kernel<T, S, MT><<<grid, block, smem, st>>>(tbl, idx, w, out, Kt, N,
                                                     R, M, ldi);
  return static_cast<int>(cudaGetLastError());
}

// The (S, M) pairs of the model's step, on either edge numbering, get the
// kernel with M known at compile time; any other pair reads M at run time.
template <typename T, int S>
int launch_direct_s(const T* tbl, const int* idx, const T* w, T* out, int Kt,
                    int N, int R, int M, int ldi, cudaStream_t st) {
#define DIRECT_CASE(MT) \
  case MT: return launch_direct_sm<T, S, MT>(tbl, idx, w, out, Kt, N, R, M, ldi, st);
  if constexpr (S == 1) {
    switch (M) { DIRECT_CASE(3) DIRECT_CASE(6) DIRECT_CASE(7) DIRECT_CASE(10) }
  } else if constexpr (S == 2) {
    switch (M) { DIRECT_CASE(6) DIRECT_CASE(7) DIRECT_CASE(8) }
  } else if constexpr (S == 3) {
    switch (M) { DIRECT_CASE(6) DIRECT_CASE(7) }
  }
#undef DIRECT_CASE
  return launch_direct_sm<T, S, 0>(tbl, idx, w, out, Kt, N, R, M, ldi, st);
}

template <typename T>
int launch_direct(const void* tbl, const void* idx, const void* w, void* out,
                  int Kt, int N, int R, int M, int S, int ldi, void* stream) {
  if (Kt < 1 || R < 1 || M < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* t = static_cast<const T*>(tbl);
  const int* i = static_cast<const int*>(idx);
  const T* ww = static_cast<const T*>(w);
  T* o = static_cast<T*>(out);
  switch (S) {
    case 1: return launch_direct_s<T, 1>(t, i, ww, o, Kt, N, R, M, ldi, st);
    case 2: return launch_direct_s<T, 2>(t, i, ww, o, Kt, N, R, M, ldi, st);
    case 3: return launch_direct_s<T, 3>(t, i, ww, o, Kt, N, R, M, ldi, st);
    case 4: return launch_direct_s<T, 4>(t, i, ww, o, Kt, N, R, M, ldi, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---- row-read form --------------------------------------------------------

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

template <typename T, int S>
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

  for (int rl = warp; rl < RT; rl += RW) {
    const int r = r0 + rl;                                    // warp-uniform
    T acc[S][KL];
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int kk = 0; kk < KL; ++kk) acc[s][kk] = T(0);

    if (r < R) {
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

template <typename T, int S>
int launch_rows_s(const T* tblT, const int* idx, const T* w, T* out, int Kt,
                  int Ktp, int R, int M, int ldi, cudaStream_t st) {
  static bool opted_in = false;
  const int smem = S * KP * RLD * static_cast<int>(sizeof(T));
  cudaError_t e = opt_in(rows_kernel<T, S>, smem, &opted_in);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((R + RT - 1) / RT, (Kt + KP - 1) / KP);
  rows_kernel<T, S><<<grid, RW * 32, smem, st>>>(tblT, idx, w, out, Kt, Ktp,
                                                 R, M, ldi);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_rows(const void* tblT, const void* idx, const void* w, void* out,
                int Kt, int Ktp, int R, int M, int S, int ldi, void* stream) {
  if (Kt < 1 || R < 1 || M < 1 || Ktp < Kt)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* t = static_cast<const T*>(tblT);
  const int* i = static_cast<const int*>(idx);
  const T* ww = static_cast<const T*>(w);
  T* o = static_cast<T*>(out);
  switch (S) {
    case 1: return launch_rows_s<T, 1>(t, i, ww, o, Kt, Ktp, R, M, ldi, st);
    case 2: return launch_rows_s<T, 2>(t, i, ww, o, Kt, Ktp, R, M, ldi, st);
    case 3: return launch_rows_s<T, 3>(t, i, ww, o, Kt, Ktp, R, M, ldi, st);
    case 4: return launch_rows_s<T, 4>(t, i, ww, o, Kt, Ktp, R, M, ldi, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The build compiles this file twice, once per element type
// (-DGATHER_REDUCE_F32, -DGATHER_REDUCE_F64), so that the two sets of
// instantiations compile side by side; with neither macro it holds both.
#if !defined(GATHER_REDUCE_F32) && !defined(GATHER_REDUCE_F64)
#define GATHER_REDUCE_F32
#define GATHER_REDUCE_F64
#endif

// Each entry point returns the cudaError_t of its launch (0 on success); S
// must be 1..4. transpose_table: tbl [Kt, N] -> tblT [N, Ktp], columns
// Kt..Ktp-1 of tblT left unwritten.
#define GATHER_REDUCE_ENTRY_POINTS(T, SUFFIX)                                  \
  extern "C" int gather_reduce_direct_##SUFFIX(                                \
      const void* tbl, const void* idx, const void* w, void* out, int Kt,      \
      int N, int R, int M, int S, int ldi, void* stream) {                     \
    return launch_direct<T>(tbl, idx, w, out, Kt, N, R, M, S, ldi, stream);    \
  }                                                                            \
  extern "C" int transpose_table_##SUFFIX(const void* tbl, void* tblT, int Kt, \
                                          int N, int Ktp, void* stream) {      \
    return launch_transpose<T>(tbl, tblT, Kt, N, Ktp, stream);                 \
  }                                                                            \
  extern "C" int gather_reduce_rows_##SUFFIX(                                  \
      const void* tblT, const void* idx, const void* w, void* out, int Kt,     \
      int Ktp, int R, int M, int S, int ldi, void* stream) {                   \
    return launch_rows<T>(tblT, idx, w, out, Kt, Ktp, R, M, S, ldi, stream);   \
  }

#ifdef GATHER_REDUCE_F32
GATHER_REDUCE_ENTRY_POINTS(float, f32)
#endif
#ifdef GATHER_REDUCE_F64
GATHER_REDUCE_ENTRY_POINTS(double, f64)
#endif
