// Fused acoustic column update: a CTA owns a tile of adjacent columns and all
// their levels, its threads spread over (column, level lane). CUDA C++ for
// sm_90a.
//
// Replaces the TPU kernel mpas_tpu/ops/pallas_acoustic.py:_kernel (reached
// through acoustic_column_update). It computes what that kernel computes:
//   - the rs/ts right-hand sides with resm off-centring;
//   - the implicit-w right-hand side on interfaces 1..K-1;
//   - forward and backward substitution with the pre-factored
//     a_tri/alpha_tri/gamma_tri;
//   - implicit Rayleigh damping of w;
//   - the wwAvg accumulation;
//   - the rho_pp/rtheta_pp recovery.
//
// What bounds it on the H100: memory. Per column it does ~60 flops per
// level against ~23 words read or written per level, far below the card's
// ridge point. At K=41, C=40962 in float32 the least traffic is
//   6 [K]-row inputs (rs0, ts0, rho_pp, rtheta_pp, cofwt, zz)
// + 13 [K+1]-row inputs (rw_p, wwAvg, tend_w, cofwz, coftz, cofwr, a_tri,
//   alpha_tri, gamma_tri, dss_i, zz_rho_i, w, dw_save)
// + 4 outputs (2 [K], 2 [K+1])
// = 958 rows x 40962 x 4 B = 157 MB, about 47 us at 3.35 TB/s (tend_rho and
// tend_rt add 2 [K] rows where they are given). To come near that time a
// kernel must keep megabytes of loads in flight; one thread per column
// walking its levels, the first design, kept ~10 warps an SM busy with one
// dependent chain each and sat at 29% of the bound.
//
// What the design does about it. The only recurrences of the function are
// the two substitution sweeps; everything else is pointwise in (level,
// column) with neighbours one level up or down. So a CTA takes a tile of TC
// adjacent columns (blockDim.x; one level's row segment is then at most one
// 128-byte line) and all K levels, with LY level lanes (blockDim.y): lane y
// handles levels y, y + LY, ... Values a neighbouring level or a later phase
// needs live in PLANES shared-memory planes of [K+1][TC]; a warp reads and
// writes a plane at 32 adjacent words, so no access conflicts.
//   1. all threads: load every input of their levels, all 22 arrays in one
//      pass (a warp reads one or two levels' adjacent words; with every
//      load of the CTA started before anything waits on a neighbour, this is
//      where the latency goes), form rs and ts, and stage them with what a
//      neighbouring level or a later step needs: rho_pp, rtheta_pp, zz,
//      cofwt, rw_p, coftz, cofwz, cofwr, the three tridiagonal factors, the
//      damping terms and wwAvg;
//   2. all threads: the right-hand side at interfaces 1..K-1 from the planes
//      of levels k and k-1;
//   3. TC threads (lane 0) run the forward and the backward substitution in
//      shared memory only, in the order of the plain version; the SM's
//      other CTAs hide it (timed without the sweeps the kernel is no
//      faster);
//   4. all threads: damping, rw_p_out, wwAvg_out; then the recovery of
//      rho_pp_out / rtheta_pp_out from the staged rs / ts and the damped
//      rw_p of levels k and k+1.
// Steps 2 to 4 touch shared memory only (and cofrz [K]). Step 1's loads are
// unconditional and stand before any use, so a thread has ~24 of them in
// flight at once; with the loads of the boundary interfaces and of the
// interior ones in separate branches, each waited for before the next was
// started, the same kernel was slower.
// Every input element is loaded once (rw_p and coftz of level k+1 a second
// time by the lane next door, out of L1) and every output stored once: the
// traffic is the bound's. Loads are 4 or 8 bytes a thread: a float32 row of
// C = 40962 is not a multiple of 16 bytes, so wider loads, 16-byte cp.async
// and TMA do not fit the state's layout. Columns beyond C in the last tile
// load and store nothing but keep every barrier. The wrapper
// (ops/acoustic_column.py, `column_tile`) picks TC from K and the element
// size and passes the shared-memory byte count.

#include <cuda_runtime.h>
#include <cstddef>

namespace {

constexpr int PLANES = 18;         // shared planes of [K+1][TC]
constexpr int MAX_THREADS = 1024;  // TC * LY at most
constexpr int MAX_SMEM = 232448;   // 227 KB, Hopper's per-block limit

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS)
acoustic_tile_kernel(
    const T* __restrict__ rs0, const T* __restrict__ ts0,
    const T* __restrict__ rho_pp, const T* __restrict__ rtheta_pp,
    const T* __restrict__ rw_p, const T* __restrict__ wwAvg,
    const T* __restrict__ tend_rho, const T* __restrict__ tend_rt,
    const T* __restrict__ tend_w, const T* __restrict__ cofrz,
    const T* __restrict__ cofwz, const T* __restrict__ coftz,
    const T* __restrict__ cofwr, const T* __restrict__ cofwt,
    const T* __restrict__ a_tri, const T* __restrict__ alpha_tri,
    const T* __restrict__ gamma_tri, const T* __restrict__ zz,
    const T* __restrict__ dss_i, const T* __restrict__ zz_rho_i,
    const T* __restrict__ w, const T* __restrict__ dw_save,
    T* __restrict__ rho_pp_out, T* __restrict__ rtheta_pp_out,
    T* __restrict__ rw_p_out, T* __restrict__ wwAvg_out,
    int K, int C, T dts, T epssm) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int TC = blockDim.x, LY = blockDim.y;
  const int cx = threadIdx.x, ly = threadIdx.y;
  const int plane = (K + 1) * TC;
  T* s_rs = sm;                  // rs, levels 0..K-1
  T* s_ts = sm + plane;          // ts
  T* s_rpp = sm + 2 * plane;     // rho_pp
  T* s_rtpp = sm + 3 * plane;    // rtheta_pp
  T* s_zz = sm + 4 * plane;      // zz
  T* s_cofwt = sm + 5 * plane;   // cofwt
  T* s_rw = sm + 6 * plane;      // rw_p, interfaces 0..K
  T* s_ctz = sm + 7 * plane;     // coftz
  T* s_a = sm + 8 * plane;       // a_tri
  T* s_alpha = sm + 9 * plane;   // alpha_tri
  T* s_gamma = sm + 10 * plane;  // gamma_tri
  T* s_x = sm + 11 * plane;      // rw_p + dts*tend_w -> rhs -> forward sweep
                                 // -> solved w -> damped rw_p
  T* s_cofwz = sm + 12 * plane;  // cofwz, interfaces 1..K-1
  T* s_cofwr = sm + 13 * plane;  // cofwr
  T* s_t1 = sm + 14 * plane;     // dts*dss_i*zz_rho_i*w
  T* s_dws = sm + 15 * plane;    // dw_save
  T* s_den = sm + 16 * plane;    // 1 + dts*dss_i
  T* s_ww = sm + 17 * plane;     // wwAvg, interfaces 0..K

  const int c = blockIdx.x * TC + cx;
  const bool active = c < C;
  const size_t Cs = static_cast<size_t>(C);
#define AT(p, k) (p)[static_cast<size_t>(k) * Cs + c]
#define SM(p, k) (p)[(k) * TC + cx]

  const T one = T(1);
  const T resm = (one - epssm) / (one + epssm);
  const T dtseps = T(0.5) * dts * (one + epssm);

  // ---- 1. every input of the thread's levels; rs and ts ----
  // The loads come first and are unconditional, so that all of them are in
  // flight before the first one is waited for: interface 0 or K loads the
  // interior arrays at the nearest interior interface and level K loads the
  // level arrays at level K-1, and neither uses what it loaded there.
  if (active) {
    const int ki_max = K > 1 ? K - 1 : 1;
    for (int k = ly; k <= K; k += LY) {
      const int ki = min(max(k, 1), ki_max);
      const int kl = min(k, K - 1);
      const T rw_k = AT(rw_p, k);
      const T coftz_k = AT(coftz, k);
      const T ww_k = AT(wwAvg, k);
      const T a_k = AT(a_tri, ki);
      const T alpha_k = AT(alpha_tri, ki);
      const T gamma_k = AT(gamma_tri, ki);
      const T cofwz_k = AT(cofwz, ki);
      const T cofwr_k = AT(cofwr, ki);
      const T dss = AT(dss_i, ki);
      const T zri = AT(zz_rho_i, ki);
      const T w_k = AT(w, ki);
      const T dws = AT(dw_save, ki);
      const T tw = AT(tend_w, ki);
      const T rw_k1 = AT(rw_p, kl + 1);
      const T coftz_k1 = AT(coftz, kl + 1);
      const T cofrz_k = cofrz[kl];
      const T rpp = AT(rho_pp, kl);
      const T rtpp = AT(rtheta_pp, kl);
      const T rs0_k = AT(rs0, kl);
      const T ts0_k = AT(ts0, kl);
      const T zz_k = AT(zz, kl);
      const T cofwt_k = AT(cofwt, kl);
      const T trho = tend_rho != nullptr ? AT(tend_rho, kl) : T(0);
      const T trt = tend_rt != nullptr ? AT(tend_rt, kl) : T(0);

      SM(s_rw, k) = rw_k;
      SM(s_ctz, k) = coftz_k;
      SM(s_ww, k) = ww_k;
      T x = T(0);
      if (k >= 1 && k < K) {
        SM(s_a, k) = a_k;
        SM(s_alpha, k) = alpha_k;
        SM(s_gamma, k) = gamma_k;
        SM(s_cofwz, k) = cofwz_k;
        SM(s_cofwr, k) = cofwr_k;
        SM(s_t1, k) = dts * dss * zri * w_k;
        SM(s_dws, k) = dws;
        SM(s_den, k) = one + dts * dss;
        x = rw_k + dts * tw;
      }
      SM(s_x, k) = x;
      if (k < K) {
        const T ctz_k = coftz_k * rw_k;
        const T ctz_k1 = coftz_k1 * rw_k1;
        const T rdzw_k = cofrz_k / dtseps;
        T rs = rpp;
        if (tend_rho != nullptr) rs += dts * trho;
        rs = rs + rs0_k - cofrz_k * resm * (rw_k1 - rw_k);
        T ts = rtpp;
        if (tend_rt != nullptr) ts += dts * trt;
        ts = ts + ts0_k - resm * rdzw_k * (ctz_k1 - ctz_k);
        SM(s_rs, k) = rs;
        SM(s_ts, k) = ts;
        SM(s_rpp, k) = rpp;
        SM(s_rtpp, k) = rtpp;
        SM(s_zz, k) = zz_k;
        SM(s_cofwt, k) = cofwt_k;
      }
    }
  }
  __syncthreads();

  // ---- 2. the implicit-w right-hand side, interfaces 1..K-1 ----
  if (active) {
    for (int k = ly; k <= K; k += LY) {
      if (k >= 1 && k < K) {
        const T rs = SM(s_rs, k), rs_m = SM(s_rs, k - 1);
        const T ts = SM(s_ts, k), ts_m = SM(s_ts, k - 1);
        const T rpp = SM(s_rpp, k), rpp_m = SM(s_rpp, k - 1);
        const T rtpp = SM(s_rtpp, k), rtpp_m = SM(s_rtpp, k - 1);
        const T zz_k = SM(s_zz, k), zz_m = SM(s_zz, k - 1);
        const T cofwt_k = SM(s_cofwt, k), cofwt_m = SM(s_cofwt, k - 1);
        SM(s_x, k) = SM(s_x, k)
            - SM(s_cofwz, k) * ((zz_k * ts - zz_m * ts_m)
                                + resm * (zz_k * rtpp - zz_m * rtpp_m))
            - SM(s_cofwr, k) * ((rs + rs_m) + resm * (rpp + rpp_m))
            + cofwt_k * (ts + resm * rtpp)
            + cofwt_m * (ts_m + resm * rtpp_m);
      }
    }
  }
  __syncthreads();

  // ---- 3. the sweeps, one thread a column ----
  if (active && ly == 0) {
    T wf = T(0);
    for (int k = 1; k < K; ++k) {
      wf = (SM(s_x, k) - SM(s_a, k) * wf) * SM(s_alpha, k);
      SM(s_x, k) = wf;
    }
    T wb = T(0);
    for (int k = K - 1; k >= 1; --k) {
      wb = SM(s_x, k) - SM(s_gamma, k) * wb;
      SM(s_x, k) = wb;
    }
  }
  __syncthreads();

  // ---- 4a. damping, rw_p_out, wwAvg_out ----
  if (active) {
    for (int k = ly; k <= K; k += LY) {
      T rwn = T(0);
      T ww = SM(s_ww, k);
      if (k >= 1 && k < K) {
        const T dws = SM(s_dws, k);
        rwn = (SM(s_x, k) + dws - SM(s_t1, k)) / SM(s_den, k) - dws;
        ww = ww + (T(0.5) * (one - epssm) * SM(s_rw, k)
                   + T(0.5) * (one + epssm) * rwn);
        SM(s_x, k) = rwn;
      }
      AT(rw_p_out, k) = rwn;
      AT(wwAvg_out, k) = ww;
    }
  }
  __syncthreads();

  // ---- 4b. recovery of rho_pp and rtheta_pp ----
  if (active) {
    for (int k = ly; k < K; k += LY) {
      const T rwn = SM(s_x, k), rwn_p = SM(s_x, k + 1);
      const T ctzn = SM(s_ctz, k) * rwn, ctzn_p = SM(s_ctz, k + 1) * rwn_p;
      const T cofrz_k = cofrz[k];
      const T rdzw_k = cofrz_k / dtseps;
      AT(rho_pp_out, k) = SM(s_rs, k) - cofrz_k * (rwn_p - rwn);
      AT(rtheta_pp_out, k) = SM(s_ts, k) - rdzw_k * (ctzn_p - ctzn);
    }
  }
#undef AT
#undef SM
}

// What a launch with this tile is allowed: cudaSuccess, or the error the
// launch would be refused with.
template <typename T>
cudaError_t tile_ok(int K, int tile_columns, int level_lanes, int smem_bytes) {
  if (K < 1 || tile_columns < 1 || level_lanes < 1 ||
      tile_columns * level_lanes > MAX_THREADS ||
      smem_bytes != PLANES * (K + 1) * tile_columns *
                        static_cast<int>(sizeof(T)) ||
      smem_bytes > MAX_SMEM)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// Dynamic shared memory above 48 KB needs the opt-in, once per instantiation.
template <typename T>
cudaError_t opt_in(int smem_bytes) {
  static bool done = false;
  if (smem_bytes <= 48 * 1024 || done) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      acoustic_tile_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      MAX_SMEM);
  if (e == cudaSuccess) done = true;
  return e;
}

template <typename T>
int launch(void* const* p, int K, int C, double dts, double epssm,
           int tile_columns, int level_lanes, int smem_bytes, void* stream) {
  cudaError_t e = tile_ok<T>(K, tile_columns, level_lanes, smem_bytes);
  if (e == cudaSuccess && C < 1) e = cudaErrorInvalidValue;
  if (e == cudaSuccess) e = opt_in<T>(smem_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((C + tile_columns - 1) / tile_columns);
  const dim3 block(tile_columns, level_lanes);
  auto in = [p](int i) { return static_cast<const T*>(p[i]); };
  auto out = [p](int i) { return static_cast<T*>(p[22 + i]); };
  acoustic_tile_kernel<T><<<grid, block, smem_bytes,
                            static_cast<cudaStream_t>(stream)>>>(
      in(0), in(1), in(2), in(3), in(4), in(5), in(6), in(7), in(8), in(9),
      in(10), in(11), in(12), in(13), in(14), in(15), in(16), in(17), in(18),
      in(19), in(20), in(21), out(0), out(1), out(2), out(3), K, C,
      static_cast<T>(dts), static_cast<T>(epssm));
  return static_cast<int>(cudaGetLastError());
}

// CTAs of this tile that fit on one SM (0 or below: -cudaError_t).
template <typename T>
int resident(int K, int tile_columns, int level_lanes, int smem_bytes) {
  cudaError_t e = tile_ok<T>(K, tile_columns, level_lanes, smem_bytes);
  if (e == cudaSuccess) e = opt_in<T>(smem_bytes);
  int n = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, acoustic_tile_kernel<T>, tile_columns * level_lanes, smem_bytes);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

}  // namespace

#define ACOUSTIC_ARGS                                                       \
  void *rs0, void *ts0, void *rho_pp, void *rtheta_pp, void *rw_p,          \
      void *wwAvg, void *tend_rho, void *tend_rt, void *tend_w, void *cofrz, \
      void *cofwz, void *coftz, void *cofwr, void *cofwt, void *a_tri,      \
      void *alpha_tri, void *gamma_tri, void *zz, void *dss_i,              \
      void *zz_rho_i, void *w, void *dw_save, void *rho_pp_out,             \
      void *rtheta_pp_out, void *rw_p_out, void *wwAvg_out, int K, int C,   \
      double dts, double epssm, int tile_columns, int level_lanes,          \
      int smem_bytes, void *stream
#define ACOUSTIC_PTRS                                                       \
  void* p[26] = {rs0, ts0, rho_pp, rtheta_pp, rw_p, wwAvg, tend_rho,        \
                 tend_rt, tend_w, cofrz, cofwz, coftz, cofwr, cofwt, a_tri, \
                 alpha_tri, gamma_tri, zz, dss_i, zz_rho_i, w, dw_save,     \
                 rho_pp_out, rtheta_pp_out, rw_p_out, wwAvg_out}

extern "C" {

// Returns the cudaError_t of the launch (0 on success). `tile_columns` x
// `level_lanes` threads a CTA; `smem_bytes` must be PLANES * (K + 1) *
// tile_columns * the element size.
int acoustic_column_update_f32(ACOUSTIC_ARGS) {
  ACOUSTIC_PTRS;
  return launch<float>(p, K, C, dts, epssm, tile_columns, level_lanes,
                       smem_bytes, stream);
}

int acoustic_column_update_f64(ACOUSTIC_ARGS) {
  ACOUSTIC_PTRS;
  return launch<double>(p, K, C, dts, epssm, tile_columns, level_lanes,
                        smem_bytes, stream);
}

// CTAs of that tile resident on one SM, as the occupancy calculator counts
// them; a negative value is minus the cudaError_t.
int acoustic_column_resident_f32(int K, int tile_columns, int level_lanes,
                                 int smem_bytes) {
  return resident<float>(K, tile_columns, level_lanes, smem_bytes);
}

int acoustic_column_resident_f64(int K, int tile_columns, int level_lanes,
                                 int smem_bytes) {
  return resident<double>(K, tile_columns, level_lanes, smem_bytes);
}

const char* mpas_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
