// Kernel 5: sedimentation of every falling species of a microphysics scheme,
// all `nfall` substeps, in one launch. CUDA C++ for sm_90a, float32 and
// float64.
//
//   for each species s (rain, snow, graupel: the fall law of each) and
//   column c, over nfall substeps of dtfall = dt / nfall:
//     vt[k]   = law(q[k], rho[k], rhofac[k])      capped at the law's bound
//     flux[k] = rho[k] q[k] vt[k]                 downward mass flux
//     q[k]    = max(q[k] + dtfall (flux[k+1] - flux[k]) / (rho[k] dz[k]), 0)
//               (flux[K] = 0: the top receives nothing)
//     acc     = acc + flux[0] dtfall              surface precipitation
//   with rhofac = sqrt(rho[0] / max(rho, 1e-12)) and every flux of a substep
//   taken from the q of the substep before.
//   q_s, rho, dz [K, C] level-major; q_out [S, K, C]; acc_out [S, C].
//
// Replaces the loop of mpas_tpu/physics/kessler.py:89 (`jax.lax.fori_loop`
// over `body`), which XLA fuses into few kernels on the TPU and which the
// port ran as 16 ATen launches a substep for each species (2544 launches of
// WSM6's step at nfall 53). The TPU has no counterpart kernel of its own.
//
// What bounds it on the H100: the bytes are few, each array read or written
// once (q, rho and dz in, q and the accumulation out: 54 MB at three species
// of [41, 40962] float32, 16 us at 3.35 TB/s). The work is a serial chain a
// column, nfall x K steps (53 x 41), each a `pow` (a few dozen instructions
// through the SFU's exp2/log2) and an IEEE division, so the rate at which
// the chains' instructions go out, not memory, sets the time.
//
// What the design does about it: one thread owns one column of one species
// (blockIdx.y is the species), so the chains of 3 x C columns run side by
// side and a warp's reads of one level touch 32 neighbouring columns. Each
// thread stages its column (q, rho, rhofac, rho dz) once into shared memory,
// laid out [K][4][THREADS] so that a warp reads one word of each of 32 banks
// and the offsets of neighbouring levels differ by constants the compiler
// sees; the substeps then read and write shared memory only, and the column
// goes back to device memory once. Blocks are one warp, so that as many
// columns as the shared memory holds are in flight on each SM (ten blocks at
// 41 levels in float32). No thread reads another's column: no barrier.
//
// Precision: the operations of the plain loop in its order, each rounded as
// its own ATen kernel rounds it (explicitly rounded intrinsics, so nothing
// is contracted into a fused multiply-add), `powf` / `pow` and `sqrtf` /
// `sqrt` at the state's precision, no fast-math intrinsics. Scalars are
// rounded to the state's type as ATen rounds a Python number, and graupel's
// division by a constant is a multiplication by its reciprocal, as ATen's
// division of a tensor by a Python number is on the card.

#include <cuda_runtime.h>
#include <cstddef>

namespace {

constexpr int THREADS = 32;          // columns a block: one warp
constexpr int MAX_SPECIES = 3;
constexpr int ARRAYS = 4;            // q, rho, rhofac, rho dz, a level
constexpr int MAX_SMEM = 227 * 1024;

// the fall laws, as physics/kessler.py and physics/wsm6.py state them
enum Law : int { RAIN = 0, SNOW = 1, GRAUPEL = 2 };
constexpr double RAIN_COEF = 36.34;          // kessler._fall_velocity
constexpr double RAIN_SCALE = 0.001;
constexpr double RAIN_EXPONENT = 0.1364;
constexpr double MAX_VT = 15.0;              // kessler.MAX_VT
constexpr double SNOW_COEF = 11.72;          // wsm6._snow_fall_velocity
constexpr double SNOW_EXPONENT = 0.25;
constexpr double MAX_VT_SNOW = 8.0;          // wsm6.MAX_VT_SNOW
constexpr double GRAUPEL_VCOEF = 981.0;      // wsm6.GRAUPEL_VCOEF
constexpr double GRAUPEL_PIRN = 6.2832e9;    // wsm6.GRAUPEL_PIRN
constexpr double GRAUPEL_EXPONENT = 0.2;
constexpr double MAX_VT_GRAUPEL = 15.0;      // wsm6.MAX_VT_GRAUPEL
constexpr double RHO_MIN = 1e-12;            // kessler.density_factor

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float divide(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double divide(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float power(float a, float b) { return powf(a, b); }
__device__ __forceinline__ double power(double a, double b) { return pow(a, b); }
__device__ __forceinline__ float root(float a) { return sqrtf(a); }
__device__ __forceinline__ double root(double a) { return sqrt(a); }

// torch.clamp's min= and max=: a NaN passes through
template <typename T>
__device__ __forceinline__ T at_least(T x, T lo) { return x < lo ? lo : x; }
template <typename T>
__device__ __forceinline__ T at_most(T x, T hi) { return x > hi ? hi : x; }

template <typename T, int LAW>
__device__ __forceinline__ T fall_speed(T q, T rho, T rhofac) {
  if (LAW == RAIN) {
    // 36.34 * clamp(q * rho * 0.001, min=0) ** 0.1364 * rhofac
    const T x = at_least(mul(mul(q, rho), T(RAIN_SCALE)), T(0));
    return at_most(mul(mul(T(RAIN_COEF), power(x, T(RAIN_EXPONENT))), rhofac),
                   T(MAX_VT));
  } else if (LAW == SNOW) {
    // 11.72 * clamp(rho * q, min=0) ** 0.25 * rhofac
    const T x = at_least(mul(rho, q), T(0));
    return at_most(mul(mul(T(SNOW_COEF), power(x, T(SNOW_EXPONENT))), rhofac),
                   T(MAX_VT_SNOW));
  } else {
    // 981 * (clamp(rho * q, min=0) / GRAUPEL_PIRN) ** 0.2 * rhofac
    const T inv_pirn = divide(T(1), T(GRAUPEL_PIRN));
    const T x = mul(at_least(mul(rho, q), T(0)), inv_pirn);
    return at_most(mul(mul(T(GRAUPEL_VCOEF), power(x, T(GRAUPEL_EXPONENT))),
                       rhofac),
                   T(MAX_VT_GRAUPEL));
  }
}

// one column of one species through every substep; `col` is the thread's
// [K][ARRAYS][THREADS] slice of shared memory (offset by its lane)
template <typename T, int LAW>
__device__ void fall(const T* __restrict__ q_in, const T* __restrict__ rho_g,
                     const T* __restrict__ dz_g, T* __restrict__ q_out,
                     T* __restrict__ acc_out, T* col, int K, int C, int c,
                     int nfall, T dtfall) {
  constexpr int Q = 0, RHO = THREADS, FAC = 2 * THREADS, RDZ = 3 * THREADS;
  constexpr int LEVEL = ARRAYS * THREADS;
  const T rho0 = rho_g[c];
  for (int k = 0; k < K; ++k) {
    const size_t g = static_cast<size_t>(k) * C + c;
    const T r = rho_g[g];
    T* lv = col + k * LEVEL;
    lv[Q] = q_in[g];
    lv[RHO] = r;
    lv[FAC] = root(divide(rho0, at_least(r, T(RHO_MIN))));
    lv[RDZ] = mul(r, dz_g[g]);
  }
  T acc = T(0);
  for (int n = 0; n < nfall; ++n) {
    T flux_in = T(0);                   // what falls into level k from above
#pragma unroll 4
    for (int k = K - 1; k >= 0; --k) {
      T* lv = col + k * LEVEL;
      const T q = lv[Q];
      const T r = lv[RHO];
      const T flux = mul(mul(r, q), fall_speed<T, LAW>(q, r, lv[FAC]));
      lv[Q] = at_least(add(q, divide(mul(dtfall, sub(flux_in, flux)), lv[RDZ])),
                       T(0));
      flux_in = flux;
    }
    acc = add(acc, mul(flux_in, dtfall));   // flux_in is now flux[0]
  }
  for (int k = 0; k < K; ++k)
    q_out[static_cast<size_t>(k) * C + c] = col[k * LEVEL + Q];
  acc_out[c] = acc;
}

template <typename T>
struct Species {
  const T* q[MAX_SPECIES];
  int law[MAX_SPECIES];
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
sediment_kernel(Species<T> sp, const T* __restrict__ rho,
                const T* __restrict__ dz, T* __restrict__ q_out,
                T* __restrict__ acc_out, int K, int C, int nfall, T dtfall) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* col = reinterpret_cast<T*>(smem_raw) + threadIdx.x;
  const int c = blockIdx.x * THREADS + threadIdx.x;
  if (c >= C) return;
  const int s = blockIdx.y;
  const T* q = sp.q[s];
  T* qo = q_out + static_cast<size_t>(s) * K * C;
  T* ao = acc_out + static_cast<size_t>(s) * C;
  switch (sp.law[s]) {
    case RAIN:
      fall<T, RAIN>(q, rho, dz, qo, ao, col, K, C, c, nfall, dtfall);
      break;
    case SNOW:
      fall<T, SNOW>(q, rho, dz, qo, ao, col, K, C, c, nfall, dtfall);
      break;
    default:
      fall<T, GRAUPEL>(q, rho, dz, qo, ao, col, K, C, c, nfall, dtfall);
      break;
  }
}

template <typename T>
int launch(const void* const* q, const int* law, int nspecies,
           const void* rho, const void* dz, void* q_out, void* acc_out, int K,
           int C, int nfall, double dtfall, void* stream) {
  static int opted_smem = 48 * 1024;
  if (K < 1 || C < 1 || nfall < 1 || nspecies < 1 || nspecies > MAX_SPECIES)
    return static_cast<int>(cudaErrorInvalidValue);
  Species<T> sp = {};
  for (int s = 0; s < nspecies; ++s) {
    if (law[s] < RAIN || law[s] > GRAUPEL || q[s] == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    sp.q[s] = static_cast<const T*>(q[s]);
    sp.law[s] = law[s];
  }
  const size_t smem = static_cast<size_t>(K) * ARRAYS * THREADS * sizeof(T);
  if (smem > static_cast<size_t>(MAX_SMEM))
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<int>(smem) > opted_smem) {
    cudaError_t e = cudaFuncSetAttribute(
        sediment_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        MAX_SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_smem = MAX_SMEM;
  }
  const dim3 grid((C + THREADS - 1) / THREADS, nspecies);
  sediment_kernel<T><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      sp, static_cast<const T*>(rho), static_cast<const T*>(dz),
      static_cast<T*>(q_out), static_cast<T*>(acc_out), K, C, nfall,
      static_cast<T>(dtfall));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q0..q2: the species' [K, C] inputs (those past nspecies are ignored),
// law0..law2 their fall laws (0 rain, 1 snow, 2 graupel); writes q_out
// [nspecies, K, C] and acc_out [nspecies, C]. Returns the cudaError_t of the
// launch (0 on success); cudaErrorInvalidValue where an argument is out of
// range or the column does not fit in a block's shared memory.
#define SEDIMENT_ENTRY_POINT(T, SUFFIX)                                        \
  extern "C" int sediment_species_##SUFFIX(                                    \
      const void* q0, const void* q1, const void* q2, int law0, int law1,      \
      int law2, int nspecies, const void* rho, const void* dz, void* q_out,    \
      void* acc_out, int K, int C, int nfall, double dtfall, void* stream) {   \
    const void* q[MAX_SPECIES] = {q0, q1, q2};                                 \
    const int law[MAX_SPECIES] = {law0, law1, law2};                           \
    return launch<T>(q, law, nspecies, rho, dz, q_out, acc_out, K, C, nfall,   \
                     dtfall, stream);                                          \
  }

SEDIMENT_ENTRY_POINT(float, f32)
SEDIMENT_ENTRY_POINT(double, f64)
