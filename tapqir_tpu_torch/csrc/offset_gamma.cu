// Offset-marginalized Gamma log-likelihood kernels for Hopper (sm_90a).
//
// Replaces the five TPU Pallas kernel bodies of tapqir_tpu/ops/offset_gamma.py:
//   _fwd_kernel        (:137)  -> offset_gamma_pixel_kernel   STATS = false
//   _fwd_stats_kernel  (:151)  -> offset_gamma_pixel_kernel   STATS = true
//   _sum_fwd_kernel    (:365)  -> offset_gamma_summed_kernel  STATS = false
//   _sum_stats_kernel  (:384)  -> offset_gamma_summed_kernel  STATS = true
//   _fact_stats_kernel (:520)  -> offset_gamma_summed_kernel  STATS = true, FACT = true
// For config m and pixel i (x = value, a = concentration, b = the rate,
// g_j / w_j = offset bins and their log weights) each computes
//
//   lp[m, i] = lse_j[w_j + (a-1) log(x-g_j) - b (x-g_j)] + a log b - lgamma(a)
//                                                        (masked to x > g_j)
// and, with STATS, the per-pixel gradient statistics the backward uses:
//   spl[m, i] = sum_j p_j log(x-g_j) + log b - digamma(a)   (= d lp / da)
//   spd[m, i] = a / b - sum_j p_j (x-g_j)                    (= d lp / db)
// with p_j the softmax weights of the lse.
//  * pixel kernel: lp, spl, spd per pixel of a flat (n_px,) value, as
//    (M, n_px) arrays.
//  * summed kernel: lp summed over each image's first ev pixels of an
//    (nb, EVP) value, as (M, nb); spl, spd per pixel, 0 on lanes i >= ev.
//  * FACT: the concentration is not read but built in registers,
//    a_m = base[n] + sum_k bit_k(mask_m) delta_k[n, i] (Kf <= 6 spot
//    factors, M <= 64 configs), so the (M, nb, EVP) concentration never
//    exists in memory: only x, base and the Kf deltas are read.
//
// What bounds them on this card: not memory. At the slice shapes (M=4
// configs, nb=5120 images of ev=196 pixels, J=61 bins) the summed stats
// kernel moves ~68 MB (0.02 ms at 3.35 TB/s) but evaluates up to 61.2 M
// (pixel, bin) pairs, each with 1 log, M exps and the configs' sums. Two
// limits of an SM meet there:
//  * instruction issue: 4 schedulers x 32 lanes, 128 thread-instructions
//    per SM per clock;
//  * the special-function unit (MUFU: ex2, lg2): 16 results per SM per
//    clock. The 1 + M = 5 MUFU operations per pair are a floor of ~0.07 ms
//    for 61.2 M pairs on 132 SMs at 1980 MHz, whatever else is done.
// The accurate logf is a polynomial (no MUFU) and expf range reduction
// around one MUFU operation, and an online logsumexp that rescales at every
// (config, bin) adds a compare, an exp of -|t - mx|, three selects and two
// multiplies: a loop built that way issued 104 (forward) and 121 (with
// statistics) SASS instructions per pair at M=4.
//
// All five kernels share one bin loop (lse_tiles):
//  * float32 works in base 2 on the MUFU: g_j and w_j log2(e) sit in
//    shared memory as one float2 per bin (one 64-bit load), the rate as
//    b log2(e); per (pixel, bin) one lg2.approx of d, per (config, bin) one
//    ex2.approx; the tail goes back to natural units once per (pixel,
//    config) by ln 2 and takes the accurate logf of the sum. d is clamped
//    to FLT_MIN before lg2 (whose ftz form reads a denormal as 0), so a
//    difference in (0, FLT_MIN) gives log2 = -126, never -inf, which a < 1
//    would turn into +inf and NaN. lgamma, the digamma series and the
//    float64 instance keep the accurate sequences (no --use_fast_math).
//  * the running max per config stays exact but is rescaled once per tile
//    of kTile bins: the tile's terms t are formed, their max taken, the
//    sums rescaled by one exp2(old - new) only where the max rose, then
//    each term adds exp2(t - max), e L and e d with plain FMAs: the SASS
//    loop issues 41 instructions and 5.5 MUFU operations per pair at M=4
//    with statistics, 31 without. The bins are padded to whole tiles in
//    shared memory with offsets at +inf, masked like any bin above the
//    pixel. Measured on an H100 (700 W, 1980 MHz) the loop runs at ~0.49
//    instructions per scheduler per clock, about issue time plus MUFU time,
//    and 2.1x faster than the summed kernel built on the loop above.
//  * configs are processed in register chunks of CH (a template parameter),
//    so any M works; M beyond CH repeats the log per chunk.
//
// Summed kernel (all three of its instances at CH = kChunk):
//  * full warps: a 256-thread block walks the flat real pixels of several
//    images (kImagesPerBlock, fewer when the per-pixel buffer below would
//    outgrow kPartialBytes), so at most one warp of a block is partly idle,
//    where a block of 224 threads per 196-pixel image ran a seventh warp
//    with 4 live lanes; neighbouring threads read and write neighbouring
//    lanes of an image.
//  * per-image sums without atomics: each pixel's lp goes to a shared
//    (config, pixel) buffer, and one warp per (config, image) sums it in a
//    fixed order (strided lane sums, then shuffles), out written as (M, nb)
//    directly; two launches on the same inputs give bitwise-equal outputs.
//  * runs of images: the nb images may come as nb / nbr equal runs, run r
//    with its own rate rate[r] (the R chains of a batched restart step: the
//    fold that vmap makes of the Pallas grid, whose rate sits in SMEM).
//    Grid row r takes run r and its blocks split the run as a launch over
//    that run alone would, so each image comes out bitwise as in R
//    single-rate launches. nbr = nb is the single-rate call.
//
// Pixel kernel: a thread per pixel of a 256-thread block (a grid-stride
// loop only beyond kMaxPixelBlocks blocks), out, spl and spd written
// straight to (M, n_px), so neighbouring threads read and write
// neighbouring addresses, and no sum crosses threads. Its chunk is sized to
// M (CH = 1 for M = 1, 2 for M = 2, else kChunk): KSMOGN.log_prob runs at
// M = 1, where a chunk of 4 spent three quarters of the loop on configs
// that do not exist. At CH = 1 the loop issues 13.75 instructions and
// 2.125 MUFU operations per pair (16.75 with statistics). Measured on an
// H100 (700 W) at 1,003,520 pixels and J = 61: 0.105 / 0.139 ms (forward /
// statistics) at M = 4 and 0.043 / 0.053 ms at M = 1, 2.1-5.3x the first
// design; four pixels per thread ran 6-11% slower. The base-2 log moves
// the forward's largest error from the float64 value from 7.4e-5 to
// 9.9e-5 there (0.46 of the tolerance of tests/test_pallas.py); the
// accurate logf for L cost 44-128% more time.
//
// The factored instance keeps the exact running max per config (M exps per
// pair) rather than the Pallas kernel's factored form (1 + Kf exps, each
// factor shifted by per-pixel analytic bounds): the bounds are loose by the
// spread of w_j - b (x - g_j) over the bins, and in float32 a spread beyond
// ~87 underflows every shifted term of a pixel (a wide offset histogram or
// a small gain gets there), while the running max is exact for any input.
// At cosmos's Kf = 2 the factored form would save one MUFU op in five. Its
// edge cases come out as the Pallas kernel's: base < 1 needs no shift to
// flip, and a pixel below every bin ends near -1e30.
//
// A pixel below every bin keeps t = NEG for every j and ends at NEG + log
// (bins counted) - finite, about -1e30 - as the TPU kernels do.
// lgamma comes from CUDA's math library; digamma is the Stirling series of
// the JAX package (_digamma_stirling: absolute error < 7e-8 plus round-off).

#include <cfloat>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kMaxJ = 1024;  // a multiple of kTile
constexpr int kChunk = 4;    // configs per register chunk (largest)
constexpr int kMaxFactors = 6;
constexpr int kMaxConfigs = 64;
constexpr int kTile = 8;              // bins per rescale of the running max
constexpr int kSumThreads = 256;      // summed kernel: threads per block
constexpr int kImagesPerBlock = 4;    // summed kernel: images per block
constexpr int kPartialBytes = 32768;  // summed kernel: per-pixel lp buffer
constexpr int kPixelThreads = 256;    // pixel kernel: threads per block
constexpr int kMaxPixelBlocks = 1 << 20;  // pixel kernel: grid-stride beyond
constexpr int kMaxRuns = 65535;          // summed kernel: rate runs (grid rows)

template <typename T> __device__ __forceinline__ T dlog(T v);
template <> __device__ __forceinline__ float dlog<float>(float v) { return logf(v); }
template <> __device__ __forceinline__ double dlog<double>(double v) { return log(v); }
template <typename T> __device__ __forceinline__ T dmax(T u, T v);
template <> __device__ __forceinline__ float dmax<float>(float u, float v) { return fmaxf(u, v); }
template <> __device__ __forceinline__ double dmax<double>(double u, double v) { return fmax(u, v); }
template <typename T> __device__ __forceinline__ T dlgamma(T v);
template <> __device__ __forceinline__ float dlgamma<float>(float v) { return lgammaf(v); }
template <> __device__ __forceinline__ double dlgamma<double>(double v) { return lgamma(v); }

// The log and exp inside the bin loop, and its units: base 2
// on the special-function unit in float32 (terms scaled by kScale = log2 e,
// brought back by kUnit = ln 2), natural base and the accurate sequences in
// float64.
template <typename T> struct BinArith;
template <> struct BinArith<float> {
  static constexpr float kScale = 1.4426950408889634f;
  static constexpr float kUnit = 0.6931471805599453f;
  static __device__ __forceinline__ float log(float d) {
    float y;
    asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(fmaxf(d, FLT_MIN)));
    return y;
  }
  static __device__ __forceinline__ float exp(float v) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(v));
    return y;
  }
};
template <> struct BinArith<double> {
  static constexpr double kScale = 1.0;
  static constexpr double kUnit = 1.0;
  static __device__ __forceinline__ double log(double d) { return ::log(d); }
  static __device__ __forceinline__ double exp(double v) { return ::exp(v); }
};

// one offset bin in shared memory: one 64-bit (float) or 128-bit load
template <typename T>
struct alignas(2 * sizeof(T)) Bin {
  T g;  // offset
  T w;  // log weight, times kScale
};

// digamma(a), a > 0: four-step recurrence to z = a + 4, Stirling series
// through z^-6 (tapqir_tpu/ops/offset_gamma.py:_digamma_stirling).
template <typename T>
__device__ __forceinline__ T digamma_stirling(T a) {
  T z = a + T(4);
  T r = T(1) / z;
  T r2 = r * r;
  T dg = dlog<T>(z) - T(0.5) * r -
         r2 * (T(0.08333333333333333) -
               r2 * (T(0.008333333333333333) - r2 * T(0.003968253968253968)));
  return dg - T(1) / a - T(1) / (a + T(1)) - T(1) / (a + T(2)) -
         T(1) / (a + T(3));
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// The factored kernel's configs: bit k of bits[m] says whether config m
// holds spot k. Passed by value (kernel parameter memory), so a call needs
// no host-to-device copy.
struct ConfigMasks {
  int bits[kMaxConfigs];
};

// Stage the J bins in shared memory as Bin<T> in BinArith's units, padded
// to whole tiles with offsets at +inf (above every pixel, so masked like
// any bin there); returns the padded count Jt.
template <typename T>
__device__ __forceinline__ int stage_bins(const T* g, const T* w, Bin<T>* sbin,
                                          int J) {
  const int Jt = (J + kTile - 1) / kTile * kTile;
  for (int j = threadIdx.x; j < Jt; j += blockDim.x) {
    Bin<T> bin;
    bin.g = j < J ? g[j] : T(CUDART_INF);
    bin.w = j < J ? w[j] * BinArith<T>::kScale : T(0);
    sbin[j] = bin;
  }
  __syncthreads();
  return Jt;
}

// The logsumexp over the Jt (a multiple of kTile) bins of one pixel for a
// chunk of CH configs (am1 = a - 1), in BinArith's units (b too): the exact
// running max mx per config, rescaled once per tile where it rose, and the
// sums s, sl (of e L, L = log d in those units) and sd (of e d).
template <typename T, bool STATS, int CH>
__device__ __forceinline__ void lse_tiles(T xi, const T (&am1)[CH],
                                          const Bin<T>* sbin, int Jt, T b,
                                          T (&mx)[CH], T (&s)[CH],
                                          T (&sl)[CH], T (&sd)[CH]) {
  using A = BinArith<T>;
  const T NEG = T(-1e30) * A::kScale;  // -1e30 in natural units
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    mx[c] = NEG;  // not -inf: a tile of log weights -inf then adds exp2(-inf) = 0
    s[c] = T(0);
    sl[c] = T(0);
    sd[c] = T(0);
  }
  for (int j0 = 0; j0 < Jt; j0 += kTile) {
    T L[kTile], cj[kTile], dd[kTile];
#pragma unroll
    for (int u = 0; u < kTile; ++u) {
      const Bin<T> bin = sbin[j0 + u];
      const T d = xi - bin.g;
      const bool ok = d > T(0);
      L[u] = ok ? A::log(d) : T(0);
      cj[u] = ok ? bin.w - b * d : NEG;
      dd[u] = ok ? d : T(0);
    }
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      T t[kTile];
      T tm = -T(CUDART_INF);
#pragma unroll
      for (int u = 0; u < kTile; ++u) {
        t[u] = am1[c] * L[u] + cj[u];
        tm = dmax<T>(tm, t[u]);
      }
      if (tm > mx[c]) {  // the running max rose: rescale the sums once
        const T r = A::exp(mx[c] - tm);
        s[c] *= r;
        if (STATS) {
          sl[c] *= r;
          sd[c] *= r;
        }
        mx[c] = tm;
      }
#pragma unroll
      for (int u = 0; u < kTile; ++u) {
        const T e = A::exp(t[u] - mx[c]);
        s[c] += e;
        if (STATS) {
          sl[c] = e * L[u] + sl[c];
          sd[c] = e * dd[u] + sd[c];
        }
      }
    }
  }
}

// lp of one (config, pixel) from its lse sums (mx and sl in units of
// `unit` natural log units); with STATS also spl and spd.
template <typename T, bool STATS>
__device__ __forceinline__ T finish(T a, T mx, T s, T sl, T sd, T log_b,
                                    T inv_b, T unit, T& pl, T& pd) {
  if (STATS) {
    const T inv_s = T(1) / s;
    pl = unit * sl * inv_s + log_b - digamma_stirling<T>(a);
    pd = a * inv_b - sd * inv_s;
  }
  return unit * mx + dlog<T>(s) + a * log_b - dlgamma<T>(a);
}

template <typename T, bool STATS, bool FACT>
__global__ void __launch_bounds__(kSumThreads) offset_gamma_summed_kernel(
    const T* __restrict__ x,     // (nb, EVP)
    const T* __restrict__ a,     // (M, nb, EVP); FACT: deltas (Kf, nb, EVP)
    const T* __restrict__ base,  // FACT: (nb,)
    ConfigMasks masks,           // FACT: config m's spots as bits
    int Kf,                      // FACT: number of spot factors
    const T* __restrict__ g,     // (J,)
    const T* __restrict__ w,     // (J,)
    const T* __restrict__ rate,  // (nb / nbr,): one rate per run of nbr images
    T* __restrict__ out,         // (M, nb)
    T* __restrict__ spl,         // (M, nb, EVP) when STATS
    T* __restrict__ spd,         // (M, nb, EVP) when STATS
    int M, int nb, int EVP, int ev, int J,
    int ipb,                     // images per block
    int nbr) {                   // images per rate (blockIdx.y: the run)
  using A = BinArith<T>;
  __shared__ Bin<T> sbin[kMaxJ];
  extern __shared__ __align__(16) unsigned char og_smem[];
  T* part = reinterpret_cast<T*>(og_smem);  // (kChunk, npx): each pixel's lp

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int n0 = blockIdx.y * nbr + blockIdx.x * ipb;
  const int nimg = min(ipb, nbr - (int)blockIdx.x * ipb);
  const int npx = nimg * ev;
  const int Jt = stage_bins<T>(g, w, sbin, J);

  const T b = rate[blockIdx.y];
  const T b_units = b * A::kScale;
  const T log_b = dlog<T>(b);
  const T inv_b = T(1) / b;
  const size_t plane = (size_t)nb * EVP;

  if (STATS && ev < EVP) {  // padded lanes: no contribution, zero gradient
    const int pad = EVP - ev;
    for (int q = tid; q < nimg * pad; q += blockDim.x) {
      const int nl = q / pad;
      const size_t off = (size_t)(n0 + nl) * EVP + ev + (q - nl * pad);
      for (int m = 0; m < M; ++m) {
        spl[m * plane + off] = T(0);
        spd[m * plane + off] = T(0);
      }
    }
  }

  for (int m0 = 0; m0 < M; m0 += kChunk) {
    int bits[kChunk];  // FACT: the chunk's configs, read once per chunk
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      bits[c] = (FACT && m0 + c < M) ? masks.bits[m0 + c] : 0;
    }

    for (int p = tid; p < npx; p += blockDim.x) {
      const int nl = p / ev;
      const int n = n0 + nl;
      const size_t off = (size_t)n * EVP + (p - nl * ev);
      const T xi = x[off];
      T av[kChunk], am1[kChunk], mx[kChunk], s[kChunk], sl[kChunk], sd[kChunk];
      if (FACT) {
        const T bn = base[n];
        T dk[kMaxFactors];
#pragma unroll
        for (int k = 0; k < kMaxFactors; ++k) dk[k] = k < Kf ? a[k * plane + off] : T(0);
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
          T ac = bn;
#pragma unroll
          for (int k = 0; k < kMaxFactors; ++k) {
            if ((bits[c] >> k) & 1) ac += dk[k];
          }
          av[c] = m0 + c < M ? ac : T(1);
        }
      } else {
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
          av[c] = (m0 + c < M) ? a[(m0 + c) * plane + off] : T(1);
        }
      }
#pragma unroll
      for (int c = 0; c < kChunk; ++c) am1[c] = av[c] - T(1);
      lse_tiles<T, STATS, kChunk>(xi, am1, sbin, Jt, b_units, mx, s, sl, sd);
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        if (m0 + c < M) {
          T pl, pd;
          part[c * npx + p] = finish<T, STATS>(av[c], mx[c], s[c], sl[c], sd[c],
                                               log_b, inv_b, A::kUnit, pl, pd);
          if (STATS) {
            spl[(m0 + c) * plane + off] = pl;
            spd[(m0 + c) * plane + off] = pd;
          }
        }
      }
    }
    __syncthreads();

    // per-image sums in a fixed order: one warp per (config, image)
    for (int q = warp; q < kChunk * nimg; q += nwarps) {
      const int c = q / nimg;
      const int nl = q - c * nimg;
      if (m0 + c >= M) continue;  // uniform across the warp
      const T* src = part + c * npx + nl * ev;
      T v = T(0);
      for (int i = lane; i < ev; i += 32) v += src[i];
      v = warp_sum<T>(v);
      if (lane == 0) out[(size_t)(m0 + c) * nb + n0 + nl] = v;
    }
    __syncthreads();
  }
}

template <typename T, bool STATS, int CH>
__global__ void __launch_bounds__(kPixelThreads) offset_gamma_pixel_kernel(
    const T* __restrict__ x,     // (n_px,)
    const T* __restrict__ a,     // (M, n_px)
    const T* __restrict__ g,     // (J,)
    const T* __restrict__ w,     // (J,)
    const T* __restrict__ rate,  // (1,)
    T* __restrict__ out,         // (M, n_px)
    T* __restrict__ spl,         // (M, n_px) when STATS
    T* __restrict__ spd,         // (M, n_px) when STATS
    int M, long long n_px, int J) {
  using A = BinArith<T>;
  __shared__ Bin<T> sbin[kMaxJ];
  const int Jt = stage_bins<T>(g, w, sbin, J);

  const T b = rate[0];
  const T b_units = b * A::kScale;
  const T log_b = dlog<T>(b);
  const T inv_b = T(1) / b;
  const size_t n = (size_t)n_px;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const T xi = x[i];
    for (int m0 = 0; m0 < M; m0 += CH) {
      T av[CH], am1[CH], mx[CH], s[CH], sl[CH], sd[CH];
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        av[c] = (m0 + c < M) ? a[(m0 + c) * n + i] : T(1);
        am1[c] = av[c] - T(1);
      }
      lse_tiles<T, STATS, CH>(xi, am1, sbin, Jt, b_units, mx, s, sl, sd);
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        if (m0 + c < M) {
          T pl, pd;
          out[(m0 + c) * n + i] = finish<T, STATS>(av[c], mx[c], s[c], sl[c],
                                                   sd[c], log_b, inv_b, A::kUnit,
                                                   pl, pd);
          if (STATS) {
            spl[(m0 + c) * n + i] = pl;
            spd[(m0 + c) * n + i] = pd;
          }
        }
      }
    }
  }
}

// The summed kernel's runs: nb images in nb / nbr runs of nbr images, run r
// reading rate[r] (the chains of a batched restart step), one grid row each.
inline bool valid_runs(int nb, int nbr) {
  return nbr >= 1 && nb % nbr == 0 && nb / nbr <= kMaxRuns;
}

// The summed kernel's launch: images per block (kImagesPerBlock, fewer
// where the per-pixel lp buffer would outgrow kPartialBytes) and that
// buffer as dynamic shared memory, raised past the default 48 KB only for
// very wide images.
template <typename T, bool STATS, bool FACT>
int launch_summed_kernel(const T* x, const T* a, const T* base,
                         const ConfigMasks& masks, int Kf, const T* g,
                         const T* w, const T* rate, T* out, T* spl, T* spd,
                         int M, int nb, int EVP, int ev, int J, int nbr,
                         cudaStream_t stream) {
  int ipb = kImagesPerBlock;
  while (ipb > 1 && (size_t)kChunk * ipb * ev * sizeof(T) > (size_t)kPartialBytes) --ipb;
  const size_t dyn = (size_t)kChunk * ipb * ev * sizeof(T);
  auto kernel = offset_gamma_summed_kernel<T, STATS, FACT>;
  if (dyn + sizeof(Bin<T>) * kMaxJ > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<dim3((nbr + ipb - 1) / ipb, nb / nbr), kSumThreads, dyn, stream>>>(
      x, a, base, masks, Kf, g, w, rate, out, spl, spd, M, nb, EVP, ev, J, ipb, nbr);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_summed(const void* x, const void* a, const void* g, const void* w,
                  const void* rate, void* out, void* spl, void* spd, int M,
                  int nb, int EVP, int ev, int J, int nbr, int stats,
                  void* stream) {
  if (J > kMaxJ || J < 1 || M < 1 || nb < 1 || ev < 1 || ev > EVP ||
      !valid_runs(nb, nbr)) {
    return (int)cudaErrorInvalidValue;
  }
  const ConfigMasks none = {};
  cudaStream_t s = (cudaStream_t)stream;
  if (stats) {
    return launch_summed_kernel<T, true, false>(
        (const T*)x, (const T*)a, nullptr, none, 0, (const T*)g, (const T*)w,
        (const T*)rate, (T*)out, (T*)spl, (T*)spd, M, nb, EVP, ev, J, nbr, s);
  }
  return launch_summed_kernel<T, false, false>(
      (const T*)x, (const T*)a, nullptr, none, 0, (const T*)g, (const T*)w,
      (const T*)rate, (T*)out, nullptr, nullptr, M, nb, EVP, ev, J, nbr, s);
}

template <typename T>
int launch_factored(const void* x, const void* base, const void* deltas,
                    const int* mask_bits, const void* g, const void* w,
                    const void* rate, void* out, void* spl, void* spd, int M,
                    int Kf, int nb, int EVP, int ev, int J, int nbr,
                    void* stream) {
  if (J > kMaxJ || J < 1 || M < 1 || M > kMaxConfigs || Kf < 1 ||
      Kf > kMaxFactors || nb < 1 || ev < 1 || ev > EVP || !valid_runs(nb, nbr)) {
    return (int)cudaErrorInvalidValue;
  }
  ConfigMasks masks = {};
  for (int m = 0; m < M; ++m) {
    if (mask_bits[m] < 0 || mask_bits[m] >= (1 << Kf)) return (int)cudaErrorInvalidValue;
    masks.bits[m] = mask_bits[m];
  }
  return launch_summed_kernel<T, true, true>(
      (const T*)x, (const T*)deltas, (const T*)base, masks, Kf, (const T*)g,
      (const T*)w, (const T*)rate, (T*)out, (T*)spl, (T*)spd, M, nb, EVP, ev,
      J, nbr, (cudaStream_t)stream);
}

// The pixel kernel's launch, its config chunk sized to M.
template <typename T, bool STATS>
int launch_pixel_kernel(const T* x, const T* a, const T* g, const T* w,
                        const T* rate, T* out, T* spl, T* spd, int M,
                        long long n_px, int J, cudaStream_t stream) {
  auto kernel = M == 1   ? offset_gamma_pixel_kernel<T, STATS, 1>
                : M == 2 ? offset_gamma_pixel_kernel<T, STATS, 2>
                         : offset_gamma_pixel_kernel<T, STATS, kChunk>;
  const long long blocks = (n_px + kPixelThreads - 1) / kPixelThreads;
  kernel<<<(unsigned)(blocks < kMaxPixelBlocks ? blocks : kMaxPixelBlocks),
           kPixelThreads, 0, stream>>>(x, a, g, w, rate, out, spl, spd, M,
                                       n_px, J);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_pixel(const void* x, const void* a, const void* g, const void* w,
                 const void* rate, void* out, void* spl, void* spd, int M,
                 long long n_px, int J, int stats, void* stream) {
  if (J > kMaxJ || J < 1 || M < 1 || n_px < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (stats) {
    return launch_pixel_kernel<T, true>(
        (const T*)x, (const T*)a, (const T*)g, (const T*)w, (const T*)rate,
        (T*)out, (T*)spl, (T*)spd, M, n_px, J, s);
  }
  return launch_pixel_kernel<T, false>(
      (const T*)x, (const T*)a, (const T*)g, (const T*)w, (const T*)rate,
      (T*)out, nullptr, nullptr, M, n_px, J, s);
}

}  // namespace

extern "C" {

int og_max_bins() { return kMaxJ; }

int og_max_runs() { return kMaxRuns; }

int og_summed_f32(const void* x, const void* a, const void* g, const void* w,
                  const void* rate, void* out, void* spl, void* spd, int M,
                  int nb, int EVP, int ev, int J, int nbr, int stats,
                  void* stream) {
  return launch_summed<float>(x, a, g, w, rate, out, spl, spd, M, nb, EVP, ev,
                              J, nbr, stats, stream);
}

int og_summed_f64(const void* x, const void* a, const void* g, const void* w,
                  const void* rate, void* out, void* spl, void* spd, int M,
                  int nb, int EVP, int ev, int J, int nbr, int stats,
                  void* stream) {
  return launch_summed<double>(x, a, g, w, rate, out, spl, spd, M, nb, EVP,
                               ev, J, nbr, stats, stream);
}

int og_factored_f32(const void* x, const void* base, const void* deltas,
                    const int* mask_bits, const void* g, const void* w,
                    const void* rate, void* out, void* spl, void* spd, int M,
                    int Kf, int nb, int EVP, int ev, int J, int nbr,
                    void* stream) {
  return launch_factored<float>(x, base, deltas, mask_bits, g, w, rate, out,
                                spl, spd, M, Kf, nb, EVP, ev, J, nbr, stream);
}

int og_factored_f64(const void* x, const void* base, const void* deltas,
                    const int* mask_bits, const void* g, const void* w,
                    const void* rate, void* out, void* spl, void* spd, int M,
                    int Kf, int nb, int EVP, int ev, int J, int nbr,
                    void* stream) {
  return launch_factored<double>(x, base, deltas, mask_bits, g, w, rate, out,
                                 spl, spd, M, Kf, nb, EVP, ev, J, nbr, stream);
}

int og_pixel_f32(const void* x, const void* a, const void* g, const void* w,
                 const void* rate, void* out, void* spl, void* spd, int M,
                 long long n_px, int J, int stats, void* stream) {
  return launch_pixel<float>(x, a, g, w, rate, out, spl, spd, M, n_px, J,
                             stats, stream);
}

int og_pixel_f64(const void* x, const void* a, const void* g, const void* w,
                 const void* rate, void* out, void* spl, void* spd, int M,
                 long long n_px, int J, int stats, void* stream) {
  return launch_pixel<double>(x, a, g, w, rate, out, spl, spd, M, n_px, J,
                              stats, stream);
}

}  // extern "C"
