// Offset-marginalized Gamma log-likelihood kernels for Hopper (sm_90a).
//
// Replaces the five TPU Pallas kernel bodies of tapqir_tpu/ops/offset_gamma.py:
//   _fwd_kernel        (:137)  -> offset_gamma_pixel_kernel   STATS = false
//   _fwd_stats_kernel  (:151)  -> offset_gamma_pixel_kernel   STATS = true
//   _sum_fwd_kernel    (:365)  -> offset_gamma_summed_kernel  STATS = false
//   _sum_stats_kernel  (:384)  -> offset_gamma_summed_kernel  STATS = true
//   _fact_stats_kernel (:520)  -> offset_gamma_summed_kernel  STATS = true, FACT = true
// For config m and pixel i (x = value, a = concentration, b = the scalar
// rate, g_j / w_j = offset bins and their log weights) each computes
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
// What bounds them on this card: per (pixel, bin) the work is 1 log and M
// exp plus ~4M+3 (forward) or ~6M+3 (with stats) FMA-class operations,
// against ~4 + 4M (+8M) bytes per PIXEL (x, a in; lp or spl, spd out). At
// the slice shapes (M=4, J=61) that is ~1 KFLOP and ~1.5k MUFU ops per ~50
// bytes: the kernels are bound by arithmetic, not memory, and among the
// arithmetic by the exp/log instruction sequences.
//
// Design (shared by all three kernels):
//  * each thread owns a pixel and keeps the configs' running max / sum (and
//    the two stats sums) in registers while it loops over the J bins, so
//    log(x - g_j) is computed once per (pixel, bin) and shared by the
//    configs (the TPU staged the same reuse through (J, rows, 128) VMEM
//    buffers, which have no purpose here);
//  * the logsumexp is an online max-rescaled sum with ONE exp per (config,
//    bin): exp(-|t - mx|) is either the new term or the rescale factor;
//  * g and w sit in shared memory (J <= kMaxJ);
//  * configs are processed in register chunks of kChunk, so any M works;
//    M beyond kChunk repeats the log per chunk.
// Summed and factored kernels: one block owns one whole image and sums its
// pixels by warp shuffles and one pass over the warps' partials: no
// atomics, a fixed summation order, out written as (M, nb) directly.
// Pixel kernel: a grid-stride loop over the flat pixels; out, spl and spd
// are written straight to (M, n_px).
//
// The factored kernel keeps the summed kernel's exact online max per config
// (M exps per (pixel, bin)) rather than the Pallas kernel's factored form
// (1 + Kf exps, each factor shifted by per-pixel analytic bounds): the
// bounds are loose by the spread of w_j - b (x - g_j) over the bins, and in
// float32 a spread beyond ~87 underflows every shifted term of a pixel (a
// wide offset histogram or a small gain gets there), while the online max
// is exact for any input. At cosmos's Kf = 2 the factored form would save
// one exp in four. Its edge cases come out as the Pallas kernel's: base < 1
// needs no shift to flip, and a pixel below every bin ends near -1e30.
//
// A pixel below every bin keeps t = NEG for every j and ends at NEG + log J
// (finite, about -1e30), as the TPU kernels do.
// lgamma comes from CUDA's math library; digamma is the Stirling series of
// the JAX package (_digamma_stirling: absolute error < 7e-8 plus round-off).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kMaxJ = 1024;
constexpr int kChunk = 4;
constexpr int kMaxWarps = 32;
constexpr int kMaxFactors = 6;
constexpr int kMaxConfigs = 64;

template <typename T> __device__ __forceinline__ T dlog(T v);
template <> __device__ __forceinline__ float dlog<float>(float v) { return logf(v); }
template <> __device__ __forceinline__ double dlog<double>(double v) { return log(v); }
template <typename T> __device__ __forceinline__ T dexp(T v);
template <> __device__ __forceinline__ float dexp<float>(float v) { return expf(v); }
template <> __device__ __forceinline__ double dexp<double>(double v) { return exp(v); }
template <typename T> __device__ __forceinline__ T dabs(T v);
template <> __device__ __forceinline__ float dabs<float>(float v) { return fabsf(v); }
template <> __device__ __forceinline__ double dabs<double>(double v) { return fabs(v); }
template <typename T> __device__ __forceinline__ T dlgamma(T v);
template <> __device__ __forceinline__ float dlgamma<float>(float v) { return lgammaf(v); }
template <> __device__ __forceinline__ double dlgamma<double>(double v) { return lgamma(v); }

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

// The online logsumexp over the J bins of one pixel for a chunk of configs
// (am1 = a - 1): running max mx, sum s and, with STATS, the sums of p_j L_j
// and p_j d_j (unnormalized, sl and sd).
template <typename T, bool STATS>
__device__ __forceinline__ void lse_bins(T xi, const T (&am1)[kChunk],
                                         const T* sg, const T* sw, int J, T b,
                                         T (&mx)[kChunk], T (&s)[kChunk],
                                         T (&sl)[kChunk], T (&sd)[kChunk]) {
  const T NEG = T(-1e30);
#pragma unroll
  for (int c = 0; c < kChunk; ++c) {
    mx[c] = -T(CUDART_INF);
    s[c] = T(0);
    sl[c] = T(0);
    sd[c] = T(0);
  }
  for (int j = 0; j < J; ++j) {
    const T d = xi - sg[j];
    const bool ok = d > T(0);
    const T L = ok ? dlog<T>(d) : T(0);
    const T cj = ok ? sw[j] - b * d : NEG;
    const T dd = ok ? d : T(0);
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const T t = cj + am1[c] * L;
      const bool up = t > mx[c];
      const T e = dexp<T>(-dabs<T>(t - mx[c]));  // new term or rescale
      const T keep = up ? e : T(1);
      const T add = up ? T(1) : e;
      s[c] = s[c] * keep + add;
      if (STATS) {
        sl[c] = sl[c] * keep + add * L;
        sd[c] = sd[c] * keep + add * dd;
      }
      mx[c] = up ? t : mx[c];
    }
  }
}

// lp of one (config, pixel) from its lse sums; with STATS also spl and spd.
template <typename T, bool STATS>
__device__ __forceinline__ T finish(T a, T mx, T s, T sl, T sd, T log_b,
                                    T inv_b, T& pl, T& pd) {
  if (STATS) {
    const T inv_s = T(1) / s;
    pl = sl * inv_s + log_b - digamma_stirling<T>(a);
    pd = a * inv_b - sd * inv_s;
  }
  return mx + dlog<T>(s) + a * log_b - dlgamma<T>(a);
}

template <typename T>
__device__ __forceinline__ void load_bins(const T* g, const T* w, T* sg, T* sw,
                                          int J) {
  for (int j = threadIdx.x; j < J; j += blockDim.x) {
    sg[j] = g[j];
    sw[j] = w[j];
  }
  __syncthreads();
}

template <typename T, bool STATS, bool FACT>
__global__ void offset_gamma_summed_kernel(
    const T* __restrict__ x,     // (nb, EVP)
    const T* __restrict__ a,     // (M, nb, EVP); FACT: deltas (Kf, nb, EVP)
    const T* __restrict__ base,  // FACT: (nb,)
    ConfigMasks masks,           // FACT: config m's spots as bits
    int Kf,                      // FACT: number of spot factors
    const T* __restrict__ g,     // (J,)
    const T* __restrict__ w,     // (J,)
    const T* __restrict__ rate,  // (1,)
    T* __restrict__ out,         // (M, nb)
    T* __restrict__ spl,         // (M, nb, EVP) when STATS
    T* __restrict__ spd,         // (M, nb, EVP) when STATS
    int M, int nb, int EVP, int ev, int J) {
  __shared__ T sg[kMaxJ];
  __shared__ T sw[kMaxJ];
  __shared__ T red[kMaxWarps][kChunk];

  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  load_bins<T>(g, w, sg, sw, J);

  const T b = rate[0];
  const T log_b = dlog<T>(b);
  const T inv_b = T(1) / b;
  const T bn = FACT ? base[n] : T(0);
  const size_t plane = (size_t)nb * EVP;
  const T* xn = x + (size_t)n * EVP;

  for (int m0 = 0; m0 < M; m0 += kChunk) {
    T acc[kChunk];
    int bits[kChunk];  // FACT: the chunk's configs, read once per chunk
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      acc[c] = T(0);
      bits[c] = (FACT && m0 + c < M) ? masks.bits[m0 + c] : 0;
    }

    for (int i = tid; i < EVP; i += blockDim.x) {
      const size_t off = (size_t)n * EVP + i;
      if (i >= ev) {  // padded lanes: no contribution, zero gradient
        if (STATS) {
#pragma unroll
          for (int c = 0; c < kChunk; ++c) {
            if (m0 + c < M) {
              spl[(m0 + c) * plane + off] = T(0);
              spd[(m0 + c) * plane + off] = T(0);
            }
          }
        }
        continue;
      }
      const T xi = xn[i];
      T av[kChunk], am1[kChunk], mx[kChunk], s[kChunk], sl[kChunk], sd[kChunk];
      if (FACT) {
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
      lse_bins<T, STATS>(xi, am1, sg, sw, J, b, mx, s, sl, sd);
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        if (m0 + c < M) {
          T pl, pd;
          acc[c] += finish<T, STATS>(av[c], mx[c], s[c], sl[c], sd[c], log_b,
                                     inv_b, pl, pd);
          if (STATS) {
            spl[(m0 + c) * plane + off] = pl;
            spd[(m0 + c) * plane + off] = pd;
          }
        }
      }
    }

    // per-image sum: warp shuffles, then one pass over the warps' partials
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const T v = warp_sum<T>(acc[c]);
      if (lane == 0) red[warp][c] = v;
    }
    __syncthreads();
    if (tid < kChunk && m0 + tid < M) {
      T tot = T(0);
      for (int k = 0; k < nwarps; ++k) tot += red[k][tid];
      out[(size_t)(m0 + tid) * nb + n] = tot;
    }
    __syncthreads();
  }
}

template <typename T, bool STATS>
__global__ void offset_gamma_pixel_kernel(
    const T* __restrict__ x,     // (n_px,)
    const T* __restrict__ a,     // (M, n_px)
    const T* __restrict__ g,     // (J,)
    const T* __restrict__ w,     // (J,)
    const T* __restrict__ rate,  // (1,)
    T* __restrict__ out,         // (M, n_px)
    T* __restrict__ spl,         // (M, n_px) when STATS
    T* __restrict__ spd,         // (M, n_px) when STATS
    int M, long long n_px, int J) {
  __shared__ T sg[kMaxJ];
  __shared__ T sw[kMaxJ];
  load_bins<T>(g, w, sg, sw, J);

  const T b = rate[0];
  const T log_b = dlog<T>(b);
  const T inv_b = T(1) / b;
  const size_t n = (size_t)n_px;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const T xi = x[i];
    for (int m0 = 0; m0 < M; m0 += kChunk) {
      T av[kChunk], am1[kChunk], mx[kChunk], s[kChunk], sl[kChunk], sd[kChunk];
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        av[c] = (m0 + c < M) ? a[(m0 + c) * n + i] : T(1);
        am1[c] = av[c] - T(1);
      }
      lse_bins<T, STATS>(xi, am1, sg, sw, J, b, mx, s, sl, sd);
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        if (m0 + c < M) {
          T pl, pd;
          out[(m0 + c) * n + i] = finish<T, STATS>(av[c], mx[c], s[c], sl[c],
                                                   sd[c], log_b, inv_b, pl, pd);
          if (STATS) {
            spl[(m0 + c) * n + i] = pl;
            spd[(m0 + c) * n + i] = pd;
          }
        }
      }
    }
  }
}

// one thread per real pixel of an image, in whole warps, at most 256
int image_threads(int ev) {
  int threads = ((ev + 31) / 32) * 32;
  return threads > 256 ? 256 : threads;
}

template <typename T>
int launch_summed(const void* x, const void* a, const void* g, const void* w,
                  const void* rate, void* out, void* spl, void* spd, int M,
                  int nb, int EVP, int ev, int J, int stats, void* stream) {
  if (J > kMaxJ || J < 1 || M < 1 || nb < 1 || ev < 1 || ev > EVP) {
    return (int)cudaErrorInvalidValue;
  }
  const ConfigMasks none = {};
  const dim3 grid(nb);
  const int threads = image_threads(ev);
  cudaStream_t s = (cudaStream_t)stream;
  if (stats) {
    offset_gamma_summed_kernel<T, true, false><<<grid, threads, 0, s>>>(
        (const T*)x, (const T*)a, nullptr, none, 0, (const T*)g, (const T*)w,
        (const T*)rate, (T*)out, (T*)spl, (T*)spd, M, nb, EVP, ev, J);
  } else {
    offset_gamma_summed_kernel<T, false, false><<<grid, threads, 0, s>>>(
        (const T*)x, (const T*)a, nullptr, none, 0, (const T*)g, (const T*)w,
        (const T*)rate, (T*)out, nullptr, nullptr, M, nb, EVP, ev, J);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_factored(const void* x, const void* base, const void* deltas,
                    const int* mask_bits, const void* g, const void* w,
                    const void* rate, void* out, void* spl, void* spd, int M,
                    int Kf, int nb, int EVP, int ev, int J, void* stream) {
  if (J > kMaxJ || J < 1 || M < 1 || M > kMaxConfigs || Kf < 1 ||
      Kf > kMaxFactors || nb < 1 || ev < 1 || ev > EVP) {
    return (int)cudaErrorInvalidValue;
  }
  ConfigMasks masks = {};
  for (int m = 0; m < M; ++m) {
    if (mask_bits[m] < 0 || mask_bits[m] >= (1 << Kf)) return (int)cudaErrorInvalidValue;
    masks.bits[m] = mask_bits[m];
  }
  offset_gamma_summed_kernel<T, true, true>
      <<<dim3(nb), image_threads(ev), 0, (cudaStream_t)stream>>>(
          (const T*)x, (const T*)deltas, (const T*)base, masks, Kf,
          (const T*)g, (const T*)w, (const T*)rate, (T*)out, (T*)spl,
          (T*)spd, M, nb, EVP, ev, J);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_pixel(const void* x, const void* a, const void* g, const void* w,
                 const void* rate, void* out, void* spl, void* spd, int M,
                 long long n_px, int J, int stats, void* stream) {
  if (J > kMaxJ || J < 1 || M < 1 || n_px < 1) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  long long blocks = (n_px + threads - 1) / threads;
  if (blocks > (1 << 20)) blocks = 1 << 20;  // the grid-stride loop covers the rest
  cudaStream_t s = (cudaStream_t)stream;
  if (stats) {
    offset_gamma_pixel_kernel<T, true><<<(unsigned)blocks, threads, 0, s>>>(
        (const T*)x, (const T*)a, (const T*)g, (const T*)w, (const T*)rate,
        (T*)out, (T*)spl, (T*)spd, M, n_px, J);
  } else {
    offset_gamma_pixel_kernel<T, false><<<(unsigned)blocks, threads, 0, s>>>(
        (const T*)x, (const T*)a, (const T*)g, (const T*)w, (const T*)rate,
        (T*)out, nullptr, nullptr, M, n_px, J);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int og_max_bins() { return kMaxJ; }

int og_summed_f32(const void* x, const void* a, const void* g, const void* w,
                  const void* rate, void* out, void* spl, void* spd, int M,
                  int nb, int EVP, int ev, int J, int stats, void* stream) {
  return launch_summed<float>(x, a, g, w, rate, out, spl, spd, M, nb, EVP, ev,
                              J, stats, stream);
}

int og_summed_f64(const void* x, const void* a, const void* g, const void* w,
                  const void* rate, void* out, void* spl, void* spd, int M,
                  int nb, int EVP, int ev, int J, int stats, void* stream) {
  return launch_summed<double>(x, a, g, w, rate, out, spl, spd, M, nb, EVP,
                               ev, J, stats, stream);
}

int og_factored_f32(const void* x, const void* base, const void* deltas,
                    const int* mask_bits, const void* g, const void* w,
                    const void* rate, void* out, void* spl, void* spd, int M,
                    int Kf, int nb, int EVP, int ev, int J, void* stream) {
  return launch_factored<float>(x, base, deltas, mask_bits, g, w, rate, out,
                                spl, spd, M, Kf, nb, EVP, ev, J, stream);
}

int og_factored_f64(const void* x, const void* base, const void* deltas,
                    const int* mask_bits, const void* g, const void* w,
                    const void* rate, void* out, void* spl, void* spd, int M,
                    int Kf, int nb, int EVP, int ev, int J, void* stream) {
  return launch_factored<double>(x, base, deltas, mask_bits, g, w, rate, out,
                                 spl, spd, M, Kf, nb, EVP, ev, J, stream);
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
