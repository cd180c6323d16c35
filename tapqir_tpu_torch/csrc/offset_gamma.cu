// Event-summed offset-marginalized Gamma log-likelihood for Hopper (sm_90a).
//
// Replaces the TPU Pallas pair in tapqir_tpu/ops/offset_gamma.py:
//   _sum_fwd_kernel   (:365)  -> STATS = false
//   _sum_stats_kernel (:384)  -> STATS = true
// For config m, image n and real pixel i < ev (x = value, a = concentration,
// b = the scalar rate, g_j / w_j = offset bins and their log weights):
//
//   out[m, n] = sum_{i<ev} ( lse_j[w_j + (a-1) log(x-g_j) - b (x-g_j)]
//                            + a log b - lgamma(a) )      (masked to x > g_j)
//
// and, with STATS, the per-pixel gradient statistics the backward uses:
//   spl[m, n, i] = sum_j p_j log(x-g_j) + log b - digamma(a)   (= d/da)
//   spd[m, n, i] = a / b - sum_j p_j (x-g_j)                    (= d/db)
// with p_j the softmax weights of the lse; lanes i >= ev get 0.
//
// What bounds it on this card: per (pixel, bin) the work is 1 log and M exp
// plus ~4M+3 (forward) or ~6M+3 (with stats) FMA-class operations, against
// ~4 + 4M (+8M) bytes per PIXEL (x, a in; spl, spd out). At the eLife slice
// shapes (M=4, J=61) that is ~1 KFLOP and ~1.5k MUFU ops per 48 bytes: the
// kernel is bound by arithmetic, not memory, and among the arithmetic by the
// special-function units (exp/log run at a fraction of the FMA rate).
//
// Design:
//  * one block owns one whole image; each thread owns pixels i = tid,
//    tid + blockDim, ... and keeps the M configs' running max / sum (and the
//    two stats sums) in registers while it loops over the J bins - so
//    log(x - g_j) is computed once per (pixel, bin) and shared by M configs
//    (the TPU staged the same reuse through (J, TB, EVP) VMEM buffers);
//  * the logsumexp is an online max-rescaled sum with ONE exp per (config,
//    bin): exp(-|t - mx|) is either the new term or the rescale factor;
//  * g and w sit in shared memory (J <= kMaxJ);
//  * the per-image sum over pixels is a warp-shuffle reduction followed by a
//    cross-warp pass in shared memory: no atomics, deterministic order, and
//    out is written as (M, nb) directly;
//  * configs are processed in register chunks of kChunk, so any M works; M
//    beyond kChunk repeats the log per chunk.
//  A pixel below every bin keeps t = NEG for every j and ends at NEG + log J
//  (finite, about -1e30), as the TPU kernel does.
//  lgamma comes from CUDA's math library; digamma is the Stirling series of
//  the JAX package (_digamma_stirling: absolute error < 7e-8 plus round-off).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kMaxJ = 1024;
constexpr int kChunk = 4;
constexpr int kMaxWarps = 32;

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

template <typename T, bool STATS>
__global__ void offset_gamma_summed_kernel(
    const T* __restrict__ x,     // (nb, EVP)
    const T* __restrict__ a,     // (M, nb, EVP)
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
  for (int j = tid; j < J; j += blockDim.x) {
    sg[j] = g[j];
    sw[j] = w[j];
  }
  __syncthreads();

  const T b = rate[0];
  const T log_b = dlog<T>(b);
  const T inv_b = T(1) / b;
  const T NEG = T(-1e30);
  const size_t plane = (size_t)nb * EVP;
  const T* xn = x + (size_t)n * EVP;

  for (int m0 = 0; m0 < M; m0 += kChunk) {
    T acc[kChunk];
#pragma unroll
    for (int c = 0; c < kChunk; ++c) acc[c] = T(0);

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
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        av[c] = (m0 + c < M) ? a[(m0 + c) * plane + off] : T(1);
        am1[c] = av[c] - T(1);
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
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        if (m0 + c < M) {
          acc[c] += mx[c] + dlog<T>(s[c]) + av[c] * log_b - dlgamma<T>(av[c]);
          if (STATS) {
            const T inv_s = T(1) / s[c];
            spl[(m0 + c) * plane + off] =
                sl[c] * inv_s + log_b - digamma_stirling<T>(av[c]);
            spd[(m0 + c) * plane + off] = av[c] * inv_b - sd[c] * inv_s;
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

template <typename T>
int launch(const void* x, const void* a, const void* g, const void* w,
           const void* rate, void* out, void* spl, void* spd, int M, int nb,
           int EVP, int ev, int J, int stats, void* stream) {
  if (J > kMaxJ || J < 1 || M < 1 || nb < 1 || ev < 1 || ev > EVP) {
    return (int)cudaErrorInvalidValue;
  }
  int threads = ((ev + 31) / 32) * 32;
  if (threads > 256) threads = 256;
  const dim3 grid(nb);
  cudaStream_t s = (cudaStream_t)stream;
  if (stats) {
    offset_gamma_summed_kernel<T, true><<<grid, threads, 0, s>>>(
        (const T*)x, (const T*)a, (const T*)g, (const T*)w, (const T*)rate,
        (T*)out, (T*)spl, (T*)spd, M, nb, EVP, ev, J);
  } else {
    offset_gamma_summed_kernel<T, false><<<grid, threads, 0, s>>>(
        (const T*)x, (const T*)a, (const T*)g, (const T*)w, (const T*)rate,
        (T*)out, nullptr, nullptr, M, nb, EVP, ev, J);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int og_max_bins() { return kMaxJ; }

int og_summed_f32(const void* x, const void* a, const void* g, const void* w,
                  const void* rate, void* out, void* spl, void* spd, int M,
                  int nb, int EVP, int ev, int J, int stats, void* stream) {
  return launch<float>(x, a, g, w, rate, out, spl, spd, M, nb, EVP, ev, J,
                       stats, stream);
}

int og_summed_f64(const void* x, const void* a, const void* g, const void* w,
                  const void* rate, void* out, void* spl, void* spd, int M,
                  int nb, int EVP, int ev, int J, int stats, void* stream) {
  return launch<double>(x, a, g, w, rate, out, spl, spd, M, nb, EVP, ev, J,
                        stats, stream);
}

}  // extern "C"
