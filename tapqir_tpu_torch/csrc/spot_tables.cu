// The per-spot dye tables of the ELBO (cosmos, cosmos+hmm, crosstalk), for
// Hopper (sm_90a).
//
// Replaces no TPU kernel. In the JAX package the tables are part of the
// jitted ELBO, and XLA fuses their element-wise work. Run op by op in
// PyTorch they were ~200-240 launches forward and ~320-400 backward an ELBO
// (eight affine-Beta log-densities, a Gamma and a HalfNormal one, log(qm)
// and log1p(-qm), and the einsums over the (M, K) config table), each over
// 10k-120k elements. Three kernels take their place, for the spot group g
// = (n, f, Q) of chain r and its K spots:
//
//  * tables_kernel (forward): a thread a spot group reads the 12 per-spot
//    inputs once, computes every log-density in registers and writes
//        term_xy[m, r, t, g] = sum_k mtab[m, k] (spec[t, k] ? sp_k : ns_k)
//        term_hw[m, r, g]    = sum_k mtab[m, k] (lph_k + lpw_k)
//        term_q[m, r, g]     = sum_k mtab[m, k] (lqh_k + lqw_k + lqx_k + lqy_k)
//        log_qm[m, r, z, g]  = sum_k mtab[m, k] log qm[z, k]
//                              + sum_k (1 - mtab[m, k]) log1p(-qm[z, k])
//    with sp_k, ns_k the specific and the uniform position priors of x_k
//    and y_k (the specific one's concentration from the chain's proximity,
//    size = ((P + 1) / (2 prox))^2 - 1), lph / lpw the height and width
//    priors, lq* the guide's densities, z the axis of q(m | z) (1 when qm
//    has none);
//  * tables_grad_kernel (backward): the same thread reads the four tables'
//    gradients, sums them over the configs into each spot's weights and
//    writes the gradients of the 12 inputs in closed form (the
//    concentrations' through the digamma function), and per block a
//    partial of d/d size of the specific prior;
//  * prox_kernel: each chain's partials added in a fixed order and taken
//    to the proximity through size = ((P + 1) / (2 prox))^2 - 1.
//
// Every value is the composition's (ops/spot_tables.py's plain version):
// torch.xlogy's zero (xlogy(0, u) = 0) and its gradients (log u for the
// concentration, as autograd takes it, and 0 / u for u), torch.lgamma,
// torch.digamma's algorithm (Cephes, as ATen writes it), log1p(-qm) (-inf
// at qm = 1), and the config table applied as a product, as the einsum
// does (0 * -inf is NaN there too). The uniform position prior has
// concentrations 1: its value is -log(P + 1) and its gradient 0. No
// floating-point atomic is used and the blocks' partials are added in a
// fixed order, so repeated launches are bitwise equal.
//
// What bounds them: bytes, and below that the launch. At cosmos's eLife
// window (10 x 512 groups, K = 2, M = 4) the forward reads 0.25 MB and
// writes 0.5 MB, the backward reads 0.7 MB and writes 0.25 MB: ~0.3 us
// each at 3.35 TB/s, under a launch's ~2-3 us. The design's answer is the
// fusing itself: one launch forward and two backward in place of ~500.
// Inputs are read through their own strides (the windows' spot axis is
// outermost), so no copy is made before a launch.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxK = 6;            // spots a group
constexpr int kMaxM = 1 << kMaxK;   // configs
constexpr int kMaxT = 1 + kMaxK;    // theta states
constexpr int kThreads = 128;       // a block's threads
constexpr int kInputs = 12;

// the per-spot inputs, in the order of the host's arrays
enum Input { kX, kY, kH, kW, kQm, kHLoc, kHBeta, kWMean, kWSize, kXMean, kYMean, kSize };

// the host's constants (float64), in this order
enum Const {
  cLow,       // -(P + 1) / 2, the positions' lower end
  cHigh,      // (P + 1) / 2
  cWidth,     // P + 1
  cLogWidth,  // log(P + 1)
  cWLow,      // width_min
  cWHigh,     // width_max
  cWWidth,    // width_max - width_min
  cLogWWidth,
  cPw1,       // the width prior's concentrations less 1 and its normaliser
  cPw0,       //   lgamma(c1 + c0) - lgamma(c1) - lgamma(c0) - log(width_max - width_min)
  cPwNorm,
  cHnConst,   // log(2 / pi) / 2 - log(height_std)
  cHnScale,   // height_std
  cP1,        // P + 1
  kConsts
};

// element (r, z, g, k) of an input, or of a gradient, at r sr + z sz + g sg + k sk
template <typename T>
struct View {
  T* p;
  long long sr, sz, sg, sk;
  __device__ __forceinline__ T& at(long long r, long long z, long long g, int k) const {
    return p[r * sr + z * sz + g * sg + k * sk];
  }
};

template <typename T>
struct Args {
  View<T> in[kInputs];
  const T* prox;  // (R,)
  long long R, G;
  int Z, M, NT;
  unsigned masks[kMaxM];  // bit k of masks[m]: spot k in config m
  unsigned spec[kMaxT];   // bit k of spec[t]: spot k specific given theta = t
  double c[kConsts];
};

__device__ __forceinline__ float lg(float a) { return logf(a); }
__device__ __forceinline__ double lg(double a) { return log(a); }
__device__ __forceinline__ float lg1p(float a) { return log1pf(a); }
__device__ __forceinline__ double lg1p(double a) { return log1p(a); }
// not inlined: every instance calls it 10 times a spot, and inlined copies
// of the double one took most of nvcc's time
__device__ __noinline__ float lgam(float a) { return lgammaf(a); }
__device__ __noinline__ double lgam(double a) { return lgamma(a); }

template <typename T>
__device__ __forceinline__ T ld(const View<T>& v, long long r, long long z, long long g, int k) {
  return __ldg(&v.at(r, z, g, k));
}

// torch.xlogy(a, u), and the factor of its gradient in a as autograd takes
// it: log u, also at a = 0, but 0 where a = 0 and u <= 0
template <typename T>
__device__ __forceinline__ T xlogy(T a, T u) {
  return isnan(u) ? u : (a == T(0) ? T(0) : a * lg(u));
}
template <typename T>
__device__ __forceinline__ T xlogy_da(T a, T u) {
  return isnan(u) ? u : (a == T(0) && u <= T(0) ? T(0) : lg(u));
}

// torch.digamma's algorithm (ATen's calc_digamma, from Cephes), in T; not
// inlined, as every instance calls it ~10 times a spot
template <typename T>
__device__ __noinline__ T digamma(T x) {
  constexpr double kPi = 3.14159265358979323846;
  if (x == T(0)) return copysign(T(INFINITY), -x);
  T result = T(0);
  if (x < T(0)) {
    if (x == trunc(x)) return T(NAN);
    const double r = fmod(double(x), 1.0);  // the fractional part, with x's sign
    result = T(-kPi / tan(kPi * r));
    x = T(1) - x;
  }
  while (x < T(10)) {
    result -= T(1) / x;
    x += T(1);
  }
  if (x == T(10)) return result + T(2.25175258906672110764);
  T y = T(0);
  if (x < T(1.0e17)) {
    const T z = T(1) / (x * x);
    T p = T(8.33333333333333333333E-2);
    p = p * z + T(-2.10927960927960927961E-2);
    p = p * z + T(7.57575757575757575758E-3);
    p = p * z + T(-4.16666666666666666667E-3);
    p = p * z + T(3.96825396825396825397E-3);
    p = p * z + T(-8.33333333333333333333E-3);
    p = p * z + T(8.33333333333333333333E-2);
    y = z * p;
  }
  return result + lg(x) - T(0.5) / x - y;
}

// log Beta(u; c1, c0) as beta_log_prob composes it, less log_width; norm is
// beta_norm(c1, c0)
template <typename T>
__device__ __forceinline__ T beta_norm(T c1, T c0) {
  return lgam(c1 + c0) - lgam(c1) - lgam(c0);
}
template <typename T>
__device__ __forceinline__ T beta_lp(T u, T c1, T c0, T norm, T log_width) {
  return xlogy(c1 - T(1), u) + xlogy(c0 - T(1), T(1) - u) + norm - log_width;
}

// its derivatives in u, c1 and c0; psi = digamma(c1 + c0), p1 = digamma(c1),
// p0 = digamma(c0)
template <typename T>
struct BetaGrad {
  T du, dc1, dc0;
};

template <typename T>
__device__ __forceinline__ BetaGrad<T> beta_grad(T u, T c1, T c0, T psi, T p1, T p0) {
  const T v = T(1) - u;
  return {(c1 - T(1)) / u - (c0 - T(1)) / v, xlogy_da(c1 - T(1), u) + psi - p1,
          xlogy_da(c0 - T(1), v) + psi - p0};
}

template <typename T>
__device__ __forceinline__ BetaGrad<T> beta_grad(T u, T c1, T c0) {
  return beta_grad(u, c1, c0, digamma(c1 + c0), digamma(c1), digamma(c0));
}

// AffineBeta(mean, size) on (low, high) at x: u and the concentrations
template <typename T>
struct Affine {
  T u, c1, c0;
};

template <typename T>
__device__ __forceinline__ Affine<T> affine(T x, T mean, T size, T low, T high, T width) {
  return {(x - low) / width, size * (mean - low) / width, size * (high - mean) / width};
}

// chain r's specific position prior, AffineBeta(0, size) on (low, high):
// the concentrations of size = ((P + 1) / (2 prox))^2 - 1
template <typename T>
__device__ __forceinline__ Affine<T> chain(const Args<T>& a, long long r) {
  const T pa = T(a.c[cP1]) / (T(2) * __ldg(a.prox + r));
  return affine(T(0), T(0), pa * pa - T(1), T(a.c[cLow]), T(a.c[cHigh]), T(a.c[cWidth]));
}

// spot k of group g in chain r: its specific position prior (sp_c the
// chain's concentrations, sp_norm their normaliser), its height and width
// priors, and its guide's density. Not inlined, so that each instance of
// the kernel holds one copy, not K.
template <typename T>
struct SpotLp {
  T sp, hw, q;
};

template <typename T>
__device__ __noinline__ SpotLp<T> spot_lp(const Args<T>& a, long long r, long long g, int k,
                                          Affine<T> sp_c, T sp_norm) {
  const T low = T(a.c[cLow]), high = T(a.c[cHigh]), width = T(a.c[cWidth]);
  const T logw = T(a.c[cLogWidth]);
  const T wlow = T(a.c[cWLow]), whigh = T(a.c[cWHigh]), wwidth = T(a.c[cWWidth]);
  const T x = ld(a.in[kX], r, 0, g, k), y = ld(a.in[kY], r, 0, g, k);
  const T h = ld(a.in[kH], r, 0, g, k), w = ld(a.in[kW], r, 0, g, k);
  const T ux = (x - low) / width, uy = (y - low) / width;
  const T hs = h / T(a.c[cHnScale]);
  const T uw = (w - wlow) / wwidth;
  const T hl = ld(a.in[kHLoc], r, 0, g, k), hb = ld(a.in[kHBeta], r, 0, g, k);
  const T conc = hl * hb;
  const T size = ld(a.in[kSize], r, 0, g, k);
  const Affine<T> qw = affine(w, ld(a.in[kWMean], r, 0, g, k), ld(a.in[kWSize], r, 0, g, k),
                              wlow, whigh, wwidth);
  const Affine<T> qx = affine(x, ld(a.in[kXMean], r, 0, g, k), size, low, high, width);
  const Affine<T> qy = affine(y, ld(a.in[kYMean], r, 0, g, k), size, low, high, width);
  SpotLp<T> out;
  out.sp = beta_lp(ux, sp_c.c1, sp_c.c0, sp_norm, logw) +
           beta_lp(uy, sp_c.c1, sp_c.c0, sp_norm, logw);
  out.hw = (T(a.c[cHnConst]) - T(0.5) * (hs * hs)) +
           (xlogy(T(a.c[cPw1]), uw) + xlogy(T(a.c[cPw0]), T(1) - uw) + T(a.c[cPwNorm]));
  out.q = (xlogy(conc, hb) + xlogy(conc - T(1), h) - hb * h - lgam(conc)) +
          beta_lp(qw.u, qw.c1, qw.c0, beta_norm(qw.c1, qw.c0), T(a.c[cLogWWidth])) +
          beta_lp(qx.u, qx.c1, qx.c0, beta_norm(qx.c1, qx.c0), logw) +
          beta_lp(qy.u, qy.c1, qy.c0, beta_norm(qy.c1, qy.c0), logw);
  return out;
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreads) tables_kernel(const __grid_constant__ Args<T> a,
                                                          T* __restrict__ txy,
                                                          T* __restrict__ thw,
                                                          T* __restrict__ tq,
                                                          T* __restrict__ tlq) {
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long r = blockIdx.y;
  if (g >= a.G) return;
  const Affine<T> sp_c = chain(a, r);
  const T sp_norm = beta_norm(sp_c.c1, sp_c.c0);
  const T ns = T(-a.c[cLogWidth]) + T(-a.c[cLogWidth]);  // the uniform prior of x and y
  T sp[K], hw[K], q[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const SpotLp<T> v = spot_lp(a, r, g, k, sp_c, sp_norm);
    sp[k] = v.sp;
    hw[k] = v.hw;
    q[k] = v.q;
  }
  const long long G = a.G, R = a.R;
  for (int m = 0; m < a.M; ++m) {
    const unsigned bits = a.masks[m];
    T shw = T(0), sq = T(0);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const T on = T((bits >> k) & 1u);
      shw += on * hw[k];
      sq += on * q[k];
    }
    thw[(m * R + r) * G + g] = shw;
    tq[(m * R + r) * G + g] = sq;
    for (int t = 0; t < a.NT; ++t) {
      T sxy = T(0);
#pragma unroll
      for (int k = 0; k < K; ++k)
        sxy += T((bits >> k) & 1u) * (((a.spec[t] >> k) & 1u) ? sp[k] : ns);
      txy[((m * R + r) * a.NT + t) * G + g] = sxy;
    }
  }
  for (int z = 0; z < a.Z; ++z) {
    T l1[K], l0[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const T qm = ld(a.in[kQm], r, z, g, k);
      l1[k] = lg(qm);
      l0[k] = lg1p(-qm);
    }
    for (int m = 0; m < a.M; ++m) {
      const unsigned bits = a.masks[m];
      T s1 = T(0), s0 = T(0);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const T on = T((bits >> k) & 1u);
        s1 += on * l1[k];
        s0 += (T(1) - on) * l0[k];
      }
      tlq[((m * R + r) * a.Z + z) * G + g] = s1 + s0;
    }
  }
}

template <typename T>
__device__ __forceinline__ T warp_sum(T t) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) t += __shfl_down_sync(0xffffffffu, t, off);
  return t;  // lane 0 holds the sum
}

// the block's sum of t, the warps' sums added in order; thread 0 holds it
template <typename T>
__device__ __forceinline__ T block_sum(T t) {
  __shared__ T red[kThreads / 32];
  t = warp_sum(t);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = t;
  __syncthreads();
  if (threadIdx.x == 0)
    for (int w = 1; w < kThreads / 32; ++w) red[0] += red[w];
  return red[0];
}

// the backward's cotangents (the four tables' gradients, laid out as the
// forward wrote them), the inputs' gradients and the blocks' partials
template <typename T>
struct Grads {
  const T *gxy, *ghw, *gq, *glq;
  View<T> out[kInputs];
  T* part;  // (R, blocks a chain): partials of d/d size of the specific prior
};

// the gradients of spot k of group g in chain r (of the 11 inputs but qm),
// for its weights wsp, whw, wq in the tables; returns its part of d/d size
// of the specific prior. Not inlined, as spot_lp.
template <typename T>
__device__ __noinline__ T spot_grad(const Args<T>& a, const Grads<T>& d, long long r,
                                    long long g, int k, T wsp, T whw, T wq, Affine<T> sp_c,
                                    T sp_psi, T sp_p1, T sp_p0) {
  const T low = T(a.c[cLow]), high = T(a.c[cHigh]), width = T(a.c[cWidth]);
  const T wlow = T(a.c[cWLow]), whigh = T(a.c[cWHigh]), wwidth = T(a.c[cWWidth]);
  const T scale = T(a.c[cHnScale]);
  const T x = ld(a.in[kX], r, 0, g, k), y = ld(a.in[kY], r, 0, g, k);
  const T h = ld(a.in[kH], r, 0, g, k), w = ld(a.in[kW], r, 0, g, k);
  const T hl = ld(a.in[kHLoc], r, 0, g, k), hb = ld(a.in[kHBeta], r, 0, g, k);
  const T wm = ld(a.in[kWMean], r, 0, g, k), wsz = ld(a.in[kWSize], r, 0, g, k);
  const T xm = ld(a.in[kXMean], r, 0, g, k), ym = ld(a.in[kYMean], r, 0, g, k);
  const T size = ld(a.in[kSize], r, 0, g, k);
  // the positions: the specific prior and the guide
  const Affine<T> qx = affine(x, xm, size, low, high, width);
  const Affine<T> qy = affine(y, ym, size, low, high, width);
  const BetaGrad<T> sx = beta_grad(qx.u, sp_c.c1, sp_c.c0, sp_psi, sp_p1, sp_p0);
  const BetaGrad<T> sy = beta_grad(qy.u, sp_c.c1, sp_c.c0, sp_psi, sp_p1, sp_p0);
  const T part = wsp * ((sx.dc1 + sy.dc1) / width * (T(0) - low) +
                        (sx.dc0 + sy.dc0) / width * (high - T(0)));
  const BetaGrad<T> bx = beta_grad(qx.u, qx.c1, qx.c0);
  const BetaGrad<T> by = beta_grad(qy.u, qy.c1, qy.c0);
  d.out[kX].at(r, 0, g, k) = (wsp * sx.du + wq * bx.du) / width;
  d.out[kY].at(r, 0, g, k) = (wsp * sy.du + wq * by.du) / width;
  const T x1 = wq * bx.dc1 / width, x0 = wq * bx.dc0 / width;
  const T y1 = wq * by.dc1 / width, y0 = wq * by.dc0 / width;
  d.out[kXMean].at(r, 0, g, k) = (x1 - x0) * size;
  d.out[kYMean].at(r, 0, g, k) = (y1 - y0) * size;
  d.out[kSize].at(r, 0, g, k) =
      x1 * (xm - low) + x0 * (high - xm) + y1 * (ym - low) + y0 * (high - ym);
  // the height: HalfNormal prior, Gamma(h_loc h_beta, h_beta) guide
  const T conc = hl * hb;
  const T dconc = xlogy_da(conc, hb) + xlogy_da(conc - T(1), h) - digamma(conc);
  d.out[kH].at(r, 0, g, k) = whw * -(h / scale / scale) + wq * ((conc - T(1)) / h - hb);
  d.out[kHLoc].at(r, 0, g, k) = wq * dconc * hb;
  d.out[kHBeta].at(r, 0, g, k) = wq * (dconc * hl + (conc / hb - h));
  // the width: AffineBeta prior with constant concentrations, and the guide
  const Affine<T> qw = affine(w, wm, wsz, wlow, whigh, wwidth);
  const BetaGrad<T> bw = beta_grad(qw.u, qw.c1, qw.c0);
  const T dpw = T(a.c[cPw1]) / qw.u - T(a.c[cPw0]) / (T(1) - qw.u);
  d.out[kW].at(r, 0, g, k) = (whw * dpw + wq * bw.du) / wwidth;
  const T w1 = wq * bw.dc1 / wwidth, w0 = wq * bw.dc0 / wwidth;
  d.out[kWMean].at(r, 0, g, k) = (w1 - w0) * wsz;
  d.out[kWSize].at(r, 0, g, k) = w1 * (wm - wlow) + w0 * (whigh - wm);
  return part;
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreads) tables_grad_kernel(const __grid_constant__ Args<T> a,
                                                               const __grid_constant__ Grads<T> d) {
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long r = blockIdx.y;
  T part = T(0);  // this thread's part of d/d size of the specific prior
  if (g < a.G) {
    const long long G = a.G, R = a.R;
    // each spot's weight in the tables: their gradients over the configs holding it
    T wsp[K], whw[K], wq[K];
#pragma unroll
    for (int k = 0; k < K; ++k) wsp[k] = whw[k] = wq[k] = T(0);
    for (int m = 0; m < a.M; ++m) {
      const unsigned bits = a.masks[m];
      const T ghw = d.ghw[(m * R + r) * G + g], gq = d.gq[(m * R + r) * G + g];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const T on = T((bits >> k) & 1u);
        whw[k] += on * ghw;
        wq[k] += on * gq;
      }
      for (int t = 0; t < a.NT; ++t) {
        const T gxy = d.gxy[((m * R + r) * a.NT + t) * G + g];
#pragma unroll
        for (int k = 0; k < K; ++k)
          if ((a.spec[t] >> k) & 1u) wsp[k] += T((bits >> k) & 1u) * gxy;
      }
    }
    const Affine<T> sp_c = chain(a, r);
    const T sp_psi = digamma(sp_c.c1 + sp_c.c0), sp_p1 = digamma(sp_c.c1),
            sp_p0 = digamma(sp_c.c0);
#pragma unroll
    for (int k = 0; k < K; ++k)
      part += spot_grad(a, d, r, g, k, wsp[k], whw[k], wq[k], sp_c, sp_psi, sp_p1, sp_p0);
    // q(m [| z]): log qm in the configs holding the spot, log1p(-qm) in the others
    for (int z = 0; z < a.Z; ++z) {
      T w1[K], w0[K];
#pragma unroll
      for (int k = 0; k < K; ++k) w1[k] = w0[k] = T(0);
      for (int m = 0; m < a.M; ++m) {
        const unsigned bits = a.masks[m];
        const T glq = d.glq[((m * R + r) * a.Z + z) * G + g];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const T on = T((bits >> k) & 1u);
          w1[k] += on * glq;
          w0[k] += (T(1) - on) * glq;
        }
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const T qm = ld(a.in[kQm], r, z, g, k);
        d.out[kQm].at(r, z, g, k) = w1[k] / qm - w0[k] / (T(1) - qm);
      }
    }
  }
  part = block_sum(part);
  if (threadIdx.x == 0) d.part[r * gridDim.x + blockIdx.x] = part;
}

// d prox[r] from chain r's partials of d/d size, added in a fixed order:
// size = a^2 - 1, a = (P + 1) / (2 prox). One block a chain.
template <typename T>
__global__ void __launch_bounds__(kThreads) prox_kernel(const T* __restrict__ part,
                                                        const T* __restrict__ prox,
                                                        long long blocks, T p1,
                                                        T* __restrict__ out) {
  const long long r = blockIdx.x;
  T t = T(0);
  for (long long j = threadIdx.x; j < blocks; j += kThreads) t += part[r * blocks + j];
  t = block_sum(t);
  if (threadIdx.x == 0) {
    const T den = T(2) * prox[r], pa = p1 / den;
    out[r] = T(2) * (-(t * T(2) * pa) * p1 / (den * den));
  }
}

// ptrs: the 12 inputs and prox (device); strides: (sr, sz, sg, sk) of each
// input (host); masks: M bitmasks, spec: NT bitmasks, consts: kConsts
// values (host)
template <typename T>
int fill(Args<T>& a, const void* const* ptrs, const long long* strides, long long R,
         long long G, int Z, int K, const unsigned* masks, int M, const unsigned* spec, int NT,
         const double* consts) {
  if (K < 1 || K > kMaxK || M < 1 || M > kMaxM || NT < 1 || NT > kMaxT || R < 1 ||
      R > 65535 || G < 1 || Z < 1)
    return int(cudaErrorInvalidValue);
  for (int i = 0; i < kInputs; ++i) {
    const long long* s = strides + 4 * i;
    a.in[i] = {static_cast<T*>(const_cast<void*>(ptrs[i])), s[0], s[1], s[2], s[3]};
  }
  a.prox = static_cast<const T*>(ptrs[kInputs]);
  a.R = R;
  a.G = G;
  a.Z = Z;
  a.M = M;
  a.NT = NT;
  for (int m = 0; m < M; ++m) a.masks[m] = masks[m];
  for (int t = 0; t < NT; ++t) a.spec[t] = spec[t];
  for (int j = 0; j < kConsts; ++j) a.c[j] = consts[j];
  return 0;
}

dim3 grid(const long long R, const long long G) {
  return dim3(unsigned((G + kThreads - 1) / kThreads), unsigned(R));
}

template <typename T, int K>
void tables_k(const Args<T>& a, T* const* out, cudaStream_t st) {
  tables_kernel<T, K><<<grid(a.R, a.G), kThreads, 0, st>>>(a, out[0], out[1], out[2], out[3]);
}

template <typename T, int K>
void tables_grad_k(const Args<T>& a, const Grads<T>& d, cudaStream_t st) {
  tables_grad_kernel<T, K><<<grid(a.R, a.G), kThreads, 0, st>>>(a, d);
}

// the kernels' instance for the number of spots
#define ST_DISPATCH(fn, T, K, ...)         \
  switch (K) {                             \
    case 1: fn<T, 1>(__VA_ARGS__); break;  \
    case 2: fn<T, 2>(__VA_ARGS__); break;  \
    case 3: fn<T, 3>(__VA_ARGS__); break;  \
    case 4: fn<T, 4>(__VA_ARGS__); break;  \
    case 5: fn<T, 5>(__VA_ARGS__); break;  \
    default: fn<T, 6>(__VA_ARGS__); break; \
  }

// outs: term_xy (M, R, NT, G), term_hw, term_q (M, R, G), log_qm (M, R, Z, G)
template <typename T>
int tables(const void* const* ptrs, const long long* strides, long long R, long long G, int Z,
           int K, const unsigned* masks, int M, const unsigned* spec, int NT,
           const double* consts, void* const* outs, void* stream) {
  Args<T> a = {};
  if (int err = fill(a, ptrs, strides, R, G, Z, K, masks, M, spec, NT, consts)) return err;
  T* out[4];
  for (int j = 0; j < 4; ++j) out[j] = static_cast<T*>(outs[j]);
  ST_DISPATCH(tables_k, T, K, a, out, static_cast<cudaStream_t>(stream))
  return int(cudaGetLastError());
}

// gos: the four tables' gradients, as tables() writes them; grads: the 12
// inputs' gradients (device) with their strides (host, as ``strides``);
// part: (R, blocks a chain)
template <typename T>
int tables_grad(const void* const* ptrs, const long long* strides, long long R, long long G,
                int Z, int K, const unsigned* masks, int M, const unsigned* spec, int NT,
                const double* consts, const void* const* gos, void* const* grads,
                const long long* gstrides, void* part, void* stream) {
  Args<T> a = {};
  if (int err = fill(a, ptrs, strides, R, G, Z, K, masks, M, spec, NT, consts)) return err;
  Grads<T> d = {};
  d.gxy = static_cast<const T*>(gos[0]);
  d.ghw = static_cast<const T*>(gos[1]);
  d.gq = static_cast<const T*>(gos[2]);
  d.glq = static_cast<const T*>(gos[3]);
  for (int i = 0; i < kInputs; ++i) {
    const long long* s = gstrides + 4 * i;
    d.out[i] = {static_cast<T*>(grads[i]), s[0], s[1], s[2], s[3]};
  }
  d.part = static_cast<T*>(part);
  ST_DISPATCH(tables_grad_k, T, K, a, d, static_cast<cudaStream_t>(stream))
  return int(cudaGetLastError());
}

template <typename T>
int prox_sum(const void* part, const void* prox, long long R, long long blocks, double p1,
             void* out, void* stream) {
  if (R < 1 || blocks < 1) return int(cudaErrorInvalidValue);
  prox_kernel<T><<<unsigned(R), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(part), static_cast<const T*>(prox), blocks, T(p1),
      static_cast<T*>(out));
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

int st_max_spots() { return kMaxK; }

int st_block_threads() { return kThreads; }

#define ST_ENTRIES(suffix, T)                                                                   \
  int st_tables_##suffix(const void* const* ptrs, const long long* strides, long long R,       \
                         long long G, int Z, int K, const unsigned* masks, int M,              \
                         const unsigned* spec, int NT, const double* consts,                    \
                         void* const* outs, void* stream) {                                     \
    return tables<T>(ptrs, strides, R, G, Z, K, masks, M, spec, NT, consts, outs, stream);    \
  }                                                                                             \
  int st_tables_grad_##suffix(const void* const* ptrs, const long long* strides, long long R,  \
                              long long G, int Z, int K, const unsigned* masks, int M,         \
                              const unsigned* spec, int NT, const double* consts,               \
                              const void* const* gos, void* const* grads,                       \
                              const long long* gstrides, void* part, void* stream) {            \
    return tables_grad<T>(ptrs, strides, R, G, Z, K, masks, M, spec, NT, consts, gos, grads,  \
                          gstrides, part, stream);                                              \
  }                                                                                             \
  int st_prox_sum_##suffix(const void* part, const void* prox, long long R, long long blocks,  \
                           double p1, void* out, void* stream) {                               \
    return prox_sum<T>(part, prox, R, blocks, p1, out, stream);                                 \
  }

ST_ENTRIES(f32, float)
ST_ENTRIES(f64, double)

}  // extern "C"
