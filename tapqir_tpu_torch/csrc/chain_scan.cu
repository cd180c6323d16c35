// The prefix products of cosmos+hmm's z-chain in the log semiring, forward
// and backward, for Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package scans the chain's log-transition
// matrices with jax.lax.associative_scan inside one jitted XLA program
// (tapqir_tpu/ops/scan.py). Run op by op in PyTorch, the Hillis-Steele
// doubling scan that took its place (ops/scan.py) issues a cat, a broadcast
// add and a logsumexp per level, 10 levels at F = 790 frames, and autograd
// runs the nodes of all of them backward: ~230 launches an ELBO for ~126 KB
// each way. Two kernels take its place. A chain is every index outside the
// frame axis and the last two axes; the input (outer, F, inner, S, S) is
// read in place, chain c = (c / inner, c % inner).
//
//  * scan_kernel (forward): P_0 = A_0 and P_f = P_{f-1} (x) A_f, with
//        (X (x) Y)[i, k] = log sum_j exp(X[i, j] + Y[j, k]),
//    each logsumexp max-subtracted as torch.logsumexp takes it (an infinite
//    max shifts by 0). One block a chain. Thread t folds the frames of its
//    run [t L, t L + L) left to right, the block scans the run products
//    (warp shuffles, then the warp totals), and each thread folds its run
//    again from the product of the runs before it, writing every P_f.
//  * scan_grad_kernel (backward), from the input A, the saved P and the
//    cotangent gP of P: with
//        w_f[i, j, k] = exp(P_{f-1}[i, j] + A_f[j, k] - P_f[i, k])
//    (0 where P_f[i, k] = -inf: an unreachable state passes nothing back),
//    the cotangent of P_f, G_f[i, j] = gP_f[i, j] + sum_k G_{f+1}[i, k]
//    w_{f+1}[i, j, k], runs from the last frame to the first, and then
//        dA_f[j, k] = sum_i G_f[i, k] w_f[i, j, k]  (f >= 1),  dA_0 = G_0.
//    Each row i of G is its own recursion g_f = gP_f[i] + W_{f+1} g_{f+1},
//    affine in g, so a run of frames composes to one map g -> c + M g. One
//    block a chain, S threads (one a row) for each run: each composes its
//    run's map, the block scans the maps from the last run back (warp
//    shuffles, then the warp totals), and each thread runs its frames again
//    from the g that follows its run, writing G_f into dA's buffer. After a
//    barrier, each thread turns the G_f of its frames into dA_f in place.
//
// Every reduction is a fixed tree and no atomic is used, so repeated
// launches are bitwise equal. The number of states S = 1 + hmm's S is a
// template parameter (an instance for each S <= kMaxS), so a matrix stays in
// registers. The accurate expf / logf (exp / log in float64); no
// --use_fast_math.
//
// What bounds them: latency. At hmm's eLife window (10 chains x 790 frames,
// S = 2) they move 253 KB forward and 506 KB backward, well under a
// microsecond at 3.35 TB/s; the forward's critical path is about 2 L +
// log2(runs) dependent products (L = 4, 198 runs), the backward's about
// twice that. On an H100 they take ~9 us and ~16 us there.

#include <cuda_runtime.h>

#include <math_constants.h>

namespace {

constexpr int kMaxS = 4;          // states of the chain
constexpr int kRunThreads = 256;  // runs a chain at most
constexpr int kWarps = kRunThreads / 32;

__device__ __forceinline__ float ex(float a) { return expf(a); }
__device__ __forceinline__ float lg(float a) { return logf(a); }
__device__ __forceinline__ double ex(double a) { return exp(a); }
__device__ __forceinline__ double lg(double a) { return log(a); }
__device__ __forceinline__ float neg_inf(float) { return -CUDART_INF_F; }
__device__ __forceinline__ double neg_inf(double) { return -CUDART_INF; }

template <typename T, int S>
struct Mat {
  T v[S][S];
};

// X (x) Y in the log semiring, each entry a max-subtracted logsumexp over j
template <typename T, int S>
__device__ __forceinline__ Mat<T, S> lmm(const Mat<T, S>& x, const Mat<T, S>& y) {
  Mat<T, S> r;
#pragma unroll
  for (int i = 0; i < S; ++i) {
#pragma unroll
    for (int k = 0; k < S; ++k) {
      T t[S];
      T m = neg_inf(T(0));
#pragma unroll
      for (int j = 0; j < S; ++j) {
        t[j] = x.v[i][j] + y.v[j][k];
        m = fmax(m, t[j]);
      }
      if (isinf(m)) m = T(0);
      T s = T(0);
#pragma unroll
      for (int j = 0; j < S; ++j) s += ex(t[j] - m);
      r.v[i][k] = lg(s) + m;
    }
  }
  return r;
}

template <typename T, int S>
__device__ __forceinline__ Mat<T, S> load(const T* p) {
  Mat<T, S> r;
#pragma unroll
  for (int i = 0; i < S; ++i)
#pragma unroll
    for (int k = 0; k < S; ++k) r.v[i][k] = p[i * S + k];
  return r;
}

template <typename T, int S>
__device__ __forceinline__ void store(T* p, const Mat<T, S>& x) {
#pragma unroll
  for (int i = 0; i < S; ++i)
#pragma unroll
    for (int k = 0; k < S; ++k) p[i * S + k] = x.v[i][k];
}

template <typename T, int S>
__device__ __forceinline__ Mat<T, S> shfl_up(const Mat<T, S>& x, int d) {
  Mat<T, S> r;
#pragma unroll
  for (int i = 0; i < S; ++i)
#pragma unroll
    for (int k = 0; k < S; ++k) r.v[i][k] = __shfl_up_sync(0xffffffffu, x.v[i][k], d);
  return r;
}

struct Shape {
  long long F, inner;  // frames, chains per outer index
  int L;               // frames a run
};

// the first element of chain c's frame 0, and the stride between frames
template <int S>
__device__ __forceinline__ long long chain_base(const Shape& s, long long c) {
  return ((c / s.inner) * s.F * s.inner + c % s.inner) * S * S;
}

template <typename T, int S>
__global__ void __launch_bounds__(kRunThreads) scan_kernel(const Shape s,
                                                           const T* __restrict__ a,
                                                           T* __restrict__ p) {
  __shared__ Mat<T, S> tot[kWarps];
  const long long base = chain_base<S>(s, blockIdx.x);
  const long long stride = s.inner * S * S;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long f0 = (long long)t * s.L;
  const long long f1 = f0 + s.L < s.F ? f0 + s.L : s.F;
  const bool live = f0 < s.F;

  // the run's product; a run past the last frame holds zeros, which only
  // later runs, none of them live, would take
  Mat<T, S> x = {};
  if (live) {
    x = load<T, S>(a + base + f0 * stride);
    for (long long f = f0 + 1; f < f1; ++f) x = lmm(x, load<T, S>(a + base + f * stride));
  }
  // the products of the runs up to this one within the warp
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Mat<T, S> y = shfl_up(x, d);
    if (lane >= d) x = lmm(y, x);
  }
  const Mat<T, S> before_lane = shfl_up(x, 1);  // the warp's runs before this one
  if (lane == 31) tot[warp] = x;
  __syncthreads();
  if (warp == 0) {  // the products of the warps up to each
    const int nw = blockDim.x >> 5;
    Mat<T, S> w = {};
    if (lane < nw) w = tot[lane];
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const Mat<T, S> y = shfl_up(w, d);
      if (lane >= d) w = lmm(y, w);
    }
    if (lane < nw) tot[lane] = w;
  }
  __syncthreads();
  if (!live) return;
  // the product of every frame before the run
  bool have = warp > 0;
  Mat<T, S> e = {};
  if (have) e = tot[warp - 1];
  if (lane > 0) {
    e = have ? lmm(e, before_lane) : before_lane;
    have = true;
  }
  for (long long f = f0; f < f1; ++f) {
    const Mat<T, S> af = load<T, S>(a + base + f * stride);
    e = have ? lmm(e, af) : af;
    have = true;
    store(p + base + f * stride, e);
  }
}

// A row's map g -> c + M g over a run of frames
template <typename T, int S>
struct Aff {
  T M[S][S];
  T c[S];
};

// (x o y)(g) = x.c + x.M (y.c + y.M g)
template <typename T, int S>
__device__ __forceinline__ Aff<T, S> compose(const Aff<T, S>& x, const Aff<T, S>& y) {
  Aff<T, S> r;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    T cj = x.c[j];
#pragma unroll
    for (int k = 0; k < S; ++k) cj += x.M[j][k] * y.c[k];
    r.c[j] = cj;
#pragma unroll
    for (int k = 0; k < S; ++k) {
      T m = T(0);
#pragma unroll
      for (int l = 0; l < S; ++l) m += x.M[j][l] * y.M[l][k];
      r.M[j][k] = m;
    }
  }
  return r;
}

template <typename T, int S>
__device__ __forceinline__ Aff<T, S> shfl_down(const Aff<T, S>& x, int d) {
  Aff<T, S> r;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    r.c[j] = __shfl_down_sync(0xffffffffu, x.c[j], d);
#pragma unroll
    for (int k = 0; k < S; ++k) r.M[j][k] = __shfl_down_sync(0xffffffffu, x.M[j][k], d);
  }
  return r;
}

// W[j][k] = w_f[i, j, k] of row i of frame f (>= 1), from P_{f-1}, A_f, P_f
template <typename T, int S>
__device__ __forceinline__ void weights(const T* pp, const T* af, const T* pf, int i,
                                        T (&W)[S][S]) {
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const T pik = pf[i * S + k];
#pragma unroll
    for (int j = 0; j < S; ++j)
      W[j][k] = isinf(pik) && pik < T(0) ? T(0) : ex(pp[i * S + j] + af[j * S + k] - pik);
  }
}

template <typename T, int S>
__global__ void __launch_bounds__(kRunThreads * kMaxS) scan_grad_kernel(
    const Shape s, const T* __restrict__ a, const T* __restrict__ p,
    const T* __restrict__ gp, T* __restrict__ ga) {
  __shared__ Aff<T, S> tot[kWarps * S];
  const long long base = chain_base<S>(s, blockIdx.x);
  const long long stride = s.inner * S * S;
  const int per_row = blockDim.x / S;  // threads a row, whole warps
  const int i = threadIdx.x / per_row, r = threadIdx.x % per_row, lane = r & 31;
  const int warp = r >> 5, nw = per_row >> 5, slot = i * kWarps;
  const long long f0 = (long long)r * s.L;
  const long long f1 = f0 + s.L < s.F ? f0 + s.L : s.F;
  const bool live = f0 < s.F;
  const T* A = a + base;
  const T* P = p + base;
  const T* GP = gp + base;
  T* G = ga + base;

  // the run's map from g_{f1} to g_{f0}; a run past the last frame holds
  // zeros, and so does the last run's M: nothing follows the last frame
  Aff<T, S> x = {};
  if (live) {
    T W[S][S];
#pragma unroll
    for (int j = 0; j < S; ++j) x.c[j] = GP[(f1 - 1) * stride + i * S + j];
    if (f1 < s.F) {
      weights<T, S>(P + (f1 - 1) * stride, A + f1 * stride, P + f1 * stride, i, W);
#pragma unroll
      for (int j = 0; j < S; ++j)
#pragma unroll
        for (int k = 0; k < S; ++k) x.M[j][k] = W[j][k];
    }
    for (long long f = f1 - 2; f >= f0; --f) {
      weights<T, S>(P + f * stride, A + (f + 1) * stride, P + (f + 1) * stride, i, W);
      Aff<T, S> y;
#pragma unroll
      for (int j = 0; j < S; ++j) {
        y.c[j] = GP[f * stride + i * S + j];
#pragma unroll
        for (int k = 0; k < S; ++k) y.M[j][k] = W[j][k];
      }
      x = compose(y, x);
    }
  }
  // the maps of this run and the warp's runs after it
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Aff<T, S> y = shfl_down(x, d);
    if (lane + d < 32) x = compose(x, y);
  }
  const Aff<T, S> after_lane = shfl_down(x, 1);  // the warp's runs after this one
  if (lane == 0) tot[slot + warp] = x;
  __syncthreads();
  if (warp == 0) {  // each row's first warp: the maps of each warp and those after it
    Aff<T, S> w = {};
    if (lane < nw) w = tot[slot + lane];
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const Aff<T, S> y = shfl_down(w, d);
      if (lane + d < nw) w = compose(w, y);
    }
    if (lane < nw) tot[slot + lane] = w;
  }
  __syncthreads();
  if (live) {
    // g_{f1}: the c of the maps of every later run, whose last M is 0
    T g[S] = {};
    const bool after_warp = warp + 1 < nw;
    if (lane < 31) {
#pragma unroll
      for (int j = 0; j < S; ++j) g[j] = after_lane.c[j];
      if (after_warp) {
        const Aff<T, S>& w = tot[slot + warp + 1];
#pragma unroll
        for (int j = 0; j < S; ++j)
#pragma unroll
          for (int k = 0; k < S; ++k) g[j] += after_lane.M[j][k] * w.c[k];
      }
    } else if (after_warp) {
#pragma unroll
      for (int j = 0; j < S; ++j) g[j] = tot[slot + warp + 1].c[j];
    }
    // G_f's row i for each frame of the run, into dA's buffer
    T W[S][S];
    for (long long f = f1 - 1; f >= f0; --f) {
      T h[S];
#pragma unroll
      for (int j = 0; j < S; ++j) h[j] = GP[f * stride + i * S + j];
      if (f + 1 < s.F) {
        weights<T, S>(P + f * stride, A + (f + 1) * stride, P + (f + 1) * stride, i, W);
#pragma unroll
        for (int j = 0; j < S; ++j)
#pragma unroll
          for (int k = 0; k < S; ++k) h[j] += W[j][k] * g[k];
      }
#pragma unroll
      for (int j = 0; j < S; ++j) {
        g[j] = h[j];
        G[f * stride + i * S + j] = h[j];
      }
    }
  }
  __syncthreads();  // every row of every G_f written
  // dA_f from G_f in place, a frame a thread; dA_0 = G_0 stays
  for (long long f = 1 + threadIdx.x; f < s.F; f += blockDim.x) {
    T Gf[S][S], dA[S][S] = {};
#pragma unroll
    for (int q = 0; q < S; ++q)
#pragma unroll
      for (int k = 0; k < S; ++k) Gf[q][k] = G[f * stride + q * S + k];
#pragma unroll
    for (int q = 0; q < S; ++q) {
      T W[S][S];
      weights<T, S>(P + (f - 1) * stride, A + f * stride, P + f * stride, q, W);
#pragma unroll
      for (int j = 0; j < S; ++j)
#pragma unroll
        for (int k = 0; k < S; ++k) dA[j][k] += Gf[q][k] * W[j][k];
    }
#pragma unroll
    for (int j = 0; j < S; ++j)
#pragma unroll
      for (int k = 0; k < S; ++k) G[f * stride + j * S + k] = dA[j][k];
  }
}

// frames a run and threads a row: runs of ceil(F / kRunThreads) frames,
// whole warps of them
void split(long long F, int& L, int& threads) {
  L = int((F + kRunThreads - 1) / kRunThreads);
  const long long runs = (F + L - 1) / L;
  threads = int((runs + 31) / 32 * 32);
}

template <typename T>
int scan(const void* a, void* p, long long outer, long long F, long long inner, int S,
         void* stream) {
  if (outer < 1 || F < 1 || inner < 1 || S < 1 || S > kMaxS || outer * inner > 0x7fffffffLL)
    return int(cudaErrorInvalidValue);
  Shape s = {F, inner, 0};
  int threads;
  split(F, s.L, threads);
  auto st = static_cast<cudaStream_t>(stream);
  const unsigned grid = unsigned(outer * inner);
  const T* at = static_cast<const T*>(a);
  T* pt = static_cast<T*>(p);
  // one thread a run, whatever S: the forward scans whole matrices
  switch (S) {
    case 1: scan_kernel<T, 1><<<grid, threads, 0, st>>>(s, at, pt); break;
    case 2: scan_kernel<T, 2><<<grid, threads, 0, st>>>(s, at, pt); break;
    case 3: scan_kernel<T, 3><<<grid, threads, 0, st>>>(s, at, pt); break;
    default: scan_kernel<T, 4><<<grid, threads, 0, st>>>(s, at, pt); break;
  }
  return int(cudaGetLastError());
}

template <typename T>
int scan_grad(const void* a, const void* p, const void* gp, void* ga, long long outer,
              long long F, long long inner, int S, void* stream) {
  if (outer < 1 || F < 1 || inner < 1 || S < 1 || S > kMaxS || outer * inner > 0x7fffffffLL)
    return int(cudaErrorInvalidValue);
  Shape s = {F, inner, 0};
  int threads;
  split(F, s.L, threads);
  auto st = static_cast<cudaStream_t>(stream);
  const unsigned grid = unsigned(outer * inner);
  const T* at = static_cast<const T*>(a);
  const T* pt = static_cast<const T*>(p);
  const T* gpt = static_cast<const T*>(gp);
  T* gat = static_cast<T*>(ga);
  // S threads a run: one a row of the cotangent
  switch (S) {
    case 1: scan_grad_kernel<T, 1><<<grid, threads, 0, st>>>(s, at, pt, gpt, gat); break;
    case 2: scan_grad_kernel<T, 2><<<grid, 2 * threads, 0, st>>>(s, at, pt, gpt, gat); break;
    case 3: scan_grad_kernel<T, 3><<<grid, 3 * threads, 0, st>>>(s, at, pt, gpt, gat); break;
    default: scan_grad_kernel<T, 4><<<grid, 4 * threads, 0, st>>>(s, at, pt, gpt, gat); break;
  }
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

int cs_max_states() { return kMaxS; }

int cs_scan_f32(const void* a, void* p, long long outer, long long F, long long inner, int S,
                void* stream) {
  return scan<float>(a, p, outer, F, inner, S, stream);
}

int cs_scan_f64(const void* a, void* p, long long outer, long long F, long long inner, int S,
                void* stream) {
  return scan<double>(a, p, outer, F, inner, S, stream);
}

int cs_scan_grad_f32(const void* a, const void* p, const void* gp, void* ga, long long outer,
                     long long F, long long inner, int S, void* stream) {
  return scan_grad<float>(a, p, gp, ga, outer, F, inner, S, stream);
}

int cs_scan_grad_f64(const void* a, const void* p, const void* gp, void* ga, long long outer,
                     long long F, long long inner, int S, void* stream) {
  return scan_grad<double>(a, p, gp, ga, outer, F, inner, S, stream);
}

}  // extern "C"
