// The spot render and config assembly of cosmos's likelihood, for Hopper
// (sm_90a).
//
// Replaces no TPU kernel. The JAX package renders K spots on every pixel of
// every image (gaussian_spots_flat), sums them into the M = 2^K spot
// configurations with an einsum over the (M, K) config table, adds the
// background and divides by the gain inside one jitted XLA program, which
// fuses the element-wise work. Run op by op in PyTorch the same chain made
// ~56 launches a step, 32 of them over 2.6M-5.2M elements, and ~0.9 GB of
// reads and writes for what needs one write of the (M, nb, EVP)
// concentration forward and one read of its gradient backward. Two kernels
// take its place, for image i (chain r = i / per_chain) and flat pixel p =
// row * P + column of EVP lanes:
//
//  * render_kernel (forward): for each config m
//        out[m, i, p] = (b[i] + sum_{k in m} s_k[i, p]) / gain[r],
//        s_k = h_k exp(-d2_k / (2 w_k^2) - log(2 pi w_k^2)),
//        d2_k = (column - x_k - tx)^2 + (row - y_k - ty)^2,
//    with s_k = 0 on lanes p >= P * P. The K spots stay in registers; each
//    block takes one image's pixels and writes every config's lane once.
//  * render_grad_kernel (backward): one warp an image reads the gradient
//    go[m, i, p] of every config once, recomputes the spots and reduces over
//    the pixels (and over the configs holding each spot) to
//        d b     = sum_{m, p} go / gain
//        d h_k   = sum_p S_k g_k / gain,
//        d w_k   = h_k / w_k sum_p S_k g_k (d2_k / w_k^2 - 2) / gain
//        d x_k   = h_k / w_k^2 sum_p S_k g_k (column - sx_k) / gain
//        d y_k   = h_k / w_k^2 sum_p S_k g_k (row - sy_k) / gain
//    (g_k = s_k / h_k, S_k = the sum of go over the configs holding spot
//    k), and writes per image the partial sum_{m, p} go (b +
//    sum_{k in m} s_k) of the gain's gradient. gain_kernel then adds each
//    chain's partials in a fixed order: d gain[r] = -sum / gain[r]^2.
//
// Every reduction is a fixed tree (warp shuffles, then the warps in order)
// and no floating-point atomic is used, so repeated launches are bitwise
// equal. Configs are bitmasks over the spots (bit k of masks[m]: spot k in
// config m), K <= 6 and M <= 64, as the factored likelihood kernel takes
// them. K is a template parameter (an instance for each), so a spot's
// values stay in registers; each spot's centre, 2 w^2 and log(2 pi w^2)
// are taken once per image, not per pixel.
//
// Arithmetic: the forward follows the PyTorch composition
// (distributions/util.py's gaussian_spots_flat, the einsum, the division)
// operation by operation with round-to-nearest intrinsics, so nothing is
// contracted into an FMA, and the accurate expf / logf (exp / log in
// float64); no --use_fast_math. The spots of a config add in k order.
//
// What bounds them: memory. At cosmos's eLife window (M = 4, nb = 5120
// images of EVP = 256 lanes) the forward writes 21.0 MB and the backward
// reads as much: ~6 us each at 3.35 TB/s.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxK = 6;            // spots an image
constexpr int kMaxM = 1 << kMaxK;   // configs
constexpr int kThreads = 256;       // a block's threads at most

template <typename T>
struct Args {
  const T* b;     // (nb,) background
  const T* h;     // (nb, K) heights
  const T* w;     // (nb, K) widths
  const T* x;     // (nb, K) column offsets from the target
  const T* y;     // (nb, K) row offsets from the target
  const T* tl;    // (nb, 2) target column, row
  const T* gain;  // (R,) one per chain
  long long nb, per_chain;
  int K, M, P, EVP;
  unsigned masks[kMaxM];
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float ex(float a) { return expf(a); }
__device__ __forceinline__ float lg(float a) { return logf(a); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double dvd(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ double ex(double a) { return exp(a); }
__device__ __forceinline__ double lg(double a) { return log(a); }

// Spot k of image i: its height, centre (column, row), 2 w^2 and log(2 pi
// w^2), which every pixel of the image shares.
template <typename T>
struct Spot {
  T h, w, sx, sy, var, var2, lnorm;
};

template <typename T, int K>
__device__ __forceinline__ Spot<T> spot(const Args<T>& a, long long i, int k) {
  const long long ik = i * K + k;
  Spot<T> s;
  s.h = __ldg(a.h + ik);
  s.w = __ldg(a.w + ik);
  s.sx = add(__ldg(a.x + ik), __ldg(a.tl + 2 * i));
  s.sy = add(__ldg(a.y + ik), __ldg(a.tl + 2 * i + 1));
  s.var = mul(s.w, s.w);
  s.var2 = mul(T(2), s.var);
  s.lnorm = lg(mul(T(6.283185307179586), s.var));
  return s;
}

// The unit Gaussian of a spot at column and row distances dx, dy (d2 their
// squared length), as gaussian_spots_flat takes it
template <typename T>
__device__ __forceinline__ T gauss(const Spot<T>& s, T dx, T dy, T& d2) {
  d2 = add(mul(dx, dx), mul(dy, dy));
  return ex(sub(dvd(-d2, s.var2), s.lnorm));
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreads) render_kernel(const __grid_constant__ Args<T> a,
                                                          T* __restrict__ out) {
  __shared__ Spot<T> sh[K];
  const long long i = blockIdx.x;
  if (threadIdx.x < K) sh[threadIdx.x] = spot<T, K>(a, i, threadIdx.x);
  __syncthreads();
  const int p = blockIdx.y * blockDim.x + threadIdx.x;
  if (p >= a.EVP) return;
  const T rb = __ldg(a.b + i);
  const T gain = __ldg(a.gain + i / a.per_chain);
  const bool live = p < a.P * a.P;
  const T py = T(p / a.P), px = T(p % a.P);
  T s[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    s[k] = T(0);
    if (live) {
      const Spot<T> q = sh[k];
      T d2;
      s[k] = mul(q.h, gauss(q, sub(px, q.sx), sub(py, q.sy), d2));
    }
  }
  const long long plane = a.nb * a.EVP;
  T* o = out + i * a.EVP + p;
  for (int m = 0; m < a.M; ++m) {
    const unsigned bits = a.masks[m];
    T sum = T(0);
#pragma unroll
    for (int k = 0; k < K; ++k)
      if ((bits >> k) & 1u) sum = add(sum, s[k]);
    o[m * plane] = dvd(add(rb, sum), gain);
  }
}

template <typename T>
__device__ __forceinline__ T warp_sum(T t) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) t += __shfl_down_sync(0xffffffffu, t, off);
  return t;  // lane 0 holds the sum
}

// One warp an image. go: (M, nb, EVP); gb, part: (nb,); gh, gw, gx, gy: (nb, K)
template <typename T, int K>
__global__ void __launch_bounds__(kThreads) render_grad_kernel(
    const __grid_constant__ Args<T> a, const T* __restrict__ go, T* __restrict__ gb,
    T* __restrict__ gh, T* __restrict__ gw, T* __restrict__ gx, T* __restrict__ gy,
    T* __restrict__ part) {
  constexpr int nv = 2 + 4 * K;
  const int lane = threadIdx.x & 31;
  const long long i = blockIdx.x * (long long)(kThreads / 32) + (threadIdx.x >> 5);
  if (i >= a.nb) return;  // a whole warp; no block-wide barrier follows
  const T rb = __ldg(a.b + i);
  Spot<T> q[K];
#pragma unroll
  for (int k = 0; k < K; ++k) q[k] = spot<T, K>(a, i, k);
  // v[0]: sum go; v[1]: sum go * (b + spots); v[2 + 4k ...]: h, w, x, y of spot k
  T v[nv];
#pragma unroll
  for (int j = 0; j < nv; ++j) v[j] = T(0);
  const long long plane = a.nb * a.EVP;
  const T* gp = go + i * a.EVP;
  for (int p = lane; p < a.EVP; p += 32) {
    const bool live = p < a.P * a.P;
    const T py = T(p / a.P), px = T(p % a.P);
    T g[K], s[K], S[K], dx[K], dy[K], d2[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      dx[k] = sub(px, q[k].sx);
      dy[k] = sub(py, q[k].sy);
      g[k] = live ? gauss(q[k], dx[k], dy[k], d2[k]) : T(0);
      s[k] = mul(q[k].h, g[k]);
      S[k] = T(0);
    }
    for (int m = 0; m < a.M; ++m) {
      const unsigned bits = a.masks[m];
      const T gm = __ldg(gp + m * plane + p);
      T sum = T(0);
#pragma unroll
      for (int k = 0; k < K; ++k)
        if ((bits >> k) & 1u) {
          sum = add(sum, s[k]);
          S[k] = add(S[k], gm);
        }
      v[0] = add(v[0], gm);
      v[1] = add(v[1], mul(gm, add(rb, sum)));
    }
    if (!live) continue;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const T u = mul(S[k], g[k]);
      v[2 + 4 * k] = add(v[2 + 4 * k], u);
      v[3 + 4 * k] = add(v[3 + 4 * k], mul(u, sub(dvd(d2[k], q[k].var), T(2))));
      v[4 + 4 * k] = add(v[4 + 4 * k], mul(u, dx[k]));
      v[5 + 4 * k] = add(v[5 + 4 * k], mul(u, dy[k]));
    }
  }
#pragma unroll
  for (int j = 0; j < nv; ++j) v[j] = warp_sum(v[j]);
  if (lane != 0) return;
  const T gain = __ldg(a.gain + i / a.per_chain);
  gb[i] = dvd(v[0], gain);
  part[i] = v[1];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const long long ik = i * K + k;
    const T hv = dvd(q[k].h, q[k].var);
    gh[ik] = dvd(v[2 + 4 * k], gain);
    gw[ik] = dvd(mul(v[3 + 4 * k], dvd(q[k].h, q[k].w)), gain);
    gx[ik] = dvd(mul(v[4 + 4 * k], hv), gain);
    gy[ik] = dvd(mul(v[5 + 4 * k], hv), gain);
  }
}

// d gain[r] = -(sum of chain r's partials) / gain[r]^2; one block a chain,
// the warps' sums added in order
template <typename T>
__global__ void __launch_bounds__(kThreads) gain_kernel(const T* __restrict__ part,
                                                        const T* __restrict__ gain,
                                                        long long per_chain, T* __restrict__ out) {
  __shared__ T red[kThreads / 32];
  const long long r = blockIdx.x;
  T t = T(0);
  for (long long j = threadIdx.x; j < per_chain; j += kThreads)
    t = add(t, part[r * per_chain + j]);
  t = warp_sum(t);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = t;
  __syncthreads();
  if (threadIdx.x == 0) {
    t = red[0];
    for (int q = 1; q < kThreads / 32; ++q) t = add(t, red[q]);
    const T g = gain[r];
    out[r] = -dvd(t, mul(g, g));
  }
}

// ptrs: b, h, w, x, y, tl, gain (device); masks: M bitmasks (host)
template <typename T>
int fill(Args<T>& a, const void* const* ptrs, long long nb, long long per_chain, int K,
         const unsigned* masks, int M, int P, int EVP) {
  if (K < 1 || K > kMaxK || M < 1 || M > kMaxM || P < 1 || EVP < P * P || nb < 1 ||
      per_chain < 1 || nb % per_chain)
    return int(cudaErrorInvalidValue);
  a.b = static_cast<const T*>(ptrs[0]);
  a.h = static_cast<const T*>(ptrs[1]);
  a.w = static_cast<const T*>(ptrs[2]);
  a.x = static_cast<const T*>(ptrs[3]);
  a.y = static_cast<const T*>(ptrs[4]);
  a.tl = static_cast<const T*>(ptrs[5]);
  a.gain = static_cast<const T*>(ptrs[6]);
  a.nb = nb;
  a.per_chain = per_chain;
  a.K = K;
  a.M = M;
  a.P = P;
  a.EVP = EVP;
  for (int m = 0; m < M; ++m) a.masks[m] = masks[m];
  return 0;
}

template <typename T, int K>
void render_k(const Args<T>& a, T* out, cudaStream_t st) {
  const int threads = a.EVP >= kThreads ? kThreads : ((a.EVP + 31) / 32) * 32;
  const dim3 grid(unsigned(a.nb), unsigned((a.EVP + threads - 1) / threads));
  render_kernel<T, K><<<grid, threads, 0, st>>>(a, out);
}

template <typename T, int K>
void render_grad_k(const Args<T>& a, const T* go, T* const* g, cudaStream_t st) {
  const long long blocks = (a.nb + kThreads / 32 - 1) / (kThreads / 32);
  render_grad_kernel<T, K><<<unsigned(blocks), kThreads, 0, st>>>(a, go, g[0], g[1], g[2],
                                                                 g[3], g[4], g[5]);
}

// the kernels' instance for the number of spots
#define SR_DISPATCH(fn, T, ...)            \
  switch (a.K) {                           \
    case 1: fn<T, 1>(__VA_ARGS__); break;  \
    case 2: fn<T, 2>(__VA_ARGS__); break;  \
    case 3: fn<T, 3>(__VA_ARGS__); break;  \
    case 4: fn<T, 4>(__VA_ARGS__); break;  \
    case 5: fn<T, 5>(__VA_ARGS__); break;  \
    default: fn<T, 6>(__VA_ARGS__); break; \
  }

template <typename T>
int render(const void* const* ptrs, long long nb, long long per_chain, int K,
           const unsigned* masks, int M, int P, int EVP, void* out, void* stream) {
  Args<T> a = {};
  if (int err = fill(a, ptrs, nb, per_chain, K, masks, M, P, EVP)) return err;
  auto st = static_cast<cudaStream_t>(stream);
  SR_DISPATCH(render_k, T, a, static_cast<T*>(out), st)
  return int(cudaGetLastError());
}

// grads: gb, gh, gw, gx, gy, part, ggain (device; ggain null: no gain gradient)
template <typename T>
int render_grad(const void* const* ptrs, long long nb, long long per_chain, int K,
                const unsigned* masks, int M, int P, int EVP, const void* go,
                void* const* grads, void* stream) {
  Args<T> a = {};
  if (int err = fill(a, ptrs, nb, per_chain, K, masks, M, P, EVP)) return err;
  auto st = static_cast<cudaStream_t>(stream);
  T* g[7];
  for (int j = 0; j < 7; ++j) g[j] = static_cast<T*>(grads[j]);
  SR_DISPATCH(render_grad_k, T, a, static_cast<const T*>(go), g, st)
  if (g[6] != nullptr)
    gain_kernel<T><<<unsigned(nb / per_chain), kThreads, 0, st>>>(g[5], a.gain, per_chain,
                                                                  g[6]);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

int sr_max_spots() { return kMaxK; }

int sr_render_f32(const void* const* ptrs, long long nb, long long per_chain, int K,
                  const unsigned* masks, int M, int P, int EVP, void* out, void* stream) {
  return render<float>(ptrs, nb, per_chain, K, masks, M, P, EVP, out, stream);
}

int sr_render_f64(const void* const* ptrs, long long nb, long long per_chain, int K,
                  const unsigned* masks, int M, int P, int EVP, void* out, void* stream) {
  return render<double>(ptrs, nb, per_chain, K, masks, M, P, EVP, out, stream);
}

int sr_render_grad_f32(const void* const* ptrs, long long nb, long long per_chain, int K,
                       const unsigned* masks, int M, int P, int EVP, const void* go,
                       void* const* grads, void* stream) {
  return render_grad<float>(ptrs, nb, per_chain, K, masks, M, P, EVP, go, grads, stream);
}

int sr_render_grad_f64(const void* const* ptrs, long long nb, long long per_chain, int K,
                       const unsigned* masks, int M, int P, int EVP, const void* go,
                       void* const* grads, void* stream) {
  return render_grad<double>(ptrs, nb, per_chain, K, masks, M, P, EVP, go, grads, stream);
}

}  // extern "C"
