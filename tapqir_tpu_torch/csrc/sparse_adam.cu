// The window-space sparse Adam of the sparse SVI step, for Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package's one_step_sparse
// (tapqir_tpu/models/model.py) gathers the minibatch's windows of the
// parameters and Adam moments, steps them and scatters them back inside one
// jitted XLA program, which fuses the element-wise work. Run op by op in
// PyTorch the same work took ~580 launches a step (two index_selects and a
// clone per leaf for the parameter windows, the same for each moment, ~16
// element-wise ops per leaf, an index_select and two index_copy_s per leaf
// and tree for the write-back). Two kernels take their place:
//
//  * window_kernel<T, false> (the gather): copies every leaf's window out of
//    the full parameter arrays into one flat buffer, whose views are the
//    ELBO's leaves: rows ndx x frames fidx of a per-AOI-frame leaf ("af"),
//    rows ndx of a per-AOI leaf ("a"), a global leaf ("g") whole.
//  * window_kernel<T, true> (the update): reads each window element's
//    gradient from the autograd output and its parameter, first and second
//    moment in place in the full arrays, takes the Adam step and writes all
//    three back, and bumps the step counts of the window: count_g once,
//    count_a[row] once per row, count_af[row * F + frame] once per (row,
//    frame).
//
// What bounds them: launch latency, not memory or arithmetic. At the eLife
// windows (10 rows x 512 frames) the update moves ~2.6 MB (cosmos) or
// ~5.2 MB (crosstalk): 0.8 / 1.6 us at 3.35 TB/s.
//
// Layout. A leaf's element is (lead, row, frame, trail) in the full array
// and (lead, i, j, trail) in its window, with row = ndx[i] and frame =
// fidx[j] (j when fidx is null). A group's "position" is what one step
// count covers: (i, j) for af, i for a, the single position of g. Its count
// index (row * F + frame, row, 0) is also the position's place in the full
// (row, frame) plane, so for a slot s = (leaf, lead, trail)
//     full   = full_base[s] + count_index * stride[s]
//     window = win_base[s]  + position    * stride[s]
// with stride = the trailing extent (an element of g is a slot of its own).
// The slot table is built once per model and window shape on the device.
//
// A block takes P consecutive positions of one group and every slot of the
// group at them. All readers of a position's count are therefore in one
// block: its first P threads read the counts, bump them and compute the
// bias corrections into shared memory, the block synchronises, then the
// block's threads walk its slots x positions (positions fastest, so a warp
// reads neighbouring frames of one slot). No count is read after its bump
// and no two blocks share one; the batch's rows and frames are distinct.
//
// Arithmetic: as the PyTorch version (ops/sparse_adam.py), operation by
// operation with round-to-nearest intrinsics, so nothing is contracted into
// an FMA: a non-finite gradient becomes 0;
//     mu2 = b1 mu + (1 - b1) g,   nu2 = b2 nu + ((1 - b2) g) g,
//     p2  = p - (lr (mu2 / c1)) / (sqrt(nu2 / c2) + eps),
// with c = 1 - b^t at t = the count after the bump, in float32 for the
// row groups (as the JAX package) and in the parameters' type for g.
// IEEE division and square root; no --use_fast_math.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxLeaves = 64;
constexpr int kThreads = 256;  // a block's positions P are at most this
constexpr int kGroups = 3;     // 0: globals, 1: per-AOI, 2: per-AOI-frame
constexpr double kB1 = 0.9, kB2 = 0.999, kEps = 1e-8;

struct Group {
  long long npos;    // positions: 1, n or n * f
  long long P;       // positions a block
  long long blocks;  // ceil(npos / P); 0 for a group without leaves
  long long slot0, slot1;
  int* count;        // its step counts (the update only)
};

struct Args {
  Group grp[kGroups];
  const long long* slots;  // (nslots, 4): leaf, stride, full base, window base
  const long long* ndx;    // (n,) AOI rows
  const long long* fidx;   // (f,) frames, or null: frame j is j
  long long f, F;          // the window's frames, the full arrays' frames
  double lr;
  void* p[kMaxLeaves];     // full parameter arrays
  void* mu[kMaxLeaves];    // full first moments
  void* nu[kMaxLeaves];    // full second moments
  void* w[kMaxLeaves];     // the gather's output window / the update's gradient
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float sqr(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ float pw(float a, float b) { return powf(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double dvd(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ double sqr(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ double pw(double a, double b) { return pow(a, b); }

// 1 - b^t: in T for globals (group 0), in float32 for the row groups
template <typename T>
__device__ __forceinline__ T correction(double b, int t, int group) {
  if (group == 0) return sub(T(1), pw(T(b), T(t)));
  return T(sub(1.0f, pw(float(b), float(t))));
}

template <typename T, bool kAdam>
__global__ void __launch_bounds__(kThreads)
    window_kernel(const __grid_constant__ Args a) {
  __shared__ long long s_cidx[kThreads];
  __shared__ T s_c1[kThreads];
  __shared__ T s_c2[kThreads];

  long long b = blockIdx.x;
  int gi = 0;
  while (b >= a.grp[gi].blocks) b -= a.grp[gi++].blocks;
  const Group& G = a.grp[gi];
  const long long pos0 = b * G.P;
  const int Pb = int(min(G.P, G.npos - pos0));
  const int tid = threadIdx.x;

  if (tid < Pb) {
    const long long pos = pos0 + tid;
    long long cidx = 0;
    if (gi == 1) {
      cidx = a.ndx[pos];
    } else if (gi == 2) {
      const long long j = pos % a.f;
      cidx = a.ndx[pos / a.f] * a.F + (a.fidx ? a.fidx[j] : j);
    }
    s_cidx[tid] = cidx;
    if (kAdam) {
      const int t = G.count[cidx] + 1;
      G.count[cidx] = t;
      s_c1[tid] = correction<T>(kB1, t, gi);
      s_c2[tid] = correction<T>(kB2, t, gi);
    }
  }
  __syncthreads();

  const int E = int(G.slot1 - G.slot0);
  const T lr = T(a.lr);
  for (int e = tid; e < E * Pb; e += kThreads) {
    const int q = e % Pb;
    const long long* sl = a.slots + 4 * (G.slot0 + e / Pb);
    const int leaf = int(__ldg(sl));
    const long long stride = __ldg(sl + 1);
    const long long full = __ldg(sl + 2) + s_cidx[q] * stride;
    const long long win = __ldg(sl + 3) + (pos0 + q) * stride;
    T* p = static_cast<T*>(a.p[leaf]);
    if (!kAdam) {
      static_cast<T*>(a.w[leaf])[win] = p[full];
      continue;
    }
    T g = static_cast<const T*>(a.w[leaf])[win];
    if (!isfinite(g)) g = T(0);
    T* mu = static_cast<T*>(a.mu[leaf]);
    T* nu = static_cast<T*>(a.nu[leaf]);
    const T mu2 = add(mul(T(kB1), mu[full]), mul(T(1.0 - kB1), g));
    const T nu2 = add(mul(T(kB2), nu[full]), mul(mul(T(1.0 - kB2), g), g));
    const T step = dvd(mul(lr, dvd(mu2, s_c1[q])), add(sqr(dvd(nu2, s_c2[q])), T(kEps)));
    p[full] = sub(p[full], step);
    mu[full] = mu2;
    nu[full] = nu2;
  }
}

// meta: per group (npos, P, blocks, slot0, slot1), then f and F;
// ptrs: the L leaves' p, then mu, nu and w pointers (host arrays)
template <typename T>
int launch(int adam, const long long* meta, const void* slots, void* const* ptrs,
           int L, const void* ndx, const void* fidx, void* const* counts, double lr,
           void* stream) {
  if (L < 0 || L > kMaxLeaves) return int(cudaErrorInvalidValue);
  Args a = {};
  long long grid = 0;
  for (int gi = 0; gi < kGroups; ++gi) {
    const long long* m = meta + 5 * gi;
    a.grp[gi] = Group{m[0], m[1], m[2], m[3], m[4],
                      adam ? static_cast<int*>(counts[gi]) : nullptr};
    grid += m[2];
  }
  a.slots = static_cast<const long long*>(slots);
  a.ndx = static_cast<const long long*>(ndx);
  a.fidx = static_cast<const long long*>(fidx);
  a.f = meta[5 * kGroups];
  a.F = meta[5 * kGroups + 1];
  a.lr = lr;
  for (int l = 0; l < L; ++l) {
    a.p[l] = ptrs[l];
    a.mu[l] = ptrs[L + l];
    a.nu[l] = ptrs[2 * L + l];
    a.w[l] = ptrs[3 * L + l];
  }
  if (grid == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  if (adam)
    window_kernel<T, true><<<unsigned(grid), kThreads, 0, st>>>(a);
  else
    window_kernel<T, false><<<unsigned(grid), kThreads, 0, st>>>(a);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

int sa_max_leaves() { return kMaxLeaves; }

int sa_threads() { return kThreads; }

int sa_window_f32(int adam, const long long* meta, const void* slots, void* const* ptrs,
                  int L, const void* ndx, const void* fidx, void* const* counts,
                  double lr, void* stream) {
  return launch<float>(adam, meta, slots, ptrs, L, ndx, fidx, counts, lr, stream);
}

int sa_window_f64(int adam, const long long* meta, const void* slots, void* const* ptrs,
                  int L, const void* ndx, const void* fidx, void* const* counts,
                  double lr, void* stream) {
  return launch<double>(adam, meta, slots, ptrs, L, ndx, fidx, counts, lr, stream);
}

}  // extern "C"
