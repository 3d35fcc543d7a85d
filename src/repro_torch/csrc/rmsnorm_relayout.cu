// Kernel 4: RMSNorm on the stream fused with the MN -> MNM{tm}N{tn} tile
// store (the paper's Table III Prefill).
//
// Replaces the reference's TPU kernel src/repro/kernels/fused_rmsnorm_relayout.py:43,
// rmsnorm_relayout (_kernel at :21): for each logical row,
// y = x * rsqrt(mean(x^2) + eps) in f32, times an optional weight widened to
// f32, rounded once to x's dtype (to nearest even), and written straight into
// the (m / tm, n / tn, tm, tn) tiles.  Rows past (m / tm) * tm are not
// written, as in the reference, whose grid covers m / tm row tiles.
//
// Bound: device-memory bytes.  x is read once and the tiles written once,
// plus the weight (which stays in L2); a few operations per element.  At the
// Prefill store (8192 x 3072 bf16 with a weight) that is 100,669,440 bytes,
// 30 us at 3.35 TB/s.
//
// Design: a group of TPR threads owns one row.  Each thread loads its share
// of the row in 16-byte packs (8 bf16 or 4 f32) and keeps up to CACHE packs in
// registers, so the row crosses device memory once: one pass takes the sum of
// squares, a deterministic group reduction gives the row's scale, and a
// second pass over the registers normalises and stores.  A pack of V columns
// never straddles a tile (tn % V == 0), so each store is one 16-byte write
// into a contiguous tile row.  The host picks TPR so the row fits the
// registers (32 threads for rows of up to 256 packs, up to 256 threads);
// longer rows re-read what did not fit.  Shapes whose columns or tiles are not
// a whole number of packs take a one-element-per-access instantiation.
#include "xdma_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int CACHE = 8;       // packs a thread keeps in registers

struct NormArgs {
  int64_t rows;      // rows normalised: (m / tm) * tm
  int64_t cols;      // n, a multiple of tn
  int64_t tm, tn;
  int64_t dtype;     // x's dtype code, also the output's
  int64_t w_dtype;   // the weight's dtype code, or -1 without a weight
  double eps;
};

__device__ __forceinline__ float weight_at(const void* w, int64_t dt,
                                           int64_t j) {
  if (dt == xdma::F32) return static_cast<const float*>(w)[j];
  if (dt == xdma::BF16)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(w)[j]);
  return __half2float(static_cast<const __half*>(w)[j]);
}

template <typename T, int V>
__device__ __forceinline__ float sum_squares(const xdma::Pack<T, V>& p) {
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const float f = xdma::to_f32<T>(p.v[e]);
    s += f * f;
  }
  return s;
}

template <typename T, int V>
__device__ __forceinline__ void norm_store(const xdma::Pack<T, V>& p,
                                           int64_t vi, float inv, const void* w,
                                           const NormArgs& a, T* orow) {
  const int64_t j = vi * V;
  xdma::Pack<T, V> o;
#pragma unroll
  for (int e = 0; e < V; ++e) {
    float y = xdma::to_f32<T>(p.v[e]) * inv;
    if (w) y = y * weight_at(w, a.w_dtype, j + e);
    o.v[e] = xdma::from_f32<T>(y);
  }
  // column j lies in tile j / tn of the row's tile row, at offset j % tn
  int64_t jt, jr;
  xdma::divmod(j, a.tn, jt, jr);
  *reinterpret_cast<xdma::Pack<T, V>*>(orow + jt * a.tm * a.tn + jr) = o;
}

template <typename T, int V, int TPR>
__global__ void __launch_bounds__(THREADS)
rmsnorm_relayout_kernel(const T* __restrict__ x, const void* __restrict__ w,
                        T* __restrict__ out, NormArgs a) {
  using P = xdma::Pack<T, V>;
  __shared__ float scratch[THREADS / 32];
  const int t = threadIdx.x % TPR;
  const int64_t row = (int64_t)blockIdx.x * (THREADS / TPR) + threadIdx.x / TPR;
  const bool live = row < a.rows;
  const int64_t nvec = a.cols / V;
  const P* src = reinterpret_cast<const P*>(x + (live ? row : 0) * a.cols);

  P cache[CACHE];
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < CACHE; ++k) {
    const int64_t vi = t + (int64_t)TPR * k;
    if (live && vi < nvec) {
      cache[k] = src[vi];
      ss += sum_squares<T, V>(cache[k]);
    }
  }
  for (int64_t vi = t + (int64_t)TPR * CACHE; live && vi < nvec; vi += TPR)
    ss += sum_squares<T, V>(src[vi]);
  ss = xdma::group_reduce<TPR>(ss, scratch, xdma::SumOp());
  if (!live) return;

  const float inv = rsqrtf(ss / (float)a.cols + (float)a.eps);
  int64_t rt, rr;
  xdma::divmod(row, a.tm, rt, rr);
  T* orow = out + rt * a.cols * a.tm + rr * a.tn;
#pragma unroll
  for (int k = 0; k < CACHE; ++k) {
    const int64_t vi = t + (int64_t)TPR * k;
    if (vi < nvec) norm_store<T, V>(cache[k], vi, inv, w, a, orow);
  }
  for (int64_t vi = t + (int64_t)TPR * CACHE; vi < nvec; vi += TPR)
    norm_store<T, V>(src[vi], vi, inv, w, a, orow);
}

template <typename T, int V, int TPR>
int launch(const NormArgs& a, const void* x, const void* w, void* out,
           cudaStream_t stream) {
  constexpr int64_t rows_per_block = THREADS / TPR;
  const int64_t blocks = (a.rows + rows_per_block - 1) / rows_per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  rmsnorm_relayout_kernel<T, V, TPR><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(x), w, static_cast<T*>(out), a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const NormArgs& a, const void* x, const void* w, void* out,
             cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const bool packed = a.cols % V == 0 && a.tn % V == 0 &&
                      (uintptr_t)x % 16 == 0 && (uintptr_t)out % 16 == 0;
  if (!packed) return launch<T, 1, 256>(a, x, w, out, s);
  const int64_t nvec = a.cols / V;
  if (nvec <= 32 * CACHE) return launch<T, V, 32>(a, x, w, out, s);
  if (nvec <= 64 * CACHE) return launch<T, V, 64>(a, x, w, out, s);
  if (nvec <= 128 * CACHE) return launch<T, V, 128>(a, x, w, out, s);
  return launch<T, V, 256>(a, x, w, out, s);
}

}  // namespace

extern "C" int xdma_rmsnorm_relayout(const void* args, const void* x,
                                     const void* w, void* out, void* stream) {
  const NormArgs& a = *static_cast<const NormArgs*>(args);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.tm <= 0 || a.tn <= 0 || a.cols % a.tn) return (int)cudaErrorInvalidValue;
  if (a.rows == 0 || a.cols == 0) return 0;
  if (w && a.w_dtype != xdma::F32 && a.w_dtype != xdma::BF16 &&
      a.w_dtype != xdma::F16)
    return (int)cudaErrorInvalidValue;
  switch (a.dtype) {
    case xdma::F32: return dispatch<float>(a, x, w, out, s);
    case xdma::BF16: return dispatch<__nv_bfloat16>(a, x, w, out, s);
    case xdma::F16: return dispatch<__half>(a, x, w, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
