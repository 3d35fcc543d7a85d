// Kernel 5: symmetric int8 quantize-on-stream into the int8 tile layout (the
// wire format of the compressed collectives).
//
// Replaces the reference's TPU kernel src/repro/kernels/quant.py:34,
// quantize_tiled (_kernel at :18): for each logical row, in f32,
// scale = amax / 127 (1.0 when amax == 0 or NaN), q = clip(round(x / scale),
// +-127) as int8 (0 where the quotient is NaN), written into the
// (m / tm, n / tn, tm, tn) tiles, with the row's f32 scale in an (m, 1)
// column.  Rows past (m / tm) * tm are not written,
// as in the reference.
//
// Exactness: values and scales must equal the reference bit for bit.  XLA
// compiles the reference's amax / 127.0, a division by a constant, into
// amax * f32(1 / 127) wherever it is traced (its Pallas kernel as the tests
// run it, jit), so the scale is that product; x / scale is an IEEE division
// (__fdiv_rn) there and here, and rounding is half to even (__float2int_rn,
// as jnp.round and torch.round).  The row max propagates NaN as jnp.max does, so
// a row holding a NaN gets scale 1.0 (amax > 0 is false) and a row holding an
// inf gets scale inf and all-zero values.  The build must not use
// --use_fast_math.
//
// Bound: device-memory bytes: x read once, one byte per element and four per
// row written.  At one phi4-mini MLP gradient leaf (3072 x 8192 f32) that is
// 125,841,408 bytes, 38 us at 3.35 TB/s.
//
// Design: as kernel 4 (rmsnorm_relayout.cu).  A group of TPR threads owns a
// row and keeps it in registers as 16-byte packs; one pass takes the row's
// amax, a group max gives the scale, a second pass over the registers
// quantises and stores V int8 values (4 or 8 bytes) into a tile row.
#include "xdma_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int CACHE = 8;

struct QuantArgs {
  int64_t rows;      // rows quantised: (m / tm) * tm
  int64_t cols;      // n, a multiple of tn
  int64_t tm, tn;
  int64_t dtype;     // x's dtype code
};

template <typename T, int V>
__device__ __forceinline__ float pack_amax(const xdma::Pack<T, V>& p,
                                           float amax) {
#pragma unroll
  for (int e = 0; e < V; ++e) amax = xdma::max_nan(amax, fabsf(xdma::to_f32<T>(p.v[e])));
  return amax;
}

template <typename T, int V>
__device__ __forceinline__ void quant_store(const xdma::Pack<T, V>& p,
                                            int64_t vi, float scale,
                                            const QuantArgs& a, int8_t* orow) {
  const int64_t j = vi * V;
  xdma::Pack<int8_t, V> o;
#pragma unroll
  for (int e = 0; e < V; ++e) {
    // round half to even into int32 (cvt.rni: NaN -> 0, as the reference's
    // conversion of a NaN quotient; +-inf saturate), then clip to +-127
    const int q = __float2int_rn(__fdiv_rn(xdma::to_f32<T>(p.v[e]), scale));
    o.v[e] = (int8_t)min(max(q, -127), 127);
  }
  int64_t jt, jr;
  xdma::divmod(j, a.tn, jt, jr);
  *reinterpret_cast<xdma::Pack<int8_t, V>*>(orow + jt * a.tm * a.tn + jr) = o;
}

template <typename T, int V, int TPR>
__global__ void __launch_bounds__(THREADS)
quantize_tiled_kernel(const T* __restrict__ x, int8_t* __restrict__ values,
                      float* __restrict__ scales, QuantArgs a) {
  using P = xdma::Pack<T, V>;
  __shared__ float scratch[THREADS / 32];
  const int t = threadIdx.x % TPR;
  const int64_t row = (int64_t)blockIdx.x * (THREADS / TPR) + threadIdx.x / TPR;
  const bool live = row < a.rows;
  const int64_t nvec = a.cols / V;
  const P* src = reinterpret_cast<const P*>(x + (live ? row : 0) * a.cols);

  P cache[CACHE];
  float amax = 0.f;
#pragma unroll
  for (int k = 0; k < CACHE; ++k) {
    const int64_t vi = t + (int64_t)TPR * k;
    if (live && vi < nvec) {
      cache[k] = src[vi];
      amax = pack_amax<T, V>(cache[k], amax);
    }
  }
  for (int64_t vi = t + (int64_t)TPR * CACHE; live && vi < nvec; vi += TPR)
    amax = pack_amax<T, V>(src[vi], amax);
  amax = xdma::group_reduce<TPR>(amax, scratch, xdma::MaxOp());
  if (!live) return;

  const float scale = amax > 0.f ? __fmul_rn(amax, 1.f / 127.f) : 1.f;
  if (t == 0) scales[row] = scale;
  int64_t rt, rr;
  xdma::divmod(row, a.tm, rt, rr);
  int8_t* orow = values + rt * a.cols * a.tm + rr * a.tn;
#pragma unroll
  for (int k = 0; k < CACHE; ++k) {
    const int64_t vi = t + (int64_t)TPR * k;
    if (vi < nvec) quant_store<T, V>(cache[k], vi, scale, a, orow);
  }
  for (int64_t vi = t + (int64_t)TPR * CACHE; vi < nvec; vi += TPR)
    quant_store<T, V>(src[vi], vi, scale, a, orow);
}

template <typename T, int V, int TPR>
int launch(const QuantArgs& a, const void* x, void* values, void* scales,
           cudaStream_t stream) {
  constexpr int64_t rows_per_block = THREADS / TPR;
  const int64_t blocks = (a.rows + rows_per_block - 1) / rows_per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  quantize_tiled_kernel<T, V, TPR><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<int8_t*>(values),
      static_cast<float*>(scales), a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const QuantArgs& a, const void* x, void* values, void* scales,
             cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const bool packed = a.cols % V == 0 && a.tn % V == 0 &&
                      (uintptr_t)x % 16 == 0 && (uintptr_t)values % 16 == 0;
  if (!packed) return launch<T, 1, 256>(a, x, values, scales, s);
  const int64_t nvec = a.cols / V;
  if (nvec <= 32 * CACHE) return launch<T, V, 32>(a, x, values, scales, s);
  if (nvec <= 64 * CACHE) return launch<T, V, 64>(a, x, values, scales, s);
  if (nvec <= 128 * CACHE) return launch<T, V, 128>(a, x, values, scales, s);
  return launch<T, V, 256>(a, x, values, scales, s);
}

}  // namespace

extern "C" int xdma_quantize_tiled(const void* args, const void* x,
                                   void* values, void* scales, void* stream) {
  const QuantArgs& a = *static_cast<const QuantArgs*>(args);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.tm <= 0 || a.tn <= 0 || a.cols % a.tn) return (int)cudaErrorInvalidValue;
  if (a.rows == 0 || a.cols == 0) return 0;
  switch (a.dtype) {
    case xdma::F32: return dispatch<float>(a, x, values, scales, s);
    case xdma::BF16: return dispatch<__nv_bfloat16>(a, x, values, scales, s);
    case xdma::F16: return dispatch<__half>(a, x, values, scales, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
