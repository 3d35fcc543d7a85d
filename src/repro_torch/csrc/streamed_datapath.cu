// Kernel 2: the streamed plugin datapath.
//
// Replaces the reference's TPU kernel src/repro/core/plugin_compiler.py:236,
// _compile_streamed (:209): a row-burst fused pass, reader to_logical ->
// chain of streaming plugins (Identity, Cast, Scale, BiasAdd, RMSNormPlugin
// with an optional weight) -> writer from_logical.
//
// Bound: device-memory bytes.  One read and one write per element, plus the
// weight vector; the arithmetic is a few operations per element.  At the
// Prefill store (8192 x 3072 bf16) that is 96 MiB, about 30 us at 3.35 TB/s.
//
// Design: one binary serves every chain.  The host compiles the chain into a
// short op list (cast to f32/bf16/f16, scale, bias, rmsnorm) with its
// constants already rounded to the stream dtype, as jnp's rules require, so
// nothing is compiled per chain at run time.  One block owns one logical
// row: it loads the row through the src layout's map into shared memory as
// f32, applies the ops in order (rounding to the stream dtype after each, to
// nearest even), takes one deterministic block reduction per RMSNorm, and
// stores the row through the dst layout's map, writing zeros into the dst
// row's stride padding.  Loads and stores walk the row with consecutive
// threads on consecutive columns, which is contiguous for row-major and
// tiled layouts.
#include "xdma_common.cuh"

namespace {

constexpr int MAX_OPS = 8;
constexpr int THREADS = 256;

enum OpCode : int64_t { OP_CAST = 1, OP_SCALE = 2, OP_BIAS = 3, OP_RMSNORM = 4 };

struct Op {
  int64_t code;
  int64_t dtype;   // stream dtype after the op
  double a;        // scalar constant (scale, bias) or eps (rmsnorm)
  int64_t vec;     // device address of an f32 vector over the columns, or 0
};

struct StreamArgs {
  int64_t rows, cols;   // logical extent
  int64_t pcols;        // dst columns including stride padding
  int64_t in_dtype, out_dtype;
  int64_t nops;
  Op ops[MAX_OPS];
  xdma::DimMap src[2];
  xdma::DimMap dst[2];
};

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(THREADS)
streamed_kernel(const Tin* __restrict__ src, Tout* __restrict__ dst,
                StreamArgs a) {
  extern __shared__ float row[];
  __shared__ float scratch[33];
  const int64_t i = blockIdx.x;
  const int64_t srow = xdma::dim_offset(a.src[0], i);
  const int64_t drow = xdma::dim_offset(a.dst[0], i);

  for (int64_t j = threadIdx.x; j < a.cols; j += blockDim.x)
    row[j] = xdma::to_f32<Tin>(src[srow + xdma::dim_offset(a.src[1], j)]);

  for (int k = 0; k < a.nops; ++k) {
    const Op op = a.ops[k];
    const float* vec = reinterpret_cast<const float*>(op.vec);
    if (op.code == OP_RMSNORM) {
      float ss = 0.f;
      for (int64_t j = threadIdx.x; j < a.cols; j += blockDim.x)
        ss += row[j] * row[j];
      ss = xdma::block_sum(ss, scratch);
      const float inv = rsqrtf(ss / (float)a.cols + (float)op.a);
      for (int64_t j = threadIdx.x; j < a.cols; j += blockDim.x) {
        float y = row[j] * inv;
        if (vec) y = y * vec[j];
        row[j] = xdma::round_to(y, op.dtype);
      }
    } else {
      for (int64_t j = threadIdx.x; j < a.cols; j += blockDim.x) {
        float v = row[j];
        const float c = vec ? vec[j] : (float)op.a;
        if (op.code == OP_SCALE) v = v * c;
        else if (op.code == OP_BIAS) v = v + c;
        row[j] = xdma::round_to(v, op.dtype);
      }
    }
  }

  for (int64_t j = threadIdx.x; j < a.pcols; j += blockDim.x) {
    const float v = j < a.cols ? row[j] : 0.f;
    dst[drow + xdma::dim_offset(a.dst[1], j)] = xdma::from_f32<Tout>(v);
  }
}

template <typename Tin, typename Tout>
int launch(const StreamArgs& a, const void* src, void* dst,
           cudaStream_t stream) {
  if (a.rows == 0) return 0;
  const size_t smem = (size_t)a.cols * sizeof(float);
  auto kern = streamed_kernel<Tin, Tout>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (a.rows > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  kern<<<(unsigned)a.rows, THREADS, smem, stream>>>(
      static_cast<const Tin*>(src), static_cast<Tout*>(dst), a);
  return (int)cudaGetLastError();
}

template <typename Tin>
int dispatch_out(const StreamArgs& a, const void* src, void* dst,
                 cudaStream_t s) {
  switch (a.out_dtype) {
    case xdma::F32: return launch<Tin, float>(a, src, dst, s);
    case xdma::BF16: return launch<Tin, __nv_bfloat16>(a, src, dst, s);
    case xdma::F16: return launch<Tin, __half>(a, src, dst, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int xdma_streamed_datapath(const void* args, const void* src,
                                      void* dst, void* stream) {
  const StreamArgs& a = *static_cast<const StreamArgs*>(args);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.nops > MAX_OPS) return (int)cudaErrorInvalidValue;
  switch (a.in_dtype) {
    case xdma::F32: return dispatch_out<float>(a, src, dst, s);
    case xdma::BF16: return dispatch_out<__nv_bfloat16>(a, src, dst, s);
    case xdma::F16: return dispatch_out<__half>(a, src, dst, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
