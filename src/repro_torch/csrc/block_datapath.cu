// Kernel 3: the block plugin datapath.
//
// Replaces the reference's TPU kernel src/repro/core/plugin_compiler.py:182,
// _compile_block (:169): reader -> any emit-capable plugin chain -> writer,
// the whole array in one grid step.  On top of the streaming plugins it runs
// Transpose, GatherScatter (a take along any axis), Compress (values plus a
// raw bool mask, one flag per block_rows rows), Decompress and ReduceStage
// (sum or max over the rows), for logical rank 2 to 4.
//
// Bound: device-memory bytes.  Index stages and value stages are a few
// operations per element; each input element is read once (a Compress or
// RMSNorm adds one read pass for its mask or row statistics), each output
// element written once.
//
// Design: the TPU stages the whole array in VMEM in one step; here the work
// is spread over many blocks with nothing staged.  The host compiles the
// chain into stages: index stages (the reader's map, Transpose, the gather
// indices) and value stages (cast, scale, bias, RMSNorm, Decompress).  The
// output pass gives each thread one element of the destination buffer in
// physical order (coalesced writes, zeros into stride padding): it maps the
// physical index back to a logical coordinate, walks it back through the
// index stages to a source offset, loads, and applies the value stages
// forward, rounding to the stream dtype after each.  A ReduceStage becomes
// a loop over the reduced rows: a 32 x 32 block gives each output column 32
// threads that sum (or max) interleaved rows in f32, then combines the 32
// partials in a fixed order, so the result is deterministic.  A value that
// exists only after a reduction over the data takes a pass of its own
// before the output pass: one block per row for an RMSNorm's inverse RMS,
// one block per row block for a Compress mask (any nonzero).  The host
// splits a chain with more than one ReduceStage into launches joined by a
// row-major intermediate buffer.
#include "xdma_common.cuh"

namespace {

constexpr int XR = 4;        // max logical rank
constexpr int XS = 8;        // max stages per launch
constexpr int XP = 2 * XR;   // max physical dims
constexpr int THREADS = 256;

enum StageCode : int64_t {
  ST_CAST = 1, ST_SCALE = 2, ST_BIAS = 3, ST_RMSNORM = 4, ST_TRANSPOSE = 5,
  ST_GATHER = 6, ST_COMPRESS = 7, ST_DECOMPRESS = 8, ST_REDUCE_SUM = 9,
  ST_REDUCE_MAX = 10
};

struct Stage {
  int64_t code;
  int64_t dtype;        // stream dtype after the stage
  int64_t axis;         // GATHER: axis, in the stage's input coordinates
  int64_t keepdims;     // REDUCE
  int64_t block_rows;   // COMPRESS / DECOMPRESS
  double a;             // SCALE / BIAS constant, RMSNORM eps
  int64_t vec;          // f32 vector over the last axis (SCALE/BIAS/RMSNORM weight) or 0
  int64_t aux;          // GATHER: int64 indices; RMSNORM: f32 inverse RMS per row;
                        // COMPRESS / DECOMPRESS: uint8 mask
  int64_t in_rank;
  int64_t in_shape[XR]; // logical shape entering the stage
};

struct BlockArgs {
  int64_t nstages;
  Stage st[XS];
  int64_t in_dtype;
  int64_t src_rank;
  xdma::DimMap src[XR];   // stage-0 logical coordinate -> src physical offset
  int64_t upto;           // the pass evaluates stages [0, upto)
  int64_t out_rank;       // logical rank after `upto` stages
  int64_t out_shape[XR];
  int64_t out_dtype;
  int64_t nphys;          // OUT pass: physical dims of the dst, post-perm
  int64_t pext[XP];       //   their extents
  int64_t pdim[XP];       //   the logical dim each one indexes
  int64_t pw[XP];         //   its weight in that logical coordinate
  int64_t total;          // OUT: dst elements; STAT: rows; MASK: mask entries
  int64_t reduce_at;      // index of the one ReduceStage in [0, upto), or -1
};

__device__ __forceinline__ float load_any(const void* p, int64_t i,
                                          int64_t dt) {
  if (dt == xdma::BF16)
    return xdma::to_f32(static_cast<const __nv_bfloat16*>(p)[i]);
  if (dt == xdma::F16) return xdma::to_f32(static_cast<const __half*>(p)[i]);
  return static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store_any(void* p, int64_t i, int64_t dt,
                                          float v) {
  if (dt == xdma::BF16)
    static_cast<__nv_bfloat16*>(p)[i] = xdma::from_f32<__nv_bfloat16>(v);
  else if (dt == xdma::F16)
    static_cast<__half*>(p)[i] = xdma::from_f32<__half>(v);
  else
    static_cast<float*>(p)[i] = v;
}

__device__ __forceinline__ bool is_reduce(int64_t code) {
  return code == ST_REDUCE_SUM || code == ST_REDUCE_MAX;
}

// Row-major linear index of coordinate c over the first `n` dims of `shape`.
__device__ __forceinline__ int64_t linear(const int64_t* c,
                                          const int64_t* shape, int n) {
  int64_t idx = 0;
  for (int d = 0; d < n; ++d) idx = idx * shape[d] + c[d];
  return idx;
}

// Walk a coordinate back from the output of stage `hi - 1` to the input of
// stage `lo`.  co[s] receives the input coordinate of stage s.  Returns the
// index of a gather stage whose index was out of range (its output is the
// NaN fill), or -1.
__device__ __forceinline__ int walk_back(const BlockArgs& a, int lo, int hi,
                                         int64_t (*co)[XR]) {
  for (int s = hi - 1; s >= lo; --s) {
    const Stage& st = a.st[s];
    const int r = (int)st.in_rank;
    for (int d = 0; d < r; ++d) co[s][d] = co[s + 1][d];
    if (st.code == ST_TRANSPOSE) {
      co[s][r - 2] = co[s + 1][r - 1];
      co[s][r - 1] = co[s + 1][r - 2];
    } else if (st.code == ST_GATHER) {
      const int64_t j = reinterpret_cast<const int64_t*>(st.aux)
          [co[s + 1][st.axis]];
      if (j < 0) return s;
      co[s][st.axis] = j;
    }
  }
  return -1;
}

// Apply value stage s to v, whose logical coordinate (stage s input) is c.
__device__ __forceinline__ float apply(const Stage& st, float v,
                                       const int64_t* c) {
  const int r = (int)st.in_rank;
  const float* vec = reinterpret_cast<const float*>(st.vec);
  switch (st.code) {
    case ST_CAST:
      return xdma::round_to(v, st.dtype);
    case ST_SCALE:
      return xdma::round_to(v * (vec ? vec[c[r - 1]] : (float)st.a), st.dtype);
    case ST_BIAS:
      return xdma::round_to(v + (vec ? vec[c[r - 1]] : (float)st.a), st.dtype);
    case ST_RMSNORM: {
      const float inv =
          reinterpret_cast<const float*>(st.aux)[linear(c, st.in_shape, r - 1)];
      float y = v * inv;
      if (vec) y = y * vec[c[r - 1]];
      return xdma::round_to(y, st.dtype);
    }
    case ST_DECOMPRESS: {
      const int64_t nb = st.in_shape[r - 2] / st.block_rows;
      const int64_t m = linear(c, st.in_shape, r - 2) * nb +
                        c[r - 2] / st.block_rows;
      const bool keep = reinterpret_cast<const uint8_t*>(st.aux)[m] != 0;
      return xdma::round_to(v * (keep ? 1.f : 0.f), st.dtype);
    }
    default:  // TRANSPOSE, GATHER, COMPRESS: values pass unchanged
      return v;
  }
}

// Value after stages [0, k) at the coordinate already in co[k]; there is no
// ReduceStage in [0, k).
__device__ __forceinline__ float eval_plain(const BlockArgs& a,
                                            const void* src, int k,
                                            int64_t (*co)[XR]) {
  const int fill = walk_back(a, 0, k, co);
  float v;
  int start;
  if (fill >= 0) {
    v = __int_as_float(0x7fc00000);   // jnp.take's NaN fill
    start = fill + 1;
  } else {
    int64_t off = 0;
    for (int d = 0; d < a.src_rank; ++d)
      off += xdma::dim_offset(a.src[d], co[0][d]);
    v = load_any(src, off, a.in_dtype);
    start = 0;
  }
  for (int s = start; s < k; ++s) v = apply(a.st[s], v, co[s]);
  return v;
}

__device__ __forceinline__ float reduce_init(int64_t code) {
  return code == ST_REDUCE_SUM ? 0.f : -__int_as_float(0x7f800000);
}

__device__ __forceinline__ float reduce_op(int64_t code, float acc, float v) {
  if (code == ST_REDUCE_SUM) return acc + v;
  return (acc != acc || (v <= acc)) ? acc : v;   // max, NaN propagates
}

// Input coordinate of ReduceStage st for row r, from its output coordinate.
__device__ __forceinline__ void reduce_input(const Stage& st,
                                             const int64_t* out, int64_t r,
                                             int64_t* in) {
  const int n = (int)st.in_rank;
  if (st.keepdims) {
    for (int d = 0; d < n; ++d) in[d] = out[d];
  } else {
    for (int d = 0; d < n - 2; ++d) in[d] = out[d];
    in[n - 1] = out[n - 2];
  }
  in[n - 2] = r;
}

// Value after stages [0, k) at the coordinate in co[k], a ReduceStage
// included (one thread loops over all of its rows).
__device__ float eval(const BlockArgs& a, const void* src, int k,
                      int64_t (*co)[XR]) {
  const int R = (int)a.reduce_at;
  if (R < 0 || R >= k) return eval_plain(a, src, k, co);
  const int fill = walk_back(a, R + 1, k, co);
  float v;
  int start;
  if (fill >= 0) {
    v = __int_as_float(0x7fc00000);
    start = fill + 1;
  } else {
    const Stage& st = a.st[R];
    int64_t inner[XS + 1][XR];
    float acc = reduce_init(st.code);
    for (int64_t r = 0; r < st.in_shape[st.in_rank - 2]; ++r) {
      reduce_input(st, co[R + 1], r, inner[R]);
      acc = reduce_op(st.code, acc, eval_plain(a, src, R, inner));
    }
    v = xdma::round_to(acc, st.dtype);
    start = R + 1;
  }
  for (int s = start; s < k; ++s) v = apply(a.st[s], v, co[s]);
  return v;
}

// Physical index p of the dst -> its padded logical coordinate; returns
// false when the coordinate falls in stride padding.
__device__ __forceinline__ bool phys_to_logical(const BlockArgs& a, int64_t p,
                                                int64_t* c) {
  for (int d = 0; d < a.out_rank; ++d) c[d] = 0;
  for (int k = (int)a.nphys - 1; k >= 0; --k) {
    int64_t q, r;
    xdma::divmod(p, a.pext[k], q, r);
    c[a.pdim[k]] += r * a.pw[k];
    p = q;
  }
  for (int d = 0; d < a.out_rank; ++d)
    if (c[d] >= a.out_shape[d]) return false;
  return true;
}

// Output pass without a ReduceStage: one thread per dst element.
__global__ void __launch_bounds__(THREADS)
out_kernel(const void* __restrict__ src, void* __restrict__ dst,
           BlockArgs a) {
  int64_t co[XS + 1][XR];
  const int k = (int)a.upto;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       p < a.total; p += step) {
    float v = 0.f;
    if (phys_to_logical(a, p, co[k])) v = eval_plain(a, src, k, co);
    store_any(dst, p, a.out_dtype, v);
  }
}

constexpr int RX = 32, RY = 32;   // reduce block: 32 outputs x 32 row lanes

// Output pass with a ReduceStage at a.reduce_at: 32 threads per output.
__global__ void __launch_bounds__(RX * RY)
out_reduce_kernel(const void* __restrict__ src, void* __restrict__ dst,
                  BlockArgs a) {
  __shared__ float part[RY][RX + 1];
  int64_t co[XS + 1][XR];
  const int k = (int)a.upto, R = (int)a.reduce_at;
  const Stage& st = a.st[R];
  const int64_t rows = st.in_shape[st.in_rank - 2];
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int64_t base = (int64_t)blockIdx.x * RX; base < a.total;
       base += (int64_t)gridDim.x * RX) {
    const int64_t p = base + tx;
    const bool live = p < a.total && phys_to_logical(a, p, co[k]);
    const int fill = live ? walk_back(a, R + 1, k, co) : -1;
    float acc = reduce_init(st.code);
    if (live && fill < 0) {
      int64_t inner[XS + 1][XR];
      for (int64_t r = ty; r < rows; r += RY) {
        reduce_input(st, co[R + 1], r, inner[R]);
        acc = reduce_op(st.code, acc, eval_plain(a, src, R, inner));
      }
    }
    part[ty][tx] = acc;
    __syncthreads();
    if (ty == 0 && p < a.total) {
      float v = 0.f;
      if (live) {
        int start = fill + 1;
        if (fill < 0) {
          float tot = part[0][tx];
          for (int y = 1; y < RY; ++y) tot = reduce_op(st.code, tot, part[y][tx]);
          v = xdma::round_to(tot, st.dtype);
          start = R + 1;
        } else {
          v = __int_as_float(0x7fc00000);
        }
        for (int s = start; s < k; ++s) v = apply(a.st[s], v, co[s]);
      }
      store_any(dst, p, a.out_dtype, v);
    }
    __syncthreads();
  }
}

// RMSNorm statistics of stage a.upto: one block per row of its input space.
__global__ void __launch_bounds__(THREADS)
stat_kernel(const void* __restrict__ src, BlockArgs a) {
  __shared__ float scratch[33];
  int64_t co[XS + 1][XR];
  const int k = (int)a.upto;
  const Stage& st = a.st[k];
  const int r = (int)st.in_rank;
  const int64_t n = st.in_shape[r - 1];
  for (int64_t row = blockIdx.x; row < a.total; row += gridDim.x) {
    float ss = 0.f;
    for (int64_t j = threadIdx.x; j < n; j += blockDim.x) {
      int64_t rem = row;
      for (int d = r - 2; d >= 0; --d) {
        co[k][d] = rem % st.in_shape[d];
        rem /= st.in_shape[d];
      }
      co[k][r - 1] = j;
      const float v = eval(a, src, k, co);
      ss += v * v;
    }
    ss = xdma::block_sum(ss, scratch);
    if (threadIdx.x == 0)
      reinterpret_cast<float*>(st.aux)[row] =
          rsqrtf(ss / (float)n + (float)st.a);
  }
}

// Compress mask of stage a.upto: one block per (lead, row block) entry.
__global__ void __launch_bounds__(THREADS)
mask_kernel(const void* __restrict__ src, BlockArgs a) {
  int64_t co[XS + 1][XR];
  const int k = (int)a.upto;
  const Stage& st = a.st[k];
  const int r = (int)st.in_rank;
  const int64_t n = st.in_shape[r - 1];
  const int64_t nb = st.in_shape[r - 2] / st.block_rows;
  const int64_t span = st.block_rows * n;
  for (int64_t e = blockIdx.x; e < a.total; e += gridDim.x) {
    const int64_t lead = e / nb, blk = e % nb;
    int any = 0;
    for (int64_t t = threadIdx.x; t < span && !any; t += blockDim.x) {
      int64_t rem = lead;
      for (int d = r - 3; d >= 0; --d) {
        co[k][d] = rem % st.in_shape[d];
        rem /= st.in_shape[d];
      }
      co[k][r - 2] = blk * st.block_rows + t / n;
      co[k][r - 1] = t % n;
      any = eval(a, src, k, co) != 0.f;
    }
    any = __syncthreads_or(any);
    if (threadIdx.x == 0) reinterpret_cast<uint8_t*>(st.aux)[e] = any ? 1 : 0;
  }
}

unsigned grid_for(int64_t work, int64_t per_block) {
  int64_t b = (work + per_block - 1) / per_block;
  if (b < 1) b = 1;
  if (b > (1LL << 20)) b = 1LL << 20;   // the kernels stride over the rest
  return (unsigned)b;
}

}  // namespace

// mode 0: output pass into dst; 1: RMSNorm statistics; 2: Compress mask.
extern "C" int xdma_block_datapath(const void* args, const void* src,
                                   void* dst, int64_t mode, void* stream) {
  const BlockArgs& a = *static_cast<const BlockArgs*>(args);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.nstages > XS || a.out_rank > XR || a.nphys > XP)
    return (int)cudaErrorInvalidValue;
  if (a.total == 0) return 0;
  if (mode == 0 && a.reduce_at < 0) {
    out_kernel<<<grid_for(a.total, THREADS), THREADS, 0, s>>>(src, dst, a);
  } else if (mode == 0) {
    out_reduce_kernel<<<grid_for(a.total, RX), dim3(RX, RY), 0, s>>>(
        src, dst, a);
  } else if (mode == 1) {
    stat_kernel<<<grid_for(a.total, 1), THREADS, 0, s>>>(src, a);
  } else if (mode == 2) {
    mask_kernel<<<grid_for(a.total, 1), THREADS, 0, s>>>(src, a);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
