// Kernel 3: the block plugin datapath.
//
// Replaces the reference's TPU kernel src/repro/core/plugin_compiler.py:182,
// _compile_block (:169): reader -> any emit-capable plugin chain -> writer,
// the whole array in one grid step.  On top of the streaming plugins it runs
// Transpose, GatherScatter (a take along any axis), Compress (values plus a
// raw bool mask, one flag per block_rows rows), Decompress and ReduceStage
// (sum or max over the rows), for logical rank 2 to 8, on float streams
// (f32, bf16, f16) and integer streams (int8, uint8, int16, int32, int64).
//
// Bound: device-memory bytes.  Index stages and value stages are a few
// operations per element; each input element is read once (a Compress or
// RMSNorm adds one read pass for its mask or row statistics), each output
// element written once.
//
// Design: the TPU stages the whole array in VMEM in one step; here the work
// is spread over many blocks.  The host compiles the chain into stages:
// index stages (the reader's map, Transpose, the gather indices) and value
// stages (cast, scale, bias, RMSNorm, Decompress), and picks one of two
// paths per launch from the compiled chain, before launch.
//
// The rank-2 path (see its section below) takes the chains whose index
// stages compose into one map per axis: a tiled copy with the layout maps
// hoisted out of the element loop and 16-byte accesses (xdma::tile2_run,
// shared with kernel 1), and row passes that read along the rows.
//
// The generic path takes the rest (logical ranks 3-8, a cast between
// dtypes, a gather after a stage that reads its coordinate, stages after a
// ReduceStage, an integer stream that does more than move words).  Its
// values travel as f32 on a float stream and as int64 on an integer one.  Its output pass gives each thread one element of the
// destination buffer in physical order (coalesced writes, zeros into stride
// padding): it maps the physical index back to a logical coordinate, walks
// it back through the index stages to a source offset, loads, and applies
// the value stages forward, rounding to the stream dtype after each.  A
// ReduceStage becomes a loop over the reduced rows: a 32 x 32 block gives
// each output column 32 threads that sum (or max) interleaved rows in f32,
// then combines the 32 partials in a fixed order, so the result is
// deterministic.
//
// On both paths a value that exists only after a reduction over the data
// takes a pass of its own before the output pass: an RMSNorm's inverse RMS
// per row, a Compress mask per row block (any nonzero).  The host splits a
// chain with more than one ReduceStage into launches joined by a row-major
// intermediate buffer.
#include "xdma_common.cuh"

namespace {

constexpr int XR = 8;        // max logical rank
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
  int64_t vec;          // vector over the last axis or 0: SCALE / BIAS in the
                        // carrier's type (f32 or int64), the RMSNORM weight f32
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
  int64_t carrier;        // 0: values travel as f32; 1: as int64 words
};

// -- the carriers: f32 for float streams, int64 for integer streams ---------
// The host cuts a chain where the stream changes between float and integer,
// so one launch has one carrier; a Cast that crosses is the first stage of
// its launch and converts on load (an integer to the nearest float, a float
// toward zero).  Integer results wrap to the stream dtype's width, as XLA's
// integer arithmetic does.
__device__ __forceinline__ long long wrap_to(long long v, int64_t dt) {
  switch (dt) {
    case xdma::I8: return (signed char)v;
    case xdma::U8: return (unsigned char)v;
    case xdma::I16: return (short)v;
    case xdma::I32: return (int)v;
    default: return v;
  }
}

template <typename C> __device__ __forceinline__ C of_float(float v);
template <> __device__ __forceinline__ float of_float<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ long long of_float<long long>(float v) {
  return __float2ll_rz(v);
}
template <typename C> __device__ __forceinline__ C of_int(long long v);
template <> __device__ __forceinline__ float of_int<float>(long long v) {
  return __ll2float_rn(v);
}
template <> __device__ __forceinline__ long long of_int<long long>(long long v) {
  return v;
}
__device__ __forceinline__ float as_float(float v) { return v; }
__device__ __forceinline__ float as_float(long long v) {
  return __ll2float_rn(v);
}
__device__ __forceinline__ long long as_int(float v) { return __float2ll_rz(v); }
__device__ __forceinline__ long long as_int(long long v) { return v; }

// Round to the stream dtype: to nearest even for a float, wrap an integer.
__device__ __forceinline__ float round_c(float v, int64_t dt) {
  return xdma::round_to(v, dt);
}
__device__ __forceinline__ long long round_c(long long v, int64_t dt) {
  return wrap_to(v, dt);
}
__device__ __forceinline__ float mul_c(float a, float b) { return a * b; }
__device__ __forceinline__ long long mul_c(long long a, long long b) {
  return (long long)((unsigned long long)a * (unsigned long long)b);
}
__device__ __forceinline__ float add_c(float a, float b) { return a + b; }
__device__ __forceinline__ long long add_c(long long a, long long b) {
  return (long long)((unsigned long long)a + (unsigned long long)b);
}

// jnp.take's fill for an index out of range: NaN, or the integer dtype's
// minimum (signed) or maximum (unsigned).
template <typename C> __device__ __forceinline__ C fill_of(int64_t dt);
template <> __device__ __forceinline__ float fill_of<float>(int64_t) {
  return __int_as_float(0x7fc00000);
}
template <> __device__ __forceinline__ long long fill_of<long long>(int64_t dt) {
  switch (dt) {
    case xdma::I8: return -128;
    case xdma::U8: return 255;
    case xdma::I16: return -32768;
    case xdma::I32: return -2147483647LL - 1;
    default: return (long long)0x8000000000000000ULL;
  }
}

template <typename C>
__device__ __forceinline__ C load_any(const void* p, int64_t i, int64_t dt) {
  switch (dt) {
    case xdma::BF16:
      return of_float<C>(xdma::to_f32(static_cast<const __nv_bfloat16*>(p)[i]));
    case xdma::F16:
      return of_float<C>(xdma::to_f32(static_cast<const __half*>(p)[i]));
    case xdma::F32: return of_float<C>(static_cast<const float*>(p)[i]);
    case xdma::I8: return of_int<C>(static_cast<const signed char*>(p)[i]);
    case xdma::U8: return of_int<C>(static_cast<const unsigned char*>(p)[i]);
    case xdma::I16: return of_int<C>(static_cast<const short*>(p)[i]);
    case xdma::I32: return of_int<C>(static_cast<const int*>(p)[i]);
    default: return of_int<C>(static_cast<const long long*>(p)[i]);
  }
}

template <typename C>
__device__ __forceinline__ void store_any(void* p, int64_t i, int64_t dt,
                                          C v) {
  switch (dt) {
    case xdma::BF16:
      static_cast<__nv_bfloat16*>(p)[i] =
          xdma::from_f32<__nv_bfloat16>(as_float(v));
      break;
    case xdma::F16:
      static_cast<__half*>(p)[i] = xdma::from_f32<__half>(as_float(v));
      break;
    case xdma::F32: static_cast<float*>(p)[i] = as_float(v); break;
    case xdma::I8: static_cast<signed char*>(p)[i] = (signed char)as_int(v); break;
    case xdma::U8:
      static_cast<unsigned char*>(p)[i] = (unsigned char)as_int(v);
      break;
    case xdma::I16: static_cast<short*>(p)[i] = (short)as_int(v); break;
    case xdma::I32: static_cast<int*>(p)[i] = (int)as_int(v); break;
    default: static_cast<long long*>(p)[i] = as_int(v); break;
  }
}

// A SCALE / BIAS constant in the carrier's type, at last-axis index j.
__device__ __forceinline__ float konst(const Stage& st, int64_t j, float*) {
  return st.vec ? reinterpret_cast<const float*>(st.vec)[j] : (float)st.a;
}
__device__ __forceinline__ long long konst(const Stage& st, int64_t j,
                                           long long*) {
  return st.vec ? reinterpret_cast<const long long*>(st.vec)[j]
                : (long long)st.a;
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
// fill), or -1.
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
template <typename C>
__device__ __forceinline__ C apply(const Stage& st, C v, const int64_t* c) {
  const int r = (int)st.in_rank;
  switch (st.code) {
    case ST_CAST:
      return round_c(v, st.dtype);
    case ST_SCALE:
      return round_c(mul_c(v, konst(st, c[r - 1], (C*)nullptr)), st.dtype);
    case ST_BIAS:
      return round_c(add_c(v, konst(st, c[r - 1], (C*)nullptr)), st.dtype);
    case ST_RMSNORM: {   // in f32, then back to the stream dtype
      const float* vec = reinterpret_cast<const float*>(st.vec);
      const float inv =
          reinterpret_cast<const float*>(st.aux)[linear(c, st.in_shape, r - 1)];
      float y = as_float(v) * inv;
      if (vec) y = y * vec[c[r - 1]];
      return round_c(of_float<C>(y), st.dtype);
    }
    case ST_DECOMPRESS: {
      const int64_t nb = st.in_shape[r - 2] / st.block_rows;
      const int64_t m = linear(c, st.in_shape, r - 2) * nb +
                        c[r - 2] / st.block_rows;
      const bool keep = reinterpret_cast<const uint8_t*>(st.aux)[m] != 0;
      return round_c(mul_c(v, (C)(keep ? 1 : 0)), st.dtype);
    }
    default:  // TRANSPOSE, GATHER, COMPRESS: values pass unchanged
      return v;
  }
}

// Value after stages [0, k) at the coordinate already in co[k]; there is no
// ReduceStage in [0, k).
template <typename C>
__device__ __forceinline__ C eval_plain(const BlockArgs& a, const void* src,
                                        int k, int64_t (*co)[XR]) {
  const int fill = walk_back(a, 0, k, co);
  C v;
  int start;
  if (fill >= 0) {
    v = fill_of<C>(a.st[fill].dtype);   // jnp.take's fill
    start = fill + 1;
  } else {
    int64_t off = 0;
    for (int d = 0; d < a.src_rank; ++d)
      off += xdma::dim_offset(a.src[d], co[0][d]);
    v = load_any<C>(src, off, a.in_dtype);
    start = 0;
  }
  for (int s = start; s < k; ++s) v = apply<C>(a.st[s], v, co[s]);
  return v;
}

template <typename C> __device__ __forceinline__ C reduce_init(int64_t code);
template <> __device__ __forceinline__ float reduce_init<float>(int64_t code) {
  return code == ST_REDUCE_SUM ? 0.f : -__int_as_float(0x7f800000);
}
template <>
__device__ __forceinline__ long long reduce_init<long long>(int64_t code) {
  return code == ST_REDUCE_SUM ? 0LL : (long long)0x8000000000000000ULL;
}

__device__ __forceinline__ float reduce_op(int64_t code, float acc, float v) {
  if (code == ST_REDUCE_SUM) return acc + v;
  return (acc != acc || (v <= acc)) ? acc : v;   // max, NaN propagates
}
__device__ __forceinline__ long long reduce_op(int64_t code, long long acc,
                                               long long v) {
  if (code == ST_REDUCE_SUM) return add_c(acc, v);   // wraps at the end
  return v > acc ? v : acc;
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
template <typename C>
__device__ C eval(const BlockArgs& a, const void* src, int k,
                  int64_t (*co)[XR]) {
  const int R = (int)a.reduce_at;
  if (R < 0 || R >= k) return eval_plain<C>(a, src, k, co);
  const int fill = walk_back(a, R + 1, k, co);
  C v;
  int start;
  if (fill >= 0) {
    v = fill_of<C>(a.st[fill].dtype);
    start = fill + 1;
  } else {
    const Stage& st = a.st[R];
    int64_t inner[XS + 1][XR];
    C acc = reduce_init<C>(st.code);
    for (int64_t r = 0; r < st.in_shape[st.in_rank - 2]; ++r) {
      reduce_input(st, co[R + 1], r, inner[R]);
      acc = reduce_op(st.code, acc, eval_plain<C>(a, src, R, inner));
    }
    v = round_c(acc, st.dtype);
    start = R + 1;
  }
  for (int s = start; s < k; ++s) v = apply<C>(a.st[s], v, co[s]);
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
template <typename C>
__global__ void __launch_bounds__(THREADS)
out_kernel(const void* __restrict__ src, void* __restrict__ dst,
           BlockArgs a) {
  int64_t co[XS + 1][XR];
  const int k = (int)a.upto;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       p < a.total; p += step) {
    C v = 0;
    if (phys_to_logical(a, p, co[k])) v = eval_plain<C>(a, src, k, co);
    store_any<C>(dst, p, a.out_dtype, v);
  }
}

constexpr int RX = 32, RY = 32;   // reduce block: 32 outputs x 32 row lanes

// Output pass with a ReduceStage at a.reduce_at: 32 threads per output.
template <typename C>
__global__ void __launch_bounds__(RX * RY)
out_reduce_kernel(const void* __restrict__ src, void* __restrict__ dst,
                  BlockArgs a) {
  __shared__ C part[RY][RX + 1];
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
    C acc = reduce_init<C>(st.code);
    if (live && fill < 0) {
      int64_t inner[XS + 1][XR];
      for (int64_t r = ty; r < rows; r += RY) {
        reduce_input(st, co[R + 1], r, inner[R]);
        acc = reduce_op(st.code, acc, eval_plain<C>(a, src, R, inner));
      }
    }
    part[ty][tx] = acc;
    __syncthreads();
    if (ty == 0 && p < a.total) {
      C v = 0;
      if (live) {
        int start = fill + 1;
        if (fill < 0) {
          C tot = part[0][tx];
          for (int y = 1; y < RY; ++y) tot = reduce_op(st.code, tot, part[y][tx]);
          v = round_c(tot, st.dtype);
          start = R + 1;
        } else {
          v = fill_of<C>(a.st[fill].dtype);
        }
        for (int s = start; s < k; ++s) v = apply<C>(a.st[s], v, co[s]);
      }
      store_any<C>(dst, p, a.out_dtype, v);
    }
    __syncthreads();
  }
}

// RMSNorm statistics of stage a.upto: one block per row of its input space.
template <typename C>
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
      const float v = as_float(eval<C>(a, src, k, co));
      ss += v * v;
    }
    ss = xdma::block_sum(ss, scratch);
    if (threadIdx.x == 0)
      reinterpret_cast<float*>(st.aux)[row] =
          rsqrtf(ss / (float)n + (float)st.a);
  }
}

// Compress mask of stage a.upto: one block per (lead, row block) entry.
template <typename C>
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
      any = eval<C>(a, src, k, co) != (C)0;
    }
    any = __syncthreads_or(any);
    if (threadIdx.x == 0) reinterpret_cast<uint8_t*>(st.aux)[e] = any ? 1 : 0;
  }
}

// ---- the rank-2 path -------------------------------------------------------
//
// For chains the host can compose (logical rank 2, one stream dtype, index
// stages that compose into a swap and one index vector per axis, a
// ReduceStage only last): no element walks the stage list.  The host folds
// the index stages of the stages before a pass's point into the pass's
// Tile2 (xdma_common.cuh): the source terms of a pass-space row and column,
// each with its composed gather indices, whose entries < 0 are the fill
// code -(g + 1) of the gather g that failed.  Value stages then run in
// chain order, once on each item of values (a 16-byte pack, or one word),
// each reading its own coordinate: the pass's (r, c) or, under an odd
// number of later transposes, (c, r).
//   OUT    the tiled copy: words unchanged (Copy) when no stage changes a
//          value, else through f32 (Values)
//   STAT   an RMSNorm's inverse RMS: one block per row, 16-byte reads along
//          the row where they can be
//   MASK   a Compress mask: one block per row block, early out on a nonzero
//   REDUCE the ReduceStage that ends the segment: a block owns 64 columns
//          of a row split, lanes along the columns; the splits' partials
//          are combined in order by the block that finishes last

struct Stage2 {
  int64_t code;
  int64_t dtype;        // stream dtype after the stage
  int64_t swap;         // 1: the stage reads its coordinate as (c, r)
  int64_t block_rows;   // DECOMPRESS
  double a;             // SCALE / BIAS constant
  int64_t vec;          // f32 vector over the stage's last axis, or 0
  int64_t aux;          // RMSNORM: f32 inverse RMS per row; DECOMPRESS: mask
};

struct Rank2Args {
  xdma::Tile2 t;        // pass space (t.rows x t.cols) -> src; OUT: -> dst.
                        // REDUCE: t.prows x t.pcols pads its (1, n) output
  int64_t nstages;      // the stages before the pass's point
  Stage2 st[XS];
  int64_t dtype;        // the stream dtype, of input and output
  int64_t fill_bits;    // OUT with Copy: the dtype's NaN, a failed gather's
  int64_t op;           // REDUCE: ST_REDUCE_SUM / ST_REDUCE_MAX
  double eps;           // STAT
  int64_t block_rows;   // MASK
  int64_t out;          // STAT: f32 per row; MASK: uint8 per row block
  int64_t splits;       // REDUCE: row splits
  int64_t partial;      // REDUCE: f32 [splits][t.cols] (splits > 1)
  int64_t counter;      // REDUCE: int32 per column strip, zeroed
};

// Rounds an item's values to the stream dtype, to nearest even.
template <int V>
__device__ __forceinline__ void round_item(float (&v)[V], int64_t dt) {
  if (dt == xdma::BF16) {
#pragma unroll
    for (int e = 0; e < V; ++e)
      v[e] = __bfloat162float(__float2bfloat16_rn(v[e]));
  } else if (dt == xdma::F16) {
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = __half2float(__float2half_rn(v[e]));
  }
}

// Value stage st on an item of V values from pass coordinate (r, c) along
// the columns (along_c) or the rows: the stage's coordinate of value e is
// (i0 + di * e, j0 + dj * e), so its switch runs once an item.
template <int V>
__device__ __forceinline__ void apply_item(const Stage2& st, float (&v)[V],
                                           int64_t r, int64_t c,
                                           bool along_c) {
  const bool sw = st.swap != 0;
  const int64_t i0 = sw ? c : r, j0 = sw ? r : c;
  const int di = along_c == sw ? 1 : 0, dj = 1 - di;
  const float* vec = reinterpret_cast<const float*>(st.vec);
  switch (st.code) {
    case ST_CAST:
      break;
    case ST_SCALE:
    case ST_BIAS: {
      const bool mul = st.code == ST_SCALE;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float k = vec ? vec[j0 + dj * e] : (float)st.a;
        v[e] = mul ? v[e] * k : v[e] + k;
      }
      break;
    }
    case ST_RMSNORM: {
      const float* inv = reinterpret_cast<const float*>(st.aux);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        float y = v[e] * inv[i0 + di * e];
        if (vec) y = y * vec[j0 + dj * e];
        v[e] = y;
      }
      break;
    }
    case ST_DECOMPRESS: {
      const uint8_t* mask = reinterpret_cast<const uint8_t*>(st.aux);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const bool keep =
            mask[xdma::div_floor(i0 + di * e, st.block_rows)] != 0;
        v[e] = v[e] * (keep ? 1.f : 0.f);
      }
      break;
    }
    default:  // TRANSPOSE, GATHER, COMPRESS: values pass unchanged
      return;
  }
  round_item<V>(v, st.dtype);
}

// The value policy of the tiled copy and the row passes: the stages before
// the pass's point on f32 values, from the stage after a failed gather on
// its NaN fill.  The stages are read from a copy in shared memory
// (stages_to_shared).
template <typename T>
struct Values {
  using In = T;
  using S = float;
  using Out = T;
  const Stage2* st;
  int n;
  template <int V>
  __device__ __forceinline__ void values(const xdma::Pack<T, V>& x, int code,
                                         int64_t r, int64_t c, bool along_c,
                                         float (&v)[V]) const {
    int from = 0;
    if (code < 0) {
      from = -code;
#pragma unroll
      for (int e = 0; e < V; ++e) v[e] = __int_as_float(0x7fc00000);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) v[e] = xdma::to_f32(x.v[e]);
    }
    for (int s = from; s < n; ++s) apply_item<V>(st[s], v, r, c, along_c);
  }
  __device__ __forceinline__ T store(float v) const {
    return xdma::from_f32<T>(v);
  }
  __device__ __forceinline__ T zero() const { return xdma::from_f32<T>(0.f); }
};

// Copies the pass's stages to shared memory; the caller syncs the block
// before a thread reads them.
__device__ __forceinline__ void stages_to_shared(const Rank2Args& a,
                                                 Stage2* sh) {
  if (threadIdx.x < a.nstages) sh[threadIdx.x] = a.st[threadIdx.x];
}

template <typename W>
__device__ __forceinline__ xdma::Copy<W> policy_of(const Rank2Args& a,
                                                   const Stage2*,
                                                   xdma::Copy<W>*) {
  return {(W)a.fill_bits};
}
template <typename T>
__device__ __forceinline__ Values<T> policy_of(const Rank2Args& a,
                                               const Stage2* sh, Values<T>*) {
  return {sh, (int)a.nstages};
}

template <class P, int VS, int VD, bool DIRECT>
__global__ void __launch_bounds__(xdma::TILE_THREADS)
out2_kernel(const typename P::In* __restrict__ src,
            typename P::Out* __restrict__ dst,
            const __grid_constant__ Rank2Args a) {
  __shared__ Stage2 sh[XS];
  stages_to_shared(a, sh);     // tile2_run syncs before any value is read
  xdma::tile2_run<P, VS, VD, DIRECT>(
      a.t, src, dst, policy_of(a, sh, static_cast<P*>(nullptr)));
}

template <class P>
struct Out2 {
  template <int VS, int VD, bool DIRECT>
  struct K {
    using Fn = void (*)(const typename P::In*, typename P::Out*,
                        const Rank2Args);
    static Fn fn() { return out2_kernel<P, VS, VD, DIRECT>; }
  };
};

// V values of pass-space row i from column j on (V > 1: one 16-byte pack;
// the host allows it only where the column term is a unit-stride run).
template <typename T, int V>
__device__ __forceinline__ void row_values(const Values<T>& pol,
                                           const T* src, int64_t i,
                                           int64_t so_r, int64_t so_c,
                                           int64_t j, float (&v)[V]) {
  const int64_t off = xdma::join(so_r, so_c);
  xdma::Pack<T, V> p;
  if (off >= 0) p = xdma::load_pack<T, V>(src + off);
  pol.template values<V>(p, off < 0 ? (int)off : 0, i, j, true, v);
}

template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
stat2_kernel(const T* __restrict__ src, const __grid_constant__ Rank2Args a) {
  __shared__ float scratch[33];
  __shared__ Stage2 sh[XS];
  stages_to_shared(a, sh);
  __syncthreads();
  const Values<T> pol{sh, (int)a.nstages};
  const int64_t n = a.t.cols;
  for (int64_t i = blockIdx.x; i < a.t.rows; i += gridDim.x) {
    const int64_t so_r = xdma::term_off(a.t.src_r, i);
    float ss = 0.f;
    for (int64_t j = (int64_t)threadIdx.x * V; j < n;
         j += (int64_t)THREADS * V) {
      float v[V];
      row_values<T, V>(pol, src, i, so_r, xdma::term_off(a.t.src_c, j), j, v);
#pragma unroll
      for (int e = 0; e < V; ++e) ss += v[e] * v[e];
    }
    ss = xdma::block_sum(ss, scratch);
    if (threadIdx.x == 0)
      reinterpret_cast<float*>(a.out)[i] = rsqrtf(ss / (float)n + (float)a.eps);
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
mask2_kernel(const T* __restrict__ src, const __grid_constant__ Rank2Args a) {
  __shared__ Stage2 sh[XS];
  stages_to_shared(a, sh);
  __syncthreads();
  const Values<T> pol{sh, (int)a.nstages};
  const int64_t packs = a.t.cols / V;
  const int64_t span = a.block_rows * packs;
  const int64_t nb = a.t.rows / a.block_rows;
  for (int64_t b = blockIdx.x; b < nb; b += gridDim.x) {
    int any = 0;
    for (int64_t k = threadIdx.x; k < span && !any; k += THREADS) {
      int64_t row, pack;
      xdma::divmod(k, packs, row, pack);
      const int64_t i = b * a.block_rows + row, j = pack * V;
      float v[V];
      row_values<T, V>(pol, src, i, xdma::term_off(a.t.src_r, i),
                       xdma::term_off(a.t.src_c, j), j, v);
#pragma unroll
      for (int e = 0; e < V; ++e) any |= v[e] != 0.f;
    }
    any = __syncthreads_or(any);
    if (threadIdx.x == 0) reinterpret_cast<uint8_t*>(a.out)[b] = any ? 1 : 0;
  }
}

constexpr int SW = 64;       // REDUCE: columns per block
constexpr int UNROLL = 4;    // REDUCE: rows in flight a thread

template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
reduce2_kernel(const T* __restrict__ src, T* __restrict__ dst,
               const __grid_constant__ Rank2Args a) {
  constexpr int JL = SW / V, IL = THREADS / JL;   // lanes along j, along i
  __shared__ float part[IL][SW + 1];
  __shared__ int last;
  __shared__ Stage2 sh[XS];
  stages_to_shared(a, sh);
  __syncthreads();
  const Values<T> pol{sh, (int)a.nstages};
  const int64_t m = a.t.rows, n = a.t.cols;
  const int64_t strip = blockIdx.x / a.splits, split = blockIdx.x % a.splits;
  const int64_t j0 = strip * SW;
  const int tj = threadIdx.x % JL, ti = threadIdx.x / JL;
  const int64_t j = j0 + (int64_t)tj * V;
  const int64_t per = (m + a.splits - 1) / a.splits;
  const int64_t i1 = (split + 1) * per < m ? (split + 1) * per : m;
  float acc[V];
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = reduce_init<float>(a.op);
  if (j < n) {
    const int64_t so_c = xdma::term_off(a.t.src_c, j);
    int64_t i = split * per + ti;
    const xdma::DimMap& rm = a.t.src_r.map;
    if (!a.t.src_r.idx && rm.tile == 1 && so_c >= 0) {
      // rows at a fixed stride: UNROLL loads in flight, then combined in
      // row order
      const int64_t step = (int64_t)IL * rm.sgrid;
      const T* p = src + so_c + i * rm.sgrid;
      for (; i + (UNROLL - 1) * IL < i1;
           i += UNROLL * IL, p += UNROLL * step) {
        xdma::Pack<T, V> x[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
          x[u] = xdma::load_pack<T, V>(p + u * step);
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          float v[V];
          pol.template values<V>(x[u], 0, i + (int64_t)u * IL, j, true, v);
#pragma unroll
          for (int e = 0; e < V; ++e) acc[e] = reduce_op(a.op, acc[e], v[e]);
        }
      }
    }
    for (; i < i1; i += IL) {
      float v[V];
      row_values<T, V>(pol, src, i, xdma::term_off(a.t.src_r, i), so_c, j, v);
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = reduce_op(a.op, acc[e], v[e]);
    }
  }
#pragma unroll
  for (int e = 0; e < V; ++e) part[ti][tj * V + e] = acc[e];
  __syncthreads();
  const int col = threadIdx.x;
  const int64_t c = j0 + col;
  float tot = 0.f;
  if (col < SW) {
    tot = part[0][col];
    for (int y = 1; y < IL; ++y) tot = reduce_op(a.op, tot, part[y][col]);
  }
  if (a.splits > 1) {
    float* partial = reinterpret_cast<float*>(a.partial);
    if (col < SW && c < n) partial[split * n + c] = tot;
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0)
      last = atomicAdd(reinterpret_cast<int*>(a.counter) + strip, 1) ==
             (int)a.splits - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    if (col < SW && c < n) {
      // the splits in order, eight loads in flight at a time
      for (int64_t q0 = 0; q0 < a.splits; q0 += 8) {
        float p[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (q0 + u < a.splits) p[u] = __ldcg(partial + (q0 + u) * n + c);
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (q0 + u < a.splits)
            tot = q0 + u == 0 ? p[u] : reduce_op(a.op, tot, p[u]);
      }
    }
  }
  if (col < SW && c < a.t.pcols) {
    const T v = xdma::from_f32<T>(c < n ? xdma::round_to(tot, a.dtype) : 0.f);
    const T zero = xdma::from_f32<T>(0.f);
    const int64_t dc = xdma::dim_offset(a.t.dst_c, c);
    for (int64_t r = 0; r < a.t.prows; ++r)
      dst[xdma::dim_offset(a.t.dst_r, r) + dc] = r == 0 ? v : zero;
  }
}

unsigned grid_for(int64_t work, int64_t per_block) {
  int64_t b = (work + per_block - 1) / per_block;
  if (b < 1) b = 1;
  if (b > (1LL << 20)) b = 1LL << 20;   // the kernels stride over the rest
  return (unsigned)b;
}

template <typename T, int V>
int launch_rows(const Rank2Args& a, const void* src, void* dst, int64_t mode,
                cudaStream_t s) {
  const T* x = static_cast<const T*>(src);
  if (mode == 4) {
    stat2_kernel<T, V><<<grid_for(a.t.rows, 1), THREADS, 0, s>>>(x, a);
  } else if (mode == 5) {
    mask2_kernel<T, V><<<grid_for(a.t.rows / a.block_rows, 1), THREADS, 0, s>>>(
        x, a);
  } else {
    const int64_t blocks = (a.t.pcols + SW - 1) / SW * a.splits;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    reduce2_kernel<T, V><<<(unsigned)blocks, THREADS, 0, s>>>(
        x, static_cast<T*>(dst), a);
  }
  return (int)cudaGetLastError();
}

template <class P>
int launch_out2(const Rank2Args& a, const void* src, void* dst,
                cudaStream_t s) {
  constexpr int V = 16 / sizeof(typename P::In);
  const int64_t blocks = xdma::tile2_blocks(a.t);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  if (!xdma::tile2_aligned(a.t, src, dst))
    return (int)cudaErrorMisalignedAddress;
  auto fn = xdma::tile2_pick<V, Out2<P>::template K>(a.t);
  fn<<<(unsigned)blocks, xdma::TILE_THREADS, 0, s>>>(
      static_cast<const typename P::In*>(src),
      static_cast<typename P::Out*>(dst), a);
  return (int)cudaGetLastError();
}

// OUT copies words (Copy) when the host says no stage changes a value.
template <typename T, typename W>
int launch_rank2(const Rank2Args& a, bool copy, const void* src, void* dst,
                 int64_t mode, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  if (mode == 3)
    return copy ? launch_out2<xdma::Copy<W>>(a, src, dst, s)
                : launch_out2<Values<T>>(a, src, dst, s);
  // the row passes read along the columns: packs when the loads run there
  const bool packed = a.t.load_axis == 1 && a.t.vs > 1;
  if (packed && (uintptr_t)src % 16) return (int)cudaErrorMisalignedAddress;
  return packed ? launch_rows<T, V>(a, src, dst, mode, s)
                : launch_rows<T, 1>(a, src, dst, mode, s);
}

// An integer stream on the rank-2 path only moves words (the host sends it
// there only then).
template <typename W>
int launch_rank2_words(const Rank2Args& a, bool copy, const void* src,
                       void* dst, int64_t mode, cudaStream_t s) {
  if (!copy || mode != 3) return (int)cudaErrorInvalidValue;
  return launch_out2<xdma::Copy<W>>(a, src, dst, s);
}

template <typename C>
int launch_generic(const BlockArgs& a, const void* src, void* dst,
                   int64_t mode, cudaStream_t s) {
  if (mode == 0 && a.reduce_at < 0) {
    out_kernel<C><<<grid_for(a.total, THREADS), THREADS, 0, s>>>(src, dst, a);
  } else if (mode == 0) {
    out_reduce_kernel<C><<<grid_for(a.total, RX), dim3(RX, RY), 0, s>>>(
        src, dst, a);
  } else if (mode == 1) {
    stat_kernel<C><<<grid_for(a.total, 1), THREADS, 0, s>>>(src, a);
  } else if (mode == 2) {
    mask_kernel<C><<<grid_for(a.total, 1), THREADS, 0, s>>>(src, a);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Generic path (BlockArgs): mode 0 output pass into dst; 1 RMSNorm
// statistics; 2 Compress mask.  Rank-2 path (Rank2Args): mode 3 OUT, 4
// STAT, 5 MASK, 6 REDUCE; mode 7 is OUT with words copied unchanged.
extern "C" int xdma_block_datapath(const void* args, const void* src,
                                   void* dst, int64_t mode, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode >= 3 && mode <= 7) {
    const Rank2Args& r = *static_cast<const Rank2Args*>(args);
    if (r.nstages > XS) return (int)cudaErrorInvalidValue;
    if (r.t.rows == 0 || r.t.cols == 0) return 0;
    const bool copy = mode == 7;
    const int64_t m = copy ? 3 : mode;
    switch (r.dtype) {
      case xdma::F32:
        return launch_rank2<float, uint32_t>(r, copy, src, dst, m, s);
      case xdma::BF16:
        return launch_rank2<__nv_bfloat16, uint16_t>(r, copy, src, dst, m, s);
      case xdma::F16:
        return launch_rank2<__half, uint16_t>(r, copy, src, dst, m, s);
      case xdma::I8:
      case xdma::U8:
        return launch_rank2_words<uint8_t>(r, copy, src, dst, m, s);
      case xdma::I16:
        return launch_rank2_words<uint16_t>(r, copy, src, dst, m, s);
      case xdma::I32:
        return launch_rank2_words<uint32_t>(r, copy, src, dst, m, s);
      case xdma::I64:
        return launch_rank2_words<uint64_t>(r, copy, src, dst, m, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  const BlockArgs& a = *static_cast<const BlockArgs*>(args);
  if (a.nstages > XS || a.out_rank > XR || a.src_rank > XR || a.nphys > XP)
    return (int)cudaErrorInvalidValue;
  if (a.total == 0) return 0;
  return a.carrier ? launch_generic<long long>(a, src, dst, mode, s)
                   : launch_generic<float>(a, src, dst, mode, s);
}
