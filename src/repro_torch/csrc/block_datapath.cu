// Kernel 3: the block plugin datapath.
//
// Replaces the reference's TPU kernel src/repro/core/plugin_compiler.py:182,
// _compile_block (:169): reader -> any emit-capable plugin chain -> writer,
// the whole array in one grid step.  On top of the streaming plugins it runs
// Transpose, GatherScatter (a take along any axis), Compress (values plus a
// raw bool mask, one flag per block_rows rows), Decompress and ReduceStage
// (sum or max over the rows), for logical rank 2 to 8 (the host folds a
// higher rank's leading axes), on every stream the reference's datapath
// takes: float (f32, bf16, f16, float8_e4m3fn, float8_e5m2), integer (int8,
// uint8, int16, uint16, int32, uint32, int64) and bool.
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
// stages compose into one map per axis, at logical rank 2 to 8: every stage
// leaves the leading axes [0, rank - 2) in place (Transpose, Scale, BiasAdd,
// RMSNorm, Compress, Decompress, a Cast to the same dtype; a gather of a
// leading axis composes into that axis's index vector; a final ReduceStage
// with or without keepdims).  The leading axes are a batch: each block
// decodes its leading index once (grid y and z) and offsets the two sides and
// the per-row buffers by it, then runs a tiled copy with the layout maps
// hoisted out of the element loop and 16-byte accesses (xdma::tile2_run,
// shared with kernel 1), or row passes that read along the rows.  The KV
// tunnel's (1, S, D) transpose and the checkpoint's stacked (L, M, N)
// leaves run there.
//
// The generic path takes the rest: a cast between dtypes, a gather after a
// stage that reads its coordinate, stages after a ReduceStage, an integer
// stream that does more than move words, a destination that pads a leading
// axis.  Its values travel as f32 on a float stream (float8 included) and
// as int64 on an integer one (the carrier, a template parameter, as are the
// source's element size and the index width: 32-bit where every size of the
// launch fits); a bool stream takes the carrier of the stream it came from,
// so a bool, uint16 or uint32 stream and a float8 one add no instance.  A
// coordinate is one running triple (the leading axes' linear index, the
// row, the column) in registers.  The host compiles two short
// lists per launch, the index stages (transposes, gathers) and the value
// stages; a thread takes up to four consecutive elements of the
// destination's innermost run (decoded once), walks them back through the
// index list to their source offsets (one load of the four where those run
// consecutively), and runs the value list forward on them, each stage
// dispatched once for the group; a stage that reads its coordinate walks
// the output's back through the index stages after it.  Zeros go into
// stride padding.  Where the source runs across the output's rows (the
// index stages an odd number of transposes), the output pass stages 32 x 32
// tiles through shared memory: reads along the source's run, writes along
// the destination's.  A ReduceStage becomes a loop over the reduced rows: a
// 32 x 8 block gives each output 8 threads that sum (or max) interleaved
// rows in the carrier, then combines the partials in a fixed order, so the
// result is deterministic.
//
// On both paths a value that exists only after a reduction over the data
// takes a pass of its own before the output pass: an RMSNorm's inverse RMS
// per row, a Compress mask per row block (any nonzero).  The host splits a
// chain with more than one ReduceStage into launches joined by a row-major
// intermediate buffer.
#include <type_traits>

#include <cuda_fp8.h>

#include "xdma_common.cuh"

namespace {

constexpr int XR = 8;        // max logical rank
constexpr int XS = 8;        // max stages per launch
constexpr int XP = 2 * XR;   // max physical dims
constexpr int THREADS = 256;
constexpr int PER_THREAD = 4;   // generic OUT: destination elements a thread

enum StageCode : int64_t {
  ST_CAST = 1, ST_SCALE = 2, ST_BIAS = 3, ST_RMSNORM = 4, ST_TRANSPOSE = 5,
  ST_GATHER = 6, ST_COMPRESS = 7, ST_DECOMPRESS = 8, ST_REDUCE_SUM = 9,
  ST_REDUCE_MAX = 10
};

struct Stage {
  int64_t code;
  int64_t dtype;        // stream dtype after the stage
  int64_t where;        // GATHER: 0 a leading axis, 1 the rows, 2 the columns
  int64_t keepdims;     // REDUCE
  int64_t block_rows;   // COMPRESS / DECOMPRESS
  double a;             // SCALE / BIAS constant, RMSNORM eps
  int64_t vec;          // vector over the last axis or 0: SCALE / BIAS in the
                        // carrier's type (f32 or int64), the RMSNORM weight f32
  int64_t aux;          // GATHER: int64 indices; RMSNORM: f32 inverse RMS per row;
                        // COMPRESS / DECOMPRESS: uint8 mask
  int64_t rows, cols;   // the stage's input extents along its last two axes
  int64_t out_rows;     // REDUCE without keepdims: its output's rows (the
                        // input's innermost leading extent)
  int64_t inner;        // GATHER of a leading axis: the product of the
                        // leading extents after it,
  int64_t ext_in;       //   its extent at the stage's input
  int64_t ext_out;      //   and at its output
  int64_t nb;           // DECOMPRESS: row blocks a leading index
};

struct BlockArgs {
  int64_t nstages;
  Stage st[XS];
  int64_t in_dtype;
  int64_t nlead;          // the source's leading axes
  int64_t lext[XR - 2];   //   their extents
  xdma::DimMap src[XR];   // stage-0 logical coordinate -> src physical offset
  int64_t upto;           // the pass evaluates stages [0, upto)
  int64_t out_dtype;
  int64_t nphys;          // OUT: physical dims of the dst, post-perm
  int64_t pext[XP];       //   their extents
  int64_t plim[XP];       //   the index from which one lies in stride padding
  int64_t pslot[XP];      //   the coordinate it adds to: 0 lead, 1 row, 2 col
  int64_t pw[XP];         //   its weight there
  int64_t total;          // OUT: dst elements; STAT: rows; MASK: mask entries
  int64_t reduce_at;      // index of the one ReduceStage in [0, upto), or -1
  int64_t carrier;        // 0: values travel as f32; 1: as int64 words
  int64_t index32;        // 1: every size of the launch is below 2^31 (the
                          // 32-bit instances: 2x to 3.8x faster than the
                          // 64-bit ones on an H100, scripts/time_block.py)
  int64_t per_thread;     // OUT: elements a thread (PER_THREAD, 2 or 1)
  int64_t nwalk;          // the stages a walk back visits, ascending:
  int64_t walk[XS];       //   transposes, gathers, coordinate readers
  int64_t nvalue;         // the stages that change a value, ascending
  int64_t value[XS];
  int64_t tiled;          // OUT: stage the pass through a shared tile
};

// -- the carriers: f32 for float streams, int64 for integer streams ---------
// The host cuts a chain where the values change carrier, so one launch has
// one carrier; a Cast that crosses is the first stage of its launch and
// converts on load (an integer to the nearest float, a float toward zero).
// Integer results wrap to the stream dtype's width, as XLA's integer
// arithmetic does; a bool is 0 or 1 in either carrier (a Cast to bool is
// x != 0, a product of bools their and, a sum their or).
__device__ __forceinline__ long long wrap_to(long long v, int64_t dt) {
  switch (dt) {
    case xdma::I8: return (signed char)v;
    case xdma::U8: return (unsigned char)v;
    case xdma::I16: return (short)v;
    case xdma::U16: return (unsigned short)v;
    case xdma::I32: return (int)v;
    case xdma::U32: return (unsigned int)v;
    case xdma::BOOL: return v != 0;
    default: return v;
  }
}

// float8 through cuda_fp8.h's conversions, to nearest even: Hopper's
// saturating instruction (its non-saturating form is emulated in software),
// with the range and the NaNs checked here as the reference rounds them
// (plugins.to_float8): past float8_e4m3fn's range (above 464) its NaN, from
// float8_e5m2's (61440 on) an infinity, each with the value's sign.  A NaN
// keeps its sign in float8_e4m3fn (0x7F); in float8_e5m2 it is 0x7E with
// its sign where a Cast made it (XLA's conversion), else 0x7F (XLA's
// float8_e5m2 arithmetic, and jnp.take's fill).
__device__ __forceinline__ bool is_f8(int64_t dt) {
  return dt == xdma::F8E4M3 || dt == xdma::F8E5M2;
}
__device__ __forceinline__ float f8_value(uint8_t b, int64_t dt) {
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(
      (__nv_fp8_storage_t)b, dt == xdma::F8E4M3 ? __NV_E4M3 : __NV_E5M2)));
}
__device__ __forceinline__ uint8_t f8_bits(float v, int64_t dt,
                                           bool cast = false) {
  const bool e4 = dt == xdma::F8E4M3;
  const uint8_t sign = (__float_as_uint(v) >> 24) & 0x80;
  if (v != v) return e4 ? (0x7F | sign) : cast ? (0x7E | sign) : 0x7F;
  const float a = fabsf(v);
  if (e4 ? a > 464.f : a >= 61440.f) return sign | (e4 ? 0x7F : 0x7C);
  return (uint8_t)__nv_cvt_float_to_fp8(v, __NV_SATFINITE,
                                        e4 ? __NV_E4M3 : __NV_E5M2);
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

// Round to the stream dtype: to nearest even for f32 / bf16 / f16, wrap an
// integer or a bool.  In the f32 carrier a bool or float8 value is left as
// it is: the host ends a launch at each stage that changes one, and the
// store rounds it (x != 0 for a bool), so that no stage carries the narrow
// streams' conversions (compiled into every stage, they made the f32 / bf16
// / f16 chains 7 % slower).  A float8 sum rounds as it goes (ordered_sum).
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
// minimum (signed) or maximum (unsigned), or True.
template <typename C> __device__ __forceinline__ C fill_of(int64_t dt);
template <> __device__ __forceinline__ float fill_of<float>(int64_t) {
  return __int_as_float(0x7fc00000);
}
template <> __device__ __forceinline__ long long fill_of<long long>(int64_t dt) {
  switch (dt) {
    case xdma::I8: return -128;
    case xdma::U8: return 255;
    case xdma::I16: return -32768;
    case xdma::U16: return 65535;
    case xdma::I32: return -2147483647LL - 1;
    case xdma::U32: return 4294967295LL;
    case xdma::BOOL: return 1;
    default: return (long long)0x8000000000000000ULL;
  }
}

// A source element's bits (SZ bytes), and their value in the carrier by
// the source dtype.
template <int SZ>
using Raw = typename std::conditional<
    SZ == 1, uint8_t,
    typename std::conditional<
        SZ == 2, uint16_t,
        typename std::conditional<SZ == 4, uint32_t, uint64_t>::type>::type>::
    type;

template <typename C, int SZ>
__device__ __forceinline__ C from_raw(Raw<SZ> r, int64_t dt) {
  if constexpr (SZ == 1) {
    if (is_f8(dt)) return of_float<C>(f8_value(r, dt));
    return dt == xdma::I8 ? of_int<C>((signed char)r) : of_int<C>(r);
  } else if constexpr (SZ == 2) {
    if (dt == xdma::BF16) return of_float<C>(__uint_as_float((uint32_t)r << 16));
    if (dt == xdma::F16) return of_float<C>(__half2float(__ushort_as_half(r)));
    return dt == xdma::U16 ? of_int<C>(r) : of_int<C>((short)r);
  } else if constexpr (SZ == 4) {
    if (dt == xdma::F32) return of_float<C>(__uint_as_float(r));
    return dt == xdma::U32 ? of_int<C>((long long)r) : of_int<C>((int)r);
  } else {
    return of_int<C>((long long)r);
  }
}

// A carrier value in the destination's element type.
template <typename T, typename C>
__device__ __forceinline__ T out_cast(C v) {
  if constexpr (std::is_same<T, float>::value) {
    return as_float(v);
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value ||
                       std::is_same<T, __half>::value) {
    return xdma::from_f32<T>(as_float(v));
  } else {
    return (T)as_int(v);
  }
}

// E (<= PT) consecutive destination elements from p0: one pack when
// E == PT (the host aligns it), else one element at a time.
template <typename T, int PT, typename C, typename I>
__device__ __forceinline__ void put(void* dst, I p0, int E,
                                    const C (&v)[PT]) {
  T* p = static_cast<T*>(dst) + p0;
  if (E == PT) {
    xdma::Pack<T, PT> pk;
#pragma unroll
    for (int e = 0; e < PT; ++e) pk.v[e] = out_cast<T>(v[e]);
    xdma::store_pack<T, PT>(p, pk);
  } else {
#pragma unroll
    for (int e = 0; e < PT; ++e)
      if (e < E) p[e] = out_cast<T>(v[e]);
  }
}

// A bool or float8 store, one byte an element: the rounding of the stage
// that made the value (x != 0, or float8 in either format, the launch's
// last stage: a Cast's NaN rounds as the conversion's).
template <int PT, typename C, typename I>
__device__ __forceinline__ void put_narrow(void* dst, I p0, int E,
                                           const BlockArgs& a,
                                           const C (&v)[PT]) {
  const int64_t dt = a.out_dtype;
  const bool cast = a.nstages > 0 && a.st[a.nstages - 1].code == ST_CAST;
  uint8_t* p = static_cast<uint8_t*>(dst) + p0;
#pragma unroll
  for (int e = 0; e < PT; ++e)
    if (e < E)
      p[e] = dt == xdma::BOOL ? (v[e] != (C)0)
                              : f8_bits(as_float(v[e]), dt, cast);
}

// E elements of the launch's output (a.out_dtype) from p0.
template <int PT, typename C, typename I>
__device__ __forceinline__ void store_group(void* dst, I p0, int E,
                                            const BlockArgs& a,
                                            const C (&v)[PT]) {
  switch (a.out_dtype) {
    case xdma::F32: put<float, PT>(dst, p0, E, v); break;
    case xdma::BF16: put<__nv_bfloat16, PT>(dst, p0, E, v); break;
    case xdma::F16: put<__half, PT>(dst, p0, E, v); break;
    case xdma::I8: put<signed char, PT>(dst, p0, E, v); break;
    case xdma::U8: put<unsigned char, PT>(dst, p0, E, v); break;
    // a value wrapped to uint16 / uint32 has the bits of its int16 / int32
    case xdma::I16:
    case xdma::U16: put<short, PT>(dst, p0, E, v); break;
    case xdma::I32:
    case xdma::U32: put<int, PT>(dst, p0, E, v); break;
    case xdma::BOOL:
    case xdma::F8E4M3:
    case xdma::F8E5M2: put_narrow<PT>(dst, p0, E, a, v); break;
    default: put<long long, PT>(dst, p0, E, v); break;
  }
}

// A SCALE / BIAS constant in the carrier's type, at last-axis index j.
template <typename I>
__device__ __forceinline__ float konst(const Stage& st, I j, float*) {
  return st.vec ? reinterpret_cast<const float*>(st.vec)[j] : (float)st.a;
}
template <typename I>
__device__ __forceinline__ long long konst(const Stage& st, I j, long long*) {
  return st.vec ? reinterpret_cast<const long long*>(st.vec)[j]
                : (long long)st.a;
}

// n / d in the index type, inline: a shift for a power of two, 32-bit
// division where both fit, else a few steps from an f32 reciprocal, each
// taking a quotient that is never too large.  (A 64-bit `/` compiles to a
// called routine, whose calling convention spills.)
__device__ __forceinline__ uint32_t quo(uint32_t n, uint32_t d) {
  return (d & (d - 1)) == 0 ? n >> (__ffs(d) - 1) : n / d;
}
__device__ __forceinline__ uint64_t quo(uint64_t n, uint64_t d) {
  if (((n | d) >> 32) == 0) return quo((uint32_t)n, (uint32_t)d);
  const float inv = __frcp_rz((float)d) * (1.f - 1.f / (1 << 20));
  uint64_t q = 0;
  while (n >= d) {
    uint64_t t = (uint64_t)__fmul_rz(__ull2float_rz(n), inv);
    t = t ? t : 1;
    q += t;
    n -= t * d;
  }
  return q;
}

// A logical coordinate at some point of the chain: the row-major index over
// the leading axes, the row and the column.
template <typename I>
struct Co {
  I lead, row, col;
};

template <typename I>
__device__ __forceinline__ void add_to(Co<I>& c, int64_t slot, I w) {
  if (slot == 0)
    c.lead += w;
  else if (slot == 1)
    c.row += w;
  else
    c.col += w;
}

// The layout map of one logical dim, in the index type.
template <typename I>
__device__ __forceinline__ I dim_off(const xdma::DimMap& m, I i) {
  if (m.tile == 1) return i * (I)m.sgrid;
  const I t = (I)m.tile;
  if ((t & (t - 1)) == 0) {
    const int sh = __ffsll((unsigned long long)m.tile) - 1;
    return (i >> sh) * (I)m.sgrid + (i & (t - 1)) * (I)m.stile;
  }
  const I q = quo(i, t);
  return q * (I)m.sgrid + (i - q * t) * (I)m.stile;
}

// The source offset of stage 0's input coordinate c.
template <typename I>
__device__ __forceinline__ I src_offset(const BlockArgs& a, Co<I> c) {
  const int n = (int)a.nlead;
  I off = dim_off<I>(a.src[n], c.row) + dim_off<I>(a.src[n + 1], c.col);
  I rem = c.lead;
  for (int d = n - 1; d >= 0; --d) {
    const I e = (I)a.lext[d];
    const I q = quo(rem, e);
    off += dim_off<I>(a.src[d], rem - q * e);
    rem = q;
  }
  return off;
}

// A group of N elements (N > 1 only in the output pass): each one's
// coordinate, whether it is a logical element (not stride padding), the
// stage of the gather whose fill it is (-1: none), and its value.  Every
// loop over the group is unrolled, so the group lives in registers; the
// loops over the stages are not, so each stage's code is dispatched once
// a group and the kernels stay small.

// Walk the live elements' coordinates c back through the index stages of
// [lo, hi) (the host's walk list: transposes and gathers), last first.  An
// element whose gather index is out of range gets that stage in fill and
// is left there: the stages before it do not matter to its value.
template <int N, typename I>
__device__ __forceinline__ void walk_back(const BlockArgs& a, int lo, int hi,
                                          Co<I> (&c)[N], const bool (&live)[N],
                                          int (&fill)[N]) {
#pragma unroll 1
  for (int w = (int)a.nwalk - 1; w >= 0; --w) {
    const int s = (int)a.walk[w];
    if (s >= hi) continue;
    if (s < lo) break;
    const Stage& st = a.st[s];
    if (st.code == ST_TRANSPOSE) {
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const I t = c[e].row;
        c[e].row = c[e].col;
        c[e].col = t;
      }
      continue;
    }
    const int64_t* idx = reinterpret_cast<const int64_t*>(st.aux);
    if (st.where == 0) {   // a leading axis, within the linear index
      const I in = (I)st.inner, eo = (I)st.ext_out, ei = (I)st.ext_in;
#pragma unroll
      for (int e = 0; e < N; ++e) {
        if (!live[e] || fill[e] >= 0) continue;
        const I mid = quo(c[e].lead, in), low = c[e].lead - mid * in;
        const I high = quo(mid, eo), q = mid - high * eo;
        const int64_t j = idx[q];
        if (j < 0)
          fill[e] = s;
        else
          c[e].lead = (high * ei + (I)j) * in + low;
      }
    } else {
      const bool rows = st.where == 1;
#pragma unroll
      for (int e = 0; e < N; ++e) {
        if (!live[e] || fill[e] >= 0) continue;
        const int64_t j = idx[rows ? c[e].row : c[e].col];
        if (j < 0)
          fill[e] = s;
        else if (rows)
          c[e].row = (I)j;
        else
          c[e].col = (I)j;
      }
    }
  }
}

__device__ __forceinline__ bool reads_coordinate(const Stage& st) {
  return st.code == ST_RMSNORM || st.code == ST_DECOMPRESS ||
         ((st.code == ST_SCALE || st.code == ST_BIAS) && st.vec);
}

// The value stages of [lo, hi) (the host's value list) forward on the
// values v of the live elements whose coordinates at point hi are c, each
// stage on the elements whose fill stage lies before it.  A stage that
// reads its coordinate gets it by walking c back through the index stages
// after it (those gathers succeed for these elements).
template <typename C, int N, typename I>
__device__ __forceinline__ void apply_forward(const BlockArgs& a, int lo,
                                              int hi, const Co<I> (&c)[N],
                                              const bool (&live)[N],
                                              const int (&fill)[N],
                                              C (&v)[N]) {
#pragma unroll 1
  for (int w = 0; w < (int)a.nvalue; ++w) {
    const int s = (int)a.value[w];
    if (s < lo) continue;
    if (s >= hi) break;
    const Stage& st = a.st[s];
    bool on[N];
    int none[N];
    Co<I> cs[N];
#pragma unroll
    for (int e = 0; e < N; ++e) {
      on[e] = live[e] && fill[e] < s;
      none[e] = -1;
      cs[e] = c[e];
    }
    if (reads_coordinate(st)) walk_back<N, I>(a, s + 1, hi, cs, on, none);
    switch (st.code) {
      case ST_CAST:
#pragma unroll
        for (int e = 0; e < N; ++e)
          if (on[e]) v[e] = round_c(v[e], st.dtype);
        break;
      case ST_SCALE:
#pragma unroll
        for (int e = 0; e < N; ++e)
          if (on[e])
            v[e] = round_c(mul_c(v[e], konst(st, cs[e].col, (C*)nullptr)),
                           st.dtype);
        break;
      case ST_BIAS:
#pragma unroll
        for (int e = 0; e < N; ++e)
          if (on[e])
            v[e] = round_c(add_c(v[e], konst(st, cs[e].col, (C*)nullptr)),
                           st.dtype);
        break;
      case ST_RMSNORM: {   // in f32, then back to the stream dtype
        const float* inv = reinterpret_cast<const float*>(st.aux);
        const float* vec = reinterpret_cast<const float*>(st.vec);
#pragma unroll
        for (int e = 0; e < N; ++e) {
          if (!on[e]) continue;
          float y = as_float(v[e]) * inv[cs[e].lead * (I)st.rows + cs[e].row];
          if (vec) y = y * vec[cs[e].col];
          v[e] = round_c(of_float<C>(y), st.dtype);
        }
        break;
      }
      case ST_DECOMPRESS: {
        const uint8_t* mask = reinterpret_cast<const uint8_t*>(st.aux);
#pragma unroll
        for (int e = 0; e < N; ++e) {
          if (!on[e]) continue;
          const bool keep = mask[cs[e].lead * (I)st.nb +
                                 quo(cs[e].row, (I)st.block_rows)] != 0;
          v[e] = round_c(mul_c(v[e], (C)(keep ? 1 : 0)), st.dtype);
        }
        break;
      }
      default:
        break;
    }
  }
}

// The values v of a group after stages [0, k) at their point-k coordinates
// c; no ReduceStage in [0, k).
template <typename C, int SZ, int N, typename I>
__device__ __forceinline__ void eval_plain(const BlockArgs& a,
                                           const void* src, int k,
                                           const Co<I> (&c)[N],
                                           const bool (&live)[N], C (&v)[N]) {
  Co<I> cw[N];
  int fill[N];
#pragma unroll
  for (int e = 0; e < N; ++e) {
    cw[e] = c[e];
    fill[e] = -1;
  }
  walk_back<N, I>(a, 0, k, cw, live, fill);
  I off[N];
  bool run = true;   // every element loads, from consecutive offsets
#pragma unroll
  for (int e = 0; e < N; ++e) {
    off[e] = live[e] && fill[e] < 0 ? src_offset<I>(a, cw[e]) : 0;
    run = run && live[e] && fill[e] < 0 && off[e] == off[0] + (I)e;
  }
  const Raw<SZ>* raw = static_cast<const Raw<SZ>*>(src);
  if (N > 1 && run && (uintptr_t)(raw + off[0]) % (N * SZ) == 0) {
    // one access for the group (a pack of N elements)
    const xdma::Pack<Raw<SZ>, N> p = xdma::load_pack<Raw<SZ>, N>(raw + off[0]);
#pragma unroll
    for (int e = 0; e < N; ++e) v[e] = from_raw<C, SZ>(p.v[e], a.in_dtype);
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) {   // every load of the group in flight
      if (!live[e])
        v[e] = C(0);
      else if (fill[e] >= 0)
        v[e] = fill_of<C>(a.st[fill[e]].dtype);   // jnp.take's fill
      else
        v[e] = from_raw<C, SZ>(raw[off[e]], a.in_dtype);
    }
  }
  apply_forward<C, N, I>(a, 0, k, c, live, fill, v);
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

// A float8 sum rounds to float8 after every addition, so its order is its
// result; it takes the reference's (XLA's CPU compiler rewrites a reduction
// over 32 rows or more into windows of 32, the rows padded evenly at both
// ends, each window summed in order from zero, then reduces the window sums
// the same way, until fewer than 32 are summed in order).  One thread walks
// the n rows (row(i): the value of row i) and closes each window as its last
// row passes.  The padding's zeros leave a sum as it is: it never holds -0.
constexpr int SUM_WINDOW = 32, SUM_LEVELS = 8;   // 32^8 rows

template <typename I, typename F>
__device__ __forceinline__ float ordered_sum(I n, int64_t dt, const F& row) {
  I ext[SUM_LEVELS], low[SUM_LEVELS];
  int levels = 0;
  for (I m = n; m >= (I)SUM_WINDOW && levels < SUM_LEVELS; ++levels) {
    const I k = (m + (I)(SUM_WINDOW - 1)) / (I)SUM_WINDOW;
    ext[levels] = m;
    low[levels] = (k * (I)SUM_WINDOW - m) / 2;
    m = k;
  }
  float acc[SUM_LEVELS + 1];
  for (int j = 0; j <= levels; ++j) acc[j] = 0.f;
  for (I i = 0; i < n; ++i) {
    acc[0] = f8_value(f8_bits(acc[0] + row(i), dt), dt);
    I e = i;
    for (int j = 0; j < levels; ++j) {   // row e of level j closes a window
      const I w = e + low[j];
      if (e != ext[j] - 1 && w % (I)SUM_WINDOW != (I)(SUM_WINDOW - 1)) break;
      acc[j + 1] = f8_value(f8_bits(acc[j + 1] + acc[j], dt), dt);
      acc[j] = 0.f;
      e = w / (I)SUM_WINDOW;
    }
  }
  return acc[levels];
}

template <typename C>
__device__ __forceinline__ bool ordered(const Stage& st) {
  return std::is_same<C, float>::value && st.code == ST_REDUCE_SUM &&
         is_f8(st.dtype);
}

// The input coordinate of ReduceStage st for row r, from its output's.
template <typename I>
__device__ __forceinline__ Co<I> reduce_input(const Stage& st, Co<I> out,
                                              I r) {
  return {st.keepdims ? out.lead : out.lead * (I)st.out_rows + out.row, r,
          out.col};
}

// One element's value after stages [0, k), before the ReduceStage at R
// (point-R coordinate c).
template <typename C, int SZ, typename I>
__device__ __forceinline__ C eval_one(const BlockArgs& a, const void* src,
                                      int k, Co<I> c) {
  const Co<I> cs[1] = {c};
  const bool live[1] = {true};
  C v[1];
  eval_plain<C, SZ, 1, I>(a, src, k, cs, live, v);
  return v[0];
}

// One element's value after stages [0, k) at point-k coordinate c, a
// ReduceStage included (the thread loops over all of its rows).  Never a
// float8 sum: the host ends a launch with one, so only the output pass
// holds its windows' registers, not the statistics and mask passes.
template <typename C, int SZ, typename I>
__device__ __forceinline__ C eval(const BlockArgs& a, const void* src, int k,
                                  Co<I> c) {
  const int R = (int)a.reduce_at;
  if (R < 0 || R >= k) return eval_one<C, SZ, I>(a, src, k, c);
  const Co<I> out[1] = {c};
  Co<I> cw[1] = {c};
  const bool live[1] = {true};
  int fill[1] = {-1};
  walk_back<1, I>(a, R + 1, k, cw, live, fill);
  C v[1];
  if (fill[0] >= 0) {
    v[0] = fill_of<C>(a.st[fill[0]].dtype);
  } else {
    const Stage& st = a.st[R];
    C acc = reduce_init<C>(st.code);
    for (I r = 0; r < (I)st.rows; ++r)
      acc = reduce_op(st.code, acc,
                      eval_one<C, SZ, I>(a, src, R, reduce_input<I>(st, cw[0], r)));
    v[0] = round_c(acc, st.dtype);
  }
  apply_forward<C, 1, I>(a, R + 1, k, out, live, fill, v);
  return v[0];
}

// What physical dims [0, top] of the dst add at index q (row-major over
// them): the coordinate, and whether one of them lies in stride padding.
template <typename I>
struct Dst {
  Co<I> c;
  bool pad;
  I inner;   // decode: the index along the innermost dim
};

template <typename I>
__device__ __forceinline__ Dst<I> decode_dims(const BlockArgs& a, I q,
                                              int top) {
  Dst<I> o{{0, 0, 0}, false, 0};
  for (int k = top; k >= 0; --k) {
    const I e = (I)a.pext[k];
    const I q2 = quo(q, e), i = q - q2 * e;
    o.pad |= i >= (I)a.plim[k];
    add_to<I>(o.c, a.pslot[k], i * (I)a.pw[k]);
    q = q2;
  }
  return o;
}

// Destination element p without its innermost physical dim.
template <typename I>
__device__ __forceinline__ Dst<I> decode(const BlockArgs& a, I p) {
  const int last = (int)a.nphys - 1;
  const I q = quo(p, (I)a.pext[last]);
  Dst<I> o = decode_dims<I>(a, q, last - 1);
  o.inner = p - q * (I)a.pext[last];
  return o;
}

// Output pass without a ReduceStage: a thread owns per_thread (<=
// PER_THREAD) consecutive elements of the dst's innermost run, in physical
// order (coalesced writes, zeros into stride padding), decoded once,
// evaluated as one group and stored as one pack.  The pass is bound by
// each group's latency (its load, then its value stages, then its store),
// so occupancy pays: the f32 carrier's 32-bit instance asks for 4 blocks an
// SM (64 registers, which it fits without spilling; measured 17 % faster on
// the checkpoint's down-cast wire than at 70 registers).  Every kernel of
// the generic path names its minimum blocks an SM: without one, ptxas
// capped several at 32 or 64 registers and spilled.
template <typename C, int SZ, typename I>
__global__ void __launch_bounds__(
    THREADS, sizeof(I) == 4 && std::is_same<C, float>::value ? 4 : 1)
out_kernel(const void* __restrict__ src, void* __restrict__ dst,
           const __grid_constant__ BlockArgs a) {
  const int k = (int)a.upto, E = (int)a.per_thread;
  const int last = (int)a.nphys - 1;
  const I groups = (I)quo((uint64_t)a.total, (uint64_t)E);
  const I step = (I)gridDim.x * THREADS;
  for (I g = (I)blockIdx.x * THREADS + threadIdx.x; g < groups; g += step) {
    const I p0 = g * (I)E;
    const Dst<I> o = decode<I>(a, p0);
    Co<I> c[PER_THREAD];
    bool live[PER_THREAD];
#pragma unroll
    for (int e = 0; e < PER_THREAD; ++e) {
      const I i = o.inner + (I)e;
      live[e] = e < E && !o.pad && i < (I)a.plim[last];
      c[e] = o.c;
      add_to<I>(c[e], a.pslot[last], i * (I)a.pw[last]);
    }
    C v[PER_THREAD];
    eval_plain<C, SZ, PER_THREAD, I>(a, src, k, c, live, v);
    store_group<PER_THREAD, C, I>(dst, p0, E, a, v);
  }
}

// Output pass staged through a shared tile (a.tiled), for a source that
// runs across the dst's rows: the host picks it for a 32-bit launch whose
// index stages are an odd number of transposes and nothing else, whose
// dst's last two physical dims are its rows and columns, and whose dst rows
// read the source's unit-stride axis (a launch of 2^31 elements or more
// takes the untiled pass: a 64-bit tiled instance would add build time).  A TT x TY block takes a TT x TT tile of those two dims:
// it evaluates the tile with its lanes along the dst's rows (coalesced
// source reads; four elements a thread, one group), stages the values in
// shared memory and stores them with its lanes along the dst's columns
// (coalesced writes, zeros into stride padding).
constexpr int TT = 32, TY = THREADS / TT;

template <typename C, int SZ, typename I>
__global__ void __launch_bounds__(
    THREADS, sizeof(I) == 4 && std::is_same<C, float>::value ? 4 : 1)
out_tiled_kernel(const void* __restrict__ src, void* __restrict__ dst,
                 const __grid_constant__ BlockArgs a) {
  constexpr int N = TT / TY;
  __shared__ C tile[TT][TT + 1];
  const int k = (int)a.upto, last = (int)a.nphys - 1;
  const I ec = (I)a.pext[last], er = (I)a.pext[last - 1];
  const I tc = quo(ec + (I)(TT - 1), (I)TT);
  const I per = quo(er + (I)(TT - 1), (I)TT) * tc;
  const I tiles = quo((I)a.total, er * ec) * per;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (I t = blockIdx.x; t < tiles; t += gridDim.x) {
    const I q = quo(t, per), rest = t - q * per, ti = quo(rest, tc);
    const I r0 = ti * (I)TT, c0 = (rest - ti * tc) * (I)TT;
    const Dst<I> o = decode_dims<I>(a, q, last - 2);
    Co<I> c[N];
    bool live[N];
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const I r = r0 + (I)tx, j = c0 + (I)(ty + TY * e);
      live[e] = !o.pad && r < (I)a.plim[last - 1] && j < (I)a.plim[last];
      c[e] = o.c;
      add_to<I>(c[e], a.pslot[last - 1], r * (I)a.pw[last - 1]);
      add_to<I>(c[e], a.pslot[last], j * (I)a.pw[last]);
    }
    C v[N];
    eval_plain<C, SZ, N, I>(a, src, k, c, live, v);
#pragma unroll
    for (int e = 0; e < N; ++e) tile[ty + TY * e][tx] = v[e];
    __syncthreads();
    const I base = q * er * ec;
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const I r = r0 + (I)(ty + TY * e), j = c0 + (I)tx;
      if (r < er && j < ec) {
        const C w[1] = {tile[tx][ty + TY * e]};
        store_group<1, C, I>(dst, base + r * ec + j, 1, a, w);
      }
    }
    __syncthreads();
  }
}

// The reduce block: RX outputs x RY row lanes, 256 threads.  In the f32
// carrier 32 x 8 (the lanes' order is its sums' order); in the int64
// carrier, whose sums (modulo 2^64) and maxima are exact in any order,
// 8 x 32: 4x the blocks and the rows in flight (3,072 columns of 32-bit
// words make 384 blocks, 8 outputs reading one 32-byte sector a row).
template <typename C> struct ReduceBlock {
  static constexpr int RX = 32, RY = 8;
};
template <> struct ReduceBlock<long long> {
  static constexpr int RX = 8, RY = 32;
};

// Output pass with a ReduceStage at a.reduce_at: RY threads per output (a
// float8 sum: one, in the reference's order).
template <typename C, int SZ, typename I>
__global__ void __launch_bounds__(256, 1)
out_reduce_kernel(const void* __restrict__ src, void* __restrict__ dst,
                  const __grid_constant__ BlockArgs a) {
  constexpr int RX = ReduceBlock<C>::RX, RY = ReduceBlock<C>::RY;
  static_assert(RX * RY == 256, "the reduce block has 256 threads");
  __shared__ C part[RY][RX + 1];
  const int k = (int)a.upto, R = (int)a.reduce_at;
  const int last = (int)a.nphys - 1;
  const Stage& st = a.st[R];
  const I rows = (I)st.rows;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (I base = (I)blockIdx.x * RX; base < (I)a.total;
       base += (I)gridDim.x * RX) {
    const I p = base + (I)tx;
    Dst<I> o{{0, 0, 0}, true, 0};
    if (p < (I)a.total) o = decode<I>(a, p);
    Co<I> out[1] = {o.c};
    add_to<I>(out[0], a.pslot[last], o.inner * (I)a.pw[last]);
    const bool live[1] = {!o.pad && o.inner < (I)a.plim[last]};
    Co<I> cw[1] = {out[0]};
    int fill[1] = {-1};
    walk_back<1, I>(a, R + 1, k, cw, live, fill);
    C acc = reduce_init<C>(st.code);
    const bool one = ordered<C>(st);
    if (live[0] && fill[0] < 0) {
      if (one) {
        if constexpr (std::is_same<C, float>::value)
          if (ty == 0)
            acc = ordered_sum<I>(rows, st.dtype, [&](I r) {
              return eval_one<C, SZ, I>(a, src, R,
                                        reduce_input<I>(st, cw[0], r));
            });
      } else {
        for (I r = (I)ty; r < rows; r += RY)
          acc = reduce_op(st.code, acc, eval_one<C, SZ, I>(
                                            a, src, R, reduce_input<I>(st, cw[0], r)));
      }
    }
    part[ty][tx] = acc;
    __syncthreads();
    if (ty == 0 && p < (I)a.total) {
      C v[1] = {};
      if (live[0]) {
        if (fill[0] < 0) {
          C tot = part[0][tx];
          for (int y = 1; y < (one ? 1 : RY); ++y)
            tot = reduce_op(st.code, tot, part[y][tx]);
          v[0] = round_c(tot, st.dtype);
        } else {
          v[0] = fill_of<C>(a.st[fill[0]].dtype);
        }
        apply_forward<C, 1, I>(a, R + 1, k, out, live, fill, v);
      }
      store_group<1, C, I>(dst, p, 1, a, v);
    }
    __syncthreads();
  }
}

// RMSNorm statistics of stage a.upto: one block per row of its input space.
template <typename C, int SZ, typename I>
__global__ void __launch_bounds__(THREADS, 1)
stat_kernel(const void* __restrict__ src, const __grid_constant__ BlockArgs a) {
  __shared__ float scratch[33];
  const int k = (int)a.upto;
  const Stage& st = a.st[k];
  const I rows = (I)st.rows, n = (I)st.cols;
  for (I row = blockIdx.x; row < (I)a.total; row += gridDim.x) {
    const I lead = quo(row, rows);
    float ss = 0.f;
    for (I j = threadIdx.x; j < n; j += THREADS) {
      const float v = as_float(
          eval<C, SZ, I>(a, src, k, Co<I>{lead, row - lead * rows, j}));
      ss += v * v;
    }
    ss = xdma::block_sum(ss, scratch);
    if (threadIdx.x == 0)
      reinterpret_cast<float*>(st.aux)[row] =
          rsqrtf(ss / (float)n + (float)st.a);
  }
}

// Compress mask of stage a.upto: one block per (lead, row block) entry.
template <typename C, int SZ, typename I>
__global__ void __launch_bounds__(THREADS, 1)
mask_kernel(const void* __restrict__ src, const __grid_constant__ BlockArgs a) {
  const int k = (int)a.upto;
  const Stage& st = a.st[k];
  const I n = (I)st.cols, br = (I)st.block_rows;
  const I nb = quo((I)st.rows, br), span = br * n;
  for (I e = blockIdx.x; e < (I)a.total; e += gridDim.x) {
    const I lead = quo(e, nb), row0 = (e - lead * nb) * br;
    int any = 0;
    for (I t = threadIdx.x; t < span && !any; t += THREADS) {
      const I r = quo(t, n);
      any = eval<C, SZ, I>(a, src, k, Co<I>{lead, row0 + r, t - r * n}) !=
            (C)0;
    }
    any = __syncthreads_or(any);
    if (threadIdx.x == 0) reinterpret_cast<uint8_t*>(st.aux)[e] = any ? 1 : 0;
  }
}

// ---- the rank-2 path -------------------------------------------------------
//
// For chains the host can compose (logical rank 2 to 8, every stage leaving
// the leading axes in place, one stream dtype, index stages that compose
// into a swap and one index vector per axis, a ReduceStage only last): no
// element walks the stage list.  The host folds the index stages of the
// stages before a pass's point into the pass's Tile2 (xdma_common.cuh): the
// source terms of a pass-space row and column, each with its composed
// gather indices, whose entries < 0 are the fill code -(g + 1) of the
// gather g that failed.  Value stages then run in chain order, once on each
// item of values (a 16-byte pack, or one word), each reading its own
// coordinate: the pass's (r, c) or, under an odd number of later
// transposes, (c, r).  The leading axes are a batch over grid y and z: a
// block decodes its one leading index (Lead2: each axis's source term, with a
// leading-axis gather's composed indices, and its destination map) and
// offsets both sides, the per-row buffers of the stages (aux_step bytes a
// leading index), the pass's own output and the REDUCE scratch by it; a
// leading index whose gather failed fills its whole slice.
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
  int64_t aux_step;     // bytes of aux a leading index
};

struct Lead2 {          // one leading axis of the pass space
  int64_t extent;
  xdma::Term src;       // its source map and composed gather indices
  xdma::DimMap dst;     // its destination map (OUT, REDUCE)
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
  int64_t partial;      // REDUCE: f32 [batch][splits][t.cols] (splits > 1)
  int64_t counter;      // REDUCE: int32 [batch][column strips], zeroed
  int64_t nlead;        // leading axes, outermost first
  int64_t batch;        // the product of their extents
  Lead2 lead[XR - 2];
};

// A block's leading index: row-major over the leading extents, each side's
// offset (the source's 0 where a gather failed: the slice is all fill) and
// the failed gather's fill code, or 0.
struct At {
  int64_t flat, src, dst;
  int code;
};

__device__ __forceinline__ At lead_at(const Rank2Args& a, int64_t b) {
  At at{b, 0, 0, 0};
  for (int d = (int)a.nlead - 1; d >= 0; --d) {
    const int64_t q = (int64_t)quo((uint64_t)b, (uint64_t)a.lead[d].extent);
    const int64_t i = b - q * a.lead[d].extent;
    b = q;
    const int64_t o = xdma::term_off(a.lead[d].src, i);
    if (o < 0)
      at.code = o < at.code ? (int)o : at.code;   // the later gather's code
    else
      at.src += o;
    at.dst += xdma::dim_offset(a.lead[d].dst, i);
  }
  if (at.code < 0) at.src = 0;
  return at;
}

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

// A policy under a leading index whose gather may have failed: the item's
// fill code merged with the block's (the later gather's, the more negative,
// stands).
template <class P>
struct Led : P {
  int lead;
  template <int V>
  __device__ __forceinline__ void values(
      const xdma::Pack<typename P::In, V>& x, int code, int64_t r, int64_t c,
      bool along_c, typename P::S (&v)[V]) const {
    P::template values<V>(x, code < lead ? code : lead, r, c, along_c, v);
  }
};

template <class P>
__device__ __forceinline__ Led<P> led(const P& p, int code) {
  Led<P> l;
  static_cast<P&>(l) = p;
  l.lead = code;
  return l;
}

// Copies the pass's stages to shared memory, each per-row buffer offset to
// the leading index `flat`; the caller syncs the block before a thread
// reads them.
__device__ __forceinline__ void stages_to_shared(const Rank2Args& a,
                                                 Stage2* sh, int64_t flat) {
  if (threadIdx.x < a.nstages) {
    Stage2 s = a.st[threadIdx.x];
    s.aux += flat * s.aux_step;
    sh[threadIdx.x] = s;
  }
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

// The block's leading index: grid y and z over the batch (y fastest), or
// none past its end.
__device__ __forceinline__ bool lead_block(const Rank2Args& a, int64_t& b) {
  b = (int64_t)blockIdx.z * gridDim.y + blockIdx.y;
  return b < a.batch;
}

// The tiled copy.  BATCHED: a block's leading index offsets both sides and
// the stages' buffers (logical rank 3-8); the rank-2 instance has no
// leading state at all: carrying it through the tile loop cost the f32
// Values instance 32 bytes of spill and 5 % of its time.
template <class P, int VS, int VD, bool DIRECT, bool BATCHED>
__global__ void __launch_bounds__(xdma::TILE_THREADS)
out2_kernel(const typename P::In* __restrict__ src,
            typename P::Out* __restrict__ dst,
            const __grid_constant__ Rank2Args a) {
  __shared__ Stage2 sh[XS];
  if constexpr (BATCHED) {
    int64_t b;
    if (!lead_block(a, b)) return;
    const At at = lead_at(a, b);
    stages_to_shared(a, sh, at.flat);   // tile2_run syncs before any read
    xdma::tile2_run<Led<P>, VS, VD, DIRECT>(
        a.t, src + at.src, dst + at.dst,
        led(policy_of(a, sh, static_cast<P*>(nullptr)), at.code));
  } else {
    stages_to_shared(a, sh, 0);
    xdma::tile2_run<P, VS, VD, DIRECT>(
        a.t, src, dst, policy_of(a, sh, static_cast<P*>(nullptr)));
  }
}

template <class P, bool BATCHED>
struct Out2 {
  template <int VS, int VD, bool DIRECT>
  struct K {
    using Fn = void (*)(const typename P::In*, typename P::Out*,
                        const Rank2Args);
    static Fn fn() { return out2_kernel<P, VS, VD, DIRECT, BATCHED>; }
  };
};

// V values of pass-space row i from column j on (V > 1: one 16-byte pack;
// the host allows it only where the column term is a unit-stride run).
template <class P, typename T, int V>
__device__ __forceinline__ void row_values(const P& pol, const T* src,
                                           int64_t i, int64_t so_r,
                                           int64_t so_c, int64_t j,
                                           float (&v)[V]) {
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
  const int64_t n = a.t.cols;
  int64_t b;
  if (!lead_block(a, b)) return;
  const At at = lead_at(a, b);
  stages_to_shared(a, sh, at.flat);
  const auto pol = led(Values<T>{sh, (int)a.nstages}, at.code);
  __syncthreads();
  const T* x = src + at.src;
  float* out = reinterpret_cast<float*>(a.out) + at.flat * a.t.rows;
  for (int64_t i = blockIdx.x; i < a.t.rows; i += gridDim.x) {
    const int64_t so_r = xdma::term_off(a.t.src_r, i);
    float ss = 0.f;
    for (int64_t j = (int64_t)threadIdx.x * V; j < n;
         j += (int64_t)THREADS * V) {
      float v[V];
      row_values<Led<Values<T>>, T, V>(pol, x, i, so_r,
                                       xdma::term_off(a.t.src_c, j), j, v);
#pragma unroll
      for (int e = 0; e < V; ++e) ss += v[e] * v[e];
    }
    ss = xdma::block_sum(ss, scratch);
    if (threadIdx.x == 0) out[i] = rsqrtf(ss / (float)n + (float)a.eps);
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
mask2_kernel(const T* __restrict__ src, const __grid_constant__ Rank2Args a) {
  __shared__ Stage2 sh[XS];
  const int64_t packs = a.t.cols / V;
  const int64_t span = a.block_rows * packs;
  const int64_t nb = (int64_t)quo((uint64_t)a.t.rows, (uint64_t)a.block_rows);
  int64_t bz;
  if (!lead_block(a, bz)) return;
  const At at = lead_at(a, bz);
  stages_to_shared(a, sh, at.flat);
  const auto pol = led(Values<T>{sh, (int)a.nstages}, at.code);
  __syncthreads();
  const T* x = src + at.src;
  uint8_t* out = reinterpret_cast<uint8_t*>(a.out) + at.flat * nb;
  for (int64_t b = blockIdx.x; b < nb; b += gridDim.x) {
    int any = 0;
    for (int64_t k = threadIdx.x; k < span && !any; k += THREADS) {
      int64_t row, pack;
      xdma::divmod(k, packs, row, pack);
      const int64_t i = b * a.block_rows + row, j = pack * V;
      float v[V];
      row_values<Led<Values<T>>, T, V>(pol, x, i,
                                       xdma::term_off(a.t.src_r, i),
                                       xdma::term_off(a.t.src_c, j), j, v);
#pragma unroll
      for (int e = 0; e < V; ++e) any |= v[e] != 0.f;
    }
    any = __syncthreads_or(any);
    if (threadIdx.x == 0) out[b] = any ? 1 : 0;
  }
}

constexpr int SW = 64;       // REDUCE: columns per block
constexpr int UNROLL = 4;    // REDUCE: rows in flight a thread

// One REDUCE block's strip and row split of the slice at `at`.
template <typename T, int V>
__device__ __forceinline__ void reduce2_slice(const T* __restrict__ src,
                                              T* __restrict__ dst,
                                              const Rank2Args& a, const At& at,
                                              const Led<Values<T>>& pol) {
  constexpr int JL = SW / V, IL = THREADS / JL;   // lanes along j, along i
  __shared__ float part[IL][SW + 1];
  __shared__ int last;
  const int64_t m = a.t.rows, n = a.t.cols;
  const uint32_t splits = (uint32_t)a.splits;   // <= the blocks, < 2^31
  const int64_t strips = gridDim.x / splits;
  const int64_t strip = blockIdx.x / splits, split = blockIdx.x % splits;
  const int64_t j0 = strip * SW;
  const int tj = threadIdx.x % JL, ti = threadIdx.x / JL;
  const int64_t j = j0 + (int64_t)tj * V;
  const int64_t per = (int64_t)quo((uint64_t)(m + a.splits - 1),
                                   (uint64_t)a.splits);
  const int64_t i1 = (split + 1) * per < m ? (split + 1) * per : m;
  src += at.src;
  dst += at.dst;
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
      row_values<Led<Values<T>>, T, V>(
          pol, src, i, xdma::term_off(a.t.src_r, i), so_c, j, v);
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
    float* partial =
        reinterpret_cast<float*>(a.partial) + at.flat * a.splits * n;
    if (col < SW && c < n) partial[split * n + c] = tot;
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0)
      last = atomicAdd(reinterpret_cast<int*>(a.counter) + at.flat * strips +
                           strip,
                       1) == (int)a.splits - 1;
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

template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
reduce2_kernel(const T* __restrict__ src, T* __restrict__ dst,
               const __grid_constant__ Rank2Args a) {
  __shared__ Stage2 sh[XS];
  int64_t b;
  if (!lead_block(a, b)) return;
  const At at = lead_at(a, b);
  stages_to_shared(a, sh, at.flat);
  const auto pol = led(Values<T>{sh, (int)a.nstages}, at.code);
  __syncthreads();
  reduce2_slice<T, V>(src, dst, a, at, pol);
}

unsigned grid_for(int64_t work, int64_t per_block) {
  int64_t b = (work + per_block - 1) / per_block;
  if (b < 1) b = 1;
  if (b > (1LL << 20)) b = 1LL << 20;   // the kernels stride over the rest
  return (unsigned)b;
}

// The grid of a batched pass: `x` blocks a leading index, the leading
// indices over y and z (lead_block).
dim3 grid_of(unsigned x, const Rank2Args& a) {
  const int64_t y = a.batch < 65535 ? a.batch : 65535;
  return dim3(x, (unsigned)y, (unsigned)((a.batch + y - 1) / y));
}

// Whether every leading axis offsets a side by whole 16-byte packs where
// that side moves packs (the host checks it: maps.fit_to).
bool lead_aligned(const Rank2Args& a, int64_t size) {
  for (int d = 0; d < a.nlead; ++d) {
    const Lead2& l = a.lead[d];
    if (l.extent < 2) continue;
    const xdma::DimMap& s = l.src.map;
    if (a.t.vs > 1 && ((s.sgrid * size) % 16 ||
                       (s.tile > 1 && (s.stile * size) % 16)))
      return false;
    if (a.t.vd > 1 && ((l.dst.sgrid * size) % 16 ||
                       (l.dst.tile > 1 && (l.dst.stile * size) % 16)))
      return false;
  }
  return true;
}

template <typename T, int V>
int launch_rows(const Rank2Args& a, const void* src, void* dst, int64_t mode,
                cudaStream_t s) {
  const T* x = static_cast<const T*>(src);
  if (mode == 4) {
    stat2_kernel<T, V><<<grid_of(grid_for(a.t.rows, 1), a), THREADS, 0, s>>>(
        x, a);
  } else if (mode == 5) {
    mask2_kernel<T, V><<<grid_of(grid_for(a.t.rows / a.block_rows, 1), a),
                         THREADS, 0, s>>>(x, a);
  } else {
    const int64_t blocks = (a.t.pcols + SW - 1) / SW * a.splits;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    reduce2_kernel<T, V><<<grid_of((unsigned)blocks, a), THREADS, 0, s>>>(
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
  if (!xdma::tile2_aligned(a.t, src, dst) ||
      !lead_aligned(a, sizeof(typename P::In)))
    return (int)cudaErrorMisalignedAddress;
  auto fn = a.nlead ? xdma::tile2_pick<V, Out2<P, true>::template K>(a.t)
                    : xdma::tile2_pick<V, Out2<P, false>::template K>(a.t);
  fn<<<grid_of((unsigned)blocks, a), xdma::TILE_THREADS, 0, s>>>(
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
  if (packed && ((uintptr_t)src % 16 || !lead_aligned(a, sizeof(T))))
    return (int)cudaErrorMisalignedAddress;
  return packed ? launch_rows<T, V>(a, src, dst, mode, s)
                : launch_rows<T, 1>(a, src, dst, mode, s);
}

// A stream other than f32, bf16 and f16 (integers, bool, float8) on the
// rank-2 path only moves words (the host sends it there only then).
template <typename W>
int launch_rank2_words(const Rank2Args& a, bool copy, const void* src,
                       void* dst, int64_t mode, cudaStream_t s) {
  if (!copy || mode != 3) return (int)cudaErrorInvalidValue;
  return launch_out2<xdma::Copy<W>>(a, src, dst, s);
}

template <typename C, int SZ, typename I>
int launch_generic(const BlockArgs& a, const void* src, void* dst,
                   int64_t mode, cudaStream_t s) {
  if (mode == 0 && a.reduce_at < 0 && a.tiled) {
    if constexpr (sizeof(I) != 4) {   // the host tiles 32-bit launches only
      return (int)cudaErrorInvalidValue;
    } else {
      const int64_t ec = a.pext[a.nphys - 1], er = a.pext[a.nphys - 2];
      const int64_t tiles = a.total / (er * ec) * ((er + TT - 1) / TT) *
                            ((ec + TT - 1) / TT);
      out_tiled_kernel<C, SZ, I><<<grid_for(tiles, 1), dim3(TT, TY), 0, s>>>(
          src, dst, a);
    }
  } else if (mode == 0 && a.reduce_at < 0) {
    const int64_t groups = a.total / a.per_thread;
    out_kernel<C, SZ, I><<<grid_for(groups, THREADS), THREADS, 0, s>>>(
        src, dst, a);
  } else if (mode == 0) {
    constexpr int rx = ReduceBlock<C>::RX, ry = ReduceBlock<C>::RY;
    out_reduce_kernel<C, SZ, I><<<grid_for(a.total, rx), dim3(rx, ry), 0, s>>>(
        src, dst, a);
  } else if (mode == 1) {
    stat_kernel<C, SZ, I><<<grid_for(a.total, 1), THREADS, 0, s>>>(src, a);
  } else if (mode == 2) {
    mask_kernel<C, SZ, I><<<grid_for(a.total, 1), THREADS, 0, s>>>(src, a);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The instance for the source's element size and the index width.
template <typename C>
int launch_generic_for(const BlockArgs& a, const void* src, void* dst,
                       int64_t mode, cudaStream_t s) {
  const int size = xdma::elem_size(a.in_dtype);
  if (a.index32) {
    switch (size) {
      case 1: return launch_generic<C, 1, uint32_t>(a, src, dst, mode, s);
      case 2: return launch_generic<C, 2, uint32_t>(a, src, dst, mode, s);
      case 4: return launch_generic<C, 4, uint32_t>(a, src, dst, mode, s);
      default: return launch_generic<C, 8, uint32_t>(a, src, dst, mode, s);
    }
  }
  switch (size) {
    case 1: return launch_generic<C, 1, uint64_t>(a, src, dst, mode, s);
    case 2: return launch_generic<C, 2, uint64_t>(a, src, dst, mode, s);
    case 4: return launch_generic<C, 4, uint64_t>(a, src, dst, mode, s);
    default: return launch_generic<C, 8, uint64_t>(a, src, dst, mode, s);
  }
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
    if (r.nstages > XS || r.nlead > XR - 2) return (int)cudaErrorInvalidValue;
    if (r.t.rows == 0 || r.t.cols == 0 || r.batch == 0) return 0;
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
      case xdma::BOOL:
      case xdma::F8E4M3:
      case xdma::F8E5M2:
        return launch_rank2_words<uint8_t>(r, copy, src, dst, m, s);
      case xdma::I16:
      case xdma::U16:
        return launch_rank2_words<uint16_t>(r, copy, src, dst, m, s);
      case xdma::I32:
      case xdma::U32:
        return launch_rank2_words<uint32_t>(r, copy, src, dst, m, s);
      case xdma::I64:
        return launch_rank2_words<uint64_t>(r, copy, src, dst, m, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  const BlockArgs& a = *static_cast<const BlockArgs*>(args);
  const int64_t most = PER_THREAD;
  if (a.nstages > XS || a.nlead > XR - 2 ||
      (mode == 0 && (a.nphys > XP || a.nphys < 1 || a.per_thread < 1 ||
                     a.per_thread > most || (a.tiled && a.nphys < 2))))
    return (int)cudaErrorInvalidValue;
  if (a.total == 0) return 0;
  if (mode == 0 && a.per_thread == most) {   // one pack a thread
    const int64_t size = xdma::elem_size(a.out_dtype);
    if ((uintptr_t)dst % (most * size)) return (int)cudaErrorMisalignedAddress;
  }
  return a.carrier ? launch_generic_for<long long>(a, src, dst, mode, s)
                   : launch_generic_for<float>(a, src, dst, mode, s);
}
