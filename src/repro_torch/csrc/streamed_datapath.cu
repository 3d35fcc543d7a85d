// Kernel 2: the streamed plugin datapath.
//
// Replaces the reference's TPU kernel src/repro/core/plugin_compiler.py:236,
// _compile_streamed (:209): a row-burst fused pass, reader to_logical ->
// chain of streaming plugins (Identity, Cast, Scale, BiasAdd, RMSNormPlugin
// with an optional weight) -> writer from_logical.
//
// Bound: device-memory bytes.  One read and one write per element, plus the
// constant vectors (which stay in L2); a few operations per element.  At the
// Prefill store (8192 x 3072 bf16) that is 96 MiB, about 30 us at 3.35 TB/s.
//
// One binary serves every chain.  The host compiles the chain into a short
// op list (cast to f32/bf16/f16, scale, bias, rmsnorm) with its constants
// already rounded to the stream dtype, as jnp's rules require.  Each op
// rounds to the stream dtype after it, to nearest even; an RMSNorm sums the
// squares of its input row in f32, in a fixed order.  The host picks one of
// two paths from the geometry and names it in StreamArgs.path; the entry
// point launches that path and refuses one that does not fit the arguments.
//
// The rows path: both sides run along the columns in whole, aligned 16-byte
// packs.  A chunk of C columns is one or two packs on each side (C is the
// wider side's pack) and never straddles a tile, since the tile widths
// (powers of two) and the strides are multiples of C; so a side's row
// offset is computed once a row and its column offset once a chunk.  A group of tpr threads owns a row,
// the fewest (32, 64, 128) whose registers hold the whole row, else 256 (as
// kernel 4 picks its group).  Each thread issues the loads of its first
// CACHE chunks before any arithmetic and keeps them in registers as loaded
// (96 bytes: at the Prefill store two warps a row, 6 chunks a thread), so an
// RMSNorm costs one group reduction (shuffles; for tpr > 32 one pass through
// shared memory) and no re-read.  The chain runs on each chunk from the
// loaded values, so a list with several RMSNorms recomputes the ops before
// each one from the registers.  Chunks past the cache (rows wider than
// 256 * CACHE chunks) are re-read from device memory for each RMSNorm and
// for the store.  Constant vectors are read as 16-byte f32 packs.
//
// What the build log showed (nvcc -Xptxas -v, registers and spills a
// kernel) shaped the code: the op list runs in one loop body shared by the
// phases, in one arithmetic form for every op, so the kernel stays a few
// thousand instructions; the cached words are re-widened in each phase, and
// the chunk offsets recomputed, instead of being kept alive across it.
//
// The generic path takes the rest: a side that runs along the rows (NM), or
// a width, stride or base address that is not a whole number of aligned
// packs.  A block of 256 threads owns a row and walks it one element at a
// time through the layout maps.  A row of up to STAGE_FLOATS columns is
// staged in shared memory as f32, after the ops applied so far; a wider row
// is re-read from the source for each RMSNorm, recomputing the ops before it.
//
// On both paths the destination's stride-padding columns get zeros.
#include "xdma_common.cuh"

namespace {

constexpr int MAX_OPS = 8;
constexpr int THREADS = 256;
constexpr int CACHE_BYTES = 96;      // source bytes a rows-path thread keeps
constexpr int64_t STAGE_FLOATS = 11264;   // widest row the generic path
                                          // stages (44 KiB of shared memory)

enum OpCode : int64_t { OP_CAST = 1, OP_SCALE = 2, OP_BIAS = 3, OP_RMSNORM = 4 };
enum PathCode : int64_t { PATH_ROWS = 0, PATH_GENERIC = 1 };

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
  int64_t path;         // PATH_ROWS or PATH_GENERIC, picked by the host
};

// An op as the kernels read it, from shared memory, in one form for every
// code: y = round((x * mul) * weight + add), where mul is a Scale's constant
// (or the row's inverse RMS for an RMSNorm), weight an RMSNorm's weight and
// add a BiasAdd's constant, each a scalar or an f32 vector over the columns.
// The unused ones are 1 and -0, exact identities (x * 1 = x, x + -0 = x for
// every x, -0 included), so each op computes what its own formula does.
struct SOp {
  const float* vmul;     // vector multiplier, or null: `mul`
  const float* vweight;  // vector weight, or null: 1
  const float* vadd;     // vector addend, or null: `add`
  float mul, add, eps;
  int norm;              // 1: multiply by the row's inverse RMS
  int dtype;             // stream dtype after the op
};

__device__ __forceinline__ void load_ops(const StreamArgs& a, SOp* ops) {
  if (threadIdx.x < a.nops) {
    const Op& o = a.ops[threadIdx.x];
    const float* vec = reinterpret_cast<const float*>(o.vec);
    SOp s = {nullptr, nullptr, nullptr, 1.f, -0.f, 0.f, 0, (int)o.dtype};
    if (o.code == OP_SCALE) {
      s.vmul = vec;
      s.mul = (float)o.a;
    } else if (o.code == OP_BIAS) {
      s.vadd = vec;
      s.add = (float)o.a;
    } else if (o.code == OP_RMSNORM) {
      s.vweight = vec;
      s.eps = (float)o.a;
      s.norm = 1;
    }
    ops[threadIdx.x] = s;
  }
  __syncthreads();
}

// N values of a constant from column j: its vector, read as one 16-byte f32
// pack when N is 4 (the rows path, where j is a multiple of 4), or the
// scalar s.
template <int N>
__device__ __forceinline__ void operand(const float* vec, float s, int64_t j,
                                        float (&c)[N]) {
  if (vec == nullptr) {
#pragma unroll
    for (int e = 0; e < N; ++e) c[e] = s;
  } else if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(vec + j) + q);
      c[4 * q] = f.x;
      c[4 * q + 1] = f.y;
      c[4 * q + 2] = f.z;
      c[4 * q + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) c[e] = __ldg(vec + j + e);
  }
}

// Ops [from, to) on the N stream values of columns j .. j + N - 1; RMSNorm k
// scales by inv[k].  __fmul_rn and __fadd_rn keep the compiler from
// contracting a product and a sum into one fused multiply-add: each op
// rounds on its own, as the plain version's does.
template <int N>
__device__ __forceinline__ void run_ops(const SOp* ops, const float* inv,
                                        int from, int to, int64_t j,
                                        float (&v)[N]) {
  constexpr int G = N % 4 == 0 ? 4 : N;    // operands read G at a time
  for (int k = from; k < to; ++k) {
    const SOp& op = ops[k];
    const float s = op.norm ? inv[k] : op.mul;
#pragma unroll
    for (int q = 0; q < N; q += G) {
      float mul[G], weight[G], add[G];
      operand<G>(op.vmul, s, j + q, mul);
      operand<G>(op.vweight, 1.f, j + q, weight);
      operand<G>(op.vadd, op.add, j + q, add);
#pragma unroll
      for (int e = 0; e < G; ++e)
        v[q + e] = __fadd_rn(__fmul_rn(__fmul_rn(v[q + e], mul[e]), weight[e]),
                             add[e]);
    }
    if (op.dtype == xdma::BF16) {
#pragma unroll
      for (int e = 0; e < N; ++e)
        v[e] = __bfloat162float(__float2bfloat16_rn(v[e]));
    } else if (op.dtype == xdma::F16) {
#pragma unroll
      for (int e = 0; e < N; ++e) v[e] = __half2float(__float2half_rn(v[e]));
    }
  }
}

// The first RMSNorm of ops [k, nops), or nops.
__device__ __forceinline__ int next_norm(const SOp* ops, int k, int nops) {
  while (k < nops && !ops[k].norm) ++k;
  return k;
}

// -- the rows path ------------------------------------------------------------
// One 32-bit word of N elements (element 0 in the low bits): its f32
// values, and the word of N f32 values rounded to nearest even.  Packing in
// registers keeps a 16-byte pack out of local memory.
template <typename T>
struct Words;
template <>
struct Words<float> {
  static constexpr int N = 1;
  static __device__ __forceinline__ void f32(uint32_t w, float* v) {
    v[0] = __uint_as_float(w);
  }
  static __device__ __forceinline__ uint32_t word(const float* v) {
    return __float_as_uint(v[0]);
  }
};
template <>
struct Words<__nv_bfloat16> {
  static constexpr int N = 2;
  static __device__ __forceinline__ void f32(uint32_t w, float* v) {
    v[0] = __uint_as_float(w << 16);
    v[1] = __uint_as_float(w & 0xffff0000u);
  }
  static __device__ __forceinline__ uint32_t word(const float* v) {
    return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[0])) |
           (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[1])) << 16;
  }
};
template <>
struct Words<__half> {
  static constexpr int N = 2;
  static __device__ __forceinline__ void f32(uint32_t w, float* v) {
    v[0] = __half2float(__ushort_as_half((unsigned short)(w & 0xffffu)));
    v[1] = __half2float(__ushort_as_half((unsigned short)(w >> 16)));
  }
  static __device__ __forceinline__ uint32_t word(const float* v) {
    return (uint32_t)__half_as_ushort(__float2half_rn(v[0])) |
           (uint32_t)__half_as_ushort(__float2half_rn(v[1])) << 16;
  }
};

// An empty asm that claims to rewrite the words: the compiler then keeps
// the cache as loaded and widens it again in each phase, instead of keeping
// the widened values of a 2-byte row alive across the reduction (twice the
// registers, which spilled).
__device__ __forceinline__ void launder(uint4& p) {
  asm volatile("" : "+r"(p.x), "+r"(p.y), "+r"(p.z), "+r"(p.w));
}

// The offset of column j of a rows-path side: its column map is untiled
// with unit stride, or a power-of-two tile with unit tile stride
// (launch_rows checks), so a shift and a mask and no division.
__device__ __forceinline__ int64_t col_offset(const xdma::DimMap& m,
                                              int64_t j) {
  if (m.tile == 1) return j;
  const int sh = __ffsll((unsigned long long)m.tile) - 1;
  return (j >> sh) * m.sgrid + (j & (m.tile - 1));
}

template <typename Tin, typename Tout>
struct Rows {
  static constexpr int VS = 16 / sizeof(Tin), VD = 16 / sizeof(Tout);
  static constexpr int C = VS > VD ? VS : VD;     // columns a chunk
  static constexpr int NS = C / VS, ND = C / VD;  // 16-byte packs a chunk
  static constexpr int CACHE = CACHE_BYTES / (C * (int)sizeof(Tin));
};

// The sum of v over each group of tpr consecutive threads, tpr a power of
// two from 32 to THREADS and the same for the whole block.
__device__ __forceinline__ float row_sum(float v, float* scratch, int tpr) {
  switch (tpr) {
    case 32: return xdma::group_reduce<32>(v, scratch, xdma::SumOp());
    case 64: return xdma::group_reduce<64>(v, scratch, xdma::SumOp());
    case 128: return xdma::group_reduce<128>(v, scratch, xdma::SumOp());
    default: return xdma::group_reduce<THREADS>(v, scratch, xdma::SumOp());
  }
}

// At least three blocks an SM (up to 80 registers a thread): without the
// bound ptxas trims some instances to 64 registers and spills.
template <typename Tin, typename Tout>
__global__ void __launch_bounds__(THREADS, 3)
streamed_rows_kernel(const Tin* __restrict__ src, Tout* __restrict__ dst,
                     const __grid_constant__ StreamArgs a, int tpr) {
  using R = Rows<Tin, Tout>;
  constexpr int C = R::C, NS = R::NS, ND = R::ND, CACHE = R::CACHE;
  using W = Words<Tin>;
  using WO = Words<Tout>;
  __shared__ SOp ops[MAX_OPS];
  __shared__ float inv[THREADS / 32][MAX_OPS];
  __shared__ float scratch[THREADS / 32];
  load_ops(a, ops);
  const int g = threadIdx.x / tpr, t = threadIdx.x % tpr;
  const int64_t row = (int64_t)blockIdx.x * (THREADS / tpr) + g;
  const bool live = row < a.rows;
  const int nops = (int)a.nops;
  const int64_t nchunks = a.cols / C, pchunks = a.pcols / C;
  const Tin* srow = src + (live ? xdma::dim_offset(a.src[0], row) : 0);
  Tout* drow = dst + (live ? xdma::dim_offset(a.dst[0], row) : 0);

  // Bytes that cross once (the cached chunks, the stores) carry the
  // streaming hint, evict first (ld/st.global.cs); re-read chunks do not.
  auto load = [&](int64_t q, uint4 (&p)[NS], bool once) {
    const uint4* s =
        reinterpret_cast<const uint4*>(srow + col_offset(a.src[1], q * C));
#pragma unroll
    for (int u = 0; u < NS; ++u) p[u] = once ? __ldcs(s + u) : s[u];
  };
  auto values = [&](const uint4 (&p)[NS], float (&v)[C]) {
#pragma unroll
    for (int u = 0; u < NS; ++u) {
      float* o = v + u * R::VS;
      W::f32(p[u].x, o);
      W::f32(p[u].y, o + W::N);
      W::f32(p[u].z, o + 2 * W::N);
      W::f32(p[u].w, o + 3 * W::N);
    }
  };
  auto store = [&](int64_t q, const float (&v)[C]) {
    uint4* d = reinterpret_cast<uint4*>(drow + col_offset(a.dst[1], q * C));
#pragma unroll
    for (int u = 0; u < ND; ++u) {
      const float* o = v + u * R::VD;
      __stcs(d + u, make_uint4(WO::word(o), WO::word(o + WO::N),
                               WO::word(o + 2 * WO::N),
                               WO::word(o + 3 * WO::N)));
    }
  };

  // Thread t's chunks are t + tpr * m: the first CACHE stay in registers.
  uint4 cache[CACHE][NS];
#pragma unroll
  for (int m = 0; m < CACHE; ++m) {
    const int64_t q = t + (int64_t)tpr * m;
    if (live && q < nchunks) load(q, cache[m], true);
  }
  // One phase for each RMSNorm k (its sum of squares) and one for the store
  // (k == nops): ops [0, k) on each of the thread's chunks in order, the
  // cached ones from the registers, then the rest re-read one at a time.
  // One copy of this code serves every phase.
  for (int k = next_norm(ops, 0, nops);; k = next_norm(ops, k + 1, nops)) {
    const bool storing = k == nops;
    float ss = 0.f;
    // t again, as far as the compiler knows: it then computes each chunk's
    // offsets in the phase that uses them instead of keeping them all in
    // registers across the phases
    int tp = t;
    asm volatile("" : "+r"(tp));
    auto each = [&](int64_t q, float (&v)[C]) {
      run_ops<C>(ops, inv[g], 0, k, q * C, v);
      if (storing) {
        store(q, v);
      } else {
#pragma unroll
        for (int e = 0; e < C; ++e) ss = __fmaf_rn(v[e], v[e], ss);
      }
    };
#pragma unroll
    for (int m = 0; m < CACHE; ++m) {
      const int64_t q = tp + (int64_t)tpr * m;
      if (live && q < nchunks) {
        float v[C];
        values(cache[m], v);
        each(q, v);
      }
    }
    for (int64_t q = tp + (int64_t)tpr * CACHE; live && q < nchunks;
         q += tpr) {
      uint4 p[NS];
      float v[C];
      load(q, p, false);
      values(p, v);
      each(q, v);
    }
    if (storing) break;
    ss = row_sum(ss, scratch, tpr);
    if (t == 0) inv[g][k] = rsqrtf(ss / (float)a.cols + ops[k].eps);
    __syncthreads();
#pragma unroll
    for (int m = 0; m < CACHE; ++m)
#pragma unroll
      for (int u = 0; u < NS; ++u) launder(cache[m][u]);
  }
  for (int64_t q = nchunks + t; live && q < pchunks; q += tpr) {
    const float zero[C] = {};
    store(q, zero);
  }
}

template <int C>
bool packs_fit(const xdma::DimMap& r, const xdma::DimMap& c) {
  const bool run = c.tile == 1 ? c.sgrid == 1
                               : c.stile == 1 && c.tile % C == 0 &&
                                     (c.tile & (c.tile - 1)) == 0 &&
                                     c.sgrid % C == 0;
  return run && r.sgrid % C == 0 && (r.tile == 1 || r.stile % C == 0);
}

inline bool aligned(uintptr_t p) { return p % 16 == 0; }

template <typename Tin, typename Tout>
int launch_rows(const StreamArgs& a, const void* src, void* dst,
                cudaStream_t s) {
  using R = Rows<Tin, Tout>;
  bool fit = a.cols % R::C == 0 && a.pcols % R::C == 0 &&
             aligned((uintptr_t)src) && aligned((uintptr_t)dst) &&
             packs_fit<R::C>(a.src[0], a.src[1]) &&
             packs_fit<R::C>(a.dst[0], a.dst[1]);
  for (int k = 0; k < a.nops; ++k) fit = fit && aligned(a.ops[k].vec);
  if (!fit) return (int)cudaErrorInvalidValue;
  // threads a row: the fewest of 32, 64, 128 that cache the whole row, else
  // THREADS (which re-read the rest)
  const int64_t nchunks = a.cols / R::C;
  int tpr = 32;
  while (tpr < THREADS && nchunks > (int64_t)tpr * R::CACHE) tpr *= 2;
  const int64_t blocks = (a.rows + THREADS / tpr - 1) / (THREADS / tpr);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  streamed_rows_kernel<Tin, Tout><<<(unsigned)blocks, THREADS, 0, s>>>(
      static_cast<const Tin*>(src), static_cast<Tout*>(dst), a, tpr);
  return (int)cudaGetLastError();
}

// -- the generic path ---------------------------------------------------------
template <typename Tin, typename Tout, bool STAGED>
__global__ void __launch_bounds__(THREADS)
streamed_generic_kernel(const Tin* __restrict__ src, Tout* __restrict__ dst,
                        const __grid_constant__ StreamArgs a) {
  extern __shared__ float row[];     // STAGED: the row after `done` ops
  __shared__ SOp ops[MAX_OPS];
  __shared__ float inv[MAX_OPS];
  __shared__ float scratch[33];
  load_ops(a, ops);
  const int64_t i = blockIdx.x;
  const int64_t srow = xdma::dim_offset(a.src[0], i);
  const int64_t drow = xdma::dim_offset(a.dst[0], i);
  const int nops = (int)a.nops;
  auto load = [&](int64_t j) {
    return xdma::to_f32<Tin>(src[srow + xdma::dim_offset(a.src[1], j)]);
  };

  int done = 0;
  if constexpr (STAGED)
    for (int64_t j = threadIdx.x; j < a.cols; j += THREADS) row[j] = load(j);
  for (int k = next_norm(ops, 0, nops); k < nops;
       k = next_norm(ops, k + 1, nops)) {
    float ss = 0.f;
    for (int64_t j = threadIdx.x; j < a.cols; j += THREADS) {
      float v[1] = {STAGED ? row[j] : load(j)};
      run_ops<1>(ops, inv, done, k, j, v);
      if constexpr (STAGED) row[j] = v[0];
      ss = __fmaf_rn(v[0], v[0], ss);
    }
    if constexpr (STAGED) done = k;
    ss = xdma::block_sum(ss, scratch);
    if (threadIdx.x == 0) inv[k] = rsqrtf(ss / (float)a.cols + ops[k].eps);
    __syncthreads();
  }
  for (int64_t j = threadIdx.x; j < a.pcols; j += THREADS) {
    float v[1] = {0.f};
    if (j < a.cols) {
      v[0] = STAGED ? row[j] : load(j);
      run_ops<1>(ops, inv, done, nops, j, v);
    }
    dst[drow + xdma::dim_offset(a.dst[1], j)] = xdma::from_f32<Tout>(v[0]);
  }
}

template <typename Tin, typename Tout>
int launch_generic(const StreamArgs& a, const void* src, void* dst,
                   cudaStream_t s) {
  if (a.rows > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const Tin* x = static_cast<const Tin*>(src);
  Tout* y = static_cast<Tout*>(dst);
  if (a.cols <= STAGE_FLOATS)
    streamed_generic_kernel<Tin, Tout, true>
        <<<(unsigned)a.rows, THREADS, a.cols * sizeof(float), s>>>(x, y, a);
  else
    streamed_generic_kernel<Tin, Tout, false>
        <<<(unsigned)a.rows, THREADS, 0, s>>>(x, y, a);
  return (int)cudaGetLastError();
}

template <typename Tin, typename Tout>
int launch(const StreamArgs& a, const void* src, void* dst, cudaStream_t s) {
  if (a.rows == 0) return 0;
  switch (a.path) {
    case PATH_ROWS: return launch_rows<Tin, Tout>(a, src, dst, s);
    case PATH_GENERIC: return launch_generic<Tin, Tout>(a, src, dst, s);
    default: return (int)cudaErrorInvalidValue;
  }
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
  if (a.nops < 0 || a.nops > MAX_OPS) return (int)cudaErrorInvalidValue;
  switch (a.in_dtype) {
    case xdma::F32: return dispatch_out<float>(a, src, dst, s);
    case xdma::BF16: return dispatch_out<__nv_bfloat16>(a, src, dst, s);
    case xdma::F16: return dispatch_out<__half>(a, src, dst, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
