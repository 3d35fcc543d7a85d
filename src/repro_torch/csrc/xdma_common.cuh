// Shared device helpers for the port's XDMA kernels: dtype codes, rounding
// to the stream dtype, and the per-logical-dim layout map.
//
// A Layout (tile, perm, pad) maps a logical coordinate to a physical element
// offset dimension by dimension: logical dim d with tile t contributes
// (i / t) * sgrid + (i % t) * stile, where sgrid and stile are the row-major
// strides of its grid and tile physical dims after the permutation (an
// untiled dim has t = 1 and only sgrid).  The host computes the strides from
// the layout and the logical shape (repro_torch/kernels/maps.py).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>

namespace xdma {

// dtype codes, shared with repro_torch/kernels/maps.py; the codes from I8
// on are kernel 3's only
constexpr int64_t F32 = 0;
constexpr int64_t BF16 = 1;
constexpr int64_t F16 = 2;
constexpr int64_t I8 = 3;
constexpr int64_t U8 = 4;
constexpr int64_t I16 = 5;
constexpr int64_t I32 = 6;
constexpr int64_t I64 = 7;
constexpr int64_t BOOL = 8;
constexpr int64_t U16 = 9;
constexpr int64_t U32 = 10;
constexpr int64_t F8E4M3 = 11;   // float8_e4m3fn
constexpr int64_t F8E5M2 = 12;   // float8_e5m2

// Bytes of an element of a dtype code.
__host__ __device__ __forceinline__ int elem_size(int64_t dt) {
  switch (dt) {
    case F32: case I32: case U32: return 4;
    case BF16: case F16: case I16: case U16: return 2;
    case I64: return 8;
    default: return 1;
  }
}

struct DimMap {
  int64_t tile;   // tile factor of the logical dim (1 when untiled)
  int64_t sgrid;  // stride of i / tile
  int64_t stile;  // stride of i % tile
};

// (q, r) = divmod(n, d) for n >= 0, d > 0; 32-bit arithmetic when both fit.
__device__ __forceinline__ void divmod(int64_t n, int64_t d, int64_t& q,
                                       int64_t& r) {
  if ((((uint64_t)n | (uint64_t)d) >> 32) == 0) {
    uint32_t a = (uint32_t)n, b = (uint32_t)d;
    uint32_t qq = a / b;
    q = qq;
    r = a - qq * b;
  } else {
    q = n / d;
    r = n - q * d;
  }
}

__device__ __forceinline__ int64_t dim_offset(const DimMap& m, int64_t i) {
  if (m.tile == 1) return i * m.sgrid;
  if ((m.tile & (m.tile - 1)) == 0) {  // power of two: shift and mask
    int sh = __ffsll((unsigned long long)m.tile) - 1;
    return (i >> sh) * m.sgrid + (i & (m.tile - 1)) * m.stile;
  }
  int64_t q, r;
  divmod(i, m.tile, q, r);
  return q * m.sgrid + r * m.stile;
}

// Round an f32 value to the stream dtype, to nearest even, and back.
__device__ __forceinline__ float round_to(float v, int64_t dt) {
  if (dt == BF16) return __bfloat162float(__float2bfloat16_rn(v));
  if (dt == F16) return __half2float(__float2half_rn(v));
  return v;
}

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <>
__device__ __forceinline__ float to_f32<__half>(__half v) {
  return __half2float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

// Deterministic block-wide sum: per-warp shuffle tree, then warp 0 sums the
// warp partials in order.  Every thread gets the result.  blockDim.x must be
// a multiple of 32; `scratch` holds at least 33 floats.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float s = lane < nwarps ? scratch[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) scratch[32] = s;
  }
  __syncthreads();
  return scratch[32];
}

// V consecutive elements of T moved as one access: one 16-byte load or store
// when V * sizeof(T) == 16 and the address is 16-byte aligned.
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// Sum or max over groups of G consecutive threads (G a power of two, from 32
// up to blockDim.x): a shuffle tree in each warp, then the group's warp
// partials combined in order, so the result is deterministic.  Every thread
// gets its group's result.  For G > 32 every thread of the block must call
// it; `scratch` holds blockDim.x / 32 floats.
struct SumOp {
  __device__ __forceinline__ float operator()(float a, float b) const {
    return a + b;
  }
};
// max that propagates NaN (as a canonical NaN), as jnp.max does; fmaxf
// drops it.  One instruction on sm_80 and later.
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
struct MaxOp {
  __device__ __forceinline__ float operator()(float a, float b) const {
    return max_nan(a, b);
  }
};

template <int G, typename Op>
__device__ __forceinline__ float group_reduce(float v, float* scratch, Op op) {
  static_assert(G >= 32 && (G & (G - 1)) == 0, "G: a power of two >= 32");
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (G == 32) return v;
  const int warp = threadIdx.x >> 5;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) scratch[warp] = v;
  __syncthreads();
  const int first = warp & ~(G / 32 - 1);
  float r = scratch[first];
  for (int w = 1; w < G / 32; ++w) r = op(r, scratch[first + w]);
  return r;
}

// -- the rank-2 tiled copy (kernel 1; kernel 3's rank-2 path) ---------------
//
// A block owns a TILE x TILE tile of the destination's padded logical space.
// Both sides' element offsets are separable, a row term plus a column term,
// so the block computes the tile's 4 x TILE terms once into shared memory
// and no element pays a layout map.  Loads run along the tile axis whose
// source term has unit stride, stores along the one whose destination term
// has; where the run, the strides, the extent and the pointer allow, an
// access moves one 16-byte pack (the host decides).  When loads and stores
// run along the same axis with the same width, a thread stores what it
// loaded; otherwise the tile is staged through shared memory, with a pitch
// of TILE + 1 that keeps 4-byte words free of bank conflicts in both phases
// (2-byte words: TILE + 2, read back in pairs).  Positions in the
// destination's stride padding get zeros.

struct Term {          // one tile axis's share of one side's element offset
  DimMap map;          // the layout map of the logical axis it indexes
  int64_t idx;         // int64 index vector over the tile axis (a gather), or
                       // 0; an entry < 0 is a fill code -(g + 1)
};

struct Tile2 {
  int64_t rows, cols;     // destination logical extent (the pass's space)
  int64_t prows, pcols;   // with the destination's stride padding
  Term src_r, src_c;      // source offset of (r, c) = src_r(r) + src_c(c)
  DimMap dst_r, dst_c;    // destination offset = dst_r(r) + dst_c(c)
  int64_t load_axis;      // tile axis the loads run along: 0 rows, 1 columns
  int64_t store_axis;     // tile axis the stores run along
  int64_t vs, vd;         // elements per load / store: 1 or a 16-byte pack
};

constexpr int TILE = 64;
constexpr int TILE_THREADS = 256;   // 4 * TILE: one thread per term

__device__ __forceinline__ int64_t term_off(const Term& t, int64_t i) {
  if (t.idx) {
    const int64_t j = reinterpret_cast<const int64_t*>(t.idx)[i];
    return j < 0 ? j : dim_offset(t.map, j);
  }
  return dim_offset(t.map, i);
}

// The sum of two terms, or the fill code of the later failed gather.
__device__ __forceinline__ int64_t join(int64_t a, int64_t b) {
  return (a < 0 || b < 0) ? (a < b ? a : b) : a + b;
}

struct TileOffsets {
  int64_t sr[TILE], sc[TILE], dr[TILE], dc[TILE];
};

// Work item `it` of a phase whose accesses are V elements wide: the line
// (position across the run) and the pack (position along it, in packs).  A
// warp covers G lines by 32 / G packs: with 16-byte packs a 128-byte run of
// each line (G = 4; more lines where a line is shorter), with words 32
// consecutive elements of one line.
template <int V>
__device__ __forceinline__ void item_pos(int it, int& line, int& pack) {
  constexpr int G = V == 1 ? 1 : (32 * V / TILE > 4 ? 32 * V / TILE : 4);
  constexpr int PW = 32 / G, PB = TILE / V / PW;
  const int lane = it & 31, w = it >> 5;
  line = (w / PB) * G + lane % G;
  pack = (w % PB) * PW + lane / G;
}

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> load_pack(const T* p) {
  return *reinterpret_cast<const Pack<T, V>*>(p);
}

template <typename T, int V>
__device__ __forceinline__ void store_pack(T* p, const Pack<T, V>& v) {
  *reinterpret_cast<Pack<T, V>*>(p) = v;
}

// A policy P gives the staged type S and turns one item, V loaded elements
// (or a fill code < 0) that start at destination coordinate (r, c) and run
// along the columns (along_c) or the rows, into V staged values, and a
// staged value into the stored type:
//   void values<V>(Pack<In, V>, code, r, c, along_c, S (&)[V]);
//   Out store(S); Out zero().
// Copy moves words unchanged (bitwise for any dtype); its fill is a word.
template <typename W>
struct Copy {
  using In = W;
  using S = W;
  using Out = W;
  W fill_bits;
  template <int V>
  __device__ __forceinline__ void values(const Pack<W, V>& x, int code,
                                         int64_t, int64_t, bool,
                                         W (&out)[V]) const {
#pragma unroll
    for (int e = 0; e < V; ++e) out[e] = code < 0 ? fill_bits : x.v[e];
  }
  __device__ __forceinline__ W store(W x) const { return x; }
  __device__ __forceinline__ W zero() const { return W(0); }
};

// floor(i / d) for i >= 0, d > 0: a shift for a power of two, else 32-bit
// arithmetic where it fits.
__device__ __forceinline__ int64_t div_floor(int64_t i, int64_t d) {
  if ((d & (d - 1)) == 0) return i >> (__ffsll((unsigned long long)d) - 1);
  int64_t q, r;
  divmod(i, d, q, r);
  return q;
}

// Loads of one item: its pack, or the item's state in `code` (1: outside
// the logical extent, < 0: a fill code, 0: loaded).
template <class P, int V>
__device__ __forceinline__ void load_item(const Tile2& g,
                                          const TileOffsets& o,
                                          const typename P::In* src,
                                          int64_t r0, int64_t c0, int r, int c,
                                          Pack<typename P::In, V>& buf,
                                          int& code) {
  code = 1;
  if (r0 + r < g.rows && c0 + c < g.cols) {
    const int64_t off = join(o.sr[r], o.sc[c]);
    code = off < 0 ? (int)off : 0;
    if (off >= 0) buf = load_pack<typename P::In, V>(src + off);
  }
}

template <class P, int V>
__device__ __forceinline__ void tile2_direct(const Tile2& g,
                                             const TileOffsets& o,
                                             const typename P::In* src,
                                             typename P::Out* dst,
                                             const P& pol, int64_t r0,
                                             int64_t c0) {
  constexpr int ITEMS = TILE * TILE / V / TILE_THREADS;
  const bool along_c = g.load_axis == 1;
  Pack<typename P::In, V> buf[ITEMS];
  int code[ITEMS];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    int line, pack;
    item_pos<V>(threadIdx.x + k * TILE_THREADS, line, pack);
    const int r = along_c ? line : pack * V, c = along_c ? pack * V : line;
    load_item<P, V>(g, o, src, r0, c0, r, c, buf[k], code[k]);
  }
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    int line, pack;
    item_pos<V>(threadIdx.x + k * TILE_THREADS, line, pack);
    const int r = along_c ? line : pack * V, c = along_c ? pack * V : line;
    if (r0 + r >= g.prows || c0 + c >= g.pcols) continue;
    Pack<typename P::Out, V> out;
    if (code[k] == 1) {
#pragma unroll
      for (int e = 0; e < V; ++e) out.v[e] = pol.zero();
    } else {
      typename P::S v[V];
      pol.template values<V>(buf[k], code[k], r0 + r, c0 + c, along_c, v);
#pragma unroll
      for (int e = 0; e < V; ++e) out.v[e] = pol.store(v[e]);
    }
    store_pack<typename P::Out, V>(dst + o.dr[r] + o.dc[c], out);
  }
}

// The staged tile's pitch: TILE + 1 words, or for 2-byte words TILE + 2,
// so that two neighbours along a row are one aligned 4-byte word.
template <typename S>
constexpr int TILE_PITCH = sizeof(S) == 2 ? TILE + 2 : TILE + 1;

template <class P, int VS, int VD>
__device__ __forceinline__ void tile2_staged(
    const Tile2& g, const TileOffsets& o, const typename P::In* src,
    typename P::Out* dst, const P& pol, int64_t r0, int64_t c0,
    typename P::S (*tile)[TILE_PITCH<typename P::S>]) {
  using S = typename P::S;
  // 2-byte words stored along the tile's rows leave it as 4-byte pairs
  constexpr bool PAIRS = sizeof(S) == 2 && VD % 2 == 0 &&
                         sizeof(typename P::Out) == 2;
  constexpr int IS = TILE * TILE / VS / TILE_THREADS;
  constexpr int ID = TILE * TILE / VD / TILE_THREADS;
  const bool lc = g.load_axis == 1, sc = g.store_axis == 1;
  {
    Pack<typename P::In, VS> buf[IS];
    int code[IS];
#pragma unroll
    for (int k = 0; k < IS; ++k) {
      int line, pack;
      item_pos<VS>(threadIdx.x + k * TILE_THREADS, line, pack);
      const int r = lc ? line : pack * VS, c = lc ? pack * VS : line;
      load_item<P, VS>(g, o, src, r0, c0, r, c, buf[k], code[k]);
    }
#pragma unroll
    for (int k = 0; k < IS; ++k) {
      if (code[k] == 1) continue;
      int line, pack;
      item_pos<VS>(threadIdx.x + k * TILE_THREADS, line, pack);
      const int r = lc ? line : pack * VS, c = lc ? pack * VS : line;
      typename P::S v[VS];
      pol.template values<VS>(buf[k], code[k], r0 + r, c0 + c, lc, v);
#pragma unroll
      for (int e = 0; e < VS; ++e)
        tile[r + (lc ? 0 : e)][c + (lc ? e : 0)] = v[e];
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < ID; ++k) {
    int line, pack;
    item_pos<VD>(threadIdx.x + k * TILE_THREADS, line, pack);
    const int r = sc ? line : pack * VD, c = sc ? pack * VD : line;
    if (r0 + r >= g.prows || c0 + c >= g.pcols) continue;
    Pack<typename P::Out, VD> out;
    if (PAIRS && sc && r0 + r < g.rows && c0 + c + VD <= g.cols) {
      const uint32_t* w = reinterpret_cast<const uint32_t*>(&tile[r][c]);
#pragma unroll
      for (int q = 0; q < VD / 2; ++q)
        reinterpret_cast<uint32_t*>(&out)[q] = w[q];
    } else {
#pragma unroll
      for (int e = 0; e < VD; ++e) {
        const int re = r + (sc ? 0 : e), ce = c + (sc ? e : 0);
        const bool inside = r0 + re < g.rows && c0 + ce < g.cols;
        out.v[e] = inside ? pol.store(tile[re][ce]) : pol.zero();
      }
    }
    store_pack<typename P::Out, VD>(dst + o.dr[r] + o.dc[c], out);
  }
}

// One block's tile: blockDim.x == TILE_THREADS, one block per tile, the
// column tiles fastest.  DIRECT needs load_axis == store_axis and VS == VD.
template <class P, int VS, int VD, bool DIRECT>
__device__ __forceinline__ void tile2_run(const Tile2& g,
                                          const typename P::In* src,
                                          typename P::Out* dst, const P& pol) {
  __shared__ TileOffsets o;
  const int64_t ntc = (g.pcols + TILE - 1) / TILE;
  const int64_t r0 = (int64_t)(blockIdx.x / ntc) * TILE;
  const int64_t c0 = (int64_t)(blockIdx.x % ntc) * TILE;
  {
    const int i = threadIdx.x % TILE;
    const int64_t r = r0 + i, c = c0 + i;
    switch (threadIdx.x / TILE) {
      case 0: o.sr[i] = r < g.rows ? term_off(g.src_r, r) : 0; break;
      case 1: o.sc[i] = c < g.cols ? term_off(g.src_c, c) : 0; break;
      case 2: o.dr[i] = r < g.prows ? dim_offset(g.dst_r, r) : 0; break;
      default: o.dc[i] = c < g.pcols ? dim_offset(g.dst_c, c) : 0; break;
    }
  }
  __syncthreads();
  if constexpr (DIRECT) {
    tile2_direct<P, VS>(g, o, src, dst, pol, r0, c0);
  } else {
    __shared__ typename P::S tile[TILE][TILE_PITCH<typename P::S>];
    tile2_staged<P, VS, VD>(g, o, src, dst, pol, r0, c0, tile);
  }
}

// Host side: the number of tiles, and whether the pointers carry the
// accesses the host chose (a pack needs a 16-byte aligned base).
inline int64_t tile2_blocks(const Tile2& g) {
  return ((g.prows + TILE - 1) / TILE) * ((g.pcols + TILE - 1) / TILE);
}

inline bool tile2_aligned(const Tile2& g, const void* src, const void* dst) {
  return (g.vs == 1 || (uintptr_t)src % 16 == 0) &&
         (g.vd == 1 || (uintptr_t)dst % 16 == 0);
}

// The instantiation of kernel K<VS, VD, DIRECT> for g's access widths, V the
// 16-byte pack: a thread stores what it loaded when both phases run along
// one axis with one width.
template <int V, template <int, int, bool> class K>
typename K<1, 1, true>::Fn tile2_pick(const Tile2& g) {
  if (g.load_axis == g.store_axis && g.vs == g.vd)
    return g.vs > 1 ? K<V, V, true>::fn() : K<1, 1, true>::fn();
  if (g.vs > 1) return g.vd > 1 ? K<V, V, false>::fn() : K<V, 1, false>::fn();
  return g.vd > 1 ? K<1, V, false>::fn() : K<1, 1, false>::fn();
}

}  // namespace xdma
