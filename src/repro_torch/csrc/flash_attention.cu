// Kernel 6: flash attention, forward.
//
// Replaces the reference's TPU kernel src/repro/kernels/flash_attention.py:80,
// flash_attention (_kernel at :24), and serves flash_attention_gqa (:100):
// online-softmax attention with f32 running max m, sum l and accumulator acc;
// scores s = (q . k) * hd^-0.5 in f32; causal (keep kp <= qp) and sliding
// window (keep kp > qp - window) masks that replace a score with -1e30; P
// rounded to v's dtype before P . V, accumulated in f32; the output
// acc / max(l, 1e-30) rounded to q's dtype.
//
// The finite -1e30 matters: a key block masked entirely before a row's first
// live block adds exp(0) = 1 terms, which the first live block wipes out with
// corr = exp(-1e30 - m) = 0.  Both paths keep the constant and the update.
// They skip key blocks that lie wholly outside every row's live range, whose
// contribution is exactly zero, but only when every row of the query block
// has a live key; otherwise they visit every key block, as the reference
// does.  Keys past Sk (the ragged last block) are not keys at all: they enter
// with p = 0 and do not move the max.
//
// Bound: operations.  4 * hd flops per live (query, key) pair and head
// (q . k and P . V); at a phi4-mini prefill (S 4096, 24 heads, hd 128,
// causal) that is 103 GFLOP, 0.104 ms at 989 TFLOP/s bf16, while the bytes
// (q, k, v, o) take 0.020 ms.
//
// Head dims.  Each path is compiled for instance widths HD and runs a head
// dim hd <= HD on the next larger instance: columns hd .. HD - 1 are zero in
// shared memory (they add nothing to q . k or P . V) and are not stored, and
// the scale is hd^-0.5 of the true hd.  Widths: wgmma 64, 128, 256; mma 16,
// 32, 64, 128; FMA 16, 32, 64, 128, 256.  A head dim above 256 takes the
// chunked path in every dtype: its tiles would not fit in shared memory
// whole, so it loops over the head dim at run time.
//
// Four paths.  The wrapper picks one by dtype, head dim and alignment
// (flash_attention.py, _path) and names it in FlashArgs.path, which is also
// the label it counts the launch under (FLASH.paths["wgmma"] / ["mma"] /
// ["fma"] / ["chunked"]); xdma_flash_attention launches the path named
// there and refuses a path that does not take the dtype, head dim or
// alignment.  Nothing falls back at run time.
//
// * bf16 / f16, 33 <= hd <= 256, every base and stepped stride a multiple of
//   16 bytes (`vec`): flash_wgmma_kernel, Hopper's warpgroup tensor cores
//   fed by TMA (the FlashArgs strides become 4-d tensor maps {hd, S, heads,
//   B}, 128-byte swizzled, encoded on the host with cuTensorMapEncodeTiled
//   and passed as __grid_constant__ parameters).  A block of 384 threads
//   covers 128 query rows of one (batch, head): a producer warpgroup, whose
//   one thread loads the two consumers' Q tiles once and keeps K and V
//   tiles of BK keys in a ring of 2 stages (each stage's K and V with a full
//   and an empty mbarrier), and two consumer warpgroups of 64 rows each
//   (setmaxnreg: 24 registers a producer thread, 240 a consumer's).  BK is
//   128 at widths 64 and 128, 80 at 256.  A consumer computes S = Q K^T by
//   wgmma m64nBKk16 with both operands K-major in shared memory, runs the
//   online softmax on the f32 accumulators in registers (the mma path's
//   rules below: exp2, masks only on blocks that cross Sk, the diagonal or
//   the window's edge for one of its rows, in 32-bit arithmetic relative to
//   the block), and adds P V by wgmma m64nHDk16 with P's accumulators,
//   rounded to the dtype, as the A registers and V read MN-major (the
//   transpose bit), so V is never transposed in memory.  Each consumer
//   skips the key blocks outside its own rows' live keys (where each row
//   has one) and hands their stages back unread.  A block's scores and the
//   block before's P V are issued together, and the softmax runs while the
//   tensor cores work on them (FA3's overlap within a warpgroup); at widths
//   64 and 128 the two consumers also take turns to issue (pingpong, named
//   barriers), so one's softmax runs beside the other's products, and the
//   kernel is persistent: one block an SM walks the tiles heaviest first, in
//   a zigzag over the grid, with Q's tile released (an empty mbarrier) once
//   its last scores are in, so the next tile's Q and K / V load while this
//   one's last P V and output run.  The output goes through shared memory
//   (its own tile; at width 256 the consumer's Q tile), swizzled, to one
//   TMA store a 64-column block, which clips rows past Sq and columns past
//   hd; rows past Sq or Sk and columns past hd load as TMA's zeros.
// * bf16 / f16 that the wgmma path does not take (hd <= 32, or a view that
//   is not 16-byte aligned at hd <= 128): flash_mma_kernel, on the tensor
//   cores (the FlashAttention-2 design on mma.sync.m16n8k16).  One block of 4 warps covers 64 query rows
//   of one (batch, head); warp w owns rows 16 w .. 16 w + 15.  Q is copied
//   once into shared memory with 16-byte cp.async and then held in registers
//   as ldmatrix.x4 A-fragments for the whole key loop.  K and V come in
//   64-key blocks, double-buffered in shared memory: the next block's K and V
//   are in flight (cp.async, one commit group a block) while this block
//   computes.  Shared rows have a pitch of hd + 8 halves, so the eight 16-byte
//   rows an ldmatrix reads fall on distinct bank quads (free of conflicts at
//   every hd).  S = Q K^T and O += P V run on mma.sync with f32 accumulators;
//   the softmax works on the accumulator fragments, each lane holding two
//   rows, the row max reduced over the lane's quad with two shuffles.  The
//   exponent is base 2 with log2(e) folded into the scale: s2 = (q . k) *
//   f32(hd^-0.5 * log2 e), p = 2^(s2 - m2) by one ex2.approx.ftz (a p under
//   2^-126 becomes 0); a masked s2 is -1e30, so the -1e30 update above holds
//   in the log2 domain.  l sums the f32 p before
//   rounding (per lane, reduced over the quad once at the end); P is rounded
//   to the dtype in registers and its C-fragments are reused as the A-
//   fragments of P . V (P never touches shared memory); V's B-fragments come
//   from ldmatrix.trans.  Masks are applied only on key blocks that cross the
//   causal diagonal, the window's lower edge or Sk.  The output is staged
//   through the warp's own rows of the Q buffer and stored as 16-byte packs.
//   Where a tensor's base or strides are not 16-byte aligned (`vec` = 0),
//   tiles are loaded and stored one element at a time, the rest unchanged.
// * f32, and bf16 / f16 views that are not aligned at 129 <= hd <= 256:
//   flash_kernel, on the FMA pipes (f32 q . k in full f32, as the
//   reference's f32 dot; TF32 would keep about three digits).  One block of
//   256 threads per (batch * head, 64-query block); the query tile and one
//   64-key tile at a time sit in shared memory as f32, rows padded by one
//   word; K and V take turns in one buffer.  Each thread owns a 4 x 4 patch
//   of the 64 x 64 score tile (rows 4 ty .. 4 ty + 3, columns tx + 16 j) and
//   a 4 x hd/16 patch of the output; the 16 threads of a row reduce its max
//   and sum by shuffles.  On bf16 / f16 P is rounded to the dtype before
//   P . V, as on the tensor-core paths.
// * hd > 256, every dtype: flash_chunked_kernel, the FMA kernel's arithmetic
//   (and its sum order) over the head dim in chunks: scores summed over
//   64-column chunks of Q and K, the output in 256-column slices, one grid z
//   index a slice, each slice with its own full online softmax (the scores
//   are recomputed per slice).  Bound as above; it runs at FMA rate, far
//   below it.
//
// All address heads by strides, so the GQA form (B, S, H, hd) is read in
// place and query head h reads kv head h / G: nothing is transposed or
// repeated.  Query blocks run last-first, so the longest causal rows start
// first.
//
// The wgmma path's accumulator and A-register maps and its 128-byte swizzle
// are listed at the top of hopper.cuh (tests/test_torch_flash.py holds them
// too and builds S and O through them bitwise).
//
// Fragment maps of the mma path (PTX ISA, "Matrix Fragments for mma.m16n8k16
// with floating point type" and "ldmatrix"; tests/test_torch_flash.py holds
// the same maps and checks the products they build bitwise).  lane = 4 g + t:
//   A (16 x 16, row):  reg 0 (g, 2t..2t+1), reg 1 (g+8, 2t..), reg 2
//                      (g, 2t+8..), reg 3 (g+8, 2t+8..); low half first.
//   B (16 x 8, col):   reg 0 (k 2t..2t+1, n g), reg 1 (k 2t+8.., n g).
//   C (16 x 8, f32):   c0, c1 (g, 2t..2t+1); c2, c3 (g+8, 2t..2t+1).
//   ldmatrix.x4:       lanes 8i .. 8i+7 give the row addresses of matrix i;
//                      reg i of a lane holds matrix i's (g, 2t..2t+1), or
//                      with .trans its (2t..2t+1, g).
//   Q (A, rows r, cols d):  lane gives row (lane & 7) + 8 ((lane >> 3) & 1),
//                      col 8 (lane >> 4): regs = A of the 16 x 16 tile.
//   K (B of S, keys n):     lane gives key (lane & 7) + 8 (lane >> 4), col
//                      8 ((lane >> 3) & 1): regs 0, 1 = B of keys n..n+7,
//                      regs 2, 3 = B of keys n+8..n+15.
//   V (B of O, .trans):     lane gives key (lane & 7) + 8 ((lane >> 3) & 1),
//                      col 8 (lane >> 4): regs 0, 1 = B of cols d..d+7,
//                      regs 2, 3 = B of cols d+8..d+15.
//   C -> A (P):        A of keys 16 kk.. = {C(2kk) c0c1, C(2kk) c2c3,
//                      C(2kk+1) c0c1, C(2kk+1) c2c3}, packed low-first.
#include <climits>
#include <type_traits>

#include "hopper.cuh"
#include "xdma_common.cuh"

namespace {

constexpr int BQ = 64, BK = 64, THREADS = 256, MMA_THREADS = 128;
constexpr float NEG_INF = -1e30f;
constexpr double LOG2E = 1.4426950408889634;
// FlashArgs.path, the index of its label in flash_attention.py's PATHS
constexpr int64_t FMA_PATH = 0, MMA_PATH = 1, CHUNKED_PATH = 2, WGMMA_PATH = 3;

struct FlashArgs {
  int64_t B, H, G;     // batch, query heads, query heads per kv head
  int64_t Sq, Sk, hd;
  int64_t causal, has_window, window;
  int64_t dtype;       // q, k, v and o share it
  int64_t vec;         // 1: every base and stride is 16-byte aligned
  int64_t path;        // FMA_PATH, MMA_PATH, CHUNKED_PATH or WGMMA_PATH
  double scale;        // hd^-0.5, rounded to f32 in the kernel
  int64_t q_sb, q_sh, q_ss;   // element strides: batch, head, position
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t o_sb, o_sh, o_ss;
};

// the live keys of query position qp: [lo, hi]
__device__ __forceinline__ int64_t live_lo(const FlashArgs& a, int64_t qp) {
  return a.has_window ? max((int64_t)0, qp - a.window + 1) : 0;
}
__device__ __forceinline__ int64_t live_hi(const FlashArgs& a, int64_t qp) {
  return a.causal ? min(qp, a.Sk - 1) : a.Sk - 1;
}

// The key blocks a query block of `bq` rows visits in blocks of `bk` keys,
// [kbeg, kend): the skip rule.
__device__ __forceinline__ void key_range(const FlashArgs& a, int64_t q0,
                                          int64_t& kbeg, int64_t& kend,
                                          int64_t bq = BQ, int64_t bk = BK) {
  const int64_t q1 = min(q0 + bq, a.Sq) - 1;
  kbeg = 0;
  kend = a.Sk;
  if (live_lo(a, q1) <= live_hi(a, q1)) {
    kbeg = live_lo(a, q0) / bk * bk;
    kend = live_hi(a, q1) + 1;
  }
}

// ---------------------------------------------------------------- f32 path
// A 64-row tile of positions [first, first + 64) as f32 (pitch HD + 1); rows
// at or past `limit` and columns at or past `hd` are zero.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* base,
                                          int64_t stride, int64_t first,
                                          int64_t limit, int64_t hd) {
  constexpr int LD = HD + 1;
  for (int idx = threadIdx.x; idx < 64 * HD; idx += THREADS) {
    const int r = idx / HD, d = idx % HD;
    const int64_t p = first + r;
    dst[r * LD + d] =
        p < limit && d < hd ? xdma::to_f32<T>(base[p * stride + d]) : 0.f;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, FlashArgs a) {
  constexpr int LD = HD + 1, LDP = BK + 1, NC = HD / 16;
  extern __shared__ float smem[];
  float* sQ = smem;                 // BQ x LD
  float* sKV = sQ + BQ * LD;        // BK x LD: K, then V
  float* sP = sKV + BK * LD;        // BQ x LDP
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int64_t q0 = (int64_t)(gridDim.y - 1 - blockIdx.y) * BQ;
  const int64_t bh = blockIdx.x, b = bh / a.H, h = bh % a.H, hk = h / a.G;
  const T* qb = q + b * a.q_sb + h * a.q_sh;
  const T* kb = k + b * a.k_sb + hk * a.k_sh;
  const T* vb = v + b * a.v_sb + hk * a.v_sh;
  T* ob = o + b * a.o_sb + h * a.o_sh;
  const float scale = (float)a.scale;

  load_tile<T, HD>(sQ, qb, a.q_ss, q0, a.Sq, a.hd);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  int64_t kbeg, kend;
  key_range(a, q0, kbeg, kend);

  for (int64_t k0 = kbeg; k0 < kend; k0 += BK) {
    __syncthreads();                        // sKV (V) and sP are free
    load_tile<T, HD>(sKV, kb, a.k_ss, k0, a.Sk, a.hd);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty * 4 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sKV[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t qp = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t kp = k0 + tx + 16 * j;
        float val = s[i][j] * scale;
        if (kp >= a.Sk) {
          val = -INFINITY;                  // past the last key: p = 0
        } else {
          if (a.causal && kp > qp) val = NEG_INF;
          if (a.has_window && kp <= qp - a.window) val = NEG_INF;
        }
        s[i][j] = val;
        mx = fmaxf(mx, val);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        psum += p;
        // P in the dtype for P . V (no change on f32)
        sP[(ty * 4 + i) * LDP + tx + 16 * j] =
            xdma::to_f32<T>(xdma::from_f32<T>(p));
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l[i] = l[i] * corr + psum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }

    __syncthreads();                        // K is read, P is written
    load_tile<T, HD>(sKV, vb, a.v_ss, k0, a.Sk, a.hd);
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4], vv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty * 4 + i) * LDP + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = sKV[kk * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t qp = q0 + ty * 4 + i;
    if (qp >= a.Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (tx + 16 * c < a.hd)
        ob[qp * a.o_ss + tx + 16 * c] =
            xdma::from_f32<T>(__fdiv_rn(acc[i][c], denom));
  }
}

// ------------------------------------------------- head dims above 256
// flash_chunked_kernel: the FMA kernel's arithmetic for any head dim, every
// dtype.  Block z of the grid owns output columns [z DC, z DC + DC) of one
// (batch * head, 64-query block).  For each key block it accumulates the
// scores over 64-column chunks of Q and K (the same d order as flash_kernel,
// so the same sums), runs the full online softmax, and adds P . V for its own
// DC columns of V.  Each column block recomputes the scores: ceil(hd / DC)
// times the q . k work, in exchange for tiles that fit in shared memory at
// any hd.  Q is re-read a chunk at a time for every key block (from L2).
template <typename T, int DC>
__global__ void __launch_bounds__(THREADS)
flash_chunked_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o, FlashArgs a) {
  constexpr int CW = 64, LC = CW + 1, LDV = DC + 1, LDP = BK + 1;
  constexpr int NC = DC / 16;
  extern __shared__ float smem[];
  float* sQ = smem;                 // BQ x LC: a 64-column chunk of Q
  float* sK = sQ + BQ * LC;         // BK x LC: the same chunk of K
  float* sP = sK + BK * LC;         // BQ x LDP
  float* sV = sP + BQ * LDP;        // BK x LDV: this block's columns of V
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int64_t q0 = (int64_t)(gridDim.y - 1 - blockIdx.y) * BQ;
  const int64_t d0 = (int64_t)blockIdx.z * DC;
  const int64_t bh = blockIdx.x, b = bh / a.H, h = bh % a.H, hk = h / a.G;
  const T* qb = q + b * a.q_sb + h * a.q_sh;
  const T* kb = k + b * a.k_sb + hk * a.k_sh;
  const T* vb = v + b * a.v_sb + hk * a.v_sh;
  T* ob = o + b * a.o_sb + h * a.o_sh;
  const float scale = (float)a.scale;

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  int64_t kbeg, kend;
  key_range(a, q0, kbeg, kend);

  for (int64_t k0 = kbeg; k0 < kend; k0 += BK) {
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int64_t c0 = 0; c0 < a.hd; c0 += CW) {
      __syncthreads();                      // sQ, sK (and sP, sV) are free
      load_tile<T, CW>(sQ, qb + c0, a.q_ss, q0, a.Sq, a.hd - c0);
      load_tile<T, CW>(sK, kb + c0, a.k_ss, k0, a.Sk, a.hd - c0);
      __syncthreads();
#pragma unroll 8
      for (int d = 0; d < CW; ++d) {
        float qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty * 4 + i) * LC + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[j] = sK[(tx + 16 * j) * LC + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t qp = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t kp = k0 + tx + 16 * j;
        float val = s[i][j] * scale;
        if (kp >= a.Sk) {
          val = -INFINITY;                  // past the last key: p = 0
        } else {
          if (a.causal && kp > qp) val = NEG_INF;
          if (a.has_window && kp <= qp - a.window) val = NEG_INF;
        }
        s[i][j] = val;
        mx = fmaxf(mx, val);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        psum += p;
        sP[(ty * 4 + i) * LDP + tx + 16 * j] =
            xdma::to_f32<T>(xdma::from_f32<T>(p));
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l[i] = l[i] * corr + psum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }

    load_tile<T, DC>(sV, vb + d0, a.v_ss, k0, a.Sk, a.hd - d0);
    __syncthreads();                        // P and V are written

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4], vv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty * 4 + i) * LDP + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = sV[kk * LDV + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t qp = q0 + ty * 4 + i;
    if (qp >= a.Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (d0 + tx + 16 * c < a.hd)
        ob[qp * a.o_ss + d0 + tx + 16 * c] =
            xdma::from_f32<T>(__fdiv_rn(acc[i][c], denom));
  }
}

// --------------------------------------------------------- bf16 / f16 path
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, asynchronous; zero-filled when !ok (the source
// is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// 2^x in one instruction (subnormal results flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d += A (16 x 16) . B (16 x 8), f32 accumulators
template <typename T> struct Mma;
template <> struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ void run(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  // two f32 rounded to nearest even, lo in the low half
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};
template <> struct Mma<__half> {
  static __device__ __forceinline__ void run(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

// A 64-row tile of positions [first, first + 64) into shared memory (pitch
// HD + 8); rows at or past `limit` are zero.  Unless FULL (hd == HD),
// columns at or past `hd` are zero too: a 16-byte chunk wholly inside or
// wholly past hd moves by cp.async where `vec`, one that straddles hd one
// element at a time.  (FULL compiles the checks away: the instance widths
// the models use pay nothing for the others.)
template <typename T, int HD, bool FULL>
__device__ __forceinline__ void mma_load_tile(T* dst, const T* base,
                                              int64_t stride, int64_t first,
                                              int64_t limit, bool vec,
                                              int64_t hd) {
  constexpr int LDS = HD + 8, CPR = HD / 8;        // 16-byte chunks a row
#pragma unroll
  for (int i = 0; i < 64 * CPR / MMA_THREADS; ++i) {
    const int c = threadIdx.x + i * MMA_THREADS, r = c / CPR, col = (c % CPR) * 8;
    const int64_t p = first + r;
    const bool ok = p < limit && (FULL || col < hd);
    T* d = dst + r * LDS + col;
    const T* s = FULL ? base + (ok ? p : 0) * stride + col
                      : base + (ok ? p * stride + col : 0);
    if (vec && (FULL || col + 8 <= hd || !ok)) {
      cp_async16(d, s, ok);
    } else {
      uint4 pack = make_uint4(0, 0, 0, 0);
      T* e = reinterpret_cast<T*>(&pack);
      if (ok) {
#pragma unroll
        for (int x = 0; x < 8; ++x)
          if (FULL || col + x < hd) e[x] = s[x];
      }
      *reinterpret_cast<uint4*>(d) = pack;
    }
  }
}

template <typename T, int HD, bool FULL>
__global__ void __launch_bounds__(MMA_THREADS)
flash_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, FlashArgs a) {
  constexpr int LDS = HD + 8, TILE = 64 * LDS, CPR = HD / 8;
  constexpr int NKQ = HD / 16;      // k-steps of Q . K^T
  constexpr int ND = HD / 8;        // n-tiles of the output
  constexpr int NS = BK / 8;        // n-tiles of the scores
  extern __shared__ __align__(16) unsigned char smem_mma[];
  T* sQ = reinterpret_cast<T*>(smem_mma);      // 64 x LDS; later the output
  T* sK = sQ + TILE;                            // 2 stages
  T* sV = sK + 2 * TILE;                        // 2 stages
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t q0 = (int64_t)(gridDim.y - 1 - blockIdx.y) * BQ;
  const int64_t bh = blockIdx.x, b = bh / a.H, h = bh % a.H, hk = h / a.G;
  const T* qb = q + b * a.q_sb + h * a.q_sh;
  const T* kb = k + b * a.k_sb + hk * a.k_sh;
  const T* vb = v + b * a.v_sb + hk * a.v_sh;
  T* ob = o + b * a.o_sb + h * a.o_sh;
  const bool vec = a.vec != 0;
  const float scale2 = (float)(a.scale * LOG2E);
  const int64_t q1 = min(q0 + BQ, a.Sq) - 1;

  int64_t kbeg, kend;
  key_range(a, q0, kbeg, kend);
  const int nblk = (int)((kend - kbeg + BK - 1) / BK);

  // commit groups: Q, then K / V of the first block
  mma_load_tile<T, HD, FULL>(sQ, qb, a.q_ss, q0, a.Sq, vec, a.hd);
  cp_async_commit();
  mma_load_tile<T, HD, FULL>(sK, kb, a.k_ss, kbeg, a.Sk, vec, a.hd);
  mma_load_tile<T, HD, FULL>(sV, vb, a.v_ss, kbeg, a.Sk, vec, a.hd);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();                          // Q has landed

  uint32_t qf[NKQ][4];
  {
    const T* qrow = sQ + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS
                    + (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < NKQ; ++kk) ldmatrix_x4(qf[kk], qrow + kk * 16);
  }
  // this lane's rows g and g + 8 of the warp's 16, and its key / column
  // offsets within an n-tile: 2t, 2t + 1
  const int64_t qr = q0 + warp * 16 + g;
  const int koff = (lane & 7) + (lane >> 4) * 8, kcol = ((lane >> 3) & 1) * 8;
  const int voff = (lane & 7) + ((lane >> 3) & 1) * 8, vcol = (lane >> 4) * 8;

  float acc[ND][4], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int it = 0; it < nblk; ++it) {
    const int st = it & 1;
    const int64_t k0 = kbeg + (int64_t)it * BK;
    // this block's K and V are the one group in flight; after the barrier
    // every warp is done with the other stage, which takes the next block's
    cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < nblk) {
      mma_load_tile<T, HD, FULL>(sK + (st ^ 1) * TILE, kb, a.k_ss, k0 + BK, a.Sk, vec,
                           a.hd);
      mma_load_tile<T, HD, FULL>(sV + (st ^ 1) * TILE, vb, a.v_ss, k0 + BK, a.Sk, vec,
                           a.hd);
      cp_async_commit();
    }
    const T* Ks = sK + st * TILE;
    const T* Vs = sV + st * TILE;

    // S = Q . K^T, 16 x 64 per warp
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NKQ; ++kk) {
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t bf[4];
        ldmatrix_x4(bf, Ks + (np * 16 + koff) * LDS + kk * 16 + kcol);
        Mma<T>::run(s[2 * np], qf[kk], bf[0], bf[1]);
        Mma<T>::run(s[2 * np + 1], qf[kk], bf[2], bf[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= scale2;

    // masks only where the block crosses Sk, the diagonal or the window edge
    const bool full = k0 + BK <= a.Sk && (!a.causal || k0 + BK - 1 <= q0) &&
                      (!a.has_window || k0 > q1 - a.window);
    if (!full) {
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int64_t qp = qr + (e >> 1) * 8;
          const int64_t kp = k0 + j * 8 + 2 * t + (e & 1);
          if (kp >= a.Sk) {
            s[j][e] = -INFINITY;            // past the last key: p = 0
          } else {
            if (a.causal && kp > qp) s[j][e] = NEG_INF;
            if (a.has_window && kp <= qp - a.window) s[j][e] = NEG_INF;
          }
        }
    }

    // online softmax on the fragments: c0, c1 row g; c2, c3 row g + 8
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NS; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      const float corr = ex2(m[r] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float p = ex2(s[j][2 * r + c] - m_new);
          s[j][2 * r + c] = p;
          ps += p;                          // l sums the f32 p
        }
      l[r] = l[r] * corr + ps;
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        acc[j][2 * r] *= corr;
        acc[j][2 * r + 1] *= corr;
      }
    }

    // O += P . V: P's C-fragments, rounded, are the A-fragments
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pa[4] = {
          Mma<T>::pack(s[2 * kk][0], s[2 * kk][1]),
          Mma<T>::pack(s[2 * kk][2], s[2 * kk][3]),
          Mma<T>::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          Mma<T>::pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, Vs + (kk * 16 + voff) * LDS + dp * 16 + vcol);
        Mma<T>::run(acc[2 * dp], pa, bf[0], bf[1]);
        Mma<T>::run(acc[2 * dp + 1], pa, bf[2], bf[3]);
      }
    }
  }

  // epilogue: l over the quad, acc / max(l, 1e-30), staged in the warp's
  // own rows of sQ (no other warp reads them), stored 16 bytes a lane
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  T* so = sQ + warp * 16 * LDS;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<uint32_t*>(so + (g + 8 * r) * LDS + j * 8 + 2 * t) =
          Mma<T>::pack(__fdiv_rn(acc[j][2 * r], denom),
                       __fdiv_rn(acc[j][2 * r + 1], denom));
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 16 * CPR / 32; ++i) {
    const int c = lane + 32 * i, r = c / CPR, col = (c % CPR) * 8;
    const int64_t qp = q0 + warp * 16 + r;
    if (qp >= a.Sq || (!FULL && col >= a.hd)) continue;
    const uint4 pack = *reinterpret_cast<const uint4*>(so + r * LDS + col);
    T* dst = ob + qp * a.o_ss + col;
    if (vec && (FULL || col + 8 <= a.hd)) {
      *reinterpret_cast<uint4*>(dst) = pack;
    } else {
      const T* e = reinterpret_cast<const T*>(&pack);
#pragma unroll
      for (int x = 0; x < 8; ++x)
        if (FULL || col + x < a.hd) dst[x] = e[x];
    }
  }
}

// ------------------------------------------------ bf16 / f16 path on Hopper
// flash_wgmma_kernel: 384 threads, one producer warpgroup and two consumer
// warpgroups; a tile is 128 query rows of one (batch, head), consumer c
// rows q0 + 64 c .. q0 + 64 c + 63.  All tiles are 128-byte swizzled, as
// TMA writes them and wgmma reads them (hopper.cuh).
template <int HD>
struct WgShape {
  static constexpr int BK = HD <= 128 ? 128 : 80;   // keys a block
  static constexpr int NCB = HD / 64;               // 64-column blocks
  static constexpr int QW = 64 * HD;        // elements: a consumer's Q / O
  static constexpr int KV = BK * HD;        // elements: a stage of K or V
  static constexpr int STAGES = 2;
  // the consumers take turns to issue their products (pingpong): faster at
  // widths 64 and 128 on the card, slower at 256 (PERF.md, PR 30)
  static constexpr bool PINGPONG = HD <= 128;
  // one block an SM walks the tiles, its output staged apart from Q, so
  // the next tile's loads overlap this one's last products and store:
  // faster at widths 64 and 128 on the card (PERF.md, PR 30); at 256 the
  // output buffer does not fit beside the ring
  static constexpr bool PERSIST = HD <= 128;
  // barriers: Q's full and empty; K's and V's full and empty of each stage
  static constexpr int NBAR = 2 + 4 * STAGES;
  static constexpr size_t SMEM =
      2 * ((PERSIST ? 4 : 2) * QW + 2 * STAGES * KV) + 8 * NBAR +
      1024;                                               // + alignment
};
// the consumers' threads, and their warps (one arrival each on an empty
// barrier: a warp's wgmma_wait has returned in all its lanes)
constexpr int WG_THREADS = 384, WG_BQ = 128, CONSUMER_THREADS = 256;
constexpr int CONSUMER_WARPS = CONSUMER_THREADS / 32;

// Tile k of this block, heaviest first: (query block q0, batch * head bh),
// or false past the last.  One tile a block, or (PERSIST) a zigzag over the
// tiles in steps of the grid, so each block's tiles add up to about the
// same work.
template <bool PERSIST>
__device__ __forceinline__ bool wg_tile(const FlashArgs& a, int k,
                                        int64_t& q0, int64_t& bh) {
  const int64_t nq = (a.Sq + WG_BQ - 1) / WG_BQ, nbh = a.B * a.H;
  if (!PERSIST) {
    q0 = (int64_t)(gridDim.y - 1 - blockIdx.y) * WG_BQ;
    bh = blockIdx.x;
    return k == 0;
  }
  const int64_t G = gridDim.x;
  const int64_t t = k * G + ((k & 1) ? G - 1 - blockIdx.x : blockIdx.x);
  if (t >= nq * nbh) return false;
  q0 = (nq - 1 - t / nbh) * WG_BQ;
  bh = t % nbh;
  return true;
}

template <typename T, int HD>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tmQ,
                   const __grid_constant__ CUtensorMap tmK,
                   const __grid_constant__ CUtensorMap tmV,
                   const __grid_constant__ CUtensorMap tmO, FlashArgs a) {
  using W = WgShape<HD>;
  constexpr int BKW = W::BK, NCB = W::NCB, STAGES = W::STAGES;
  constexpr bool PP = W::PINGPONG, PERSIST = W::PERSIST;
  extern __shared__ __align__(1024) unsigned char smem_wg[];
  unsigned char* base =
      smem_wg + ((1024 - (hopper::smem_u32(smem_wg) & 1023)) & 1023);
  T* sQ = reinterpret_cast<T*>(base);   // consumer c: sQ + c QW, NCB blocks
                                        // of 64 rows
  T* sO = PERSIST ? sQ + 2 * W::QW : sQ;    // its output, the same way
  T* sK = sO + 2 * W::QW;               // stage s: sK + s KV, NCB blocks of BK
  if (!PERSIST) sK = sQ + 2 * W::QW;
  T* sV = sK + STAGES * W::KV;
  uint64_t* full_q = reinterpret_cast<uint64_t*>(sV + STAGES * W::KV);
  uint64_t* empty_q = full_q + 1;
  uint64_t* full_k = empty_q + 1;
  uint64_t* full_v = full_k + STAGES;
  uint64_t* empty_k = full_v + STAGES;
  uint64_t* empty_v = empty_k + STAGES;

  const int wg = threadIdx.x >> 7;
  if (threadIdx.x == 0) {
    hopper::mbar_init(full_q, 1);
    hopper::mbar_init(empty_q, CONSUMER_WARPS);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full_k[s], 1);
      hopper::mbar_init(&full_v[s], 1);
      hopper::mbar_init(&empty_k[s], CONSUMER_WARPS);
      hopper::mbar_init(&empty_v[s], CONSUMER_WARPS);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread keeps the ring of K / V stages full
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      hopper::prefetch_map(&tmQ);
      hopper::prefetch_map(&tmK);
      hopper::prefetch_map(&tmV);
      int gk = 0;                         // key blocks loaded, all tiles
      int64_t q0, bh;
      for (int k = 0; wg_tile<PERSIST>(a, k, q0, bh); ++k) {
        const int64_t b = bh / a.H, h = bh % a.H, hk = h / a.G;
        int64_t kbeg, kend;
        key_range(a, q0, kbeg, kend, WG_BQ, BKW);
        const int nblk = (int)((kend - kbeg + BKW - 1) / BKW);
        // a fresh barrier's "previous" phase (parity 1) counts as complete,
        // so the first pass through a ring does not wait
        hopper::mbar_wait(empty_q, (k & 1) ^ 1);
        hopper::mbar_expect_tx(full_q, 2 * W::QW * sizeof(T));
        for (int c = 0; c < 2; ++c)
          for (int j = 0; j < NCB; ++j)
            hopper::tma_load_4d(sQ + c * W::QW + j * 64 * 64, &tmQ, full_q,
                                64 * j, (int)(q0 + 64 * c), (int)h, (int)b);
        for (int it = 0; it < nblk; ++it, ++gk) {
          const int st = gk % STAGES;
          const uint32_t ph = (gk / STAGES) & 1;
          const int k0 = (int)(kbeg + (int64_t)it * BKW);
          hopper::mbar_wait(&empty_k[st], ph ^ 1);
          hopper::mbar_expect_tx(&full_k[st], W::KV * sizeof(T));
          for (int j = 0; j < NCB; ++j)
            hopper::tma_load_4d(sK + st * W::KV + j * BKW * 64, &tmK,
                                &full_k[st], 64 * j, k0, (int)hk, (int)b);
          hopper::mbar_wait(&empty_v[st], ph ^ 1);
          hopper::mbar_expect_tx(&full_v[st], W::KV * sizeof(T));
          for (int j = 0; j < NCB; ++j)
            hopper::tma_load_4d(sV + st * W::KV + j * BKW * 64, &tmV,
                                &full_v[st], 64 * j, k0, (int)hk, (int)b);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each
    hopper::setmaxnreg_inc<240>();
    const int cw = wg - 1, tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const T* sQw = sQ + cw * W::QW;
    T* sOw = sO + cw * W::QW;
    const float scale2 = (float)(a.scale * LOG2E);

    float o[HD / 2];
    float m[2], l[2];
    float s[BKW / 2];
    uint32_t pa[BKW / 16][4];
    int64_t q0, bh, r0, r1;

    auto release = [&](uint64_t* bar) {
      if (lane == 0) hopper::mbar_arrive(bar);
    };
    // S = Q K^T, 64 x BK: HD / 16 steps of m64nBKk16, both from shared
    auto scores = [&](int st) {
      const T* Ks = sK + st * W::KV;
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        hopper::WgmmaSS<BKW, T>::run(
            s,
            hopper::desc_sw128(sQw + (kk / 4) * 64 * 64 + (kk % 4) * 16, 16,
                               1024),
            hopper::desc_sw128(Ks + (kk / 4) * BKW * 64 + (kk % 4) * 16, 16,
                               1024),
            kk > 0);
      hopper::wgmma_commit();
    };
    // O += P V: m64nHDk16 steps, P from registers, V MN-major from shared
    auto pv = [&](int st) {
      const T* Vs = sV + st * W::KV;
      hopper::fence_regs(o);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKW / 16; ++kk)
        hopper::WgmmaRS<HD, T>::run(
            o, pa[kk], hopper::desc_sw128(Vs + kk * 16 * 64, BKW * 128, 1024),
            1);
      hopper::wgmma_commit();
    };
    // scale, mask, online softmax of the block at key k0: s becomes the f32
    // p, corr the factor O must take before this block's P V
    auto softmax = [&](int64_t k0, float (&corr)[2]) {
#pragma unroll
      for (int i = 0; i < BKW / 2; ++i) s[i] *= scale2;
      // masks only where the block crosses Sk, the diagonal or the
      // window's lower edge for one of this consumer's rows
      const bool full = k0 + BKW <= a.Sk &&
                        (!a.causal || k0 + BKW - 1 <= r0) &&
                        (!a.has_window || k0 > r1 - a.window);
      if (!full) {
        // element 4 j + e holds key 8 j + 2 t + (e & 1) of the block and
        // row warp 16 + g + 8 r (r = e >> 1) of the consumer's; the key's
        // constant part 8 j + (e & 1) is held to row r's limits, 2 t taken
        // into them: masked past hi (causal) or at or below lo (window).
        // Keys past Sk (a ragged last block) take -inf: p = 0
        const int64_t dq = r0 - k0, cap = (int64_t)1 << 30;
        int hi[2], lo[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int64_t lr = warp * 16 + g + 8 * r + dq - 2 * t;
          hi[r] = a.causal ? (int)max(min(lr, cap), -cap) : (int)cap;
          lo[r] = a.has_window ? (int)max(min(lr - a.window, cap), -cap)
                               : (int)-cap;
        }
#pragma unroll
        for (int j = 0; j < BKW / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 8 * j + (e & 1), r = e >> 1;
            if (c > hi[r] || c <= lo[r]) s[4 * j + e] = NEG_INF;
          }
        const int klim = (int)min(a.Sk - k0, (int64_t)BKW) - 2 * t;
        if (klim < BKW - 2 * t) {
#pragma unroll
          for (int j = 0; j < BKW / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (8 * j + (e & 1) >= klim) s[4 * j + e] = -INFINITY;
        }
      }
      // registers 4 j + 2 r + c hold row r of the thread's two
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < BKW / 8; ++j)
          mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx);
        corr[r] = ex2(m[r] - m_new);
        float ps = 0.f;
#pragma unroll
        for (int j = 0; j < BKW / 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float p = ex2(s[4 * j + 2 * r + c] - m_new);
            s[4 * j + 2 * r + c] = p;
            ps += p;                              // l sums the f32 p
          }
        l[r] = l[r] * corr[r] + ps;
        m[r] = m_new;
      }
    };
    // O's rows take corr; P rounded to the dtype: the accumulators of keys
    // 16 kk .. 16 kk + 15 are the A registers of the kk-th step of P V
    auto rescale_and_pack = [&](const float (&corr)[2]) {
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[4 * j + e] *= corr[e >> 1];
#pragma unroll
      for (int kk = 0; kk < BKW / 16; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          pa[kk][i] = Mma<T>::pack(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
    };
    // hand a stage back unread (a block outside the consumer's keys)
    auto pass = [&](int gi) {
      const int st = gi % STAGES;
      const uint32_t ph = (gi / STAGES) & 1;
      hopper::mbar_wait(&full_k[st], ph);
      release(&empty_k[st]);
      hopper::mbar_wait(&full_v[st], ph);
      release(&empty_v[st]);
    };

    int gk = 0;                           // key blocks consumed, all tiles
    for (int k = 0; wg_tile<PERSIST>(a, k, q0, bh); ++k) {
      const int64_t b = bh / a.H, h = bh % a.H;
      int64_t kbeg, kend;
      key_range(a, q0, kbeg, kend, WG_BQ, BKW);
      const int nblk = (int)((kend - kbeg + BKW - 1) / BKW);
      r0 = q0 + 64 * cw;                      // the consumer's rows,
      r1 = min(r0 + 63, a.Sq - 1);            // the last one clipped
      const bool any = r0 < a.Sq;
      // The skip rule on the consumer's 64 rows: where each has a live
      // key, a key block outside every row's live range adds exactly
      // nothing.  The blocks it computes are then [i0, i1) of the tile's;
      // it hands the other stages back unread.
      int i0 = 0, i1 = any ? nblk : 0;
      if (any && live_lo(a, r1) <= live_hi(a, r1)) {
        i0 = (int)((live_lo(a, r0) - kbeg) / BKW);
        i1 = min(nblk, (int)((live_hi(a, r1) - kbeg) / BKW) + 1);
      }
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
      m[0] = m[1] = NEG_INF;
      l[0] = l[1] = 0.f;

      // With PP the two consumers take turns to issue their products
      // (named barriers 3 and 4, the other's arrival opening a turn;
      // consumer 0 first), so one's softmax runs beside the other's
      // products.  Each takes nblk + 1 turns a tile, a turn with nothing to
      // issue included.
      int turns = 0;
      auto turn_begin = [&]() {
        if (PP) hopper::named_sync(3 + cw, CONSUMER_THREADS);
      };
      auto turn_end = [&]() {
        if (PP && (cw == 0 || ++turns <= nblk))
          hopper::named_arrive(4 - cw, CONSUMER_THREADS);
      };

      hopper::mbar_wait(full_q, k & 1);
      if (PP && cw == 1) hopper::named_arrive(3, CONSUMER_THREADS);
      for (int it = 0; it < i0; ++it) {
        pass(gk + it);
        turn_begin();
        turn_end();
      }
      if (i0 < i1) {
        // the first block: scores and softmax
        float corr[2];
        const int f = gk + i0;
        hopper::mbar_wait(&full_k[f % STAGES], (f / STAGES) & 1);
        turn_begin();
        scores(f % STAGES);
        turn_end();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(s);
        release(&empty_k[f % STAGES]);
        softmax(kbeg + (int64_t)i0 * BKW, corr);
        rescale_and_pack(corr);
        // then each block's scores and the block before's P V run on the
        // tensor cores while this warpgroup's softmax waits on the scores
        for (int it = i0 + 1; it < i1; ++it) {
          const int gi = gk + it, st = gi % STAGES, pst = (gi - 1) % STAGES;
          hopper::mbar_wait(&full_k[st], (gi / STAGES) & 1);
          hopper::mbar_wait(&full_v[pst], ((gi - 1) / STAGES) & 1);
          turn_begin();
          scores(st);
          pv(pst);
          turn_end();
          hopper::wgmma_wait<1>();                // the scores have landed
          hopper::fence_regs(s);
          release(&empty_k[st]);
          softmax(kbeg + (int64_t)it * BKW, corr);
          hopper::wgmma_wait<0>();                // so has the P V
          hopper::fence_regs(o);
          release(&empty_v[pst]);
          rescale_and_pack(corr);
        }
        // Q is read: the next tile's may load.  Then the last block's P V
        release(empty_q);
        const int last = gk + i1 - 1, lst = last % STAGES;
        hopper::mbar_wait(&full_v[lst], (last / STAGES) & 1);
        turn_begin();
        pv(lst);
        turn_end();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(o);
        release(&empty_v[lst]);
      } else {
        release(empty_q);
        turn_begin();
        turn_end();
      }
      for (int it = max(i0, i1); it < nblk; ++it) {
        pass(gk + it);
        turn_begin();
        turn_end();
      }
      gk += nblk;

      // epilogue: l over the quad, O / max(l, 1e-30) rounded into the
      // consumer's output tile (swizzled as TMA reads it) once the last
      // tile's store has read it, one TMA store a 64-column block; rows
      // past Sq and columns past hd are not written
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      }
      if (PERSIST) {
        if (tid == 0) hopper::tma_store_wait_read();
        hopper::named_sync(1 + cw, 128);
      }
      unsigned char* so = reinterpret_cast<unsigned char*>(sOw);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float denom = fmaxf(l[r], 1e-30f);
        const int row = warp * 16 + g + 8 * r;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
          *reinterpret_cast<uint32_t*>(
              so + (j / 8) * 64 * 64 * sizeof(T) + row * 128 +
              (((j % 8) ^ (row % 8)) * 16) + 4 * t) =
              Mma<T>::pack(__fdiv_rn(o[4 * j + 2 * r], denom),
                           __fdiv_rn(o[4 * j + 2 * r + 1], denom));
      }
      hopper::fence_proxy_async();
      hopper::named_sync(1 + cw, 128);
      if (tid == 0 && any) {
        for (int j = 0; j < NCB; ++j)
          hopper::tma_store_4d(&tmO, sOw + j * 64 * 64, 64 * j, (int)r0,
                               (int)h, (int)b);
        hopper::tma_store_commit();
      }
    }
    if (tid == 0) hopper::tma_store_wait_read();
  }
}

template <typename T>
int launch(void (*kern)(const T*, const T*, const T*, T*, FlashArgs),
           int threads, size_t smem, const FlashArgs& a, const void* q,
           const void* k, const void* v, void* o, cudaStream_t stream,
           int64_t nz = 1) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int64_t nq = (a.Sq + BQ - 1) / BQ, nbh = a.B * a.H;
  if (nq > 65535 || nz > 65535 || nbh > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  kern<<<dim3((unsigned)nbh, (unsigned)nq, (unsigned)nz), threads, smem,
         stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), a);
  return (int)cudaGetLastError();
}

// the FMA kernel (f32), or the tensor-core kernel (bf16 / f16: Q, then two
// stages of K and of V, each 64 rows of HD + 8 halves)
template <typename T, int HD, bool MMA>
int launch_hd(const FlashArgs& a, const void* q, const void* k, const void* v,
              void* o, cudaStream_t s) {
  if constexpr (MMA) {
    constexpr size_t smem = sizeof(T) * 5 * 64 * (HD + 8);
    return launch<T>(a.hd == HD ? flash_mma_kernel<T, HD, true>
                                : flash_mma_kernel<T, HD, false>,
                     MMA_THREADS, smem, a, q, k, v,
                     o, s);
  } else {
    constexpr size_t smem =
        sizeof(float) * ((BQ + BK) * (HD + 1) + BQ * (BK + 1));
    return launch<T>(flash_kernel<T, HD>, THREADS, smem, a, q, k, v, o, s);
  }
}

// The instance for head dim a.hd: the next larger width of 16, 32, 64, 128.
template <typename T, bool MMA>
int dispatch(const FlashArgs& a, const void* q, const void* k, const void* v,
             void* o, cudaStream_t s) {
  if (a.hd < 1) return (int)cudaErrorInvalidValue;
  if (a.hd <= 16) return launch_hd<T, 16, MMA>(a, q, k, v, o, s);
  if (a.hd <= 32) return launch_hd<T, 32, MMA>(a, q, k, v, o, s);
  if (a.hd <= 64) return launch_hd<T, 64, MMA>(a, q, k, v, o, s);
  if (a.hd <= 128) return launch_hd<T, 128, MMA>(a, q, k, v, o, s);
  return (int)cudaErrorInvalidValue;
}

// Head dims 129 to 256 on the FMA path (f32, and bf16 / f16 views the wgmma
// path does not take): the FMA kernel's 256-wide instance.
template <typename T>
int dispatch_wide(const FlashArgs& a, const void* q, const void* k,
                  const void* v, void* o, cudaStream_t s) {
  if (a.hd <= 128 || a.hd > 256) return (int)cudaErrorInvalidValue;
  return launch_hd<T, 256, false>(a, q, k, v, o, s);
}

// Head dims above 256, every dtype: flash_chunked_kernel, one block a 256-wide
// column slice of the output.
template <typename T>
int dispatch_chunked(const FlashArgs& a, const void* q, const void* k,
                     const void* v, void* o, cudaStream_t s) {
  constexpr int DC = 256;
  if (a.hd <= 256) return (int)cudaErrorInvalidValue;
  constexpr size_t smem = sizeof(float) * ((BQ + BK) * (64 + 1) +
                                           BQ * (BK + 1) + BK * (DC + 1));
  return launch<T>(flash_chunked_kernel<T, DC>, THREADS, smem, a, q, k, v, o,
                   s, (a.hd + DC - 1) / DC);
}

// A (B, S, heads, hd) view as a 4-d tensor map {hd, S, heads, B} with a
// box of 64 columns x `rows` positions, 128-byte swizzled; positions past S
// and columns past hd read as zeros.  The strides are the view's own (a
// size-1 dim's, never stepped, is replaced by a packed one).
template <typename T>
bool encode_map(CUtensorMap* map, const void* p, int64_t hd, int64_t S,
                int64_t heads, int64_t B, int64_t ss, int64_t sh, int64_t sb,
                uint32_t rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)S,
                              (cuuint64_t)heads, (cuuint64_t)B};
  const int64_t step[3] = {ss, sh, sb};
  cuuint64_t strides[3];
  uint64_t packed = (uint64_t)hd * sizeof(T);
  for (int i = 0; i < 3; ++i) {
    packed = (packed + 15) / 16 * 16;
    strides[i] = dims[i + 1] == 1 ? packed : (cuuint64_t)step[i] * sizeof(T);
    packed = strides[i] * dims[i + 1];
  }
  const cuuint32_t box[4] = {64, rows, 1, 1}, unit[4] = {1, 1, 1, 1};
  return cuTensorMapEncodeTiled(
             map,
             std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                            : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
             4, const_cast<void*>(p), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int HD>
int launch_wgmma(const FlashArgs& a, const void* q, const void* k,
                 const void* v, void* o, cudaStream_t stream) {
  using W = WgShape<HD>;
  CUtensorMap tq, tk, tv, to;
  const int64_t kv = a.H / a.G;
  if (!encode_map<T>(&tq, q, a.hd, a.Sq, a.H, a.B, a.q_ss, a.q_sh, a.q_sb,
                     64) ||
      !encode_map<T>(&tk, k, a.hd, a.Sk, kv, a.B, a.k_ss, a.k_sh, a.k_sb,
                     W::BK) ||
      !encode_map<T>(&tv, v, a.hd, a.Sk, kv, a.B, a.v_ss, a.v_sh, a.v_sb,
                     W::BK) ||
      !encode_map<T>(&to, o, a.hd, a.Sq, a.H, a.B, a.o_ss, a.o_sh, a.o_sb,
                     64))
    return (int)cudaErrorInvalidValue;
  auto kern = flash_wgmma_kernel<T, HD>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)W::SMEM);
  if (e != cudaSuccess) return (int)e;
  const int64_t nq = (a.Sq + WG_BQ - 1) / WG_BQ, nbh = a.B * a.H;
  if (nq > 65535 || nbh > 0x7fffffffLL || a.Sq > 0x7fffffffLL ||
      a.Sk > 0x7fffffffLL || nq * nbh > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  dim3 grid((unsigned)nbh, (unsigned)nq);
  if (W::PERSIST) {                       // one block an SM
    int dev = 0, sms = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
      return (int)e;
    grid = dim3((unsigned)min(nq * nbh, (int64_t)sms));
  }
  kern<<<grid, WG_THREADS, W::SMEM, stream>>>(tq, tk, tv, to, a);
  return (int)cudaGetLastError();
}

// Head dims 33 to 256 in bf16 / f16, every base and stepped stride 16-byte
// aligned (TMA's rule): the next larger width of 64, 128, 256.
template <typename T>
int dispatch_wgmma(const FlashArgs& a, const void* q, const void* k,
                   const void* v, void* o, cudaStream_t s) {
  if (!a.vec || a.hd < 33 || a.hd > 256) return (int)cudaErrorInvalidValue;
  if (a.hd <= 64) return launch_wgmma<T, 64>(a, q, k, v, o, s);
  if (a.hd <= 128) return launch_wgmma<T, 128>(a, q, k, v, o, s);
  return launch_wgmma<T, 256>(a, q, k, v, o, s);
}

}  // namespace

extern "C" int xdma_flash_attention(const void* args, const void* q,
                                    const void* k, const void* v, void* o,
                                    void* stream) {
  const FlashArgs& a = *static_cast<const FlashArgs*>(args);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.H <= 0 || a.G <= 0 || a.H % a.G) return (int)cudaErrorInvalidValue;
  if (a.B == 0 || a.Sq == 0) return 0;
  if (a.Sk <= 0) return (int)cudaErrorInvalidValue;
  if (a.path == CHUNKED_PATH) {
    if (a.dtype == xdma::F32) return dispatch_chunked<float>(a, q, k, v, o, s);
    if (a.dtype == xdma::BF16)
      return dispatch_chunked<__nv_bfloat16>(a, q, k, v, o, s);
    if (a.dtype == xdma::F16) return dispatch_chunked<__half>(a, q, k, v, o, s);
    return (int)cudaErrorInvalidValue;
  }
  if (a.path == WGMMA_PATH) {
    if (a.dtype == xdma::BF16)
      return dispatch_wgmma<__nv_bfloat16>(a, q, k, v, o, s);
    if (a.dtype == xdma::F16) return dispatch_wgmma<__half>(a, q, k, v, o, s);
    return (int)cudaErrorInvalidValue;
  }
  if (a.path == FMA_PATH && a.hd > 128) {
    if (a.dtype == xdma::F32) return dispatch_wide<float>(a, q, k, v, o, s);
    if (a.dtype == xdma::BF16)
      return dispatch_wide<__nv_bfloat16>(a, q, k, v, o, s);
    if (a.dtype == xdma::F16) return dispatch_wide<__half>(a, q, k, v, o, s);
    return (int)cudaErrorInvalidValue;
  }
  if (a.path == FMA_PATH && a.dtype == xdma::F32)
    return dispatch<float, false>(a, q, k, v, o, s);
  if (a.path == MMA_PATH && a.dtype == xdma::BF16)
    return dispatch<__nv_bfloat16, true>(a, q, k, v, o, s);
  if (a.path == MMA_PATH && a.dtype == xdma::F16)
    return dispatch<__half, true>(a, q, k, v, o, s);
  return (int)cudaErrorInvalidValue;
}
