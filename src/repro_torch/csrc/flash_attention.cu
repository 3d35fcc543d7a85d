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
// Head dims.  Each path is compiled for instance widths HD (16, 32, 64, 128;
// the FMA path also 256) and runs a head dim hd <= HD on the next larger
// instance: columns hd .. HD - 1 are zero in shared memory (they add nothing
// to q . k or P . V) and are not stored, and the scale is hd^-0.5 of the true
// hd.  A head dim of 129 to 256 takes the FMA path in every dtype (the mma
// path would hold 2 x 128 accumulator and Q registers a thread there).  A
// head dim above 256 takes the chunked path in every dtype: its tiles would
// not fit in shared memory whole, so it loops over the head dim at run time.
//
// Three paths.  The wrapper picks one by dtype and head dim
// (flash_attention.py, _path) and names it in FlashArgs.path, which is also
// the label it counts the launch under (FLASH.paths["fma"] / ["mma"] /
// ["chunked"]); xdma_flash_attention launches the path named there and refuses
// a path that does not take the dtype or head dim.  Nothing falls back at
// run time.
//
// * bf16 / f16: flash_mma_kernel, on the tensor cores (the FlashAttention-2
//   design on mma.sync.m16n8k16).  One block of 4 warps covers 64 query rows
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
// * f32: flash_kernel, on the FMA pipes (f32 q . k in full f32, as the
//   reference's f32 dot; TF32 would keep about three digits).  One block of
//   256 threads per (batch * head, 64-query block); the query tile and one
//   64-key tile at a time sit in shared memory as f32, rows padded by one
//   word; K and V take turns in one buffer.  Each thread owns a 4 x 4 patch
//   of the 64 x 64 score tile (rows 4 ty .. 4 ty + 3, columns tx + 16 j) and
//   a 4 x hd/16 patch of the output; the 16 threads of a row reduce its max
//   and sum by shuffles.  On bf16 / f16 (head dims above 128 only) P is
//   rounded to the dtype before P . V, as on the mma path.
// * hd > 256, every dtype: flash_chunked_kernel, the FMA kernel's arithmetic
//   (and its sum order) over the head dim in chunks: scores summed over
//   64-column chunks of Q and K, the output in 256-column slices, one grid z
//   index a slice, each slice with its own full online softmax (the scores
//   are recomputed per slice).  Bound as above; it runs at FMA rate, far
//   below it.
//
// Both address heads by strides, so the GQA form (B, S, H, hd) is read in
// place and query head h reads kv head h / G: nothing is transposed or
// repeated.  Query blocks run last-first, so the longest causal rows start
// first.
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
#include <type_traits>

#include "xdma_common.cuh"

namespace {

constexpr int BQ = 64, BK = 64, THREADS = 256, MMA_THREADS = 128;
constexpr float NEG_INF = -1e30f;
constexpr double LOG2E = 1.4426950408889634;
// FlashArgs.path, the index of its label in flash_attention.py's PATHS
constexpr int64_t FMA_PATH = 0, MMA_PATH = 1, CHUNKED_PATH = 2;

struct FlashArgs {
  int64_t B, H, G;     // batch, query heads, query heads per kv head
  int64_t Sq, Sk, hd;
  int64_t causal, has_window, window;
  int64_t dtype;       // q, k, v and o share it
  int64_t vec;         // 1: every base and stride is 16-byte aligned
  int64_t path;        // FMA_PATH (f32), MMA_PATH (bf16 / f16), CHUNKED_PATH
                       // (hd > 256, every dtype)
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

// The key blocks a query block visits, [kbeg, kend): the skip rule.
__device__ __forceinline__ void key_range(const FlashArgs& a, int64_t q0,
                                          int64_t& kbeg, int64_t& kend) {
  const int64_t q1 = min(q0 + BQ, a.Sq) - 1;
  kbeg = 0;
  kend = a.Sk;
  if (live_lo(a, q1) <= live_hi(a, q1)) {
    kbeg = live_lo(a, q0) / BK * BK;
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

// Head dims 129 to 256, every dtype: the FMA kernel's 256-wide instance.
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
