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
// corr = exp(-1e30 - m) = 0.  This kernel keeps the constant and the update.
// It skips key blocks that lie wholly outside every row's live range, whose
// contribution is exactly zero, but only when every row of the query block
// has a live key; otherwise it visits every key block, as the reference does.
// Keys past Sk (the ragged last block) are not keys at all: they enter with
// p = 0 and do not move the max.
//
// Bound: operations.  4 * hd flops per live (query, key) pair and head
// (q . k and P . V); at a phi4-mini prefill (S 4096, 24 heads, hd 128,
// causal) that is 103 GFLOP, 0.104 ms at 989 TFLOP/s bf16, while the bytes
// (q, k, v, o) take 0.020 ms.
//
// Design (a simple first version on the f32 FMA pipes, no tensor cores): one
// block of 256 threads per (batch * head, 64-query block).  The query tile
// and one 64-key tile at a time sit in shared memory as f32, rows padded by
// one word so that the column walks are free of bank conflicts; K and V take
// turns in one buffer.  Each thread owns a 4 x 4 patch of the 64 x 64 score
// tile (rows 4 ty .. 4 ty + 3, columns tx + 16 j) and a 4 x hd/16 patch of
// the output; the 16 threads of a row reduce its max and sum by shuffles.
// Heads are addressed by strides, so the GQA form (B, S, H, hd) is read in
// place and query head h reads kv head h / G: nothing is transposed or
// repeated.  Query blocks run last-first, so the longest causal rows start
// first.
#include "xdma_common.cuh"

namespace {

constexpr int BQ = 64, BK = 64, THREADS = 256;
constexpr float NEG_INF = -1e30f;

struct FlashArgs {
  int64_t B, H, G;     // batch, query heads, query heads per kv head
  int64_t Sq, Sk, hd;
  int64_t causal, has_window, window;
  int64_t dtype;       // q, k, v and o share it
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

template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* base,
                                          int64_t stride, int64_t first,
                                          int64_t limit) {
  constexpr int LD = HD + 1;
  for (int idx = threadIdx.x; idx < 64 * HD; idx += THREADS) {
    const int r = idx / HD, d = idx % HD;
    const int64_t p = first + r;
    dst[r * LD + d] = p < limit ? xdma::to_f32<T>(base[p * stride + d]) : 0.f;
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
  const bool round_p = a.dtype != xdma::F32;

  load_tile<T, HD>(sQ, qb, a.q_ss, q0, a.Sq);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  // key range: skip the blocks no row of this query block can see, unless a
  // row has no live key at all (then every block counts, as in the reference)
  const int64_t q1 = min(q0 + BQ, a.Sq) - 1;
  int64_t kbeg = 0, kend = a.Sk;
  if (live_lo(a, q1) <= live_hi(a, q1)) {
    kbeg = live_lo(a, q0) / BK * BK;
    kend = live_hi(a, q1) + 1;
  }

  for (int64_t k0 = kbeg; k0 < kend; k0 += BK) {
    __syncthreads();                        // sKV (V) and sP are free
    load_tile<T, HD>(sKV, kb, a.k_ss, k0, a.Sk);
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
        sP[(ty * 4 + i) * LDP + tx + 16 * j] = round_p ? xdma::round_to(p, a.dtype) : p;
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
    load_tile<T, HD>(sKV, vb, a.v_ss, k0, a.Sk);
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
      ob[qp * a.o_ss + tx + 16 * c] = xdma::from_f32<T>(__fdiv_rn(acc[i][c], denom));
  }
}

template <typename T, int HD>
int launch(const FlashArgs& a, const void* q, const void* k, const void* v,
           void* o, cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * ((BQ + BK) * (HD + 1) + BQ * (BK + 1));
  auto kern = flash_kernel<T, HD>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int64_t nq = (a.Sq + BQ - 1) / BQ, nbh = a.B * a.H;
  if (nq > 65535 || nbh > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  kern<<<dim3((unsigned)nbh, (unsigned)nq), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const FlashArgs& a, const void* q, const void* k, const void* v,
             void* o, cudaStream_t s) {
  switch (a.hd) {
    case 16: return launch<T, 16>(a, q, k, v, o, s);
    case 32: return launch<T, 32>(a, q, k, v, o, s);
    case 64: return launch<T, 64>(a, q, k, v, o, s);
    case 128: return launch<T, 128>(a, q, k, v, o, s);
    default: return (int)cudaErrorInvalidValue;
  }
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
  switch (a.dtype) {
    case xdma::F32: return dispatch<float>(a, q, k, v, o, s);
    case xdma::BF16: return dispatch<__nv_bfloat16>(a, q, k, v, o, s);
    case xdma::F16: return dispatch<__half>(a, q, k, v, o, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
