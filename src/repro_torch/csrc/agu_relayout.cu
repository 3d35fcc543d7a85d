// Kernel 1: the generic AGU relayout.
//
// Replaces the reference's TPU kernel src/repro/kernels/agu.py:168,
// AGUPlan.run (inner `kernel`, :162): a 2-D relayout between two Layouts
// (tile, perm, pad) with an optional swap of the last two logical axes.
//
// Bound: pure data movement, so device-memory bytes.  Each element is read
// once and written once (plus the zeros of the dst stride padding); at
// 4096 x 4096 f32 that is 128 MiB, about 40 us at 3.35 TB/s.
//
// Design: the copy works in words of the element size (1, 2, 4 or 8 bytes),
// so it is bitwise whatever the dtype (NaN payloads and -0.0 included).  A
// block owns a 32 x 32 tile of the destination's *padded logical* space.  It
// reads the tile with the thread index running along the logical axis that
// is innermost in the source's physical order, stages it through a 32 x 33
// shared-memory tile, and writes it with the thread index running along the
// axis innermost in the destination's physical order, so both sides stay
// coalesced for transposes, column-major layouts and tile grids alike.
// Positions in the destination's stride padding get zeros.  The TPU plan's
// grid and block (plan_relayout) are kept on the host for plan and stat
// parity only; the CUDA grid is this kernel's own.
#include "xdma_common.cuh"

namespace {

struct RelayoutArgs {
  int64_t rows, cols;      // dst logical extent
  int64_t prows, pcols;    // dst logical extent including stride padding
  int64_t transpose;       // 1: dst logical (r, c) reads src logical (c, r)
  int64_t src_inner;       // dst-logical axis innermost in src physical order
  int64_t dst_inner;       // dst-logical axis innermost in dst physical order
  int64_t elem_bytes;      // 1, 2, 4 or 8
  xdma::DimMap src[2];     // src logical (row, col) -> src physical offset
  xdma::DimMap dst[2];     // dst logical (row, col) -> dst physical offset
};

constexpr int TILE = 32;
constexpr int ROWS = 8;    // blockDim = (32, 8)

template <typename W>
__global__ void __launch_bounds__(TILE * ROWS)
relayout_kernel(const W* __restrict__ src, W* __restrict__ dst,
                RelayoutArgs a) {
  __shared__ W tile[TILE][TILE + 1];
  const int64_t ntc = (a.pcols + TILE - 1) / TILE;
  const int64_t r0 = (int64_t)(blockIdx.x / ntc) * TILE;
  const int64_t c0 = (int64_t)(blockIdx.x % ntc) * TILE;
  const int tx = threadIdx.x, ty = threadIdx.y;

  for (int k = ty; k < TILE; k += ROWS) {
    const int lr = a.src_inner ? k : tx;
    const int lc = a.src_inner ? tx : k;
    const int64_t r = r0 + lr, c = c0 + lc;
    if (r < a.rows && c < a.cols) {
      const int64_t sr = a.transpose ? c : r, sc = a.transpose ? r : c;
      tile[lr][lc] = src[xdma::dim_offset(a.src[0], sr) +
                         xdma::dim_offset(a.src[1], sc)];
    }
  }
  __syncthreads();
  for (int k = ty; k < TILE; k += ROWS) {
    const int lr = a.dst_inner ? k : tx;
    const int lc = a.dst_inner ? tx : k;
    const int64_t r = r0 + lr, c = c0 + lc;
    if (r < a.prows && c < a.pcols) {
      const W v = (r < a.rows && c < a.cols) ? tile[lr][lc] : W(0);
      dst[xdma::dim_offset(a.dst[0], r) + xdma::dim_offset(a.dst[1], c)] = v;
    }
  }
}

template <typename W>
int launch(const RelayoutArgs& a, const void* src, void* dst,
           cudaStream_t stream) {
  const int64_t blocks =
      ((a.prows + TILE - 1) / TILE) * ((a.pcols + TILE - 1) / TILE);
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  relayout_kernel<W><<<(unsigned)blocks, dim3(TILE, ROWS), 0, stream>>>(
      static_cast<const W*>(src), static_cast<W*>(dst), a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int xdma_agu_relayout(const void* args, const void* src, void* dst,
                                 void* stream) {
  const RelayoutArgs& a = *static_cast<const RelayoutArgs*>(args);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a.elem_bytes) {
    case 1: return launch<uint8_t>(a, src, dst, s);
    case 2: return launch<uint16_t>(a, src, dst, s);
    case 4: return launch<uint32_t>(a, src, dst, s);
    case 8: return launch<uint64_t>(a, src, dst, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
