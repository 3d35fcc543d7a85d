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
// Design: xdma::tile2_run (xdma_common.cuh) with the Copy policy.  A block
// moves a 64 x 64 tile of the destination's padded logical space (16 KiB
// at f32), its layout maps computed once per tile row and column, not per
// element.  Words are the element's size (1, 2, 4 or 8 bytes) and move
// unchanged, so the copy is bitwise for any dtype (NaN payloads and -0.0
// included); where a side's innermost run, strides and extent allow, a
// thread moves them as 16-byte packs.  When both sides are innermost along
// the same logical axis (tile, untile, tile-to-tile) a thread stores what
// it loaded; under a transpose or a column-major side the tile is staged
// through shared memory.  The TPU plan's grid and block (plan_relayout) are
// kept on the host for plan and stat parity only.
#include "xdma_common.cuh"

namespace {

struct RelayoutArgs {
  xdma::Tile2 t;
  int64_t elem_bytes;      // 1, 2, 4 or 8
};

template <typename W, int VS, int VD, bool DIRECT>
__global__ void __launch_bounds__(xdma::TILE_THREADS)
relayout_kernel(const W* __restrict__ src, W* __restrict__ dst,
                const __grid_constant__ RelayoutArgs a) {
  xdma::tile2_run<xdma::Copy<W>, VS, VD, DIRECT>(a.t, src, dst,
                                                 xdma::Copy<W>{W(0)});
}

template <typename W>
struct Relayout {
  template <int VS, int VD, bool DIRECT>
  struct K {
    using Fn = void (*)(const W*, W*, const RelayoutArgs);
    static Fn fn() { return relayout_kernel<W, VS, VD, DIRECT>; }
  };
};

template <typename W>
int launch(const RelayoutArgs& a, const void* src, void* dst,
           cudaStream_t stream) {
  constexpr int V = 16 / sizeof(W);
  const int64_t blocks = xdma::tile2_blocks(a.t);
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  if (!xdma::tile2_aligned(a.t, src, dst))
    return (int)cudaErrorMisalignedAddress;
  auto fn = xdma::tile2_pick<V, Relayout<W>::template K>(a.t);
  fn<<<(unsigned)blocks, xdma::TILE_THREADS, 0, stream>>>(
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
