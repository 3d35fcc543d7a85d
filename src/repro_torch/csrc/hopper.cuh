// Hopper's asynchronous copy and warpgroup tensor-core instructions, as
// raw PTX for sm_90a: mbarriers, TMA tile loads and stores through a
// CUtensorMap, the wgmma shared-memory matrix descriptor, and
// wgmma.mma_async with f32 accumulators (PTX ISA, "Asynchronous Warpgroup
// Level Matrix Multiply-Accumulate Instructions", "Tensor copy", "mbarrier").
//
// wgmma m64nNk16, f32 accumulators: warp w of the warpgroup holds rows
// 16 w .. 16 w + 15; with lane = 4 g + t, accumulator register 4 j + e holds
// (row g + 8 (e >> 1), column 8 j + 2 t + (e & 1)) for j < N / 8, the
// mma.m16n8k16 C layout repeated over N.  An A operand in registers takes
// that warp's rows in the mma.m16n8k16 A layout: reg 0 (g, 2t..2t+1),
// reg 1 (g+8, 2t..), reg 2 (g, 2t+8..), reg 3 (g+8, 2t+8..), low half first.
//
// Shared tiles use the 128-byte swizzle (TMA's CU_TENSOR_MAP_SWIZZLE_128B,
// descriptor layout 1): a tile is stored as blocks of 64 16-bit columns,
// each block R rows of 128 bytes; the 16-byte chunk c of row r lies at
// chunk c ^ (r % 8) of its row.  Every block starts on 1024 bytes.
#pragma once

#include <cstdint>
#include <type_traits>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// ---------------------------------------------------------------- mbarrier
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}
// make the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}
// arrive, and expect `bytes` more of TMA traffic in this phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}

// -------------------------------------------------------------------- TMA
// a (c0, c1, c2, c3) box of `map` into shared memory, completing on `bar`;
// elements outside the tensor arrive as zeros
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"((uint64_t)map), "r"(smem_u32(bar)),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
// shared memory into the (c0, c1, c2, c3) box of `map`; elements outside
// the tensor are not written
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.tile.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n"
      :: "l"((uint64_t)map), "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2),
         "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// the shared source of every committed store has been read
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// this thread's ordinary shared-memory writes become visible to TMA
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" :: "l"((uint64_t)map) : "memory");
}

// ------------------------------------------------------------ warpgroups
template <uint32_t N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}
template <uint32_t N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}
// the `count` threads of barrier `id` meet (id 0 is __syncthreads')
__device__ __forceinline__ void named_sync(uint32_t id, uint32_t count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}
// count towards barrier `id`'s `count` without waiting
__device__ __forceinline__ void named_arrive(uint32_t id, uint32_t count) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

// ------------------------------------------------------------------ wgmma
// The shared-memory matrix descriptor of a 128-byte-swizzled operand whose
// block starts at `p` (1024-byte aligned, so the base offset is 0):
// address >> 4, leading byte offset >> 4 (bits 16-29), stride byte offset
// >> 4 (bits 32-45), layout 1 = 128-byte swizzle (bits 62-63).
//   K-major (Q, K): rows of 128 bytes, 8-row groups `sbo` = 1024 bytes apart;
//     the leading offset is unused (1).  The k-th 16-wide step of a block
//     starts 32 k bytes in.
//   MN-major (V as the B of P V): the N dim runs along the 128-byte rows,
//     64 columns a block, blocks `lbo` bytes apart; K runs down the rows,
//     8-row groups `sbo` = 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// keeps the compiler from moving accesses of r across an asynchronous
// wgmma that reads or writes it
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// The instructions, one macro a shape; TY is "bf16" or "f16".  SS: A and B
// both K-major in shared memory.  RS: A in registers, B MN-major (the
// transpose bit) in shared memory.  scale_d = 0 writes d = A B, 1 adds.
#define XDMA_WGMMA_SS_80(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n80k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, " \
      "%8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, " \
      "%24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39" \
      "}, %40, %41, p, 1, 1, 0, 0;\n}\n" \
    : \
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]) \
    : "l"(da), "l"(db), "r"(scale_d))

#define XDMA_WGMMA_SS_128(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, " \
      "%8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, " \
      "%24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, " \
      "%40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, " \
      "%56, %57, %58, %59, %60, %61, %62, %63" \
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n" \
    : \
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
      "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
    : "l"(da), "l"(db), "r"(scale_d))

#define XDMA_WGMMA_RS_64(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, " \
      "%8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, " \
      "%24, %25, %26, %27, %28, %29, %30, %31" \
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n" \
    : \
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
    : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))

#define XDMA_WGMMA_RS_128(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, " \
      "%8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, " \
      "%24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, " \
      "%40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, " \
      "%56, %57, %58, %59, %60, %61, %62, %63" \
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n" \
    : \
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
      "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
    : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))

#define XDMA_WGMMA_RS_256(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, " \
      "%8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, " \
      "%24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, " \
      "%40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, " \
      "%56, %57, %58, %59, %60, %61, %62, %63, " \
      "%64, %65, %66, %67, %68, %69, %70, %71, " \
      "%72, %73, %74, %75, %76, %77, %78, %79, " \
      "%80, %81, %82, %83, %84, %85, %86, %87, " \
      "%88, %89, %90, %91, %92, %93, %94, %95, " \
      "%96, %97, %98, %99, %100, %101, %102, %103, " \
      "%104, %105, %106, %107, %108, %109, %110, %111, " \
      "%112, %113, %114, %115, %116, %117, %118, %119, " \
      "%120, %121, %122, %123, %124, %125, %126, %127" \
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n" \
    : \
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
      "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), \
      "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), \
      "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
      "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), \
      "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
      "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), \
      "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), \
      "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), \
      "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), \
      "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), \
      "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), \
      "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), \
      "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), \
      "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), \
      "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
      "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), \
      "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127]) \
    : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))


// d (N / 2 f32 registers a thread) = or += A (64 x 16) B (16 x N)
template <int N, typename T>
struct WgmmaSS;   // A and B K-major in shared memory, by descriptor
template <int N, typename T>
struct WgmmaRS;   // A in registers, B MN-major in shared memory

#define XDMA_WGMMA_STRUCT(KIND, N, ARGS)                                     \
  template <typename T>                                                      \
  struct Wgmma##KIND<N, T> {                                                 \
    static __device__ __forceinline__ void run(float (&d)[N / 2], ARGS,     \
                                               uint64_t db, int scale_d) {   \
      if constexpr (std::is_same<T, __half>::value) {                        \
        XDMA_WGMMA_##KIND##_##N("f16");                                      \
      } else {                                                               \
        static_assert(std::is_same<T, __nv_bfloat16>::value, "16-bit only"); \
        XDMA_WGMMA_##KIND##_##N("bf16");                                     \
      }                                                                      \
    }                                                                        \
  };
#define XDMA_A_DESC uint64_t da
#define XDMA_A_REGS const uint32_t (&a)[4]
XDMA_WGMMA_STRUCT(SS, 80, XDMA_A_DESC)
XDMA_WGMMA_STRUCT(SS, 128, XDMA_A_DESC)
XDMA_WGMMA_STRUCT(RS, 64, XDMA_A_REGS)
XDMA_WGMMA_STRUCT(RS, 128, XDMA_A_REGS)
XDMA_WGMMA_STRUCT(RS, 256, XDMA_A_REGS)

}  // namespace hopper
