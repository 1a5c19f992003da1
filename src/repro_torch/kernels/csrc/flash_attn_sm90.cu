// Flash-attention forward for Hopper, bf16 route (kernel 6 of the port).
//
// Replaces repro/kernels/flash_attention.py::_flash_kernel (launched from
// flash_attention through pl.pallas_call) for bfloat16 q, k, v: causal,
// sliding-window or full attention over (BH, S, hd) with an online softmax,
// the scale pre-applied.  Masked scores are -1e30, never -inf; the output is
// acc / max(l, 1e-30) in bfloat16.  GQA: k and v hold BH / groups heads and
// query head bh reads kv head bh / groups.  float32 inputs take the SIMT
// kernel of flash_attn.cu: no tensor-core type keeps float32's precision.
//
// What bounds it on an H100: 4 * hd flops per visible (query, key) pair
// against 2 * (BH + 2 * BH / groups) * S * hd bytes moved, so at the
// prefill's S = 2048 the bf16 tensor cores (989 TFLOP/s) bound it, and the
// exponentials of the softmax (one MUFU op per score, 16 a clock per SM)
// come second.  The design:
//   * both products run on the tensor cores as warpgroup MMAs (wgmma) with
//     float32 accumulators in registers: S = Q.K^T reads Q and K from shared
//     memory (K-major), O += P.V takes P from registers (the S accumulator
//     converted to bf16 maps onto the A fragment k16 chunk by k16 chunk) and
//     V from shared memory (MN-major, transposed B).  Rounding P to bf16 is
//     the one departure from the reference kernel, which keeps p in float32
//     (its own naive path rounds the probabilities the same way);
//   * a block holds three consumer warpgroups of 64 query rows each (192
//     rows of one head; two and 128 rows at hd 192) and one producer warpgroup, one thread of which
//     issues every TMA copy: Q once, then K and V tiles into a ring of
//     kStages stages in shared memory, each stage with a "full" mbarrier
//     (armed with the bytes to expect) and an "empty" one (one arrival per
//     consumer warp), so the next tiles load while the current one is
//     multiplied.  setmaxnreg moves the producer's registers to the
//     consumers (24 and 160 a thread);
//   * inside a warpgroup, tile t's Q.K^T is issued together with tile
//     t - 1's P.V, and the softmax of tile t runs while P.V is still on the
//     tensor cores; the warpgroups of a block fill each other's gaps;
//   * tiles stay bf16 in shared memory, in the swizzle that matches their
//     row width (32, 64 or 128 bytes), the
//     same layout the wgmma descriptors name (hd 128 and 192 as two and
//     three 64-column boxes; hd 96, which no 64-column box divides, as three
//     32-column boxes in the 64-byte swizzle).  The tensor maps are 3-D
//     (hd, S, heads): a ragged last tile is zero-filled inside its own head;
//   * the mask (causal, window, keys >= S) and the online softmax run on the
//     accumulator fragment in registers, in the log2 domain (one fused
//     multiply-add and one ex2 a score): a thread holds 2 rows, the row max
//     reduces over the 4 lanes of a quad, and the row sum stays per thread
//     until the epilogue;
//   * kv tiles that the mask hides from every row of the block are never
//     loaded, and a warpgroup skips the products of the tiles that it hides
//     from all of its own rows (the diagonal's far side, rows past S);
//     blocks of the last query tiles (the most causal work) go first.
// At hd 192 a block has two consumer warpgroups (128 rows): the O
// accumulator is 96 floats a thread and takes 240 registers, and 64-key
// tiles in three stages keep shared memory at 193 KB.  At hd 96, 64-key
// tiles too: S (32), P (16) and O (48 floats) then fit the 160 registers of
// a consumer thread, where 128-key tiles would need 144 of them for the
// fragments alone.  One block per SM;
// ptxas reports the launch's share of registers (128 a thread at 512
// threads, 168 at 384), no spills.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace fa90 {

constexpr int kProducerRegs = 24;                   // registers of a producer thread
constexpr int kStages = 3;                          // K/V ring depth
constexpr float kNegInf = -1e30f;                   // the reference's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Tile {
  // consumer warpgroups of 64 query rows: three, or two at hd 192, whose
  // O accumulator (96 floats a thread) needs the registers of the third
  static constexpr int kConsumers = HD == 192 ? 2 : 3;
  static constexpr int kBlockQ = 64 * kConsumers;         // query rows per block
  static constexpr int kThreads = (kConsumers + 1) * 128; // + the producer warpgroup
  // registers a consumer thread after setmaxnreg: the producer gives its
  // share to the consumers' accumulators (the launch gives 128 a thread at
  // 512 threads, 168 at 384)
  static constexpr int kConsumerRegs = HD == 192 ? 240 : 160;
  static_assert(128 * (kProducerRegs + kConsumers * kConsumerRegs) <= 65536, "register file");
  static constexpr int kBlockK = HD >= 96 ? 64 : 128;     // keys per K/V tile
  // columns per TMA box: the whole row up to 64, else 64-column boxes, or
  // 32-column ones where 64 does not divide hd (96)
  static constexpr int kCols = HD <= 64 ? HD : (HD % 64 ? 32 : 64);
  static constexpr int kHalves = HD / kCols;              // boxes a row: 2 at hd 128, 3 at 96, 192
  static constexpr int kRowBytes = 2 * kCols;             // 32, 64 or 128: the swizzle span
  static constexpr int kChunks = kCols / 16;              // k16 chunks per box row
  // wgmma descriptor layout type: 1 = 128 B swizzle, 2 = 64 B, 3 = 32 B
  static constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : (kRowBytes == 64 ? 2 : 3);
  static constexpr CUtensorMapSwizzle kSwizzle =
      kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                       : (kRowBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B);
  static constexpr int kQHalf = kBlockQ * kRowBytes;      // bytes of one Q box
  static constexpr int kKVHalf = kBlockK * kRowBytes;     // bytes of one K or V box
  static constexpr int kQBytes = kHalves * kQHalf;
  static constexpr int kKVBytes = kHalves * kKVHalf;      // one K or V tile
  static constexpr int kBarOffset = kQBytes + 2 * kStages * kKVBytes;
  // tiles, barriers (q, full[], empty[]) and the slack to align the base to 1 KB
  static constexpr int kSmem = kBarOffset + 8 * (1 + 2 * kStages) + 1024;
};

// ------------------------------------------------------------- PTX helpers
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA: the box at (c0, c1, c2) of a 3-D tensor map into shared memory,
// completing its bytes on ``bar``
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>  // until at most N committed groups are pending
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins accumulator registers at this point of the program: their reads
// after a wgmma wait cannot move above it
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle layout type in bits 62-63
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// D (m64n64, f32) {+}= A (smem, K-major) * B (smem, K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D (m64n128, f32) {+}= A (smem, K-major) * B (smem, K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D (m64n16, f32) += A (registers, 4 x bf16x2) * B (smem, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[8], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1));
}

// D (m64n32, f32) += A (registers, 4 x bf16x2) * B (smem, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[16], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1));
}

// D (m64n64, f32) += A (registers, 4 x bf16x2) * B (smem, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1));
}

// D (m64n96, f32) += A (registers, 4 x bf16x2) * B (smem, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[48], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1));
}

// D (m64n128, f32) += A (registers, 4 x bf16x2) * B (smem, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1));
}

// D (m64n192, f32) += A (registers, 4 x bf16x2) * B (smem, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[96], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95 "
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1));
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// S = Q.K^T for the K tile at ks: hd / 16 k16 steps; within a swizzled row
// a step is 32 bytes, and hd 128 and 192 move to the next box every 4, hd
// 96 (32-column boxes) every 2
template <int HD>
__device__ __forceinline__ void issue_qk(float (&s)[Tile<HD>::kBlockK / 2], uint64_t desc_q,
                                         uint32_t ks) {
  using T = Tile<HD>;
#pragma unroll
  for (int c = 0; c < HD / 16; ++c) {
    const uint32_t h = c / T::kChunks, off = (c % T::kChunks) * 32;
    wgmma_ss(s, desc_q + ((h * T::kQHalf + off) >> 4),
             make_desc(ks + h * T::kKVHalf + off, 16, 8 * T::kRowBytes, T::kLayout), c > 0);
  }
}

// O += P.V for the V tile at vs: BK / 16 k16 steps of 16 keys, V rows
// kRowBytes apart; the boxes of hd 96, 128 and 192 (N = 96, 128 or 192 in
// one wgmma) are the descriptor's leading offset apart
template <int HD>
__device__ __forceinline__ void issue_pv(float (&acc)[HD / 2],
                                         const uint32_t (&p)[Tile<HD>::kBlockK / 4], uint32_t vs) {
  using T = Tile<HD>;
#pragma unroll
  for (int c = 0; c < T::kBlockK / 16; ++c) {
    wgmma_rs(acc, p[4 * c], p[4 * c + 1], p[4 * c + 2], p[4 * c + 3],
             make_desc(vs + 16 * c * T::kRowBytes, T::kKVHalf, 8 * T::kRowBytes, T::kLayout));
  }
}

// Mask and online softmax of one S tile in registers.  Element j of the
// m64nBK accumulator fragment is row ``row + 8 * ((j >> 1) & 1)``, key
// ``k0 + 8 * (j >> 2) + 2 * quad + (j & 1)``.  s becomes p = exp(s - m) in
// place (as ex2 of a fused multiply-add in the log2 domain), m and this
// thread's share of l are updated, and corr is the factor for the earlier
// sums.  While a row has seen masked scores only, its exponent base stays
// 0, so those terms are exp(-1e30) = 0 rather than the reference's
// exp(0) = 1: both vanish for good at the row's first visible key (corr =
// exp(-1e30 - m) = 0), which every row < S has.
template <int BK>
__device__ __forceinline__ void online_softmax(float (&s)[BK / 2], float (&m)[2], float (&l)[2],
                                               float (&corr)[2], bool partial, int k0, int row,
                                               int quad, int seq, int causal, int window) {
  float mx[2] = {kNegInf, kNegInf};
  if (partial) {
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      const int qp = row + 8 * ((j >> 1) & 1);
      const int key = k0 + 8 * (j >> 2) + 2 * quad + (j & 1);
      bool ok = key < seq;
      if (causal) ok = ok && key <= qp;
      if (window) ok = ok && key > qp - window;
      s[j] = ok ? s[j] : kNegInf;
      mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], s[j]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], s[j]);
  }
  float base[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    corr[r] = ex2((m[r] - m_new) * kLog2e);
    m[r] = m_new;
    base[r] = m_new == kNegInf ? 0.f : m_new * kLog2e;
    l[r] *= corr[r];
  }
#pragma unroll
  for (int j = 0; j < BK / 2; ++j) {
    s[j] = ex2(fmaf(s[j], kLog2e, -base[(j >> 1) & 1]));
    l[(j >> 1) & 1] += s[j];
  }
}

template <int N>
__device__ __forceinline__ void pack_p(uint32_t (&p)[N], const float (&s)[2 * N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) p[j] = pack_bf16(s[2 * j], s[2 * j + 1]);
}

// One block: kBlockQ query rows [q0, q0 + kBlockQ) of head bh.  Warpgroups
// 0 .. kConsumers - 1 consume (rows q0 + 64 * wg ...); the last one
// produces, from one thread.
template <int HD>
__global__ void __launch_bounds__(Tile<HD>::kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                   int seq, int bh_count, int groups, int n_qt, int causal, int window) {
  using T = Tile<HD>;
  constexpr int BK = T::kBlockK;
  constexpr int kConsumers = T::kConsumers, kBlockQ = T::kBlockQ;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;  // swizzle atoms need 1 KB
  const uint32_t q_s = base;                           // [halves][kBlockQ][kCols]
  const uint32_t k_s = base + T::kQBytes;              // [stage][halves][BK][kCols]
  const uint32_t v_s = k_s + kStages * T::kKVBytes;
  const uint32_t q_full = base + T::kBarOffset;        // then full[kStages], empty[kStages]
  const uint32_t full0 = q_full + 8, empty0 = full0 + 8 * kStages;

  // last query tiles (the most causal work) first, heads sharing a kv head
  // side by side
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / bh_count;
  const int bh = static_cast<int>(blockIdx.x) % bh_count;
  const int q0 = qt * kBlockQ;
  // kv tiles that hold a visible key for some row of this block
  int last = seq - 1;
  if (causal) last = min(last, q0 + kBlockQ - 1);
  const int kt_lo = window ? max(0, q0 - window + 1) / BK : 0;
  const int n_tiles = last / BK - kt_lo + 1;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers * 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= kConsumers * 4) {  // -------------------------- producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == kConsumers * 4 && lane == 0) {
      const int kvh = bh / groups;
      mbar_expect_tx(q_full, T::kQBytes);
      for (int h = 0; h < T::kHalves; ++h) {
        tma_load(q_s + h * T::kQHalf, &tq, q_full, h * T::kCols, q0, bh);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % kStages;
        if (it >= kStages) mbar_wait(empty0 + 8 * st, (it / kStages - 1) & 1);
        const int k0 = (kt_lo + it) * BK;
        const uint32_t full = full0 + 8 * st;
        mbar_expect_tx(full, 2 * T::kKVBytes);
        for (int h = 0; h < T::kHalves; ++h) {
          const uint32_t off = st * T::kKVBytes + h * T::kKVHalf;
          tma_load(k_s + off, &tk, full, h * T::kCols, k0, kvh);
          tma_load(v_s + off, &tv, full, h * T::kCols, k0, kvh);
        }
      }
    }
    return;
  }

  // ---------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(T::kConsumerRegs));
  const int wg = warp / 4;
  const int wq0 = q0 + 64 * wg;                      // this warpgroup's first row
  const int quad = lane % 4;
  const int row = wq0 + 16 * (warp % 4) + lane / 4;  // this thread's rows: row, row + 8
  float s[BK / 2];
  float acc[HD / 2];
  uint32_t p[BK / 4];  // P in bf16 pairs: the A fragment of k16 chunk c is p[4c .. 4c + 3]
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, corr[2];
#pragma unroll
  for (int j = 0; j < HD / 2; ++j) acc[j] = 0.f;
#pragma unroll
  for (int j = 0; j < BK / 2; ++j) s[j] = 0.f;
  // a tile that hides no score from any row of this warpgroup skips the mask
  auto partial = [&](int k0) {
    return k0 + BK > seq || (causal && k0 + BK - 1 > wq0) || (window && k0 <= wq0 + 63 - window);
  };
  // this warpgroup's own tiles [first, end) of the block's: outside them
  // its rows see no key (and rows >= seq need none), so it only passes
  // those stages on, after they have landed, to keep the ring's phases
  int first = 0, end = 0;
  if (wq0 < seq) {
    int hi = seq - 1;
    if (causal) hi = min(hi, wq0 + 63);
    first = (window ? max(0, wq0 - window + 1) : 0) / BK - kt_lo;
    end = hi / BK - kt_lo + 1;
  }
  auto pass_on = [&](int it) {
    mbar_wait(full0 + 8 * (it % kStages), (it / kStages) & 1);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * (it % kStages));
  };
  for (int it = 0; it < first; ++it) pass_on(it);
  if (first < end) {
    // tile it's S = Q.K^T is issued together with tile it - 1's P.V, so
    // the softmax of tile it runs while the tensor cores finish P.V
    const uint64_t desc_q =
        make_desc(q_s + 64 * wg * T::kRowBytes, 16, 8 * T::kRowBytes, T::kLayout);
    mbar_wait(q_full, 0);
    int k0 = (kt_lo + first) * BK;
    mbar_wait(full0 + 8 * (first % kStages), (first / kStages) & 1);
    wgmma_fence();
    issue_qk<HD>(s, desc_q, k_s + (first % kStages) * T::kKVBytes);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    online_softmax<BK>(s, m, l, corr, partial(k0), k0, row, quad, seq, causal, window);
    pack_p(p, s);
    for (int it = first + 1; it < end; ++it) {
      const int st = it % kStages, prev = (it - 1) % kStages;
      k0 += BK;
      mbar_wait(full0 + 8 * st, (it / kStages) & 1);
      wgmma_fence();
      issue_qk<HD>(s, desc_q, k_s + st * T::kKVBytes);
      wgmma_commit();
      issue_pv<HD>(acc, p, v_s + prev * T::kKVBytes);
      wgmma_commit();
      wgmma_wait<1>();  // S of tile it is done; P.V of tile it - 1 may still run
      fence_regs(s);
      online_softmax<BK>(s, m, l, corr, partial(k0), k0, row, quad, seq, causal, window);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(p);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * prev);  // this warp is done with tile it - 1
#pragma unroll
      for (int j = 0; j < HD / 2; ++j) acc[j] *= corr[(j >> 1) & 1];
      pack_p(p, s);
    }
    const int st = (end - 1) % kStages;
    wgmma_fence();
    issue_pv<HD>(acc, p, v_s + st * T::kKVBytes);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(p);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * st);
  }
  for (int it = end > first ? end : first; it < n_tiles; ++it) pass_on(it);
  if (first >= end) return;

  // epilogue: acc / max(l, 1e-30) in bf16, rows < seq only
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
    const int qp = row + 8 * r;
    if (qp < seq) {
      __nv_bfloat16* orow = o + (static_cast<size_t>(bh) * seq + qp) * HD + 2 * quad;
#pragma unroll
      for (int nb = 0; nb < HD / 8; ++nb) {
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * nb) =
            __floats2bfloat162_rn(acc[4 * nb + 2 * r] / l[r], acc[4 * nb + 2 * r + 1] / l[r]);
      }
    }
  }
}

// ------------------------------------------------------------------ host
// Error codes besides cudaError_t's (which are >= 0)
constexpr int kErrNoEncode = -1;  // cuTensorMapEncodeTiled was not found
constexpr int kErrEncode = -2;    // a tensor map was refused
constexpr int kErrAlign = -3;     // a pointer is not 16-byte aligned

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled looked up through the runtime, so the library
// needs no -lcuda
EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr,
                                                             12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// 3-D map (hd, seq, heads) over a contiguous (heads, seq, hd) bf16 tensor,
// boxes of rows x kCols in the tile's swizzle; rows past seq read as zeros
template <int HD>
bool encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int seq, int heads, int rows) {
  using T = Tile<HD>;
  const cuuint64_t dims[3] = {HD, static_cast<cuuint64_t>(seq), static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {2 * HD, 2ull * HD * static_cast<cuuint64_t>(seq)};
  const cuuint32_t box[3] = {T::kCols, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, T::kSwizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int bh, int seq, int groups,
           int causal, int window, cudaStream_t st) {
  using T = Tile<HD>;
  const int n_qt = (seq + T::kBlockQ - 1) / T::kBlockQ;
  const long long blocks = static_cast<long long>(bh) * n_qt;
  if (seq < 1 || blocks < 1 || blocks > 0x7fffffffLL || groups < 1 || bh % groups || window < 0) {
    return cudaErrorInvalidValue;
  }
  if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o))) return kErrAlign;
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return kErrNoEncode;
  CUtensorMap tq, tk, tv;
  if (!(encode<HD>(fn, &tq, q, seq, bh, T::kBlockQ) &&
        encode<HD>(fn, &tk, k, seq, bh / groups, T::kBlockK) &&
        encode<HD>(fn, &tv, v, seq, bh / groups, T::kBlockK))) {
    return kErrEncode;
  }
  auto kern = flash_wgmma_kernel<HD>;
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err != cudaSuccess) return err;
  kern<<<static_cast<unsigned>(blocks), T::kThreads, T::kSmem, st>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), seq, bh, groups, n_qt, causal, window);
  return cudaGetLastError();
}

}  // namespace fa90

// bf16 q (BH, S, hd), k and v (BH / groups, S, hd), o like q; every pointer
// 16-byte aligned.  Returns 0 when launched, else a cudaError_t or one of
// the negative codes above (flash_sm90_error_string names it).
extern "C" int flash_sm90_launch(const void* q, const void* k, const void* v, void* o, int bh,
                                 int seq, int head_dim, int groups, int causal, int window,
                                 void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: return fa90::launch<16>(q, k, v, o, bh, seq, groups, causal, window, st);
    case 32: return fa90::launch<32>(q, k, v, o, bh, seq, groups, causal, window, st);
    case 64: return fa90::launch<64>(q, k, v, o, bh, seq, groups, causal, window, st);
    case 96: return fa90::launch<96>(q, k, v, o, bh, seq, groups, causal, window, st);
    case 128: return fa90::launch<128>(q, k, v, o, bh, seq, groups, causal, window, st);
    case 192: return fa90::launch<192>(q, k, v, o, bh, seq, groups, causal, window, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* flash_sm90_error_string(int code) {
  switch (code) {
    case fa90::kErrNoEncode: return "cuTensorMapEncodeTiled was not found (CUDA 12 needed)";
    case fa90::kErrEncode: return "cuTensorMapEncodeTiled refused a tensor map";
    case fa90::kErrAlign: return "q, k, v and o must be 16-byte aligned (TMA)";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}
