// Flash-attention forward, float32 route (kernel 6 of the port).
//
// Replaces repro/kernels/flash_attention.py::_flash_kernel (launched from
// flash_attention through pl.pallas_call) for float32 q, k, v: causal,
// sliding-window or full attention over (BH, S, hd) with an online softmax,
// the scale pre-applied; scores, the softmax and the P.V product are
// float32, as the reference casts its tiles to float32; the output is
// acc / max(l, 1e-30).  Masked scores are -1e30, not -inf, so a row whose
// first kv tile is fully masked gets exp(0) terms that the next unmasked
// tile multiplies by exp(-1e30 - m) = 0, never NaN.  bfloat16 inputs take
// flash_attn_sm90.cu (wgmma fed by TMA): no tensor-core type keeps the
// float32 tolerance (TF32 keeps 10 mantissa bits), so the products here are
// float32 FMAs in the CUDA cores.
//
// GQA: k and v hold BH / groups heads and query head bh reads kv head
// bh / groups, the reference's repeat of K/V over groups without
// materializing it.
//
// Layout: one block of 8 warps per (bh, tile of 64 query rows); the blocks
// of every head's last query tile (the most causal work) are scheduled
// first.  The query tile, one kv tile of 64 keys and the tile's
// probabilities sit in shared memory (Q and K rows padded to hd + 4 words).
// Thread (rg, kg), rg = 0..15 and kg = 0..15 (a half warp shares rg), holds
// the rows rg + 16i (i < 4): in the scores the keys kg + 16j (j < 4), a
// 4 x 4 register micro-tile built from float4 fragments of Q and K along the
// head dim (8 shared loads a 64 FMAs, where the kernel this replaced spent
// one a FMA); in P.V the accumulator columns of group kg (hd / 16 of them:
// at most 48 floats at hd 192), each key's probabilities read as float4 and
// its V row as float4 (float2 at hd 96).  A row's max and sum are shuffles
// over its half warp; m, l and acc stay in registers.  The kv tiles are
// staged by cp.async (16 bytes a copy, rows past S zero-filled) into one K
// and one V buffer, each load overlapping the other half of the tile's
// work: tile t + 1's K loads while P.V of tile t runs, its V while the
// scores of tile t + 1 run.  kv tiles that the mask hides from the whole
// block are skipped (their terms are exactly 0), and a tile that the mask
// does not touch skips the mask.
//
// Bound on an H100: 4 * hd flops per visible (query, key) pair against
// 2 * (BH + 2 * BH / groups) * S * hd float32 elements moved, so at S = 2048
// the float32 rate bounds it (67 TFLOP/s outside the tensor cores).  A
// micro-tile's 64 FMAs come with 8 float4 shared loads, which take 12 of
// the SM's shared-memory cycles against its 16 FMA cycles; with the expf of
// every score and the block's three barriers a tile, it ran at 45-50% of
// that rate on an H100 at every head dim.  TF32 tensor cores would not
// hold the float32 tolerance, so no tensor-core route serves this dtype.
#include <cuda_runtime.h>

namespace flash {

constexpr int kThreads = 256;          // 8 warps
constexpr int kBlockQ = 64;            // query rows per block
constexpr int kBlockK = 64;            // keys per staged kv tile
constexpr int kRows = 4;               // query rows per thread: rg + 16 i
constexpr int kKeys = 4;               // keys per thread in the scores: kg + 16 j
constexpr int kLdP = kBlockK + 16;     // P rows: a half warp's two rows 16 banks apart
constexpr float kNegInf = -1e30f;      // the reference's NEG_INF

template <int HD>
struct Tile {
  static constexpr int kLd = HD + 4;                 // Q and K rows: 4 banks apart
  static constexpr int kCols = HD / 16;              // accumulator columns per thread
  static constexpr int kVec = kCols % 4 == 0 ? 4 : kCols % 2 == 0 ? 2 : 1;
  static constexpr int kNVec = kCols / kVec;         // vectors of kVec columns per thread
  static constexpr int kSmemBytes =
      static_cast<int>(sizeof(float)) *
      (kBlockQ * kLd + kBlockK * kLd + kBlockK * HD + kBlockQ * kLdP);
  // blocks an SM the registers must allow (shared memory allows one from
  // hd 128)
  static constexpr int kMinBlocks = HD >= 128 ? 1 : 2;
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start copying rows [row0, row0 + 64) of one (seq, HD) head into shared
// memory with leading dimension ld; rows at or past seq become zeros.
template <int HD>
__device__ __forceinline__ void stage(float* dst, int ld, const float* __restrict__ src, int row0,
                                      int seq) {
  constexpr int kChunks = HD / 4;  // 16-byte copies a row
#pragma unroll
  for (int e = threadIdx.x; e < kBlockK * kChunks; e += kThreads) {
    const int row = e / kChunks, c4 = e % kChunks;
    const bool ok = row0 + row < seq;
    cp_async16(dst + row * ld + 4 * c4, src + static_cast<size_t>(ok ? row0 + row : 0) * HD + 4 * c4,
               ok);
  }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float part(const float4& f, int i) {
  return i == 0 ? f.x : i == 1 ? f.y : i == 2 ? f.z : f.w;
}

template <int HD>
__global__ void __launch_bounds__(kThreads, Tile<HD>::kMinBlocks)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int n_bh, int seq,
                 int groups, int n_qt, int causal, int window) {
  using T = Tile<HD>;
  constexpr int LD = T::kLd, NC = T::kCols, VW = T::kVec, NV = T::kNVec;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                // [64][HD + 4]
  float* ks = qs + kBlockQ * LD;   // [64][HD + 4]
  float* vs = ks + kBlockK * LD;   // [64][HD]
  float* ps = vs + kBlockK * HD;   // [64][80] probabilities, row-major

  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x / n_bh);
  const int bh = static_cast<int>(blockIdx.x % n_bh);
  const size_t head = static_cast<size_t>(seq) * HD;
  const float* qh = q + bh * head;
  const float* kh = k + (bh / groups) * head;
  const float* vh = v + (bh / groups) * head;
  const int q0 = qt * kBlockQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rg = 2 * warp + (lane >> 4);  // rows rg + 16 i
  const int kg = lane & 15;               // keys kg + 16 j; accumulator column group kg

  // kv tiles that hold a visible key for some row of this tile
  int last = seq - 1;
  if (causal) last = min(last, q0 + kBlockQ - 1);
  const int kt_hi = last / kBlockK;
  const int kt_lo = window ? max(0, q0 - window + 1) / kBlockK : 0;

  stage<HD>(qs, LD, qh, q0, seq);
  stage<HD>(ks, LD, kh, kt_lo * kBlockK, seq);
  cp_commit();
  stage<HD>(vs, HD, vh, kt_lo * kBlockK, seq);
  cp_commit();

  float m[kRows], l[kRows], acc[kRows][NC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * kBlockK;
    cp_wait<1>();  // the query tile and this K tile have landed (V may not have)
    __syncthreads();

    // scores of rows rg + 16i against keys k0 + kg + 16j, the head dim in
    // float4 steps
    float s[kRows][kKeys];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < HD; d += 4) {
      float4 qf[kRows], kf[kKeys];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        qf[i] = *reinterpret_cast<const float4*>(qs + (rg + 16 * i) * LD + d);
#pragma unroll
      for (int j = 0; j < kKeys; ++j)
        kf[j] = *reinterpret_cast<const float4*>(ks + (kg + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
#pragma unroll
        for (int j = 0; j < kKeys; ++j) {
          s[i][j] = fmaf(qf[i].x, kf[j].x, s[i][j]);
          s[i][j] = fmaf(qf[i].y, kf[j].y, s[i][j]);
          s[i][j] = fmaf(qf[i].z, kf[j].z, s[i][j]);
          s[i][j] = fmaf(qf[i].w, kf[j].w, s[i][j]);
        }
      }
    }
    // the mask, unless every key of the tile is visible to every row
    const bool whole = k0 + kBlockK <= seq && (!causal || k0 + kBlockK - 1 <= q0) &&
                       (!window || k0 > q0 + kBlockQ - 1 - window);
    if (!whole) {
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int qpos = q0 + rg + 16 * i;
#pragma unroll
        for (int j = 0; j < kKeys; ++j) {
          const int kp = k0 + kg + 16 * j;
          bool ok = kp < seq;
          if (causal) ok = ok && kp <= qpos;
          if (window) ok = ok && kp > qpos - window;
          s[i][j] = ok ? s[i][j] : kNegInf;
        }
      }
    }
    // online softmax: a row's max over its half warp; l sums this thread's
    // keys (the row's lanes are added at the end)
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      float mx = s[i][0];
#pragma unroll
      for (int j = 1; j < kKeys; ++j) mx = fmaxf(mx, s[i][j]);
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float corr = expf(m[i] - m_new);
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        ps[(rg + 16 * i) * kLdP + kg + 16 * j] = p;
      }
      l[i] = l[i] * corr + sum;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
    cp_wait<0>();  // this V tile has landed
    __syncthreads();  // P and V are visible; nobody reads K any more
    if (kt < kt_hi) stage<HD>(ks, LD, kh, k0 + kBlockK, seq);
    cp_commit();

    // acc[i][t * VW + u] (column t * 16 * VW + kg * VW + u) += p * v over
    // the tile's keys, four keys a step
#pragma unroll 2
    for (int j = 0; j < kBlockK; j += 4) {
      float4 pf[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        pf[i] = *reinterpret_cast<const float4*>(ps + (rg + 16 * i) * kLdP + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vrow = vs + (j + jj) * HD + kg * VW;
        float vv[NC];
#pragma unroll
        for (int t = 0; t < NV; ++t) {
          if constexpr (VW == 4) {
            const float4 f = *reinterpret_cast<const float4*>(vrow + t * 16 * VW);
            vv[4 * t] = f.x; vv[4 * t + 1] = f.y; vv[4 * t + 2] = f.z; vv[4 * t + 3] = f.w;
          } else if constexpr (VW == 2) {
            const float2 f = *reinterpret_cast<const float2*>(vrow + t * 16 * VW);
            vv[2 * t] = f.x; vv[2 * t + 1] = f.y;
          } else {
            vv[t] = vrow[t * 16];
          }
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float p = part(pf[i], jj);
#pragma unroll
          for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
        }
      }
    }
    __syncthreads();  // nobody reads P or V any more
    if (kt < kt_hi) stage<HD>(vs, HD, vh, k0 + kBlockK, seq);
    cp_commit();
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const float denom = fmaxf(half_warp_sum(l[i]), 1e-30f);
    const int qpos = q0 + rg + 16 * i;
    if (qpos >= seq) continue;
    float* orow = o + bh * head + static_cast<size_t>(qpos) * HD + kg * VW;
#pragma unroll
    for (int t = 0; t < NV; ++t) {
#pragma unroll
      for (int u = 0; u < VW; ++u) orow[t * 16 * VW + u] = acc[i][t * VW + u] / denom;
    }
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int bh, int seq,
                   int groups, int causal, int window, cudaStream_t st) {
  const int n_qt = (seq + kBlockQ - 1) / kBlockQ;
  const long long blocks = static_cast<long long>(bh) * n_qt;
  if (blocks < 1 || blocks > 0x7fffffffLL || groups < 1 || bh % groups) {
    return cudaErrorInvalidValue;
  }
  const size_t addr = reinterpret_cast<size_t>(q) | reinterpret_cast<size_t>(k) |
                      reinterpret_cast<size_t>(v) | reinterpret_cast<size_t>(o);
  if (addr % 16) return cudaErrorMisalignedAddress;  // cp.async copies 16 bytes
  constexpr int smem = Tile<HD>::kSmemBytes;
  auto kern = flash_fwd_kernel<HD>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kern<<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), bh, seq, groups, n_qt, causal, window);
  return cudaGetLastError();
}

}  // namespace flash

// float32 q (BH, S, hd), k and v (BH / groups, S, hd), o like q, each
// 16-byte aligned.  Returns a cudaError_t (0 = launched).
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v, void* o, int bh,
                                 int seq, int head_dim, int groups, int causal, int window,
                                 void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (head_dim) {
    case 16: err = flash::launch<16>(q, k, v, o, bh, seq, groups, causal, window, st); break;
    case 32: err = flash::launch<32>(q, k, v, o, bh, seq, groups, causal, window, st); break;
    case 64: err = flash::launch<64>(q, k, v, o, bh, seq, groups, causal, window, st); break;
    case 96: err = flash::launch<96>(q, k, v, o, bh, seq, groups, causal, window, st); break;
    case 128: err = flash::launch<128>(q, k, v, o, bh, seq, groups, causal, window, st); break;
    case 192: err = flash::launch<192>(q, k, v, o, bh, seq, groups, causal, window, st); break;
    default: break;
  }
  return static_cast<int>(err);
}

extern "C" const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
