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
// float32 tolerance (TF32 keeps 10 mantissa bits).
//
// GQA: k and v hold BH / groups heads and query head bh reads kv head
// bh / groups, the reference's repeat of K/V over groups without
// materializing it.
//
// Layout: one block per (bh, tile of 64 query rows), 128 threads, two per
// row.  The query tile and each kv tile of 64 keys are staged through
// shared memory (rows padded to hd + 1 words, so the two key rows and
// sixteen query rows a warp reads at once fall in distinct banks).  The
// thread pair of a row splits the keys of a tile (even / odd) for the
// scores and the columns of the accumulator (even / odd) for P.V, and
// exchanges the row max, the row sum and the probabilities by shuffles; m,
// l and acc stay in registers.  kv tiles that the mask hides entirely are
// skipped: their terms are exactly 0.  Blocks of the last query tiles (the
// most causal work) are scheduled first.
//
// Bound on an H100: 4 * hd flops per visible (query, key) pair against
// 2 * (BH + 2 * BH / groups) * S * hd elements moved, so at S = 2048 the
// float32 rate bounds it (67 TFLOP/s outside the tensor cores).  Its
// products are FMAs in the CUDA cores, each fed by a shared-memory load,
// so the shared-memory pipe bounds it first.
#include <cuda_runtime.h>

namespace flash {

constexpr int kBlockQ = 64;             // query rows per block
constexpr int kBlockK = 64;             // keys per staged kv tile
constexpr int kThreads = 2 * kBlockQ;   // two threads per query row
constexpr float kNegInf = -1e30f;       // the reference's NEG_INF

template <int HD>
constexpr int smem_bytes() {
  return static_cast<int>(sizeof(float)) * (kBlockQ * (HD + 1) + kBlockK * (HD + 1) + kBlockK * HD);
}

// Rows [row0, row0 + 64) of one (seq, HD) head into shared memory with
// leading dimension ld; rows at or past seq become zeros.
template <int HD>
__device__ __forceinline__ void stage(float* dst, int ld, const float* __restrict__ src, int row0,
                                      int seq) {
  for (int e = threadIdx.x; e < kBlockK * HD; e += kThreads) {
    const int row = e / HD, col = e % HD;
    const int p = row0 + row;
    dst[row * ld + col] = p < seq ? src[static_cast<size_t>(p) * HD + col] : 0.f;
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int seq, int groups,
                 int n_qt, int causal, int window) {
  constexpr int LD = HD + 1;
  constexpr int HALF = HD / 2;   // accumulator columns per thread
  constexpr int KH = kBlockK / 2;  // keys per thread per tile
  extern __shared__ float smem[];
  float* qs = smem;                    // [64][HD + 1]
  float* ks = qs + kBlockQ * LD;       // [64][HD + 1]
  float* vs = ks + kBlockK * LD;       // [64][HD]

  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x % n_qt);
  const int bh = static_cast<int>(blockIdx.x / n_qt);
  const size_t head = static_cast<size_t>(seq) * HD;
  const float* qh = q + bh * head;
  const float* kh = k + (bh / groups) * head;
  const float* vh = v + (bh / groups) * head;
  const int q0 = qt * kBlockQ;
  const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
  const int qpos = q0 + r;

  stage<HD>(qs, LD, qh, q0, seq);

  // kv tiles that hold a visible key for some row of this tile
  int last = seq - 1;
  if (causal) last = min(last, q0 + kBlockQ - 1);
  const int kt_hi = last / kBlockK;
  const int kt_lo = window ? max(0, q0 - window + 1) / kBlockK : 0;

  float m = kNegInf, l = 0.f;
  float acc[HALF];
#pragma unroll
  for (int c = 0; c < HALF; ++c) acc[c] = 0.f;

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // the query tile is staged; nobody reads the last kv tile
    stage<HD>(ks, LD, kh, k0, seq);
    stage<HD>(vs, HD, vh, k0, seq);
    __syncthreads();

    // scores of this row against keys k0 + 2j + half
    float s[KH];
#pragma unroll
    for (int j = 0; j < KH; ++j) s[j] = 0.f;
    const float* qrow = qs + r * LD;
    const float* krow = ks + half * LD;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      const float qd = qrow[d];
#pragma unroll
      for (int j = 0; j < KH; ++j) s[j] = fmaf(qd, krow[2 * j * LD + d], s[j]);
    }
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < KH; ++j) {
      const int kp = k0 + 2 * j + half;
      bool ok = kp < seq;
      if (causal) ok = ok && kp <= qpos;
      if (window) ok = ok && kp > qpos - window;
      s[j] = ok ? s[j] : kNegInf;
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < KH; ++j) {
      s[j] = expf(s[j] - m_new);
      sum += s[j];
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    const float corr = expf(m - m_new);
    l = l * corr + sum;
    m = m_new;
#pragma unroll
    for (int c = 0; c < HALF; ++c) acc[c] *= corr;

    // acc[c] (column 2c + half) += p(key) * v[key][2c + half] over the tile
#pragma unroll
    for (int j = 0; j < KH; ++j) {
      const float other = __shfl_xor_sync(0xffffffffu, s[j], 1);
      const float p_even = half ? other : s[j];  // key k0 + 2j
      const float p_odd = half ? s[j] : other;   // key k0 + 2j + 1
      const float* v_even = vs + (2 * j) * HD + half;
      const float* v_odd = v_even + HD;
#pragma unroll
      for (int c = 0; c < HALF; ++c) {
        acc[c] = fmaf(p_even, v_even[2 * c], acc[c]);
        acc[c] = fmaf(p_odd, v_odd[2 * c], acc[c]);
      }
    }
  }

  if (qpos < seq) {
    const float denom = fmaxf(l, 1e-30f);
    float* orow = o + bh * head + static_cast<size_t>(qpos) * HD + half;
#pragma unroll
    for (int c = 0; c < HALF; ++c) orow[2 * c] = acc[c] / denom;
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
  constexpr int smem = smem_bytes<HD>();
  auto kern = flash_fwd_kernel<HD>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kern<<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), seq, groups, n_qt, causal, window);
  return cudaGetLastError();
}

}  // namespace flash

// float32 q (BH, S, hd), k and v (BH / groups, S, hd), o like q.  Returns a
// cudaError_t (0 = launched).
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
