// The prefix-reuse shift walk on the device-memory route (kernels 4 and 5
// of the port at registers of 13 qubits and more).
//
// Replaces repro/kernels/vqc_statevector.py::_shift_forward_kernel and
// ::_shift_tile_kernel (the spilled branch of vqc_shift_fidelity) where no
// block's shared memory holds one sample of either shift-walk kernel: from
// m = 13 (27-qubit QuClassi) one checkpoint and the walk's three live
// states take 256 KB against a block's 227 KB (_shift_route in
// vqc_statevector.py).  It computes the same rows: the data-register pass,
// f0, and every requested (param, shift) variant of the walk, in the
// reference's group order.
//
//   One block a sample.  Every state of the walk lives in device memory, in
//   the wrapper's scratch tensor: [sample][slot][re/im][amp], slot 0 chi
//   (seeded with the data state), slot 1 a multi-pass replay's variant,
//   slot 2 + i checkpoint i.  The walk arrives as a program of passes built
//   on the host (_shift_dmem_walk): the data run, the forward runs between
//   checkpoints (each storing the next checkpoint), f0, and in descending
//   anchor order the inverse runs of chi and each variant's replay of its
//   parameter's span from its checkpoint with the shift on that
//   parameter's gates.  A run is cut into passes of at most k = 13 local
//   qubits (dmem_plan's cutting, the three lowest-order qubits always
//   local), so the state splits into 2^(m - k) chunks of 2^k amplitudes
//   (64 KB: the whole state at m = 13).  A pass loads each chunk of its
//   source slot into shared memory (or makes |0...0> there), applies its
//   gates with chunk_gates (the gate arithmetic of every kernel of the
//   port: rot1, rot2, dot2), and stores the chunk to its destination slot,
//   and/or takes the chunk's share of <chi|v>, chi read from device memory
//   at the same amplitudes.  A pass whose source is the slot the previous
//   single-chunk pass stored skips the load: the chunk is still staged.
//   Pass angles come from a per-sample table of cos/sin built once in
//   shared memory (base angles of the data and train ops, and theta[j] +
//   shift for each variant), negated sin for the inverted ops of chi.
//
// Inner products sum in a fixed order: each thread its float4 elements in
// turn, a block reduction of warp sums in warp order (block_sum), then the
// chunks' partials in chunk order.  A lane's rows therefore depend only on
// its own angles: not on the batch, nor on how many samples a launch takes
// (the wrapper splits a batch by samples when their scratch would exceed
// SHIFT_DMEM_WORKSPACE_BYTES).
//
// Bound on an H100: the function moves only the angles in and one float a
// row out; its float32 arithmetic (the gate applications and the inner
// products over 2^m amplitudes) is the bound.  This route's own traffic,
// every pass's loads and stores of 2 * 4 * 2^k bytes a chunk through
// device memory (34 MB a sample at 27q-3l: shift_dmem_traffic_bytes), is
// far larger, and the checkpoints of the samples in flight do not fit the
// 50 MB L2: device memory bounds the design.  Keeping chi staged beside the variant (two
// chunks a block) is the next step.
#include "dmem.cuh"
#include "statevector.cuh"

namespace vqc {

constexpr int kWalkPassFields = 7;  // source, destination, row, op lo, op hi, local mask (two halves)
constexpr int kAllF0Rows = -2;      // a pass row that writes every base-fidelity row

// <chi|v> over the chunk, summed over the block: v staged in shared memory,
// chi read from device memory at the chunk's amplitudes.
__device__ __noinline__ float2 chunk_inner(const Chunk ch, const float4* sre, const float4* sim,
                                           const float* cre, const float* cim, float* partial) {
  float ip_re = 0.f, ip_im = 0.f;
#pragma unroll 1
  for (int e = threadIdx.x; e < ch.size / 4; e += blockDim.x) {
    const long long g = ch.at(4 * e);
    const float4 xr = __ldcg(reinterpret_cast<const float4*>(cre + g));
    const float4 xi = __ldcg(reinterpret_cast<const float4*>(cim + g));
    const float4 r = sre[e], m = sim[e];
    accumulate(xr.x, xi.x, r.x, m.x, ip_re, ip_im);
    accumulate(xr.y, xi.y, r.y, m.y, ip_re, ip_im);
    accumulate(xr.z, xi.z, r.z, m.z, ip_re, ip_im);
    accumulate(xr.w, xi.w, r.w, m.w, ip_re, ip_im);
  }
  ip_re = block_sum(ip_re, partial);
  return make_float2(ip_re, block_sum(ip_im, partial));
}

// A slot's chunk into shared memory (|0...0> for slot -1), and back: out
// of line, like chunk_inner and chunk_gates, which keeps the kernel within
// its 64 registers (__launch_bounds__(1024)) without spilling.
__device__ __noinline__ void load_slot(const Chunk ch, float4* sre, float4* sim, const float* mine,
                                       int src, long long dim) {
  const float* s = src < 0 ? nullptr : mine + src * 2 * dim;
  load_chunk(ch, sre, sim, s, s ? s + dim : nullptr, 0ULL, src < 0);
}

__device__ __noinline__ void store_slot(const Chunk ch, const float4* sre, const float4* sim,
                                        float* mine, int dst, long long dim) {
  store_chunk(ch, sre, sim, mine + dst * 2 * dim, mine + dst * 2 * dim + dim);
}

// Sample blockIdx.x of the launch: its angles at theta + b * n_theta, its
// scratch at scratch + b * sample_floats, its rows in column col0 + b of
// out (out_stride columns).
__global__ void __launch_bounds__(1024)
shift_dmem_kernel(const float* __restrict__ theta, const float* __restrict__ data, int n_theta,
                  int n_data, const int* __restrict__ base_ops,
                  const float* __restrict__ base_consts, int n_base,
                  const int* __restrict__ var_param, const float* __restrict__ var_shift,
                  int n_var, const int* __restrict__ passes, int n_passes,
                  const int* __restrict__ pass_ops, const int* __restrict__ pass_refs,
                  int max_pass_ops, const int* __restrict__ f0_rows, int n_f0_rows, int m, int k,
                  float* scratch, long long sample_floats, float* __restrict__ out,
                  long long out_stride, long long col0) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x, nt = blockDim.x, size = 1 << k;
  const long long b = blockIdx.x, dim = 1LL << m;
  const float* th = theta + b * n_theta;
  const float* dt = data + b * n_data;
  float* mine = scratch + b * sample_floats;
  float* sre = smem;                    // [2^k]
  float* sim = sre + size;              // [2^k]
  float4* sre4 = reinterpret_cast<float4*>(sre);
  float4* sim4 = reinterpret_cast<float4*>(sim);
  float* ang = sim + size;              // [2 * (n_base + n_var)]
  float* pang = ang + 2 * (n_base + n_var);  // [2 * max_pass_ops]
  long long* dep_lo = reinterpret_cast<long long*>(pang + 2 * max_pass_ops);
  long long* dep_hi = dep_lo + kDepLo;
  float* partial = reinterpret_cast<float*>(dep_hi + kDepHi);  // one a warp
  const unsigned long long all = (1ULL << m) - 1;
  const long long n_chunks = 1LL << (m - k);

  for (int j = tid; j < n_base; j += nt) {
    op_angle(base_ops + j * kOpFields, base_consts[j], th, dt, 0.f, ang[2 * j], ang[2 * j + 1]);
  }
  for (int v = tid; v < n_var; v += nt) {
    const float a = th[var_param[v]] + var_shift[v];
    ang[2 * (n_base + v)] = cosf(a / 2.f);
    ang[2 * (n_base + v) + 1] = sinf(a / 2.f);
  }
  unsigned long long staged_mask = 0;  // the local mask the deposit tables hold (0: none)
  int resident = -1;                   // the slot whose only chunk is staged, or -1
#pragma unroll 1
  for (int p = 0; p < n_passes; ++p) {
    const int* row = passes + p * kWalkPassFields;
    const int src = row[0], dst = row[1], out_row = row[2], lo = row[3], n_ops = row[4] - lo;
    const unsigned long long local = mask_at(row + 5);
    __syncthreads();  // the angle table is written; the last pass is done with pang and the tables
    if (local != staged_mask) {
      for (int e = tid; e < kDepLo + kDepHi; e += nt) {
        if (e < kDepLo) dep_lo[e] = deposit(e, local);
        else dep_hi[e - kDepLo] = deposit(static_cast<long long>(e - kDepLo) << 8, local);
      }
      staged_mask = local;
    }
    for (int j = tid; j < n_ops; j += nt) {
      const int ref = pass_refs[lo + j], a = ref >> 1;
      pang[2 * j] = ang[2 * a];
      pang[2 * j + 1] = (ref & 1) ? -ang[2 * a + 1] : ang[2 * a + 1];
    }
    __syncthreads();
    const bool staged = src >= 0 && src == resident;
    float acc_re = 0.f, acc_im = 0.f;
#pragma unroll 1
    for (long long c = 0; c < n_chunks; ++c) {
      const Chunk ch{deposit(c, all & ~local), dep_lo, dep_hi, size};
      if (!staged) {
        load_slot(ch, sre4, sim4, mine, src, dim);
        __syncthreads();
      }
      chunk_gates(pass_ops + lo * kOpFields, pang, 0, n_ops, sre, sim, k);
      if (dst >= 0) store_slot(ch, sre4, sim4, mine, dst, dim);
      if (out_row != -1) {
        const float2 ip = chunk_inner(ch, sre4, sim4, mine, mine + dim, partial);  // chi: slot 0
        acc_re += ip.x;
        acc_im += ip.y;
      }
      __syncthreads();  // the chunk in shared memory is free
    }
    resident = n_chunks == 1 && dst >= 0 ? dst : -1;
    if (out_row != -1 && tid == 0) {
      const float f = acc_re * acc_re + acc_im * acc_im;
      if (out_row == kAllF0Rows) {
        for (int r = 0; r < n_f0_rows; ++r) out[f0_rows[r] * out_stride + col0 + b] = f;
      } else {
        out[out_row * out_stride + col0 + b] = f;
      }
    }
  }
}

}  // namespace vqc

// Samples [col0, col0 + n_samples) of a batch of out_stride: theta and data
// are the launch's own rows, scratch holds sample_floats floats a sample.
extern "C" int vqc_shift_dmem_launch(const float* theta, const float* data, int n_samples,
                                     int n_theta, int n_data, const int* base_ops,
                                     const float* base_consts, int n_base, const int* var_param,
                                     const float* var_shift, int n_var, const int* passes,
                                     int n_passes, const int* pass_ops, const int* pass_refs,
                                     int max_pass_ops, const int* f0_rows, int n_f0_rows, int m,
                                     int k, float* scratch, long long sample_floats, float* out,
                                     long long out_stride, long long col0, int threads,
                                     int smem_bytes, void* stream) {
  if (k < 2 || k > 14 || k > m || m - k > 30 || n_samples < 1 || threads > 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = vqc::allow_smem(vqc::shift_dmem_kernel, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  vqc::shift_dmem_kernel<<<n_samples, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      theta, data, n_theta, n_data, base_ops, base_consts, n_base, var_param, var_shift, n_var,
      passes, n_passes, pass_ops, pass_refs, max_pass_ops, f0_rows, n_f0_rows, m, k, scratch,
      sample_floats, out, out_stride, col0);
  return static_cast<int>(cudaGetLastError());
}
